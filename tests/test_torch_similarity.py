"""The port's similarity operator against the JAX package's (plain and Pallas).

The CUDA kernel itself runs only on a card: its tests carry the ``gpu`` marker
and skip on machines without one. The JAX package is imported by a fixture, so
the card's tests also run where JAX is not installed.
"""

import importlib
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.kernels import similarity, similarity_cuda, similarity_ref

# the wrapper module, which keeps the launch count (the package's `similarity` is the op)
sim_module = importlib.import_module("repro_torch.kernels.similarity.similarity")

# tests/test_kernels.py's sweep
SHAPES = [(64, 32, 16), (256, 256, 256), (130, 70, 33), (8, 8, 4), (512, 128, 1024)]
KINDS = ["inverse_distance", "gaussian"]
DTYPES = ["float32", "bfloat16"]
# Both sides get the same (bf16-rounded) values and compute in float32, so bfloat16
# inputs are held at the float32 bar; tests/test_kernels.py's 5e-2 is for bf16 against
# a float32 reference of the unrounded values.
TOL = 5e-6
GAMMA = 1.7


def _gamma(n):
    """sqrt(2n), about the median distance between two standard-normal rows of width n,
    so that both kinds stay well away from 0 at every shape of the sweep."""
    return float(np.sqrt(2.0 * n))


def _inputs(m, b, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, n)).astype(np.float32)
    y = rng.standard_normal((b, n)).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels.similarity import similarity_pallas, similarity_ref

    return types.SimpleNamespace(jnp=jnp, pallas=similarity_pallas, ref=similarity_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("m,b,n", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_ref_matches_jax_ref_and_pallas(jax_side, m, b, n, dtype, kind):
    x, y = _inputs(m, b, n)
    # the same values for both packages: bf16 rounding from f32 is the same in each
    jx, jy = (jax_side.jnp.asarray(a, getattr(jax_side.jnp, dtype)) for a in (x, y))
    tx, ty = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, y))
    gamma = _gamma(n)
    out = similarity_ref(tx, ty, gamma, kind).numpy()
    assert out.dtype == np.float32 and out.shape == (m, b)
    assert out.min() > 0.01
    ref = jax_side.ref(jx, jy, gamma, kind)
    np.testing.assert_allclose(out, np.asarray(ref), atol=TOL, rtol=TOL)
    pallas = jax_side.pallas(jx, jy, gamma, kind, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), atol=TOL, rtol=TOL)


def test_auto_on_cpu_takes_plain_version_without_launching():
    x, y = _inputs(40, 24, 12, seed=3)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    sim_module.launches = 0
    out = similarity(tx, ty, gamma=GAMMA, kind="gaussian")
    assert sim_module.launches == 0
    assert torch.equal(out, similarity_ref(tx, ty, GAMMA, "gaussian"))


def test_cuda_impl_on_cpu_tensor_raises():
    x, y = _inputs(8, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        similarity(torch.from_numpy(x), torch.from_numpy(y), impl="cuda")
    assert sim_module.launches == 0


@pytest.mark.parametrize(
    "impl,kind,err", [("pallas", "inverse_distance", "impl"), ("ref", "cosine", "kind")]
)
def test_unknown_impl_or_kind_raises(impl, kind, err):
    x, y = _inputs(8, 8, 4)
    with pytest.raises(ValueError, match=err):
        similarity(torch.from_numpy(x), torch.from_numpy(y), kind=kind, impl=impl)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_version_on_card(cuda, dtype, kind):
    for m, b, n in SHAPES:
        x, y = _inputs(m, b, n)
        tx = torch.from_numpy(x).to(cuda, getattr(torch, dtype))
        ty = torch.from_numpy(y).to(cuda, getattr(torch, dtype))
        gamma = _gamma(n)
        before = sim_module.launches
        out = similarity(tx, ty, gamma=gamma, kind=kind)
        torch.cuda.synchronize()
        assert sim_module.launches == before + 1
        ref = similarity_ref(tx, ty, gamma, kind)
        assert float(ref.min()) > 0.01
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=TOL, rtol=TOL)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError):
        similarity_cuda(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        similarity_cuda(x.T, x.T)
    with pytest.raises(ValueError, match="expected"):
        similarity_cuda(x, torch.zeros((4, 5), device=cuda))
