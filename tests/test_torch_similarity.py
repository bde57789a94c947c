"""The port's similarity operator against the JAX package's (plain and Pallas).

The CUDA kernel itself runs only on a card: its tests carry the ``gpu`` marker
and skip on machines without one. The JAX package is imported by a fixture, so
the card's tests also run where JAX is not installed. The kernel's arithmetic
(x and y split into TF32 hi + lo, three products) is emulated here with numpy,
so that what it keeps of float32 is tested on the CPU too.
"""

import importlib
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.kernels import similarity, similarity_cuda, similarity_ref
from repro_torch.mset import train
from repro_torch.tpss import TPSSParams, synthesize
from torch_tf32_cases import split as _split
from torch_tf32_cases import tf32 as _tf32
from torch_tf32_cases import truncating_product as _truncating_product

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
# ragged shapes for the card: n of 1, 3 and 1000 (not multiples of the kernel's 32-float
# K tile), m and b not multiples of 64 or 128
RAGGED = [(1, 1, 1), (97, 65, 3), (200, 333, 1000), (129, 191, 1), (300, 257, 3)]


def _gamma(n):
    """sqrt(2n), about the median distance between two standard-normal rows of width n,
    so that both kinds stay well away from 0 at every shape of the sweep."""
    return float(np.sqrt(2.0 * n))


def _wide_gamma(x, y):
    """At least sqrt(2n) and a third of the largest distance, so that no value of either
    kind is near 0 even at n = 1 (gaussian >= exp(-4.5))."""
    d = np.sqrt(np.maximum(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1), 0.0))
    return max(_gamma(x.shape[1]), float(d.max()) / 3)


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


# ------------------------------------------------ the kernel's arithmetic, on the CPU


def _product(x, y, terms):
    """x . y^T as the kernel forms it from the split: hi.hi alone (terms 1, one TF32
    product) or lo.hi + hi.lo + hi.hi (terms 3), every product exact and summed in
    float64 (an ideal accumulator), then rounded to float32."""
    (xh, xl), (yh, yl) = _split(x), _split(y)
    f = np.float64
    acc = xh.astype(f) @ yh.T.astype(f)
    if terms == 3:
        acc += xl.astype(f) @ yh.T.astype(f) + xh.astype(f) @ yl.T.astype(f)
    return acc.astype(np.float32)


def _epilogue(acc, x, y, gamma, kind):
    """similarity_ref's arithmetic with its x . y^T replaced by `acc`."""
    xf, yf = torch.from_numpy(x), torch.from_numpy(y)
    x2 = torch.sum(xf * xf, dim=-1)[:, None]
    y2 = torch.sum(yf * yf, dim=-1)[None, :]
    d2 = torch.clamp(x2 + y2 - 2.0 * torch.from_numpy(acc), min=0.0)
    if kind == "inverse_distance":
        return (1.0 / (1.0 + torch.sqrt(d2) / gamma)).numpy()
    return torch.exp(-d2 / (2.0 * gamma * gamma)).numpy()


def _check_conditioned(out, ref, x, y, gamma, kind):
    """`out` against the plain version `ref`, pair by pair as its conditioning allows.

    A pair is ill-conditioned in float32 when moving its d2 by eight float32 roundings of
    the norms, 8 eps (|x_i|^2 + |y_j|^2), moves its similarity by more than half the bar
    (at n of 1 or 3 with inverse_distance, pairs so close that d2 = |x|^2 + |y|^2 - 2 x.y is
    mostly rounding, where no two float32 orders of rounding agree to the bar). There
    `out` must be within the cancellation bound of float64,
    sqrt(2 (n + 1) eps (|x_i|^2 + |y_j|^2)) / gamma; at every other pair, within the bar of
    `ref`. Returns the number of ill-conditioned pairs."""
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    norms = (x64 * x64).sum(1)[:, None] + (y64 * y64).sum(1)[None, :]
    d2 = np.maximum(norms - 2 * x64 @ y64.T, 0.0)

    def h(v):
        if kind == "inverse_distance":
            return 1 / (1 + np.sqrt(v) / gamma)
        return np.exp(-v / (2 * gamma**2))

    eps = float(np.finfo(np.float32).eps)
    exact = h(d2)
    ill = np.abs(exact - h(d2 + 8 * eps * norms)) > TOL / 2
    np.testing.assert_allclose(out[~ill], ref[~ill], atol=TOL, rtol=TOL)
    bound = np.sqrt(2 * (x.shape[1] + 1) * eps * norms) / gamma
    assert (np.abs(out.astype(np.float64) - exact) <= bound)[ill].all()
    return int(ill.sum())


def _tpss_pair(seed, n_signals, n_memvec, n_obs):
    """MSET2's own operands on TPSS telemetry: the memory matrix D of a model trained on
    2 n_memvec observations, the next n_obs standardized as `estimate` does, and gamma."""
    X = synthesize(seed, TPSSParams(n_signals=n_signals, n_obs=2 * n_memvec + n_obs), "cpu")
    model = train(X[: 2 * n_memvec], n_memvec=n_memvec)
    Xs = (X[2 * n_memvec :] - model.mean) / model.std
    return model.D.numpy(), Xs.numpy(), model.gamma


@pytest.fixture(scope="module")
def tpss_256():
    return _tpss_pair(14, 256, 1024, 2000)


@pytest.fixture(scope="module")
def tpss_1024_truncated():
    D, Xs, gamma = _tpss_pair(15, 1024, 512, 1000)
    products = {tile: _truncating_product(D, Xs, tile=tile) for tile in (None, 32)}
    return D, Xs, gamma, products


def test_tf32_rounding_leaves_tf32_and_bf16_values_unchanged():
    rng = np.random.default_rng(7)
    v = (rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000)).astype(np.float32)
    t = _tf32(v)
    assert not (t.view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(_tf32(t), t)
    # to nearest: within half a TF32 spacing, 2^(e - 11) for v in [2^e, 2^(e + 1))
    half = np.ldexp(1.0, np.frexp(v.astype(np.float64))[1] - 12)
    assert (np.abs(t.astype(np.float64) - v) <= half).all()
    # bfloat16 values (7 fraction bits) are TF32 values already
    bf16 = (v.view(np.int32) & np.int32(-0x10000)).view(np.float32)
    np.testing.assert_array_equal(_tf32(bf16), bf16)
    np.testing.assert_array_equal(
        torch.from_numpy(bf16).bfloat16().float().numpy(), bf16
    )  # torch agrees that they are bfloat16 values
    # ties go away from zero; one bit under a tie goes down
    tie = np.float32(1 + 2.0**-11)
    assert _tf32(tie) == np.float32(1 + 2.0**-10) and _tf32(-tie) == -np.float32(1 + 2.0**-10)
    assert _tf32(np.nextafter(tie, np.float32(0))) == np.float32(1.0)
    # the split carries v to about 2^-22 relative
    hi, lo = _split(v)
    assert (np.abs(hi.astype(np.float64) + lo - v) <= 2.0**-22 * np.abs(v)).all()


def _split_case(x, y, gamma, kind):
    """Holds the three products at the bar; returns one product's largest error."""
    ref = similarity_ref(torch.from_numpy(x), torch.from_numpy(y), gamma, kind).numpy()
    assert ref.min() > 0.01
    three = _epilogue(_product(x, y, 3), x, y, gamma, kind)
    one = _epilogue(_product(x, y, 1), x, y, gamma, kind)
    np.testing.assert_allclose(three, ref, atol=TOL, rtol=TOL)
    return float(np.abs(one - ref).max())


@pytest.mark.parametrize("m,b,n", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_split_tf32_holds_the_bar_where_one_product_does_not(m, b, n, kind):
    x, y = _inputs(m, b, n)
    one_err = _split_case(x, y, _gamma(n), kind)
    if n in (33, 1024):
        assert one_err > TOL, one_err


@pytest.mark.parametrize("m,b,n", RAGGED)
@pytest.mark.parametrize("kind", KINDS)
def test_split_tf32_on_ragged_shapes_holds_the_conditioned_bar(m, b, n, kind):
    # the truncating accumulator, the pessimistic model; at n = 1 inverse_distance has
    # ill-conditioned pairs, held to the cancellation bound of float64 (as in chip_smoke.py)
    x, y = _inputs(m, b, n, seed=m + n)
    gamma = _wide_gamma(x, y)
    ref = similarity_ref(torch.from_numpy(x), torch.from_numpy(y), gamma, kind).numpy()
    assert ref.min() > 0.01
    out = _epilogue(_truncating_product(x, y), x, y, gamma, kind)
    n_ill = _check_conditioned(out, ref, x, y, gamma, kind)
    assert n_ill == 0 or (kind == "inverse_distance" and n <= 3)


@pytest.mark.parametrize("kind", KINDS)
def test_split_tf32_holds_the_bar_on_tpss_telemetry(tpss_256, kind):
    D, Xs, gamma = tpss_256
    one_err = _split_case(D, Xs, gamma, kind)
    assert one_err > TOL, one_err


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tile", [None, 32], ids=["one-accumulator", "promoted"])
def test_split_tf32_with_a_truncating_accumulator_on_tpss(tpss_1024_truncated, kind, tile):
    # how close a float32 adder that truncates after each 8-deep step comes to the bar
    # (about 3e-6 with one accumulator), and how far promoting each 32-deep K tile into a
    # sum rounded to nearest takes it back (the kernel's design: about 1e-7)
    D, Xs, gamma, products = tpss_1024_truncated
    ref = similarity_ref(torch.from_numpy(D), torch.from_numpy(Xs), gamma, kind).numpy()
    out = _epilogue(products[tile], D, Xs, gamma, kind)
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=TOL)
    if tile:
        np.testing.assert_allclose(out, ref, atol=TOL / 10, rtol=TOL / 10)


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


@pytest.mark.gpu
@pytest.mark.parametrize("m,b,n", RAGGED)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_version_on_ragged_shapes(cuda, m, b, n, dtype, kind):
    x, y = _inputs(m, b, n, seed=m + n)
    tx = torch.from_numpy(x).to(cuda, getattr(torch, dtype))
    ty = torch.from_numpy(y).to(cuda, getattr(torch, dtype))
    gamma = _wide_gamma(tx.float().cpu().numpy(), ty.float().cpu().numpy())
    before = sim_module.launches
    out = similarity(tx, ty, gamma=gamma, kind=kind)
    torch.cuda.synchronize()
    assert sim_module.launches == before + 1
    ref = similarity_ref(tx, ty, gamma, kind)
    assert float(ref.min()) > 0.01
    xs, ys = (t.float().cpu().numpy() for t in (tx, ty))
    _check_conditioned(out.cpu().numpy(), ref.cpu().numpy(), xs, ys, gamma, kind)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_splits_y_is_x_once_and_gives_a_copys_result(cuda, dtype):
    x, _ = _inputs(300, 1, 70, seed=4)
    D = torch.from_numpy(x).to(cuda, getattr(torch, dtype))
    gamma = _gamma(70)
    before = sim_module.launches
    same, copy = similarity(D, D, gamma=gamma), similarity(D, D.clone(), gamma=gamma)
    assert sim_module.launches == before + 2
    assert torch.equal(same, copy)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_on_tpss_telemetry_against_float64(cuda, tpss_256, kind):
    # MSET2's own operands; the kernel may be no further from float64 than the plain
    # float32 version is, plus the bar
    D, Xs = (torch.from_numpy(a).to(cuda) for a in tpss_256[:2])
    gamma = tpss_256[2]
    D64, X64 = D.double(), Xs.double()
    d2 = ((D64 * D64).sum(1)[:, None] + (X64 * X64).sum(1)[None, :] - 2 * D64 @ X64.T).clamp(0)
    if kind == "inverse_distance":
        exact = 1 / (1 + d2.sqrt() / gamma)
    else:
        exact = torch.exp(-d2 / (2 * gamma * gamma))
    kernel_err = float((similarity(D, Xs, gamma=gamma, kind=kind).double() - exact).abs().max())
    plain_err = float((similarity_ref(D, Xs, gamma, kind).double() - exact).abs().max())
    assert kernel_err <= plain_err + TOL, (kernel_err, plain_err)
