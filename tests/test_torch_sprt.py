"""The SPRT recursion's op (``repro_torch.kernels.sprt``) on the CPU, held against
the JAX package's ``lax.scan`` (``repro.mset.sprt.sprt``).

On the CPU the op runs its plain version; the CUDA kernel (K3) is held against
that plain version bit for bit on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax.numpy as jnp

from repro.mset.sprt import SPRTParams as JaxSPRTParams
from repro.mset.sprt import sprt as jax_sprt
from repro_torch.kernels import sprt_scan
from repro_torch.mset import SPRTParams, sprt

sprt_ops = importlib.import_module("repro_torch.kernels.sprt.ops")
sprt_module = importlib.import_module("repro_torch.kernels.sprt.sprt")

# (alpha, beta, m_shift): tests/test_torch_mset.py's parity cases
PARAMS = [(1e-3, 1e-3, 3.0), (1e-2, 1e-3, 4.0), (0.05, 0.1, 2.0)]


def _inputs(m_shift, T=3000, n=6, nan_at=None):
    rng = np.random.default_rng(int(m_shift * 10))
    r = rng.standard_normal((T, n)).astype(np.float32)
    r[T // 2 :, 2] += 3.0
    r[2 * T // 3 :, 4] -= 2.5
    if nan_at is not None:
        r[nan_at] = np.nan
    sigma = rng.uniform(0.8, 1.2, n).astype(np.float32)
    mu = rng.uniform(-0.1, 0.1, n).astype(np.float32)
    return r, sigma, mu


def _scan(r, sigma, mu, p, impl):
    t = torch.from_numpy
    return sprt_scan(
        t(r),
        t(sigma),
        None if mu is None else t(mu),
        m_shift=p.m_shift,
        upper=p.upper,
        lower=p.lower,
        impl=impl,
    )


def _check(got, want):
    """test_torch_mset.py's bar: identical alarms, the LLRs within 1e-4 + 1e-5|x|
    (a NaN only where the reference has one)."""
    (a, sp, sn), (a_ref, sp_ref, sn_ref) = got, want
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sp_ref), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(sn.numpy(), np.asarray(sn_ref), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("with_mu", [True, False])
@pytest.mark.parametrize("alpha,beta,m_shift", PARAMS)
def test_plain_scan_matches_reference(alpha, beta, m_shift, with_mu):
    r, sigma, mu = _inputs(m_shift)
    mu = mu if with_mu else None
    jp, p = JaxSPRTParams(alpha, beta, m_shift), SPRTParams(alpha, beta, m_shift)
    want = jax_sprt(jnp.asarray(r), jnp.asarray(sigma), jp, mu=mu)
    got = _scan(r, sigma, mu, p, "ref")
    _check(got, want)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.float32
    assert got[0].numpy()[1500:, 2].any()


def test_nan_residual_propagates_as_in_reference():
    """A NaN residual makes its signal's sums NaN from then on in both packages
    (the clamp keeps a NaN), with no alarm; the other signals are untouched."""
    r, sigma, mu = _inputs(3.0, T=400, nan_at=(150, 1))
    p = SPRTParams()
    want = jax_sprt(jnp.asarray(r), jnp.asarray(sigma), JaxSPRTParams(), mu=jnp.asarray(mu))
    got = _scan(r, sigma, mu, p, "ref")
    _check(got, want)
    a, sp, sn = got
    assert bool(torch.isnan(sp[150:, 1]).all()) and bool(torch.isnan(sn[150:, 1]).all())
    assert not bool(a[150:, 1].any())
    assert bool(torch.isfinite(sp[:, [0, 2, 3, 4, 5]]).all())


def test_llrs_are_views_of_one_interleaved_array():
    r, sigma, mu = _inputs(3.0, T=50)
    _, sp, sn = _scan(r, sigma, mu, SPRTParams(), "ref")
    assert sp.stride() == (12, 1) and sn.stride() == (12, 1)
    assert sn.data_ptr() - sp.data_ptr() == 6 * 4


def test_mset_sprt_is_the_op():
    r, sigma, mu = _inputs(4.0)
    p = SPRTParams(m_shift=4.0)
    t = torch.from_numpy
    for x, y in zip(sprt(t(r), t(sigma), p, mu=t(mu)), _scan(r, sigma, mu, p, "ref")):
        assert torch.equal(x, y)


def test_auto_takes_the_plain_version_on_the_cpu(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("the CUDA kernel was asked for a CPU tensor")

    monkeypatch.setattr(sprt_ops, "sprt_cuda", no_kernel)
    r, sigma, mu = _inputs(2.0, T=200)
    before = sprt_module.launches
    want = _scan(r, sigma, mu, SPRTParams(), "ref")
    for x, y in zip(_scan(r, sigma, mu, SPRTParams(), "auto"), want):
        assert torch.equal(x, y)
    assert sprt_module.launches == before


def test_cuda_on_a_cpu_tensor_raises():
    r, sigma, mu = _inputs(2.0, T=20)
    before = sprt_module.launches
    with pytest.raises(ValueError, match="CUDA device"):
        _scan(r, sigma, mu, SPRTParams(), "cuda")
    with pytest.raises(ValueError, match="unknown sprt impl"):
        _scan(r, sigma, mu, SPRTParams(), "triton")
    assert sprt_module.launches == before


@pytest.mark.parametrize("T,n", [(1, 5), (0, 3), (7, 1)])
def test_ragged_and_empty_shapes(T, n):
    rng = np.random.default_rng(T * 10 + n)
    r = (3.0 * rng.standard_normal((T, n))).astype(np.float32)
    sigma = np.ones(n, np.float32)
    want = jax_sprt(jnp.asarray(r), jnp.asarray(sigma), JaxSPRTParams())
    got = _scan(r, sigma, None, SPRTParams(), "ref")
    assert got[0].shape == (T, n) and got[1].shape == (T, n)
    _check(got, want)
