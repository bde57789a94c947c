"""The SPRT recursion's op (``repro_torch.kernels.sprt``) on the CPU, held against
the JAX package's ``lax.scan`` (``repro.mset.sprt.sprt``).

On the CPU the op runs its plain version; the CUDA kernel (K3) is held against
that plain version bit for bit on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``). The kernel's algorithm, a chunked scan with a fix-up pass, is
modelled in plain torch by ``sprt_chunked_ref`` and held here bit for bit against
the plain loop and the JAX package on the cases of ``torch_sprt_cases.py``.
"""

import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax.numpy as jnp

from repro.mset.sprt import SPRTParams as JaxSPRTParams
from repro.mset.sprt import sprt as jax_sprt
from repro_torch.kernels import sprt_chunked_ref, sprt_ref, sprt_scan
from repro_torch.mset import SPRTParams, sprt
from torch_sprt_cases import CASES, CHUNKS, case_inputs, chunked_params

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


# ------------------------------------------------ the chunked scan's model


def _bits(x):
    return np.ascontiguousarray(x).view(np.int32)


@functools.lru_cache(maxsize=None)
def _chunk_case(name):
    """The case's torch inputs, the plain loop's outputs and the JAX package's."""
    r, sigma, mu = case_inputs(name)
    p = SPRTParams()
    t = torch.from_numpy
    args = [t(r), t(sigma), None if mu is None else t(mu)]
    plain = sprt_ref(*args, p.m_shift, p.upper, p.lower)
    jmu = None if mu is None else jnp.asarray(mu)
    jax_out = jax_sprt(jnp.asarray(r), jnp.asarray(sigma), JaxSPRTParams(), mu=jmu)
    return args, plain, [np.asarray(x) for x in jax_out]


@pytest.mark.parametrize("name,chunk", chunked_params())
def test_chunked_model_equals_the_plain_loop_and_reference_bit_for_bit(name, chunk):
    args, plain, (a_jax, sp_jax, sn_jax) = _chunk_case(name)
    T, n = args[0].shape
    L = CHUNKS[chunk](T)
    p = SPRTParams()
    a, sp, sn, reruns = sprt_chunked_ref(*args, p.m_shift, p.upper, p.lower, L)
    assert a.dtype == torch.bool and a.shape == (T, n)
    assert sp.stride() == plain[1].stride() and sn.stride() == plain[2].stride()
    assert torch.equal(a, plain[0])
    np.testing.assert_array_equal(a.numpy(), a_jax)
    for x, y, z in ((sp, plain[1], sp_jax), (sn, plain[2], sn_jax)):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(z))
    C = -(-T // min(L, T))
    assert reruns.shape == (C, n) and reruns.dtype == torch.int64
    assert not bool(reruns[0].any())  # the first chunk starts from the true start
    if L >= T:
        assert C == 1
    lengths = torch.tensor([min(L, T - c * L) for c in range(C)])
    assert bool((reruns <= lengths[:, None]).all())
    if CASES[name][3] == "pathological":
        # the guessed trajectory keeps its own phase: every later chunk is re-run whole
        assert torch.equal(reruns[1:], lengths[1:, None].expand(C - 1, n))


def test_chunked_model_rewrites_after_a_nan_to_the_end():
    """A NaN sum never meets a finite one: from the chunk after a NaN on, its signal
    is re-run to the end of every chunk; the NaN's own chunk is re-run up to it only
    where pass 1 had not met the true trajectory before it."""
    args, plain, _ = _chunk_case("nan-at-chunk-edges")
    p = SPRTParams()
    L = 64
    *out, reruns = sprt_chunked_ref(*args, p.m_shift, p.upper, p.lower, L)
    T = args[0].shape[0]
    for t_nan, j in ((448, 1), (447, 2)):
        first = t_nan // L + 1
        whole = torch.tensor([min(L, T - c * L) for c in range(first, reruns.shape[0])])
        assert torch.equal(reruns[first:, j], whole)
        assert bool(torch.isnan(out[1][t_nan:, j]).all())
    assert torch.equal(out[0], plain[0])
    for x, y in zip(out[1:], plain[1:]):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def test_chunked_model_needs_few_reruns_on_gaussian_residuals():
    """Under no shift the clamp at ``lower`` makes a chunk forget its start within a
    few steps: the re-run steps are a small share of the chunks after the first."""
    args, plain, _ = _chunk_case("gauss")
    p = SPRTParams()
    *_, reruns = sprt_chunked_ref(*args, p.m_shift, p.upper, p.lower, 64)
    assert int(reruns.max()) <= 8 and float(reruns[1:].float().mean()) < 2.0


def test_chunk_length_fills_the_card():
    L = sprt_module.chunk_length
    # 132 SMs: 33 chunks of 1986 steps at the full-width cell, 33 x 1024 >= 132 x 256 threads
    assert L(65536, 1024, 132) == 1986 and -(-65536 // 1986) * 1024 >= 132 * 256
    # one chunk when the signals alone fill the card, or T is short
    assert L(65536, 200_000, 132) == 65536
    assert L(200, 8, 132) == 200
    assert L(1, 1024, 132) == 1
    for T, n in ((1_048_576, 32), (4099, 1000), (2049, 65), (65536, 1024)):
        steps = L(T, n, 132)
        assert sprt_module.MIN_CHUNK <= steps <= T
        assert -(-T // steps) * n >= 132 * 256 or steps == sprt_module.MIN_CHUNK


def test_sprt_cuda_checks_chunk_and_reruns_before_launching():
    r, sigma, mu = (torch.from_numpy(x) for x in _inputs(2.0, T=20))
    before = sprt_module.launches
    with pytest.raises(ValueError, match="CUDA device"):
        sprt_module.sprt_cuda(r, sigma, mu, 3.0, 6.9, -6.9, chunk=4)
    with pytest.raises(ValueError, match="CUDA device"):
        counter = torch.zeros(2, dtype=torch.int64)
        sprt_module.sprt_cuda(r, sigma, mu, 3.0, 6.9, -6.9, reruns=counter)
    with pytest.raises(ValueError, match="chunk must be >= 1"):
        sprt_chunked_ref(r, sigma, mu, 3.0, 6.9, -6.9, 0)
    assert sprt_module.launches == before
