"""The port's SSD block (``repro_torch.models.mamba``) against the JAX package's
``models/mamba.py`` on the CPU: the chunked scan (against ``repro`` and a naive
per-step recurrence), the causal conv, and the block in its three modes.

Inputs are numpy draws from a seed; float32 throughout, held at 1e-4.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.distributed import make_rules
from repro.models import mamba as jax_mamba
from repro_torch.configs import get_config
from repro_torch.models import mamba

RULES = make_rules(None)
TOL = 1e-4


def _cfgs(**kw):
    kw.setdefault("dtype", "float32")
    return (
        get_config("mamba2-130m", smoke=True).replace(**kw),
        jax_get_config("mamba2-130m", smoke=True).replace(**kw),
    )


def _scan_inputs(B, S, H, P, G, N, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))  # softplus
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, S, G, N)) * 0.5
    Cm = rng.standard_normal((B, S, G, N)) * 0.5
    return [a.astype(np.float32) for a in (xh, dt, A, Bm, Cm)]


def _naive(xh, dt, A, Bm, Cm):
    """tests/test_property.py:13's O(S·N·P) recurrence, in float64 numpy."""
    B, S, H, P = xh.shape
    rep = H // Bm.shape[2]
    Bh, Ch = np.repeat(Bm, rep, axis=2), np.repeat(Cm, rep, axis=2)
    state = np.zeros((B, H, Bm.shape[3], P))
    ys = []
    for t in range(S):
        dA = np.exp(dt[:, t] * A[None, :])
        upd = np.einsum("bh,bhn,bhp->bhnp", dt[:, t], Bh[:, t], xh[:, t])
        state = state * dA[..., None, None] + upd
        ys.append(np.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    return np.stack(ys, axis=1), state


# (S, chunk, H, G, N): chunks that divide S, that do not (padded with dt = 0), one
# chunk, and groups shared by several heads
SCANS = [
    (32, 8, 4, 1, 8),
    (37, 8, 4, 1, 8),
    (40, 16, 4, 2, 4),
    (5, 16, 2, 1, 4),
    (64, 64, 8, 2, 16),
]


@pytest.mark.parametrize("S, chunk, H, G, N", SCANS)
def test_ssd_chunked_matches_reference_and_naive(S, chunk, H, G, N):
    port, ref = _cfgs(ssd_chunk=chunk)
    inputs = _scan_inputs(2, S, H, 8, G, N, seed=S + chunk)
    jy, js = jax_mamba.ssd_chunked(ref, *map(jnp.asarray, inputs))
    ty, ts = mamba.ssd_chunked(port, *map(torch.from_numpy, inputs))
    assert ts.shape == (2, H, N, 8) and ts.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL, rtol=TOL)
    ny, ns = _naive(*[a.astype(np.float64) for a in inputs])
    # tests/test_property.py:51's bar for the chunked algorithm against the recurrence
    np.testing.assert_allclose(ty.numpy(), ny, atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(ts.numpy(), ns, atol=2e-4, rtol=2e-3)


def test_ssd_chunked_from_an_initial_state():
    port, ref = _cfgs(ssd_chunk=8)
    inputs = _scan_inputs(2, 20, 4, 8, 1, 8, seed=9)
    s0 = np.random.default_rng(10).standard_normal((2, 4, 8, 8)).astype(np.float32)
    jy, js = jax_mamba.ssd_chunked(ref, *map(jnp.asarray, inputs), init_state=jnp.asarray(s0))
    ty, ts = mamba.ssd_chunked(
        port, *map(torch.from_numpy, inputs), init_state=torch.from_numpy(s0)
    )
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=TOL, rtol=TOL)


def test_ssd_chunked_is_finite_with_long_decays():
    """Large dt·|A| over a chunk of 128: the upper triangle's exponents would overflow
    if they were not zeroed before exp."""
    port, _ = _cfgs(ssd_chunk=128)
    xh, dt, A, Bm, Cm = _scan_inputs(1, 256, 2, 8, 1, 4, seed=11)
    y, s = mamba.ssd_chunked(port, *map(torch.from_numpy, (xh, dt * 20, A * 10, Bm, Cm)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


def _ssd_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, din, H = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    cch = mamba.conv_channels(cfg)
    proj = 2 * din + 2 * cfg.ssm_ngroups * cfg.ssm_state + H
    p = {
        "w_in": rng.standard_normal((d, proj)) / np.sqrt(d),
        "conv_w": rng.standard_normal((cfg.conv_width, cch)) / 2,
        "conv_b": rng.standard_normal(cch) * 0.1,
        "A_log": np.log(rng.uniform(1, 16, H)),
        "D": 1 + rng.standard_normal(H) * 0.1,
        "dt_bias": np.log(np.expm1(np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H)))),
        "norm": 1 + rng.standard_normal(din) * 0.1,
        "w_out": rng.standard_normal((din, d)) / np.sqrt(din),
    }
    return {n: a.astype(np.float32) for n, a in p.items()}


def test_causal_conv_matches_reference():
    port, ref = _cfgs()
    p = _ssd_params(port)
    xbc = np.random.default_rng(1).standard_normal((2, 19, mamba.conv_channels(port)))
    xbc = xbc.astype(np.float32)
    want = jax_mamba._causal_conv(ref, {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(xbc))
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    got = mamba._causal_conv(port, tp, torch.from_numpy(xbc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("S", [16, 21])
def test_apply_ssd_matches_reference_in_every_mode(S):
    """No cache; prefill with its cache (the last W - 1 pre-conv inputs and the final
    state); then two decode steps from that cache, updated in place."""
    port, ref = _cfgs(ssd_chunk=8)
    p = _ssd_params(port, seed=S)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    x = np.random.default_rng(S).standard_normal((2, S + 2, port.d_model)).astype(np.float32)

    jy, jc = jax_mamba.apply_ssd(ref, jp, jnp.asarray(x[:, :S]), RULES)
    ty, tc = mamba.apply_ssd(port, tp, torch.from_numpy(x[:, :S]))
    assert jc is None and tc is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)

    jy, jc = jax_mamba.apply_ssd(ref, jp, jnp.asarray(x[:, :S]), RULES, cache={})
    cache = {n: torch.zeros(sh, dtype=dt) for n, (sh, dt) in mamba.cache_spec(port, 2).items()}
    ty, tc = mamba.apply_ssd(port, tp, torch.from_numpy(x[:, :S]), cache=cache)
    assert tc is cache
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
    for name in ("conv", "state"):
        assert cache[name].shape == jc[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]), atol=TOL, rtol=TOL)

    for t in (S, S + 1):
        jy, jc = jax_mamba.apply_ssd(ref, jp, jnp.asarray(x[:, t : t + 1]), RULES, cache=jc, pos=t)
        ty, _ = mamba.apply_ssd(port, tp, torch.from_numpy(x[:, t : t + 1]), cache=cache, pos=t)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=TOL)
        for name in ("conv", "state"):
            want = np.asarray(jc[name])
            np.testing.assert_allclose(cache[name].numpy(), want, atol=TOL, rtol=TOL)


def test_cache_spec_matches_reference():
    for arch in ("mamba2-130m", "jamba-v0.1-52b"):
        for smoke in (True, False):
            port = get_config(arch, smoke=smoke)
            want = jax_mamba.cache_spec(jax_get_config(arch, smoke=smoke), 3)
            for name, (shape, dtype) in mamba.cache_spec(port, 3).items():
                spec = want[name].value
                assert shape == spec.shape and str(dtype)[6:] == str(spec.dtype), name
            assert mamba.conv_channels(port) == jax_mamba.conv_channels(port)


def test_ssd_module_holds_float32_masters():
    """conv_w is read in float32 at decode and in the working dtype at prefill (and D
    likewise), so the bf16 module keeps them, and the other small vectors, in float32."""
    cfg = get_config("mamba2-130m", smoke=True)
    ssd = mamba.SSD(cfg, "cpu")
    ssd.reset_parameters(torch.Generator().manual_seed(0))
    assert ssd.w_in.dtype == ssd.w_out.dtype == torch.bfloat16
    for name in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm"):
        assert getattr(ssd, name).dtype == torch.float32, name
    x = torch.randn(2, 9, cfg.d_model, generator=torch.Generator().manual_seed(1)).bfloat16()
    y, _ = ssd(x)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and torch.isfinite(y.float()).all()

