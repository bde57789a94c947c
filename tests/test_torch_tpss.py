"""The port's TPSS synthesis against the JAX package's.

``torch.Generator`` cannot reproduce ``jax.random``'s bits, so the deterministic
transform is fed jax's own draws and compared; the port's own draws are checked
for the statistics the paper says matter (serial correlation, cross-correlation,
moments), as tests/test_tpss.py checks the reference's.
"""

import functools
import math

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference the port is held against

import jax
import jax.numpy as jnp
import numpy as np

from repro import tpss as jtpss
from repro_torch.tpss import (
    TPSSDraws,
    TPSSParams,
    inject_anomaly,
    synthesize,
    synthesize_batch,
    synthesize_from_draws,
)

CPU = "cpu"
# The AR(2) recursion and the harmonics are summed in another order (and XLA may
# contract multiply-adds), so the telemetry agrees to float32 rounding of values
# of order mean_scale = 10, not bit for bit.
ATOL, RTOL = 2e-5, 2e-6


# jit: the reference runs op by op otherwise, several times slower on the CPU
_jax_synthesize = jax.jit(jtpss.synthesize, static_argnums=1)
_jax_synthesize_batch = jax.jit(jtpss.synthesize_batch, static_argnums=(1, 2))


@functools.partial(jax.jit, static_argnums=1)
def _jax_draws_jit(key, p):
    """The random inputs repro.tpss.synthesize draws from ``key``, in its order."""
    F32 = jnp.float32
    k_ar, k_lat, k_mix, k_phase, k_freq, k_mean, k_std = jax.random.split(key, 7)
    nh, ns = p.n_harmonics, p.n_signals
    arrays = dict(
        eps_own=jax.random.normal(k_ar, (p.n_obs, ns), F32),
        eps_lat=jax.random.normal(k_lat, (p.n_obs, p.cross_rank), F32),
        mix=jax.random.normal(k_mix, (p.cross_rank, ns), F32),
        freqs=jax.random.uniform(
            k_freq, (nh, ns), F32, 2 * math.pi / p.n_obs * 2, 2 * math.pi / 64
        ),
        phase=jax.random.uniform(k_phase, (nh, ns), F32, 0, 2 * math.pi),
        mean=jax.random.normal(k_mean, (ns,), F32),
        std=jax.random.normal(k_std, (ns,), F32),
    )
    return arrays


def _jax_draws(key, p):
    return {k: np.asarray(v) for k, v in _jax_draws_jit(key, p).items()}


def _torch_draws(arrays):
    return TPSSDraws(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


def _jparams(p):
    return jtpss.TPSSParams(**p.__dict__)


@pytest.mark.parametrize(
    "fields",
    [
        dict(n_signals=8, n_obs=512),
        dict(n_signals=16, n_obs=256, skew=0.5, tailweight=1.4, cross_weight=0.9),
        dict(n_signals=3, n_obs=300, ar1=0.9, ar2=-0.05, cross_rank=2, n_harmonics=0, mean_scale=0),
    ],
)
def test_transform_on_jax_draws_matches_reference(fields):
    p = TPSSParams(**fields)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(_jax_synthesize(key, _jparams(p)))
    out = synthesize_from_draws(_torch_draws(_jax_draws(key, p)), p).numpy()
    assert out.shape == (p.n_obs, p.n_signals) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_batched_transform_matches_reference_batch():
    p = TPSSParams(n_signals=6, n_obs=200)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(_jax_synthesize_batch(key, _jparams(p), 3))
    per_asset = [_jax_draws(k, p) for k in jax.random.split(key, 3)]
    stacked = {k: np.stack([d[k] for d in per_asset]) for k in per_asset[0]}
    out = synthesize_from_draws(_torch_draws(stacked), p).numpy()
    assert out.shape == (3, 200, 6)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_inject_anomaly_matches_reference():
    x = np.random.default_rng(0).standard_normal((300, 4)).astype(np.float32)
    x0 = x.copy()
    ref = np.asarray(jtpss.inject_anomaly(jnp.asarray(x), 120, 2, 0.03))
    out = inject_anomaly(torch.from_numpy(x), start=120, signal=2, drift_per_step=0.03)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
    assert np.array_equal(x, x0)  # input left as it was
    np.testing.assert_array_equal(out.numpy()[:120], x[:120])


def test_own_draws_shapes_and_determinism():
    p = TPSSParams(n_signals=8, n_obs=512)
    a = synthesize(7, p, device=CPU).numpy()
    b = synthesize(7, p, device=CPU).numpy()
    c = synthesize(8, p, device=CPU).numpy()
    g = torch.Generator().manual_seed(7)
    d = synthesize(g, p, device=CPU).numpy()
    assert a.shape == (512, 8)
    assert np.array_equal(a, b) and np.array_equal(a, d)
    assert not np.array_equal(a, c)
    batch = synthesize_batch(7, p, 3, device=CPU).numpy()
    assert batch.shape == (3, 512, 8)
    assert not np.array_equal(batch[0], batch[1])


def test_own_draws_serial_correlation():
    p = TPSSParams(n_signals=4, n_obs=4096, ar1=0.9, ar2=-0.05, harmonic_amp=0.0)
    x = synthesize(1, p, device=CPU).numpy()
    x = (x - x.mean(0)) / x.std(0)
    lag1 = np.mean([np.corrcoef(x[:-1, i], x[1:, i])[0, 1] for i in range(4)])
    # AR(2) lag-1 autocorrelation is a1 / (1 - a2) = 0.857 before the sinh-arcsinh
    assert 0.75 < lag1 < 0.95, lag1


def test_own_draws_cross_correlation():
    base = dict(n_signals=6, n_obs=4096, harmonic_amp=0.0)
    x_ind = synthesize(2, TPSSParams(**base, cross_weight=0.0), device=CPU).numpy()
    x_cor = synthesize(2, TPSSParams(**base, cross_weight=0.9, cross_rank=1), device=CPU).numpy()

    def mean_offdiag(x):
        c = np.corrcoef(x.T)
        return np.abs(c[~np.eye(len(c), dtype=bool)]).mean()

    assert mean_offdiag(x_ind) < 0.15
    assert mean_offdiag(x_cor) > mean_offdiag(x_ind) + 0.2


def _skew(x):
    x = x - x.mean(0)
    return (np.mean(x**3, 0) / np.mean(x**2, 0) ** 1.5).mean()


def _kurt(x):
    x = x - x.mean(0)
    return (np.mean(x**4, 0) / np.mean(x**2, 0) ** 2).mean()


def test_own_draws_moments():
    base = dict(
        n_signals=4, n_obs=8192, harmonic_amp=0.0, mean_scale=0.0, std_scale=1.0, cross_weight=0.0
    )
    x_sym = synthesize(3, TPSSParams(**base, skew=0.0, tailweight=1.0), device=CPU).numpy()
    x_skw = synthesize(3, TPSSParams(**base, skew=0.5, tailweight=1.0), device=CPU).numpy()
    x_hvy = synthesize(3, TPSSParams(**base, skew=0.0, tailweight=1.4), device=CPU).numpy()
    assert abs(_skew(x_sym)) < 0.25
    assert abs(_kurt(x_sym) - 3.0) < 0.5  # gaussian kurtosis at the identity transform
    assert _skew(x_skw) > _skew(x_sym) + 0.4
    assert _kurt(x_hvy) > _kurt(x_sym) + 0.8
