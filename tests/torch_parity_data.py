"""Telemetry for the port's tests, made with numpy from a seed (no torch, no jax)."""

import numpy as np


def telemetry(seed, n_obs, n_signals):
    """Cross-correlated, serially correlated float32 telemetry with per-signal offsets."""
    rng = np.random.default_rng(seed)
    lat = np.cumsum(rng.standard_normal((n_obs, 3)), 0) * 0.1
    t = np.arange(n_obs)[:, None]
    X = lat @ rng.standard_normal((3, n_signals))
    X += np.sin(t * rng.uniform(0.01, 0.1, n_signals)) + 0.3 * rng.standard_normal(X.shape)
    return (X * rng.uniform(0.5, 2, n_signals) + 10 * rng.standard_normal(n_signals)).astype(
        np.float32
    )


# (seed, n_signals, n_obs, n_memvec) whose memory vectors, chosen from the first 75%
# of the observations, are all distinct, so G is well conditioned (ROADMAP, R3).
WELL_POSED = [(4, 8, 1024, 64), (5, 6, 768, 48), (9, 4, 512, 32)]
