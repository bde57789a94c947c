"""TPSS — Telemetry Parameter Synthesis System (paper refs [7-9]).

Synthesizes dense-sensor IoT telemetry that matches real signals in the statistics
that matter to ML prognostics (paper §II.C):

* serial correlation   — AR(2) innovations + deterministic harmonics (duty cycles)
* cross correlation    — signals mixed through a random low-rank + diagonal loading
                         matrix (Cholesky of a valid correlation matrix)
* stochastic content   — per-signal variance; skew/kurtosis shaped with a
                         sinh-arcsinh transform

Two steps: ``draw`` takes every random number from a ``torch.Generator``, and
``synthesize_from_draws`` is the deterministic transform. ``torch.Generator``
cannot reproduce ``jax.random``'s bits, so the transform is what is held against
the JAX package, fed with the same draws.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch._device import resolve_device

F32 = torch.float32


@dataclass(frozen=True)
class TPSSParams:
    n_signals: int
    n_obs: int
    ar1: float = 0.85  # AR(2) coefficients (stable: ar1+ar2<1)
    ar2: float = -0.10
    n_harmonics: int = 3
    harmonic_amp: float = 0.6
    cross_rank: int = 4  # rank of the shared latent factors
    cross_weight: float = 0.5  # 0 = independent, 1 = fully shared
    skew: float = 0.15  # sinh-arcsinh skew parameter (0 = symmetric)
    tailweight: float = 1.05  # sinh-arcsinh tail weight (1 = gaussian kurtosis)
    mean_scale: float = 10.0
    std_scale: float = 1.0


@dataclass(frozen=True)
class TPSSDraws:
    """Every random number one synthesis uses; leading dims are batch dims."""

    eps_own: torch.Tensor  # (..., n_obs, n_signals) AR(2) innovations per signal
    eps_lat: torch.Tensor  # (..., n_obs, cross_rank) AR(2) innovations of latent factors
    mix: torch.Tensor  # (..., cross_rank, n_signals) standard normal loadings
    freqs: torch.Tensor  # (..., n_harmonics, n_signals) in [4 pi / n_obs, 2 pi / 64)
    phase: torch.Tensor  # (..., n_harmonics, n_signals) in [0, 2 pi)
    mean: torch.Tensor  # (..., n_signals) standard normal
    std: torch.Tensor  # (..., n_signals) standard normal


def _generator(seed, device: torch.device) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        if seed.device.type != device.type:
            raise ValueError(f"generator is on {seed.device}, synthesis on {device}")
        return seed
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def draw(seed, p: TPSSParams, batch: tuple = (), device=None) -> TPSSDraws:
    """Draw the random inputs of ``batch`` syntheses; ``seed`` is an int or a Generator."""
    dev = resolve_device(device)
    g = _generator(seed, dev)

    def normal(*shape):
        return torch.randn(*batch, *shape, generator=g, device=dev, dtype=F32)

    def uniform(lo, hi, *shape):
        u = torch.rand(*batch, *shape, generator=g, device=dev, dtype=F32)
        return u * (hi - lo) + lo

    nh, ns = p.n_harmonics, p.n_signals
    return TPSSDraws(
        eps_own=normal(p.n_obs, ns),
        eps_lat=normal(p.n_obs, p.cross_rank),
        mix=normal(p.cross_rank, ns),
        freqs=uniform(2 * math.pi / p.n_obs * 2, 2 * math.pi / 64, nh, ns),
        phase=uniform(0.0, 2 * math.pi, nh, ns),
        mean=normal(ns),
        std=normal(ns),
    )


def _ar2(eps: torch.Tensor, a1: float, a2: float) -> torch.Tensor:
    """y[t] = a1 y[t-1] + a2 y[t-2] + eps[t] along dim -2, normalized to unit variance.

    A loop over time on the tensors' device: two launches a step, written into one
    buffer whose first two rows are the zero initial state.
    """
    *lead, n_obs, n_series = eps.shape
    ys = torch.zeros(*lead, n_obs + 2, n_series, dtype=F32, device=eps.device)
    for t in range(n_obs):
        torch.add(eps[..., t, :], ys[..., t + 1, :], alpha=a1, out=ys[..., t + 2, :])
        ys[..., t + 2, :].add_(ys[..., t, :], alpha=a2)
    # normalize to unit variance (theoretical AR(2) variance)
    denom = (1 + a2) * ((1 - a2) ** 2 - a1**2) / (1 - a2)
    std = math.sqrt(1.0 / max(denom, 1e-6))
    return ys[..., 2:, :] / std


def _sinh_arcsinh(x, skew: float, tail: float):
    """Jones-Pewsey sinh-arcsinh: shapes skewness/kurtosis, identity at (0, 1)."""
    return torch.sinh(tail * torch.asinh(x) + skew)


def synthesize_from_draws(d: TPSSDraws, p: TPSSParams) -> torch.Tensor:
    """The deterministic transform: draws -> (..., n_obs, n_signals) telemetry."""
    # serially-correlated stochastic content: own AR(2) + shared latent AR(2),
    # run as one recursion over the concatenated series
    both = _ar2(torch.cat([d.eps_own, d.eps_lat], dim=-1), p.ar1, p.ar2)
    own, lat = both[..., : p.n_signals], both[..., p.n_signals :]
    mix = d.mix / torch.linalg.vector_norm(d.mix, dim=-2, keepdim=True)
    shared = lat @ mix
    w = p.cross_weight
    noise = math.sqrt(1 - w * w) * own + w * shared

    # deterministic harmonics (mission/duty cycles), summed in the reference's order
    t = torch.arange(p.n_obs, dtype=F32, device=own.device)[:, None]
    harm = torch.zeros_like(own)
    for h in range(p.n_harmonics):
        harm = harm + torch.sin(t * d.freqs[..., h, None, :] + d.phase[..., h, None, :])
    harm = harm * (p.harmonic_amp / max(p.n_harmonics, 1))

    x = _sinh_arcsinh(noise, p.skew, p.tailweight) + harm

    mean = d.mean * p.mean_scale
    std = torch.exp(d.std * 0.3) * p.std_scale
    return x * std[..., None, :] + mean[..., None, :]


def synthesize(seed, p: TPSSParams, device=None) -> torch.Tensor:
    """Return (n_obs, n_signals) synthesized telemetry; ``seed`` is an int or a Generator."""
    return synthesize_from_draws(draw(seed, p, device=device), p)


def synthesize_batch(seed, p: TPSSParams, n_assets: int, device=None) -> torch.Tensor:
    """(n_assets, n_obs, n_signals) — a fleet of similar-but-distinct assets."""
    return synthesize_from_draws(draw(seed, p, batch=(n_assets,), device=device), p)


def inject_anomaly(x, start: int, signal: int, drift_per_step: float):
    """Additive ramp drift on one signal from `start` (classic incipient fault)."""
    t = torch.arange(x.shape[0], dtype=F32, device=x.device)
    ramp = torch.where(t >= start, (t - start) * drift_per_step, 0.0)
    out = x.clone()
    out[:, signal] += ramp
    return out
