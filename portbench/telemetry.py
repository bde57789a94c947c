"""The benchmark's telemetry generator: dense-sensor series made on the device from a seed.

A copy of the statistics of the port's TPSS synthesis (``repro_torch/tpss/synth.py``:
AR(2) serial correlation, low-rank cross correlation, harmonics, a sinh-arcsinh
shape, per-signal mean and scale), rebuilt so that it runs in a few large calls:
the AR(2) recursion becomes a convolution with its impulse response, cut where the
response falls under 1e-12 of its first tap, in place of a loop over time. Every
random number comes from one ``torch.Generator`` on the device, so one seed gives
the same series in every run on one kind of device.

A series is one asset's telemetry: its first observations train the model, the next
batch calibrates the detector, and the rest are cut into the batches that the traffic
replays. Faults (ramps on a few signals) are added to those batches only, as the
traffic's file asks.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
MASK63 = (1 << 63) - 1


def sub_seed(seed: int, part: int) -> int:
    """A seed for one part of a run, the same in every process (a 64-bit mix)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(part) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x ^= x >> 31
    x = (x * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (x ^ (x >> 29)) & MASK63


def generator(seed: int, part: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, part))
    return g


def ar2_response(a1: float, a2: float, tol: float = 1e-12) -> torch.Tensor:
    """The impulse response of y[t] = a1 y[t-1] + a2 y[t-2] + e[t], scaled to unit
    variance, up to the first tap under ``tol`` (float64 on the host)."""
    h = [1.0, a1]
    while abs(h[-1]) >= tol or abs(h[-2]) >= tol:
        h.append(a1 * h[-1] + a2 * h[-2])
        if len(h) > 4096:
            raise ValueError(f"AR(2) ({a1}, {a2}) is not stable")
    h = torch.tensor(h, dtype=torch.float64)
    return h / torch.sqrt(torch.sum(h * h))


def _ar2(eps: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(C, T + K - 1) innovations -> (C, T): each row filtered by ``h``."""
    w = h.flip(0).to(eps.device, F32).view(1, 1, -1)
    return torch.nn.functional.conv1d(eps.unsqueeze(1), w).squeeze(1)


def series(seed: int, n_obs: int, n_signals: int, p: dict, device, part: int = 0) -> torch.Tensor:
    """(n_obs, n_signals) float32 telemetry of one asset, contiguous; ``p`` holds the
    shape's parameters (a configuration's ``telemetry`` entry)."""
    g = generator(seed, part, device)
    h = ar2_response(p["ar1"], p["ar2"])
    k, r, nh = h.numel(), p["cross_rank"], p["n_harmonics"]

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=device, dtype=F32)

    def uniform(lo, hi, *shape):
        return torch.rand(*shape, generator=g, device=device, dtype=F32) * (hi - lo) + lo

    own = _ar2(normal(n_signals, n_obs + k - 1), h)  # (n, T)
    lat = _ar2(normal(r, n_obs + k - 1), h)  # (r, T)
    mix = normal(r, n_signals)
    mix = mix / torch.linalg.vector_norm(mix, dim=0, keepdim=True)
    w = p["cross_weight"]
    x = own.T.contiguous().mul_(math.sqrt(1 - w * w))  # (T, n)
    del own
    for i in range(r):  # the shared factors as adds, whatever the products' precision
        x.add_(lat[i][:, None] * mix[i], alpha=w)
    del lat
    x = torch.sinh(torch.asinh(x).mul_(p["tailweight"]).add_(p["skew"]))
    freqs = uniform(2 * math.pi / n_obs * 2, 2 * math.pi / 64, nh, n_signals)
    phase = uniform(0.0, 2 * math.pi, nh, n_signals)
    t = torch.arange(n_obs, dtype=F32, device=device)[:, None]
    amp = p["harmonic_amp"] / max(nh, 1)
    for i in range(nh):
        x.add_(torch.sin(t * freqs[i] + phase[i]), alpha=amp)
    mean = normal(n_signals) * p["mean_scale"]
    scale = torch.exp(normal(n_signals) * 0.3) * p["std_scale"]
    return x.mul_(scale).add_(mean)


def add_faults(batch: torch.Tensor, seed: int, part: int, share: float, sigmas: float, scale):
    """Add a ramp to ``share`` of the signals of a (B, n) batch, each starting at a drawn
    observation and reaching ``sigmas`` times the signal's ``scale`` by the batch's end."""
    b, n = batch.shape
    k = int(round(share * n))
    if k == 0:
        return batch
    g = generator(seed, part, batch.device)
    cols = torch.randperm(n, generator=g, device=batch.device)[:k]
    start = torch.randint(0, b // 2, (k,), generator=g, device=batch.device)
    t = torch.arange(b, device=batch.device)[:, None]
    ramp = torch.clamp(t - start[None, :], min=0).to(F32) / (b - start[None, :]).to(F32)
    batch[:, cols] += ramp * (sigmas * scale[cols])[None, :]
    return batch
