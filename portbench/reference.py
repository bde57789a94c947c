"""The plain reference: MSET2 training, estimation and the two-sided SPRT, worked out
again from the inputs the benchmark made. Plain PyTorch; it imports nothing of the
program under test.

The memory vectors are an integer choice (the observations that hold each signal's
minimum and maximum, then equidistant picks in order of norm), so the reference
makes that choice in float32 from float32 standardization, with the rule the
configuration's model states, and from there computes in ``dtype``: float64 for the
reference, lower for a control. ``tf32=True`` runs the products of a float32 control
on the TF32 tensor cores (on the CPU, which has none, their operands are rounded to
TF32's 10-bit mantissa first).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

F32, F64 = torch.float32, torch.float64


@contextlib.contextmanager
def _tf32_cores():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a, b, tf32: bool = False):
    """a @ b; with ``tf32`` a float32 product on the TF32 tensor cores."""
    if not tf32 or a.dtype != F32:
        return a @ b
    if a.is_cuda:
        with _tf32_cores():
            return a @ b
    return to_tf32(a) @ to_tf32(b)


def standardization(X: torch.Tensor):
    """float32 mean and std (population, + 1e-6) of the training telemetry."""
    Xf = X.to(F32)
    return torch.mean(Xf, dim=0), torch.std(Xf, dim=0, correction=0) + 1e-6


def equidistant(n_obs: int, m: int, device) -> torch.Tensor:
    """Positions floor(i * (f32(n_obs - 1) * (1 / f32(m - 1)))) in float32, the last n_obs - 1."""
    if m <= 1:
        return torch.zeros(m, dtype=torch.int64, device=device)
    step = float(np.float32(n_obs - 1) * (np.float32(1) / np.float32(m - 1)))
    head = (torch.arange(m - 1, dtype=F32, device=device) * step).to(torch.int64)
    return torch.cat([head, torch.tensor([n_obs - 1], device=device)])


def memory_indices(Xs: torch.Tensor, m: int) -> torch.Tensor:
    """Min-max envelope first (argmin of each signal, then argmax), truncated to m, then
    observations in order of norm at equidistant positions."""
    n_obs, n = Xs.shape
    envelope = torch.cat([torch.argmin(Xs, dim=0), torch.argmax(Xs, dim=0)])
    order = torch.argsort(torch.sqrt(torch.sum(Xs * Xs, dim=1)), stable=True)
    n_env = min(2 * n, m)
    return torch.cat([envelope[:n_env], order[equidistant(n_obs, m, Xs.device)][: m - n_env]])


def similarity(x, y, gamma: float, kind: str, tf32: bool = False):
    x2 = torch.sum(x * x, dim=1)[:, None]
    y2 = torch.sum(y * y, dim=1)[None, :]
    d2 = torch.clamp(x2 + y2 - 2.0 * mm(x, y.T, tf32), min=0.0)
    if kind == "inverse_distance":
        return 1.0 / (1.0 + torch.sqrt(d2) / gamma)
    if kind == "gaussian":
        return torch.exp(-d2 / (2.0 * gamma * gamma))
    raise ValueError(f"unknown similarity kind {kind!r}")


def bandwidth(D, tf32: bool = False) -> float:
    """The median of the pairwise distances among the first 256 memory vectors (the
    zeros of the diagonal included), at least 1e-3."""
    s = D[: min(256, D.shape[0])]
    x2 = torch.sum(s * s, dim=1)
    d = torch.sqrt(torch.clamp(x2[:, None] + x2[None, :] - 2 * mm(s, s.T, tf32), min=0.0))
    v = torch.sort(d.flatten()).values
    k = v.numel()
    return max(float((v[(k - 1) // 2] + v[k // 2]) * 0.5), 1e-3)


def pinv(G, reg: float, tf32: bool = False):
    """(G + reg I)^+ through its eigendecomposition, eigenvalues <= reg dropped."""
    Gr = G + reg * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    evals, evecs = torch.linalg.eigh((Gr + Gr.T) / 2)
    inv = torch.where(evals > reg, 1.0 / evals, torch.zeros_like(evals))
    return mm(evecs * inv[None, :], evecs.T, tf32)


@dataclass
class Model:
    D: torch.Tensor  # (m, n) standardized memory vectors, in the working dtype
    Ginv: torch.Tensor  # (m, m)
    mean: torch.Tensor  # (n,) float32
    std: torch.Tensor  # (n,) float32
    gamma: float
    kind: str
    tf32: bool = False


def train(X, m: int, kind: str, reg: float, dtype=F64, tf32: bool = False,
          distinct: bool = False) -> Model:
    """(n_obs, n) raw training telemetry -> the model, in ``dtype`` from the memory
    vectors on. ``distinct`` keeps each repeated memory vector once (a witness: the
    same model without G's exact null space)."""
    mean, std = standardization(X)
    Xs = (X.to(F32) - mean) / std
    idx = memory_indices(Xs, m)
    D = Xs[torch.unique(idx) if distinct else idx].to(dtype)
    del Xs
    g = bandwidth(D, tf32)
    Ginv = pinv(similarity(D, D, g, kind, tf32), reg, tf32)
    return Model(D, Ginv, mean, std, g, kind, tf32)


def estimate(model: Model, X, rows: int = 8192):
    """(b, n) observations -> residuals X - x_hat, (b, n) in the model's dtype, in blocks
    of ``rows`` observations."""
    dt = model.D.dtype
    mean, std = model.mean.to(dt), model.std.to(dt)
    out = torch.empty(X.shape, dtype=dt, device=X.device)
    for i in range(0, X.shape[0], rows):
        x = X[i : i + rows].to(dt)
        K = similarity(model.D, (x - mean) / std, model.gamma, model.kind, model.tf32)
        W = mm(model.Ginv, K, model.tf32)
        out[i : i + rows] = x - (mm(W.T, model.D, model.tf32) * std + mean)
    return out


def sprt_bounds(alpha: float, beta: float) -> tuple[float, float]:
    """(upper, lower) decision bounds, log((1 - beta) / alpha) and log(beta / (1 - alpha))."""
    return float(np.log((1 - beta) / alpha)), float(np.log(beta / (1 - alpha)))


def sprt(residuals, sigma, mu, m_shift: float, upper: float, lower: float):
    """Two-sided SPRT over (T, n) residuals in their dtype, from zero at t = 0 ->
    (alarms (T, n) bool, llr (T, 2, n)): each step s = max(s + increment, lower), and
    a side that reaches ``upper`` alarms and restarts at 0."""
    z = (residuals - mu) / sigma
    half = 0.5 * m_shift * m_shift
    inc = torch.stack([m_shift * z - half, -m_shift * z - half], dim=1)  # (T, 2, n)
    T, _, n = inc.shape
    llr = torch.empty_like(inc)
    alarms = torch.empty((T, n), dtype=torch.bool, device=z.device)
    s = torch.zeros((2, n), dtype=z.dtype, device=z.device)
    for t in range(T):
        s = torch.clamp(s + inc[t], min=lower)
        hit = s >= upper
        alarms[t] = hit.any(dim=0)
        s = torch.where(hit, torch.zeros_like(s), s)
        llr[t] = s
    return alarms, llr
