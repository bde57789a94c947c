"""Memory-vector selection for MSET2 training.

Classic two-stage procedure: (1) the min-max algorithm keeps every observation
that realizes the minimum or maximum of some signal (guarantees coverage of the
operating envelope), then (2) the remaining budget is filled by vector-ordering —
observations sorted by their vector norm and sampled equidistantly.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def equidistant_take(n_obs: int, n_memvec: int, device=None) -> torch.Tensor:
    """int64 positions ``linspace(0, n_obs - 1, n_memvec)`` truncated toward zero.

    Bit-for-bit the f32 arithmetic the JAX reference runs for
    ``jnp.linspace(0, n_obs - 1, n_memvec).astype(int32)``: XLA rewrites it to
    ``iota * (f32(n_obs - 1) * (1 / f32(n_memvec - 1)))`` with the last point set
    to ``n_obs - 1``. ``torch.linspace`` and ``np.linspace`` round differently and
    pick a neighbouring observation at some positions.
    """
    if n_memvec <= 1:
        return torch.zeros(n_memvec, dtype=torch.int64, device=device)
    step = np.float32(n_obs - 1) * (np.float32(1) / np.float32(n_memvec - 1))
    head = torch.arange(n_memvec - 1, dtype=F32, device=device) * float(step)
    last = torch.full((1,), n_obs - 1, dtype=torch.int64, device=device)
    return torch.cat([head.to(torch.int32).to(torch.int64), last])


def select_memory_vectors(X, n_memvec: int):
    """X: (n_obs, n_signals) -> int64 indices (n_memvec,) into X.

    If 2*n_signals >= n_memvec, min-max indices are truncated deterministically.
    """
    n_obs, n_sig = X.shape
    xf = X.float()
    mins = torch.argmin(xf, dim=0)  # (n_sig,), first occurrence on ties
    maxs = torch.argmax(xf, dim=0)
    envelope = torch.cat([mins, maxs])  # (2*n_sig,)

    # vector-ordering: sort all observations by norm, take equidistant samples
    norms = torch.sqrt(torch.sum(xf * xf, dim=1))
    order = torch.argsort(norms, stable=True)
    ordered = order[equidistant_take(n_obs, n_memvec, device=X.device)]  # (n_memvec,)

    # prefer envelope vectors, fill the rest with ordered samples; duplicates are
    # harmless for MSET but wasteful, and the equidistant fill makes them rare
    n_env = min(2 * n_sig, n_memvec)
    return torch.cat([envelope[:n_env], ordered[: n_memvec - n_env]])


def build_memory_matrix(X, n_memvec: int):
    idx = select_memory_vectors(X, n_memvec)
    return X[idx], idx
