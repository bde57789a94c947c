"""Analytic cost of MSET2 as a cloud service: batched fleet surveillance.

Only the pure cost functions are here so far; the sharded service itself waits
for the port's ``distributed/`` layer.
"""

from __future__ import annotations


def service_flops_bytes(n_signals: int, n_memvec: int, batch: int):
    """Analytic per-call cost of one sharded estimate on a batch of
    observations: similarity kernel (K = sim(D, X)), weight solve (W = Ginv K),
    reconstruction (Xhat = W^T D). Feeds the fleet scenario's roofline rows."""
    m, n, b = n_memvec, n_signals, batch
    flops = 2.0 * m * b * n + 2.0 * m * m * b + 2.0 * b * m * n
    bytes_ = 4.0 * (
        m * n
        + m * m  # D, Ginv (weight streaming)
        + 3 * b * n  # X in, Xhat + residual out
        + 2 * m * b  # K, W intermediates
    )
    return flops, bytes_


def service_collective_bytes(n_signals: int, batch: int) -> float:
    """All-reduce traffic of the x_hat contraction over the sharded m axis."""
    return 2.0 * 4.0 * batch * n_signals  # ring all-reduce ~ 2x payload
