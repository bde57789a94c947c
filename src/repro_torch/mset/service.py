"""MSET2 as a cloud service: batched fleet surveillance, the JAX package's
``mset/service.py`` at one chip.

``_estimate_sharded`` is the service's estimate on one device (the similarity op:
K1 on the card, its plain version on the CPU and on meta tensors), which the dry-run
counts on ``abstract_service_inputs``; ``make_service``, which shards it over a mesh
(memory vectors over ``model``, observations over the batch axes, one all-reduce for
the x_hat contraction), waits for the port's ``distributed/``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.similarity.ops import similarity

F32 = torch.float32


def _estimate_sharded(D, Ginv, mean, std, X, *, gamma, kind):
    """The service's estimate on a batch X (b, n): (Xhat, residuals X - Xhat)."""
    Xs = (X.to(F32) - mean) / std
    K = similarity(D, Xs, gamma=gamma, kind=kind)  # (m, b)
    W = Ginv @ K  # (m, b)
    Xhat = W.T @ D  # (b, n)
    Xhat = Xhat * std + mean
    return Xhat, X - Xhat


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


def abstract_service_inputs(n_signals: int, n_memvec: int, batch: int):
    """The service's inputs as float32 meta tensors (shapes, no data) for dry-run
    scoping of the MSET service."""

    def f32(*shape):
        return torch.empty(shape, dtype=F32, device="meta")

    return {
        "D": f32(n_memvec, n_signals),
        "Ginv": f32(n_memvec, n_memvec),
        "mean": f32(n_signals),
        "std": f32(n_signals),
        "X": f32(batch, n_signals),
    }
