"""MSET2 as a sharded cloud service: batched fleet surveillance on a device mesh, the
JAX package's ``mset/service.py``.

The estimation math shards naturally: memory vectors (m) over the ``model`` axis, the
observation batch over (pod, data). ``_estimate_sharded`` is the estimate on plain
tensors (the similarity op: K1 on the card, its plain version on the CPU and on meta
tensors), which the dry-run counts on ``abstract_service_inputs``; ``make_service``
runs it on DTensors, with the similarity op through ``local_call`` (K1 sees local
shards only) and the x_hat contraction over the sharded m ending in one all-reduce.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.distributed.sharding import local_call, make_rules, place
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


def sharded_similarity(D, Xs, gamma: float, kind: str):
    """K = sim(D, Xs) (m, b) of DTensors D (m, n) and Xs (b, n), each sharded along its
    rows only, through ``local_call``: the similarity op (K1 on the card) sees each
    rank's local rows; K comes out sharded as D's rows and Xs's."""
    k_pl = tuple(
        Shard(0) if d == Shard(0) else Shard(1) if x == Shard(0) else Replicate()
        for d, x in zip(D.placements, Xs.placements)
    )
    return local_call(lambda d, x: similarity(d, x, gamma=gamma, kind=kind), (k_pl,), D, Xs)


def make_service(model, mesh, kind: Optional[str] = None):
    """estimate(X (b, n)) -> (Xhat, residuals) with the reference's shardings on
    ``mesh``: D and Ginv row-sharded over ``model``, mean and std replicated, X and both
    outputs sharded over the batch axes (each dropped where it does not divide, as the
    rules do). X may be a plain tensor (placed first) or a DTensor; the outputs are
    DTensors. ``estimate.inputs`` holds the placed model tensors."""
    rules = make_rules(mesh, {"mset_mvec": "model", "mset_batch": ("pod", "data")})
    kind = kind or model.kind
    gamma = model.gamma
    rep = (mesh, (Replicate(),) * mesh.ndim)
    D = place(model.D, rules.sharding_for(("mset_mvec", None), model.D.shape))
    Ginv = place(model.Ginv, rules.sharding_for(("mset_mvec", None), model.Ginv.shape))
    mean, std = place(model.mean, rep), place(model.std, rep)

    def estimate(X):
        s_X = rules.sharding_for(("mset_batch", None), X.shape)
        X = place(X, s_X)
        Xs = (X.to(F32) - mean) / std
        W = Ginv @ sharded_similarity(D, Xs, gamma, kind)  # (m, b)
        Xhat = (W.T @ D).redistribute(mesh, s_X[1])  # the contraction over the sharded m
        Xhat = Xhat * std + mean
        return Xhat, X - Xhat

    estimate.inputs = {"D": D, "Ginv": Ginv, "mean": mean, "std": std}
    return estimate


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
