"""MSET2 — Multivariate State Estimation Technique (nonlinear nonparametric
regression for prognostic surveillance), the paper's pluggable ML workload.

Training (paper Fig. 4 cost driver):
    D     = memory matrix, (m, n) selected from training data
    G     = D (x) D  — the nonlinear similarity operator (the CUDA kernel)
    Ginv  = regularized pseudo-inverse of G (eigendecomposition)

Surveillance (paper Fig. 5 cost driver), streamed over observations x:
    w     = Ginv · (D (x) x)
    x_hat = w^T · D
residuals x - x_hat feed the SPRT detector (sprt.py). On the card both products run on
K4 (``kernels/gemm``), which reads Ginv and D^T as TF32 planes that the model keeps.

Each step runs inside a telemetry span (``repro_torch._telemetry``): ``mset2.train``
with ``.standardize``, ``.memory_vectors``, ``.bandwidth``, ``.similarity`` and
``.pinv``; ``mset2.estimate`` with ``.standardize``, ``.similarity``, ``.ginv_k``,
``.wt_d`` and ``.residuals``. They cost one check each unless the profiler records or
a session is open.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch._telemetry import counter, span
from repro_torch.kernels.gemm import gemm, split_cols, split_rows
from repro_torch.kernels.similarity import similarity
from repro_torch.mset.memory_vectors import build_memory_matrix

F32 = torch.float32


class MSETModel(nn.Module):
    """A trained MSET2 model; ``D``, ``Ginv``, ``mean`` and ``std`` are buffers."""

    def __init__(self, D, Ginv, gamma: float, kind: str, mean, std):
        super().__init__()
        self.register_buffer("D", D)  # (m, n) memory matrix
        self.register_buffer("Ginv", Ginv)  # (m, m)
        self.register_buffer("mean", mean)  # (n,) standardization
        self.register_buffer("std", std)  # (n,)
        self.gamma = float(gamma)
        self.kind = kind
        self._planes = {}  # name -> (buffer, its version and address, its K4 planes); not state

    def forward(self, X):
        return estimate(self, X)

    def _kept(self, name: str, t, split):
        """``split(t)``, the TF32 hi and lo planes in which K4 reads buffer ``t`` on the card
        (twice its bytes), made once and again only when ``t`` is replaced or edited in
        place (another tensor, another ``_version``), each making counted by the session
        counter ``mset2_plane_splits_total{plane=name}``. Kept out of the state dict. None
        where ``gemm`` takes the plain product (off the card) or a version is not tracked."""
        if not t.is_cuda or t.is_inference():
            return None
        key = (t._version, t.data_ptr())
        cached = self._planes.get(name)
        if cached is None or cached[0]() is not t or cached[1] != key:
            self._planes.pop(name, None)
            del cached  # the old planes go before the new are made
            cached = self._planes[name] = (weakref.ref(t), key, split(t))
            counter("mset2_plane_splits_total", plane=name)
        return cached[2]

    def ginv_split(self):
        """Ginv's planes (2, m, m_pad): K4's a in W = Ginv K."""
        return self._kept("ginv", self.Ginv, split_rows)

    def dt_split(self):
        """D^T's planes (2, n, m_pad): K4's b in X_hat = W^T D."""
        return self._kept("dt", self.D, split_cols)

    def __getstate__(self):
        return dict(super().__getstate__(), _planes={})  # a weakref does not pickle

    @classmethod
    def from_numpy(cls, D, Ginv, mean, std, gamma: float, kind: str, device=None) -> "MSETModel":
        """Carry a model across from numpy arrays (e.g. a ``repro`` model's fields)."""
        dev = resolve_device(device)

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

        return cls(t(D), t(Ginv), gamma, kind, t(mean), t(std))

    def to_numpy(self) -> dict:
        """The model's fields as numpy arrays and Python scalars (``from_numpy``'s inverse)."""
        arrays = {k: getattr(self, k).detach().cpu().numpy() for k in ("D", "Ginv", "mean", "std")}
        return dict(arrays, gamma=self.gamma, kind=self.kind)


def _bandwidth(D) -> torch.Tensor:
    """Median-distance heuristic for gamma, from a subsample of D."""
    s = D[: min(256, D.shape[0])]
    x2 = torch.sum(s * s, dim=1)
    d2 = torch.clamp(x2[:, None] + x2[None, :] - 2 * s @ s.T, min=0.0)
    # numpy-style median (mean of the two middle values; torch.median takes the lower).
    # Like the reference, the diagonal zeros stay in the sample.
    v = torch.sort(torch.sqrt(d2).flatten()).values
    k = v.numel()
    med = (v[(k - 1) // 2] + v[k // 2]) * 0.5
    return torch.clamp(med, min=1e-3)


def regularized_pinv(G, reg: float):
    """Pseudo-inverse of G + reg*I through its eigendecomposition, dropping evals <= reg."""
    m = G.shape[0]
    Gr = G + reg * torch.eye(m, dtype=F32, device=G.device)
    # symmetrize as jnp.linalg.eigh does by default before decomposing
    evals, evecs = torch.linalg.eigh((Gr + Gr.T) / 2)
    inv_evals = torch.where(evals > reg, 1.0 / evals, torch.zeros_like(evals))
    return (evecs * inv_evals[None, :]) @ evecs.T


def _run(name: str, fn: Callable[[], Any]) -> Any:
    return fn()


def train(
    X,
    n_memvec: int,
    *,
    kind: str = "inverse_distance",
    gamma: Optional[float] = None,
    reg: float = 1e-6,
    step: Callable[[str, Callable[[], Any]], Any] = _run,
) -> MSETModel:
    """X: (n_obs, n_signals) raw training telemetry, on the device to train on.

    ``step(name, fn)`` runs each named step as ``fn()``; a caller may pass one that
    times the steps.
    """
    with span("mset2.train"):
        with span("mset2.train.standardize"):
            Xf = X.float()
            mean = torch.mean(Xf, dim=0)
            std = torch.std(Xf, dim=0, correction=0) + 1e-6
            Xs = (Xf - mean) / std

        with span("mset2.train.memory_vectors"):
            D, _ = step("memory vectors", lambda: build_memory_matrix(Xs, n_memvec))
        if gamma is not None:
            g = float(gamma)
        else:
            with span("mset2.train.bandwidth"):
                g = step("bandwidth", lambda: float(_bandwidth(D)))

        with span("mset2.train.similarity"):
            G = step("similarity D x D", lambda: similarity(D, D, gamma=g, kind=kind))  # (m, m)
        with span("mset2.train.pinv"):
            Ginv = step("eigh pseudo-inverse", lambda: regularized_pinv(G, reg))
        return MSETModel(D=D, Ginv=Ginv, gamma=g, kind=kind, mean=mean, std=std)


def estimate(model: MSETModel, X, step: Callable[[str, Callable[[], Any]], Any] = _run):
    """X: (b, n) observations -> (x_hat (b, n), residuals (b, n)). ``step`` as in ``train``."""
    with span("mset2.estimate"):
        with span("mset2.estimate.standardize"):
            Xs = (X.float() - model.mean) / model.std
        with span("mset2.estimate.similarity"):
            K = step(
                "similarity D x X",
                lambda: similarity(model.D, Xs, gamma=model.gamma, kind=model.kind),
            )
        with span("mset2.estimate.ginv_k"):
            # (m, b); on the card K4, with Ginv split once a model
            W = step("Ginv K", lambda: gemm(model.Ginv, K, a_split=model.ginv_split()))
        with span("mset2.estimate.wt_d"):
            # (b, n); on the card K4, with W^T split from W and D^T split once a model
            Xhat_s = step("W^T D", lambda: gemm(W.T, model.D, b_split=model.dt_split()))
        with span("mset2.estimate.residuals"):
            Xhat = Xhat_s * model.std + model.mean
            return Xhat, X - Xhat


def surveil(model: MSETModel, X_stream):
    """Convenience: full-stream estimation. X_stream: (T, n)."""
    return estimate(model, X_stream)
