"""Pluggable prognostic-algorithm registry (paper §II.B: the framework must
accommodate other nonlinear-nonparametric-regression techniques — NN, SVM, AAKR).

Each plugin implements  train(X, n_memvec, **kw) -> model  and
estimate(model, X) -> (x_hat, residuals). ContainerStress scopes any of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.kernels.similarity import similarity
from repro_torch.mset import mset2
from repro_torch.mset.memory_vectors import build_memory_matrix

F32 = torch.float32


@dataclass(frozen=True)
class Plugin:
    name: str
    train: Callable
    estimate: Callable


def _standardize(X):
    Xf = X.float()
    mean, std = torch.mean(Xf, 0), torch.std(Xf, 0, correction=0) + 1e-6
    return (Xf - mean) / std, mean, std


# --------------------------- AAKR ------------------------------------------


@dataclass
class AAKRModel:
    D: torch.Tensor
    gamma: float
    mean: torch.Tensor
    std: torch.Tensor


def aakr_train(X, n_memvec: int, *, gamma=None, **_):
    Xs, mean, std = _standardize(X)
    D, _ = build_memory_matrix(Xs, n_memvec)
    g = float(gamma) if gamma is not None else 1.0
    return AAKRModel(D, g, mean, std)


def aakr_estimate(model: AAKRModel, X):
    Xs = (X.float() - model.mean) / model.std
    K = similarity(model.D, Xs, gamma=model.gamma, kind="gaussian")  # (m, b)
    w = K / (torch.sum(K, dim=0, keepdim=True) + 1e-9)
    Xhat = (w.T @ model.D) * model.std + model.mean
    return Xhat, X - Xhat


# --------------------------- ridge (linear baseline) ------------------------


@dataclass
class RidgeModel:
    W: torch.Tensor  # (n, n) auto-associative map
    mean: torch.Tensor
    std: torch.Tensor


def ridge_train(X, n_memvec: int = 0, *, reg: float = 1e-3, **_):
    """Auto-associative ridge regression x -> x (leave-one-in linear baseline)."""
    Xs, mean, std = _standardize(X)
    n = Xs.shape[1]
    C = Xs.T @ Xs / Xs.shape[0]
    G = C + reg * torch.eye(n, dtype=F32, device=Xs.device)
    W = torch.linalg.solve(G, C)
    return RidgeModel(W, mean, std)


def ridge_estimate(model: RidgeModel, X, **_):
    Xs = (X.float() - model.mean) / model.std
    Xhat = (Xs @ model.W) * model.std + model.mean
    return Xhat, X - Xhat


REGISTRY: dict[str, Plugin] = {
    "mset2": Plugin("mset2", mset2.train, mset2.estimate),
    "aakr": Plugin("aakr", aakr_train, aakr_estimate),
    "ridge": Plugin("ridge", ridge_train, ridge_estimate),
}


def get_plugin(name: str) -> Plugin:
    return REGISTRY[name]
