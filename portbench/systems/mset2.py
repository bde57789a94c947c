"""The ``mset2`` system: MSET2 with a two-sided SPRT, as the port (the system under test)
and, in its place, the control (the reference computed in the precision below the
configuration's).

Each gives ``prepare``, ``train``, ``estimate`` and ``sprt`` with one signature, so
that the ``stream`` and ``cells`` loops drive either without knowing which it is. The
port is imported only when it is built, so that the benchmark's tests and the control
never load it.
"""

from __future__ import annotations

import importlib

import torch

from portbench import reference


def _hook(span):
    """The port's ``step(name, fn)`` hook: each named step as a ``bench.<name>`` span."""

    def step(name, fn):
        with span(name):
            return fn()

    return step


class Port:
    """``repro_torch``: MSET2 ``train`` and ``estimate`` (K1 on the card) and ``sprt`` (K3)."""

    name = "port"

    def __init__(self):
        self.mset2 = importlib.import_module("repro_torch.mset.mset2")
        self.sprt_mod = importlib.import_module("repro_torch.mset.sprt")
        self.device_mod = importlib.import_module("repro_torch._device")

    def prepare(self, cfg: dict):
        if cfg["precision"] != "float32":
            raise ValueError(f"the port runs MSET2 in float32, not {cfg['precision']}")
        self.device_mod.f32_matmul_highest()
        self.params = self.sprt_mod.SPRTParams(**cfg["sprt"])

    def train(self, X, cfg: dict, span):
        return self.mset2.train(
            X, cfg["n_memvec"], kind=cfg["kind"], reg=cfg["reg"], step=_hook(span)
        )

    def estimate(self, model, X, span):
        return self.mset2.estimate(model, X, step=_hook(span))[1]

    def sprt(self, r, sigma, mu):
        """-> (alarms (T, n) bool, llr (T, 2, n) float32), the LLRs as the kernel wrote them."""
        alarms, pos, neg = self.sprt_mod.sprt(r, sigma, self.params, mu=mu)
        T, n = pos.shape
        base = pos.as_strided((T, 2, n), (2 * n, n, 1), pos.storage_offset())
        if pos.stride() == (2 * n, 1) and neg.data_ptr() == pos.data_ptr() + 4 * n:
            return alarms, base
        return alarms, torch.stack([pos, neg], dim=1)


class Control:
    """The reference in the program's place, in float32 with TF32 products: the step
    below the configuration's float32 with TF32 off."""

    name = "control"

    def prepare(self, cfg: dict):
        if cfg["precision"] != "float32":
            raise ValueError(f"no control is defined for {cfg['precision']}")
        s = cfg["sprt"]
        self.m_shift = s["m_shift"]
        self.upper, self.lower = reference.sprt_bounds(s["alpha"], s["beta"])

    def train(self, X, cfg: dict, span):
        with span("train"):
            return reference.train(
                X, cfg["n_memvec"], cfg["kind"], cfg["reg"], dtype=torch.float32, tf32=True
            )

    def estimate(self, model, X, span):
        with span("estimate"):
            return reference.estimate(model, X)

    def sprt(self, r, sigma, mu):
        return reference.sprt(r, sigma, mu, self.m_shift, self.upper, self.lower)


SYSTEMS = {"port": Port, "control": Control}
