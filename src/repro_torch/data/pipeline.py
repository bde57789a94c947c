"""Deterministic synthetic data pipelines, shard-aware: the JAX package's
``data/pipeline.py``.

* ``TokenPipeline`` — seeded LM token stream: each (step, host shard) draws its slice
  from numpy's ``SeedSequence([seed, step, host_id])``, as the reference does, so
  the tokens are the reference's bit for bit, and a restart reproduces the same
  global batch for a given step. Targets are the next tokens of the same stream
  (Zipf-ish draws with a copy structure, so that losses fall).
* ``TelemetryPipeline`` — TPSS sensor streams for MSET surveillance, through the
  port's ``tpss`` (whose draws come from a ``torch.Generator``; the reference's
  from ``jax.random``).

Placing a batch with a mesh sharding (the reference's ``sharded_batch``) is not ported
yet: it needs a process per device (ROADMAP item 10).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.tpss import TPSSParams, synthesize_batch


@dataclass
class TokenPipeline:
    """``batch(step)`` -> {"tokens", "targets"}: (host_batch, seq_len) int64 tensors on
    ``device`` (None -> cuda)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    device: Any = None

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} over {self.n_hosts} hosts")
        self.host_batch = self.global_batch // self.n_hosts
        self.device = resolve_device(self.device)

    def _host_slice(self, step: int) -> np.ndarray:
        """(host_batch, seq_len + 1) int32, deterministic in (step, host)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step, self.host_id]))
        # Zipf-ish marginal + short-range repetition structure
        base = rng.zipf(1.3, size=(self.host_batch, self.seq_len + 1))
        toks = (base % self.vocab_size).astype(np.int32)
        # inject copy structure: every 8th token repeats 4 back (learnable signal)
        toks[:, 8::8] = toks[:, 4:-4:8] if toks.shape[1] > 12 else toks[:, 8::8]
        return toks

    def batch(self, step: int) -> dict:
        toks = torch.from_numpy(self._host_slice(step)).to(self.device, torch.int64)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


@dataclass
class TelemetryPipeline:
    """``window(step)``: (n_assets, n_obs, n_signals) telemetry on ``device`` (None ->
    cuda), synthesized from seed ``seed + 7919 step`` as the reference keys it."""

    params: TPSSParams
    n_assets: int
    seed: int = 0
    device: Any = None

    def window(self, step: int) -> torch.Tensor:
        return synthesize_batch(self.seed + step * 7919, self.params, self.n_assets, self.device)
