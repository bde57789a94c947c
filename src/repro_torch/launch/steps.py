"""Step builders shared by the trainer, the server and the dry-run: the JAX package's
``launch/steps.py`` on one device.

The reference's ``StepBuilder`` holds no state: it builds jitted functions of
(params, opt_state, batch). Here the builder owns what those functions act on, a
model for training (float32 parameters, cast at use) and its AdamW state, and
``train_step`` updates both in place, as the reference's donated buffers are. On
``device="meta"`` it draws no weights, and the dry-run counts its steps there
(``core.hlo_analysis.analyze``): ``grad_step`` is the body of the reference's
``jit_grad_step``, and ``abstract_params``, ``abstract_opt_state`` and
``cache_abstract`` give the reference's abstract trees as meta tensors. The sharding
helpers and the ``jit_*`` forms' shardings wait for the port's ``distributed/``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.layers import _run
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.grad_accum import microbatched_value_and_grad


class StepBuilder:
    """A trainable model of ``cfg`` on ``device`` (None -> cuda), its weights drawn
    from ``seed``, and its AdamW state; ``train_step`` runs one optimizer step over
    ``n_microbatches`` microbatches."""

    def __init__(
        self,
        cfg: ArchConfig,
        n_microbatches: int = 1,
        opt: Optional[AdamWConfig] = None,
        device=None,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.model = Model(cfg, device, trainable=True)
        self.params = dict(self.model.named_parameters())
        self.n_microbatches = n_microbatches
        self.opt = opt or AdamWConfig()
        self.reset(seed)
        self._value_and_grad = microbatched_value_and_grad(
            lambda params, batch: self.model.loss(batch), n_microbatches
        )

    def reset(self, seed: int):
        """Fresh weights drawn from ``seed`` and a fresh AdamW state. A model on the
        meta device has no data to draw."""
        if self.model.device.type != "meta":
            self.model.init_weights(torch.Generator(self.model.device).manual_seed(seed))
        self.opt_state = adamw.init(self.params)

    # -------------------------- abstract trees ---------------------------
    def abstract_params(self, dtype=None) -> dict:
        """The reference's parameter tree as meta tensors, float32 or ``dtype``."""
        tree = self.model.abstract_params()
        if dtype is None:
            return tree
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return _tree.map(lambda t: torch.empty(t.shape, dtype=dtype, device="meta"), tree)

    def abstract_opt_state(self, params_abs) -> adamw.AdamWState:
        """AdamW's state for ``params_abs`` (meta tensors): int32 step, float32 moments."""
        return adamw.init(params_abs)

    def cache_abstract(self, shape: ShapeSpec) -> tuple:
        """The decode cache of ``shape`` (global_batch sequences of seq_len) as meta
        tensors in the reference's tree (``Model.cache_specs``)."""
        return tuple(
            {
                kind: {n: torch.empty(dims, dtype=dt, device="meta") for n, (dims, dt) in e.items()}
                for kind, e in entry.items()
            }
            for entry in self.model.cache_specs(shape.global_batch, shape.seq_len)
        )

    # -------------------------- step functions --------------------------
    def train_step(self, batch: dict, step=_run) -> dict:
        """Forward, backward and AdamW on ``batch`` (its leading dim split into the
        microbatches). Returns the metrics nll, z_loss, moe_aux, loss, grad_norm and lr
        as 0-dim tensors on the model's device: reading one waits for the step.
        ``step(name, fn)`` is a hook around the two parts, "forward + backward" and
        "AdamW"."""
        (loss, metrics), grads = step(
            "forward + backward", lambda: self._value_and_grad(self.params, batch)
        )
        _, self.opt_state, om = step(
            "AdamW", lambda: adamw.update(self.opt, grads, self.opt_state, self.params)
        )
        for p in self.params.values():
            p.grad = None
        return dict(metrics, loss=loss, **om)

    def grad_step(self, params: dict, batch: dict):
        """The body of the reference's ``jit_grad_step``, the dry-run's cost probe: the
        loss on ``batch`` and the gradients of ``params`` (the model's parameters,
        ``self.params``), in one pass with no microbatching and no optimizer. Returns
        (grads, loss); the gradients are the parameters' ``.grad``."""
        (loss, _), grads = microbatched_value_and_grad(lambda p, b: self.model.loss(b), 1)(
            params, batch
        )
        return grads, loss

    def prefill(self, tokens, cache=None, **source):
        return self.model.prefill(tokens, cache, **source)

    def decode(self, cache, tokens, pos: int):
        return self.model.decode_step(cache, tokens, pos)

    # ---------------- the reference's (params, opt_state) tree ----------------
    def state_tree(self):
        """(params, AdamWState(step, mu, nu)) as numpy arrays in the reference's trees:
        what its trainer checkpoints."""
        st = self.opt_state
        return (
            self.model.to_numpy(),
            adamw.AdamWState(
                st.step.cpu().numpy(), self.model.to_numpy(st.mu), self.model.to_numpy(st.nu)
            ),
        )

    def state_like(self):
        """``state_tree``'s structure with no data, for ``Checkpointer.restore``."""
        like = self.model.tree_like()
        return like, adamw.AdamWState(np.zeros((), np.int32), like, like)

    def load_state_tree(self, tree):
        """Copy a (params, AdamWState) tree in the reference's layout into the model's
        parameters and the AdamW state."""
        params, st = tree
        self.model.load_numpy(params)
        self.model.load_numpy(st.mu, into=self.opt_state.mu)
        self.model.load_numpy(st.nu, into=self.opt_state.nu)
        self.opt_state.step.fill_(int(st.step))
