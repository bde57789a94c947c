"""Step builders shared by the trainer, the server and the dry-run: the JAX package's
``launch/steps.py`` on one device.

The reference's ``StepBuilder`` holds no state: it builds jitted functions of
(params, opt_state, batch). Here the builder owns what those functions act on, a
model for training (float32 parameters, cast at use) and its AdamW state, and
``train_step`` updates both in place, as the reference's donated buffers are. On
``device="meta"`` it draws no weights, and the dry-run counts its steps there
(``core.hlo_analysis.analyze``): ``grad_step`` is the body of the reference's
``jit_grad_step``, and ``abstract_params``, ``abstract_opt_state`` and
``cache_abstract`` give the reference's abstract trees as meta tensors.

With ``rules`` on a mesh the builder's model is sharded (``Model.shard``; its experts
padded to the ``model`` axis, ``_ep_size``), its AdamW moments are placed as the
parameters, and ``param_shardings``, ``opt_shardings`` and ``cache_shardings`` give the
``(mesh, placements)`` of each leaf of the reference's trees. The ``jit_*`` forms keep
the reference's names, but there is no jit: each returns a callable that places its
inputs by those shardings (the batch by ``batch_sharding``) and runs the step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import Replicate

from repro_torch import _tree
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import ShardingRules, is_sharding, place, unbox_values
from repro_torch.models.layers import _run
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.optim.grad_accum import microbatched_value_and_grad


def batch_sharding(rules: Optional[ShardingRules], specs: dict):
    """``(mesh, placements)`` for each input of a spec dict: dim 0 the batch, the rest
    replicated, a 0-dim tensor replicated, anything else (an int position) None; None
    without a mesh."""
    if rules is None or rules.mesh is None:
        return None
    out = {}
    for k, v in specs.items():
        if not torch.is_tensor(v):
            out[k] = None
        elif v.dim() == 0:
            out[k] = (rules.mesh, (Replicate(),) * rules.mesh.ndim)
        else:
            out[k] = rules.sharding_for(("batch",) + (None,) * (v.dim() - 1), v.shape)
    return out


def place_tree(tree, shardings):
    """Each tensor of ``tree`` placed by the ``(mesh, placements)`` at its place in
    ``shardings`` (a tree of the same structure, or None for none)."""
    if shardings is None:
        return tree
    flat, treedef = _tree.flatten(tree)
    sh = _tree.leaves(shardings, is_leaf=lambda x: x is None or is_sharding(x))
    return _tree.unflatten(
        treedef, [place(t, s) if torch.is_tensor(t) else t for t, s in zip(flat, sh)]
    )


def cast_tree(tree, dtype):
    """Each floating tensor of ``tree`` in ``dtype`` (a meta tensor stays one)."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def one(x):
        if torch.is_tensor(x) and x.is_floating_point():
            return x.to(dtype)
        return x

    return _tree.map(one, tree)


class StepBuilder:
    """A model of ``cfg`` on ``device`` (None -> cuda), trainable unless ``trainable``
    is False (a serving model, for prefill and decode), its weights drawn from ``seed``,
    and its AdamW state; ``train_step`` runs one optimizer step over ``n_microbatches``
    microbatches. ``rules`` with a mesh shards the model and places the state on it."""

    def __init__(
        self,
        cfg: ArchConfig,
        n_microbatches: int = 1,
        opt: Optional[AdamWConfig] = None,
        device=None,
        seed: int = 0,
        rules: Optional[ShardingRules] = None,
        trainable: bool = True,
    ):
        self.cfg = cfg
        self.rules = rules
        self.model = Model(cfg, device, trainable=trainable, ep_size=self._ep_size())
        self.n_microbatches = n_microbatches
        self.opt = opt or AdamWConfig()
        if self.model.device.type != "meta":
            self.model.init_weights(torch.Generator(self.model.device).manual_seed(seed))
        self.model.shard(rules)
        self.params = dict(self.model.named_parameters())
        self.opt_state = adamw.init(self.params)
        self._value_and_grad = microbatched_value_and_grad(
            lambda params, batch: self.model.loss(batch), n_microbatches
        )

    def reset(self, seed: int):
        """Fresh weights drawn from ``seed`` and a fresh AdamW state. A model on the
        meta device has no data to draw."""
        if self.model.device.type != "meta":
            self.model.init_weights(torch.Generator(self.model.device).manual_seed(seed))
        self.opt_state = adamw.init(self.params)

    def _ep_size(self) -> Optional[int]:
        if self.rules is None or self.rules.mesh is None:
            return None
        return self.rules.axis_size("model")

    # -------------------------- abstract trees ---------------------------
    def abstract_params(self, dtype=None) -> dict:
        """The reference's parameter tree as meta tensors, float32 or ``dtype``."""
        tree = self.model.abstract_params()
        return tree if dtype is None else cast_tree(tree, dtype)

    def param_shardings(self):
        """``(mesh, placements)`` of each leaf of the reference's parameter tree (None
        for each without a mesh)."""
        boxed = self.model.abstract_boxes()
        if self.rules is None:
            return _tree.map(lambda _: None, unbox_values(boxed))
        return self.rules.tree_shardings(boxed)

    def opt_shardings(self, param_shardings) -> adamw.AdamWState:
        """AdamW's state: the step replicated, the moments as the parameters."""
        mesh = None if self.rules is None else self.rules.mesh
        step = None if mesh is None else (mesh, (Replicate(),) * mesh.ndim)
        return adamw.AdamWState(step=step, mu=param_shardings, nu=param_shardings)

    def cache_shardings(self, shape: ShapeSpec):
        """``(mesh, placements)`` of each leaf of the cache tree of ``shape``."""
        specs = self.model.cache_specs(shape.global_batch, shape.seq_len)
        axes = self.model.cache_axes()
        return tuple(
            {
                kind: {
                    n: None if self.rules is None else self.rules.sharding_for(a[kind][n], sp[0])
                    for n, sp in e.items()
                }
                for kind, e in ent.items()
            }
            for ent, a in zip(specs, axes)
        )

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

    # ---------------------- the reference's sharded forms ----------------------
    def _placed(self, batch: dict) -> dict:
        return place_tree(batch, batch_sharding(self.rules, batch))

    def jit_train_step(self):
        """(params, opt_state, batch) -> metrics: ``train_step`` on the batch placed by
        ``batch_sharding`` (params and state are the builder's, placed already)."""
        return lambda params, opt_state, batch: self.train_step(self._placed(batch))

    def jit_grad_step(self):
        """(params, batch) -> (grads, loss): ``grad_step`` on the placed batch, the
        dry-run's cost probe."""
        return lambda params, batch: self.grad_step(params, self._placed(batch))

    def jit_prefill(self, shape: ShapeSpec):
        """(params, batch) -> (cache, logits): a prefill of the placed batch into a
        cache of ``shape``'s length placed by ``cache_shardings``."""

        def prefill(params, batch):
            batch = self._placed(batch)
            source = {k: batch[k] for k in ("frames", "src_tokens") if k in batch}
            cache = self.model.init_cache(shape.global_batch, shape.seq_len)
            return self.model.prefill(batch["tokens"], cache, **source)

        return prefill

    def jit_decode_step(self):
        """(params, cache, tokens, pos) -> (cache, logits): one decode step with the
        tokens placed by the batch axes (the cache from ``init_cache``, placed)."""

        def decode(params, cache, tokens, pos):
            tokens = self._placed({"tokens": tokens})["tokens"]
            return self.model.decode_step(cache, tokens, pos)

        return decode

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
