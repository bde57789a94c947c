"""Public model API: ``build_model(cfg)`` -> ``Model`` with prefill / decode and a
KV cache; counterpart of the JAX package's ``models/model.py`` (serving only).

``Model.from_numpy`` takes the reference's ``init_values`` tree (numpy arrays, each
block parameter with the leading ``stack`` dim) and ``to_numpy`` gives it back, so
both packages can compute the same thing on the same weights.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, transformer


class Model(nn.Module):
    """The decoder-only LM (dense, MoE, SSM and hybrid families). ``Model(cfg, device)``
    allocates the parameters uninitialised on ``device`` (None -> cuda); ``build_model``
    draws them, ``from_numpy`` copies them in. The two together stand for the
    reference's ``init_lm``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.program = transformer.check_ported(cfg)
        P = len(self.program)
        self.embed = layers.Embed(cfg, device)
        self.final_norm = layers.Norm(cfg, cfg.d_model, device)
        self.blocks = nn.ModuleList(
            transformer.Block(cfg, self.program[i % P], device) for i in range(cfg.n_layers)
        )

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def init_weights(self, generator: torch.Generator) -> "Model":
        """The reference's init scheme (``dense_init`` normals, unit norm scales, zero
        biases), drawn from ``generator`` in module order."""
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    # ---- steps ----
    @torch.no_grad()
    def prefill(self, tokens, cache=None, step=layers._run):
        """tokens (B, S) -> (cache, last-token logits (B, 1, V)). Without a cache, one
        of length S is allocated; a given one (max_seq >= S) is filled in place."""
        if cache is None:
            cache = self.init_cache(*tokens.shape)
        return transformer.forward_prefill(self, tokens, cache, step)

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        return transformer.decode_step(self, cache, tokens, pos)

    def cache_specs(self, batch: int, max_seq: int):
        return transformer.cache_specs(self.cfg, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int):
        """Zero cache in the reference's tree (``cache_specs``): per period position
        {"attn": {"k", "v"}} or {"ssm": {"conv", "state"}}, each stacked over n_stack;
        prefill and decode fill it in place."""

        def zeros(spec):
            return torch.zeros(spec[0], dtype=spec[1], device=self.device)

        return tuple(
            {kind: {n: zeros(s) for n, s in e.items()} for kind, e in entry.items()}
            for entry in self.cache_specs(batch, max_seq)
        )

    # ---- the reference's parameter tree ----
    def _tree_leaves(self):
        """(path in the reference's tree, stack index or None, parameter) for each
        parameter; block parameters are stacked over the layers of one position."""
        P = len(self.program)
        for name, p in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "blocks":
                i = int(parts[1])
                yield ("blocks", i % P, *parts[2:]), i // P, p
            else:
                yield tuple(parts), None, p

    def to_numpy(self) -> dict:
        """The parameters as the reference's ``init_values`` tree, in float32."""
        tree: dict = {}
        stacks: dict = {}
        for path, s, p in self._tree_leaves():
            a = p.detach().float().cpu().numpy()
            if s is None:
                _set(tree, path, a)
            else:
                stacks.setdefault(path, {})[s] = a
        for path, by_stack in stacks.items():
            _set(tree, path, np.stack([by_stack[s] for s in sorted(by_stack)]))
        tree["blocks"] = tuple(tree["blocks"][j] for j in range(len(self.program)))
        return tree

    @classmethod
    def from_numpy(cls, cfg: ArchConfig, params: dict, device=None) -> "Model":
        """A model holding the reference tree ``params`` (numpy or anything
        ``np.asarray`` takes), on ``device`` (None -> cuda)."""
        model = cls(cfg, device)
        with torch.no_grad():
            for path, s, p in model._tree_leaves():
                a = _get(params, path)
                a = np.asarray(a if s is None else a[s])
                if a.shape != tuple(p.shape):
                    raise ValueError(f"{'.'.join(map(str, path))}: {a.shape} vs {tuple(p.shape)}")
                p.copy_(torch.from_numpy(np.array(a, np.float32)))
        return model


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def build_model(cfg: ArchConfig, device=None, generator: torch.Generator | None = None) -> Model:
    """A model with random weights drawn on ``device`` (None -> cuda) from
    ``generator`` (None -> a generator on that device seeded with 0)."""
    model = Model(cfg, device)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    return model.init_weights(generator)
