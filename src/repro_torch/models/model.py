"""Public model API: ``build_model(cfg)`` -> ``Model`` with loss, prefill / decode
and a KV cache; counterpart of the JAX package's ``models/model.py``.

``Model.from_numpy`` takes the reference's ``init_values`` tree (numpy arrays, each
block parameter with the leading ``stack`` dim) and ``to_numpy`` gives it back, so
both packages can compute the same thing on the same weights; the same tree carries
AdamW's moments and checkpoints across. ``param_axes`` and ``cache_axes`` give the
logical axes of that tree's leaves and of the cache's, and ``Model.shard(rules)`` places
the parameters on a mesh by them.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import Box, place, unbox_axes, zeros
from repro_torch.models import layers, moe, transformer


class Model(nn.Module):
    """The LM of every family: decoder-only (dense, MoE, SSM, hybrid) or enc-dec, whose
    encoder stack (``enc_blocks``, ``enc_norm``) feeds each decoder block's cross-
    attention. ``Model(cfg, device)``
    allocates the parameters uninitialised on ``device`` (None -> cuda); ``build_model``
    draws them, ``from_numpy`` copies them in. The two together stand for the
    reference's ``init_lm``.

    A serving model stores its matmul weights and embeddings in the working dtype and
    takes no gradients; a ``trainable`` one stores every parameter in float32 with
    ``requires_grad``, as the reference keeps them, and casts each at use.

    ``ep_size`` pads the MoE's experts to a multiple of it (``moe.padded_experts``), as
    the reference's ``init_lm`` does for a mesh's ``model`` axis. ``rules`` is None
    until ``shard`` places the parameters on a mesh."""

    def __init__(self, cfg: ArchConfig, device=None, trainable: bool = False, ep_size=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.rules = None
        self.program = transformer.block_program(cfg)
        self.embed = layers.Embed(cfg, device)
        self.final_norm = layers.Norm(cfg, cfg.d_model, device)
        self.blocks = _stack(cfg, self.program, cfg.n_layers, device, ep_size)
        if cfg.encdec:
            self.enc_program = transformer.block_program(cfg, decoder=False)
            self.enc_blocks = _stack(cfg, self.enc_program, cfg.n_enc_layers, device, ep_size)
            self.enc_norm = layers.Norm(cfg, cfg.d_model, device)
        if trainable:
            self.float().requires_grad_(True)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def shard(self, rules) -> "Model":
        """Place every parameter on ``rules``' mesh as a DTensor by its logical axes
        (the reference's ``param_shardings``) and keep ``rules`` for the forward; with
        no mesh, nothing changes."""
        if rules is None or rules.mesh is None:
            return self
        for name, p in list(self.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            module = self.get_submodule(owner)
            d = place(p.data, rules.sharding_for(module.AXES[leaf], p.shape))
            setattr(module, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
        self.rules = rules
        return self

    def init_weights(self, generator: torch.Generator) -> "Model":
        """The reference's init scheme (``dense_init`` normals, unit norm scales, zero
        biases), drawn from ``generator`` in module order."""
        for m in self.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    # ---- steps ----
    def loss(self, batch, **kw):
        """The training loss: ``transformer.loss_fn`` on batch {"tokens", "targets", and
        for an enc-dec model "frames" or "src_tokens"}. Returns (loss, metrics)."""
        return transformer.loss_fn(self, batch, **kw)

    @torch.no_grad()
    def prefill(self, tokens, cache=None, step=layers._run, *, frames=None, src_tokens=None):
        """tokens (B, S) -> (cache, last-token logits (B, 1, V)). Without a cache, one
        of length S is allocated; a given one (max_seq >= S) is filled in place.

        An enc-dec model takes its source as exactly one of ``frames`` (B, S_enc, d),
        cast to the working dtype, and ``src_tokens`` (B, S_enc), with S_enc no more
        than ``cfg.enc_memory_len``, the cross cache's length; any other model takes
        neither. Anything else raises ValueError."""
        source = {"frames": frames, "src_tokens": src_tokens}
        given = [name for name, t in source.items() if t is not None]
        if self.cfg.encdec:
            if len(given) != 1:
                raise ValueError(
                    f"{self.cfg.name} is an encoder-decoder: prefill takes exactly one of "
                    f"frames= and src_tokens=, got {given or 'neither'}"
                )
            n = (frames if frames is not None else src_tokens).shape[1]
            if n > self.cfg.enc_memory_len:
                raise ValueError(
                    f"{self.cfg.name}: a source of {n} is longer than the cross cache "
                    f"(enc_memory_len {self.cfg.enc_memory_len})"
                )
        elif given:
            raise ValueError(f"{self.cfg.name} has no encoder: prefill takes no {given[0]}=")
        if cache is None:
            cache = self.init_cache(*tokens.shape)
        return transformer.forward_prefill(
            self, tokens, cache, step, frames=frames, src_tokens=src_tokens
        )

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        return transformer.decode_step(self, cache, tokens, pos)

    def cache_specs(self, batch: int, max_seq: int):
        return transformer.cache_specs(self.cfg, batch, max_seq)

    def cache_axes(self):
        """The logical axes of ``cache_specs``' leaves, in its tree (they do not depend
        on the batch or the length)."""
        return transformer.cache_axes(self.cfg)

    def init_cache(self, batch: int, max_seq: int):
        """Zero cache in the reference's tree (``cache_specs``): per period position
        {"attn": {"k", "v"}} or {"ssm": {"conv", "state"}}, with {"cross": {"ck", "cv"}}
        of ``enc_memory_len`` entries in the enc-dec family, each stacked over n_stack;
        prefill and decode fill it in place. On a mesh each entry is a DTensor placed
        by its logical axes (the reference's ``cache_shardings``)."""
        rules = self.rules
        specs, axes = self.cache_specs(batch, max_seq), self.cache_axes()

        def entry(spec, ax):
            sharding = None if rules is None else rules.sharding_for(ax, spec[0])
            return zeros(spec[0], spec[1], self.device, sharding)

        return tuple(
            {kind: {n: entry(e[n], a[kind][n]) for n in e} for kind, e in ent.items()}
            for ent, a in zip(specs, axes)
        )

    # ---- the reference's parameter tree ----
    def _programs(self) -> dict:
        """The block programs by their name in the reference's tree."""
        progs = {"blocks": self.program}
        if self.cfg.encdec:
            progs["enc_blocks"] = self.enc_program
        return progs

    def _tree_leaves(self):
        """(name, path in the reference's tree, stack index or None, parameter) for each
        parameter; block parameters (``blocks``, ``enc_blocks``) are stacked over the
        layers of one position."""
        periods = {name: len(prog) for name, prog in self._programs().items()}
        for name, p in self.named_parameters():
            parts = name.split(".")
            if parts[0] in periods:
                i, P = int(parts[1]), periods[parts[0]]
                yield name, (parts[0], i % P, *parts[2:]), i // P, p
            else:
                yield name, tuple(parts), None, p

    def _tree(self, convert, stack, values=None) -> dict:
        """The reference's parameter tree of the parameters (or of ``values[name]`` for
        each parameter name): each leaf ``convert(tensor)``, a stacked leaf ``stack`` of
        its layers' in stack order."""
        groups: dict = {}
        for name, path, s, p in self._tree_leaves():
            groups.setdefault(path, {})[s] = p if values is None else values[name]
        tree: dict = {}
        for path, by_stack in groups.items():
            if None in by_stack:
                _set(tree, path, convert(by_stack[None]))
            else:
                _set(tree, path, stack([convert(by_stack[s]) for s in sorted(by_stack)]))
        for name, prog in self._programs().items():
            tree[name] = tuple(tree[name][j] for j in range(len(prog)))
        return tree

    def to_numpy(self, values: dict | None = None) -> dict:
        """The parameters (or ``values``, a tensor for each parameter name, such as
        AdamW's moments) as the reference's ``init_values`` tree, in float32."""

        def host(t):  # a copy, never a view of a parameter on the CPU
            return t.detach().to("cpu", torch.float32, copy=True).numpy()

        return self._tree(host, np.stack, values)

    def tree_like(self) -> dict:
        """The reference's parameter tree with a meta tensor of each leaf's shape and no
        data: the structure ``Checkpointer.restore`` takes."""

        def stack(ts):
            return torch.empty((len(ts), *ts[0].shape), device="meta")

        return self._tree(lambda t: torch.empty(t.shape, device="meta"), stack)

    def abstract_params(self) -> dict:
        """The reference's ``abstract_params`` values: its parameter tree of float32
        meta tensors, for the dry-run (``param_axes`` gives its boxes' axes)."""
        return self.tree_like()

    def abstract_boxes(self) -> dict:
        """The reference's Box tree of its abstract parameters: each leaf a float32
        meta tensor with its logical axes, a stacked leaf's led by ``"stack"``."""
        boxes = {}
        for name, _, _, p in self._tree_leaves():
            owner, _, leaf = name.rpartition(".")
            meta = torch.empty(p.shape, device="meta")
            boxes[name] = Box(meta, self.get_submodule(owner).AXES[leaf])

        def stack(bs):
            meta = torch.empty((len(bs), *bs[0].value.shape), device="meta")
            return Box(meta, ("stack", *bs[0].axes))

        return self._tree(lambda b: b, stack, boxes)

    def param_axes(self) -> dict:
        """The logical axes of each leaf of the reference's parameter tree (its
        ``unbox_axes``), a stacked leaf's led by ``"stack"``."""
        return unbox_axes(self.abstract_boxes())

    def load_numpy(self, params: dict, into: dict | None = None) -> "Model":
        """Copy the reference tree ``params`` (numpy or anything ``np.asarray`` takes)
        into the parameters, or into ``into[name]`` for each parameter name. An expert
        stack padded otherwise than the model's (the reference pads to a multiple of
        its mesh's ``model`` axis) has its padding cut off or zero-filled: the router
        never selects a padded expert."""
        with torch.no_grad():
            for name, path, s, p in self._tree_leaves():
                a = _get(params, path)
                a = np.asarray(a if s is None else a[s])
                if isinstance(self.get_submodule(name.rpartition(".")[0]), moe.MoE):
                    a = _repad(a, p.shape)
                if a.shape != tuple(p.shape):
                    raise ValueError(f"{'.'.join(map(str, path))}: {a.shape} vs {tuple(p.shape)}")
                dst = p if into is None else into[name]
                dst.copy_(torch.from_numpy(np.array(a, np.float32)))
        return self

    @classmethod
    def from_numpy(
        cls, cfg: ArchConfig, params: dict, device=None, trainable: bool = False, ep_size=None
    ) -> "Model":
        """A model holding the reference tree ``params`` (numpy or anything
        ``np.asarray`` takes), on ``device`` (None -> cuda)."""
        return cls(cfg, device, trainable, ep_size).load_numpy(params)


def _stack(cfg: ArchConfig, program: list[dict], n_layers: int, device, ep_size) -> nn.ModuleList:
    """The layers of one stack in execution order: layer i runs ``program[i % P]``."""
    P = len(program)
    return nn.ModuleList(
        transformer.Block(cfg, program[i % P], device, ep_size) for i in range(n_layers)
    )


def _repad(a: np.ndarray, shape) -> np.ndarray:
    """An expert stack ``a`` (E, ...) cut or zero-padded to ``shape``'s expert count."""
    E = shape[0]
    if a.ndim != len(shape) or a.shape[1:] != tuple(shape[1:]) or a.shape[0] == E:
        return a
    if a.shape[0] > E:
        return a[:E]
    return np.concatenate([a, np.zeros((E - a.shape[0], *a.shape[1:]), a.dtype)])


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def build_model(
    cfg: ArchConfig,
    device=None,
    generator: torch.Generator | None = None,
    trainable: bool = False,
    ep_size=None,
) -> Model:
    """A model with random weights drawn on ``device`` (None -> cuda) from
    ``generator`` (None -> a generator on that device seeded with 0)."""
    model = Model(cfg, device, trainable, ep_size)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    return model.init_weights(generator)
