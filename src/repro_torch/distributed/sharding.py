"""Logical-axis sharding on a ``DeviceMesh``: the JAX package's
``distributed/sharding.py``.

Parameters and activations carry *logical* axis names; a rules table maps them onto
mesh axes (MaxText-style), with the reference's fallback when a dimension is not
divisible by the assigned mesh axes (e.g. kv_heads=1 under TP=16). ``spec_for``
resolves value for value as the reference does and returns a tuple in
``PartitionSpec``'s form; ``placements_for`` turns it into DTensor placements, one per
mesh dim: ``Shard(d)`` where that mesh axis is assigned to tensor dim d, ``Replicate()``
elsewhere.

A tensor dim on two mesh axes, ``("pod", "data")``, is ``Shard(0)`` on both. DTensor
orders such shards by mesh dim, which is JAX's order only while the tuple is in mesh
order (``DEFAULT_RULES`` has only that case); any other order raises.

``constrain`` stands for ``with_sharding_constraint``: the identity without a mesh, a
``redistribute`` of a DTensor, and a ``distribute_tensor`` of a plain tensor.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map

from repro_torch import _tree


class Box:
    """A parameter leaf bundled with its logical axis names (one per dim)."""

    __slots__ = ("value", "axes")

    def __init__(self, value, axes):
        self.value = value
        self.axes = tuple(axes)

    def __repr__(self):
        shape = getattr(self.value, "shape", None)
        return f"Box(shape={shape}, axes={self.axes})"


def is_box(x) -> bool:
    return isinstance(x, Box)


def unbox_values(tree):
    return _tree.map(lambda b: b.value, tree, is_leaf=is_box)


def unbox_axes(tree):
    return _tree.map(lambda b: b.axes, tree, is_leaf=is_box)


# Mapping: logical axis -> mesh axis (str), tuple of mesh axes, or None.
DEFAULT_RULES: dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),
    "act_seq": None,
    "sp_seq": "model",  # sequence-parallel fallback (heads % TP != 0)
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    # weights
    "embed": "data",  # FSDP axis
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "state": None,
    "conv": None,
    "stack": None,  # scan-stacked layer dim
    # kv / ssm caches (serving)
    "cache_batch": ("pod", "data"),
    "cache_heads": None,
    "cache_seq": "model",  # sequence-sharded KV cache (SP) — fits 32k..500k
    "cache_dim": None,
}


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def lift(t, like):
    """``t`` as a DTensor replicated on ``like``'s mesh when ``like`` is a DTensor (a
    tensor the forward makes, such as positions or a mask, meeting sharded ones); ``t``
    itself otherwise."""
    if isinstance(like, DTensor) and not isinstance(t, DTensor):
        mesh = like.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t


def owned(size: int, mesh, placements, dim: int, coord=None) -> tuple[int, int]:
    """[lo, hi): the block of a tensor dim of ``size`` that ``placements`` may shard,
    held by the rank at mesh coordinate ``coord`` (None: this rank), mesh dim by mesh
    dim as DTensor orders the shards. An uneven split is ``torch.chunk``'s, as
    DTensor's: blocks of ceil(n / members), the last ones short or empty."""
    lo, hi = 0, size
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            chunk = -(-(hi - lo) // mesh.shape[i])
            at = mesh.get_local_rank(i) if coord is None else coord[i]
            start = min(lo + at * chunk, hi)
            lo, hi = start, min(start + chunk, hi)
    return lo, hi


def _block(shape, mesh, placements, coord=None) -> tuple:
    """The slices of a tensor of ``shape`` that the rank at ``coord`` (None: this rank)
    holds: ``owned`` for every dim."""
    return tuple(
        slice(*owned(n, mesh, placements, d, coord)) for d, n in enumerate(shape)
    )


def local_part(t, sharding):
    """``t`` (a tensor or numpy array, the same whole value on every rank) as a DTensor
    with ``sharding`` = ``(mesh, placements)`` made from the block this rank owns, on the
    mesh's device: no collective. ``t`` itself (as a tensor) for None."""
    t = torch.as_tensor(t)
    if sharding is None:
        return t
    mesh, placements = sharding
    local = t[_block(t.shape, mesh, placements)].contiguous().to(mesh.device_type)
    stride = torch.empty(t.shape, device="meta").stride()
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=t.shape, stride=stride
    )


def full(t):
    """The whole value of a DTensor on every rank (a collective: every rank must call
    it, in the same order); any other value as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def to_main(t):
    """A DTensor's whole value on rank 0 (or alone) as a tensor on the host, None on every
    other rank: one copy of it in the world, gathered block by block (``dist.gather``, a
    collective: every rank calls it, in the same order). Any other value as it is."""
    if not isinstance(t, DTensor):
        return t
    main = dist.get_rank() == 0
    mesh = t.device_mesh
    placements = [Replicate() if isinstance(p, Partial) else p for p in t.placements]
    if placements != list(t.placements):  # a pending sum is reduced first
        t = t.redistribute(mesh, placements)
    world = dist.get_world_size()
    if mesh.mesh.numel() != world:
        raise ValueError(f"a mesh of {mesh.mesh.numel()} ranks in a world of {world}")
    local = t.to_local()
    if world == 1:
        return local.cpu()
    # every block padded to the largest, the first one's (torch.chunk's split)
    top = _block(t.shape, mesh, placements, (0,) * mesh.ndim)
    buf = local.new_zeros([b.stop - b.start for b in top])
    buf[tuple(slice(0, n) for n in local.shape)] = local
    parts = [torch.empty_like(buf) for _ in range(world)] if main else None
    dist.gather(buf, parts, dst=0)
    if not main:
        return None
    out = torch.empty(t.shape, dtype=t.dtype)
    for rank, part in enumerate(parts):
        block = _block(t.shape, mesh, placements, (mesh.mesh == rank).nonzero()[0].tolist())
        out[block] = part[tuple(slice(0, b.stop - b.start) for b in block)].cpu()
    return out


def local_call(fn, out_placements: tuple, *args):
    """``fn`` on the local shards of the DTensor ``args`` (``local_map``), its outputs
    placed by ``out_placements``, one entry per output (None for a non-tensor). The
    gradient of an input replicated along a mesh dim along which an output varies
    (sharded or partial) is partial there: each rank used it on its own part."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    in_pl = tuple(a.placements if isinstance(a, DTensor) else None for a in args)
    varies = [
        any(o is not None and not isinstance(o[i], Replicate) for o in out_placements)
        for i in range(mesh.ndim)
    ]
    grad_pl = tuple(
        None
        if pl is None
        else tuple(Partial() if v and isinstance(p, Replicate) else p for p, v in zip(pl, varies))
        for pl in in_pl
    )
    return local_map(fn, out_placements, in_pl, grad_pl, device_mesh=mesh)(*args)


class ShardingRules:
    """Resolve logical axes -> PartitionSpec / placements for a mesh (no-op w/o mesh)."""

    def __init__(self, mesh=None, rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    # -- resolution ---------------------------------------------------------
    def _mesh_axis_sizes(self) -> dict[str, int]:
        return {} if self.mesh is None else mesh_axis_sizes(self.mesh)

    def axis_size(self, name: str) -> int:
        return self._mesh_axis_sizes().get(name, 1)

    def spec_for(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> tuple:
        """A PartitionSpec's entries (None, a mesh axis, or a tuple of them), dropping
        assignments that do not divide the dim or that reuse an already-used mesh
        axis, trailing Nones trimmed."""
        sizes = self._mesh_axis_sizes()
        used: set[str] = set()
        entries = []
        for dim, logical in zip(shape, axes):
            assignment = self.rules.get(logical) if logical else None
            if assignment is None:
                entries.append(None)
                continue
            axes_tuple = assignment if isinstance(assignment, tuple) else (assignment,)
            # keep only mesh axes that exist and are unused
            axes_tuple = tuple(a for a in axes_tuple if a in sizes and a not in used)
            # drop trailing axes until the product divides the dim
            while axes_tuple and dim % math.prod(sizes[a] for a in axes_tuple) != 0:
                axes_tuple = axes_tuple[:-1]
            if not axes_tuple:
                entries.append(None)
                continue
            used.update(axes_tuple)
            entries.append(axes_tuple if len(axes_tuple) > 1 else axes_tuple[0])
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def placements_for(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> tuple:
        """One placement per mesh dim: Shard(d) where the mesh axis is assigned to
        tensor dim d, Replicate() elsewhere."""
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec_for(axes, shape)):
            group = entry if isinstance(entry, tuple) else (entry,) if entry else ()
            order = [names.index(a) for a in group]
            if order != sorted(order):
                raise ValueError(
                    f"{group} shards one dim out of mesh order {tuple(names)}: DTensor would "
                    "order its shards otherwise than the reference"
                )
            for i in order:
                out[i] = Shard(d)
        return tuple(out)

    def sharding_for(self, axes: Sequence[Optional[str]], shape: Sequence[int]):
        """``(mesh, placements)``, or None without a mesh."""
        if self.mesh is None:
            return None
        return self.mesh, self.placements_for(axes, shape)

    # -- use sites ----------------------------------------------------------
    def constrain(self, x, axes: Sequence[Optional[str]]):
        """Place ``x`` as the rules say on the mesh; the identity without one."""
        if self.mesh is None:
            return x
        placements = self.placements_for(axes, x.shape)
        if isinstance(x, DTensor):
            if tuple(x.placements) == placements:
                return x
            return x.redistribute(self.mesh, placements)
        return distribute_tensor(x, self.mesh, placements)

    def tree_shardings(self, boxed_tree):
        """``(mesh, placements)`` for each leaf of a Box tree (params or cache specs)."""
        return _tree.map(
            lambda b: self.sharding_for(b.axes, b.value.shape), boxed_tree, is_leaf=is_box
        )


def is_sharding(x) -> bool:
    """Whether x is a ``(mesh, placements)`` pair."""
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], DeviceMesh)


def make_rules(mesh, overrides: Optional[dict] = None) -> ShardingRules:
    return ShardingRules(mesh, overrides)


def _local_shape(shape, mesh, placements) -> list:
    return [b.stop - b.start for b in _block(shape, mesh, placements)]


def place(t: torch.Tensor, sharding, requires_grad: Optional[bool] = None):
    """``t`` as a DTensor with ``sharding`` = ``(mesh, placements)``, ``t`` itself for
    None; a DTensor is redistributed. No collective otherwise: a meta tensor becomes its
    local shard directly (no global allocation); any other, the same whole value on
    every rank, keeps this rank's block (``local_part``)."""
    if sharding is None:
        return t
    mesh, placements = sharding
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == tuple(placements) else t.redistribute(mesh, placements)
    if t.device.type == "meta":
        out = zeros(t.shape, t.dtype, "meta", sharding)
    else:
        out = local_part(t.detach(), sharding)
    if requires_grad is not None:
        out.requires_grad_(requires_grad)
    return out


def zeros(shape, dtype, device, sharding):
    """A zero tensor of ``shape``, made shard by shard as a DTensor with ``sharding`` =
    ``(mesh, placements)`` (plain for None): no rank holds the whole."""
    if sharding is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    mesh, placements = sharding
    local = torch.zeros(_local_shape(shape, mesh, placements), dtype=dtype, device=device)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(
        local, mesh, placements, run_check=False, shape=torch.Size(shape), stride=stride
    )
