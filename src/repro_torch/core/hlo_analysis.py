"""Roofline inputs for one step, counted op by op: the JAX package's
``core/hlo_analysis.py``.

There is no HLO here. The reference lowers and compiles a workload and reads XLA's
``cost_analysis()`` and ``memory_analysis()``. ``analyze`` runs the step function
once on ``device="meta"`` tensors (shapes and dtypes, no data) under a
``TorchDispatchMode`` that sees every ATen op the step runs, its backward and any
recomputation included, and counts them by XLA's HloCostAnalysis rules:

* a matmul-like op (``mm``, ``addmm``, ``bmm``, ``baddbmm``, a convolution and its
  backward) by its formula from ``torch.utils.flop_counter``: 2·M·N·K for a product;
* any other elementwise op, converts, compares and selects included, one FLOP an
  output element; a reduction one an input element; a softmax four;
* transcendentals (exp, log, tanh, rsqrt, sigmoid, ...) apart, out of ``flops``;
* copies, gathers, scatters, sorts and fills no FLOP;
* bytes accessed: each op's tensor inputs read and outputs written, the eager
  program's traffic; views, ``detach`` and metadata ops move nothing.

A data-dependent op (``.item()``, ``nonzero``, ``bincount``) has no meta kernel and
raises, and so does an op on a tensor with elements off the meta device: a count never
guesses.
A Python loop is counted once a pass, so no probe needs unrolling.

``parse_collectives`` and its regexes are the reference's, pure Python, for HLO text;
at one chip the port runs no collective and ``collectives`` stays empty.
"""

from __future__ import annotations

import functools
import math
import re
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_DTYPE_BYTES = {
    "pred": 1,
    "s8": 1,
    "u8": 1,
    "s16": 2,
    "u16": 2,
    "f16": 2,
    "bf16": 2,
    "s32": 4,
    "u32": 4,
    "f32": 4,
    "s64": 8,
    "u64": 8,
    "f64": 8,
    "c64": 8,
    "c128": 16,
    "f8e4m3fn": 1,
    "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# collective op line: "%name = <shapes> <kind>(" or "ROOT %name = ..."
_COLL_LINE_RE = re.compile(
    r"=\s*(?P<shapes>\([^)]*\)|[\w\[\]{},\s]*?)\s*"
    r"(?P<kind>all-gather-start|all-gather|all-reduce-start|all-reduce|"
    r"reduce-scatter|all-to-all|collective-permute-start|collective-permute)\("
)


def _shape_bytes(text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Sum per-device operand/result bytes of collective ops in post-SPMD HLO."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _COLL_LINE_RE.search(line)
        if not m:
            continue
        kind = m.group("kind").replace("-start", "")
        nbytes = _shape_bytes(m.group("shapes"))
        stats.bytes_by_kind[kind] = stats.bytes_by_kind.get(kind, 0) + nbytes
        stats.count_by_kind[kind] = stats.count_by_kind.get(kind, 0) + 1
    return stats


@dataclass
class CompiledCost:
    """Everything the roofline needs, in GLOBAL units (per-device x n_devices)."""

    n_devices: int
    flops: float  # global FLOPs per step
    bytes_accessed: float  # global HBM traffic per step
    collective_bytes: float  # global collective traffic per step
    collectives: CollectiveStats
    peak_memory_per_device: float
    argument_bytes_per_device: float
    temp_bytes_per_device: float
    output_bytes_per_device: float

    def as_dict(self) -> dict:
        return {
            "n_devices": self.n_devices,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "collective_bytes_by_kind": dict(self.collectives.bytes_by_kind),
            "collective_count_by_kind": dict(self.collectives.count_by_kind),
            "peak_memory_per_device": self.peak_memory_per_device,
            "argument_bytes_per_device": self.argument_bytes_per_device,
            "temp_bytes_per_device": self.temp_bytes_per_device,
            "output_bytes_per_device": self.output_bytes_per_device,
        }


# Elementwise ops XLA counts as transcendentals, not FLOPs (by ATen name).
_TRANSCENDENTAL = set(
    (
        "exp exp2 expm1 log log1p log2 log10 tanh rsqrt sqrt sigmoid silu silu_backward gelu "
        "gelu_backward sin cos tan atan atan2 erf erfc erfinv softplus log_sigmoid_forward"
    ).split()
)
# FLOPs an element of ops that are a few elementwise ops and reductions in one:
# softmax = max, subtract, sum, divide (its exp a transcendental); its backward
# multiply, sum, subtract, multiply; log-softmax's backward sum, multiply, subtract.
_PER_ELEMENT = {
    "_softmax": 4,
    "_log_softmax": 4,
    "_softmax_backward_data": 4,
    "_log_softmax_backward_data": 3,
    "cumsum": 1,
}
# Ops that copy: a FLOP an element only when they convert the dtype.
_COPIES = {"_to_copy", "copy_", "clone"}
# Ops that write without reading (their destination is not an operand read).
_WRITE_ONLY = {"copy_", "fill_", "zero_"}
# Allocations: they move nothing.
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}


def _tensors(tree, out=None) -> list:
    """The tensors in ``tree`` (nested tuples, lists and dicts), in order."""
    out = [] if out is None else out
    for x in tree.values() if isinstance(tree, dict) else tree:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list, dict)):
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the elements ``t`` addresses: a broadcast (zero-stride) dim reads one."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size() if t.numel() else 0


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[id(s)] = s.nbytes()
    return sum(seen.values())


class _Counter(TorchDispatchMode):
    """Counts FLOPs and bytes op by op, and the bytes of the storages that ops create,
    live at each moment (a storage leaves when its last view dies)."""

    def __init__(self, known_storages):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.high_water = 0
        self._known = set(known_storages)  # ids of storages that exist before the run
        self._new = {}  # id -> nbytes of storages made during the run and still alive

    def _freed(self, key, nbytes):
        if self._new.pop(key, None) is not None:
            self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors(kwargs, _tensors(args))
        outs = _tensors((out,))
        for t in ins + outs:  # an empty tensor (checkpoint's CPU marker) holds nothing
            if t.device.type != "meta" and t.numel():
                raise ValueError(
                    f"analyze counts meta tensors only: {func} has a tensor on {t.device}"
                )
        in_storages = {id(t.untyped_storage()) for t in ins}
        fresh = False
        for t in outs:
            s = t.untyped_storage()
            key = id(s)
            if key in in_storages or key in self._known or key in self._new:
                continue
            self._new[key] = nbytes = s.nbytes()
            weakref.finalize(s, self._freed, key, nbytes)
            self.live += nbytes
            fresh = True
        self.high_water = max(self.high_water, self.live)
        name, kind = _rule(func)
        if kind == "none" or (kind == "alias" and not fresh):
            return out
        read = ins[1:] if name in _WRITE_ONLY else ins
        self.bytes += sum(_nbytes(t) for t in read) + sum(_nbytes(t) for t in outs)
        n_out = sum(t.numel() for t in outs)
        if kind == "matmul":
            self.flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        elif kind == "fused":
            self.flops += _PER_ELEMENT[name] * n_out
        elif kind == "copy":
            if ins[-1].dtype != outs[0].dtype:
                self.flops += n_out
        elif kind == "reduction":
            self.flops += ins[0].numel()
        elif kind == "pow":
            if isinstance(args[1], (int, float)) and args[1] % 1 == 0:
                self.flops += n_out  # x ** k for a whole k is products, as jnp.square's
        elif kind == "pointwise":
            self.flops += n_out
        return out


@functools.cache
def _rule(func) -> tuple[str, str]:
    """(ATen name, how the op is counted): none (a view or an allocation: nothing),
    alias (nothing when its outputs alias its inputs), matmul, fused, copy, reduction,
    pow, pointwise (a FLOP an element), or data (bytes only: transcendentals, fills,
    gathers, scatters, sorts)."""
    name = func._schema.name.split("::")[-1]
    base = name.rstrip("_")
    inplace = func._schema.is_mutable  # it writes an argument
    # a view returns an alias its op does not write (an in-place op's return is written)
    returns = func._schema.returns
    view = any(r.alias_info is not None and not r.alias_info.is_write for r in returns)
    if view or name in _ALLOCS:
        return name, "none"
    if func._overloadpacket in flop_registry:
        return name, "matmul"
    if name in _PER_ELEMENT:
        return name, "fused"
    if name in _COPIES:
        return name, "copy"
    if torch.Tag.reduction in func.tags:
        return name, "reduction"
    if torch.Tag.pointwise in func.tags and base not in ("fill", "zero"):
        if base == "pow":
            return name, "pow"
        return name, "data" if base in _TRANSCENDENTAL else "pointwise"
    return name, "data" if inplace else "alias"


def analyze(fn, *args, n_devices: int = 1) -> CompiledCost:
    """Run ``fn(*args)`` once on meta tensors and count what it does.

    ``args`` (any tree of tensors; every tensor ``fn`` touches must be on the meta
    device) give ``argument_bytes_per_device``, the result ``output_bytes_per_device``
    (its storages that are not arguments: an argument updated in place is counted
    once, as an argument), and the high-water mark of the bytes that ops allocate
    during the run gives ``temp_bytes_per_device`` once the output is taken out. The
    counts are per device and, as the reference's, globalized by ``n_devices``."""
    arg_tensors = _tensors(args)
    arg_bytes = _storage_bytes(arg_tensors)
    counter = _Counter(id(t.untyped_storage()) for t in arg_tensors)
    with counter:
        out = fn(*args)
    known = {id(t.untyped_storage()) for t in arg_tensors}
    outs = [t for t in _tensors((out,)) if id(t.untyped_storage()) not in known]
    out_bytes = _storage_bytes(outs)
    temp = max(counter.high_water - out_bytes, 0)
    return CompiledCost(
        n_devices=n_devices,
        flops=counter.flops * n_devices,
        bytes_accessed=counter.bytes * n_devices,
        collective_bytes=0.0,
        collectives=CollectiveStats(),
        peak_memory_per_device=float(arg_bytes + temp + out_bytes),
        argument_bytes_per_device=float(arg_bytes),
        temp_bytes_per_device=float(temp),
        output_bytes_per_device=float(out_bytes),
    )
