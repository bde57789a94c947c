"""Error-feedback int8 gradient compression for the data-parallel all-reduce: the
JAX package's ``distributed/compression.py``.

Quantize (grad + residual) to int8 with a per-tensor scale, and keep the
quantization error as the residual for the next step. ``torch.round`` rounds half to
even, as ``jnp.round`` does, and the quotients are taken by tensors (the card takes
a quotient by a Python number as a product with its reciprocal), so the int8 values
are the reference's bit for bit.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import _tree

F32 = torch.float32


class EFState(NamedTuple):
    residual: Any


def init(grads_like) -> EFState:
    return EFState(_tree.map(lambda g: torch.zeros_like(g, dtype=F32), grads_like))


def quantize(x):
    """f32 -> (int8, scale). Symmetric per-tensor."""
    amax = x.abs().max() + 1e-12
    scale = amax / amax.new_tensor(127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q, scale):
    return q.to(F32) * scale


def compress_grads(grads, state: EFState):
    """Returns (quantized_tree [(q, scale) per leaf], new_state)."""

    def one(g, r):
        x = g.to(F32) + r
        q, s = quantize(x)
        return (q, s), x - dequantize(q, s)

    flat, treedef = _tree.flatten(grads)
    pairs = [one(g, r) for g, r in zip(flat, _tree.leaves(state.residual))]
    return (
        _tree.unflatten(treedef, [qs for qs, _ in pairs]),
        EFState(_tree.unflatten(treedef, [err for _, err in pairs])),
    )


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and not isinstance(x[0], dict)


def decompress_grads(qtree):
    return _tree.map(lambda qs: dequantize(*qs), qtree, is_leaf=_is_pair)
