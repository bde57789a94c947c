"""Nested containers of tensors, walked in ``jax.tree``'s order.

A dict's values come by sorted key, a tuple's, list's or NamedTuple's in order;
``None`` is an empty subtree; anything else is a leaf. The port keeps this much of
``jax.tree`` so that its optimizer sums a tree's leaves, and its checkpointer numbers
them, in the reference's order: a checkpoint that one package writes restores in the
other.
"""

from __future__ import annotations

from typing import Any, Callable

_LEAF = object()


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def flatten(tree, is_leaf: Callable | None = None) -> tuple[list, Any]:
    """(leaves, treedef): the leaves in order, and the structure that ``unflatten``
    fills with new ones. ``is_leaf(x)`` True stops the walk at x."""
    leaves: list = []

    def walk(x):
        if is_leaf is not None and is_leaf(x):
            leaves.append(x)
            return _LEAF
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: walk(x[k]) for k in sorted(x)}
        if _is_namedtuple(x):
            return type(x)(*(walk(c) for c in x))
        if isinstance(x, (tuple, list)):
            return type(x)(walk(c) for c in x)
        leaves.append(x)
        return _LEAF

    return leaves, walk(tree)


def unflatten(treedef, leaves) -> Any:
    """``treedef`` (from ``flatten``) with its leaves taken from ``leaves`` in order."""
    it = iter(leaves)

    def build(d):
        if d is _LEAF:
            return next(it)
        if d is None:
            return None
        if isinstance(d, dict):
            return {k: build(v) for k, v in d.items()}
        if _is_namedtuple(d):
            return type(d)(*(build(c) for c in d))
        return type(d)(build(c) for c in d)

    out = build(treedef)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("more leaves than the tree holds")
    return out


def leaves(tree, is_leaf: Callable | None = None) -> list:
    return flatten(tree, is_leaf)[0]


def map(fn: Callable, tree, *rest, is_leaf: Callable | None = None) -> Any:
    """``fn`` of each leaf (and of the leaves at the same place in ``rest``)."""
    flat, treedef = flatten(tree, is_leaf)
    others = [flatten(r, is_leaf)[0] for r in rest]
    for o in others:
        if len(o) != len(flat):
            raise ValueError(f"trees of {len(flat)} and {len(o)} leaves")
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])
