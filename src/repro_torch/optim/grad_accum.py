"""Microbatch gradient accumulation: the JAX package's ``optim/grad_accum.py``.

The reference scans the microbatches (microbatch 0 first, then the rest added in
order) and multiplies the sums by ``1 / n``. Here each microbatch's backward adds
its gradients into the parameters' ``.grad`` in the same order, so that one set of
gradients is live, whatever the number of microbatches.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import _tree


def microbatched_value_and_grad(loss_fn: Callable, n_microbatches: int):
    """loss_fn(params, batch) -> (loss, metrics), ``params`` a tree of leaf tensors
    that require grad. Batch leaves have a leading global-batch dim divisible by
    n_microbatches. Returns fn(params, batch) -> ((loss, metrics), grads), averaged over
    microbatches; grads is ``params``' tree of their ``.grad``, which fn sets."""

    def split(x, i):
        b = x.shape[0]
        if b % n_microbatches:
            raise ValueError(f"a batch of {b} does not split into {n_microbatches} microbatches")
        m = b // n_microbatches
        return x[i * m : (i + 1) * m]

    def fn(params, batch):
        leaves = _tree.leaves(params)
        for p in leaves:
            p.grad = None
        loss = metrics = None
        for i in range(n_microbatches):
            mb = batch if n_microbatches <= 1 else _tree.map(lambda x: split(x, i), batch)
            loss_i, metrics_i = loss_fn(params, mb)
            loss_i.backward()
            loss_i, metrics_i = loss_i.detach(), _tree.map(torch.Tensor.detach, metrics_i)
            if loss is None:
                loss, metrics = loss_i, metrics_i
            else:
                loss, metrics = loss + loss_i, _tree.map(torch.add, metrics, metrics_i)
        for p in leaves:
            if p.grad is None:  # a leaf the loss does not reach
                p.grad = torch.zeros_like(p)
        if n_microbatches > 1:
            inv = 1.0 / n_microbatches
            loss, metrics = loss * inv, _tree.map(lambda m: m * inv, metrics)
            for p in leaves:
                p.grad.mul_(inv)
        return (loss, metrics), _tree.map(lambda p: p.grad, params)

    return fn
