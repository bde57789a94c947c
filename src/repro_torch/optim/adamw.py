"""AdamW with decoupled weight decay and global-norm clipping: the JAX package's
``optim/adamw.py``.

The reference donates the parameters and returns new ones; here ``update`` writes
the parameters and the moments in place and returns them. The order of its
arithmetic is the reference's: the step is counted first and the learning rate looked
up at the new step; the bias corrections ``1 - b ** step`` are float32; the reported
``grad_norm`` is the norm before the clip, whose scale is ``min(1, clip_norm / (norm +
1e-9))``; weight decay applies to every leaf. The state's step lives on the
parameters' device, so that no quotient is taken by a host scalar (which the card
computes as a product with the reciprocal).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import _tree

F32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any
    nu: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def init(params) -> AdamWState:
    """Zero moments in float32 beside each leaf of ``params``, and step 0."""
    leaves = _tree.leaves(params)
    device = leaves[0].device if leaves else None
    zeros = lambda t: _tree.map(lambda p: torch.zeros_like(p, dtype=F32), t)
    step = torch.zeros((), dtype=torch.int32, device=device)
    return AdamWState(step=step, mu=zeros(params), nu=zeros(params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the per-leaf sums of squares, added in the tree's leaf order."""
    return torch.sqrt(sum(g.to(F32).square().sum() for g in _tree.leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """One AdamW step on ``params`` and the state's moments, in place. Returns
    (params, new_state, {"grad_norm", "lr"}); ``grads`` is left as it is."""
    step = state.step + 1
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr

    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(gnorm.new_tensor(cfg.clip_norm) / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    t = step.to(F32)
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    leaves = zip(*(_tree.leaves(t) for t in (params, grads, state.mu, state.nu)))
    for p, g, m, v in leaves:
        g = g.to(F32) if scale is None else g.to(F32) * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square().mul_(1 - b2))
        u = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        u.add_(cfg.weight_decay * p.to(F32))
        if p.dtype == F32:
            p.sub_(u.mul_(lr))
        else:
            p.copy_(p.to(F32).sub_(u.mul_(lr)))
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}
