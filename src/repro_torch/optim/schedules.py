"""LR schedules (warmup + cosine decay): the JAX package's ``optim/schedules.py``.

A schedule maps the optimizer's int step (a 0-dim tensor) to the learning rate as a
float32 0-dim tensor on the step's device, computed in float32 as the reference
computes it. Divisors are tensors: on the card PyTorch divides by a Python number as a
product with its reciprocal, which can differ from the quotient in the last bit.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    def schedule(step):
        s = torch.as_tensor(step).to(F32)
        warm = peak_lr * s / s.new_tensor(max(warmup_steps, 1))
        span = s.new_tensor(max(total_steps - warmup_steps, 1))
        prog = torch.clamp((s - warmup_steps) / span, 0, 1)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)

    return schedule


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=F32, device=torch.as_tensor(step).device)
