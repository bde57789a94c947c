"""Plain PyTorch version of the pairwise similarity operator (MSET2 hot spot).

The CPU path and the yardstick the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch

KINDS = ("inverse_distance", "gaussian")


def similarity_ref(x, y, gamma: float = 1.0, kind: str = "inverse_distance"):
    """S[i, j] = h(||x_i - y_j||). x: (m, n), y: (b, n) -> (m, b) f32.

    kind:
      inverse_distance — 1 / (1 + d / gamma)          (MSET-style nonlinear op)
      gaussian         — exp(-d^2 / (2 gamma^2))      (AAKR kernel)
    """
    xf, yf = x.float(), y.float()
    x2 = torch.sum(xf * xf, dim=-1)[:, None]
    y2 = torch.sum(yf * yf, dim=-1)[None, :]
    d2 = torch.clamp(x2 + y2 - 2.0 * (xf @ yf.T), min=0.0)
    if kind == "inverse_distance":
        return 1.0 / (1.0 + torch.sqrt(d2) / gamma)
    if kind == "gaussian":
        return torch.exp(-d2 / (2.0 * gamma * gamma))
    raise ValueError(f"unknown similarity kind {kind!r}")
