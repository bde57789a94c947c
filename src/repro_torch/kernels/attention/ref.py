"""Plain PyTorch version of flash attention (the CPU path, and the yardstick the CUDA
kernel is held against on the card).

A copy of the JAX package's ``mha_ref``: float32 scores, float32 softmax, float32
P·V, the output cast to q's dtype. Queries are processed in chunks of ``Q_CHUNK``
rows, so the live float32 score buffer is (B, H, chunk, S) rather than (B, H, S, S):
the unchunked one is 1.6 GB at B = 4, S = 2048, H = 24 and 103 GB at S = 32k.
"""

from __future__ import annotations

import torch

Q_CHUNK = 1024  # query rows per chunk


def mha_ref(q, k, v, causal: bool = True, scale=None, *, q_offset: int = 0):
    """q: (B, Sq, H, hd); k/v: (B, S, H, hd), the same head count (GQA is expanded
    by the caller). Query row i sits at absolute position ``q_offset + i`` for the
    causal mask. Returns (B, Sq, H, hd) in q's dtype."""
    B, Sq, H, hd = q.shape
    S = k.shape[1]
    scale = scale or (hd**-0.5)
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    cols = torch.arange(S, device=q.device)
    for r0 in range(0, Sq, Q_CHUNK):
        qc = q[:, r0 : r0 + Q_CHUNK].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale
        if causal:
            rows = q_offset + r0 + torch.arange(qc.shape[1], device=q.device)
            s = s.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
        w = torch.softmax(s, dim=-1)
        out[:, r0 : r0 + Q_CHUNK] = torch.einsum("bhqk,bkhd->bqhd", w, vf).to(q.dtype)
    return out
