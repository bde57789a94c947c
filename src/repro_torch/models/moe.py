"""Mixture-of-Experts FFN: the single-device (``gather``) path of the JAX package's
``models/moe.py``.

Tokens are routed to their top-k experts, ranked within each expert by a cumsum over
the flattened (token, slot) order, and gathered into an (E, C) buffer; slots past an
expert's capacity C are dropped, as in the reference. The expert-parallel path
(``_moe_ep``: shard_map and all_to_all) and expert padding (``padded_experts``)
wait for ``distributed/``; without a mesh the reference always takes this path.

Two orders are fixed where PyTorch promises none, so that the port gives the
reference's bits and one run on the card gives the same tokens as the next:

* ties in the top k go to the lower expert index (``lax.top_k``'s order): the top k
  come from a stable descending sort, where ``torch.topk`` leaves ties unordered;
* a token's k expert outputs are summed in ascending expert id, starting from zero,
  in the working dtype (the order of the reference's ``.at[idx].add`` on the CPU),
  where ``index_add_`` on the card adds by atomics in no fixed order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import _param, _run, dense_init_, working_dtype

F32 = torch.float32


def _expert_ffn(mlp_type: str, p, xg):
    """xg: (E, C, d) -> (E, C, d) through each expert's FFN (``p``: w_up, w_down and,
    for swiglu, w_gate, each stacked over E)."""
    h = torch.bmm(xg, p["w_up"].to(xg.dtype))
    if mlp_type == "swiglu":
        h = F.silu(torch.bmm(xg, p["w_gate"].to(xg.dtype))) * h
    elif mlp_type == "relu2":
        h = F.relu(h).square()
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["w_down"].to(h.dtype))


def _route(cfg: ArchConfig, logits):
    """Top-k routing. logits: (T, E). Returns (expert ids (T, k), weights (T, k) in the
    logits' dtype, the load-balancing aux loss). Softmax, top k and renormalisation in
    float32; ties go to the lower expert index."""
    k = cfg.n_experts_per_tok
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :k], top_i[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    # Switch-style load balancing: E * sum_e f_e * p_e
    E = logits.shape[-1]
    me = probs.mean(0)
    ce = _one_hot(top_i, E).to(F32).sum(1).mean(0)  # fraction routed
    aux = E * (me * ce).sum() / k
    return top_i, top_p.to(logits.dtype), aux


def _one_hot(idx, E: int):
    """(..., E) int32 one-hot of ``idx``. ``F.one_hot`` reads its input's range back to
    the host on the card, a synchronisation in every MoE layer."""
    return (idx[..., None] == torch.arange(E, device=idx.device)).to(torch.int32)


def _slots(token_e, E: int, C: int):
    """Each (token, slot)'s place in the flattened (E, C) buffer: e * C + its rank
    within expert e in (token, slot) order, or the sentinel E * C when that rank is
    past the capacity (the slot is dropped). token_e: (T * k,) expert ids.

    The one-hot is laid out (E, T * k) so that the cumsum runs along the contiguous
    dim: along the outer dim the card scans each of the E columns with one thread."""
    onehot = _one_hot(token_e, E).T.contiguous()  # (E, Tk)
    rank = ((torch.cumsum(onehot, 1) - 1) * onehot).sum(0)  # 0-based rank, (Tk,)
    return torch.where(rank < C, token_e * C + rank, E * C)


def _group(token_e, token_w, T: int, E: int, C: int):
    """The reference's ``_group``: (E, C) buffers of token ids (T, the pad row, where
    a place is empty) and combine weights (0 there). token_e / token_w: (T * k,).
    A dropped slot's weight lands in the sentinel place, which is cut off, so its
    gradient is zero, as the reference's ``mode="drop"`` write gives."""
    Tk = token_e.shape[0]
    slot = _slots(token_e, E, C)
    tok_ids = torch.arange(Tk, device=token_e.device, dtype=torch.int32) // (Tk // T)
    # dropped slots all write the sentinel place E * C, cut off below; kept ones are unique
    tok_of_slot = torch.full((E * C + 1,), T, dtype=torch.int32, device=token_e.device)
    w_of_slot = torch.zeros(E * C + 1, dtype=token_w.dtype, device=token_w.device)
    tok_of_slot[slot] = tok_ids
    w_of_slot[slot] = token_w
    return tok_of_slot[: E * C].view(E, C), w_of_slot[: E * C].view(E, C), slot


def capacity(cfg: ArchConfig, T: int) -> int:
    """Slots per expert for T tokens: the reference's expression, so the same float
    rounds to the same int; at most T."""
    k = cfg.n_experts_per_tok
    C = max(1, int(math.ceil(T * k / cfg.n_experts * cfg.capacity_factor)))
    return min(C, T)


def _combine(yg, slot, top_i, T: int):
    """Each token's k expert rows summed in ascending expert id from zero, in yg's
    dtype; a dropped slot adds a zero row. yg: (E * C + 1, d), its last row zero (the
    sentinel's); slot, top_i: (T * k,), (T, k)."""
    k = top_i.shape[1]
    order = torch.argsort(top_i, dim=1, stable=True)
    rows = yg[torch.gather(slot.view(T, k), 1, order)]  # (T, k, d), ascending expert id
    y = torch.zeros(T, yg.shape[1], dtype=yg.dtype, device=yg.device)
    for j in range(k):
        y = y + rows[:, j]
    return y


def apply_moe(cfg: ArchConfig, p, x, step=_run):
    """The reference's ``_moe_gather`` (and so ``apply_moe`` without a mesh).
    x: (B, S, d) -> (y (B, S, d), aux). ``p``: router (d, E_real) and the expert stacks,
    E = w_up.shape[0]."""
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    top_i, top_w, aux = step("router + top-k", lambda: _route(cfg, xf @ p["router"].to(x.dtype)))
    E = p["w_up"].shape[0]
    C = capacity(cfg, T)

    def dispatch():
        idx, w, slot = _group(top_i.reshape(-1), top_w.reshape(-1), T, E, C)
        xg = torch.cat([xf, xf.new_zeros(1, d)])[idx]  # (E, C, d)
        return xg, w, slot

    xg, w, slot = step("group + gather", dispatch)
    yg = step("expert FFNs", lambda: _expert_ffn(cfg.mlp_type, p, xg))

    def combine():
        weighted = yg.view(E * C, d) * w.view(E * C, 1).to(x.dtype)
        # the last row is the sentinel's zero
        return _combine(F.pad(weighted, (0, 0, 0, 1)), slot, top_i, T)

    y = step("combine", combine)
    return y.view(B, S, d), aux


class MoE(nn.Module):
    """``init_moe``'s parameters (no expert padding): router (d, E), w_up and w_gate
    (E, d, ff), w_down (E, ff, d), all in the working dtype (float32 for training)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.cfg = cfg
        d, ff, E, dt = cfg.d_model, cfg.moe_d_ff, cfg.n_experts, working_dtype(cfg)
        self.router = _param((d, E), dt, device)
        self.w_up = _param((E, d, ff), dt, device)
        self.w_down = _param((E, ff, d), dt, device)
        if cfg.mlp_type == "swiglu":
            self.w_gate = _param((E, d, ff), dt, device)

    def reset_parameters(self, generator):
        dense_init_(self.router, generator)
        # in_axis=1 as in init_moe: fan_in is E * d (E * ff for w_down)
        for w in (self.w_up, self.w_down) + ((self.w_gate,) if hasattr(self, "w_gate") else ()):
            dense_init_(w, generator, in_axis=1)

    def forward(self, x, step=_run):
        return apply_moe(self.cfg, dict(self.named_parameters()), x, step)
