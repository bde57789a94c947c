"""Mixture-of-Experts FFN: the JAX package's ``models/moe.py``.

Two dispatch paths, as in the reference:

* ``gather``: tokens are routed to their top-k experts, ranked within each expert by a
  cumsum over the flattened (token, slot) order, and gathered into an (E, C) buffer;
  slots past an expert's capacity C are dropped. Without a mesh every call takes it;
  on a mesh (decode, or ``moe_impl`` other than "ep") the routing and the combine run
  on every device over all tokens and the expert FFNs are sharded over ``model``.
* ``ep`` (on a mesh): expert parallelism. The reference's ``shard_map`` is
  ``local_map`` with the same in and out specs: each ``model`` member routes its
  slice of the sequence, the (E, C) buffers go to the experts' owners with
  ``all_to_all_single`` and come back the same way; the reference's ``all_gather``
  of the sequence and ``pmean`` of the aux loss are the output's placements
  (sequence-sharded, and a partial average), which the next constraint resolves.

Experts are padded to a multiple of the model-axis size when necessary
(``padded_experts``; granite-moe: 40 -> 48); the router never selects padded experts.

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
from typing import Optional

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import local_call
from repro_torch.models.layers import _param, _run, dense_init_, working_dtype

F32 = torch.float32


def padded_experts(cfg: ArchConfig, ep_size: Optional[int]) -> int:
    e = cfg.n_experts
    if ep_size and e % ep_size != 0:
        e = math.ceil(e / ep_size) * ep_size
    return e


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
    """Slots per expert for T tokens (the real experts' count, not the padded one): the
    reference's expression, so the same float rounds to the same int; at most T."""
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


def _dispatch(cfg: ArchConfig, router, xf, E: int, C: int, step=_run):
    """Route xf (T, d) and gather the (E, C, d) buffer: (xg, w, slot, top_i, aux)."""
    T, d = xf.shape
    top_i, top_w, aux = step("router + top-k", lambda: _route(cfg, xf @ router.to(xf.dtype)))

    def dispatch():
        idx, w, slot = _group(top_i.reshape(-1), top_w.reshape(-1), T, E, C)
        xg = torch.cat([xf, xf.new_zeros(1, d)])[idx]  # (E, C, d)
        return xg, w, slot

    xg, w, slot = step("group + gather", dispatch)
    return xg, w, slot, top_i, aux


def _weighted_combine(yg, w, slot, top_i):
    """Each token's k expert rows, weighted by w, summed (``_combine``). yg: (E, C, d)."""
    E, C, d = yg.shape
    weighted = yg.reshape(E * C, d) * w.reshape(E * C, 1).to(yg.dtype)
    # the last row is the sentinel's zero
    return _combine(F.pad(weighted, (0, 0, 0, 1)), slot, top_i, top_i.shape[0])


def apply_moe(cfg: ArchConfig, p, x, step=_run, rules=None, impl: Optional[str] = None):
    """The reference's ``apply_moe``: ``_moe_ep`` when ``impl`` (default
    ``cfg.moe_impl``) is "ep" and ``rules`` has a mesh, the gather path otherwise.
    x: (B, S, d) -> (y (B, S, d), aux). ``p``: router (d, E_real) and the expert
    stacks, E = w_up.shape[0] (padded)."""
    impl = impl or cfg.moe_impl
    if rules is not None and rules.mesh is not None:
        if impl == "ep":
            return _moe_ep(cfg, p, x, rules)
        return _moe_gather_sharded(cfg, p, x, rules)
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    E = p["w_up"].shape[0]
    xg, w, slot, top_i, aux = _dispatch(cfg, p["router"], xf, E, capacity(cfg, T), step)
    yg = step("expert FFNs", lambda: _expert_ffn(cfg.mlp_type, p, xg))
    y = step("combine", lambda: _weighted_combine(yg, w, slot, top_i))
    return y.view(B, S, d), aux


def _moe_gather_sharded(cfg: ArchConfig, p, x, rules):
    """The gather path on a mesh: routing, grouping and the combine on every device
    over all T tokens (``local_map`` on replicated inputs); the (E, C, d) buffer
    constrained to ``("experts", None, "act_embed")``, so that the expert FFNs are
    sharded over ``model``, as the reference's constraint at ``_moe_gather`` has it."""
    mesh = rules.mesh
    R = (Replicate(),) * mesh.ndim
    B, S, d = x.shape
    T = B * S
    E = p["w_up"].shape[0]
    C = capacity(cfg, T)
    xf = x.reshape(T, d).redistribute(mesh, R)
    router = p["router"].redistribute(mesh, R)
    xg, w, slot, top_i, aux = local_call(
        lambda xf, router: _dispatch(cfg, router, xf, E, C), (R,) * 5, xf, router
    )
    xg = rules.constrain(xg, ("experts", None, "act_embed"))
    yg = _expert_ffn(cfg.mlp_type, p, xg).redistribute(mesh, R)
    y = local_call(_weighted_combine, (R,), yg, w, slot, top_i)
    return y.view(B, S, d), aux


def _moe_ep(cfg: ArchConfig, p, x, rules):
    """Expert-parallel dispatch over the ``model`` axis (the reference's ``shard_map``
    as ``local_map``, ``lax.all_to_all`` as ``all_to_all_single``). x arrives
    batch-sharded and replicated over ``model``; each member takes its slice of the
    sequence, routes it over all E (padded) experts, sends each owner its (E_l, C, d)
    part, runs its E_l local experts on what it receives, and sends the results back.
    The output leaves sequence-sharded over ``model`` and the aux loss a partial
    average, which the block's constraint and the loss resolve (the reference's
    ``all_gather`` and ``pmean``)."""
    mesh = rules.mesh
    names = list(mesh.mesh_dim_names)
    batch_dims = [names.index(a) for a in ("pod", "data") if a in names]
    ep_dim = names.index("model")
    ep = mesh.shape[ep_dim]
    E = p["w_up"].shape[0]
    if E % ep:
        raise ValueError(f"padded experts {E} not divisible by ep={ep}")
    E_l = E // ep
    k = cfg.n_experts_per_tok
    B, S, d = x.shape
    if S % ep:
        raise ValueError(f"seq {S} not divisible by model axis {ep}")
    S_l = S // ep
    m = mesh.get_local_rank(ep_dim)
    group = mesh.get_group(ep_dim)

    def placements(model, batch):
        pl = [Replicate()] * mesh.ndim
        pl[ep_dim] = model
        for i in batch_dims:
            pl[i] = batch
        return tuple(pl)

    x_pl = placements(Replicate(), Shard(0))
    w_pl = placements(Shard(0), Replicate())
    R = placements(Replicate(), Replicate())
    names_e = ["w_up", "w_down"] + (["w_gate"] if cfg.mlp_type == "swiglu" else [])

    def local(x_l, router, *ws):
        xs = x_l[:, m * S_l : (m + 1) * S_l]  # (B_l, S_l, d): this member's seq slice
        B_l = xs.shape[0]
        T_l = B_l * S_l
        C = capacity(cfg, T_l)
        xg, w, slot, top_i, aux = _dispatch(cfg, router, xs.reshape(T_l, d), E, C)
        # (E, C, d) -> (ep, E_l, C, d): recv[j] is member j's tokens for my experts
        recv = funcol.all_to_all_single_autograd(xg.reshape(ep, E_l, C, d), None, None, group)
        xr = recv.transpose(0, 1).reshape(E_l, ep * C, d)
        yr = _expert_ffn(cfg.mlp_type, dict(zip(names_e, ws)), xr)  # (E_l, ep * C, d)
        back = yr.reshape(E_l, ep, C, d).transpose(0, 1).contiguous()  # (ep, E_l, C, d)
        ybuf = funcol.all_to_all_single_autograd(back, None, None, group)
        y = _weighted_combine(ybuf.reshape(E, C, d), w, slot, top_i)
        return y.reshape(B_l, S_l, d), aux

    out = (placements(Shard(1), Shard(0)), placements(Partial("avg"), Partial("avg")))
    ws = [p[n].redistribute(mesh, w_pl) for n in names_e]
    x, router = x.redistribute(mesh, x_pl), p["router"].redistribute(mesh, R)
    y, aux = local_call(local, out, x, router, *ws)
    return y, aux.redistribute(mesh, R)


class MoE(nn.Module):
    """``init_moe``'s parameters: router (d, E_real), w_up and w_gate (E, d, ff), w_down
    (E, ff, d), E the experts padded to a multiple of ``ep_size``, all in the working
    dtype (float32 for training)."""

    AXES = {
        "router": ("embed", None),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
        "w_gate": ("experts", "embed", "expert_mlp"),
    }

    def __init__(self, cfg: ArchConfig, device, ep_size: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        d, ff, dt = cfg.d_model, cfg.moe_d_ff, working_dtype(cfg)
        E = padded_experts(cfg, ep_size)
        self.router = _param((d, cfg.n_experts), dt, device)
        self.w_up = _param((E, d, ff), dt, device)
        self.w_down = _param((E, ff, d), dt, device)
        if cfg.mlp_type == "swiglu":
            self.w_gate = _param((E, d, ff), dt, device)

    def reset_parameters(self, generator):
        dense_init_(self.router, generator)
        # in_axis=1 as in init_moe: fan_in is E * d (E * ff for w_down)
        for w in (self.w_up, self.w_down) + ((self.w_gate,) if hasattr(self, "w_gate") else ()):
            dense_init_(w, generator, in_axis=1)

    def forward(self, x, step=_run, rules=None, impl: Optional[str] = None):
        return apply_moe(self.cfg, dict(self.named_parameters()), x, step, rules, impl)
