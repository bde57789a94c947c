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

A config with ``moe_dropless`` (granite-4.0-h) takes a third path without a mesh,
``_moe_dropless``: the (token, slot) pairs sorted by expert and every expert run over
its own rows in one grouped product (``torch._grouped_mm``, bfloat16) or a loop over
the experts, so no slot is dropped and no (E, C) buffer is padded. A config with
``shared_d_ff`` adds a shared SwiGLU expert's output, computed for every token, to the
routed experts'. Every other config keeps the paths above as they were.

Without a mesh each step runs inside a telemetry span (``lm.moe.route``,
``.dispatch``, ``.experts``, ``.shared``, ``.combine``), and an open session counts
``moe_routed_slots_total{layer}`` and ``moe_dropped_slots_total`` (on the card, read
at export) and sets the gauge ``moe_expert_load_max{layer}``, the busiest expert's
slots over the mean (a read of the device, in a session only).

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

from repro_torch import _telemetry as telemetry
from repro_torch.configs.base import ArchConfig, hybrid_setting
from repro_torch.distributed.sharding import local_call
from repro_torch.models.layers import _param, _part, _run, dense_init_, working_dtype

F32 = torch.float32


def padded_experts(cfg: ArchConfig, ep_size: Optional[int]) -> int:
    e = cfg.n_experts
    if ep_size and e % ep_size != 0:
        e = math.ceil(e / ep_size) * ep_size
    return e


def _ffn(mlp_type: str, mm, w_up, w_gate, w_down, x):
    """The FFN of x through ``mm(x, w)`` for each weight: swiglu, relu² or gelu."""
    h = mm(x, w_up)
    if mlp_type == "swiglu":
        h = F.silu(mm(x, w_gate)) * h
    elif mlp_type == "relu2":
        h = F.relu(h).square()
    else:
        h = F.gelu(h, approximate="tanh")
    return mm(h, w_down)


def _weights(p, prefix="w_"):
    return p[prefix + "up"], p.get(prefix + "gate"), p[prefix + "down"]


def _expert_ffn(mlp_type: str, p, xg):
    """xg: (E, C, d) -> (E, C, d) through each expert's FFN (``p``: w_up, w_down and,
    for swiglu, w_gate, each stacked over E)."""
    return _ffn(mlp_type, lambda a, w: torch.bmm(a, w.to(a.dtype)), *_weights(p), xg)


def _expert_rows(mlp_type: str, p, xs, offs):
    """xs: (N, d), rows sorted by expert, expert e's rows ending at offs[e] (int32,
    (E,)) -> (N, d) through each row's expert. bfloat16 runs one grouped product a
    weight (``torch._grouped_mm``), anything else a loop over the experts, which reads
    the offsets back to the host."""
    w = _weights(p)
    if xs.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        return _ffn(mlp_type, lambda a, w: torch._grouped_mm(a, w.to(a.dtype), offs=offs), *w, xs)
    ends = offs.tolist()
    outs = []
    for e, (lo, hi) in enumerate(zip([0] + ends[:-1], ends)):
        mm = lambda a, w: a @ w[e].to(a.dtype)  # noqa: E731
        outs.append(_ffn(mlp_type, mm, *w, xs[lo:hi]))
    return torch.cat(outs)


def _shared_expert(cfg: ArchConfig, p, x):
    """The shared expert (``shared_up``, ``shared_gate``, ``shared_down``) over every
    token of x (..., d)."""
    return _ffn(cfg.mlp_type, lambda a, w: a @ w.to(a.dtype), *_weights(p, "shared_"), x)


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


def _routed(cfg: ArchConfig, router, xf, step=_run):
    """The router's top k for xf (T, d): (expert ids (T, k), weights, aux)."""
    return _part(step, "lm.moe.route", "router + top-k", lambda: _route(cfg, xf @ router.to(xf.dtype)))


def _dispatch(cfg: ArchConfig, router, xf, E: int, C: int, step=_run):
    """Route xf (T, d) and gather the (E, C, d) buffer: (xg, w, slot, top_i, aux)."""
    T, d = xf.shape
    top_i, top_w, aux = _routed(cfg, router, xf, step)

    def dispatch():
        idx, w, slot = _group(top_i.reshape(-1), top_w.reshape(-1), T, E, C)
        xg = torch.cat([xf, xf.new_zeros(1, d)])[idx]  # (E, C, d)
        return xg, w, slot

    xg, w, slot = _part(step, "lm.moe.dispatch", "group + gather", dispatch)
    return xg, w, slot, top_i, aux


def _moe_dropless(cfg: ArchConfig, p, xf, step=_run):
    """Every (token, slot) pair through its expert: the T·k pairs sorted by expert
    (stably, so each expert's rows stay in token order), gathered, run through
    ``_expert_rows`` and weighted, and each token's k rows summed by ``_combine``.
    xf (T, d) -> (y (T, d), aux, expert offsets (E,) int32)."""
    T, d = xf.shape
    E, k = p["w_up"].shape[0], cfg.n_experts_per_tok
    top_i, top_w, aux = _routed(cfg, p["router"], xf, step)

    def dispatch():
        flat = top_i.reshape(-1)
        order = torch.argsort(flat, stable=True)  # (T·k,): pairs in expert order
        experts = torch.arange(1, E + 1, device=flat.device)
        offs = torch.searchsorted(flat[order], experts, right=False).to(torch.int32)
        slot = torch.empty_like(order)
        slot[order] = torch.arange(T * k, device=order.device)  # each pair's sorted row
        return xf[order // k], order, offs, slot

    xs, order, offs, slot = _part(step, "lm.moe.dispatch", "group + gather", dispatch)
    ys = _part(step, "lm.moe.experts", "expert FFNs", lambda: _expert_rows(cfg.mlp_type, p, xs, offs))

    def combine():
        weighted = ys * top_w.reshape(-1)[order, None].to(ys.dtype)
        return _combine(weighted, slot, top_i, T)

    return _part(step, "lm.moe.combine", "combine", combine), aux, offs


def _count(layer, T: int, k: int, E: int, device, load, dropped=None):
    """The MoE counters of the open session: the layer's routed slots, the dropped
    slots (``dropped``, a device count, or none), and the gauge of the busiest expert's
    slots over the mean (``load``: each expert's slots, (E,))."""
    telemetry.counter("moe_routed_slots_total", T * k, layer=layer)
    dropped_total = telemetry.device_counter("moe_dropped_slots_total", device)
    if dropped is not None:
        dropped_total += dropped
    telemetry.gauge("moe_expert_load_max", float(load.max()) * E / (T * k), layer=layer)


def _weighted_combine(yg, w, slot, top_i):
    """Each token's k expert rows, weighted by w, summed (``_combine``). yg: (E, C, d)."""
    E, C, d = yg.shape
    weighted = yg.reshape(E * C, d) * w.reshape(E * C, 1).to(yg.dtype)
    # the last row is the sentinel's zero
    return _combine(F.pad(weighted, (0, 0, 0, 1)), slot, top_i, top_i.shape[0])


def apply_moe(
    cfg: ArchConfig, p, x, step=_run, rules=None, impl: Optional[str] = None, layer=None
):
    """The reference's ``apply_moe``: ``_moe_ep`` when ``impl`` (default
    ``cfg.moe_impl``) is "ep" and ``rules`` has a mesh, the gather path otherwise, or
    without a mesh ``_moe_dropless`` where the config asks for it; plus the shared
    expert where the config has one. x: (B, S, d) -> (y (B, S, d), aux). ``p``: router
    (d, E_real) and the expert stacks, E = w_up.shape[0] (padded). ``layer`` labels the
    session's counters."""
    impl = impl or cfg.moe_impl
    dropless, shared = hybrid_setting(cfg, "moe_dropless"), hybrid_setting(cfg, "shared_d_ff")
    if rules is not None and rules.mesh is not None:
        if dropless or shared:
            raise ValueError(f"{cfg.name}: dropless routing and a shared expert run without a mesh")
        if impl == "ep":
            return _moe_ep(cfg, p, x, rules)
        return _moe_gather_sharded(cfg, p, x, rules)
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    E, k = p["w_up"].shape[0], cfg.n_experts_per_tok
    if dropless:
        y, aux, offs = _moe_dropless(cfg, p, xf, step)
        if telemetry.active() is not None:
            _count(layer, T, k, E, x.device, torch.diff(offs, prepend=offs.new_zeros(1)))
    else:
        C = capacity(cfg, T)
        xg, w, slot, top_i, aux = _dispatch(cfg, p["router"], xf, E, C, step)
        yg = _part(step, "lm.moe.experts", "expert FFNs", lambda: _expert_ffn(cfg.mlp_type, p, xg))
        y = _part(step, "lm.moe.combine", "combine", lambda: _weighted_combine(yg, w, slot, top_i))
        if telemetry.active() is not None:
            load = _one_hot(top_i.reshape(-1), E).sum(0)
            _count(layer, T, k, E, x.device, load, dropped=(slot == E * C).sum())
    y = y.view(B, S, d)
    if shared:
        y = y + _part(step, "lm.moe.shared", "shared expert", lambda: _shared_expert(cfg, p, x))
    return y, aux


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
    dtype (float32 for training); with ``shared_d_ff`` also the shared expert's
    shared_up and shared_gate (d, shared_d_ff) and shared_down (shared_d_ff, d).
    ``layer`` (the block's index) labels the session's counters."""

    AXES = {
        "router": ("embed", None),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
        "w_gate": ("experts", "embed", "expert_mlp"),
        "shared_up": ("embed", "mlp"),
        "shared_gate": ("embed", "mlp"),
        "shared_down": ("mlp", "embed"),
    }

    def __init__(self, cfg: ArchConfig, device, ep_size: Optional[int] = None, layer=None):
        super().__init__()
        self.cfg, self.layer = cfg, layer
        d, ff, dt = cfg.d_model, cfg.moe_d_ff, working_dtype(cfg)
        E = padded_experts(cfg, ep_size)
        self.router = _param((d, cfg.n_experts), dt, device)
        self.w_up = _param((E, d, ff), dt, device)
        self.w_down = _param((E, ff, d), dt, device)
        if cfg.mlp_type == "swiglu":
            self.w_gate = _param((E, d, ff), dt, device)
        shared = hybrid_setting(cfg, "shared_d_ff")
        if shared:
            self.shared_up = _param((d, shared), dt, device)
            self.shared_down = _param((shared, d), dt, device)
            if cfg.mlp_type == "swiglu":
                self.shared_gate = _param((d, shared), dt, device)

    def reset_parameters(self, generator):
        dense_init_(self.router, generator)
        # in_axis=1 as in init_moe: fan_in is E * d (E * ff for w_down)
        for w in (self.w_up, self.w_down) + ((self.w_gate,) if hasattr(self, "w_gate") else ()):
            dense_init_(w, generator, in_axis=1)
        for name in ("shared_up", "shared_gate", "shared_down"):
            if hasattr(self, name):
                dense_init_(getattr(self, name), generator)

    def forward(self, x, step=_run, rules=None, impl: Optional[str] = None):
        p = dict(self.named_parameters())
        return apply_moe(self.cfg, p, x, step, rules, impl, self.layer)
