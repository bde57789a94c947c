"""Mamba2 / SSD (state-space duality) block: the counterpart of the JAX package's
``models/mamba.py``.

Prefill uses the chunked SSD algorithm (quadratic within a chunk, a linear scan of
states across chunks); decode the O(1) recurrent update. State math in float32,
projections in the working dtype.

Parameter dtypes follow what the reference reads, not only what it stores: ``w_in``
and ``w_out`` are matmul weights and live in the working dtype, as in ``layers.py``
(float32 in a model for training, cast at use);
``conv_w`` is read in float32 at decode and in the working dtype at prefill, and
``D`` likewise, so both stay float32 masters, cast at use, as do ``conv_b``,
``A_log``, ``dt_bias`` and ``norm``.

Step sizes go through ``F.softplus``, which returns x itself above its threshold of
20 where ``jax.nn.softplus`` computes log1p(exp(x)): the two differ by under 1e-8.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import Replicate

from repro_torch.configs.base import ArchConfig, hybrid_setting
from repro_torch.distributed.sharding import local_call
from repro_torch.models.layers import (
    _param,
    _part,
    _run,
    column_parallel,
    constrain,
    dense_init_,
    rms_norm_nohead,
    row_parallel,
    sharded,
    working_dtype,
    write_all,
)

F32 = torch.float32


def conv_channels(cfg: ArchConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def _split_proj(cfg: ArchConfig, zxbcdt):
    din, G, N = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din : 2 * din + 2 * G * N]
    dt = zxbcdt[..., 2 * din + 2 * G * N :]
    return z, xbc, dt


def _causal_conv(cfg: ArchConfig, p, xbc):
    """Depthwise causal conv over (B, S, C) with width W: the reference's sum of W
    shifted products in the working dtype (``F.conv1d`` accumulates in another order)."""
    W, S = cfg.conv_width, xbc.shape[1]
    pad = F.pad(xbc, (0, 0, W - 1, 0))
    acc = None
    for i in range(W):
        term = pad[:, i : i + S, :] * p["conv_w"][i].to(xbc.dtype)
        acc = term if acc is None else acc + term
    return F.silu(acc + p["conv_b"].to(xbc.dtype))


def ssd_chunked(cfg: ArchConfig, xh, dt, A, Bm, Cm, init_state=None):
    """Chunked SSD scan.

    xh: (B, S, H, P) inputs per head; dt: (B, S, H) softplus'd step sizes;
    A: (H,) negative decay rates; Bm/Cm: (B, S, G, N).
    Returns y (B, S, H, P) and the final state (B, H, N, P), both float32 (the
    reference's code builds (B, H, N, P), whatever its docstring says).
    """
    Bsz, S, H, Pd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(cfg.ssd_chunk, S)
    S_orig = S
    if S % Q != 0:
        # pad with dt = 0 steps: zero contribution, unit decay, so exact
        pad = Q - S % Q
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    rep = H // G

    xf = xh.float().reshape(Bsz, nc, Q, H, Pd)
    dtf = dt.float().reshape(Bsz, nc, Q, H)
    Bh = Bm.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)  # (B, nc, Q, H, N)
    Ch = Cm.float().reshape(Bsz, nc, Q, G, N).repeat_interleave(rep, dim=3)

    ca = torch.cumsum(dtf * A, dim=2)  # within-chunk cumsum of dt * A (negative)
    ca_last = ca[:, :, -1:, :]  # (B, nc, 1, H)

    # ---- intra-chunk: L[i, j] = exp(ca_i - ca_j) for i >= j, else 0 ----
    gates = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    ci = ca.transpose(2, 3)  # (B, nc, H, Q)
    ldiff = ci[..., :, None] - ci[..., None, :]  # (B, nc, H, Q, Q)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()
    # zero the masked exponents before exp: above the diagonal ldiff is large and
    # positive (ca decreases), exp would overflow to inf, and the outer where's
    # backward would multiply that inf by 0 (NaN gradients in training)
    L = torch.where(mask, torch.exp(torch.where(mask, ldiff, 0.0)), 0.0)
    M = gates * L * dtf.transpose(2, 3)[..., None, :]  # * dt_j
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", M, xf)

    # ---- chunk states: S_c = sum_j exp(ca_last - ca_j) dt_j B_j x_j^T ----
    w = torch.exp(ca_last - ca) * dtf  # (B, nc, Q, H)
    states = torch.einsum("bcqhn,bcqhp->bchnp", Bh * w[..., None], xf)  # (B, nc, H, N, P)

    # ---- inter-chunk scan (the reference's lax.scan), the state before each chunk ----
    chunk_decay = torch.exp(ca_last[:, :, 0, :])  # (B, nc, H)
    s = xf.new_zeros(Bsz, H, N, Pd) if init_state is None else init_state
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, N, P)

    # ---- inter-chunk contribution: y_i += C_i . (exp(ca_i) * state_prev) ----
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", Ch * torch.exp(ca)[..., None], prev_states)
    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)[:, :S_orig]
    return y, s


def _whole(t):
    """A DTensor replicated on its mesh."""
    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def _ssd_sharded(cfg: ArchConfig, rules, xh, dt, dt_bias, A, Bm, Cm):
    """softplus(dt + dt_bias) and ``ssd_chunked`` on a mesh through ``local_call``:
    heads are independent, so each rank scans its own (``ssm_heads`` over ``model``
    where H divides it), with B and C whole on every rank; no collective. (DTensor has
    no sharding rule for softplus's backward, so it runs on the local shards too.)"""
    xh = rules.constrain(xh, ("batch", "act_seq", "ssm_heads", None))
    dt = rules.constrain(dt, ("batch", "act_seq", "ssm_heads"))
    dt_bias = rules.constrain(dt_bias, ("ssm_heads",))
    A = rules.constrain(A, ("ssm_heads",))
    Bm = rules.constrain(Bm, ("batch", "act_seq", None, None))
    Cm = rules.constrain(Cm, ("batch", "act_seq", None, None))
    B_, _, H, Pd = xh.shape
    state_pl = rules.placements_for(("batch", "ssm_heads", None, None), (B_, H, Bm.shape[3], Pd))

    def scan(xh, dt, dt_bias, A, Bm, Cm):
        return ssd_chunked(cfg, xh, F.softplus(dt + dt_bias[None, None]), A, Bm, Cm)

    return local_call(scan, (xh.placements, state_pl), xh, dt, dt_bias, A, Bm, Cm)


def apply_ssd(cfg: ArchConfig, p, x, cache=None, pos=None, step=_run, rules=None):
    """The full SSD block, as the reference's caller convention has it:

    * cache None             -> no cache (the training path's forward), (y, None);
    * cache given, pos None  -> prefill: the chunked scan, and the cache's ``conv``
      (the last W - 1 pre-conv inputs) and ``state`` written in place;
    * cache given, pos given -> one-token decode, the cache updated in place.

    ``cache`` = {"conv": (B, W - 1, cch) working dtype, "state": (B, H, N, P) f32}.
    On a mesh (``rules``) the constraints sit where the reference's do, the scan runs
    through ``_ssd_sharded`` and the cache entries are written placed as they are.
    """
    dt_m = x.dtype
    din, H, G, N = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_ngroups, cfg.ssm_state
    Pd, W = cfg.ssm_headdim, cfg.conv_width
    A = -torch.exp(p["A_log"])

    if sharded(rules):
        zxbcdt = _part(step, "lm.mamba.in_proj", "in_proj", lambda: column_parallel(x, p["w_in"]))
    else:
        zxbcdt = _part(step, "lm.mamba.in_proj", "in_proj", lambda: x @ p["w_in"].to(dt_m))
    zxbcdt = constrain(rules, zxbcdt, ("batch", "act_seq", "act_mlp"))
    if sharded(rules):
        # (z | xbc | dt) gathered along model once: DTensor slices a sharded dim across
        # its shards' boundaries only by gathering the whole, once for each slice
        zxbcdt = constrain(rules, zxbcdt, ("batch", "act_seq", None))
        # and the small per-channel weights whole: the gated norm's scale sharded along
        # din would shard the heads' gradients where H does not divide the axis
        p = dict(p, **{k: _whole(p[k]) for k in ("conv_w", "conv_b", "norm")})
    z, xbc, dtr = _split_proj(cfg, zxbcdt)

    if cache is not None and pos is not None:
        # ---- decode: the recurrent update; conv cache is a rolling window of
        # pre-activation inputs ----
        window = torch.cat([cache["conv"], xbc[:, :1, :]], dim=1)  # (B, W, cch)
        # on a mesh the three contractions are written elementwise: DTensor works out a
        # product's placements far more slowly than a product's and a sum's
        on_mesh = sharded(rules)
        if on_mesh:
            conv = (window.float() * p["conv_w"].float()).sum(1)
        else:
            conv = torch.einsum("bwc,wc->bc", window.float(), p["conv_w"].float())
        conv = F.silu(conv + p["conv_b"].float())
        xh = conv[:, :din].reshape(-1, H, Pd)  # (B, H, P)
        Bh = conv[:, din : din + G * N].reshape(-1, G, N).repeat_interleave(H // G, dim=1)
        Ch = conv[:, din + G * N :].reshape(-1, G, N).repeat_interleave(H // G, dim=1)
        dtv = F.softplus(dtr[:, 0, :].float() + p["dt_bias"][None])  # (B, H)
        dA = torch.exp(dtv * A[None])
        if on_mesh:
            upd = (Bh * dtv[..., None])[..., :, None] * xh[..., None, :]
        else:
            upd = torch.einsum("bhn,bhp->bhnp", Bh * dtv[..., None], xh)
        state = cache["state"] * dA[..., None, None] + upd
        y = (Ch[..., None] * state).sum(2) if on_mesh else torch.einsum("bhn,bhnp->bhp", Ch, state)
        y = y + p["D"].float()[None, :, None] * xh
        y = y.reshape(-1, 1, din).to(dt_m)
        y = rms_norm_nohead(y * F.silu(z.float()).to(dt_m), p["norm"], hybrid_setting(cfg, "ssm_norm_eps"))
        write_all(cache["conv"], window[:, 1:, :])
        write_all(cache["state"], state)
        out = row_parallel(y, p["w_out"]) if on_mesh else y @ p["w_out"].to(dt_m)
        return out, cache

    # ---- prefill / no cache: the chunked scan ----
    if sharded(rules):  # along the sequence, each rank on its batch shard's channels

        def conv():
            local = lambda x, w, b: _causal_conv(cfg, {"conv_w": w, "conv_b": b}, x)
            return local_call(local, (xbc.placements,), xbc, p["conv_w"], p["conv_b"])

        xbc_c = _part(step, "lm.mamba.conv", "conv", conv)
    else:
        xbc_c = _part(step, "lm.mamba.conv", "conv", lambda: _causal_conv(cfg, p, xbc))
    B_, S_ = xbc_c.shape[:2]
    xh = xbc_c[..., :din].reshape(B_, S_, H, Pd)
    Bm = xbc_c[..., din : din + G * N].reshape(B_, S_, G, N)
    Cm = xbc_c[..., din + G * N :].reshape(B_, S_, G, N)
    xh = constrain(rules, xh, ("batch", "act_seq", "ssm_heads", None))

    def scan():
        if sharded(rules):
            return _ssd_sharded(cfg, rules, xh, dtr.float(), p["dt_bias"], A, Bm, Cm)
        dtv = F.softplus(dtr.float() + p["dt_bias"][None, None])
        return ssd_chunked(cfg, xh, dtv, A, Bm, Cm)

    y, final_state = _part(step, "lm.mamba.ssd", "SSD", scan)

    def gate_norm():
        yd = y.to(dt_m) + p["D"].to(dt_m)[None, None, :, None] * xh
        yd = yd.reshape(B_, S_, din)
        return rms_norm_nohead(yd * F.silu(z.float()).to(dt_m), p["norm"], hybrid_setting(cfg, "ssm_norm_eps"))

    yn = _part(step, "lm.mamba.gate_norm", "gate + norm", gate_norm)
    if sharded(rules):
        out = _part(step, "lm.mamba.out_proj", "out_proj", lambda: row_parallel(yn, p["w_out"]))
    else:
        out = _part(step, "lm.mamba.out_proj", "out_proj", lambda: yn @ p["w_out"].to(dt_m))
    if cache is not None:
        write_all(cache["conv"], xbc[:, -(W - 1) :, :])
        write_all(cache["state"], final_state)
    return out, cache


# the logical axes of the decode cache's entries
CACHE_AXES = {
    "conv": ("cache_batch", None, "ssm_inner"),
    "state": ("cache_batch", "ssm_heads", None, None),
}


def cache_spec(cfg: ArchConfig, batch: int):
    """(shape, dtype) of the decode cache's entries."""
    H, N, Pd = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim
    return {
        "conv": ((batch, cfg.conv_width - 1, conv_channels(cfg)), working_dtype(cfg)),
        "state": ((batch, H, N, Pd), F32),
    }


class SSD(nn.Module):
    """``init_ssd``'s parameters: w_in (d, 2·din + 2·G·N + H) and w_out (din, d) in the
    working dtype; conv_w (W, cch), conv_b (cch,), A_log, D and dt_bias (H,) and
    norm (din,) in float32."""

    AXES = {
        "w_in": ("embed", "ssm_inner"),
        "conv_w": ("conv", "ssm_inner"),
        "conv_b": ("ssm_inner",),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": ("ssm_inner",),
        "w_out": ("ssm_inner", "embed"),
    }

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.cfg = cfg
        d, din, H = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
        G, N, cch, dt = cfg.ssm_ngroups, cfg.ssm_state, conv_channels(cfg), working_dtype(cfg)
        self.w_in = _param((d, 2 * din + 2 * G * N + H), dt, device)
        self.conv_w = _param((cfg.conv_width, cch), F32, device)
        self.conv_b = _param((cch,), F32, device)
        self.A_log = _param((H,), F32, device)
        self.D = _param((H,), F32, device)
        self.dt_bias = _param((H,), F32, device)
        self.norm = _param((din,), F32, device)
        self.w_out = _param((din, d), dt, device)

    def reset_parameters(self, generator):
        """``init_ssd``'s scheme: dense_init for the projections and the conv (its
        scale 1 is every caller's), zero conv bias, unit D and norm, A = U(1, 16) and
        dt = exp(U(log 1e-3, log 1e-1)) stored as A_log and softplus⁻¹(dt)."""
        H = self.A_log.shape[0]
        dense_init_(self.w_in, generator)
        dense_init_(self.conv_w, generator)
        dense_init_(self.w_out, generator)
        dev = self.A_log.device
        u = torch.rand(H, generator=generator, dtype=F32, device=dev)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        a = 1.0 + 15.0 * torch.rand(H, generator=generator, dtype=F32, device=dev)
        with torch.no_grad():
            self.conv_b.zero_()
            self.D.fill_(1.0)
            self.norm.fill_(1.0)
            self.dt_bias.copy_(torch.log(torch.expm1(dt)))
            self.A_log.copy_(torch.log(a))

    def forward(self, x, cache=None, pos=None, step=_run, rules=None):
        return apply_ssd(self.cfg, dict(self.named_parameters()), x, cache, pos, step, rules)
