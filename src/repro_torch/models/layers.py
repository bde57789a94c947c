"""Model building blocks: norms, RoPE, sinusoidal positions, GQA attention (prefill,
decode, the encoder's bidirectional mode, cross-attention, and the training forms of
causal, bidirectional and cross attention), MLP variants, embeddings. Counterpart of
the JAX package's ``models/layers.py``.

Parameters keep the reference's names and layouts, (d, H, hd) for ``wq``,
(d, K, hd) for ``wk``/``wv`` and (H, hd, d) for ``wo``, so that a reference
parameter tree moves across as it is (``Model.from_numpy``). The reference keeps
every parameter in float32 and casts matmul weights and embedding rows to the
working dtype at use (embedding rows after the gather). A serving model stores those
in the working dtype, which gives the same values, and keeps norm scales and biases in
float32; a model for training stores every parameter in float32, as the reference
does, so that its gradients are summed in float32. Every use casts to the input's
dtype (``w.to(x.dtype)``, the tensor itself when it is stored in that dtype).

Every ``step`` argument is a hook ``step(name, fn) -> fn()`` through which a caller
can time the sublayers; the default just calls ``fn``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.attention.ops import gqa_attention

F32 = torch.float32


def _run(name, fn):
    return fn()


def working_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init_(p: torch.Tensor, generator, in_axis: int = 0):
    """The reference's ``dense_init`` (every caller there has scale 1): normal /
    sqrt(fan_in), fan_in the product of the dims up to ``in_axis``, drawn in float32
    and then stored."""
    fan_in = math.prod(p.shape[: in_axis + 1])
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(p.shape, generator=generator, dtype=F32, device=p.device)
    with torch.no_grad():
        p.copy_(w.mul_(std))  # in place: one float32 temporary (3.1 GB for minitron's table)


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


class Norm(nn.Module):
    """``init_norm``/``apply_norm``: LayerNorm (population variance) or RMSNorm,
    computed in float32 and cast back to the input's dtype."""

    def __init__(self, cfg: ArchConfig, dim: int, device):
        super().__init__()
        self.kind = cfg.norm
        self.scale = _param((dim,), F32, device)
        self.bias = _param((dim,), F32, device) if cfg.norm == "layernorm" else None

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        eps = 1e-5
        xf = x.float()
        if self.kind == "layernorm":
            mu = xf.mean(-1, keepdim=True)
            var = xf.var(-1, keepdim=True, correction=0)
            y = (xf - mu) * torch.rsqrt(var + eps) * self.scale + self.bias
        else:
            ms = xf.square().mean(-1, keepdim=True)
            y = xf * torch.rsqrt(ms + eps) * self.scale
        return y.to(x.dtype)


def rms_norm_nohead(x, scale):
    """RMS norm over the last dim, eps 1e-6 (qk-norm)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + 1e-6) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (partial rotary: chatglm3's "RoPE 2d" is fraction 0.5)
# ---------------------------------------------------------------------------


def apply_rope(x, positions, theta: float, fraction: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotate-half over the
    first ``rot`` dims, the rest passed through; cos and sin in float32."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=F32, device=x.device) * (math.log(theta) / half)
    )
    ang = positions[..., None].to(F32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x_rot[..., :half].float(), x_rot[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def sinusoidal_pos_emb(positions, dim: int, dtype):
    """sin and cos of positions x exp(-i ln(1e4) / max(half - 1, 1)) for i < half, in
    float32, concatenated and cast to ``dtype``; positions (...,) -> (..., dim).

    The frequencies come from torch's float32 ``exp``, which is correctly rounded far
    more often than XLA's on the CPU, so an angle can sit one float32 ulp from the
    reference's (2^-12 rad at 4095; ROADMAP, R12)."""
    half = dim // 2
    freqs = torch.exp(
        -torch.arange(half, dtype=F32, device=positions.device)
        * (math.log(10_000.0) / max(half - 1, 1))
    )
    ang = positions[..., None].to(F32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """GQA attention in the reference's five modes: self-attention ``causal``
    (prefill), ``bidir`` (the encoder) and ``decode``; cross-attention ``cross``
    (prefill, keys and values from ``kv_x``) and ``cross_decode`` (from the cache)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.cfg = cfg
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = working_dtype(cfg)
        self.wq = _param((d, H, hd), dt, device)
        self.wk = _param((d, K, hd), dt, device)
        self.wv = _param((d, K, hd), dt, device)
        self.wo = _param((H, hd, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = _param((hd,), F32, device)
            self.k_norm = _param((hd,), F32, device)

    def reset_parameters(self, generator):
        dense_init_(self.wq, generator)
        dense_init_(self.wk, generator)
        dense_init_(self.wv, generator)
        dense_init_(self.wo, generator, in_axis=1)
        if self.cfg.qk_norm:
            with torch.no_grad():
                self.q_norm.fill_(1.0)
                self.k_norm.fill_(1.0)

    def _q(self, x):
        """The query projection, qk-normed when the config says so (no RoPE)."""
        B, S, d = x.shape
        q = x @ self.wq.to(x.dtype).view(d, -1)
        q = q.view(B, S, self.cfg.n_heads, self.cfg.head_dim)
        return rms_norm_nohead(q, self.q_norm) if self.cfg.qk_norm else q

    def _kv(self, x):
        """The key and value projections (B, S, K, hd), neither normed nor rotated."""
        B, S, d = x.shape
        shape = (B, S, self.cfg.n_kv_heads, self.cfg.head_dim)
        k = x @ self.wk.to(x.dtype).view(d, -1)
        return k.view(shape), (x @ self.wv.to(x.dtype).view(d, -1)).view(shape)

    def cross_kv(self, enc_out):
        """The reference's ``cross_kv``: the encoder output's keys and values in the
        cache layout (B, K, S, hd), without ``k_norm`` (ROADMAP, R9)."""
        k, v = self._kv(enc_out)
        return {"ck": k.transpose(1, 2), "cv": v.transpose(1, 2)}

    def _qkv(self, x, positions):
        cfg = self.cfg
        q = self._q(x)
        k, v = self._kv(x)
        if cfg.qk_norm:
            k = rms_norm_nohead(k, self.k_norm)
        if cfg.pos_emb == "rope":
            q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
            k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
        return q, k, v

    def _out(self, o):
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.to(o.dtype).view(-1, self.cfg.d_model)

    def forward(
        self, x, *, mode: str, positions=None, cache=None, pos=None, kv_x=None, step=_run
    ):
        """causal: x (B, S, d); writes k and v into ``cache`` = {"k", "v"} of shape
        (B, K, Smax, hd) at [:, :, :S]. bidir: the same attention without the mask
        and without a cache. decode: x (B, 1, d) at absolute position ``pos``; writes k
        and v at ``pos`` and attends over the first pos + 1 entries. cross: queries
        from x, keys and values from ``kv_x`` (B, S_enc, d), written into ``cache`` =
        {"ck", "cv"} of (B, K, L, hd) at [:, :, :S_enc] (L >= S_enc); the rest stays as
        it is. cross_decode: attends over all L entries of ``cache``. Returns (out,
        cache). The cache is updated in place, where the reference returns new arrays
        (``dynamic_update_slice``, ``pad_cache``)."""
        if mode in ("causal", "bidir"):
            causal = mode == "causal"
            q, k, v = step("qkv + rope", lambda: self._qkv(x, positions))
            out = step("attention kernel", lambda: gqa_attention(q, k, v, causal=causal))
            if causal:
                S = x.shape[1]
                # prefill cache layout (B, K, S, hd): seq next to head_dim, as the reference's
                cache["k"][:, :, :S].copy_(k.transpose(1, 2))
                cache["v"][:, :, :S].copy_(v.transpose(1, 2))
            return step("out projection", lambda: self._out(out)), cache
        if mode == "cross":
            # One projection of the encoder output serves the attention and the cache,
            # where the reference projects it twice (models/layers.py:264 and :308).
            q = step("cross q", lambda: self._q(x))
            kv = step("cross K/V", lambda: self.cross_kv(kv_x))
            if cache is not None:
                n = kv_x.shape[1]
                cache["ck"][:, :, :n].copy_(kv["ck"])
                cache["cv"][:, :, :n].copy_(kv["cv"])
            k = kv["ck"]
            if self.cfg.qk_norm:  # prefill's keys are normed, the cached ones not (R9)
                k = rms_norm_nohead(k, self.k_norm)
            out = step("cross attention", lambda: _sdpa(q, k, kv["cv"]))
            return step("cross out projection", lambda: self._out(out)), cache
        if mode == "cross_decode":
            out = _sdpa(self._q(x), cache["ck"], cache["cv"])
            return self._out(out), cache
        if mode == "decode":
            positions = torch.full((1, 1), pos, device=x.device)
            q, k, v = self._qkv(x, positions)
            cache["k"][:, :, pos].copy_(k[:, 0])
            cache["v"][:, :, pos].copy_(v[:, 0])
            out = _sdpa(q, cache["k"][:, :, : pos + 1], cache["v"][:, :, : pos + 1])
            return self._out(out), cache
        raise ValueError(f"unknown attention mode {mode!r}")

    def forward_train(self, x, *, mode: str, positions=None, kv_x=None, q_chunk: int = 1024):
        """The reference's training attention (``attention`` in modes causal, bidir and
        cross, without the cache it returns): causal and bidir over x with RoPE at
        ``positions``; cross with queries from x and keys and values from ``kv_x``,
        unrotated. No cache, nothing written in place, and never K2: the reference
        trains through its plain ``_sdpa`` (``_sdpa_heads`` here), and K2 has no
        backward."""
        if mode in ("causal", "bidir"):
            q, k, v = self._qkv(x, positions)
        elif mode == "cross":
            q = self._q(x)
            k, v = self._kv(kv_x)
            if self.cfg.qk_norm:
                k = rms_norm_nohead(k, self.k_norm)
        else:
            raise ValueError(f"attention has no training mode {mode!r}")
        out = _sdpa_heads(self.cfg, q, k, v, causal=mode == "causal", q_chunk=q_chunk)
        return self._out(out)


def _sdpa_heads(
    cfg: ArchConfig, q, k, v, *, causal: bool, q_offset=0, kv_valid_len=None, q_chunk: int = 1024
):
    """The reference's ``_sdpa`` in its heads layout, the attention it trains through:
    KV heads repeated to H (``repeat_interleave``, jnp.repeat's order), scores in the
    working dtype then float32 and scaled, the causal and ``kv_valid_len`` masks at
    -1e30, a float32 softmax whose weights are cast back before P·V; queries in chunks
    of ``q_chunk`` (Sq a multiple of it when longer), each over every key, or with
    ``cfg.causal_block_skip`` (causal, from position 0, no kv_valid_len) in up to 8
    buckets of chunks, bucket b over the keys [0, (b + 1) Sq / nb).

    q: (B, Sq, H, hd); k/v: (B, Skv, K, hd). q_offset: absolute position of q[0].
    Returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    K = k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)  # (B, Skv, H, hd)
        v = v.repeat_interleave(H // K, dim=2)
    kv_pos = torch.arange(k.shape[1], device=q.device)

    def chunk_attn(qc, row0, kc, vc, kvp):
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kc).float() * scale
        mask = None
        if causal:
            rows = row0 + torch.arange(qc.shape[1], device=q.device)
            mask = kvp[None, :] <= rows[:, None]
        if kv_valid_len is not None:
            vm = (kvp < kv_valid_len)[None, :]
            mask = vm if mask is None else (mask & vm)
        if mask is not None:
            s = torch.where(mask, s, -1e30)
        w = torch.softmax(s, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", w, vc)

    if Sq <= q_chunk:
        return chunk_attn(q, q_offset, k, v, kv_pos)
    if Sq % q_chunk:
        raise ValueError(f"seq {Sq} not divisible by q_chunk {q_chunk}")
    n = Sq // q_chunk
    chunks = q.split(q_chunk, dim=1)
    if causal and cfg.causal_block_skip and q_offset == 0 and kv_valid_len is None:
        # bucketed block-causal: bucket b's q chunks read only kv[0:(b+1)*S/nb]
        nb = min(8, n)
        while n % nb:
            nb -= 1
        per = n // nb
        outs = []
        for i, qc in enumerate(chunks):
            hi = (i // per + 1) * per * q_chunk
            outs.append(chunk_attn(qc, i * q_chunk, k[:, :hi], v[:, :hi], kv_pos[:hi]))
        return torch.cat(outs, dim=1)
    outs = [chunk_attn(qc, q_offset + i * q_chunk, k, v, kv_pos) for i, qc in enumerate(chunks)]
    return torch.cat(outs, dim=1)


def _sdpa(q, k, v):
    """The reference's ``_sdpa`` with no mask, in plain torch as the reference
    computes it outside any Pallas kernel: scores in the working dtype then float32,
    float32 softmax, weights cast back before P·V. It serves decode, ``cross_decode``
    and ``cross`` (where the query length is not the key length and K2 does not
    apply). q: (B, Sq, H, hd); k/v: (B, K, L, hd), the cache layout, hold the L keys
    attended to. In decode the reference masks the entries past L with -1e30, which
    add exactly 0."""
    B, Sq, H, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bqkgh,bksh->bkgqs", qg, k).float() * (1.0 / math.sqrt(hd))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bksh->bqkgh", w, v)
    return o.reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``init_mlp``/``apply_mlp``: swiglu, relu² or gelu (the tanh form, which is
    ``jax.nn.gelu``'s default)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.mlp_type = cfg.mlp_type
        d, ff, dt = cfg.d_model, cfg.d_ff, working_dtype(cfg)
        self.w_up = _param((d, ff), dt, device)
        self.w_down = _param((ff, d), dt, device)
        if cfg.mlp_type == "swiglu":
            self.w_gate = _param((d, ff), dt, device)

    def reset_parameters(self, generator):
        dense_init_(self.w_up, generator)
        dense_init_(self.w_down, generator)
        if self.mlp_type == "swiglu":
            dense_init_(self.w_gate, generator)

    def forward(self, x):
        h = x @ self.w_up.to(x.dtype)
        if self.mlp_type == "swiglu":
            h = F.silu(x @ self.w_gate.to(x.dtype)) * h
        elif self.mlp_type == "relu2":
            h = F.relu(h).square()
        else:
            h = F.gelu(h, approximate="tanh")
        return h @ self.w_down.to(h.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    """``init_embed``/``embed_tokens``/``unembed``: token rows, cast to the working
    dtype after the gather, and an output head (the transposed token table when
    embeddings are tied)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.tie = cfg.tie_embeddings
        self.dtype = dt = working_dtype(cfg)
        self.tok = _param((cfg.vocab_size, cfg.d_model), dt, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.vocab_size), dt, device)

    def reset_parameters(self, generator):
        dense_init_(self.tok, generator)
        if not self.tie:
            dense_init_(self.unembed, generator)

    def embed_tokens(self, tokens):
        return self.tok[tokens].to(self.dtype)

    def logits(self, x):
        return x @ (self.tok.T if self.tie else self.unembed).to(x.dtype)
