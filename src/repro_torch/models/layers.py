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
can time the sublayers; the default just calls ``fn``. Each such sublayer of the
serving path also runs inside a telemetry span (``lm.attention.qkv`` and so on, see
``_part``), which costs one check while nothing records.

Every ``rules`` argument is a ``distributed.sharding.ShardingRules``; with a mesh the
parameters and activations are DTensors and each ``rules.constrain`` sits where the
reference's does. Four things differ from the mesh-free path, none in value:

* Every product runs column or row parallel (``column_parallel``, ``row_parallel``):
  each rank multiplies its own shards through ``local_call`` (over ``local_map``),
  whatever DTensor's matmul rules (which differ across torch versions) would pick.
* K2 (and the training attention) runs through ``local_call`` on the head-sharded (at
  one card, trivially sharded) q, k and v, so that the kernel only ever sees local
  tensors. When H does not divide the ``model`` axis the queries are
  sequence-parallel (``sp_seq``) and the local query length differs from the key
  length, which K2 does not take (the Pallas kernel takes equal lengths only): that
  case runs the plain attention, ``_sdpa_heads``, as the reference's serving path does
  everywhere (ROADMAP, R5). It never arises on one card.
* The cache's sequence dim is sharded over ``model`` (``cache_seq``), and DTensor
  cannot write into a view of a sharded dim: ``write_seq`` writes through
  ``local_call``, each rank the positions it owns, without gathering the cache.
* Decode attends over the whole seq-sharded cache with the entries past ``pos``
  masked (the reference's ``layout="seq"``), where the mesh-free path slices the
  cache; the masked entries add exactly 0.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import _telemetry as telemetry
from repro_torch.configs.base import ArchConfig, hybrid_setting
from repro_torch.distributed.sharding import lift, local_call, owned
from repro_torch.kernels.attention.ops import gqa_attention

F32 = torch.float32


def _run(name, fn):
    return fn()


def _part(step, span: str, name: str, fn):
    """``step(name, fn)`` inside the telemetry span ``span``: the span is what the
    profiler's trace and a session see, the hook's name what a caller's hook sees."""
    with telemetry.span(span):
        return step(name, fn)


def working_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def sharded(rules) -> bool:
    """Whether ``rules`` places tensors on a mesh."""
    return rules is not None and rules.mesh is not None


def constrain(rules, x, axes):
    """``rules.constrain(x, axes)`` on a mesh; x itself otherwise."""
    return rules.constrain(x, axes) if sharded(rules) else x


def write_seq(dst, src, start: int):
    """dst[:, :, start : start + n] = src for a cache entry dst (B, K, L, hd) and src
    (B, K, n, hd). On a mesh dst's dim 2 may be sharded, which a DTensor view cannot
    take: src is replicated along that dim and each rank writes, through ``local_map``,
    the positions of [start, start + n) that it owns."""
    n = src.shape[2]
    if not isinstance(dst, DTensor):
        dst[:, :, start : start + n].copy_(src)
        return
    mesh = dst.device_mesh
    seq = [i for i, p in enumerate(dst.placements) if isinstance(p, Shard) and p.dim == 2]
    src_pl = tuple(Replicate() if i in seq else p for i, p in enumerate(dst.placements))
    src = src.redistribute(mesh, src_pl)
    lo, hi = owned(dst.shape[2], mesh, dst.placements, 2)
    a, b = max(lo, start), min(hi, start + n)

    def local(d, s):
        if a < b:
            d[:, :, a - lo : b - lo].copy_(s[:, :, a - start : b - start])

    local_call(local, (None,), dst, src)


def write_all(dst, src):
    """dst.copy_(src), src first placed as dst on a mesh."""
    if isinstance(dst, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


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

    AXES = {"scale": ("act_embed",), "bias": ("act_embed",)}

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


def rms_norm_nohead(x, scale, eps: float = 1e-6):
    """RMS norm over the last dim, eps 1e-6 unless given (qk-norm; the SSD block's gated
    norm passes its config's)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


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
    cos = lift(torch.cos(ang)[..., None, :], x)  # (..., S, 1, half)
    sin = lift(torch.sin(ang)[..., None, :], x)
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

    AXES = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
        "q_norm": ("head_dim",),
        "k_norm": ("head_dim",),
    }

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
        q = _heads(x, self.wq)
        return rms_norm_nohead(q, self.q_norm) if self.cfg.qk_norm else q

    def _kv(self, x):
        """The key and value projections (B, S, K, hd), neither normed nor rotated."""
        return _heads(x, self.wk), _heads(x, self.wv)

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
        if isinstance(o, DTensor):
            return row_parallel(o, self.wo, n_in=2)
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ self.wo.to(o.dtype).view(-1, self.cfg.d_model)

    def forward(
        self,
        x,
        *,
        mode: str,
        positions=None,
        cache=None,
        pos=None,
        kv_x=None,
        step=_run,
        rules=None,
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
        scale = hybrid_setting(self.cfg, "attention_multiplier")
        if mode in ("causal", "bidir"):
            causal = mode == "causal"
            q, k, v = _part(step, "lm.attention.qkv", "qkv + rope", lambda: self._qkv(x, positions))
            if sharded(rules):
                q = rules.constrain(q, ("batch", "act_seq", "act_heads", None))
                k = rules.constrain(k, ("batch", "act_seq", "act_heads", None))

                def attend():
                    return sharded_attention(self.cfg, q, k, v, causal=causal, rules=rules)
            else:

                def attend():
                    return gqa_attention(q, k, v, causal=causal, scale=scale)

            out = _part(step, "lm.attention.flash", "attention kernel", attend)
            if sharded(rules):
                out = rules.constrain(out, ("batch", "act_seq", "act_heads", None))
            if causal:
                # prefill cache layout (B, K, S, hd): seq next to head_dim, as the reference's
                write_seq(cache["k"], k.transpose(1, 2), 0)
                write_seq(cache["v"], v.transpose(1, 2), 0)
            return _part(step, "lm.attention.out", "out projection", lambda: self._out(out)), cache
        if mode == "cross":
            # One projection of the encoder output serves the attention and the cache,
            # where the reference projects it twice (models/layers.py:264 and :308).
            q = step("cross q", lambda: self._q(x))
            kv = step("cross K/V", lambda: self.cross_kv(kv_x))
            if cache is not None:
                write_seq(cache["ck"], kv["ck"], 0)
                write_seq(cache["cv"], kv["cv"], 0)
            k = kv["ck"]
            if self.cfg.qk_norm:  # prefill's keys are normed, the cached ones not (R9)
                k = rms_norm_nohead(k, self.k_norm)
            out = step("cross attention", lambda: _sdpa(q, k, kv["cv"], rules=rules, scale=scale))
            return step("cross out projection", lambda: self._out(out)), cache
        if mode == "cross_decode":
            out = _sdpa(self._q(x), cache["ck"], cache["cv"], rules=rules, scale=scale)
            return self._out(out), cache
        if mode == "decode":
            positions = torch.full((1, 1), pos, device=x.device)
            q, k, v = _part(step, "lm.attention.qkv", "qkv + rope", lambda: self._qkv(x, positions))
            write_seq(cache["k"], k.transpose(1, 2), pos)
            write_seq(cache["v"], v.transpose(1, 2), pos)
            if sharded(rules):  # the whole seq-sharded cache, masked past pos
                out = _sdpa(q, cache["k"], cache["v"], kv_valid_len=pos + 1, rules=rules, scale=scale)
            else:
                out = _sdpa(q, cache["k"][:, :, : pos + 1], cache["v"][:, :, : pos + 1], scale=scale)
            return _part(step, "lm.attention.out", "out projection", lambda: self._out(out)), cache
        raise ValueError(f"unknown attention mode {mode!r}")

    def forward_train(
        self, x, *, mode: str, positions=None, kv_x=None, q_chunk: int = 1024, rules=None
    ):
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
        causal = mode == "causal"
        if not sharded(rules):
            out = _sdpa_heads(self.cfg, q, k, v, causal=causal, q_chunk=q_chunk)
            return self._out(out)
        q = rules.constrain(q, ("batch", "act_seq", "act_heads", None))
        k = rules.constrain(k, ("batch", "act_seq", "act_heads", None))
        out = sharded_attention(
            self.cfg, q, k, v, causal=causal, rules=rules, kernel=False, q_chunk=q_chunk
        )
        return self._out(rules.constrain(out, ("batch", "act_seq", "act_heads", None)))


def _heads(x, w):
    """x (B, S, d) @ w (d, heads, hd) -> (B, S, heads, hd); ``column_parallel`` on a
    mesh."""
    if isinstance(x, DTensor):
        return column_parallel(x, w)
    B, S, d = x.shape
    return (x @ w.to(x.dtype).view(d, -1)).view(B, S, *w.shape[1:])


def column_parallel(x, w):
    """x (..., d) @ w (d, *out) -> (..., *out) of DTensors, through ``local_call``: w
    gathered along d (its FSDP ``embed`` shards), its output dims as placed; x whole
    along d and replicated along each mesh dim that shards w's output; the result
    sharded as w's output dims and x's leading dims. Each product is the rank's own
    (Megatron's column parallelism), whatever DTensor's matmul rules would pick."""
    mesh, n = x.device_mesh, x.dim()
    w = w.redistribute(mesh, _whole(w.placements, 0))
    cols = [p.dim if isinstance(p, Shard) else None for p in w.placements]
    x_pl = tuple(Replicate() if c else p for c, p in zip(cols, _whole(x.placements, n - 1)))
    out = tuple(Shard(n - 2 + c) if c else p for c, p in zip(cols, x_pl))
    x = x.redistribute(mesh, x_pl)
    return local_call(lambda x, w: torch.tensordot(x, w.to(x.dtype), dims=1), (out,), x, w)


def row_parallel(h, w, n_in: int = 1):
    """h (..., *in) @ w (*in, d) -> (..., d) of DTensors, contracting w's first n_in
    dims, through ``local_call``: w gathered along d, its contracted dims as placed; h
    sharded alike along its last n_in dims; the result a partial sum along each mesh
    dim that shards them (Megatron's row parallelism)."""
    mesh, n = h.device_mesh, h.dim()
    w = w.redistribute(mesh, _whole(w.placements, n_in))
    rows = [p.dim if isinstance(p, Shard) else None for p in w.placements]
    h_pl = _whole(h.placements, *range(n - n_in, n))
    h_pl = tuple(Shard(n - n_in + r) if r is not None else p for r, p in zip(rows, h_pl))
    out = tuple(Partial() if r is not None else p for r, p in zip(rows, h_pl))
    h = h.redistribute(mesh, h_pl)
    return local_call(lambda h, w: torch.tensordot(h, w.to(h.dtype), dims=n_in), (out,), h, w)


def _whole(placements, *dims) -> tuple:
    """``placements`` with ``dims`` unsharded and nothing partial."""
    return tuple(
        Replicate() if isinstance(p, Partial) or (isinstance(p, Shard) and p.dim in dims) else p
        for p in placements
    )


def sharded_attention(cfg: ArchConfig, q, k, v, *, causal, rules, kernel=True, q_chunk=1024):
    """The attention of q (B, Sq, H, hd) over k/v (B, Skv, K, hd), DTensors on
    ``rules``' mesh, through ``local_call``: the reference's ``_sdpa`` TP rule. Heads are
    sharded over ``model`` when H divides it, k and v repeated to H heads first when K
    does not; each rank then runs K2 (``kernel``, serving) or ``_sdpa_heads``
    (training) on its local heads. Otherwise the queries are sequence-parallel on
    ``sp_seq`` over keys replicated along ``model``, and each rank runs ``_sdpa_heads``
    on its rows from their absolute offset (K2 takes equal query and key lengths
    only)."""
    mesh = rules.mesh
    H, K = q.shape[2], k.shape[2]
    tp = rules.axis_size("model")
    if tp > 1 and H % tp:
        q = rules.constrain(q, ("batch", "sp_seq", None, None))
        k = rules.constrain(k, ("batch", "act_seq", None, None))
        v = rules.constrain(v, ("batch", "act_seq", None, None))
    else:
        if K != H and K % tp:
            k = k.repeat_interleave(H // K, dim=2)  # (B, Skv, H, hd), head-shardable
            v = v.repeat_interleave(H // K, dim=2)
        k = rules.constrain(k, ("batch", "act_seq", "act_heads", None))
        v = rules.constrain(v, ("batch", "act_seq", "act_heads", None))
    offset, rows_end = owned(q.shape[1], mesh, q.placements, 1)  # this rank's query rows
    rows_split = rows_end - offset < q.shape[1]
    if kernel and not rows_split and q.shape[1] == k.shape[1]:

        def core(q, k, v):
            return gqa_attention(q, k, v, causal=causal, scale=hybrid_setting(cfg, "attention_multiplier"))
    else:

        def core(q, k, v):
            return _sdpa_heads(cfg, q, k, v, causal=causal, q_offset=offset, q_chunk=q_chunk)

    return local_call(core, (q.placements,), q, k, v)


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
    Returns (B, Sq, H, hd). The scale is ``cfg.attention_multiplier`` where set."""
    B, Sq, H, hd = q.shape
    scale = hybrid_setting(cfg, "attention_multiplier") or 1.0 / math.sqrt(hd)
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


def _sdpa(q, k, v, kv_valid_len=None, rules=None, scale=None):
    """The reference's ``_sdpa`` in its cache layout (``layout="seq"``), in plain torch
    as the reference computes it outside any Pallas kernel: scores in the working dtype
    then float32, float32 softmax, weights cast back before P·V. It serves decode,
    ``cross_decode`` and ``cross`` (where the query length is not the key length and K2
    does not apply). q: (B, Sq, H, hd); k/v: (B, K, L, hd), the cache layout, hold the L
    keys attended to; entries at or past ``kv_valid_len`` are masked with -1e30, which
    add exactly 0 (the reference's decode; the mesh-free decode slices them off). On a
    mesh it runs as ``_sdpa_seq_sharded``. ``scale`` multiplies the scores (None:
    hd ** -0.5)."""
    if sharded(rules):
        return _sdpa_seq_sharded(q, k, v, kv_valid_len, rules, scale)
    B, Sq, H, hd = q.shape
    K = k.shape[1]
    qg = q.reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bqkgh,bksh->bkgqs", qg, k).float() * (scale or 1.0 / math.sqrt(hd))
    if kv_valid_len is not None:
        s = torch.where(torch.arange(k.shape[2], device=q.device) < kv_valid_len, s, -1e30)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bksh->bqkgh", w, v)
    return o.reshape(B, Sq, H, hd)


def _sdpa_seq_sharded(q, k, v, kv_valid_len, rules, scale=None):
    """``_sdpa`` on DTensors through ``local_call``, k and v kept sequence-sharded as
    the cache is (``cache_seq``): the reference's two-pass partial reduction. Each rank
    scores its batch rows' queries (all heads) against the keys it holds; the softmax's
    row max is reduced by max and its sum by sum, and each rank's share of P·V is a
    partial sum. Where no mesh dim of more than one device splits the keys (one card),
    each rank runs ``_sdpa`` whole on its rows."""
    mesh = rules.mesh
    q = rules.constrain(q, ("batch", None, None, None))
    cache = ("cache_batch", "cache_heads", "cache_seq", None)
    k, v = rules.constrain(k, cache), rules.constrain(v, cache)
    split = [i for i, p in enumerate(k.placements) if p == Shard(2) and mesh.shape[i] > 1]
    if not split:
        return local_call(
            lambda q, k, v: _sdpa(q, k, v, kv_valid_len, scale=scale), (q.placements,), q, k, v
        )
    B, Sq, H, hd = q.shape
    lo, _ = owned(k.shape[2], mesh, k.placements, 2)
    s_pl = tuple(Shard(4) if i in split else p for i, p in enumerate(q.placements))

    def rows(reduce):  # the (B, K, G, Sq) row statistics: the keys' shards reduced
        return tuple(reduce if i in split else p for i, p in enumerate(q.placements))

    def scores(q, k):
        K, L = k.shape[1], k.shape[2]
        qg = q.reshape(q.shape[0], Sq, K, H // K, hd)
        s = torch.einsum("bqkgh,bksh->bkgqs", qg, k).float() * (scale or 1.0 / math.sqrt(hd))
        if kv_valid_len is not None:
            s = torch.where(torch.arange(lo, lo + L, device=q.device) < kv_valid_len, s, -1e30)
        return s

    s = local_call(scores, (s_pl,), q, k)
    m = local_call(lambda s: s.amax(-1), (rows(Partial("max")),), s)
    m = m.redistribute(mesh, rows(Replicate()))
    se = local_call(lambda s, m: torch.exp(s - m[..., None]).sum(-1), (rows(Partial()),), s, m)
    se = se.redistribute(mesh, rows(Replicate()))

    def pv(s, m, se, v):
        w = (torch.exp(s - m[..., None]) / se[..., None]).to(v.dtype)
        return torch.einsum("bkgqs,bksh->bqkgh", w, v).reshape(v.shape[0], Sq, H, hd)

    return local_call(pv, (rows(Partial()),), s, m, se, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """``init_mlp``/``apply_mlp``: swiglu, relu² or gelu (the tanh form, which is
    ``jax.nn.gelu``'s default)."""

    AXES = {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed"), "w_gate": ("embed", "mlp")}

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

    def forward(self, x, rules=None):
        mm = column_parallel if sharded(rules) else lambda x, w: x @ w.to(x.dtype)
        h = mm(x, self.w_up)
        if self.mlp_type == "swiglu":
            h = F.silu(mm(x, self.w_gate)) * h
        elif self.mlp_type == "relu2":
            h = F.relu(h).square()
        else:
            h = F.gelu(h, approximate="tanh")
        if not sharded(rules):
            return h @ self.w_down.to(h.dtype)
        return row_parallel(rules.constrain(h, ("batch", "act_seq", "act_mlp")), self.w_down)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    """``init_embed``/``embed_tokens``/``unembed``: token rows, cast to the working
    dtype after the gather, and an output head (the transposed token table when
    embeddings are tied). A config's ``embedding_multiplier`` scales the rows and its
    ``logits_scaling`` divides the logits, each in the working dtype, where not 1."""

    AXES = {"tok": ("vocab", "embed"), "unembed": ("embed", "vocab")}

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.tie = cfg.tie_embeddings
        self.dtype = dt = working_dtype(cfg)
        self.multiplier = hybrid_setting(cfg, "embedding_multiplier")
        self.logits_scaling = hybrid_setting(cfg, "logits_scaling")
        self.tok = _param((cfg.vocab_size, cfg.d_model), dt, device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.vocab_size), dt, device)

    def reset_parameters(self, generator):
        dense_init_(self.tok, generator)
        if not self.tie:
            dense_init_(self.unembed, generator)

    def embed_tokens(self, tokens, rules=None):
        """Token rows in the working dtype. On a mesh the tokens are placed by the
        batch axes and the rows looked up in the vocab-sharded table through
        ``local_map`` (the table gathered along its embed dim first): each ``model``
        member gives the rows it holds and zeros elsewhere, a partial sum that the
        constraint of the reference's ``embed_tokens`` reduces."""
        if not sharded(rules):
            return _times(self.tok[tokens].to(self.dtype), self.multiplier)
        mesh = rules.mesh
        tokens = rules.constrain(tokens, ("batch",) + (None,) * (tokens.dim() - 1))
        table_pl = rules.placements_for(("vocab", None), self.tok.shape)
        offset, _ = owned(self.tok.shape[0], mesh, table_pl, 0)
        out_pl = [
            Partial() if isinstance(t, Shard) else p for t, p in zip(table_pl, tokens.placements)
        ]

        def lookup(ids, table):
            local = ids - offset
            inside = (local >= 0) & (local < table.shape[0])
            rows = table[local.clamp(0, table.shape[0] - 1)]
            return torch.where(inside[..., None], rows, 0).to(self.dtype)

        table = self.tok.redistribute(mesh, table_pl)
        x = local_call(lookup, (tuple(out_pl),), tokens, table)
        return _times(rules.constrain(x, ("batch", "act_seq", "act_embed")), self.multiplier)

    def logits(self, x, rules=None):
        w = self.tok.T if self.tie else self.unembed
        if not sharded(rules):
            return _times(x @ w.to(x.dtype), 1.0 / self.logits_scaling)
        out = rules.constrain(column_parallel(x, w), ("batch", "act_seq", "act_vocab"))
        return _times(out, 1.0 / self.logits_scaling)


def _times(x, c: float):
    """x * c, or x itself where c is 1 (no extra pass for the configs without one)."""
    return x if c == 1.0 else x * c
