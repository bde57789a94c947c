"""A plain reference of IBM's Granite 4.0-H language model (``granitemoehybrid``):
the forward pass as the published description states it, in plain PyTorch, with no
kernel, cache or batching trick, for holding a faster implementation against.

It imports torch alone. The configuration is a dict with the keys of the model's
``config.json`` (``hidden_size``, ``layer_types``, ``mamba_d_state``, ...); the weights
are a dict of tensors (``init_params`` draws them, ``forward`` reads them):

    {"embed": (V, d), "norm": (d,), "layers": [one dict a layer:
        "input_norm", "post_norm": (d,);
        "mamba": {"in_proj": (d, 2·din + 2·G·N + H), "conv_w": (W, din + 2·G·N),
                  "conv_b": (din + 2·G·N,), "A_log", "D", "dt_bias": (H,),
                  "norm": (din,), "out_proj": (din, d)}        (a "mamba" layer), or
        "attention": {"q": (d, Hq·hd), "k", "v": (d, Hkv·hd), "o": (Hq·hd, d)};
        "moe": {"router": (d, E), "up", "gate": (E, d, ff), "down": (E, ff, d)};
        "shared": {"up", "gate": (d, ff_s), "down": (ff_s, d)}]}

The equations (``forward``):

    h = embed[ids] · embedding_multiplier
    per layer:  h += residual_multiplier · mixer(rmsnorm(h))
                u = rmsnorm(h);  h += residual_multiplier · (moe(u) + shared(u))
    logits = rmsnorm(h) · embedᵀ / logits_scaling

* mixer, a "mamba" layer: Mamba-2. in_proj splits into z (din), xBC (din + 2·G·N) and
  dt (H); xBC through a causal depthwise conv of width W with bias and SiLU, split
  into x (H heads of P), B and C (G groups of N); dt = softplus(dt + dt_bias),
  A = -exp(A_log); the recurrence, position by position,
  h_t = exp(dt_t·A)·h_{t-1} + dt_t·B_t ⊗ x_t and y_t = C_t·h_t + D·x_t (head h reads
  group h // (H / G)); then y·silu(z) through an RMSNorm (eps ``rms_norm_eps``) and
  out_proj.
* mixer, an "attention" layer: GQA, no positional encoding, softmax(q·kᵀ ·
  attention_multiplier) causal, each KV head serving Hq / Hkv consecutive query heads.
* moe: the router's logits, their top k, a softmax over those k, and the sum of each
  chosen expert's SwiGLU (down(silu(gate·u) · up·u)) by its weight; every routed
  (token, slot) is computed, none dropped. shared: one SwiGLU over every token.

Departures from the published description, each without effect on the result's
mathematics: the logits are computed only at the last ``last`` positions (the head is
position-wise); weights may be stored in a lower precision and are cast to the compute
dtype one layer at a time, so that a model of many GB fits beside its activations;
attention runs over blocks of queries, for the same reason; the SSD recurrence is the
sequential scan, not the chunked algorithm of Mamba-2's kernels (the same sums in
another order). With n_groups 1 the gated norm spans all din channels, as the
published one does.

``dtype`` sets the precision of every step: float32 is the reference (TF32 off); a
lower one (bfloat16) computes the parts the deployment keeps in float32 (the scan's
state and decay, the norms, the softmaxes) in it too. ``tap``, where given, is handed
each Mamba-2 layer's recurrence: ``tap(i, xs, dt, Bm, state)``, the layer's index, the
recurrence's inputs (``recurrence``'s) and its state after the last position.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Q_BLOCK = 1024  # query rows per attention block


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def layer_types(cfg: dict) -> list[str]:
    return list(cfg["layer_types"][: cfg["num_hidden_layers"]])


def init_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """Random weights from ``seed``: each matrix normal with standard deviation
    1 / sqrt(its input width) (an expert's over its own width), drawn in float32 and
    stored in ``dtype``; the embedding likewise over d. Norm scales 1 + 0.1·N(0, 1);
    conv weights N(0, 1 / W), conv bias N(0, 0.01); A = U(1, 16), dt = exp(U(ln 1e-3,
    ln 1e-1)) stored as A_log and softplus⁻¹(dt); D = 1 + 0.1·N(0, 1). The small vectors
    stay float32."""
    g = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32

    def normal(*shape, std=1.0, mean=0.0, keep=False):
        t = torch.randn(shape, generator=g, dtype=f32, device=device).mul_(std).add_(mean)
        return t if keep else t.to(dtype)

    def matrix(*shape):  # (..., in, out)
        return normal(*shape, std=shape[-2] ** -0.5)

    def scales(n):
        return normal(n, std=0.1, mean=1.0, keep=True)

    d, V = cfg["hidden_size"], cfg["vocab_size"]
    E, ff, ffs = cfg["num_local_experts"], cfg["intermediate_size"], cfg["shared_intermediate_size"]
    H, P, N, G = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], cfg["mamba_n_groups"]
    W, din = cfg["mamba_d_conv"], cfg["mamba_expand"] * d
    Hq, Hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    params = {"embed": normal(V, d, std=d**-0.5), "norm": scales(d), "layers": []}
    for kind in layer_types(cfg):
        lp = {"input_norm": scales(d), "post_norm": scales(d)}
        if kind == "mamba":
            u = torch.rand(H, generator=g, dtype=f32, device=device)
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
            a = 1.0 + 15.0 * torch.rand(H, generator=g, dtype=f32, device=device)
            lp["mamba"] = {
                "in_proj": matrix(d, 2 * din + 2 * G * N + H),
                "conv_w": normal(W, din + 2 * G * N, std=W**-0.5, keep=True),
                "conv_b": normal(din + 2 * G * N, std=0.1, keep=True),
                "A_log": torch.log(a),
                "D": scales(H),
                "dt_bias": torch.log(torch.expm1(dt)),
                "norm": scales(din),
                "out_proj": matrix(din, d),
            }
        else:
            lp["attention"] = {"q": matrix(d, Hq * hd), "k": matrix(d, Hkv * hd),
                               "v": matrix(d, Hkv * hd), "o": matrix(Hq * hd, d)}
        lp["moe"] = {"router": matrix(d, E), "up": matrix(E, d, ff), "gate": matrix(E, d, ff),
                     "down": matrix(E, ff, d)}
        lp["shared"] = {"up": matrix(d, ffs), "gate": matrix(d, ffs), "down": matrix(ffs, d)}
        params["layers"].append(lp)
    return params


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def recurrence(cfg: dict, p: dict, xs, dt, Bm, Cm=None):
    """The SSD recurrence, position by position, in xs's dtype: xs (B, S, H, P), dt
    (B, S, H) before its softplus, Bm and Cm (B, S, G, N) -> (y (B, S, H, P), None
    without Cm; the state (B, H, N, P) after the last position)."""
    Bsz, S, H, P = xs.shape
    G, N = Bm.shape[2:]
    xs = xs.reshape(Bsz, S, G, H // G, P)
    Bm = Bm.reshape(Bsz, S, G, 1, N)
    dt = F.softplus(dt + p["dt_bias"]).reshape(Bsz, S, G, H // G)
    decay = torch.exp(dt * -torch.exp(p["A_log"]).reshape(G, H // G))
    h = xs.new_zeros(Bsz, G, H // G, N, P)
    y = None if Cm is None else torch.empty_like(xs)
    for t in range(S):
        h = h * decay[:, t, ..., None, None] + (dt[:, t, ..., None] * Bm[:, t])[..., None] * xs[:, t, :, :, None, :]
        if y is not None:
            y[:, t] = (Cm[:, t].reshape(Bsz, G, 1, N)[..., None] * h).sum(-2)
    return (None if y is None else y.reshape(Bsz, S, H, P)), h.reshape(Bsz, H, N, P)


def mamba(cfg: dict, p: dict, x, tap=None):
    """The Mamba-2 mixer over x (B, S, d), every weight in x's dtype; ``tap(xs, dt, Bm,
    state)`` is handed the recurrence's inputs and last state."""
    Bsz, S, d = x.shape
    H, P, N, G = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"], cfg["mamba_n_groups"]
    W, din = cfg["mamba_d_conv"], cfg["mamba_expand"] * d
    z, xbc, dt = (x @ p["in_proj"]).split([din, din + 2 * G * N, H], dim=-1)
    conv = F.conv1d(xbc.transpose(1, 2), p["conv_w"].T[:, None, :], p["conv_b"],
                    padding=W - 1, groups=xbc.shape[-1])
    xbc = F.silu(conv[..., :S].transpose(1, 2))
    xs, Bm, Cm = xbc.split([din, G * N, G * N], dim=-1)
    xs = xs.reshape(Bsz, S, H, P)
    Bm, Cm = Bm.reshape(Bsz, S, G, N), Cm.reshape(Bsz, S, G, N)
    y, state = recurrence(cfg, p, xs, dt, Bm, Cm)
    if tap is not None:
        tap(xs, dt, Bm, state)
    y = (y + p["D"][..., None] * xs).reshape(Bsz, S, din)
    y = rms_norm(y * F.silu(z), p["norm"], cfg["rms_norm_eps"])
    return y @ p["out_proj"]


def attention(cfg: dict, p: dict, x):
    """Causal GQA over x (B, S, d) with no positional encoding, queries in blocks."""
    Bsz, S, _ = x.shape
    Hq, Hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    q = (x @ p["q"]).view(Bsz, S, Hq, hd)
    k = (x @ p["k"]).view(Bsz, S, Hkv, hd).repeat_interleave(Hq // Hkv, dim=2)
    v = (x @ p["v"]).view(Bsz, S, Hkv, hd).repeat_interleave(Hq // Hkv, dim=2)
    out = torch.empty_like(q)
    keys = torch.arange(S, device=x.device)
    for r0 in range(0, S, Q_BLOCK):
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, r0 : r0 + Q_BLOCK], k) * cfg["attention_multiplier"]
        rows = r0 + torch.arange(s.shape[2], device=x.device)
        s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        out[:, r0 : r0 + Q_BLOCK] = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return out.reshape(Bsz, S, Hq * hd) @ p["o"]


def swiglu(x, up, gate, down):
    return (F.silu(x @ gate) * (x @ up)) @ down


def moe(cfg: dict, p: dict, u):
    """The routed experts over u (T, d): every (token, slot) computed."""
    T, d = u.shape
    k = cfg["num_experts_per_tok"]
    top, idx = (u @ p["router"]).topk(k, dim=-1)
    weight = torch.softmax(top, dim=-1)
    rows = u.new_zeros(T, k, d)
    for e in range(p["up"].shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out = swiglu(u[tok], p["up"][e], p["gate"][e], p["down"][e])
            rows[tok, slot] = out * weight[tok, slot, None]
    return rows.sum(1)


def forward(cfg: dict, params: dict, tokens, dtype=torch.float32, last: int = 1, tap=None):
    """tokens (B, S) int -> the logits at the last ``last`` positions, (B, last, V) in
    float32, every step computed in ``dtype``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps, rm = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = params["embed"][tokens].to(dtype) * cfg["embedding_multiplier"]
    Bsz, S, d = x.shape
    for i, (kind, lp) in enumerate(zip(layer_types(cfg), params["layers"])):
        lp = _cast(lp, dtype)  # this layer's weights alone in the compute dtype
        h = rms_norm(x, lp["input_norm"], eps)
        if kind == "mamba":
            h = mamba(cfg, lp[kind], h, None if tap is None else lambda *scan, i=i: tap(i, *scan))
        else:
            h = attention(cfg, lp[kind], h)
        x = x + h * rm
        u = rms_norm(x, lp["post_norm"], eps).reshape(Bsz * S, d)
        s = lp["shared"]
        x = x + (moe(cfg, lp["moe"], u) + swiglu(u, s["up"], s["gate"], s["down"])).view(Bsz, S, d) * rm
        del lp
    x = rms_norm(x[:, -last:], params["norm"].to(dtype), eps)
    return ((x @ params["embed"].to(dtype).T) / cfg["logits_scaling"]).float()
