"""Layer-stack engine: the decoder-only path of the JAX package's ``models/transformer.py``.

Every architecture is described by a *block program*: the periodic pattern of
(mixer, ffn, cross) sublayers, ``n_layers = n_stack * period`` deep. The reference
stacks each position-in-period's parameters over ``n_stack`` and runs the stack
with ``lax.scan``; here the layers are an ``nn.ModuleList`` in execution order
(layer ``s * period + j`` is stack entry ``s`` of position ``j``) and a Python loop
runs them.

Ported: mixers ``attn`` and ``ssm`` with FFNs ``dense``, ``moe`` or none, in modes
prefill and decode, which covers the dense, MoE, SSM and hybrid families. Cross-
attention (enc-dec) raises ``NotImplementedError``; ``forward_train`` and ``loss_fn``
wait for the training slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers, mamba, moe
from repro_torch.models.layers import _run

# ---------------------------------------------------------------------------
# block program
# ---------------------------------------------------------------------------


def block_period(cfg: ArchConfig) -> int:
    p = 1
    if cfg.attn_period:
        p = math.lcm(p, cfg.attn_period)
    if cfg.moe and cfg.moe_period > 1:
        p = math.lcm(p, cfg.moe_period)
    return p


def block_program(cfg: ArchConfig) -> list[dict]:
    P = block_period(cfg)
    prog = []
    for j in range(P):
        if cfg.family == "ssm":
            mixer, ffn = "ssm", None
        elif cfg.attn_period:
            mixer = "attn" if cfg.is_attn_layer(j) else "ssm"
            ffn = "moe" if cfg.is_moe_layer(j) else ("dense" if cfg.d_ff else None)
        else:
            mixer = "attn"
            ffn = "moe" if cfg.is_moe_layer(j) else ("dense" if cfg.d_ff else None)
        prog.append({"mixer": mixer, "ffn": ffn, "cross": bool(cfg.encdec)})
    return prog


def check_ported(cfg: ArchConfig) -> list[dict]:
    """The block program, or NotImplementedError for the enc-dec family."""
    prog = block_program(cfg)
    if any(entry["cross"] for entry in prog):
        raise NotImplementedError(
            f"{cfg.name}: enc-dec cross-attention is not ported yet: ROADMAP Queue 1, item 6b"
        )
    return prog


# ---------------------------------------------------------------------------
# one block (the reference's _apply_block_pos without cross-attention)
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer: x + mixer(norm1(x)), then x + ffn(norm2(x)) when it has an FFN.
    The mixer is attention or SSD, the FFN a dense MLP, an MoE or none."""

    def __init__(self, cfg: ArchConfig, entry: dict, device):
        super().__init__()
        self.norm1 = layers.Norm(cfg, cfg.d_model, device)
        self.kind = entry["mixer"]
        if self.kind == "attn":
            self.mixer = layers.Attention(cfg, device)
        else:
            self.mixer = mamba.SSD(cfg, device)
        self.ffn_kind = entry["ffn"]
        if self.ffn_kind:
            self.norm2 = layers.Norm(cfg, cfg.d_model, device)
            self.ffn = layers.MLP(cfg, device) if self.ffn_kind == "dense" else moe.MoE(cfg, device)

    def forward(self, x, *, mode: str, positions=None, cache=None, pos=None, step=_run):
        """mode: prefill | decode. ``cache`` is this layer's {"attn": {"k", "v"}} or
        {"ssm": {"conv", "state"}}, updated in place."""
        h = step("norms", lambda: self.norm1(x))
        if self.kind == "attn":
            attn_mode = "causal" if mode == "prefill" else "decode"
            out, _ = self.mixer(
                h, mode=attn_mode, positions=positions, cache=cache["attn"], pos=pos, step=step
            )
        else:
            out, _ = self.mixer(h, cache=cache["ssm"], pos=pos, step=step)
        x = x + out
        if self.ffn_kind:
            h = step("norms", lambda: self.norm2(x))
            if self.ffn_kind == "dense":
                x = x + step("mlp", lambda: self.ffn(h))
            else:
                # the gather path: the reference's decode asks for it (moe_impl="gather"),
                # and without a mesh its prefill takes it too
                x = x + self.ffn(h, step=step)[0]
        return x


# ---------------------------------------------------------------------------
# public model functions
# ---------------------------------------------------------------------------


def _layer_cache(cache, layer: int, period: int):
    """Layer ``layer``'s entry, {"attn": {"k", "v"}} or {"ssm": {"conv", "state"}}:
    views into the stacked cache tree."""
    s = layer // period
    return {
        kind: {name: t[s] for name, t in entry.items()}
        for kind, entry in cache[layer % period].items()
    }


def forward_prefill(model, tokens, cache, step=_run):
    """tokens (B, S) -> (cache, last-token logits (B, 1, V)). ``cache`` (from
    ``Model.init_cache`` with max_seq >= S) is filled in place at [:S]."""
    x = step("embed", lambda: model.embed.embed_tokens(tokens))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    P = len(model.program)
    for i, block in enumerate(model.blocks):
        c = _layer_cache(cache, i, P)
        x = block(x, mode="prefill", positions=positions, cache=c, step=step)
    x = step("norms", lambda: model.final_norm(x[:, -1:, :]))
    return cache, step("unembed", lambda: model.embed.logits(x))


def decode_step(model, cache, tokens, pos: int):
    """One decode step. tokens: (B, 1); pos: absolute position. Returns (cache,
    logits (B, 1, V)); the cache is updated in place."""
    x = model.embed.embed_tokens(tokens)
    P = len(model.program)
    for i, block in enumerate(model.blocks):
        x = block(x, mode="decode", cache=_layer_cache(cache, i, P), pos=pos)
    return cache, model.embed.logits(model.final_norm(x))


# ---------------------------------------------------------------------------
# cache specs: the reference's tree structure, (shape, dtype) at the leaves
# ---------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int):
    """Per period position, {"attn": {"k", "v"}} of (n_stack, B, K, max_seq, hd) in the
    working dtype, or {"ssm": {"conv", "state"}} of (n_stack, B, W - 1, cch) in the
    working dtype and (n_stack, B, H, N, P) in float32."""
    prog = check_ported(cfg)
    n_stack = cfg.n_layers // len(prog)
    kv = ((n_stack, batch, cfg.n_kv_heads, max_seq, cfg.head_dim), layers.working_dtype(cfg))
    ssm = {n: ((n_stack, *shape), dt) for n, (shape, dt) in mamba.cache_spec(cfg, batch).items()}
    return tuple(
        {"attn": {"k": kv, "v": kv}} if e["mixer"] == "attn" else {"ssm": dict(ssm)} for e in prog
    )
