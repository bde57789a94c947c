"""Layer-stack engine: the JAX package's ``models/transformer.py``.

Every architecture is described by a *block program*: the periodic pattern of
(mixer, ffn, cross) sublayers, ``n_layers = n_stack * period`` deep. The reference
stacks each position-in-period's parameters over ``n_stack`` and runs the stack
with ``lax.scan``; here the layers are an ``nn.ModuleList`` in execution order
(layer ``s * period + j`` is stack entry ``s`` of position ``j``) and a Python loop
runs them.

Ported: mixers ``attn`` and ``ssm`` with FFNs ``dense``, ``moe`` or none, in modes
prefill, decode and train, which covers the dense, MoE, SSM and hybrid families; and
the enc-dec family's two stacks, the encoder [bidirectional attention + FFN] and the
decoder [attention + cross-attention + FFN]. ``forward_train`` and ``loss_fn`` are the
training forward and loss; with ``remat == "full"`` each period of blocks (the body
of the reference's scan) is recomputed in the backward (``torch.utils.checkpoint``),
which changes memory, not numbers.

Each function reads the model's ``rules`` (``Model.shard``; no mesh by default) and
passes them to every block, which constrains its residual stream where the
reference's ``_apply_block_pos`` does.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import lift, local_call, owned
from repro_torch.models import layers, mamba, moe
from repro_torch.models.layers import _run, constrain

_RESIDUAL = ("batch", "act_seq", "act_embed")

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


def block_program(cfg: ArchConfig, decoder: bool = True) -> list[dict]:
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
        prog.append({"mixer": mixer, "ffn": ffn, "cross": bool(cfg.encdec and decoder)})
    return prog


# ---------------------------------------------------------------------------
# one block (the reference's _apply_block_pos)
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One layer: x + mixer(norm1(x)); in a decoder block of the enc-dec family then
    x + cross(norm_cross(x), encoder output); then x + ffn(norm2(x)) when it has an
    FFN. The mixer is attention or SSD, the FFN a dense MLP, an MoE or none."""

    def __init__(self, cfg: ArchConfig, entry: dict, device, ep_size=None):
        super().__init__()
        self.norm1 = layers.Norm(cfg, cfg.d_model, device)
        self.kind = entry["mixer"]
        if self.kind == "attn":
            self.mixer = layers.Attention(cfg, device)
        else:
            self.mixer = mamba.SSD(cfg, device)
        self.has_cross = entry["cross"]
        if self.has_cross:
            self.norm_cross = layers.Norm(cfg, cfg.d_model, device)
            self.cross = layers.Attention(cfg, device)
        self.ffn_kind = entry["ffn"]
        if self.ffn_kind:
            self.norm2 = layers.Norm(cfg, cfg.d_model, device)
            if self.ffn_kind == "dense":
                self.ffn = layers.MLP(cfg, device)
            else:
                self.ffn = moe.MoE(cfg, device, ep_size)

    def forward(
        self,
        x,
        *,
        mode: str,
        positions=None,
        cache=None,
        pos=None,
        enc_out=None,
        step=_run,
        rules=None,
    ):
        """mode: encode | prefill | decode. ``cache`` is this layer's {"attn": {"k", "v"}}
        or {"ssm": {"conv", "state"}}, with {"cross": {"ck", "cv"}} in a decoder block of
        the enc-dec family, updated in place; an encoder block takes none. ``enc_out``
        is the encoder's output at prefill."""
        h = step("norms", lambda: self.norm1(x))
        if mode == "encode":  # every encoder block's mixer is attention
            out, _ = self.mixer(h, mode="bidir", positions=positions, step=step, rules=rules)
        elif self.kind == "attn":
            attn_mode = "causal" if mode == "prefill" else "decode"
            out, _ = self.mixer(
                h,
                mode=attn_mode,
                positions=positions,
                cache=cache["attn"],
                pos=pos,
                step=step,
                rules=rules,
            )
        else:
            out, _ = self.mixer(h, cache=cache["ssm"], pos=pos, step=step, rules=rules)
        x = constrain(rules, x + out, _RESIDUAL)
        if self.has_cross:
            h = step("norms", lambda: self.norm_cross(x))
            if mode == "decode":
                out, _ = self.cross(h, mode="cross_decode", cache=cache["cross"], rules=rules)
            else:
                out, _ = self.cross(
                    h, mode="cross", kv_x=enc_out, cache=cache["cross"], step=step, rules=rules
                )
            x = x + out
        if self.ffn_kind:
            h = step("norms", lambda: self.norm2(x))
            if self.ffn_kind == "dense":
                x = x + step("mlp", lambda: self.ffn(h, rules))
            else:
                # decode takes the gather path (the reference's moe_impl="gather"), as does
                # every call without a mesh; on a mesh prefill takes cfg.moe_impl
                impl = "gather" if mode == "decode" else None
                x = x + self.ffn(h, step=step, rules=rules, impl=impl)[0]
            x = constrain(rules, x, _RESIDUAL)
        return x

    def forward_train(
        self, x, *, positions, enc_out=None, encoder=False, q_chunk=1024, rules=None
    ):
        """The reference's ``_apply_block_pos`` in mode train: attention causal (bidir in
        an encoder block) through the training attention, SSD without a cache, cross-
        attention over ``enc_out``, the FFN. Returns (x, aux), aux the MoE's load-
        balancing loss (0 without one)."""
        h = self.norm1(x)
        if self.kind == "attn":
            mode = "bidir" if encoder else "causal"
            out = self.mixer.forward_train(
                h, mode=mode, positions=positions, q_chunk=q_chunk, rules=rules
            )
        else:
            out, _ = self.mixer(h, rules=rules)
        x = constrain(rules, x + out, _RESIDUAL)
        if self.has_cross:
            h = self.norm_cross(x)
            x = x + self.cross.forward_train(
                h, mode="cross", kv_x=enc_out, q_chunk=q_chunk, rules=rules
            )
        aux = x.new_zeros((), dtype=torch.float32)
        if self.ffn_kind == "dense":
            x = x + self.ffn(self.norm2(x), rules)
        elif self.ffn_kind:
            out, aux = self.ffn(self.norm2(x), rules=rules)
            x = x + out
        if self.ffn_kind:
            x = constrain(rules, x, _RESIDUAL)
        return x, aux


# ---------------------------------------------------------------------------
# public model functions
# ---------------------------------------------------------------------------


def _layer_cache(cache, layer: int, period: int):
    """Layer ``layer``'s entry, {"attn": {"k", "v"}} or {"ssm": {"conv", "state"}} (and
    {"cross": {"ck", "cv"}}): views into the stacked cache tree."""
    s = layer // period
    return {
        kind: {name: t[s] for name, t in entry.items()}
        for kind, entry in cache[layer % period].items()
    }


def _prefixed(step, prefix: str):
    """``step`` with ``prefix`` before every name: the enc-dec family's split tells
    the encoder's sublayers from the decoder's."""
    return lambda name, fn: step(prefix + name, fn)


def _add_positions(cfg: ArchConfig, x, positions):
    """x + the sinusoidal table at ``positions``, cast to x's dtype before the add, as
    the reference does; x as it is for any other ``pos_emb``."""
    if cfg.pos_emb != "sinusoidal":
        return x
    return x + lift(layers.sinusoidal_pos_emb(positions, cfg.d_model, x.dtype)[None], x)


def _run_train(model, blocks, x, positions, *, enc_out=None, encoder=False, q_chunk=1024):
    """The reference's ``_run_stack`` in mode train over ``blocks``, one period of the
    block program (the reference's scan body) at a time, recomputed in the backward
    when ``cfg.remat == "full"``. Returns (x, the MoE aux losses summed)."""
    P = len(model.enc_program if encoder else model.program)

    def body(x, period):
        aux = x.new_zeros((), dtype=torch.float32)
        for block in period:
            x, a = block.forward_train(
                x,
                positions=positions,
                enc_out=enc_out,
                encoder=encoder,
                q_chunk=q_chunk,
                rules=model.rules,
            )
            aux = aux + a
        return x, aux

    auxes = []
    for s in range(0, len(blocks), P):
        period = blocks[s : s + P]
        if model.cfg.remat == "full":
            x, aux = checkpoint(body, x, period, use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = body(x, period)
        auxes.append(aux)
    return x, torch.stack(auxes).sum()


def _encode(model, frames=None, src_tokens=None, step=_run, *, train=False, q_chunk=1024):
    """The encoder: ``frames`` (B, S, d) cast to the working dtype, or ``src_tokens``
    (B, S) through the shared embedding; then the positions, the encoder stack (its
    training form when ``train``) and ``enc_norm``. Returns (B, S, d)."""
    rules = model.rules
    if frames is not None:
        x = constrain(rules, frames.to(layers.working_dtype(model.cfg)), _RESIDUAL)
    else:
        x = step("embed", lambda: model.embed.embed_tokens(src_tokens, rules))
    positions = torch.arange(x.shape[1], device=x.device)
    x = _add_positions(model.cfg, x, positions)
    if train:
        x, _ = _run_train(model, model.enc_blocks, x, positions, encoder=True, q_chunk=q_chunk)
    else:
        for block in model.enc_blocks:
            x = block(x, mode="encode", positions=positions, step=step, rules=rules)
    return step("norms", lambda: model.enc_norm(x))


def forward_train(model, batch, q_chunk=1024):
    """The training forward: batch {"tokens" (B, S), and for an enc-dec model "frames"
    or "src_tokens"} -> (logits (B, S, V) in the working dtype, the MoE aux losses
    summed)."""
    enc_out = None
    if model.cfg.encdec:
        src = {k: batch[k] for k in ("frames", "src_tokens") if k in batch}
        enc_out = _encode(model, **src, train=True, q_chunk=q_chunk)
    tokens = batch["tokens"]
    x = model.embed.embed_tokens(tokens, model.rules)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _add_positions(model.cfg, x, positions)
    x, aux = _run_train(model, model.blocks, x, positions, enc_out=enc_out, q_chunk=q_chunk)
    return model.embed.logits(model.final_norm(x), model.rules), aux


def loss_fn(model, batch, q_chunk=1024, z_loss: float = 1e-4, moe_aux_weight: float = 1e-2):
    """The reference's ``loss_fn``: mean next-token NLL + z_loss * mean(lse²) +
    moe_aux_weight * aux. With ``softmax_dtype`` float32 the logits go to float32;
    otherwise (the reference's bf16 loss) the float32 row max is subtracted in the
    logits' dtype, exponentiated there and summed in float32. Returns (loss, {"nll",
    "z_loss", "moe_aux"})."""
    logits, aux = forward_train(model, batch, q_chunk)
    if layers.sharded(model.rules):
        targets = model.rules.constrain(batch["targets"], ("batch", None))
        lse, ll = _vocab_parallel_lse(model.cfg, logits, targets.long(), model.rules)
        nll = (lse - ll).mean()
        zl = z_loss * lse.square().mean()
        total = nll + zl + moe_aux_weight * aux
        return total, {"nll": nll, "z_loss": zl, "moe_aux": aux}
    targets = batch["targets"].long()[..., None]
    if model.cfg.softmax_dtype == "float32":
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        ll = lf.gather(-1, targets)[..., 0]
    else:
        # amax: its gradient is shared among tied maxima, as jnp.max's is
        m = logits.amax(dim=-1).float()
        p = torch.exp(logits - m[..., None].to(logits.dtype))
        lse = m + torch.log(p.sum(dim=-1, dtype=torch.float32))
        ll = logits.gather(-1, targets)[..., 0].float()
    nll = (lse - ll).mean()
    zl = z_loss * lse.square().mean()
    total = nll + zl + moe_aux_weight * aux
    return total, {"nll": nll, "z_loss": zl, "moe_aux": aux}


def _vocab_parallel_lse(cfg: ArchConfig, logits, targets, rules):
    """(lse, target logit) of logits (B, S, V) sharded along the vocab over ``model``,
    each (B, S), through ``local_map``: the row max reduced by max first (no gradient
    flows through it: it cancels), then each member's sum of exp(l - max) and its
    target logit (zero where the target is not among its rows) reduced by sum. The
    float32 and bf16 losses as in ``loss_fn``."""
    mesh, pl = rules.mesh, logits.placements
    offset, _ = owned(logits.shape[-1], mesh, pl, 2)

    def rows(reduce):  # the (B, S) outputs: the vocab's shards become partial
        return tuple(reduce if isinstance(p, Shard) and p.dim == 2 else p for p in pl)

    f32 = cfg.softmax_dtype == "float32"
    with torch.no_grad():
        m = local_call(lambda l: l.amax(-1).float(), (rows(Partial("max")),), logits)
        m = m.redistribute(mesh, rows(Replicate()))

    def local(l, m, t):
        lf = l.float() if f32 else l
        e = torch.exp(lf - m[..., None].to(lf.dtype))
        se = e.sum(-1, dtype=torch.float32)
        t = t - offset
        inside = (t >= 0) & (t < l.shape[-1])
        tl = lf.gather(-1, t.clamp(0, l.shape[-1] - 1)[..., None])[..., 0].float()
        return se, torch.where(inside, tl, 0.0)

    out = (rows(Partial()), rows(Partial()))
    se, ll = local_call(local, out, logits, m, targets)
    rep = rows(Replicate())
    return m + torch.log(se.redistribute(mesh, rep)), ll.redistribute(mesh, rep)


def forward_prefill(model, tokens, cache, step=_run, *, frames=None, src_tokens=None):
    """tokens (B, S) -> (cache, last-token logits (B, 1, V)). ``cache`` (from
    ``Model.init_cache`` with max_seq >= S) is filled in place at [:S]. An enc-dec
    model first encodes ``frames`` or ``src_tokens`` and writes each decoder layer's
    cross keys and values into the cache at [:S_enc]."""
    enc_out = None
    rules = model.rules
    if model.cfg.encdec:
        enc_out = _encode(model, frames, src_tokens, _prefixed(step, "encoder "))
        step = _prefixed(step, "decoder ")
    x = step("embed", lambda: model.embed.embed_tokens(tokens, rules))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _add_positions(model.cfg, x, positions)
    P = len(model.program)
    for i, block in enumerate(model.blocks):
        c = _layer_cache(cache, i, P)
        x = block(
            x,
            mode="prefill",
            positions=positions,
            cache=c,
            enc_out=enc_out,
            step=step,
            rules=rules,
        )
    x = step("norms", lambda: model.final_norm(x[:, -1:, :]))
    return cache, step("unembed", lambda: model.embed.logits(x, rules))


def decode_step(model, cache, tokens, pos: int):
    """One decode step. tokens: (B, 1); pos: absolute position. Returns (cache,
    logits (B, 1, V)); the cache is updated in place."""
    rules = model.rules
    x = model.embed.embed_tokens(tokens, rules)
    x = _add_positions(model.cfg, x, torch.full((1,), pos, device=x.device))
    P = len(model.program)
    for i, block in enumerate(model.blocks):
        x = block(x, mode="decode", cache=_layer_cache(cache, i, P), pos=pos, rules=rules)
    return cache, model.embed.logits(model.final_norm(x), rules)


# ---------------------------------------------------------------------------
# cache specs: the reference's tree structure, (shape, dtype) at the leaves
# ---------------------------------------------------------------------------


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int):
    """Per period position, {"attn": {"k", "v"}} of (n_stack, B, K, max_seq, hd) in the
    working dtype, or {"ssm": {"conv", "state"}} of (n_stack, B, W - 1, cch) in the
    working dtype and (n_stack, B, H, N, P) in float32; a decoder position of the
    enc-dec family adds {"cross": {"ck", "cv"}} of (n_stack, B, K, enc_memory_len, hd)."""
    prog = block_program(cfg)
    n_stack = cfg.n_layers // len(prog)
    dt = layers.working_dtype(cfg)
    kv = ((n_stack, batch, cfg.n_kv_heads, max_seq, cfg.head_dim), dt)
    cross = ((n_stack, batch, cfg.n_kv_heads, cfg.enc_memory_len, cfg.head_dim), dt)
    ssm = {n: ((n_stack, *shape), t) for n, (shape, t) in mamba.cache_spec(cfg, batch).items()}
    entries = []
    for e in prog:
        entry = {"attn": {"k": kv, "v": kv}} if e["mixer"] == "attn" else {"ssm": dict(ssm)}
        if e["cross"]:
            entry["cross"] = {"ck": cross, "cv": cross}
        entries.append(entry)
    return tuple(entries)


def cache_axes(cfg: ArchConfig):
    """The logical axes of ``cache_specs``' leaves, in its tree (the reference's
    ``unbox_axes`` of its cache Box tree)."""
    kv = ("stack", "cache_batch", "cache_heads", "cache_seq", None)
    ssm = {n: ("stack", *a) for n, a in mamba.CACHE_AXES.items()}
    entries = []
    for e in block_program(cfg):
        entry = {"attn": {"k": kv, "v": kv}} if e["mixer"] == "attn" else {"ssm": dict(ssm)}
        if e["cross"]:
            entry["cross"] = {"ck": kv, "cv": kv}
        entries.append(entry)
    return tuple(entries)
