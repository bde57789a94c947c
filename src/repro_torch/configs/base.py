"""Architecture + input-shape configuration system.

Every assigned architecture is an ``ArchConfig``; every benchmark input shape is a
``ShapeSpec``. A copy of the JAX package's ``configs/base.py``, field for field, so
that a config compares equal with the reference's. ``input_specs`` gives meta tensors
where the reference gives ``jax.ShapeDtypeStruct`` stand-ins.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ArchConfig:
    """One architecture, fully specified (no runtime defaults hidden in model code)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int  # 0 => attention-free
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp_type: str = "swiglu"  # swiglu | relu2 | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    pos_emb: str = "rope"  # rope | sinusoidal | none
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # chatglm3: 0.5 ("RoPE 2d" == partial rotary)
    qk_norm: bool = False  # chameleon
    tie_embeddings: bool = False

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    n_experts_per_tok: int = 0
    moe_period: int = 1  # MoE FFN every `period` layers (jamba: 2)
    moe_offset: int = 0  # first MoE layer index within a period (jamba: 1)
    moe_d_ff: int = 0  # per-expert hidden size
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm: bool = False
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 128

    # --- hybrid (jamba): attention layer at index `attn_offset` of every
    # `attn_period` layers; all other layers are SSM. ---
    attn_period: int = 0
    attn_offset: int = 0

    # --- encoder-decoder ---
    encdec: bool = False
    n_enc_layers: int = 0
    dec_len_fraction: int = 8  # decoder_len = seq_len // this (train/prefill)
    enc_memory_len: int = 4096  # encoder memory length for pure-decode shapes

    # --- modality frontend (stubbed per brief) ---
    frontend: str = "none"  # none | audio | vision

    # --- numerics / perf knobs ---
    # use_flash_kernel, scan_layers and unroll are kept so that a config compares
    # field for field with the reference's; the port reads none of them. Its serving
    # attention picks the flash kernel from the tensors' device alone (CUDA: the
    # kernel, CPU: the plain version), whatever use_flash_kernel says; its training
    # attention is the reference's plain one. remat is read by the training forward.
    dtype: str = "bfloat16"
    remat: str = "full"  # full | none  (activation checkpointing per layer)
    use_flash_kernel: bool = False  # Pallas attention on real TPU (reference)
    scan_layers: bool = True
    unroll: bool = False
    # block-causal attention over q-chunks in the reference's plain attention
    causal_block_skip: bool = False
    # MoE dispatch implementation: "dense" (one-hot einsum) or "ep" (expert parallel)
    moe_impl: str = "dense"
    # logits softmax accumulation dtype
    softmax_dtype: str = "float32"

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---------- derived quantities ----------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm else 0

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_period:
            return i % self.attn_period == self.attn_offset
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.moe:
            return False
        return i % self.moe_period == self.moe_offset

    # ---------- parameter counting (for MODEL_FLOPS = 6·N·D) ----------
    def param_counts(self) -> dict[str, float]:
        """Return total and active parameter counts (floats to avoid overflow)."""
        d, V = self.d_model, self.vocab_size
        embed = d * V
        out_head = 0 if self.tie_embeddings else d * V

        def attn_params() -> float:
            q = d * self.n_heads * self.head_dim
            kv = 2 * d * self.n_kv_heads * self.head_dim
            o = self.n_heads * self.head_dim * d
            return q + kv + o

        def dense_ffn(dff: int) -> float:
            mult = 3 if self.mlp_type == "swiglu" else 2
            return mult * d * dff

        total = float(embed + out_head)
        active = float(embed + out_head)
        n_layers = self.n_layers + (self.n_enc_layers if self.encdec else 0)
        for i in range(n_layers):
            is_enc = self.encdec and i >= self.n_layers
            li = i if not is_enc else i - self.n_layers
            layer_t = 0.0
            layer_a = 0.0
            if self.family == "ssm" or (self.attn_period and not self.is_attn_layer(li)):
                # SSD block params
                din, H, G, N = self.d_inner, self.ssm_nheads, self.ssm_ngroups, self.ssm_state
                p = d * (2 * din + 2 * G * N + H)  # in_proj (z,x,B,C,dt)
                p += self.conv_width * (din + 2 * G * N)  # conv
                p += H * 2 + din  # A_log, D, norm
                p += din * d  # out_proj
                layer_t += p
                layer_a += p
            else:
                layer_t += attn_params()
                layer_a += attn_params()
                if (not is_enc) and self.encdec:
                    layer_t += attn_params()  # cross-attention
                    layer_a += attn_params()
            # FFN
            if self.is_moe_layer(li) and not is_enc:
                ep = dense_ffn(self.moe_d_ff)
                shared_ff = hybrid_setting(self, "shared_d_ff")
                shared = dense_ffn(shared_ff) if shared_ff else 0
                layer_t += self.n_experts * ep + d * self.n_experts + shared
                layer_a += self.n_experts_per_tok * ep + d * self.n_experts + shared
            elif self.family == "ssm" or (
                self.attn_period and not self.is_attn_layer(li) and self.d_ff == 0
            ):
                pass  # pure SSM block, no FFN
            elif self.d_ff > 0:
                layer_t += dense_ffn(self.d_ff)
                layer_a += dense_ffn(self.d_ff)
            total += layer_t
            active += layer_a
        return {"total": total, "active": active}


@dataclass(frozen=True)
class HybridMoEConfig(ArchConfig):
    """An ``ArchConfig`` with the settings of IBM's ``granitemoehybrid`` models (Granite
    4.0-H) as fields: µP-style multipliers on the embedding, the residual branches, the
    attention scores and the logits, a shared expert beside the routed ones, routing
    that drops no slot, and the eps of the SSD block's gated norm. The JAX package has
    no such model, so no reference config is compared with it field for field; the
    other configs lack these fields, so that their ``asdict`` stays the reference's.
    Each default is neutral: the model computes what it computes for a config without
    the field. The model code reads them through ``hybrid_setting``."""

    embedding_multiplier: float = 1.0  # token rows scaled after the lookup
    residual_multiplier: float = 1.0  # each branch scaled before its residual add
    attention_multiplier: float | None = None  # the softmax scale; None: head_dim ** -0.5
    logits_scaling: float = 1.0  # the logits divided by it
    shared_d_ff: int = 0  # a shared SwiGLU expert beside the routed ones (0: none)
    moe_dropless: bool = False  # route every slot (no capacity) through a grouped product
    ssm_norm_eps: float = 1e-6  # the SSD block's gated RMSNorm

    def published(self) -> dict:
        """The config under the keys of the model's published ``config.json``, the form
        that the model's plain reference reads."""
        return {
            "hidden_size": self.d_model,
            "num_hidden_layers": self.n_layers,
            "layer_types": ["attention" if self.is_attn_layer(i) else "mamba"
                            for i in range(self.n_layers)],
            "num_attention_heads": self.n_heads,
            "num_key_value_heads": self.n_kv_heads,
            "vocab_size": self.vocab_size,
            "intermediate_size": self.moe_d_ff,
            "shared_intermediate_size": self.shared_d_ff,
            "num_local_experts": self.n_experts,
            "num_experts_per_tok": self.n_experts_per_tok,
            "mamba_n_heads": self.ssm_nheads,
            "mamba_d_head": self.ssm_headdim,
            "mamba_d_state": self.ssm_state,
            "mamba_n_groups": self.ssm_ngroups,
            "mamba_d_conv": self.conv_width,
            "mamba_expand": self.ssm_expand,
            "mamba_chunk_size": self.ssd_chunk,
            "rms_norm_eps": self.ssm_norm_eps,
            "embedding_multiplier": self.embedding_multiplier,
            "residual_multiplier": self.residual_multiplier,
            "attention_multiplier": self.attention_multiplier,
            "logits_scaling": self.logits_scaling,
            "position_embedding_type": "nope" if self.pos_emb == "none" else self.pos_emb,
            "tie_word_embeddings": self.tie_embeddings,
            "model_type": "granitemoehybrid",
            "hidden_act": "silu" if self.mlp_type == "swiglu" else self.mlp_type,
            "normalization_function": self.norm,
            "attention_bias": False,
            "mamba_proj_bias": False,
            "mamba_conv_bias": True,
        }


_HYBRID_NEUTRAL = {f.name: f.default for f in dataclasses.fields(HybridMoEConfig)
                   if f.name not in ArchConfig.__dataclass_fields__}


def hybrid_setting(cfg: ArchConfig, name: str):
    """``HybridMoEConfig``'s setting ``name`` of any config: its own, or the field's
    neutral default where the config has no such field."""
    return getattr(cfg, name, _HYBRID_NEUTRAL[name])


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """long_500k needs sub-quadratic sequence handling => SSM/hybrid only."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins) for the dry-run.
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeSpec, device="meta") -> dict:
    """Every model input of the given step kind, as tensors on ``device`` with the
    reference's keys and shapes and the dtypes the port's entry points take: int64
    token ids, frames in the working dtype.

    train  -> {tokens, targets[, frames | src_tokens]}
    prefill-> {tokens[, frames | src_tokens]}
    decode -> {tokens (B, 1), pos[, enc_out]}; ``pos`` is the int ``seq_len - 1``,
              the step over a full cache (what the reference's masked attention over
              the whole cache counts), and the cache comes from the model.
    """
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def ids(*dims):
        return torch.empty(dims, dtype=torch.int64, device=device)

    def acts(*dims):
        return torch.empty(dims, dtype=dt, device=device)

    specs: dict = {}
    if shape.kind == "decode":
        if cfg.encdec:  # the encoder memory; the port's decode reads it from the cache
            specs["enc_out"] = acts(B, cfg.enc_memory_len, cfg.d_model)
        specs["tokens"] = ids(B, 1)
        specs["pos"] = S - 1
        return specs
    n_tok = S
    if cfg.encdec:
        n_tok = max(S // cfg.dec_len_fraction, 16)
        if cfg.frontend == "audio":
            specs["frames"] = acts(B, S, cfg.d_model)
        else:
            specs["src_tokens"] = ids(B, S)
    specs["tokens"] = ids(B, n_tok)
    if shape.kind == "train":
        specs["targets"] = ids(B, n_tok)
    return specs


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE), D = processed tokens.

    For decode shapes D = global_batch tokens (one step). Train counts fwd+bwd (6x);
    prefill/decode count forward only (2x). Attention FLOPs are *excluded* by this
    convention (it is the 'useful model FLOPs' yardstick).
    """
    counts = cfg.param_counts()
    n = counts["active"]
    if shape.kind == "train":
        toks = shape.tokens
        if cfg.encdec:
            toks = shape.global_batch * (
                shape.seq_len + max(shape.seq_len // cfg.dec_len_fraction, 16)
            )
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.tokens
        if cfg.encdec:
            toks = shape.global_batch * (
                shape.seq_len + max(shape.seq_len // cfg.dec_len_fraction, 16)
            )
        return 2.0 * n * toks
    # decode: one token per sequence; keep the simple 2·N·B convention.
    return 2.0 * n * shape.global_batch
