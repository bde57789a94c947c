"""Operations and peaks of a language model's prefill: the arithmetic that turns the
``prefill`` loop's device times into shares, worked out from the configuration (the
keys of the model's published ``config.json``) and the traffic's shapes alone.
Peaks: NVIDIA's data sheet for the H100 SXM (dense), which assume its 700 W limit.
"""

from __future__ import annotations

from portbench.counts import PEAK_HBM_BYTES

PEAK_BF16_FLOPS = 989e12  # bf16 tensor cores, dense
BF16_BYTES = 2


def _layers(c: dict) -> list[str]:
    return list(c["layer_types"][: c["num_hidden_layers"]])


def attention_flops(c: dict, batch: int, seq: int) -> float:
    """One causal attention layer (K2): Q·Kᵀ and P·V over the S(S+1)/2 pairs a head."""
    hd = c["hidden_size"] // c["num_attention_heads"]
    return 4.0 * batch * c["num_attention_heads"] * hd * seq * (seq + 1) / 2


def attention_bytes(c: dict, batch: int, seq: int) -> float:
    """q and o of Hq heads, k and v of Hkv, each read or written once in bf16."""
    hd = c["hidden_size"] // c["num_attention_heads"]
    heads = 2 * c["num_attention_heads"] + 2 * c["num_key_value_heads"]
    return float(BF16_BYTES * batch * seq * heads * hd)


def attention_seconds_at_roofline(c: dict, batch: int, seq: int) -> float:
    return max(attention_flops(c, batch, seq) / PEAK_BF16_FLOPS,
               attention_bytes(c, batch, seq) / PEAK_HBM_BYTES)


def ssd_flops(c: dict, batch: int, seq: int) -> float:
    """One Mamba-2 layer's state-space part by the chunked algorithm (chunk Q): C·Bᵀ a
    group and its product with x a head over each chunk's causal pairs, and the chunk
    states and their contribution to the outputs (2·N·P a head a token each)."""
    Q, N, P = c["mamba_chunk_size"], c["mamba_d_state"], c["mamba_d_head"]
    H, G = c["mamba_n_heads"], c["mamba_n_groups"]
    chunks = batch * -(-seq // Q)
    return chunks * ((G * N + H * P) * Q * (Q + 1) + 4.0 * H * N * P * Q)


def matmul_flops_per_token(c: dict, kind: str) -> float:
    """Two a weight a token in every product that a token passes through: the mixer's
    projections, the router, its k routed experts and the shared expert."""
    d, hd = c["hidden_size"], c["hidden_size"] // c["num_attention_heads"]
    if kind == "mamba":
        H, N, G = c["mamba_n_heads"], c["mamba_d_state"], c["mamba_n_groups"]
        din = c["mamba_expand"] * d
        mixer = d * (2 * din + 2 * G * N + H) + din * d
    else:
        mixer = d * (c["num_attention_heads"] + 2 * c["num_key_value_heads"]) * hd
        mixer += c["num_attention_heads"] * hd * d
    moe = d * c["num_local_experts"] + 3 * d * (
        c["num_experts_per_tok"] * c["intermediate_size"] + c["shared_intermediate_size"])
    return 2.0 * (mixer + moe)


def prefill_flops(c: dict, batch: int, seq: int) -> float:
    """A prefill of ``batch`` prompts of ``seq`` tokens: every layer's products, the
    attention layers' attention, the Mamba-2 layers' state-space part, and the head at
    each prompt's last token."""
    total = 2.0 * c["hidden_size"] * c["vocab_size"] * batch
    for kind in _layers(c):
        total += matmul_flops_per_token(c, kind) * batch * seq
        total += attention_flops(c, batch, seq) if kind == "attention" else ssd_flops(c, batch, seq)
    return total


def attention_layers(c: dict) -> int:
    return sum(kind == "attention" for kind in _layers(c))
