"""granite-4.0-h-small — IBM Granite 4.0-H Small (32B-A9B), ``granitemoehybrid``.

40 layers, Mamba-2 mixers except attention at layers 5, 15, 25 and 35 (period 10,
offset 5); after every mixer an MoE of 72 routed SwiGLU experts of width 768, top 10,
plus one shared SwiGLU expert of width 1,536. Mamba-2: 128 heads of 64, d_state 128,
one group, conv width 4 with bias, expand 2, chunk 256. Attention: GQA 32 / 8 heads
of 128, no positional encoding (NoPE). Vocabulary 100,352, tied embeddings, RMSNorm
eps 1e-5. µP-style multipliers: embeddings x 12, each residual branch x 0.22, the
softmax scale 0.0078125 (in place of 128 ** -0.5), logits / 16.
[hf:ibm-granite/granite-4.0-h-small config.json]

    h = embed(ids) * 12
    per layer: h += 0.22 * mixer(norm(h)); u = norm(h); h += 0.22 * (moe(u) + shared(u))
    logits = embed^T norm(h) / 16

The router takes the top 10 of its logits and a softmax over those 10, which equals
the port's softmax over all 72 renormalised over the top 10. Routing drops no slot.
"""

from repro_torch.configs.base import HybridMoEConfig

CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,
    vocab_size=100352,
    mlp_type="swiglu",
    norm="rmsnorm",
    pos_emb="none",
    tie_embeddings=True,
    moe=True,
    n_experts=72,
    n_experts_per_tok=10,
    moe_period=1,
    moe_offset=0,
    moe_d_ff=768,
    ssm=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    conv_width=4,
    ssd_chunk=256,
    attn_period=10,
    attn_offset=5,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    shared_d_ff=1536,
    moe_dropless=True,
    ssm_norm_eps=1e-5,
)

# One whole period of 10 layers (9 Mamba-2 + 1 attention, each with its MoE) at tiny
# widths: 8 experts top 2 beside the shared one.
SMOKE = CONFIG.replace(
    name="granite-4.0-h-small-smoke",
    n_layers=10,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    vocab_size=512,
    n_experts=8,
    n_experts_per_tok=2,
    moe_d_ff=32,
    shared_d_ff=48,
    ssm_state=16,
    ssm_headdim=16,
    ssd_chunk=16,
)
