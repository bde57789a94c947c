"""granite-moe-3b-a800m — MoE 40 experts top-8, d_ff/expert=512.

[hf:ibm-granite/granite-3.0-*; spec field "MoE 40e top-8" followed — see DESIGN.md]
40 experts are padded to 48 for expert-parallel sharding over 16 model shards.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49155,
    mlp_type="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    moe=True,
    n_experts=40,
    n_experts_per_tok=8,
    moe_d_ff=512,
)

SMOKE = CONFIG.replace(
    name="granite-moe-3b-a800m-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    vocab_size=512,
    n_experts=8,
    n_experts_per_tok=2,
    moe_d_ff=64,
)
