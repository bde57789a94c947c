"""olmoe-1b-7b — MoE 64 experts top-8, d_ff/expert=1024, MHA. [arXiv:2409.02060; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=50304,
    mlp_type="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    qk_norm=True,
    moe=True,
    n_experts=64,
    n_experts_per_tok=8,
    moe_d_ff=1024,
)

SMOKE = CONFIG.replace(
    name="olmoe-1b-7b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    vocab_size=512,
    n_experts=8,
    n_experts_per_tok=2,
    moe_d_ff=64,
)
