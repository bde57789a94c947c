"""chatglm3-6b — GQA kv=2, partial ("2d") RoPE. [arXiv:2406.12793; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    mlp_type="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    rope_fraction=0.5,
)

SMOKE = CONFIG.replace(
    name="chatglm3-6b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=224,
    vocab_size=512,
)
