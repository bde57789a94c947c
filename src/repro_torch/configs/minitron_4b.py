"""minitron-4b — width-pruned nemotron. [arXiv:2407.14679; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_type="relu2",
    norm="layernorm",
    pos_emb="rope",
)

SMOKE = CONFIG.replace(
    name="minitron-4b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
)
