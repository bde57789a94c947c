"""granite-20b — code model, MQA (kv=1). [arXiv:2405.04324; hf]

Note: the assignment line says "llama-arch"; with a 3-matmul SwiGLU MLP the listed
dims give 28B params, but granite-20b-code is a 20B gpt-bigcode-style model with a
2-matmul GELU MLP. We keep RoPE+RMSNorm (llama-style) and use the GELU MLP so the
parameter count matches the published 20B (see DESIGN.md §Arch-applicability).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    norm="rmsnorm",
    pos_emb="rope",
)

SMOKE = CONFIG.replace(
    name="granite-20b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
)
