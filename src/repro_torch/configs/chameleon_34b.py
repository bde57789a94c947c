"""chameleon-34b — early-fusion VLM; image VQ tokens share the 65536 vocab, so the
backbone consumes plain token ids (VQ tokenizer stubbed). qk-norm. [arXiv:2405.09818]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    mlp_type="swiglu",
    norm="rmsnorm",
    pos_emb="rope",
    qk_norm=True,
    frontend="vision",
)

SMOKE = CONFIG.replace(
    name="chameleon-34b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=224,
    vocab_size=512,
)
