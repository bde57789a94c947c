"""mamba2-130m — attention-free SSD (state-space duality). [arXiv:2405.21060]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    pos_emb="none",
    tie_embeddings=True,
    ssm=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    conv_width=4,
)

SMOKE = CONFIG.replace(
    name="mamba2-130m-smoke",
    n_layers=2,
    d_model=64,
    vocab_size=512,
    ssm_state=16,
    ssm_headdim=16,
    ssd_chunk=16,
)
