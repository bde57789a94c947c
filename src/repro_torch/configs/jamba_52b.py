"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2 every 2nd
layer. Mamba sublayers use our SSD block with d_state=16 (Jamba v0.1 is Mamba-1;
SSD is the TPU-efficient equivalent — noted in DESIGN.md). [arXiv:2403.19887; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    mlp_type="swiglu",
    norm="rmsnorm",
    pos_emb="none",  # jamba uses no positional encoding on attention
    moe=True,
    n_experts=16,
    n_experts_per_tok=2,
    moe_period=2,
    moe_offset=1,
    moe_d_ff=14336,
    ssm=True,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    conv_width=4,
    attn_period=8,
    attn_offset=4,
)

SMOKE = CONFIG.replace(
    name="jamba-v0.1-52b-smoke",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    n_experts=4,
    n_experts_per_tok=2,
    moe_d_ff=128,
    ssm_state=16,
    ssm_headdim=16,
    ssd_chunk=16,
    attn_period=8,
    attn_offset=4,
)
