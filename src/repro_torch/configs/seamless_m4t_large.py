"""seamless-m4t-large-v2 — encoder-decoder backbone, audio frontend STUB.

Backbone only per the brief: 24 encoder + 24 decoder layers, d=1024, 16H MHA,
d_ff=8192, vocab 256206. ``input_specs`` supplies precomputed frame embeddings
(B, S, d_model) for the encoder. [arXiv:2308.11596; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,  # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp_type="gelu",
    norm="layernorm",
    pos_emb="sinusoidal",
    encdec=True,
    n_enc_layers=24,
    frontend="audio",
)

SMOKE = CONFIG.replace(
    name="seamless-m4t-large-v2-smoke",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    enc_memory_len=64,
)
