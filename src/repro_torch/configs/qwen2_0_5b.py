"""qwen2-0.5b [dense] -- Qwen2-0.5B (arXiv:2407.10671). GQA with QKV bias.

Assigned: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    block_pattern=("attn",),
    attn_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

LONG_CONFIG = dataclasses.replace(CONFIG, sliding_window=8192)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    block_pattern=("attn",),
    attn_bias=True,
    tie_embeddings=True,
    remat=False,
)
