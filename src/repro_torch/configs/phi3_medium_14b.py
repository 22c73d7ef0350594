"""phi3-medium-14b [dense] -- Phi-3 Medium (arXiv:2404.14219). RoPE SwiGLU GQA.

Assigned: 40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    arch_type="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    block_pattern=("attn",),
)

LONG_CONFIG = dataclasses.replace(CONFIG, sliding_window=8192)

SMOKE = ModelConfig(
    name="phi3-medium-14b-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=160,
    n_heads=4,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    block_pattern=("attn",),
    remat=False,
)
