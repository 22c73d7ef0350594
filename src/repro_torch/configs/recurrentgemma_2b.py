"""recurrentgemma-2b [hybrid] -- Griffin/RecurrentGemma (arXiv:2402.19427).

Assigned: 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.
Pattern: RG-LRU + local attention, 1:2 (two recurrent blocks per local-attn
block), local window 2048.  Sub-quadratic by construction -> runs long_500k
natively (recurrent state + ring-buffer window cache).
"""

from ..models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local"),
    sliding_window=2048,
    rglru=RGLRUConfig(d_conv=4, c=8.0),
    mlp_act="gelu",
    tie_embeddings=True,
)

LONG_CONFIG = CONFIG  # natively sub-quadratic

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke",
    arch_type="hybrid",
    n_layers=3,
    d_model=128,
    n_heads=4,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    block_pattern=("rglru", "rglru", "local"),
    sliding_window=16,
    rglru=RGLRUConfig(d_conv=4, c=8.0),
    mlp_act="gelu",
    tie_embeddings=True,
    remat=False,
)
