"""smollm-135m [dense] -- [hf:HuggingFaceTB/SmolLM-135M], llama-arch small.

Assigned: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    block_pattern=("attn",),
    tie_embeddings=True,
)

LONG_CONFIG = dataclasses.replace(CONFIG, sliding_window=8192)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    arch_type="dense",
    n_layers=2,
    d_model=96,
    n_heads=3,
    n_kv_heads=1,
    d_ff=256,
    vocab_size=512,
    block_pattern=("attn",),
    tie_embeddings=True,
    remat=False,
)
