"""internvl2-2b [vlm] -- InternVL2-2B (arXiv:2404.16821).

Assigned: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The InternViT vision encoder + projector are a STUB per the carve-out:
``input_specs()`` provides (batch, 256, d_model) patch embeddings which a
learned projector maps into the InternLM2-style decoder's prefix.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    block_pattern=("attn",),
    n_prefix_tokens=256,
)

LONG_CONFIG = dataclasses.replace(CONFIG, sliding_window=8192)

SMOKE = ModelConfig(
    name="internvl2-2b-smoke",
    arch_type="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    block_pattern=("attn",),
    n_prefix_tokens=8,
    remat=False,
)
