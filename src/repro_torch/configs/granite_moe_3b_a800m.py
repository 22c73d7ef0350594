"""granite-moe-3b-a800m [moe] -- IBM Granite MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base family].

Assigned: 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155,
MoE 40 experts top-8.
"""

import dataclasses

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=40, top_k=8, n_shared=0, d_expert=512,
                  first_dense=0),
    tie_embeddings=True,
)

LONG_CONFIG = dataclasses.replace(CONFIG, sliding_window=8192)

SMOKE = ModelConfig(
    name="granite-moe-3b-a800m-smoke",
    arch_type="moe",
    n_layers=2,
    d_model=96,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=512,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert=64,
                  first_dense=0),
    tie_embeddings=True,
    remat=False,
)
