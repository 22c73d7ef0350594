"""moonshot-v1-16b-a3b -- Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B].

Assigned: 48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840,
MoE 64 experts top-6.  The assignment tags it [dense] but specifies a MoE
layout ("MoE?"); Moonlight *is* a DeepSeek-V3-style MoE, so it is built as a
GQA-attention MoE with 2 shared experts (DESIGN.md §Arch-applicability).
"""

import dataclasses

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    arch_type="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=11264,                      # dense first layer
    vocab_size=163840,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  first_dense=1),
    rope_theta=50000.0,
)

LONG_CONFIG = dataclasses.replace(CONFIG, sliding_window=8192)

SMOKE = ModelConfig(
    name="moonshot-v1-16b-a3b-smoke",
    arch_type="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    block_pattern=("attn",),
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=64,
                  first_dense=1),
    remat=False,
)
