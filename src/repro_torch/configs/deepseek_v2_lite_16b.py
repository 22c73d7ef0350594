"""deepseek-v2-lite-16b [moe] -- DeepSeek-V2-Lite (arXiv:2405.04434).

Assigned: 27L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400,
MoE 64 experts top-6, MLA kv_lora=512, 2 shared experts.
(The release-card 160-routed-expert variant is noted in DESIGN.md; the
assignment's 64e figure is canonical here.)  Attention is MLA, so the GQA
kv=16 figure is subsumed by the latent cache.
"""

import dataclasses

from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,                      # dense first layer FFN (V2-Lite)
    vocab_size=102400,
    head_dim=128,
    block_pattern=("mla",),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                  first_dense=1),
    rope_theta=10000.0,
)

# sliding-window variant for long_500k (sub-quadratic requirement)
LONG_CONFIG = dataclasses.replace(CONFIG, sliding_window=8192)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke",
    arch_type="moe",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    head_dim=32,
    block_pattern=("mla",),
    mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
                  v_head_dim=32),
    moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=64,
                  first_dense=1),
    remat=False,
)
