"""whisper-medium [audio] -- Whisper (arXiv:2212.04356), enc-dec backbone.

Assigned: 24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
The mel-spectrogram + conv frontend is a STUB per the carve-out:
``input_specs()`` provides (batch, 1500, d_model) frame embeddings; the full
24-layer bidirectional encoder + 24-layer causal decoder with cross-attention
are implemented.  RoPE replaces Whisper's learned positions (TPU adaptation,
noted in DESIGN.md).
"""

import dataclasses

from ..models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    arch_type="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    block_pattern=("attn",),
    mlp_act="gelu",
    encoder=EncoderConfig(n_layers=24, n_frames=1500),
)

LONG_CONFIG = dataclasses.replace(CONFIG, sliding_window=8192)

SMOKE = ModelConfig(
    name="whisper-medium-smoke",
    arch_type="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    block_pattern=("attn",),
    mlp_act="gelu",
    encoder=EncoderConfig(n_layers=2, n_frames=30),
    remat=False,
)
