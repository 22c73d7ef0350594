"""mamba2-370m [ssm] -- Mamba-2 SSD (arXiv:2405.21060). Attention-free.

Assigned: 48L d_model=1024 (attn-free) d_ff=0 vocab=50280, ssm_state=128.
Sub-quadratic (O(1) recurrent state) -> runs long_500k natively.
STC applies unchanged (gradient-space; DESIGN.md §Arch-applicability).
"""

from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    block_pattern=("ssd",),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tie_embeddings=True,
)

LONG_CONFIG = CONFIG  # natively sub-quadratic

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    arch_type="ssm",
    n_layers=2,
    d_model=128,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=512,
    block_pattern=("ssd",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, n_groups=1,
                  chunk=8),
    tie_embeddings=True,
    remat=False,
)
