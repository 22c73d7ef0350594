"""The model zoo, functional over dicts of tensors: the paper's small
federated benchmarks and the TransformerLM of the LM configs (attention,
MLA and MoE blocks), with its KV-cache decode (``init_cache``,
``decode_step``).

Counterpart of ``repro/models``.  The encoder (``encode_frames``) and the
SSD and RG-LRU blocks are still to port (ROADMAP Queue 1).
"""

from .config import (EncoderConfig, MLAConfig, ModelConfig, MoEConfig,
                     RGLRUConfig, SSMConfig)
from .paper_models import MODEL_ZOO, params_from_jax
from .transformer import decode_step, forward, init_cache, init_model, lm_loss
from . import paper_models

__all__ = [
    "EncoderConfig", "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig",
    "SSMConfig", "decode_step", "forward", "init_cache", "init_model",
    "lm_loss", "paper_models",
    "MODEL_ZOO", "params_from_jax",
]
