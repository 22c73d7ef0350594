"""The model zoo, functional over dicts of tensors: the paper's small
federated benchmarks and the TransformerLM of the LM configs (attention,
MLA, MoE, SSD and RG-LRU blocks, the encoder of an encoder-decoder and a
VLM's prefix), with its cached decode (``init_cache``, ``decode_step``).

Counterpart of ``repro/models``.
"""

from .config import (EncoderConfig, MLAConfig, ModelConfig, MoEConfig,
                     RGLRUConfig, SSMConfig)
from .paper_models import MODEL_ZOO, params_from_jax
from .transformer import (decode_step, encode_frames, forward, init_cache,
                          init_model, lm_loss)
from . import paper_models

__all__ = [
    "EncoderConfig", "MLAConfig", "ModelConfig", "MoEConfig", "RGLRUConfig",
    "SSMConfig", "decode_step", "encode_frames", "forward", "init_cache",
    "init_model", "lm_loss", "paper_models",
    "MODEL_ZOO", "params_from_jax",
]
