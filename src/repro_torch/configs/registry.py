"""Architecture registry: ``--arch <id>`` resolution and the input specs of
each (architecture, input shape).

Counterpart of ``repro/configs/registry.py``.  The arch modules are data,
copied from the reference.  ``input_specs`` gives each model input as a
:class:`TensorSpec` (shape and torch dtype) where the reference gives a
``jax.ShapeDtypeStruct``.  ``long_500k`` resolves each arch's
``LONG_CONFIG`` (the sliding-window variant of a full-attention arch).
``stand_in_inputs`` builds the stub front ends' frames and prefix that the
specs name, for the train CLI, the examples and the card's smoke run.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np
import torch

from ..models.config import ModelConfig
from .shapes import INPUT_SHAPES, InputShape

__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "input_specs",
           "stand_in_inputs", "INPUT_SHAPES", "TensorSpec"]

_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "smollm-135m": "smollm_135m",
    "qwen2-0.5b": "qwen2_0_5b",
    "whisper-medium": "whisper_medium",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "mamba2-370m": "mamba2_370m",
    "phi3-medium-14b": "phi3_medium_14b",
    "internvl2-2b": "internvl2_2b",
}

ARCH_IDS = tuple(_MODULES)


class TensorSpec(NamedTuple):
    """A model input's shape and dtype, with no allocation."""

    shape: tuple
    dtype: torch.dtype


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; options: {ARCH_IDS}")
    return importlib.import_module(f"{__package__}.{_MODULES[arch]}")


def get_config(arch: str, shape: str | InputShape | None = None) -> ModelConfig:
    """Full config; resolves the LONG_CONFIG variant for long_500k."""
    mod = _module(arch)
    if shape is not None:
        name = shape if isinstance(shape, str) else shape.name
        if name == "long_500k":
            return mod.LONG_CONFIG
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def input_specs(cfg: ModelConfig, shape: InputShape | str) -> dict:
    """Shape-and-dtype stand-ins for every model input.

    train:   tokens + labels (B, S) int32  [+ frames / prefix embeddings]
    prefill: tokens (B, S)                 [+ frames / prefix embeddings]
    decode:  token (B, 1)                  [+ encoder memory for enc-dec]
    """
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    i32, emb = torch.int32, torch.bfloat16

    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = TensorSpec((b, s), i32)
        specs["labels"] = TensorSpec((b, s), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = TensorSpec((b, s), i32)
    else:  # decode: one new token against a seq_len cache
        specs["token"] = TensorSpec((b, 1), i32)

    if cfg.encoder is not None:
        name = "memory" if shape.kind == "decode" else "frames"
        specs[name] = TensorSpec((b, cfg.encoder.n_frames, cfg.d_model), emb)
    if cfg.n_prefix_tokens and shape.kind != "decode":
        specs["prefix"] = TensorSpec((b, cfg.n_prefix_tokens, cfg.d_model),
                                     emb)
    return specs


def stand_in_inputs(cfg: ModelConfig, batch: int, kind: str = "train",
                    scale: float = 0.0, seed: int = 0) -> dict:
    """The stub front ends' inputs that :func:`input_specs` names, built
    for ``batch`` rows as fp32 CPU tensors: an encoder-decoder's
    ``frames`` (batch, F, d) and a VLM's ``prefix`` (batch, P, d) at a
    ``train`` or ``prefill`` kind; nothing for other archs or at
    ``decode`` (whose ``memory`` is :func:`repro_torch.models.encode_frames`'
    output).  Zeros, or ``scale`` times standard normals drawn in that
    order from ``numpy.random.default_rng(seed)``."""
    specs = input_specs(cfg, InputShape("stand_in", 1, batch, kind))
    rng = np.random.default_rng(seed)
    out = {}
    for name in ("frames", "prefix"):
        if name in specs:
            shape = specs[name].shape
            out[name] = (torch.zeros(shape) if not scale else
                         torch.from_numpy((scale * rng.standard_normal(
                             shape)).astype(np.float32)))
    return out
