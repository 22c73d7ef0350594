"""Basic layer initializers, functional: parameters are dicts of tensors.

Counterpart of ``repro/models/layers.py`` (``dense_init`` only; the LLM
layers are still to port).  Initial values come from an explicit
``torch.Generator``: they do not reproduce ``jax.random``, so parity tests
hand the reference's initial values over with
:func:`repro_torch.models.paper_models.params_from_jax`.
"""

from __future__ import annotations

import math

import torch

__all__ = ["dense_init"]


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    """A ``(d_in, d_out)`` weight, normal with std ``scale`` (default
    ``1 / sqrt(d_in)``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen,
                       dtype=torch.float32) * scale
