"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py``.  Real-Gated Linear Recurrent
Unit:

    r_t = σ(W_a x_t)                       (recurrence gate)
    i_t = σ(W_x x_t)                       (input gate)
    a_t = exp(-c · softplus(Λ) · r_t)      (diagonal recurrence, 0<a<1)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The temporal-mixing block is conv1d(4) → RG-LRU → out-proj.  The gates
run in fp32 whatever the compute dtype, as the reference's do.  A full
sequence scans the (a, b) pairs with a Hillis–Steele scan: ⌈log₂ S⌉ rounds
of the combine (a₁, b₁)∘(a₂, b₂) = (a₁·a₂, a₂·b₁ + b₂) with the pairs
``d`` positions back (identity before the start), in plain tensor ops.
The reference's ``jax.lax.associative_scan`` combines in another order,
so the two agree to fp32 rounding, not bitwise (ROADMAP Queue 3, R13).

Decode is the O(1) recurrence.  ``rglru_decode`` updates the cache's ``h``
and ``conv`` IN PLACE (R12): the cache passed in is consumed, and the one
returned holds the same tensors and ``idx + 1`` on the device.  ``lam``
comes from numpy in the reference's formula (an ulp from ``jnp``'s).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import RGLRUConfig
from .layers import causal_conv, dense_init

__all__ = ["RGLRUCache", "rglru_init", "rglru_apply", "rglru_decode",
           "init_rglru_cache"]


class RGLRUCache(NamedTuple):
    h: torch.Tensor       # (B, w) fp32 recurrent state
    conv: torch.Tensor    # (B, k-1, w) conv history
    idx: torch.Tensor     # 0-d int32 on the cache's device: tokens seen


def _width(d_model: int, cfg: RGLRUConfig) -> int:
    return cfg.block_width or d_model


def rglru_init(gen: torch.Generator, d_model: int, cfg: RGLRUConfig):
    w = _width(d_model, cfg)
    # Λ so that a^c ∈ (0.9, 0.999) at r = 1 (the paper's init range)
    a0 = np.linspace(0.9, 0.999, w).astype(np.float32)
    lam = np.log(np.expm1(-np.log(a0) / np.float32(cfg.c)))
    return {
        "w_in": dense_init(gen, d_model, w),
        "conv_w": torch.randn((cfg.d_conv, w), generator=gen,
                              dtype=torch.float32) * 0.1,
        "w_a": dense_init(gen, w, w),
        "w_x": dense_init(gen, w, w),
        "lam": torch.as_tensor(lam.astype(np.float32)),
        "w_out": dense_init(gen, w, d_model),
    }


def _gates(params, x, cfg: RGLRUConfig):
    """x: (..., w) -> (a, b) of the recurrence h' = a·h + b, fp32."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(xf @ params["w_a"])
    i = torch.sigmoid(xf @ params["w_x"])
    log_a = -cfg.c * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    # multiplier sqrt(1 - a²) computed stably from log_a
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * (i * xf)


def _scan(a, b):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t (h_{-1} = 0) over dim 1:
    Hillis–Steele, ⌈log₂ S⌉ rounds."""
    s = a.shape[1]
    d = 1
    while d < s:
        a_prev = F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        b_prev = F.pad(b[:, :-d], (0, 0, d, 0))
        a, b = a_prev * a, a * b_prev + b
        d *= 2
    return b


def rglru_apply(params, x: torch.Tensor, cfg: RGLRUConfig, d_model: int):
    """Temporal-mixing block over a full sequence. x: (B,S,d) -> (B,S,d)."""
    u = x @ params["w_in"].to(x.dtype)                # (B,S,w)
    u = causal_conv(u, params["conv_w"])[0]
    a, b = _gates(params, u, cfg)                     # (B,S,w) fp32
    h = _scan(a, b)
    return h.to(x.dtype) @ params["w_out"].to(x.dtype)


def init_rglru_cache(batch: int, d_model: int, cfg: RGLRUConfig,
                     dtype=torch.float32, device=None) -> RGLRUCache:
    w = _width(d_model, cfg)
    return RGLRUCache(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.d_conv - 1, w), dtype=dtype,
                         device=device),
        idx=torch.zeros((), dtype=torch.int32, device=device))


def rglru_decode(params, x: torch.Tensor, cache: RGLRUCache,
                 cfg: RGLRUConfig, d_model: int):
    """One-token decode. x: (B,1,d) -> (out (B,1,d), cache).  ``h`` and the
    conv tail are updated IN PLACE; the cache passed in is consumed and the
    one returned holds the same tensors and ``idx + 1``."""
    u = x @ params["w_in"].to(x.dtype)                # (B,1,w)
    conv_out, tail = causal_conv(u, params["conv_w"], cache.conv)
    cache.conv.copy_(tail)
    a, b = _gates(params, conv_out[:, 0], cfg)        # (B, w)
    h = cache.h
    h.mul_(a).add_(b)
    out = h.to(x.dtype)[:, None, :] @ params["w_out"].to(x.dtype)
    return out, cache._replace(idx=cache.idx + 1)
