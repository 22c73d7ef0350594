"""Basic layers: norms, MLPs, embeddings, RoPE, the causal depthwise conv.  Functional: parameters are
dicts of tensors, initialized in fp32; the compute dtype is the caller's.

Counterpart of ``repro/models/layers.py``, with the reference's casts:
``rms_norm`` works in fp32 and casts back, ``apply_rope`` promotes to fp32
and casts back.  Initial values come from an explicit ``torch.Generator``:
they do not reproduce ``jax.random``, so parity tests hand the reference's
initial values over with
:func:`repro_torch.models.paper_models.params_from_jax`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = [
    "dense_init", "rms_norm", "rms_norm_init", "mlp_init", "mlp_apply",
    "embed_init", "rope_freqs", "apply_rope", "causal_conv",
]


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    """A ``(d_in, d_out)`` weight, normal with std ``scale`` (default
    ``1 / sqrt(d_in)``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen,
                       dtype=torch.float32) * scale


def rms_norm_init(d: int):
    return {"g": torch.ones((d,), dtype=torch.float32)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params["g"]).to(dt)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             act: str = "swiglu"):
    if act == "swiglu":
        return {
            "w_gate": dense_init(gen, d_model, d_ff),
            "w_up": dense_init(gen, d_model, d_ff),
            "w_down": dense_init(gen, d_ff, d_model),
        }
    return {
        "w_up": dense_init(gen, d_model, d_ff),
        "w_down": dense_init(gen, d_ff, d_model),
    }


def mlp_apply(params, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


def embed_init(gen: torch.Generator, vocab: int, d_model: int):
    return torch.randn((vocab, d_model), generator=gen,
                       dtype=torch.float32) * 0.02


def rope_freqs(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions: (..., S) integers -> (cos, sin) of shape (..., S, dim//2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, dim) with rotary applied over the last dim (paired)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                tail: torch.Tensor | None = None) -> tuple:
    """Depthwise causal conv over (B, S, C) with a (k, C) kernel:
    ``out[:, t] = sum_i w[i] · x[:, t + i - (k - 1)]``, the k - 1 steps
    before the start taken from ``tail`` (B, k - 1, C), or zeros.  The taps
    are added one by one in ``x``'s dtype, so a full sequence and a decode
    step round alike.  Returns ``(out (B, S, C), new tail (B, k - 1, C))``:
    the new tail is a view of the last k - 1 inputs."""
    k, s = conv_w.shape[0], x.shape[1]
    xp = (F.pad(x, (0, 0, k - 1, 0)) if tail is None else
          torch.cat([tail.to(x.dtype), x], dim=1))      # (B, S + k - 1, C)
    out = torch.zeros_like(xp[:, :s])
    for i in range(k):
        out = out + conv_w[i].to(x.dtype) * xp[:, i:i + s]
    return out, xp[:, s:]
