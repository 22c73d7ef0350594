"""Attention: GQA (+ optional QKV bias), causal / sliding-window / cross,
with the flash-style attention of :mod:`.flash` or the chunked
online-softmax reference.

Counterpart of ``repro/models/attention.py`` for full sequences (training
and prefill).  The single-token decode with a KV cache (``init_kv_cache``,
``attn_decode``) comes with the serve path (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash import _fwd_scan, _to_bshd, flash_attention
from .layers import apply_rope, dense_init, rope_freqs

__all__ = ["attn_init", "attn_apply", "chunked_attention"]

# "flash": the O(S·d)-residual attention with its own backward (default).
# "chunked": the plain online-softmax scan (reference; autograd keeps every
# probability block for the backward).
ATTN_IMPL = "flash"


def _attention(q, k, v, *, causal, window=0, chunk=1024, impl=None):
    impl = impl or ATTN_IMPL
    if impl == "flash":
        return flash_attention(q, k, v, causal, window, chunk)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk=chunk)


def attn_init(gen: torch.Generator, d_model: int, n_heads: int,
              n_kv_heads: int, head_dim: int, bias: bool = False):
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim),
        "wo": dense_init(gen, n_heads * head_dim, d_model),
    }
    if bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=torch.float32)
        p["bk"] = torch.zeros((n_kv_heads * head_dim,), dtype=torch.float32)
        p["bv"] = torch.zeros((n_kv_heads * head_dim,), dtype=torch.float32)
    return p


def chunked_attention(
    q: torch.Tensor,           # (B, Sq, H, hd)
    k: torch.Tensor,           # (B, Skv, KV, hd)
    v: torch.Tensor,           # (B, Skv, KV, hdv)
    *,
    causal: bool,
    window: int = 0,           # 0 = unbounded
    q_offset: int = 0,         # absolute position of q[0]
    chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention, scanning KV in chunks, differentiated by
    autograd through the scan. Returns (B, Sq, H, hdv)."""
    out, _ = _fwd_scan(q, k, v, causal, window, chunk, q_offset)
    return _to_bshd(out, q.dtype)


def _project_qkv(params, x, n_heads, n_kv_heads, head_dim):
    b, s, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (q.reshape(b, s, n_heads, head_dim),
            k.reshape(b, s, n_kv_heads, head_dim),
            v.reshape(b, s, n_kv_heads, head_dim))


def attn_apply(
    params, x: torch.Tensor, *, n_heads: int, n_kv_heads: int, head_dim: int,
    rope_theta: float = 10000.0, causal: bool = True, window: int = 0,
    memory: Optional[torch.Tensor] = None, chunk: int = 1024,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence attention. ``memory`` switches to cross-attention
    (k/v projected from memory, no causal mask, no RoPE on memory keys)."""
    b, s, _ = x.shape
    if memory is None:
        q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
        pos = positions if positions is not None else torch.arange(
            s, device=x.device)
        cos, sin = rope_freqs(pos, head_dim, rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = _attention(q, k, v, causal=causal, window=window, chunk=chunk)
    else:
        sm = memory.shape[1]
        q = (x @ params["wq"].to(x.dtype)).reshape(b, s, n_heads, head_dim)
        k = (memory @ params["wk"].to(x.dtype)).reshape(b, sm, n_kv_heads,
                                                        head_dim)
        v = (memory @ params["wv"].to(x.dtype)).reshape(b, sm, n_kv_heads,
                                                        head_dim)
        out = _attention(q, k, v, causal=False, window=0, chunk=chunk)
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"].to(x.dtype)
