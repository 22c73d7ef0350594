"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Counterpart of ``repro/models/mla.py``.  Keys and values are up-projected
from a low-rank latent ``c_kv = x @ W_dkv`` (rank ``kv_lora_rank``); a
small decoupled RoPE key (``qk_rope_head_dim``, shared across heads)
carries position.  The KV cache stores only ``(c_kv, k_rope)``:
``kv_lora + rope_dim`` values a position instead of ``2·H·hd``.

The full-sequence path (training, prefill) goes through the port's
flash attention, which takes a qk width other than the v width.  The
decode is the absorbed form: W_uk is folded into the query, the scores
are taken against the latent ``c_kv`` plus the shared ``k_rope`` in fp32,
and W_uv is applied after the weighted sum of latents.

As the dense decode does (R12), ``mla_decode`` writes the new position
into the cache IN PLACE (:func:`.attention.write_slot`, at the cache's
device ``idx``, clamped at the last slot; no host sync): a cache passed in
is consumed, and the one returned holds the same tensors and ``idx + 1``.
Like the reference's, the latent cache is never a ring: ``init_cache``
gives an MLA layer ``s_cache`` slots whatever ``sliding_window`` is.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .attention import NEG_INF, _attention, write_slot
from .config import MLAConfig
from .layers import apply_rope, dense_init, rope_freqs

__all__ = ["MLACache", "mla_init", "mla_apply", "mla_decode",
           "init_mla_cache"]


class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S, kv_lora)
    k_rope: torch.Tensor  # (B, S, rope_dim)
    idx: torch.Tensor     # 0-d int32 on the cache's device: positions written


def mla_init(gen: torch.Generator, d_model: int, n_heads: int,
             cfg: MLAConfig):
    qk_dim = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "wq": dense_init(gen, d_model, n_heads * qk_dim),
        "w_dkv": dense_init(gen, d_model, cfg.kv_lora_rank),
        "w_uk": dense_init(gen, cfg.kv_lora_rank,
                           n_heads * cfg.qk_nope_head_dim),
        "w_uv": dense_init(gen, cfg.kv_lora_rank, n_heads * cfg.v_head_dim),
        "w_kr": dense_init(gen, d_model, cfg.qk_rope_head_dim),
        "wo": dense_init(gen, n_heads * cfg.v_head_dim, d_model),
    }


def _mla_qkv(params, x, n_heads: int, cfg: MLAConfig, positions, rope_theta):
    """Returns q (B,S,H,qk_dim), k (B,S,H,qk_dim), v (B,S,H,v_dim), c_kv."""
    b, s, _ = x.shape
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, s, n_heads, nope + rope)
    q_nope, q_rope = torch.split(q, [nope, rope], dim=-1)

    c_kv = x @ params["w_dkv"].to(x.dtype)                       # (B,S,r)
    k_nope = (c_kv @ params["w_uk"].to(x.dtype)).reshape(b, s, n_heads, nope)
    v = (c_kv @ params["w_uv"].to(x.dtype)).reshape(b, s, n_heads,
                                                    cfg.v_head_dim)
    k_rope = (x @ params["w_kr"].to(x.dtype))[:, :, None, :]   # shared head

    cos, sin = rope_freqs(positions, rope, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin).expand(b, s, n_heads, rope)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    return q, k, v, c_kv


def mla_apply(params, x, *, n_heads: int, cfg: MLAConfig,
              rope_theta: float = 10000.0, chunk: int = 1024,
              window: int = 0) -> torch.Tensor:
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    q, k, v, _ = _mla_qkv(params, x, n_heads, cfg, positions, rope_theta)
    out = _attention(q, k, v, causal=True, window=window, chunk=chunk)
    return (out.reshape(b, s, n_heads * cfg.v_head_dim) @
            params["wo"].to(x.dtype))


def init_mla_cache(batch: int, s_cache: int, cfg: MLAConfig,
                   dtype=torch.bfloat16, device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, s_cache, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, s_cache, cfg.qk_rope_head_dim),
                           dtype=dtype, device=device),
        idx=torch.zeros((), dtype=torch.int32, device=device))


def mla_decode(params, x, cache: MLACache, *, n_heads: int, cfg: MLAConfig,
               rope_theta: float = 10000.0):
    """One-token decode from the latent cache. x: (B,1,d) -> (out (B,1,d),
    cache)."""
    b = x.shape[0]
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (x @ params["wq"].to(x.dtype)).reshape(b, 1, n_heads, nope + rope)
    q_nope, q_rope = torch.split(q, [nope, rope], dim=-1)
    cos, sin = rope_freqs(cache.idx[None], rope, rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)

    c_new = x @ params["w_dkv"].to(x.dtype)                      # (B,1,r)
    kr_new = apply_rope((x @ params["w_kr"].to(x.dtype))[:, :, None, :],
                        cos, sin)[:, :, 0, :]                    # (B,1,rope)
    write_slot(cache.idx, False, (cache.c_kv, c_new), (cache.k_rope, kr_new))

    # absorbed attention: score = q_nope·(c_kv W_uk) + q_rope·k_rope
    r = cfg.kv_lora_rank
    w_uk = params["w_uk"].to(x.dtype).reshape(r, n_heads, nope)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)     # (B,H,r)
    c_kv = cache.c_kv.to(torch.float32)
    s_lat = q_lat.to(torch.float32) @ c_kv.transpose(1, 2)       # (B,H,S)
    s_rope = (q_rope[:, 0].to(torch.float32) @
              cache.k_rope.to(torch.float32).transpose(1, 2))
    # 1 / sqrt(fp32(qk_dim)) rounded to fp32, as a host number (no sync)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(nope + rope)))
    scores = (s_lat + s_rope) * scale
    valid = torch.arange(cache.c_kv.shape[1], device=x.device) <= cache.idx
    scores = scores.masked_fill(~valid[None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)

    # values from the latent: o_lat = p·c_kv, then up-projected through W_uv
    o_lat = p @ c_kv                                             # (B,H,r)
    w_uv = params["w_uv"].to(x.dtype).reshape(r, n_heads, cfg.v_head_dim)
    o = torch.einsum("bhr,rhd->bhd", o_lat.to(x.dtype), w_uv)
    out = (o.reshape(b, 1, n_heads * cfg.v_head_dim) @
           params["wo"].to(x.dtype))
    return out, cache._replace(idx=cache.idx + 1)
