"""Attention: GQA (+ optional QKV bias), causal / sliding-window / cross,
with the flash-style attention of :mod:`.flash` or the chunked
online-softmax reference.

Counterpart of ``repro/models/attention.py``: full sequences (training
and prefill) and the single-token decode against a KV cache
(``init_kv_cache``, ``attn_decode``).

Two differences from the reference, neither numeric:

* ``attn_decode`` writes the new token's K/V into the cache tensors IN
  PLACE (the reference's ``dynamic_update_slice`` returns a new cache;
  copying a cache of tens of GB every step is not an option on the card).
  The slot is addressed by the cache's device ``idx``, so a step makes no
  host sync.  The cache passed in is consumed: the returned ``KVCache``
  holds the same ``k`` / ``v`` tensors and ``idx + 1``.
* The reference's ``DECODE_SHARD_HINT`` (a GSPMD layout hook that
  ``launch.serve`` sets per ``cache_mode``) is left out: the port has no
  GSPMD, and on one device every layout gives the same values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .flash import _fwd_scan, _to_bshd, flash_attention
from .layers import apply_rope, dense_init, rope_freqs

__all__ = ["KVCache", "attn_init", "attn_apply", "attn_decode",
           "init_kv_cache", "chunked_attention"]

NEG_INF = -1e30

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


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_cache, KV, hd)
    v: torch.Tensor     # (B, S_cache, KV, hd)
    idx: torch.Tensor   # 0-d int32 on the cache's device: positions written
    ring: bool = False  # True -> S_cache is a sliding window ring buffer


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
    positions: Optional[torch.Tensor] = None, tp=None,
) -> torch.Tensor:
    """Full-sequence attention. ``memory`` switches to cross-attention
    (k/v projected from memory, no causal mask, no RoPE on memory keys).

    Under tensor parallelism (``tp``, a
    :class:`~repro_torch.sharding.tensor_parallel.TensorParallel`; self
    attention only) ``params`` are the rank's blocks and ``n_heads`` /
    ``n_kv_heads`` its local heads: ``wq``, ``wk``, ``wv`` and the biases
    split by whole heads, ``wo`` by rows, and the partial outputs are
    summed over the model group.  The attention itself sees only local
    heads, and its backward needs nothing of the other ranks."""
    from ..sharding.tensor_parallel import copy_to, reduce_from
    b, s, _ = x.shape
    if tp is not None:
        if memory is not None:
            raise NotImplementedError("cross-attention under tensor "
                                      "parallelism (ROADMAP.md Queue 1, "
                                      "item 4c)")
        x = copy_to(x, tp)
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
    return reduce_from(out.reshape(b, s, n_heads * head_dim) @
                       params["wo"].to(x.dtype), tp)


def init_kv_cache(batch: int, s_cache: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, ring: bool = False,
                  device=None) -> KVCache:
    shape = (batch, s_cache, n_kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        idx=torch.zeros((), dtype=torch.int32, device=device), ring=ring)


def attn_decode(
    params, x: torch.Tensor, cache: KVCache, *, n_heads: int, n_kv_heads: int,
    head_dim: int, rope_theta: float = 10000.0, window: int = 0,
    memory: Optional[torch.Tensor] = None, tp=None,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode: x is (B, 1, d). Returns (out (B,1,d), cache).

    Full cache: write at idx (clamped to the last slot, as the reference's
    ``dynamic_update_slice`` clamps).  Sliding window (``cache.ring``):
    write at idx % S_cache; positions beyond the window are never attended
    because the ring only holds the last S_cache = window tokens.  The
    write goes into ``cache.k`` / ``cache.v`` in place: the cache passed in
    is consumed, and the one returned holds the same tensors and
    ``idx + 1`` (on the device).  ``memory`` switches to cross-attention
    over it, and the cache comes back untouched.

    Under tensor parallelism (``tp``, self attention only) ``params`` are
    the rank's blocks, as in :func:`attn_apply`, ``n_heads`` /
    ``n_kv_heads`` its local heads, and ``cache`` holds only its KV heads;
    the partial outputs are summed over the model group (Megatron's *g*,
    an ``all_reduce`` in the forward).
    """
    from ..sharding.tensor_parallel import reduce_from
    b = x.shape[0]
    if tp is not None and memory is not None:
        raise NotImplementedError("cross-attention under tensor "
                                  "parallelism (ROADMAP.md Queue 1, "
                                  "item 4c)")
    if memory is not None:
        sm = memory.shape[1]
        q = (x @ params["wq"].to(x.dtype)).reshape(b, 1, n_heads, head_dim)
        k = (memory @ params["wk"].to(x.dtype)).reshape(b, sm, n_kv_heads,
                                                        head_dim)
        v = (memory @ params["wv"].to(x.dtype)).reshape(b, sm, n_kv_heads,
                                                        head_dim)
        valid = torch.ones((sm,), dtype=torch.bool, device=x.device)
        out = _dense_decode_attn(q, k, v, valid)
        return (out.reshape(b, 1, n_heads * head_dim) @
                params["wo"].to(x.dtype)), cache

    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    cos, sin = rope_freqs(cache.idx[None], head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    s_cache = cache.k.shape[1]
    write_slot(cache.idx, cache.ring, (cache.k, k), (cache.v, v))
    n_valid = torch.clamp(cache.idx + 1, max=s_cache)
    valid = torch.arange(s_cache, device=x.device) < n_valid
    out = _dense_decode_attn(q, cache.k, cache.v, valid)
    out = reduce_from(out.reshape(b, 1, n_heads * head_dim) @
                      params["wo"].to(x.dtype), tp)
    return out, cache._replace(idx=cache.idx + 1)


def write_slot(idx: torch.Tensor, ring: bool, *pairs) -> None:
    """Write each ``(buffer, value)`` pair's one-position ``value`` into its
    ``(B, S_cache, ...)`` buffer IN PLACE, at position ``idx`` (the
    caches' device counter: no host sync) along dim 1: ``idx % S_cache``
    for a ring, else ``idx`` clamped to the last slot, as the reference's
    ``dynamic_update_slice`` clamps."""
    s_cache = pairs[0][0].shape[1]
    slot = idx % s_cache if ring else torch.clamp(idx, max=s_cache - 1)
    slot = slot.reshape(1).long()
    for buf, value in pairs:
        buf.index_copy_(1, slot, value.to(buf.dtype))


def _dense_decode_attn(q, k, v, valid):
    """q: (B,1,H,hd); k/v: (B,S,KV,hd); valid: (S,) bool.  Scores and
    softmax in fp32 on the fp32-upcast cache; out in q's dtype."""
    b, _, h, hd = q.shape
    kv = k.shape[2]
    rep = h // kv
    # 1 / sqrt(fp32(hd)) rounded to fp32, as a Python number: a device
    # tensor made from a host value would copy (and sync) every step
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    qg = q.reshape(b, kv, rep, hd).to(torch.float32) * scale
    s = torch.einsum("bgrd,bcgd->bgrc", qg, k.to(torch.float32))
    s = s.masked_fill(~valid[None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrc,bcgd->bgrd", p, v.to(torch.float32))
    return o.reshape(b, 1, h, hd).to(q.dtype)
