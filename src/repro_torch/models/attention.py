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
           "init_kv_cache", "chunked_attention", "core_heads"]

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


def core_heads(n_heads: int, n_kv_heads: int, m: int) -> tuple[int, int]:
    """The query and KV heads that one of ``m`` model ranks runs the
    attention core on and holds in its KV cache: its share where ``m``
    splits both counts into whole heads (the whole-head route), every head
    where it does not (the gather route)."""
    if n_heads % m == 0 and n_kv_heads % m == 0:
        return n_heads // m, n_kv_heads // m
    return n_heads, n_kv_heads


def _route(n_heads: int, n_kv_heads: int, tp) -> tuple[int, int, bool]:
    """A layer's ``(query heads, KV heads, gather)`` under ``tp`` (None:
    one rank) from the global head counts."""
    m = 1 if tp is None else tp.size
    h, kv = core_heads(n_heads, n_kv_heads, m)
    return h, kv, m > 1 and h == n_heads


def _gather_qkv(params, x, n_heads, n_kv_heads, head_dim, tp):
    """The gather route's whole q, k and v, ``(B, S, heads, hd)`` on every
    rank.  Each of ``wq``, ``wk``, ``wv`` (and its bias) is the rank's
    column block where ``fit_spec`` splits it, a block that may cut a head,
    or the whole leaf; the split products take ``x`` through ``copy_to``,
    the whole ones take it as it is (their input gradient is already whole
    on every rank), and the split blocks are joined in ONE ``all_gather``
    of their concatenation."""
    from ..sharding.tensor_parallel import copy_to, gather_from
    b, s, _ = x.shape
    heads = {"q": n_heads, "k": n_kv_heads, "v": n_kv_heads}
    split = [n for n in "qkv" if params["w" + n].shape[1] !=
             heads[n] * head_dim]
    xs = copy_to(x, tp) if split else x
    out = {}
    for n in "qkv":
        y = (xs if n in split else x) @ params["w" + n].to(x.dtype)
        if "b" + n in params:
            y = y + params["b" + n].to(x.dtype)
        out[n] = y
    if split:
        cols = [out[n].shape[-1] for n in split]
        joined = gather_from(torch.cat([out[n] for n in split], dim=-1), tp)
        parts = joined.reshape(b, s, tp.size, sum(cols)).split(cols, dim=-1)
        for n, part in zip(split, parts):
            out[n] = part.reshape(b, s, tp.size * part.shape[-1])
    return tuple(out[n].reshape(b, s, heads[n], head_dim) for n in "qkv")


def _out_proj(params, o, tp, gather):
    """``o @ wo`` summed over the model group: the whole-head route's
    row block of the rank's heads; on the gather route the rank's row block
    of the whole ``o`` (``scatter_to``), or the whole ``wo`` replicated."""
    from ..sharding.tensor_parallel import reduce_from, scatter_to
    wo = params["wo"].to(o.dtype)
    if gather and wo.shape[0] == o.shape[-1]:
        return o @ wo
    if gather:
        o = scatter_to(o, tp)
    return reduce_from(o @ wo, tp)


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
    ``n_kv_heads`` stay the global counts.  Where ``tp.size`` splits both
    into whole heads (:func:`core_heads`) the layer takes the whole-head
    route: ``wq``, ``wk``, ``wv`` and the biases split by whole heads,
    ``wo`` by rows, and the partial outputs are summed over the model
    group; the attention sees only local heads, and its backward needs
    nothing of the other ranks.  Otherwise it takes the gather route: the
    rank's column blocks of q, k and v, which may cut a head, are joined
    in one ``all_gather``, RoPE and the attention run on whole heads on
    every rank (RoPE pairs dimension i of a head with i + hd/2, which a
    block cut mid-head may not hold), and ``wo`` takes the rank's row
    block of the output (``scatter_to``)."""
    from ..sharding.tensor_parallel import copy_to
    b, s, _ = x.shape
    if tp is not None and memory is not None:
        raise NotImplementedError("cross-attention under tensor "
                                  "parallelism (ROADMAP.md Queue 1, "
                                  "item 4c)")
    n_heads, n_kv_heads, gather = _route(n_heads, n_kv_heads, tp)
    if gather:
        q, k, v = _gather_qkv(params, x, n_heads, n_kv_heads, head_dim, tp)
    elif tp is not None:
        x = copy_to(x, tp)
    if memory is None:
        if not gather:
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
    return _out_proj(params, out.reshape(b, s, n_heads * head_dim), tp,
                     gather)


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
    the rank's blocks and the head counts the global ones, as in
    :func:`attn_apply`.  On the whole-head route ``cache`` holds only the
    rank's KV heads and the partial outputs are summed over the model
    group (Megatron's *g*, an ``all_reduce`` in the forward).  On the
    gather route ``cache`` is whole on every rank: the whole new k and v,
    joined as :func:`attn_apply` joins them, go into it, and the attention
    runs on whole heads on every rank.
    """
    b = x.shape[0]
    if tp is not None and memory is not None:
        raise NotImplementedError("cross-attention under tensor "
                                  "parallelism (ROADMAP.md Queue 1, "
                                  "item 4c)")
    n_heads, n_kv_heads, gather = _route(n_heads, n_kv_heads, tp)
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

    if gather:
        q, k, v = _gather_qkv(params, x, n_heads, n_kv_heads, head_dim, tp)
    else:
        q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    cos, sin = rope_freqs(cache.idx[None], head_dim, rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    s_cache = cache.k.shape[1]
    write_slot(cache.idx, cache.ring, (cache.k, k), (cache.v, v))
    n_valid = torch.clamp(cache.idx + 1, max=s_cache)
    valid = torch.arange(s_cache, device=x.device) < n_valid
    out = _dense_decode_attn(q, cache.k, cache.v, valid)
    out = _out_proj(params, out.reshape(b, 1, n_heads * head_dim), tp, gather)
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
