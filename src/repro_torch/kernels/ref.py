"""Plain-PyTorch oracles of the reference's kernel semantics.

Counterpart of ``repro/kernels/ref.py`` (and of its ``stc_compress_ref``,
``pack_bits_ref`` and ``unpack_bits_ref``): each function is the
reference's oracle written in torch, on any device.  They compute as the
reference does on its CPU and TPU backends, which flush subnormal fp32
values to zero: inputs and results are flushed here
(:func:`repro_torch.core.selection.flush_subnormal`).  Unlike the port's
kernels, :func:`threshold_stats_ref` counts exact zeros at a threshold of
0, as the reference's oracle does.  Sums accumulate in fp64 and round to
fp32 once.  Words are the port's: a uint32 bit pattern held in int32.
"""

from __future__ import annotations

import torch

from ..core.selection import NBINS, bin_index, flush_subnormal
from .bitpack import pack_bits_plain
from .topk_threshold import topk_threshold_plain
from .wiredecode import unpack_words_plain

__all__ = [
    "threshold_stats_ref",
    "topk_threshold_ref",
    "magnitude_histogram_ref",
    "stc_apply_ref",
    "stc_fused_ref",
    "stc_compress_ref",
    "pack_bits_ref",
    "unpack_bits_ref",
]


def threshold_stats_ref(x: torch.Tensor, thresh):
    """``(count int32, Σ|x| fp32)`` of the entries with ``|x| >= thresh``;
    ``x`` a flat fp32 vector."""
    a = flush_subnormal(x.to(torch.float32)).abs()
    t = flush_subnormal(torch.as_tensor(thresh, dtype=torch.float32,
                                        device=x.device))
    mask = a >= t
    total = torch.where(mask, a, torch.zeros_like(a)).to(torch.float64).sum()
    return mask.sum(dtype=torch.int32), total.to(torch.float32)


def topk_threshold_ref(x: torch.Tensor, k: int, iters: int = 32):
    """The magnitude threshold ``t`` with ``count(|x| >= t) >= k`` found by
    ``iters`` bisection steps over ``[0, max|x|·(1 + 1e-6) + 1e-30]``: the
    largest bracketed threshold that keeps ``k`` (``lax.top_k``'s k-th
    magnitude up to ties)."""
    return topk_threshold_plain(x.reshape(-1).to(torch.float32), k,
                                iters)[0]


def magnitude_histogram_ref(x: torch.Tensor, scale, bins: int = NBINS):
    """Per-bin ``(count int32, Σ|x| fp32)`` with the linear binning of the
    histogram kernel (the shared
    :func:`~repro_torch.core.selection.bin_index`)."""
    a = flush_subnormal(x.reshape(-1).to(torch.float32)).abs()
    scale = torch.as_tensor(scale, dtype=torch.float32, device=a.device)
    idx = bin_index(a, scale, bins).to(torch.int64)
    cnt = torch.bincount(idx, minlength=bins).to(torch.int32)
    sums = torch.bincount(idx, weights=a.to(torch.float64), minlength=bins)
    return cnt, sums.to(torch.float32)


def stc_apply_ref(carried: torch.Tensor, thresh, mu):
    """``tern = µ·sign(carried)·[|carried| >= thresh]`` and the new residual
    ``carried - tern``, for a flat fp32 carried vector and scalar
    ``thresh``, ``mu``."""
    c = flush_subnormal(carried)
    t = flush_subnormal(torch.as_tensor(thresh, dtype=c.dtype,
                                        device=c.device))
    m = flush_subnormal(torch.as_tensor(mu, dtype=c.dtype, device=c.device))
    tern = torch.where(c.abs() >= t, m * torch.sign(c), torch.zeros_like(c))
    tern = flush_subnormal(tern)
    return tern.to(carried.dtype), flush_subnormal(c - tern).to(carried.dtype)


def stc_fused_ref(delta: torch.Tensor, residual: torch.Tensor, thresh, mu):
    """:func:`stc_apply_ref` on ``carried = delta + residual``; ``tern`` in
    ``delta``'s dtype, the residual in ``residual``'s."""
    carried = flush_subnormal(delta + residual)
    tern, res = stc_apply_ref(carried, thresh, mu)
    return tern.to(delta.dtype), res.to(residual.dtype)


def stc_compress_ref(delta: torch.Tensor, residual: torch.Tensor, p: float,
                     *, iters: int = 32):
    """STC by bisection, with the kernel path's signature:
    ``(tern, new_residual, mu, thresh, count)`` for ``k = max(int(n·p),
    1)``."""
    k = max(int(delta.numel() * p), 1)
    carried = flush_subnormal(delta.reshape(-1).to(torch.float32) +
                              residual.reshape(-1).to(torch.float32))
    thresh = topk_threshold_ref(carried, k, iters=iters)
    cnt, s = threshold_stats_ref(carried, thresh)
    mu = flush_subnormal(s / torch.clamp(cnt, min=1).to(torch.float32))
    tern, new_res = stc_apply_ref(carried, thresh, mu)
    return tern, new_res, mu, thresh, cnt


def pack_bits_ref(bits: torch.Tensor) -> torch.Tensor:
    """A flat 0/1 vector packed into MSB-first words."""
    return pack_bits_plain(bits.reshape(-1).to(torch.uint8))


def unpack_bits_ref(words: torch.Tensor) -> torch.Tensor:
    """Words -> the full MSB-first 0/1 bit vector (uint8)."""
    return unpack_words_plain(words.reshape(-1))[0]
