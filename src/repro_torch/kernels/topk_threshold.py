"""k-selection by threshold bisection: the reference selector.

Counterpart of ``repro/kernels/topk_threshold.py`` (and of the bisection
oracle in ``repro/kernels/ref.py``).  :func:`threshold_stats` is one
streaming pass, the count and magnitude mass of ``|x| >= t``; on a CUDA
tensor it launches ``csrc/threshold_stats.cu`` and on a CPU tensor it runs
:func:`threshold_stats_plain`.  :func:`topk_threshold` is the whole
bisection, ``iters`` steps and one final stats pass (``iters + 1`` logical
passes): on a CUDA tensor one launch of ``csrc/bisect_select.cu``, a thread
block cluster of 16 CTAs that reads x once and runs every step on chip; on a CPU
tensor :func:`topk_threshold_plain`, the loop over
:func:`threshold_stats_plain`.

The bracket follows the reference bit for bit: ``hi0 = fp32(a_max ·
fp32(1 + 1e-6)) + fp32(1e-30)``, ``lo0 = 0``, ``mid = fp32(0.5 · fp32(lo +
hi))``, every result flushed as XLA flushes it (``flush_subnormal``), and
counts are exact, so ``lo`` is the reference's on either device.

Counts follow Algorithm 1 (``|x| >= t & |x| > 0``, ROADMAP Queue 3, R1):
for every ``t > 0`` that is the reference's count; at ``t = 0`` (a row with
fewer non-zeros than k, where ``lo`` stays 0) count and Σ cover the
non-zeros only, as in the reference's ``"jnp"`` backend.  Subnormal values
of x and of t count as zeros.  Σ accumulates in fp64 and rounds to fp32
once, in the kernels and in the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.selection import PASSES, flush_subnormal
from . import _build

__all__ = ["threshold_stats", "threshold_stats_plain", "topk_threshold",
           "topk_threshold_plain"]

_TARGET_CTAS = 4 * 132          # enough resident blocks to fill an H100
_ELEMS_PER_CTA = 2048
_MAX_N = 2**31 - 1              # int32 counts
HI_SCALE = 1.0 + 1e-6           # hi0 = fp32(a_max * fp32(HI_SCALE))
HI_PAD = 1e-30                  #       + fp32(HI_PAD)
_STATS_SCRATCH: dict = {}       # (device index, stream) -> partials, ticket


def threshold_stats_plain(x: torch.Tensor, thresh: torch.Tensor):
    """Plain PyTorch version: ``(count int32, Σ|x| fp32)`` as 0-d tensors."""
    a = flush_subnormal(x).abs()
    m = (a >= flush_subnormal(thresh)) & (a > 0.0)
    total = torch.where(m, a, torch.zeros_like(a)).to(torch.float64).sum()
    return m.sum(dtype=torch.int32), total.to(torch.float32)


def _stats_scratch(device: torch.device, stream: int, blocks: int):
    """Per-CTA partials and the zeroed ticket, allocated once per device
    and stream and grown on demand; the kernel leaves the ticket at 0."""
    key = (device.index, stream)
    have = _STATS_SCRATCH.get(key)
    if have is None or have[0].numel() < blocks:
        blocks = max(blocks, _TARGET_CTAS)
        have = (torch.empty(blocks, dtype=torch.int32, device=device),
                torch.empty(blocks, dtype=torch.float64, device=device),
                have[2] if have is not None else
                torch.zeros(1, dtype=torch.int32, device=device))
        _STATS_SCRATCH[key] = have
    return have


def _launch(x: torch.Tensor, thresh: torch.Tensor):
    fn = _build.entry("threshold_stats", "threshold_stats_f32",
                      [ctypes.c_void_p] * 7 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p])
    n = x.numel()
    blocks = max(1, min(-(-n // _ELEMS_PER_CTA), _TARGET_CTAS))
    cnt = torch.empty((), dtype=torch.int32, device=x.device)
    total = torch.empty((), dtype=torch.float32, device=x.device)
    if n == 0:
        return cnt.zero_(), total.zero_()
    stream = _build.stream_ptr(x.device)
    part_cnt, part_sum, ticket = _stats_scratch(x.device, stream, blocks)
    err = fn(x.data_ptr(), thresh.data_ptr(), cnt.data_ptr(),
             total.data_ptr(), part_cnt.data_ptr(), part_sum.data_ptr(),
             ticket.data_ptr(), n, blocks, stream)
    _build.check("threshold_stats", err)
    _build.LAUNCHES.record("threshold_stats", x.shape)
    return cnt, total


def _check_flat(x_flat: torch.Tensor) -> None:
    if x_flat.ndim != 1 or x_flat.dtype != torch.float32:
        raise ValueError(f"x_flat must be a flat float32 tensor, got "
                         f"{tuple(x_flat.shape)} {x_flat.dtype}")
    if x_flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x_flat.device}")
    if x_flat.numel() > _MAX_N:
        raise ValueError(f"at most {_MAX_N} elements, got {x_flat.numel()}")


def threshold_stats(x_flat: torch.Tensor, thresh):
    """``(count, Σ|x|)`` over the entries of a flat fp32 tensor with
    ``|x| >= thresh`` (and ``|x| > 0``).  ``thresh`` is a one-element fp32
    tensor on ``x_flat``'s device (or a number, moved there)."""
    _check_flat(x_flat)
    t = torch.as_tensor(thresh, dtype=torch.float32, device=x_flat.device)
    if t.numel() != 1:
        raise ValueError(f"thresh must hold one value, got {tuple(t.shape)}")
    PASSES.record("threshold_stats")
    if x_flat.device.type == "cpu":
        return threshold_stats_plain(x_flat, t.reshape(()))
    return _launch(x_flat.contiguous(), t.reshape(()).contiguous())


def topk_threshold_plain(x_flat: torch.Tensor, k: int, iters: int = 32):
    """Plain PyTorch version of the bisection: ``iters`` steps of
    :func:`threshold_stats_plain` on a bracket kept on the tensor's device
    (``torch.where``, no host sync), then the stats at ``lo``."""
    # fp32 constants made by fills on the device: a host scalar copied in
    # would synchronize the stream
    f32 = dict(dtype=torch.float32, device=x_flat.device)
    a_max = flush_subnormal(x_flat).abs().amax()
    hi = flush_subnormal(flush_subnormal(a_max * torch.full((), HI_SCALE,
                                                            **f32))
                         + torch.full((), HI_PAD, **f32))
    lo = torch.zeros((), **f32)
    for _ in range(iters):
        mid = flush_subnormal(0.5 * flush_subnormal(lo + hi))
        cnt, _ = threshold_stats_plain(x_flat, mid)
        keep = cnt >= k
        lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
    cnt, total = threshold_stats_plain(x_flat, lo)
    return lo, cnt, total


def _launch_bisect(x: torch.Tensor, k: int, iters: int):
    fn = _build.entry("bisect_select", "bisect_select_f32",
                      [ctypes.c_void_p] * 4
                      + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    lo = torch.empty((), dtype=torch.float32, device=x.device)
    cnt = torch.empty((), dtype=torch.int32, device=x.device)
    total = torch.empty((), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), lo.data_ptr(), cnt.data_ptr(), total.data_ptr(),
             x.numel(), k, iters, HI_SCALE, HI_PAD,
             _build.stream_ptr(x.device))
    _build.check("bisect_select", err)
    _build.LAUNCHES.record("bisect_select", x.shape)
    return lo, cnt, total


def topk_threshold(x_flat: torch.Tensor, k: int, *, iters: int = 32):
    """Bisection k-selection over a flat fp32 tensor (``iters + 1`` logical
    passes): one launch of ``csrc/bisect_select.cu`` on a CUDA tensor,
    :func:`topk_threshold_plain` on a CPU tensor.

    Returns 0-d ``(thresh, count, sum_abs)``: ``count = #{|x| >= thresh,
    |x| > 0} >= k`` whenever the tensor has k non-zeros, and ``sum_abs``
    their magnitude mass (the µ numerator).
    """
    _check_flat(x_flat)
    n = x_flat.numel()
    if not 1 <= k <= n:
        raise ValueError(f"k out of range [1, {n}]: {k}")
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    PASSES.record("threshold_stats", iters + 1)
    if x_flat.device.type == "cpu":
        return topk_threshold_plain(x_flat, k, iters)
    return _launch_bisect(x_flat.contiguous(), int(k), int(iters))
