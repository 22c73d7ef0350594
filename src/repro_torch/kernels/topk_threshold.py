"""k-selection by threshold bisection: the reference selector.

Counterpart of ``repro/kernels/topk_threshold.py`` (and of the bisection
oracle in ``repro/kernels/ref.py``).  :func:`threshold_stats` is one
streaming pass, the count and magnitude mass of ``|x| >= t``; on a CUDA
tensor it launches ``csrc/threshold_stats.cu`` and on a CPU tensor it runs
:func:`threshold_stats_plain`.  :func:`topk_threshold` drives ``iters``
bisection rounds and one final stats pass over it (``iters + 1`` passes).

The bracket follows the reference bit for bit: ``hi0 = a_max ·
fp32(1 + 1e-6) + fp32(1e-30)``, ``lo0 = 0``, ``mid = 0.5 · (lo + hi)``, all
fp32, and counts are exact, so ``lo`` is the reference's on either device.
The bracket stays on the tensor's device and is updated with
``torch.where``: the passes queue without a host sync.

Counts follow Algorithm 1 (``|x| >= t & |x| > 0``, ROADMAP Queue 3, R1):
for every ``t > 0`` that is the reference's count; at ``t = 0`` (a row with
fewer non-zeros than k, where ``lo`` stays 0) count and Σ cover the
non-zeros only, as in the reference's ``"jnp"`` backend.  Σ accumulates in
fp64 and rounds to fp32 once, in the kernel and in the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.selection import PASSES
from . import _build

__all__ = ["threshold_stats", "threshold_stats_plain", "topk_threshold"]

_TARGET_CTAS = 4 * 132          # enough resident blocks to fill an H100
_ELEMS_PER_CTA = 2048


def threshold_stats_plain(x: torch.Tensor, thresh: torch.Tensor):
    """Plain PyTorch version: ``(count int32, Σ|x| fp32)`` as 0-d tensors."""
    a = x.abs()
    m = (a >= thresh) & (a > 0.0)
    total = torch.where(m, a, torch.zeros_like(a)).to(torch.float64).sum()
    return m.sum(dtype=torch.int32), total.to(torch.float32)


def _launch(x: torch.Tensor, thresh: torch.Tensor):
    fn = _build.entry("threshold_stats", "threshold_stats_f32",
                      [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p])
    n = x.numel()
    blocks = max(1, min(-(-n // _ELEMS_PER_CTA), _TARGET_CTAS))
    cnt = torch.zeros((), dtype=torch.int32, device=x.device)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    err = fn(x.data_ptr(), thresh.data_ptr(), cnt.data_ptr(),
             total.data_ptr(), n, blocks, _build.stream_ptr(x.device))
    _build.check("threshold_stats", err)
    _build.LAUNCHES.record("threshold_stats", x.shape)
    return cnt, total.to(torch.float32)


def threshold_stats(x_flat: torch.Tensor, thresh):
    """``(count, Σ|x|)`` over the entries of a flat fp32 tensor with
    ``|x| >= thresh`` (and ``|x| > 0``).  ``thresh`` is a one-element fp32
    tensor on ``x_flat``'s device (or a number, moved there)."""
    if x_flat.ndim != 1 or x_flat.dtype != torch.float32:
        raise ValueError(f"x_flat must be a flat float32 tensor, got "
                         f"{tuple(x_flat.shape)} {x_flat.dtype}")
    t = torch.as_tensor(thresh, dtype=torch.float32, device=x_flat.device)
    if t.numel() != 1:
        raise ValueError(f"thresh must hold one value, got {tuple(t.shape)}")
    PASSES.record("threshold_stats")
    if x_flat.device.type == "cpu":
        return threshold_stats_plain(x_flat, t.reshape(()))
    if x_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {x_flat.device}")
    return _launch(x_flat.contiguous(), t.reshape(()).contiguous())


def topk_threshold(x_flat: torch.Tensor, k: int, *, iters: int = 32):
    """Bisection k-selection over a flat fp32 tensor through
    :func:`threshold_stats` (``iters + 1`` passes).

    Returns 0-d ``(thresh, count, sum_abs)``: ``count = #{|x| >= thresh,
    |x| > 0} >= k`` whenever the tensor has k non-zeros, and ``sum_abs``
    their magnitude mass (the µ numerator).
    """
    n = x_flat.numel()
    if not 1 <= k <= n:
        raise ValueError(f"k out of range [1, {n}]: {k}")
    # fp32 constants made by fills on the device: a host scalar copied in
    # would synchronize the stream
    f32 = dict(dtype=torch.float32, device=x_flat.device)
    a_max = x_flat.abs().amax()
    hi = a_max * torch.full((), 1.0 + 1e-6, **f32) \
        + torch.full((), 1e-30, **f32)
    lo = torch.zeros((), **f32)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cnt, _ = threshold_stats(x_flat, mid)
        keep = cnt >= k
        lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
    cnt, total = threshold_stats(x_flat, lo)
    return lo, cnt, total
