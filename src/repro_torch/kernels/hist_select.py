"""Histogram k-selection for STC: a 256-bin magnitude histogram per row,
a cumulative-sum bin search, and one refinement over the candidate bin.

Counterpart of ``repro/kernels/hist_select.py``.
:func:`magnitude_histogram_batched` launches ``csrc/histogram.cu`` on a CUDA
tensor and runs :func:`magnitude_histogram_plain` on a CPU tensor.

:func:`hist_topk_threshold_batched` is the k-selection, the same on
both devices:

1. ``a_max = max|x|`` per row and ``scale = 256 / a_max`` (0 for an
   all-zero row);                                         (pass 1, torch)
2. the histogram of per-bin ``(count, Σ|x|)``;           (pass 2, kernel)
3. ``locate_bin`` finds the bin ``b`` that holds the k-th largest magnitude
   and its rank ``r`` inside it; one refinement pass gathers the bin's
   candidates and reads the exact k-th magnitude from their top ``cap``
   values;                                                (pass 3, torch)
4. if a candidate bin holds more than ``cap`` elements (heavy ties, extreme
   dynamic range), that row falls back to an exact sort.

Unlike the reference, this selection never skips the histogram: the
reference's small-k shortcut (``interpret and k_max <= cap``) would bypass
the kernel at every main-path k.

Counts and sums follow Algorithm 1 (the reference's ``"jnp"`` contract):
exact zeros are never counted, so a row with fewer than k non-zeros gets
``v = 0``, ``count = #non-zeros`` and ``Σ`` over them (ROADMAP Queue 3, R1).
The threshold is an element of the row and the count is exact; ``Σ`` is
assembled from bin sums plus candidates, so it differs from a
mask-then-reduce sum at the ulp level.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.selection import DEFAULT_CAP, NBINS, PASSES, bin_index, locate_bin
from . import _build

__all__ = ["NBINS", "DEFAULT_CAP", "magnitude_histogram_batched",
           "magnitude_histogram_plain", "hist_topk_threshold_batched"]

# 512-thread CTAs a launch aims for on each SM (chip_smoke.py times 1, 2
# and 4); every CTA of a row adds one partial that the row's last CTA
# reduces, and a CTA takes at most _MAX_CTA_ELEMS elements (its split
# integer sums stay below 2^32)
_CTAS_PER_SM = 1
_MIN_ELEMS_PER_CTA = 8192
_MAX_CTA_ELEMS = 65000
_MAX_ROWS = 65535               # the grid's y extent
_SCRATCH: dict = {}             # (device index, stream) -> partials, tickets
_SMS: dict = {}                 # device index -> SM count


def magnitude_histogram_plain(x: torch.Tensor, scale: torch.Tensor,
                              bins: int = NBINS):
    """Plain PyTorch version: per-row ``(count int32, Σ|x| fp32)``.  Sums
    accumulate in fp64 and round to fp32 once, like the kernel."""
    a = x.abs()
    idx = bin_index(a, scale[:, None], bins).to(torch.int64)
    rows = x.shape[0]
    cnt = torch.zeros((rows, bins), dtype=torch.int32, device=x.device)
    cnt.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    sums = torch.zeros((rows, bins), dtype=torch.float64, device=x.device)
    sums.scatter_add_(1, idx, a.to(torch.float64))
    return cnt, sums.to(torch.float32)


def _grid(rows: int, n: int, sms: int) -> int:
    """CTAs a row: all resident at once (``_CTAS_PER_SM`` on every SM over
    the batch), none with fewer than ``_MIN_ELEMS_PER_CTA`` elements, and
    none with more than ``_MAX_CTA_ELEMS``."""
    return max(1, min(-(-n // _MIN_ELEMS_PER_CTA),
                      _CTAS_PER_SM * sms // rows),
               -(-n // _MAX_CTA_ELEMS))


def _scratch(device: torch.device, stream: int, slots: int):
    """Per-CTA partials (int32 counts, fp64 sums) and the zeroed per-row
    tickets, allocated once per device and stream and grown on demand; the
    kernel leaves every ticket at 0 again."""
    key = (device.index, stream)
    have = _SCRATCH.get(key)
    if have is None or have[0].numel() < slots * NBINS:
        slots = max(slots, 2 * _CTAS_PER_SM * _SMS[device.index])
        have = (torch.empty(slots * NBINS, dtype=torch.int32, device=device),
                torch.empty(slots * NBINS, dtype=torch.float64, device=device),
                have[2] if have is not None else
                torch.zeros(_MAX_ROWS, dtype=torch.int32, device=device))
        _SCRATCH[key] = have
    return have


def _launch(x, scale, bins):
    if bins != NBINS:
        raise ValueError(f"the CUDA histogram has {NBINS} bins, got {bins}")
    fn = _build.entry("histogram", "magnitude_histogram_f32",
                      [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p])
    rows, n = x.shape
    cnt = torch.empty((rows, bins), dtype=torch.int32, device=x.device)
    sums = torch.empty((rows, bins), dtype=torch.float32, device=x.device)
    if rows == 0 or n == 0:
        return cnt.zero_(), sums.zero_()
    idx = x.device.index
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(x.device) \
            .multi_processor_count
    per_row = _grid(rows, n, _SMS[idx])
    stream = _build.stream_ptr(x.device)
    part_cnt, part_sum, tickets = _scratch(x.device, stream, rows * per_row)
    err = fn(x.data_ptr(), scale.data_ptr(), cnt.data_ptr(), sums.data_ptr(),
             part_cnt.data_ptr(), part_sum.data_ptr(), tickets.data_ptr(),
             rows, n, per_row, stream)
    _build.check("histogram", err)
    _build.LAUNCHES.record("histogram", x.shape)
    return cnt, sums


def magnitude_histogram_batched(x: torch.Tensor, scale: torch.Tensor, *,
                                bins: int = NBINS):
    """Batched histogram over a ``(B, n)`` fp32 matrix with per-row
    ``(B,)`` scale -> ``(B, bins)`` int32 counts and fp32 sums."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, n) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    rows = x.shape[0]
    if scale.shape != (rows,) or scale.dtype != torch.float32 \
            or scale.device != x.device:
        raise ValueError(f"scale must be ({rows},) float32 on {x.device}, "
                         f"got {tuple(scale.shape)} {scale.dtype} on "
                         f"{scale.device}")
    PASSES.record("histogram")
    if x.device.type == "cpu":
        return magnitude_histogram_plain(x, scale, bins)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if rows > _MAX_ROWS:
        raise ValueError(f"at most {_MAX_ROWS} rows per launch, got {rows}")
    return _launch(x.contiguous(), scale.contiguous(), bins)


def _row_ks(k, rows: int, n: int, device) -> torch.Tensor:
    ks = torch.tensor(k, dtype=torch.int64).reshape(-1)
    ks = ks.expand(rows) if ks.numel() == 1 else ks
    if ks.shape != (rows,):
        raise ValueError(f"k must be an int or ({rows},), got {tuple(ks.shape)}")
    if rows and not (1 <= int(ks.min()) and int(ks.max()) <= n):
        raise ValueError(f"per-row k out of range [1, {n}]: {ks.tolist()}")
    return ks.to(device)


def hist_topk_threshold_batched(x: torch.Tensor, k, *, bins: int = NBINS,
                                cap: int = DEFAULT_CAP):
    """Exact per-row k-selection over ``(B, n)``.

    ``k`` is an int shared by every row or a ``(B,)`` per-row vector.
    Returns ``(thresh, count, sum_abs)`` of shape ``(B,)``: ``thresh`` the
    exact k-th largest magnitude, ``count`` the non-zeros at or above it
    (ties kept) and ``sum_abs`` their magnitude mass.
    """
    rows, n = x.shape
    kj = _row_ks(k, rows, n, x.device)
    x = x.to(torch.float32)
    cap_eff = min(cap, n)

    PASSES.record("max")                                        # pass 1
    a = x.abs()
    a_max = a.amax(dim=1)
    scale = torch.where(a_max > 0, torch.full_like(a_max, float(bins)) / a_max,
                        torch.zeros_like(a_max))

    cnt, sums = magnitude_histogram_batched(x, scale, bins=bins)  # pass 2
    b, cnt_gt, sum_gt, cnt_b = locate_bin(cnt, sums, kj, bins)
    r = kj - cnt_gt.to(torch.int64)                     # rank inside bin b

    PASSES.record("refine")                                     # pass 3
    in_bin = bin_index(a, scale[:, None], bins) == b[:, None]
    topc = torch.topk(torch.where(in_bin, a, torch.full_like(a, -1.0)),
                      cap_eff, dim=1).values
    v = topc.gather(1, torch.clamp(r - 1, 0, cap_eff - 1)[:, None])[:, 0]
    ge = (topc > 0.0) & (topc >= v[:, None])
    count = cnt_gt + ge.sum(dim=1, dtype=torch.int32)
    total = sum_gt + torch.where(ge, topc, torch.zeros_like(topc)).sum(dim=1)

    overflow = cnt_b > cap_eff
    if bool(overflow.any()):
        srt = torch.sort(a, dim=1).values
        vs = srt.gather(1, (n - kj)[:, None])[:, 0]
        m = (a >= vs[:, None]) & (a > 0.0)
        v = torch.where(overflow, vs, v)
        count = torch.where(overflow, m.sum(dim=1, dtype=torch.int32), count)
        total = torch.where(overflow,
                            torch.where(m, a, torch.zeros_like(a)).sum(dim=1),
                            total)
    return v, count, total
