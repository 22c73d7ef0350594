"""Histogram k-selection for STC: a 256-bin magnitude histogram per row,
a cumulative-sum bin search, and an exact select inside the candidate bin.

Counterpart of ``repro/kernels/hist_select.py``.
:func:`magnitude_histogram_batched` launches ``csrc/histogram.cu`` and
:func:`candidate_select_batched` launches ``csrc/bin_select.cu`` on a CUDA
tensor; on a CPU tensor they run :func:`magnitude_histogram_plain` and
:func:`candidate_select_plain`.

:func:`hist_topk_threshold_batched` is the k-selection, the same on
both devices:

1. ``a_max = max|x|`` per row and ``scale = 256 / a_max`` (0 for a row
   of zeros and subnormals);                              (pass 1, torch)
2. the histogram of per-bin ``(count, Σ|x|)``;           (pass 2, kernel)
3. ``locate_bin`` finds the bin ``b`` that holds the k-th largest magnitude
   and its rank ``r`` inside it, and the select reads the exact ``r``-th
   largest magnitude of bin ``b`` with the count and mass of the bin's
   elements at or above it.                               (pass 3, kernel)

The select kernel is a radix select on the fp32 bit pattern with no
capacity limit and exact integer sums, on one of two routes that
:func:`select_plan` picks from the batch's shape alone: rows that fit a
thread block cluster's shared memory are held there and selected in one
launch (``"cluster"``); longer rows read x twice, the second time
compacting the candidates of the level-0 digit that holds the rank into a
buffer that the last level reads (``"two_read"``).  Its plain version is
the reference's refinement: the top ``cap`` values of the masked row, or an
exact sort of the row when the candidate bin holds more than ``cap``
elements (heavy ties, extreme dynamic range, and bin 0 of the trainers'
carried residual rows).

Unlike the reference, this selection never skips the histogram: the
reference's small-k shortcut (``interpret and k_max <= cap``) would bypass
the kernel at every main-path k.

Counts and sums follow Algorithm 1 (the reference's ``"jnp"`` contract):
exact zeros are never counted and subnormal values count as zeros (the
kernels and the plain versions flush them, ``flush_subnormal``), so a row
with fewer than k non-zeros gets ``v = 0``, ``count = #non-zeros`` and
``Σ`` over them (ROADMAP Queue 3, R1).
The threshold is an element of the row and the count is exact; ``Σ`` is
assembled from bin sums plus the candidates', so it differs from a
mask-then-reduce sum at the ulp level.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.selection import (DEFAULT_CAP, FLT_MIN, NBINS, PASSES, bin_index,
                              flush_subnormal, locate_bin)
from . import _build

__all__ = ["NBINS", "DEFAULT_CAP", "magnitude_histogram",
           "magnitude_histogram_batched", "magnitude_histogram_plain",
           "candidate_select_batched", "candidate_select_plain",
           "hist_topk_threshold", "hist_topk_threshold_batched",
           "SelectPlan", "select_plan", "two_read_plan"]

# 512-thread CTAs a launch aims for on each SM (chip_smoke.py times 1, 2
# and 4); every CTA of a row adds one partial that the row's last CTA
# reduces, and a CTA takes at most _MAX_CTA_ELEMS elements (its split
# integer sums stay below 2^32)
_CTAS_PER_SM = 1
_MIN_ELEMS_PER_CTA = 8192
_MAX_CTA_ELEMS = 65000
_MAX_ROWS = 65535               # the grid's y extent: rows a launch
_SCRATCH: dict = {}             # (device index, stream) -> partials, tickets
_SMS: dict = {}                 # device index -> SM count
# the select (csrc/bin_select.cu): a row of at most _MAX_CLUSTER *
# _CLUSTER_KEYS elements is held in a cluster's shared memory, _CLUSTER_KEYS
# a CTA (the kernel's CLUSTER_KEYS); a longer row takes the two-read route,
# whose per-row scratch is _ROW_SCRATCH_BYTES (its RowScratch) and whose
# candidate buffer holds n / _BUFFER_SHARE elements a row
_CLUSTER_KEYS = 53_248
_MAX_CLUSTER = 16
_ROW_SCRATCH_BYTES = 18_480
_BUFFER_SHARE = 32
_SELECT_SCRATCH: dict = {}      # (device index, stream) -> select scratch


def magnitude_histogram_plain(x: torch.Tensor, scale: torch.Tensor,
                              bins: int = NBINS):
    """Plain PyTorch version: per-row ``(count int32, Σ|x| fp32)``.  Sums
    accumulate in fp64 and round to fp32 once, like the kernel."""
    a = flush_subnormal(x).abs()
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


def _row_batches(rows: int):
    """``[r0, r1)`` row ranges of at most ``_MAX_ROWS`` rows, one a launch:
    every row is independent, so a batch of more rows than the grid's y
    extent is the launches over its ranges, in order."""
    return [(r0, min(r0 + _MAX_ROWS, rows))
            for r0 in range(0, rows, _MAX_ROWS)]


def _sms(device: torch.device) -> int:
    idx = device.index
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(device) \
            .multi_processor_count
    return _SMS[idx]


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
    stream = _build.stream_ptr(x.device)
    for r0, r1 in _row_batches(rows):
        per_row = _grid(r1 - r0, n, _sms(x.device))
        part_cnt, part_sum, tickets = _scratch(x.device, stream,
                                               (r1 - r0) * per_row)
        err = fn(x.data_ptr() + 4 * r0 * n, scale.data_ptr() + 4 * r0,
                 cnt.data_ptr() + 4 * r0 * bins,
                 sums.data_ptr() + 4 * r0 * bins, part_cnt.data_ptr(),
                 part_sum.data_ptr(), tickets.data_ptr(), r1 - r0, n,
                 per_row, stream)
        _build.check("histogram", err)
        _build.LAUNCHES.record("histogram", (r1 - r0, n))
    return cnt, sums


def magnitude_histogram_batched(x: torch.Tensor, scale: torch.Tensor, *,
                                bins: int = NBINS):
    """Batched histogram over a ``(B, n)`` fp32 matrix with per-row
    ``(B,)`` scale -> ``(B, bins)`` int32 counts and fp32 sums.  On the
    card a launch takes at most 65,535 rows; more rows take successive
    launches."""
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
    return _launch(x.contiguous(), scale.contiguous(), bins)


def magnitude_histogram(x_flat: torch.Tensor, scale: torch.Tensor, *,
                        bins: int = NBINS):
    """One row: ``(counts, sums)`` of shape ``(bins,)`` for a flat fp32
    vector and a 0-d ``scale``.  The batched histogram with a row of
    one."""
    cnt, sums = magnitude_histogram_batched(
        x_flat.reshape(1, -1), scale.reshape(1), bins=bins)
    return cnt[0], sums[0]


def _row_ks(k, rows: int, n: int, device) -> torch.Tensor:
    """``k`` as a ``(rows,)`` int64 tensor on ``device``.

    An int or per-row ks on the host are range-checked on the host; a
    shared k becomes a device fill and per-row ks an asynchronous copy from
    pinned memory.  An integer tensor of ks (computed on the device, as the
    adaptive controllers compute them) is clipped to ``[1, n]`` where it
    lies and read nothing of back.  None of them synchronizes."""
    if isinstance(k, torch.Tensor):
        if k.dtype.is_floating_point or k.dtype == torch.bool \
                or k.numel() not in (1, rows):
            raise ValueError(f"k must be an integer tensor of one or {rows} "
                             f"ks, got {tuple(k.shape)} {k.dtype}")
        kj = k.to(device=device, dtype=torch.int64).reshape(-1)
        return torch.clamp(kj.expand(rows), 1, max(n, 1))
    ks = np.asarray(k, np.int64).reshape(-1)
    if ks.size not in (1, rows):
        raise ValueError(f"k must be an int or ({rows},), got {ks.shape}")
    if rows and not (1 <= ks.min() and ks.max() <= n):
        raise ValueError(f"per-row k out of range [1, {n}]: {ks.tolist()}")
    if ks.size == 1:
        return torch.full((rows,), int(ks[0]), dtype=torch.int64,
                          device=device)
    host = torch.from_numpy(ks.copy())
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def candidate_select_plain(x: torch.Tensor, scale: torch.Tensor,
                           b: torch.Tensor, r: torch.Tensor, *,
                           cap: int = DEFAULT_CAP):
    """Plain PyTorch version of the candidate-bin select: per row, ``v`` the
    ``r``-th largest ``|x|`` among the elements of bin ``b``, and
    ``(cnt_in, sum_in)`` over the bin's elements ``>= v`` and ``> 0``.

    The bin's candidates are read from the top ``cap`` values of the masked
    row; a row whose bin holds more than ``cap`` elements takes them from a
    full sort.  Runs on the CPU; the card runs ``csrc/bin_select.cu``."""
    n = x.shape[1]
    cap_eff = min(cap, n)
    a = flush_subnormal(x).abs()
    in_bin = bin_index(a, scale[:, None], NBINS) == b[:, None]
    topc = torch.topk(torch.where(in_bin, a, torch.full_like(a, -1.0)),
                      cap_eff, dim=1).values
    v = topc.gather(1, torch.clamp(r - 1, 0, cap_eff - 1)[:, None])[:, 0]
    ge = (topc > 0.0) & (topc >= v[:, None])
    count = ge.sum(dim=1, dtype=torch.int32)
    total = torch.where(ge, topc, torch.zeros_like(topc)).sum(dim=1)

    overflow = in_bin.sum(dim=1) > cap_eff
    if bool(overflow.any()):
        srt = torch.sort(torch.where(in_bin, a, torch.full_like(a, -1.0)),
                         dim=1, descending=True).values
        vs = srt.gather(1, torch.clamp(r - 1, 0, n - 1)[:, None])[:, 0]
        m = in_bin & (a >= vs[:, None]) & (a > 0.0)
        v = torch.where(overflow, vs, v)
        count = torch.where(overflow, m.sum(dim=1, dtype=torch.int32), count)
        total = torch.where(overflow,
                            torch.where(m, a, torch.zeros_like(a)).sum(dim=1),
                            total)
    return v, count, total


class SelectPlan(NamedTuple):
    """How ``bin_select`` runs a batch: ``route`` ``"cluster"`` (one
    launch, each row held in the shared memory of a cluster of ``cluster``
    CTAs) or ``"two_read"`` (three launches of ``ctas_per_row`` CTAs a
    row, two of them reading x, with a candidate buffer of ``capacity``
    elements a row)."""
    route: str
    cluster: int
    ctas_per_row: int
    capacity: int


def select_plan(rows: int, n: int, sms: int) -> SelectPlan:
    """The select's route for a ``(rows, n)`` batch on a card of ``sms``
    SMs, from the shape alone (no value of the batch is read, so nothing
    synchronizes).  A row of at most ``_MAX_CLUSTER * _CLUSTER_KEYS``
    elements takes the cluster route with the smallest power of two of CTAs
    that holds it (16 CTAs at the cnn rows are faster for one row and
    slower for ten: ``PERF.md`` §6); a longer one the two-read route over one CTA an SM
    across the batch (none with fewer than ``_MIN_ELEMS_PER_CTA``
    elements), with room for ``n / _BUFFER_SHARE`` candidates a row,
    rounded up to a multiple of 4."""
    if n <= _MAX_CLUSTER * _CLUSTER_KEYS:
        cluster = 1
        while -(-n // cluster) > _CLUSTER_KEYS:
            cluster *= 2
        return SelectPlan("cluster", cluster, cluster, 0)
    return two_read_plan(rows, n, sms)


def two_read_plan(rows: int, n: int, sms: int) -> SelectPlan:
    """The two-read route's plan for a ``(rows, n)`` batch, which
    :func:`select_plan` takes for rows too long for a cluster (and
    ``chip_smoke.py --select-study`` times at shorter rows too)."""
    per_row = max(1, min(-(-n // _MIN_ELEMS_PER_CTA), sms // rows))
    capacity = -(-n // _BUFFER_SHARE)
    return SelectPlan("two_read", 0, per_row, capacity + (-capacity) % 4)


def _select_scratch(device: torch.device, stream: int, rows: int,
                    capacity: int):
    """The select's scratch on ``device`` and ``stream``, allocated once
    and grown on demand: ``reads``, where each call writes the elements of
    x it loaded for each row; and for the two-read route (``capacity`` >
    0) its zeroed per-row records (``rows``; the kernels leave them zeroed
    again) and its candidate buffer (``buf``)."""
    have = _SELECT_SCRATCH.setdefault((device.index, stream), {})
    if have.get("reads") is None or have["reads"].numel() < rows:
        have["reads"] = torch.zeros(rows, dtype=torch.int64, device=device)
    if capacity == 0:
        return have
    words = _ROW_SCRATCH_BYTES // 8
    if have.get("rows") is None or have["rows"].numel() < rows * words:
        have["rows"] = torch.zeros(rows * words, dtype=torch.int64,
                                   device=device)
    if have.get("buf") is None or have["buf"].numel() < rows * capacity:
        have["buf"] = torch.empty(rows * capacity, dtype=torch.int32,
                                  device=device)
    return have


def select_counters(device, rows: int) -> dict:
    """The last select on ``device``'s current stream, per row: ``reads``,
    the elements of x that the kernel loaded (n on the cluster route, 2n on
    the two-read route, 3n when the level-0 digit held more than the
    plan's ``capacity``), and for a two-read select ``seen``, the
    candidates that digit held.  Reads the scratch back, so it
    synchronizes: for checks, not for the selection."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    have = _SELECT_SCRATCH[(device.index, _build.stream_ptr(device))]
    out = {"reads": have["reads"][:rows].tolist()}
    if have.get("rows") is not None:
        words = have["rows"].view(torch.int32).reshape(
            -1, _ROW_SCRATCH_BYTES // 4)
        out["seen"] = words[:rows, 0].tolist()
    return out


@functools.cache
def _select_entries():
    """The select's two C entries, with the library's scratch size checked
    against ``_ROW_SCRATCH_BYTES`` once."""
    ptrs = [ctypes.c_void_p] * 8
    cluster = _build.entry("bin_select", "candidate_select_cluster_f32",
                           ptrs + [ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_int, ctypes.c_void_p])
    two_read = _build.entry("bin_select", "candidate_select_two_read_f32",
                            ptrs + [ctypes.c_void_p] * 2
                            + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_void_p])
    size = _build.entry("bin_select", "candidate_select_scratch_bytes", [],
                        restype=ctypes.c_longlong)
    if size() != _ROW_SCRATCH_BYTES:
        raise RuntimeError(f"bin_select.cu's row scratch is {size()} bytes, "
                           f"hist_select expects {_ROW_SCRATCH_BYTES}")
    return cluster, two_read


def _launch_select(x, scale, b, r):
    cluster_fn, two_read_fn = _select_entries()
    rows, n = x.shape
    v = torch.empty(rows, dtype=torch.float32, device=x.device)
    cnt = torch.empty(rows, dtype=torch.int32, device=x.device)
    total = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0 or n == 0:
        return v.zero_(), cnt.zero_(), total.zero_()
    stream = _build.stream_ptr(x.device)
    for r0, r1 in _row_batches(rows):
        m = r1 - r0
        plan = select_plan(m, n, _sms(x.device))
        s = _select_scratch(x.device, stream, rows, plan.capacity)
        args = (x.data_ptr() + 4 * r0 * n, scale.data_ptr() + 4 * r0,
                b.data_ptr() + 8 * r0, r.data_ptr() + 8 * r0,
                v.data_ptr() + 4 * r0, cnt.data_ptr() + 4 * r0,
                total.data_ptr() + 4 * r0, s["reads"].data_ptr() + 8 * r0)
        if plan.route == "cluster":
            err = cluster_fn(*args, m, n, plan.cluster, stream)
        else:
            err = two_read_fn(*args, s["rows"].data_ptr(),
                              s["buf"].data_ptr(), m, n, plan.ctas_per_row,
                              plan.capacity, stream)
        _build.check("bin_select", err)
        _build.LAUNCHES.record("bin_select", (m, n))
    return v, cnt, total


def candidate_select_batched(x: torch.Tensor, scale: torch.Tensor,
                             b: torch.Tensor, r: torch.Tensor, *,
                             cap: int = DEFAULT_CAP):
    """Exact candidate-bin select over a ``(B, n)`` fp32 matrix: per row,
    ``(v, cnt_in, sum_in)`` for the candidate bin ``b`` and the rank ``r``
    inside it (``(B,)`` int64, from ``locate_bin``), with the row's
    ``scale``.  ``v`` is the ``r``-th largest ``|x|`` of the bin, ``cnt_in``
    and ``sum_in`` count and sum the bin's elements ``>= v`` and ``> 0``.

    On a CUDA tensor it launches ``csrc/bin_select.cu`` on the route
    :func:`select_plan` picks, which has no capacity limit and does not
    synchronize; on a CPU tensor it runs
    :func:`candidate_select_plain`, the only place ``cap`` is read.  A
    launch takes at most 65,535 rows; more rows take successive launches."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, n) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    rows = x.shape[0]
    for name, t, dtype in (("scale", scale, torch.float32),
                           ("b", b, torch.int64), ("r", r, torch.int64)):
        if t.shape != (rows,) or t.dtype != dtype or t.device != x.device:
            raise ValueError(f"{name} must be ({rows},) {dtype} on "
                             f"{x.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    PASSES.record("refine")
    if x.device.type == "cpu":
        return candidate_select_plain(x, scale, b, r, cap=cap)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch_select(x.contiguous(), scale.contiguous(), b.contiguous(),
                          r.contiguous())


def hist_topk_threshold_batched(x: torch.Tensor, k, *, bins: int = NBINS,
                                cap: int = DEFAULT_CAP):
    """Exact per-row k-selection over ``(B, n)``.

    ``k`` is an int shared by every row or a ``(B,)`` per-row vector, on
    the host or (clipped to ``[1, n]``) an integer tensor on the device.
    Returns ``(thresh, count, sum_abs)`` of shape ``(B,)``: ``thresh`` the
    exact k-th largest magnitude, ``count`` the non-zeros at or above it
    (ties kept) and ``sum_abs`` their magnitude mass.

    On the card it is ``max|x|``, the histogram kernel, ``locate_bin`` and
    the select kernel: no ``(B, n)`` temporary, no sort or top-k, and no
    host synchronization.  ``cap`` is read only on the CPU, where it sizes
    the plain select's top-k gather.
    """
    rows, n = x.shape
    kj = _row_ks(k, rows, n, x.device)
    x = x.to(torch.float32)

    PASSES.record("max")                                        # pass 1
    a_max = torch.linalg.vector_norm(x, float("inf"), dim=1)
    # a row of zeros and subnormals is all zeros: scale 0, as the reference
    scale = torch.where(a_max >= FLT_MIN,
                        torch.full_like(a_max, float(bins)) / a_max,
                        torch.zeros_like(a_max))

    cnt, sums = magnitude_histogram_batched(x, scale, bins=bins)  # pass 2
    b, cnt_gt, sum_gt, _ = locate_bin(cnt, sums, kj, bins)
    r = kj - cnt_gt.to(torch.int64)                     # rank inside bin b
    v, cnt_in, sum_in = candidate_select_batched(x, scale, b, r,  # pass 3
                                                 cap=cap)
    return v, cnt_gt + cnt_in, sum_gt + sum_in


def hist_topk_threshold(x_flat: torch.Tensor, k: int, *, bins: int = NBINS,
                        cap: int = DEFAULT_CAP):
    """One row: ``(thresh, count, sum_abs)`` as 0-d tensors, the exact
    k-selection of a flat vector.  :func:`hist_topk_threshold_batched`
    with a row of one."""
    t, cnt, sums = hist_topk_threshold_batched(x_flat.reshape(1, -1), k,
                                               bins=bins, cap=cap)
    return t[0], cnt[0], sums[0]
