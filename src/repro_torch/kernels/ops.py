"""STC with error feedback, composed from the k-selection and the fused
apply kernel.

Counterpart of ``repro/kernels/ops.py``:

    1. exact k-selection (``k = max(int(n·p), 1)``): by histogram
       (``selector="hist"``, the default) or by threshold bisection
       (``selector="bisect"``, ``iters + 1`` logical stats passes in one
       launch on the card)
    2. ``µ = Σ|carried at or above t| / max(count, 1)``
    3. fused ternarize + error feedback over the carried vector

The kernels and their plain versions treat subnormal values as zeros, as
the reference does.  The carried sum ``delta + residual`` is one torch add
that does not flush its operands (ROADMAP Queue 3, R5): flushing them would
cost two more passes over the batch.

:func:`stc_compress_rows` is the one composition of steps 1-3 over the
rows of a carried matrix, with a k per row given on the host or as an
integer tensor on the device (the adaptive controllers' ks, clipped where
they lie and never read back).  :func:`stc_compress_batch` compresses a
round's ``(P, n)`` client updates through it with one shared k -- the flat
trainer's route -- and the chunked codec's ``(layer, chunk)`` blocks go
through it with their per-row ks: one histogram, one ``bin_select`` and one
apply launch either way.  It keeps the histogram route, as in the
reference.
"""

from __future__ import annotations

import torch

from ..core.selection import DEFAULT_CAP
from .hist_select import hist_topk_threshold_batched
from .stc_compress import stc_apply_batched
from .topk_threshold import topk_threshold

__all__ = ["stc_compress_rows", "stc_compress_batch", "stc_compress_kernel"]


def stc_compress_rows(carried: torch.Tensor, ks, *, k_cap=None,
                      cap: int = DEFAULT_CAP):
    """STC over the rows of a ``(B, n)`` carried matrix with a k per row.

    ``ks`` is an int shared by every row, ``(B,)`` ks on the host, or an
    integer tensor of ks, which needs the static ceiling ``k_cap`` and is
    clipped into ``[1, min(k_cap, n)]`` on its device.  Returns ``(tern,
    new_residual, mu, thresh, nnz)``: ``(B, n)`` tensors and ``(B,)``
    statistics.
    """
    if carried.ndim != 2:
        raise ValueError(f"carried must be (B, n), got "
                         f"{tuple(carried.shape)}")
    carried = carried.to(torch.float32)
    if isinstance(ks, torch.Tensor):
        if k_cap is None:
            raise ValueError(
                "per-row ks computed as a tensor (adaptive controller) "
                "require a static k_cap bound; pass k_cap=int(caps.max())")
        k_cap = min(int(k_cap), carried.shape[1])
        if k_cap < 1:
            raise ValueError(f"k_cap must be >= 1, got {k_cap}")
        ks = torch.clamp(ks.to(device=carried.device, dtype=torch.int64)
                         .reshape(-1), 1, k_cap)
    thresh, cnt, s = hist_topk_threshold_batched(carried, ks, cap=cap)
    mu = s / torch.clamp(cnt, min=1).to(torch.float32)
    tern, new_res = stc_apply_batched(carried, thresh, mu)
    return tern, new_res, mu, thresh, cnt


def stc_compress_batch(deltas: torch.Tensor, residuals: torch.Tensor,
                       p: float, *, cap: int = DEFAULT_CAP):
    """Batched STC over ``(B, n)`` updates and residuals, one k
    (``max(int(n·p), 1)``) for every row.

    Returns ``(tern, new_residual, mu, thresh, nnz)``: ``(B, n)`` tensors
    and ``(B,)`` statistics.
    """
    if deltas.shape != residuals.shape or deltas.ndim != 2:
        raise ValueError(f"deltas {tuple(deltas.shape)} and residuals "
                         f"{tuple(residuals.shape)} must be equal (B, n)")
    k = max(int(deltas.shape[1] * p), 1)
    carried = deltas.to(torch.float32) + residuals.to(torch.float32)
    return stc_compress_rows(carried, k, cap=cap)


def stc_compress_kernel(delta: torch.Tensor, residual: torch.Tensor,
                        p: float, *, selector: str = "hist", iters: int = 32,
                        cap: int = DEFAULT_CAP):
    """Single-vector form.  ``selector="hist"`` is a row batch of one;
    ``"bisect"`` selects by :func:`.topk_threshold.topk_threshold`."""
    if selector == "hist":
        tern, res, mu, thresh, cnt = stc_compress_batch(
            delta.reshape(1, -1), residual.reshape(1, -1), p, cap=cap)
        return tern[0], res[0], mu[0], thresh[0], cnt[0]
    if selector != "bisect":
        raise ValueError(f"unknown selector {selector!r}")
    carried = (delta.to(torch.float32) + residual.to(torch.float32)) \
        .reshape(-1)
    k = max(int(carried.numel() * p), 1)
    thresh, cnt, s = topk_threshold(carried, k, iters=iters)
    mu = s / torch.clamp(cnt, min=1).to(torch.float32)
    tern, new_res = stc_apply_batched(carried[None], thresh[None], mu[None])
    return tern[0], new_res[0], mu, thresh, cnt
