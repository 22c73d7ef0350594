"""Fused STC apply (mask -> ternarize -> error feedback), batched over rows.

Counterpart of ``repro/kernels/stc_compress.py``.  On a CUDA tensor the
wrapper launches ``csrc/stc_apply.cu``; on a CPU tensor it runs
:func:`stc_apply_plain`, which is also the oracle the kernel is held to
(bitwise, given the same ``(t, µ)``).

The mask is ``|c| >= t & |c| > 0``: exact zeros are never selected, as in
the reference's ``"jnp"`` backend and Algorithm 1 (the reference's Pallas
path counts zeros at ``t = 0``; see ROADMAP Queue 3, R1).  Subnormal values
count as zeros, as the reference computes them: ``t``, ``µ`` and the
residual as the zero of their sign (``flush_subnormal``), and a carried
value as +0, which is the reference's flushed carried sum of a subnormal
delta and a +0 residual (the carried sum here is not flushed; R5).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.selection import FLT_MIN, PASSES, flush_subnormal
from . import _build

__all__ = ["stc_apply_batched", "stc_apply_plain"]


def stc_apply_plain(carried: torch.Tensor, thresh: torch.Tensor,
                    mu: torch.Tensor):
    """Plain PyTorch version: ``(tern, carried - tern)`` per row."""
    c = torch.where((carried != 0) & (carried.abs() < FLT_MIN), 0.0,
                    carried)
    a = c.abs()
    keep = (a >= flush_subnormal(thresh)[:, None]) & (a > 0.0)
    tern = torch.where(keep, flush_subnormal(mu)[:, None] * torch.sign(c),
                       torch.zeros((), dtype=c.dtype, device=c.device))
    return tern, flush_subnormal(c - tern)


_MAX_ROWS = 65535                # the grid's y extent: rows a launch


def _launch(carried, thresh, mu):
    fn = _build.entry("stc_apply", "stc_apply_f32",
                      [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_void_p])
    rows, n = carried.shape
    tern = torch.empty_like(carried)
    res = torch.empty_like(carried)
    stream = _build.stream_ptr(carried.device)
    for r0 in range(0, rows, _MAX_ROWS):
        m = min(_MAX_ROWS, rows - r0)
        err = fn(carried.data_ptr() + 4 * r0 * n, thresh.data_ptr() + 4 * r0,
                 mu.data_ptr() + 4 * r0, tern.data_ptr() + 4 * r0 * n,
                 res.data_ptr() + 4 * r0 * n, m, n, stream)
        _build.check("stc_apply", err)
        _build.LAUNCHES.record("stc_apply", (m, n))
    return tern, res


def stc_apply_batched(carried: torch.Tensor, thresh: torch.Tensor,
                      mu: torch.Tensor):
    """Fused apply over a ``(B, n)`` fp32 carried matrix with per-row
    ``(B,)`` threshold and magnitude.  Returns ``(tern, new_residual)``.
    On the card a launch takes at most 65,535 rows; more rows take
    successive launches."""
    if carried.ndim != 2 or carried.dtype != torch.float32:
        raise ValueError(f"carried must be (B, n) float32, got "
                         f"{tuple(carried.shape)} {carried.dtype}")
    rows = carried.shape[0]
    for name, v in (("thresh", thresh), ("mu", mu)):
        if v.shape != (rows,) or v.dtype != torch.float32 \
                or v.device != carried.device:
            raise ValueError(f"{name} must be ({rows},) float32 on "
                             f"{carried.device}, got {tuple(v.shape)} "
                             f"{v.dtype} on {v.device}")
    PASSES.record("stc_apply")
    if carried.device.type == "cpu":
        return stc_apply_plain(carried, thresh, mu)
    if carried.device.type != "cuda":
        raise ValueError(f"unsupported device {carried.device}")
    return _launch(carried.contiguous(), thresh.contiguous(),
                   mu.contiguous())
