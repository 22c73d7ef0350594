"""Building blocks of histogram k-selection, shared by the kernels and core.

Counterpart of ``repro/core/selection.py``:

* ``bin_index`` / ``locate_bin`` -- the 256-bin linear magnitude binning and
  the cumulative-sum bin/rank search of the histogram selector.  The binning
  is ``(a * scale)`` in fp32 truncated toward zero to int32, then clipped; it
  MUST stay bit-identical to the reference and to the CUDA histogram kernel
  (``__float2int_rz(a * scale)``: one fp32 multiply, no fused add).
* ``flush_subnormal`` -- an fp32 value below ``FLT_MIN`` in magnitude as
  the zero of its sign: what XLA on the CPU and the TPU do to the inputs and
  outputs of fp32 arithmetic and comparisons, and so what the reference's
  operators compute.  The plain versions flush their inputs with it; the
  CUDA kernels flush the same values in the same places.
* ``PASSES`` -- streaming-pass counter: every logical full sweep over the
  data records itself here.

The reference's ``resolve_interpret`` has no counterpart: a wrapper here
picks its kernel or its plain version from the tensor's device.
"""

from __future__ import annotations

import torch

__all__ = ["NBINS", "DEFAULT_CAP", "FLT_MIN", "flush_subnormal", "bin_index",
           "locate_bin", "PASSES", "PassCounter"]

NBINS = 256         # histogram bins
DEFAULT_CAP = 8192  # refinement-gather capacity (candidate bin size)
FLT_MIN = torch.finfo(torch.float32).tiny   # 2^-126, the least normal fp32


def flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal value (``0 < |x| < FLT_MIN``) replaced by
    the zero of its sign, as flush-to-zero hardware does."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def bin_index(a: torch.Tensor, scale: torch.Tensor, bins: int) -> torch.Tensor:
    """Linear magnitude binning; bit-identical to the reference's
    ``jnp.clip((a * scale).astype(int32), 0, bins - 1)``, whose product
    flushes a subnormal ``a`` to 0."""
    return torch.clamp((flush_subnormal(a) * scale).to(torch.int32), 0,
                       bins - 1)


def locate_bin(cnt: torch.Tensor, sums: torch.Tensor, k: torch.Tensor,
               bins: int):
    """Candidate bin + above-bin partials from ``(B, bins)`` histograms.

    ``k`` is a ``(B,)`` integer tensor.  Returns ``(b, cnt_gt, sum_gt,
    cnt_b)`` per row: ``b`` the largest bin with at least ``k`` elements at
    or above it, ``cnt_gt`` / ``sum_gt`` the count and magnitude mass of the
    bins above ``b``, and ``cnt_b`` the population of bin ``b``.
    """
    rc = torch.flip(torch.cumsum(torch.flip(cnt, (1,)), 1, dtype=torch.int32),
                    (1,))                                  # rc[j] = #{bin >= j}
    rs = torch.flip(torch.cumsum(torch.flip(sums, (1,)), 1), (1,))
    iota = torch.arange(bins, dtype=torch.int64, device=cnt.device)
    b = torch.where(rc >= k[:, None].to(rc.dtype), iota,
                    torch.full_like(iota, -1)).amax(dim=1)
    pad_c = torch.zeros((cnt.shape[0], 1), dtype=rc.dtype, device=cnt.device)
    pad_s = torch.zeros((cnt.shape[0], 1), dtype=rs.dtype, device=cnt.device)
    above = torch.clamp(b + 1, 0, bins)[:, None]
    cnt_gt = torch.cat([rc, pad_c], 1).gather(1, above)[:, 0]
    sum_gt = torch.cat([rs, pad_s], 1).gather(1, above)[:, 0]
    cnt_b = cnt.gather(1, torch.clamp(b, 0, bins - 1)[:, None])[:, 0]
    return b, cnt_gt, sum_gt, cnt_b


class PassCounter:
    """Counts logical streaming passes over the full input vector."""

    def __init__(self):
        self.counts: dict[str, int] = {}

    def reset(self) -> None:
        self.counts.clear()

    def record(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def total(self) -> int:
        return sum(self.counts.values())


PASSES = PassCounter()
