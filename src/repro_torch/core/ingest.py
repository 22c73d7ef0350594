"""Fused decode→aggregate server ingestion: no dense ``(P, numel)`` block.

The port's numpy copy of ``repro/core/ingest.py``: the accumulator stays
on the host, and its ``sum``, ``weight_mass`` and ``combined()`` are bitwise
the reference's on the same fields and fp64 weights.

The paper's fleet regime (many clients, participation ``1/400`` and below,
Fig. 7) makes the server the bottleneck: a round's uploads decoded into a
dense ``(P, numel)`` batch cost ``P * numel`` floats of peak memory before a
single aggregate FLOP.  This module replaces that block with ONE
``numel``-sized accumulator pair that every arriving wire stream scatters
into directly:

* ``sum``          -- fp64 weighted coordinate sums (the only O(numel) state)
* ``weight_mass``  -- arrived participation-weight total (the denominator of
  the masked/staleness-weighted mean, accumulated in ARRIVAL order)

so peak ingest memory is independent of how many clients report, and decode
fuses with aggregation: the Golomb field decoder
(:func:`repro_torch.core.wire.decode_ternary_fields_batch`) yields
``(segment, position, sign)`` triples that scatter straight into ``sum`` --
the dense per-client tensor never exists.

Bit-exactness contract (property-tested in tests/test_torch_ingest.py): the
fused
wire scatter and the dense decode→``add_dense`` oracle perform THE SAME fp64
products in THE SAME order -- ``(sign * fp32(µ)) -> fp64 * fp64(w)`` per
coordinate, message-major -- and untouched coordinates differ only by adding
``w * (+/-0.0)``, which is a bitwise no-op on an fp64 accumulator.  Both
paths therefore share one ``combined()`` and one codec ``finalize_ingest``,
and agree bit for bit, not just to tolerance.

``weight_mass`` is summed by a sequential scalar loop on the codec side (NOT
``np.sum``, whose pairwise tree would re-order the adds) so arrival-order
identity holds for the denominator too.
"""

from __future__ import annotations

import numpy as np

__all__ = ["IngestAccumulator"]


class IngestAccumulator:
    """Streaming server-side accumulator for one round's uploads.

    O(numel) state; every method is O(touched coordinates).  ``offset``
    arguments let chunked codecs scatter each chunk sub-stream into its flat
    slice of the merged vector (``ChunkSpec.chunk_start``).
    """

    __slots__ = ("numel", "sum", "weight_mass", "n_msgs", "nnz",
                 "stream_bits", "n_screened")

    def __init__(self, numel: int):
        self.numel = int(numel)
        self.sum = np.zeros(self.numel, np.float64)
        self.weight_mass = 0.0
        self.n_msgs = 0
        self.nnz = 0
        self.stream_bits = 0.0
        self.n_screened = 0

    # -- per-message bookkeeping ---------------------------------------------
    def begin_message(self, weight: float, *, bits: float = 0.0) -> None:
        """Account one arrival: its aggregation weight (mask × staleness
        decay, already resolved by the caller) and its measured wire bits."""
        self.n_msgs += 1
        self.weight_mass += float(weight)
        self.stream_bits += float(bits)

    def note_screened(self) -> None:
        """Record one message rejected by a screening aggregation rule
        (``norm_screened_mean`` with ``policy="reject"``): it was counted
        by :meth:`begin_message` with zero weight -- bits billed, zero
        aggregate contribution."""
        self.n_screened += 1

    # -- scatter paths (weight_mass is NOT touched here) ---------------------
    def scatter_ternary(self, positions: np.ndarray, signs: np.ndarray,
                        mu: float, weight: float, *, offset: int = 0) -> None:
        """One message's decoded ternary fields -> weighted coordinate adds.

        ``positions`` are unique within a message, so a plain fancy-index
        ``+=`` is exact (no lost duplicate updates)."""
        if positions.size == 0:
            return
        self.nnz += int(positions.size)
        contrib = (signs * np.float32(mu)).astype(np.float64) \
            * np.float64(weight)
        self.sum[offset + positions] += contrib

    def scatter_ternary_batch(self, seg: np.ndarray, positions: np.ndarray,
                              signs: np.ndarray, mus: np.ndarray,
                              weights: np.ndarray, *,
                              offsets: np.ndarray = None) -> None:
        """A whole batch's fields in ONE scatter; ``offsets`` (one per row,
        e.g. each chunk sub-stream's ``ChunkSpec.chunk_start``) shifts each
        row's positions into its flat slice.

        ``np.add.at`` applies element-order, and the fields are row-major
        in stream order, so this is bitwise the sequential per-row
        :meth:`scatter_ternary` loop."""
        if positions.size == 0:
            return
        self.nnz += int(positions.size)
        mu32 = np.asarray(mus, np.float64).astype(np.float32)
        w64 = np.asarray(weights, np.float64)
        contrib = (signs * mu32[seg]).astype(np.float64) * w64[seg]
        if offsets is not None:
            positions = positions + np.asarray(offsets, np.int64)[seg]
        np.add.at(self.sum, positions, contrib)

    def add_sign_plane(self, bits01: np.ndarray, step: float, weight: float,
                       *, offset: int = 0) -> None:
        """A dense 1-bit sign plane: every coordinate lands ``±step``."""
        n = int(bits01.size)
        if n == 0:
            return
        self.nnz += n
        vals = np.where(bits01 == 1, np.float32(step), np.float32(-step))
        self.sum[offset : offset + n] += vals.astype(np.float64) \
            * np.float64(weight)

    def add_dense(self, vec: np.ndarray, weight: float, *,
                  offset: int = 0) -> None:
        """A decoded dense fp32 message (the oracle path, and the ingest
        route for codecs without a wire format)."""
        v = np.asarray(vec, np.float32)
        self.nnz += int(np.count_nonzero(v))
        self.sum[offset : offset + v.size] += v.astype(np.float64) \
            * np.float64(weight)

    # -- read-out ------------------------------------------------------------
    def combined(self) -> np.ndarray:
        """Weighted mean over arrived mass, fp32.

        The denominator guard matches :meth:`Codec.combine` exactly
        (``total if total > 0 else 1.0``, NOT ``max(total, 1)``), so an
        all-masked round degrades identically on both aggregate paths."""
        total = self.weight_mass
        denom = total if total > 0 else 1.0
        return (self.sum / np.float64(denom)).astype(np.float32)
