"""Server-side partial-sum cache for partial client participation (Sec. V-B).

The port's numpy copy of ``repro/core/caching.py``, byte-identical in behaviour.

The server keeps the last ``τ`` compressed global updates
``{ΔW~^(T-1), ..., ΔW~^(T-τ)}`` and their partial sums
``P^(s) = Σ_{t=1..s} ΔW~^(T-t)``.  A client that skipped ``s`` rounds
downloads ``P^(s)`` (one message) instead of replaying ``s`` updates; a client
that skipped more than ``τ`` rounds downloads the full model ``W^(T)``.

Entropy bound (Eq. 13): H(P^(τ)) <= τ·H(ΔW~), i.e. download size grows at most
linearly in the number of skipped rounds -- we account bits accordingly.
"""

from __future__ import annotations

import collections
from typing import Deque, Optional

import numpy as np

__all__ = ["UpdateCache"]


class UpdateCache:
    """Host-side ring buffer of global updates + lazily materialized partials.

    ``partial_sum`` answers from a cached cumulative sum over the stacked
    ring buffer (one vectorized ``np.add.accumulate``, no Python
    accumulation loop), grown lazily to the deepest staleness actually
    queried -- so a cohort of repeated queries costs O(1) each, and memory
    stays bounded by the worst staleness seen, not ``max_rounds``.
    """

    def __init__(self, numel: int, max_rounds: int = 32) -> None:
        self.numel = numel
        self.max_rounds = max_rounds
        self._updates: Deque[np.ndarray] = collections.deque(maxlen=max_rounds)
        self._cum: Optional[np.ndarray] = None   # (depth, numel) prefix sums
        self.round = 0

    def push(self, update: np.ndarray) -> None:
        self._updates.appendleft(np.asarray(update, dtype=np.float32).reshape(-1))
        self._cum = None                          # invalidate prefix cache
        self.round += 1

    def _prefix_sums(self, depth: int) -> np.ndarray:
        """(>= depth, numel) rows with row s-1 = P^(s), newest update first."""
        have = 0 if self._cum is None else self._cum.shape[0]
        if have < depth:
            extra = np.stack([self._updates[t] for t in range(have, depth)])
            np.add.accumulate(extra, axis=0, out=extra)
            if have:
                extra += self._cum[-1]
                self._cum = np.concatenate([self._cum, extra])
            else:
                self._cum = extra
        return self._cum

    def partial_sum(self, skipped: int) -> Optional[np.ndarray]:
        """P^(s): the sum of the last ``skipped`` updates, or None if too stale."""
        if skipped == 0:
            return np.zeros(self.numel, dtype=np.float32)
        if skipped > len(self._updates):
            return None  # caller must download the full model
        return self._prefix_sums(skipped)[skipped - 1].copy()

    def sync_bits(self, skipped: int, bits_per_update: float, model_bits: float) -> float:
        """Download cost for a client that skipped ``skipped`` rounds (Eq. 13).

        ``bits_per_update`` may be the analytic expectation OR the measured
        wire size of this round's update (see ``Codec.measured_download_bits``)
        -- the Eq. 13 bound H(P^(s)) <= s*H(ΔW~) is applied either way.
        """
        if skipped > len(self._updates):
            return model_bits
        # The partial sum of s sparse updates has at most s-times the nnz;
        # H(P^(s)) <= s * H(ΔW~) is attained in the worst case (disjoint masks).
        return max(1, skipped) * bits_per_update

    def sync_bits_batch(self, skipped, bits_per_update: float,
                        model_bits: float) -> float:
        """Total download cost for a cohort: vectorized ``sync_bits`` over an
        integer array of per-client skipped-round counts."""
        skipped = np.asarray(skipped, dtype=np.int64)
        per_client = np.where(
            skipped > len(self._updates), model_bits,
            np.maximum(skipped, 1).astype(np.float64) * bits_per_update)
        return float(per_client.sum())
