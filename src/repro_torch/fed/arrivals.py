"""Client arrival simulation for deadline-based buffered aggregation.

The port's numpy copy of ``repro/fed/arrivals.py``: the same draws from
the same seeds and the same collect order, byte for byte.

The synchronous trainer assumes every sampled client reports before the
server moves -- exactly the assumption that breaks in the paper's favored
regime (many clients, low participation, §V).  This module simulates the
missing piece: per-client network/compute latency, a server round deadline,
and the buffer that carries late updates into later rounds.

Time model: latencies are abstract time units; the server closes its
aggregation window every ``deadline`` units.  An update dispatched in round
``t`` with sampled latency ``L`` arrives ``floor(L / deadline)`` rounds
later, i.e. staleness ``s = floor(L / deadline)`` (0 = on time).  With
``deadline = inf`` every update is on time and the buffered trainer
reproduces the synchronous one bit for bit.

:class:`LatencyModel` is a lognormal latency distribution with optional
per-client heterogeneity (persistent fast/slow clients) and a chronic
straggler population; :class:`ArrivalSimulator` owns the in-flight buffer.
Payloads are opaque to the simulator -- the trainer hands it already-encoded
client messages and gets them back, tagged with their dispatch round, when
they "reach" the server.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple

import numpy as np

__all__ = ["Arrival", "LatencyModel", "ArrivalSimulator"]


class Arrival(NamedTuple):
    """One client update reaching the server."""

    client: int
    sent_round: int     # round the client was dispatched (staleness = now - this)
    payload: object     # the encoded message (opaque to the simulator)


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """Per-client round-trip latency distribution.

    Latency of client ``i`` is ``scale_i * LogNormal(log(mean), sigma)``
    where ``scale_i`` is a persistent per-client multiplier:
    ``exp(hetero * N(0,1))``, further multiplied by ``straggler_scale`` for a
    ``straggler_frac`` fraction of chronically slow clients.  All defaults
    give a homogeneous fleet that is on time for any ``deadline >= ~1``.
    """

    mean: float = 0.5               # median latency, in deadline time units
    sigma: float = 0.25             # lognormal shape of the per-draw noise
    hetero: float = 0.0             # persistent per-client speed spread
    straggler_frac: float = 0.0     # fraction of chronically slow clients
    straggler_scale: float = 8.0    # their latency multiplier

    def __post_init__(self):
        # typed, field-named errors instead of a math-domain error deep in
        # ``sample`` (log(mean)) or silently nonsensical populations
        if not self.mean > 0.0:
            raise ValueError(f"LatencyModel.mean must be > 0, got {self.mean}")
        if self.sigma < 0.0:
            raise ValueError(
                f"LatencyModel.sigma must be >= 0, got {self.sigma}")
        if self.hetero < 0.0:
            raise ValueError(
                f"LatencyModel.hetero must be >= 0, got {self.hetero}")
        if not 0.0 <= self.straggler_frac <= 1.0:
            raise ValueError("LatencyModel.straggler_frac must be in [0, 1], "
                             f"got {self.straggler_frac}")
        if not self.straggler_scale > 0.0:
            raise ValueError("LatencyModel.straggler_scale must be > 0, "
                             f"got {self.straggler_scale}")

    def client_scales(self, n_clients: int, seed: int = 0) -> np.ndarray:
        """Deterministic persistent per-client latency multipliers."""
        rng = np.random.default_rng(seed)
        scales = np.exp(self.hetero * rng.standard_normal(n_clients))
        if self.straggler_frac > 0.0:
            slow = rng.random(n_clients) < self.straggler_frac
            scales = np.where(slow, scales * self.straggler_scale, scales)
        return scales.astype(np.float64)

    def sample(self, client_ids, scales: np.ndarray,
               rng: np.random.Generator) -> np.ndarray:
        """Latency draws for one dispatched cohort."""
        ids = np.asarray(client_ids, dtype=np.int64)
        noise = rng.lognormal(mean=math.log(self.mean), sigma=self.sigma,
                              size=ids.size)
        return noise * scales[ids]


class ArrivalSimulator:
    """Deadline-bucketed in-flight buffer between clients and the server.

    ``dispatch(round, client_ids, payloads)`` samples each client's latency
    and files its payload under the round in which it will arrive;
    ``collect(round)`` drains everything that has arrived by that round's
    deadline (including updates dispatched the same round, when fast enough).
    Arrivals come back oldest dispatch first, then in dispatch order, so the
    drain is deterministic given the seed.
    """

    def __init__(self, latency: LatencyModel, n_clients: int,
                 deadline: float = math.inf, seed: int = 0) -> None:
        if not deadline > 0.0:
            raise ValueError(f"deadline must be positive, got {deadline}")
        self.latency = latency
        self.deadline = float(deadline)
        self.rng = np.random.default_rng(seed)
        self.scales = latency.client_scales(n_clients, seed=seed + 1)
        self._pending: Dict[int, List[Arrival]] = {}

    def rounds_late(self, latencies: np.ndarray) -> np.ndarray:
        """How many deadlines elapse before each update lands (its staleness).

        ``floor(L / deadline)`` with the quotient snapped to the nearest
        integer when it is within one part in 10^9: a latency that is an
        EXACT multiple of the deadline always buckets as ``L/deadline``
        rounds late, whatever rounding the platform's division produced
        (e.g. ``0.3 / 0.1 == 2.999...96`` must not bucket one round early).
        """
        lat = np.asarray(latencies, dtype=np.float64)
        if math.isinf(self.deadline):
            return np.zeros(lat.shape, dtype=np.int64)
        q = lat / self.deadline
        nearest = np.rint(q)
        q = np.where(np.isclose(q, nearest, rtol=1e-9, atol=1e-12), nearest, q)
        return np.floor(q).astype(np.int64)

    def dispatch(self, rnd: int, client_ids, payloads) -> np.ndarray:
        """File one cohort's payloads; returns the sampled latencies."""
        ids = np.asarray(client_ids, dtype=np.int64)
        if len(payloads) != ids.size:
            raise ValueError(f"{ids.size} clients but {len(payloads)} payloads")
        lats = self.latency.sample(ids, self.scales, self.rng)
        self.dispatch_with_latencies(rnd, ids, payloads, lats)
        return lats

    def dispatch_with_latencies(self, rnd: int, client_ids, payloads,
                                latencies) -> None:
        """File one cohort's payloads under externally sampled latencies.

        This is the hook a scenario library drives (the reference's
        ``fed/scenarios.py``, not ported yet): it samples time-varying
        latencies (and loss masks) itself and files only the surviving
        payloads here, reusing the simulator's deadline bucketing and
        buffer.
        """
        ids = np.asarray(client_ids, dtype=np.int64)
        lats = np.asarray(latencies, dtype=np.float64)
        if not (len(payloads) == ids.size == lats.size):
            raise ValueError(f"{ids.size} clients but {len(payloads)} "
                             f"payloads / {lats.size} latencies")
        late = self.rounds_late(lats)
        for cid, extra, payload in zip(ids, late, payloads):
            self._pending.setdefault(rnd + int(extra), []).append(
                Arrival(int(cid), rnd, payload))

    def collect(self, rnd: int) -> List[Arrival]:
        """Drain every update that arrived by round ``rnd``'s deadline."""
        due = sorted(r for r in self._pending if r <= rnd)
        out: List[Arrival] = []
        for r in due:
            out.extend(self._pending.pop(r))
        out.sort(key=lambda a: a.sent_round)   # oldest first; stable in dispatch order
        return out

    def pending_count(self) -> int:
        """Updates still in flight (the buffer the next rounds will drain)."""
        return sum(len(v) for v in self._pending.values())
