"""Registered fleet scenarios: WHEN updates arrive (and whether they do).

The port's numpy copy of the reference's ``fed/scenarios.py``: the same
latencies and loss masks from the same seeds, byte for byte.

:mod:`repro_torch.fed.arrivals` models a stationary fleet -- one lognormal
latency distribution, forever.  Real fleets are nothing like that: load is
diurnal, crowds flash, a region drops off the map for an hour, chronic
stragglers drift slower as their batteries age, and clients themselves give
up on uploads that exceed their personal deadline.  Each scenario here is a
named, seeded generator layered on :class:`LatencyModel`: it turns a
dispatch at simulation time ``t`` into per-client latencies plus a lost
mask (updates that never reach the server -- no bits billed).  The
event-driven trainer (:mod:`repro_torch.fed.events`) and the model-free
simulator drive the same objects.

The registry mirrors ``repro_torch.core.protocols``: ``register_scenario`` /
``make_scenario(name, **overrides)`` / ``registered_scenarios()``.  A
custom scenario is a frozen dataclass subclassing :class:`Scenario` and
overriding any of the three hooks (``latency_scale``, ``loss_prob``,
``client_factors``) or ``client_deadline``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import registry as _registry
from repro_torch.fed.arrivals import LatencyModel

__all__ = ["Scenario", "SteadyScenario", "DiurnalScenario",
           "FlashCrowdScenario", "RegionalOutageScenario",
           "StragglerDriftScenario", "AdaptiveDeadlineScenario",
           "ComposedScenario", "FlashOutageScenario",
           "register_scenario", "make_scenario", "registered_scenarios"]


_REGISTRY: dict[str, type["Scenario"]] = {}


def register_scenario(cls=None, *, name: Optional[str] = None):
    """Class decorator adding a scenario to the registry under ``cls.name``."""
    def _register(c):
        key = name or getattr(c, "name", None)
        if not key:
            raise ValueError(f"scenario {c.__name__} needs a `name`")
        _REGISTRY[key] = c
        return c
    return _register(cls) if cls is not None else _register


def registered_scenarios() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_scenario(scenario, **overrides) -> "Scenario":
    """Instantiate a registered scenario by name (loud on unknown names),
    or pass a :class:`Scenario` instance through untouched."""
    return _registry.resolve("scenario", scenario, _REGISTRY, Scenario,
                             **overrides)


def _hash_frac(ids: np.ndarray) -> np.ndarray:
    """Deterministic per-client uniform in [0, 1) from the client id alone
    (Knuth multiplicative hash) -- membership in a scenario subpopulation
    must not depend on draw order or platform."""
    h = ((np.asarray(ids, np.uint64) * np.uint64(2654435761))
         % np.uint64(1 << 32))
    return h.astype(np.float64) / float(1 << 32)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Base scenario: a stationary fleet (every hook is neutral).

    ``sample(t, client_ids, scales, rng)`` is the one entry point callers
    call: latencies are ``LatencyModel`` draws scaled by the global
    ``latency_scale(t)`` and the per-client ``client_factors(t, ids)``;
    ``lost`` marks updates that never reach the server -- dropped in the
    network with probability ``loss_prob(t, ids)``, or aborted client-side
    when the draw exceeds ``client_deadline(ids, scales)``.
    """

    name = "steady"
    latency: LatencyModel = LatencyModel()

    # -- hooks ---------------------------------------------------------------
    def latency_scale(self, t: float) -> float:
        """Global (fleet-wide) latency multiplier at simulation time t."""
        return 1.0

    def client_factors(self, t: float, ids: np.ndarray) -> np.ndarray:
        """Per-client latency multipliers at time t (drift effects)."""
        return np.ones(np.asarray(ids).size, np.float64)

    def loss_prob(self, t: float, ids: np.ndarray) -> np.ndarray:
        """Per-client probability the update is lost in the network."""
        return np.zeros(np.asarray(ids).size, np.float64)

    def client_deadline(self, ids: np.ndarray,
                        scales: np.ndarray) -> Optional[np.ndarray]:
        """Per-client upload deadline (None = clients never give up)."""
        return None

    # -- caller entry point --------------------------------------------------
    def sample(self, t: float, client_ids, scales: np.ndarray,
               rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        """(latencies, lost) for one cohort dispatched at time ``t``."""
        ids = np.asarray(client_ids, np.int64)
        lats = (self.latency.sample(ids, scales, rng)
                * self.latency_scale(t) * self.client_factors(t, ids))
        lost = np.zeros(ids.size, bool)
        lp = np.asarray(self.loss_prob(t, ids), np.float64)
        if np.any(lp > 0.0):
            lost |= rng.random(ids.size) < lp
        dl = self.client_deadline(ids, scales)
        if dl is not None:
            lost |= lats > np.asarray(dl, np.float64)
        return lats, lost


@register_scenario
@dataclasses.dataclass(frozen=True)
class SteadyScenario(Scenario):
    """Stationary fleet: the arrivals model, unmodulated (the regression
    point -- under it the event trainer's K = cohort config is bit-identical
    to the synchronous trainer)."""

    name = "steady"


@register_scenario
@dataclasses.dataclass(frozen=True)
class DiurnalScenario(Scenario):
    """Diurnal load curve: latency swells smoothly to ``(1 + amp)`` x at
    mid-period (busy hours) and back -- trough at t = 0."""

    name = "diurnal"
    amp: float = 1.0
    period: float = 6.0

    def __post_init__(self):
        if not self.period > 0.0:
            raise ValueError(
                f"DiurnalScenario.period must be > 0, got {self.period}")

    def latency_scale(self, t):
        return 1.0 + self.amp * 0.5 * (1.0 - math.cos(2.0 * math.pi
                                                      * t / self.period))


@register_scenario
@dataclasses.dataclass(frozen=True)
class FlashCrowdScenario(Scenario):
    """Flash crowd: a one-off congestion spike multiplies every latency by
    ``surge`` during ``[start, start + width)``."""

    name = "flash-crowd"
    start: float = 1.0
    width: float = 2.0
    surge: float = 5.0

    def latency_scale(self, t):
        return self.surge if self.start <= t < self.start + self.width else 1.0


@register_scenario
@dataclasses.dataclass(frozen=True)
class RegionalOutageScenario(Scenario):
    """Correlated regional dropouts: clients live in ``regions`` regions
    (``id % regions``); every ``period`` time units one region (rotating)
    loses connectivity for ``width`` units and its dispatched updates are
    lost with probability ``loss`` -- failures are CORRELATED, the exact
    condition iid-dropout models miss."""

    name = "regional-outage"
    regions: int = 4
    period: float = 4.0
    width: float = 2.0
    loss: float = 0.9

    def __post_init__(self):
        if self.regions < 1:
            raise ValueError("RegionalOutageScenario.regions must be >= 1, "
                             f"got {self.regions}")
        if not 0.0 <= self.loss <= 1.0:
            raise ValueError("RegionalOutageScenario.loss must be in [0, 1], "
                             f"got {self.loss}")

    def loss_prob(self, t, ids):
        ids = np.asarray(ids, np.int64)
        cycle = int(t // self.period)
        if t - cycle * self.period >= self.width:    # outage window over
            return np.zeros(ids.size, np.float64)
        down = cycle % self.regions                  # the region that is dark
        return np.where(ids % self.regions == down, self.loss, 0.0)


@register_scenario
@dataclasses.dataclass(frozen=True)
class StragglerDriftScenario(Scenario):
    """Chronic-straggler drift: a fixed ``frac`` of clients (deterministic
    in the client id) slows down linearly with simulation time --
    ``1 + drift * t`` on top of their base latency."""

    name = "straggler-drift"
    frac: float = 0.2
    drift: float = 0.25

    def __post_init__(self):
        if not 0.0 <= self.frac <= 1.0:
            raise ValueError("StragglerDriftScenario.frac must be in [0, 1], "
                             f"got {self.frac}")
        if self.drift < 0.0:
            raise ValueError("StragglerDriftScenario.drift must be >= 0, "
                             f"got {self.drift}")

    def client_factors(self, t, ids):
        slow = _hash_frac(ids) < self.frac
        return np.where(slow, 1.0 + self.drift * max(t, 0.0), 1.0)


@register_scenario
@dataclasses.dataclass(frozen=True)
class AdaptiveDeadlineScenario(Scenario):
    """Per-client adaptive deadlines: every client aborts uploads slower
    than ``factor`` x its OWN typical latency (``scale_i * latency.mean``)
    -- fast clients enforce tight deadlines, slow clients loose ones, so
    the abort rate is roughly uniform across the fleet instead of
    concentrating on stragglers."""

    name = "adaptive-deadline"
    factor: float = 1.3

    def __post_init__(self):
        if not self.factor > 0.0:
            raise ValueError("AdaptiveDeadlineScenario.factor must be > 0, "
                             f"got {self.factor}")

    def client_deadline(self, ids, scales):
        ids = np.asarray(ids, np.int64)
        return self.factor * scales[ids] * self.latency.mean


@dataclasses.dataclass(frozen=True)
class ComposedScenario(Scenario):
    """Combinator overlaying two scenarios' hooks on ONE fleet.

    Latency effects multiply (a flash crowd during busy hours is slower
    than either alone); loss probabilities combine as independent drop
    events (``1 - (1-p_a)(1-p_b)`` -- a literal product would nullify a
    one-sided outage); deadlines take the elementwise minimum (whichever
    constraint binds first aborts the upload).  The composed fleet draws
    latencies from the OUTER ``latency`` model -- the components contribute
    only their modulation hooks, not their base distributions.
    """

    name = "composed"
    a: Scenario = dataclasses.field(default_factory=SteadyScenario)
    b: Scenario = dataclasses.field(default_factory=SteadyScenario)

    def __post_init__(self):
        for side, s in (("a", self.a), ("b", self.b)):
            if not isinstance(s, Scenario):
                raise TypeError(
                    f"ComposedScenario.{side} must be a Scenario, "
                    f"got {type(s).__name__}")

    def latency_scale(self, t):
        return self.a.latency_scale(t) * self.b.latency_scale(t)

    def client_factors(self, t, ids):
        return self.a.client_factors(t, ids) * self.b.client_factors(t, ids)

    def loss_prob(self, t, ids):
        pa = np.asarray(self.a.loss_prob(t, ids), np.float64)
        pb = np.asarray(self.b.loss_prob(t, ids), np.float64)
        return 1.0 - (1.0 - pa) * (1.0 - pb)

    def client_deadline(self, ids, scales):
        da = self.a.client_deadline(ids, scales)
        db = self.b.client_deadline(ids, scales)
        if da is None:
            return db
        if db is None:
            return da
        return np.minimum(np.asarray(da, np.float64),
                          np.asarray(db, np.float64))


@register_scenario
@dataclasses.dataclass(frozen=True)
class FlashOutageScenario(ComposedScenario):
    """A regional outage DURING a flash crowd (the ROADMAP's compound
    case): the surge stretches every latency while one rotating region is
    dark, so stale-but-arrived and lost-forever updates peak together."""

    name = "flash-outage"
    a: Scenario = dataclasses.field(default_factory=FlashCrowdScenario)
    b: Scenario = dataclasses.field(default_factory=RegionalOutageScenario)
