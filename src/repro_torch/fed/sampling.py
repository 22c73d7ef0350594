"""Pluggable client samplers: WHO participates, orthogonal to the codec.

The port's numpy copy of the reference's ``fed/sampling.py``: the same
cohorts from the same generator states.

Sampling which clients join a round matters as much as compressing what
they send (Grudzień et al. 2023): a fleet server re-dispatches clients as
buffer slots free up, and the policy it uses shapes both convergence and
fairness under non-IID splits.  This module is the sampler registry --
mirroring ``repro_torch.core.protocols.register_protocol`` -- that the
event-driven trainer (:mod:`repro_torch.fed.events`) consults every time it
refills its in-flight pool.

A sampler sees a :class:`SamplerView` (the server's per-client bookkeeping:
current round, last participation round, in-flight flags) plus the
trainer's own ``numpy`` Generator, and returns a duplicate-free cohort.
``UniformSampler`` draws ``rng.choice(n, size, replace=False)`` -- exactly
the synchronous trainer's selection, which is what keeps the event trainer's
K = cohort configuration bit-identical to :class:`FederatedTrainer`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core import registry as _registry

__all__ = ["SamplerView", "ClientSampler", "UniformSampler",
           "StalenessAwareSampler", "register_sampler", "make_sampler",
           "registered_samplers"]


class SamplerView(NamedTuple):
    """What the server knows per client when it picks the next cohort."""

    round: int              # current aggregation round
    last_seen: np.ndarray   # (n_clients,) round of last dispatch
    inflight: np.ndarray    # (n_clients,) bool: an update is in the air
    # (n_clients,) bool: client has been dispatched at least once.  A
    # zero in ``last_seen`` is ambiguous -- "sampled at round 0" and
    # "never sampled" collide -- so age-aware samplers need this to give
    # never-seen clients maximal weight.  None (legacy callers) falls
    # back to the ambiguous reading.
    seen: Optional[np.ndarray] = None


_REGISTRY: dict[str, type["ClientSampler"]] = {}


def register_sampler(cls=None, *, name: Optional[str] = None):
    """Class decorator adding a sampler to the registry under ``cls.name``."""
    def _register(c):
        key = name or getattr(c, "name", None)
        if not key:
            raise ValueError(f"sampler {c.__name__} needs a `name`")
        _REGISTRY[key] = c
        return c
    return _register(cls) if cls is not None else _register


def registered_samplers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_sampler(sampler, **overrides) -> "ClientSampler":
    """Instantiate a registered sampler by name (loud on unknown names),
    or pass a :class:`ClientSampler` instance through untouched."""
    return _registry.resolve("client sampler", sampler, _REGISTRY,
                             ClientSampler, **overrides)


@dataclasses.dataclass(frozen=True)
class ClientSampler:
    """Base sampler; subclasses override :meth:`select`."""

    name = "base"

    def select(self, rng: np.random.Generator, view: SamplerView,
               cohort: int) -> np.ndarray:
        """A duplicate-free (cohort,) int64 array of client ids."""
        raise NotImplementedError(type(self).__name__)


@register_sampler
@dataclasses.dataclass(frozen=True)
class UniformSampler(ClientSampler):
    """Uniform without replacement -- the synchronous trainer's draw,
    byte-for-byte (same ``rng.choice`` call on the same generator)."""

    name = "uniform"

    def select(self, rng, view, cohort):
        return rng.choice(view.last_seen.size, size=cohort, replace=False)


@register_sampler
@dataclasses.dataclass(frozen=True)
class StalenessAwareSampler(ClientSampler):
    """Prefer clients the server has not heard from recently.

    Selection weight of client ``i`` is ``(1 + round - last_seen_i)^bias``,
    zeroed while an update of theirs is still in flight (no duplicate
    in-flight work) -- unless that would starve the cohort, in which case
    in-flight clients are readmitted at the minimum weight.

    Never-yet-seen clients (``view.seen`` False) get ``age = round + 1`` --
    strictly older than any client sampled at round 0 -- so no client can
    starve behind a zero-initialized ``last_seen``: at bias > 0 an unseen
    client always carries the maximal weight until its first dispatch.
    """

    name = "staleness"
    bias: float = 1.0

    def __post_init__(self):
        if self.bias < 0.0:
            raise ValueError(
                f"StalenessAwareSampler.bias must be >= 0, got {self.bias}")

    def select(self, rng, view, cohort):
        n = view.last_seen.size
        age = (view.round - view.last_seen).astype(np.float64)
        if view.seen is not None:
            age = np.where(np.asarray(view.seen, bool), age,
                           float(view.round) + 1.0)
        w = (1.0 + np.maximum(age, 0.0)) ** self.bias
        free = ~np.asarray(view.inflight, bool)
        if int(free.sum()) >= cohort:
            w = np.where(free, w, 0.0)
        return rng.choice(n, size=cohort, replace=False, p=w / w.sum())
