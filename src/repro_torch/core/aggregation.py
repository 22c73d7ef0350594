"""Pluggable server-side aggregation rules (the combine estimator).

Counterpart of ``repro/core/aggregation.py``.  Every codec combines its
clients' messages through a registered, frozen-dataclass
:class:`AggregationRule`.  This slice ports the base class and the default
``mean`` rule (the participation-weighted mean); the robust rules
(norm-screened mean, coordinate median, trimmed mean) are still to port.

Weighted semantics: each message row carries the weight
``Codec.participation_weights(mask, staleness)`` gives it, and a rule must
be invariant to permuting (row, weight) pairs together and to inserting
rows of zero weight.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import torch

from . import registry as _registry

__all__ = ["AggregationRule", "MeanRule", "register_rule", "make_rule",
           "get_rule_class", "registered_rules"]

_REGISTRY: dict = {}


def register_rule(cls=None, *, name: Optional[str] = None,
                  override: bool = False):
    """Class decorator adding an :class:`AggregationRule` to the registry."""

    def _register(cls):
        key = name or cls.name
        if not key:
            raise ValueError(f"rule class {cls.__name__} has no name")
        if key in _REGISTRY and not override:
            raise ValueError(f"aggregation rule {key!r} already registered")
        _REGISTRY[key] = cls
        return cls

    return _register(cls) if cls is not None else _register


def get_rule_class(name: str) -> type:
    return _registry.lookup("aggregation rule", name, _REGISTRY)


def make_rule(rule, **overrides) -> "AggregationRule":
    """Resolve a registered name (plus field overrides) or pass an
    :class:`AggregationRule` instance through untouched."""
    return _registry.resolve("aggregation rule", rule, _REGISTRY,
                             AggregationRule, **overrides)


def registered_rules() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@dataclasses.dataclass(frozen=True)
class AggregationRule:
    """Base class: a frozen combine estimator.

    Subclasses implement :meth:`combine_weighted`; screening rules
    additionally override :meth:`screen`.
    """

    name: ClassVar[str] = ""
    #: the rule factors into a running per-message accumulation
    supports_streaming: ClassVar[bool] = False
    #: the rule screens individual messages before combining
    screens: ClassVar[bool] = False

    def screen(self, msgs, weights):
        """Batched pre-combine screen: ``(msgs, weights) -> (msgs,
        weights)``.  The base rule screens nothing."""
        return msgs, weights

    def combine_weighted(self, msgs: torch.Tensor, weights):
        """Combine clients-first stacked ``msgs`` under per-row ``weights``
        (``None``: every row fully present, no staleness)."""
        raise NotImplementedError

    def combine(self, msgs, weights=None):
        """Screen, then combine."""
        msgs, weights = self.screen(msgs, weights)
        return self.combine_weighted(msgs, weights)


@register_rule
@dataclasses.dataclass(frozen=True)
class MeanRule(AggregationRule):
    """The participation-weighted mean, the registry default."""

    name: ClassVar[str] = "mean"
    supports_streaming: ClassVar[bool] = True

    def combine_weighted(self, msgs, weights):
        if weights is None:
            return msgs.mean(dim=0)
        # the weight mass summed in arrival order, one fp32 add at a time,
        # as XLA reduces a cohort-sized vector (torch.sum's vectorized
        # order moves its last bit, and the mean's with it)
        total = weights.new_zeros(())
        for w in weights:
            total = total + w
        denom = torch.where(total > 0, total, torch.ones_like(total))
        wb = weights.reshape((msgs.shape[0],) + (1,) * (msgs.ndim - 1))
        return (msgs * wb).sum(dim=0) / denom
