"""Pluggable server-side aggregation rules (the combine estimator).

Counterpart of ``repro/core/aggregation.py``.  Every codec combines its
clients' messages through a registered, frozen-dataclass
:class:`AggregationRule`:

=====================  ==========  =========  =============================
rule                   streaming   screens    estimator
=====================  ==========  =========  =============================
``mean``               yes         no         weighted mean (the default)
``norm_screened_mean`` yes         yes        weighted mean after a norm
                                              clip / reject screen
``coordinate_median``  no          no         coordinate-wise weighted
                                              median
``trimmed_mean``       no          no         coordinate-wise beta-trimmed
                                              weighted mean
=====================  ==========  =========  =============================

Weighted semantics: each message row carries the weight
``Codec.participation_weights(mask, staleness)`` gives it, and a rule must
be invariant to permuting (row, weight) pairs together and to inserting
rows of zero weight.

Every tensor stays on the messages' device.  The order-statistic rules are
a stable sort of the ``(clients, numel)`` block along the client axis, a
gather of the weights and a cumulative weight mass.  The sort keys are the
messages with ``-0.0`` made ``+0.0``, so that ties fall in input order on
every device, as the reference's sort compares zeros; the gathered values
keep their sign.  The cumulative mass and the trimmed mean's column sum
are explicit fp32 adds in the order of the reference's CPU lowering (rows
in order; the mass in tiles of 16 rows, each tile's total carried into the
next), as are the mean's sums, so a combine of up to 32 rows is bitwise the
reference's and the same on the card and the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple

import torch

from . import registry as _registry

__all__ = ["AggregationRule", "MeanRule", "NormScreenedMeanRule",
           "CoordinateMedianRule", "TrimmedMeanRule", "register_rule",
           "make_rule", "get_rule_class", "registered_rules"]

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


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """The sum over the leading (client) axis, one fp32 add at a time from
    ``+0.0``: XLA's order on the CPU for up to 32 rows (a single row is
    returned as it is, as XLA does)."""
    if x.shape[0] == 1:
        return x[0].clone()
    acc = torch.zeros_like(x[0])
    for row in x:
        acc = acc + row
    return acc


@dataclasses.dataclass(frozen=True)
class AggregationRule:
    """Base class: a frozen combine estimator.

    Subclasses implement :meth:`combine_weighted`; screening rules
    additionally override :meth:`screen` (batched, used by ``combine``)
    and :meth:`screen_weight` (its per-message host twin, used by the
    streaming ingest path).
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

    def screen_weight(self, norm: float) -> Tuple[float, bool]:
        """Host-side per-message twin of :meth:`screen` for the streaming
        ingest path: maps a message's L2 norm to ``(weight_scale,
        rejected)``."""
        return 1.0, False

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
            # times the fp32 reciprocal of the row count, as XLA computes a
            # mean on the CPU
            one = torch.ones((), dtype=msgs.dtype, device=msgs.device)
            recip = one / torch.full_like(one, msgs.shape[0])
            return _sum_rows(msgs) * recip
        # the weight mass and the weighted rows summed in arrival order, one
        # fp32 add at a time, as XLA reduces a cohort-sized axis (torch.sum's
        # vectorized order moves the last bit)
        total = _sum_rows(weights)
        denom = torch.where(total > 0, total, torch.ones_like(total))
        wb = weights.reshape((msgs.shape[0],) + (1,) * (msgs.ndim - 1))
        return _sum_rows(msgs * wb) / denom


@register_rule
@dataclasses.dataclass(frozen=True)
class NormScreenedMeanRule(MeanRule):
    """The norm clip / reject screen, as a rule: ``clip`` rescales any
    message with L2 norm above ``bound`` onto the ball (weight unchanged),
    ``reject`` zeroes its weight."""

    name: ClassVar[str] = "norm_screened_mean"
    screens: ClassVar[bool] = True

    bound: float = 1.0
    policy: str = "clip"

    def __post_init__(self):
        if self.policy not in ("clip", "reject"):
            raise ValueError(
                f"policy must be 'clip' or 'reject', got {self.policy!r}")
        if not self.bound > 0.0:
            raise ValueError(f"bound must be positive, got {self.bound!r}")

    def screen(self, msgs, weights):
        flat = msgs.reshape(msgs.shape[0], -1)
        norms = torch.sqrt((flat * flat).sum(dim=1))
        bound = torch.tensor(self.bound, dtype=torch.float32,
                             device=msgs.device)
        if self.policy == "clip":
            scale = torch.clamp(bound / torch.clamp(norms, min=1e-30),
                                max=1.0)
            shape = (msgs.shape[0],) + (1,) * (msgs.ndim - 1)
            return msgs * scale.reshape(shape), weights
        keep = (norms <= bound).to(torch.float32)
        if weights is None:
            return msgs, keep
        return msgs, torch.as_tensor(weights, dtype=torch.float32,
                                     device=keep.device) * keep

    def screen_weight(self, norm: float) -> Tuple[float, bool]:
        if norm <= self.bound or norm <= 0.0:
            return 1.0, False
        if self.policy == "clip":
            return float(self.bound) / float(norm), False
        return 0.0, True


_CUMSUM_TILE = 16


def _cumsum_rows(ws: torch.Tensor) -> torch.Tensor:
    """Inclusive fp32 cumulative sum over the rows, one add at a time: up
    to 16 rows in order; past that, tiles of 16 rows each summed in order,
    plus the cumulative sum (the same scheme) of the tiles' totals before
    it."""
    P = ws.shape[0]
    if P <= _CUMSUM_TILE:
        out = [ws[0]]
        for i in range(1, P):
            out.append(out[-1] + ws[i])
        return torch.stack(out)
    T = -(-P // _CUMSUM_TILE)
    tiles = ws.new_zeros((T * _CUMSUM_TILE,) + ws.shape[1:])
    tiles[:P] = ws
    tiles = tiles.reshape((T, _CUMSUM_TILE) + ws.shape[1:])
    inner = torch.stack([_cumsum_rows(t) for t in tiles])
    before = _cumsum_rows(inner[:, -1])
    carry = torch.cat([torch.zeros_like(before[:1]), before[:-1]])
    return (inner + carry[:, None]).reshape((T * _CUMSUM_TILE,)
                                            + ws.shape[1:])[:P]


def _sorted_with_cumweights(msgs, weights):
    """Common prefix of the order-statistic rules: per-coordinate stable
    sort of the (clients, numel) block with the weight rows carried along,
    plus inclusive cumulative weights."""
    flat = msgs.reshape(msgs.shape[0], -1)
    if weights is None:
        weights = torch.ones(msgs.shape[0], dtype=flat.dtype,
                             device=flat.device)
    w = torch.as_tensor(weights, dtype=flat.dtype,
                        device=flat.device)[:, None].expand(flat.shape)
    # +0.0 turns -0.0 into +0.0: zeros tie, whatever the device's sort
    _, order = torch.sort(flat + 0.0, dim=0, stable=True)
    xs = torch.gather(flat, 0, order)
    ws = torch.gather(w, 0, order)
    return xs, ws, _cumsum_rows(ws)


def _first_true(cond: torch.Tensor) -> torch.Tensor:
    """Per column, the index of the first True row (0 when none)."""
    return cond.to(torch.int32).argmax(dim=0)


@register_rule
@dataclasses.dataclass(frozen=True)
class CoordinateMedianRule(AggregationRule):
    """Coordinate-wise weighted median (Yin et al. 2018): per coordinate,
    the midpoint of the lower and upper weighted medians.  Rows of zero
    weight are never selected."""

    name: ClassVar[str] = "coordinate_median"

    def combine_weighted(self, msgs, weights):
        xs, ws, cw = _sorted_with_cumweights(msgs, weights)
        total = cw[-1]
        half = 0.5 * total
        lo = _first_true(cw >= half[None])
        above = cw[-1][None] - cw + ws      # mass at or above each position
        hi = (xs.shape[0] - 1) - _first_true(
            torch.flip(above >= half[None], dims=[0]))
        med = 0.5 * (torch.gather(xs, 0, lo[None].long())[0]
                     + torch.gather(xs, 0, hi[None].long())[0])
        med = torch.where(total > 0, med, torch.zeros_like(med))
        return med.reshape(msgs.shape[1:])


@register_rule
@dataclasses.dataclass(frozen=True)
class TrimmedMeanRule(AggregationRule):
    """Coordinate-wise beta-trimmed weighted mean (Yin et al. 2018): per
    coordinate, drop the smallest and largest ``beta`` fractions of the
    weight mass and average what remains."""

    name: ClassVar[str] = "trimmed_mean"

    beta: float = 0.1

    def __post_init__(self):
        if not 0.0 <= self.beta < 0.5:
            raise ValueError(
                f"beta must lie in [0, 0.5), got {self.beta!r}")

    def combine_weighted(self, msgs, weights):
        xs, ws, cw = _sorted_with_cumweights(msgs, weights)
        total = cw[-1]
        lo = self.beta * total
        hi = (1.0 - self.beta) * total
        # each sorted entry's weight inside the [lo, hi] mass window
        eff = (torch.minimum(torch.maximum(cw, lo[None]), hi[None])
               - torch.minimum(torch.maximum(cw - ws, lo[None]), hi[None]))
        span = hi - lo
        denom = torch.where(span > 0, span, torch.ones_like(span))
        out = _sum_rows(xs * eff) / denom
        out = torch.where(total > 0, out, torch.zeros_like(out))
        return out.reshape(msgs.shape[1:])
