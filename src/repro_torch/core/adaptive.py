"""Adaptive per-chunk sparsity controllers (accuracy-per-bit Pareto).

Counterpart of ``repro/core/adaptive.py``.  The static ``p_fn`` schedule of
:func:`repro_torch.core.chunking.chunk_codec` fixes each (layer, chunk)'s
sparsity for the whole run; a controller sets each chunk's k from the
per-chunk statistics of the round's carried update instead, in the spirit
of CFedAvg's SNR-constant compressors (Yang et al. 2021), with the
residual-mass budget allocator as the simpler stateless sibling.

A :class:`SparsityController` is a frozen dataclass with three hooks:

* ``caps(base_ks, valid)`` -- static per-chunk selection ceilings, computed
  on the host.  They bound the dynamic k (the selection's ``k_cap``) and so
  the measured wire bits.
* ``init_state(base_ks, device)`` -- the controller's state tensor (None
  for stateless controllers).  Stateful controllers live inside the
  codec's client and server states (``{"base": codec_state, "ctrl":
  state}``), so the trainers gather and scatter them with the rest.
* ``chunk_ks(carried, state, base_ks=, caps=)`` -- the policy: observe the
  ``(R, n_chunks, chunk_numel)`` carried blocks (update + residual,
  zero-padded past each chunk's valid length) and return ``((R, n_chunks)
  int32 per-row k, new_state)``, ks clipped to ``[1, caps]``.  Everything
  is computed on the carried tensor's device; nothing is read back to the
  host.

The controllers reduce their per-chunk energies in fp64 and round them to
fp32 once, so the card and the CPU compute the same ks and the same EMA
state (a torch fp32 sum's order differs between the two, and from XLA's);
against the reference's fp32 sums a k can move by one only where a
product lands within its last ulps of an integer or of ``f * total``.

Registered controllers::

    fixed          -- the static p_fn path (a no-op marker)
    residual_mass  -- k per chunk proportional to its share of residual
                      l2 mass, under ``budget`` x the fixed-p k budget
    snr_constant   -- holds each chunk's selected-vs-discarded energy ratio
                      at ``snr`` through an EMA over rounds (stateful)

Hyphens and underscores are interchangeable in names ("residual-mass" ==
"residual_mass").
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch

from .registry import resolve
from .selection import flush_subnormal

__all__ = [
    "SparsityController",
    "FixedController",
    "ResidualMassController",
    "SnrConstantController",
    "register_controller",
    "make_controller",
    "registered_controllers",
    "validate_sparsity",
]


def validate_sparsity(p, layer: str, depth) -> float:
    """Guard a schedule- or controller-produced sparsity: finite and in
    (0, 1].  Raises a ValueError naming the (layer, chunk), so a bad
    ``p_fn`` fails at wrap time instead of yielding k=0 selections or
    full-dense chunks with a wrong bit ledger."""
    try:
        pf = float(p)
    except (TypeError, ValueError):
        raise ValueError(
            f"sparsity schedule returned non-numeric p={p!r} for layer "
            f"{layer!r} (depth {depth}); p must be a float in (0, 1]")
    if not math.isfinite(pf) or not 0.0 < pf <= 1.0:
        raise ValueError(
            f"sparsity schedule returned invalid p={pf!r} for layer "
            f"{layer!r} (depth {depth}); p must be finite and in (0, 1]")
    return pf


def _on_device(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A small host array as a tensor on ``device``: an asynchronous copy
    from pinned memory on the card, so the round does not synchronize."""
    host = torch.from_numpy(np.ascontiguousarray(values)).to(dtype)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def _energy(carried: torch.Tensor) -> torch.Tensor:
    """``carried²`` in fp32 as XLA computes it: subnormal operands and
    squares flushed to zero."""
    c = flush_subnormal(carried.to(torch.float32))
    return flush_subnormal(c * c)


@dataclasses.dataclass(frozen=True)
class SparsityController:
    """Base class: a per-chunk k policy evaluated inside the round.

    Subclass, set ``name``, and register with :func:`register_controller`.
    ``adapts=False`` marks controllers that are pure markers for the static
    path (the chunked codec then runs the fixed-k path unchanged);
    ``stateful=True`` makes the codec carry ``init_state``'s tensor in its
    states and thread it through ``chunk_ks``.
    """

    name: ClassVar[str] = ""
    adapts: ClassVar[bool] = True
    stateful: ClassVar[bool] = False

    #: dynamic k may exceed the fixed-p k by at most this factor (per
    #: chunk, always capped by the chunk's unpadded length).  Bounds both
    #: the selection's k_cap and the worst-case wire bits.
    k_max_scale: float = 4.0

    def __post_init__(self):
        if not (isinstance(self.k_max_scale, (int, float))
                and math.isfinite(self.k_max_scale)
                and self.k_max_scale >= 1.0):
            raise ValueError(
                f"{type(self).__name__}: k_max_scale must be finite and "
                f">= 1, got {self.k_max_scale!r}")

    # -- static geometry (host side) -------------------------------------
    def caps(self, base_ks: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Per-chunk ceiling on the dynamic k (static int64 numpy)."""
        base_ks = np.asarray(base_ks, np.int64)
        valid = np.asarray(valid, np.int64)
        hi = np.ceil(base_ks.astype(np.float64) * float(self.k_max_scale))
        return np.minimum(np.maximum(hi.astype(np.int64), base_ks), valid)

    def init_state(self, base_ks: np.ndarray, device=None):
        """Controller state for one client / the server (None when
        stateless)."""
        return None

    # -- the policy --------------------------------------------------------
    def chunk_ks(self, carried, state, *, base_ks, caps):
        """``(R, C, W)`` carried blocks -> ``((R, C) int32 ks, new_state)``.

        ``state`` is ``init_state``'s tensor (with a leading axis matching
        R for client states), or None for stateless controllers."""
        raise NotImplementedError(type(self).__name__)


CONTROLLERS: dict = {}


def register_controller(cls):
    """Class decorator: add a controller to the registry under its name."""
    CONTROLLERS[cls.name] = cls
    return cls


def registered_controllers() -> tuple:
    return tuple(sorted(CONTROLLERS))


def make_controller(controller, **overrides) -> SparsityController:
    """Resolve a registered name ("fixed", "residual-mass", ...) or pass an
    instance through (:func:`repro_torch.core.registry.resolve`)."""
    if isinstance(controller, str):
        controller = controller.replace("-", "_")
    return resolve("sparsity controller", controller, CONTROLLERS,
                   SparsityController, **overrides)


# ---------------------------------------------------------------------------
# the registered family
# ---------------------------------------------------------------------------


@register_controller
@dataclasses.dataclass(frozen=True)
class FixedController(SparsityController):
    """The static schedule, as a registered no-op marker: the chunked codec
    routes ``controller="fixed"`` through exactly the static fixed-k path
    (the same parameters, ledgers and wire log)."""

    name: ClassVar[str] = "fixed"
    adapts: ClassVar[bool] = False

    def caps(self, base_ks, valid):
        return np.asarray(base_ks, np.int64)

    def chunk_ks(self, carried, state, *, base_ks, caps):
        ks = _on_device(np.asarray(base_ks), torch.int32, carried.device)
        return ks[None].expand(carried.shape[0], len(base_ks)), state


@register_controller
@dataclasses.dataclass(frozen=True)
class ResidualMassController(SparsityController):
    """Budgeted proportional allocation: chunk c gets
    ``k_c = floor(B * mass_c / sum(mass))`` with ``B = budget * sum(fixed-p
    ks)``, so coordinates go where the error-feedback mass is, at a total
    bit budget ``budget`` x the fixed-p schedule's.  Stateless."""

    name: ClassVar[str] = "residual_mass"

    #: total-k budget as a fraction of the fixed-p schedule's sum(ks);
    #: budget < 1 spends strictly fewer coordinates (and so bits) per round
    budget: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        if not (isinstance(self.budget, (int, float))
                and math.isfinite(self.budget) and self.budget > 0.0):
            raise ValueError(
                f"residual_mass: budget must be finite and > 0, got "
                f"{self.budget!r}")

    def chunk_ks(self, carried, state, *, base_ks, caps):
        mass = _energy(carried).sum(dim=-1, dtype=torch.float64) \
            .to(torch.float32)                                  # (R, C)
        total = mass.sum(dim=-1, keepdim=True, dtype=torch.float64) \
            .to(torch.float32)
        frac = flush_subnormal(mass / torch.clamp(total, min=1e-30))
        B = float(self.budget) * float(np.asarray(base_ks, np.int64).sum())
        ks = torch.floor(frac * B).to(torch.int32)
        cap = _on_device(np.asarray(caps), torch.int32, carried.device)
        return torch.clamp(ks, min=1).minimum(cap[None]), state


@register_controller
@dataclasses.dataclass(frozen=True)
class SnrConstantController(SparsityController):
    """CFedAvg-style SNR-constant sparsification: per chunk, the smallest k
    whose selected energy reaches the fraction ``f = snr / (1 + snr)`` of
    the carried energy (selected-vs-discarded ratio ``snr``), smoothed by
    an EMA over rounds so one noisy update cannot blow the budget.  The EMA
    state lives in the codec's states (per client upstream, the server's
    downstream); with ``state=None`` the instantaneous k is used."""

    name: ClassVar[str] = "snr_constant"
    stateful: ClassVar[bool] = True

    #: target selected/discarded energy ratio (higher = denser messages)
    snr: float = 3.0
    #: EMA retention of the running per-chunk k estimate
    ema: float = 0.5

    def __post_init__(self):
        super().__post_init__()
        if not (isinstance(self.snr, (int, float))
                and math.isfinite(self.snr) and self.snr > 0.0):
            raise ValueError(
                f"snr_constant: snr must be finite and > 0, got "
                f"{self.snr!r}")
        if not (isinstance(self.ema, (int, float))
                and math.isfinite(self.ema) and 0.0 <= self.ema < 1.0):
            raise ValueError(
                f"snr_constant: ema must be in [0, 1), got {self.ema!r}")

    def init_state(self, base_ks, device=None):
        # the running k estimate starts at the fixed-p schedule
        return torch.as_tensor(np.asarray(base_ks), dtype=torch.float32,
                               device=device)

    def chunk_ks(self, carried, state, *, base_ks, caps):
        R, C, W = carried.shape
        a2 = _energy(carried).reshape(R * C, W)
        kcap = min(int(np.asarray(caps, np.int64).max()), W)
        top = torch.topk(a2, kcap, dim=1).values
        cum = torch.cumsum(top, dim=1, dtype=torch.float64).to(torch.float32)
        tot = a2.sum(dim=1, keepdim=True, dtype=torch.float64) \
            .to(torch.float32)
        f = float(self.snr) / (1.0 + float(self.snr))
        # smallest k with cum[k-1] >= f * tot (k = kcap when never reached)
        k_inst = 1 + (cum < flush_subnormal(tot * f)).sum(dim=1,
                                                          dtype=torch.int32)
        k_inst = torch.clamp(k_inst, max=kcap).reshape(R, C) \
            .to(torch.float32)
        if state is None:
            new_state, k_est = None, k_inst
        else:
            upd = k_inst
            if state.ndim == 1:          # server state: (C,), carried (1,C,W)
                upd = k_inst.mean(dim=0)
            new_state = (state * float(self.ema)
                         + upd * (1.0 - float(self.ema)))
            k_est = (new_state if new_state.ndim == 2
                     else new_state[None]).expand(R, C)
        cap = _on_device(np.asarray(caps), torch.int32, carried.device)
        ks = torch.round(k_est).to(torch.int32)
        return torch.clamp(ks, min=1).minimum(cap[None]), new_state
