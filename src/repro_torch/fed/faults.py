"""Registered fault models: WHAT goes wrong with updates (and the server).

The port's numpy copy of the reference's ``fed/faults.py``: the same
decisions and the same rewritten or corrupted payloads from the same seeds.
Payloads are host objects (numpy arrays and wire messages), as in the
reference.

:mod:`repro_torch.fed.scenarios` models when updates arrive; this module models
what arrives -- and whether the processes at either end survive.  Each fault
model is a named, seeded generator of per-dispatch failures layered on top
of any scenario: bit flips in the Golomb word stream, payload truncation,
duplicate delivery, stale replay of an earlier dispatch, client crashes
mid-dispatch, and a server kill at a chosen event index.  The event loop
(:mod:`repro_torch.fed.events`) applies the faults at dispatch time and defends
against them at admission time (quarantine on :class:`WireDecodeError`,
duplicate/replay rejection keyed on ``(client, dispatch_version)``).

Byzantine valid-update adversaries (:class:`SignFlipFault`,
:class:`ScaleAttackFault`, :class:`CollusionFault`) are the complement:
their payloads pass every admission check BY CONSTRUCTION, so the only
defense is a robust aggregation rule
(:mod:`repro_torch.core.aggregation`).

Determinism contract: every fault decision for the dispatch with global
sequence number ``dseq`` is drawn from ``rng(dseq)`` -- a counter-based
generator keyed on ``(salt, model seed, dseq)`` alone.  Faults therefore
never consume the event loop's latency RNG (a no-fault run is bit-identical
to a run with ``faults=None``), need no stream state in checkpoints, and any
scenario x fault combination replays exactly from the seeds.

The registry mirrors ``repro_torch.fed.scenarios``: ``register_fault`` /
``make_fault(name, **overrides)`` / ``registered_faults()``.  A custom fault
is a frozen dataclass subclassing :class:`FaultModel` and overriding any of
the per-dispatch hooks (``crash`` / ``corrupt`` / ``duplicate`` /
``replay``) or the per-event ``kill_check``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core import registry as _registry
from repro_torch.core.wire import ChunkedWireMessage, WireMessage
from repro_torch.fed.scenarios import _hash_frac

__all__ = ["FaultModel", "NoFault", "BitFlipFault", "TruncateFault",
           "DuplicateFault", "ReplayFault", "ClientCrashFault",
           "ServerKillFault", "ServerKilled", "CorruptPayload",
           "ByzantineFault", "SignFlipFault", "ScaleAttackFault",
           "CollusionFault",
           "register_fault", "make_fault", "registered_faults"]


class ServerKilled(RuntimeError):
    """The fault model killed the server process at a chosen event index.

    Raised by :class:`ServerKillFault` BEFORE the event is served, so a
    checkpoint written at the previous event boundary is consistent; catch
    it, restore from the checkpoint and continue (see
    ``EventDrivenTrainer.restore_checkpoint``).
    """


class CorruptPayload(NamedTuple):
    """Marker wrapping a payload corrupted past structural recognition.

    Used for opaque payloads (the model-free simulator's ``None``
    placeholders, or message types the byte-level corruptors do not
    understand) so admission control still sees -- and quarantines -- a
    deterministic corruption event.
    """

    original: object


_REGISTRY: dict[str, type["FaultModel"]] = {}

# Mixed into every per-dispatch generator key so fault draws can never
# collide with any other seeded stream in the repo.
_FAULT_SALT = 0x5EEDFA17


def register_fault(cls=None, *, name: Optional[str] = None):
    """Class decorator adding a fault model to the registry under
    ``cls.name``."""
    def _register(c):
        key = name or getattr(c, "name", None)
        if not key:
            raise ValueError(f"fault model {c.__name__} needs a `name`")
        _REGISTRY[key] = c
        return c
    return _register(cls) if cls is not None else _register


def registered_faults() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def make_fault(fault, **overrides) -> "FaultModel":
    """Instantiate a registered fault model by name (loud on unknowns),
    or pass a :class:`FaultModel` instance through untouched."""
    return _registry.resolve("fault model", fault, _REGISTRY, FaultModel,
                             **overrides)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Base fault model: nothing ever goes wrong (every hook is neutral).

    The event loop calls :meth:`rng` once per dispatched message and feeds
    the SAME generator through the per-dispatch hooks in a fixed order
    (``crash`` -> ``byzantine`` -> ``corrupt`` -> ``duplicate`` ->
    ``replay``), so each model's failure pattern is a pure function of
    ``(seed, dseq)``.  ``kill_check(n_served)`` runs once per served event
    on the trainer side.
    """

    name = "none"
    seed: int = 0

    def rng(self, dseq: int) -> np.random.Generator:
        """The counter-based generator owning dispatch ``dseq``'s draws."""
        return np.random.default_rng((_FAULT_SALT, self.seed, int(dseq)))

    # -- per-dispatch hooks --------------------------------------------------
    def crash(self, rng: np.random.Generator) -> bool:
        """True: the client dies mid-dispatch; the update never arrives."""
        return False

    def byzantine(self, payload, client: int, rng: np.random.Generator):
        """Adversarial VALID-update rewrite: a Byzantine client replaces its
        honest payload with a poisoned one that still passes every admission
        check (``validate_wire``, size, finiteness) by construction -- only
        the aggregation rule can defend.  Runs before :meth:`corrupt` (the
        adversary crafts the bytes; transit may then mangle them like any
        honest message).  The base model consumes NO rng draws here, so
        adding the hook left every existing fault trace bit-identical."""
        return payload

    def corrupt(self, payload, rng: np.random.Generator):
        """Return the payload as delivered (possibly mangled in transit)."""
        return payload

    def duplicate(self, rng: np.random.Generator) -> bool:
        """True: the network delivers a second copy of this dispatch."""
        return False

    def replay(self, rng: np.random.Generator) -> bool:
        """True: a stale copy of the client's PREVIOUS dispatch is
        re-delivered alongside this one."""
        return False

    # -- per-event hook (server side) ----------------------------------------
    def kill_check(self, n_served: int) -> None:
        """Raise :class:`ServerKilled` to kill the server before serving
        event index ``n_served``."""


@register_fault
@dataclasses.dataclass(frozen=True)
class NoFault(FaultModel):
    """The explicit no-op entry: chaos sweeps use it as their baseline row."""

    name = "none"


def _corrupt_opaque(payload) -> CorruptPayload:
    return (payload if isinstance(payload, CorruptPayload)
            else CorruptPayload(payload))


@register_fault
@dataclasses.dataclass(frozen=True)
class BitFlipFault(FaultModel):
    """Random bit flips inside the packed word stream (memory/link errors).

    With probability ``prob`` per dispatch, ``n_bits`` uniformly chosen bits
    of the message's uint32 words are XOR-flipped.  Flips that land in a
    coded field typically break the Golomb parse (quarantined at admission);
    flips in the word padding or that yield another VALID stream are
    semantically undetectable without checksums -- the quarantine rate under
    this fault is therefore below the injection rate by construction.  Dense
    ndarray payloads are poisoned with NaNs instead (caught by the trainer's
    finiteness screen); opaque payloads get the :class:`CorruptPayload`
    marker.
    """

    name = "bit-flip"
    prob: float = 0.3
    n_bits: int = 4

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(
                f"BitFlipFault.prob must be in [0, 1], got {self.prob}")
        if self.n_bits < 1:
            raise ValueError(
                f"BitFlipFault.n_bits must be >= 1, got {self.n_bits}")

    def corrupt(self, payload, rng):
        if rng.random() >= self.prob:
            return payload
        if isinstance(payload, WireMessage):
            words = np.asarray(payload.words)
            if words.size == 0:
                # nothing to flip: advertise bits the empty buffer cannot
                # hold (the _check_bit_len class of corruption)
                return payload._replace(bit_len=int(payload.bit_len) + 8)
            w = words.copy()
            idx = rng.integers(0, w.size, self.n_bits)
            bit = rng.integers(0, 32, self.n_bits).astype(np.uint32)
            np.bitwise_xor.at(w, idx, np.uint32(1) << bit)
            return payload._replace(words=w)
        if isinstance(payload, np.ndarray):
            v = np.array(payload, copy=True)
            idx = rng.integers(0, max(v.size, 1), self.n_bits)
            v.reshape(-1)[idx[idx < v.size]] = np.nan
            return v
        return _corrupt_opaque(payload)


@register_fault
@dataclasses.dataclass(frozen=True)
class TruncateFault(FaultModel):
    """Payload truncation: the tail of the word buffer is cut in transit
    while the advertised ``bit_len`` still claims the full stream -- the
    classic partial-read corruption.  Always structurally detectable
    (``bit_len`` overruns the delivered words), so every truncated payload
    quarantines."""

    name = "truncate"
    prob: float = 0.3

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(
                f"TruncateFault.prob must be in [0, 1], got {self.prob}")

    def corrupt(self, payload, rng):
        if rng.random() >= self.prob:
            return payload
        if isinstance(payload, WireMessage):
            if payload.bit_len == 0:
                return payload          # nothing on the wire to cut
            words = np.asarray(payload.words)
            return payload._replace(words=words[: words.size // 2].copy())
        if isinstance(payload, np.ndarray):
            flat = np.asarray(payload).reshape(-1)
            return np.array(flat[: max(flat.size // 2, 1)], copy=True)
        return _corrupt_opaque(payload)


@register_fault
@dataclasses.dataclass(frozen=True)
class DuplicateFault(FaultModel):
    """Duplicate delivery: with probability ``prob`` the network delivers a
    second, later copy of the same dispatch.  Admission control must reject
    the second copy (same ``(client, dispatch_version)`` key) while still
    billing its upstream bits."""

    name = "duplicate"
    prob: float = 0.3

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(
                f"DuplicateFault.prob must be in [0, 1], got {self.prob}")

    def duplicate(self, rng):
        return bool(rng.random() < self.prob)


@register_fault
@dataclasses.dataclass(frozen=True)
class ReplayFault(FaultModel):
    """Stale replay: with probability ``prob`` a copy of the client's
    PREVIOUS dispatch (older payload, older model version) is re-delivered.
    If the original already arrived, the replay is a duplicate by key; if
    the original was lost, the replay carries genuinely stale data and runs
    the normal staleness screen."""

    name = "replay"
    prob: float = 0.3

    def replay(self, rng):
        return bool(rng.random() < self.prob)

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(
                f"ReplayFault.prob must be in [0, 1], got {self.prob}")


@register_fault
@dataclasses.dataclass(frozen=True)
class ClientCrashFault(FaultModel):
    """Client crash mid-dispatch: the local step ran (client state advanced,
    battery drained) but the upload never happens -- indistinguishable from
    network loss at the server, billed zero bits."""

    name = "client-crash"
    prob: float = 0.3

    def __post_init__(self):
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(
                f"ClientCrashFault.prob must be in [0, 1], got {self.prob}")

    def crash(self, rng):
        return bool(rng.random() < self.prob)


@register_fault
@dataclasses.dataclass(frozen=True)
class ServerKillFault(FaultModel):
    """Kill the server before serving event index ``at_event`` (0-based
    count of served events).  The trainer raises :class:`ServerKilled` at
    that boundary; resume from the last checkpoint with ``faults="none"``
    (or a later ``at_event``) and the run continues bit-identically."""

    name = "server-kill"
    at_event: int = 40

    def __post_init__(self):
        if self.at_event < 0:
            raise ValueError(
                f"ServerKillFault.at_event must be >= 0, got {self.at_event}")

    def kill_check(self, n_served):
        if n_served >= self.at_event:
            raise ServerKilled(
                f"server killed before event {n_served} "
                f"(at_event={self.at_event})")


# ---------------------------------------------------------------------------
# Byzantine valid-update adversaries: payloads the admission pipeline CANNOT
# catch (they parse, size-check and finite-check like honest updates); only
# the aggregation rule (repro_torch.core.aggregation) defends.
# ---------------------------------------------------------------------------


def _rewrite_valid(payload, factor: float):
    """Multiply an update payload by ``factor`` while keeping it VALID for
    every admission check -- the shared mechanics of the Byzantine models.

    Dense ndarrays scale directly.  A ternary wire stream (STC / chunked
    STC) scales through its µ header(s): the Golomb position words are
    untouched, so the stream still parses, and the decoder multiplies every
    surviving coordinate by the poisoned µ.  A dense sign plane (signSGD,
    ``bit_len == numel``) carries no magnitude at all: a negative factor
    inverts every sign bit (the strongest rewrite the format admits), a
    positive one is a no-op -- majority-vote formats are scale-immune by
    construction.  Opaque payloads (the model-free simulator's ``None``
    placeholders) pass through untouched: there is nothing semantic to
    poison, and wrapping them would trip quarantine, which a Byzantine
    client never does."""
    if isinstance(payload, np.ndarray):
        return np.asarray(payload, np.float32) * np.float32(factor)
    if isinstance(payload, WireMessage):
        if int(payload.bit_len) == int(payload.numel):   # dense sign plane
            if factor >= 0:
                return payload
            return payload._replace(
                words=np.bitwise_not(np.asarray(payload.words)))
        return payload._replace(mu=float(payload.mu) * float(factor))
    if isinstance(payload, ChunkedWireMessage):
        b = payload.batch
        flipped = tuple(sb._replace(mu=np.asarray(sb.mu, np.float64)
                                    * float(factor))
                        for sb in b.batches)
        return ChunkedWireMessage(b._replace(batches=flipped))
    return payload


@dataclasses.dataclass(frozen=True)
class ByzantineFault(FaultModel):
    """Base for valid-update adversaries: a deterministic ``fraction`` of
    the client population is Byzantine, membership hashed from the client
    id alone (the same Knuth-hash trick as the scenario subpopulations), so
    WHO is compromised is stable across dispatches, draw order and
    platforms -- a colluding cohort, not independent coin flips.  Every
    dispatch from a compromised client is rewritten via :meth:`attack`.
    Not registered itself: subclasses define the attack."""

    fraction: float = 0.2

    def __post_init__(self):
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(
                f"{type(self).__name__}.fraction must be in [0, 1], "
                f"got {self.fraction}")

    def is_byzantine(self, client: int) -> bool:
        return bool(_hash_frac(np.asarray([client]))[0] < self.fraction)

    def byzantine(self, payload, client, rng):
        if not self.is_byzantine(client):
            return payload
        return self.attack(payload, client, rng)

    def attack(self, payload, client: int, rng: np.random.Generator):
        raise NotImplementedError(type(self).__name__)


@register_fault
@dataclasses.dataclass(frozen=True)
class SignFlipFault(ByzantineFault):
    """Gradient-reversal attack: compromised clients send ``-scale`` times
    their honest update.  With ``scale=1`` the payload norm is exactly
    honest (no norm screen can see it); larger scales amplify the damage
    but become norm-screenable -- the classic robustness trade-off."""

    name = "sign-flip"
    scale: float = 1.0

    def attack(self, payload, client, rng):
        return _rewrite_valid(payload, -self.scale)


@register_fault
@dataclasses.dataclass(frozen=True)
class ScaleAttackFault(ByzantineFault):
    """Overscaling attack: compromised clients send ``factor`` times their
    honest update -- right direction, poisoned step size.  The cheapest
    attack to mount and the one ``norm_screened_mean`` exists to stop."""

    name = "scale-attack"
    factor: float = 100.0

    def attack(self, payload, client, rng):
        return _rewrite_valid(payload, self.factor)


@register_fault
@dataclasses.dataclass(frozen=True)
class CollusionFault(ByzantineFault):
    """Colluding cohort: every compromised client sends ``scale`` times its
    honest norm along ONE common poisoned direction (seeded from the model
    seed, NOT the dispatch counter -- all colluders push the same way, which
    is what defeats per-message norm screening at ``scale=1`` and shifts a
    mean by the full colluding weight mass).  Wire-format payloads cannot
    carry an arbitrary direction without re-encoding through the codec, so
    there the colluders fall back to the coordinated amplified sign-flip of
    their own updates (documented approximation; the dense event path
    mounts the full attack)."""

    name = "collusion"
    scale: float = 1.0

    def attack(self, payload, client, rng):
        if isinstance(payload, np.ndarray):
            v = np.asarray(payload, np.float32).reshape(-1)
            d = _collusion_direction(self.seed, v.size)
            out = (np.float32(self.scale)
                   * np.float32(np.linalg.norm(v))) * d
            return out.reshape(np.shape(payload))
        return _rewrite_valid(payload, -self.scale)


@functools.lru_cache(maxsize=8)
def _collusion_direction(seed: int, numel: int) -> np.ndarray:
    """The colluders' common unit direction -- a pure function of the model
    seed and payload size (cached: one draw per fleet, not per dispatch)."""
    g = np.random.default_rng((_FAULT_SALT ^ 0xC0111DE, seed, numel))
    d = g.standard_normal(numel)
    n = np.linalg.norm(d)
    return (d / (n if n > 0 else 1.0)).astype(np.float32)
