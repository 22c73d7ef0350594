"""Pluggable communication codecs for federated optimization (paper Table I).

Counterpart of ``repro/core/protocols.py``.  Every protocol is a
:class:`Codec`: a frozen dataclass holding the protocol's hyperparameters
and implementing a small interface that the federated trainer
(:mod:`repro_torch.fed.loop`) calls and nothing else:

* ``init_client_state(numel, device)`` / ``init_server_state(numel,
  device)`` -- per-client / server codec state (``None`` when stateless);
  the trainer stacks client states along a leading ``(n_clients,)`` axis.
* ``encode_batch(deltas, states)`` -- client-side compression of a whole
  ``(P, numel)`` round; returns ``(msgs, states, stats)``.
* ``aggregate(msgs, server_state, mask=None, staleness=None)`` -- the
  combine through the codec's :class:`~repro_torch.core.aggregation.
  AggregationRule`, then downstream compression.
* ``upload_bits`` / ``download_bits`` -- the analytic bit ledger (Eq. 1).
* ``encode_wire`` / ``encode_wire_batch`` and ``measured_*`` -- the real
  bitstream (host-side, :mod:`repro_torch.core.wire`): codecs with
  ``wire_format = True`` get exact measured bits in the trainer's ledger.
  A message that is a tensor is packed by the wire backend on the tensor's
  device.

This slice ports the base class and :class:`StcCodec`; the other paper
codecs (baseline, fedavg, signsgd, topk, ternquant) are still to port.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch

from . import golomb, wire
from .aggregation import AggregationRule, make_rule
from .compression import CompressionStats, get_stc_backend
from .registry import lookup as _registry_lookup, resolve as _registry_resolve
from .residual import ResidualState, init_residual, map_states, take_states

__all__ = ["Codec", "make_protocol", "register_protocol",
           "registered_protocols", "get_protocol_class", "StcCodec"]

_REGISTRY: dict[str, type["Codec"]] = {}


def register_protocol(cls=None, *, name: Optional[str] = None,
                      override: bool = False):
    """Register a :class:`Codec` subclass under ``name`` (default:
    ``cls.name``).  Re-registering a name with a different class raises
    unless ``override=True``."""

    def _register(c):
        key = name if name is not None else getattr(c, "name", None)
        if not key:
            raise ValueError(f"codec {c!r} needs a `name` class attribute")
        prior = _REGISTRY.get(key)
        if prior is not None and prior is not c and not override:
            raise ValueError(
                f"protocol {key!r} is already registered to {prior.__name__}; "
                f"pass register_protocol(..., override=True) to replace it")
        _REGISTRY[key] = c
        return c

    return _register(cls) if cls is not None else _register


def registered_protocols() -> tuple[str, ...]:
    """Names of every registered codec (sorted)."""
    return tuple(sorted(_REGISTRY))


def get_protocol_class(name: str) -> type["Codec"]:
    return _registry_lookup("protocol", name, _REGISTRY)


def make_protocol(name, **overrides) -> "Codec":
    """Factory with the paper's default hyperparameters (Section VI).
    Accepts a registered name (plus field overrides) or an already-built
    :class:`Codec` instance, which passes through untouched."""
    return _registry_resolve("protocol", name, _REGISTRY, Codec, **overrides)


def _host(x) -> np.ndarray:
    """A message as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _device_of(x):
    """Where the wire backend packs a message: the tensor's device, or the
    default (CUDA) for a host array."""
    return x.device if isinstance(x, torch.Tensor) else None


@dataclasses.dataclass(frozen=True)
class Codec:
    """A compression protocol with explicit state."""

    name: ClassVar[str] = ""
    error_feedback: ClassVar[bool] = False

    local_iters: int = 1                    # n (communication delay period)
    # staleness-weighted combining: an update s rounds old enters the
    # weighted mean with weight (1+s)^-decay
    staleness_decay: float = 0.5
    # the server-side combine estimator: a registered AggregationRule name
    # or instance; None -> "mean"
    rule: Optional[AggregationRule] = None

    def __post_init__(self):
        object.__setattr__(
            self, "rule", make_rule(self.rule if self.rule is not None
                                    else "mean"))

    # -- state ------------------------------------------------------------
    def init_client_state(self, numel: int, device=None):
        """One client's codec state (None = stateless)."""
        return None

    def init_server_state(self, numel: int, device=None):
        return None

    # -- client side (upstream) --------------------------------------------
    def encode(self, delta: torch.Tensor, state):
        """Compress ONE flat client update. Returns (msg, new_state, stats)."""
        raise NotImplementedError(type(self).__name__)

    def encode_batch(self, deltas: torch.Tensor, states):
        """Compress a whole (P, numel) round. Returns (msgs, states, stats),
        every output carrying the leading client axis.  The default loops
        :meth:`encode` over the rows."""
        msgs, states, stats = zip(*(
            self.encode(deltas[i], take_states(states, i))
            for i in range(deltas.shape[0])))
        return (torch.stack(msgs),
                map_states(lambda *xs: torch.stack(xs), *states),
                CompressionStats(*(torch.stack(s) for s in zip(*stats))))

    # -- server side (aggregation + downstream) -----------------------------
    def participation_weights(self, mask, staleness=None) -> torch.Tensor:
        """Per-message combining weights ``w_i = mask_i * (1+s_i)^-decay``;
        with ``staleness`` None or zero the weights are exactly the mask."""
        w = torch.as_tensor(mask, dtype=torch.float32)
        if staleness is not None:
            s = torch.as_tensor(staleness, dtype=torch.float32,
                                device=w.device)
            w = w * (1.0 + s) ** (-self.staleness_decay)
        return w

    def combine(self, msgs: torch.Tensor, mask=None, staleness=None):
        """Combine (P, ...) messages over the client axis through the
        codec's rule: the rule's screen runs on the raw mask, then the rule
        combines under ``participation_weights``."""
        msgs, mask = self.rule.screen(msgs, mask)
        if mask is None and staleness is None:
            return self.rule.combine_weighted(msgs, None)
        if mask is None:
            mask = torch.ones(msgs.shape[0], dtype=torch.float32,
                              device=msgs.device)
        w = self.participation_weights(mask, staleness).to(msgs.device)
        return self.rule.combine_weighted(msgs, w)

    def aggregate(self, msgs: torch.Tensor, server_state, mask=None,
                  staleness=None):
        """Aggregate (P, numel) messages. Returns (global_delta, state,
        stats)."""
        mean = self.combine(msgs, mask, staleness)
        stats = CompressionStats(nnz=torch.tensor(mean.numel()),
                                 numel=torch.tensor(mean.numel()),
                                 mu=torch.tensor(0.0))
        return mean, server_state, stats

    # -- bit ledger ----------------------------------------------------------
    def upload_bits(self, numel: int) -> float:
        raise NotImplementedError(type(self).__name__)

    def download_bits(self, numel: int, n_participating: int = 1) -> float:
        raise NotImplementedError(type(self).__name__)

    # -- wire format (host-side measured ledger) -----------------------------
    wire_format: ClassVar[bool] = False
    wire_header_bits: ClassVar[float] = 0.0
    # True when the wire size is statically known (measured == analytic)
    wire_static_size: ClassVar[bool] = False

    def encode_wire(self, msg, *, direction: str = "up") -> wire.WireMessage:
        """Serialize ONE already-compressed message to its wire bitstream."""
        raise NotImplementedError(
            f"{type(self).__name__} has no wire format")

    def encode_wire_batch(self, msgs, *,
                          direction: str = "up") -> wire.WireBatch:
        """Serialize a stacked (P, numel) round of messages."""
        return wire.concat_messages([
            self.encode_wire(m, direction=direction) for m in msgs])

    def measured_batch_bits(self, batch: wire.WireBatch) -> float:
        """Total size of an already-encoded batch (stream + headers)."""
        return batch.total_bits() + batch.n_msgs * self.wire_header_bits

    def measured_message_bits(self, msg: wire.WireMessage) -> float:
        """Total size of ONE already-encoded message (stream + header)."""
        return msg.bit_len + self.wire_header_bits

    def measured_upload_bits(self, msgs) -> float:
        """EXACT upstream bits for a (P, numel) stack of compressed client
        messages; the analytic model for wire-less codecs."""
        if not self.wire_format:
            return msgs.shape[0] * self.upload_bits(msgs.shape[-1])
        return self.measured_batch_bits(
            self.encode_wire_batch(msgs, direction="up"))

    def measured_download_bits(self, msg, n_participating: int = 1) -> float:
        """EXACT bits of ONE downstream (global update) message."""
        if not self.wire_format:
            return self.download_bits(int(np.prod(msg.shape)),
                                      n_participating=n_participating)
        return self.measured_message_bits(self.encode_wire(msg,
                                                           direction="down"))

    def wire_bound_bits(self, numel: int, nnz: int,
                        direction: str = "up") -> Optional[float]:
        """Deterministic per-message ceiling on the measured size (stream
        plus header bits; None = no bound known)."""
        return None


class _ErrorFeedbackMixin:
    error_feedback: ClassVar[bool] = True

    def init_client_state(self, numel: int, device=None) -> ResidualState:
        return init_residual(numel, device)


@register_protocol
@dataclasses.dataclass(frozen=True)
class StcCodec(_ErrorFeedbackMixin, Codec):
    """The paper's contribution: bidirectional sparse ternary compression +
    error feedback + Golomb-coded messages."""

    name: ClassVar[str] = "stc"

    sparsity_up: float = 1 / 400
    sparsity_down: float = 1 / 400
    backend: str = "kernel"                 # STC impl: "kernel" | "torch"
    wire_backend: str = "numpy"             # wire packer: "numpy" | "kernel"

    wire_format: ClassVar[bool] = True      # Golomb position stream (Alg. 3)
    wire_header_bits: ClassVar[float] = 32.0  # fp32 µ per message (Eq. 15)

    def init_server_state(self, numel: int, device=None) -> ResidualState:
        return init_residual(numel, device)

    def _wire_p(self, direction: str) -> float:
        return self.sparsity_up if direction == "up" else self.sparsity_down

    def encode_wire(self, msg, *, direction="up"):
        return wire.encode_ternary_words(
            _host(msg), self._wire_p(direction), backend=self.wire_backend,
            device=_device_of(msg))

    def encode_wire_batch(self, msgs, *, direction="up"):
        return wire.encode_ternary_words_batch(
            _host(msgs), self._wire_p(direction), backend=self.wire_backend,
            device=_device_of(msgs))

    def wire_bound_bits(self, numel, nnz, direction="up"):
        return golomb.stc_stream_bound_bits(numel, nnz,
                                            self._wire_p(direction))

    def encode(self, delta, state):
        be = get_stc_backend(self.backend)
        msg, new_res, stats = be.compress_with_residual(
            delta, state.residual, self.sparsity_up)
        return msg, ResidualState(residual=new_res), stats

    def encode_batch(self, deltas, states):
        # one batched backend call: one launch per kernel for the round
        be = get_stc_backend(self.backend)
        msgs, new_res, stats = be.compress_with_residual_batch(
            deltas, states.residual, self.sparsity_up)
        return msgs, ResidualState(residual=new_res), stats

    def aggregate(self, msgs, server_state, mask=None, staleness=None):
        be = get_stc_backend(self.backend)
        mean = self.combine(msgs, mask, staleness)
        out, new_res, stats = be.compress_with_residual(
            mean, server_state.residual, self.sparsity_down)
        return out, ResidualState(residual=new_res), stats

    def upload_bits(self, numel: int) -> float:
        return golomb.stc_message_bits(numel, self.sparsity_up)

    def download_bits(self, numel: int, n_participating: int = 1) -> float:
        return golomb.stc_message_bits(numel, self.sparsity_down)
