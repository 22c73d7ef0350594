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
* ``encode_wire`` / ``decode_wire`` / ``encode_wire_batch`` and
  ``measured_*`` -- the real bitstream (host-side,
  :mod:`repro_torch.core.wire`): codecs with ``wire_format = True`` get
  exact measured bits in the trainer's ledger.  A message that is a tensor
  is packed by the wire backend on the tensor's device.
* the fused decode→aggregate ingest (``supports_ingest``, ``make_ingest``,
  ``ingest_dense`` / ``ingest_wire*``, ``aggregate_ingest``): a round's
  wire messages scatter into one host :class:`~repro_torch.core.ingest.
  IngestAccumulator`, bitwise equal to the dense oracle.  The ingest and
  validation methods take ``device=``, where the ``"kernel"`` wire backend
  decodes the streams (CUDA unless the caller names the CPU).  On that
  backend signSGD keeps a round's sign planes on the device both ways:
  one pack of the cohort's fp32 messages, and one tally of the planes into
  the accumulator's sum.

* the chunked ``(layer, chunk)`` block path (``chunk_blocks``,
  ``encode_chunk_blocks[_adaptive]``, ``aggregate_chunk_blocks[_adaptive]``)
  that :class:`~repro_torch.core.chunking.ChunkedCodec` drives: STC
  compresses every ``(client, chunk)`` row of a round in one selection.

The paper's comparison set (Table I) is ported:
:class:`BaselineCodec`, :class:`FedAvgCodec`, :class:`SignSGDCodec`,
:class:`TopKCodec`, :class:`StcCodec` and :class:`TernQuantCodec`,
registered in the reference's order; each runs chunked too.  Under a
screening rule (``norm_screened_mean``) the ingest screens each message by
its norm: the dense message's in fp64, a wire message's from its side
information (``wire_norm``).

* the tree path of the mesh trainer (:mod:`repro_torch.launch.train`):
  ``has_client_state`` / ``has_server_state``, ``tree_encode``,
  ``tree_reduce`` (the one collective, over the process group of the
  client ranks) and ``tree_decode``, on parameter trees.  STC's tree
  compression is the flat kernel composition over the flattened tree
  (:mod:`repro_torch.core.distributed`).
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import warnings
from typing import ClassVar, Optional

import numpy as np
import torch

from . import golomb, wire
from .aggregation import (AggregationRule, MeanRule, NormScreenedMeanRule,
                          make_rule)
from .compression import (CompressionStats, _stc_rows, _torch_carry,
                          flatten_pytree, get_stc_backend, majority_vote_sign,
                          sign_compress, ternary_quantize,
                          ternary_quantize_batch, top_k_sparsify,
                          top_k_sparsify_batch, tree_leaves, tree_map,
                          unflatten_pytree)
from .distributed import (all_gather, psum, sign_compress_tree,
                          stc_compress_tree, stc_compress_tree_chunked,
                          stc_compress_tree_with_residual,
                          ternary_quantize_tree)
from .ingest import IngestAccumulator
from .registry import lookup as _registry_lookup, resolve as _registry_resolve
from .residual import (ResidualState, compress_with_feedback, init_residual,
                       map_states, take_states)
from .selection import flush_subnormal

__all__ = ["Codec", "Protocol", "make_protocol", "register_protocol",
           "registered_protocols", "get_protocol_class", "PROTOCOLS",
           "BaselineCodec", "FedAvgCodec", "SignSGDCodec", "TopKCodec",
           "StcCodec", "TernQuantCodec"]

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


# the pre-registry Protocol dataclass carried EVERY protocol's fields; the
# factory still accepts this set on any codec, dropping the ones a codec
# does not declare (they were functionally inert)
_LEGACY_FIELDS = frozenset({"sparsity_up", "sparsity_down", "sign_step",
                            "error_feedback", "backend", "local_iters"})


def _instantiate_protocol(cls: type["Codec"], overrides: dict) -> "Codec":
    """``make_protocol``'s keyword handling: declared fields pass through,
    legacy fields drop silently when inert (and raise ``ValueError`` when
    they contradict a ClassVar), anything else is a ``TypeError`` naming
    the declared fields."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in overrides.items():
        if k in fields:
            kwargs[k] = v
        elif k in _LEGACY_FIELDS:
            cur = getattr(cls, k, None)
            if cur is not None and cur != v:
                raise ValueError(
                    f"{cls.name!r} fixes {k}={cur!r}; "
                    f"override is not supported")
        else:
            raise TypeError(
                f"{cls.name!r} codec has no field {k!r}; declared fields: "
                f"{sorted(fields)}")
    return cls(**kwargs)


def make_protocol(name, **overrides) -> "Codec":
    """Factory with the paper's default hyperparameters (Section VI).
    Accepts a registered name (plus field overrides, and the legacy fields
    of :data:`_LEGACY_FIELDS`) or an already-built :class:`Codec` instance,
    which passes through untouched."""
    return _registry_resolve("protocol", name, _REGISTRY, Codec,
                             instantiate=_instantiate_protocol, **overrides)


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
    # DEPRECATED norm-bound screen: forwarded to
    # ``rule=norm_screened_mean(bound=, policy=)`` with a DeprecationWarning;
    # setting them alongside an explicit ``rule`` raises
    norm_bound: Optional[float] = None
    norm_policy: str = "clip"               # "clip" | "reject"
    # the server-side combine estimator: a registered AggregationRule name
    # or instance; None -> "mean"
    rule: Optional[AggregationRule] = None

    def __post_init__(self):
        if self.norm_policy not in ("clip", "reject"):
            raise ValueError(
                f"norm_policy must be 'clip' or 'reject', "
                f"got {self.norm_policy!r}")
        if self.norm_bound is not None and not self.norm_bound > 0.0:
            raise ValueError(
                f"norm_bound must be > 0 (or None), got {self.norm_bound}")
        rule = self.rule
        if self.norm_bound is not None:
            shim = NormScreenedMeanRule(bound=float(self.norm_bound),
                                        policy=self.norm_policy)
            if rule is None:
                warnings.warn(
                    "Codec(norm_bound=, norm_policy=) is deprecated; use "
                    "rule=make_rule('norm_screened_mean', bound=..., "
                    "policy=...) -- the shim forwards bit-identically for "
                    "one release", DeprecationWarning, stacklevel=3)
                rule = shim
            elif rule != shim:
                # an equal rule is dataclasses.replace() of an already
                # shimmed codec: re-normalizing is not a conflict
                raise ValueError(
                    "norm_bound/norm_policy cannot be combined with an "
                    "explicit aggregation rule; fold the screen into "
                    "rule=make_rule('norm_screened_mean', bound=..., "
                    "policy=...)")
        object.__setattr__(
            self, "rule", make_rule(rule if rule is not None else "mean"))

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # a 2-argument aggregate predates the masked API: fail at class
        # definition, naming the migration, instead of mis-aggregating
        # masked rounds at run time
        for meth in ("aggregate", "tree_reduce"):
            fn = cls.__dict__.get(meth)
            if fn is None or not callable(fn):
                continue
            try:
                params = inspect.signature(fn).parameters
            except (TypeError, ValueError):
                continue
            if any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values()):
                continue
            if "mask" not in params or "staleness" not in params:
                raise TypeError(
                    f"{cls.__name__}.{meth} predates the masked aggregation "
                    f"API: every codec now implements {meth}(..., mask=None, "
                    "staleness=None)")

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

    # -- chunked (layer, chunk) block path ------------------------------------
    # A codec with ``chunk_blocks = True`` compresses a zero-padded
    # (P, n_chunks, chunk_numel) block tensor in ONE fused call with a static
    # per-chunk k vector, instead of the generic per-group path of
    # :class:`repro_torch.core.chunking.ChunkedCodec`.  Contract: each block
    # is compressed exactly as the flat codec would compress its unpadded
    # slice (padding is zero and is never selected).

    chunk_blocks: ClassVar[bool] = False

    def encode_chunk_blocks(self, blocks, states, *, ks):
        """Fused chunked upstream compression; see ``chunk_blocks`` above."""
        raise NotImplementedError(
            f"{type(self).__name__} has no fused chunk-blocks path")

    def aggregate_chunk_blocks(self, blocks, server_state, *, ks, mask=None,
                               staleness=None):
        """Fused chunked aggregation + downstream compression."""
        raise NotImplementedError(
            f"{type(self).__name__} has no fused chunk-blocks path")

    # Adaptive-controller variants (repro_torch.core.adaptive): the per-chunk
    # k comes from a controller that observes the carried blocks, and its
    # state (if any) threads through the call.  Only meaningful for
    # ``chunk_blocks = True`` codecs.

    def encode_chunk_blocks_adaptive(self, blocks, states, controller,
                                     ctrl_state, *, base_ks, caps):
        """Fused upstream compression with controller-chosen per-chunk k.

        Returns ``(tern, new_states, new_ctrl_state, stats)``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no adaptive chunk-blocks path")

    def aggregate_chunk_blocks_adaptive(self, blocks, server_state,
                                        controller, ctrl_state, *, base_ks,
                                        caps, mask=None, staleness=None):
        """Fused aggregation + downstream compression with controller-chosen
        per-chunk k.  Returns ``(out, new_state, new_ctrl_state, stats)``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no adaptive chunk-blocks path")

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

    def decode_wire(self, msg: wire.WireMessage, *,
                    direction: str = "up") -> np.ndarray:
        """Inverse of :meth:`encode_wire` (host numpy), exact up to the
        wire format's resolution (a 1-bit sign plane cannot represent
        exact zeros -- see :func:`wire.pack_sign_words`)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no wire format")

    def validate_wire(self, msg: wire.WireMessage, *, direction: str = "up",
                      device=None) -> None:
        """Admission-control validation of ONE arriving wire message:
        raises :class:`wire.WireDecodeError` on any corruption the decoder
        can detect.  The default decodes the full message and discards it;
        codecs with a cheaper structural check override it."""
        self.decode_wire(msg, direction=direction)

    def wire_norm(self, msg: wire.WireMessage) -> float:
        """Cheap l2-norm estimate of ONE encoded message from its wire side
        information alone (no decode)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no wire-norm estimate")

    def encode_wire_batch(self, msgs, *, direction: str = "up",
                          device=None) -> wire.WireBatch:
        """Serialize a stacked (P, numel) round of messages.  ``device`` is
        where a wire backend that packs on a device packs a host array
        (None: a tensor's own device, or the default); the default loops
        :meth:`encode_wire`."""
        return wire.concat_messages([
            self.encode_wire(m, direction=direction) for m in msgs])

    def measured_batch_bits(self, batch: wire.WireBatch) -> float:
        """Total size of an already-encoded batch (stream + headers)."""
        return batch.total_bits() + batch.n_msgs * self.wire_header_bits

    def measured_message_bits(self, msg: wire.WireMessage) -> float:
        """Total size of ONE already-encoded message (stream + header)."""
        return msg.bit_len + self.wire_header_bits

    def measured_upload_bits(self, msgs, device=None) -> float:
        """EXACT upstream bits for a (P, numel) stack of compressed client
        messages; the analytic model for wire-less codecs.  ``device`` as
        in :meth:`encode_wire_batch`."""
        if not self.wire_format:
            return msgs.shape[0] * self.upload_bits(msgs.shape[-1])
        return self.measured_batch_bits(
            self.encode_wire_batch(msgs, direction="up", device=device))

    def measured_download_bits(self, msg, n_participating: int = 1,
                               device=None) -> float:
        """EXACT bits of ONE downstream (global update) message; a
        ``device`` packs a host array there, as one row of
        :meth:`encode_wire_batch`."""
        if not self.wire_format:
            return self.download_bits(int(np.prod(msg.shape)),
                                      n_participating=n_participating)
        if device is not None:
            return self.measured_batch_bits(self.encode_wire_batch(
                msg.reshape(1, -1), direction="down", device=device))
        return self.measured_message_bits(self.encode_wire(msg,
                                                           direction="down"))

    def wire_bound_bits(self, numel: int, nnz: int,
                        direction: str = "up") -> Optional[float]:
        """Deterministic per-message ceiling on the measured size (stream
        plus header bits; None = no bound known)."""
        return None

    # -- fused decode→aggregate ingestion (repro_torch.core.ingest) ----------
    # A codec with ``supports_ingest = True`` consumes a round as a stream
    # of wire messages scattered into one O(numel) host accumulator;
    # ``aggregate_ingest`` finalizes the round from it.  Contract: the wire
    # paths are bitwise the dense oracle (``decode_wire`` + ``ingest_dense``)
    # and both share ``finalize_ingest``.

    supports_ingest: ClassVar[bool] = False

    def make_ingest(self, numel: int) -> IngestAccumulator:
        """A fresh per-round accumulator sized for the flat message vector."""
        if not self.supports_ingest:
            raise NotImplementedError(
                f"{type(self).__name__} has no ingest path")
        if not self.rule.supports_streaming:
            raise NotImplementedError(
                f"aggregation rule {self.rule.name!r} needs every client's "
                "coordinates at once and cannot stream through "
                "IngestAccumulator; use the dense aggregate path (trainers "
                "asked for ingest=True fall back automatically)")
        return IngestAccumulator(numel)

    def ingest_dense(self, acc: IngestAccumulator, vec: np.ndarray,
                     weight: float) -> None:
        """One dense (decoded, or never wire-encoded) host message into the
        accumulator -- the fused wire paths' bit-exactness oracle.  Under a
        screening rule the message's fp64 norm is screened first: a
        rejected message counts with zero weight and adds nothing."""
        if self.rule.screens:
            norm = float(np.linalg.norm(np.asarray(vec, np.float64)))
            scale, rejected = self.rule.screen_weight(norm)
            if rejected:
                acc.begin_message(0.0)
                acc.note_screened()
                return
            acc.begin_message(weight)
            acc.add_dense(vec, weight * scale)
            return
        acc.begin_message(weight)
        acc.add_dense(vec, weight)

    def ingest_wire_chunk(self, acc: IngestAccumulator, msg, weight: float,
                          *, direction: str = "up", offset: int = 0,
                          device=None) -> None:
        """Scatter ONE wire sub-stream at flat ``offset`` (no per-message
        bookkeeping)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no wire ingest path")

    def ingest_wire(self, acc: IngestAccumulator, msg, weight: float, *,
                    direction: str = "up", device=None) -> None:
        """One arriving wire message: account its weight and measured bits,
        then scatter its decoded fields into the accumulator.  Under a
        screening rule the message's wire-side norm (``wire_norm``, host
        fp64) is screened first: a rejected message still bills its bits
        but enters with zero weight, and is not decoded."""
        bits = self.measured_message_bits(msg)
        if self.rule.screens:
            scale, rejected = self.rule.screen_weight(self.wire_norm(msg))
            if rejected:
                acc.begin_message(0.0, bits=bits)
                acc.note_screened()
                return
            acc.begin_message(weight, bits=bits)
            self.ingest_wire_chunk(acc, msg, weight * scale,
                                   direction=direction, device=device)
            return
        acc.begin_message(weight, bits=bits)
        self.ingest_wire_chunk(acc, msg, weight, direction=direction,
                               device=device)

    def ingest_wire_batch(self, acc: IngestAccumulator, batch, weights, *,
                          direction: str = "up", device=None) -> None:
        """A whole encoded round, message-major.  The default loops
        :meth:`ingest_wire`; STC overrides it with a fused decode."""
        for i, w in enumerate(np.asarray(weights, np.float64)):
            self.ingest_wire(acc, batch.message(i), float(w),
                             direction=direction, device=device)

    def ingest_wire_rows(self, acc: IngestAccumulator, batch, weights,
                         offsets, *, direction: str = "up",
                         device=None) -> None:
        """Scatter every row of ``batch`` with its weight at its flat
        offset, in row order, with no per-message bookkeeping (the chunked
        ingest's sub-streams).  The default loops
        :meth:`ingest_wire_chunk`; STC overrides it with a fused decode."""
        w = np.asarray(weights, np.float64)
        offs = np.asarray(offsets, np.int64)
        for i in range(batch.n_msgs):
            self.ingest_wire_chunk(acc, batch.message(i), float(w[i]),
                                   direction=direction, offset=int(offs[i]),
                                   device=device)

    def finalize_ingest(self, combined: np.ndarray, server_state):
        """Downstream compression of the accumulator's fp32 weighted mean;
        the ingest twin of the tail of :meth:`aggregate`.  Returns
        ``(global_delta, new_server_state, stats)``."""
        raise NotImplementedError(
            f"{type(self).__name__} has no ingest path")

    def aggregate_ingest(self, acc: IngestAccumulator, server_state):
        """Finalize a round straight from the accumulator (the fused wire
        path and the dense oracle both end here, so they agree bitwise)."""
        return self.finalize_ingest(acc.combined(), server_state)

    # -- tree path (the mesh trainer, repro_torch.launch.train) -------------
    # ``axes`` is the process group of the client ranks (None: no client
    # axes, one client); the leaves are dicts and lists of tensors.
    # ``model`` (a core.distributed.ModelShards, tensor parallelism) is the
    # client's model group: the leaves are this rank's blocks, and the
    # codecs with global statistics (STC, top-k, TernQuant) take them over
    # the whole tree; ``numel`` stays the global size.
    def has_client_state(self) -> bool:
        return self.init_client_state(0, "cpu") is not None

    def has_server_state(self) -> bool:
        return self.init_server_state(0, "cpu") is not None

    def tree_encode(self, delta, residual, *, numel: int, iters: int = 32,
                    model=None):
        """Client-side compression over a parameter tree.  ``residual`` is
        a bare fp32 tree (or None).  Returns (msg_tree, new_residual,
        metrics)."""
        return delta, residual, {}

    def _tree_reduce_gather(self, msgs, axes, mask, staleness):
        """Order-statistic rules need every rank's coordinates at once:
        all_gather the message trees plus their weight mass, then run the
        rule once per leaf."""
        rule = self.rule
        device = tree_leaves(msgs)[0].device
        if mask is None:
            mask = torch.ones((1,), dtype=torch.float32, device=device)
        w = self.participation_weights(mask, staleness).to(device).sum()
        if axes is None:
            return tree_map(lambda t: rule.combine(t[None], w[None]), msgs)
        ws = all_gather(w, axes)
        return tree_map(lambda t: rule.combine(all_gather(t, axes), ws),
                        msgs)

    def tree_reduce(self, msgs, axes, n_clients: int, mask=None,
                    staleness=None):
        """The one protocol-level collective: combine the client ranks'
        message trees over ``axes``.

        Mean-family rules reduce by one ``all_reduce`` of the flattened
        tree; other rules go through :meth:`_tree_reduce_gather`.
        ``mask`` / ``staleness`` are THIS rank's slice of the per-client
        vectors (shape ``(1,)``): a masked-out rank contributes zero
        weight, and the weighted sum renormalizes by the total arrived
        weight mass.  Divisions are by tensors (correctly rounded on the
        card too).
        """
        if not isinstance(self.rule, MeanRule):
            return self._tree_reduce_gather(msgs, axes, mask, staleness)
        device = tree_leaves(msgs)[0].device
        if mask is None and staleness is None:
            if axes is None:
                return msgs
            n = torch.tensor(float(n_clients), device=device)
            return _tree_collective(msgs, lambda v: psum(v, axes) / n)
        if mask is None:
            mask = torch.ones((1,), dtype=torch.float32, device=device)
        w = self.participation_weights(mask, staleness).to(device).sum()
        if axes is None:
            denom = torch.where(w > 0, w, torch.ones_like(w))
            return tree_map(lambda t: w * t / denom, msgs)
        total = psum(w, axes)
        denom = torch.where(total > 0, total, torch.ones_like(total))
        return _tree_collective(msgs, lambda v: psum(w * v, axes) / denom)

    def tree_decode(self, combined, residual, *, numel: int, iters: int = 32,
                    model=None):
        """Server-side downstream compression of the combined tree.
        Returns (global_delta_tree, new_server_residual, metrics)."""
        return combined, residual, {}


def _tree_collective(tree, fn):
    """``fn`` over the tree's leaves flattened into one fp32 vector (one
    collective a tree), the result in the tree's structure."""
    vec, spec = flatten_pytree(tree)
    return unflatten_pytree(fn(vec), spec)


def _tree_carry(delta, residual):
    """The error-feedback carried tree ``delta + residual``, operands and
    sum flushed as XLA computes them (the flat codecs' carried sum)."""
    return tree_map(_torch_carry, delta, residual)


def _tree_sub(carried, msg):
    """The new residual tree ``carried - msg``, flushed."""
    return tree_map(lambda c, t: flush_subnormal(c - t), carried, msg)


class _ErrorFeedbackMixin:
    error_feedback: ClassVar[bool] = True

    def init_client_state(self, numel: int, device=None) -> ResidualState:
        return init_residual(numel, device)


# ---------------------------------------------------------------------------
# the paper's comparison set (Table I)
# ---------------------------------------------------------------------------


@register_protocol
@dataclasses.dataclass(frozen=True)
class BaselineCodec(Codec):
    """Uncompressed distributed SGD: dense fp32 both ways."""

    name: ClassVar[str] = "baseline"

    def encode(self, delta, state):
        stats = CompressionStats(nnz=torch.tensor(delta.numel()),
                                 numel=torch.tensor(delta.numel()),
                                 mu=torch.tensor(0.0))
        return delta, state, stats

    def upload_bits(self, numel: int) -> float:
        return golomb.fedavg_message_bits(numel)

    def download_bits(self, numel: int, n_participating: int = 1) -> float:
        return golomb.fedavg_message_bits(numel)


@register_protocol
@dataclasses.dataclass(frozen=True)
class FedAvgCodec(BaselineCodec):
    """Federated Averaging: dense messages every ``local_iters``
    iterations."""

    name: ClassVar[str] = "fedavg"

    local_iters: int = 400


@register_protocol
@dataclasses.dataclass(frozen=True)
class SignSGDCodec(Codec):
    """signSGD with majority vote (Bernstein et al. '18); δ = ``sign_step``.
    Flat and tree paths."""

    name: ClassVar[str] = "signsgd"

    sign_step: float = 2e-4
    wire_backend: str = "numpy"             # wire packer: "numpy" | "kernel"

    wire_format: ClassVar[bool] = True      # dense sign plane, 1 bit/coord
    wire_static_size: ClassVar[bool] = True  # numel bits, exactly, always
    supports_ingest: ClassVar[bool] = True

    def _sign_stats(self, out: torch.Tensor) -> CompressionStats:
        return CompressionStats(nnz=torch.tensor(out.numel()),
                                numel=torch.tensor(out.numel()),
                                mu=torch.tensor(self.sign_step))

    def encode(self, delta, state):
        msg, stats = sign_compress(delta, self.sign_step)
        return msg, state, stats

    def _planes_on_device(self, msg) -> bool:
        """The ``"kernel"`` backend packs a tensor's sign planes where the
        tensor lies, straight from its fp32 values."""
        return self.wire_backend == "kernel" and isinstance(msg,
                                                            torch.Tensor)

    def encode_wire(self, msg, *, direction="up"):
        if self._planes_on_device(msg):
            return wire.pack_sign_planes_batch(
                msg.reshape(1, -1), self.sign_step).message(0)
        return wire.pack_sign_words(_host(msg), self.sign_step,
                                    backend=self.wire_backend,
                                    device=_device_of(msg))

    def encode_wire_batch(self, msgs, *, direction="up", device=None):
        # one pack_sign_planes launch for the round; the batch is the
        # default loop's, field for field
        if self.wire_backend == "kernel" and device is not None \
                and not isinstance(msgs, torch.Tensor):
            msgs = torch.from_numpy(np.ascontiguousarray(msgs, np.float32)) \
                .to(device)
        if self._planes_on_device(msgs) and msgs.shape[0] > 0:
            return wire.pack_sign_planes_batch(
                msgs.reshape(msgs.shape[0], -1), self.sign_step)
        return super().encode_wire_batch(msgs, direction=direction)

    def decode_wire(self, msg, *, direction="up"):
        return wire.unpack_sign_words(msg)

    def validate_wire(self, msg, *, direction="up", device=None):
        # a sign plane is exactly numel bits; anything else is truncation
        # or padding corruption, by construction
        if int(msg.bit_len) != int(msg.numel):
            raise wire.WireDecodeError(
                "corrupt sign plane: bit_len != numel")
        wire.sign_plane_bits(msg, backend=self.wire_backend, device=device)

    def wire_norm(self, msg):
        # every coordinate is exactly ±sign_step
        return self.sign_step * math.sqrt(int(msg.numel))

    def wire_bound_bits(self, numel, nnz, direction="up"):
        return float(numel)                 # measured == analytic, exactly

    # ---- fused ingest: the vote tally IS the weighted plane sum ----
    def ingest_wire_chunk(self, acc, msg, weight, *, direction="up",
                          offset=0, device=None):
        bits01 = wire.sign_plane_bits(msg, backend=self.wire_backend,
                                      device=device)
        acc.add_sign_plane(bits01, self.sign_step, weight, offset=offset)

    def ingest_wire_batch(self, acc, batch, weights, *, direction="up",
                          device=None):
        """On the ``"kernel"`` backend the whole round is one
        :func:`repro_torch.kernels.wiredecode.sign_plane_tally` on
        ``device`` (its plain version on the CPU): every message is checked
        first (``bit_len == numel`` and within its words, else
        :class:`wire.WireDecodeError` with the accumulator untouched), then
        accounted in order as the default loop does, then the words and
        ``acc.sum`` go to the device, the planes are added in message order
        and the sum comes back, bitwise the default loop's."""
        if self.wire_backend != "kernel" or self.rule.screens:
            # (a screening rule screens message by message)
            return super().ingest_wire_batch(acc, batch, weights,
                                             direction=direction,
                                             device=device)
        from repro_torch.device import resolve_device
        from repro_torch.kernels.wiredecode import sign_plane_tally
        w = np.asarray(weights, np.float64)
        rows = wire.sign_plane_rows(batch)
        for i in range(batch.n_msgs):
            acc.begin_message(float(w[i]), bits=self.measured_message_bits(
                batch.message(i)))
        if batch.n_msgs == 0 or batch.numel == 0:
            return
        acc.nnz += batch.n_msgs * int(batch.numel)
        dev = resolve_device(device)
        host = torch.from_numpy(acc.sum)
        total = host.to(dev)
        sign_plane_tally(torch.from_numpy(rows.view(np.int32)).to(dev),
                         self.sign_step,
                         torch.from_numpy(w).to(dev), total)
        if total is not host:
            host.copy_(total)

    def finalize_ingest(self, combined, server_state):
        # sign(weighted mean) == sign(weighted vote tally): the arrived mass
        # is positive and the wire planes are exactly ±step.  The result is
        # a CPU tensor (signSGD has no server state to place it by).
        out = self.sign_step * torch.sign(
            torch.from_numpy(np.asarray(combined, np.float32)))
        return out, server_state, self._sign_stats(out)

    def aggregate(self, msgs, server_state, mask=None, staleness=None):
        if not isinstance(self.rule, MeanRule):
            # order-statistic rules: combine the ±step messages through the
            # rule, then re-quantize to the sign plane
            out = self.sign_step * torch.sign(
                self.combine(msgs, mask, staleness))
            return out, server_state, self._sign_stats(out)
        # mean family: the weighted majority vote
        weights = None
        if mask is not None or staleness is not None:
            if mask is None:
                mask = torch.ones(msgs.shape[0], dtype=torch.float32,
                                  device=msgs.device)
            weights = self.participation_weights(mask, staleness)
        out = majority_vote_sign(msgs, self.sign_step, weights=weights)
        return out, server_state, self._sign_stats(out)

    def upload_bits(self, numel: int) -> float:
        return golomb.signsgd_message_bits(numel)

    def download_bits(self, numel: int, n_participating: int = 1) -> float:
        return golomb.signsgd_message_bits(numel)

    # ---- tree path ----
    def tree_encode(self, delta, residual, *, numel, iters=32, model=None):
        return sign_compress_tree(delta, self.sign_step), residual, {}

    def tree_reduce(self, msgs, axes, n_clients, mask=None, staleness=None):
        if not isinstance(self.rule, MeanRule):
            # gathered rule over the ±step trees; tree_decode's sign()
            # re-quantizes the combined tree either way
            return self._tree_reduce_gather(msgs, axes, mask, staleness)
        if mask is None and staleness is None:
            if axes is None:
                return tree_map(torch.sign, msgs)
            return _tree_collective(msgs, lambda v: psum(torch.sign(v), axes))
        # weighted vote: an absent rank casts no vote (weight 0); no
        # renormalization -- tree_decode takes the sign of the tally anyway
        device = tree_leaves(msgs)[0].device
        if mask is None:
            mask = torch.ones((1,), dtype=torch.float32, device=device)
        w = self.participation_weights(mask, staleness).to(device).sum()
        if axes is None:
            return tree_map(lambda t: w * torch.sign(t), msgs)
        return _tree_collective(msgs,
                                lambda v: psum(w * torch.sign(v), axes))

    def tree_decode(self, combined, residual, *, numel, iters=32,
                    model=None):
        out = tree_map(lambda v: self.sign_step * torch.sign(v), combined)
        return out, residual, {}


# top-k's sparse message: 16-bit positions (the paper's own accounting for
# the comparison baseline, Appx. A) + one fp32 value per surviving entry
_TOPK_POSITION_BITS = 16.0
_TOPK_VALUE_BITS = 32.0


@register_protocol
@dataclasses.dataclass(frozen=True)
class TopKCodec(_ErrorFeedbackMixin, Codec):
    """Upload-only top-k sparsification + error feedback (Aji/Lin).  The
    round's selection is the exact histogram k-selection of the
    ``"kernel"`` STC backend (its plain versions on the CPU)."""

    name: ClassVar[str] = "topk"

    sparsity_up: float = 1 / 400

    def encode(self, delta, state):
        return compress_with_feedback(
            delta, state, lambda v: top_k_sparsify(v, self.sparsity_up))

    def encode_batch(self, deltas, states):
        # one selection for the round: one histogram and one bin_select
        # launch on the card
        return compress_with_feedback(
            deltas, states,
            lambda v: top_k_sparsify_batch(v, self.sparsity_up))

    def _message_bits(self, numel: int, nnz: int) -> float:
        """Sparse message cost shared by the up/down ledger entries: 16-bit
        positions + 32-bit values, densifying to plain fp32 when full."""
        if nnz >= numel:
            return golomb.fedavg_message_bits(numel)
        return nnz * (_TOPK_POSITION_BITS + _TOPK_VALUE_BITS)

    def upload_bits(self, numel: int) -> float:
        k = max(int(numel * self.sparsity_up), 1)
        return self._message_bits(numel, k)

    def download_bits(self, numel: int, n_participating: int = 1) -> float:
        # upload-only compression: downstream density grows with clients
        # (Section V-A) until the update is effectively dense
        k = max(int(numel * self.sparsity_up), 1)
        return self._message_bits(numel, min(k * n_participating, numel))

    # ---- tree path ----
    def tree_encode(self, delta, residual, *, numel, iters=32, model=None):
        carried = _tree_carry(delta, residual)
        _, st = stc_compress_tree(carried, self.sparsity_up, numel=numel,
                                  iters=iters, model=model)
        # pure top-k keeps magnitudes: mask = |x| >= thresh
        msg = tree_map(lambda x: torch.where(x.abs() >= st.thresh, x,
                                             torch.zeros_like(x)), carried)
        return msg, _tree_sub(carried, msg), {"nnz_up": st.nnz}


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
    # tree-path chunking (the mesh trainer's TrainConfig.chunks): when set,
    # tree_encode / tree_decode select per (leaf, chunk) block instead of
    # one global top-k; ``p_fn(layer_name, depth)`` is the per-layer
    # sparsity schedule and ``controller`` an adaptive per-chunk sparsity
    # controller (repro_torch.core.adaptive).  These fields drive the TREE
    # path only: the flat trainers chunk by wrapping (core.chunking).
    chunk_size: Optional[int] = None
    p_fn: Optional[object] = None
    controller: Optional[object] = None

    wire_format: ClassVar[bool] = True      # Golomb position stream (Alg. 3)
    wire_header_bits: ClassVar[float] = 32.0  # fp32 µ per message (Eq. 15)
    supports_ingest: ClassVar[bool] = True
    #: fused-ingest decode block: rows are grouped so each multi-segment
    #: decode pass touches at most this many stream words
    ingest_block_words: ClassVar[int] = 1 << 16

    def init_server_state(self, numel: int, device=None) -> ResidualState:
        return init_residual(numel, device)

    def _wire_p(self, direction: str) -> float:
        return self.sparsity_up if direction == "up" else self.sparsity_down

    def encode_wire(self, msg, *, direction="up"):
        return wire.encode_ternary_words(
            _host(msg), self._wire_p(direction), backend=self.wire_backend,
            device=_device_of(msg))

    def decode_wire(self, msg, *, direction="up"):
        return wire.decode_ternary_words(msg, self._wire_p(direction))

    def validate_wire(self, msg, *, direction="up", device=None):
        # fields-only parse: every decoder corruption check fires without
        # materializing the dense vector
        wire.decode_ternary_fields(msg, self._wire_p(direction),
                                   backend=self.wire_backend, device=device)

    def wire_norm(self, msg):
        # nnz coordinates of magnitude |µ| exactly (abs: a negated µ must
        # not give a negative norm)
        return abs(float(msg.mu)) * math.sqrt(max(int(msg.nnz), 0))

    def encode_wire_batch(self, msgs, *, direction="up", device=None):
        return wire.encode_ternary_words_batch(
            _host(msgs), self._wire_p(direction), backend=self.wire_backend,
            device=_device_of(msgs) if device is None else device)

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

    # ---- fused ingest: Golomb fields -> accumulator scatter ----
    def ingest_wire_chunk(self, acc, msg, weight, *, direction="up",
                          offset=0, device=None):
        pos, signs = wire.decode_ternary_fields(
            msg, self._wire_p(direction), backend=self.wire_backend,
            device=device)
        acc.scatter_ternary(pos, signs, msg.mu, weight, offset=offset)

    def ingest_wire_batch(self, acc, batch, weights, *, direction="up",
                          device=None):
        if self.rule.screens:
            # screened rounds take the per-message path: the screen is per
            # message anyway, and a rejected row must not scatter or count
            # non-zeros, so batch == oracle stays bitwise
            return Codec.ingest_wire_batch(self, acc, batch, weights,
                                           direction=direction,
                                           device=device)
        w = np.asarray(weights, np.float64)
        for i in range(batch.n_msgs):
            acc.begin_message(float(w[i]),
                              bits=float(batch.bit_len[i])
                              + self.wire_header_bits)
        self.ingest_wire_rows(acc, batch, w, np.zeros(batch.n_msgs, np.int64),
                              direction=direction, device=device)

    def ingest_wire_rows(self, acc, batch, weights, offsets, *,
                         direction="up", device=None):
        # multi-segment field decode + one scatter per bounded word block
        # (bitwise the sequential ingest_wire_chunk loop: np.add.at applies
        # in element order, and the fields come out row-major)
        w = np.asarray(weights, np.float64)
        offs = np.asarray(offsets, np.int64)
        p = self._wire_p(direction)
        i0, n_rows = 0, batch.n_msgs
        while i0 < n_rows:
            i1, words = i0, 0
            while i1 < n_rows and (i1 == i0
                                   or words + int(batch.word_count[i1])
                                   <= self.ingest_block_words):
                words += int(batch.word_count[i1])
                i1 += 1
            sub = batch.rows(i0, i1)
            seg, pos, signs = wire.decode_ternary_fields_batch(
                sub, p, backend=self.wire_backend, device=device)
            acc.scatter_ternary_batch(seg, pos, signs, sub.mu, w[i0:i1],
                                      offsets=offs[i0:i1])
            i0 = i1

    def finalize_ingest(self, combined, server_state):
        # the host mean goes to the server residual's device, then through
        # the codec's STC backend, as in aggregate
        be = get_stc_backend(self.backend)
        res = server_state.residual
        mean = torch.from_numpy(np.asarray(combined, np.float32)).to(
            res.device)
        out, new_res, stats = be.compress_with_residual(
            mean, res, self.sparsity_down)
        return out, ResidualState(residual=new_res), stats

    # ---- fused chunked block path (repro_torch.core.chunking) ----
    chunk_blocks: ClassVar[bool] = True

    def _blocks(self, carried, ks, k_cap=None):
        """STC over the (rows, W) carried rows with per-row ks: one
        selection and one apply for every row (on the ``"kernel"`` route
        one histogram, one ``bin_select`` and one ``stc_apply`` launch)."""
        return _stc_rows(get_stc_backend(self.backend), carried, ks, k_cap)

    def _carried(self, blocks, residual):
        return get_stc_backend(self.backend).carry(blocks, residual)

    def _client_blocks(self, carried, ks, k_cap=None):
        P, C, W = carried.shape
        tern, res, cnt, mu = self._blocks(carried.reshape(P * C, W), ks,
                                          k_cap)
        stats = CompressionStats(nnz=cnt.reshape(P, C).sum(dim=1),
                                 numel=torch.full((P,), C * W),
                                 mu=mu.reshape(P, C).mean(dim=1))
        return (tern.reshape(P, C, W),
                ResidualState(residual=res.reshape(P, C, W)), stats)

    def _server_blocks(self, carried, ks, k_cap=None):
        tern, res, cnt, mu = self._blocks(carried, ks, k_cap)
        stats = CompressionStats(nnz=cnt.sum(),
                                 numel=torch.tensor(carried.numel()),
                                 mu=mu.mean())
        return tern, ResidualState(residual=res), stats

    def encode_chunk_blocks(self, blocks, states, *, ks):
        """One selection over every (client, chunk) row."""
        return self._client_blocks(self._carried(blocks, states.residual),
                                   np.tile(np.asarray(ks), blocks.shape[0]))

    def aggregate_chunk_blocks(self, blocks, server_state, *, ks, mask=None,
                               staleness=None):
        mean = self.combine(blocks, mask, staleness)          # (C, W)
        return self._server_blocks(self._carried(mean, server_state.residual),
                                   ks)

    def encode_chunk_blocks_adaptive(self, blocks, states, controller,
                                     ctrl_state, *, base_ks, caps):
        """Controller-chosen per-(client, chunk) k: the controller observes
        the carried (update + residual) blocks and picks the ks on their
        device, bounded by the static ``caps``; then one dynamic selection
        compresses every row, reading no k back."""
        carried = self._carried(blocks, states.residual)
        ks, new_ctrl = controller.chunk_ks(carried, ctrl_state,
                                           base_ks=base_ks, caps=caps)
        tern, new_states, stats = self._client_blocks(
            carried, ks.reshape(-1), int(np.asarray(caps).max()))
        return tern, new_states, new_ctrl, stats

    def aggregate_chunk_blocks_adaptive(self, blocks, server_state,
                                        controller, ctrl_state, *, base_ks,
                                        caps, mask=None, staleness=None):
        mean = self.combine(blocks, mask, staleness)          # (C, W)
        carried = self._carried(mean, server_state.residual)
        ks, new_ctrl = controller.chunk_ks(carried[None], ctrl_state,
                                           base_ks=base_ks, caps=caps)
        out, new_state, stats = self._server_blocks(
            carried, ks.reshape(-1), int(np.asarray(caps).max()))
        return out, new_state, new_ctrl, stats

    def upload_bits(self, numel: int) -> float:
        return golomb.stc_message_bits(numel, self.sparsity_up)

    def download_bits(self, numel: int, n_participating: int = 1) -> float:
        return golomb.stc_message_bits(numel, self.sparsity_down)

    # ---- tree path ----
    def _tree_stc(self, carried, p, numel, model=None):
        """``(ternary, new_residual, stats)`` of the carried tree: one
        global selection (on the ``"kernel"`` route one histogram, one
        ``bin_select`` and one ``stc_apply`` launch over the flattened
        tree, or over the rank's row split across ``model``), or per
        ``(leaf, chunk)`` block with ``chunk_size``."""
        if self.chunk_size:
            if model is not None:
                raise NotImplementedError(
                    "the chunked STC under tensor parallelism: its blocks "
                    "cut across the shards (ROADMAP.md Queue 1, item 4d)")
            tern, st = stc_compress_tree_chunked(
                carried, p, self.chunk_size, p_fn=self.p_fn,
                backend=self.backend, controller=self.controller)
            return tern, _tree_sub(carried, tern), st
        return stc_compress_tree_with_residual(carried, p, numel=numel,
                                               backend=self.backend,
                                               model=model)

    def _tree_carried(self, delta, residual):
        return tree_map(get_stc_backend(self.backend).carry, delta, residual)

    def tree_encode(self, delta, residual, *, numel, iters=32, model=None):
        tern, new_res, st = self._tree_stc(
            self._tree_carried(delta, residual), self.sparsity_up, numel,
            model)
        return tern, new_res, {"nnz_up": st.nnz}

    def tree_decode(self, combined, residual, *, numel, iters=32,
                    model=None):
        down, new_res, st = self._tree_stc(
            self._tree_carried(combined, residual), self.sparsity_down, numel,
            model)
        return down, new_res, {"nnz_down": st.nnz}


@register_protocol
@dataclasses.dataclass(frozen=True)
class TernQuantCodec(_ErrorFeedbackMixin, Codec):
    """Dense ternary quantization à la T-FedAvg (Xu et al., 2020).

    Every coordinate is quantized to {-µ, 0, +µ} with TWN thresholding
    (Δ = θ·mean|x|) and error feedback on both sides; the wire format is an
    uncoded dense ternary stream (log2(3) bits/weight -- no position
    coding), so the ledger is analytic.  Ingest is dense only: the
    messages come to the host accumulator as fp32 vectors.
    """

    name: ClassVar[str] = "ternquant"

    theta: float = 0.75                     # TWN threshold factor

    supports_ingest: ClassVar[bool] = True  # dense ingest only (no wire)

    def init_server_state(self, numel: int, device=None) -> ResidualState:
        return init_residual(numel, device)

    def encode(self, delta, state):
        return compress_with_feedback(
            delta, state, lambda v: ternary_quantize(v, self.theta))

    def encode_batch(self, deltas, states):
        return compress_with_feedback(
            deltas, states, lambda v: ternary_quantize_batch(v, self.theta))

    def aggregate(self, msgs, server_state, mask=None, staleness=None):
        mean = self.combine(msgs, mask, staleness)
        return compress_with_feedback(
            mean, server_state, lambda v: ternary_quantize(v, self.theta))

    def finalize_ingest(self, combined, server_state):
        # the host mean goes to the server residual's device
        mean = torch.from_numpy(np.asarray(combined, np.float32)).to(
            server_state.residual.device)
        return compress_with_feedback(
            mean, server_state, lambda v: ternary_quantize(v, self.theta))

    def upload_bits(self, numel: int) -> float:
        return golomb.ternary_dense_bits(numel)

    def download_bits(self, numel: int, n_participating: int = 1) -> float:
        return golomb.ternary_dense_bits(numel)

    # ---- tree path ----
    def tree_encode(self, delta, residual, *, numel, iters=32, model=None):
        carried = _tree_carry(delta, residual)
        tern, st = ternary_quantize_tree(carried, self.theta, numel=numel,
                                         model=model)
        return tern, _tree_sub(carried, tern), {"nnz_up": st.nnz}

    def tree_decode(self, combined, residual, *, numel, iters=32,
                    model=None):
        carried = _tree_carry(combined, residual)
        down, st = ternary_quantize_tree(carried, self.theta, numel=numel,
                                         model=model)
        return down, _tree_sub(carried, down), {"nnz_down": st.nnz}


# The pre-registry name of :class:`Codec`, kept as an alias.
Protocol = Codec

# The paper's comparison set (Table I); the live registry may hold more.
PROTOCOLS = ("baseline", "fedavg", "signsgd", "topk", "stc")
