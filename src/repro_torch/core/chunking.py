"""Chunked per-layer codec states: compress ``(layer, chunk)`` blocks.

Counterpart of ``repro/core/chunking.py``.  The paper applies STC to ONE
flat parameter vector per client, but its Eq. 1 bit accounting and the
residual mechanics (Eqs. 9-12) hold equally per block.  This module turns
any registered :class:`~repro_torch.core.protocols.Codec` into a chunked
codec whose selection, µ and residuals are independent per ``(layer,
chunk)`` block, which makes per-layer sparsity schedules (T-FedAvg-style
tuned ranges, Xu et al. 2020) and the adaptive controllers of
:mod:`repro_torch.core.adaptive` expressible.

Two pieces:

* :class:`ChunkSpec` -- static chunk geometry from the model's parameter
  tree (layer boundaries + a chunk size): which flat slice each chunk
  covers, and the zero-padded ``split``/``merge`` between the flat ``(P,
  numel)`` trainer view and the ``(P, n_chunks, chunk_numel)`` block view.
  Chunks never cross layer boundaries (except the degenerate
  :func:`whole_vector_spec`); the last chunk of a layer may be ragged and
  empty layers contribute none.  Layer names are the reference's
  ``jax.tree_util.keystr`` strings (``['conv0']``,
  ``['layers'][0]['b']``), so a ``p_fn`` written for the reference
  schedules the port identically.

* :func:`chunk_codec` -- wraps a base codec into a :class:`ChunkedCodec`
  implementing the flat :class:`Codec` interface (both trainers run it
  unchanged), with per-chunk states, per-chunk analytic and measured bit
  ledgers and per-chunk wire framing.  A ``p_fn(layer_name, depth)`` hook
  rescales the sparsity per layer for codecs that declare ``sparsity_up``
  / ``sparsity_down``.

Contract: the chunked result is the base codec applied to every chunk's
unpadded slice independently (the per-chunk flat oracle), and a
``whole_vector_spec`` reproduces the flat path bit for bit -- parameters,
measured and analytic ledgers and the wire log.

Codecs with a batched block path opt in through ``Codec.chunk_blocks``
(STC: one selection -- on the card one histogram, one ``bin_select`` and
one ``stc_apply`` launch -- over every ``(client, chunk)`` row); every
other codec runs the generic grouped path, which calls the base codec's
own ``encode_batch`` once a group of equal-width chunks (every row of an
encode is independent, as the default ``Codec.encode_batch`` loops them)
and its ``aggregate`` / ``finalize_ingest`` once a chunk.

The wire encode copies a round's messages to the host once and packs each
group of equal-width chunks in one call (one ``pack_chunks`` launch a
group on the ``"kernel"`` wire backend); the ingest decodes each group's
sub-streams together (one ``golomb_decode`` a bounded word block) and
scatters them at their chunks' flat offsets, each coordinate's adds in
message order, so the accumulator is bitwise the reference's per-chunk
loop.  The reference's tree-path delegation (``tree_encode``,
``tree_reduce``, ``tree_decode``) is not ported: the port has no tree
path yet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import wire
from .adaptive import SparsityController, make_controller, validate_sparsity
from .compression import CompressionStats
from .protocols import Codec
from .residual import map_states, stack_states

__all__ = [
    "ChunkSpec",
    "chunk_spec_from_sizes",
    "chunk_spec_from_tree",
    "whole_vector_spec",
    "ChunkedCodec",
    "chunk_codec",
]


class ChunkSpec(NamedTuple):
    """Static ``(layer, chunk)`` geometry over a flat parameter vector.

    All fields are plain tuples, so a spec is hashable (codecs carrying one
    stay usable as cache keys).  ``chunk_numel`` is the uniform padded
    block width; chunk ``c`` covers the flat slice ``[chunk_start[c],
    chunk_start[c] + chunk_valid[c])`` of layer ``chunk_layer[c]``.
    """

    numel: int
    chunk_numel: int
    layer_names: tuple
    layer_sizes: tuple
    chunk_layer: tuple
    chunk_start: tuple
    chunk_valid: tuple

    @property
    def n_chunks(self) -> int:
        return len(self.chunk_start)

    def is_whole_vector(self) -> bool:
        return self.n_chunks == 1 and self.chunk_valid[0] == self.numel

    # -- flat <-> block views -------------------------------------------------
    def split(self, x):
        """``(..., numel)`` -> zero-padded ``(..., n_chunks, chunk_numel)``.

        Works on tensors (on their device) and numpy arrays alike
        (pad-one-then-gather)."""
        idx = _gather_index(self)
        if isinstance(x, torch.Tensor):
            padded = torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)
            return padded.index_select(-1, _device_index(
                self, "gather", x.device)).reshape(x.shape[:-1] + idx.shape)
        x = np.asarray(x)
        pad = np.zeros(x.shape[:-1] + (1,), x.dtype)
        return np.concatenate([x, pad], axis=-1)[..., idx]

    def merge(self, blocks):
        """``(..., n_chunks, chunk_numel)`` -> ``(..., numel)`` (drops pad)."""
        flat = blocks.reshape(blocks.shape[:-2] + (-1,))
        if isinstance(blocks, torch.Tensor):
            return flat.index_select(-1, _device_index(self, "merge",
                                                       blocks.device))
        return flat[..., _merge_index(self)]

    def valid_mask(self) -> np.ndarray:
        """(n_chunks, chunk_numel) bool: True where a block element is real."""
        return (np.arange(self.chunk_numel)[None, :]
                < np.asarray(self.chunk_valid)[:, None])

    # -- per-chunk hyperparameters -------------------------------------------
    def chunk_ks(self, ps) -> np.ndarray:
        """Per-chunk ``k = max(int(valid * p), 1)`` (Algorithm 1 line 3,
        applied to each block's UNPADDED length)."""
        ps = np.broadcast_to(np.asarray(ps, np.float64), (self.n_chunks,))
        valid = np.asarray(self.chunk_valid, np.int64)
        return np.maximum((valid.astype(np.float64) * ps).astype(np.int64), 1)


@functools.lru_cache(maxsize=128)
def _gather_index(spec: ChunkSpec) -> np.ndarray:
    """(n_chunks, chunk_numel) flat-position gather; padding points at the
    sentinel column ``numel`` (a zero appended by ``split``)."""
    idx = np.full((spec.n_chunks, spec.chunk_numel), spec.numel, np.int64)
    for c, (start, valid) in enumerate(zip(spec.chunk_start,
                                           spec.chunk_valid)):
        idx[c, :valid] = np.arange(start, start + valid)
    return idx


@functools.lru_cache(maxsize=128)
def _merge_index(spec: ChunkSpec) -> np.ndarray:
    """(numel,) index into the flattened (n_chunks*chunk_numel,) block view."""
    inv = np.empty(spec.numel, np.int64)
    for c, (start, valid) in enumerate(zip(spec.chunk_start,
                                           spec.chunk_valid)):
        inv[start : start + valid] = c * spec.chunk_numel + np.arange(valid)
    return inv


@functools.lru_cache(maxsize=128)
def _device_index(spec: ChunkSpec, kind: str, device: torch.device):
    """The gather or merge index as a flat int64 tensor on ``device``,
    copied there once."""
    idx = _gather_index(spec) if kind == "gather" else _merge_index(spec)
    return torch.from_numpy(idx.reshape(-1)).to(device)


def chunk_spec_from_sizes(sizes, names=None,
                          chunk_size: Optional[int] = None) -> ChunkSpec:
    """Spec from per-layer flat sizes.  ``chunk_size=None`` = one chunk per
    (non-empty) layer; otherwise each layer splits into ``ceil(size /
    chunk_size)`` chunks with a ragged tail.  Empty layers contribute no
    chunks but keep their name/size slot (the flat offsets stay aligned)."""
    sizes = [int(s) for s in sizes]
    if names is None:
        names = [f"layer{i}" for i in range(len(sizes))]
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    chunk_layer, chunk_start, chunk_valid = [], [], []
    off = 0
    for li, size in enumerate(sizes):
        step = size if chunk_size is None else min(chunk_size, max(size, 1))
        pos = 0
        while pos < size:
            valid = min(step, size - pos)
            chunk_layer.append(li)
            chunk_start.append(off + pos)
            chunk_valid.append(valid)
            pos += valid
        off += size
    if not chunk_start:
        raise ValueError(f"no non-empty layers in {sizes}")
    return ChunkSpec(
        numel=off, chunk_numel=max(chunk_valid),
        layer_names=tuple(names), layer_sizes=tuple(sizes),
        chunk_layer=tuple(chunk_layer), chunk_start=tuple(chunk_start),
        chunk_valid=tuple(chunk_valid))


def _leaf_paths(tree, prefix: str = ""):
    """``(keystr, leaf)`` in ``jax.tree.flatten`` order: dict keys sorted as
    ``['key']``, list and tuple items in order as ``[i]``."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaf_paths(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaf_paths(sub, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def chunk_spec_from_tree(tree, chunk_size: Optional[int] = None) -> ChunkSpec:
    """Spec whose layers are the tree's leaves, in flat-concatenation order
    (matching :func:`repro_torch.core.compression.flatten_pytree`), named
    as the reference's ``jax.tree_util.keystr`` names them."""
    paths = list(_leaf_paths(tree))
    names = [name for name, _ in paths]
    sizes = [int(np.prod(tuple(leaf.shape), dtype=np.int64))
             for _, leaf in paths]
    return chunk_spec_from_sizes(sizes, names, chunk_size)


def whole_vector_spec(numel: int) -> ChunkSpec:
    """The degenerate spec: ONE chunk spanning the whole flat vector
    (crossing layer boundaries) -- the flat path, bit for bit."""
    return chunk_spec_from_sizes([numel], names=["all"], chunk_size=None)


# ---------------------------------------------------------------------------
# the chunked codec wrapper
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def _chunk_groups(spec: ChunkSpec, layer_codecs: tuple):
    """Chunks grouped by (unpadded width, layer codec): every group runs
    the base codec's own batched path on one stacked unpadded slice.  Each
    group also carries the flat positions of its chunks, chunk-major
    (``(G * valid,)``).  The group count is small and static."""
    groups: dict = {}
    for c in range(spec.n_chunks):
        key = (spec.chunk_valid[c], layer_codecs[spec.chunk_layer[c]])
        groups.setdefault(key, []).append(c)
    out = []
    for (valid, codec), idxs in groups.items():
        starts = np.asarray([spec.chunk_start[c] for c in idxs], np.int64)
        flat = (starts[:, None] + np.arange(valid)).reshape(-1)
        out.append((valid, codec, tuple(idxs), flat))
    return tuple(out)


@functools.lru_cache(maxsize=256)
def _group_tensors(spec: ChunkSpec, layer_codecs: tuple, g: int,
                   device: torch.device):
    """Group ``g``'s chunk ids and flat positions as tensors on ``device``."""
    _, _, idxs, flat = _chunk_groups(spec, layer_codecs)[g]
    return (torch.tensor(idxs, dtype=torch.int64, device=device),
            torch.from_numpy(flat).to(device))


@functools.lru_cache(maxsize=1024)
def _analytic_bits(spec: ChunkSpec, layer_codecs: tuple, direction: str,
                   n_participating: int) -> float:
    """Eq. 1 summed over every chunk's UNPADDED length (cached: constant
    per frozen codec, but evaluated by the trainers every round)."""
    per_chunk = (layer_codecs[li] for li in spec.chunk_layer)
    if direction == "up":
        return float(sum(c.upload_bits(v)
                         for c, v in zip(per_chunk, spec.chunk_valid)))
    return float(sum(c.download_bits(v, n_participating=n_participating)
                     for c, v in zip(per_chunk, spec.chunk_valid)))


def _state_index(chunks, valid, leaf_ndim, lead: int):
    """Index tuple selecting ``chunks`` (an id or an id tensor; truncated to
    ``valid`` on a trailing block axis) out of a state leaf with ``lead``
    leading axes before the chunk axis."""
    ix = (slice(None),) * lead + (chunks,)
    if leaf_ndim > lead + 1:
        ix = ix + (Ellipsis, slice(0, valid))
    return ix


def _take_chunks(state, chunks, valid, lead):
    return map_states(
        lambda x: x[_state_index(chunks, valid, x.ndim, lead)], state)


def _put_chunks(full, upd, chunks, valid, lead):
    """Write ``upd`` into the chunks of ``full`` (a state the caller owns)."""
    def put(f, u):
        f[_state_index(chunks, valid, f.ndim, lead)] = u
        return f
    return map_states(put, full, upd)


def _state_device(state, default="cpu"):
    """The device of a state's first tensor (``default`` when stateless)."""
    leaves = []
    map_states(lambda x: leaves.append(x) or x, state)
    return leaves[0].device if leaves else torch.device(default)


@dataclasses.dataclass(frozen=True)
class ChunkedCodec(Codec):
    """A base :class:`Codec` applied independently per ``(layer, chunk)``.

    Implements the flat codec interface over the full ``numel`` vector, so
    both trainers carry it unchanged; internally every chunk has its own
    k-selection, µ, residual state, wire sub-stream and ledger entry.
    Build it with :func:`chunk_codec` (which applies the per-layer sparsity
    schedule and forwards the base codec's trainer-visible fields).
    """

    name = "chunked"

    base: Codec = None
    spec: ChunkSpec = None
    layer_codecs: tuple = ()
    #: adaptive per-chunk sparsity controller (repro_torch.core.adaptive);
    #: None or a non-adapting controller ("fixed") runs the static path
    controller: Optional[SparsityController] = None

    # -- forwarded base behaviour (properties shadow the base-class
    #    ClassVars: a wrapper is whatever its base is) ------------------------
    @property
    def error_feedback(self):                                  # noqa: D401
        return self.base.error_feedback

    @property
    def wire_format(self):
        return self.base.wire_format

    @property
    def wire_static_size(self):
        return self.base.wire_static_size

    @property
    def supports_ingest(self):
        return self.base.supports_ingest

    def _chunk_codecs(self):
        """Per-chunk codec (the layer's, after the p_fn schedule)."""
        return tuple(self.layer_codecs[li] for li in self.spec.chunk_layer)

    def _chunk_ps(self, direction: str) -> np.ndarray:
        field = "sparsity_up" if direction == "up" else "sparsity_down"
        return np.asarray([getattr(c, field) for c in self._chunk_codecs()],
                          np.float64)

    def _groups(self):
        return _chunk_groups(self.spec, self.layer_codecs)

    def _group_tensors(self, g: int, device):
        return _group_tensors(self.spec, self.layer_codecs, g,
                              torch.device(device))

    # -- adaptive-controller geometry ----------------------------------------
    def _adapts(self) -> bool:
        return self.controller is not None and self.controller.adapts

    def _ctrl_stateful(self) -> bool:
        return self._adapts() and self.controller.stateful

    def _ctrl_geometry(self, direction: str):
        """Static (base_ks, caps) for the controller: the fixed-p schedule's
        per-chunk k budget and the controller's selection ceilings."""
        base_ks = self.spec.chunk_ks(self._chunk_ps(direction))
        valid = np.asarray(self.spec.chunk_valid, np.int64)
        return base_ks, self.controller.caps(base_ks, valid)

    def _split_ctrl(self, state):
        """Unwrap ``{"base": codec_state, "ctrl": controller_state}`` (the
        wrap exists only for stateful controllers)."""
        if not self._ctrl_stateful():
            return state, None
        return state["base"], state["ctrl"]

    def _join_ctrl(self, base_state, ctrl_state):
        if not self._ctrl_stateful():
            return base_state
        return {"base": base_state, "ctrl": ctrl_state}

    # -- state ----------------------------------------------------------------
    def _init_state(self, one, direction: str, device):
        base = stack_states(one, self.spec.n_chunks)
        if not self._ctrl_stateful():
            return base
        return {"base": base,
                "ctrl": self.controller.init_state(
                    self._ctrl_geometry(direction)[0], device)}

    def init_client_state(self, numel: int, device=None):
        return self._init_state(
            self.base.init_client_state(self.spec.chunk_numel, device), "up",
            device)

    def init_server_state(self, numel: int, device=None):
        return self._init_state(
            self.base.init_server_state(self.spec.chunk_numel, device),
            "down", device)

    # -- client side ----------------------------------------------------------
    def encode(self, delta, state):
        msgs, states, stats = self.encode_batch(
            delta[None], map_states(lambda x: x[None], state))
        return (msgs[0], map_states(lambda x: x[0], states),
                CompressionStats(*(s[0] for s in stats)))

    def encode_batch(self, deltas, states):
        spec = self.spec
        if self._adapts():
            base_st, ctrl_st = self._split_ctrl(states)
            base_ks, caps = self._ctrl_geometry("up")
            msg_blocks, base_st, ctrl_st, _ = \
                self.base.encode_chunk_blocks_adaptive(
                    spec.split(deltas), base_st, self.controller, ctrl_st,
                    base_ks=base_ks, caps=caps)
            msgs = spec.merge(msg_blocks)
            states = self._join_ctrl(base_st, ctrl_st)
        elif self.base.chunk_blocks:
            msg_blocks, states, _ = self.base.encode_chunk_blocks(
                spec.split(deltas), states,
                ks=spec.chunk_ks(self._chunk_ps("up")))
            msgs = spec.merge(msg_blocks)
        else:
            msgs, states = self._grouped_encode(deltas, states)
        P = msgs.shape[0]
        stats = CompressionStats(
            nnz=(msgs != 0).sum(dim=-1),
            numel=torch.full((P,), spec.numel),
            mu=torch.zeros(P, dtype=torch.float32, device=msgs.device))
        return msgs, states, stats

    def _grouped_encode(self, deltas, states):
        """The base codec's ``encode_batch`` once a group, on its ``(P * G,
        valid)`` rows (client-major)."""
        P = deltas.shape[0]
        msgs = torch.zeros_like(deltas)
        states = map_states(torch.clone, states)
        for g, (valid, codec, idxs, _) in enumerate(self._groups()):
            G = len(idxs)
            ids, flat = self._group_tensors(g, deltas.device)
            sub = deltas.index_select(-1, flat).reshape(P * G, valid)
            st = map_states(lambda x: x.reshape((P * G,) + x.shape[2:]),
                            _take_chunks(states, ids, valid, lead=1))
            m, st, _ = codec.encode_batch(sub, st)
            msgs.index_copy_(-1, flat, m.reshape(P, G * valid)
                             .to(msgs.dtype))
            _put_chunks(states, map_states(
                lambda x: x.reshape((P, G) + x.shape[1:]), st), ids, valid,
                lead=1)
        return msgs, states

    # -- server side ----------------------------------------------------------
    def aggregate(self, msgs, server_state, mask=None, staleness=None):
        spec = self.spec
        if self._adapts():
            base_st, ctrl_st = self._split_ctrl(server_state)
            base_ks, caps = self._ctrl_geometry("down")
            out_blocks, base_st, ctrl_st, _ = \
                self.base.aggregate_chunk_blocks_adaptive(
                    spec.split(msgs), base_st, self.controller, ctrl_st,
                    base_ks=base_ks, caps=caps, mask=mask,
                    staleness=staleness)
            out = spec.merge(out_blocks)
            server_state = self._join_ctrl(base_st, ctrl_st)
        elif self.base.chunk_blocks:
            out_blocks, server_state, _ = self.base.aggregate_chunk_blocks(
                spec.split(msgs), server_state,
                ks=spec.chunk_ks(self._chunk_ps("down")), mask=mask,
                staleness=staleness)
            out = spec.merge(out_blocks)
        else:
            out, server_state = self._per_chunk(
                server_state, msgs.device,
                lambda codec, lo, hi, st: codec.aggregate(
                    msgs[:, lo:hi], st, mask=mask, staleness=staleness))
        return out, server_state, self._out_stats(out)

    def _per_chunk(self, server_state, device, fn):
        """``fn(codec, lo, hi, chunk_state) -> (out, state, stats)`` on
        every chunk's flat slice ``[lo, hi)``; returns the merged output
        and the updated server state."""
        spec = self.spec
        out = torch.zeros(spec.numel, dtype=torch.float32, device=device)
        server_state = map_states(torch.clone, server_state)
        for valid, codec, idxs, _ in self._groups():
            for ci in idxs:
                lo = spec.chunk_start[ci]
                o, st, _ = fn(codec, lo, lo + valid,
                              _take_chunks(server_state, ci, valid, lead=0))
                out[lo:lo + valid] = o.to(device)
                _put_chunks(server_state, st, ci, valid, lead=0)
        return out, server_state

    def _out_stats(self, out):
        return CompressionStats(nnz=(out != 0).sum(),
                                numel=torch.tensor(self.spec.numel),
                                mu=torch.tensor(0.0))

    # -- analytic bit ledger (Eq. 1 summed over chunks) -----------------------
    # cached: the codec is frozen/hashable and the trainers evaluate these
    # on the host every round (a fine-chunked model has 10k+ chunks)
    def upload_bits(self, numel: int) -> float:
        return _analytic_bits(self.spec, self.layer_codecs, "up", 1)

    def download_bits(self, numel: int, n_participating: int = 1) -> float:
        return _analytic_bits(self.spec, self.layer_codecs, "down",
                              n_participating)

    # -- wire format: one sub-stream + header per chunk -----------------------
    def _host_rows(self, msgs):
        """Each width group's ``(P * G, valid)`` rows (client-major) on the
        host, from ONE copy of the round: a tensor is gathered group by
        group where it lies and copied down once; a host array is gathered
        on the host."""
        groups = self._groups()
        if isinstance(msgs, torch.Tensor):
            x = msgs.reshape(-1, self.spec.numel).to(torch.float32)
            host = torch.cat([
                x.index_select(-1, self._group_tensors(g, x.device)[1])
                .reshape(-1) for g in range(len(groups))]).cpu().numpy()
        else:
            x = np.asarray(msgs, np.float32).reshape(-1, self.spec.numel)
            host = np.concatenate([x[:, flat].reshape(-1)
                                   for _, _, _, flat in groups])
        sizes = [x.shape[0] * flat.size for _, _, _, flat in groups]
        return x.shape[0], [part.reshape(-1, valid) for part, (valid, *_) in
                            zip(np.split(host, np.cumsum(sizes)[:-1]),
                                groups)]

    def encode_wire_batch(self, msgs, *, direction: str = "up",
                          device=None) -> wire.ChunkedWireBatch:
        """One copy of the round's messages to the host, then one
        ``encode_wire_batch`` of the group's codec a group (packed on the
        messages' device, or ``device`` for host messages)."""
        if isinstance(msgs, torch.Tensor) and device is None:
            device = msgs.device
        P, rows = self._host_rows(msgs)
        batches, group_ids, group_valid = [], [], []
        bit_len = np.zeros(P, np.int64)
        nnz = np.zeros(P, np.int64)
        for (valid, codec, idxs, _), x in zip(self._groups(), rows):
            G = len(idxs)
            wb = codec.encode_wire_batch(x, direction=direction,
                                         device=device)
            batches.append(wb)
            group_ids.append(idxs)
            group_valid.append(valid)
            bit_len += np.asarray(wb.bit_len).reshape(P, G).sum(axis=1)
            nnz += np.asarray(wb.nnz).reshape(P, G).sum(axis=1)
        return wire.ChunkedWireBatch(
            batches=tuple(batches), chunk_ids=tuple(group_ids),
            chunk_valid=tuple(group_valid), bit_len=bit_len, nnz=nnz,
            n_msgs=P, numel=self.spec.numel, n_chunks=self.spec.n_chunks)

    def encode_wire(self, msg, *, direction: str = "up"):
        return wire.ChunkedWireMessage(self.encode_wire_batch(
            msg.reshape(1, -1) if isinstance(msg, torch.Tensor)
            else np.asarray(msg).reshape(1, -1), direction=direction))

    def decode_wire_batch(self, batch: wire.ChunkedWireBatch, *,
                          direction: str = "up") -> np.ndarray:
        spec = self.spec
        out = np.zeros((batch.n_msgs, spec.numel), np.float32)
        # group order is deterministic: batches[g] parallels _groups()[g]
        for (valid, codec, idxs, _), wb in zip(self._groups(),
                                               batch.batches):
            G = len(idxs)
            for p in range(batch.n_msgs):
                for j, ci in enumerate(idxs):
                    lo = spec.chunk_start[ci]
                    out[p, lo:lo + valid] = codec.decode_wire(
                        wb.message(p * G + j), direction=direction)
        return out

    def decode_wire(self, msg, *, direction: str = "up") -> np.ndarray:
        if isinstance(msg, wire.ChunkedWireMessage):
            msg = msg.batch
        return self.decode_wire_batch(msg, direction=direction)[0]

    # -- fused ingest: every chunk sub-stream scatters into its flat slice --
    def ingest_wire(self, acc, msg, weight, *, direction: str = "up",
                    device=None):
        if isinstance(msg, wire.ChunkedWireMessage):
            msg = msg.batch
        self.ingest_wire_batch(acc, msg, np.asarray([weight], np.float64),
                               direction=direction, device=device)

    def ingest_wire_batch(self, acc, batch: wire.ChunkedWireBatch, weights,
                          *, direction: str = "up", device=None):
        """Every message accounted in order (its bits with every chunk's
        header), then each group's sub-streams through the group codec's
        ``ingest_wire_rows`` in one go, row ``p * G + j`` at chunk
        ``idxs[j]``'s flat offset with message ``p``'s weight: each
        coordinate lies in one chunk, so its adds come in message order,
        as in the reference's per-(message, chunk) loop."""
        w = np.asarray(weights, np.float64)
        header = self._header_bits_per_msg()
        for i in range(batch.n_msgs):
            acc.begin_message(float(w[i]),
                              bits=float(batch.bit_len[i]) + header)
        starts = np.asarray(self.spec.chunk_start, np.int64)
        for (valid, codec, idxs, _), wb in zip(self._groups(),
                                               batch.batches):
            G = len(idxs)
            codec.ingest_wire_rows(
                acc, wb, np.repeat(w, G),
                np.tile(starts[np.asarray(idxs)], batch.n_msgs),
                direction=direction, device=device)

    def finalize_ingest(self, combined, server_state):
        spec = self.spec
        if self._adapts() or self.base.chunk_blocks:
            base_st, ctrl_st = self._split_ctrl(server_state)
            blocks = spec.split(torch.from_numpy(
                np.asarray(combined, np.float32)).to(_state_device(base_st)))
            # a (1, C, W) block tensor: the combine of one row is the row
            if self._adapts():
                base_ks, caps = self._ctrl_geometry("down")
                out_blocks, base_st, ctrl_st, _ = \
                    self.base.aggregate_chunk_blocks_adaptive(
                        blocks[None], base_st, self.controller, ctrl_st,
                        base_ks=base_ks, caps=caps)
            else:
                out_blocks, base_st, _ = self.base.aggregate_chunk_blocks(
                    blocks[None], base_st,
                    ks=spec.chunk_ks(self._chunk_ps("down")))
            out = spec.merge(out_blocks)
            server_state = self._join_ctrl(base_st, ctrl_st)
        elif self.base.init_server_state(1) is None:
            # stateless elementwise base (signsgd): chunking is a no-op
            return self.base.finalize_ingest(combined, server_state)
        else:
            combined = np.asarray(combined, np.float32)
            out, server_state = self._per_chunk(
                server_state, _state_device(server_state),
                lambda codec, lo, hi, st: codec.finalize_ingest(
                    combined[lo:hi], st))
        return out, server_state, self._out_stats(out)

    def _header_bits_per_msg(self) -> float:
        # every chunk carries the base codec's side information independently
        return self.spec.n_chunks * self.base.wire_header_bits

    def measured_batch_bits(self, batch) -> float:
        return batch.total_bits() + batch.n_msgs * self._header_bits_per_msg()

    def measured_message_bits(self, msg) -> float:
        return msg.bit_len + self._header_bits_per_msg()

    def wire_bound_bits(self, numel, nnz, direction="up"):
        # Each chunk's bound is monotone in its nnz, so charging every chunk
        # min(nnz, valid) ceilings ANY split of nnz across chunks; at
        # whole-vector this reduces exactly to the base codec's bound.
        per_chunk = [c.wire_bound_bits(v, min(int(nnz), v), direction)
                     for c, v in zip(self._chunk_codecs(),
                                     self.spec.chunk_valid)]
        if any(b is None for b in per_chunk):
            return None
        return float(sum(per_chunk))


def chunk_codec(base: Codec, spec: ChunkSpec,
                p_fn: Optional[Callable] = None,
                controller=None) -> ChunkedCodec:
    """Wrap ``base`` into a :class:`ChunkedCodec` over ``spec``.

    ``p_fn(layer_name, depth) -> p | None`` rescales the sparsity of layers
    whose codec declares ``sparsity_up``/``sparsity_down`` (None keeps the
    base value); other codecs ignore the hook.  Every schedule-produced p
    is validated at wrap time (finite, 0 < p <= 1) with a ``ValueError``
    naming the offending layer.

    ``controller`` is a registered :class:`repro_torch.core.adaptive.
    SparsityController` name or instance; ``"fixed"``/None keep the static
    path, adaptive controllers require a base codec with the fused
    chunk-blocks path (``TypeError`` otherwise).  The wrapper forwards the
    base codec's trainer-visible knobs (``local_iters``, staleness decay,
    the aggregation ``rule``).
    """
    if isinstance(base, ChunkedCodec):
        raise TypeError("chunk_codec over an already-chunked codec")
    ctrl = make_controller(controller) if controller is not None else None
    if ctrl is not None and ctrl.adapts and not base.chunk_blocks:
        raise TypeError(
            f"adaptive sparsity controller {ctrl.name!r} requires a codec "
            f"with the fused chunk-blocks path (chunk_blocks=True); "
            f"{type(base).__name__} has none")
    fields = {f.name for f in dataclasses.fields(type(base))}
    layer_codecs = []
    for depth, lname in enumerate(spec.layer_names):
        c = base
        p = p_fn(lname, depth) if p_fn is not None else None
        if p is not None:
            p = validate_sparsity(p, lname, depth)
            repl = {k: float(p) for k in ("sparsity_up", "sparsity_down")
                    if k in fields}
            if repl:
                c = dataclasses.replace(base, **repl)
        layer_codecs.append(c)
    return ChunkedCodec(base=base, spec=spec, layer_codecs=tuple(layer_codecs),
                        controller=ctrl,
                        local_iters=base.local_iters,
                        staleness_decay=base.staleness_decay,
                        rule=base.rule)
