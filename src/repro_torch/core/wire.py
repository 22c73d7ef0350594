"""Vectorized wire-format subsystem: batched Golomb/ternary bitstream packing.

The port's numpy copy of ``repro/core/wire.py``: every stream it packs is
byte-identical to the reference's.  Only the ``"kernel"`` backend differs:
its packers, its ternary field decoder and its sign-plane unpacker are the
CUDA kernels of :mod:`repro_torch.kernels.bitpack` (Golomb chunks and sign
planes) and :mod:`repro_torch.kernels.wiredecode`.  Two entries serve the
signSGD codec's ``"kernel"`` backend on tensor rounds:
:func:`pack_sign_planes_batch` packs a round's fp32 messages where they
lie, and :func:`sign_plane_rows` checks a batch's planes and lays their
words out for the ingest's one-launch tally.

The paper's communication claims rest on the REAL Golomb-encoded ternary
bitstream (Algorithms 3-4, Eqs. 15-17).  The per-bit host loop in
:mod:`repro_torch.core.golomb` is the correctness oracle; this module is the
production packer, vectorized end to end:

1. **Codeword fields** -- every non-zero's gap splits into the Golomb pair
   ``(q, r) = divmod(gap - 1, 2^b*)``; the codeword is ``q`` unary ones, a
   terminator ``0``, ``b*`` remainder bits (MSB first) and one sign bit.
   All fields are computed with numpy vector ops over the whole tensor.
2. **Chunk decomposition** -- each codeword becomes ``q // 32`` full
   32-one chunks plus one tail chunk ``(rem_ones, 0, r, sign)`` of at most
   ``31 + b* + 2 <= 63`` bits, so every chunk fits a uint64 ``(length,
   value)`` pair regardless of how pathological the gaps are.
3. **Exclusive-scan scatter** -- chunk bit offsets are the exclusive cumsum
   of chunk lengths; each chunk lands in the packed word stream with two
   masked shifts (a chunk spans at most one uint64 boundary), OR-aggregated
   per word by ``bitwise_or.reduceat`` over the (sorted) word indices.
   No per-bit Python anywhere.

The packed stream is canonical: stream bit ``t`` lives in uint32 word
``t >> 5`` at bit ``31 - (t & 31)`` (MSB-first), so the byte view equals
``np.packbits`` of the oracle's bit sequence -- bit-identical streams are a
byte-compare away (asserted in tests/test_wire.py).

``encode_ternary_words_batch`` packs a whole federated round's ``(P, numel)``
client messages in ONE vectorized pass into a single word-aligned stream
(per-client slices are views), which beats P sequential single-message packs.

Backends mirror :func:`repro_torch.core.compression.get_stc_backend`: ``"numpy"``
is the host scatter above; ``"kernel"`` copies the chunk fields to the
device and ORs them into 32-bit words there with the CUDA kernel
:func:`repro_torch.kernels.bitpack.pack_chunks` (its plain PyTorch version
when the backend is asked for the CPU), so the card and the CPU share one
API.  Above the fused-batch limit the ``"kernel"`` backend still builds each
client's chunks on its own, as the per-client regime does, but packs the
whole round in one call.

Decode is vectorized end to end -- and multi-segment: ONE pass parses every
client stream of a word-aligned batch into ``(seg, positions, signs)``.  On
``"numpy"``: one host bit unpack (``unpackbits``), one ``searchsorted`` over
the zero positions giving each candidate terminator its successor (capped
at its own segment's data end), then a pointer-doubling transitive closure
-- ``O(Z log Z)`` array ops, no Python chase -- marks each segment's
terminator chain; batch gathers recover remainders and signs and a
segmented cumsum the positions.  On ``"kernel"``: the words go to the
device and the CUDA Golomb decoder of :mod:`repro_torch.kernels.wiredecode`
parses the fields there (a chunk-parallel decode; its plain version, asked
for the CPU, is the scan above in torch), so the fields, not the bits, come
back.  Truncated or corrupt payloads (``bit_len`` past the buffer, a run
past ``numel``, a stream ending mid-codeword, a codeword count other than
the advertised ``nnz``) raise :class:`WireDecodeError` on every path.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np

from . import golomb

__all__ = [
    "WireMessage",
    "WireBatch",
    "ChunkedWireBatch",
    "ChunkedWireMessage",
    "WireBackend",
    "WireDecodeError",
    "get_wire_backend",
    "register_wire_backend",
    "encode_ternary_words",
    "encode_ternary_words_batch",
    "decode_ternary_words",
    "decode_ternary_words_batch",
    "decode_ternary_fields",
    "decode_ternary_fields_batch",
    "pack_sign_words",
    "pack_sign_planes_batch",
    "unpack_sign_words",
    "sign_plane_bits",
    "sign_plane_rows",
    "concat_messages",
    "words_to_bits",
    "words_to_bytes",
]


class WireDecodeError(ValueError):
    """A wire payload failed validation during decode: the advertised
    ``bit_len`` overruns the word buffer, a unary run crosses the stream
    end, the stream ends mid-codeword, or a decoded position overflows the
    target tensor.  Subclasses :class:`ValueError` so pre-existing callers
    catching the old untyped errors keep working."""

_U64 = np.uint64
_MAX_B_STAR = 30  # tail chunk must fit 63 bits: 31 ones + b* + 2
# fused-batch crossover: above this many total non-zeros the fused pass's
# working set leaves L2 and cache-resident per-client packs are faster
_FUSED_NNZ_MAX = 32768


class WireMessage(NamedTuple):
    """One packed bitstream message.

    ``words`` is the canonical uint32 stream (MSB-first within each word),
    ``bit_len`` the number of meaningful bits, ``mu`` the ternary magnitude
    (or the signSGD step), ``numel`` the decoded tensor length and ``nnz``
    the number of coded positions (= ``numel`` for dense sign streams).
    """

    words: np.ndarray
    bit_len: int
    mu: float
    numel: int
    nnz: int

    def payload_bytes(self) -> np.ndarray:
        """Packed uint8 view, trimmed to ``ceil(bit_len / 8)`` bytes."""
        return words_to_bytes(self.words, self.bit_len)


class WireBatch(NamedTuple):
    """A batch of messages packed into ONE word-aligned uint32 stream.

    Client ``i`` owns ``words[word_start[i] : word_start[i] + word_count[i]]``
    with ``bit_len[i]`` meaningful bits; slicing is a view, not a copy.
    """

    words: np.ndarray       # (total_words,) uint32
    word_start: np.ndarray  # (P,) int64
    word_count: np.ndarray  # (P,) int64
    bit_len: np.ndarray     # (P,) int64
    mu: np.ndarray          # (P,) float64
    nnz: np.ndarray         # (P,) int64
    numel: int

    @property
    def n_msgs(self) -> int:
        return len(self.bit_len)

    def message(self, i: int) -> WireMessage:
        s, c = int(self.word_start[i]), int(self.word_count[i])
        return WireMessage(self.words[s : s + c], int(self.bit_len[i]),
                           float(self.mu[i]), self.numel, int(self.nnz[i]))

    def rows(self, i0: int, i1: int) -> "WireBatch":
        """View of message rows ``[i0, i1)`` as their own batch (no copy --
        rows are word-contiguous by construction).  Lets the ingest path
        decode a fleet round in bounded-workspace blocks."""
        w0 = int(self.word_start[i0]) if i1 > i0 else 0
        w1 = (int(self.word_start[i1 - 1] + self.word_count[i1 - 1])
              if i1 > i0 else 0)
        return WireBatch(self.words[w0:w1], self.word_start[i0:i1] - w0,
                         self.word_count[i0:i1], self.bit_len[i0:i1],
                         self.mu[i0:i1], self.nnz[i0:i1], self.numel)

    def total_bits(self) -> float:
        return float(self.bit_len.sum())


class ChunkedWireBatch(NamedTuple):
    """A round of chunked messages: per-(message, chunk) sub-streams.

    The chunked codecs (:mod:`repro_torch.core.chunking`) frame every message as
    one independent sub-stream PER CHUNK, each with its own side-information
    header (e.g. a per-chunk Golomb µ).  Chunks sharing wire parameters are
    fused group-wise: ``batches[g]`` is ONE word-aligned :class:`WireBatch`
    whose rows are message-major -- row ``p * len(chunk_ids[g]) + j`` is
    message ``p``'s sub-stream for chunk ``chunk_ids[g][j]`` (a tensor of
    ``chunk_valid[g]`` decoded elements).

    ``bit_len`` / ``nnz`` are per-MESSAGE totals (summed over that message's
    chunks), so the ledger sees the same shape contract as
    :class:`WireBatch`.
    """

    batches: tuple          # tuple[WireBatch], one per wire-parameter group
    chunk_ids: tuple        # tuple[tuple[int, ...]] chunk ids per group
    chunk_valid: tuple      # tuple[int] decoded elements per chunk, per group
    bit_len: np.ndarray     # (P,) total stream bits per message
    nnz: np.ndarray         # (P,) total coded positions per message
    n_msgs: int
    numel: int              # decoded (merged) tensor length
    n_chunks: int

    def total_bits(self) -> float:
        return float(self.bit_len.sum())

    def message(self, i: int) -> "ChunkedWireMessage":
        """Message ``i`` as a standalone single-row chunked batch (per-group
        word buffers are copies of just that message's rows, so the view is
        safe to ship through the arrival simulator independently)."""
        subs = []
        for wb, ids in zip(self.batches, self.chunk_ids):
            g = len(ids)
            subs.append(concat_messages([wb.message(i * g + j)
                                         for j in range(g)]))
        return ChunkedWireMessage(ChunkedWireBatch(
            tuple(subs), self.chunk_ids, self.chunk_valid,
            self.bit_len[i : i + 1], self.nnz[i : i + 1], 1, self.numel,
            self.n_chunks))


class ChunkedWireMessage(NamedTuple):
    """ONE chunked message (a :class:`ChunkedWireBatch` with ``n_msgs==1``),
    quacking like :class:`WireMessage` for the trainers' ledger hooks."""

    batch: ChunkedWireBatch

    @property
    def bit_len(self) -> int:
        return int(self.batch.bit_len[0])

    @property
    def nnz(self) -> int:
        return int(self.batch.nnz[0])

    @property
    def numel(self) -> int:
        return self.batch.numel

    @property
    def n_chunks(self) -> int:
        return self.batch.n_chunks


# ---------------------------------------------------------------------------
# word-stream helpers (canonical bit order: MSB-first within uint32 words)
# ---------------------------------------------------------------------------


def words_to_bytes(words: np.ndarray, bit_len: int) -> np.ndarray:
    """uint32 word stream -> packed uint8 payload (np.packbits convention)."""
    by = np.ascontiguousarray(np.asarray(words).astype(">u4")).view(np.uint8)
    return by[: (int(bit_len) + 7) // 8]


def words_to_bits(words: np.ndarray, bit_len: int) -> np.ndarray:
    """uint32 word stream -> uint8 0/1 array of length ``bit_len``."""
    nbytes = (int(bit_len) + 7) // 8
    payload = words_to_bytes(words, 8 * nbytes)
    return np.unpackbits(payload)[: int(bit_len)]


def _bytes_to_words(payload: np.ndarray) -> np.ndarray:
    by = np.ascontiguousarray(payload, np.uint8)
    pad = (-by.size) % 4
    if pad:
        by = np.concatenate([by, np.zeros(pad, np.uint8)])
    return by.view(">u4").astype(np.uint32)


# ---------------------------------------------------------------------------
# packing backends ("numpy" host scatter / "kernel" CUDA word packer)
# ---------------------------------------------------------------------------


class WireBackend(NamedTuple):
    """How chunk streams and dense bit planes become uint32 words -- and back.

    ``pack_chunks(vals, lens, offs, total_bits)``: uint64 ``(value, length)``
    chunk arrays at exclusive-scan bit offsets -> canonical uint32 words.
    ``pack_bits(bits)``: a dense uint8 0/1 array -> canonical uint32 words.
    ``unpack_bits(words)``: the sign-plane decode -- ALL ``32 * n_words``
    MSB-first bits as uint8 0/1.
    ``decode_fields(words, word_start, bit_len, nnz, numel, b)``: the
    ternary decode -- every segment's Golomb codewords as ``(seg,
    positions, signs)``, raising :class:`WireDecodeError` on corruption
    (including a codeword count other than ``nnz``).
    All must be bit-identical across backends.
    """

    name: str
    pack_chunks: Callable
    pack_bits: Callable
    unpack_bits: Callable
    decode_fields: Callable


def _or_group_sorted(u64: np.ndarray, idx: np.ndarray,
                     contrib: np.ndarray) -> None:
    """``u64[idx] |= contrib`` with OR-aggregation of duplicate indices.

    ``idx`` is non-decreasing (chunk offsets are an exclusive scan), so the
    duplicates are runs: one ``bitwise_or.reduceat`` per run start replaces
    the (much slower) ``ufunc.at`` scatter.
    """
    first = np.empty(idx.shape, bool)
    first[0] = True
    np.not_equal(idx[1:], idx[:-1], out=first[1:])
    starts = np.flatnonzero(first)
    u64[idx[starts]] |= np.bitwise_or.reduceat(contrib, starts)


def _scatter_chunks_numpy(vals: np.ndarray, lens: np.ndarray,
                          offs: np.ndarray, total_bits: int) -> np.ndarray:
    """Exclusive-scan chunk scatter into uint64 accumulation words.

    (A uint32-specialized variant for <=32-bit chunks was measured SLOWER
    than this uint64 path on x86 numpy -- the narrow-int ops don't pay for
    the extra conversions -- so one width serves every regime.)
    """
    n_words32 = (int(total_bits) + 31) // 32
    u64 = np.zeros((n_words32 + 1) // 2, _U64)
    if len(vals):
        vals = vals.astype(_U64, copy=False)
        end = (offs + lens).astype(_U64)
        k_hi = (end - _U64(1)) >> _U64(6)
        s = _U64(64) * (k_hi + _U64(1)) - end          # 0..63
        _or_group_sorted(u64, k_hi, np.left_shift(vals, s))
        k_lo = offs.astype(_U64) >> _U64(6)
        cross = k_lo != k_hi                            # cross => 1 <= 64-s <= 63
        if cross.any():
            _or_group_sorted(u64, k_lo[cross],
                             np.right_shift(vals[cross], _U64(64) - s[cross]))
    words = np.empty(2 * u64.size, np.uint32)
    words[0::2] = (u64 >> _U64(32)).astype(np.uint32)
    words[1::2] = (u64 & _U64(0xFFFFFFFF)).astype(np.uint32)
    return words[:n_words32]


def _pack_bits_numpy(bits: np.ndarray) -> np.ndarray:
    return _bytes_to_words(np.packbits(np.asarray(bits, np.uint8)))


def _unpack_bits_numpy(words: np.ndarray) -> np.ndarray:
    return words_to_bits(words, 32 * int(np.asarray(words).size))


def _decode_fields_numpy(words, word_start, bit_len, nnz, numel: int,
                         b: int):
    """The host field scan over the host bit unpack, with the per-segment
    count check."""
    seg, positions, signs = _decode_stream_fields(
        _unpack_bits_numpy(words), 32 * np.asarray(word_start, np.int64),
        np.asarray(bit_len, np.int64), numel, b)
    counts = np.bincount(seg, minlength=len(bit_len))
    if np.any(counts != np.asarray(nnz, np.int64)):
        raise WireDecodeError("corrupt golomb stream: decoded nnz mismatch")
    return seg, positions, signs


WIRE_BACKENDS: dict[str, WireBackend] = {
    "numpy": WireBackend("numpy", _scatter_chunks_numpy, _pack_bits_numpy,
                         _unpack_bits_numpy, _decode_fields_numpy),
}


def register_wire_backend(backend: WireBackend) -> None:
    """Add a host wire backend under ``backend.name`` (``"kernel"`` is
    built per device by :func:`get_wire_backend` and cannot be replaced)."""
    if backend.name == "kernel":
        raise ValueError("the 'kernel' wire backend is built per device; "
                         "register another name")
    WIRE_BACKENDS[backend.name] = backend


@functools.lru_cache(maxsize=None)
def _make_kernel_backend(device=None) -> WireBackend:
    """The ``"kernel"`` backend, one per device (resolved when a stream is
    packed or decoded: CUDA unless the caller names the CPU).  Encode: the
    chunk fields go to ``device`` and
    :func:`repro_torch.kernels.bitpack.pack_chunks` ORs them into words
    there; sign planes go up as bits to
    :func:`repro_torch.kernels.bitpack.pack_bits`.  Ternary decode: the
    words and the segment table go to ``device``,
    :func:`repro_torch.kernels.wiredecode.decode_golomb_fields` parses the
    codewords there, and the fields come back in one copy.  Sign planes:
    the words go to ``device``,
    :func:`repro_torch.kernels.wiredecode.unpack_bits_words` explodes them
    into bits there, and the bits come back."""
    # lazy: keeps core import-light (layering: kernels -> core, never back)

    def pack_bits(bits: np.ndarray) -> np.ndarray:
        import torch
        from repro_torch.device import resolve_device
        from repro_torch.kernels.bitpack import pack_bits as pack_kernel
        t = torch.from_numpy(np.ascontiguousarray(bits, np.uint8))
        words = pack_kernel(t.to(resolve_device(device)))
        return words.cpu().numpy().view(np.uint32)

    def pack_chunks(vals, lens, offs, total_bits):
        import torch
        from repro_torch.device import resolve_device
        from repro_torch.kernels.bitpack import pack_chunks as chunk_kernel
        dev = resolve_device(device)

        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        words = chunk_kernel(up(np.asarray(vals, _U64).view(np.int64),
                                np.int64),
                             up(lens, np.int32), up(offs, np.int64),
                             int(total_bits))
        return words.cpu().numpy().view(np.uint32)

    def unpack_bits(words: np.ndarray) -> np.ndarray:
        import torch
        from repro_torch.device import resolve_device
        from repro_torch.kernels.wiredecode import unpack_bits_words
        w = np.ascontiguousarray(words, np.uint32).view(np.int32)
        bits = unpack_bits_words(
            torch.from_numpy(w).to(resolve_device(device)))
        return bits.cpu().numpy()

    def decode_fields(words, word_start, bit_len, nnz, numel, b):
        import torch
        from repro_torch.device import resolve_device
        from repro_torch.kernels.wiredecode import decode_golomb_fields
        w = np.ascontiguousarray(words, np.uint32).view(np.int32)
        table = [torch.from_numpy(np.array(a, np.int64, ndmin=1))
                 for a in (word_start, bit_len, nnz)]
        fields = decode_golomb_fields(
            torch.from_numpy(w).to(resolve_device(device)), *table,
            int(numel), b)
        return tuple(f.numpy() for f in fields)

    return WireBackend("kernel", pack_chunks, pack_bits, unpack_bits,
                       decode_fields)


def get_wire_backend(name: str, device=None) -> WireBackend:
    """Look up a wire packing backend ("numpy" / "kernel").  ``device`` is
    where the ``"kernel"`` backend packs and unpacks words; the host
    backends ignore it."""
    if name == "kernel":
        return _make_kernel_backend(device)
    if name not in WIRE_BACKENDS:
        raise ValueError(
            f"unknown wire backend {name!r}; options: "
            f"{sorted(set(WIRE_BACKENDS) | {'kernel'})}")
    return WIRE_BACKENDS[name]


# ---------------------------------------------------------------------------
# Golomb ternary encode (vectorized Algorithms 3/4)
# ---------------------------------------------------------------------------


def _b_star_checked(p: float) -> int:
    b = golomb.golomb_b_star(p)
    if b > _MAX_B_STAR:
        raise ValueError(
            f"golomb b*={b} exceeds the packer's 63-bit tail chunk "
            f"(p={p} is far below any practical sparsity)")
    return b


def _codeword_chunks(d: np.ndarray, signs: np.ndarray, b: int):
    """Vectorized codeword fields -> uint64 (value, length) chunk arrays.

    ``d`` is gap-1 per non-zero (int64, >= 0), ``signs`` bool.  Returns
    ``(vals, lens, lengths)`` where ``lengths`` is bits per codeword.
    """
    if b:
        q, r = d >> b, d & ((1 << b) - 1)
    else:
        q, r = d, None
    lengths = q + (b + 2)
    if int(q.max(initial=0)) < 32:
        # fast path (overwhelmingly common: quotients < 32 whenever the
        # configured p is within ~3 octaves of the realized sparsity):
        # one <=63-bit chunk per codeword, no repeat/ownership machinery
        tail_val = ((_U64(1) << q.astype(_U64)) - _U64(1)) << _U64(b + 2)
        if r is not None:
            tail_val |= r.astype(_U64) << _U64(1)
        tail_val |= signs.astype(_U64)
        return tail_val, lengths, lengths
    f = (q >> 5).astype(np.int64)        # full 32-one chunks per codeword
    rem = (q & 31).astype(_U64)
    # tail chunk: rem ones, terminator 0, b remainder bits, sign (<= 63 bits)
    tail_val = ((((_U64(1) << rem) - _U64(1)) << _U64(b + 2))
                | signs.astype(_U64))
    if r is not None:
        tail_val |= r.astype(_U64) << _U64(1)
    tail_len = rem.astype(np.int64) + b + 2
    counts = f + 1
    total_chunks = int(counts.sum())
    owner = np.repeat(np.arange(len(q)), counts)
    starts = np.cumsum(counts) - counts
    is_tail = (np.arange(total_chunks) - starts[owner]) == f[owner]
    vals = np.where(is_tail, tail_val[owner], _U64(0xFFFFFFFF))
    lens = np.where(is_tail, tail_len[owner], 32)
    return vals, lens, lengths


def _message_chunks(x: np.ndarray, nz: np.ndarray, b: int):
    """One flat ternary vector's chunks from its (non-empty) nonzero
    indices: ``(vals, lens, offs, total_bits, mu)``, offsets from 0."""
    nzv = x[nz]
    mu = float(np.abs(nzv).mean())
    d = np.diff(nz, prepend=np.int64(-1)) - 1           # gap-1 >= 0
    vals, lens, _ = _codeword_chunks(d, (nzv > 0), b)
    cs = np.cumsum(lens)
    total_bits = int(cs[-1])    # == lengths.sum(): chunks partition codewords
    return vals, lens, cs - lens, total_bits, mu


def _encode_from_nz(x: np.ndarray, nz: np.ndarray, b: int,
                    backend: str, device=None) -> WireMessage:
    """Pack one flat ternary vector given its precomputed nonzero indices."""
    n = int(x.size)
    if nz.size == 0:
        return WireMessage(np.zeros(0, np.uint32), 0, 0.0, n, 0)
    vals, lens, offs, total_bits, mu = _message_chunks(x, nz, b)
    words = get_wire_backend(backend, device).pack_chunks(vals, lens, offs,
                                                          total_bits)
    return WireMessage(words, total_bits, mu, n, int(nz.size))


def _client_chunks_batch(x: np.ndarray, per_client: list, b: int):
    """Every client's chunks built as :func:`_encode_from_nz` builds them,
    each client's offsets rebased to its word-aligned start: ``(vals, lens,
    offs, batch)``, where ``batch`` is the :class:`WireBatch` that
    :func:`concat_messages` of the per-client messages gives, with
    ``words=None`` until the chunks are packed."""
    parts = [_message_chunks(x[i], nz, b) if nz.size else None
             for i, nz in enumerate(per_client)]
    bit_len = np.asarray([p[3] if p else 0 for p in parts], np.int64)
    word_count = (bit_len + 31) // 32
    word_start = np.cumsum(word_count) - word_count
    live = [i for i, p in enumerate(parts) if p]
    offs = np.concatenate([parts[i][2] + 32 * word_start[i] for i in live])
    batch = WireBatch(None, word_start, word_count, bit_len,
                      np.asarray([p[4] if p else 0.0 for p in parts],
                                 np.float64),
                      np.asarray([nz.size for nz in per_client], np.int64),
                      x.shape[1])
    return (np.concatenate([parts[i][0] for i in live]),
            np.concatenate([parts[i][1] for i in live]), offs, batch)


def encode_ternary_words(tensor: np.ndarray, p: float, *,
                         backend: str = "numpy", device=None) -> WireMessage:
    """Vectorized Algorithm 3: pack a flat ternary tensor into uint32 words.

    Bit-identical to :func:`repro_torch.core.golomb.encode_ternary` (the per-bit
    oracle), orders of magnitude faster on real model sizes.
    """
    b = _b_star_checked(p)
    x = np.asarray(tensor).reshape(-1)
    nz = np.flatnonzero(x != 0)       # bool scan: ~10x faster than on floats
    return _encode_from_nz(x, nz, b, backend, device)


def encode_ternary_words_batch(tensors: np.ndarray, p: float, *,
                               backend: str = "numpy",
                               device=None) -> WireBatch:
    """Batched client-axis encode: ``(P, numel)`` -> one word-aligned stream.

    Cache-resident per-row nonzero scans, then ONE fused chunk/scatter pass
    for the whole cohort; each client's stream starts on a 32-bit word
    boundary so per-client slices are views into the shared buffer.
    """
    b = _b_star_checked(p)
    x = np.asarray(tensors)
    assert x.ndim == 2, x.shape
    P, n = x.shape
    # per-row bool scans stay cache-resident (one (P*n,) scan thrashes LLC)
    per_client = [np.flatnonzero(x[i] != 0) for i in range(P)]
    nnz_c = np.asarray([v.size for v in per_client], np.int64)
    nnz_total = int(nnz_c.sum())
    if nnz_total == 0:
        z = np.zeros(P, np.int64)
        return WireBatch(np.zeros(0, np.uint32), z, z.copy(), z.copy(),
                         np.zeros(P, np.float64), z.copy(), n)
    if nnz_total > _FUSED_NNZ_MAX:
        # dense regime: the fused pass's working set falls out of L2 and
        # per-element cost triples; cache-resident per-client chunk builds
        # win (reusing the scans above)
        if backend != "kernel":
            return concat_messages([
                _encode_from_nz(x[i], per_client[i], b, backend, device)
                for i in range(P)])
        # the device packer takes the whole round's chunks in one call
        vals, lens, offs, batch = _client_chunks_batch(x, per_client, b)
        return batch._replace(words=get_wire_backend(backend, device)
                              .pack_chunks(vals, lens, offs,
                                           32 * int(batch.word_count.sum())))
    # sparse regime (the paper's operating point): ONE fused vectorized
    # pass over all clients amortizes every fixed-cost stage
    pos = np.concatenate(per_client)
    seg_start = np.cumsum(nnz_c) - nnz_c      # first codeword per client
    nonempty = nnz_c > 0                      # reduceat over these starts
    cl = np.repeat(np.arange(P), nnz_c)
    nzvals = x[cl, pos]
    mu_c = np.zeros(P, np.float64)
    mu_c[nonempty] = (np.add.reduceat(np.abs(nzvals, dtype=np.float64),
                                      seg_start[nonempty])
                      / nnz_c[nonempty])

    first = np.zeros(cl.size, bool)
    first[seg_start[nonempty]] = True
    prev = np.empty_like(pos)
    prev[0] = -1
    prev[1:] = pos[:-1]
    d = np.where(first, pos, pos - prev - 1).astype(np.int64)  # gap-1
    vals, lens, lengths = _codeword_chunks(d, (nzvals > 0), b)

    bits_c = np.zeros(P, np.int64)
    bits_c[nonempty] = np.add.reduceat(lengths, seg_start[nonempty])
    word_count = (bits_c + 31) // 32
    word_start = np.cumsum(word_count) - word_count
    # per-codeword global offset: within-client exclusive scan, rebased to
    # the client's word-aligned start
    excl = np.cumsum(lengths) - lengths
    bits_before_client = np.concatenate([[0], np.cumsum(bits_c)[:-1]])
    rebase = 32 * word_start - bits_before_client
    offsets_cw = excl + rebase[cl]
    if len(vals) == len(lengths):
        offs = offsets_cw           # fast path: one chunk per codeword
    else:
        # a codeword's chunks are f 32-one words then the tail, contiguous
        # from its offset; f = (codeword_bits - b - 2) >> 5
        f = ((lengths - b - 2) >> 5).astype(np.int64)
        chunk_counts = f + 1
        owner = np.repeat(np.arange(len(lengths)), chunk_counts)
        starts = np.cumsum(chunk_counts) - chunk_counts
        within = np.arange(int(chunk_counts.sum())) - starts[owner]
        offs = offsets_cw[owner] + 32 * within
    total_words = int(word_count.sum())
    words = get_wire_backend(backend, device).pack_chunks(
        vals, lens, offs, 32 * total_words)
    return WireBatch(words[:total_words], word_start, word_count, bits_c,
                     mu_c, nnz_c, n)


# ---------------------------------------------------------------------------
# decode (vectorized Algorithm 4, multi-segment)
# ---------------------------------------------------------------------------


def _decode_stream_fields(bits: np.ndarray, seg_start: np.ndarray,
                          seg_len: np.ndarray, numel: int,
                          b: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse every segment's Golomb codewords out of ONE unpacked bit array.

    ``bits`` covers ALL ``32 * n_words`` stream bits (word padding included);
    segment ``i`` owns ``[seg_start[i], seg_start[i] + seg_len[i])``.  A
    codeword terminator is a 0-bit whose successor terminator sits ``b + 2``
    bits past it: one ``searchsorted`` over the zero positions builds those
    links for every candidate at once (final terminators -- landing exactly
    on their segment's data end -- and overruns point at a sentinel), then a
    pointer-doubling transitive closure marks each segment's chain from its
    first zero in ``O(Z log Z)`` array ops.  Padding zeros overrun their
    segment end, so a reached overrun IS a truncated codeword; every active
    segment must reach a final terminator or the stream ended mid-codeword.
    (A corrupt segment's chain may escape into a neighbour's zeros -- that
    only ADDS failure flags, never removes one, so valid batches are immune.)

    Returns ``(cw_seg, positions, signs)``: the owning segment index, decoded
    tensor position and ±1.0 sign of every codeword, segment-major in stream
    order.  Raises :class:`WireDecodeError` on any corruption.
    """
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64),
             np.zeros(0, np.float32))
    active = np.flatnonzero(seg_len > 0)
    if active.size == 0:
        return empty
    seg_end = seg_start + seg_len
    zeros = np.flatnonzero(bits == 0).astype(np.int64)
    Z = zeros.size
    if Z == 0:
        raise WireDecodeError("corrupt golomb stream: no unary terminator")
    seg_of = np.searchsorted(seg_start, zeros, side="right") - 1
    nxt = zeros + b + 2
    is_final = nxt == seg_end[seg_of]
    overrun = nxt > seg_end[seg_of]
    succ = np.full(Z + 1, Z, np.int64)          # sentinel self-loop at Z
    interior = ~(is_final | overrun)
    succ[:Z][interior] = np.searchsorted(zeros, nxt[interior])
    seeds = np.searchsorted(zeros, seg_start[active])
    if np.any(seeds >= Z):
        raise WireDecodeError("corrupt golomb stream: no unary terminator")
    reached = np.zeros(Z + 1, bool)
    reached[seeds] = True
    jump = succ                                  # covers 2^k steps at iter k
    while True:
        idx = np.flatnonzero(reached[:Z])
        reached[jump[idx]] = True
        if np.count_nonzero(reached[:Z]) == idx.size:
            break
        jump = jump[jump]
    sel = reached[:Z]
    if np.any(sel & overrun):
        raise WireDecodeError("corrupt golomb stream: truncated codeword")
    ok = np.zeros(len(seg_start), bool)
    ok[seg_of[sel & is_final]] = True
    if not ok[active].all():
        raise WireDecodeError("corrupt golomb stream: truncated codeword")
    T = zeros[sel]                               # terminators, stream order
    cw_seg = seg_of[sel]
    first = np.ones(T.size, bool)
    first[1:] = cw_seg[1:] != cw_seg[:-1]
    fidx = np.flatnonzero(first)
    starts = np.empty_like(T)
    starts[fidx] = seg_start[cw_seg[fidx]]
    nonfirst = np.flatnonzero(~first)
    starts[nonfirst] = T[nonfirst - 1] + b + 2
    q = T - starts
    if b:
        rbits = bits[T[:, None] + 1 + np.arange(b)].astype(np.int64)
        r = rbits @ (1 << np.arange(b - 1, -1, -1, dtype=np.int64))
    else:
        r = np.zeros_like(q)
    signs = np.where(bits[T + b + 1] == 1, np.float32(1.0), np.float32(-1.0))
    gaps = q * (np.int64(1) << np.int64(b)) + r + 1
    cum = np.cumsum(gaps)
    seg_base = cum[fidx] - gaps[fidx]            # segmented cumsum rebase
    counts = np.diff(np.append(fidx, T.size))
    positions = cum - np.repeat(seg_base, counts) - 1
    last = np.append(fidx[1:], T.size) - 1       # gaps >= 1: max is the last
    if np.any(positions[last] >= numel):
        raise WireDecodeError(
            "corrupt golomb stream: position overflows tensor")
    return cw_seg, positions, signs


def _check_bit_len(bit_len, word_count) -> None:
    if np.any(np.asarray(bit_len) > 32 * np.asarray(word_count)):
        raise WireDecodeError(
            "corrupt wire payload: bit_len past the word buffer")


def decode_ternary_fields(msg: WireMessage, p: float, *,
                          backend: str = "numpy", device=None
                          ) -> tuple[np.ndarray, np.ndarray]:
    """One message's coded ``(positions, signs)`` -- no dense scatter.

    The fused ingest path (:mod:`repro_torch.core.ingest`) consumes these fields
    directly; :func:`decode_ternary_words` adds the scatter on top.
    ``device`` is where the ``"kernel"`` backend decodes the words.
    """
    b = _b_star_checked(p)
    if msg.bit_len == 0:
        if int(msg.nnz) != 0:
            raise WireDecodeError(
                "corrupt golomb stream: decoded nnz mismatch")
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    words = np.ascontiguousarray(msg.words)
    _check_bit_len(msg.bit_len, words.size)
    # integrity: the advertised nnz is side information the decoder can
    # cross-check for free -- a mutated stream that still parses but yields
    # a different codeword count is corruption, not data
    _, positions, signs = get_wire_backend(backend, device).decode_fields(
        words, np.zeros(1, np.int64), np.asarray([msg.bit_len], np.int64),
        np.asarray([msg.nnz], np.int64), msg.numel, b)
    return positions, signs


def decode_ternary_fields_batch(batch: WireBatch, p: float, *,
                                backend: str = "numpy", device=None
                                ) -> tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """All messages' ``(seg, positions, signs)`` in ONE decode pass.

    ``seg`` maps every codeword to its message row.  One multi-segment
    field decode of the shared word buffer -- no per-client Python loop or
    repeated ``unpackbits`` views; every message's decoded codeword count
    must match its advertised nnz.  ``device`` is where the ``"kernel"``
    backend decodes.
    """
    b = _b_star_checked(p)
    if batch.n_msgs == 0 or int(batch.bit_len.sum()) == 0:
        if batch.n_msgs and np.any(np.asarray(batch.nnz) != 0):
            raise WireDecodeError(
                "corrupt golomb stream: decoded nnz mismatch")
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    _check_bit_len(batch.bit_len, batch.word_count)
    return get_wire_backend(backend, device).decode_fields(
        batch.words, np.asarray(batch.word_start, np.int64),
        np.asarray(batch.bit_len, np.int64), np.asarray(batch.nnz, np.int64),
        batch.numel, b)


def decode_ternary_words(msg: WireMessage, p: float, *,
                         backend: str = "numpy", device=None) -> np.ndarray:
    """Vectorized Algorithm 4: unpack a word stream back to the flat tensor."""
    out = np.zeros(msg.numel, np.float32)
    positions, signs = decode_ternary_fields(msg, p, backend=backend,
                                             device=device)
    if positions.size:
        out[positions] = signs * np.float32(msg.mu)
    return out


def decode_ternary_words_batch(batch: WireBatch, p: float, *,
                               backend: str = "numpy",
                               device=None) -> np.ndarray:
    """Decode every message of a batch; returns ``(P, numel)`` fp32.

    The whole batch decodes as one multi-segment pass (shared unpack,
    vectorized per-client offset arithmetic) followed by one 2-D scatter.
    """
    out = np.zeros((batch.n_msgs, batch.numel), np.float32)
    seg, positions, signs = decode_ternary_fields_batch(
        batch, p, backend=backend, device=device)
    if positions.size:
        mu32 = batch.mu.astype(np.float32)
        out[seg, positions] = signs * mu32[seg]
    return out


# ---------------------------------------------------------------------------
# dense sign planes (signSGD wire format)
# ---------------------------------------------------------------------------


def pack_sign_words(tensor: np.ndarray, step: float, *,
                    backend: str = "numpy", device=None) -> WireMessage:
    """Dense one-bit-per-coordinate sign plane (the signSGD message).

    One bit cannot represent a zero: coordinates with ``x <= 0`` (including
    exact zeros from dead units or tied majority votes) pack as the ``-step``
    symbol, exactly like the real 1-bit protocol on the wire.  The measured
    size (``numel`` bits) is unaffected.
    """
    x = np.asarray(tensor).reshape(-1)
    bits = (x > 0).astype(np.uint8)
    words = get_wire_backend(backend, device).pack_bits(bits)
    return WireMessage(words, int(x.size), float(step), int(x.size),
                       int(x.size))


def pack_sign_planes_batch(x, step: float) -> WireBatch:
    """The sign planes of a ``(P, n)`` fp32 tensor, packed on the tensor's
    own device in one launch of
    :func:`repro_torch.kernels.bitpack.pack_sign_planes` (its plain version
    on the CPU); only the words come to the host.  The batch is
    :func:`concat_messages` of :func:`pack_sign_words` of each row, field
    for field: every row is padded to whole words."""
    from repro_torch.kernels.bitpack import pack_sign_planes
    rows, n = x.shape
    words = pack_sign_planes(x).cpu().numpy().view(np.uint32)
    n_words = words.shape[1]
    return WireBatch(words.reshape(-1),
                     np.arange(rows, dtype=np.int64) * n_words,
                     np.full(rows, n_words, np.int64),
                     np.full(rows, n, np.int64),
                     np.full(rows, float(step), np.float64),
                     np.full(rows, n, np.int64), int(n))


def unpack_sign_words(msg: WireMessage) -> np.ndarray:
    bits = words_to_bits(msg.words, msg.bit_len)
    return np.where(bits == 1, np.float32(msg.mu),
                    -np.float32(msg.mu)).astype(np.float32)


def sign_plane_bits(msg: WireMessage, *, backend: str = "numpy",
                    device=None) -> np.ndarray:
    """The ``bit_len`` 0/1 sign bits of a dense sign-plane message, through
    the named unpack backend (validated like the Golomb decode paths;
    ``device`` is where the ``"kernel"`` backend unpacks)."""
    words = np.ascontiguousarray(msg.words)
    _check_bit_len(msg.bit_len, words.size)
    return get_wire_backend(backend, device).unpack_bits(words)[
        : int(msg.bit_len)]


def sign_plane_rows(batch: WireBatch) -> np.ndarray:
    """Every message's first ``ceil(numel / 32)`` words as one ``(P, W)``
    uint32 array, after each message's checks, in order: a sign plane is
    exactly ``numel`` bits, and ``bit_len`` must fit its words; either
    raises :class:`WireDecodeError` before any row is returned."""
    n_words = -(-int(batch.numel) // 32)
    rows = []
    for i in range(batch.n_msgs):
        msg = batch.message(i)
        if int(msg.bit_len) != int(batch.numel):
            raise WireDecodeError("corrupt sign plane: bit_len != numel")
        _check_bit_len(msg.bit_len, msg.words.size)
        rows.append(msg.words[:n_words])
    if not rows:
        return np.zeros((0, n_words), np.uint32)
    return np.ascontiguousarray(np.stack(rows), np.uint32)


# ---------------------------------------------------------------------------
# generic batch assembly (default Codec.encode_wire_batch fallback)
# ---------------------------------------------------------------------------


def concat_messages(msgs: list[WireMessage]) -> WireBatch:
    """Assemble independently packed messages into one word-aligned batch."""
    word_count = np.asarray([m.words.size for m in msgs], np.int64)
    word_start = np.cumsum(word_count) - word_count
    words = (np.concatenate([m.words for m in msgs])
             if msgs else np.zeros(0, np.uint32))
    return WireBatch(
        words, word_start, word_count,
        np.asarray([m.bit_len for m in msgs], np.int64),
        np.asarray([m.mu for m in msgs], np.float64),
        np.asarray([m.nnz for m in msgs], np.int64),
        msgs[0].numel if msgs else 0)
