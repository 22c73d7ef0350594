"""Wire-stream decoding on the card: word unpacking and the Golomb field
decode.

Counterpart of ``repro/kernels/wiredecode.py``, whose one Pallas kernel
(``_unpack_kernel``) explodes every uint32 stream word into its 32 MSB-first
bits, with the word's zero count beside it,

    bit[32w + j] = (word[w] >> (31 - j)) & 1
    zeros[w]     = 32 - popc(word[w])

over ALL ``32 * n_words`` bits (word padding included), for the host field
scan to parse.  Two kernels take its place here:

* :func:`unpack_words_batched` (``csrc/unpack_bits.cu``): the same
  unpacking over a ``(B, W)`` batch of word rows in one launch;
  :func:`unpack_words_with_counts` / :func:`unpack_bits_words` are its
  one-row case, for signSGD's dense sign planes, whose bits are the
  message;
* :func:`sign_plane_tally` (``csrc/unpack_bits.cu``): the unpack fused
  with what the signSGD ingest does with the bits, a batch of sign planes
  added into the fp64 accumulator sum in message order, so no bit plane is
  ever written;
* :func:`decode_golomb_fields` (``csrc/golomb_decode.cu``): the ternary
  stream's Golomb codewords parsed on the card into ``(seg, positions,
  signs)`` -- what the unpack plus ``core/wire.py::_decode_stream_fields``
  computed -- so the fields, not the bits, come back to the host.

Words come in as int32 tensors holding the uint32 bit patterns (as
:func:`.bitpack.pack_bits` returns them).  On a CUDA tensor the wrappers
launch their kernels; on a CPU tensor they run their plain versions
(:func:`unpack_words_plain`, :func:`sign_plane_tally_plain`,
:func:`decode_golomb_fields_plain`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..core.selection import PASSES
from ..core.wire import _MAX_B_STAR, WireDecodeError
from . import _build

__all__ = ["unpack_words_batched", "unpack_words_with_counts",
           "unpack_bits_words", "unpack_words_plain", "sign_plane_tally",
           "sign_plane_tally_plain", "decode_golomb_fields",
           "decode_golomb_fields_plain", "DecodePlan", "decode_plan"]

_SHIFTS = list(range(31, -1, -1))


def unpack_words_plain(words: torch.Tensor):
    """Plain PyTorch version: ``(bits uint8 (..., 32W), zeros int32 (...,
    W))`` for a ``(W,)`` or ``(B, W)`` word tensor."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=words.device)
    bits = ((u[..., None] >> shifts) & 1).to(torch.uint8)
    zeros = 32 - bits.sum(dim=-1, dtype=torch.int32)
    return bits.reshape(*words.shape[:-1], -1), zeros


def _launch(words: torch.Tensor):
    fn = _build.entry("unpack_bits", "unpack_bits_u32",
                      [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_void_p])
    rows, n_words = words.shape
    bits = torch.empty((rows, 32 * n_words), dtype=torch.uint8,
                       device=words.device)
    zeros = torch.empty((rows, n_words), dtype=torch.int32,
                        device=words.device)
    if words.numel() == 0:
        return bits, zeros
    err = fn(words.data_ptr(), bits.data_ptr(), zeros.data_ptr(),
             words.numel(), _build.stream_ptr(words.device))
    _build.check("unpack_bits", err)
    _build.LAUNCHES.record("unpack_bits", words.shape)
    return bits, zeros


def unpack_words_batched(words: torch.Tensor):
    """A ``(B, W)`` int32 word tensor -> ``(bits (B, 32W) uint8, zeros (B,
    W) int32)`` in one launch: row ``i``'s stream bit ``t`` from word ``[i,
    t >> 5]`` at bit ``31 - (t & 31)``, and the number of 0-bits of every
    word."""
    if words.ndim != 2 or words.dtype != torch.int32:
        raise ValueError(f"words must be a (B, W) int32 tensor, got "
                         f"{tuple(words.shape)} {words.dtype}")
    PASSES.record("unpack_bits")
    if not _build.on_card(words):
        return unpack_words_plain(words)
    return _launch(words.contiguous())


def unpack_words_with_counts(words: torch.Tensor):
    """A flat int32 word tensor -> ``(bits, zeros)``: all ``32 * W`` stream
    bits as uint8 0/1 (stream bit ``t`` from word ``t >> 5`` at bit
    ``31 - (t & 31)``) and the number of 0-bits of every word."""
    if words.ndim != 1 or words.dtype != torch.int32:
        raise ValueError(f"words must be a flat int32 tensor, got "
                         f"{tuple(words.shape)} {words.dtype}")
    bits, zeros = unpack_words_batched(words.reshape(1, -1))
    return bits[0], zeros[0]


def unpack_bits_words(words: torch.Tensor) -> torch.Tensor:
    """A flat int32 word tensor -> all ``32 * W`` bits (uint8 0/1); the
    zero counts are computed and dropped, as in the reference."""
    bits, _ = unpack_words_with_counts(words)
    return bits


# ---------------------------------------------------------------------------
# signSGD's sign planes tallied into the ingest sum (csrc/unpack_bits.cu)
# ---------------------------------------------------------------------------

def _step64(step: float) -> float:
    """``f64(f32(step))``: the plane's value as the host accumulator adds
    it (``np.float32(step)`` widened)."""
    return float(torch.tensor(float(step), dtype=torch.float32))


def sign_plane_tally_plain(words: torch.Tensor, step: float,
                           weights: torch.Tensor,
                           total: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the host loop of
    ``IngestAccumulator.add_sign_plane`` in torch fp64: message by message,
    the plane's ``±f32(step)`` widened, times its weight (rounded), added
    into ``total`` (rounded), in place."""
    n = total.numel()
    v = torch.tensor(_step64(step), dtype=torch.float64, device=total.device)
    for i in range(words.shape[0]):
        bits = unpack_words_plain(words[i])[0][:n]
        total += torch.where(bits == 1, v, -v) * weights[i]
    return total


def _launch_tally(words, step, weights, total) -> None:
    fn = _build.entry("unpack_bits", "sign_plane_tally_f64",
                      [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
                      + [ctypes.c_double, ctypes.c_void_p])
    rows, n_words = words.shape
    if rows == 0 or total.numel() == 0:
        return
    err = fn(words.data_ptr(), weights.data_ptr(), total.data_ptr(), rows,
             n_words, total.numel(), _step64(step),
             _build.stream_ptr(words.device))
    _build.check("sign_plane_tally", err)
    _build.LAUNCHES.record("sign_plane_tally", words.shape)


def sign_plane_tally(words: torch.Tensor, step: float,
                     weights: torch.Tensor,
                     total: torch.Tensor) -> torch.Tensor:
    """Add ``B`` sign planes into the fp64 sum ``total`` (``(n,)``, in
    place, returned), in message order: for each coordinate ``j`` and
    ``i = 0 .. B - 1`` in turn,

        total[j] = total[j] + f64(bit(i, j) ? f32(step) : -f32(step))
                   * weights[i]

    with the product and the add each rounded in fp64, bitwise the host
    accumulator's ``add_sign_plane`` loop.  ``words`` is ``(B, ceil(n /
    32))`` int32 (row ``i``'s bit ``j`` in word ``[i, j >> 5]`` at bit
    ``31 - (j & 31)``), ``weights`` ``(B,)`` fp64; one launch on the card,
    where the planes are never unpacked into memory."""
    if words.ndim != 2 or words.dtype != torch.int32:
        raise ValueError(f"words must be a (B, W) int32 tensor, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if total.ndim != 1 or total.dtype != torch.float64:
        raise ValueError(f"total must be a flat float64 tensor, got "
                         f"{tuple(total.shape)} {total.dtype}")
    if words.shape[1] != -(-total.numel() // 32):
        raise ValueError(f"{words.shape[1]} words a row do not hold "
                         f"{total.numel()} coordinates")
    if weights.shape != (words.shape[0],) or weights.dtype != torch.float64:
        raise ValueError(f"weights must be ({words.shape[0]},) float64, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    if not words.device == weights.device == total.device:
        raise ValueError("words, weights and total must be on one device")
    PASSES.record("sign_plane_tally")
    if not _build.on_card(total):
        return sign_plane_tally_plain(words, step, weights, total)
    if not total.is_contiguous():
        raise ValueError("total must be contiguous: it is updated in place")
    _launch_tally(words.contiguous(), step, weights.contiguous(), total)
    return total


# ---------------------------------------------------------------------------
# Golomb field decode of the ternary wire (csrc/golomb_decode.cu)
# ---------------------------------------------------------------------------

_FINAL, _OVERRUN = 64, 128       # csrc/golomb_decode.cu: status flags
_CHUNK_BITS = 128                # its CHUNK_BITS: a chunk's stream bits
_TILE_CHUNKS = 64                # its TILE: chunks a CTA holds at once
_MAX_DECODE_CLUSTER = 16         # its MAX_CLUSTER


def decode_golomb_fields_plain(words: torch.Tensor,
                               seg_word_start: torch.Tensor,
                               seg_bit_len: torch.Tensor, nnz: torch.Tensor,
                               numel: int, b: int):
    """Plain PyTorch version: the host field scan
    (``core/wire.py::_decode_stream_fields``) transcribed to tensors, over
    the bits of :func:`unpack_words_plain`.  Every zero bit is a candidate
    terminator; one ``searchsorted`` links each to the first zero ``b + 2``
    bits past it, and a pointer-doubling closure marks each segment's chain
    from its first zero -- an algorithm independent of the kernel's chunk
    decode.  Raises :class:`WireDecodeError` where the scan does, and on a
    segment whose codeword count is not its ``nnz``."""
    dev, i64 = words.device, torch.int64
    seg_start = 32 * seg_word_start.to(dev)
    seg_len = seg_bit_len.to(dev)
    n_seg = seg_start.numel()
    active = torch.nonzero(seg_len > 0).flatten()
    if active.numel() == 0:
        fields = (torch.zeros(0, dtype=i64, device=dev),
                  torch.zeros(0, dtype=i64, device=dev),
                  torch.zeros(0, dtype=torch.float32, device=dev))
    else:
        bits, _ = unpack_words_plain(words)
        fields = _scan_fields(bits, seg_start, seg_start + seg_len, active,
                              n_seg, numel, b)
    counts = torch.bincount(fields[0], minlength=n_seg)
    if not torch.equal(counts.cpu(), nnz.to(i64).cpu()):
        raise WireDecodeError("corrupt golomb stream: decoded nnz mismatch")
    return fields


def _scan_fields(bits, seg_start, seg_end, active, n_seg, numel, b):
    dev, i64 = bits.device, torch.int64
    zeros = torch.nonzero(bits == 0).flatten()
    n_zeros = zeros.numel()
    if n_zeros == 0:
        raise WireDecodeError("corrupt golomb stream: no unary terminator")
    seg_of = torch.searchsorted(seg_start, zeros, right=True) - 1
    nxt = zeros + (b + 2)
    is_final = nxt == seg_end[seg_of]
    overrun = nxt > seg_end[seg_of]
    succ = torch.full((n_zeros + 1,), n_zeros, dtype=i64, device=dev)
    interior = ~(is_final | overrun)
    succ[:n_zeros][interior] = torch.searchsorted(zeros, nxt[interior])
    seeds = torch.searchsorted(zeros, seg_start[active])
    if bool((seeds >= n_zeros).any()):
        raise WireDecodeError("corrupt golomb stream: no unary terminator")
    reached = torch.zeros(n_zeros + 1, dtype=torch.bool, device=dev)
    reached[seeds] = True
    jump = succ                                  # covers 2^k steps at iter k
    while True:
        idx = torch.nonzero(reached[:n_zeros]).flatten()
        reached[jump[idx]] = True
        if int(reached[:n_zeros].sum()) == idx.numel():
            break
        jump = jump[jump]
    sel = reached[:n_zeros]
    if bool((sel & overrun).any()):
        raise WireDecodeError("corrupt golomb stream: truncated codeword")
    ok = torch.zeros(n_seg, dtype=torch.bool, device=dev)
    ok[seg_of[sel & is_final]] = True
    if not bool(ok[active].all()):
        raise WireDecodeError("corrupt golomb stream: truncated codeword")
    term = zeros[sel]                            # terminators, stream order
    cw_seg = seg_of[sel]
    first = torch.ones(term.numel(), dtype=torch.bool, device=dev)
    first[1:] = cw_seg[1:] != cw_seg[:-1]
    fidx = torch.nonzero(first).flatten()
    starts = torch.empty_like(term)
    starts[fidx] = seg_start[cw_seg[fidx]]
    nonfirst = torch.nonzero(~first).flatten()
    starts[nonfirst] = term[nonfirst - 1] + (b + 2)
    q = term - starts
    if b:
        offs = torch.arange(1, b + 1, dtype=i64, device=dev)
        rbits = bits[term[:, None] + offs].to(i64)
        r = (rbits << torch.arange(b - 1, -1, -1, dtype=i64,
                                   device=dev)).sum(dim=1)
    else:
        r = torch.zeros_like(q)
    signs = torch.where(bits[term + b + 1] == 1,
                        torch.ones((), dtype=torch.float32, device=dev),
                        -torch.ones((), dtype=torch.float32, device=dev))
    gaps = q * (1 << b) + r + 1
    cum = torch.cumsum(gaps, dim=0)
    seg_base = cum[fidx] - gaps[fidx]            # segmented cumsum rebase
    ends = torch.cat([fidx[1:], torch.tensor([term.numel()], device=dev)])
    positions = cum - torch.repeat_interleave(seg_base, ends - fidx) - 1
    if bool((positions[ends - 1] >= numel).any()):  # gaps >= 1: the last
        raise WireDecodeError(
            "corrupt golomb stream: position overflows tensor")
    return cw_seg, positions, signs


def _segment_table(words, seg_word_start, seg_bit_len, nnz, b):
    """The host segment table as numpy, checked: word starts in order, each
    segment's bits inside its words and before the next segment's, and no
    segment advertising more codewords than its bits can hold."""
    for name, t in (("seg_word_start", seg_word_start),
                    ("seg_bit_len", seg_bit_len), ("nnz", nnz)):
        if t.ndim != 1 or t.dtype != torch.int64 or t.device.type != "cpu":
            raise ValueError(f"{name} must be a flat int64 CPU tensor (the "
                             f"host segment table), got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    ws, bl, cnt = (t.numpy() for t in (seg_word_start, seg_bit_len, nnz))
    if not ws.size == bl.size == cnt.size:
        raise ValueError(f"segment table columns differ in length: "
                         f"{ws.size}, {bl.size}, {cnt.size}")
    if np.any(ws < 0) or np.any(np.diff(ws) < 0):
        raise ValueError("segment word starts must be >= 0 and in order")
    limit = np.append(32 * ws[1:], 32 * words.numel())
    if np.any(bl < 0) or np.any(32 * ws + bl > limit):
        raise WireDecodeError(
            "corrupt wire payload: bit_len past the word buffer")
    if np.any(cnt < 0) or np.any(cnt > bl // (b + 2)):
        raise WireDecodeError("corrupt golomb stream: decoded nnz mismatch")
    return ws, bl, cnt


class DecodePlan(NamedTuple):
    """How ``golomb_decode`` runs a batch: one launch of a thread block
    cluster of ``cluster`` CTAs of ``threads`` threads a segment, a CTA
    holding at most ``tile`` chunks at once.  On the ``"cluster"`` route
    every segment fits one tile of the cluster; on the ``"tiled"`` route the
    longest segment does not, and the cluster walks it tile by tile,
    carrying its cursor."""
    route: str
    cluster: int
    threads: int
    tile: int


def _cluster_plan(n_chunks_max: int, cluster: int) -> DecodePlan:
    """The launch in clusters of ``cluster`` CTAs for segments of at most
    ``n_chunks_max`` chunks: ``tile`` the chunks a CTA then takes of the
    longest segment (at most ``_TILE_CHUNKS``: its shared memory grows with
    them), ``threads`` one a (chunk, state) pair at up to 8 states
    (b <= 6), 64 to 512."""
    route = ("cluster" if n_chunks_max <= cluster * _TILE_CHUNKS
             else "tiled")
    tile = max(1, min(_TILE_CHUNKS, -(-n_chunks_max // cluster)))
    threads = min(512, max(64, 1 << (8 * tile - 1).bit_length()))
    return DecodePlan(route, cluster, threads, tile)


def decode_plan(n_chunks_max: int) -> DecodePlan:
    """The decode's launch for segments of at most ``n_chunks_max`` chunks
    (``_CHUNK_BITS`` bits each): clusters of the fewest CTAs, a power of
    two, that hold the longest segment in one tile, at most
    ``_MAX_DECODE_CLUSTER``.  Neither the segment count nor the card's SMs
    change it: on an H100 a lone cnn message ran as fast in 16 CTAs as in
    8, and a cnn round's ten segments slower (``PERF.md`` section 6)."""
    cluster = 1
    while (cluster < _MAX_DECODE_CLUSTER
           and -(-n_chunks_max // cluster) > _TILE_CHUNKS):
        cluster *= 2
    return _cluster_plan(n_chunks_max, cluster)


def _segment_meta(ws, bl, cnt) -> np.ndarray:
    """The kernel's segment table: int64 rows of (first bit, bit length,
    first output), and a last row holding the output total in its last
    column."""
    meta = np.zeros((ws.size + 1, 3), np.int64)
    meta[:-1, 0], meta[:-1, 1] = 32 * ws, bl
    meta[1:, 2] = np.cumsum(cnt)
    return meta


def _field_views(buf, n_out: int, n_seg: int):
    """``(positions, signs), status`` as views of the one int64 buffer the
    kernel writes (a tensor or its numpy copy): positions, the status rows,
    then the signs' float32 pairs."""
    pos, status = buf[:n_out], buf[n_out:n_out + 3 * n_seg]
    tail = buf[n_out + 3 * n_seg:]
    sign = (tail.view(torch.float32) if isinstance(tail, torch.Tensor)
            else tail.view(np.float32))[:n_out]
    return (pos, sign), status


def _launch_decode(words, meta, plan: DecodePlan, n_out: int, b: int):
    """Enqueue the one launch on ``meta`` (the segment table, already on
    ``words``' device); returns the buffer it writes, unread (see
    :func:`_field_views`)."""
    fn = _build.entry("golomb_decode", "golomb_decode",
                      [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
                      + [ctypes.c_void_p] * 4)
    dev, n_seg = words.device, meta.shape[0] - 1
    buf = torch.empty(n_out + 3 * n_seg + (n_out + 1) // 2,
                      dtype=torch.int64, device=dev)
    (pos, sign), status = _field_views(buf, n_out, n_seg)
    err = fn(words.data_ptr(), meta.data_ptr(), n_seg, b, plan.cluster,
             plan.threads, plan.tile, pos.data_ptr(), sign.data_ptr(),
             status.data_ptr(), _build.stream_ptr(dev))
    _build.check("golomb_decode", err)
    _build.LAUNCHES.record("golomb_decode", words.shape)
    return buf


def _check_status(status: np.ndarray, bl, cnt, numel: int) -> None:
    """Raise as the host scan would, from the kernel's per-segment
    ``(count, last state, last position)``."""
    count, code, last = status.reshape(-1, 3).T
    if np.any((bl > 0) & ((code & _FINAL) == 0) & ((code & _OVERRUN) == 0)):
        raise WireDecodeError("corrupt golomb stream: no unary terminator")
    if np.any((bl > 0) & ((code & _OVERRUN) != 0)):
        raise WireDecodeError("corrupt golomb stream: truncated codeword")
    if np.any(count != cnt):
        raise WireDecodeError("corrupt golomb stream: decoded nnz mismatch")
    if np.any((count > 0) & (last >= numel)):
        raise WireDecodeError(
            "corrupt golomb stream: position overflows tensor")


def decode_golomb_fields(words: torch.Tensor, seg_word_start: torch.Tensor,
                         seg_bit_len: torch.Tensor, nnz: torch.Tensor,
                         numel: int, b: int):
    """Parse every segment's Golomb ternary codewords out of a word buffer.

    ``words`` is the flat int32 stream; the host segment table (flat int64
    CPU tensors of one length) gives segment ``i`` the stream bits
    ``[32 * seg_word_start[i], 32 * seg_word_start[i] + seg_bit_len[i])``
    and its advertised codeword count ``nnz[i]``; ``b`` is the Golomb
    parameter (0-30).  Returns ``(seg, positions, signs)`` as CPU tensors
    -- int64 owning segment, int64 decoded position and float32 ±1.0 of
    every codeword, segment-major in stream order -- bitwise the
    reference's field scan.  Raises :class:`WireDecodeError` exactly where
    that scan (plus its count check) does: a truncated codeword, a unary
    run with no terminator, a count other than ``nnz``, a position at or
    past ``numel``.  On the card the kernel's one buffer (positions, the
    per-segment status, signs) comes down in one copy and the status is
    checked there; ``seg`` is the advertised counts spelled out, which the
    check has just confirmed."""
    if words.ndim != 1 or words.dtype != torch.int32:
        raise ValueError(f"words must be a flat int32 tensor, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if not 0 <= int(b) <= _MAX_B_STAR:
        raise ValueError(f"golomb parameter b must be in [0, {_MAX_B_STAR}],"
                         f" got {b}")
    b = int(b)
    ws, bl, cnt = _segment_table(words, seg_word_start, seg_bit_len, nnz, b)
    PASSES.record("golomb_decode")
    if words.device.type == "cpu":
        return decode_golomb_fields_plain(words, seg_word_start, seg_bit_len,
                                          nnz, numel, b)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    meta = _segment_meta(ws, bl, cnt)
    n_out = int(meta[-1, 2])
    buf = _launch_decode(
        words.contiguous(), torch.from_numpy(meta).to(words.device),
        decode_plan(int(-(-bl.max(initial=0) // _CHUNK_BITS))), n_out, b)
    (pos, sign), status = _field_views(buf.cpu().numpy(), n_out, ws.size)
    _check_status(status, bl, cnt, int(numel))
    seg = np.repeat(np.arange(ws.size, dtype=np.int64), cnt)
    return tuple(torch.from_numpy(f) for f in (seg, pos, sign))
