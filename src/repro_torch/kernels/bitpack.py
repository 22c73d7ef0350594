"""Bit-stream word packing for the wire format.

Counterpart of ``repro/kernels/bitpack.py``: 32 consecutive stream bits
become one MSB-first uint32 word,

    word[w] = sum_j bits[32w + j] << (31 - j)

with the bits past the stream's end taken as 0.  Entries:

* :func:`pack_bits_batched` packs a ``(B, m)`` batch of uint8 0/1 bit
  planes, each row padded to whole words, in one launch of
  ``csrc/pack_bits.cu`` (the reference's ``pack_bits_words_batched``);
  :func:`pack_bits` is its one-row case (``pack_bits_words``);
* :func:`pack_sign_planes` packs a ``(B, n)`` batch of fp32 values as
  their sign planes, ``bit = x > 0`` (signSGD's wire planes,
  ``core/wire.py::pack_sign_words``), in one launch of the same source;
* :func:`pack_chunks` packs the ternary wire's Golomb chunks, ``(value,
  length)`` pairs at given bit offsets, through ``csrc/pack_chunks.cu``:
  what the reference computes as ``pack_bits_words`` over the host's
  chunk -> bit expansion, without the expansion.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain version.  Words come back as int32 tensors holding the uint32
bit patterns (``.numpy().view(np.uint32)`` reads them as words).  A
batch's rows are word-aligned, so its flattened words are the
concatenation of the rows' own packs.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.selection import PASSES
from . import _build

__all__ = ["pack_bits", "pack_bits_batched", "pack_bits_plain",
           "pack_bits_batched_plain", "pack_sign_planes",
           "pack_sign_planes_plain", "pack_chunks", "pack_chunks_plain"]

_WEIGHTS = [1 << (31 - j) for j in range(32)]
_F32_INF = 0x7F800000            # bit pattern of +inf


def pack_bits_batched_plain(bits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version over a ``(B, m)`` uint8 0/1 tensor."""
    rows, m = bits.shape
    n_words = -(-m // 32)
    padded = torch.zeros((rows, 32 * n_words), dtype=torch.int64,
                         device=bits.device)
    padded[:, :m] = (bits != 0).to(torch.int64)
    weights = torch.tensor(_WEIGHTS, dtype=torch.int64, device=bits.device)
    words = (padded.reshape(rows, n_words, 32) * weights).sum(dim=2)
    # reinterpret the uint32 pattern as int32 (two's complement)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def pack_bits_plain(bits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version over a flat uint8 0/1 tensor."""
    return pack_bits_batched_plain(bits.reshape(1, -1))[0]


def pack_sign_planes_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x > 0`` read from the fp32 bit pattern
    (positive, non-zero, not NaN; a subnormal is not flushed), then
    :func:`pack_bits_batched_plain`."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return pack_bits_batched_plain(
        ((u >= 1) & (u <= _F32_INF)).to(torch.uint8))


def _launch(symbol: str, x: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/pack_bits.cu``'s ``symbol`` over the (B, m)
    batch ``x``."""
    fn = _build.entry("pack_bits", symbol,
                      [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_longlong]
                      * 3 + [ctypes.c_void_p])
    rows, m = x.shape
    n_words = -(-m // 32)
    words = torch.empty((rows, n_words), dtype=torch.int32, device=x.device)
    if words.numel() == 0:
        return words
    err = fn(x.data_ptr(), words.data_ptr(), rows, m, n_words,
             _build.stream_ptr(x.device))
    name = "pack_sign_planes" if symbol == "pack_sign_f32" else "pack_bits"
    _build.check(name, err)
    _build.LAUNCHES.record(name, x.shape)
    return words


def pack_bits_batched(bits: torch.Tensor) -> torch.Tensor:
    """Pack a ``(B, m)`` uint8 0/1 tensor into ``(B, ceil(m / 32))`` words
    in one launch; row ``i``'s bit ``t`` lands in word ``[i, t >> 5]`` at
    bit ``31 - (t & 31)``, and ``b != 0`` counts as 1."""
    if bits.ndim != 2 or bits.dtype != torch.uint8:
        raise ValueError(f"bits must be a (B, m) uint8 tensor, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    PASSES.record("pack_bits")
    if not _build.on_card(bits):
        return pack_bits_batched_plain(bits)
    return _launch("pack_bits_u8", bits.contiguous())


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a flat uint8 0/1 tensor into ``ceil(m / 32)`` words; stream bit
    ``t`` lands in word ``t >> 5`` at bit ``31 - (t & 31)``."""
    if bits.ndim != 1 or bits.dtype != torch.uint8:
        raise ValueError(f"bits must be a flat uint8 tensor, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    return pack_bits_batched(bits.reshape(1, -1))[0]


def pack_sign_planes(x: torch.Tensor) -> torch.Tensor:
    """Pack the sign planes of a ``(B, n)`` fp32 tensor into ``(B,
    ceil(n / 32))`` words in one launch: ``bit = x > 0`` exactly as numpy
    decides it (a positive subnormal and ``+inf`` give 1; ``-0.0``, NaN
    and negative values 0)."""
    if x.ndim != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be a (B, n) float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    PASSES.record("pack_sign_planes")
    if not _build.on_card(x):
        return pack_sign_planes_plain(x)
    return _launch("pack_sign_f32", x.contiguous())


def pack_chunks_plain(vals: torch.Tensor, lens: torch.Tensor,
                      offs: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Plain PyTorch version: every chunk expanded to its bits (most
    significant first) at its offset, then :func:`pack_bits_plain`."""
    dev = vals.device
    lens64 = lens.to(torch.int64)
    n_bits = int(lens64.sum())
    bits = torch.zeros(int(total_bits), dtype=torch.uint8, device=dev)
    if n_bits:
        owner = torch.repeat_interleave(
            torch.arange(lens64.numel(), device=dev), lens64)
        start = torch.cumsum(lens64, 0) - lens64
        within = torch.arange(n_bits, device=dev) - start[owner]
        shift = lens64[owner] - 1 - within
        bits[offs[owner] + within] = ((vals[owner] >> shift) & 1) \
            .to(torch.uint8)
    return pack_bits_plain(bits)


def _launch_chunks(vals, lens, offs, n_words: int) -> torch.Tensor:
    fn = _build.entry("pack_chunks", "pack_chunks_u64",
                      [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_longlong,
                                               ctypes.c_void_p])
    words = torch.empty(n_words, dtype=torch.int32, device=vals.device)
    if n_words == 0:
        return words
    err = fn(vals.data_ptr(), lens.data_ptr(), offs.data_ptr(),
             words.data_ptr(), vals.numel(), n_words,
             _build.stream_ptr(vals.device))
    _build.check("pack_chunks", err)
    _build.LAUNCHES.record("pack_chunks", vals.shape)
    return words


def pack_chunks(vals: torch.Tensor, lens: torch.Tensor, offs: torch.Tensor,
                total_bits: int) -> torch.Tensor:
    """Pack chunks into ``ceil(total_bits / 32)`` words.

    ``vals`` (int64, carrying uint64 values), ``lens`` (int32, 1-63 bits)
    and ``offs`` (int64, non-decreasing, gaps allowed) are flat tensors of
    one length on one device: chunk ``i``'s ``lens[i]`` low bits, most
    significant first, land at stream bits ``[offs[i], offs[i] +
    lens[i])``.  Chunks do not overlap and end by ``total_bits``; the other
    bits are 0."""
    if not (vals.ndim == lens.ndim == offs.ndim == 1
            and vals.numel() == lens.numel() == offs.numel()):
        raise ValueError(f"vals, lens and offs must be flat and of one "
                         f"length, got {tuple(vals.shape)}, "
                         f"{tuple(lens.shape)}, {tuple(offs.shape)}")
    if (vals.dtype, lens.dtype, offs.dtype) != (torch.int64, torch.int32,
                                                 torch.int64):
        raise ValueError(f"vals, lens, offs must be int64, int32, int64, got "
                         f"{vals.dtype}, {lens.dtype}, {offs.dtype}")
    if not vals.device == lens.device == offs.device:
        raise ValueError("vals, lens and offs must be on one device")
    PASSES.record("pack_chunks")
    if not _build.on_card(vals):
        return pack_chunks_plain(vals, lens, offs, total_bits)
    return _launch_chunks(vals.contiguous(), lens.contiguous(),
                          offs.contiguous(), -(-int(total_bits) // 32))
