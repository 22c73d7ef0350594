"""Bit-stream word packing for the wire format.

Counterpart of ``repro/kernels/bitpack.py``: 32 consecutive stream bits
become one MSB-first uint32 word,

    word[w] = sum_j bits[32w + j] << (31 - j)

with the bits past the stream's end taken as 0.  On a CUDA tensor the
wrapper launches ``csrc/pack_bits.cu``; on a CPU tensor it runs
:func:`pack_bits_plain`.  Words come back as int32 tensors holding the
uint32 bit patterns (``.numpy().view(np.uint32)`` reads them as words).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.selection import PASSES
from . import _build

__all__ = ["pack_bits", "pack_bits_plain"]

_WEIGHTS = [1 << (31 - j) for j in range(32)]


def pack_bits_plain(bits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version over a flat uint8 0/1 tensor."""
    m = bits.numel()
    n_words = -(-m // 32)
    padded = torch.zeros(32 * n_words, dtype=torch.int64, device=bits.device)
    padded[:m] = (bits != 0).to(torch.int64)
    weights = torch.tensor(_WEIGHTS, dtype=torch.int64, device=bits.device)
    words = (padded.reshape(n_words, 32) * weights).sum(dim=1)
    # reinterpret the uint32 pattern as int32 (two's complement)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def _launch(bits: torch.Tensor) -> torch.Tensor:
    fn = _build.entry("pack_bits", "pack_bits_u8",
                      [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p])
    m = bits.numel()
    n_words = -(-m // 32)
    words = torch.empty(n_words, dtype=torch.int32, device=bits.device)
    if n_words == 0:
        return words
    err = fn(bits.data_ptr(), words.data_ptr(), m, n_words,
             _build.stream_ptr(bits.device))
    _build.check("pack_bits", err)
    _build.LAUNCHES.record("pack_bits", bits.shape)
    return words


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a flat uint8 0/1 tensor into ``ceil(m / 32)`` words; stream bit
    ``t`` lands in word ``t >> 5`` at bit ``31 - (t & 31)``."""
    if bits.ndim != 1 or bits.dtype != torch.uint8:
        raise ValueError(f"bits must be a flat uint8 tensor, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    PASSES.record("pack_bits")
    if bits.device.type == "cpu":
        return pack_bits_plain(bits)
    if bits.device.type != "cuda":
        raise ValueError(f"unsupported device {bits.device}")
    return _launch(bits.contiguous())

