"""Bit-stream word unpacking for the wire-decode path.

Counterpart of ``repro/kernels/wiredecode.py``, the exact inverse of
:mod:`.bitpack`: every uint32 stream word explodes into its 32 MSB-first
bits, with the word's zero count beside it,

    bit[32w + j] = (word[w] >> (31 - j)) & 1
    zeros[w]     = 32 - popc(word[w])

over ALL ``32 * n_words`` bits (word padding included).  Words come in as
int32 tensors holding the uint32 bit patterns (as :func:`.bitpack.pack_bits`
returns them); bits come out as uint8 0/1.  On a CUDA tensor the wrappers
launch ``csrc/unpack_bits.cu``; on a CPU tensor they run
:func:`unpack_words_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.selection import PASSES
from . import _build

__all__ = ["unpack_words_with_counts", "unpack_bits_words",
           "unpack_words_plain"]

_SHIFTS = list(range(31, -1, -1))


def unpack_words_plain(words: torch.Tensor):
    """Plain PyTorch version: ``(bits uint8 (32W,), zeros int32 (W,))``."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.tensor(_SHIFTS, dtype=torch.int64, device=words.device)
    bits = ((u[:, None] >> shifts) & 1).to(torch.uint8)
    zeros = 32 - bits.sum(dim=1, dtype=torch.int32)
    return bits.reshape(-1), zeros


def _launch(words: torch.Tensor):
    fn = _build.entry("unpack_bits", "unpack_bits_u32",
                      [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                               ctypes.c_void_p])
    n_words = words.numel()
    bits = torch.empty(32 * n_words, dtype=torch.uint8, device=words.device)
    zeros = torch.empty(n_words, dtype=torch.int32, device=words.device)
    if n_words == 0:
        return bits, zeros
    err = fn(words.data_ptr(), bits.data_ptr(), zeros.data_ptr(), n_words,
             _build.stream_ptr(words.device))
    _build.check("unpack_bits", err)
    _build.LAUNCHES.record("unpack_bits", words.shape)
    return bits, zeros


def unpack_words_with_counts(words: torch.Tensor):
    """A flat int32 word tensor -> ``(bits, zeros)``: all ``32 * W`` stream
    bits as uint8 0/1 (stream bit ``t`` from word ``t >> 5`` at bit
    ``31 - (t & 31)``) and the number of 0-bits of every word."""
    if words.ndim != 1 or words.dtype != torch.int32:
        raise ValueError(f"words must be a flat int32 tensor, got "
                         f"{tuple(words.shape)} {words.dtype}")
    PASSES.record("unpack_bits")
    if words.device.type == "cpu":
        return unpack_words_plain(words)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    return _launch(words.contiguous())


def unpack_bits_words(words: torch.Tensor) -> torch.Tensor:
    """A flat int32 word tensor -> all ``32 * W`` bits (uint8 0/1); the
    zero counts are computed and dropped, as in the reference."""
    bits, _ = unpack_words_with_counts(words)
    return bits
