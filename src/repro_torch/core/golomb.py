"""Golomb position coding for sparse ternary updates (paper Appx. A, Eq. 17).

The port's numpy copy of ``repro/core/golomb.py``, byte-identical in behaviour.

Two layers:

* **Analytic model** (jit-friendly Python floats): entropy of sparse (Eq. 15)
  and sparse-ternary (Eq. 16) updates, the optimal Golomb parameter
  ``b* = 1 + floor(log2(log(φ-1)/log(1-p)))`` and the expected bits/position
  ``b̄_pos = b* + 1/(1-(1-p)^{2^b*})`` (Eq. 17).  These feed the communication
  ledger used by the federated loop and the benchmarks.

* **Real codec** (host-side numpy, Algorithms 3 & 4): encodes the non-zero
  positions of a flat ternary tensor as unary(q)+binary(r) Golomb codewords
  plus one sign bit per element and a 32-bit float µ, packed MSB-first into
  bytes with an explicit bit length.  Round-trip tested; the measured
  bitstream length is asserted ≈ the analytic model in tests.

This per-bit loop is kept as the reference ORACLE; the production packer is
the vectorized word-stream codec in :mod:`repro_torch.core.wire`, which is asserted
bit-identical to this one.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    "golomb_b_star",
    "golomb_position_bits",
    "entropy_sparse",
    "entropy_sparse_ternary",
    "stc_message_bits",
    "stc_stream_bound_bits",
    "fedavg_message_bits",
    "signsgd_message_bits",
    "ternary_dense_bits",
    "encode_ternary",
    "decode_ternary",
]

_PHI = (math.sqrt(5.0) + 1.0) / 2.0


def golomb_b_star(p: float) -> int:
    """Optimal Golomb parameter for geometric gaps with success prob p."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"sparsity p must be in (0,1), got {p}")
    return max(0, 1 + int(math.floor(math.log2(math.log(_PHI - 1.0) / math.log(1.0 - p)))))


def golomb_position_bits(p: float) -> float:
    """Eq. 17: expected bits per non-zero position."""
    b = golomb_b_star(p)
    return b + 1.0 / (1.0 - (1.0 - p) ** (2**b))


def entropy_sparse(p: float, value_bits: int = 32) -> float:
    """Eq. 15: bits/weight for sparse full-precision updates."""
    return -p * math.log2(p) - (1 - p) * math.log2(1 - p) + value_bits * p


def entropy_sparse_ternary(p: float) -> float:
    """Eq. 16: bits/weight for sparse ternary updates (1 sign bit per nnz)."""
    return -p * math.log2(p) - (1 - p) * math.log2(1 - p) + p


def stc_message_bits(numel: int, p: float) -> float:
    """Size in bits of one Golomb-encoded STC message for a numel-sized tensor."""
    k = max(int(numel * p), 1)
    return k * (golomb_position_bits(p) + 1.0) + 32.0  # +32 for µ


def stc_stream_bound_bits(numel: int, nnz: int, p: float) -> float:
    """Deterministic ceiling on the measured Golomb stream length.

    ``nnz`` distinct positions in ``[0, numel)`` have gaps summing to at most
    ``numel``, so the unary quotients sum to at most ``(numel - nnz) / 2^b*``;
    every non-zero then pays the terminator, ``b*`` remainder bits and one
    sign bit, plus the 32-bit µ header.  Unlike :func:`stc_message_bits`
    (the Eq. 17 *expectation* under the geometric gap model) this holds for
    EVERY realizable mask, so ``measured <= bound`` is assertable round by
    round -- the Eq. 13 / Eq. 15 cross-check of the measured ledger.
    """
    if nnz == 0:
        return 32.0
    b = golomb_b_star(p)
    return float((numel - nnz) // (2 ** b) + nnz * (b + 2) + 32)


def fedavg_message_bits(numel: int, weight_bits: int = 32) -> float:
    """FedAvg communicates the dense update."""
    return float(numel * weight_bits)


def signsgd_message_bits(numel: int) -> float:
    return float(numel)


def ternary_dense_bits(numel: int) -> float:
    """Dense ternary message (T-FedAvg-style, Xu et al. 2020).

    Every weight carries one of {-µ, 0, +µ}: log2(3) bits/weight at the
    entropy bound of an uncoded ternary stream, plus a 32-bit float µ.
    """
    return numel * math.log2(3.0) + 32.0


# ---------------------------------------------------------------------------
# Real bitstream codec (Algorithms 3 and 4) -- host-side numpy.
# ---------------------------------------------------------------------------


class _BitWriter:
    """MSB-first bit sink backed by packed bytes (one bit per BIT, not per
    byte: large models used to blow up 8x through the old uint8-per-bit
    buffer).  ``getvalue`` returns the packed payload; ``len`` is in bits."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0          # partial byte, MSB-first
        self._nacc = 0         # bits currently in _acc (0..7)

    def write(self, bit: int) -> None:
        self._acc = (self._acc << 1) | (bit & 1)
        self._nacc += 1
        if self._nacc == 8:
            self._bytes.append(self._acc)
            self._acc = 0
            self._nacc = 0

    def write_unary(self, q: int) -> None:
        for _ in range(q):
            self.write(1)
        self.write(0)

    def write_binary(self, value: int, width: int) -> None:
        for shift in range(width - 1, -1, -1):
            self.write((value >> shift) & 1)

    def getvalue(self) -> np.ndarray:
        """Packed payload bytes (zero-padded tail), MSB-first within bytes."""
        tail = ([self._acc << (8 - self._nacc)] if self._nacc else [])
        return np.frombuffer(bytes(self._bytes) + bytes(tail), np.uint8)

    def __len__(self) -> int:
        return 8 * len(self._bytes) + self._nacc


class _BitReader:
    """MSB-first reader over packed payload bytes with an explicit bit count."""

    def __init__(self, payload: np.ndarray, bit_len: int) -> None:
        self._payload = np.asarray(payload, dtype=np.uint8)
        self._bit_len = int(bit_len)
        self._pos = 0

    def eof(self) -> bool:
        return self._pos >= self._bit_len

    def read(self) -> int:
        byte = int(self._payload[self._pos >> 3])
        bit = (byte >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return bit

    def read_binary(self, width: int) -> int:
        v = 0
        for _ in range(width):
            v = (v << 1) | self.read()
        return v


def encode_ternary(tensor: np.ndarray, p: float) -> tuple[np.ndarray, int, float, int]:
    """Algorithm 3: Golomb-encode a flat ternary tensor ``{-µ,0,µ}``.

    Returns ``(payload, bit_len, µ, n)`` where ``payload`` is the packed
    uint8 byte stream (MSB-first, zero-padded tail) and ``bit_len`` the exact
    number of meaningful bits.  Each nnz is encoded as Golomb(gap) followed
    by one sign bit (1 -> +µ).

    This per-bit host loop is the ORACLE codec: the vectorized packer in
    :mod:`repro_torch.core.wire` must produce bit-identical streams (asserted in
    tests); use the wire module for anything performance-sensitive.
    """
    tensor = np.asarray(tensor).reshape(-1)
    nz = np.flatnonzero(tensor)
    mu = float(np.abs(tensor[nz]).mean()) if nz.size else 0.0
    b_star = golomb_b_star(p)
    w = _BitWriter()
    prev = -1
    for idx in nz:
        d = int(idx) - prev  # gap >= 1
        q, r = divmod(d - 1, 2**b_star)
        w.write_unary(q)
        w.write_binary(r, b_star)
        w.write(1 if tensor[idx] > 0 else 0)
        prev = int(idx)
    return w.getvalue(), len(w), mu, int(tensor.size)


def decode_ternary(
    payload: np.ndarray, bit_len: int, mu: float, n: int, p: float
) -> np.ndarray:
    """Algorithm 4: decode a packed Golomb bitstream back to the flat tensor."""
    b_star = golomb_b_star(p)
    out = np.zeros(n, dtype=np.float32)
    r = _BitReader(payload, bit_len)
    pos = -1
    q = 0
    while not r.eof():
        bit = r.read()
        if bit == 1:
            q += 1
            continue
        # terminator of the unary part -> read b* remainder bits + 1 sign bit
        rem = r.read_binary(b_star)
        sign = 1.0 if r.read() == 1 else -1.0
        pos += q * (2**b_star) + rem + 1
        out[pos] = sign * mu
        q = 0
    return out
