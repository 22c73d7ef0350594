"""Ternary wire batches for the Golomb field decode tests: valid batches,
the chunk-boundary traps of the card decoder, and corrupt variants.

numpy and the port only (no JAX), so the card tests can use them.  A case
is ``(name, batch, p)``: a port :class:`~repro_torch.core.wire.WireBatch`
and a sparsity whose Golomb parameter ``b* = golomb_b_star(p)`` it was
encoded with (:func:`p_for_b` gives one for every ``b`` in 0..30).
"""

import math

import numpy as np

from repro_torch.core import golomb, wire

P_GRID = [1 / 400, 1 / 50, 0.1, 0.5]
CHUNK_BITS = 128            # csrc/golomb_decode.cu: a chunk of the decode


def p_for_b(b: int) -> float:
    """A sparsity whose optimal Golomb parameter is ``b``."""
    p = 0.5 if b == 0 else -math.expm1(
        math.log(golomb._PHI - 1.0) / 2.0 ** (b - 0.5))
    assert golomb.golomb_b_star(p) == b, (b, p)
    return p


def ternary(rng, n, density, mu=0.37):
    x = np.zeros(n, np.float32)
    m = rng.random(n) < density
    x[m] = np.where(rng.random(int(m.sum())) < 0.5, mu, -mu)
    return x


def encode_rows(x, p):
    """Each row packed on its own, then concatenated (any density)."""
    b = wire._b_star_checked(p)
    return wire.concat_messages([
        wire._encode_from_nz(row, np.flatnonzero(row), b, "numpy")
        for row in np.atleast_2d(x)])


def valid_cases():
    """Mixed-density rows (one empty) at the P grid and at b = 30."""
    cases = []
    for p in P_GRID + [p_for_b(30)]:
        rng = np.random.default_rng(int(1 / p) % 2**32)
        x = np.stack([ternary(rng, 5003, min(d, 1.0))
                      for d in (p, 4 * p, 0.0, 0.5, 0.03)])
        cases.append((f"p={p:.3g}", encode_rows(x, p), p))
    return cases


def _aligned_gaps(b, n_codewords, rng):
    """Gaps of codewords that end exactly on a chunk end (and so on a word
    end) half the time they can."""
    gaps, used = [], 0
    for _ in range(n_codewords):
        room = CHUNK_BITS - used % CHUNK_BITS
        if room >= b + 2 and rng.random() < 0.5:
            q = room - (b + 2)
        else:
            q = int(rng.integers(0, 40))
        gaps.append((q << b) + 1)
        used += q + b + 2
    return np.asarray(gaps, np.int64)


def trap_cases():
    """The decoder's traps: unary runs over several chunks and compose
    tiles, remainder and sign bits across word and chunk ends, codewords
    ending on chunk ends, ``bit_len % 32 == 0``, empty segments, b = 0
    (:func:`valid_cases` has b = 30)."""
    rng = np.random.default_rng(11)
    cases = []
    for b in (0, 1, 5):
        p = p_for_b(b)
        n = 600_000 if b < 2 else 60_000
        x = np.zeros((4, n), np.float32)
        # runs of n/4 ones: across chunks, and across compose tiles
        x[0, [5, n // 4, n // 4 + 5, n // 2, n // 2 + 1, n - 1]] = 1.0
        x[1, np.arange(7, n, 977)] = -1.0        # q across word ends
        gaps = _aligned_gaps(b, 400, rng)
        pos = np.cumsum(gaps) - 1
        x[3, pos[pos < n]] = np.where(rng.random(int((pos < n).sum()))
                                      < 0.5, 1.0, -1.0)
        # row 2 stays empty: a segment with no words between two others
        cases.append((f"traps b={b}", encode_rows(x, p), p))
    for seed in range(400):                      # bit_len % 32 == 0
        r2 = np.random.default_rng(1000 + seed)
        p = P_GRID[seed % len(P_GRID)]
        x = ternary(r2, int(r2.integers(50, 3000)), 4 * p)
        batch = encode_rows(x, p)
        if batch.bit_len[0] and batch.bit_len[0] % 32 == 0:
            cases.append((f"bit_len%32 seed={seed}", batch, p))
    return cases


def cnn_round(seed=7):
    """A cnn round's upstream batch: 10 x 307,434 at p = 1/50."""
    rng = np.random.default_rng(seed)
    x = np.stack([ternary(rng, 307_434, 1 / 50) for _ in range(10)])
    return wire.encode_ternary_words_batch(x, 1 / 50), 1 / 50


def corrupt_cases(n_cases, seed=0):
    """Mutations of valid batches (flipped bits, an all-ones or all-zeros
    word, a changed nnz, bit_len or numel, an all-ones buffer); some still
    decode, most must raise."""
    rng = np.random.default_rng(seed)
    cases = []
    for trial in range(n_cases):
        p = [1 / 50, 0.1, 0.5, p_for_b(30), 1 / 16][trial % 5]
        rows = int(rng.integers(1, 5))
        n = int(rng.integers(20, 4000))
        x = np.stack([ternary(rng, n, float(rng.choice([0.0, p, 4 * p])))
                      for _ in range(rows)])
        batch = encode_rows(x, p)
        words, nnz = batch.words.copy(), batch.nnz.copy()
        bit_len, numel = batch.bit_len.copy(), batch.numel
        mode = trial % 6
        if mode == 0 and words.size:
            i = rng.integers(0, words.size, int(rng.integers(1, 5)))
            words[i] ^= np.uint32(1) << rng.integers(0, 32, i.size).astype(
                np.uint32)
        elif mode == 1 and words.size:
            words[rng.integers(0, words.size)] = rng.choice(
                np.asarray([0, 0xFFFFFFFF], np.uint32))
        elif mode == 2:
            nnz[rng.integers(rows)] += int(rng.choice([-2, -1, 1, 3]))
        elif mode == 3:
            k = rng.integers(rows)
            bit_len[k] = int(rng.integers(0, 32 * batch.word_count[k] + 1))
        elif mode == 4:
            numel = int(rng.integers(1, n + 1))
        else:
            words[:] = np.uint32(0xFFFFFFFF)
        cases.append((f"corrupt {trial} mode {mode}",
                      batch._replace(words=words, nnz=nnz, bit_len=bit_len,
                                     numel=numel), p))
    return cases


def fuzz_messages():
    """The 60 single-message mutations of the reference's wire fuzz test
    (same generator, same draws): ``(trial, message, p)``."""
    rng = np.random.default_rng(0)
    p = 1 / 16
    out = []
    for trial in range(60):
        n = int(rng.integers(64, 2048))
        x = np.zeros(n, np.float32)
        k = max(1, int(n * p))
        idx = rng.choice(n, size=k, replace=False)
        x[idx] = rng.choice([-1.0, 1.0], size=k)
        msg = wire.encode_ternary_words(x, p)
        words = np.asarray(msg.words).copy()
        mode = trial % 3
        if mode == 0 and words.size:
            i = rng.integers(0, words.size, 4)
            words[i] ^= (np.uint32(1) << rng.integers(0, 32, 4)
                         .astype(np.uint32))
            bad = msg._replace(words=words)
        elif mode == 1 and words.size:
            bad = msg._replace(words=words[: words.size // 2])
        else:
            bad = msg._replace(nnz=int(msg.nnz) + int(rng.integers(1, 5)))
        out.append((trial, bad, p))
    return out
