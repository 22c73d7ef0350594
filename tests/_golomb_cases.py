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


def encode_gaps(gap_lists, b, numel, seed=0):
    """A valid batch from each segment's gaps (``position[k] -
    position[k-1]``, the first from -1) at Golomb parameter ``b``, random
    signs, every segment starting on a word; an empty list is an empty
    segment.  Builds the bits directly, so any ``b`` and any run length is
    cheap."""
    rng = np.random.default_rng(seed)
    words, start, count, bit_len, nnz = [], [], [], [], []
    at = 0
    for gaps in gap_lists:
        gaps = np.asarray(gaps, np.int64)
        q, r = (gaps - 1) >> b, (gaps - 1) & ((1 << b) - 1)
        lengths = q + b + 2
        first = np.cumsum(lengths) - lengths
        total = int(lengths.sum())
        bits = np.zeros(total + (-total) % 32, np.int8)
        ones = np.zeros(bits.size + 1, np.int64)      # runs as a difference
        np.add.at(ones, first, 1)
        np.add.at(ones, first + q, -1)
        bits[np.cumsum(ones)[:-1] > 0] = 1
        for j in range(b):                            # remainder, MSB first
            bits[first + q + 1 + j] = (r >> (b - 1 - j)) & 1
        bits[first + q + b + 1] = rng.random(gaps.size) < 0.5
        seg_words = (np.packbits(bits.astype(np.uint8)).view(">u4")
                     .astype(np.uint32))
        words.append(seg_words)
        start.append(at)
        count.append(seg_words.size)
        bit_len.append(total)
        nnz.append(gaps.size)
        at += seg_words.size
    z = np.asarray
    return wire.WireBatch(np.concatenate(words) if words else
                          np.zeros(0, np.uint32), z(start, np.int64),
                          z(count, np.int64), z(bit_len, np.int64),
                          np.ones(len(gap_lists), np.float64),
                          z(nnz, np.int64), int(numel))


def _geometric_gaps(rng, n, p):
    return rng.geometric(p, n).astype(np.int64)


def synthetic_cases():
    """Batches of the shapes the card decode's launch plans turn on: the
    chunked codec's widest group (740 segments of ~5 chunks), empty
    segments first, between and last, segments of exactly a tile of a
    cluster and one chunk more, segments longer than a cluster's tile with
    unary runs over chunk, CTA and tile edges, and b = 0 and b = 30."""
    rng = np.random.default_rng(27)
    cases = []
    p = 1 / 50
    b = golomb.golomb_b_star(p)
    group = [_geometric_gaps(rng, int(rng.integers(60, 100)), p)
             for _ in range(740)]
    cases.append(("740 tiny segments", encode_gaps(group, b, 4096 * 80),
                  p))
    mid = _geometric_gaps(rng, 6000, p)
    cases.append(("empty first, between and last", encode_gaps(
        [[], mid, [], mid[:77], []], b, 10**6), p))
    # 8 CTAs of 64 chunks hold 512, 16 hold 1,024
    for n_chunks in (512, 513, 1024, 1025):
        gaps = _geometric_gaps(rng, 20 * n_chunks, p)
        used = np.cumsum(((gaps - 1) >> b) + b + 2)
        gaps = gaps[:np.searchsorted(used, CHUNK_BITS * n_chunks, "right")]
        cases.append((f"one segment of {n_chunks} chunks",
                      encode_gaps([gaps], b, int(gaps.sum()) + 5), p))
    for b_long in (0, 5):
        gaps = _geometric_gaps(rng, 30_000, 0.5 if b_long == 0 else p)
        gaps[[10, 4_000, 9_000, 9_001, 20_000]] = [70_000, 9_000, 200_000,
                                                   128, 131_072]
        cases.append((f"long runs over tiles b={b_long}",
                      encode_gaps([gaps[:20], gaps, gaps[:3_000]], b_long,
                                  int(gaps.sum()) + 1), p_for_b(b_long)))
    big = rng.integers(1, 1 << 30, 25_000) + (rng.integers(0, 3, 25_000)
                                               << 30)
    cases.append(("b=30 over tiles", encode_gaps([big[:40], big, []], 30,
                                                 int(big.sum()) + 1),
                  p_for_b(30)))
    return cases
