"""Port parity of the wire format: the numpy copies of core/wire.py and
core/golomb.py, and the plain versions of the ``pack_bits`` and
``pack_chunks`` kernels.

Word streams are byte-identical to the reference's on the same ternary
inputs, for the port's "numpy" backend and its "kernel" backend (whose
packers run their plain versions on the CPU), in the fused and the
per-client regime of the batch encode; the analytic Golomb bits are equal.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import golomb as ref_golomb
from repro.core import wire as ref_wire
from repro.kernels import pack_bits_words as ref_pack_kernel
from repro_torch.core import golomb, wire
from repro_torch.kernels import (pack_bits, pack_bits_plain, pack_chunks,
                                 pack_chunks_plain)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

P_GRID = [1 / 400, 1 / 50, 0.1, 0.5]


def _ternary(rng, shape, density, mu=0.37):
    x = np.zeros(shape, np.float32)
    m = rng.random(shape) < density
    x[m] = np.where(rng.random(int(m.sum())) < 0.5, mu, -mu)
    return x


def _same_message(a, b):
    assert a.words.dtype == b.words.dtype == np.uint32
    np.testing.assert_array_equal(a.words, b.words)
    assert (a.bit_len, a.numel, a.nnz) == (b.bit_len, b.numel, b.nnz)
    assert a.mu == b.mu


def _same_batch(a, b):
    for field in ("words", "word_start", "word_count", "bit_len", "mu",
                  "nnz"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert a.numel == b.numel


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("p", P_GRID)
def test_encode_ternary_words_identical(backend, p):
    rng = np.random.default_rng(int(1 / p))
    for density in (p, 4 * p, 0.9):
        x = _ternary(rng, 6007, min(density, 1.0))
        want = ref_wire.encode_ternary_words(x, p)
        got = wire.encode_ternary_words(x, p, backend=backend, device="cpu")
        _same_message(got, want)
        np.testing.assert_array_equal(
            wire.decode_ternary_words(got, p),
            ref_wire.decode_ternary_words(want, p))


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
@pytest.mark.parametrize("rows,n,density", [(5, 3000, 0.02),
                                            (10, 20_000, 0.2),  # dense
                                            (3, 500, 0.0)])
def test_encode_ternary_words_batch_identical(backend, rows, n, density):
    rng = np.random.default_rng(rows * n)
    x = _ternary(rng, (rows, n), density)
    want = ref_wire.encode_ternary_words_batch(x, 1 / 50)
    got = wire.encode_ternary_words_batch(x, 1 / 50, backend=backend,
                                          device="cpu")
    _same_batch(got, want)


def test_encode_handles_long_gaps():
    """Quotients of 32 and more take the multi-chunk codeword path."""
    x = np.zeros(200_000, np.float32)
    x[[3, 150_000, 199_999]] = [1.0, -1.0, 1.0]
    for backend in ("numpy", "kernel"):
        _same_message(wire.encode_ternary_words(x, 0.1, backend=backend,
                                                device="cpu"),
                      ref_wire.encode_ternary_words(x, 0.1))


def test_per_client_regime_empty_client_and_long_quotient():
    """Above the fused-batch limit the "kernel" backend packs every
    client's chunks in one call: an empty client (no words) and a client
    whose gaps need 32-one chunks (quotients >= 32) keep their fields."""
    rng = np.random.default_rng(11)
    x = _ternary(rng, (6, 30_000), 0.4)
    x[2] = 0.0                                           # empty client
    x[4] = 0.0
    x[4, [5, 9_000, 29_999]] = [0.37, -0.37, 0.37]      # gaps >> 32 * 2^b*
    assert int((x != 0).sum()) > wire._FUSED_NNZ_MAX
    want = ref_wire.encode_ternary_words_batch(x, 1 / 50)
    assert want.word_count[2] == 0 and want.bit_len[4] > 3 * 32
    for backend in ("numpy", "kernel"):
        got = wire.encode_ternary_words_batch(x, 1 / 50, backend=backend,
                                              device="cpu")
        _same_batch(got, want)
    np.testing.assert_array_equal(
        wire.decode_ternary_words_batch(got, 1 / 50),
        ref_wire.decode_ternary_words_batch(want, 1 / 50))


def _chunk_case(case, seed):
    """``(vals uint64, lens int64, offs int64, total_bits)`` chunk sets."""
    rng = np.random.default_rng(seed)
    if case == "random":                     # lengths 1-63, back to back
        lens = rng.integers(1, 64, 700)
        offs = np.cumsum(lens) - lens
    elif case == "straddle_one":             # bits 20..49 of each 64
        lens = np.full(300, 30)
        offs = 64 * np.arange(300) + 20
    elif case == "straddle_two":             # 63 bits over 3 words
        lens = np.full(300, 63)
        offs = 96 * np.arange(300) + 31
    elif case == "ones32":                   # 32-one chunks, odd offsets
        lens = np.where(rng.random(400) < 0.5, 32, rng.integers(1, 64, 400))
        offs = np.cumsum(lens) - lens + 7
    elif case == "one_bit":                  # 32 chunks to a word
        lens = np.ones(1100, np.int64)
        offs = np.arange(1100)
    elif case == "long_gaps":                # runs of empty words
        lens = np.where(rng.random(600) < 0.3, 63, rng.integers(1, 64, 600))
        offs = np.cumsum(lens) - lens + 32 * (np.arange(600) // 200) * 1100
    else:                                    # word-aligned client starts
        lens = rng.integers(1, 64, 900)
        offs = np.cumsum(lens) - lens
        for cut in sorted(rng.choice(np.arange(1, 900), 6, replace=False)):
            gap = (-int(offs[cut]) % 32) + 32 * int(rng.integers(0, 3))
            offs[cut:] += gap
    lens = lens.astype(np.int64)
    vals = rng.integers(0, 1 << 63, lens.size, dtype=np.uint64)
    vals &= (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    if case == "ones32":
        vals[lens == 32] = np.uint64(0xFFFFFFFF)
    if case == "long_gaps":
        vals[::7] = 0                        # chunks of zeros
    total_bits = int(offs[-1] + lens[-1]) + int(rng.integers(1, 31))
    return vals, lens, offs.astype(np.int64), total_bits


@pytest.mark.parametrize("case", ["random", "straddle_one", "straddle_two",
                                  "ones32", "client_gaps", "one_bit",
                                  "long_gaps"])
def test_plain_pack_chunks_matches_scatter_and_reference_kernel(case):
    vals, lens, offs, total_bits = _chunk_case(case, len(case))
    assert total_bits % 32
    want = ref_wire._scatter_chunks_numpy(vals, lens, offs, total_bits)
    t = (torch.from_numpy(vals.view(np.int64)),
         torch.from_numpy(lens.astype(np.int32)), torch.from_numpy(offs))
    got = pack_chunks(*t, total_bits).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pack_chunks_plain(*t, total_bits).numpy().view(np.uint32), want)
    np.testing.assert_array_equal(      # the Pallas kernel, interpreted
        ref_wire.get_wire_backend("kernel").pack_chunks(vals, lens, offs,
                                                        total_bits), want)
    np.testing.assert_array_equal(
        wire.get_wire_backend("kernel", "cpu").pack_chunks(vals, lens, offs,
                                                           total_bits), want)
    np.testing.assert_array_equal(
        wire._scatter_chunks_numpy(vals, lens, offs, total_bits), want)


@pytest.mark.parametrize("m", [1, 31, 32, 33, 1000, 4097, 70_001])
def test_plain_pack_bits_matches_numpy_and_reference_kernel(m):
    bits = (np.random.default_rng(m).random(m) < 0.4).astype(np.uint8)
    words = pack_bits(torch.from_numpy(bits)).numpy().view(np.uint32)
    np.testing.assert_array_equal(words, ref_wire._pack_bits_numpy(bits))
    np.testing.assert_array_equal(
        words, np.asarray(ref_pack_kernel(jnp.asarray(bits), interpret=True)))
    np.testing.assert_array_equal(pack_bits_plain(torch.from_numpy(bits)),
                                  pack_bits(torch.from_numpy(bits)))


def test_pack_bits_all_ones_word():
    """0xFFFFFFFF survives the int32 reinterpretation."""
    words = pack_bits(torch.ones(64, dtype=torch.uint8)).numpy()
    np.testing.assert_array_equal(words.view(np.uint32),
                                  np.full(2, 0xFFFFFFFF, np.uint32))


def test_sign_plane_identical():
    x = np.random.default_rng(4).standard_normal(1001).astype(np.float32)
    for backend in ("numpy", "kernel"):
        _same_message(wire.pack_sign_words(x, 2e-4, backend=backend,
                                           device="cpu"),
                      ref_wire.pack_sign_words(x, 2e-4))


def test_kernel_backend_without_device_needs_cuda():
    """The "kernel" packer defaults to the card and never falls back to the
    CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = _ternary(np.random.default_rng(0), 1000, 0.05)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wire.encode_ternary_words(x, 0.05, backend="kernel")


@pytest.mark.parametrize("p", [1e-4, 1 / 400, 1 / 50, 0.1, 0.5, 0.9])
def test_golomb_analytic_bits_equal(p):
    assert golomb.golomb_b_star(p) == ref_golomb.golomb_b_star(p)
    assert golomb.golomb_position_bits(p) == ref_golomb.golomb_position_bits(p)
    assert golomb.entropy_sparse_ternary(p) == \
        ref_golomb.entropy_sparse_ternary(p)
    for numel in (7850, 307_434):
        assert golomb.stc_message_bits(numel, p) == \
            ref_golomb.stc_message_bits(numel, p)
        for nnz in (0, 1, 100):
            assert golomb.stc_stream_bound_bits(numel, nnz, p) == \
                ref_golomb.stc_stream_bound_bits(numel, nnz, p)


def test_golomb_oracle_codec_identical():
    x = _ternary(np.random.default_rng(8), 3000, 0.03)
    payload, bit_len, mu, n = golomb.encode_ternary(x, 1 / 50)
    want = ref_golomb.encode_ternary(x, 1 / 50)
    np.testing.assert_array_equal(payload, want[0])
    assert (bit_len, mu, n) == want[1:]
    np.testing.assert_array_equal(
        golomb.decode_ternary(payload, bit_len, mu, n, 1 / 50),
        ref_golomb.decode_ternary(*want, 1 / 50))
