"""Port parity of the wire-decode kernel's plain version and of the
``"kernel"`` decode backend.

* ``unpack_words_with_counts`` on a CPU tensor (the plain version) against
  the reference's Pallas kernel in interpret mode and the host
  ``_unpack_bits_numpy``: bits and zero counts identical, at the edge words
  0, 1, 0x80000000 and 0xFFFFFFFF and at W in {0, 1, 2, 129, 5000};
* ``pack_bits`` then ``unpack_bits_words`` is the identity on the stream;
* the ``"kernel"`` decode backend, asked for the CPU, parses the same fields
  as the ``"numpy"`` one and as the reference, and without a device it
  needs a card.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as ref_wire
from repro.kernels import unpack_words_with_counts as ref_unpack
from repro_torch import kernels as rk
from repro_torch.core import wire
from repro_torch.core.selection import PASSES

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

EDGE = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)


def _words(n_words, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32)
    w[:min(n_words, EDGE.size)] = EDGE[:n_words]
    return w


def _as_tensor(w):
    return torch.from_numpy(w.view(np.int32))


@pytest.mark.parametrize("n_words", [0, 1, 2, 129, 5000])
def test_plain_unpack_matches_reference_and_numpy(n_words):
    w = _words(n_words, n_words)
    bits, zeros = rk.unpack_words_with_counts(_as_tensor(w))
    assert bits.dtype == torch.uint8 and zeros.dtype == torch.int32
    assert bits.shape == (32 * n_words,) and zeros.shape == (n_words,)
    want_bits, want_zeros = ref_unpack(jnp.asarray(w), interpret=True)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(zeros.numpy(), np.asarray(want_zeros))
    np.testing.assert_array_equal(bits.numpy(),
                                  ref_wire._unpack_bits_numpy(w))
    np.testing.assert_array_equal(
        zeros.numpy(), 32 - np.unpackbits(w.astype(">u4").view(np.uint8))
        .reshape(-1, 32).sum(axis=1))


def test_edge_words():
    bits, zeros = rk.unpack_words_with_counts(_as_tensor(EDGE.copy()))
    rows = bits.numpy().reshape(4, 32)
    assert rows[0].sum() == 0 and rows[1].tolist() == [0] * 31 + [1]
    assert rows[2].tolist() == [1] + [0] * 31 and rows[3].sum() == 32
    assert zeros.tolist() == [32, 31, 31, 0]


@pytest.mark.parametrize("m", [1, 31, 32, 33, 4097])
def test_pack_then_unpack_is_identity(m):
    bits = (np.random.default_rng(m).random(m) < 0.4).astype(np.uint8)
    words = rk.pack_bits(torch.from_numpy(bits))
    back = rk.unpack_bits_words(words)
    assert back.shape == (32 * words.numel(),)
    np.testing.assert_array_equal(back.numpy()[:m], bits)
    assert int(back[m:].sum()) == 0              # word padding is zero


def test_unpack_bits_words_drops_the_counts():
    w = _as_tensor(_words(77, 3))
    assert torch.equal(rk.unpack_bits_words(w),
                       rk.unpack_words_with_counts(w)[0])
    assert torch.equal(rk.unpack_words_plain(w)[0],
                       rk.unpack_words_with_counts(w)[0])


def test_wrapper_validates_and_never_launches_on_cpu():
    rk.LAUNCHES.reset()
    PASSES.reset()
    rk.unpack_words_with_counts(_as_tensor(_words(10, 0)))
    assert rk.LAUNCHES.counts["unpack_bits"] == 0
    assert PASSES.counts == {"unpack_bits": 1}
    with pytest.raises(ValueError):
        rk.unpack_words_with_counts(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        rk.unpack_words_with_counts(torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        rk.unpack_words_with_counts(
            torch.zeros(4, dtype=torch.int32, device="meta"))


def _ternary(rng, n, density, mu=0.37):
    x = np.zeros(n, np.float32)
    m = rng.random(n) < density
    x[m] = np.where(rng.random(int(m.sum())) < 0.5, mu, -mu)
    return x


@pytest.mark.parametrize("p", [1 / 400, 1 / 50, 0.1])
def test_kernel_backend_decode_on_cpu(p):
    rng = np.random.default_rng(int(1 / p))
    x = np.stack([_ternary(rng, 5003, d) for d in (p, 4 * p, 0.0, 0.5)])
    batch = wire.encode_ternary_words_batch(x, p)
    want = ref_wire.decode_ternary_fields_batch(
        ref_wire.encode_ternary_words_batch(x, p), p)
    got = wire.decode_ternary_fields_batch(batch, p, backend="kernel",
                                           device="cpu")
    for g, h, w in zip(got, wire.decode_ternary_fields_batch(batch, p), want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(h, w)
    np.testing.assert_array_equal(
        wire.decode_ternary_words_batch(batch, p, backend="kernel",
                                        device="cpu"), x)
    msg = batch.message(1)
    np.testing.assert_array_equal(
        wire.decode_ternary_words(msg, p, backend="kernel", device="cpu"),
        x[1])


def test_sign_plane_bits_kernel_backend_on_cpu():
    x = np.random.default_rng(4).standard_normal(1001).astype(np.float32)
    msg = wire.pack_sign_words(x, 2e-4)
    got = wire.sign_plane_bits(msg, backend="kernel", device="cpu")
    np.testing.assert_array_equal(got, (x > 0).astype(np.uint8))
    np.testing.assert_array_equal(
        got, ref_wire.sign_plane_bits(ref_wire.pack_sign_words(x, 2e-4)))


def test_kernel_decode_without_device_needs_cuda():
    """The "kernel" unpack defaults to the card and never falls back to the
    CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = _ternary(np.random.default_rng(0), 1000, 0.05)
    msg = wire.encode_ternary_words(x, 0.05)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wire.decode_ternary_fields(msg, 0.05, backend="kernel")
