"""Port parity: the histogram binning and bin search of core/selection.py.

``bin_index`` must equal the reference bitwise (bin edges, the all-zero
row's scale 0, the row maximum); ``locate_bin`` must give the same bin,
above-bin count, above-bin sum and bin population.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as ref
from repro_torch.core import selection as port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _edge_values(scale: np.float32) -> np.ndarray:
    """Magnitudes on, just below and just above every bin edge j / scale."""
    edges = (np.arange(0, 258, dtype=np.float32) / scale).astype(np.float32)
    return np.concatenate([
        edges, np.nextafter(edges, np.float32(np.inf)),
        np.nextafter(edges, np.float32(0)), np.float32([0.0])])


@pytest.mark.parametrize("a_max", [1.0, 3.7e-3, 123.456, 1e-20, 7e25])
def test_bin_index_bitwise_at_bin_edges(a_max):
    scale = np.float32(256.0) / np.float32(a_max)
    a = _edge_values(scale)
    a = np.concatenate([a, np.float32([a_max])])
    want = np.asarray(ref.bin_index(jnp.asarray(a), jnp.float32(scale), 256))
    got = port.bin_index(torch.from_numpy(a), torch.tensor(scale), 256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_bin_index_all_zero_row_scale_zero():
    a = np.zeros(1000, np.float32)
    want = np.asarray(ref.bin_index(jnp.asarray(a), jnp.float32(0.0), 256))
    got = port.bin_index(torch.from_numpy(a), torch.tensor(0.0), 256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) == 0


@pytest.mark.parametrize("seed", range(4))
def test_bin_index_bitwise_random_rows(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 5000)) * 10.0 ** rng.uniform(-8, 8, (3, 1))
         ).astype(np.float32)
    a = np.abs(x)
    scale = (np.float32(256.0) / a.max(axis=1)).astype(np.float32)
    want = np.asarray(ref.bin_index(jnp.asarray(a),
                                    jnp.asarray(scale)[:, None], 256))
    got = port.bin_index(torch.from_numpy(a),
                         torch.from_numpy(scale)[:, None], 256)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k_kind", ["small", "large", "per_row", "exact_bin"])
def test_locate_bin_exact(seed, k_kind):
    """Integer-valued float sums are exact in any summation order, so every
    output must match the reference exactly."""
    rng = np.random.default_rng(seed)
    rows, bins = 5, 256
    cnt = rng.integers(0, 40, (rows, bins)).astype(np.int32)
    cnt[:, rng.integers(0, bins, 30)] = 0                 # empty bins
    sums = (cnt * rng.integers(1, 9, (rows, bins))).astype(np.float32)
    total = cnt.sum(axis=1)
    if k_kind == "small":
        k = np.ones(rows, np.int64)
    elif k_kind == "large":
        k = total.astype(np.int64)
    elif k_kind == "per_row":
        k = rng.integers(1, total + 1).astype(np.int64)
    else:                   # k lands exactly on a bin's upper cumulative edge
        rc = np.cumsum(cnt[:, ::-1], axis=1)[:, ::-1]
        k = rc[:, 200].astype(np.int64)
        k = np.maximum(k, 1)
    want = jax.vmap(lambda c, s, kk: ref.locate_bin(c, s, kk, bins))(
        jnp.asarray(cnt), jnp.asarray(sums), jnp.asarray(k, jnp.int32))
    got = port.locate_bin(torch.from_numpy(cnt), torch.from_numpy(sums),
                          torch.from_numpy(k), bins)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pass_counter():
    port.PASSES.reset()
    port.PASSES.record("max")
    port.PASSES.record("histogram", 2)
    assert port.PASSES.total() == 3
    assert port.PASSES.counts == {"max": 1, "histogram": 2}
    port.PASSES.reset()
    assert port.PASSES.total() == 0


def test_flush_subnormal_keeps_the_sign_and_every_normal():
    """What XLA's flush-to-zero does to an fp32 input: a subnormal becomes
    the zero of its sign; zeros, normals, infinities and NaN stay."""
    x = np.array([1e-40, -1e-40, 1.17e-38, port.FLT_MIN, -port.FLT_MIN, 0.0,
                  -0.0, 2.5, np.inf, -np.inf, np.nan], np.float32)
    got = port.flush_subnormal(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x) * jnp.float32(1.0))     # XLA's flush
    np.testing.assert_array_equal(got.view(np.uint32)[:-1],
                                  want.view(np.uint32)[:-1])
    assert np.isnan(got[-1])
    assert port.FLT_MIN == np.finfo(np.float32).tiny


@pytest.mark.parametrize("a_max", [1e-36, 1.0])
def test_bin_index_flushes_subnormal_magnitudes(a_max):
    """A subnormal magnitude lands in bin 0 as in the reference, whose
    product flushes it, even where the row's scale would lift it above."""
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.uniform(0, 1.2e-38, 500),
                        rng.uniform(0, a_max, 500)]).astype(np.float32)
    scale = np.float32(256.0) / np.float32(a_max)
    want = np.asarray(ref.bin_index(jnp.asarray(a), jnp.float32(scale), 256))
    got = port.bin_index(torch.from_numpy(a), torch.tensor(scale), 256)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.numpy()[a < port.FLT_MIN].any()
