"""The port's kernel oracles (``kernels/ref.py``) and the reference's
kernel names in ``repro_torch.kernels``.

* Each oracle against ``repro.kernels.ref`` (and the reference's
  ``stc_compress_ref``, ``pack_bits_ref``, ``unpack_bits_ref``) on seeded
  numpy inputs: counts, thresholds, masks, words and bits exact; sums
  and µ within rtol 1e-6 (the reference sums in fp32 in XLA's order, the
  port in fp64 rounded once), and STC's ternary values and residuals
  within 2e-6·µ, what that last bit of µ moves.
* The one-row entries ``stc_apply``, ``magnitude_histogram`` and
  ``hist_topk_threshold`` are the batched wrappers' row of one, and hold
  to the oracles; ``pack_bits_words`` / ``pack_bits_words_batched`` are
  ``pack_bits`` / ``pack_bits_batched``; ``PASSES`` is the selection's
  counter; every name of the reference's ``__all__`` but
  ``resolve_interpret`` is exported.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as ref_kernels
from repro.kernels import ref as ref_oracles
from repro_torch import kernels
from repro_torch.core import selection
from repro_torch.kernels import ref

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SIZES = (1, 33, 1000, 4097)


def _vector(n, seed, zeros=0.1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * rng.uniform(0.01, 3.0)).astype(np.float32)
    x[rng.random(n) < zeros] = 0.0
    return x


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(x.copy())


@pytest.mark.parametrize("n", SIZES)
def test_threshold_stats_ref(n):
    x = _vector(n, n)
    jx, tx = _pair(x)
    for t in (0.0, float(np.median(np.abs(x))), float(np.abs(x).max()),
              1e9):
        c_ref, s_ref = ref_oracles.threshold_stats_ref(jx, jnp.float32(t))
        c, s = ref.threshold_stats_ref(tx, t)
        assert c.dtype == torch.int32 and int(c) == int(c_ref), t
        np.testing.assert_allclose(float(s), float(s_ref), rtol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_topk_threshold_ref(n):
    x = _vector(n, 10 + n)
    jx, tx = _pair(x)
    for k in sorted({1, max(n // 50, 1), max(n // 2, 1), n}):
        for iters in (8, 32):
            want = ref_oracles.topk_threshold_ref(jx, k, iters=iters)
            got = ref.topk_threshold_ref(tx, k, iters=iters)
            assert np.float32(got) == np.float32(want), (k, iters)


@pytest.mark.parametrize("n", SIZES)
def test_magnitude_histogram_ref(n):
    x = _vector(n, 20 + n)
    jx, tx = _pair(x)
    a_max = float(np.abs(x).max())
    scale = np.float32(256.0 / a_max) if a_max else np.float32(0.0)
    c_ref, s_ref = ref_oracles.magnitude_histogram_ref(jx,
                                                       jnp.float32(scale))
    c, s = ref.magnitude_histogram_ref(tx, torch.tensor(scale))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-6)
    c1, s1 = kernels.magnitude_histogram(tx, torch.tensor(scale))
    np.testing.assert_array_equal(c1.numpy(), c.numpy())
    np.testing.assert_allclose(s1.numpy(), s.numpy(), rtol=1e-6)


@pytest.mark.parametrize("n", SIZES)
def test_stc_apply_and_fused_ref(n):
    x, r = _vector(n, 30 + n), _vector(n, 40 + n, zeros=0.5)
    (jx, tx), (jr, tr) = _pair(x), _pair(r)
    carried = x + r
    t = np.float32(np.quantile(np.abs(carried), 0.9))
    mu = np.float32(np.abs(carried)[np.abs(carried) >= t].mean())
    want = ref_oracles.stc_apply_ref(jnp.asarray(carried), jnp.float32(t),
                                     jnp.float32(mu))
    got = ref.stc_apply_ref(torch.from_numpy(carried), t, mu)
    one_row = kernels.stc_apply(torch.from_numpy(carried), torch.tensor(t),
                                torch.tensor(mu))
    for w, g, o in zip(want, got, one_row):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(o.numpy(), np.asarray(w))
    want = ref_oracles.stc_fused_ref(jx, jr, jnp.float32(t), jnp.float32(mu))
    got = ref.stc_fused_ref(tx, tr, t, mu)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("p", [1 / 50, 1 / 400, 0.5])
@pytest.mark.parametrize("n", SIZES)
def test_stc_compress_ref(n, p):
    x, r = _vector(n, 50 + n), _vector(n, 60 + n, zeros=0.7)
    (jx, tx), (jr, tr) = _pair(x), _pair(r)
    want = ref_kernels.stc_compress_ref(jx, jr, p)
    got = kernels.stc_compress_ref(tx, tr, p)
    tern, res, mu, thresh, cnt = got
    assert float(thresh) == float(want[3]) and int(cnt) == int(want[4])
    np.testing.assert_allclose(float(mu), float(want[2]), rtol=1e-6)
    # the same mask and signs; the values move with µ's last bit
    np.testing.assert_array_equal(np.sign(tern.numpy()),
                                  np.sign(np.asarray(want[0])))
    atol = 2e-6 * float(mu)
    np.testing.assert_allclose(tern.numpy(), np.asarray(want[0]), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(res.numpy(), np.asarray(want[1]), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("m", [1, 31, 32, 33, 1000])
def test_pack_and_unpack_bits_ref(m):
    rng = np.random.default_rng(m)
    bits = (rng.random(m) < 0.3).astype(np.uint8)
    want = np.asarray(ref_kernels.pack_bits_ref(jnp.asarray(bits)))
    got = kernels.pack_bits_ref(torch.from_numpy(bits))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        kernels.pack_bits_words(torch.from_numpy(bits)).numpy(),
        got.numpy())
    back = kernels.unpack_bits_ref(got)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref_kernels.unpack_bits_ref(
            jnp.asarray(want))))
    np.testing.assert_array_equal(back.numpy()[:m], bits)


@pytest.mark.parametrize("n", SIZES)
def test_hist_topk_threshold_is_the_batched_row(n):
    x = torch.from_numpy(_vector(n, 70 + n))
    k = max(n // 50, 1)
    t, c, s = kernels.hist_topk_threshold(x, k)
    tb, cb, sb = kernels.hist_topk_threshold_batched(x[None], k)
    assert (t.shape, c.shape, s.shape) == ((), (), ())
    assert torch.equal(t, tb[0]) and torch.equal(c, cb[0]) \
        and torch.equal(s, sb[0])
    # the exact k-th largest magnitude
    a = x.abs()
    assert int((a >= t).sum()) >= k and int((a > t).sum()) < k


def test_reference_names_are_exported():
    assert kernels.pack_bits_words is kernels.pack_bits
    assert kernels.pack_bits_words_batched is kernels.pack_bits_batched
    assert kernels.PASSES is selection.PASSES
    missing = set(ref_kernels.__all__) - set(kernels.__all__)
    assert missing == {"resolve_interpret"}
    assert set(ref_oracles.__all__) <= set(ref.__all__)
    for name in kernels.__all__:
        assert hasattr(kernels, name), name
