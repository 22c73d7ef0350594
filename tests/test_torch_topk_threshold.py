"""Port parity of the bisection selector: ``threshold_stats``'s plain
version, the ``topk_threshold`` driver and ``stc_compress_kernel(selector=
"bisect")``, against the reference's Pallas kernels in interpret mode.

* ``threshold_stats`` at t > 0 on the shapes of tests/test_kernels.py:
  count exact, Σ within rtol 1e-6;
* at t = 0 on rows with zeros: Algorithm 1 (zeros never counted; the
  reference kernel counts them there, ROADMAP Queue 3, R1);
* ``topk_threshold``: ``lo`` bitwise the reference's and the count exact,
  for p in {0.001, 0.01, 0.1};
* ``selector="bisect"``: ternary message and residual within 1e-6 of the
  reference's, count exact, and the same mask as ``selector="hist"`` on
  continuous data;
* the edge cases of ``tests/_bisect_cases.py`` (all zero, subnormal, k =
  n, ``iters = 0``, ties, n below 32, fewer non-zeros than k): ``lo``
  bitwise, counts exact where R1 does not apply, subnormals counted as
  zeros, as XLA's flush-to-zero makes them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _bisect_cases import EDGE_CASES, FLT_MIN, edge_row
from repro.core.compression import get_stc_backend as ref_backend
from repro.kernels import stc_compress_kernel as ref_stc_kernel
from repro.kernels import threshold_stats as ref_stats
from repro.kernels import topk_threshold as ref_topk
from repro_torch import kernels as rk
from repro_torch.core.selection import PASSES

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SHAPES = [64, 1000, 4096, 8192, 65536, 100_003]


def _rand(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * scale).astype(np.float32)


@pytest.mark.parametrize("n", SHAPES)
@pytest.mark.parametrize("t", [0.05, 0.8, 2.5])
def test_threshold_stats_matches_reference(n, t):
    x = _rand(n, n)
    cnt_r, sum_r = ref_stats(jnp.asarray(x), jnp.float32(t), interpret=True)
    cnt, total = rk.threshold_stats(torch.from_numpy(x), t)
    assert cnt.dtype == torch.int32 and total.dtype == torch.float32
    assert int(cnt) == int(cnt_r)
    np.testing.assert_allclose(float(total), float(sum_r), rtol=1e-6)


@pytest.mark.parametrize("zeros", [0.0, 0.3, 1.0])
def test_threshold_stats_at_zero_follows_algorithm_1(zeros):
    x = _rand(5000, 7)
    x[np.random.default_rng(8).random(5000) < zeros] = 0.0
    cnt, total = rk.threshold_stats(torch.from_numpy(x),
                                    torch.zeros((), dtype=torch.float32))
    nz = np.abs(x[x != 0]).astype(np.float64)
    assert int(cnt) == nz.size
    np.testing.assert_allclose(float(total), nz.sum(), rtol=1e-6)
    if zeros:                     # where the reference kernel differs (R1)
        cnt_r, _ = ref_stats(jnp.asarray(x), jnp.float32(0.0),
                             interpret=True)
        assert int(cnt_r) == x.size


def test_threshold_above_max_counts_nothing():
    x = torch.from_numpy(_rand(3000, 2))
    cnt, total = rk.threshold_stats(x, float(x.abs().max()) * 2)
    assert int(cnt) == 0 and float(total) == 0.0


@pytest.mark.parametrize("n", SHAPES)
@pytest.mark.parametrize("p", [0.001, 0.01, 0.1])
def test_topk_threshold_bitwise_reference(n, p):
    x = _rand(n, n + int(p * 1e4))
    k = max(int(n * p), 1)
    t_r, c_r, s_r = ref_topk(jnp.asarray(x), k, interpret=True)
    t, c, s = rk.topk_threshold(torch.from_numpy(x), k)
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  np.asarray(t_r).view(np.uint32))
    assert int(c) == int(c_r) == k              # continuous data: exact
    np.testing.assert_allclose(float(s), float(s_r), rtol=1e-6)


@pytest.mark.parametrize("nnz", [0, 1, 7])
def test_fewer_nonzeros_than_k_follow_jnp(nnz):
    """R1: lo stays 0; count and Σ cover the non-zeros only, as ``"jnp"``."""
    rng = np.random.default_rng(nnz)
    x = np.zeros(3000, np.float32)
    x[rng.choice(3000, nnz, replace=False)] = rng.standard_normal(nnz)
    t_j, c_j, s_j = ref_backend("jnp").select_batch(jnp.asarray(x[None]), 60)
    t, c, s = rk.topk_threshold(torch.from_numpy(x), 60)
    assert float(t) == float(t_j[0]) == 0.0
    assert int(c) == int(c_j[0]) == nnz
    np.testing.assert_allclose(float(s), float(s_j[0]), rtol=1e-6)


def test_bisection_passes_and_no_launch_on_cpu():
    PASSES.reset()
    rk.LAUNCHES.reset()
    rk.topk_threshold(torch.from_numpy(_rand(4096, 1)), 40, iters=32)
    assert PASSES.counts == {"threshold_stats": 33}
    assert rk.LAUNCHES.counts["threshold_stats"] == 0


def test_threshold_stats_validates_inputs():
    with pytest.raises(ValueError):
        rk.threshold_stats(torch.zeros((2, 4)), 0.5)
    with pytest.raises(ValueError):
        rk.threshold_stats(torch.zeros(4, dtype=torch.float64), 0.5)
    with pytest.raises(ValueError):
        rk.threshold_stats(torch.zeros(4), torch.zeros(2))
    with pytest.raises(ValueError, match="unsupported device"):
        rk.threshold_stats(torch.zeros(4, device="meta"), 0.5)
    with pytest.raises(ValueError):
        rk.topk_threshold(torch.zeros(4), 5)


@pytest.mark.parametrize("n", [1000, 8192, 100_003])
def test_stc_compress_bisect_matches_reference(n):
    d, r = _rand(n, 1), _rand(n, 2, 0.1)
    tern_r, res_r, mu_r, th_r, cnt_r = ref_stc_kernel(
        jnp.asarray(d), jnp.asarray(r), 0.01, selector="bisect",
        interpret=True)
    tern, res, mu, th, cnt = rk.stc_compress_kernel(
        torch.from_numpy(d), torch.from_numpy(r), 0.01, selector="bisect")
    np.testing.assert_allclose(tern.numpy(), np.asarray(tern_r), atol=1e-6)
    np.testing.assert_allclose(res.numpy(), np.asarray(res_r), atol=1e-6)
    assert int(cnt) == int(cnt_r)
    assert float(th) == float(th_r)
    np.testing.assert_allclose(float(mu), float(mu_r), rtol=1e-6)


@pytest.mark.parametrize("n", [1000, 30_011])
@pytest.mark.parametrize("p", [1 / 400, 1 / 50, 0.1])
def test_bisect_mask_equals_hist_mask(n, p):
    d, r = torch.from_numpy(_rand(n, 3)), torch.from_numpy(_rand(n, 4, 0.05))
    bis = rk.stc_compress_kernel(d, r, p, selector="bisect")
    hist = rk.stc_compress_kernel(d, r, p, selector="hist")
    assert torch.equal(bis[0] != 0, hist[0] != 0)
    assert torch.equal(torch.sign(bis[0]), torch.sign(hist[0]))
    assert int(bis[4]) == int(hist[4]) == max(int(n * p), 1)
    np.testing.assert_allclose(float(bis[2]), float(hist[2]), rtol=1e-6)


def test_unknown_selector_raises():
    with pytest.raises(ValueError, match="selector"):
        rk.stc_compress_kernel(torch.zeros(8), torch.zeros(8), 0.5,
                               selector="sort")


# ---------------------------------------------------------------------------
# The cases the fused bisection kernel must get right, against the reference
# in interpret mode: ``lo`` bitwise; the count exact where R1 does not apply
# (lo > 0) and at lo = 0 the normal non-zeros; Σ within rtol 1e-6.
# Subnormal values count as zeros (XLA flushes them).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [0, 32])
@pytest.mark.parametrize("case,k", EDGE_CASES)
def test_topk_threshold_edge_cases_match_reference(case, k, iters):
    x = edge_row(case, np.random.default_rng(k))
    t_r, c_r, s_r = ref_topk(jnp.asarray(x), k, iters=iters, interpret=True)
    t, c, s = rk.topk_threshold(torch.from_numpy(x), k, iters=iters)
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  np.asarray(t_r).view(np.uint32))
    a = np.abs(x)
    normal = a >= FLT_MIN
    if float(t) > 0:                          # R1 does not apply
        assert int(c) == int(c_r)
        assert int(c) >= k or normal.sum() < k
    else:                 # lo = 0: the normal non-zeros (R1: every element)
        assert int(c) == int(normal.sum()) and int(c_r) == x.size
        assert normal.sum() < k or iters == 0
    want = a[normal & (a >= float(t))].astype(np.float64).sum()
    np.testing.assert_allclose(float(s), want, rtol=1e-6)
    np.testing.assert_allclose(float(s), float(s_r), rtol=1e-6)


def test_bisection_of_subnormals_is_the_all_zero_bisection():
    """1,000 values of N(0, 1)·1e-40, k = 10: the reference flushes every
    one, so ``lo`` is 0 and Σ is 0 (its count is 1,000 by R1); the port
    counts no non-zero."""
    x = (np.random.default_rng(5).standard_normal(1000) * 1e-40).astype(
        np.float32)
    t_r, c_r, s_r = ref_topk(jnp.asarray(x), 10, interpret=True)
    t, c, s = rk.topk_threshold(torch.from_numpy(x), 10)
    assert np.asarray(t_r).view(np.uint32) == t.numpy().view(np.uint32) == 0
    assert int(c_r) == 1000 and int(c) == 0
    assert float(s_r) == float(s) == 0.0


@pytest.mark.parametrize("t", [0.0, 1e-40, FLT_MIN, 0.3, -1.0])
def test_threshold_stats_subnormals_count_as_zero(t):
    """Subnormal values of x never count, and a subnormal threshold acts as
    0 (the count then covers the normal non-zeros; the reference counts
    every element there, R1)."""
    x = edge_row("subnormal_mix", np.random.default_rng(9))
    x[:4] = [FLT_MIN, -FLT_MIN, 1e-40, -1e-40]
    cnt_r, sum_r = ref_stats(jnp.asarray(x), jnp.float32(t), interpret=True)
    cnt, total = rk.threshold_stats(torch.from_numpy(x), t)
    a = np.abs(x)
    counted = (a >= FLT_MIN) & (a >= np.float32(t if t >= FLT_MIN else 0.0))
    assert int(cnt) == int(counted.sum())
    if t >= FLT_MIN:
        assert int(cnt) == int(cnt_r)
    else:
        assert int(cnt_r) == x.size
    np.testing.assert_allclose(float(total),
                               a[counted].astype(np.float64).sum(), rtol=1e-6)
    np.testing.assert_allclose(float(total), float(sum_r), rtol=1e-6)


def test_topk_threshold_plain_is_the_cpu_route():
    x = torch.from_numpy(_rand(5000, 3))
    got = rk.topk_threshold(x, 50)
    want = rk.topk_threshold_plain(x, 50)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="iters"):
        rk.topk_threshold(x, 50, iters=-1)
