"""Port parity of the STC kernels' plain versions against the JAX package.

The reference kernels run as its own tests run them on the CPU: Pallas in
interpret mode, with a small ``cap`` where the histogram route is wanted
(the reference skips the histogram when ``k <= cap`` off the TPU).

* histogram: counts exact, sums within rtol 1e-6;
* histogram selection: threshold bitwise, count exact, Σ within rtol 1e-6,
  on rows with at least k non-zeros (per-row k included);
* ``stc_apply``: bitwise given the same ``(t, µ)``, on rows without zeros;
* rows with fewer non-zeros than k: held to the ``"jnp"`` contract only
  (ROADMAP Queue 3, R1).

The wrappers take their plain version only for a CPU tensor: the launch
counters stay at 0 here, and a tensor on any other non-CUDA device raises.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import get_stc_backend as ref_backend
from repro.kernels import (hist_topk_threshold_batched as ref_select,
                           magnitude_histogram_batched as ref_hist,
                           stc_apply_batched as ref_apply)
from repro_torch import kernels as rk
from repro_torch.core.selection import PASSES

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _rows(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _scale(x):
    a_max = np.abs(x).max(axis=1)
    scale = np.zeros_like(a_max)
    np.divide(np.float32(256.0), a_max, out=scale, where=a_max > 0)
    return scale


def _ties(n, seed):
    rng = np.random.default_rng(seed)
    vals = np.where(rng.random(n) < 0.5, 1.0, rng.uniform(0.0, 0.5, n))
    return (vals * np.sign(rng.standard_normal(n))).astype(np.float32)


def _extreme(n, seed):
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.uniform(-30, 30, n)
    return (mags * np.sign(rng.standard_normal(n))).astype(np.float32)


@pytest.mark.parametrize("shape", [(1, 64), (3, 1000), (2, 4096),
                                   (4, 20_011)])
def test_plain_histogram_matches_reference(shape):
    x = _rows(shape, seed=shape[1], scale=1e-2)
    scale = _scale(x)
    cnt_r, sum_r = ref_hist(jnp.asarray(x), jnp.asarray(scale),
                            interpret=True)
    cnt_p, sum_p = rk.magnitude_histogram_batched(torch.from_numpy(x),
                                                  torch.from_numpy(scale))
    np.testing.assert_array_equal(cnt_p.numpy(), np.asarray(cnt_r))
    np.testing.assert_allclose(sum_p.numpy(), np.asarray(sum_r), rtol=1e-6)
    assert int(cnt_p.sum()) == x.size


def test_plain_histogram_extreme_and_zero_rows():
    x = np.stack([_extreme(5000, 1), np.zeros(5000, np.float32),
                  _ties(5000, 2)])
    scale = _scale(x)
    cnt_r, sum_r = ref_hist(jnp.asarray(x), jnp.asarray(scale),
                            interpret=True)
    cnt_p, sum_p = rk.magnitude_histogram_batched(torch.from_numpy(x),
                                                  torch.from_numpy(scale))
    np.testing.assert_array_equal(cnt_p.numpy(), np.asarray(cnt_r))
    np.testing.assert_allclose(sum_p.numpy(), np.asarray(sum_r), rtol=1e-6)
    assert int(cnt_p[1, 0]) == 5000          # scale 0: all in bin 0


def _skewed(n, seed):
    """One outlier; every other magnitude below 1/256 of it (bin 0)."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(n) * 1e-3, -3e-3, 3e-3)
    x[rng.integers(n)] = -1.0
    return x.astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 5001])
def test_plain_histogram_skewed_zero_and_odd_rows(n):
    """The redesigned kernel keeps bins 0 and 1 apart from the others: its
    plain version on a skewed row (everything but one outlier in bin 0), an
    all-zero row and a normal row, at n = 1 and odd n."""
    x = np.stack([_skewed(n, n), np.zeros(n, np.float32),
                  _rows(n, seed=n + 1, scale=1e-2)])
    scale = _scale(x)
    cnt_r, sum_r = ref_hist(jnp.asarray(x), jnp.asarray(scale),
                            interpret=True)
    cnt_p, sum_p = rk.magnitude_histogram_batched(torch.from_numpy(x),
                                                  torch.from_numpy(scale))
    np.testing.assert_array_equal(cnt_p.numpy(), np.asarray(cnt_r))
    np.testing.assert_allclose(sum_p.numpy(), np.asarray(sum_r), rtol=1e-6)
    assert int(cnt_p[0, 255]) == 1 and int(cnt_p[0, 0]) == n - 1
    assert int(cnt_p[1, 0]) == n and float(sum_p[1].abs().sum()) == 0.0


@pytest.mark.parametrize("rows", [1, 10, 64, 200, 65535])
@pytest.mark.parametrize("n", [1, 5001, 307_434, 10_000_019])
def test_histogram_grid_keeps_every_cta_in_its_limit(rows, n):
    """The launch grid: at least one CTA a row, every CTA resident at once
    unless the rows or the per-CTA limit need more, and no CTA with more
    elements (its share of the float4 body plus the scalar head and tail)
    than the kernel's split integer sums allow."""
    from repro_torch.kernels import hist_select
    per_row = hist_select._grid(rows, n, 132)
    assert per_row >= 1
    assert 4 * -(-(n // 4) // per_row) + 6 <= 65535
    forced = max(1, -(-n // hist_select._MAX_CTA_ELEMS))
    assert rows * per_row <= max(132 * hist_select._CTAS_PER_SM,
                                 rows * forced)


def _check_select(x, k, cap):
    t_r, c_r, s_r = ref_select(jnp.asarray(x), k, cap=cap, interpret=True)
    t_p, c_p, s_p = rk.hist_topk_threshold_batched(torch.from_numpy(x), k,
                                                   cap=cap)
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_r))   # bitwise
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-6)


@pytest.mark.parametrize("n,k,cap", [(1000, 1, 64), (4096, 300, 128),
                                     (20_011, 400, 64), (3000, 3000, 128)])
def test_hist_selection_matches_reference(n, k, cap):
    _check_select(_rows((3, n), seed=n + k), k, cap)


@pytest.mark.parametrize("k", [1, 100, 4000])
def test_hist_selection_adversarial_rows(k):
    """Ties at the threshold and extreme dynamic range overflow the
    candidate bin and take the exact sort route, row by row."""
    n = 4000
    x = np.stack([_ties(n, 3), _extreme(n, 4), _rows(n, 5),
                  np.full(n, 0.5, np.float32)])
    _check_select(x, k, 64)


def test_hist_selection_per_row_k():
    x = _rows((4, 5000), seed=9, scale=3.0)
    _check_select(x, np.array([1, 77, 640, 5000]), 128)


def test_histogram_route_always_taken():
    """No small-k shortcut: every selection streams max, histogram, refine
    (the reference would skip the histogram here, k <= cap)."""
    PASSES.reset()
    rk.hist_topk_threshold_batched(torch.from_numpy(_rows((2, 8192), 1)), 81)
    assert PASSES.counts == {"max": 1, "histogram": 1, "refine": 1}


@pytest.mark.parametrize("n", [100, 4096, 30_001])
def test_plain_stc_apply_bitwise(n):
    x = _rows((3, n), seed=n)
    x[x == 0] = 1.0                      # rows without zeros
    a = np.abs(x)
    t = np.sort(a, axis=1)[:, -max(n // 50, 1)].astype(np.float32)
    mu = (a.mean(axis=1) * 1.5).astype(np.float32)
    tern_r, res_r = ref_apply(jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(mu), interpret=True)
    tern_p, res_p = rk.stc_apply_batched(torch.from_numpy(x),
                                         torch.from_numpy(t),
                                         torch.from_numpy(mu))
    np.testing.assert_array_equal(tern_p.numpy().view(np.uint32),
                                  np.asarray(tern_r).view(np.uint32))
    np.testing.assert_array_equal(res_p.numpy().view(np.uint32),
                                  np.asarray(res_r).view(np.uint32))


@pytest.mark.parametrize("nnz", [0, 1, 7, 40])
def test_fewer_nonzeros_than_k_follow_jnp(nnz):
    """R1: v = 0, count = #non-zeros, Σ over them, zeros never selected."""
    rng = np.random.default_rng(nnz)
    n, p = 3000, 1 / 50                                  # k = 60 > nnz
    x = np.zeros((2, n), np.float32)
    for row in range(2):
        x[row, rng.choice(n, nnz, replace=False)] = rng.standard_normal(nnz)
    k = max(int(n * p), 1)
    t_j, c_j, s_j = ref_backend("jnp").select_batch(jnp.asarray(x), k)
    t_p, c_p, s_p = rk.hist_topk_threshold_batched(torch.from_numpy(x), k)
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), rtol=1e-6)
    assert (c_p.numpy() == nnz).all()

    zeros = np.zeros_like(x)
    tern_j, res_j, st_j = ref_backend("jnp").compress_with_residual_batch(
        jnp.asarray(x), jnp.asarray(zeros), p)
    tern_p, res_p, _, _, nnz_p = rk.stc_compress_batch(
        torch.from_numpy(x), torch.from_numpy(zeros), p)
    np.testing.assert_array_equal(np.sign(tern_p.numpy()),
                                  np.sign(np.asarray(tern_j)))
    np.testing.assert_array_equal(nnz_p.numpy(), np.asarray(st_j.nnz))
    np.testing.assert_allclose(res_p.numpy(), np.asarray(res_j), rtol=1e-6,
                               atol=1e-6)


def test_cpu_tensors_never_launch():
    rk.LAUNCHES.reset()
    x = torch.from_numpy(_rows((2, 3000), 0))
    rk.stc_compress_batch(x, torch.zeros_like(x), 0.01)
    rk.pack_bits(torch.ones(100, dtype=torch.uint8))
    assert all(v == 0 for v in rk.LAUNCHES.counts.values())


def test_non_cuda_devices_raise():
    x = torch.zeros((2, 64), device="meta")
    v = torch.zeros(2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rk.stc_apply_batched(x, v, v)
    with pytest.raises(ValueError, match="unsupported device"):
        rk.magnitude_histogram_batched(x, v)
    with pytest.raises(ValueError, match="unsupported device"):
        rk.pack_bits(torch.zeros(64, dtype=torch.uint8, device="meta"))


def test_wrappers_validate_inputs():
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError):
        rk.stc_apply_batched(x, torch.zeros(3), torch.zeros(2))
    with pytest.raises(ValueError):
        rk.magnitude_histogram_batched(x.double(), torch.zeros(2))
    with pytest.raises(ValueError):
        rk.pack_bits(torch.zeros(64, dtype=torch.int32))
    with pytest.raises(ValueError):
        rk.hist_topk_threshold_batched(x, 65)


def test_single_vector_forms_are_row_batches_of_one():
    """A batch of one row (B = 1, the server's launch) gives that row's
    result in a larger batch; ``stc_compress_kernel`` is the B = 1 batch."""
    x = torch.from_numpy(_rows((2, 4000), 21))
    t, c, s = rk.hist_topk_threshold_batched(x[:1], 40)
    tb, cb, sb = rk.hist_topk_threshold_batched(x, 40)
    assert (t[0], c[0], s[0]) == (tb[0], cb[0], sb[0])
    scale = torch.from_numpy(_scale(x.numpy()))
    cnt, sums = rk.magnitude_histogram_batched(x[:1], scale[:1])
    cnt_b, sums_b = rk.magnitude_histogram_batched(x, scale)
    assert torch.equal(cnt[0], cnt_b[0]) and torch.equal(sums[0], sums_b[0])
    tern, res = rk.stc_apply_batched(x[:1], t, s / c)
    tern_b, res_b = rk.stc_apply_batched(x, tb, sb / cb)
    assert torch.equal(tern[0], tern_b[0]) and torch.equal(res[0], res_b[0])
    out = rk.stc_compress_kernel(x[0], torch.zeros(4000), 0.01)
    out_b = rk.stc_compress_batch(x[:1], torch.zeros(1, 4000), 0.01)
    assert all(torch.equal(a, b[0]) for a, b in zip(out, out_b))


def test_pack_chunks_on_the_cpu_never_launches():
    rk.LAUNCHES.reset()
    PASSES.reset()
    words = rk.pack_chunks(torch.tensor([5], dtype=torch.int64),
                           torch.tensor([3], dtype=torch.int32),
                           torch.tensor([30], dtype=torch.int64), 40)
    assert words.numpy().view(np.uint32).tolist() == [0b10, 1 << 31]
    assert rk.LAUNCHES.counts["pack_chunks"] == 0
    assert PASSES.counts == {"pack_chunks": 1}


def test_pack_chunks_validates_inputs():
    v = torch.zeros(4, dtype=torch.int64)
    lens = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        rk.pack_chunks(v.to("meta"), lens.to("meta"), v.to("meta"), 64)
    with pytest.raises(ValueError, match="int64, int32, int64"):
        rk.pack_chunks(v, lens.long(), v, 64)
    with pytest.raises(ValueError, match="one length"):
        rk.pack_chunks(v, lens[:3], v, 64)
    with pytest.raises(ValueError, match="one device"):
        rk.pack_chunks(v, lens, v.to("meta"), 64)
