"""The candidate-bin select and the k-selection around it.

On the CPU the k-selection runs the select's plain version
(``candidate_select_plain``: the top ``cap`` values of the masked row, or a
full sort when the candidate bin holds more than ``cap``).  Here it is held
to the JAX package's ``hist_topk_threshold_batched``, run as its own tests
run it (Pallas in interpret mode, a small ``cap`` so that the histogram
route is taken), on rows built to overflow ``cap``: threshold and count
exact, Σ within rtol 1e-6.  Rows with fewer non-zeros than k (zero rows
among them) are held to the ``"jnp"`` backend instead (ROADMAP Queue 3,
R1).  The select itself is held to a full sort of the row.  The CUDA
kernel is held to the plain version in ``test_torch_cuda_kernels.py``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compression import get_stc_backend as ref_backend
from repro.kernels import hist_topk_threshold_batched as ref_select
from repro_torch import kernels as rk
from repro_torch.core.selection import PASSES, locate_bin
from repro_torch.kernels import hist_select

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CAP = 64


def _carried(rows, n, seed):
    """Like a carried residual row: one outlier a row and every other
    magnitude below 1/256 of it, so about 99 % of the row is in bin 0."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal((rows, n)) * 1e-3, -3e-3, 3e-3)
    x[np.arange(rows), rng.integers(0, n, rows)] = 1.0
    x[:, rng.integers(0, n, n // 100)] *= 200.0        # ~1 % above bin 0
    return x.astype(np.float32)


def _ties(rows, n, seed):
    rng = np.random.default_rng(seed)
    vals = np.where(rng.random((rows, n)) < 0.5, 1.0,
                    rng.uniform(0.0, 0.5, (rows, n)))
    return (vals * np.sign(rng.standard_normal((rows, n)))) \
        .astype(np.float32)


def _normal(rows, n, seed):
    return np.random.default_rng(seed).standard_normal((rows, n)) \
        .astype(np.float32)


def _constant(rows, n, seed):
    """Every element in bin 255: a candidate bin of n elements."""
    return np.full((rows, n), 0.25 * (seed + 1), np.float32)


def _with_zeros(rows, n, seed):
    """Zeros among the bin-0 candidates, and at least k non-zeros."""
    x = _carried(rows, n, seed)
    x[:, np.random.default_rng(seed).random(n) < 0.3] = 0.0
    return x


ROWS = {"carried": _carried, "ties": _ties, "normal": _normal,
        "constant": _constant, "with_zeros": _with_zeros}


def _check_against_reference(x, k):
    t_r, c_r, s_r = ref_select(jnp.asarray(x), k, cap=CAP, interpret=True)
    t_p, c_p, s_p = rk.hist_topk_threshold_batched(torch.from_numpy(x), k,
                                                   cap=CAP)
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_r))   # bitwise
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_r))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), rtol=1e-6)


@pytest.mark.parametrize("kind", sorted(ROWS))
@pytest.mark.parametrize("rows,n,k", [(3, 4000, 100), (1, 5003, 65),
                                      (2, 3001, 1500)])
def test_selection_matches_reference_on_overflowing_bins(kind, rows, n, k):
    x = ROWS[kind](rows, n, seed=n + k)
    _check_against_reference(x, k)


def test_carried_rows_overflow_cap():
    """The carried-like rows do what the test above needs: bin 0 holds
    about 99 % of the row, far more than ``cap``."""
    x = torch.from_numpy(_carried(3, 4000, 1))
    a_max = x.abs().amax(dim=1)
    cnt, _ = rk.magnitude_histogram_batched(x, 256.0 / a_max)
    assert (cnt[:, 0] > 0.97 * 4000).all() and (cnt[:, 0] > CAP).all()


def test_selection_per_row_k_matches_reference():
    x = np.concatenate([_carried(2, 5000, 3), _ties(2, 5000, 4)])
    _check_against_reference(x, np.array([65, 4999, 300, 2500]))


@pytest.mark.parametrize("nnz", [0, 5, 40])
@pytest.mark.parametrize("rows", [1, 3])
def test_fewer_nonzeros_than_k_match_jnp(nnz, rows):
    """R1 rows, zero rows among them: v = 0, count = #non-zeros, Σ over
    them, as the reference's ``"jnp"`` backend gives."""
    rng = np.random.default_rng(nnz + rows)
    n, k = 3000, 100
    x = np.zeros((rows, n), np.float32)
    for row in range(rows):
        x[row, rng.choice(n, nnz, replace=False)] = rng.standard_normal(nnz)
    t_j, c_j, s_j = ref_backend("jnp").select_batch(jnp.asarray(x), k)
    t_p, c_p, s_p = rk.hist_topk_threshold_batched(torch.from_numpy(x), k,
                                                   cap=CAP)
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(c_p.numpy(), np.asarray(c_j))
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), rtol=1e-6)
    assert (c_p.numpy() == nnz).all() and (t_p.numpy() == 0).all()


def _select_inputs(x, k):
    """``(scale, b, r, cnt_b)`` as the k-selection hands them to the
    select."""
    rows, n = x.shape
    kj = hist_select._row_ks(k, rows, n, "cpu")
    a_max = x.abs().amax(dim=1)
    scale = torch.where(a_max > 0, 256.0 / a_max, torch.zeros_like(a_max))
    cnt, sums = rk.magnitude_histogram_batched(x, scale)
    b, cnt_gt, _, cnt_b = locate_bin(cnt, sums, kj, 256)
    return scale, b, kj - cnt_gt.to(torch.int64), cnt_b


@pytest.mark.parametrize("kind", sorted(ROWS))
@pytest.mark.parametrize("cap", [1, CAP, 8192])
def test_select_matches_full_sort_inside_the_bin(kind, cap):
    """The plain select on both of its routes (top-``cap`` and sort): ``v``
    the r-th largest of the bin, count and Σ of the bin's elements at or
    above it and non-zero, against a sort of the bin's elements."""
    x = torch.from_numpy(ROWS[kind](3, 2001, seed=cap))
    scale, b, r, cnt_b = _select_inputs(x, 150)
    v, cnt, total = rk.candidate_select_batched(x, scale, b, r, cap=cap)
    a = x.abs()
    for row in range(3):
        in_bin = (a[row] * scale[row]).to(torch.int32).clamp(0, 255) \
            == b[row]
        cand = torch.sort(a[row][in_bin], descending=True).values
        assert cand.numel() == int(cnt_b[row])
        want = cand[int(r[row]) - 1]
        sel = cand[(cand >= want) & (cand > 0)]
        assert v[row].item() == want.item()
        assert int(cnt[row]) == sel.numel()
        np.testing.assert_allclose(float(total[row]),
                                   float(sel.double().sum()), rtol=1e-6)


@pytest.mark.parametrize("n,k", [(1, 1), (7, 3), (4096, 1), (4096, 4096)])
def test_candidate_bins_of_one_and_of_n(n, k):
    """k = 1 on a normal row: the max alone in bin 255; a constant row:
    the whole row in one bin; and the smallest rows."""
    for x in (_normal(2, n, n), _constant(2, n, n)):
        scale, b, r, cnt_b = _select_inputs(torch.from_numpy(x), k)
        if k == 1:
            assert (b == 255).all()
        v, cnt, _ = rk.candidate_select_batched(torch.from_numpy(x), scale,
                                                b, r, cap=2)
        srt = np.sort(np.abs(x), axis=1)[:, ::-1]
        np.testing.assert_array_equal(v.numpy(), srt[:, k - 1])
    assert int(cnt_b.min()) == n                   # the constant rows


def test_select_records_one_refine_pass_and_never_launches():
    x = torch.from_numpy(_carried(2, 3000, 5))
    rk.LAUNCHES.reset()
    PASSES.reset()
    rk.hist_topk_threshold_batched(x, 70)
    assert PASSES.counts == {"max": 1, "histogram": 1, "refine": 1}
    assert all(v == 0 for v in rk.LAUNCHES.counts.values())


def test_select_validates_inputs():
    x = torch.zeros((2, 64))
    s = torch.ones(2)
    i = torch.zeros(2, dtype=torch.int64)
    for bad in ((x.double(), s, i, i), (x, s.double(), i, i),
                (x, s, i.int(), i), (x, s, i, i[:1]), (x[0], s, i, i)):
        with pytest.raises(ValueError):
            rk.candidate_select_batched(*bad)
    m = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rk.candidate_select_batched(x.to(m), s.to(m), i.to(m), i.to(m))


@pytest.mark.parametrize("k,want", [(5, [5, 5, 5]), (np.int64(7), [7] * 3),
                                    ([1, 2, 64], [1, 2, 64]),
                                    (np.array([3, 3, 3]), [3, 3, 3]),
                                    (torch.tensor([4, 5, 6]), [4, 5, 6])])
def test_row_ks_forms(k, want):
    ks = hist_select._row_ks(k, 3, 64, "cpu")
    assert ks.dtype == torch.int64 and ks.tolist() == want


@pytest.mark.parametrize("k", [0, 65, [1, 2], [1, 2, 65]])
def test_row_ks_out_of_range_raise(k):
    with pytest.raises(ValueError):
        hist_select._row_ks(k, 3, 64, "cpu")


# -- the select kernel's route, chosen on the host from the shape alone ------

def _cu_constant(name):
    """A ``constexpr int`` or a ``static_assert`` size of bin_select.cu."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "bin_select.cu").read_text()
    if name == "sizeof(RowScratch)":
        return int(re.search(r"sizeof\(RowScratch\) == (\d+)", src).group(1))
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_select_plan_constants_match_the_kernel():
    """The host's cluster slice and row scratch are the kernel's."""
    assert hist_select._CLUSTER_KEYS == _cu_constant("CLUSTER_KEYS")
    assert hist_select._MAX_CLUSTER == _cu_constant("MAX_CLUSTER")
    assert hist_select._ROW_SCRATCH_BYTES == _cu_constant("sizeof(RowScratch)")


LONGEST = hist_select._MAX_CLUSTER * hist_select._CLUSTER_KEYS


@pytest.mark.parametrize("rows,n,route,cluster", [
    (10, 307_434, "cluster", 8),            # the cnn's clients, main path
    (1, 307_434, "cluster", 8),             # the cnn's server
    (790, 4096, "cluster", 1),              # chunked clients
    (79, 4096, "cluster", 1),               # chunked server
    (1, 4_000_037, "two_read", 0),          # the overflow witness
    (1, 134_515_008, "two_read", 0),        # mesh (SmolLM-135M)
    (1, 63_713_088, "two_read", 0),         # mesh (SmolLM-135M, 10 layers)
    (1, 368_227_840, "two_read", 0),        # ssm (Mamba-2-370M, 48 l.)
    (1, 209_857_792, "two_read", 0),        # ssm (Mamba-2-370M, 24 l.)
    (1, 810_987_520, "two_read", 0),        # enc (whisper-medium, 24 + 24)
    (1, 458_604_544, "two_read", 0),        # enc (whisper-medium, 12 + 12)
    (1, 1_394_772_480, "two_read", 0),      # hybrid (RecurrentGemma, 12 l.)
    (1, 1_025_067_520, "two_read", 0),      # hybrid (RecurrentGemma, 6 l.)
    (1, 1_641_666_560, "two_read", 0),      # vlm (internvl2-2b, 20 layers)
    (1, 1_138_317_312, "two_read", 0),      # vlm (internvl2-2b, 12 layers)
    (1, 1_670_133_760, "two_read", 0),      # moe (DeepSeek-V2-Lite, 3 l.)
])
def test_select_plan_of_each_chip_smoke_shape(rows, n, route, cluster):
    plan = hist_select.select_plan(rows, n, 132)
    assert plan.route == route and plan.cluster == cluster
    if route == "cluster":
        assert plan.ctas_per_row == cluster and plan.capacity == 0
        assert -(-n // cluster) <= hist_select._CLUSTER_KEYS
        assert cluster == 1 or -(-n // (cluster // 2)) \
            > hist_select._CLUSTER_KEYS    # the smallest that holds the row
    else:
        assert plan.ctas_per_row == max(1, min(-(-n // 8192), 132 // rows))
        share = hist_select._BUFFER_SHARE
        assert plan.capacity % 4 == 0
        assert n / share <= plan.capacity < n / share + 4
        assert plan == hist_select.two_read_plan(rows, n, 132)


@pytest.mark.parametrize("n,cluster", [
    (1, 1), (hist_select._CLUSTER_KEYS, 1),
    (hist_select._CLUSTER_KEYS + 1, 2), (2 * hist_select._CLUSTER_KEYS, 2),
    (2 * hist_select._CLUSTER_KEYS + 1, 4),
    (4 * hist_select._CLUSTER_KEYS + 1, 8),
    (8 * hist_select._CLUSTER_KEYS + 1, 16), (LONGEST, 16)])
def test_select_plan_cluster_sizes(n, cluster):
    """Each cluster size, up to the longest row the cluster route takes."""
    for rows in (1, 10, 65_535):
        plan = hist_select.select_plan(rows, n, 132)
        assert (plan.route, plan.cluster) == ("cluster", cluster)


def test_select_plan_first_two_read_row():
    plan = hist_select.select_plan(1, LONGEST + 1, 132)
    assert plan.route == "two_read"
    assert plan.capacity >= (LONGEST + 1) / hist_select._BUFFER_SHARE


def test_select_plan_reads_only_the_shape():
    """The plan is a function of three integers (no tensor is read, so the
    card's selection needs no host sync for it), the same on every call."""
    a = hist_select.select_plan(3, 5_000_000, 132)
    assert a == hist_select.select_plan(3, 5_000_000, 132)
    assert all(isinstance(v, int) for v in a[1:])
    assert a.ctas_per_row == 44 and a.capacity == 156_252   # n / 32, 4 | it


def test_select_scratch_grows_on_demand_and_is_zeroed():
    """The select's scratch: a per-row count of x's elements read (both
    routes); for the two-read route zeroed row records of the kernel's size
    and a candidate buffer; kept per device and stream and grown only when
    a call needs more."""
    key = (None, 12345)
    dev = torch.device("cpu")
    hist_select._SELECT_SCRATCH.pop(key, None)
    try:
        s = hist_select._select_scratch(dev, 12345, 2, 100)
        words = hist_select._ROW_SCRATCH_BYTES // 8
        assert s["rows"].numel() == 2 * words and not bool(s["rows"].any())
        assert s["buf"].numel() == 200
        assert s["reads"].numel() == 2 and s["reads"].dtype == torch.int64
        again = hist_select._select_scratch(dev, 12345, 1, 50)
        assert again["rows"] is s["rows"] and again["buf"] is s["buf"]
        assert again["reads"] is s["reads"]
        grown = hist_select._select_scratch(dev, 12345, 3, 100)
        assert grown["rows"].numel() == 3 * words
        assert grown["buf"].numel() == 300 and grown["reads"].numel() == 3
    finally:
        hist_select._SELECT_SCRATCH.pop(key, None)


def test_select_scratch_of_the_cluster_route_is_the_read_count_alone():
    """The cluster route (``capacity`` 0) needs no row records and no
    buffer: only the count of x's elements read, grown on demand."""
    key = (None, 54321)
    dev = torch.device("cpu")
    hist_select._SELECT_SCRATCH.pop(key, None)
    try:
        s = hist_select._select_scratch(dev, 54321, 790, 0)
        assert set(s) == {"reads"} and s["reads"].numel() == 790
        assert hist_select._select_scratch(dev, 54321, 10, 0)["reads"] \
            is s["reads"]
    finally:
        hist_select._SELECT_SCRATCH.pop(key, None)
