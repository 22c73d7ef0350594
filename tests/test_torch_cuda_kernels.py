"""The CUDA kernels against their plain versions on the card.

Marked ``cuda``: they need a card and ``nvcc`` and skip without them (the
CPU tests hold the plain versions to the JAX package).  On a machine with
a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

import _bisect_cases as bisect_cases
import _golomb_cases as golomb_cases
from repro_torch import kernels as rk
from repro_torch.core import wire

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rows(dev, shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("shape", [(1, 1), (3, 1000), (10, 307_434)])
def test_stc_apply_bitwise(dev, shape):
    x = _rows(dev, shape, 0)
    t = x.abs().quantile(0.98, dim=1)
    mu = x.abs().mean(dim=1)
    before = rk.LAUNCHES.counts["stc_apply"]
    got = rk.stc_apply_batched(x, t, mu)
    want = rk.stc_apply_plain(x, t, mu)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["stc_apply"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", [(2, 5000), (10, 307_434)])
def test_histogram(dev, shape):
    x = _rows(dev, shape, 1)
    scale = 256.0 / x.abs().amax(dim=1)
    cnt, sums = rk.magnitude_histogram_batched(x, scale)
    cnt_p, sums_p = rk.magnitude_histogram_plain(x, scale)
    assert torch.equal(cnt, cnt_p)
    assert torch.allclose(sums, sums_p, rtol=1e-6, atol=0.0)


def _hist_rows(dev, rows, n, seed):
    """Row 0 skewed (one outlier, the rest in bin 0), row 1 all zero, the
    rest normal; with the scale the k-selection gives them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, n)) * 1e-3).astype(np.float32)
    x[0] = np.clip(x[0], -3e-3, 3e-3)
    x[0, rng.integers(n)] = 1.0
    if rows > 1:
        x[1] = 0.0
    x = torch.from_numpy(x).to(dev)
    a_max = x.abs().amax(dim=1)
    return x, torch.where(a_max > 0, 256.0 / a_max, torch.zeros_like(a_max))


@pytest.mark.parametrize("rows", [1, 10, 64])
@pytest.mark.parametrize("n", [1, 5001, 307_434])
def test_histogram_skewed_zero_rows_one_launch_deterministic(dev, rows, n):
    x, scale = _hist_rows(dev, rows, n, rows * n)
    before = rk.LAUNCHES.counts["histogram"]
    cnt, sums = rk.magnitude_histogram_batched(x, scale)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["histogram"] == before + 1
    cnt_p, sums_p = rk.magnitude_histogram_plain(x, scale)
    assert torch.equal(cnt, cnt_p)
    assert torch.allclose(sums, sums_p, rtol=1e-6, atol=0.0)
    again = rk.magnitude_histogram_batched(x, scale)
    assert torch.equal(cnt, again[0]) and torch.equal(sums, again[1])
    assert int(cnt[0, 0]) == n - 1 and int(cnt[0, 255]) == 1


def _chunks(rng, count, gaps=False):
    lens = rng.integers(1, 64, count)
    lens[rng.random(count) < 0.2] = 32
    offs = np.cumsum(lens) - lens
    if gaps:
        for cut in sorted(rng.choice(np.arange(1, count), 8, replace=False)):
            offs[cut:] += (-int(offs[cut]) % 32) + 32 * int(rng.integers(3))
    vals = rng.integers(0, 1 << 63, count, dtype=np.uint64)
    vals &= (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    vals[lens == 32] = np.uint64(0xFFFFFFFF)
    return vals, lens, offs, int(offs[-1] + lens[-1]) + 17


def _pack_on_card(dev, vals, lens, offs, total_bits):
    t = (torch.from_numpy(vals.view(np.int64)).to(dev),
         torch.from_numpy(lens.astype(np.int32)).to(dev),
         torch.from_numpy(offs.astype(np.int64)).to(dev))
    before = rk.LAUNCHES.counts["pack_chunks"]
    words = rk.pack_chunks(*t, total_bits)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["pack_chunks"] == before + 1
    assert torch.equal(words, rk.pack_chunks_plain(*t, total_bits))
    return words.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("count,gaps", [(1, False), (5000, False),
                                        (61_480, True)])
def test_pack_chunks(dev, count, gaps):
    vals, lens, offs, total_bits = _chunks(np.random.default_rng(count),
                                           count, gaps)
    got = _pack_on_card(dev, vals, lens, offs, total_bits)
    np.testing.assert_array_equal(
        got, wire._scatter_chunks_numpy(vals, lens, offs, total_bits))


def _round_messages(density, rows=10, n=307_434, seed=5):
    rng = np.random.default_rng(seed)
    x = np.zeros((rows, n), np.float32)
    m = rng.random((rows, n)) < density
    x[m] = np.where(rng.random(int(m.sum())) < 0.5, 2e-3, -2e-3)
    return x


def test_pack_chunks_real_round_upstream_batch(dev):
    """A cnn round's upstream batch (10 clients at p = 1/50), its chunks
    built as the per-client regime builds them."""
    x = _round_messages(1 / 50)
    per_client = [np.flatnonzero(r) for r in x]
    vals, lens, offs, batch = wire._client_chunks_batch(
        x, per_client, wire._b_star_checked(1 / 50))
    total_bits = 32 * int(batch.word_count.sum())
    got = _pack_on_card(dev, vals, lens, offs, total_bits)
    np.testing.assert_array_equal(
        got, wire._scatter_chunks_numpy(vals, lens, offs, total_bits))


@pytest.mark.parametrize("density", [0.001, 1 / 50])    # fused, per client
def test_encode_batch_kernel_backend_on_card(dev, density):
    x = _round_messages(density)
    before = rk.LAUNCHES.counts["pack_chunks"]
    got = wire.encode_ternary_words_batch(x, 1 / 50, backend="kernel",
                                          device=dev)
    assert rk.LAUNCHES.counts["pack_chunks"] == before + 1
    want = wire.encode_ternary_words_batch(x, 1 / 50)
    for field in ("words", "word_start", "word_count", "bit_len", "mu",
                  "nnz"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


@pytest.mark.parametrize("k", [1, 6148, 307_434])
def test_selection_matches_cpu_route(dev, k):
    x = _rows(dev, (3, 307_434), 2)
    t, c, s = rk.hist_topk_threshold_batched(x, k)
    t_c, c_c, s_c = rk.hist_topk_threshold_batched(x.cpu(), k)
    assert torch.equal(t.cpu(), t_c) and torch.equal(c.cpu(), c_c)
    assert torch.allclose(s.cpu(), s_c, rtol=1e-6, atol=0.0)


def _select_rows(kind, rows, n, seed):
    """Rows for the candidate-bin select: ``carried`` (one outlier, ~1 %
    of the row above bin 0, the rest in bin 0), ``ties`` across the
    threshold, ``sparse`` (zero rows and rows with fewer non-zeros than
    k), ``constant`` (the whole row in one bin) and ``normal``."""
    rng = np.random.default_rng(seed)
    if kind == "carried":
        x = np.clip(rng.standard_normal((rows, n)) * 1e-3, -3e-3, 3e-3)
        x[:, rng.integers(0, n, n // 100)] *= 200.0
        x[np.arange(rows), rng.integers(0, n, rows)] = 1.0
    elif kind == "ties":
        x = np.where(rng.random((rows, n)) < 0.5, 1.0,
                     rng.uniform(0, 0.5, (rows, n)))
        x *= np.sign(rng.standard_normal((rows, n)))
    elif kind == "sparse":
        x = np.zeros((rows, n))
        for row in range(1, rows):
            x[row, rng.choice(n, 19 * row, replace=False)] = 0.37
    elif kind == "constant":
        x = np.full((rows, n), 0.25)
    else:
        x = rng.standard_normal((rows, n))
    return x.astype(np.float32)


def _select_inputs(x, k):
    """``(scale, b, r)`` on the card as the k-selection makes them."""
    from repro_torch.core.selection import locate_bin
    from repro_torch.kernels import hist_select
    rows, n = x.shape
    kj = hist_select._row_ks(k, rows, n, x.device)
    a_max = x.abs().amax(dim=1)
    scale = torch.where(a_max >= bisect_cases.FLT_MIN, 256.0 / a_max,
                        torch.zeros_like(a_max))
    cnt, sums = rk.magnitude_histogram_batched(x, scale)
    b, cnt_gt, _, _ = locate_bin(cnt, sums, kj, 256)
    return scale, b, kj - cnt_gt.to(torch.int64)


@pytest.mark.parametrize("kind", ["carried", "ties", "sparse", "constant",
                                  "normal"])
@pytest.mark.parametrize("rows,k", [(1, 6148), (10, 6148), (10, 1),
                                    (4, np.array([1, 400, 6148, 300_000]))])
def test_bin_select_matches_plain_and_is_deterministic(dev, kind, rows, k):
    """The select kernel against its plain version (``v`` and ``cnt_in``
    bitwise, ``sum_in`` within rtol 1e-6), one launch a call, and two calls
    with identical bits."""
    x = torch.from_numpy(_select_rows(kind, rows, 307_434, rows)).to(dev)
    scale, b, r = _select_inputs(x, k)
    before = rk.LAUNCHES.counts["bin_select"]
    got = rk.candidate_select_batched(x, scale, b, r)
    again = rk.candidate_select_batched(x, scale, b, r)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["bin_select"] == before + 2
    want = rk.candidate_select_plain(x, scale, b, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("rows", [1, 10])
def test_stc_compress_batch_does_not_synchronize(dev, rows):
    """The card's STC step, selection included, runs under
    ``set_sync_debug_mode("error")`` (after a first call has built the
    kernels and the scratch), and its selection calls no sort or top-k."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.from_numpy(_select_rows("carried", rows, 307_434, 7)).to(dev)
    res = torch.zeros_like(x)
    rk.stc_compress_batch(x, res, 1 / 50)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rk.stc_compress_batch(x, res, 1 / 50)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out[4].min()) >= 6148
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rk.hist_topk_threshold_batched(x, 6148)
        torch.cuda.synchronize()
    ops = {e.name for e in prof.events()}
    assert not ops & {"aten::topk", "aten::sort", "aten::kthvalue"}, ops


@pytest.mark.parametrize("m", [1, 33, 49_838, 1_000_003])
def test_pack_bits(dev, m):
    bits = (torch.rand(m, device=dev) < 0.3).to(torch.uint8)
    assert torch.equal(rk.pack_bits(bits), rk.pack_bits_plain(bits))


@pytest.mark.parametrize("n_words", [1, 2, 9608, 15_640, 1_000_003])
def test_unpack_bits(dev, n_words):
    w = np.random.default_rng(n_words).integers(
        0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32)
    w[:4] = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)[:n_words]
    words = torch.from_numpy(w.view(np.int32)).to(dev)
    before = rk.LAUNCHES.counts["unpack_bits"]
    bits, zeros = rk.unpack_words_with_counts(words)
    bits_p, zeros_p = rk.unpack_words_plain(words)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["unpack_bits"] == before + 1
    assert torch.equal(bits, bits_p) and torch.equal(zeros, zeros_p)
    assert torch.equal(rk.unpack_bits_words(words), bits_p)
    assert rk.LAUNCHES.counts["unpack_bits"] == before + 2


# -------------------------------------------- signSGD's sign planes

_SIGN_EDGE = np.array([2e-4, -2e-4, 0.0, -0.0, 1e-40, -1e-40, 1.4e-45,
                       -1.4e-45, np.inf, -np.inf, np.nan, 1.1754944e-38,
                       3.4e38], np.float32)


def _sign_rows(rows, n, seed):
    """signSGD-like rows (±2e-4, 0) with every edge value of the sign test
    among them, a NaN with its sign bit last."""
    rng = np.random.default_rng(seed)
    x = (np.sign(rng.standard_normal((rows, n))) * 2e-4).astype(np.float32)
    pick = rng.random((rows, n)) < 0.05
    x[pick] = rng.choice(_SIGN_EDGE, int(pick.sum()))
    flat = x.reshape(-1)
    flat[:min(_SIGN_EDGE.size, flat.size)] = _SIGN_EDGE[:flat.size]
    flat[-1] = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    return x


def _host_sign_words(x):
    return np.stack([wire._pack_bits_numpy((r > 0).astype(np.uint8))
                     for r in x])


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 31), (3, 33), (10, 1000),
                                    (1, 307_434), (10, 307_434)])
def test_pack_sign_planes_bitwise(dev, rows, n):
    x_np = _sign_rows(rows, n, rows * n)
    x = torch.from_numpy(x_np).to(dev)
    before = rk.LAUNCHES.counts["pack_sign_planes"]
    got = rk.pack_sign_planes(x)
    again = rk.pack_sign_planes(x)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["pack_sign_planes"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), rk.pack_sign_planes_plain(x.cpu()))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  _host_sign_words(x_np))


@pytest.mark.parametrize("rows,m", [(3, 1), (3, 33), (10, 1000),
                                    (4, 4096), (10, 307_434)])
def test_pack_bits_batched(dev, rows, m):
    """Rows start off 16-byte boundaries unless 16 divides m; bytes other
    than 0 and 1 pack as 1."""
    rng = np.random.default_rng(m)
    bits_np = ((rng.random((rows, m)) < 0.3)
               * rng.integers(1, 256, (rows, m))).astype(np.uint8)
    bits = torch.from_numpy(bits_np).to(dev)
    before = rk.LAUNCHES.counts["pack_bits"]
    got = rk.pack_bits_batched(bits)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["pack_bits"] == before + 1
    assert torch.equal(got, rk.pack_bits_batched_plain(bits))
    assert torch.equal(got, rk.pack_bits_batched(bits))
    for i in (0, rows - 1):
        assert torch.equal(got[i], rk.pack_bits(bits[i].contiguous()))


@pytest.mark.parametrize("rows,n_words", [(3, 1), (10, 9608)])
def test_unpack_words_batched(dev, rows, n_words):
    w = np.random.default_rng(n_words).integers(
        0, 1 << 32, (rows, n_words), dtype=np.uint64).astype(np.uint32)
    words = torch.from_numpy(w.view(np.int32)).to(dev)
    before = rk.LAUNCHES.counts["unpack_bits"]
    bits, zeros = rk.unpack_words_batched(words)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["unpack_bits"] == before + 1
    bits_p, zeros_p = rk.unpack_words_plain(words)
    assert torch.equal(bits, bits_p) and torch.equal(zeros, zeros_p)
    assert torch.equal(bits[rows - 1],
                       rk.unpack_bits_words(words[rows - 1].contiguous()))


@pytest.mark.parametrize("rows,n", [(1, 1), (3, 33), (10, 1000),
                                    (10, 307_434), (64, 307_434)])
def test_sign_plane_tally_bitwise(dev, rows, n):
    """Onto a sum that holds values: bitwise the plain version on the CPU
    and the host accumulator's ``add_sign_plane`` loop; one launch."""
    from repro_torch.core.ingest import IngestAccumulator
    rng = np.random.default_rng(rows * n)
    n_words = -(-n // 32)
    w_np = rng.integers(0, 1 << 32, (rows, n_words),
                        dtype=np.uint64).astype(np.uint32)
    weights = rng.uniform(0, 2, rows)
    weights[0] = 1 / 3
    start = rng.standard_normal(n) * 1e-4
    acc = IngestAccumulator(n)
    acc.sum[:] = start
    for i in range(rows):
        acc.add_sign_plane(wire.words_to_bits(w_np[i], n), 2e-4,
                           float(weights[i]))
    words = torch.from_numpy(w_np.view(np.int32))
    w64 = torch.from_numpy(weights)
    total = torch.from_numpy(start.copy()).to(dev)
    before = rk.LAUNCHES.counts["sign_plane_tally"]
    rk.sign_plane_tally(words.to(dev), 2e-4, w64.to(dev), total)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["sign_plane_tally"] == before + 1
    got = total.cpu().numpy().view(np.uint64)
    plain = rk.sign_plane_tally(words, 2e-4, w64,
                                torch.from_numpy(start.copy()))
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint64))
    np.testing.assert_array_equal(got, acc.sum.view(np.uint64))


def test_signsgd_codec_packs_and_tallies_a_round_in_one_launch_each(dev):
    """The codec's ``"kernel"`` wire on card messages: one
    ``pack_sign_planes`` for the batch, one ``sign_plane_tally`` for the
    ingest, no per-plane ``pack_bits``/``unpack_bits``; the batch and the
    accumulator equal the CPU's and the host backend's."""
    from repro_torch.core import make_protocol
    port = make_protocol("signsgd", wire_backend="kernel")
    host = make_protocol("signsgd")
    msgs_np = _sign_rows(10, 307_434, 7)
    msgs = torch.from_numpy(msgs_np).to(dev)
    w = np.linspace(0.1, 1.0, 10)
    before = dict(rk.LAUNCHES.counts)
    batch = port.encode_wire_batch(msgs)
    acc = port.make_ingest(307_434)
    acc.sum[:] = 0.125
    port.ingest_wire_batch(acc, batch, w, device=dev)
    torch.cuda.synchronize()
    after = rk.LAUNCHES.counts
    assert after["pack_sign_planes"] == before["pack_sign_planes"] + 1
    assert after["sign_plane_tally"] == before["sign_plane_tally"] + 1
    assert after["pack_bits"] == before["pack_bits"]
    assert after["unpack_bits"] == before["unpack_bits"]
    batch_h = host.encode_wire_batch(msgs_np)
    for field in ("words", "word_start", "word_count", "bit_len", "mu",
                  "nnz"):
        np.testing.assert_array_equal(getattr(batch, field),
                                      getattr(batch_h, field))
    acc_h = host.make_ingest(307_434)
    acc_h.sum[:] = 0.125
    host.ingest_wire_batch(acc_h, batch_h, w)
    np.testing.assert_array_equal(acc.sum.view(np.uint64),
                                  acc_h.sum.view(np.uint64))
    assert (acc.nnz, acc.n_msgs, acc.weight_mass, acc.stream_bits) == \
        (acc_h.nnz, acc_h.n_msgs, acc_h.weight_mass, acc_h.stream_bits)


@pytest.mark.parametrize("q", [0.0, 0.5, 0.98, 2.0])
def test_threshold_stats(dev, q):
    x = _rows(dev, (307_434,), 3)
    x[::7] = 0.0                                 # zeros: counted never
    t = (x.abs().quantile(q) if q <= 1 else x.abs().max() * q)
    t = t.reshape(()) if q > 0 else torch.zeros((), device=dev)
    before = rk.LAUNCHES.counts["threshold_stats"]
    cnt, total = rk.threshold_stats(x, t)
    cnt_p, total_p = rk.threshold_stats_plain(x, t)
    again = rk.threshold_stats(x, t)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["threshold_stats"] == before + 2
    assert int(cnt) == int(cnt_p)
    assert torch.allclose(total, total_p, rtol=1e-6, atol=0.0)
    assert torch.equal(cnt, again[0]) and torch.equal(total, again[1])


@pytest.mark.parametrize("p", [0.001, 0.02, 0.1])
def test_bisection_matches_cpu(dev, p):
    x = _rows(dev, (307_434,), 4)
    k = max(int(x.numel() * p), 1)
    before = dict(rk.LAUNCHES.counts)
    t, c, s = rk.topk_threshold(x, k)
    t_c, c_c, s_c = rk.topk_threshold(x.cpu(), k)
    assert rk.LAUNCHES.counts["bisect_select"] == before["bisect_select"] + 1
    assert rk.LAUNCHES.counts["threshold_stats"] == before["threshold_stats"]
    assert torch.equal(t.cpu(), t_c) and int(c) == int(c_c) == k
    assert torch.allclose(s.cpu(), s_c, rtol=1e-6, atol=0.0)


def _bisect_vs_plain(x, k, iters=32):
    """The fused bisection on the card against its plain version on the
    CPU: ``lo`` and the count bitwise, Σ within rtol 1e-6, one launch a
    call, and a second call with identical bits."""
    before = rk.LAUNCHES.counts["bisect_select"]
    got = rk.topk_threshold(x, k, iters=iters)
    again = rk.topk_threshold(x, k, iters=iters)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["bisect_select"] == before + 2
    want = rk.topk_threshold_plain(x.cpu(), k, iters)
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.allclose(got[2].cpu(), want[2], rtol=1e-6, atol=0.0)
    assert all(torch.equal(g.view(torch.int32), a.view(torch.int32))
               for g, a in zip(got, again))
    return got


@pytest.mark.parametrize("iters", [0, 32])
@pytest.mark.parametrize("case,k", bisect_cases.EDGE_CASES)
def test_bisect_select_edge_cases(dev, iters, case, k):
    x = bisect_cases.edge_row(case, np.random.default_rng(k))
    _bisect_vs_plain(torch.from_numpy(x).to(dev), k, iters)


@pytest.mark.parametrize("n,k", [(4_000_037, 4000), (4_000_037, 3_600_000),
                                 (4_000_037, 3_999_000), (917_505, 18_350)])
def test_bisect_select_beyond_shared_memory(dev, n, k):
    """Vectors larger than the cluster's shared memory holds (16 x 57,344
    elements): the rest is read again from global memory in every round,
    inside the one launch.  With fewer non-zeros than k (3,636,397 here)
    ``lo`` stays 0 and the count covers the non-zeros (R1)."""
    x = _rows(dev, (n,), n % 97)
    x[::11] = 0.0
    nnz = int((x != 0).sum())
    lo, c, _ = _bisect_vs_plain(x, k)
    if k <= nnz:
        assert int(c) == k
    else:
        assert float(lo) == 0.0 and int(c) == nnz


def test_bisection_does_not_synchronize(dev):
    x = _rows(dev, (307_434,), 6)
    rk.topk_threshold(x, 6148)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rk.stc_compress_kernel(x, torch.zeros_like(x), 1 / 50,
                                     selector="bisect")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(out[4]) == 6148


def _subnormal_rows(dev, rows, n, seed):
    """N(0, 1)·1e-40 subnormals with ~1 % N(0, 1) values and some values
    near FLT_MIN; the last row all subnormal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)) * 1e-40
    x[:, rng.integers(0, n, n // 100)] = rng.standard_normal(n // 100)
    x[:, rng.integers(0, n, n // 100)] = rng.uniform(-4, 4, n // 100) \
        * bisect_cases.FLT_MIN
    x[-1] = rng.standard_normal(n) * 1e-40
    return torch.from_numpy(x.astype(np.float32)).to(dev)


def test_kernels_flush_subnormal_rows_as_their_plain_versions(dev):
    """Subnormals count as zeros in every kernel of the k-selection and
    the apply, as in their plain versions (and the reference)."""
    x = _subnormal_rows(dev, 3, 307_434, 8)
    k = 6148
    t, c, s = rk.hist_topk_threshold_batched(x, k)
    t_c, c_c, s_c = rk.hist_topk_threshold_batched(x.cpu(), k)
    assert torch.equal(t.cpu(), t_c) and torch.equal(c.cpu(), c_c)
    assert torch.allclose(s.cpu(), s_c, rtol=1e-6, atol=0.0)
    assert int(c[-1]) == 0 and float(t[-1]) == 0.0
    scale, b, r = _select_inputs(x, k)
    cnt, sums = rk.magnitude_histogram_batched(x, scale)
    cnt_p, sums_p = rk.magnitude_histogram_plain(x, scale)
    assert torch.equal(cnt, cnt_p)
    assert torch.allclose(sums, sums_p, rtol=1e-6, atol=0.0)
    got = rk.candidate_select_batched(x, scale, b, r)
    want = rk.candidate_select_plain(x, scale, b, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0)
    mu = s / torch.clamp(c, min=1).to(torch.float32)
    tern, res = rk.stc_apply_batched(x, t, mu)
    tern_p, res_p = rk.stc_apply_plain(x, t, mu)
    assert torch.equal(tern.view(torch.int32), tern_p.view(torch.int32))
    assert torch.equal(res.view(torch.int32), res_p.view(torch.int32))
    a = res.abs()
    assert not bool(((a > 0) & (a < bisect_cases.FLT_MIN)).any())
    for q in (0.0, 1e-40, 0.5):
        cnt1, tot1 = rk.threshold_stats(x[0], q)
        cnt1_p, tot1_p = rk.threshold_stats_plain(x[0].cpu(),
                                                 torch.tensor(q))
        assert int(cnt1) == int(cnt1_p)
        assert torch.allclose(tot1.cpu(), tot1_p, rtol=1e-6, atol=0.0)
    _bisect_vs_plain(x[0], 3000)
    _bisect_vs_plain(x[-1], 10)


def _decode_table(words, word_start, bit_len, nnz):
    w = torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                         .view(np.int32))
    return w, [torch.from_numpy(np.array(a, np.int64, ndmin=1))
               for a in (word_start, bit_len, nnz)]


def _decode_verdict(fn):
    try:
        return fn()
    except wire.WireDecodeError:
        return "raised"


def _golomb_kernel_vs_plain(dev, words, word_start, bit_len, nnz, numel, b):
    """The kernel and its plain version on the same card words: the same
    verdict, and fields identical; returns the kernel's outcome."""
    w, table = _decode_table(words, word_start, bit_len, nnz)
    w = w.to(dev)
    got = _decode_verdict(
        lambda: rk.decode_golomb_fields(w, *table, numel, b))
    torch.cuda.synchronize()
    want = _decode_verdict(
        lambda: rk.decode_golomb_fields_plain(w, *table, numel, b))
    assert isinstance(got, str) == isinstance(want, str), (got, want)
    if not isinstance(got, str):
        assert all(torch.equal(g, h) for g, h in zip(got, want))
    return got


@pytest.mark.parametrize(
    "case", golomb_cases.valid_cases() + golomb_cases.trap_cases(),
    ids=lambda c: c[0])
def test_golomb_decode_matches_plain(dev, case):
    name, batch, p = case
    before = rk.LAUNCHES.counts["golomb_decode"]
    got = _golomb_kernel_vs_plain(
        dev, batch.words, batch.word_start, batch.bit_len, batch.nnz,
        batch.numel, wire._b_star_checked(p))
    assert rk.LAUNCHES.counts["golomb_decode"] == before + 1
    assert not isinstance(got, str) and got[1].numel() == batch.nnz.sum()


def test_golomb_decode_cnn_round_through_the_wire_backend(dev):
    batch, p = golomb_cases.cnn_round()
    before = dict(rk.LAUNCHES.counts)
    got = wire.decode_ternary_fields_batch(batch, p, backend="kernel",
                                           device=dev)
    assert rk.LAUNCHES.counts["golomb_decode"] == before["golomb_decode"] + 1
    assert rk.LAUNCHES.counts["unpack_bits"] == before["unpack_bits"]
    want = wire.decode_ternary_fields_batch(batch, p)
    for g, h in zip(got, want):
        assert g.dtype == h.dtype
        np.testing.assert_array_equal(g, h)
    _golomb_kernel_vs_plain(dev, batch.words, batch.word_start,
                            batch.bit_len, batch.nnz, batch.numel,
                            wire._b_star_checked(p))


def test_golomb_decode_corrupt_same_verdict(dev):
    """Corrupt batches and the 60 mutations of the reference's wire fuzz
    test: the kernel raises exactly where its plain version raises."""
    raised = 0
    for name, batch, p in golomb_cases.corrupt_cases(300):
        got = _decode_verdict(lambda: wire.decode_ternary_fields_batch(
            batch, p, backend="kernel", device=dev))
        want = _decode_verdict(lambda: wire.decode_ternary_fields_batch(
            batch, p, backend="kernel", device="cpu"))
        assert isinstance(got, str) == isinstance(want, str), name
        if not isinstance(got, str):
            assert all(np.array_equal(g, h) for g, h in zip(got, want))
        raised += isinstance(got, str)
    for trial, msg, p in golomb_cases.fuzz_messages():
        got = _decode_verdict(lambda: wire.decode_ternary_fields(
            msg, p, backend="kernel", device=dev))
        want = _decode_verdict(lambda: wire.decode_ternary_fields(
            msg, p, backend="kernel", device="cpu"))
        assert isinstance(got, str) == isinstance(want, str), trial
        if not isinstance(got, str):
            assert all(np.array_equal(g, h) for g, h in zip(got, want))
    assert raised >= 150


@pytest.mark.parametrize("b", [0, 5, 30])
def test_golomb_decode_all_ones_and_zero_buffers(dev, b):
    for fill in (0xFFFFFFFF, 0):
        words = np.full(40, fill, np.uint32)
        for bit_len in (1, 31, 32, 33, 256, 257, 1280):
            for nnz in {0, 1, bit_len // (b + 2)}:
                _golomb_kernel_vs_plain(dev, words, [0], [bit_len], [nnz],
                                        10**9, b)


def _codec_rows(seed, rows, n):
    """Carried-like rows of a top-k / TernQuant round: heavy-tailed, one
    with fewer non-zeros than k, one of zeros, one of subnormals among a
    few normals."""
    rng = np.random.default_rng(seed)
    x = rng.standard_t(1.5, (rows, n)).astype(np.float32)
    x[1] = 0.0
    x[1, rng.choice(n, 3, replace=False)] = 1.0
    x[2] = 0.0
    x[3] = (rng.standard_normal(n) * 1e-40).astype(np.float32)
    x[3, rng.choice(n, 5, replace=False)] = rng.standard_normal(5)
    return x


def test_topk_encode_on_the_card_bitwise_its_cpu_route(dev):
    """``TopKCodec.encode_batch`` at the cnn round's (10, 307,434): one
    histogram and one ``bin_select`` launch, and messages, counts and
    residuals bitwise the CPU's (the kernels' plain versions)."""
    from repro_torch.core import make_protocol
    from repro_torch.core.residual import ResidualState
    codec = make_protocol("topk", sparsity_up=1 / 50)
    d = _codec_rows(11, 10, 307_434)
    r = _codec_rows(12, 10, 307_434) * np.float32(0.01)
    before = dict(rk.LAUNCHES.counts)
    msgs, st, stats = codec.encode_batch(
        torch.from_numpy(d).to(dev), ResidualState(torch.from_numpy(r).to(dev)))
    torch.cuda.synchronize()
    after = rk.LAUNCHES.counts
    assert after["histogram"] == before["histogram"] + 1
    assert after["bin_select"] == before["bin_select"] + 1
    assert after["stc_apply"] == before["stc_apply"]
    msgs_c, st_c, stats_c = codec.encode_batch(
        torch.from_numpy(d), ResidualState(torch.from_numpy(r)))
    for got, want in ((msgs, msgs_c), (st.residual, st_c.residual)):
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32),
                                      want.numpy().view(np.int32))
    assert torch.equal(stats.nnz.cpu(), stats_c.nnz)


def test_ternquant_encode_on_the_card_masks_exact(dev):
    """``TernQuantCodec.encode_batch`` on the card launches no selection
    kernel; its masks equal the CPU's and µ is within rtol 1e-6 (the two
    fp64 sums round once to fp32)."""
    from repro_torch.core import make_protocol
    from repro_torch.core.residual import ResidualState
    codec = make_protocol("ternquant")
    d = _codec_rows(13, 10, 307_434)
    before = dict(rk.LAUNCHES.counts)
    msgs, _, stats = codec.encode_batch(
        torch.from_numpy(d).to(dev),
        ResidualState(torch.zeros(d.shape, device=dev)))
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts == before
    msgs_c, _, stats_c = codec.encode_batch(
        torch.from_numpy(d), ResidualState(torch.zeros(d.shape)))
    assert torch.equal(msgs.cpu() != 0, msgs_c != 0)
    assert torch.equal(torch.sign(msgs.cpu()), torch.sign(msgs_c))
    assert torch.equal(stats.nnz.cpu(), stats_c.nnz)
    assert torch.allclose(stats.mu.cpu(), stats_c.mu, rtol=1e-6, atol=0.0)


def test_buffered_padded_batch_through_the_kernels(dev):
    """The buffered STC trainer on the card with stragglers: the padded
    aggregation buffer (a multiple of the cohort, zero-weight padding) is
    combined on the card and the server's STC runs through the kernels;
    the arrival log equals the CPU run's and the first round's global
    delta has the CPU's positions and signs."""
    from repro_torch.core import make_protocol
    from repro_torch.data import make_classification
    from repro_torch.fed import (BufferedFederatedTrainer, FedEnvironment,
                                 LatencyModel, TrainerConfig)
    from repro_torch.models import MODEL_ZOO
    train, test = make_classification(seed=0, n=2000)
    env = FedEnvironment(n_clients=10, participation=0.5,
                         classes_per_client=2, batch_size=20)
    runs = []
    for device in (dev, "cpu"):
        tr = BufferedFederatedTrainer(
            MODEL_ZOO["logreg"], train, test, env,
            make_protocol("stc", sparsity_up=1 / 20, sparsity_down=1 / 20),
            TrainerConfig(lr=0.05), latency=LatencyModel(
                mean=1.2, sigma=0.6, hetero=0.5, straggler_frac=0.2,
                straggler_scale=4.0), deadline=1.0, max_staleness=2,
            device=device)
        bufs, deltas = [], []
        apply_update = tr._apply_update

        def record(msgs, mask, staleness, apply_update=apply_update,
                   bufs=bufs, deltas=deltas):
            bufs.append((tuple(msgs.shape), msgs.device.type,
                         np.asarray(mask).tolist()))
            out = apply_update(msgs, mask, staleness)
            deltas.append(out.cpu())
            return out

        tr._apply_update = record
        before = dict(rk.LAUNCHES.counts)
        tr.run(4, eval_every=4)
        runs.append((tr, bufs, deltas, {k: rk.LAUNCHES.counts[k] - before[k]
                                        for k in before}))
    (card, bufs, deltas, launches), (cpu, bufs_c, deltas_c, _) = runs
    assert card.arrival_log == cpu.arrival_log
    assert [b[0] for b in bufs] == [b[0] for b in bufs_c]
    assert all(shape[0] % 5 == 0 and kind == "cuda"
               for shape, kind, _ in bufs)
    assert any(0.0 in mask for _, _, mask in bufs)          # padding rows
    assert launches["histogram"] == launches["bin_select"] == \
        4 + len(bufs)                       # every encode, every aggregate
    assert launches["stc_apply"] == 4 + len(bufs)
    assert torch.equal(torch.sign(deltas[0]), torch.sign(deltas_c[0]))


def test_row_batches_beyond_the_grid(dev):
    """70,000 short rows: the histogram, ``bin_select`` and ``stc_apply``
    take two launches each (65,535 rows a launch at most) and give,
    bitwise, what one launch gives on each half; counts equal the plain
    versions'."""
    rows, n = 70_000, 48
    x = _rows(dev, (rows, n), 21) * 1e-2
    x[7] = 0.0
    ks = torch.from_numpy(np.random.default_rng(22).integers(
        1, n, rows)).to(dev)
    before = dict(rk.LAUNCHES.counts)
    t, c, s = rk.hist_topk_threshold_batched(x, ks)
    mu = s / torch.clamp(c, min=1).to(torch.float32)
    tern, res = rk.stc_apply_batched(x, t, mu)
    torch.cuda.synchronize()
    for name in ("histogram", "bin_select", "stc_apply"):
        assert rk.LAUNCHES.counts[name] == before[name] + 2
    halves = [slice(0, 35_000), slice(35_000, rows)]
    parts = [rk.hist_topk_threshold_batched(x[h], ks[h]) for h in halves]
    for got, part in zip((t, c, s), zip(*parts)):
        assert torch.equal(got, torch.cat(part))
    applied = [rk.stc_apply_batched(x[h].contiguous(), t[h].contiguous(),
                                    mu[h].contiguous()) for h in halves]
    assert torch.equal(tern, torch.cat([a[0] for a in applied]))
    assert torch.equal(res, torch.cat([a[1] for a in applied]))
    t_c, c_c, _ = rk.hist_topk_threshold_batched(x.cpu(), ks.cpu())
    assert torch.equal(t.cpu(), t_c) and torch.equal(c.cpu(), c_c)


@pytest.mark.parametrize("rows", [79, 790])
def test_stc_compress_blocks_fixed_and_device_ks(dev, rows):
    """The chunked STC core at the cnn's chunked shapes: per-row ks on the
    host and as a device tensor give the CPU plain route's thresholds,
    counts and masks (µ within rtol 1e-6), one launch of each kernel a
    call and no host synchronization."""
    from repro_torch.core.compression import stc_compress_blocks
    rng = np.random.default_rng(rows)
    x_np = (rng.standard_normal((rows, 4096)) * 1e-3).astype(np.float32)
    x_np[3, 100:] = 0.0
    x_np[4] = 0.0
    x = torch.from_numpy(x_np).to(dev)
    ks = rng.integers(1, 330, rows)
    kt = torch.from_numpy(ks.astype(np.int32)).to(dev)
    want = stc_compress_blocks(torch.from_numpy(x_np), ks)
    stc_compress_blocks(x, ks)                     # grows the scratch
    torch.cuda.synchronize()
    before = dict(rk.LAUNCHES.counts)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = stc_compress_blocks(x, ks)
        dyn = stc_compress_blocks(x, kt, k_cap=330)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for name in ("histogram", "bin_select", "stc_apply"):
        assert rk.LAUNCHES.counts[name] == before[name] + 2
    for out in (got, dyn):
        assert torch.equal(torch.sign(out[0].cpu()), torch.sign(want[0]))
        assert torch.equal(out[1].cpu(), want[1])
        assert torch.allclose(out[2].cpu(), want[2], rtol=1e-6, atol=0.0)
    assert all(torch.equal(a, b) for a, b in zip(got, dyn))


def test_chunked_ingest_decode_matches_per_chunk_loop(dev):
    """The chunked ingest on the card (one ``golomb_decode`` a width group)
    against the per-(message, chunk) loop of single decodes: the
    accumulator bitwise."""
    from repro_torch.core import Codec, make_protocol
    from repro_torch.core.chunking import chunk_codec, chunk_spec_from_sizes
    from repro_torch.core.residual import stack_states
    cc = chunk_codec(make_protocol("stc", sparsity_up=1 / 20,
                                   sparsity_down=1 / 20,
                                   wire_backend="kernel"),
                     chunk_spec_from_sizes([9000, 4096, 128, 10],
                                           chunk_size=4096))
    P, n = 10, cc.spec.numel
    d = _rows(dev, (P, n), 23) * 1e-2
    msgs, _, _ = cc.encode_batch(
        d, stack_states(cc.init_client_state(n, dev), P))
    batch = cc.encode_wire_batch(msgs)
    w = np.linspace(0.5, 1.0, P)
    before = rk.LAUNCHES.counts["golomb_decode"]
    acc = cc.make_ingest(n)
    cc.ingest_wire_batch(acc, batch, w, device=dev)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["golomb_decode"] == before + len(batch.batches)
    loop = cc.make_ingest(n)
    for i in range(P):
        loop.begin_message(float(w[i]), bits=float(batch.bit_len[i])
                           + 32.0 * cc.spec.n_chunks)
    starts = np.asarray(cc.spec.chunk_start)
    for (valid, codec, idxs, _), wb in zip(cc._groups(), batch.batches):
        Codec.ingest_wire_rows(codec, loop, wb, np.repeat(w, len(idxs)),
                               np.tile(starts[list(idxs)], P), device=dev)
    assert acc.sum.tobytes() == loop.sum.tobytes()
    assert (acc.weight_mass, acc.nnz, acc.stream_bits) == \
        (loop.weight_mass, loop.nnz, loop.stream_bits)


@pytest.mark.parametrize("fault", ["bit-flip", "truncate"])
def test_golomb_decode_fault_corruptions_same_verdict(dev, fault):
    """The event server's corruptions (the ``bit-flip`` and ``truncate``
    fault models on STC wire messages at p = 1/50): admission validation
    and the screened ingest on the card raise ``WireDecodeError`` exactly
    where they raise on the CPU, and the accumulators of the messages that
    pass are identical."""
    from repro_torch.core import make_protocol
    from repro_torch.fed import make_fault
    proto = make_protocol("stc", sparsity_up=1 / 50, wire_backend="kernel",
                          rule="norm_screened_mean")
    fm = make_fault(fault, prob=0.8, n_bits=2) if fault == "bit-flip" \
        else make_fault(fault, prob=0.5)
    rng = np.random.default_rng(11)
    raised = 0
    for d in range(120):
        x = golomb_cases.ternary(rng, int(rng.integers(500, 20_000)), 1 / 50)
        msg = fm.corrupt(wire.encode_ternary_words(x, 1 / 50), fm.rng(d))
        got = _decode_verdict(lambda: proto.validate_wire(msg, device=dev))
        want = _decode_verdict(lambda: proto.validate_wire(msg,
                                                           device="cpu"))
        assert (got == "raised") == (want == "raised"), d
        raised += got == "raised"
        if got != "raised":
            accs = []
            for where in (dev, "cpu"):
                acc = proto.make_ingest(msg.numel)
                proto.ingest_wire(acc, msg, 0.5, device=where)
                accs.append(acc)
            assert np.array_equal(accs[0].sum, accs[1].sum)
            assert accs[0].n_screened == accs[1].n_screened
    assert raised > 20


def test_event_trainer_quarantines_on_the_card_as_on_the_cpu(dev):
    """The event server under truncation on the ingest route, card against
    CPU (logreg, 4 aggregations): the same events, the same quarantine log
    and finite parameters; each admitted STC arrival launches
    ``golomb_decode`` twice (validation and ingest)."""
    from repro_torch.core import make_protocol
    from repro_torch.data import make_classification
    from repro_torch.fed import (EventDrivenTrainer, FedEnvironment,
                                 TrainerConfig, make_fault)
    from repro_torch.models import MODEL_ZOO

    def run(device):
        tr = EventDrivenTrainer(
            MODEL_ZOO["logreg"], *make_classification(seed=0, n=900,
                                                      n_test=240),
            FedEnvironment(n_clients=8, participation=0.25,
                           classes_per_client=2, batch_size=10),
            make_protocol("stc", sparsity_up=1 / 20, sparsity_down=1 / 20,
                          wire_backend="kernel"),
            TrainerConfig(seed=0, ingest=True), scenario="flash-outage",
            k_arrivals=2, concurrency=4, max_staleness=3,
            faults=make_fault("truncate", prob=0.5), device=device)
        before = rk.LAUNCHES.counts["golomb_decode"]
        for _ in range(4):
            tr.run_round()
        return tr, rk.LAUNCHES.counts["golomb_decode"] - before

    card, launched = run(dev)
    cpu, _ = run("cpu")
    kinds = [(r["kind"], r.get("client")) for r in card.event_log]
    assert kinds == [(r["kind"], r.get("client")) for r in cpu.event_log]
    assert card.loop.quarantine_log == cpu.loop.quarantine_log
    assert card.loop.n_quarantined > 0
    assert launched == 2 * card.loop.n_arrived
    assert bool(torch.isfinite(card.params_vec).all())


# -- the mesh trainer's row: SmolLM-135M flattened, (1, 134,515,008) -------

MESH_N = 134_515_008
MESH_K = 2_690_300                       # p = 1/50


def _mesh_row(dev, kind):
    """A (1, 134,515,008) row on the card: ``normal`` (x 1e-3) or
    ``bf16`` (the same rounded to bf16: the tie-heavy grads of a bf16
    step)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((1, MESH_N), generator=gen, device=dev) * 1e-3
    return x.to(torch.bfloat16).to(torch.float32) if kind == "bf16" else x


@pytest.mark.parametrize("kind", ["normal", "bf16"])
def test_mesh_row_histogram(dev, kind):
    x = _mesh_row(dev, kind)
    scale = 256.0 / x.abs().amax(dim=1)
    cnt, sums = rk.magnitude_histogram_batched(x, scale)
    cnt_p, sums_p = rk.magnitude_histogram_plain(x, scale)
    assert torch.equal(cnt, cnt_p) and int(cnt.sum()) == MESH_N
    assert torch.allclose(sums, sums_p, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("kind", ["normal", "bf16"])
def test_mesh_row_bin_select_and_selection(dev, kind):
    x = _mesh_row(dev, kind)
    scale, b, r = _select_inputs(x, MESH_K)
    got = rk.candidate_select_batched(x, scale, b, r)
    want = rk.candidate_select_plain(x, scale, b, r)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0)
    t, c, _ = rk.hist_topk_threshold_batched(x, MESH_K)
    a = x.abs()
    assert int((a > t[0]).sum()) < MESH_K <= int((a >= t[0]).sum()) \
        == int(c[0])


@pytest.mark.parametrize("kind", ["normal", "bf16"])
def test_mesh_row_stc_apply_bitwise(dev, kind):
    x = _mesh_row(dev, kind)
    t, c, s = rk.hist_topk_threshold_batched(x, MESH_K)
    mu = s / c.to(torch.float32)
    got = rk.stc_apply_batched(x, t, mu)
    want = rk.stc_apply_plain(x, t, mu)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
