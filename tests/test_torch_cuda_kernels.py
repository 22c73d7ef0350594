"""The CUDA kernels against their plain versions on the card.

Marked ``cuda``: they need a card and ``nvcc`` and skip without them (the
CPU tests hold the plain versions to the JAX package).  On a machine with
a card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels as rk

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


@pytest.mark.parametrize("k", [1, 6148, 307_434])
def test_selection_matches_cpu_route(dev, k):
    x = _rows(dev, (3, 307_434), 2)
    t, c, s = rk.hist_topk_threshold_batched(x, k)
    t_c, c_c, s_c = rk.hist_topk_threshold_batched(x.cpu(), k)
    assert torch.equal(t.cpu(), t_c) and torch.equal(c.cpu(), c_c)
    assert torch.allclose(s.cpu(), s_c, rtol=1e-6, atol=0.0)


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


@pytest.mark.parametrize("q", [0.0, 0.5, 0.98, 2.0])
def test_threshold_stats(dev, q):
    x = _rows(dev, (307_434,), 3)
    x[::7] = 0.0                                 # zeros: counted never
    t = (x.abs().quantile(q) if q <= 1 else x.abs().max() * q)
    t = t.reshape(()) if q > 0 else torch.zeros((), device=dev)
    before = rk.LAUNCHES.counts["threshold_stats"]
    cnt, total = rk.threshold_stats(x, t)
    cnt_p, total_p = rk.threshold_stats_plain(x, t)
    torch.cuda.synchronize()
    assert rk.LAUNCHES.counts["threshold_stats"] == before + 1
    assert int(cnt) == int(cnt_p)
    assert torch.allclose(total, total_p, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("p", [0.001, 0.02, 0.1])
def test_bisection_matches_cpu(dev, p):
    x = _rows(dev, (307_434,), 4)
    k = max(int(x.numel() * p), 1)
    before = rk.LAUNCHES.counts["threshold_stats"]
    t, c, s = rk.topk_threshold(x, k)
    t_c, c_c, s_c = rk.topk_threshold(x.cpu(), k)
    assert rk.LAUNCHES.counts["threshold_stats"] == before + 33
    assert torch.equal(t.cpu(), t_c) and int(c) == int(c_c) == k
    assert torch.allclose(s.cpu(), s_c, rtol=1e-6, atol=0.0)
