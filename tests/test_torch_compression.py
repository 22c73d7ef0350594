"""Port parity of core/compression.py: both port backends ("torch", and
"kernel" through its plain versions on the CPU) against the reference's
"jnp" backend, on the cases of tests/test_compression.py (ties, zeros,
extreme dynamic range, k = 1, k = n), plus the parameter-tree flattening
order that the global top-k depends on.

Masks, message positions and signs, and counts are exact; µ within rtol
1e-6 (the "kernel" route assembles Σ from histogram bins).  A residual
``carried - µ·sign`` inherits µ's error, so it is held within 1e-6 of
``|residual| + µ`` of its row (plus atol 1e-6).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as ref
from repro_torch.core import compression as port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BACKENDS = ["torch", "kernel"]
CASES = ["gaussian", "ties", "zeros", "extreme"]


def _case(name, rng, n):
    if name == "gaussian":
        return rng.standard_normal(n)
    if name == "ties":
        return np.where(rng.random(n) < 0.5, 1.0,
                        rng.uniform(0, 0.5, n)) * np.sign(
                            rng.standard_normal(n))
    if name == "zeros":
        x = rng.standard_normal(n)
        x[rng.random(n) < 0.7] = 0.0
        return x
    if name == "extreme":
        return 10.0 ** rng.uniform(-30, 30, n) * np.sign(
            rng.standard_normal(n))
    raise ValueError(name)


def _compare(d, r, p, backend):
    tj, rj, sj = ref.get_stc_backend("jnp").compress_with_residual_batch(
        jnp.asarray(d), jnp.asarray(r), p)
    tp, rp, sp = port.get_stc_backend(backend).compress_with_residual_batch(
        torch.from_numpy(d), torch.from_numpy(r), p)
    tj, rj = np.asarray(tj), np.asarray(rj)
    np.testing.assert_array_equal(tp.numpy() != 0, tj != 0)       # mask
    np.testing.assert_array_equal(np.sign(tp.numpy()), np.sign(tj))
    np.testing.assert_array_equal(sp.nnz.numpy(), np.asarray(sj.nnz))
    np.testing.assert_allclose(sp.mu.numpy(), np.asarray(sj.mu), rtol=1e-6)
    _assert_residual_close(rp.numpy(), rj, np.asarray(sj.mu))


def _assert_residual_close(got, want, mu):
    tol = 1e-6 * (np.abs(want) + np.abs(mu).reshape(-1, 1)) + 1e-6
    assert np.all(np.abs(got - want) <= tol), np.max(np.abs(got - want) - tol)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("p", [1 / 400, 1 / 50, 0.1])
def test_backend_matches_jnp(backend, case, p):
    rng = np.random.default_rng(1000 * CASES.index(case) + int(1 / p))
    d = np.stack([_case(case, rng, 4000) for _ in range(3)]).astype(
        np.float32)
    r = (rng.standard_normal(d.shape) * 1e-2).astype(np.float32)
    if case == "zeros":
        r[:] = 0.0                 # keep the zeros through the carried sum
    _compare(d, r, p, backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("p", [1e-9, 1.0])            # k = 1 and k = n
def test_k_extremes(backend, p):
    rng = np.random.default_rng(3)
    d = rng.standard_normal((2, 1500)).astype(np.float32)
    _compare(d, np.zeros_like(d), p, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_all_zero_rows(backend):
    d = np.zeros((2, 1000), np.float32)
    _compare(d, d.copy(), 0.01, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_vector_form(backend):
    rng = np.random.default_rng(5)
    d = rng.standard_normal(3000).astype(np.float32)
    r = (rng.standard_normal(3000) * 0.1).astype(np.float32)
    tj, rj, sj = ref.get_stc_backend("jnp").compress_with_residual(
        jnp.asarray(d), jnp.asarray(r), 0.01)
    tp, rp, sp = port.get_stc_backend(backend).compress_with_residual(
        torch.from_numpy(d), torch.from_numpy(r), 0.01)
    np.testing.assert_array_equal(np.sign(tp.numpy()), np.sign(np.asarray(tj)))
    assert int(sp.nnz) == int(sj.nnz)
    np.testing.assert_allclose(float(sp.mu), float(sj.mu), rtol=1e-6)
    _assert_residual_close(rp.numpy()[None], np.asarray(rj)[None],
                           np.asarray(sj.mu))


@pytest.mark.parametrize("backend", BACKENDS)
def test_select_batch_per_row_k(backend):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 2000)).astype(np.float32)
    ks = np.array([1, 40, 2000])
    vj, cj, sj = ref.get_stc_backend("jnp").select_batch(jnp.asarray(x), ks)
    vp, cp, sp = port.get_stc_backend(backend).select_batch(
        torch.from_numpy(x), ks)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=1e-6)


@pytest.mark.parametrize("case", ["gaussian", "ties", "zeros"])
def test_stc_compress_operator(case):
    rng = np.random.default_rng(11)
    x = _case(case, rng, 5000).astype(np.float32)
    tj, sj = ref.stc_compress(jnp.asarray(x), 0.01)
    tp, sp = port.stc_compress(torch.from_numpy(x), 0.01)
    np.testing.assert_array_equal(np.sign(tp.numpy()), np.sign(np.asarray(tj)))
    assert int(sp.nnz) == int(sj.nnz)
    np.testing.assert_allclose(float(sp.mu), float(sj.mu), rtol=1e-6)


def _tree(rng):
    return {
        "w": rng.standard_normal((13, 7)).astype(np.float32),
        "layers": [
            {"wx": rng.standard_normal((3, 8)).astype(np.float32),
             "b": rng.standard_normal(8).astype(np.float32),
             "wh": rng.standard_normal((2, 8)).astype(np.float32)},
            {"wx": rng.standard_normal((8, 4)).astype(np.float32),
             "b": rng.standard_normal(4).astype(np.float32),
             "wh": rng.standard_normal((2, 4)).astype(np.float32)},
        ],
        "a": rng.standard_normal(5).astype(np.float32),
        "conv0": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
    }


def test_flatten_order_matches_jax_tree_flatten():
    tree = _tree(np.random.default_rng(0))
    vj, _ = ref.flatten_pytree(jax.tree.map(jnp.asarray, tree))
    tt = jax.tree.map(torch.from_numpy, tree)
    vp, spec = port.flatten_pytree(tt)
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    back = port.unflatten_pytree(vp, spec)
    for a, b in zip(port.tree_leaves(back), port.tree_leaves(tt)):
        assert torch.equal(a, b)
    # a stacked cohort unflattens leaf by leaf with its leading axis
    rows = port.unflatten_pytree(torch.stack([vp, 2 * vp]), spec)
    assert torch.equal(rows["layers"][1]["wh"][1], 2 * tt["layers"][1]["wh"])


def test_global_topk_spans_leaves():
    """The flat vector's top-k over a tree selects the same coordinates as
    the reference's (the reason the flatten order must match)."""
    tree = _tree(np.random.default_rng(1))
    vj, _ = ref.flatten_pytree(jax.tree.map(jnp.asarray, tree))
    vp, _ = port.flatten_pytree(jax.tree.map(torch.from_numpy, tree))
    mj = np.asarray(ref.top_k_mask(vj, 17))
    mp = port.top_k_mask(vp, 17).numpy()
    np.testing.assert_array_equal(mp, mj)


def test_unknown_backend():
    with pytest.raises(ValueError, match="unknown STC backend"):
        port.get_stc_backend("nope")


# ---------------------------------------------------------------------------
# Subnormal fp32 values: XLA on the CPU (and the TPU) flushes them to zero in
# arithmetic and comparisons, so the reference never selects or counts them.
# ---------------------------------------------------------------------------

FLT_MIN = np.finfo(np.float32).tiny


def _subnormal_rows(rng, rows, n, normals):
    """N(0, 1)·1e-40 subnormals with ``normals`` N(0, 1) values a row."""
    x = rng.standard_normal((rows, n)) * 1e-40
    for row in x:
        row[rng.choice(n, normals, replace=False)] = rng.standard_normal(
            normals)
    return x.astype(np.float32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("normals", [5, 40])
def test_subnormals_count_as_zero_like_jnp(backend, normals):
    """n = 2,000, a few N(0, 1) values among subnormals, residual 0, p =
    1/100 (k = 20).  Mask, count and threshold are "jnp"'s bit for bit, and
    so is the residual wherever nothing was sent (every subnormal leaves
    +0, the reference's flushed value).  µ, and with it the sent entries'
    residuals, is held to rtol 1e-6, as everywhere in this file: its fp32
    sum is reduced in another order than XLA's."""
    rng = np.random.default_rng(normals)
    d = _subnormal_rows(rng, 2, 2000, normals)
    r = np.zeros_like(d)
    tj, rj, sj = ref.get_stc_backend("jnp").compress_with_residual_batch(
        jnp.asarray(d), jnp.asarray(r), 0.01)
    tp, rp, sp = port.get_stc_backend(backend).compress_with_residual_batch(
        torch.from_numpy(d), torch.from_numpy(r), 0.01)
    tj, rj = np.asarray(tj), np.asarray(rj)
    sent = tj != 0
    np.testing.assert_array_equal(tp.numpy() != 0, sent)
    np.testing.assert_array_equal(np.sign(tp.numpy()), np.sign(tj))
    np.testing.assert_array_equal(sp.nnz.numpy(), np.asarray(sj.nnz))
    assert (sp.nnz.numpy() == min(normals, 20)).all()
    np.testing.assert_array_equal(rp.numpy()[~sent].view(np.uint32),
                                  rj[~sent].view(np.uint32))
    assert not np.any((rp.numpy() != 0) & (np.abs(rp.numpy()) < FLT_MIN))
    np.testing.assert_allclose(sp.mu.numpy(), np.asarray(sj.mu), rtol=1e-6)
    _assert_residual_close(rp.numpy(), rj, np.asarray(sj.mu))
    # the threshold of the same (flushed) carried rows
    vj, cj, _ = ref.get_stc_backend("jnp").select_batch(
        jnp.asarray(d) + jnp.asarray(r), 20)
    vp, cp, _ = port.get_stc_backend(backend).select_batch(
        torch.from_numpy(d), 20)
    np.testing.assert_array_equal(vp.numpy().view(np.uint32),
                                  np.asarray(vj).view(np.uint32))
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))


@pytest.mark.parametrize("backend", BACKENDS)
def test_select_batch_on_unflushed_subnormal_rows(backend):
    """Handed subnormals directly, the reference's ``select_batch`` returns
    the k-th largest subnormal's bits as the threshold (``top_k`` moves bits
    without flushing them) and then compares as if it were 0; the port
    returns 0.  Both count and sum the same normal values."""
    rng = np.random.default_rng(3)
    x = _subnormal_rows(rng, 3, 2000, 5)
    vj, cj, sj = ref.get_stc_backend("jnp").select_batch(jnp.asarray(x), 20)
    vp, cp, sp = port.get_stc_backend(backend).select_batch(
        torch.from_numpy(x), 20)
    vj = np.asarray(vj)
    assert ((vj > 0) & (vj < FLT_MIN)).all()
    assert (vp.numpy() == 0).all()
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    assert (cp.numpy() == 5).all()
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=1e-6)


def test_sign_compress_subnormals_have_sign_zero():
    """signSGD: a subnormal coordinate sends 0.  The reference gives -0 for
    a negative one (``jnp.sign`` keeps the sign of zero); the port gives +0
    (``torch.sign``).  They are the same value."""
    x = np.array([1e-40, -1e-40, 0.5, 0.0, -3.0, FLT_MIN], np.float32)
    want = np.asarray(ref.sign_compress(jnp.asarray(x), 2e-4)[0])
    got = port.sign_compress(torch.from_numpy(x), 2e-4)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.float32([0, 0, 2e-4, 0, -2e-4,
                                                   2e-4]))
    assert np.signbit(want[1]) and not np.signbit(got[1])


def test_r5_kernel_route_carried_sum_is_not_flushed():
    """ROADMAP Queue 3, R5.  ``"torch"`` flushes the operands of the carried
    sum as XLA does: every unsent residual is ``"jnp"``'s bit for bit.  The
    ``"kernel"`` route adds them unflushed (flushing would cost two passes
    on the card), so where one operand is subnormal and the other is below
    2^-102 in magnitude (where a subnormal moves the sum) the carried value,
    and with it the residual, is not the reference's; where the unflushed
    sum is itself subnormal, the residual is +0 and the reference's is the
    zero of the sum's sign.  What holds: mask, signs and count exact, µ
    within rtol 1e-6, and every other unsent residual bit for bit."""
    rng = np.random.default_rng(17)
    d = (rng.standard_normal((2, 2000)) * 1e-38).astype(np.float32)
    r = (rng.standard_normal((2, 2000))
         * np.where(rng.random((2, 2000)) < 0.5, 1e-38, 1e-3)
         ).astype(np.float32)
    d[:, :40] = rng.standard_normal((2, 40))
    tj, rj, sj = ref.get_stc_backend("jnp").compress_with_residual_batch(
        jnp.asarray(d), jnp.asarray(r), 0.01)
    tj, rj = np.asarray(tj), np.asarray(rj)
    for backend in BACKENDS:
        tp, rp, sp = port.get_stc_backend(
            backend).compress_with_residual_batch(
                torch.from_numpy(d), torch.from_numpy(r), 0.01)
        sent = tj != 0
        np.testing.assert_array_equal(tp.numpy() != 0, sent)
        np.testing.assert_array_equal(np.sign(tp.numpy()), np.sign(tj))
        np.testing.assert_array_equal(sp.nnz.numpy(), np.asarray(sj.nnz))
        np.testing.assert_allclose(sp.mu.numpy(), np.asarray(sj.mu),
                                   rtol=1e-6)
        rp = rp.numpy()
        if backend == "torch":
            np.testing.assert_array_equal(rp[~sent].view(np.uint32),
                                          rj[~sent].view(np.uint32))
            continue
        sub_d = (d != 0) & (np.abs(d) < FLT_MIN)
        sub_r = (r != 0) & (np.abs(r) < FLT_MIN)
        small = 2.0 ** -102
        r5 = (sub_d & (np.abs(r) < small)) | (sub_r & (np.abs(d) < small))
        np.testing.assert_array_equal(rp[~sent & ~r5], rj[~sent & ~r5])
        raw = d + r
        signed = ~sent & ~r5 & ~((raw != 0) & (np.abs(raw) < FLT_MIN))
        np.testing.assert_array_equal(rp[signed].view(np.uint32),
                                      rj[signed].view(np.uint32))
        # what differs on this input (the numbers of R5 in ROADMAP.md)
        u, uj = rp[~sent], rj[~sent]
        assert int((u != uj).sum()) == 946
        assert int(((u == uj) & (u.view(np.uint32) != uj.view(np.uint32))
                    ).sum()) == 216
