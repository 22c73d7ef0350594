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
