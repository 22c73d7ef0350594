"""Port parity of ``repro_torch.optim``: momentum SGD, AdamW and the
learning-rate schedules, against the JAX package on numpy inputs made from
a seed.

* ``sgd_apply`` and ``adamw_apply`` over 5 steps on a nested tree (dicts
  and a list) with fp32 and bf16 parameters, at lr as a number and as a
  schedule's value: parameters and every state leaf within rtol 1e-7 (fp32
  arithmetic in the same order; the bf16 parameters round the same fp32
  values); the state stays fp32 and the parameters keep their dtype.
* ``constant_lr``, ``cosine_lr`` and ``warmup_cosine_lr`` at every step of
  0..1,100 as Python integers and as int32 tensors: within rtol 1e-7 (the
  port's cosine of a host value is glibc's ``cosf``, which XLA's CPU
  backend calls, so they come out bitwise).
* The reference's own optimizer checks (``tests/test_checkpoint_optim.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref
from repro_torch import optim
from repro_torch.core.compression import tree_leaves

RTOL = 1e-7


def _tree(seed, dtype):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {"w": a(8, 4), "blocks": [{"g": a(5), "w_up": a(3, 6)}, a(2, 2)]}
    if dtype == "bf16":
        tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(
            x, jnp.bfloat16).astype(jnp.float32)), tree)
    return tree


def _to_jax(tree, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return jax.tree.map(lambda x: jnp.asarray(x, jdt), tree)


def _to_torch(tree, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)).to(tdt), tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _same(got, want):
    got_leaves, want_leaves = tree_leaves(got), jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=0)


LRS = {"number": (lambda s: 0.05, lambda s: 0.05),
       "cosine": (ref.cosine_lr(0.05, 7), optim.cosine_lr(0.05, 7))}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("lr", list(LRS))
def test_sgd_matches_reference(dtype, momentum, lr):
    ref_lr, port_lr = LRS[lr]
    p_np = _tree(0, dtype)
    rp, tp = _to_jax(p_np, dtype), _to_torch(p_np, dtype)
    rs, ts = ref.sgd_init(rp), optim.sgd_init(tp)
    assert all(x.dtype == torch.float32 for x in tree_leaves(ts))
    for step in range(5):
        g_np = _tree(10 + step, "fp32")
        rp, rs = ref.sgd_apply(rp, _to_jax(g_np, dtype), rs, ref_lr(step),
                               momentum=momentum)
        tp, ts = optim.sgd_apply(tp, _to_torch(g_np, dtype), ts,
                                 port_lr(step), momentum=momentum)
        _same(tp, rp)
        _same(ts, rs)
    want_dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert all(x.dtype == want_dt for x in tree_leaves(tp))
    assert all(x.dtype == torch.float32 for x in tree_leaves(ts))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("lr", list(LRS))
def test_adamw_matches_reference(dtype, weight_decay, lr):
    ref_lr, port_lr = LRS[lr]
    p_np = _tree(1, dtype)
    rp, tp = _to_jax(p_np, dtype), _to_torch(p_np, dtype)
    rs, ts = ref.adamw_init(rp), optim.adamw_init(tp)
    for step in range(5):
        g_np = _tree(20 + step, "fp32")
        rp, rs = ref.adamw_apply(rp, _to_jax(g_np, dtype), rs, ref_lr(step),
                                 weight_decay=weight_decay)
        tp, ts = optim.adamw_apply(tp, _to_torch(g_np, dtype), ts,
                                   port_lr(step), weight_decay=weight_decay)
        _same(tp, rp)
        _same(ts["m"], rs["m"])
        _same(ts["v"], rs["v"])
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == int(rs["t"])


SCHEDULES = {
    "constant": (ref.constant_lr(0.3), optim.constant_lr(0.3)),
    "cosine": (ref.cosine_lr(0.3, 977), optim.cosine_lr(0.3, 977)),
    "cosine_frac": (ref.cosine_lr(1.0, 100, 0.0),
                    optim.cosine_lr(1.0, 100, 0.0)),
    "warmup_cosine": (ref.warmup_cosine_lr(0.3, 37, 977),
                      optim.warmup_cosine_lr(0.3, 37, 977)),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_reference(name):
    rf, pf = SCHEDULES[name]
    steps = range(0, 1100)
    want = np.array([np.float32(rf(s)) for s in steps])
    got = np.array([pf(s).numpy() for s in steps])
    got_t = np.array([pf(torch.tensor(s, dtype=torch.int32)).numpy()
                      for s in steps])
    want_j = np.array([np.float32(rf(jnp.int32(s))) for s in steps])
    for g in (got, got_t):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got_t, want_j, rtol=RTOL, atol=0)


def test_reference_optimizer_checks():
    p, g = {"w": torch.zeros(3)}, {"w": torch.ones(3)}
    v = optim.sgd_init(p)
    p1, v1 = optim.sgd_apply(p, g, v, lr=1.0, momentum=0.9)
    p2, v2 = optim.sgd_apply(p1, g, v1, lr=1.0, momentum=0.9)
    np.testing.assert_allclose(v2["w"].numpy(), 1.9)
    np.testing.assert_allclose(p2["w"].numpy(), -2.9)
    p = {"w": torch.ones(4)}
    st = optim.adamw_init(p)
    p1, st1 = optim.adamw_apply(p, {"w": torch.full((4,), 0.5)}, st, lr=0.1)
    assert float(p1["w"][0]) < 1.0 and int(st1["t"]) == 1
    assert float(optim.constant_lr(0.1)(1000)) == pytest.approx(0.1)
    c = optim.cosine_lr(1.0, 100)
    assert float(c(0)) == pytest.approx(1.0)
    assert float(c(100)) == pytest.approx(0.1)
    w = optim.warmup_cosine_lr(1.0, 10, 110)
    assert float(w(0)) == pytest.approx(0.0)
    assert float(w(10)) == pytest.approx(1.0)


def test_surface_matches_reference():
    assert optim.__all__ == ref.__all__
