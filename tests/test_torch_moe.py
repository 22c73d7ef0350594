"""Port parity of the MoE FFN (``repro_torch.models.moe``) against the JAX
package, at fp32 on numpy inputs made from a seed, with the reference's
initial parameters handed over through ``params_from_jax``.

* ``moe_apply``, ragged and capacity dispatch (capacity factor 1.0, where
  rows drop, 1.25 and 8.0), over the ``(e, k)`` sweep of
  ``tests/test_moe_dispatch.py``: the output and the aux loss within 1e-5
  of their largest magnitude, and the gradients of every parameter (the
  router's included) and of the input, through ``jax.vjp`` with random
  cotangents, within 1e-5 of their largest magnitude (at k = 1 the
  router's within 1e-2: there the gate g / g = 1 has an exactly
  cancelling gradient, rounding noise in both packages; with the aux
  loss's cotangent alone the router's gradient is held at 1e-5).
* The capacity dispatch's drop set at capacity factor 1.0, exactly: each
  expert writes a one-hot column, so a dropped (token, expert) row shows
  as an exact zero in the output, the reference's and the port's.
* The router on scores that tie exactly (duplicated router columns; bf16
  logits): the expert indices of ``jax.lax.top_k`` on the same
  probabilities, the lower index first, and ``moe_apply`` the reference's.
* The capacity, ``max(int(t·k·cf/E + 0.999), 8)``, as a Python integer.
* The ragged dispatch against the capacity dispatch at factor 8 (no drop)
  within 3e-5, the reference's own tolerance; and two runs bitwise equal,
  gradients included.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch.core.compression import tree_leaves
from repro_torch.models import moe, params_from_jax
from repro_torch.models.config import MoEConfig

TOL = 1e-5          # of the largest magnitude, fp32

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _close_to_max(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _setup(e=8, k=2, d=64, d_e=32, t=(2, 16), seed=0, **kw):
    cfg = dict(dict(n_experts=e, top_k=k, n_shared=1, d_expert=d_e), **kw)
    ref_cfg, cfg = RefMoEConfig(**cfg), MoEConfig(**cfg)
    params = jax.tree.map(np.asarray, ref_moe.moe_init(
        jax.random.PRNGKey(seed), d, ref_cfg))
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(t + (d,)).astype(np.float32)
    return ref_cfg, cfg, params, x


def _ref_run(params, x, cfg, dout, daux):
    @jax.jit
    def run(p, xx, do, da):
        (out, aux), vjp = jax.vjp(lambda pp, xv: ref_moe.moe_apply(
            pp, xv, cfg), p, xx)
        return out, aux, vjp((do, da))

    out, aux, (gp, gx) = run(jax.tree.map(jnp.asarray, params),
                             jnp.asarray(x), jnp.asarray(dout),
                             jnp.float32(daux))
    return (np.asarray(out), float(aux), [np.asarray(g) for g in
                                          jax.tree.leaves(gp)],
            np.asarray(gx))


def _ref_out(params, x, cfg):
    return np.asarray(jax.jit(lambda p, xx: ref_moe.moe_apply(p, xx, cfg)[0])(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x)))


def _port_run(params, x, cfg, dout, daux):
    p = params_from_jax(params)
    leaves = tree_leaves(p)
    xt = torch.from_numpy(x).requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    out, aux = moe.moe_apply(p, xt, cfg)
    grads = torch.autograd.grad((out, aux), leaves + [xt],
                                (torch.from_numpy(dout), torch.tensor(daux)))
    return (out.detach().numpy(), float(aux.detach()), [g.numpy() for g in
                                               grads[:-1]], grads[-1].numpy())


CASES = [(e, k, dispatch, cf) for e, k in [(4, 1), (8, 2), (16, 4)]
         for dispatch, cf in [("ragged", 1.25), ("capacity", 1.0),
                              ("capacity", 1.25), ("capacity", 8.0)]]


@pytest.mark.parametrize("e,k,dispatch,cf", CASES)
def test_moe_apply_and_grads_match_reference(e, k, dispatch, cf):
    ref_cfg, cfg, params, x = _setup(e=e, k=k, dispatch=dispatch,
                                     capacity_factor=cf)
    rng = np.random.default_rng(7)
    dout = rng.standard_normal(x.shape).astype(np.float32)
    want = _ref_run(params, x, ref_cfg, dout, 3.0)
    got = _port_run(params, x, cfg, dout, 3.0)
    _close_to_max(got[0], want[0], what="out")
    np.testing.assert_allclose(got[1], want[1], rtol=TOL)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert len(got[2]) == len(want[2]) == len(names)
    for name, g, w in zip(names, got[2], want[2]):
        # at k = 1 the gate is g / g = 1, and its gradient an exact
        # cancellation that both packages round to noise of ~ulp(ct / g)
        # (3e-6 here); the router's gradient then gets 1e-2, and is held
        # at 1e-5 below with the aux loss's cotangent alone
        tol = 1e-2 if (k == 1 and name == "['router']") else TOL
        _close_to_max(g, w, tol, what=f"grad {name}")
    _close_to_max(got[3], want[3], what="grad x")
    if k == 1:
        zero = np.zeros_like(dout)
        want = _ref_run(params, x, ref_cfg, zero, 3.0)[2][names.index(
            "['router']")]
        got = _port_run(params, x, cfg, zero, 3.0)[2][names.index(
            "['router']")]
        _close_to_max(got, want, what="router grad, aux alone")


def _one_hot_experts(params, e, d_e):
    """Expert j's FFN maps every token to 10·silu-ish times column j of
    the output: swiglu of (x·W_gate)[0] = 10·x_0, (x·W_up)[0] = x_0, and
    W_down's row 0 = one_hot(j); no shared expert."""
    params = dict(params)
    d = params["router"].shape[0]
    w_gate = np.zeros((e, d, d_e), np.float32)
    w_up = np.zeros((e, d, d_e), np.float32)
    w_down = np.zeros((e, d_e, d), np.float32)
    w_gate[:, 0, 0], w_up[:, 0, 0] = 10.0, 1.0
    w_down[np.arange(e), 0, np.arange(e)] = 1.0
    params.update(w_gate=w_gate, w_up=w_up, w_down=w_down)
    return params


@pytest.mark.parametrize("e,k,t", [(8, 2, (2, 16)), (4, 2, (1, 64)),
                                   (16, 4, (3, 11))])
def test_capacity_drop_set_matches_reference_exactly(e, k, t):
    ref_cfg, cfg, params, x = _setup(e=e, k=k, t=t, n_shared=0,
                                     dispatch="capacity",
                                     capacity_factor=1.0)
    params = _one_hot_experts(params, e, 32)
    x[..., 0] = 1.0
    want = _ref_out(params, x, ref_cfg)
    got = moe.moe_apply(params_from_jax(params), torch.from_numpy(x),
                        cfg)[0].numpy()
    probs, _, idx = moe.route(params_from_jax(params),
                              torch.from_numpy(x.reshape(-1, x.shape[-1])),
                              cfg)
    idx = idx.numpy()
    tok = np.arange(idx.shape[0])[:, None]
    dropped_want = want.reshape(-1, want.shape[-1])[tok, idx] == 0.0
    dropped_got = got.reshape(-1, got.shape[-1])[tok, idx] == 0.0
    np.testing.assert_array_equal(dropped_got, dropped_want)
    cap = moe.capacity(cfg, idx.shape[0])
    n_rows = np.bincount(idx.reshape(-1), minlength=e)
    assert dropped_got.sum() == np.maximum(n_rows - cap, 0).sum() > 0
    _close_to_max(got, want)


def _tied_router(d, e, dtype):
    """Router columns in pairs: column j + e/2 equals column j, so every
    token's scores tie exactly in pairs."""
    rng = np.random.default_rng(3)
    half = rng.standard_normal((d, e // 2)).astype(np.float32)
    return np.concatenate([half, half], axis=1)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_router_ties_break_toward_the_lower_expert_index(dtype):
    e, k, d = 8, 3, 16
    ref_cfg, cfg, params, x = _setup(e=e, k=k, d=d, d_e=8, t=(2, 24))
    params = dict(params, router=_tied_router(d, e, dtype))
    tdt, jdt = {"fp32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    xt = torch.from_numpy(x.reshape(-1, d)).to(tdt)
    probs, gates, idx = moe.route(params_from_jax(params), xt, cfg)
    p = probs.numpy()
    assert np.all(p[:, :e // 2] == p[:, e // 2:])          # exact pair ties
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(p), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    # of two tied experts the lower index comes first
    for row in idx.numpy():
        for j in row:
            if j >= e // 2:
                assert j - e // 2 in row
                assert list(row).index(j - e // 2) < list(row).index(j)
    if dtype == "fp32":
        want = _ref_out(params, x, ref_cfg)
        got = moe.moe_apply(params_from_jax(params), torch.from_numpy(x),
                            cfg)[0].numpy()
        _close_to_max(got, want)


def test_bf16_logits_tie_and_break_as_top_k():
    """In bf16 the rounded logits tie between experts of one token (64
    experts, the deepseek router's width): the port picks the experts
    ``jax.lax.top_k`` picks on the same probabilities."""
    e, k, d = 64, 6, 32
    _, cfg, params, x = _setup(e=e, k=k, d=d, d_e=8, t=(4, 64))
    xt = torch.from_numpy(x.reshape(-1, d)).to(torch.bfloat16)
    probs, _, idx = moe.route(params_from_jax(params), xt, cfg)
    p = probs.numpy()
    srt = -np.sort(-p, axis=1)
    assert np.any(srt[:, :k + 1][:, 1:] == srt[:, :k + 1][:, :-1])
    np.testing.assert_array_equal(idx.numpy(),
                                  np.asarray(jax.lax.top_k(p, k)[1]))


@pytest.mark.parametrize("t,k,e,cf", [(32, 2, 8, 1.25), (32, 2, 8, 1.0),
                                      (64, 2, 4, 1.0), (33, 4, 16, 1.25),
                                      (7, 6, 64, 1.25), (2048, 6, 64, 1.1),
                                      (3, 1, 4, 8.0)])
def test_capacity_is_the_reference_integer(t, k, e, cf):
    cfg = MoEConfig(n_experts=e, top_k=k, capacity_factor=cf)
    want = min(max(int(t * k * cf / e + 0.999), 8), t * k)
    assert moe.capacity(cfg, t) == want
    assert isinstance(moe.capacity(cfg, t), int)


def test_ragged_matches_capacity_without_drops_and_reruns_bitwise():
    _, cfg, params, x = _setup()
    big = dataclasses.replace(cfg, dispatch="capacity", capacity_factor=8.0)
    p = params_from_jax(params)
    o_r, aux_r = moe.moe_apply(p, torch.from_numpy(x), cfg)
    o_c, aux_c = moe.moe_apply(p, torch.from_numpy(x), big)
    np.testing.assert_allclose(o_c.numpy(), o_r.numpy(), atol=3e-5)
    np.testing.assert_allclose(float(aux_c), float(aux_r), rtol=1e-5)
    dout = np.random.default_rng(2).standard_normal(x.shape).astype(
        np.float32)
    runs = [_port_run(params, x, cfg, dout, 1.0) for _ in range(2)]
    assert np.array_equal(runs[0][0], runs[1][0])
    assert all(np.array_equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
