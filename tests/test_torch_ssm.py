"""Port parity of the recurrent blocks (``repro_torch.models.ssm``: Mamba-2's
chunked SSD; ``repro_torch.models.rglru``: Griffin's RG-LRU) against the
JAX package, at fp32 on numpy inputs made from a seed, with the
reference's initial parameters handed over through ``params_from_jax``.

* ``ssd_scan`` at chunk 2, 4 and 8 over S = 16, with one and with two
  groups: ``y`` and the final state within 1e-5 of their largest
  magnitude; two halves carried through ``init_state`` give the whole.
* ``ssd_apply`` and ``rglru_apply``: the output within 1e-5 and the
  gradients of every parameter and of the input (``jax.vjp`` with a
  random cotangent) within 1e-4 of their largest magnitude (fp32 orders
  of summation differ: the SSD's einsums are batched matmuls here, the
  RG-LRU's scan is Hillis–Steele where XLA's ``associative_scan`` combines
  in another order, R13), at S that are not powers of two; the SSD's
  gradients stay finite at one full chunk where the masked upper triangle
  of ``_segsum`` would overflow ``exp``.  At bf16 the output within 0.05
  of its largest magnitude (8 bits; torch and XLA round bf16 matmuls at
  other places).  ``softplus``: torch's ``threshold=20`` switch and
  ``jax.nn.softplus``'s ``logaddexp`` agree to rounding inside these
  tolerances.
* ``ssd_decode`` / ``rglru_decode`` over 8 steps from a random state:
  output, state and conv tail within 1e-5 of their largest magnitude; the
  state is written in place and ``idx`` advances on its device.
* The deterministic init leaves: ``A_log`` within 5e-7 absolute and
  ``lam`` within rtol 2e-5 of the reference's (the port's
  ``np.linspace`` is within 2 ulps of ``jnp.linspace``, which computes
  ``start·(1 − step) + stop·step``; ``log(expm1(−log a / c))`` amplifies
  that by up to 1 / |log a| ≈ 1000 near a = 0.999), ``D``, ``dt_bias``,
  ``norm_g`` exact; leaf keys and shapes; the caches' shapes and dtypes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro.models.config import RGLRUConfig as RefRGLRUConfig
from repro.models.config import SSMConfig as RefSSMConfig
from repro_torch.core.compression import tree_leaves
from repro_torch.models import params_from_jax, rglru, ssm
from repro_torch.models.layers import causal_conv
from repro_torch.models.config import RGLRUConfig, SSMConfig

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D = 16
TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 0.05


def _close_to_max(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- ssd_scan -----------------------------------------------------------------


def _scan_inputs(groups, seed=0, b=2, s=16, h=4, p=8, n=4):
    rng = np.random.default_rng(seed)
    f = np.float32
    xh = rng.standard_normal((b, s, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f)
    A = (rng.standard_normal(h) * 0.5).astype(f)
    B = rng.standard_normal((b, s, groups, n)).astype(f)
    C = rng.standard_normal((b, s, groups, n)).astype(f)
    return xh, dt, A, B, C


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk", [2, 4, 8])
def test_ssd_scan_matches_reference(chunk, groups):
    inputs = _scan_inputs(groups, seed=chunk)
    y_ref, st_ref = ref_ssm.ssd_scan(*inputs, chunk)
    y, st = ssm.ssd_scan(*map(_t, inputs), chunk)
    _close_to_max(y.numpy(), y_ref, what="y")
    _close_to_max(st.numpy(), st_ref, what="final state")


def test_ssd_scan_init_state_continuation_matches_reference():
    """Scanning two halves with the carried state == scanning the whole
    (the twin of the reference's ``test_final_state_continuation``)."""
    xh, dt, A, B, C = _scan_inputs(1, seed=3, b=1, h=2, p=4)
    halves = [tuple(_t(v[:, sl]) for v in (xh, dt, B, C))
              for sl in (slice(0, 8), slice(8, 16))]
    y_full, st_full = ssm.ssd_scan(*map(_t, (xh, dt, A, B, C)), 4)
    (x1, d1, b1, c1), (x2, d2, b2, c2) = halves
    y1, st1 = ssm.ssd_scan(x1, d1, _t(A), b1, c1, 4)
    y2, st2 = ssm.ssd_scan(x2, d2, _t(A), b2, c2, 4, init_state=st1)
    _close_to_max(torch.cat([y1, y2], 1).numpy(), y_full.numpy())
    _close_to_max(st2.numpy(), st_full.numpy())
    _, ref_st1 = ref_ssm.ssd_scan(xh[:, :8], dt[:, :8], A, B[:, :8],
                                  C[:, :8], 4)
    ref_y2, ref_st2 = ref_ssm.ssd_scan(xh[:, 8:], dt[:, 8:], A, B[:, 8:],
                                       C[:, 8:], 4, init_state=ref_st1)
    _close_to_max(y2.numpy(), ref_y2)
    _close_to_max(st2.numpy(), ref_st2)


def test_ssd_scan_refuses_a_chunk_that_does_not_divide():
    inputs = map(_t, _scan_inputs(1, s=12))
    with pytest.raises(ValueError, match="divisible"):
        ssm.ssd_scan(*inputs, 8)


# -- ssd_apply ----------------------------------------------------------------

SSD_CASES = {
    # name: (S, chunk, groups, dt_bias)
    "two_chunks": (16, 8, 1, None),
    "ragged_s_groups": (12, 4, 2, None),
    "one_full_chunk": (8, 8, 1, None),
    # softplus(5) ~ 5 and A = 16: dA ~ -80 a step, so the masked upper
    # triangle of _segsum would reach exp(+560) = inf
    "one_chunk_overflowing_triangle": (8, 8, 1, 5.0),
}


def _ssd_setup(groups, seed=0, dt_bias=None):
    kw = dict(d_state=8, d_conv=4, expand=2, head_dim=8, n_groups=groups)
    params = jax.tree.map(np.asarray, ref_ssm.ssd_init(
        jax.random.PRNGKey(seed), D, RefSSMConfig(**kw)))
    rng = np.random.default_rng(seed + 1)
    # exercise D and dt_bias away from their 1 / 0 init
    params["D"] = (1 + 0.5 * rng.standard_normal(params["D"].shape)).astype(
        np.float32)
    params["dt_bias"] = (np.full(params["dt_bias"].shape, dt_bias, np.float32)
                         if dt_bias is not None else
                         (0.5 * rng.standard_normal(params["dt_bias"].shape))
                         .astype(np.float32))
    params["norm_g"] = (1 + 0.1 * rng.standard_normal(
        params["norm_g"].shape)).astype(np.float32)
    return kw, params


def _apply_vjp(ref_fn, port_fn, params, x, dy):
    out, vjp = jax.vjp(jax.jit(ref_fn), params, jnp.asarray(x))
    g_params, g_x = vjp(jnp.asarray(dy))
    want = [np.asarray(out)] + [np.asarray(g) for g in
                                jax.tree.leaves(g_params)] + [np.asarray(g_x)]
    p = params_from_jax(params)
    leaves = tree_leaves(p)
    xt = _t(x).requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = port_fn(p, xt)
    grads = torch.autograd.grad(got, leaves + [xt], _t(dy))
    return want, [got.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_apply_and_grads_match_reference(case):
    s, chunk, groups, dt_bias = SSD_CASES[case]
    kw, params = _ssd_setup(groups, dt_bias=dt_bias)
    ref_cfg, cfg = RefSSMConfig(chunk=chunk, **kw), SSMConfig(chunk=chunk,
                                                              **kw)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    dy = rng.standard_normal((2, s, D)).astype(np.float32)
    want, got = _apply_vjp(
        lambda p, xx: ref_ssm.ssd_apply(p, xx, ref_cfg, D),
        lambda p, xx: ssm.ssd_apply(p, xx, cfg, D), params, x, dy)
    assert all(np.isfinite(g).all() for g in got), case
    assert all(np.isfinite(w).all() for w in want), case
    _close_to_max(got[0], want[0], TOL, "output")
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        _close_to_max(g, w, GRAD_TOL, f"gradient {i}")


def test_ssd_apply_bf16_matches_reference():
    kw, params = _ssd_setup(1, seed=2)
    x = np.random.default_rng(5).standard_normal((2, 16, D)).astype(
        np.float32)
    want = ref_ssm.ssd_apply(params, jnp.asarray(x, jnp.bfloat16),
                             RefSSMConfig(chunk=4, **kw), D)
    got = ssm.ssd_apply(params_from_jax(params), _t(x).to(torch.bfloat16),
                        SSMConfig(chunk=4, **kw), D)
    assert got.dtype == torch.bfloat16
    _close_to_max(got.float().numpy(), np.asarray(want, np.float32),
                  BF16_TOL)


# -- ssd_decode ---------------------------------------------------------------


def _randomized(ref, port, rng):
    """The reference's and the port's fresh caches with their states and
    conv tails set to the same random values."""
    fields = {name: (0.5 * rng.standard_normal(getattr(ref, name).shape))
              .astype(np.float32) for name in ref._fields if name != "idx"}
    for name, v in fields.items():
        getattr(port, name).copy_(_t(v))
    return ref._replace(**{k: jnp.asarray(v) for k, v in fields.items()}), \
        port


def _decode_steps(ref_step, port_step, ref_cache, cache, rng, steps=8):
    for t in range(steps):
        x = rng.standard_normal((2, 1, D)).astype(np.float32)
        want, ref_cache = ref_step(jnp.asarray(x), ref_cache)
        got, cache = port_step(_t(x), cache)
        _close_to_max(got.numpy(), want, what=f"output at step {t}")
        for name in cache._fields:
            if name == "idx":
                assert int(cache.idx) == int(ref_cache.idx) == t + 1
            else:
                _close_to_max(getattr(cache, name).numpy(),
                              getattr(ref_cache, name),
                              what=f"{name} at step {t}")
    return cache


def test_ssd_decode_matches_reference_and_writes_in_place():
    kw, params = _ssd_setup(2, seed=4)
    ref_cfg, cfg = RefSSMConfig(**kw), SSMConfig(**kw)
    rng = np.random.default_rng(6)
    ref_cache, cache = _randomized(ref_ssm.init_ssm_cache(2, D, ref_cfg),
                                   ssm.init_ssm_cache(2, D, cfg,
                                                      device="cpu"), rng)
    state, conv = cache.state, cache.conv
    p = params_from_jax(params)
    out = _decode_steps(
        lambda x, c: ref_ssm.ssd_decode(params, x, c, ref_cfg, D),
        lambda x, c: ssm.ssd_decode(p, x, c, cfg, D), ref_cache, cache, rng)
    assert out.state is state and out.conv is conv      # the same storage
    assert out.idx.device == state.device and out.idx.dtype == torch.int32


# -- rglru --------------------------------------------------------------------


def _rglru_params(seed=0):
    params = jax.tree.map(np.asarray, ref_rglru.rglru_init(
        jax.random.PRNGKey(seed), D, RefRGLRUConfig()))
    return params


@pytest.mark.parametrize("s", [1, 5, 12, 16])
def test_rglru_apply_and_grads_match_reference(s):
    params = _rglru_params()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    dy = rng.standard_normal((2, s, D)).astype(np.float32)
    want, got = _apply_vjp(
        lambda p, xx: ref_rglru.rglru_apply(p, xx, RefRGLRUConfig(), D),
        lambda p, xx: rglru.rglru_apply(p, xx, RGLRUConfig(), D),
        params, x, dy)
    _close_to_max(got[0], want[0], TOL, "output")
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        _close_to_max(g, w, GRAD_TOL, f"gradient {i}")


def test_rglru_scan_matches_a_sequential_loop():
    """The Hillis–Steele scan against h_t = a_t·h_{t-1} + b_t step by step
    (S = 13: the shifts run past the end in the last round)."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 13, 6)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 13, 6)).astype(np.float32))
    h = torch.zeros((2, 6))
    want = []
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close_to_max(rglru._scan(a, b).numpy(), torch.stack(want, 1).numpy(),
                  1e-6)


def test_rglru_gates_stay_fp32_and_match_reference():
    params = _rglru_params(1)
    x = np.random.default_rng(8).standard_normal((2, 5, D)).astype(
        np.float32)
    want = ref_rglru._gates(params, jnp.asarray(x, jnp.bfloat16),
                            RefRGLRUConfig())
    got = rglru._gates(params_from_jax(params), _t(x).to(torch.bfloat16),
                       RGLRUConfig())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close_to_max(g.numpy(), w, TOL)


def test_rglru_apply_bf16_matches_reference():
    params = _rglru_params(2)
    x = np.random.default_rng(9).standard_normal((2, 12, D)).astype(
        np.float32)
    want = ref_rglru.rglru_apply(params, jnp.asarray(x, jnp.bfloat16),
                                 RefRGLRUConfig(), D)
    got = rglru.rglru_apply(params_from_jax(params), _t(x).to(torch.bfloat16),
                            RGLRUConfig(), D)
    assert got.dtype == torch.bfloat16
    _close_to_max(got.float().numpy(), np.asarray(want, np.float32),
                  BF16_TOL)


def test_rglru_decode_matches_reference_and_writes_in_place():
    params = _rglru_params(3)
    rng = np.random.default_rng(10)
    ref_cfg, cfg = RefRGLRUConfig(), RGLRUConfig()
    ref_cache, cache = _randomized(
        ref_rglru.init_rglru_cache(2, D, ref_cfg),
        rglru.init_rglru_cache(2, D, cfg, device="cpu"), rng)
    h, conv = cache.h, cache.conv
    p = params_from_jax(params)
    out = _decode_steps(
        lambda x, c: ref_rglru.rglru_decode(params, x, c, ref_cfg, D),
        lambda x, c: rglru.rglru_decode(p, x, c, cfg, D), ref_cache, cache,
        rng)
    assert out.h is h and out.conv is conv
    assert out.idx.dtype == torch.int32


# -- init ---------------------------------------------------------------------


@pytest.mark.parametrize("d,head_dim", [(16, 8), (128, 32), (1024, 64),
                                        (200, 4)])
def test_ssd_init_leaves_match_reference(d, head_dim):
    kw = dict(head_dim=head_dim, d_state=8)
    ref = jax.tree.map(np.asarray, ref_ssm.ssd_init(
        jax.random.PRNGKey(0), d, RefSSMConfig(**kw)))
    got = ssm.ssd_init(torch.Generator().manual_seed(0), d, SSMConfig(**kw))
    assert list(sorted(got)) == list(sorted(ref)) == [
        "A_log", "D", "conv_w", "dt_bias", "norm_g", "w_in", "w_out"]
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    assert all(v.dtype == torch.float32 for v in got.values())
    np.testing.assert_allclose(got["A_log"].numpy(), ref["A_log"], rtol=0,
                               atol=5e-7)
    for name in ("D", "dt_bias", "norm_g"):
        np.testing.assert_array_equal(got[name].numpy(), ref[name])


@pytest.mark.parametrize("w", [2, 16, 1000, 2560])
def test_rglru_init_leaves_match_reference(w):
    ref = jax.tree.map(np.asarray, ref_rglru.rglru_init(
        jax.random.PRNGKey(0), w, RefRGLRUConfig()))
    got = rglru.rglru_init(torch.Generator().manual_seed(0), w,
                           RGLRUConfig())
    assert list(sorted(got)) == list(sorted(ref)) == [
        "conv_w", "lam", "w_a", "w_in", "w_out", "w_x"]
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in ref.items()}
    np.testing.assert_allclose(got["lam"].numpy(), ref["lam"], rtol=2e-5)


def test_init_caches_match_reference():
    kw = dict(d_state=8, head_dim=8, n_groups=2)
    for dtype, ref_dtype in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
        pairs = [(ssm.init_ssm_cache(3, D, SSMConfig(**kw), dtype,
                                     device="cpu"),
                  ref_ssm.init_ssm_cache(3, D, RefSSMConfig(**kw),
                                         ref_dtype)),
                 (rglru.init_rglru_cache(3, D, RGLRUConfig(block_width=24),
                                         dtype, device="cpu"),
                  ref_rglru.init_rglru_cache(
                      3, D, RefRGLRUConfig(block_width=24), ref_dtype))]
        for got, want in pairs:
            assert got._fields == want._fields
            for g, w in zip(got, want):
                assert tuple(g.shape) == w.shape
                assert str(g.dtype).replace("torch.", "") == str(w.dtype)
                assert not g.any()


@pytest.mark.parametrize("split", [1, 3, 7])
def test_causal_conv_with_a_carried_tail_matches_the_whole_sequence(split):
    """The shared conv of both blocks: a sequence cut in two, the second
    part fed the first part's tail, gives the whole sequence's output
    bitwise, and the tail is the last k - 1 inputs (zeros before them)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((2, 8, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    whole, tail = causal_conv(x, w)
    first, mid = causal_conv(x[:, :split], w)
    second, end = causal_conv(x[:, split:], w, mid)
    assert torch.equal(torch.cat([first, second], dim=1), whole)
    assert torch.equal(end, tail) and torch.equal(tail, x[:, -3:])
    want_mid = torch.cat([torch.zeros(2, max(0, 3 - split), 5),
                          x[:, max(0, split - 3):split]], dim=1)
    assert torch.equal(mid, want_mid)
    # against the reference's formula, tap by tap in fp64
    xp = torch.nn.functional.pad(x.double(), (0, 0, 3, 0))
    ref = sum(w[i].double() * xp[:, i:i + 8] for i in range(4))
    assert torch.allclose(whole.double(), ref, rtol=1e-6, atol=1e-6)
