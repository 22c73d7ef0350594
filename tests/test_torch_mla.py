"""Port parity of Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package, at fp32 on numpy inputs made from a seed, with
the reference's initial parameters handed over through
``params_from_jax``.

* ``mla_apply``'s output and the gradients of every parameter and of the
  input, through ``jax.vjp`` with a random cotangent, within 1e-5 of their
  largest magnitude (one KV chunk, chunks that do not divide S, a sliding
  window); ``_mla_qkv``'s q, k, v and latent within 1e-5 of theirs.
* ``mla_decode`` teacher-forced over 10 steps from a fresh cache: each
  step's output and the whole latent cache (``c_kv``, ``k_rope``) within
  rtol 1e-5 / atol 1e-6 of the reference's, ``idx`` equal; with 8 slots
  the last two steps write the last slot (clamped, as
  ``dynamic_update_slice`` clamps), and with bf16 caches within 0.05 of
  the largest output.
* ``init_mla_cache``'s shapes and dtypes; the decode writes the cache in
  place and advances ``idx`` on its device.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as ref_mla
from repro.models.config import MLAConfig as RefMLAConfig
from repro_torch.core.compression import tree_leaves
from repro_torch.models import mla, params_from_jax
from repro_torch.models.config import MLAConfig

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

D, H = 32, 4
CFG = dict(kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
           v_head_dim=6)
REF_CFG, PORT_CFG = RefMLAConfig(**CFG), MLAConfig(**CFG)
DECODE_TOL = dict(rtol=1e-5, atol=1e-6)


def _close_to_max(got, want, tol=1e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=what)


def _params(seed=0):
    return jax.tree.map(np.asarray, ref_mla.mla_init(
        jax.random.PRNGKey(seed), D, H, REF_CFG))


@pytest.mark.parametrize("s,chunk,window", [(12, 1024, 0), (13, 4, 0),
                                            (12, 5, 3)])
def test_mla_apply_and_grads_match_reference(s, chunk, window):
    params = _params()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    dout = rng.standard_normal((2, s, D)).astype(np.float32)
    kw = dict(n_heads=H, rope_theta=10000.0, chunk=chunk, window=window)

    @jax.jit
    def ref(p, xx, do):
        out, vjp = jax.vjp(lambda pp, xv: ref_mla.mla_apply(
            pp, xv, cfg=REF_CFG, **kw), p, xx)
        return out, vjp(do)

    want, (gp, gx) = ref(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                         jnp.asarray(dout))
    p = params_from_jax(params)
    leaves = tree_leaves(p)
    xt = torch.from_numpy(x).requires_grad_(True)
    for leaf in leaves:
        leaf.requires_grad_(True)
    got = mla.mla_apply(p, xt, cfg=PORT_CFG, **kw)
    grads = torch.autograd.grad(got, leaves + [xt], torch.from_numpy(dout))
    _close_to_max(got.detach().numpy(), want, what="out")
    ref_grads = jax.tree.leaves(gp)
    assert len(ref_grads) == len(grads) - 1 == 6
    for g, w in zip(grads, ref_grads + [gx]):
        _close_to_max(g.numpy(), w)


def test_mla_qkv_matches_reference():
    params = _params(1)
    x = np.random.default_rng(2).standard_normal((2, 9, D)).astype(
        np.float32)
    want = ref_mla._mla_qkv(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), H, REF_CFG, jnp.arange(9),
                            10000.0)
    got = mla._mla_qkv(params_from_jax(params), torch.from_numpy(x), H,
                       PORT_CFG, torch.arange(9), 10000.0)
    for g, w in zip(got, want):
        _close_to_max(g.numpy(), w)


def _ref_cache(cache):
    return ref_mla.MLACache(*(jnp.asarray(x.numpy()) for x in cache))


@pytest.mark.parametrize("s_cache,dtype", [(16, "fp32"), (8, "fp32"),
                                           (12, "bf16")],
                         ids=["room", "clamped_last_slot", "bf16_cache"])
def test_mla_decode_teacher_forced_matches_reference(s_cache, dtype):
    params = _params(3)
    steps = 10
    x = np.random.default_rng(4).standard_normal((2, steps, D)).astype(
        np.float32)
    tdt, jdt = {"fp32": (torch.float32, jnp.float32),
                "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    cache = mla.init_mla_cache(2, s_cache, PORT_CFG, tdt, device="cpu")
    ref_cache = ref_mla.init_mla_cache(2, s_cache, REF_CFG, jdt)
    kw = dict(n_heads=H, rope_theta=10000.0)
    ref_step = jax.jit(lambda p, xx, c: ref_mla.mla_decode(
        p, xx, c, cfg=REF_CFG, **kw))
    p_ref = jax.tree.map(jnp.asarray, params)
    p = params_from_jax(params)
    for t in range(steps):
        want, ref_cache = ref_step(p_ref, jnp.asarray(x[:, t:t + 1]),
                                   ref_cache)
        got, cache = mla.mla_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                    cache, cfg=PORT_CFG, **kw)
        want = np.asarray(want)
        if dtype == "fp32":
            np.testing.assert_allclose(got.numpy(), want, **DECODE_TOL,
                                       err_msg=f"out at step {t}")
            for name in ("c_kv", "k_rope"):
                np.testing.assert_allclose(
                    getattr(cache, name).numpy(),
                    np.asarray(getattr(ref_cache, name)), **DECODE_TOL,
                    err_msg=f"{name} at step {t}")
        else:
            _close_to_max(got.numpy(), want, 0.05, f"out at step {t}")
            assert cache.c_kv.dtype == torch.bfloat16
        assert int(cache.idx) == int(ref_cache.idx) == t + 1
    if s_cache < steps:
        # the last slot holds the last step's latent, as the reference's
        np.testing.assert_allclose(cache.c_kv[:, -1].numpy(),
                                   np.asarray(ref_cache.c_kv[:, -1]),
                                   **DECODE_TOL)


def test_init_mla_cache_matches_reference():
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        got = mla.init_mla_cache(3, 7, PORT_CFG, dtype, device="cpu")
        want = ref_mla.init_mla_cache(3, 7, REF_CFG, jdt)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
            assert not g.any()


def test_mla_decode_writes_in_place_and_advances_idx_on_the_device():
    params = params_from_jax(_params(5))
    cache = mla.init_mla_cache(2, 6, PORT_CFG, torch.float32, device="cpu")
    cache = cache._replace(idx=torch.tensor(2, dtype=torch.int32))
    x = torch.randn((2, 1, D), generator=torch.Generator().manual_seed(0))
    _, new = mla.mla_decode(params, x, cache, n_heads=H, cfg=PORT_CFG)
    assert new.c_kv is cache.c_kv and new.k_rope is cache.k_rope
    assert cache.c_kv[:, 2].any() and not cache.c_kv[:, [0, 1, 3, 4, 5]].any()
    assert new.idx.dtype == torch.int32 and int(new.idx) == 3
    assert int(cache.idx) == 2
