"""Port parity of the LM's serve path: the KV cache, the decode step and
``launch/serve.py``'s prefill and decode steps, on the CPU at the smoke
configs.

Held against the JAX package on numpy inputs made from a seed, with the
reference's initial parameters handed over through ``params_from_jax``:

* ``init_cache``: the same shapes, dtypes and ``ring`` flags for the full
  and long configs of smollm, qwen2 and phi3, and across the ring boundary
  (``s_cache`` below, at and above the window);
* ``attn_decode``: output and new K/V within rtol 1e-5 / atol 1e-6 at fp32
  (full cache, a ring that wraps, a full cache at its last slot,
  cross-attention);
* ``decode_step``: 10 teacher-forced steps, logits and caches within rtol
  1e-5 / atol 1e-5 at fp32, with QKV biases and with a ring
  (``sliding_window=4``, ``s_cache=10``) that wraps;
* the port's own decode against its ``forward`` (the reference's
  ``test_dense_gqa`` and ``test_sliding_ring_buffer_matches_full``, at
  their rtol 5e-3 / atol 2e-3);
* ``make_prefill_step`` / ``make_decode_step`` against the reference's on
  a (1, 1) mesh: fp32 within rtol 1e-5 / atol 1e-5; bf16 within 0.05 of the
  largest logit (bf16 keeps 8 bits, and torch and XLA round their bf16
  matmuls at different places; the LM tests hold bf16 logits so);
* every ``cache_mode`` gives the same values; ``model > 1`` raises; the
  cache is written in place and ``idx`` advances on its device; prefill
  with remat on and off is bitwise the same.
* The MoE family (deepseek: MLA and MoE blocks; moonshot and granite:
  attention and MoE): ``init_cache``'s shapes, dtypes and cache kinds for
  the full and long configs (an MLA layer's latent cache has ``s_cache``
  slots whatever the window); ``decode_step`` over 10 steps at the F32
  tolerances above, the latent caches included and with 8 slots clamped at
  the last; the prefill and decode entries at fp32 and bf16 as above; the
  port's decode against its ``forward`` (the twins of the reference's
  ``TestDecodeConsistency.test_mla`` / ``test_moe``, and each smoke
  config, at rtol 5e-3 / atol 2e-3).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import mesh as ref_mesh
from repro.launch import serve as ref_serve
from repro.models import attention as ref_attn
from repro.models import decode_step as ref_decode_step
from repro.models import init_cache as ref_init_cache
from repro.models import init_model as ref_init_model
from repro_torch import configs
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import (CACHE_MODES, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import (MLAConfig, MoEConfig, attention, decode_step,
                                forward, init_cache, init_model,
                                params_from_jax)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

DENSE = ("smollm-135m", "qwen2-0.5b", "phi3-medium-14b")
MOE = ("deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "granite-moe-3b-a800m")
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _reset_decode_hint():
    """The reference's ``make_decode_step`` sets a module global."""
    yield
    ref_attn.DECODE_SHARD_HINT = None


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_params(cfg, seed=0, bias_seed=None):
    """The reference's initial parameters as numpy; with ``bias_seed`` the
    (zero-initialized) QKV biases, where the config has them, get random
    values."""
    params = _np_tree(ref_init_model(cfg, jax.random.PRNGKey(seed)))
    if bias_seed is not None and cfg.attn_bias:
        rng = np.random.default_rng(bias_seed)
        for block in params["blocks"]:
            for name in ("bq", "bk", "bv"):
                block["mix"][name] = (rng.standard_normal(
                    block["mix"][name].shape) * 0.1).astype(np.float32)
    return params


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


# -- init_cache ---------------------------------------------------------------


def _ref_cache_specs(cfg, batch, s_cache):
    """Shapes, dtypes and ring flags of the reference's caches, traced
    without allocating them (the full configs' caches are GBs)."""
    rings = []

    def build():
        caches = ref_init_cache(cfg, batch, s_cache)
        rings.extend(c.ring for c in caches)
        return [(c.k, c.v, c.idx) for c in caches]

    shapes = jax.eval_shape(build)
    return [tuple((tuple(x.shape), str(x.dtype)) for x in kvi) + (ring,)
            for kvi, ring in zip(shapes, rings)]


def _port_cache_specs(cfg, batch, s_cache):
    caches = init_cache(cfg, batch, s_cache, device="meta")
    return [tuple((tuple(x.shape), str(x.dtype).replace("torch.", ""))
                  for x in (c.k, c.v, c.idx)) + (c.ring,) for c in caches]


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("which,s_cache", [
    ("full", 64), ("long", 8191), ("long", 8192), ("long", 8193)])
def test_init_cache_matches_reference(arch, which, s_cache):
    get = (lambda m: m.get_config(arch)) if which == "full" else (
        lambda m: m.get_config(arch, "long_500k"))
    want = _ref_cache_specs(get(ref_configs), 2, s_cache)
    got = _port_cache_specs(get(configs), 2, s_cache)
    assert got == want
    assert any(ring for *_, ring in got) == (which == "long" and
                                             s_cache > 8192)


def _cache_fields(cache):
    """A cache's tensors by field name (``KVCache``: k, v, idx and the ring
    flag; ``MLACache``: c_kv, k_rope, idx)."""
    return {f: getattr(cache, f) for f in cache._fields}


def _spec(x):
    if isinstance(x, bool):
        return x
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("which,s_cache", [
    ("full", 64), ("long", 8192), ("long", 8193)])
def test_init_cache_of_the_moe_archs_matches_reference(arch, which, s_cache):
    """MLA layers get a latent cache of s_cache slots whatever the window
    (no ring), attention layers the dense rule."""
    get = (lambda m: m.get_config(arch)) if which == "full" else (
        lambda m: m.get_config(arch, "long_500k"))
    kinds = []

    def build():
        caches = ref_init_cache(get(ref_configs), 2, s_cache)
        kinds.extend(type(c).__name__ for c in caches)
        return [{f: getattr(c, f) for f in c._fields if f != "ring"}
                for c in caches]

    want = [{f: (tuple(x.shape), str(x.dtype)) for f, x in c.items()}
            for c in jax.eval_shape(build)]
    caches = init_cache(get(configs), 2, s_cache, device="meta")
    got = [{f: _spec(x) for f, x in _cache_fields(c).items() if f != "ring"}
           for c in caches]
    assert got == want
    assert [type(c).__name__ for c in caches] == kinds
    rings = [c.ring for c in caches if hasattr(c, "ring")]
    assert any(rings) == (which == "long" and s_cache > 8192 and
                          arch != "deepseek-v2-lite-16b")


@pytest.mark.parametrize("window,s_cache", [(4, 3), (4, 4), (4, 10), (0, 10)])
def test_init_cache_ring_boundary_allocates_like_reference(window, s_cache):
    cfg = dataclasses.replace(configs.get_smoke_config("smollm-135m"),
                              sliding_window=window)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config("smollm-135m"),
                                  sliding_window=window)
    caches = init_cache(cfg, 1, s_cache, torch.float32, device="cpu")
    want = ref_init_cache(ref_cfg, 1, s_cache, jnp.float32)
    for c, w in zip(caches, want):
        assert c.k.shape == w.k.shape and c.ring == w.ring
        assert c.k.dtype == torch.float32 and c.idx.dtype == torch.int32
        assert c.idx.shape == () and int(c.idx) == 0
        assert not c.k.any() and not c.v.any()


def test_init_cache_defaults_to_bf16_on_the_card():
    cfg = configs.get_smoke_config("smollm-135m")
    assert init_cache(cfg, 1, 4, device="meta")[0].k.dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_cache(cfg, 1, 4)


# -- attn_decode --------------------------------------------------------------

D, H, KV, HD = 32, 4, 2, 8


def _attn_setup(seed, s_cache, idx, ring, bias=True):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(
            np.float32)

    params = {"wq": w(D, H * HD), "wk": w(D, KV * HD), "wv": w(D, KV * HD),
              "wo": w(H * HD, D)}
    if bias:
        for name, n in (("bq", H * HD), ("bk", KV * HD), ("bv", KV * HD)):
            params[name] = (rng.standard_normal(n) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 1, D)).astype(np.float32)
    k = rng.standard_normal((2, s_cache, KV, HD)).astype(np.float32)
    v = rng.standard_normal((2, s_cache, KV, HD)).astype(np.float32)
    memory = rng.standard_normal((2, 5, D)).astype(np.float32)
    return params, x, k, v, np.int32(idx), ring, memory


def _port_cache(k, v, idx, ring):
    return attention.KVCache(torch.tensor(k), torch.tensor(v),
                             torch.tensor(idx), ring)


@pytest.mark.parametrize("s_cache,idx,ring", [
    (12, 0, False), (12, 5, False), (12, 11, False), (12, 14, False),
    (6, 3, True), (6, 13, True)],
    ids=["first", "mid", "last_slot", "past_end", "ring", "ring_wrapped"])
def test_attn_decode_matches_reference(s_cache, idx, ring):
    params, x, k, v, idx, ring, _ = _attn_setup(0, s_cache, idx, ring)
    kw = dict(n_heads=H, n_kv_heads=KV, head_dim=HD, rope_theta=10000.0)
    want, want_cache = ref_attn.attn_decode(
        params, jnp.asarray(x), ref_attn.KVCache(jnp.asarray(k),
                                                 jnp.asarray(v),
                                                 jnp.asarray(idx), ring), **kw)
    got, cache = attention.attn_decode(
        {n: torch.tensor(a) for n, a in params.items()}, torch.tensor(x),
        _port_cache(k, v, idx, ring), **kw)
    tol = dict(rtol=1e-5, atol=1e-6)
    _close(got, want, **tol)
    _close(cache.k, want_cache.k, **tol)
    _close(cache.v, want_cache.v, **tol)
    assert int(cache.idx) == int(want_cache.idx) == idx + 1
    assert cache.ring == want_cache.ring


def test_attn_decode_cross_attention_matches_reference():
    params, x, k, v, idx, ring, memory = _attn_setup(1, 6, 2, False,
                                                     bias=False)
    kw = dict(n_heads=H, n_kv_heads=H, head_dim=HD)
    params["wk"] = np.tile(params["wk"], (1, 2))       # kv heads = heads
    params["wv"] = np.tile(params["wv"], (1, 2))
    want, want_cache = ref_attn.attn_decode(
        params, jnp.asarray(x), ref_attn.init_kv_cache(2, 6, H, HD),
        memory=jnp.asarray(memory), **kw)
    cache = attention.init_kv_cache(2, 6, H, HD, device="cpu")
    got, back = attention.attn_decode(
        {n: torch.tensor(a) for n, a in params.items()}, torch.tensor(x),
        cache, memory=torch.tensor(memory), **kw)
    _close(got, want, rtol=1e-5, atol=1e-6)
    assert back is cache and int(back.idx) == 0 and not back.k.any()


def test_attn_decode_writes_in_place_and_advances_idx_on_the_device():
    params, x, k, v, idx, ring, _ = _attn_setup(2, 8, 3, False)
    cache = _port_cache(k, v, idx, ring)
    k_before = cache.k.clone()
    out, new = attention.attn_decode(
        {n: torch.tensor(a) for n, a in params.items()}, torch.tensor(x),
        cache, n_heads=H, n_kv_heads=KV, head_dim=HD)
    assert new.k is cache.k and new.v is cache.v          # the same storage
    assert not torch.equal(cache.k[:, 3], k_before[:, 3])  # slot 3 written
    rest = [i for i in range(8) if i != 3]
    assert torch.equal(cache.k[:, rest], k_before[:, rest])
    assert isinstance(new.idx, torch.Tensor) and new.idx.dtype == torch.int32
    assert new.idx.device == cache.k.device and int(new.idx) == 4
    assert int(cache.idx) == 3                              # not mutated


# -- decode_step --------------------------------------------------------------


def _both_caches(cfg, ref_cfg, batch, s_cache):
    return (init_cache(cfg, batch, s_cache, torch.float32, device="cpu"),
            ref_init_cache(ref_cfg, batch, s_cache, jnp.float32))


DECODE_CASES = {
    # name: (arch, overrides, s_cache, bias_seed)
    "smollm": ("smollm-135m", {}, 12, None),
    "qwen2_bias": ("qwen2-0.5b", {}, 12, 3),
    "ring_wraps": ("smollm-135m", {"sliding_window": 4}, 10, None),
    "phi3": ("phi3-medium-14b", {}, 11, None),
    "deepseek_mla_moe": ("deepseek-v2-lite-16b", {}, 12, None),
    "deepseek_clamped": ("deepseek-v2-lite-16b", {}, 8, None),
    "moonshot_moe": ("moonshot-v1-16b-a3b", {}, 12, None),
    "granite_moe_tied": ("granite-moe-3b-a800m", {}, 11, None),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_step_matches_reference(case):
    arch, over, s_cache, bias_seed = DECODE_CASES[case]
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch), **over)
    params_np = _ref_params(ref_cfg, bias_seed=bias_seed)
    params = params_from_jax(params_np)
    toks = _tokens(cfg, (2, 10))
    caches, ref_caches = _both_caches(cfg, ref_cfg, 2, s_cache)
    assert [getattr(c, "ring", None) for c in caches] == \
        [getattr(c, "ring", None) for c in ref_caches]
    if case == "ring_wraps":
        assert caches[0].ring and caches[0].k.shape[1] == 4
    for t in range(10):
        want, ref_caches = ref_decode_step(
            params_np, ref_cfg, jnp.asarray(toks[:, t:t + 1]), ref_caches,
            compute_dtype=jnp.float32)
        got, caches = decode_step(params, cfg, torch.tensor(toks[:, t:t + 1]),
                                  caches, compute_dtype=torch.float32)
        _close(got, want, err_msg=f"{case} logits at step {t}", **F32)
        for c, w in zip(caches, ref_caches):
            assert c._fields == w._fields
            for name in c._fields:
                if name not in ("idx", "ring"):
                    _close(getattr(c, name), getattr(w, name),
                           err_msg=f"{case} {name} at step {t}", **F32)
            assert int(c.idx) == int(w.idx) == t + 1


def _consistency(cfg, steps=6, atol=2e-3):
    params = init_model(cfg, 0)
    toks = torch.tensor(_tokens(cfg, (2, steps), seed=2))
    full, _ = forward(params, cfg, toks, compute_dtype=torch.float32)
    caches = init_cache(cfg, 2, steps + 2, torch.float32, device="cpu")
    for t in range(steps):
        lg, caches = decode_step(params, cfg, toks[:, t:t + 1], caches,
                                 compute_dtype=torch.float32)
        np.testing.assert_allclose(
            lg[:, 0].numpy(), full[:, t].numpy(), rtol=5e-3, atol=atol,
            err_msg=f"{cfg.name} decode diverges at step {t}")


def test_dense_gqa():
    cfg = configs.get_smoke_config("qwen2-0.5b")
    cfg = dataclasses.replace(cfg, name="d", n_layers=2, d_model=32,
                              n_heads=4, n_kv_heads=2, d_ff=64,
                              vocab_size=61, attn_bias=True, remat=False)
    _consistency(cfg)


def test_mla():
    """The twin of the reference's ``TestDecodeConsistency.test_mla``."""
    cfg = dataclasses.replace(
        configs.get_smoke_config("deepseek-v2-lite-16b"), name="m",
        arch_type="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
        d_ff=64, vocab_size=61, head_dim=0,
        mla=MLAConfig(kv_lora_rank=16, qk_nope_head_dim=8,
                      qk_rope_head_dim=4, v_head_dim=8), moe=None,
        remat=False)
    _consistency(cfg)


def test_moe():
    """The twin of the reference's ``TestDecodeConsistency.test_moe``."""
    cfg = dataclasses.replace(
        configs.get_smoke_config("smollm-135m"), name="e", arch_type="moe",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab_size=61, head_dim=0, tie_embeddings=False,
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=1, d_expert=16),
        remat=False)
    _consistency(cfg)


@pytest.mark.parametrize("arch", MOE)
def test_moe_archs_decode_like_their_forward(arch):
    cfg = dataclasses.replace(configs.get_smoke_config(arch), remat=False)
    _consistency(cfg, steps=8)


def test_sliding_ring_buffer_matches_full():
    """Ring-buffer decode == the windowed forward, past the window."""
    cfg = dataclasses.replace(configs.get_smoke_config("smollm-135m"),
                              name="r", n_layers=1, d_model=32, n_heads=2,
                              n_kv_heads=2, d_ff=64, vocab_size=61,
                              sliding_window=4, remat=False)
    params = init_model(cfg, 0)
    toks = torch.tensor(_tokens(cfg, (1, 10), seed=4))
    ref_logits, _ = forward(params, cfg, toks, compute_dtype=torch.float32)
    caches = init_cache(cfg, 1, 10, torch.float32, device="cpu")
    assert caches[0].k.shape[1] == 4 and caches[0].ring
    for t in range(10):
        lg, caches = decode_step(params, cfg, toks[:, t:t + 1], caches,
                                 compute_dtype=torch.float32)
        np.testing.assert_allclose(lg[:, 0].numpy(), ref_logits[:, t].numpy(),
                                   rtol=5e-3, atol=2e-3, err_msg=f"step {t}")


# -- launch/serve.py ----------------------------------------------------------


def _serve_setup(arch="qwen2-0.5b", dtype="f32"):
    cfg = configs.get_smoke_config(arch)
    ref_cfg = ref_configs.get_smoke_config(arch)
    params_np = _ref_params(ref_cfg, bias_seed=5)
    dt = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    return cfg, ref_cfg, params_np, params_from_jax(params_np), dt


def _ref_mesh():
    return ref_mesh.make_debug_mesh(data=1, model=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_step_matches_reference(dtype):
    _check_prefill("qwen2-0.5b", dtype)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_prefill_step_matches_reference(arch, dtype):
    _check_prefill(arch, dtype)


def _check_prefill(arch, dtype):
    cfg, ref_cfg, params_np, params, (dt, ref_dt) = _serve_setup(arch, dtype)
    toks = _tokens(cfg, (2, 16))
    want = ref_serve.make_prefill_step(ref_cfg, _ref_mesh(), ref_dt)(
        params_np, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(cfg, make_debug_mesh(data=1, model=1), dt,
                            device="cpu")(params, {"tokens": toks})
    assert tuple(got.shape) == tuple(want.shape) == (2, 1, cfg.vocab_size)
    assert got.dtype == dt
    want = np.asarray(want, np.float32)
    tol = F32 if dtype == "f32" else dict(rtol=0,
                                          atol=0.05 * np.abs(want).max())
    _close(got.float(), want, **tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_step_entry_matches_reference(dtype):
    _check_decode_entry("qwen2-0.5b", dtype)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_decode_step_entry_matches_reference(arch, dtype):
    _check_decode_entry(arch, dtype)


def _check_decode_entry(arch, dtype):
    cfg, ref_cfg, params_np, params, (dt, ref_dt) = _serve_setup(arch, dtype)
    toks = _tokens(cfg, (2, 6))
    ref_step = ref_serve.make_decode_step(ref_cfg, _ref_mesh(), ref_dt)
    step = make_decode_step(cfg, make_debug_mesh(data=1, model=1), dt,
                            device="cpu")
    caches = init_cache(cfg, 2, 8, dt, device="cpu")
    ref_caches = ref_init_cache(ref_cfg, 2, 8, ref_dt)
    for t in range(6):
        want, ref_caches = ref_step(params_np, jnp.asarray(toks[:, t:t + 1]),
                                    ref_caches)
        got, caches = step(params, toks[:, t:t + 1], caches)
        want = np.asarray(want, np.float32)
        tol = F32 if dtype == "f32" else dict(
            rtol=0, atol=0.05 * np.abs(want).max())
        _close(got.float(), want, err_msg=f"step {t}", **tol)
        if dtype == "f32":
            for c, w in zip(caches, ref_caches):
                for name in c._fields:
                    if name not in ("idx", "ring"):
                        _close(getattr(c, name), getattr(w, name), **F32)
    assert caches[0][0].dtype == dt


def test_every_cache_mode_gives_the_same_values():
    cfg, _, _, params, _ = _serve_setup("smollm-135m")
    toks = torch.tensor(_tokens(cfg, (2, 5)))
    mesh = make_debug_mesh(data=1, model=1)
    runs = []
    for mode in CACHE_MODES:
        step = make_decode_step(cfg, mesh, torch.float32, cache_mode=mode,
                                device="cpu")
        caches = init_cache(cfg, 2, 6, torch.float32, device="cpu")
        logits = []
        for t in range(5):
            lg, caches = step(params, toks[:, t:t + 1], caches)
            logits.append(lg)
        runs.append((torch.cat(logits, 1), caches))
    for logits, caches in runs[1:]:
        assert torch.equal(logits, runs[0][0])
        for c, w in zip(caches, runs[0][1]):
            assert torch.equal(c.k, w.k) and torch.equal(c.v, w.v)
    with pytest.raises(ValueError, match="cache_mode"):
        make_decode_step(cfg, mesh, cache_mode="rows", device="cpu")


@pytest.mark.parametrize("make", [make_prefill_step, make_decode_step])
def test_tensor_parallel_mesh_raises(make):
    cfg = configs.get_smoke_config("smollm-135m")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        make(cfg, make_debug_mesh(data=1, model=2), device="cpu")


def test_prefill_skips_remat_under_inference_and_is_bitwise_the_same():
    cfg, _, _, params, _ = _serve_setup("smollm-135m")
    toks = _tokens(cfg, (2, 12))
    mesh = make_debug_mesh(data=1, model=1)
    outs = [make_prefill_step(dataclasses.replace(cfg, remat=remat), mesh,
                              torch.float32, device="cpu")(
                params, {"tokens": toks}) for remat in (True, False)]
    assert torch.equal(outs[0], outs[1])


def test_decode_entry_writes_caches_in_place():
    cfg, _, _, params, _ = _serve_setup("smollm-135m")
    step = make_decode_step(cfg, make_debug_mesh(data=1, model=1),
                            torch.float32, device="cpu")
    caches = init_cache(cfg, 2, 4, torch.float32, device="cpu")
    ks = [c.k for c in caches]
    _, new = step(params, _tokens(cfg, (2, 1)), caches)
    assert all(c.k is k for c, k in zip(new, ks))
    assert all(c.k[:, 0].any() and not c.k[:, 1:].any() for c in new)
    assert [int(c.idx) for c in new] == [1] * cfg.n_layers
