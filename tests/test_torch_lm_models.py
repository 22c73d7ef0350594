"""Port parity of the LM zoo's dense part: configs, layers, flash and
chunked attention, and the TransformerLM's forward and loss.

Held against the JAX package on numpy inputs made from a seed:

* ``ARCH_IDS``, every arch's full and smoke config (fields and
  ``param_count`` / ``active_param_count``) and the input specs' shapes.
* ``flash_attention``'s forward and its three gradients (``jax.vjp``) at
  fp32 within rtol 1e-5 of the largest value (causal, windowed, GQA, a
  chunk that does not divide S, cross attention with another v width);
  ``chunked_attention`` likewise.
* ``forward`` (logits) and ``lm_loss`` with its gradient for the smollm
  and qwen2 smoke configs (and phi3's at fp32), from the reference's
  initial parameters through ``params_from_jax``: at fp32 the loss within
  rtol 1e-6 and logits and every gradient within 1e-4 of their largest
  magnitude; at bf16 (the trainer's compute dtype) the loss within rtol
  1e-3, the logits within 0.05 and the gradients within 0.1 of their
  largest magnitude (bf16 carries 8 bits, and torch's and XLA's bf16
  matmuls round at different places).
* The same for the MoE family's smoke configs (deepseek: MLA and MoE;
  moonshot, granite: attention and MoE; the MoE aux loss in the loss) at
  fp32 and bf16 with the tolerances above; their parameter trees' leaf
  order and key paths are ``jax.tree.flatten``'s (a MoE block ``mix,
  moe, norm1, norm2``; its ``moe`` dict ``router, shared_i, w_down,
  w_gate, w_up``).
* remat on and off give bitwise equal gradients (also through MLA and the
  MoE dispatch); ``logit_chunk`` gives the reference's chunked loss; the
  leaf order of the parameter tree is the reference's.  The SSD, RG-LRU,
  encoder and prefix archs: ``tests/test_torch_zoo.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import attention as ref_attn
from repro.models import flash as ref_flash
from repro.models import forward as ref_forward
from repro.models import init_model as ref_init_model
from repro.models import lm_loss as ref_lm_loss
from repro_torch import configs
from repro_torch.core.compression import tree_leaves
from repro_torch.models import params_from_jax
from repro_torch.models import attention, flash
from repro_torch.models.transformer import forward, init_model, lm_loss

DENSE = ("smollm-135m", "qwen2-0.5b", "phi3-medium-14b")
MOE = ("deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "granite-moe-3b-a800m")


# -- configs ------------------------------------------------------------------


def test_arch_ids_match_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("which", ["full", "smoke", "long"])
def test_configs_match_reference(arch, which):
    get = {"full": lambda m, a: m.get_config(a),
           "smoke": lambda m, a: m.get_smoke_config(a),
           "long": lambda m, a: m.get_config(a, "long_500k")}[which]
    got, want = get(configs, arch), get(ref_configs, arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()
    assert [got.layer_kind(i) for i in range(got.n_layers)] == \
        [want.layer_kind(i) for i in range(want.n_layers)]
    for shape in ref_configs.INPUT_SHAPES:
        g = configs.input_specs(got, shape)
        w = ref_configs.input_specs(want, shape)
        assert {k: tuple(v.shape) for k, v in g.items()} == \
            {k: tuple(v.shape) for k, v in w.items()}


def test_smollm_full_width():
    cfg = configs.get_config("smollm-135m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings) == \
        (30, 576, 9, 3, 1536, 49152, True)
    assert cfg.param_count() == 134_515_008


# -- attention ----------------------------------------------------------------

ATTN_CASES = {
    # name: (B, Sq, Skv, H, KV, hd, hdv, causal, window, chunk)
    "causal_gqa": (2, 12, 12, 4, 2, 8, 8, True, 0, 4),
    "window_ragged_chunk": (2, 13, 13, 6, 3, 8, 8, True, 5, 4),
    "mha_one_chunk": (1, 9, 9, 2, 2, 16, 16, True, 0, 1024),
    "cross_other_v_width": (2, 7, 11, 4, 1, 8, 12, False, 0, 3),
}


def _attn_inputs(case, seed=0):
    b, sq, skv, h, kv, hd, hdv = ATTN_CASES[case][:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, hdv)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, hdv)).astype(np.float32)
    return q, k, v, do


def _close_to_max(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_flash_attention_forward_and_grads(case):
    q, k, v, do = _attn_inputs(case)
    causal, window, chunk = ATTN_CASES[case][7:]
    out, vjp = jax.vjp(lambda a, b, c: ref_flash.flash_attention(
        a, b, c, causal, window, chunk), q, k, v)
    want = (out,) + vjp(jnp.asarray(do))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got = flash.flash_attention(*ts, causal, window, chunk)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(do))
    for g, w in zip((got,) + grads, want):
        _close_to_max(g.detach().numpy(), w, 1e-5)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_forward_and_grads(case):
    q, k, v, do = _attn_inputs(case, 1)
    causal, window, chunk = ATTN_CASES[case][7:]
    out, vjp = jax.vjp(lambda a, b, c: ref_attn.chunked_attention(
        a, b, c, causal=causal, window=window, chunk=chunk), q, k, v)
    want = (out,) + vjp(jnp.asarray(do))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got = attention.chunked_attention(*ts, causal=causal, window=window,
                                      chunk=chunk)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(do))
    for g, w in zip((got,) + grads, want):
        _close_to_max(g.detach().numpy(), w, 1e-5)


def test_flash_and_chunked_agree():
    q, k, v, _ = _attn_inputs("window_ragged_chunk", 2)
    ts = [torch.from_numpy(x) for x in (q, k, v)]
    _close_to_max(flash.flash_attention(*ts, True, 5, 4).numpy(),
                  attention.chunked_attention(*ts, causal=True, window=5,
                                              chunk=4).numpy(), 1e-6)


# -- the TransformerLM -----------------------------------------------------------

B, S = 2, 16
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16,
                                                        jnp.bfloat16)}
# (loss rtol, logits and gradients: fraction of their largest magnitude)
TOL = {"fp32": (1e-6, 1e-4, 1e-4), "bf16": (1e-3, 0.05, 0.1)}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_init_model(ref_configs.get_smoke_config(arch),
                          jax.random.PRNGKey(0))


def _tokens(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _ref_loss_grads(arch, dtype):
    cfg = ref_configs.get_smoke_config(arch)
    toks, labels = _tokens(cfg)
    jdt = DTYPES[dtype][1]

    def f(p):
        loss = ref_lm_loss(p, cfg, toks, labels, compute_dtype=jdt)
        return loss, ref_forward(p, cfg, toks, compute_dtype=jdt)[0]

    (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        _ref_params(arch))
    return float(loss), np.asarray(logits, np.float32), [
        np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_params(arch):
    return params_from_jax(jax.tree.map(np.asarray, _ref_params(arch)))


def _port_loss_grads(arch, dtype, cfg=None):
    cfg = cfg or configs.get_smoke_config(arch)
    toks, labels = _tokens(cfg)
    params = _port_params(arch)
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = lm_loss(params, cfg, torch.from_numpy(toks),
                   torch.from_numpy(labels), compute_dtype=DTYPES[dtype][0])
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        logits = forward(params, cfg, torch.from_numpy(toks),
                         compute_dtype=DTYPES[dtype][0])[0]
    return float(loss.detach()), logits.to(torch.float32).numpy(), [
        g.numpy() for g in grads]


def test_params_from_jax_keeps_the_reference_leaf_order():
    for arch in DENSE:
        ref = jax.tree.leaves(_ref_params(arch))
        port = tree_leaves(_port_params(arch))
        assert [tuple(x.shape) for x in port] == [x.shape for x in ref]
        assert all(np.array_equal(p.numpy(), np.asarray(r))
                   for p, r in zip(port, ref))
        mine = init_model(configs.get_smoke_config(arch), 0)
        assert [tuple(x.shape) for x in tree_leaves(mine)] == \
            [x.shape for x in ref]


@pytest.mark.parametrize("arch,dtype", [
    ("smollm-135m", "fp32"), ("smollm-135m", "bf16"), ("qwen2-0.5b", "fp32"),
    ("qwen2-0.5b", "bf16"), ("phi3-medium-14b", "fp32")] + [
    (arch, dtype) for arch in MOE for dtype in ("fp32", "bf16")])
def test_forward_and_lm_loss_with_grads_match_reference(arch, dtype):
    loss_tol, logit_tol, grad_tol = TOL[dtype]
    want_loss, want_logits, want_grads = _ref_loss_grads(arch, dtype)
    loss, logits, grads = _port_loss_grads(arch, dtype)
    np.testing.assert_allclose(loss, want_loss, rtol=loss_tol)
    _close_to_max(logits, want_logits, logit_tol)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        _close_to_max(g, w, grad_tol)


def _key_paths(tree, prefix=""):
    """``jax.tree_util.keystr`` of each leaf of a port tree, in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _key_paths(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _key_paths(v, f"{prefix}[{i}]")]
    return [prefix]


@pytest.mark.parametrize("arch", MOE)
def test_moe_params_from_jax_keep_the_reference_leaf_order(arch):
    cfg = configs.get_smoke_config(arch)
    ref = jax.tree_util.tree_flatten_with_path(_ref_params(arch))[0]
    port = _port_params(arch)
    mine = init_model(cfg, 0)
    want = [jax.tree_util.keystr(path) for path, _ in ref]
    assert _key_paths(port) == _key_paths(mine) == want
    leaves = tree_leaves(port)
    assert all(np.array_equal(p.numpy(), np.asarray(r))
               for p, (_, r) in zip(leaves, ref))
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [x.shape for _, x in ref]
    assert sum(x.numel() for x in leaves) == cfg.param_count()
    # a MoE block: mix, moe, norm1, norm2; its moe dict router, shared_i,
    # w_down, w_gate, w_up
    blk = cfg.moe.first_dense
    assert list(sorted(port["blocks"][blk])) == ["mix", "moe", "norm1",
                                                 "norm2"]
    assert list(sorted(port["blocks"][blk]["moe"])) == (
        ["router"] + [f"shared_{i}" for i in range(cfg.moe.n_shared)]
        + ["w_down", "w_gate", "w_up"])


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b"])
def test_remat_gives_the_same_gradients_for(arch):
    cfg = configs.get_smoke_config(arch)
    on = _port_loss_grads(arch, "fp32", dataclasses.replace(cfg, remat=True))
    off = _port_loss_grads(arch, "fp32",
                           dataclasses.replace(cfg, remat=False))
    assert on[0] == off[0]
    assert all(np.array_equal(a, b) for a, b in zip(on[2], off[2]))


def test_remat_gives_the_same_gradients():
    cfg = configs.get_smoke_config("smollm-135m")
    on = _port_loss_grads("smollm-135m", "fp32",
                          dataclasses.replace(cfg, remat=True))
    off = _port_loss_grads("smollm-135m", "fp32",
                           dataclasses.replace(cfg, remat=False))
    assert on[0] == off[0]
    assert all(np.array_equal(a, b) for a, b in zip(on[2], off[2]))


def test_logit_chunk_matches_reference():
    arch = "qwen2-0.5b"
    cfg = dataclasses.replace(configs.get_smoke_config(arch), logit_chunk=4)
    ref_cfg = dataclasses.replace(ref_configs.get_smoke_config(arch),
                                  logit_chunk=4)
    toks, labels = _tokens(cfg, 1)
    want = float(ref_lm_loss(_ref_params(arch), ref_cfg, toks, labels,
                             compute_dtype=jnp.float32))
    got = float(lm_loss(_port_params(arch), cfg, torch.from_numpy(toks),
                        torch.from_numpy(labels),
                        compute_dtype=torch.float32))
    whole = float(lm_loss(_port_params(arch), configs.get_smoke_config(arch),
                          torch.from_numpy(toks), torch.from_numpy(labels),
                          compute_dtype=torch.float32))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, whole, rtol=1e-6)
