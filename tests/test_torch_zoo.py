"""Port parity of the rest of the model zoo: the SSD arch (``mamba2-370m``),
the RG-LRU hybrid (``recurrentgemma-2b``), the encoder-decoder
(``whisper-medium``: ``encode_frames`` and cross-attention) and the VLM
(``internvl2-2b``: the prefix projector), whole models at their smoke
configs, with the reference's initial parameters handed over through
``params_from_jax``.

* ``forward`` (logits) and ``lm_loss`` with its gradient at the
  tolerances of ``test_torch_lm_models.py``: at fp32 the loss within rtol
  1e-6, logits and every gradient within 1e-4 of their largest magnitude;
  at bf16 the loss within rtol 1e-3, logits within 0.05 and gradients
  within 0.1 (bf16 keeps 8 bits).  whisper takes ``frames``, internvl a
  ``prefix``, whose loss covers the text tokens only.
* ``param_count()`` is the sum of the leaves' sizes; the leaf order and
  key paths are ``jax.tree.flatten``'s (``encoder``, ``prefix_proj``, a
  decoder block's ``cross`` and ``norm_x``, an SSD block's ``mix`` and
  ``norm1`` only).
* The port's teacher-forced ``decode_step`` against its ``forward``, at
  the reference's own tolerances (``tests/test_models.py``): rtol 5e-3,
  atol 5e-3 for the SSD and 2e-3 otherwise; whisper decodes against the
  memory of ``encode_frames``.
* 8 decode steps against the reference's ``decode_step``: logits within
  1e-5 of the largest logit, every cache field within 1e-5 of its
  largest magnitude.
* ``init_cache`` of the full configs: the shapes and dtypes of the
  reference's, and the same bytes at ``long_500k``'s length as at
  ``decode_32k``'s for the SSD and the hybrid (recurrent states, rings of
  the window).
* Every arch of ``ARCH_IDS`` inits, runs ``forward``, ``lm_loss``,
  ``init_cache`` and ``decode_step`` at its smoke config.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import lm_loss as ref_lm_loss
from repro_torch import configs
from repro_torch.core.compression import tree_leaves
from repro_torch.models import (decode_step, encode_frames, forward,
                                init_cache, init_model, lm_loss)
from test_torch_lm_models import (B, DTYPES, S, TOL, _close_to_max,
                                  _key_paths, _port_params, _ref_params,
                                  _tokens)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ZOO = ("mamba2-370m", "recurrentgemma-2b", "whisper-medium", "internvl2-2b")
RECURRENT = ("mamba2-370m", "recurrentgemma-2b")


def _extra(cfg, seed=3, b=B):
    """The arch's extra inputs as numpy: ``frames`` (b, F, d) for the
    encoder-decoder, ``prefix`` (b, P, d) for the VLM."""
    return {name: x.numpy() for name, x in
            configs.stand_in_inputs(cfg, b, scale=0.1, seed=seed).items()}


@functools.lru_cache(maxsize=None)
def _ref_run(arch, dtype):
    cfg = ref_configs.get_smoke_config(arch)
    toks, labels = _tokens(cfg)
    extra = _extra(cfg)
    jdt = DTYPES[dtype][1]

    def f(p):
        loss = ref_lm_loss(p, cfg, toks, labels, compute_dtype=jdt, **extra)
        return loss, ref_forward(p, cfg, toks, compute_dtype=jdt, **extra)[0]

    (loss, logits), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        _ref_params(arch))
    return float(loss), np.asarray(logits, np.float32), [
        np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_run(arch, dtype):
    cfg = configs.get_smoke_config(arch)
    toks, labels = _tokens(cfg)
    extra = {k: torch.from_numpy(v) for k, v in _extra(cfg).items()}
    params = _port_params(arch)
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    dt = DTYPES[dtype][0]
    loss = lm_loss(params, cfg, torch.from_numpy(toks),
                   torch.from_numpy(labels), compute_dtype=dt, **extra)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        logits = forward(params, cfg, torch.from_numpy(toks),
                         compute_dtype=dt, **extra)[0]
    return float(loss.detach()), logits.to(torch.float32).numpy(), [
        g.numpy() for g in grads]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ZOO)
def test_forward_and_lm_loss_with_grads_match_reference(arch, dtype):
    loss_tol, logit_tol, grad_tol = TOL[dtype]
    want_loss, want_logits, want_grads = _ref_run(arch, dtype)
    loss, logits, grads = _port_run(arch, dtype)
    np.testing.assert_allclose(loss, want_loss, rtol=loss_tol)
    cfg = configs.get_smoke_config(arch)
    assert logits.shape == (B, cfg.n_prefix_tokens + S, cfg.vocab_size)
    _close_to_max(logits, want_logits, logit_tol)
    assert len(grads) == len(want_grads)
    for g, w in zip(grads, want_grads):
        assert np.isfinite(g).all()
        _close_to_max(g, w, grad_tol)


def test_prefix_loss_covers_the_text_tokens_only():
    """The VLM's loss is the text tokens' cross-entropy: the mean over S of
    the logits after the P prefix positions."""
    arch = "internvl2-2b"
    cfg = configs.get_smoke_config(arch)
    toks, labels = _tokens(cfg)
    prefix = torch.from_numpy(_extra(cfg)["prefix"])
    params = _port_params(arch)
    with torch.no_grad():
        logits, _ = forward(params, cfg, torch.from_numpy(toks),
                            prefix=prefix, compute_dtype=torch.float32)
        loss = lm_loss(params, cfg, torch.from_numpy(toks),
                       torch.from_numpy(labels), prefix=prefix,
                       compute_dtype=torch.float32)
    text = logits[:, cfg.n_prefix_tokens:].double()
    want = torch.nn.functional.cross_entropy(
        text.reshape(-1, cfg.vocab_size),
        torch.from_numpy(labels).long().reshape(-1))
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-6)


@pytest.mark.parametrize("arch", ZOO)
def test_param_count_is_the_sum_of_the_leaves(arch):
    cfg = configs.get_smoke_config(arch)
    mine = init_model(cfg, 0)
    assert sum(x.numel() for x in tree_leaves(mine)) == cfg.param_count()
    assert all(x.dtype == torch.float32 for x in tree_leaves(mine))


@pytest.mark.parametrize("arch", ZOO)
def test_params_from_jax_keep_the_reference_leaf_order(arch):
    cfg = configs.get_smoke_config(arch)
    ref = jax.tree_util.tree_flatten_with_path(_ref_params(arch))[0]
    port = _port_params(arch)
    mine = init_model(cfg, 0)
    want = [jax.tree_util.keystr(path) for path, _ in ref]
    assert _key_paths(port) == _key_paths(mine) == want
    assert all(np.array_equal(p.numpy(), np.asarray(r))
               for p, (_, r) in zip(tree_leaves(port), ref))
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [x.shape for _, x in ref]
    kinds = {cfg.layer_kind(i): sorted(mine["blocks"][i])
             for i in range(cfg.n_layers)}
    if arch == "mamba2-370m":
        assert kinds == {"ssd": ["mix", "norm1"]}
        assert sorted(mine["blocks"][0]["mix"]) == [
            "A_log", "D", "conv_w", "dt_bias", "norm_g", "w_in", "w_out"]
    if arch == "recurrentgemma-2b":
        assert kinds["rglru"] == ["mix", "mlp", "norm1", "norm2"]
        assert sorted(mine["blocks"][0]["mix"]) == [
            "conv_w", "lam", "w_a", "w_in", "w_out", "w_x"]
    if arch == "whisper-medium":
        assert kinds["attn"] == ["cross", "mix", "mlp", "norm1", "norm2",
                                 "norm_x"]
        assert sorted(mine["encoder"]) == ["blocks", "final_norm"]
        assert len(mine["encoder"]["blocks"]) == cfg.encoder.n_layers
    if arch == "internvl2-2b":
        assert tuple(mine["prefix_proj"].shape) == (cfg.d_model, cfg.d_model)
        assert mine["prefix_proj"].is_contiguous()


# -- decode -------------------------------------------------------------------


def _memory(params, cfg, dtype=torch.float32):
    if cfg.encoder is None:
        return None
    frames = torch.from_numpy(_extra(cfg)["frames"])
    return encode_frames(params, cfg, frames.to(dtype))


@pytest.mark.parametrize("arch", ZOO)
def test_decode_step_matches_forward(arch):
    """The twin of the reference's ``TestDecodeConsistency`` for each smoke
    config (the VLM's decode has no prefix: the reference's consistency
    test skips prefix decode too)."""
    cfg = configs.get_smoke_config(arch)
    params = init_model(cfg, 0)
    toks = torch.from_numpy(_tokens(cfg, 2)[0])       # two SSD chunks
    extra = {k: torch.from_numpy(v) for k, v in _extra(cfg).items()
             if k == "frames"}
    with torch.no_grad():
        full, _ = forward(params, cfg, toks, compute_dtype=torch.float32,
                          **extra)
        memory = _memory(params, cfg)
    atol = 5e-3 if arch == "mamba2-370m" else 2e-3
    caches = init_cache(cfg, B, S + 2, torch.float32, device="cpu")
    for t in range(S):
        lg, caches = decode_step(params, cfg, toks[:, t:t + 1], caches,
                                 memory=memory, compute_dtype=torch.float32)
        np.testing.assert_allclose(
            lg[:, 0].numpy(), full[:, t].numpy(), rtol=5e-3, atol=atol,
            err_msg=f"{arch} decode diverges at step {t}")


@pytest.mark.parametrize("arch", ZOO)
def test_decode_step_matches_reference(arch):
    cfg = configs.get_smoke_config(arch)
    ref_cfg = ref_configs.get_smoke_config(arch)
    params_np = jax.tree.map(np.asarray, _ref_params(arch))
    params = _port_params(arch)
    toks = _tokens(cfg, 4)[0][:, :8]
    memory = _memory(params, cfg)
    ref_memory = None
    if cfg.encoder is not None:
        ref_memory = jnp.asarray(memory.numpy())
    caches = init_cache(cfg, B, 8, torch.float32, device="cpu")
    ref_caches = ref_init_cache(ref_cfg, B, 8, jnp.float32)
    for t in range(8):
        want, ref_caches = ref_decode_step(
            params_np, ref_cfg, jnp.asarray(toks[:, t:t + 1]), ref_caches,
            memory=ref_memory, compute_dtype=jnp.float32)
        got, caches = decode_step(params, cfg, torch.from_numpy(
            toks[:, t:t + 1]), caches, memory=memory,
            compute_dtype=torch.float32)
        _close_to_max(got.numpy(), np.asarray(want), 1e-5)
        for c, w in zip(caches, ref_caches):
            assert c._fields == w._fields
            for name in c._fields:
                if name == "idx":
                    assert int(c.idx) == int(w.idx) == t + 1
                elif name != "ring":
                    _close_to_max(getattr(c, name).numpy(),
                                  np.asarray(getattr(w, name)), 1e-5)


def _cache_specs(caches):
    return [{f: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
             for f, x in zip(c._fields, c) if f != "ring"} for c in caches]


@pytest.mark.parametrize("arch", RECURRENT)
def test_long_500k_caches_are_the_size_of_decode_32k(arch):
    """The SSD and RG-LRU layers keep a fixed recurrent state; the hybrid's
    local layers a ring of the window: the same bytes at 524,288 positions
    as at 32,768, at decode_32k's batch of 128; the shapes and dtypes are
    the reference's."""
    batch = configs.INPUT_SHAPES["decode_32k"].global_batch
    sizes = {}
    for shape in ("decode_32k", "long_500k"):
        s = configs.INPUT_SHAPES[shape].seq_len
        cfg = configs.get_config(arch, shape)
        caches = init_cache(cfg, batch, s, device="meta")
        sizes[shape] = sum(x.numel() * x.element_size() for c in caches
                           for x in c if isinstance(x, torch.Tensor))
        want = jax.eval_shape(lambda: [
            {f: getattr(c, f) for f in c._fields if f != "ring"}
            for c in ref_init_cache(ref_configs.get_config(arch, shape),
                                    batch, s)])
        assert _cache_specs(caches) == [
            {f: (tuple(x.shape), str(x.dtype)) for f, x in c.items()}
            for c in want]
    assert sizes["long_500k"] == sizes["decode_32k"] > 0
    if arch == "recurrentgemma-2b":
        rings = [c for c in init_cache(configs.get_config(arch), 1, 524_288,
                                       device="meta") if hasattr(c, "ring")]
        assert rings and all(c.ring and c.k.shape[1] == 2048 for c in rings)


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_every_arch_inits_trains_and_serves(arch):
    """``init_model``, ``forward``, ``lm_loss`` (with the arch's extra
    inputs), ``init_cache`` and 3 ``decode_step`` calls at the smoke config:
    finite values of the expected shapes."""
    cfg = configs.get_smoke_config(arch)
    params = init_model(cfg, 0)
    toks, labels = (torch.from_numpy(t[:, :8]) for t in _tokens(cfg, 5))
    extra = {k: torch.from_numpy(v) for k, v in _extra(cfg).items()}
    with torch.no_grad():
        logits, aux = forward(params, cfg, toks, compute_dtype=torch.float32,
                              **extra)
        loss = lm_loss(params, cfg, toks, labels,
                       compute_dtype=torch.float32, **extra)
        memory = _memory(params, cfg)
        caches = init_cache(cfg, B, 4, torch.float32, device="cpu")
        for t in range(3):
            lg, caches = decode_step(params, cfg, toks[:, t:t + 1], caches,
                                     memory=memory,
                                     compute_dtype=torch.float32)
    assert logits.shape == (B, cfg.n_prefix_tokens + 8, cfg.vocab_size)
    assert lg.shape == (B, 1, cfg.vocab_size)
    assert all(bool(torch.isfinite(x).all()) for x in (logits, aux, loss, lg))
    assert len(caches) == cfg.n_layers
    assert all(int(c.idx) == 3 for c in caches)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_stand_in_inputs_follow_input_specs(arch):
    """``stand_in_inputs`` builds exactly the frames / prefix that
    ``input_specs`` names, in its shapes: zeros by default, seeded normals
    scaled by ``scale`` (frames drawn before prefix), nothing at decode."""
    cfg = configs.get_config(arch)
    specs = configs.input_specs(cfg, configs.InputShape("t", 16, 3,
                                                        "prefill"))
    names = [n for n in ("frames", "prefix") if n in specs]
    zeros = configs.stand_in_inputs(cfg, 3, kind="prefill")
    assert list(zeros) == names
    for n in names:
        assert tuple(zeros[n].shape) == specs[n].shape
        assert zeros[n].dtype == torch.float32 and not zeros[n].any()
    drawn = configs.stand_in_inputs(cfg, 3, scale=0.5, seed=4)
    rng = np.random.default_rng(4)
    for n in names:
        want = (0.5 * rng.standard_normal(specs[n].shape)).astype(np.float32)
        assert np.array_equal(drawn[n].numpy(), want)
    assert configs.stand_in_inputs(cfg, 3, kind="decode") == {}
