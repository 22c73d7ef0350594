"""Port parity of the rest of the model zoo through the entry points: the
mesh trainer (``launch/train.py``), the serve steps (``launch/serve.py``)
and the pytree checkpoint, for ``mamba2-370m`` (SSD), ``recurrentgemma-2b``
(RG-LRU and local attention), ``whisper-medium`` (encoder and
cross-attention) and ``internvl2-2b`` (prefix), at their smoke configs.

* 3 lock-step single-client STC steps against the reference's
  ``make_train_step`` for the SSD and the hybrid (the helper and
  tolerances of ``test_torch_mesh_train.py``: every state entry within
  1e-6 absolute, the loss within rtol 1e-5, ``nnz`` exact), on a batch of
  4 x 32 (four SSD chunks).
* Two gloo client ranks on the CPU (``tests/_torch_mesh_worker.py``):
  whisper's ``frames`` and internvl's ``prefix`` split by rows with the
  tokens; the baseline step's parameters are ``p − lr·mean`` of the two
  row blocks' gradients, within 1e-4 of the step and 2 ulps of the
  parameters (the trainer adds in another order).
* The train CLI (``--device cpu --steps 2``) for each of the four archs.
* ``make_prefill_step`` with the arch's ``prefix`` / ``frames`` against
  the reference's at fp32 (rtol 1e-5 / atol 1e-5) and bf16 (0.05 of the
  largest logit); ``make_decode_step`` over 6 steps at fp32 (logits and
  every cache field within rtol 1e-5 / atol 1e-5), whisper against the
  memory of ``encode_frames``; at bf16 the logits within 0.05 of the
  largest and the states kept fp32.
* ``save_checkpoint`` / ``restore_checkpoint`` of each new parameter
  tree: bitwise, the treedef string JAX's, and the reference restores the
  port's file bitwise; the caches are NamedTuples, which the pytree
  checkpoint refuses as it refuses ``KVCache``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import msgpack_ckpt as ref_ckpt
from repro.launch import mesh as ref_mesh
from repro.launch import serve as ref_serve
from repro.models import encode_frames as ref_encode_frames
from repro.models import init_cache as ref_init_cache
from repro.models import init_model as ref_init_model
from repro_torch import configs
from repro_torch.checkpoint import (msgpack_ckpt, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.compression import tree_leaves
from repro_torch.launch import train as port_train
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import make_decode_step, make_prefill_step
from repro_torch.models import (encode_frames, init_cache, init_model,
                                lm_loss, params_from_jax)
from test_torch_mesh_train import LOCKSTEP, _lockstep, _run_worker
from test_torch_serve import F32, _check_decode_entry, _close, _serve_setup
from test_torch_zoo import RECURRENT, ZOO, _extra

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


# -- the mesh trainer ---------------------------------------------------------


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_archs_single_client_lockstep_with_reference(arch):
    pstate, pm = _lockstep(arch, LOCKSTEP["stc"])
    assert int(pstate["step"]) == 3
    cfg = configs.get_smoke_config(arch)
    assert int(pm["nnz_up"]) >= int(cfg.param_count() / 50)
    assert tuple(pstate["client_res"]["blocks"][0]["mix"]["w_in"].shape)[0] \
        == 1


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-2b"])
def test_two_ranks_split_frames_and_prefix_with_the_tokens(arch, tmp_path):
    cfg = configs.get_smoke_config(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    extra = {k: torch.from_numpy(v) for k, v in _extra(cfg, b=4).items()}
    params = init_model(cfg, 0)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, 1)), **extra}
    lr = 0.1
    outs = _run_worker("step", {
        "arch": arch, "params": params, "batch": batch,
        "jobs": [(dict(protocol="baseline", lr=lr), None, None, {})]},
        tmp_path)
    grads = []
    for rows in (slice(0, 2), slice(2, 4)):
        leaves = [x.clone().requires_grad_(True) for x in tree_leaves(params)]
        tree = port_train._rebuild(params, iter(leaves))
        loss = lm_loss(tree, cfg, batch["tokens"][rows],
                       batch["labels"][rows], compute_dtype=torch.float32,
                       **{k: v[rows] for k, v in extra.items()})
        grads.append(torch.autograd.grad(loss, leaves))
    want = [p - lr * (a + b) / 2 for p, a, b in zip(tree_leaves(params),
                                                     *grads)]
    # rows split wrongly would move a leaf by the order of its step; the
    # trainer's own order of adds leaves 2 ulps of the parameters
    ulp = torch.finfo(torch.float32).eps
    for rank, out in enumerate(outs):
        got = tree_leaves(out[0][0]["params"])
        for g, w, p in zip(got, want, tree_leaves(params)):
            tol = (1e-4 * float((w - p).abs().max())
                   + 2 * ulp * float(p.abs().max()))
            assert float((g - w).abs().max()) <= tol, rank


@pytest.mark.parametrize("arch", ZOO)
def test_train_cli_runs_each_arch(arch, capsys):
    port_train.main(["--device", "cpu", "--steps", "2", "--arch", arch])
    out = capsys.readouterr().out
    assert out.count("step ") == 2 and "nnz_up" in out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert all(np.isfinite(losses))


# -- launch/serve.py ----------------------------------------------------------


def _ref_mesh():
    return ref_mesh.make_debug_mesh(data=1, model=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", ZOO)
def test_prefill_step_with_the_arch_inputs_matches_reference(arch, dtype):
    cfg, ref_cfg, params_np, params, (dt, ref_dt) = _serve_setup(arch, dtype)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)
    extra = _extra(cfg)
    want = ref_serve.make_prefill_step(ref_cfg, _ref_mesh(), ref_dt)(
        params_np, {"tokens": jnp.asarray(toks),
                    **{k: jnp.asarray(v) for k, v in extra.items()}})
    got = make_prefill_step(cfg, make_debug_mesh(data=1, model=1), dt,
                            device="cpu")(params, {"tokens": toks, **extra})
    assert tuple(got.shape) == tuple(want.shape) == (2, 1, cfg.vocab_size)
    assert got.dtype == dt
    want = np.asarray(want, np.float32)
    tol = F32 if dtype == "f32" else dict(rtol=0,
                                          atol=0.05 * np.abs(want).max())
    _close(got.float(), want, **tol)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b",
                                  "internvl2-2b"])
def test_decode_step_entry_matches_reference(arch):
    _check_decode_entry(arch, "f32")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_whisper_decode_entry_with_memory_matches_reference(dtype):
    arch = "whisper-medium"
    cfg, ref_cfg, params_np, params, (dt, ref_dt) = _serve_setup(arch, dtype)
    frames = _extra(cfg)["frames"]
    memory = encode_frames(params, cfg, torch.from_numpy(frames).to(dt))
    ref_memory = ref_encode_frames(params_np, ref_cfg,
                                   jnp.asarray(frames, ref_dt))
    _close(memory.float(), np.asarray(ref_memory, np.float32),
           **(F32 if dtype == "f32" else dict(rtol=0, atol=0.05)))
    _decode_entry(arch, dtype, memory, ref_memory)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_entry_at_bf16_matches_reference(arch):
    _decode_entry(arch, "bf16")


def _decode_entry(arch, dtype, memory=None, ref_memory=None):
    cfg, ref_cfg, params_np, params, (dt, ref_dt) = _serve_setup(arch, dtype)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    ref_step = ref_serve.make_decode_step(ref_cfg, _ref_mesh(), ref_dt)
    step = make_decode_step(cfg, make_debug_mesh(data=1, model=1), dt,
                            device="cpu")
    caches = init_cache(cfg, 2, 8, dt, device="cpu")
    ref_caches = ref_init_cache(ref_cfg, 2, 8, ref_dt)
    for t in range(6):
        want, ref_caches = ref_step(params_np, jnp.asarray(toks[:, t:t + 1]),
                                    ref_caches, memory=ref_memory)
        got, caches = step(params, toks[:, t:t + 1], caches, memory=memory)
        want = np.asarray(want, np.float32)
        tol = F32 if dtype == "f32" else dict(
            rtol=0, atol=0.05 * np.abs(want).max())
        _close(got.float(), want, err_msg=f"step {t}", **tol)
        if dtype == "f32":
            for c, w in zip(caches, ref_caches):
                for name in c._fields:
                    if name not in ("idx", "ring"):
                        _close(getattr(c, name), getattr(w, name), **F32)
    for c, w in zip(caches, ref_caches):
        for name in c._fields:
            if name not in ("idx", "ring"):      # states fp32, as XLA's
                assert str(getattr(c, name).dtype).replace("torch.", "") == \
                    str(getattr(w, name).dtype)


# -- checkpoint ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_new_parameter_trees_checkpoint_bitwise_both_ways(arch, tmp_path):
    pytest.importorskip("msgpack")
    tree = init_model(configs.get_smoke_config(arch), 0)
    ref = ref_init_model(ref_configs.get_smoke_config(arch),
                         jax.random.PRNGKey(0))
    leaves, treedef = msgpack_ckpt._tree_flatten(tree)
    assert treedef == str(jax.tree.flatten(ref)[1])
    path = str(tmp_path / "p.ck")
    save_checkpoint(path, tree)
    back = restore_checkpoint(path, tree)
    for g, w in zip(tree_leaves(back), leaves):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.int32),
                                                  w.view(torch.int32))
    in_ref = jax.tree.leaves(ref_ckpt.restore_checkpoint(path, ref))
    assert [np.asarray(x).tobytes() for x in in_ref] == \
        [x.numpy().tobytes() for x in leaves]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_caches_are_refused_like_kv_caches(arch, tmp_path):
    caches = init_cache(configs.get_smoke_config(arch), 1, 4, device="cpu")
    with pytest.raises(TypeError, match="Cache"):
        save_checkpoint(str(tmp_path / "c.ck"), caches)


def test_params_from_jax_carries_every_new_leaf():
    for arch in ZOO:
        ref = ref_init_model(ref_configs.get_smoke_config(arch),
                             jax.random.PRNGKey(1))
        port = params_from_jax(jax.tree.map(np.asarray, ref))
        assert sum(x.numel() for x in tree_leaves(port)) == \
            configs.get_smoke_config(arch).param_count()
