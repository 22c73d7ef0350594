"""Port parity of the MoE family under tensor parallelism: a mesh
``model`` axis of 2 over two gloo ranks on the CPU
(``tests/_torch_mesh_worker.py``, one spawn of the cases ``tp_moe``,
``tp_step`` and ``tp_serve``), on the smoke configs of
``granite-moe-3b-a800m`` (4 experts top-2, no shared expert) and
``moonshot-v1-16b-a3b`` (a dense first layer, then 4 experts top-2 and one
shared expert), ``d_expert`` 64 split 32 a rank, from the reference's
initial parameters through ``params_from_jax``, at fp32.

* The MoE block alone on the rank's blocks of the experts, both
  dispatches: output, aux loss and the gradients of ``x`` and of every
  leaf (the ranks' blocks joined) against the unsplit block within 1e-6
  of the largest; both ranks' outputs and ``x`` gradients bitwise equal;
  the expert choices equal.
* The step on ``make_debug_mesh(1, 2)`` against the port's ``model = 1``
  step (STC p = 1/50 both ways): loss within rtol 1e-5, ``nnz`` exact,
  every state entry within 1e-6; the replicated leaves (router, norms)
  bitwise equal on the ranks after every step; every MoE layer's expert
  choices bitwise equal on the ranks, and equal to the ``model = 1``
  step's wherever the k-th and (k+1)-th router probabilities lie more
  than 1e-6 apart.  Granite on both dispatches, Moonshot on the ragged
  one, and Granite with ``d_expert`` 63, which does not split two ways:
  ``fit_spec`` keeps the experts whole and the block runs replicated.
* The ragged steps against the reference's own tensor-parallel step on
  ``make_debug_mesh(1, 2)``, run in a subprocess with two host devices
  (GSPMD splits its ``ragged_dot`` s; the same tolerances).
* One more step of each job under ``FlopCounterMode`` and with what it
  hands gloo counted: equal to the dry run's ``flops`` and
  ``tp_collectives`` (remat on in bf16 for both archs, whose recompute
  re-issues no MoE collective; the gates' gradient sum in fp32).
* Serving on two ranks: the prefill of a 16-token prompt and 24
  teacher-forced decode steps against the port's ``model = 1`` steps and
  the reference's on ``make_debug_mesh(1, 2)``, within rtol 1e-5 of the
  largest |logit|, both ranks' logits bitwise equal; the caches at their
  stand-ins' bytes; what a bf16 prefill and decode step hand gloo equal
  to the dry run's ``tp_serve_collectives``.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.launch.train import TrainConfig as RefTrainConfig
from repro.launch.train import init_train_state as ref_init_state
from repro_torch.configs import InputShape, get_smoke_config
from repro_torch.core.compression import tree_leaves
from repro_torch.data import make_lm_tokens
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import (make_decode_step, make_prefill_step,
                                      serve_state_structs)
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step)
from repro_torch.models import init_cache, params_from_jax
from repro_torch.models.moe import moe_apply, route
from repro_torch.sharding.rules import model_dim, param_specs
from _torch_mesh_worker import RouterCalls, _moe_leaves, _moe_tree

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")
GRANITE, MOONSHOT = "granite-moe-3b-a800m", "moonshot-v1-16b-a3b"
ARCHS = (GRANITE, MOONSHOT)
B, S = 4, 32
PROMPT, TAIL = 16, 8
STEPS = 2
STC = dict(protocol="stc", lr=0.05, sparsity_up=1 / 50, sparsity_down=1 / 50)
WHOLE_EXPERTS = 63          # a d_expert that does not split two ways
# a router near-tie: choices are compared only where the k-th and the
# (k+1)-th probabilities lie further apart than this
NEAR_TIE = 1e-6


def _ref_cfg(arch, d_expert=None):
    cfg = ref_smoke(arch)
    if d_expert is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_expert=d_expert))
    return cfg


def _port_cfg(arch, d_expert=None, dispatch=None):
    cfg = get_smoke_config(arch)
    moe = cfg.moe
    if d_expert is not None:
        moe = dataclasses.replace(moe, d_expert=d_expert)
    if dispatch is not None:
        moe = dataclasses.replace(moe, dispatch=dispatch)
    return dataclasses.replace(cfg, moe=moe)


@functools.lru_cache(maxsize=None)
def _np_params(arch, d_expert=None):
    """The reference's initial parameters (its ``init_train_state``'s from
    ``PRNGKey(0)``) as numpy."""
    state = ref_init_state(_ref_cfg(arch, d_expert),
                           RefTrainConfig(compute_dtype=jnp.float32), 1,
                           jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state["params"])


@functools.lru_cache(maxsize=None)
def _tokens(arch):
    toks = make_lm_tokens(n_tokens=B * S + 1, vocab=ref_smoke(arch).vocab_size)
    return toks[:-1].reshape(B, S), toks[1:].reshape(B, S)


@functools.lru_cache(maxsize=None)
def _serve_tokens(arch):
    return np.random.default_rng(1).integers(
        0, ref_smoke(arch).vocab_size, (2, PROMPT + TAIL)).astype(np.int64)


def _batch(arch):
    toks, labels = _tokens(arch)
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


def _flat(tree):
    leaves = (jax.tree.leaves(tree) if isinstance(
        jax.tree.leaves(tree)[0], (jax.Array, np.ndarray))
        else tree_leaves(tree))
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


def _close_to_max(got, want, rtol):
    """Every entry within ``rtol`` of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def _block_input(arch):
    rng = np.random.default_rng(0)
    d = ref_smoke(arch).d_model
    return (torch.from_numpy(rng.standard_normal((2, 16, d), np.float32)),
            torch.from_numpy(rng.standard_normal((2, 16, d), np.float32)))


BLOCK_CASES = [(GRANITE, "ragged"), (GRANITE, "capacity"),
               (MOONSHOT, "ragged"), (MOONSHOT, "capacity")]

# the step's jobs on make_debug_mesh(1, 2), each counted once more:
# (arch, d_expert, dispatch, remat, compute dtype)
JOBS = {
    "granite": (GRANITE, None, None, False, torch.float32),
    "moonshot": (MOONSHOT, None, None, False, torch.float32),
    "granite_capacity": (GRANITE, None, "capacity", False, torch.float32),
    "granite_whole_experts": (GRANITE, WHOLE_EXPERTS, None, False,
                              torch.float32),
    "granite_remat_bf16": (GRANITE, None, None, True, torch.bfloat16),
    "moonshot_remat_bf16": (MOONSHOT, None, None, True, torch.bfloat16),
}
# the jobs held to the model = 1 step and the reference (fp32)
HELD = ("granite", "moonshot", "granite_capacity", "granite_whole_experts")


def _job_cfg(name):
    arch, d_expert, dispatch, remat, _ = JOBS[name]
    return dataclasses.replace(_port_cfg(arch, d_expert, dispatch),
                               remat=remat)


def _job_tc(name):
    return TrainConfig(**STC, compute_dtype=JOBS[name][4])


def _step_input():
    jobs = []
    for name, (arch, d_expert, _, _, dtype) in JOBS.items():
        cfg = _job_cfg(name)
        jobs.append(dict(arch=arch, cfg={"moe": cfg.moe, "remat": cfg.remat},
                         tc=dict(STC, compute_dtype=dtype), steps=STEPS,
                         params=params_from_jax(_np_params(arch, d_expert)),
                         batch=_batch(arch), count=True, choices=True))
    return {"arch": GRANITE, "params": None, "batch": None, "mesh": (1, 2),
            "jobs": jobs}


REF_MOE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.data import make_lm_tokens
from repro.launch.mesh import make_debug_mesh
from repro.launch.serve import make_decode_step, make_prefill_step
from repro.launch.train import TrainConfig, init_train_state, make_train_step
from repro.models import init_cache, init_model
from repro.sharding.rules import cache_specs, fit_spec, param_shardings

inp = np.load(sys.argv[1])
mesh = make_debug_mesh(data=1, model=2)
out = {}
for arch in sys.argv[3].split(","):
    cfg = get_smoke_config(arch)
    # the tensor-parallel train step, STC p = 1/50 both ways
    toks = make_lm_tokens(n_tokens=4 * 32 + 1, vocab=cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks[:-1].reshape(4, 32)),
             "labels": jnp.asarray(toks[1:].reshape(4, 32))}
    tc = TrainConfig(compute_dtype=jnp.float32, protocol="stc", lr=0.05,
                     sparsity_up=1 / 50, sparsity_down=1 / 50)
    state = init_train_state(cfg, tc, 1, jax.random.PRNGKey(0))
    step = make_train_step(cfg, mesh, tc)
    for i in range(int(inp["steps"])):
        state, m = step(state, batch)
        for k, v in m.items():
            out[f"{arch}/metrics/{i}/{k}"] = np.asarray(v)
    for key, tree in state.items():
        out[f"{arch}/state/{key}"] = np.concatenate(
            [np.asarray(x, np.float32).ravel() for x in jax.tree.leaves(tree)])
    # the serve steps on the parameters handed in
    shapes = jax.eval_shape(lambda: init_model(cfg, jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree.flatten(shapes)
    params = treedef.unflatten([jnp.asarray(inp[f"{arch}/param/{i}"])
                                for i in range(len(leaves))])
    params = jax.device_put(params, param_shardings(params, mesh))
    toks = inp[f"{arch}/tokens"]
    b, steps = toks.shape
    prompt_len = int(inp["prompt_len"])
    out[f"{arch}/prefill"] = np.asarray(make_prefill_step(
        cfg, mesh, jnp.float32)(params, {"tokens": jnp.asarray(
            toks[:, :prompt_len])}))
    caches = init_cache(cfg, b, steps, jnp.float32)
    placed = []
    for c, spec in zip(caches, cache_specs(caches, mesh, b)):
        kv = [jax.device_put(x, NamedSharding(mesh, fit_spec(
            s, x.shape, mesh))) for x, s in ((c.k, spec.k), (c.v, spec.v))]
        placed.append(c._replace(k=kv[0], v=kv[1], idx=jax.device_put(
            c.idx, NamedSharding(mesh, P()))))
    out[f"{arch}/cache_shard"] = np.asarray(
        placed[0].k.sharding.shard_shape(placed[0].k.shape))
    dec = make_decode_step(cfg, mesh, jnp.float32)
    logits = []
    for t in range(steps):
        lg, placed = dec(params, jnp.asarray(toks[:, t:t + 1]), placed)
        logits.append(np.asarray(lg))
    out[f"{arch}/decode"] = np.concatenate(logits, axis=1)
np.savez(sys.argv[2], **out)
print("REF_MOE_OK")
"""


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's tensor-parallel train and serve steps on two host
    devices, started first so that it runs beside the port's ranks."""
    where = tmp_path_factory.mktemp("ref_moe")
    inp = {"prompt_len": np.asarray(PROMPT), "steps": np.asarray(STEPS)}
    for arch in ARCHS:
        inp[f"{arch}/tokens"] = _serve_tokens(arch)
        for i, leaf in enumerate(jax.tree.leaves(_np_params(arch))):
            inp[f"{arch}/param/{i}"] = leaf
    np.savez(where / "in.npz", **inp)
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_MOE, str(where / "in.npz"),
         str(where / "out.npz"), ",".join(ARCHS)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    yield proc, where / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(ref_run, tmp_path_factory):
    """One spawn of two ranks: the blocks, the steps, serving."""
    where = tmp_path_factory.mktemp("tp_moe")
    blocks = {"cases": BLOCK_CASES,
              "params": {arch: _np_params(arch) for arch in ARCHS},
              "x": {arch: _block_input(arch)[0] for arch in ARCHS},
              "cot": {arch: _block_input(arch)[1] for arch in ARCHS}}
    serve = {arch: {"params": _np_params(arch),
                    "prompt": torch.from_numpy(_serve_tokens(arch)[:, :PROMPT]),
                    "tail": torch.from_numpy(_serve_tokens(arch)[:, PROMPT:])}
             for arch in ARCHS}
    inp = {"tp_moe": blocks, "tp_step": _step_input(), "tp_serve": serve}
    case = "+".join(inp)
    torch.save(inp, where / "in.pt")
    out = subprocess.run([sys.executable,
                          os.path.join(HERE, "_torch_mesh_worker.py"), case,
                          str(where / "in.pt"), str(where / "out.pt"), "2"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    assert not os.path.exists(where / "out.pt.rendezvous")
    outs = [torch.load(where / f"out.pt.{r}", weights_only=False)
            for r in range(2)]
    return {c: [o[c] for o in outs] for c in inp}


@pytest.fixture(scope="module")
def ref(ref_run):
    proc, path = ref_run
    stdout, stderr = proc.communicate(timeout=300)
    assert "REF_MOE_OK" in stdout, stderr[-3000:]
    return dict(np.load(path))


# -- the MoE block alone ----------------------------------------------------


def _unsplit_block(arch, dispatch):
    cfg = _port_cfg(arch, dispatch=dispatch)
    blk = params_from_jax(_np_params(arch))["blocks"][-1]["moe"]
    leaves = {k: v.clone().requires_grad_(True) for k, v in _moe_leaves(blk)}
    x, cot = _block_input(arch)
    x = x.clone().requires_grad_(True)
    y, aux = moe_apply(_moe_tree(leaves), x, cfg.moe, cfg.mlp_act)
    ((y * cot).sum() + aux).backward()
    return y.detach(), aux.detach(), x.grad, {k: v.grad
                                              for k, v in leaves.items()}


@pytest.mark.parametrize("arch,dispatch", BLOCK_CASES)
def test_split_moe_block_matches_the_unsplit_block(ranks, arch, dispatch):
    outs = [out[(arch, dispatch)] for out in ranks["tp_moe"]]
    y, aux, gx, grads = _unsplit_block(arch, dispatch)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][2], outs[1][2])
    assert torch.equal(outs[0][4], outs[1][4])
    _close_to_max(outs[0][0], y, 1e-6)
    _close_to_max(outs[0][1], aux, 1e-6)
    _close_to_max(outs[0][2], gx, 1e-6)
    mesh = make_debug_mesh(1, 2)
    specs = dict(_moe_leaves(param_specs(_np_params(arch))["blocks"][-1]
                             ["moe"]))
    split = 0
    for name, want in grads.items():
        dim = model_dim(specs[name], tuple(want.shape), mesh)
        parts = [out[3][name] for out in outs]
        if dim is None:
            assert torch.equal(parts[0], parts[1]), name   # the router
            got = parts[0]
        else:
            got = torch.cat(parts, dim=dim)
            split += 1
        _close_to_max(got, want, 1e-6)
    assert split == len(grads) - 1          # all but the router split
    cfg = _port_cfg(arch, dispatch=dispatch)
    x = _block_input(arch)[0].reshape(-1, cfg.d_model)
    blk = params_from_jax(_np_params(arch))["blocks"][-1]["moe"]
    assert torch.equal(outs[0][4], route(blk, x, cfg.moe)[2])


# -- the step ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _one_rank(name):
    """The port's ``model = 1`` step of job ``name``: ``(metrics a step,
    the last state, the choices a step)``."""
    arch, d_expert = JOBS[name][:2]
    cfg, tc = _job_cfg(name), _job_tc(name)
    state = init_train_state(cfg, tc, 1, device="cpu",
                             params=params_from_jax(_np_params(arch,
                                                               d_expert)))
    step = make_train_step(cfg, make_debug_mesh(1, 1), tc, device="cpu")
    metrics, choices = [], []
    for _ in range(STEPS):
        with RouterCalls() as chosen:
            state, m = step(state, _batch(arch))
        metrics.append({k: float(v) for k, v in m.items()})
        choices.append(chosen.log)
    state = {k: v for k, v in state.items() if k != "step"}
    return metrics, state, choices


def _hold_metrics(got, want):
    for pm, rm in zip(got, want, strict=True):
        assert sorted(pm) == sorted(rm)
        assert int(pm["nnz_up"]) == int(rm["nnz_up"])
        assert int(pm["nnz_down"]) == int(rm["nnz_down"])
        np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-5)


def _clear_of_ties(probs, k):
    """Tokens whose k-th and (k+1)-th router probabilities lie more than
    ``NEAR_TIE`` apart."""
    top = torch.sort(probs, dim=-1, descending=True).values
    return (top[:, k - 1] - top[:, k]) > NEAR_TIE


@pytest.mark.parametrize("name", HELD)
def test_two_shards_match_the_one_shard_step(ranks, name):
    i = list(JOBS).index(name)
    jobs = [out[i] for out in ranks["tp_step"]]
    metrics, state, choices = _one_rank(name)
    cfg = _job_cfg(name)
    for job in jobs:
        _hold_metrics(job["metrics"], metrics)
        assert sorted(job["state"]) == sorted(state)
        for key in state:
            np.testing.assert_allclose(_flat(job["state"][key]),
                                       _flat(state[key]), rtol=0, atol=1e-6,
                                       err_msg=f"{name} {key}")
    # the router, the norms (and the embedding where it is whole) bitwise
    # equal on the ranks after every step
    for a, b in zip(jobs[0]["replicated"], jobs[1]["replicated"],
                    strict=True):
        assert torch.equal(a, b)
    moe_layers = cfg.n_layers - cfg.moe.first_dense
    n_router = moe_layers * cfg.d_model * cfg.moe.n_experts
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    whole = cfg.d_model * cfg.moe.d_expert * cfg.moe.n_experts * 3 * \
        moe_layers if cfg.moe.d_expert == WHOLE_EXPERTS else 0
    assert jobs[0]["replicated"][0].numel() == n_router + norms + whole
    # every MoE layer's choices a step: bitwise on the ranks, and the
    # model = 1 step's clear of near-ties
    for s in range(STEPS):
        got = [job["choices"][s] for job in jobs]
        assert len(got[0]) == moe_layers == len(choices[s])
        for (a, _), (b, _), (want, probs) in zip(got[0], got[1], choices[s]):
            assert torch.equal(a, b)
            clear = _clear_of_ties(probs, cfg.moe.top_k)
            assert torch.equal(a[clear], want[clear])
            assert int(clear.sum()) >= 0.9 * len(clear)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_shards_match_the_reference_tp_step(ranks, ref, arch):
    i = list(JOBS).index("granite" if arch == GRANITE else "moonshot")
    for job in (out[i] for out in ranks["tp_step"]):
        want = [{k.split("/")[-1]: float(ref[k]) for k in ref
                 if k.startswith(f"{arch}/metrics/{s}/")}
                for s in range(STEPS)]
        _hold_metrics(job["metrics"], want)
        for key, tree in job["state"].items():
            np.testing.assert_allclose(_flat(tree),
                                       ref[f"{arch}/state/{key}"], rtol=0,
                                       atol=1e-6, err_msg=f"{arch} {key}")


@pytest.mark.parametrize("name", list(JOBS))
def test_flops_and_collectives_equal_the_dry_run(ranks, name):
    i = list(JOBS).index(name)
    arch = JOBS[name][0]
    cfg, tc = _job_cfg(name), _job_tc(name)
    mesh = make_debug_mesh(1, 2)
    rec = dryrun.lower_combo(arch, InputShape("row", S, B, "train"),
                             mesh=mesh, cfg=cfg, tc=tc, verbose=False,
                             ingest=False)
    assert not [a for a in rec["assumptions"] if "not counted" in a]
    assert "model-activations-all-gather" not in rec["collectives"]
    want = rec["collectives"]["model-all-reduce"]
    split = cfg.moe.d_expert != WHOLE_EXPERTS
    moe_layers = cfg.n_layers - cfg.moe.first_dense
    for out in ranks["tp_step"]:
        flops, handed = out[i]["counted"]
        assert flops == rec["flops"]
        reduced = {dtype: v for (g, op, dtype), v in handed.items()
                   if g == "model" and op == "all_reduce"}
        assert [sum(c for c, _ in reduced.values()),
                sum(b for _, b in reduced.values())] == \
            [want["count"], want["bytes"]]
        # the gates' gradient: (t, k) fp32 a MoE layer whose experts split,
        # beside the cross-entropy's 2 fp32 calls and STC's 2 + 2
        fp32 = reduced.get("torch.float32", [0, 0])
        gates = moe_layers * split
        if tc.compute_dtype == torch.float32:
            assert fp32[0] == want["count"]
        else:
            assert fp32[0] == gates + 2 + 4
            assert fp32[1] == (gates * B * S * cfg.moe.top_k * 4 +
                               3 * 4 * B * S + 2 * (4 + 4 * 256))
        gathered = handed.get(("model", "all_gather", "torch.int32"))
        assert gathered == [rec["collectives"]["model-all-gather"][k]
                            for k in ("count", "bytes")]
        assert not [k for k in handed if k[0] != "model"]


# -- serving ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _serve_one_rank(arch):
    cfg = get_smoke_config(arch)
    mesh = make_debug_mesh(1, 1)
    params = params_from_jax(_np_params(arch))
    toks = torch.from_numpy(_serve_tokens(arch))
    b, steps = toks.shape
    prefill = make_prefill_step(cfg, mesh, torch.float32, device="cpu")(
        params, {"tokens": toks[:, :PROMPT]})
    step = make_decode_step(cfg, mesh, torch.float32, device="cpu")
    caches = init_cache(cfg, b, steps, torch.float32, device="cpu")
    logits = []
    for t in range(steps):
        lg, caches = step(params, toks[:, t:t + 1], caches)
        logits.append(lg)
    return {"prefill": prefill, "decode": torch.cat(logits, dim=1)}


@pytest.mark.parametrize("which", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_two_ranks_matches_one_rank_and_the_reference(
        ranks, ref, arch, which):
    got = [out[arch][which] for out in ranks["tp_serve"]]
    assert torch.equal(got[0], got[1])
    _close_to_max(got[0], _serve_one_rank(arch)[which], 1e-5)
    _close_to_max(got[0], ref[f"{arch}/{which}"], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_caches_and_collectives_equal_the_stand_ins_and_dry_run(
        ranks, ref, arch):
    cfg = get_smoke_config(arch)
    mesh = make_debug_mesh(1, 2)
    b, steps = _serve_tokens(arch).shape
    heads = cfg.n_kv_heads // 2
    want = (b, steps, heads, cfg.resolved_head_dim)
    _, structs = serve_state_structs(cfg, mesh, b, steps, torch.float32)
    stand_in = sum(x.device_bytes() for x in tree_leaves(structs)
                   if hasattr(x, "device_bytes"))
    assert tuple(ref[f"{arch}/cache_shard"]) == want
    for out in ranks["tp_serve"]:
        assert out[arch]["cache"] == [[want, want, ()]] * cfg.n_layers
        assert out[arch]["cache_bytes"] == stand_in
        for kind, seq in (("prefill", PROMPT), ("decode", steps)):
            rec = dryrun.tp_serve_collectives(cfg, mesh, kind, b, seq)
            log = out[arch][f"bf16_{kind}_handed"]
            assert all(g == "model" and d == "torch.bfloat16"
                       for g, _, d in log), log
            got = {f"model-{op.replace('_', '-')}": [c, nbytes]
                   for (_, op, _), (c, nbytes) in log.items()}
            assert got == {k: [v["count"], v["bytes"]]
                           for k, v in rec.items()}
        # a decode step: the embedding's sum, two a layer, the logits'
        # gather (fp32 here)
        decode = out[arch]["decode_handed"]
        assert sum(c for c, _ in decode.values()) == 2 * cfg.n_layers + 2
