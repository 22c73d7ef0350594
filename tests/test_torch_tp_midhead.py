"""Port parity of tensor parallelism on splits that are not whole heads: a
mesh ``model`` axis whose ranks' columns of ``wq``, ``wk`` and ``wv`` cut a
head (the attention's gather route), over gloo ranks on the CPU
(``tests/_torch_mesh_worker.py``), at fp32, from the reference's initial
parameters through ``params_from_jax``.  SmolLM's smoke config has 3
query heads and 1 KV head of 32: on two ranks a rank holds 48 of ``wq``'s
96 columns and 16 of ``wk``'s 32.

* ``gather_from`` and ``scatter_to`` around a split product, forward and
  backward, against the unsplit product (four ranks).
* The step on ``make_debug_mesh(1, 4)`` for SmolLM's and Qwen2's smoke
  configs against the port's ``model = 1`` step (loss within rtol 1e-5,
  ``nnz`` exact, every state entry within 1e-6), the replicated leaves
  bitwise equal on the four ranks; and a config whose vocabulary and
  ``d_ff`` do not split four ways, so ``fit_spec`` keeps the embedding and
  the MLP whole and they run replicated.
* The step on ``make_debug_mesh(2, 2)`` for SmolLM's smoke config, the six
  codecs and the masked STC step, against the reference's own
  tensor-parallel step on ``make_debug_mesh(data=2, model=2)`` in a
  subprocess with four host devices, held as
  ``tests/test_torch_tensor_parallel.py``'s (2, 2) test holds Qwen2
  (``hold_two_by_two``): TernQuant and signSGD at R15's tolerance, and
  signSGD held to R16's cause besides.
* One step's ``FlopCounterMode`` count on each of four ranks equals the
  dry run's per-device ``flops``, and what it hands gloo equals the dry
  run's ``tp_collectives`` (remat in bf16 with STC, and TernQuant on the
  ``logit_chunk`` route).
* Serving on two and four ranks (whole caches on every rank, the KV heads
  not splitting): prefill and teacher-forced decode logits against the
  port's ``model = 1`` steps and, on two ranks, against the reference's
  serve steps on ``make_debug_mesh(1, 2)``, within rtol 1e-5 of the
  largest |logit|; the ranks' logits bitwise equal; each rank's cache at
  the bytes of its stand-ins; what a bf16 step hands gloo equal to the dry
  run's ``tp_serve_collectives``.
"""

import dataclasses
import functools
import json
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
from repro.models import init_model as ref_init_model
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
from repro_torch.models.transformer import init_model
from test_torch_tensor_parallel import (CODECS, FOUR, REF_TP_STEPS, STEPS,
                                        _close_to_max, _flat,
                                        hold_two_by_two)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")
ARCH = "smollm-135m"
ARCHS = ("smollm-135m", "qwen2-0.5b")
B, S = 4, 32
# serving: a 16-token prompt and 8 more teacher-forced decode steps
SB, PROMPT, TAIL = 2, 16, 8
# a vocabulary and d_ff that do not split four ways: the embedding, the
# head and the MLP are whole on every rank
WHOLE = {"vocab_size": 510, "d_ff": 250}
COUNTED = {"remat_bf16": dict(cfg={"remat": True},
                              tc=dict(CODECS["stc"],
                                      compute_dtype=torch.bfloat16)),
           "logit_chunk": dict(cfg={"logit_chunk": 8},
                               tc=CODECS["ternquant"])}


@functools.lru_cache(maxsize=None)
def _np_params(arch, **cfg):
    """The reference's initial parameters as numpy."""
    rcfg = dataclasses.replace(ref_smoke(arch), **cfg)
    state = ref_init_state(rcfg, RefTrainConfig(compute_dtype=jnp.float32),
                           1, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state["params"])


@functools.lru_cache(maxsize=None)
def _serve_params(arch):
    """The reference's ``init_model`` parameters, the QKV biases (zeros at
    init) drawn from a seed where the arch has them."""
    cfg = ref_smoke(arch)
    params = jax.tree.map(np.asarray, ref_init_model(cfg,
                                                     jax.random.PRNGKey(0)))
    if cfg.attn_bias:
        rng = np.random.default_rng(5)
        for block in params["blocks"]:
            for name in ("bq", "bk", "bv"):
                block["mix"][name] = (0.1 * rng.standard_normal(
                    block["mix"][name].shape)).astype(np.float32)
    return params


def _batch(vocab):
    toks = make_lm_tokens(n_tokens=B * S + 1, vocab=vocab)
    return {"tokens": torch.from_numpy(toks[:-1].reshape(B, S)),
            "labels": torch.from_numpy(toks[1:].reshape(B, S))}


def _tokens(arch):
    return np.random.default_rng(1).integers(
        0, ref_smoke(arch).vocab_size, (SB, PROMPT + TAIL)).astype(np.int64)


def _spawn(case, inp, where, ranks):
    torch.save(inp, where / "in.pt")
    out = subprocess.run([sys.executable,
                          os.path.join(HERE, "_torch_mesh_worker.py"), case,
                          str(where / "in.pt"), str(where / "out.pt"),
                          str(ranks)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    assert not os.path.exists(where / "out.pt.rendezvous")
    return [torch.load(where / f"out.pt.{r}", weights_only=False)
            for r in range(ranks)]


# -- the reference: its (2, 2) step and its (1, 2) serve steps ----------------

# argv 4: the serving spec
REF = REF_TP_STEPS + """
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.serve import make_decode_step, make_prefill_step
from repro.models import init_cache, init_model
from repro.sharding.rules import cache_specs, fit_spec, param_shardings

spec = json.loads(sys.argv[4])
# serving on (1, 2): the prefill of the prompt, the teacher-forced decode
mesh = make_debug_mesh(data=1, model=2)
params = init_model(cfg, jax.random.PRNGKey(0))
params = jax.device_put(params, param_shardings(params, mesh))
toks = np.random.default_rng(1).integers(
    0, cfg.vocab_size, (spec["batch"], spec["steps"])).astype(np.int64)
out["prefill"] = np.asarray(make_prefill_step(cfg, mesh, jnp.float32)(
    params, {"tokens": jnp.asarray(toks[:, :spec["prompt"]])}))
caches = init_cache(cfg, spec["batch"], spec["steps"], jnp.float32)
placed = []
for c, cs in zip(caches, cache_specs(caches, mesh, spec["batch"])):
    kv = [jax.device_put(x, NamedSharding(mesh, fit_spec(s, x.shape, mesh)))
          for x, s in ((c.k, cs.k), (c.v, cs.v))]
    placed.append(c._replace(k=kv[0], v=kv[1], idx=jax.device_put(
        c.idx, NamedSharding(mesh, P()))))
out["cache_shard"] = np.asarray(
    placed[0].k.sharding.shard_shape(placed[0].k.shape))
step = make_decode_step(cfg, mesh, jnp.float32)
logits = []
for t in range(spec["steps"]):
    lg, placed = step(params, jnp.asarray(toks[:, t:t + 1]), placed)
    logits.append(np.asarray(lg))
out["decode"] = np.concatenate(logits, axis=1)
np.savez(sys.argv[2], **out)
print("REF_MIDHEAD_OK")
"""


@pytest.fixture(scope="module")
def ref_proc(tmp_path_factory):
    """The reference on four host devices, started first so that it runs
    beside the port's ranks."""
    path = tmp_path_factory.mktemp("ref_midhead") / "ref.npz"
    spec = {"batch": SB, "prompt": PROMPT, "steps": PROMPT + TAIL}
    proc = subprocess.Popen(
        [sys.executable, "-c", REF, json.dumps(FOUR), str(path), ARCH,
         json.dumps(spec)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ref(ref_proc, four_ranks, two_ranks):
    proc, path = ref_proc
    stdout, stderr = proc.communicate(timeout=300)
    assert "REF_MIDHEAD_OK" in stdout, stderr[-3000:]
    return dict(np.load(path))


# -- the ranks ----------------------------------------------------------------


def _ops_input():
    rng = np.random.default_rng(3)

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {"column": (normal(2, 5, 12), normal(12, 40), normal(2, 5, 40),
                       -1),
            "row": (normal(2, 5, 40), normal(40, 12), normal(2, 5, 12), -1),
            "dim1": (normal(2, 8, 6), normal(6), normal(2, 8, 6), 1)}


def _step_jobs():
    jobs = [dict(arch=arch, params=params_from_jax(_np_params(arch)),
                 batch=_batch(ref_smoke(arch).vocab_size), mesh=(1, 4),
                 tc=CODECS["stc"], steps=STEPS) for arch in ARCHS]
    jobs.append(dict(cfg=WHOLE, params=params_from_jax(_np_params(
        ARCH, **WHOLE)), batch=_batch(WHOLE["vocab_size"]), mesh=(1, 4),
        tc=CODECS["stc"], steps=STEPS))
    jobs += [dict(job, mesh=(1, 4), count=True) for job in COUNTED.values()]
    # signSGD's messages come back (measure_wire) for its vote sums
    jobs += [dict(tc=dict(kw, measure_wire=name == "signsgd"), steps=steps,
                  mask=mask, mesh=(2, 2)) for name, kw, steps, mask in FOUR]
    return jobs


def _serve_input():
    return {arch: {"params": _serve_params(arch),
                   "prompt": torch.from_numpy(_tokens(arch)[:, :PROMPT]),
                   "tail": torch.from_numpy(_tokens(arch)[:, PROMPT:])}
            for arch in ARCHS}


@pytest.fixture(scope="module")
def four_ranks(ref_proc, tmp_path_factory):
    """One spawn of four ranks: the operators, the steps on (1, 4) and
    (2, 2), serving on (1, 4)."""
    inp = {"tp_ops": _ops_input(),
           "tp_step": {"arch": ARCH, "params": params_from_jax(
               _np_params(ARCH)), "batch": _batch(ref_smoke(ARCH).vocab_size),
               "mesh": (1, 4), "jobs": _step_jobs()},
           "tp_serve": _serve_input()}
    outs = _spawn("+".join(inp), inp, tmp_path_factory.mktemp("tp4"), 4)
    return {case: [out[case] for out in outs] for case in inp}


@pytest.fixture(scope="module")
def two_ranks(ref_proc, tmp_path_factory):
    """One spawn of two ranks serving SmolLM on (1, 2)."""
    inp = {ARCH: _serve_input()[ARCH]}
    return _spawn("tp_serve", inp, tmp_path_factory.mktemp("tp2"), 2)


# -- the operators ------------------------------------------------------------


@pytest.mark.parametrize("name", ["column", "row", "dim1"])
def test_gather_and_scatter_match_the_unsplit_product(four_ranks, name):
    x, w, cot, dim = _ops_input()[name]
    xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = xx * ww if name == "dim1" else xx @ ww
    (y * cot).sum().backward()
    m = 4
    for rank, out in enumerate(four_ranks["tp_ops"]):
        got_y, got_gx, got_gblk = out[name]
        assert torch.equal(got_y, four_ranks["tp_ops"][0][name][0])
        _close_to_max(got_y, y.detach())
        if name == "dim1":
            n = x.shape[dim] // m
            want = (cot * w).narrow(dim, rank * n, n)
            assert got_gx is None
        else:
            _close_to_max(got_gx, xx.grad)      # whole on every rank
            k = 1 if name == "column" else 0
            n = w.shape[k] // m
            want = ww.grad.narrow(k, rank * n, n)
        _close_to_max(got_gblk, want)


# -- the step -----------------------------------------------------------------


def _one_shard(arch, cfg_kw, kw, steps):
    """The port's ``model = 1`` step: ``(metrics a step, the last
    state)``."""
    cfg = dataclasses.replace(get_smoke_config(arch), **cfg_kw)
    tc = TrainConfig(compute_dtype=torch.float32, **kw)
    state = init_train_state(cfg, tc, 1, device="cpu", params=params_from_jax(
        _np_params(arch, **cfg_kw)))
    step = make_train_step(cfg, make_debug_mesh(1, 1), tc, device="cpu")
    metrics = []
    for _ in range(steps):
        state, m = step(state, _batch(cfg.vocab_size))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


@pytest.mark.parametrize("which", ["smollm-135m", "qwen2-0.5b", "whole"])
def test_one_client_four_shards_match_one_shard(four_ranks, which):
    i = ["smollm-135m", "qwen2-0.5b", "whole"].index(which)
    arch, cfg_kw = (ARCH, WHOLE) if which == "whole" else (which, {})
    want_m, want_state = _one_shard(arch, cfg_kw, CODECS["stc"], STEPS)
    outs = [out[i] for out in four_ranks["tp_step"]]
    for job in outs:
        for pm, wm in zip(job["metrics"], want_m, strict=True):
            assert sorted(pm) == sorted(wm)
            for key in ("nnz_up", "nnz_down"):
                assert pm[key] == wm[key], (which, key)
            np.testing.assert_allclose(pm["loss"], wm["loss"], rtol=1e-5)
        for key in ("params", "client_res", "server_res"):
            np.testing.assert_allclose(_flat(job["state"][key]),
                                       _flat(want_state[key]), rtol=0,
                                       atol=1e-6, err_msg=f"{which} {key}")
    for s in range(STEPS):
        reps = [job["replicated"][s] for job in outs]
        assert all(torch.equal(reps[0], r) for r in reps[1:])
    cfg = dataclasses.replace(get_smoke_config(arch), **cfg_kw)
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    # whole: the embedding and every MLP leaf are replicated too
    extra = (cfg.vocab_size * cfg.d_model + cfg.n_layers * 3 * cfg.d_model
             * cfg.d_ff if which == "whole" else 0)
    assert outs[0]["replicated"][0].numel() == norms + extra


def _handed_by_op(handed, skip=()):
    """A ``_Handed`` log over the model group as ``{op: [calls, bytes]}``,
    leaving out the ``(op, dtype)`` keys in ``skip``."""
    out = {}
    for (group, op, dtype), (calls, nbytes) in handed.items():
        assert group == "model", handed
        if (op, dtype) in skip:
            continue
        rec = out.setdefault(op, [0, 0])
        rec[0] += calls
        rec[1] += nbytes
    return out


def _dry_by_op(collectives):
    out = {}
    for name, rec in collectives.items():
        op = "all_gather" if name.endswith("all-gather") else "all_reduce"
        got = out.setdefault(op, [0, 0])
        got[0] += rec["count"]
        got[1] += rec["bytes"]
    return out


@pytest.mark.parametrize("which", list(COUNTED))
def test_four_shards_flops_and_collectives_equal_the_dry_run(four_ranks,
                                                             which):
    i = 3 + list(COUNTED).index(which)
    spec = COUNTED[which]
    cfg = dataclasses.replace(get_smoke_config(ARCH), **spec["cfg"])
    tc = TrainConfig(**{"compute_dtype": torch.float32, **spec["tc"]})
    rec = dryrun.lower_combo(ARCH, InputShape("row", S, B, "train"),
                             mesh=make_debug_mesh(1, 4), cfg=cfg, tc=tc,
                             verbose=False, ingest=False)
    assert not [a for a in rec["assumptions"] if "evenly" in a]
    assert "model-activations-all-gather" in rec["collectives"]
    dependent = rec["collectives_data_dependent"]
    for out in four_ranks["tp_step"]:
        flops, handed = out[i]["counted"]
        assert flops == rec["flops"]
        # the candidates' gather (fp32) depends on the data: counted apart
        skip = {("all_gather", "torch.float32")} if dependent else set()
        assert _handed_by_op(handed, skip) == _dry_by_op(rec["collectives"])
        if dependent:
            assert handed[("model", "all_gather", "torch.float32")][0] == \
                dependent["model-candidates-all-gather"]["count"]


@pytest.mark.parametrize("name", [name for name, *_ in FOUR])
def test_two_clients_two_shards_match_the_reference_tp_mesh(four_ranks, ref,
                                                            name):
    i = 5 + [n for n, *_ in FOUR].index(name)
    hold_two_by_two([out[i] for out in four_ranks["tp_step"]], ref, name,
                    dict((n, s) for n, _, s, _ in FOUR)[name],
                    _flat(params_from_jax(_np_params(ARCH))))


# -- serving ------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _serve_one_rank(arch):
    """The port's ``model = 1`` serve steps on the joined weights."""
    cfg = get_smoke_config(arch)
    mesh = make_debug_mesh(1, 1)
    params = params_from_jax(_serve_params(arch))
    toks = torch.from_numpy(_tokens(arch))
    prefill = make_prefill_step(cfg, mesh, torch.float32, device="cpu")(
        params, {"tokens": toks[:, :PROMPT]})
    step = make_decode_step(cfg, mesh, torch.float32, device="cpu")
    caches = init_cache(cfg, SB, PROMPT + TAIL, torch.float32, device="cpu")
    logits = []
    for t in range(PROMPT + TAIL):
        lg, caches = step(params, toks[:, t:t + 1], caches)
        logits.append(lg)
    return {"prefill": prefill, "decode": torch.cat(logits, dim=1)}


def _serve_ranks(four_ranks, two_ranks, m):
    return four_ranks["tp_serve"] if m == 4 else two_ranks


@pytest.mark.parametrize("which", ["prefill", "decode"])
@pytest.mark.parametrize("arch,m", [(ARCH, 2), (ARCH, 4),
                                    ("qwen2-0.5b", 4)])
def test_serving_matches_one_rank(four_ranks, two_ranks, arch, m, which):
    cfg = get_smoke_config(arch)
    got = [out[arch][which] for out in _serve_ranks(four_ranks, two_ranks,
                                                    m)]
    assert all(torch.equal(got[0], g) for g in got[1:])
    n = 1 if which == "prefill" else PROMPT + TAIL
    assert tuple(got[0].shape) == (SB, n, cfg.vocab_size)
    _close_to_max(got[0], _serve_one_rank(arch)[which])


@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_two_rank_serving_matches_the_reference(two_ranks, ref, which):
    _close_to_max(two_ranks[0][ARCH][which], ref[which])


@pytest.mark.parametrize("arch,m", [(ARCH, 2), (ARCH, 4),
                                    ("qwen2-0.5b", 4)])
def test_each_rank_holds_the_whole_cache_at_the_stand_ins_bytes(
        four_ranks, two_ranks, ref, arch, m):
    cfg = get_smoke_config(arch)
    want = (SB, PROMPT + TAIL, cfg.n_kv_heads, cfg.resolved_head_dim)
    _, structs = serve_state_structs(cfg, make_debug_mesh(1, m), SB,
                                     PROMPT + TAIL, torch.float32)
    stand_in_bytes = sum(x.device_bytes() for x in tree_leaves(structs)
                         if hasattr(x, "device_bytes"))
    for out in _serve_ranks(four_ranks, two_ranks, m):
        assert out[arch]["cache"] == [[want, want, ()]] * cfg.n_layers
        assert out[arch]["cache_bytes"] == stand_in_bytes
    if m == 2:
        assert tuple(ref["cache_shard"]) == want


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch,m", [(ARCH, 2), (ARCH, 4),
                                    ("qwen2-0.5b", 4)])
def test_a_serve_step_hands_gloo_what_the_dry_run_lists(
        four_ranks, two_ranks, arch, m, kind):
    cfg = get_smoke_config(arch)
    seq = PROMPT if kind == "prefill" else PROMPT + TAIL
    rec = dryrun.lower_combo(arch, InputShape("row", seq, SB, kind),
                             mesh=make_debug_mesh(1, m), cfg=cfg,
                             verbose=False, ingest=False)
    assert not [a for a in rec["assumptions"] if "evenly" in a]
    calls = sum(c["count"] for c in rec["collectives"].values())
    assert calls == 3 * cfg.n_layers + 2           # the gather route
    assert rec["flops"] == dryrun.step_flops(cfg, kind, SB, seq, model=m)
    for out in _serve_ranks(four_ranks, two_ranks, m):
        handed = out[arch][f"bf16_{kind}_handed"]
        assert {d for _, _, d in handed} == {"torch.bfloat16"}
        assert _handed_by_op(handed) == _dry_by_op(rec["collectives"])


def test_a_mid_head_serve_step_counts_its_flops():
    """The serve steps' FLOPs on four ranks (the attention core on every
    head, the projections' blocks) equal ``FlopCounterMode`` run on the
    rank's blocks in one process, whose collectives are stubbed."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.sharding import tensor_parallel as tpm
    from repro_torch.sharding.rules import shard_tree
    cfg = get_smoke_config(ARCH)
    mesh = make_debug_mesh(1, 4)
    params = shard_tree(init_model(cfg, 0), mesh, 1)
    fake = tpm.TensorParallel(object(), 1, 4)
    calls = []

    def gather(x, group, size, dim):
        calls.append("all_gather")
        return torch.cat([x] * size, dim=dim)

    def reduce(x, group, op="sum"):
        calls.append("all_reduce")
        return x
    saved = tpm._all_gather, tpm._all_reduce
    tpm._all_gather, tpm._all_reduce = gather, reduce
    try:
        from repro_torch.models.transformer import decode_step, forward
        toks = torch.from_numpy(_tokens(ARCH))
        with torch.inference_mode(), FlopCounterMode(display=False) as fc:
            hidden, _ = forward(params, cfg, toks[:, :PROMPT],
                                compute_dtype=torch.float32,
                                return_hidden=True, tp=fake)
            hidden[:, -1:] @ params["embed"].T
        assert fc.get_total_flops() == dryrun.step_flops(
            cfg, "prefill", SB, PROMPT, model=4)
        caches = init_cache(cfg, SB, PROMPT + TAIL, torch.float32,
                            device="cpu", model=4)
        with torch.inference_mode(), FlopCounterMode(display=False) as fc:
            decode_step(params, cfg, toks[:, :1], caches,
                        compute_dtype=torch.float32, tp=fake)
        assert fc.get_total_flops() == dryrun.step_flops(
            cfg, "decode", SB, PROMPT + TAIL, model=4)
    finally:
        tpm._all_gather, tpm._all_reduce = saved
    assert calls.count("all_gather") == 2 * cfg.n_layers + 1
