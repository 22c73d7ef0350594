"""Port parity of tensor parallelism in the mesh trainer: a mesh ``model``
axis > 1 over gloo ranks on the CPU (``tests/_torch_mesh_worker.py``), on
``qwen2-0.5b``'s smoke config (4 query and 2 KV heads, ``d_ff`` 256,
vocab 512: whole heads on two ranks), from the reference's initial
parameters through ``params_from_jax``, at fp32.

* Which configs the step runs (``tensor_parallel_gap``), and
  ``shard_leaf``'s blocks against the ``Sharding`` shard shapes.
* The split blocks on two ranks: the MLP, the attention, the
  vocab-parallel embedding and cross-entropy, outputs and gradients
  (joined over the ranks) against the unsplit port functions and the
  reference's JAX functions, within 1e-5 of the largest.
* The split k-selection against the port's ``hist_topk_threshold_batched``
  on the joined row: threshold and count exact, the sum within rtol 1e-6,
  every rank the same; a candidate bin spread over both ranks, all ties,
  fewer non-zeros than k, a rank of zeros, bin 0 holding most of the row;
  and the tree STC over a model group, its replicated leaves counted once.
* The step on ``make_debug_mesh(1, 2)`` against the reference's
  ``make_train_step`` on its ``model = 1`` mesh in this process (GSPMD's
  same function) for stc, topk, signsgd, fedavg (``local_iters=2``),
  baseline and ternquant, at ``tests/test_torch_mesh_train.py``'s
  lock-step tolerances (every state entry within 1e-6, the loss within
  rtol 1e-5, ``nnz`` exact; TernQuant at its R15 tolerance, as the
  ``model = 1`` port is held), the replicated leaves bitwise equal on both
  ranks after every step; and on ``make_debug_mesh(2, 2)`` (four ranks),
  the same codecs and the masked STC step with mask (1, 0), against the
  reference's own tensor-parallel step on ``make_debug_mesh(data=2,
  model=2)``, run in a subprocess with four host devices.
* ``WireLedger``'s bits from the joined messages equal the ``model = 1``
  run's.
* One step's ``FlopCounterMode`` count on each rank equals the dry run's
  per-device ``flops``, and what the step hands gloo over the model group
  equals the dry run's ``tp_collectives`` (remat on in bf16, and the
  ``logit_chunk`` route with TernQuant).
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
import torch.nn.functional as F

from repro.configs import get_smoke_config as ref_smoke
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh
from repro.launch.train import TrainConfig as RefTrainConfig
from repro.launch.train import init_train_state as ref_init_state
from repro.launch.train import make_train_step as ref_make_step
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro_torch.configs import (ARCH_IDS, InputShape, get_config,
                                 get_smoke_config)
from repro_torch.core.compression import tree_leaves
from repro_torch.core.distributed import stc_compress_tree_with_residual
from repro_torch.data import make_lm_tokens
from repro_torch.kernels.hist_select import (bin_index, hist_topk_threshold_batched,
                                             locate_bin,
                                             magnitude_histogram_batched)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.train import (TrainConfig, WireLedger, codec_for,
                                      init_train_state, make_train_step,
                                      tensor_parallel_gap)
from repro_torch.models import params_from_jax
from repro_torch.models.attention import attn_apply
from repro_torch.models.layers import mlp_apply
from repro_torch.models.transformer import init_model
from repro_torch.sharding.rules import (map_tree, model_dim, param_shardings,
                                        param_specs, shard_leaf)
from test_torch_mesh_train import held_r15

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")
ARCH = "qwen2-0.5b"
B, S = 4, 32


@functools.lru_cache(maxsize=None)
def _np_params():
    tc = RefTrainConfig(compute_dtype=jnp.float32)
    state = ref_init_state(ref_smoke(ARCH), tc, 1, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state["params"])


def _batch():
    toks = make_lm_tokens(n_tokens=B * S + 1, vocab=ref_smoke(ARCH).vocab_size)
    return toks[:-1].reshape(B, S), toks[1:].reshape(B, S)


def _flat(tree):
    leaves = (jax.tree.leaves(tree) if isinstance(
        jax.tree.leaves(tree)[0], (jax.Array, np.ndarray))
        else tree_leaves(tree))
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


def _run_worker(case, inp, tmp_path, ranks=2):
    inp_path, out_path = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save(inp, inp_path)
    out = subprocess.run([sys.executable,
                          os.path.join(HERE, "_torch_mesh_worker.py"), case,
                          str(inp_path), str(out_path), str(ranks)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    return [torch.load(f"{out_path}.{r}", weights_only=False)
            for r in range(ranks)]


def _close_to_max(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def _join(parts, dim):
    return parts[0] if dim is None else torch.cat(parts, dim=dim)


# -- what runs, and the blocks ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_what_tensor_parallelism_runs(arch):
    """The attention family, dense or MoE, runs on every split
    ``fit_spec`` makes: at ``model`` 2, 4 and 16 (the production mesh's
    axis), whole heads or not; the other families name item 4c; the
    chunked STC still names item 4d; ``model = 1`` always runs."""
    dense = arch in ("qwen2-0.5b", "phi3-medium-14b", "smollm-135m",
                     "granite-moe-3b-a800m", "moonshot-v1-16b-a3b")
    meshes = [make_debug_mesh(1, m) for m in (2, 4, 16)]
    meshes.append(make_production_mesh())
    for cfg in (get_config(arch), get_smoke_config(arch)):
        for mesh in meshes:
            gap = tensor_parallel_gap(cfg, mesh, TrainConfig())
            assert (gap is None) if dense else ("item 4c" in gap), gap
            chunked = tensor_parallel_gap(cfg, mesh, TrainConfig(chunks=4096))
            assert ("item 4d" in chunked) if dense else ("item 4c" in chunked)
        assert tensor_parallel_gap(cfg, make_debug_mesh(2, 1),
                                   TrainConfig()) is None


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi3-medium-14b"])
def test_shard_leaf_blocks_are_the_sharding_shapes(arch):
    """Every leaf's :func:`shard_leaf` block has its ``Sharding``'s shard
    shape on ``make_debug_mesh(1, 2)`` and the production mesh (meta
    tensors), and the smoke config's blocks joined along ``model_dim``
    give the leaf back."""
    meta = init_model(get_config(arch), device="meta")
    for mesh in (make_debug_mesh(1, 2), make_production_mesh()):
        m = mesh.shape["model"]
        got = map_tree(lambda _, x, s: [tuple(shard_leaf(x, s, mesh, r).shape)
                                        for r in (0, m - 1)],
                       meta, param_specs(meta))
        want = map_tree(lambda _, x, sh: [sh.shard_shape(x.shape)] * 2, meta,
                        param_shardings(meta, mesh))
        assert tree_leaves(got) == tree_leaves(want)
    params = init_model(get_smoke_config(arch), 0)
    mesh = make_debug_mesh(1, 2)
    joined = map_tree(lambda _, x, s: torch.equal(_join(
        [shard_leaf(x, s, mesh, r) for r in range(2)],
        model_dim(s, tuple(x.shape), mesh)), x), params, param_specs(params))
    assert all(tree_leaves(joined))


# -- the split blocks ----------------------------------------------------------


@pytest.fixture(scope="module")
def ref_tp(tmp_path_factory):
    """The reference's tensor-parallel step on four host devices, started
    first so that it runs beside the port's ranks."""
    path = tmp_path_factory.mktemp("ref_tp") / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_TP, json.dumps(FOUR), str(path), ARCH],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    yield proc, path
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def two_ranks(ref_tp, tmp_path_factory):
    """One spawn of two ranks: the split blocks, the split selections and
    the jobs on ``make_debug_mesh(1, 2)``."""
    inp = {"tp_blocks": _blocks_input(), "tp_select": _select_input(),
           "tp_step": _one_by_two_input()}
    outs = _run_worker("+".join(inp), inp, tmp_path_factory.mktemp("tp2"))
    return {case: [out[case] for out in outs] for case in inp}


@pytest.fixture(scope="module")
def blocks(two_ranks):
    return _blocks_input(), two_ranks["tp_blocks"]


@functools.lru_cache(maxsize=None)
def _blocks_input():
    cfg = ref_smoke(ARCH)
    rng = np.random.default_rng(0)
    d, v = cfg.d_model, cfg.vocab_size
    inp = {"arch": ARCH, "params": _np_params(), "chunk": 8,
           "x": torch.from_numpy(rng.standard_normal((2, 16, d), np.float32)),
           "cot": torch.from_numpy(rng.standard_normal((2, 16, d),
                                                       np.float32)),
           "tokens": torch.from_numpy(rng.integers(0, v, (2, 16))),
           "logits": torch.from_numpy(
               3 * rng.standard_normal((2, 16, v), np.float32)),
           "labels": torch.from_numpy(rng.integers(0, v, (2, 16))),
           "cot_ce": torch.from_numpy(rng.standard_normal((2, 16),
                                                          np.float32))}
    return inp


def _unsplit(name, inp):
    """The unsplit port block: ``(out, grad of the input, {leaf: grad})``
    and the reference's from ``jax.vjp``."""
    cfg = get_smoke_config(ARCH)
    np_params = _np_params()
    x = inp["x"].clone().requires_grad_(True)
    if name in ("mlp", "attention"):
        key = "mlp" if name == "mlp" else "mix"
        w = {k: torch.from_numpy(np.array(a)).requires_grad_(True)
             for k, a in np_params["blocks"][0][key].items()}
        kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                  head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)
        if name == "mlp":
            y = mlp_apply(w, x, cfg.mlp_act)
            ref_fn = lambda p, xx: ref_layers.mlp_apply(p, xx, cfg.mlp_act)
        else:
            y = attn_apply(w, x, chunk=inp["chunk"], **kw)
            ref_fn = lambda p, xx: ref_attn.attn_apply(
                p, xx, chunk=inp["chunk"], **kw)
        (y * inp["cot"]).sum().backward()
        port = (y.detach(), x.grad, {k: t.grad for k, t in w.items()})
        ry, vjp = jax.vjp(ref_fn, np_params["blocks"][0][key],
                          jnp.asarray(inp["x"].numpy()))
        rw, rx = vjp(jnp.asarray(inp["cot"].numpy()))
        return port, (ry, rx, rw)
    if name == "embedding":
        table = torch.from_numpy(np.array(np_params["embed"])) \
            .requires_grad_(True)
        y = F.embedding(inp["tokens"], table)
        (y * inp["cot"]).sum().backward()
        ry, vjp = jax.vjp(lambda t: jnp.take(t, inp["tokens"].numpy(),
                                             axis=0), np_params["embed"])
        return ((y.detach(), None, {"embed": table.grad}),
                (ry, None, {"embed": vjp(jnp.asarray(
                    inp["cot"].numpy()))[0]}))
    logits = inp["logits"].clone().requires_grad_(True)
    gold = torch.take_along_dim(logits, inp["labels"][..., None], -1)[..., 0]
    y = torch.logsumexp(logits, -1) - gold
    (y * inp["cot_ce"]).sum().backward()
    labels = inp["labels"].numpy()

    def ref_ce(lg):
        g = jnp.take_along_axis(lg, labels[..., None], -1)[..., 0]
        return jax.nn.logsumexp(lg, -1) - g

    ry, vjp = jax.vjp(ref_ce, jnp.asarray(inp["logits"].numpy()))
    return ((y.detach(), None, {"logits": logits.grad}),
            (ry, None, {"logits": vjp(jnp.asarray(
                inp["cot_ce"].numpy()))[0]}))


_BLOCK_SPECS = {"mlp": ("blocks", 0, "mlp"), "attention": ("blocks", 0, "mix"),
                "embedding": (), "ce": None}


@pytest.mark.parametrize("name", ["mlp", "attention", "embedding", "ce"])
def test_split_block_matches_unsplit_and_reference(blocks, name):
    inp, outs = blocks
    port, ref = _unsplit(name, inp)
    mesh = make_debug_mesh(1, 2)
    specs = param_specs(_np_params())
    ys = [out[name][0] for out in outs]
    assert torch.equal(ys[0], ys[1])            # replicated output
    _close_to_max(ys[0], port[0])
    _close_to_max(ys[0], ref[0])
    if port[1] is not None:
        gx = [out[name][1] for out in outs]
        assert torch.equal(gx[0], gx[1])
        _close_to_max(gx[0], port[1])
        _close_to_max(gx[0], ref[1])
    for leaf, want in port[2].items():
        if name == "ce":
            dim = 2
        else:
            sub = specs
            for key in _BLOCK_SPECS[name]:
                sub = sub[key]
            dim = model_dim(sub[leaf], tuple(want.shape), mesh)
        got = _join([out[name][2][leaf] for out in outs], dim)
        _close_to_max(got, want)
        _close_to_max(got, ref[2][leaf])


# -- the split k-selection -------------------------------------------------------


def _select_rows():
    rng = np.random.default_rng(1)
    n = 3000

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    bin0 = normal(2, n)
    bin0[0, 7] = 1e6                          # every other element: bin 0
    sparse = np.zeros((2, n), np.float32)
    sparse[0, rng.choice(n, 30, replace=False)] = normal(30)
    sparse[1, rng.choice(n, 20, replace=False)] = normal(20)
    ties = np.where(rng.random((2, n)) < 0.5, 1.5, -1.5).astype(np.float32)
    zero = np.stack([normal(n), np.zeros(n, np.float32)])
    return {"spread": (normal(2, n), 600), "ties": (ties, 100),
            "fewer_nonzeros": (sparse, 200), "zero_shard": (zero, 300),
            "bin0": (bin0, 500)}


def _tree_case():
    rng = np.random.default_rng(2)
    tree = {"a": rng.standard_normal((6, 10)).astype(np.float32),
            "b": 50 * rng.standard_normal(8).astype(np.float32),
            "c": rng.standard_normal((4, 6)).astype(np.float32),
            "g": 40 * rng.standard_normal(5).astype(np.float32)}
    shards = [{"a": tree["a"][:, 5 * r:5 * r + 5], "b": tree["b"],
               "c": tree["c"][2 * r:2 * r + 2], "g": tree["g"]}
              for r in range(2)]
    as_t = lambda t: {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in t.items()}
    return as_t(tree), [as_t(s) for s in shards], [False, True, False, True]


def _select_input():
    _, shards, replicated = _tree_case()
    return {"rows": [(parts, k) for parts, k in _select_rows().values()],
            "trees": [(shards, replicated, 0.2, 97)]}


@pytest.fixture(scope="module")
def selections(two_ranks):
    return _select_rows(), _tree_case()[0], two_ranks["tp_select"]


@pytest.mark.parametrize("case", ["spread", "ties", "fewer_nonzeros",
                                  "zero_shard", "bin0"])
def test_split_selection_equals_the_joined_row(selections, case):
    rows, _, outs = selections
    i = list(rows).index(case)
    parts, k = rows[case]
    joined = torch.from_numpy(parts.reshape(1, -1))
    t, c, s = hist_topk_threshold_batched(joined, k)
    for out in outs:
        v, cnt, total = out["rows"][i]
        assert float(v[0]) == float(t[0]), (case, v, t)
        assert int(cnt[0]) == int(c[0])
        np.testing.assert_allclose(float(total[0]), float(s[0]), rtol=1e-6)
        assert torch.equal(v, outs[0]["rows"][i][0])
        assert torch.equal(total, outs[0]["rows"][i][2])
    a_max = joined.abs().max()
    scale = (256 / a_max).reshape(1) if a_max > 0 else torch.zeros(1)
    cnt, sums = magnitude_histogram_batched(joined, scale)
    b = int(locate_bin(cnt, sums, torch.tensor([k]), 256)[0])
    if case == "spread":                 # the candidate bin on both ranks
        for part in parts:
            bins = bin_index(torch.from_numpy(part).abs(), scale, 256)
            assert int((bins == b).sum()) > 0
    if case == "bin0":
        assert b == 0 and int(cnt[0, 0]) > 0.99 * joined.numel()
    if case == "fewer_nonzeros":
        assert float(t[0]) == 0.0 and int(c[0]) == 50


def test_split_tree_stc_counts_replicated_leaves_once(selections):
    _, tree, outs = selections
    tern, res, st = stc_compress_tree_with_residual(tree, 0.2, numel=97)
    joined = {}
    for key, dim in (("a", 1), ("b", None), ("c", 0), ("g", None)):
        joined[key] = _join([out["trees"][0][0][key] for out in outs], dim)
        if dim is None:                  # replicated: the same on every rank
            assert torch.equal(outs[0]["trees"][0][0][key],
                               outs[1]["trees"][0][0][key])
    for out in outs:
        _, _, (nnz, numel, mu, thresh) = out["trees"][0]
        assert int(nnz) == int(st.nnz) and numel == 97
        assert float(thresh) == float(st.thresh)
        np.testing.assert_allclose(float(mu), float(st.mu), rtol=1e-6)
    for key in tree:
        assert torch.equal(torch.sign(joined[key]), torch.sign(tern[key]))
    # the replicated leaves are large: counting them twice would move k
    assert int(st.nnz) == 19 and int((tern["b"] != 0).sum()) > 0


# -- the step ----------------------------------------------------------------------


CODECS = {
    "stc": dict(protocol="stc", lr=0.05, sparsity_up=1 / 50,
                sparsity_down=1 / 50),
    "topk": dict(protocol="topk", lr=0.05, sparsity_up=1 / 50),
    "signsgd": dict(protocol="signsgd", lr=0.01),
    "fedavg": dict(protocol="fedavg", lr=0.05, local_iters=2),
    "baseline": dict(protocol="baseline", lr=0.05),
    "ternquant": dict(protocol="ternquant", lr=0.05),
}
STEPS = 2
COUNTED = {"remat_bf16": dict(cfg={"remat": True},
                              tc=dict(CODECS["stc"],
                                      compute_dtype=torch.bfloat16)),
           "logit_chunk": dict(cfg={"logit_chunk": 8},
                               tc=CODECS["ternquant"])}
# SmolLM's smoke config on two ranks: 48 of wq's 96 columns and 16 of wk's
# 32 a rank, heads cut in half (the attention's gather route)
MID_HEAD = "smollm-135m"
COUNTED.update({f"mid_head_{name}": dict(job, arch=MID_HEAD)
                for name, job in list(COUNTED.items())})


def _port_batch():
    toks, labels = _batch()
    return {"tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


@functools.lru_cache(maxsize=None)
def _mid_head_inputs():
    """SmolLM's smoke parameters (the reference's) and a batch in its
    vocabulary, for a job of another arch than ``ARCH``."""
    cfg = ref_smoke(MID_HEAD)
    state = ref_init_state(cfg, RefTrainConfig(compute_dtype=jnp.float32), 1,
                           jax.random.PRNGKey(0))
    toks = make_lm_tokens(n_tokens=B * S + 1, vocab=cfg.vocab_size)
    return (params_from_jax(jax.tree.map(np.asarray, state["params"])),
            {"tokens": torch.from_numpy(toks[:-1].reshape(B, S)),
             "labels": torch.from_numpy(toks[1:].reshape(B, S))})


def _one_by_two_input():
    jobs = [dict(tc=kw, steps=STEPS) for kw in CODECS.values()]
    jobs.append(dict(tc=dict(CODECS["stc"], measure_wire=True), steps=2))
    for job in COUNTED.values():
        job = dict(job, count=True)
        if "arch" in job:
            job["params"], job["batch"] = _mid_head_inputs()
        jobs.append(job)
    return {"arch": ARCH, "params": params_from_jax(_np_params()),
            "batch": _port_batch(), "mesh": (1, 2), "jobs": jobs}


@pytest.fixture(scope="module")
def one_by_two(two_ranks):
    return two_ranks["tp_step"]


def _ref_run(kw, steps):
    """The reference's step on its model = 1 mesh in this process:
    ``(metrics a step, the last state)``."""
    cfg = ref_smoke(ARCH)
    rtc = RefTrainConfig(compute_dtype=jnp.float32, **kw)
    state = ref_init_state(cfg, rtc, 1, jax.random.PRNGKey(0))
    mesh = ref_debug_mesh(data=1, model=1)
    toks, labels = _batch()
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    set_mesh = getattr(jax, "set_mesh", None)
    metrics = []
    with (set_mesh(mesh) if set_mesh is not None else mesh):
        step = ref_make_step(cfg, mesh, rtc)
        for _ in range(steps):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def _held(port_metrics, port_state, ref_metrics, ref_state, what):
    """``tests/test_torch_mesh_train.py``'s lock-step tolerances (R15's for
    TernQuant, µ read from the reference's parameter moves)."""
    r15 = what == "ternquant"
    for pm, rm in zip(port_metrics, ref_metrics, strict=True):
        assert sorted(pm) == sorted(rm)
        for key in ("nnz_up", "nnz_down"):
            if key in rm:
                assert abs(int(pm[key]) - int(rm[key])) <= int(r15), \
                    (what, key)
        np.testing.assert_allclose(pm["loss"], rm["loss"], rtol=1e-5)
    assert sorted(port_state) == sorted(k for k in ref_state if k != "step")
    mu = float(np.abs(_flat(ref_state["params"]) - _flat(_np_params())).max())
    for key in sorted(port_state):
        if r15:
            held_r15(_flat(port_state[key]), _flat(ref_state[key]), mu)
            continue
        np.testing.assert_allclose(_flat(port_state[key]),
                                   _flat(ref_state[key]), rtol=0, atol=1e-6,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("codec", list(CODECS))
def test_one_client_two_shards_match_the_reference(one_by_two, codec):
    i = list(CODECS).index(codec)
    kw = dict(CODECS[codec])
    ref_metrics, ref_state = _ref_run(kw, STEPS)
    for out in one_by_two:
        job = out[i]
        _held(job["metrics"], job["state"], ref_metrics, ref_state, codec)
    # the replicated leaves (the norms) bitwise equal on both ranks
    cfg = get_smoke_config(ARCH)
    for a, b in zip(one_by_two[0][i]["replicated"],
                    one_by_two[1][i]["replicated"], strict=True):
        assert a.numel() == (2 * cfg.n_layers + 1) * cfg.d_model
        assert torch.equal(a, b)


def test_wire_ledger_bits_equal_the_one_shard_run(one_by_two):
    cfg = get_smoke_config(ARCH)
    tc = TrainConfig(compute_dtype=torch.float32, measure_wire=True,
                     **CODECS["stc"])
    state = init_train_state(cfg, tc, 1, device="cpu",
                             params=params_from_jax(_np_params()))
    step = make_train_step(cfg, make_debug_mesh(1, 1), tc, device="cpu")
    want = WireLedger(codec_for(tc), cfg.param_count())
    for _ in range(2):
        state, _, (msgs, gd) = step(state, _port_batch())
        want.record_round(msgs, gd)
    job = len(CODECS)
    for out in one_by_two:
        got = WireLedger(codec_for(tc), cfg.param_count())
        for msgs, gd in out[job]["wire"]:
            assert tree_leaves(msgs)[0].shape[0] == 1
            got.record_round(msgs, gd)
        assert got.summary() == want.summary()
    assert want.summary()["bits_up"] > 0


@pytest.mark.parametrize("which", list(COUNTED))
def test_flops_and_collectives_equal_the_dry_run(one_by_two, which):
    job = len(CODECS) + 1 + list(COUNTED).index(which)
    spec = COUNTED[which]
    arch = spec.get("arch", ARCH)
    cfg = dataclasses.replace(get_smoke_config(arch), **spec["cfg"])
    tc = TrainConfig(**{"compute_dtype": torch.float32, **spec["tc"]})
    mesh = make_debug_mesh(1, 2)
    rec = dryrun.lower_combo(arch, InputShape("row", S, B, "train"),
                             mesh=mesh, cfg=cfg, tc=tc, verbose=False,
                             ingest=False)
    # the gather route's q/k/v and output-gradient gathers, in the compute
    # dtype (none on whole heads)
    acts = rec["collectives"].get("model-activations-all-gather")
    assert (acts is not None) == (arch == MID_HEAD)
    for out in one_by_two:
        flops, handed = out[job]["counted"]
        handed = dict(handed)
        if acts is not None:
            key = ("model", "all_gather", str(tc.compute_dtype))
            assert handed.pop(key) == [acts["count"], acts["bytes"]]
        assert flops == rec["flops"]
        reduced = [v for (g, op, _), v in handed.items()
                   if g == "model" and op == "all_reduce"]
        want = rec["collectives"]["model-all-reduce"]
        assert [sum(c for c, _ in reduced), sum(b for _, b in reduced)] == \
            [want["count"], want["bytes"]]
        gathered = handed.get(("model", "all_gather", "torch.int32"))
        if "model-all-gather" in rec["collectives"]:
            want = rec["collectives"]["model-all-gather"]
            assert gathered == [want["count"], want["bytes"]]
            cand = handed[("model", "all_gather", "torch.float32")]
            assert cand[0] == rec["collectives_data_dependent"][
                "model-candidates-all-gather"]["count"]
        else:
            assert gathered is None
        assert not [k for k in handed if k[0] != "model"]


# -- four ranks, against the reference's own tensor-parallel mesh --------------------


# the reference's steps: argv 1 the jobs (``FOUR``), 2 the .npz to write, 3
# the arch; what follows it saves ``out``
REF_TP_STEPS = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.data import make_lm_tokens
from repro.launch.mesh import make_debug_mesh
from repro.launch.train import TrainConfig, init_train_state, make_train_step

cfg = get_smoke_config(sys.argv[3])
mesh = make_debug_mesh(data=2, model=2)
toks = make_lm_tokens(n_tokens=4 * 32 + 1, vocab=cfg.vocab_size)
batch = {"tokens": jnp.asarray(toks[:-1].reshape(4, 32)),
         "labels": jnp.asarray(toks[1:].reshape(4, 32))}
out = {}
for name, kw, steps, mask in json.loads(sys.argv[1]):
    # signSGD's votes: the clients' sign messages summed, a step
    votes = name == "signsgd"
    tc = TrainConfig(compute_dtype=jnp.float32, measure_wire=votes, **kw)
    state = init_train_state(cfg, tc, 2, jax.random.PRNGKey(0))
    step = make_train_step(cfg, mesh, tc)
    args = () if mask is None else (jnp.asarray(mask), jnp.zeros(2))
    for i in range(steps):
        res = step(state, batch, *args)
        state, m = res[0], res[1]
        for k, v in m.items():
            out[f"{name}/metrics/{i}/{k}"] = np.asarray(v)
        if votes:
            out[f"{name}/votes/{i}"] = np.concatenate(
                [np.asarray(x, np.float32).reshape(x.shape[0], -1)
                 for x in jax.tree.leaves(res[2][0])], axis=1).sum(axis=0)
    for key, tree in state.items():
        out[f"{name}/state/{key}"] = np.concatenate(
            [np.asarray(x, np.float32).reshape(x.shape[0] if key in
             ("client_res", "momentum") else 1, -1)
             for x in jax.tree.leaves(tree)], axis=1)
"""
REF_TP = REF_TP_STEPS + """
np.savez(sys.argv[2], **out)
print("REF_TP_OK")
"""
FOUR = [(name, kw, STEPS, None) for name, kw in CODECS.items()] + [
    ("masked", dict(CODECS["stc"], masked=True), 1, [1.0, 0.0])]


@pytest.fixture(scope="module")
def two_by_two(ref_tp, tmp_path_factory):
    # signSGD's messages come back (measure_wire) for its vote sums
    jobs = [dict(tc=dict(kw, measure_wire=name == "signsgd"), steps=steps,
                 mask=mask) for name, kw, steps, mask in FOUR]
    inp = {"arch": ARCH, "params": params_from_jax(_np_params()),
           "batch": _port_batch(), "mesh": (2, 2), "jobs": jobs}
    outs = _run_worker("tp_step", inp, tmp_path_factory.mktemp("tp22"),
                       ranks=4)
    proc, path = ref_tp
    stdout, stderr = proc.communicate(timeout=300)
    assert "REF_TP_OK" in stdout, stderr[-3000:]
    return outs, dict(np.load(path))


def _vote_ties(ref, job, name, steps):
    """signSGD's coordinates whose vote sum was 0 at some step:
    ``(in the reference's run, in the port's)``, the port's from its
    messages joined a step; None for the other codecs."""
    if name != "signsgd":
        return None
    port = [np.concatenate([np.asarray(x, np.float32).reshape(
        x.shape[0], -1) for x in tree_leaves(msgs)], axis=1).sum(axis=0)
        for msgs, _ in job["wire"]]
    assert len(port) == steps
    return (np.any([ref[f"{name}/votes/{s}"] == 0 for s in range(steps)],
                   axis=0),
            np.any([v == 0 for v in port], axis=0))


# signSGD's coordinates that may differ where only the port's votes tied
# (a client's gradient within an ulp of 0, so its sign, not the tie, moved)
PORT_ONLY_TIES = 2


def hold_two_by_two(outs, ref, name, steps, init):
    """One job of four ranks on ``(2, 2)`` (``outs``, rank order) against
    the reference's own step on ``make_debug_mesh(data=2, model=2)``
    (``ref``, from ``REF_TP_STEPS``); ``init`` the flat initial
    parameters.  Returns signSGD's ``{state key: (coordinates that differ,
    reference ties, port-only ties)}`` of rank 0 (None for the other
    codecs)."""
    # TernQuant: R15; signSGD: R15 too, and held to R16's cause: two
    # clients' votes tie at 0 where their gradients' signs differ, so an
    # ulp of one flips a coordinate by a step, which the one-client runs
    # cannot show; a coordinate may differ only where the reference's vote
    # sum was 0 at some step, or, for at most PORT_ONLY_TIES of them, where
    # the port's was
    loose = name in ("ternquant", "signsgd")
    ties = _vote_ties(ref, outs[0], name, steps)
    seen = None if ties is None else {}
    for rank, job in enumerate(outs):
        client = rank // 2
        assert len(job["metrics"]) == steps
        for s, pm in enumerate(job["metrics"]):
            keys = sorted(k.split("/")[-1] for k in ref
                          if k.startswith(f"{name}/metrics/{s}/"))
            assert sorted(pm) == keys
            # the reference's replicated out_spec returns client 0's
            # nnz_up; nnz_down is the server's, the same on every rank
            for key in ("nnz_up", "nnz_down") if client == 0 \
                    else ("nnz_down",):
                if key in pm:
                    want = int(ref[f"{name}/metrics/{s}/{key}"])
                    assert abs(int(pm[key]) - want) <= int(loose), \
                        (name, key)
            np.testing.assert_allclose(
                pm["loss"], float(ref[f"{name}/metrics/{s}/loss"]),
                rtol=1e-5)
        mu = float(np.abs(ref[f"{name}/state/params"][0] - init).max())
        for key, tree in job["state"].items():
            want = ref[f"{name}/state/{key}"]
            want = want[client] if key in ("client_res", "momentum") \
                else want[0]
            if loose:
                held_r15(_flat(tree), want, mu)
            else:
                np.testing.assert_allclose(_flat(tree), want, rtol=0,
                                           atol=1e-6,
                                           err_msg=f"{name} rank {rank} "
                                                   f"{key}")
            if ties is not None:
                ref_ties, port_ties = ties
                off = np.abs(_flat(tree) - want) > 1e-6
                port_only = off & ~ref_ties
                assert not np.any(port_only & ~port_ties), \
                    (name, rank, key, int(off.sum()))
                assert int(port_only.sum()) <= PORT_ONLY_TIES, \
                    (name, rank, key, int(port_only.sum()))
                if rank == 0:
                    seen[key] = (int(off.sum()), int(ref_ties.sum()),
                                 int((port_ties & ~ref_ties).sum()))
    for s in range(steps):
        reps = [job["replicated"][s] for job in outs]
        assert all(torch.equal(reps[0], r) for r in reps[1:])
    if name == "masked":                 # client 1's residual is frozen
        for rank in (2, 3):
            assert np.all(_flat(outs[rank]["state"]["client_res"]) == 0)
    return seen


@pytest.mark.parametrize("name", [name for name, *_ in FOUR])
def test_two_clients_two_shards_match_the_reference_tp_mesh(two_by_two,
                                                            name):
    outs, ref = two_by_two
    i = [n for n, *_ in FOUR].index(name)
    hold_two_by_two([out[i] for out in outs], ref, name, FOUR[i][2],
                    _flat(_np_params()))
