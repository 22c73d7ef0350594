"""Port parity of prefill and decode under tensor parallelism: a mesh
``model`` axis of 2 over two gloo ranks on the CPU
(``tests/_torch_mesh_worker.py``, case ``tp_serve``), on the smoke configs
of ``qwen2-0.5b`` and ``phi3-medium-14b`` (4 query and 2 KV heads each:
whole heads on two ranks), from the reference's initial parameters (QKV
biases drawn, where the arch has them) through ``params_from_jax``, at
fp32, with a 16-token prompt and 8 more decode steps of seeded numpy
tokens.

* Each rank's prefill logits and its 24 teacher-forced decode steps'
  logits against the port's ``model = 1`` steps on the joined weights,
  and against the reference's ``make_prefill_step`` /
  ``make_decode_step`` on ``make_debug_mesh(1, 2)`` in a subprocess with
  two host devices (parameters placed by ``param_shardings``, caches by
  ``cache_specs``), within rtol 1e-5 of the largest |logit|; the two
  ranks' logits bitwise equal.
* Each rank's caches hold ``n_kv_heads // 2`` heads, with the bytes of its
  stand-ins from ``serve_state_structs`` (and the reference's caches the
  same shard shape).
* A decode step hands gloo ``2·L + 2`` collectives: the embedding's sum,
  two a layer, the logits' gather; a bf16 prefill and decode step hand it
  what the dry run's records at ``model = 2`` list.
* Which archs and cache modes the serve steps refuse, and the ROADMAP item
  each names (no spawn).
"""

import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import init_model as ref_init_model
from repro_torch.configs import ARCH_IDS, InputShape, get_config, \
    get_smoke_config
from repro_torch.core.compression import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import (CACHE_MODES, make_decode_step,
                                      make_prefill_step, serve_gap,
                                      serve_state_structs)
from repro_torch.models import attention, init_cache, params_from_jax
from repro_torch.sharding.tensor_parallel import (TensorParallel, arch_gap,
                                                  gather_vocab)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SRC = os.path.join(REPO, "src")
ARCHS = ("qwen2-0.5b", "phi3-medium-14b")
B, PROMPT, TAIL = 2, 16, 8
STEPS = PROMPT + TAIL
# the split sums each attention and MLP output as two partial products
# and an all_reduce where the unsplit step runs one product: fp32 order
# noise, ~1e-7 of the largest logit; the reference's GSPMD split orders its
# sums its own way
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _np_params(arch):
    """The reference's initial parameters as numpy, the QKV biases (zeros
    at init) drawn from a seed where the arch has them."""
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


@functools.lru_cache(maxsize=None)
def _tokens(arch):
    return np.random.default_rng(1).integers(
        0, ref_smoke(arch).vocab_size, (B, STEPS)).astype(np.int64)


def _close_to_max(got, want, rtol=RTOL):
    """``tests/test_torch_tensor_parallel.py``'s rule: every entry within
    ``rtol`` of the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


REF_SERVE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.launch.mesh import make_debug_mesh
from repro.launch.serve import make_decode_step, make_prefill_step
from repro.models import init_cache, init_model
from repro.sharding.rules import cache_specs, fit_spec, param_shardings

inp = np.load(sys.argv[1])
prompt_len = int(inp["prompt_len"])
mesh = make_debug_mesh(data=1, model=2)
out = {}
for arch in sys.argv[3].split(","):
    cfg = get_smoke_config(arch)
    shapes = jax.eval_shape(lambda: init_model(cfg, jax.random.PRNGKey(0)))
    leaves, treedef = jax.tree.flatten(shapes)
    params = treedef.unflatten([jnp.asarray(inp[f"{arch}/param/{i}"])
                                for i in range(len(leaves))])
    params = jax.device_put(params, param_shardings(params, mesh))
    toks = inp[f"{arch}/tokens"]
    b, steps = toks.shape
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
    step = make_decode_step(cfg, mesh, jnp.float32)
    logits = []
    for t in range(steps):
        lg, placed = step(params, jnp.asarray(toks[:, t:t + 1]), placed)
        logits.append(np.asarray(lg))
    out[f"{arch}/decode"] = np.concatenate(logits, axis=1)
np.savez(sys.argv[2], **out)
print("REF_SERVE_OK")
"""


@pytest.fixture(scope="module")
def ref_serve(tmp_path_factory):
    """The reference's steps on two host devices, started first so that it
    runs beside the port's ranks."""
    where = tmp_path_factory.mktemp("ref_serve")
    inp = {"prompt_len": np.asarray(PROMPT)}
    for arch in ARCHS:
        inp[f"{arch}/tokens"] = _tokens(arch)
        for i, leaf in enumerate(jax.tree.leaves(_np_params(arch))):
            inp[f"{arch}/param/{i}"] = leaf
    np.savez(where / "in.npz", **inp)
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SERVE, str(where / "in.npz"),
         str(where / "out.npz"), ",".join(ARCHS)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    yield proc, where / "out.npz"
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def ranks(ref_serve, tmp_path_factory):
    """One spawn of two ranks serving both archs (``tp_serve``)."""
    where = tmp_path_factory.mktemp("tp_serve")
    inp = {arch: {"params": _np_params(arch),
                  "prompt": torch.from_numpy(_tokens(arch)[:, :PROMPT]),
                  "tail": torch.from_numpy(_tokens(arch)[:, PROMPT:])}
           for arch in ARCHS}
    torch.save(inp, where / "in.pt")
    out = subprocess.run([sys.executable,
                          os.path.join(HERE, "_torch_mesh_worker.py"),
                          "tp_serve", str(where / "in.pt"),
                          str(where / "out.pt"), "2"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    assert not os.path.exists(where / "out.pt.rendezvous")
    return [torch.load(where / f"out.pt.{r}", weights_only=False)
            for r in range(2)]


@pytest.fixture(scope="module")
def ref(ref_serve):
    proc, path = ref_serve
    stdout, stderr = proc.communicate(timeout=300)
    assert "REF_SERVE_OK" in stdout, stderr[-3000:]
    return dict(np.load(path))


@functools.lru_cache(maxsize=None)
def _one_rank(arch):
    """The port's ``model = 1`` steps on the joined weights:
    ``{"prefill": (B, 1, V), "decode": (B, STEPS, V)}``."""
    cfg = get_smoke_config(arch)
    mesh = make_debug_mesh(1, 1)
    params = params_from_jax(_np_params(arch))
    toks = torch.from_numpy(_tokens(arch))
    prefill = make_prefill_step(cfg, mesh, torch.float32, device="cpu")(
        params, {"tokens": toks[:, :PROMPT]})
    step = make_decode_step(cfg, mesh, torch.float32, device="cpu")
    caches = init_cache(cfg, B, STEPS, torch.float32, device="cpu")
    logits = []
    for t in range(STEPS):
        lg, caches = step(params, toks[:, t:t + 1], caches)
        logits.append(lg)
    return {"prefill": prefill, "decode": torch.cat(logits, dim=1)}


@pytest.mark.parametrize("which", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_match_one_rank_and_the_reference(ranks, ref, arch,
                                                    which):
    cfg = get_smoke_config(arch)
    got = [out[arch][which] for out in ranks]
    assert torch.equal(got[0], got[1])        # every rank the whole logits
    n = 1 if which == "prefill" else STEPS
    assert tuple(got[0].shape) == (B, n, cfg.vocab_size)
    assert got[0].dtype == torch.float32
    _close_to_max(got[0], _one_rank(arch)[which])
    _close_to_max(got[0], ref[f"{arch}/{which}"])


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_kv_heads_at_the_stand_ins_bytes(ranks, ref,
                                                              arch):
    cfg = get_smoke_config(arch)
    mesh = make_debug_mesh(1, 2)
    heads = cfg.n_kv_heads // 2
    want = (B, STEPS, heads, cfg.resolved_head_dim)
    _, structs = serve_state_structs(cfg, mesh, B, STEPS, torch.float32)
    stand_in_bytes = sum(x.device_bytes() for x in tree_leaves(structs)
                         if hasattr(x, "device_bytes"))
    for out in ranks:
        assert out[arch]["cache"] == [[want, want, ()]] * cfg.n_layers
        assert out[arch]["cache_bytes"] == stand_in_bytes
    assert tuple(ref[f"{arch}/cache_shard"]) == want


def _handed(log, dtype):
    """A ``_Handed`` log as the dry run's collectives over the model
    group."""
    assert all(g == "model" and d == dtype for g, _, d in log), log
    return {f"model-{op.replace('_', '-')}": {"count": c, "bytes": nbytes}
            for (_, op, _), (c, nbytes) in log.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_a_decode_step_issues_two_per_layer_and_two_collectives(ranks,
                                                                 arch):
    cfg = get_smoke_config(arch)
    d, v = cfg.d_model, cfg.vocab_size
    acts = 2 * cfg.n_layers + 1
    for out in ranks:
        got = _handed(out[arch]["decode_handed"], "torch.float32")
        assert got == {"model-all-reduce": {"count": acts,
                                            "bytes": acts * B * d * 4},
                       "model-all-gather": {"count": 1,
                                            "bytes": B * v * 4}}
        assert sum(rec["count"] for rec in got.values()) == \
            2 * cfg.n_layers + 2


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_the_dry_run_lists_what_a_serve_step_hands_gloo(ranks, arch, kind):
    cfg = get_smoke_config(arch)
    seq = PROMPT if kind == "prefill" else STEPS
    rec = dryrun.lower_combo(arch, InputShape("row", seq, B, kind),
                             mesh=make_debug_mesh(1, 2), cfg=cfg,
                             verbose=False, ingest=False)
    want = {name: {k: c[k] for k in ("count", "bytes")}
            for name, c in rec["collectives"].items()}
    assert set(want) == {"model-all-reduce", "model-all-gather"}
    assert not [a for a in rec["assumptions"] if "not counted" in a]
    for out in ranks:
        assert _handed(out[arch][f"bf16_{kind}_handed"],
                       "torch.bfloat16") == want


# -- what the serve steps refuse ---------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_what_serving_runs_under_tensor_parallelism(arch):
    """The train step's archs run: the attention family, dense or MoE, at
    ``model`` 2, 4 and 16, on whole heads or not; the other families name
    item 4c, and both steps raise with that message; the dry run then
    counts no tensor-parallel collective and says so.  ``model = 1``
    always runs."""
    dense = arch in ("qwen2-0.5b", "phi3-medium-14b", "smollm-135m",
                     "granite-moe-3b-a800m", "moonshot-v1-16b-a3b")
    want = None if dense else "item 4c"
    mesh = make_debug_mesh(1, 2)
    for cfg in (get_config(arch), get_smoke_config(arch)):
        for m in (2, 4, 16):
            gap = serve_gap(cfg, make_debug_mesh(1, m))
            assert gap == arch_gap(cfg, make_debug_mesh(1, m))
            assert (gap is None) if want is None else (want in gap), gap
        assert serve_gap(cfg, make_debug_mesh(2, 1)) is None
    cfg = get_smoke_config(arch)
    rec = dryrun.lower_combo(arch, InputShape("row", 8, 2, "decode"),
                             mesh=mesh, cfg=cfg, verbose=False,
                             ingest=False)
    if want is None:
        assert rec["collectives"]
        assert not [a for a in rec["assumptions"] if "not counted" in a]
        return
    for make in (make_prefill_step, make_decode_step):
        with pytest.raises(NotImplementedError, match=want):
            make(cfg, mesh, device="cpu")
    assert rec["collectives"] == {}
    assert [a for a in rec["assumptions"] if "not counted" in a]


@pytest.mark.parametrize("mode", [m for m in CACHE_MODES if m != "heads"])
@pytest.mark.parametrize("arch", ARCHS)
def test_other_cache_modes_raise_under_tensor_parallelism(arch, mode):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError,
                       match="item 4b, the other cache modes"):
        make_decode_step(cfg, make_debug_mesh(1, 2), cache_mode=mode,
                         device="cpu")
    assert serve_gap(cfg, make_debug_mesh(1, 1), mode) is None
    make_decode_step(cfg, make_debug_mesh(1, 1), cache_mode=mode,
                     device="cpu")
    rec = dryrun.tp_serve_collectives(cfg, make_debug_mesh(1, 2), "decode",
                                      B, STEPS, mode)
    assert rec == {}


def test_the_rank_cache_and_cross_attention_refuse_what_they_do_not_split():
    """``init_cache(model=2)`` allocates KV heads only where they split,
    the whole cache where they do not (SmolLM's one KV head), and raises on
    a cache of another kind; the decode's cross-attention under ``tp``
    names item 4c; the logits' gather is the identity without ``tp``."""
    smollm = get_smoke_config("smollm-135m")
    assert [tuple(c.k.shape) for c in init_cache(
        smollm, 1, 4, device="meta", model=2)] == \
        [(1, 4, smollm.n_kv_heads, smollm.resolved_head_dim)] * \
        smollm.n_layers
    with pytest.raises(NotImplementedError, match="item 4c"):
        init_cache(get_smoke_config("mamba2-370m"), 1, 4, device="meta",
                   model=2)
    qwen = get_smoke_config("qwen2-0.5b")
    whole = init_cache(qwen, 2, 4, device="meta")
    half = init_cache(qwen, 2, 4, device="meta", model=2)
    assert [c.k.shape[2] for c in whole] == [2] * qwen.n_layers
    assert [c.k.shape[2] for c in half] == [1] * qwen.n_layers
    params = params_from_jax(_np_params("qwen2-0.5b"))
    x = torch.zeros(1, 1, qwen.d_model)
    with pytest.raises(NotImplementedError, match="item 4c"):
        attention.attn_decode(params["blocks"][0]["mix"], x, whole[0],
                              n_heads=2, n_kv_heads=1, head_dim=32,
                              memory=torch.zeros(1, 3, qwen.d_model),
                              tp=TensorParallel(None, 0, 2))
    logits = torch.randn(2, 1, 8)
    assert gather_vocab(logits, None) is logits
