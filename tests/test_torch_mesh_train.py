"""Port parity of the mesh trainer (``launch/train.py``): ``make_train_step``
on one client and on two gloo client ranks spawned on the CPU.

Held against the JAX package on the smoke configs, from the reference's
initial parameters through ``params_from_jax``, at fp32:

* 3 lock-step steps of one client (no client axes) against the
  reference's ``make_train_step`` on ``make_debug_mesh(data=1, model=1)``:
  STC at p = 1/50, and FedAvg's 2 local iterations with momentum 0.9; STC
  on the deepseek (MLA and MoE) and granite (MoE, tied) smoke configs;
  every state entry (parameters, residuals, momentum) within 1e-6
  absolute, the loss within rtol 1e-5, ``nnz_up`` / ``nnz_down`` exact.
* A 2-rank STC step against the reference's host composition (per-client
  grad, tree STC, mean, server tree STC, apply), as the reference's
  ``test_distributed_stc_matches_single_device_semantics`` builds it, at
  its tolerances (rtol 5e-3, atol 5e-5); the two ranks hold bitwise the
  same parameters.
* The masked step on two ranks: mask (1, 0) gives client 0's update alone
  (baseline: ``p - lr·grad`` of rows 0:2 at the same tolerances; STC: the
  server's decode of rank 0's message, exact) and leaves rank 1's residual
  unchanged; an all-zero mask moves neither the parameters nor the server
  residual (bitwise).
* ``WireLedger``'s four columns equal the reference's on the same messages.
* The loss falls over 4 steps for stc, topk, signsgd, fedavg
  (``local_iters=2``), baseline and ternquant.
* The errors: a mask without ``masked=True``, a ``model`` axis > 1, no card
  without ``device="cpu"``, a 2-client mesh without a process group; and
  the CLI on two ranks.
"""

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
from repro.core.distributed import stc_compress_tree as ref_stc_tree
from repro.launch.mesh import make_debug_mesh as ref_debug_mesh
from repro.launch.train import TrainConfig as RefTrainConfig
from repro.launch.train import WireLedger as RefWireLedger
from repro.launch.train import codec_for as ref_codec_for
from repro.launch.train import init_train_state as ref_init_state
from repro.launch.train import make_train_step as ref_make_step
from repro.models import lm_loss as ref_lm_loss
from repro_torch.configs import get_smoke_config
from repro_torch.core.compression import tree_leaves
from repro_torch.data import make_lm_tokens
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import (TrainConfig, WireLedger, codec_for,
                                      init_train_state, make_train_step)
from repro_torch.models import params_from_jax
from repro_torch.models.transformer import lm_loss

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
CPU = "cpu"


def _flat(tree):
    leaves = (jax.tree.leaves(tree) if isinstance(
        jax.tree.leaves(tree)[0], jax.Array) else tree_leaves(tree))
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])


@functools.lru_cache(maxsize=None)
def _ref_state(arch, **tc_kw):
    tc = RefTrainConfig(compute_dtype=jnp.float32, **tc_kw)
    return ref_init_state(ref_smoke(arch), tc, 1, jax.random.PRNGKey(0))


def _np_params(arch):
    return jax.tree.map(np.asarray, _ref_state(arch)["params"])


def _lm_batch(vocab, b=4, s=32):
    toks = make_lm_tokens(n_tokens=b * s + 1, vocab=vocab)
    return toks[:-1].reshape(b, s), toks[1:].reshape(b, s)


# -- one client ------------------------------------------------------------------


LOCKSTEP = {
    "stc": dict(protocol="stc", lr=0.05, sparsity_up=1 / 50,
                sparsity_down=1 / 50),
    "fedavg_momentum": dict(protocol="fedavg", lr=0.05, local_iters=2,
                            momentum=0.9),
}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_single_client_lockstep_with_reference(case):
    pstate, pm = _lockstep("smollm-135m", LOCKSTEP[case])
    assert int(pstate["step"]) == 3
    lead = "client_res" if case == "stc" else "momentum"
    assert tuple(pstate[lead]["embed"].shape) == (1, 512, 96)
    if case == "stc":
        assert int(pm["nnz_up"]) == 4924


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "granite-moe-3b-a800m"])
def test_moe_single_client_lockstep_with_reference(arch):
    """STC at p = 1/50 on a MoE smoke config (deepseek: MLA and MoE blocks
    after a dense first layer; granite: attention and MoE, tied), the MoE
    aux loss in the loss."""
    pstate, pm = _lockstep(arch, LOCKSTEP["stc"])
    assert int(pstate["step"]) == 3
    cfg = get_smoke_config(arch)
    moe = pstate["client_res"]["blocks"][cfg.moe.first_dense]["moe"]
    assert tuple(moe["w_up"].shape) == (1, cfg.moe.n_experts, cfg.d_model,
                                        cfg.moe.d_expert)
    assert int(pm["nnz_up"]) >= int(cfg.param_count() / 50)


def _lockstep(arch, kw):
    """3 lock-step steps of one client against the reference's
    ``make_train_step``: the metrics' keys and counts, the loss and every
    state entry as the module docstring says.  Returns the port's last
    state and metrics."""
    cfg = ref_smoke(arch)
    toks, labels = _lm_batch(cfg.vocab_size)
    rtc = RefTrainConfig(compute_dtype=jnp.float32, **kw)
    rstate = ref_init_state(cfg, rtc, 1, jax.random.PRNGKey(0))
    mesh = ref_debug_mesh(data=1, model=1)
    set_mesh = getattr(jax, "set_mesh", None)
    with (set_mesh(mesh) if set_mesh is not None else mesh):
        rstep = ref_make_step(cfg, mesh, rtc)
        tc = TrainConfig(compute_dtype=torch.float32, **kw)
        pstate = init_train_state(
            get_smoke_config(arch), tc, 1, device=CPU,
            params=jax.tree.map(np.asarray, rstate["params"]))
        pstep = make_train_step(get_smoke_config(arch),
                                make_debug_mesh(data=1, model=1), tc,
                                device=CPU)
        rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        pb = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
        for _ in range(3):
            rstate, rm = rstep(rstate, rb)
            pstate, pm = pstep(pstate, pb)
            assert sorted(pm) == sorted(rm)
            for key in ("nnz_up", "nnz_down"):
                if key in rm:
                    assert int(pm[key]) == int(rm[key])
            np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                       rtol=1e-5)
            assert sorted(pstate) == sorted(rstate)
            for key in sorted(pstate):
                np.testing.assert_allclose(_flat(pstate[key]),
                                           _flat(rstate[key]), rtol=0,
                                           atol=1e-6, err_msg=key)
    return pstate, pm


@pytest.mark.parametrize("protocol", ["stc", "topk", "signsgd", "fedavg",
                                      "baseline", "ternquant"])
def test_loss_falls_over_four_steps(protocol):
    cfg = get_smoke_config("smollm-135m")
    toks, labels = _lm_batch(cfg.vocab_size, 4, 128)
    tc = TrainConfig(protocol=protocol, lr=0.05, sparsity_up=1 / 50,
                     sparsity_down=1 / 50,
                     local_iters=2 if protocol == "fedavg" else 1)
    state = init_train_state(cfg, tc, 1, key=0, device=CPU)
    step = make_train_step(cfg, make_debug_mesh(data=1, model=1), tc,
                           device=CPU)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    losses = []
    for _ in range(4):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses


def test_wire_ledger_matches_reference():
    arch = "smollm-135m"
    cfg = get_smoke_config(arch)
    toks, labels = _lm_batch(cfg.vocab_size)
    tc = TrainConfig(protocol="stc", lr=0.05, sparsity_up=1 / 50,
                     sparsity_down=1 / 50, compute_dtype=torch.float32,
                     measure_wire=True)
    state = init_train_state(cfg, tc, 1, device=CPU, params=_np_params(arch))
    step = make_train_step(cfg, make_debug_mesh(data=1, model=1), tc,
                           device=CPU)
    ledger = WireLedger(codec_for(tc), cfg.param_count())
    ref_ledger = RefWireLedger(ref_codec_for(RefTrainConfig(
        protocol="stc", sparsity_up=1 / 50, sparsity_down=1 / 50)),
        cfg.param_count())
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    for _ in range(2):
        state, _, (msgs, gd) = step(state, batch)
        assert tree_leaves(msgs)[0].shape[0] == 1
        ledger.record_round(msgs, gd)
        ref_ledger.record_round(
            jax.tree.map(lambda x: jnp.asarray(x.numpy()), msgs),
            jax.tree.map(lambda x: jnp.asarray(x.numpy()), gd))
    assert ledger.summary() == ref_ledger.summary()
    assert ledger.summary()["bits_up"] > 0


def test_mask_needs_masked_mode():
    cfg = get_smoke_config("smollm-135m")
    tc = TrainConfig(compute_dtype=torch.float32)
    state = init_train_state(cfg, tc, 1, device=CPU)
    step = make_train_step(cfg, make_debug_mesh(data=1, model=1), tc,
                           device=CPU)
    toks, labels = _lm_batch(cfg.vocab_size, 2, 8)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    with pytest.raises(ValueError, match="masked"):
        step(state, batch, torch.ones(1), torch.zeros(1))


def test_model_axis_and_missing_card_and_group_raise():
    cfg = get_smoke_config("smollm-135m")
    tc = TrainConfig()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(cfg, make_debug_mesh(data=1, model=2), tc,
                        device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(cfg, make_debug_mesh(data=1, model=1), tc)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_train_state(cfg, tc, 1)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_train_step(cfg, make_debug_mesh(data=2, model=1), tc,
                        device=CPU)


# -- two gloo ranks ---------------------------------------------------------------


def _run_worker(case, inp, tmp_path):
    inp_path, out_path = tmp_path / "in.pt", tmp_path / "out.pt"
    torch.save(inp, inp_path)
    out = subprocess.run([sys.executable,
                          os.path.join(HERE, "_torch_mesh_worker.py"), case,
                          str(inp_path), str(out_path)],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    return [torch.load(f"{out_path}.{r}", weights_only=False)
            for r in range(2)]


ARCH2 = "qwen2-0.5b"
STC2 = dict(protocol="stc", lr=0.1, sparsity_up=1 / 20, sparsity_down=1 / 20)
JOBS = [
    (STC2, None, None, {}),
    (dict(protocol="baseline", lr=0.1, masked=True), [1.0, 0.0], [0.0, 0.0],
     {}),
    (dict(protocol="baseline", lr=0.1, masked=True), [0.0, 0.0], [0.0, 0.0],
     {}),
    (dict(STC2, masked=True), [0.0, 0.0], [0.0, 0.0], {"server_res": 0.01}),
    (dict(STC2, masked=True), [1.0, 0.0], [0.0, 0.0], {"client_res": 0.02}),
]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    cfg = ref_smoke(ARCH2)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    params = params_from_jax(_np_params(ARCH2))
    jobs = []
    for kw, mask, stal, fills in JOBS:
        overrides = {}
        for key, value in fills.items():
            lead = (1,) if key == "client_res" else ()
            overrides[key] = jax.tree.map(
                lambda x: torch.full(lead + x.shape, value), _np_params(ARCH2))
        jobs.append((kw, mask, stal, overrides))
    inp = {"arch": ARCH2, "params": params, "jobs": jobs,
           "batch": {"tokens": torch.from_numpy(toks),
                     "labels": torch.from_numpy(toks)}}
    return toks, _run_worker("step", inp, tmp_path_factory.mktemp("step"))


def _ref_grad(toks, sl):
    cfg = ref_smoke(ARCH2)
    return jax.grad(lambda p: ref_lm_loss(p, cfg, toks[sl], toks[sl],
                                          compute_dtype=jnp.float32))(
        _ref_state(ARCH2)["params"])


def test_two_rank_stc_step_matches_reference_composition(two_ranks):
    toks, outs = two_ranks
    params = _ref_state(ARCH2)["params"]
    numel = ref_smoke(ARCH2).param_count()
    msgs = []
    for sl in (slice(0, 2), slice(2, 4)):
        delta = jax.tree.map(lambda u: -STC2["lr"] * u, _ref_grad(toks, sl))
        msgs.append(ref_stc_tree(delta, STC2["sparsity_up"], numel=numel)[0])
    mean = jax.tree.map(lambda a, b: (a + b) / 2, *msgs)
    down, _ = ref_stc_tree(mean, STC2["sparsity_down"], numel=numel)
    want = _flat(jax.tree.map(lambda p, d: p + d, params, down))
    got = [_flat(out[0][0]["params"]) for out in outs]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want, rtol=5e-3, atol=5e-5)
    metrics = [out[0][1] for out in outs]
    assert int(metrics[0]["nnz_down"]) == int(metrics[1]["nnz_down"])


def test_two_rank_masked_baseline_is_client_zero_alone(two_ranks):
    toks, outs = two_ranks
    params = _ref_state(ARCH2)["params"]
    g = _ref_grad(toks, slice(0, 2))
    want = _flat(jax.tree.map(lambda p, gg: p - 0.1 * gg, params, g))
    for out in outs:
        np.testing.assert_allclose(_flat(out[1][0]["params"]), want,
                                   rtol=5e-3, atol=5e-5)
        # nothing arrives: the parameters do not move
        np.testing.assert_array_equal(_flat(out[2][0]["params"]),
                                      _flat(params))


def test_two_rank_zero_mask_freezes_stc_server(two_ranks):
    _, outs = two_ranks
    for out in outs:
        new_state = out[3][0]
        np.testing.assert_array_equal(_flat(new_state["params"]),
                                      _flat(_ref_state(ARCH2)["params"]))
        assert np.all(_flat(new_state["server_res"]) == np.float32(0.01))


def test_two_rank_masked_stc_is_rank_zero_message_alone(two_ranks):
    """mask (1, 0): rank 1's residual is unchanged, and the update is the
    server's decode of rank 0's message alone."""
    toks, outs = two_ranks
    cfg = get_smoke_config(ARCH2)
    tc = TrainConfig(compute_dtype=torch.float32, **STC2)
    codec = codec_for(tc)
    params = params_from_jax(_np_params(ARCH2))
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    t = torch.from_numpy(toks[:2])
    grads = torch.autograd.grad(lm_loss(params, cfg, t, t,
                                        compute_dtype=torch.float32), leaves)
    res = jax.tree.map(lambda x: torch.full(x.shape, 0.02),
                       _np_params(ARCH2))
    delta = jax.tree.unflatten(jax.tree.structure(_np_params(ARCH2)),
                               [-0.1 * g.detach() for g in grads])
    msg, _, _ = codec.tree_encode(delta, res, numel=cfg.param_count())
    down, _, _ = codec.tree_decode(
        msg, jax.tree.map(lambda x: torch.zeros(x.shape), _np_params(ARCH2)),
        numel=cfg.param_count())
    want = _flat(_np_params(ARCH2)) + _flat(down)
    for rank, out in enumerate(outs):
        new_state = out[4][0]
        np.testing.assert_array_equal(_flat(new_state["params"]), want)
    assert np.all(_flat(outs[1][4][0]["client_res"]) == np.float32(0.02))
    assert not np.all(_flat(outs[0][4][0]["client_res"]) == np.float32(0.02))


def test_cli_on_two_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--ranks", "2", "--steps", "2", "--measure-wire"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("step ") == 2
    assert "wire ledger over 2 rounds" in out.stdout
