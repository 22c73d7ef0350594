"""The port's dry run (``launch/dryrun.py``).

* ``step_flops`` equals ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the port's own steps exactly, at every arch's smoke config on
  the CPU: the train step (STC, and FedAvg's two local microbatches), with
  remat on too (the checkpoint's recompute), the prefill and the decode
  steps; the MoE archs also on the capacity dispatch; and past one
  1,024-key flash chunk (1,025 positions, whisper's 1,025 frames).
* ``measured_ingest_bytes`` (the ``"kernel"`` wire backend on the CPU, and
  ``"numpy"``) and ``fleet_event_stats`` equal the reference's.
* ``python -m repro_torch.launch.dryrun --all`` (and ``--multi-pod``) with
  ``--device cpu`` writes the 40 records; a record's fields; a lever the
  port lacks raises; on one card the record's state bytes are the bytes
  ``init_train_state`` allocates.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host
devices) when imported; the fixture starts JAX's backend first and puts
the variable back, so no later test in the worker sees it.
"""

import dataclasses
import json
import os

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import train as ref_train
from repro_torch import configs
from repro_torch.core.compression import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.serve import make_decode_step, make_prefill_step
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step)
from repro_torch.models import encode_frames, init_cache

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B, S, S_CACHE = 2, 32, 24
PROTOCOLS = ("stc", "signsgd", "topk", "ternquant", "fedavg", "baseline")


@pytest.fixture(scope="module")
def ref_dryrun():
    jax.devices()               # the backend starts with this worker's flags
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return ref


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _batch(cfg):
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    return {"tokens": toks, "labels": toks.roll(1, 1),
            **configs.stand_in_inputs(cfg, B, scale=0.1)}


def _train_flops(cfg, tc, batch) -> int:
    state = init_train_state(cfg, tc, 1, 0, device="cpu")
    step = make_train_step(cfg, make_debug_mesh(1, 1), tc, device="cpu")
    return _count(lambda: step(state, batch))


def _params(cfg):
    return init_train_state(cfg, TrainConfig(), 1, 0, device="cpu")["params"]


def _variants(arch):
    cfg = configs.get_smoke_config(arch)
    out = [cfg, dataclasses.replace(cfg, remat=True)]
    if cfg.moe is not None:
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch="capacity")))
    return out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_flops_equal_the_flop_counter(arch):
    mesh = make_debug_mesh(1, 1)
    for cfg in _variants(arch):
        batch = _batch(cfg)
        for proto, iters in (("stc", 1), ("fedavg", 2)):
            tc = TrainConfig(protocol=proto, local_iters=iters,
                             compute_dtype=torch.float32)
            assert _train_flops(cfg, tc, batch) == dryrun.step_flops(
                cfg, "train", B, S, local_iters=iters), (cfg, proto)
        params = _params(cfg)
        prefill = make_prefill_step(cfg, mesh, torch.float32, device="cpu")
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        assert _count(lambda: prefill(params, inputs)) == \
            dryrun.step_flops(cfg, "prefill", B, S), cfg
        decode = make_decode_step(cfg, mesh, torch.float32, device="cpu")
        caches = init_cache(cfg, B, S_CACHE, torch.float32, device="cpu")
        memory = None
        if cfg.encoder is not None:
            with torch.inference_mode():
                memory = encode_frames(params, cfg, batch["frames"])
        assert _count(lambda: decode(params, batch["tokens"][:, :1], caches,
                                     memory=memory)) == \
            dryrun.step_flops(cfg, "decode", B, S_CACHE), cfg


def _long_seq(cfg) -> int:
    """The shortest sequence past one 1,024-key flash chunk: 1,025, or for
    the SSD (whose scan splits the sequence into whole chunks) the next
    multiple of its chunk."""
    if cfg.ssm is None:
        return 1025
    return -(-1025 // cfg.ssm.chunk) * cfg.ssm.chunk


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_flops_equal_the_flop_counter_past_one_flash_chunk(arch):
    """Past 1,024 keys the flash scan runs a second, zero-padded chunk:
    the train step with remat on, the prefill and the decode at one row
    counted by ``FlopCounterMode`` equal ``step_flops``; whisper's encoder
    sees 1,025 frames (two chunks in the encoder and the cross-attention).
    """
    cfg = dataclasses.replace(configs.get_smoke_config(arch), remat=True)
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_frames=1025))
    s = _long_seq(cfg)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (1, s), generator=gen)
    batch = {"tokens": toks, "labels": toks.roll(1, 1),
             **configs.stand_in_inputs(cfg, 1, scale=0.1)}
    tc = TrainConfig(protocol="stc", compute_dtype=torch.float32)
    assert _train_flops(cfg, tc, batch) == dryrun.step_flops(
        cfg, "train", 1, s), cfg
    mesh = make_debug_mesh(1, 1)
    params = _params(cfg)
    prefill = make_prefill_step(cfg, mesh, torch.float32, device="cpu")
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    assert _count(lambda: prefill(params, inputs)) == \
        dryrun.step_flops(cfg, "prefill", 1, s), cfg
    decode = make_decode_step(cfg, mesh, torch.float32, device="cpu")
    caches = init_cache(cfg, 1, s, torch.float32, device="cpu")
    memory = None
    if cfg.encoder is not None:
        with torch.inference_mode():
            memory = encode_frames(params, cfg, batch["frames"])
    assert _count(lambda: decode(params, toks[:, :1], caches,
                                 memory=memory)) == \
        dryrun.step_flops(cfg, "decode", 1, s), cfg


def test_step_flops_counts_every_flash_chunk():
    """A sequence of 1,025 positions scans two key chunks of 1,024, the
    second zero-padded: the count is that of 2,048 keys."""
    cfg = configs.get_smoke_config("smollm-135m")
    one = dryrun.step_flops(cfg, "prefill", 1, 1024)
    two = dryrun.step_flops(cfg, "prefill", 1, 1025)
    h, hd, layers = cfg.n_heads, cfg.resolved_head_dim, cfg.n_layers

    def scan(queries, keys):    # q·kᵀ and p·v, every layer
        return layers * 2 * h * queries * keys * 2 * hd

    head = 2 * cfg.d_model * cfg.vocab_size     # the last position only
    per_token, rest = divmod(one - scan(1024, 1024) - head, 1024)
    assert rest == 0
    assert two == scan(1025, 2048) + 1025 * per_token + head
    with pytest.raises(ValueError):
        dryrun.step_flops(cfg, "serve", 1, 8)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_measured_ingest_bytes_equal_the_reference(protocol, ref_dryrun):
    for numel, n_clients in ((1000, 3), (3_000_000, 16)):
        want = ref_dryrun.measured_ingest_bytes(
            ref_train.TrainConfig(protocol=protocol), numel, n_clients,
            sample_cap=1 << 20)
        for backend in ("kernel", "numpy"):
            got = dryrun.measured_ingest_bytes(
                TrainConfig(protocol=protocol), numel, n_clients,
                sample_cap=1 << 20, wire_backend=backend, device="cpu")
            assert got == want, (backend, numel)


@pytest.mark.parametrize("n_clients", [8, 16, 32])
def test_fleet_event_stats_equal_the_reference(n_clients, ref_dryrun):
    assert dryrun.fleet_event_stats(n_clients) == \
        ref_dryrun.fleet_event_stats(n_clients)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cli_sizes_all_forty_combinations(multi_pod, tmp_path, capsys,
                                          monkeypatch):
    from repro_torch.models import transformer

    def no_draw(key):
        raise AssertionError("the dry run drew parameters")

    monkeypatch.setattr(transformer, "_generator", no_draw)
    argv = ["--all", "--device", "cpu", "--out", str(tmp_path)]
    dryrun.main(argv + (["--multi-pod"] if multi_pod else []))
    mesh = "2x16x16" if multi_pod else "16x16"
    assert f"all 40 combinations sized on mesh {mesh}" in \
        capsys.readouterr().out
    files = sorted(tmp_path.iterdir())
    assert len(files) == 40
    for path in files:
        rec = json.loads(path.read_text())
        assert rec["mesh"] == mesh
        assert "temp_size_in_bytes" not in rec["memory"]
        assert rec["not_measured"] == ["temp_size_in_bytes"]
        assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
        assert rec["roofline"]["card"] == "NVIDIA H100 80GB HBM3"
        assert set(rec["roofline"]) >= {"t_compute_s", "t_memory_s",
                                         "t_collective_s", "dominant"}
        # the attention family, dense or MoE, runs the model axis of 16
        # (tensor parallelism's collectives counted); the other families do
        # not
        dense = rec["arch"] in ("smollm-135m", "qwen2-0.5b",
                                "phi3-medium-14b", "granite-moe-3b-a800m",
                                "moonshot-v1-16b-a3b")
        tp = {k for k in rec["collectives"] if k.startswith("model-")}
        assert bool(tp) == dense, (rec["arch"], rec["shape"])
        if rec["kind"] == "train":
            assert rec["collectives"]["all-reduce"]["count"] == 1
            assert rec["server_ingest"]["n_clients"] == (32 if multi_pod
                                                         else 16)
            assert rec["fleet_scenarios"]
        else:
            assert set(rec["collectives"]) == tp
        if rec["kind"] == "decode":
            assert rec["memory"]["alias_size_in_bytes"] == \
                rec["memory"]["arguments"]["caches"]


def test_record_on_one_card_is_what_init_train_state_allocates():
    """On ``make_debug_mesh(1, 1)`` the record's state bytes are the bytes
    of the state ``init_train_state`` builds, and its flops the step's."""
    cfg = dataclasses.replace(configs.get_smoke_config("smollm-135m"),
                              n_layers=3)
    tc = TrainConfig(protocol="stc", compute_dtype=torch.float32)
    shape = configs.InputShape("row", S, B, "train")
    rec = dryrun.lower_combo("smollm-135m", shape, mesh=make_debug_mesh(1, 1),
                             cfg=cfg, tc=tc, device="cpu", verbose=False)
    state = init_train_state(cfg, tc, 1, 0, device="cpu")
    assert rec["memory"]["arguments"]["state"] == sum(
        t.numel() * t.element_size() for t in tree_leaves(state))
    assert rec["flops"] == _train_flops(cfg, tc, _batch(cfg))
    assert rec["mesh"] == "1x1" and rec["collectives"] == {}
    assert rec["server_ingest"]["n_clients"] == 1


def test_levers():
    with pytest.raises(NotImplementedError, match="bf16"):
        dryrun.lower_combo("smollm-135m", "train_4k", flash_bf16=True,
                           verbose=False, ingest=False)
    heads = dryrun.lower_combo("qwen2-0.5b", "decode_32k", verbose=False)
    hd = dryrun.lower_combo("qwen2-0.5b", "decode_32k", cache_shard="hd",
                            verbose=False)
    # 2 KV heads do not split 16 ways; head_dim 64 does
    assert hd["memory"]["arguments"]["caches"] * 16 == pytest.approx(
        heads["memory"]["arguments"]["caches"], rel=1e-6)
    for pin in ("batch", "local", "seq"):
        with pytest.raises(NotImplementedError, match="pins no cache"):
            dryrun.lower_combo("qwen2-0.5b", "decode_32k", cache_shard=pin,
                               verbose=False)
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k",
                     "--logit-chunk", "512"])
