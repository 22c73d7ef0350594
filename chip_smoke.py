#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; fails without them.  Phases:

1. build the three CUDA kernels from ``src/repro_torch/csrc`` into
   ``build/kernels/`` (one ``nvcc`` per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and on adversarial rows: ``stc_apply`` bitwise,
   histogram counts exact and sums within rtol 1e-6, selection threshold
   and count exact, ``pack_bits`` words identical;
3. train the paper CNN at full width with STC (the configuration of
   ``examples/federated_noniid.py``: 10 clients, 2 classes each, p = 1/50
   up and down, lr 0.05, 40 rounds) through ``backend="kernel"`` and
   ``wire_backend="kernel"``, with the launch counters set to 0 just
   before; then the same run on the CPU with the plain versions; final
   accuracy must agree within 0.03 and upstream bits within 2 %, and every
   kernel must have launched; then, from the trained state, 3 lock-step
   rounds of the card's encode, apply and ledger phases against the CPU's
   on the same inputs (positions, signs, counts and wire words exact, µ
   within rtol 1e-6, residuals and parameters within 1e-6 of
   ``|value| + µ``), and ``pack_bits`` at the main path's own stream size;
4. time each kernel and its plain version with CUDA events (device time:
   the stream is held while the host enqueues), the k-selection
   beside ``torch.topk``, and one round split into local SGD, encode,
   apply and ledger (with the ``"kernel"`` and the host wire packer).

Prints the card's name and power limit, the TF32 flags, the timing lines,
a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
MAIN_ROWS, MAIN_N = 10, 307_434  # cohort x cnn parameters
P_STC = 1 / 50
ROUNDS = 40


class Failure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 2

def check_kernels(torch, np, rk):
    """Each kernel against its plain version on the same card inputs."""
    from repro_torch.core.compression import get_stc_backend
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    errs = {}

    def rows(shape, scale=1e-3):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    n_adv = 20_000
    ties = np.where(rng.random(n_adv) < 0.5, 1.0, rng.uniform(0, 0.5, n_adv))
    extreme = 10.0 ** rng.uniform(-30, 30, n_adv)
    few = np.zeros(n_adv)
    few[rng.choice(n_adv, 7, replace=False)] = rng.standard_normal(7)
    adversarial = torch.from_numpy(np.stack([
        ties * np.sign(rng.standard_normal(n_adv)),
        np.full(n_adv, 0.25),                       # constant row
        extreme * np.sign(rng.standard_normal(n_adv)),
        np.zeros(n_adv),                            # all-zero row
        few,                                        # fewer non-zeros than k
        rng.standard_normal(n_adv),
    ]).astype(np.float32)).to(dev)

    torch_select = get_stc_backend("torch").select_batch
    sets = [(rows((MAIN_ROWS, MAIN_N)), max(int(MAIN_N * P_STC), 1)),
            (rows((1, MAIN_N), 1e-4), max(int(MAIN_N * P_STC), 1)),
            (adversarial, 100),
            (adversarial, 1),
            (adversarial, n_adv)]
    hist_err = sel_err = apply_err = 0.0
    for x, k in sets:
        a = x.abs()
        a_max = a.amax(dim=1)
        scale = torch.where(a_max > 0, 256.0 / a_max, torch.zeros_like(a_max))
        cnt_k, sum_k = rk.magnitude_histogram_batched(x, scale)
        cnt_p, sum_p = rk.magnitude_histogram_plain(x, scale)
        require(torch.equal(cnt_k, cnt_p), f"histogram counts differ k={k}")
        require(torch.allclose(sum_k, sum_p, rtol=1e-6, atol=0.0),
                f"histogram sums beyond rtol 1e-6 k={k}")
        hist_err = max(hist_err, float((sum_k - sum_p).abs().max()))

        t_k, c_k, s_k = rk.hist_topk_threshold_batched(x, k)
        t_o, c_o, s_o = torch_select(x, k)
        t_c, c_c, _ = rk.hist_topk_threshold_batched(x.cpu(), k)
        require(torch.equal(t_k, t_o) and torch.equal(t_k.cpu(), t_c),
                f"selection threshold differs k={k}")
        require(torch.equal(c_k, c_o) and torch.equal(c_k.cpu(), c_c),
                f"selection count differs k={k}")
        require(torch.allclose(s_k, s_o, rtol=1e-6, atol=0.0),
                f"selection sum beyond rtol 1e-6 k={k}")
        sel_err = max(sel_err, float((s_k - s_o).abs().max()))

        mu = s_k / torch.clamp(c_k, min=1).to(torch.float32)
        tern_k, res_k = rk.stc_apply_batched(x, t_k, mu)
        tern_p, res_p = rk.stc_apply_plain(x, t_k, mu)
        require(torch.equal(tern_k, tern_p) and torch.equal(res_k, res_p),
                f"stc_apply not bitwise equal k={k}")
        apply_err = max(apply_err, float((tern_k - tern_p).abs().max()))
    errs["stc_apply"], errs["histogram"] = apply_err, hist_err
    errs["selection"] = sel_err

    errs["pack_bits"] = max(check_pack_bits(torch, np, rk, rng, m)
                            for m in (1, 31, 32, 1_000_003, 2_400_000))
    torch.cuda.synchronize()
    return errs


def words_err(np, got, want) -> float:
    """Largest |difference| between two uint32 word streams."""
    require(got.shape == want.shape,
            f"word streams differ in length: {got.shape} vs {want.shape}")
    return float(np.abs(got.astype(np.int64) - want.astype(np.int64))
                 .max(initial=0))


def check_pack_bits(torch, np, rk, rng, m) -> float:
    """``pack_bits`` on ``m`` random card bits against its plain version
    and the host packer; returns the words' max abs difference (0.0)."""
    from repro_torch.core.wire import _pack_bits_numpy
    bits_np = (rng.random(m) < 0.3).astype(np.uint8)
    bits = torch.from_numpy(bits_np).to("cuda")
    w_k = rk.pack_bits(bits).cpu().numpy().view(np.uint32)
    w_p = rk.pack_bits_plain(bits).cpu().numpy().view(np.uint32)
    w_np = _pack_bits_numpy(bits_np)
    err = max(words_err(np, w_k, w_p), words_err(np, w_k, w_np))
    require(err == 0.0, f"pack_bits words differ at m={m} (max {err})")
    return err


# ---------------------------------------------------------------- phase 3

def make_trainer(device, torch):
    from repro_torch.core import make_protocol
    from repro_torch.data import make_image_classification
    from repro_torch.fed import FedEnvironment, FederatedTrainer, \
        TrainerConfig
    from repro_torch.models import MODEL_ZOO
    train, test = make_image_classification(seed=0, n=6000)
    env = FedEnvironment(n_clients=10, participation=1.0,
                         classes_per_client=2, batch_size=20)
    proto = make_protocol("stc", sparsity_up=P_STC, sparsity_down=P_STC,
                          backend="kernel", wire_backend="kernel")
    return FederatedTrainer(MODEL_ZOO["cnn"], train, test, env, proto,
                            TrainerConfig(lr=0.05), device=device)


def run_trainers(torch, rk):
    gpu = make_trainer("cuda", torch)
    require(gpu.numel == MAIN_N, f"cnn has {gpu.numel} parameters")
    rk.LAUNCHES.reset()
    t0 = time.perf_counter()
    h_gpu = gpu.run(ROUNDS, eval_every=ROUNDS)[-1]
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = dict(rk.LAUNCHES.counts)
    shapes = dict(rk.LAUNCHES.shapes)
    require(bool(torch.isfinite(gpu.params_vec).all()), "non-finite params")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the main path")

    cpu = make_trainer("cpu", torch)
    t0 = time.perf_counter()
    h_cpu = cpu.run(ROUNDS, eval_every=ROUNDS)[-1]
    cpu_s = time.perf_counter() - t0
    require(rk.LAUNCHES.counts == launches,
            "the CPU run launched a CUDA kernel")
    d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
    d_up = abs(h_gpu["bits_up"] / h_cpu["bits_up"] - 1.0)
    d_params = float((gpu.params_vec.cpu() - cpu.params_vec).norm()
                     / cpu.params_vec.norm())
    print(f"trainer: cnn {gpu.numel} params, {ROUNDS} rounds | card "
          f"acc={h_gpu['acc']:.4f} bits_up={h_gpu['bits_up']:.0f} "
          f"bits_down={h_gpu['bits_down']:.0f} ({gpu_s:.1f} s) | cpu "
          f"acc={h_cpu['acc']:.4f} bits_up={h_cpu['bits_up']:.0f} "
          f"bits_down={h_cpu['bits_down']:.0f} ({cpu_s:.1f} s) | "
          f"|d acc|={d_acc:.4f} |d bits_up|={d_up:.4%} "
          f"|d params|/|params|={d_params:.3e}")
    print(f"main-path launches: {json.dumps(launches)} shapes: "
          f"{json.dumps({k: list(v) for k, v in shapes.items()})}")
    require(d_acc <= 0.03, f"accuracy differs by {d_acc:.4f} > 0.03")
    require(d_up <= 0.02, f"bits_up differs by {d_up:.4%} > 2%")
    return gpu, launches, shapes


def check_lockstep(torch, np, rk, tr, rounds=3):
    """The card's encode, apply and ledger phases against the same phases
    on the CPU (plain versions), round by round from the same inputs: the
    card's local-SGD deltas and the card's state (client and server
    residuals, parameters) at the start of the round, from the trained
    state on.  Positions, signs, counts and wire words must be exact; µ
    within rtol 1e-6; residuals and parameters within 1e-6 of
    ``|value| + µ``.  The trainer's parameters and residuals are left as
    they were; only its data stream advances."""
    from repro_torch.core import wire
    from repro_torch.core.compression import get_stc_backend
    from repro_torch.core.residual import ResidualState
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    be = get_stc_backend(proto.backend)
    ones = torch.ones(p, device=tr.device)
    zeros = torch.zeros(p, device=tr.device)
    params = tr.params_vec.clone()
    client_res = tr.client_state.residual.clone()
    server_res = tr.server_state.residual.clone()
    worst = {"mu_rtol": 0.0, "residual_abs": 0.0, "params_abs": 0.0,
             "words_abs": 0.0}

    def close(what, got, want, mu):
        want = want.reshape(mu.numel(), -1)
        gap = (got.cpu().reshape(want.shape) - want).abs()
        require(bool((gap <= 1e-6 * (want.abs() + mu.abs().reshape(-1, 1)))
                     .all()), f"lock-step round {r}: {what} beyond 1e-6 of "
                              f"|value| + µ (max gap {float(gap.max())})")
        return float(gap.max())

    def same_message(what, got, want, st_got, st_want):
        require(torch.equal(torch.sign(got.cpu()), torch.sign(want)),
                f"lock-step round {r}: {what} positions or signs differ")
        require(torch.equal(st_got.nnz.cpu(), st_want.nnz),
                f"lock-step round {r}: {what} counts differ")
        mu_want = st_want.mu.reshape(-1)
        rel = float(((st_got.mu.cpu().reshape(-1) - mu_want).abs()
                     / mu_want.abs()).max())
        require(rel <= 1e-6, f"lock-step round {r}: {what} µ off by "
                             f"rtol {rel:.3e} > 1e-6")
        worst["mu_rtol"] = max(worst["mu_rtol"], rel)
        close(f"{what} values", got, want, mu_want)

    def same_words(what, got, want):
        require(np.array_equal(got.bit_len, want.bit_len),
                f"lock-step round {r}: {what} stream lengths differ")
        worst["words_abs"] = max(worst["words_abs"],
                                 words_err(np, got.words, want.words))
        require(worst["words_abs"] == 0.0,
                f"lock-step round {r}: {what} wire words differ")

    packs = rk.LAUNCHES.counts["pack_bits"]
    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        msgs, cstate, st = proto.encode_batch(
            deltas, ResidualState(residual=client_res[idx]))
        gd, sstate, sg = proto.aggregate(msgs, ResidualState(server_res),
                                         mask=ones, staleness=zeros)
        mean = proto.combine(msgs, ones, zeros)

        msgs_c, cstate_c, st_c = proto.encode_batch(
            deltas.cpu(), ResidualState(residual=client_res[idx].cpu()))
        gd_c, sres_c, sg_c = be.compress_with_residual(
            mean.cpu(), server_res.cpu(), proto.sparsity_down)
        same_message("client messages", msgs, msgs_c, st, st_c)
        worst["residual_abs"] = max(
            worst["residual_abs"],
            close("client residuals", cstate.residual, cstate_c.residual,
                  st_c.mu),
            close("server residual", sstate.residual, sres_c, sg_c.mu))
        same_message("server message", gd, gd_c, sg, sg_c)
        worst["params_abs"] = max(worst["params_abs"], close(
            "parameters", params + gd, params.cpu() + gd_c, sg_c.mu))

        # the ledger: the "kernel" wire backend on the card's messages
        # against the host packer on the same messages
        same_words("upstream", proto.encode_wire_batch(msgs, direction="up"),
                   wire.encode_ternary_words_batch(
                       msgs.cpu().numpy(), proto.sparsity_up))
        same_words("downstream", proto.encode_wire(gd, direction="down"),
                   wire.encode_ternary_words(
                       gd.cpu().numpy(), proto.sparsity_down))

        client_res[idx] = cstate.residual
        server_res = sstate.residual
        params = params + gd
    require(rk.LAUNCHES.counts["pack_bits"] > packs,
            "the lock-step ledger did not go through pack_bits")
    print(f"lock-step ({rounds} rounds, card vs CPU from the same inputs): "
          f"{json.dumps(worst)}")
    return worst


# ---------------------------------------------------------------- phase 4

def event_ms(torch, fn, iters=50, hold_stream=True) -> float:
    """Mean device time of ``fn`` over back-to-back launches (CUDA events).

    With ``hold_stream`` a sleep kernel holds the stream while the host
    enqueues every launch, so the wrapper's host overhead does not show:
    the events then time the device work alone.  A ``fn`` that
    synchronizes inside must pass ``hold_stream=False`` (host included).
    """
    t0 = time.perf_counter()
    for _ in range(iters):                       # warm-up, and the host's
        fn()                                     # enqueue time for the hold
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold_stream:
        torch.cuda._sleep(int(4e6 * host_ms) + 2_000_000)  # ~2 cycles/ns
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(torch, np, rk, shapes, launches, errs):
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rows, n = MAIN_ROWS, MAIN_N          # the encode phase's (P, n) launch
    x = torch.from_numpy(
        (rng.standard_normal((rows, n)) * 1e-3).astype(np.float32)).to(dev)
    k = max(int(n * P_STC), 1)
    a_max = x.abs().amax(dim=1)
    scale = 256.0 / a_max
    t, c, s = rk.hist_topk_threshold_batched(x, k)
    mu = s / c.to(torch.float32)
    m = shapes["pack_bits"][0]
    bits = torch.from_numpy((rng.random(m) < 0.3).astype(np.uint8)).to(dev)

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    out = []
    nb = rows * n * 4
    out.append({
        "name": "stc_apply", "route": "cuda",
        "source": "src/repro_torch/csrc/stc_apply.cu",
        "replaces": "src/repro/kernels/stc_compress.py:56",
        "launches": launches["stc_apply"], "max_abs_err": errs["stc_apply"],
        "ms": event_ms(torch, lambda: rk.stc_apply_batched(x, t, mu)),
        "plain_ms": event_ms(torch, lambda: rk.stc_apply_plain(x, t, mu)),
        "bound_ms": bound(3 * nb + 8 * rows), "bound_by": "bytes",
        "library_ms": None})
    out.append({
        "name": "magnitude_histogram", "route": "cuda",
        "source": "src/repro_torch/csrc/histogram.cu",
        "replaces": "src/repro/kernels/hist_select.py:123",
        "launches": launches["histogram"], "max_abs_err": errs["histogram"],
        "ms": event_ms(torch,
                       lambda: rk.magnitude_histogram_batched(x, scale)),
        "plain_ms": event_ms(torch,
                             lambda: rk.magnitude_histogram_plain(x, scale)),
        "bound_ms": bound(nb + 4 * rows + 8 * 256 * rows),
        "bound_by": "bytes", "library_ms": None})
    n_words = -(-m // 32)
    out.append({
        "name": "pack_bits", "route": "cuda",
        "source": "src/repro_torch/csrc/pack_bits.cu",
        "replaces": "src/repro/kernels/bitpack.py:59",
        "launches": launches["pack_bits"], "max_abs_err": errs["pack_bits"],
        "ms": event_ms(torch, lambda: rk.pack_bits(bits)),
        "plain_ms": event_ms(torch, lambda: rk.pack_bits_plain(bits)),
        "bound_ms": bound(m + 4 * n_words), "bound_by": "bytes",
        "library_ms": None})
    # the k-selection synchronizes once (the overflow test), so it is
    # timed with its host work; torch.topk beside it the same way
    sel_ms = event_ms(torch, lambda: rk.hist_topk_threshold_batched(x, k),
                      iters=20, hold_stream=False)
    topk_ms = event_ms(torch, lambda: torch.topk(x.abs(), k, dim=1),
                       iters=20, hold_stream=False)
    print(f"selection at ({rows}, {n}), k={k}, host included: histogram "
          f"route {sel_ms:.4f} ms, torch.topk {topk_ms:.4f} ms")
    for row in out:
        print(f"kernel {row['name']}: {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms)")
    return out


def time_round(torch, np, tr):
    """One round split into its phases, state left untouched, median of 5.
    ``ledger`` is the trainer's (``wire_backend="kernel"``);
    ``ledger_numpy`` packs the same messages with the host packer."""
    from repro_torch.core.residual import take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    host = dataclasses.replace(proto, wire_backend="numpy")
    phases = {"local_sgd": [], "encode": [], "apply": [], "ledger": [],
              "ledger_numpy": [], "round": []}

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(5):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        t0 = sync_now()
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        t1 = sync_now()
        msgs, _, _ = proto.encode_batch(deltas,
                                        take_states(tr.client_state, idx))
        t2 = sync_now()
        _, _, gd = tr._apply_fn(
            tr.params_vec, tr.server_state, msgs,
            torch.ones(p, device=tr.device), torch.zeros(p, device=tr.device))
        t3 = sync_now()
        proto.encode_wire_batch(msgs, direction="up")
        proto.encode_wire(gd, direction="down")
        t4 = sync_now()
        host.encode_wire_batch(msgs, direction="up")
        host.encode_wire(gd, direction="down")
        t5 = sync_now()
        for name, dt in zip(("local_sgd", "encode", "apply", "ledger",
                             "ledger_numpy"),
                            (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            phases[name].append(dt * 1e3)
    for _ in range(5):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print("round phases (median of 5, ms, host clock after synchronize): "
          + json.dumps({k: round(v, 3) for k, v in med.items()}))
    return med


# ------------------------------------------------------------------- main

def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import repro_torch.kernels as rk
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}",
              file=sys.stderr)
        return 2
    try:
        t0 = time.perf_counter()
        rk.build_all()
        print(f"build: {time.perf_counter() - t0:.1f} s "
              f"(nvcc, one process per source)")
        errs = check_kernels(torch, np, rk)
        print(f"kernel checks passed: {json.dumps(errs)}")
        tr, launches, shapes = run_trainers(torch, rk)
        check_lockstep(torch, np, rk, tr)
        errs["pack_bits"] = max(errs["pack_bits"], check_pack_bits(
            torch, np, rk, np.random.default_rng(2), shapes["pack_bits"][0]))
        print(f"pack_bits at the main path's m={shapes['pack_bits'][0]}: "
              f"words identical to its plain version and the host packer")
        rows = time_kernels(torch, np, rk, shapes, launches, errs)
        time_round(torch, np, tr)
        for row in rows:
            require(all(isinstance(row[f], (int, float)) and math.isfinite(
                row[f]) for f in ("ms", "plain_ms", "bound_ms")),
                f"missing timing for {row['name']}")
        card = card_line()
    except (Failure, RuntimeError, subprocess.SubprocessError) as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"tf32: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
