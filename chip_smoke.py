#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --signsgd-round   # only the signSGD round's phases
    python3 chip_smoke.py --paper-codecs    # only phase 7
    python3 chip_smoke.py --buffered        # only phase 8
    python3 chip_smoke.py --chunked         # only phase 9
    python3 chip_smoke.py --drift-witness   # phase 9's runs, one ulp apart

Needs one CUDA card and ``nvcc``; fails without them.  Phases:

1. build the nine CUDA sources from ``src/repro_torch/csrc`` into
   ``build/kernels/`` (one ``nvcc`` per source, in parallel) and print the
   registers and shared memory (``-Xptxas -v``) of the histogram,
   ``bin_select``, ``pack_bits``, ``pack_chunks``, ``unpack_bits``,
   ``golomb_decode``, ``threshold_stats`` and ``bisect_select``, and the
   atomics, conversions and fp64 adds in the histogram's SASS;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and on adversarial inputs: ``stc_apply`` bitwise,
   histogram counts exact and sums within rtol 1e-6 (normal, skewed and
   all-zero rows; two calls identical; one device operation a call),
   the candidate-bin select ``bin_select`` ``v`` and count bitwise and sums
   within rtol 1e-6 (two calls identical) on normal, carried-like (~99 %
   in bin 0), skewed, tied, constant, all-zero and fewer-non-zeros-than-k
   rows and per-row k, selection threshold and count exact (also against
   the ``"torch"`` route and the CPU), ``pack_bits`` (one plane and
   batches whose rows start off 16-byte boundaries),
   ``pack_sign_planes`` (rows of ±step with -0.0, subnormals, ±inf and
   NaN) and ``pack_chunks`` words identical (also to the host packer),
   ``unpack_bits`` bits and zero counts identical (also to the host
   unpack, one plane and batches), ``sign_plane_tally`` bitwise its plain
   version and the host accumulator's loop, ``golomb_decode``
   fields identical and raising on the same inputs (valid batches, the
   decoder's chunk-boundary traps, a cnn round, 300 corrupt batches and
   the 60 mutations of the reference's wire fuzz test), ``threshold_stats``
   counts exact and sums within rtol 1e-6 (two calls identical), the fused
   bisection ``bisect_select`` ``lo`` and count bitwise its plain version's
   (on the card and on the CPU) and sums within rtol 1e-6 (two calls
   identical) at the cnn's n, on the edge cases of
   ``tests/_bisect_cases.py``, a subnormal row and 4,000,037 elements,
   ``selector="bisect"`` under ``set_sync_debug_mode("error")`` and giving
   the ``"hist"`` mask; every selection check also runs on rows of
   subnormals, which count as zeros (the reference's flush-to-zero);
3. the dense path: train the paper CNN at full width with STC (the
   configuration of ``examples/federated_noniid.py``: 10 clients, 2
   classes each, p = 1/50 up and down, lr 0.05, 40 rounds) through
   ``backend="kernel"`` and ``wire_backend="kernel"``, with the launch
   counters set to 0 just before; then the same run on the CPU with the
   plain versions; final accuracy must agree within 0.03 and upstream bits
   within 2 %, and ``stc_apply``, the histogram, ``bin_select`` and
   ``pack_chunks`` must have launched (the histogram and ``bin_select``
   twice a round: the clients' encode and the server's STC; ``pack_chunks``
   twice a round: the upstream batch and the downstream message); the card
   run prints, round by round, each selection's candidate bin and its
   population, and how many of them the old refinement (``torch.topk``
   with ``cap = 8192``) would have sent to its full-row ``torch.sort``;
   then, from the trained state, 3 lock-step rounds of
   the card's encode, apply and ledger phases against the CPU's on the
   same inputs (positions, signs, counts and wire words exact, µ within
   rtol 1e-6, residuals and parameters within 1e-6 of ``|value| + µ``),
   ``pack_chunks`` on the chunks of the last round's upstream batch, and
   ``bin_select`` against its plain version on the last round's carried
   matrices, the clients' (10, n) and the server's (1, n); then
   ``stc_compress_batch`` on those matrices under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host synchronization)
   and the selection under ``torch.profiler`` (no ``aten::topk``,
   ``aten::sort`` or ``aten::kthvalue``);
4. the ingest path: the same run with ``TrainerConfig(ingest=True)`` (the
   fused server ingest, decoding the ternary wire through
   ``golomb_decode``), card against CPU as in 3, with ``golomb_decode``
   launched at least once a round, ``unpack_bits`` never, and the three
   kernels of 3 launched; then 3 lock-step ingest rounds on the card's
   messages (accumulator sum bitwise the CPU's, global-delta positions and
   signs exact, µ within rtol 1e-6), and ``golomb_decode`` on the last
   one's batch against its plain version and the numpy scan; then signSGD
   through the same ingest (``wire_backend="kernel"``): one
   ``pack_sign_planes`` launch (the round's upstream batch) and one
   ``sign_plane_tally`` launch (the ingest) a round and no ``pack_bits``
   or ``unpack_bits``, 3 lock-step rounds card against CPU with wire
   batches (also the host packer's), unpacked bits, accumulator (also the
   host backend's) and global delta identical, and both kernels on the
   last one's messages and words;
5. the bisection path: ``stc_compress_kernel(selector="bisect")`` at the
   cnn's width, which must launch ``bisect_select`` once, ``stc_apply``
   once and ``threshold_stats`` never; then ``threshold_stats`` through
   its own entry point at the selected threshold (one launch, a check
   only: no path launches ``threshold_stats``, and its row's count is the
   path's, 0);
6. time each kernel and its plain version with CUDA events (device time:
   the stream is held while the host enqueues) beside the library call
   that computes the same function where there is one (the histogram on
   the carried matrices of a lock-step round and on a normal matrix, and
   at 1, 2 and 4 CTAs an SM; ``bin_select`` on those carried matrices
   beside ``torch.topk``, with its four passes by ``torch.profiler``;
   ``pack_chunks`` on a real round's upstream chunks; the sign-plane
   kernels on a signSGD round's messages and words, beside ten one-plane
   launches and, for the tally, the host loop it replaces;
   ``bisect_select`` per step and host included, beside ``torch.topk``,
   and at n = 17 and n = 4,000,037 beside it),
   the k-selections beside ``torch.topk`` (on the carried matrices host
   included and in device time, on a normal matrix host included), and a
   dense and an
   ingest round split into phases (with the ``"kernel"`` and the host
   wire backends, in turns), and the ingest decode of one round's batch
   split into words up, the decode, fields down and ``np.add.at``, beside
   the numpy field scan on the same batch, and a signSGD ingest round split
   into phases (both wire backends, in turns).

7. the paper's comparison codecs on the same cnn and data: ``baseline``,
   ``fedavg`` (10 local iterations a round), ``topk`` (p = 1/50 up) and
   ``ternquant``, at lr 0.01 (at the demo's 0.05 their training is
   unstable: FedAvg reaches NaN, in the JAX package too, and card and CPU
   part ways), 20 local iterations each (fedavg: 2 rounds) on the card
   (counters set to 0 just before) and on the CPU from the same initial
   parameters: accuracy within 0.03 and the four analytic ledger columns
   equal; top-k launches the histogram and ``bin_select`` exactly once a
   round and nothing else, the other three no kernel; then 3 lock-step
   rounds card vs CPU (top-k messages, masks, counts and residuals
   bitwise; baseline and FedAvg messages bitwise; TernQuant masks exact,
   client and server side, and µ within rtol 1e-6), and each codec's
   round split into ``local_sgd``, ``encode``, ``apply`` and ``ledger``;
8. the buffered trainer: STC (p = 1/50 both ways) under
   ``BufferedFederatedTrainer`` with the default ``LatencyModel`` and a
   deadline of 0.5 (its median latency), 10 rounds on the dense route and
   with ``TrainerConfig(ingest=True)``, card and CPU: ``arrival_log``
   identical, accuracy within 0.03, ``bits_up`` within 2 %, and the
   launches the arrival log implies (the clients' STC every round, the
   server's each round that aggregated, one ``golomb_decode`` an ingested
   arrival); whole rounds timed; then ``deadline=inf`` against the
   synchronous trainer on the card, 3 rounds a route: parameters, ledger
   and wire log bitwise;
9. the chunked codec states and the adaptive controllers on the same cnn
   at lr 0.05: ``chunks="whole"`` against the flat trainer on the card (5
   rounds; parameters, ledger and wire log bitwise); then
   ``chunks=4096`` (79 chunks in 6 width groups), 40 rounds on the dense
   and the ingest route, card (counters set to 0 just before) against CPU
   (accuracy within 0.03, ``bits_up`` within 2 %, analytic columns equal,
   the upstream messages' non-zeros summed over the run within rtol 1e-4:
   every chunk keeps its fixed k, ties aside), the launch log showing one
   histogram, ``bin_select`` and ``stc_apply`` launch a round at (790,
   4096) and at (79, 4096), two ``pack_chunks`` a width group a round (up
   and down) and on the ingest route one ``golomb_decode`` a width group a
   round; one round of each under
   ``torch.profiler`` (two of each STC kernel, no ``topk``/``sort``); 3
   lock-step rounds from the trained dense state (both selections'
   thresholds and counts, masks, wire words and the ingest accumulator
   exact, µ within rtol 1e-6), ``bin_select`` against its plain version at
   both shapes and ``stc_compress_blocks`` with host and device ks under
   ``set_sync_debug_mode("error")``; then ``residual_mass`` (budget 1.0)
   and ``snr_constant`` (snr 3, ema 0.5), 40 dense rounds card against CPU
   (at 10 and 20 rounds the cnn is still unconverged and card and CPU
   parted by up to 0.21 in accuracy while their lock-step rounds were
   exact; ``--drift-witness`` measures how far one ulp moves a run there),
   each with 2 lock-step rounds (per-chunk ks and EMA states identical, the
   dynamic selection exact, the adaptive encode under
   ``set_sync_debug_mode("error")`` with one launch of each STC kernel);
   then the chunked rounds split into phases and the STC kernels timed at
   the chunked shapes beside their bounds, ``golomb_decode`` on the largest
   width group's sub-streams.

``--signsgd-round`` runs the last of the timings of 6 alone on the package
of the tree the file sits in: a copy inside a parent checkout unpacked
beside the change times the parent.  ``--paper-codecs``, ``--buffered``
and ``--chunked`` run phase 7, 8 or 9 alone.  ``--drift-witness`` trains
phase 9's dense and ``residual_mass`` runs 20 rounds on the card twice, on
the card and the CPU with one parameter and with every parameter moved by
one ulp, on the CPU, and on the CPU with one thread, and prints their
accuracies every 5 rounds: how far the card's own variation and ulps on
one device part two runs, beside the card-CPU gap.

Prints the timing lines, the TF32 flags, the card's name and power limit,
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
FLT_MIN = 1.1754943508222875e-38  # the least normal fp32
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


# ---------------------------------------------------------------- phase 1

FP64_SHARED_ATOMIC_PROBE = r"""
__global__ void probe(const double* x, double* out) {
  __shared__ double acc;
  if (threadIdx.x == 0) acc = 0.0;
  __syncthreads();
  atomicAdd(&acc, x[threadIdx.x]);
  __syncthreads();
  if (threadIdx.x == 0) *out = acc;
}
"""


def sass_opcodes(cuobjdump: str, binary: Path, prefixes) -> dict:
    """Counts of the SASS instructions of ``binary`` whose opcode starts
    with one of ``prefixes``."""
    import re
    out = subprocess.run([cuobjdump, "-sass", str(binary)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    ops = re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", out)
    counts: dict = {}
    for op in ops:
        if op.startswith(tuple(prefixes)):
            counts[op] = counts.get(op, 0) + 1
    return counts


def print_build_notes() -> None:
    """``-Xptxas -v`` of the eight redesigned kernels, the atomics,
    conversions, fp64 adds and votes in the histogram's SASS, and the SASS
    of a plain fp64 ``atomicAdd`` to shared memory (whether it compiles to
    a compare-and-swap loop)."""
    from repro_torch.kernels import _build
    for name in ("histogram", "bin_select", "pack_bits", "pack_chunks",
                 "unpack_bits", "golomb_decode", "threshold_stats",
                 "bisect_select"):
        notes = [line.split(":", 1)[-1].strip()
                 for line in _build.build_log(name).splitlines()
                 if "Used" in line or "spill" in line]
        print(f"ptxas -v {name}: {' | '.join(notes)}")
    nvcc = Path(_build._nvcc())
    cuobjdump = str(nvcc.parent / "cuobjdump")
    atomics = ("ATOM", "RED.", "CAS")
    try:
        lib = _build.build_all(("histogram",))["histogram"]
        ops = sass_opcodes(cuobjdump, lib,
                           atomics + ("F2I", "F2F", "DADD", "VOTE"))
        print(f"histogram SASS atomics, conversions, fp64 adds and votes: "
              f"{json.dumps(ops)}")
        src = _build.BUILD_DIR / "probe_fp64_shared_atomic.cu"
        src.write_text(FP64_SHARED_ATOMIC_PROBE)
        cubin = src.with_suffix(".cubin")
        subprocess.run([str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-cubin", "-O3", "-o", str(cubin), str(src)],
                       capture_output=True, text=True, timeout=120,
                       check=True)
        print(f"fp64 atomicAdd to shared memory, SASS atomics: "
              f"{json.dumps(sass_opcodes(cuobjdump, cubin, atomics))}")
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"SASS not read: {exc}")


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
        subnormal_row(np, rng, n_adv),              # subnormals as zeros
        rng.standard_normal(n_adv) * 1e-40,         # all subnormal
    ]).astype(np.float32)).to(dev)

    torch_select = get_stc_backend("torch").select_batch
    k_main = max(int(MAIN_N * P_STC), 1)
    sets = [(rows((MAIN_ROWS, MAIN_N)), k_main),
            (rows((1, MAIN_N), 1e-4), k_main),
            (skewed(torch, np, rng, MAIN_ROWS, MAIN_N), k_main),
            (carried_like(torch, np, rng, MAIN_ROWS, MAIN_N), k_main),
            (carried_like(torch, np, rng, 1, MAIN_N), k_main),
            (adversarial, 100),
            (adversarial, 1),
            (adversarial, n_adv),
            (adversarial, np.array([1, 100, 7, 20_000, 5_000, 6_148, 300,
                                    5]))]
    hist_err = sel_err = apply_err = select_err = 0.0
    for x, k in sets:
        scale = row_scale(torch, x)
        hist_err = max(hist_err, check_histogram(torch, rk, x, scale))

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
        select_err = max(select_err, check_bin_select(torch, rk, x, k))

        mu = s_k / torch.clamp(c_k, min=1).to(torch.float32)
        tern_k, res_k = rk.stc_apply_batched(x, t_k, mu)
        tern_p, res_p = rk.stc_apply_plain(x, t_k, mu)
        require(torch.equal(tern_k, tern_p) and torch.equal(res_k, res_p),
                f"stc_apply not bitwise equal k={k}")
        apply_err = max(apply_err, float((tern_k - tern_p).abs().max()))
    errs["stc_apply"], errs["histogram"] = apply_err, hist_err
    errs["selection"], errs["bin_select"] = sel_err, select_err

    x, scale = skewed(torch, np, rng, MAIN_ROWS, MAIN_N, scale=True)
    ops = device_ops(torch, lambda: rk.magnitude_histogram_batched(x, scale))
    require(ops is None or len(ops) == 1,
            f"the histogram ran {len(ops or ())} device operations, not 1: "
            f"{ops}")
    print(f"histogram: device operations in one call (torch.profiler): "
          f"{ops if ops is not None else 'not seen by the profiler'}")
    errs["pack_bits"] = max(
        [check_pack_bits(torch, np, rk, rng, m)
         for m in (1, 31, 32, 1_000_003, 2_400_000)]
        + [check_pack_bits(torch, np, rk, rng, m, rows)
           for rows, m in ((3, 1), (3, 33), (10, 1000), (10, MAIN_N),
                           (4, 4096), (2, 1_000_003))])
    errs["pack_sign_planes"] = max(
        check_pack_sign_planes(torch, np, rk, sign_rows(np, rng, rows, n))
        for rows, n in ((1, 1), (3, 31), (3, 33), (10, 1000),
                        (1, MAIN_N), (MAIN_ROWS, MAIN_N), (2, 1_000_003)))
    errs["pack_chunks"] = max(check_pack_chunks(torch, np, rk, *chunk_set(
        np, rng, count, gaps)) for count, gaps in ((1, False), (33, True),
                                                   (61_480, True),
                                                   (1_000_003, False)))
    errs["unpack_bits"] = max(
        [check_unpack_bits(torch, np, rk, rng, w)
         for w in (1, 2, 9608, 1_000_003)]
        + [check_unpack_bits(torch, np, rk, rng, w, rows)
           for rows, w in ((3, 1), (MAIN_ROWS, 9608))])
    errs["sign_plane_tally"] = max(
        check_sign_plane_tally(
            torch, np, rk, rng, rng.integers(0, 1 << 32, (rows, w),
                                             dtype=np.uint64)
            .astype(np.uint32), rng.uniform(0, 2, rows))
        for rows, w in ((1, 1), (3, 2), (MAIN_ROWS, 32), (MAIN_ROWS, 9608),
                        (64, 9608)))
    errs["golomb_decode"] = check_golomb_cases(torch, np, rk)
    errs["threshold_stats"] = check_threshold_stats(torch, np, rk, rng)
    errs["bisection"] = check_bisection(torch, np, rk, rng)
    torch.cuda.synchronize()
    return errs


def skewed(torch, np, rng, n_rows, n, scale=False):
    """Rows like the carried deltas at their most skewed: one outlier a row
    and every other magnitude below 1/256 of it (bin 0); the last row all
    zero.  With ``scale`` also the k-selection's scale."""
    x = np.clip(rng.standard_normal((n_rows, n)) * 1e-3, -3e-3, 3e-3)
    x[np.arange(n_rows), rng.integers(0, n, n_rows)] = 1.0
    x[-1] = 0.0
    x = torch.from_numpy(x.astype(np.float32)).to("cuda")
    if not scale:
        return x
    return x, row_scale(torch, x)


def subnormal_row(np, rng, n):
    """N(0, 1)·1e-40 subnormals with ~1 % N(0, 1) values and ~1 % values
    within a factor 4 of FLT_MIN on either side (float64; the caller
    casts)."""
    x = rng.standard_normal(n) * 1e-40
    x[rng.integers(0, n, n // 100)] = rng.standard_normal(n // 100)
    x[rng.integers(0, n, n // 100)] = rng.uniform(-4, 4, n // 100) * FLT_MIN
    return x


def carried_like(torch, np, rng, n_rows, n):
    """Rows like a trained cnn's carried residuals: one outlier a row,
    about 1 % of the row in the bins above 0 and the rest, about 99 %, in
    bin 0."""
    x = np.clip(rng.standard_normal((n_rows, n)) * 1e-3, -3e-3, 3e-3)
    x[:, rng.integers(0, n, n // 100)] *= 200.0
    x[np.arange(n_rows), rng.integers(0, n, n_rows)] = 1.0
    return torch.from_numpy(x.astype(np.float32)).to("cuda")


def select_inputs(torch, x, k):
    """``(scale, b, r, cnt_b)``: what ``hist_topk_threshold_batched`` hands the
    candidate-bin select for ``x`` and ``k``, made on the card."""
    from repro_torch.core.selection import locate_bin
    from repro_torch.kernels import hist_select
    rows, n = x.shape
    kj = hist_select._row_ks(k, rows, n, x.device)
    scale = row_scale(torch, x)
    cnt, sums = hist_select.magnitude_histogram_batched(x, scale)
    b, cnt_gt, _, cnt_b = locate_bin(cnt, sums, kj, 256)
    return scale, b, kj - cnt_gt.to(torch.int64), cnt_b


def check_bin_select(torch, rk, x, k) -> float:
    """``bin_select`` against its plain version on the k-selection's inputs
    for ``x`` and ``k``: ``v`` and the count bitwise, the sum within rtol
    1e-6, one launch a call, and a second call identical to the first.
    Returns the sums' largest abs difference."""
    scale, b, r, _ = select_inputs(torch, x, k)
    before = rk.LAUNCHES.counts["bin_select"]
    got = rk.candidate_select_batched(x, scale, b, r)
    require(rk.LAUNCHES.counts["bin_select"] == before + 1,
            "one bin_select call is not one launch")
    want = rk.candidate_select_plain(x, scale, b, r)
    shape = tuple(x.shape)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"bin_select v or count differs from its plain version at "
            f"{shape}")
    require(torch.allclose(got[2], want[2], rtol=1e-6, atol=0.0),
            f"bin_select sums beyond rtol 1e-6 at {shape}")
    again = rk.candidate_select_batched(x, scale, b, r)
    require(all(torch.equal(g, a) for g, a in zip(got, again)),
            f"two bin_select calls differ at {shape}")
    return float((got[2] - want[2]).abs().max())


def check_histogram(torch, rk, x, scale) -> float:
    """The histogram kernel against its plain version (counts exact, sums
    within rtol 1e-6), one launch a call, and a second call identical to
    the first.  Returns the sums' largest abs difference."""
    before = rk.LAUNCHES.counts["histogram"]
    cnt_k, sum_k = rk.magnitude_histogram_batched(x, scale)
    require(rk.LAUNCHES.counts["histogram"] == before + 1,
            "one histogram call is not one launch")
    cnt_p, sum_p = rk.magnitude_histogram_plain(x, scale)
    shape = tuple(x.shape)
    require(torch.equal(cnt_k, cnt_p), f"histogram counts differ at {shape}")
    require(torch.allclose(sum_k, sum_p, rtol=1e-6, atol=0.0),
            f"histogram sums beyond rtol 1e-6 at {shape}")
    cnt_2, sum_2 = rk.magnitude_histogram_batched(x, scale)
    require(torch.equal(cnt_k, cnt_2) and torch.equal(sum_k, sum_2),
            f"two histogram calls differ at {shape}")
    return float((sum_k - sum_p).abs().max())


def device_ops(torch, fn):
    """Names of the device operations (kernels, memsets, copies) that one
    call of ``fn`` runs, by ``torch.profiler``; None if the profiler sees
    no device activity at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return names or None


def kernel_times(torch, fn, calls=10):
    """Device time (ms) of each kernel that a call of ``fn`` runs, mean over
    ``calls`` calls, by ``torch.profiler``; None if it sees none."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernel = re.search(r"(\w+)(<\d+>)?\(", e.name)  # kernel's name
            name = kernel.group(1) + (kernel.group(2) or "") if kernel \
                else e.name
            times[name] = (times.get(name, 0.0)
                           + e.time_range.elapsed_us() / calls / 1e3)
    return times or None


def chunk_set(np, rng, count, gaps=False):
    """``count`` Golomb-like chunks (lengths 1-63, a fifth of them 32-one
    chunks), back to back or with word-aligned client gaps, and a total
    that is not a multiple of 32: ``(vals, lens, offs, total_bits)``."""
    lens = rng.integers(1, 64, count)
    lens[rng.random(count) < 0.2] = 32
    offs = np.cumsum(lens) - lens
    if gaps and count > 1:
        for cut in sorted(rng.choice(np.arange(1, count), min(8, count - 1),
                                     replace=False)):
            offs[cut:] += (-int(offs[cut]) % 32) + 32 * int(rng.integers(3))
    vals = rng.integers(0, 1 << 63, count, dtype=np.uint64)
    vals &= (np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1)
    vals[lens == 32] = np.uint64(0xFFFFFFFF)
    return vals, lens, offs, int(offs[-1] + lens[-1]) + 17


def chunk_tensors(torch, np, vals, lens, offs):
    """The chunk fields as the card tensors ``pack_chunks`` takes."""
    return (torch.from_numpy(np.ascontiguousarray(vals).view(np.int64))
            .to("cuda"),
            torch.from_numpy(lens.astype(np.int32)).to("cuda"),
            torch.from_numpy(offs.astype(np.int64)).to("cuda"))


def check_pack_chunks(torch, np, rk, vals, lens, offs, total_bits) -> float:
    """``pack_chunks`` on the card against its plain version and the host
    scatter; returns the words' max abs difference (0.0)."""
    from repro_torch.core.wire import _scatter_chunks_numpy
    t = chunk_tensors(torch, np, vals, lens, offs)
    w_k = rk.pack_chunks(*t, total_bits).cpu().numpy().view(np.uint32)
    w_p = rk.pack_chunks_plain(*t, total_bits).cpu().numpy().view(np.uint32)
    w_np = _scatter_chunks_numpy(vals, lens, offs, total_bits)
    err = max(words_err(np, w_k, w_p), words_err(np, w_k, w_np))
    require(err == 0.0, f"pack_chunks words differ at {len(vals)} chunks "
                        f"(max {err})")
    return err


def words_err(np, got, want) -> float:
    """Largest |difference| between two uint32 word streams."""
    require(got.shape == want.shape,
            f"word streams differ in length: {got.shape} vs {want.shape}")
    return float(np.abs(got.astype(np.int64) - want.astype(np.int64))
                 .max(initial=0))


def check_pack_bits(torch, np, rk, rng, m, rows=None) -> float:
    """``pack_bits`` on ``m`` random card bits (or ``pack_bits_batched`` on
    ``rows`` rows of ``m``: rows start off 16-byte boundaries unless 16
    divides m) against its plain version and the host packer, with bytes
    other than 0 and 1 among the bits; one launch a call, two calls
    identical.  Returns the words' max abs difference (0.0)."""
    from repro_torch.core.wire import _pack_bits_numpy
    shape = (m,) if rows is None else (rows, m)
    bits_np = ((rng.random(shape) < 0.3) * rng.integers(1, 256, shape)) \
        .astype(np.uint8)
    bits = torch.from_numpy(bits_np).to("cuda")
    pack = rk.pack_bits if rows is None else rk.pack_bits_batched
    before = rk.LAUNCHES.counts["pack_bits"]
    got = pack(bits)
    again = pack(bits)
    require(rk.LAUNCHES.counts["pack_bits"] == before + 2,
            f"one pack_bits call is not one launch at {shape}")
    require(torch.equal(got, again), f"two pack_bits calls differ at {shape}")
    plain = (rk.pack_bits_plain if rows is None
             else rk.pack_bits_batched_plain)
    w_k = got.cpu().numpy().view(np.uint32)
    w_p = plain(bits).cpu().numpy().view(np.uint32)
    w_np = np.stack([_pack_bits_numpy(r != 0)
                     for r in bits_np.reshape(-1, m)]).reshape(w_k.shape)
    err = max(words_err(np, w_k, w_p), words_err(np, w_k, w_np))
    require(err == 0.0, f"pack_bits words differ at {shape} (max {err})")
    return err


def sign_rows(np, rng, rows, n):
    """``rows`` fp32 rows of length ``n`` of ±2e-4 and 0 (signSGD messages)
    with the edge values of the sign test among them: -0.0, subnormals of
    both signs, ±inf, NaN of both signs, the least normal and the largest
    float."""
    edge = np.array([2e-4, -2e-4, 0.0, -0.0, 1e-40, -1e-40, 1.4e-45,
                     -1.4e-45, np.inf, -np.inf, np.nan, FLT_MIN, 3.4e38],
                    np.float32)
    x = (np.sign(rng.standard_normal((rows, n))) * 2e-4).astype(np.float32)
    pick = rng.random((rows, n)) < 0.05
    x[pick] = rng.choice(edge, int(pick.sum()))
    flat = x.reshape(-1)
    flat[:min(edge.size, flat.size)] = edge[:flat.size]
    flat[-1] = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    return x


def check_pack_sign_planes(torch, np, rk, x_np) -> float:
    """``pack_sign_planes`` on the card rows ``x_np`` against its plain
    version and numpy's ``x > 0`` through the host packer; one launch a
    call, two calls identical.  Returns the words' max abs difference."""
    from repro_torch.core.wire import _pack_bits_numpy
    x = torch.from_numpy(np.ascontiguousarray(x_np)).to("cuda")
    before = rk.LAUNCHES.counts["pack_sign_planes"]
    got = rk.pack_sign_planes(x)
    again = rk.pack_sign_planes(x)
    shape = tuple(x.shape)
    require(rk.LAUNCHES.counts["pack_sign_planes"] == before + 2,
            f"one pack_sign_planes call is not one launch at {shape}")
    require(torch.equal(got, again),
            f"two pack_sign_planes calls differ at {shape}")
    w_k = got.cpu().numpy().view(np.uint32)
    w_p = rk.pack_sign_planes_plain(x.cpu()).numpy().view(np.uint32)
    w_np = np.stack([_pack_bits_numpy((r > 0).astype(np.uint8))
                     for r in x_np])
    err = max(words_err(np, w_k, w_p), words_err(np, w_k, w_np))
    require(err == 0.0, f"pack_sign_planes words differ at {shape}")
    return err


def check_sign_plane_tally(torch, np, rk, rng, words_np, weights) -> float:
    """``sign_plane_tally`` on the card words ``words_np`` ((B, W) uint32)
    into a sum that already holds values, against its plain version on the
    CPU and the host accumulator's ``add_sign_plane`` loop, bitwise; one
    launch a call.  Returns the largest abs difference (0.0)."""
    from repro_torch.core.ingest import IngestAccumulator
    from repro_torch.core.wire import words_to_bits
    rows, n_words = words_np.shape
    n = 32 * n_words - int(rng.integers(0, 32))
    start = rng.standard_normal(n) * 1e-4
    acc = IngestAccumulator(n)
    acc.sum[:] = start
    for i in range(rows):
        acc.add_sign_plane(words_to_bits(words_np[i], n), 2e-4,
                           float(weights[i]))
    words = torch.from_numpy(words_np.view(np.int32))
    w = torch.from_numpy(np.asarray(weights, np.float64))
    total = torch.from_numpy(start.copy()).to("cuda")
    before = rk.LAUNCHES.counts["sign_plane_tally"]
    rk.sign_plane_tally(words.to("cuda"), 2e-4, w.to("cuda"), total)
    require(rk.LAUNCHES.counts["sign_plane_tally"] == before + 1,
            f"one sign_plane_tally call is not one launch at {rows} rows")
    plain = rk.sign_plane_tally(words, 2e-4, w,
                                torch.from_numpy(start.copy()))
    got = total.cpu().numpy()
    require(np.array_equal(got.view(np.uint64), plain.numpy().view(np.uint64))
            and np.array_equal(got.view(np.uint64), acc.sum.view(np.uint64)),
            f"sign_plane_tally differs from its plain version or the host "
            f"loop at ({rows}, {n_words}), n={n}")
    return float(np.abs(got - acc.sum).max(initial=0.0))


def check_unpack_bits(torch, np, rk, rng, n_words, rows=None) -> float:
    """``unpack_bits`` on ``n_words`` random card words (or
    ``unpack_words_batched`` on ``rows`` rows of them; the edge words 0, 1,
    0x80000000 and 0xFFFFFFFF first) against its plain version and the
    host unpack: bits and zero counts identical, one launch a call;
    returns 0.0."""
    from repro_torch.core.wire import _unpack_bits_numpy
    shape = (n_words,) if rows is None else (rows, n_words)
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)
    w.reshape(-1)[:min(w.size, 4)] = edge[:w.size]
    words = torch.from_numpy(w.view(np.int32)).to("cuda")
    unpack = (rk.unpack_words_with_counts if rows is None
              else rk.unpack_words_batched)
    before = rk.LAUNCHES.counts["unpack_bits"]
    bits, zeros = unpack(words)
    require(rk.LAUNCHES.counts["unpack_bits"] == before + 1,
            f"one unpack_bits call is not one launch at {shape}")
    bits_p, zeros_p = rk.unpack_words_plain(words)
    w = w.reshape(-1)
    bits_np = _unpack_bits_numpy(w)
    zeros_np = 32 - bits_np.reshape(-1, 32).sum(axis=1, dtype=np.int64)
    got_bits = bits.cpu().numpy().reshape(-1)
    got_zeros = zeros.cpu().numpy().reshape(-1)
    err = max(float(np.abs(got_bits.astype(np.int64) - bits_np).max()),
              float(np.abs(got_zeros - zeros_np).max()))
    require(torch.equal(bits, bits_p) and torch.equal(zeros, zeros_p)
            and err == 0.0, f"unpack_bits differs at {shape}")
    return err


def golomb_vs_plain(torch, np, rk, words, word_start, bit_len, nnz, numel,
                    b):
    """``golomb_decode`` and its plain version on the same card words:
    ``(raised, max_abs_err)``; fails unless both raise or both give
    identical fields."""
    from repro_torch.core.wire import WireDecodeError
    w = torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                         .view(np.int32)).to("cuda")
    table = [torch.from_numpy(np.array(a, np.int64, ndmin=1))
             for a in (word_start, bit_len, nnz)]
    out = []
    for fn in (rk.decode_golomb_fields, rk.decode_golomb_fields_plain):
        try:
            out.append(fn(w, *table, numel, b))
        except WireDecodeError:
            out.append(None)
    torch.cuda.synchronize()
    got, want = out
    require((got is None) == (want is None),
            f"golomb_decode {'raised' if got is None else 'decoded'} where "
            f"its plain version did not (W={w.numel()}, b={b})")
    if got is None:
        return True, 0.0
    require(all(g.dtype == h.dtype and torch.equal(g, h)
                for g, h in zip(got, want)),
            f"golomb_decode fields differ from its plain version "
            f"(W={w.numel()}, b={b})")
    return False, max(float((g.double() - h.double()).abs().max())
                      if g.numel() else 0.0 for g, h in zip(got, want))


def check_golomb_cases(torch, np, rk) -> float:
    """``golomb_decode`` against its plain version on the card: valid
    batches over the P grid and b = 30, the decoder's traps (unary runs over
    chunks and compose tiles, codewords ending on chunk ends, ``bit_len %
    32 == 0``, empty segments, b = 0), a cnn round, all-ones buffers, 300
    corrupt batches and the 60 mutations of the reference's wire fuzz test
    (the case builders of ``tests/_golomb_cases.py``); fields identical,
    verdicts identical.  Returns the largest field difference (0.0)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _golomb_cases as gc
    from repro_torch.core import wire
    err, raised, n = 0.0, 0, 0
    batches = (gc.valid_cases() + gc.trap_cases() + [("cnn", *gc.cnn_round())]
               + gc.corrupt_cases(300))
    tables = [(bt.words, bt.word_start, bt.bit_len, bt.nnz, bt.numel,
               wire._b_star_checked(p)) for _, bt, p in batches]
    tables += [(m.words, 0, m.bit_len, m.nnz, m.numel,
                wire._b_star_checked(p)) for _, m, p in gc.fuzz_messages()
               if m.bit_len <= 32 * m.words.size]
    tables += [(np.full(40, 0xFFFFFFFF, np.uint32), 0, bl, 0, 10**9, b)
               for b in (0, 5, 30) for bl in (1, 32, 257, 1280)]
    for table in tables:
        r, e = golomb_vs_plain(torch, np, rk, *table)
        raised, err, n = raised + r, max(err, e), n + 1
    require(raised >= 150, f"only {raised} corrupt golomb cases raised")
    print(f"golomb_decode: {n} cases against its plain version on the card, "
          f"{raised} raised on both, the rest identical fields")
    return err


def check_threshold_stats(torch, np, rk, rng) -> float:
    """``threshold_stats`` at the cnn's n on a row with zeros and on a
    subnormal row, at t = 0, a subnormal t, two quantiles and above the
    max, and on a short row (n = 17): counts exact, sums within rtol 1e-6,
    one launch a call, and a second call identical to the first.  Returns
    the sums' largest abs difference."""
    x_np = (rng.standard_normal(MAIN_N) * 1e-3).astype(np.float32)
    x_np[rng.random(MAIN_N) < 0.1] = 0.0
    rows = [torch.from_numpy(x_np).to("cuda"),
            torch.from_numpy(subnormal_row(np, rng, MAIN_N).astype(
                np.float32)).to("cuda"),
            torch.from_numpy(rng.standard_normal(17).astype(
                np.float32)).to("cuda")]
    err = 0.0
    for x in rows:
        a = x.abs()
        for t in (torch.zeros((), device="cuda"),
                  torch.full((), 1e-40, device="cuda"), a.quantile(0.5),
                  a.quantile(0.98), a.max() * 2):
            before = rk.LAUNCHES.counts["threshold_stats"]
            cnt, total = rk.threshold_stats(x, t)
            again = rk.threshold_stats(x, t)
            require(rk.LAUNCHES.counts["threshold_stats"] == before + 2,
                    "one threshold_stats call is not one launch")
            cnt_p, total_p = rk.threshold_stats_plain(x, t)
            what = f"n={x.numel()} t={float(t)}"
            require(int(cnt) == int(cnt_p),
                    f"threshold_stats count differs at {what}")
            require(bool(torch.allclose(total, total_p, rtol=1e-6,
                                        atol=0.0)),
                    f"threshold_stats sum beyond rtol 1e-6 at {what}")
            require(torch.equal(cnt, again[0])
                    and torch.equal(total, again[1]),
                    f"two threshold_stats calls differ at {what}")
            err = max(err, float((total - total_p).abs()))
    require(int(rk.threshold_stats(rows[0], torch.zeros((), device="cuda"))
                [0]) == int((x_np != 0).sum()),
            "threshold_stats counted zeros")
    normal = int((rows[1].abs() >= FLT_MIN).sum())
    require(int(rk.threshold_stats(rows[1], 1e-40)[0]) == normal,
            "threshold_stats counted subnormals")
    return err


def bisect_vs_plain(torch, rk, x, k, iters=32) -> float:
    """The fused bisection on the card against its plain version on the
    same card tensor and on the CPU: ``lo`` and the count bitwise, Σ within
    rtol 1e-6, one launch a call, and a second call with identical bits.
    Returns Σ's abs difference."""
    what = f"n={x.numel()} k={k} iters={iters}"
    before = rk.LAUNCHES.counts["bisect_select"]
    got = rk.topk_threshold(x, k, iters=iters)
    again = rk.topk_threshold(x, k, iters=iters)
    require(rk.LAUNCHES.counts["bisect_select"] == before + 2,
            f"one bisection is not one launch at {what}")
    for want in (rk.topk_threshold_plain(x, k, iters),
                 rk.topk_threshold_plain(x.cpu(), k, iters)):
        require(torch.equal(got[0].cpu().view(torch.int32),
                            want[0].cpu().view(torch.int32))
                and int(got[1]) == int(want[1]),
                f"bisection lo or count differs from its plain version at "
                f"{what}")
        require(bool(torch.allclose(got[2].cpu(), want[2].cpu(), rtol=1e-6,
                                    atol=0.0)),
                f"bisection sum beyond rtol 1e-6 at {what}")
    require(all(torch.equal(g.view(torch.int32), a.view(torch.int32))
                for g, a in zip(got, again)),
            f"two bisection calls differ at {what}")
    return float((got[2].cpu() - want[2]).abs())


def check_bisection(torch, np, rk, rng) -> float:
    """The fused bisection against its plain version: at the cnn's n for
    p in {0.001, 1/50, 0.1} (count = k), on
    the edge cases of ``tests/_bisect_cases.py`` (all zero, subnormal,
    k = n, ties, n below 32, fewer non-zeros than k) with ``iters`` 0 and
    32, on a subnormal row, and on a vector larger than the cluster's
    shared memory (4,000,037 elements); ``stc_compress_kernel(selector=
    "bisect")`` under ``set_sync_debug_mode("error")``, and against
    ``"hist"`` at p = 1/50 (the same mask).  Returns the largest sum
    difference."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _bisect_cases as bc
    x = torch.from_numpy(
        (rng.standard_normal(MAIN_N) * 1e-3).astype(np.float32)).to("cuda")
    err = 0.0
    for p in (0.001, P_STC, 0.1):
        k = max(int(MAIN_N * p), 1)
        err = max(err, bisect_vs_plain(torch, rk, x, k))
        require(int(rk.topk_threshold(x, k)[1]) == k,
                f"bisection count is not k={k}")
    n_cases = 0
    for case, k in bc.EDGE_CASES:
        row = torch.from_numpy(bc.edge_row(
            case, np.random.default_rng(k))).to("cuda")
        for iters in (0, 32):
            err = max(err, bisect_vs_plain(torch, rk, row, k, iters))
            n_cases += 1
    sub = torch.from_numpy(subnormal_row(np, rng, MAIN_N).astype(
        np.float32)).to("cuda")
    big = torch.from_numpy(
        (rng.standard_normal(4_000_037) * 1e-3).astype(np.float32)).to("cuda")
    for row, k in ((sub, 1000), (sub, 6148), (big, 80_000)):
        err = max(err, bisect_vs_plain(torch, rk, row, k))
    print(f"bisect_select: {n_cases} edge cases, the cnn's n at three k "
          f"a subnormal row and n=4,000,037: lo and "
          f"count bitwise its plain version's, two calls identical")
    res = torch.zeros_like(x)
    rk.stc_compress_kernel(x, res, P_STC, selector="bisect")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rk.stc_compress_kernel(x, res, P_STC, selector="bisect")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    r = torch.from_numpy(
        (rng.standard_normal(MAIN_N) * 1e-4).astype(np.float32)).to("cuda")
    bis = rk.stc_compress_kernel(x, r, P_STC, selector="bisect")
    hist = rk.stc_compress_kernel(x, r, P_STC, selector="hist")
    require(torch.equal(torch.sign(bis[0]), torch.sign(hist[0]))
            and int(bis[4]) == int(hist[4]),
            "selector='bisect' and 'hist' select different masks")
    return err


# ---------------------------------------------------------------- phase 3

DENSE_KERNELS = ("stc_apply", "histogram", "bin_select", "pack_chunks")
INGEST_KERNELS = DENSE_KERNELS + ("golomb_decode",)


# each codec's settings on the cnn: examples/federated_noniid.py's
# DEMO_OVERRIDES, and the "kernel" backends where a codec has them
CODEC_KW = {
    "stc": dict(sparsity_up=P_STC, sparsity_down=P_STC, backend="kernel",
                wire_backend="kernel"),
    "signsgd": dict(wire_backend="kernel"),
    "topk": dict(sparsity_up=P_STC),
    "fedavg": dict(local_iters=10),
}


def make_trainer(device, torch, ingest=False, codec="stc", buffered=None,
                 lr=0.05, **cfg):
    """The cnn trainer of ``examples/federated_noniid.py`` with ``codec``;
    ``buffered`` (a dict of ``BufferedFederatedTrainer`` keywords) makes it
    the buffered trainer; ``cfg`` are further ``TrainerConfig`` fields
    (``chunks``, ``controller``)."""
    from repro_torch.core import make_protocol
    from repro_torch.data import make_image_classification
    from repro_torch.fed import FedEnvironment, FederatedTrainer, \
        TrainerConfig
    from repro_torch.models import MODEL_ZOO
    train, test = make_image_classification(seed=0, n=6000)
    env = FedEnvironment(n_clients=10, participation=1.0,
                         classes_per_client=2, batch_size=20)
    proto = make_protocol(codec, **CODEC_KW.get(codec, {}))
    args = (MODEL_ZOO["cnn"], train, test, env, proto,
            TrainerConfig(lr=lr, ingest=ingest, **cfg))
    if buffered is not None:
        from repro_torch.fed import BufferedFederatedTrainer
        return BufferedFederatedTrainer(*args, **buffered, device=device)
    return FederatedTrainer(*args, device=device)


def run_trainers(torch, rk, ingest=False):
    """The cnn on the card (counters set to 0 just before) and on the CPU;
    requires the path's kernels to have launched on the card's run.  The
    dense card run also records every selection's candidate bin
    (``probe_selections``)."""
    from repro_torch.kernels import hist_select
    path, needed = (("ingest", INGEST_KERNELS) if ingest
                    else ("dense", DENSE_KERNELS))
    gpu = make_trainer("cuda", torch, ingest=ingest)
    require(gpu.numel == MAIN_N, f"cnn has {gpu.numel} parameters")
    require(gpu.ingest == ingest, f"the {path} trainer is not on its path")
    located = []
    locate_bin = hist_select.locate_bin

    def recording_locate_bin(*args):
        out = locate_bin(*args)
        located.append((out[0].clone(), out[3].clone()))   # b, cnt_b
        return out

    if not ingest:
        hist_select.locate_bin = recording_locate_bin
    try:
        rk.LAUNCHES.reset()
        t0 = time.perf_counter()
        h_gpu = gpu.run(ROUNDS, eval_every=ROUNDS)[-1]
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        launches = dict(rk.LAUNCHES.counts)
        shapes = dict(rk.LAUNCHES.shapes)
    finally:
        hist_select.locate_bin = locate_bin
    require(bool(torch.isfinite(gpu.params_vec).all()), "non-finite params")
    for name in needed:
        require(launches[name] > 0,
                f"kernel {name} never launched on the {path} path")
    require(launches["bin_select"] == launches["histogram"] == 2 * ROUNDS,
            f"the {path} path selected {launches['bin_select']} times with "
            f"bin_select and {launches['histogram']} with the histogram in "
            f"{ROUNDS} rounds, not twice a round with both")
    if located:
        probe_selections(located)
    require(launches["pack_chunks"] == 2 * ROUNDS
            and launches["pack_bits"] == 0,
            f"the {path} ledger packed {launches['pack_chunks']} times with "
            f"pack_chunks and {launches['pack_bits']} with pack_bits in "
            f"{ROUNDS} rounds, not twice a round with pack_chunks alone")
    if ingest:
        require(launches["golomb_decode"] >= ROUNDS
                and launches["unpack_bits"] == 0,
                f"the ingest path decoded {launches['golomb_decode']} times "
                f"with golomb_decode and {launches['unpack_bits']} with "
                f"unpack_bits in {ROUNDS} rounds, not at least once a round "
                f"with golomb_decode alone")

    cpu = make_trainer("cpu", torch, ingest=ingest)
    t0 = time.perf_counter()
    h_cpu = cpu.run(ROUNDS, eval_every=ROUNDS)[-1]
    cpu_s = time.perf_counter() - t0
    require(rk.LAUNCHES.counts == launches,
            "the CPU run launched a CUDA kernel")
    d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
    d_up = abs(h_gpu["bits_up"] / h_cpu["bits_up"] - 1.0)
    d_params = float((gpu.params_vec.cpu() - cpu.params_vec).norm()
                     / cpu.params_vec.norm())
    print(f"{path} trainer: cnn {gpu.numel} params, {ROUNDS} rounds | card "
          f"acc={h_gpu['acc']:.4f} bits_up={h_gpu['bits_up']:.0f} "
          f"bits_down={h_gpu['bits_down']:.0f} ({gpu_s:.1f} s) | cpu "
          f"acc={h_cpu['acc']:.4f} bits_up={h_cpu['bits_up']:.0f} "
          f"bits_down={h_cpu['bits_down']:.0f} ({cpu_s:.1f} s) | "
          f"|d acc|={d_acc:.4f} |d bits_up|={d_up:.4%} "
          f"|d params|/|params|={d_params:.3e}")
    print(f"{path}-path launches: {json.dumps(launches)} shapes: "
          f"{json.dumps({k: list(v) for k, v in shapes.items()})}")
    require(d_acc <= 0.03, f"accuracy differs by {d_acc:.4f} > 0.03")
    require(d_up <= 0.02, f"bits_up differs by {d_up:.4%} > 2%")
    return gpu, launches, shapes


def probe_selections(located) -> None:
    """Round by round, the candidate bin ``b`` and its population ``cnt_b``
    of the encode selection (the cohort's rows) and of the server's, and
    how many of them the old refinement would have sent to its full-row
    ``torch.sort`` (a selection sorted when any row's bin held more than
    ``cap`` elements)."""
    from repro_torch.core.selection import DEFAULT_CAP
    require(len(located) == 2 * ROUNDS,
            f"{len(located)} selections recorded in {ROUNDS} rounds")
    sorted_sel = {"encode": 0, "server": 0}
    rows_over = rows_all = 0
    for rnd in range(ROUNDS):
        line = []
        for role, (b, cnt_b) in zip(("encode", "server"),
                                    located[2 * rnd:2 * rnd + 2]):
            b, cnt_b = b.tolist(), cnt_b.tolist()
            require(len(b) == (MAIN_ROWS if role == "encode" else 1),
                    f"round {rnd + 1}: the {role} selection has {len(b)} "
                    f"rows")
            over = sum(c > DEFAULT_CAP for c in cnt_b)
            sorted_sel[role] += over > 0
            if role == "encode":
                rows_over, rows_all = rows_over + over, rows_all + len(b)
            line.append(f"{role} b={b} cnt_b={cnt_b} over cap {over}")
        print(f"selection probe round {rnd + 1}: {'; '.join(line)}")
    print(f"selection probe: {sorted_sel['encode']} of {ROUNDS} encode and "
          f"{sorted_sel['server']} of {ROUNDS} server selections would have "
          f"taken the old route's full-row torch.sort; {rows_over} of "
          f"{rows_all} client rows had a candidate bin over cap = "
          f"{DEFAULT_CAP}")


def check_lockstep(torch, np, rk, tr, rounds=3):
    """The card's encode, apply and ledger phases against the same phases
    on the CPU (plain versions), round by round from the same inputs: the
    card's local-SGD deltas and the card's state (client and server
    residuals, parameters) at the start of the round, from the trained
    state on.  Positions, signs, counts and wire words must be exact; µ
    within rtol 1e-6; residuals and parameters within 1e-6 of
    ``|value| + µ``.  The trainer's parameters and residuals are left as
    they were; only its data stream advances.  Returns the last round's
    carried matrices (clients', server's) and upstream messages, for the
    timings."""
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

    packs = rk.LAUNCHES.counts["pack_chunks"]
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
        last = {"carried": deltas + client_res[idx],
                "server_carried": (mean + server_res)[None],
                "upstream": msgs.cpu().numpy()}

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
    require(rk.LAUNCHES.counts["pack_chunks"] > packs,
            "the lock-step ledger did not go through pack_chunks")
    print(f"lock-step ({rounds} rounds, card vs CPU from the same inputs): "
          f"{json.dumps(worst)}")
    return last


def check_carried_selection(torch, rk, last) -> float:
    """On the last lock-step round's carried matrices, the clients' (10, n)
    and the server's (1, n): ``bin_select`` against its plain version;
    ``stc_compress_batch`` (the flat trainer's ``"kernel"`` STC, through
    ``stc_compress_rows``) under ``torch.cuda.set_sync_debug_mode("error")``
    (after a first call, which may grow the scratch); and the selection
    under ``torch.profiler``, which must show no ``aten::topk``,
    ``aten::sort`` or ``aten::kthvalue``.  Returns the sums' largest abs
    difference."""
    from torch.profiler import ProfilerActivity, profile
    k = max(int(MAIN_N * P_STC), 1)
    err = 0.0
    for name in ("carried", "server_carried"):
        x = last[name].contiguous()
        err = max(err, check_bin_select(torch, rk, x, k))
        res = torch.zeros_like(x)
        want = rk.stc_compress_batch(x, res, P_STC)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = rk.stc_compress_batch(x, res, P_STC)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(all(torch.equal(g, w) for g, w in zip(got, want)),
                f"two stc_compress_batch calls on the {name} matrix differ")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rk.hist_topk_threshold_batched(x, k)
            torch.cuda.synchronize()
        ops = sorted({e.name for e in prof.events()})
        banned = {"aten::topk", "aten::sort", "aten::kthvalue"} & set(ops)
        require(not banned, f"the card's selection called {sorted(banned)}")
        # host time of the selection's ops, under the profiler (which adds
        # its own overhead to each): where the host-bound selection goes
        avg = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        top = {e.key: [e.count, round(e.self_cpu_time_total / 1e3, 4)]
               for e in avg[:12]}
        calls = sum(e.count for e in avg if e.key.startswith("aten::"))
        print(f"selection on the {name} matrix {tuple(x.shape)}: bin_select "
              f"identical to its plain version; stc_compress_batch ran under "
              f"set_sync_debug_mode('error'); {calls} aten calls (nested ones "
              f"included), host ops "
              f"by self CPU ms under torch.profiler [count, ms]: "
              f"{json.dumps(top)}")
    return err


def check_ingest_lockstep(torch, np, rk, tr, rounds=3):
    """The fused ingest on the card (decode through ``golomb_decode``, STC
    on the card) against the same ingest on the CPU, round by round on the
    card's messages from the trained state: wire words identical, the
    accumulator's sum and weight mass bitwise, the global delta's
    positions, signs and count exact and µ within rtol 1e-6.  The trainer's
    parameters and residuals are left as they were.  Returns the worst
    gaps and the last round's upstream batch."""
    from repro_torch.core.residual import ResidualState
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))
    params = tr.params_vec.clone()
    client_res = tr.client_state.residual.clone()
    server = ResidualState(tr.server_state.residual.clone())
    worst = {"mu_rtol": 0.0, "words_abs": 0.0, "sum_abs": 0.0}
    decodes = rk.LAUNCHES.counts["golomb_decode"]
    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        msgs, cstate, _ = proto.encode_batch(
            deltas, ResidualState(residual=client_res[idx]))
        batch = proto.encode_wire_batch(msgs, direction="up")
        batch_c = proto.encode_wire_batch(msgs.cpu(), direction="up")
        worst["words_abs"] = max(worst["words_abs"],
                                 words_err(np, batch.words, batch_c.words))
        require(worst["words_abs"] == 0.0,
                f"ingest lock-step round {r}: wire words differ")
        acc = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc, batch, w, direction="up",
                                device=tr.device)
        acc_c = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc_c, batch_c, w, direction="up",
                                device="cpu")
        worst["sum_abs"] = max(worst["sum_abs"],
                               float(np.abs(acc.sum - acc_c.sum).max()))
        require(np.array_equal(acc.sum, acc_c.sum)
                and acc.weight_mass == acc_c.weight_mass,
                f"ingest lock-step round {r}: accumulators differ")
        gd, server_new, st = proto.aggregate_ingest(acc, server)
        gd_c, _, st_c = proto.aggregate_ingest(
            acc_c, ResidualState(server.residual.cpu()))
        require(torch.equal(torch.sign(gd.cpu()), torch.sign(gd_c))
                and int(st.nnz) == int(st_c.nnz),
                f"ingest lock-step round {r}: global-delta positions, "
                f"signs or count differ")
        rel = abs(float(st.mu) - float(st_c.mu)) / abs(float(st_c.mu))
        require(rel <= 1e-6, f"ingest lock-step round {r}: µ off by rtol "
                             f"{rel:.3e} > 1e-6")
        worst["mu_rtol"] = max(worst["mu_rtol"], rel)
        client_res[idx] = cstate.residual
        server = server_new
        params = params + gd
    require(rk.LAUNCHES.counts["golomb_decode"] > decodes,
            "the ingest lock-step did not decode through golomb_decode")
    print(f"ingest lock-step ({rounds} rounds, card vs CPU on the card's "
          f"messages): {json.dumps(worst)}")
    return worst, batch


def check_golomb_at_path(torch, np, rk, proto, batch) -> float:
    """``golomb_decode`` on an ingest round's batch (the path's own W)
    against its plain version on the card and the numpy scan; returns the
    largest field difference (0.0)."""
    from repro_torch.core import wire
    b = wire._b_star_checked(proto.sparsity_up)
    raised, err = golomb_vs_plain(torch, np, rk, batch.words,
                                  batch.word_start, batch.bit_len, batch.nnz,
                                  batch.numel, b)
    require(not raised, "golomb_decode raised on a valid ingest batch")
    got = wire.decode_ternary_fields_batch(batch, proto.sparsity_up,
                                           backend="kernel", device="cuda")
    want = wire.decode_ternary_fields_batch(batch, proto.sparsity_up)
    require(all(g.dtype == h.dtype and np.array_equal(g, h)
                for g, h in zip(got, want)),
            "golomb_decode fields differ from the numpy scan")
    print(f"golomb_decode at the ingest path's W={batch.words.size} "
          f"({got[1].size} codewords, {batch.n_msgs} segments): fields "
          f"identical to its plain version and the numpy scan")
    return err


SIGN_KERNELS = ("pack_sign_planes", "sign_plane_tally")


def check_signsgd_ingest(torch, np, rk, rounds=3):
    """signSGD through the fused ingest: the cnn trainer's rounds on the
    card (counters set to 0 just before): one ``pack_sign_planes`` launch
    (the upstream batch) and one ``sign_plane_tally`` launch a round, and
    no per-plane ``pack_bits`` or ``unpack_bits``; then 3 lock-step rounds
    card against CPU from its state: messages, wire words (also against the
    host packer), unpacked sign bits, accumulator (also against the host
    backend's default loop) and global delta identical.  Returns the launch
    counts and shapes of its rounds, and the last lock-step round's
    messages, batch and weights."""
    from repro_torch.core import wire
    from repro_torch.fed.loop import local_sgd
    tr = make_trainer("cuda", torch, ingest=True, codec="signsgd")
    require(tr.ingest, "the signSGD trainer is not on the ingest path")
    rk.LAUNCHES.reset()
    tr.run(rounds, eval_every=rounds)
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES.counts)
    shapes = dict(rk.LAUNCHES.shapes)
    require(all(launches[k] == rounds for k in SIGN_KERNELS)
            and launches["pack_bits"] == launches["unpack_bits"] == 0,
            f"the signSGD ingest path launched pack_sign_planes "
            f"{launches['pack_sign_planes']}, sign_plane_tally "
            f"{launches['sign_plane_tally']}, pack_bits "
            f"{launches['pack_bits']} and unpack_bits "
            f"{launches['unpack_bits']} times in {rounds} rounds, not once "
            f"a round each of the first two and never the last two")
    require(bool(torch.isfinite(tr.params_vec).all()), "non-finite params")
    proto, p = tr.protocol, tr.env.participants_per_round
    host = dataclasses.replace(proto, wire_backend="numpy")
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))
    params = tr.params_vec.clone()
    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        msgs, _, _ = proto.encode_batch(deltas, None)
        msgs_c, _, _ = proto.encode_batch(deltas.cpu(), None)
        require(torch.equal(msgs.cpu(), msgs_c),
                f"signSGD lock-step round {r}: messages differ")
        batch = proto.encode_wire_batch(msgs, direction="up")
        batch_c = proto.encode_wire_batch(msgs_c, direction="up")
        batch_h = host.encode_wire_batch(msgs_c, direction="up")
        for other in (batch_c, batch_h):
            require(words_err(np, batch.words, other.words) == 0.0
                    and all(np.array_equal(getattr(batch, f),
                                           getattr(other, f))
                            for f in ("word_start", "word_count", "bit_len",
                                      "mu", "nnz"))
                    and batch.numel == other.numel,
                    f"signSGD lock-step round {r}: wire batches differ")
        for i in range(p):
            bits = wire.sign_plane_bits(batch.message(i), backend="kernel",
                                        device=tr.device)
            bits_c = wire.sign_plane_bits(batch_c.message(i),
                                          backend="kernel", device="cpu")
            require(np.array_equal(bits, bits_c),
                    f"signSGD lock-step round {r}: unpacked bits differ")
        acc = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc, batch, w, direction="up",
                                device=tr.device)
        acc_c = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc_c, batch_c, w, direction="up",
                                device="cpu")
        acc_h = host.make_ingest(tr.numel)
        host.ingest_wire_batch(acc_h, batch_h, w, direction="up")
        for other in (acc_c, acc_h):
            require(np.array_equal(acc.sum.view(np.uint64),
                                   other.sum.view(np.uint64))
                    and (acc.nnz, acc.n_msgs, acc.weight_mass,
                         acc.stream_bits)
                    == (other.nnz, other.n_msgs, other.weight_mass,
                        other.stream_bits),
                    f"signSGD lock-step round {r}: accumulators differ")
        gd, _, _ = proto.aggregate_ingest(acc, None)
        gd_c, _, _ = proto.aggregate_ingest(acc_c, None)
        require(torch.equal(gd, gd_c),
                f"signSGD lock-step round {r}: global deltas differ")
        params = params + gd.to(tr.device)
    print(f"signSGD ingest: {rounds} rounds on the card, launches "
          f"{json.dumps(launches)}; {rounds} lock-step rounds card vs CPU: "
          f"messages, words, unpacked bits, accumulator (also the host "
          f"backend's) and global delta identical")
    return launches, shapes, {"msgs": msgs, "batch": batch, "weights": w,
                              "trainer": tr}


def run_bisection(torch, np, rk):
    """The bisection path through its entry point,
    ``stc_compress_kernel(selector="bisect")``, at the cnn's width, counters
    set to 0 just before: exactly one ``bisect_select`` launch (all iters +
    1 = 33 rounds), one ``stc_apply`` and no ``threshold_stats``; then
    ``threshold_stats`` through its own entry point at the selected
    threshold (one launch, counting k): a check only, whose launch is not
    counted (no path launches ``threshold_stats``).  Returns the path's
    launch counts and shapes."""
    rng = np.random.default_rng(3)
    delta = torch.from_numpy(
        (rng.standard_normal(MAIN_N) * 1e-3).astype(np.float32)).to("cuda")
    residual = torch.from_numpy(
        (rng.standard_normal(MAIN_N) * 1e-4).astype(np.float32)).to("cuda")
    rk.LAUNCHES.reset()
    tern, res, mu, thresh, cnt = rk.stc_compress_kernel(
        delta, residual, P_STC, selector="bisect")
    torch.cuda.synchronize()
    launches = dict(rk.LAUNCHES.counts)
    shapes = dict(rk.LAUNCHES.shapes)
    require(launches["bisect_select"] == 1 and launches["stc_apply"] == 1
            and launches["threshold_stats"] == 0,
            f"the bisection path launched bisect_select "
            f"{launches['bisect_select']} times, stc_apply "
            f"{launches['stc_apply']} and threshold_stats "
            f"{launches['threshold_stats']}, not 1, 1 and 0")
    k = max(int(MAIN_N * P_STC), 1)
    require(int(cnt) == k and int((tern != 0).sum()) == k
            and bool(torch.isfinite(res).all()) and float(mu) > 0,
            "the bisection path's message is wrong")
    print(f"bisection path: stc_compress_kernel(selector='bisect') at n="
          f"{MAIN_N}, k={k}: count {int(cnt)}, launches "
          f"{json.dumps(launches)}")
    carried = delta + residual
    rk.LAUNCHES.reset()
    c_t, s_t = rk.threshold_stats(carried, thresh)
    torch.cuda.synchronize()
    require(rk.LAUNCHES.counts["threshold_stats"] == 1 and int(c_t) == k
            and bool(torch.allclose(s_t, mu * k, rtol=1e-6, atol=0.0)),
            "threshold_stats at the selected threshold is not one launch "
            "counting k with the selection's mass")
    return launches, shapes


# ---------------------------------------------------------------- phase 4

KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")

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


def upstream_chunks(np, last):
    """The chunks of the last lock-step round's upstream batch, as the
    ``"kernel"`` backend hands them to ``pack_chunks`` in the per-client
    regime: ``(vals, lens, offs, total_bits)``."""
    from repro_torch.core import wire
    up = last["upstream"]
    vals, lens, offs, batch = wire._client_chunks_batch(
        up, [np.flatnonzero(r) for r in up], wire._b_star_checked(P_STC))
    return vals, lens, offs, 32 * int(batch.word_count.sum())


def row_scale(torch, x):
    """The k-selection's per-row scale, 256 / max|x| (0 for a row of zeros
    and subnormals)."""
    a_max = x.abs().amax(dim=1)
    return torch.where(a_max >= FLT_MIN, 256.0 / a_max,
                       torch.zeros_like(a_max))


def time_histogram(torch, rk, mats):
    """The histogram's device time on each named ``(x, scale)`` at 1, 2 and
    4 CTAs an SM (the launch's grid), printed; returns the times at the
    shipped setting."""
    from repro_torch.kernels import hist_select
    shipped = hist_select._CTAS_PER_SM
    sweep = {}
    try:
        for per_sm in (1, 2, 4):
            hist_select._CTAS_PER_SM = per_sm
            sweep[per_sm] = {
                name: event_ms(torch, lambda x=x, sc=sc:
                               rk.magnitude_histogram_batched(x, sc))
                for name, (x, sc) in mats.items()}
    finally:
        hist_select._CTAS_PER_SM = shipped
    print(f"histogram ms by CTAs an SM (shipped: {shipped}): "
          f"{json.dumps(sweep)}")
    return sweep[shipped]


def golomb_row(torch, np, rk, launches, errs, batch, p, bound):
    """``golomb_decode`` on an ingest round's batch: device time of its
    three passes (the segment table uploaded once), the wrapper with its
    status read, the plain version on the card and the numpy field scan
    (host included), and the byte bound of this batch."""
    from repro_torch.core import wire
    from repro_torch.kernels import wiredecode
    b = wire._b_star_checked(p)
    ws, bl, nnz = (np.asarray(a, np.int64)
                   for a in (batch.word_start, batch.bit_len, batch.nnz))
    table = [torch.from_numpy(a) for a in (ws, bl, nnz)]
    w = torch.from_numpy(np.ascontiguousarray(batch.words, np.uint32)
                         .view(np.int32)).to("cuda")
    meta_np = wiredecode._segment_meta(ws, bl, nnz)
    meta = torch.from_numpy(meta_np).to("cuda")
    n_chunks, n_out = int(meta_np[-1, 2]), int(meta_np[-1, 3])
    n_words, n_seg = w.numel(), ws.size

    def passes():
        return wiredecode._launch_decode(w, meta, n_chunks, n_out, b)

    return {
        "name": "golomb_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/golomb_decode.cu",
        "replaces": "src/repro/kernels/wiredecode.py:57",
        "launches": launches["golomb_decode"],
        "max_abs_err": errs["golomb_decode"],
        "ms": event_ms(torch, passes),
        "plain_ms": event_ms(torch, lambda: rk.decode_golomb_fields_plain(
            w, *table, batch.numel, b), iters=10, hold_stream=False),
        # words, the (start, length, nnz) table and the status read once;
        # seg, position and sign written once a codeword
        "bound_ms": bound(4 * n_words + 24 * n_seg + 24 * n_seg
                          + 20 * n_out), "bound_by": "bytes",
        "library_ms": None,
        "wrapper_ms": event_ms(torch, lambda: rk.decode_golomb_fields(
            w, *table, batch.numel, b), iters=20, hold_stream=False),
        "numpy_ms": event_ms(torch, lambda: wire._decode_fields_numpy(
            batch.words, ws, bl, nnz, batch.numel, b), iters=5,
            hold_stream=False),
        "pass_ms": kernel_times(torch, passes),
        "words": n_words, "codewords": n_out, "segments": n_seg,
        "chunks": n_chunks}


def select_row(torch, rk, launches, errs, last, bound):
    """``bin_select`` on the last lock-step round's carried matrices, the
    clients' (10, n) and the server's (1, n), at the inputs the selection
    gives it: device time and its four passes (``torch.profiler``), the
    plain version (host included: it synchronizes), the byte bound and
    ``torch.topk`` of the same matrix; and the whole k-selection, host
    included and in device time, beside ``torch.topk`` in both."""
    k = max(int(MAIN_N * P_STC), 1)
    row = {"name": "bin_select", "route": "cuda",
           "source": "src/repro_torch/csrc/bin_select.cu",
           "replaces": "src/repro/kernels/hist_select.py:292",
           "launches": launches["bin_select"],
           "max_abs_err": errs["bin_select"], "bound_by": "bytes"}
    for name, sfx in (("carried", ""), ("server_carried", "_b1")):
        x = last[name].contiguous()
        rows, n = x.shape
        scale, b, r, cnt_b = select_inputs(torch, x, k)
        a = x.abs()

        def kernel(x=x, scale=scale, b=b, r=r):
            return rk.candidate_select_batched(x, scale, b, r)

        def topk(a=a):
            return torch.topk(a, k, dim=1)

        def select(x=x):
            return rk.hist_topk_threshold_batched(x, k)

        def topk_abs(x=x):
            return torch.topk(x.abs(), k, dim=1)

        row["ms" + sfx] = event_ms(torch, kernel)
        row["plain_ms" + sfx] = event_ms(
            torch, lambda x=x, scale=scale, b=b, r=r:
            rk.candidate_select_plain(x, scale, b, r), iters=10,
            hold_stream=False)
        # x read once; scale, b and r read and v, cnt_in, sum_in written
        row["bound_ms" + sfx] = bound(4 * rows * n + 20 * rows + 12 * rows)
        row["library_ms" + sfx] = event_ms(torch, topk)
        row["pass_ms" + sfx] = kernel_times(torch, kernel)
        row["cnt_b" + sfx] = cnt_b.tolist()
        sel = {"host": event_ms(torch, select, iters=20, hold_stream=False),
               "device": event_ms(torch, select, iters=20)}
        ref = {"host": event_ms(torch, topk_abs, iters=20, hold_stream=False),
               "device": event_ms(torch, topk_abs, iters=20)}
        row["selection_ms" + sfx], row["topk_ms" + sfx] = sel, ref
        print(f"selection on the {name} matrix ({rows}, {n}), k={k}: "
              f"histogram route host included {sel['host']:.4f} ms, device "
              f"{sel['device']:.4f} ms; torch.topk of |x| host included "
              f"{ref['host']:.4f} ms, device {ref['device']:.4f} ms")
    return row


def bisect_row(torch, rk, launches, errs, x1, bound):
    """The fused bisection on the bisection path's vector: device time and
    host included, and per step (iters + 1 = 33 steps: 32 bisection steps,
    settled two a round, and the final count); the plain loop (device time: its ~300 small launches
    queue behind the hold two calls at a time); the bound, one read of x;
    and ``torch.topk`` of ``|x|``, the library call that selects the same
    k, in device time and host included.  Then both in device time at
    n = 17 (below one warp a CTA) and n = 4,000,037 (past the cluster's
    shared memory, 917,504 elements), where the kernel is not held to its
    bound."""
    n = x1.numel()
    k = max(int(n * P_STC), 1)
    steps = 33

    def kernel():
        return rk.topk_threshold(x1, k)

    def topk():
        return torch.topk(x1.abs(), k)

    row = {"name": "bisect_select", "route": "cuda",
           "source": "src/repro_torch/csrc/bisect_select.cu",
           "replaces": "src/repro/kernels/topk_threshold.py:104",
           "launches": launches["bisect_select"],
           "max_abs_err": errs["bisection"]}
    row["ms"] = event_ms(torch, kernel)
    row["ms_host"] = event_ms(torch, kernel, iters=20, hold_stream=False)
    row["us_per_step"] = row["ms"] * 1e3 / steps
    row["plain_ms"] = event_ms(
        torch, lambda: rk.topk_threshold_plain(x1, k), iters=1)
    row["plain_ms_host"] = event_ms(
        torch, lambda: rk.topk_threshold_plain(x1, k), iters=5,
        hold_stream=False)
    row["bound_ms"] = bound(4 * n + 4 + 4 + 4)   # x once; lo, cnt, sum
    row["bound_by"] = "bytes"
    row["library_ms"] = event_ms(torch, topk)
    row["library_ms_host"] = event_ms(torch, topk, iters=20,
                                      hold_stream=False)
    print(f"bisect_select at n={n}, k={k}, {steps} steps: device "
          f"{row['ms']:.4f} ms ({row['us_per_step']:.3f} us a step), host "
          f"included {row['ms_host']:.4f} ms; torch.topk of |x| device "
          f"{row['library_ms']:.4f} ms, host included "
          f"{row['library_ms_host']:.4f} ms; bound {row['bound_ms']:.5f} ms")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for m in (17, 4_000_037):
        xm = torch.randn(m, generator=gen, device="cuda")
        km = max(int(m * P_STC), 1)
        ms = event_ms(torch, lambda: rk.topk_threshold(xm, km))
        lib = event_ms(torch, lambda: torch.topk(xm.abs(), km))
        row[f"ms_n{m}"], row[f"library_ms_n{m}"] = ms, lib
        print(f"bisect_select at n={m}, k={km}: device {ms:.4f} ms, "
              f"torch.topk of |x| {lib:.4f} ms, bound "
              f"{bound(4 * m + 12):.5f} ms")
    return row


def sign_plane_kernel_rows(torch, np, rk, shapes, launches, errs, signsgd,
                           bound):
    """The four sign-plane rows on the last signSGD lock-step round: the
    path's kernels ``pack_sign_planes`` on its (B, n) messages and
    ``sign_plane_tally`` on its (B, W) words into an fp64 sum of n, and the
    uint8 forms no path launches (``pack_bits``, ``unpack_bits``: 0
    launches, timed at one plane and at the batch, through their own
    entries).  Beside the kernels: their plain versions on the card, ten
    one-plane launches (what the path ran before it was batched), and for
    the tally the host loop it replaces (``add_sign_plane`` over the
    unpacked planes, host clock) and the ingest step host included (words
    and sum up, one launch, sum down)."""
    from repro_torch.core.ingest import IngestAccumulator
    from repro_torch.core.wire import words_to_bits
    msgs = signsgd["msgs"].contiguous()
    rows, n = shapes["pack_sign_planes"]
    require(tuple(msgs.shape) == (rows, n),
            f"signSGD messages {tuple(msgs.shape)} are not the path's "
            f"pack_sign_planes shape {(rows, n)}")
    batch, weights = signsgd["batch"], signsgd["weights"]
    n_words = -(-n // 32)
    words_np = batch.words.reshape(rows, n_words)
    words = torch.from_numpy(words_np.view(np.int32)).to("cuda")
    w64 = torch.from_numpy(np.asarray(weights, np.float64)).to("cuda")
    total = torch.zeros(n, dtype=torch.float64, device="cuda")
    bits = (msgs > 0).to(torch.uint8)
    planes = [bits[i] for i in range(rows)]
    word_rows = [words[i] for i in range(rows)]

    def ten_packs():
        for plane in planes:
            rk.pack_bits(plane)

    def ten_unpacks():
        for row in word_rows:
            rk.unpack_words_with_counts(row)

    def host_loop():
        acc = IngestAccumulator(n)
        for i in range(rows):
            acc.add_sign_plane(words_to_bits(words_np[i], n), 2e-4,
                               float(weights[i]))

    def tally_step():
        host = np.zeros(n)
        t = torch.from_numpy(host).to("cuda")
        rk.sign_plane_tally(torch.from_numpy(words_np.view(np.int32))
                            .to("cuda"), 2e-4, torch.from_numpy(
                                np.asarray(weights, np.float64)).to("cuda"),
                            t)
        torch.from_numpy(host).copy_(t)

    def plain_tally():
        rk.sign_plane_tally_plain(words, 2e-4, w64, total)

    out = [{
        "name": "pack_sign_planes", "route": "cuda",
        "source": "src/repro_torch/csrc/pack_bits.cu",
        "replaces": "src/repro/kernels/bitpack.py:59",
        "launches": launches["pack_sign_planes"],
        "max_abs_err": errs["pack_sign_planes"],
        "ms": event_ms(torch, lambda: rk.pack_sign_planes(msgs)),
        "plain_ms": event_ms(torch, lambda: rk.pack_sign_planes_plain(msgs)),
        # fp32 values read once, words written once
        "bound_ms": bound(4 * rows * n + 4 * rows * n_words),
        "bound_by": "bytes", "library_ms": None,
        "ms_b1": event_ms(torch, lambda: rk.pack_sign_planes(msgs[:1])),
        "bound_ms_b1": bound(4 * n + 4 * n_words),
        "ms_ten_pack_bits_launches": event_ms(torch, ten_packs)}, {
        "name": "pack_bits", "route": "cuda",
        "source": "src/repro_torch/csrc/pack_bits.cu",
        "replaces": "src/repro/kernels/bitpack.py:59",
        "launches": launches["pack_bits"],
        "max_abs_err": errs["pack_bits"],
        "ms": event_ms(torch, lambda: rk.pack_bits(planes[0])),
        "plain_ms": event_ms(torch, lambda: rk.pack_bits_plain(planes[0])),
        "bound_ms": bound(n + 4 * n_words), "bound_by": "bytes",
        "library_ms": None, "on_path": False,
        "ms_batched": event_ms(torch, lambda: rk.pack_bits_batched(bits)),
        "bound_ms_batched": bound(rows * (n + 4 * n_words))}, {
        "name": "sign_plane_tally", "route": "cuda",
        "source": "src/repro_torch/csrc/unpack_bits.cu",
        "replaces": "src/repro/kernels/wiredecode.py:57",
        "launches": launches["sign_plane_tally"],
        "max_abs_err": errs["sign_plane_tally"],
        "ms": event_ms(torch, lambda: rk.sign_plane_tally(words, 2e-4, w64,
                                                          total)),
        "plain_ms": event_ms(torch, plain_tally, iters=10),
        # words and weights read once, the fp64 sum read and written once
        "bound_ms": bound(4 * rows * n_words + 8 * rows + 16 * n),
        "bound_by": "bytes", "library_ms": None,
        "host_loop_ms": event_ms(torch, host_loop, iters=5,
                                 hold_stream=False),
        "step_ms_host": event_ms(torch, tally_step, iters=20,
                                 hold_stream=False),
        "ms_ten_unpack_bits_launches": event_ms(torch, ten_unpacks)}, {
        "name": "unpack_bits", "route": "cuda",
        "source": "src/repro_torch/csrc/unpack_bits.cu",
        "replaces": "src/repro/kernels/wiredecode.py:57",
        "launches": launches["unpack_bits"],
        "max_abs_err": errs["unpack_bits"],
        "ms": event_ms(torch, lambda: rk.unpack_words_with_counts(
            word_rows[0])),
        "plain_ms": event_ms(torch, lambda: rk.unpack_words_plain(
            word_rows[0])),
        "bound_ms": bound(4 * n_words + 32 * n_words + 4 * n_words),
        "bound_by": "bytes", "library_ms": None, "on_path": False,
        "ms_batched": event_ms(torch, lambda: rk.unpack_words_batched(words)),
        "bound_ms_batched": bound(rows * 40 * n_words)}]
    return out


def time_kernels(torch, np, rk, shapes, launches, errs, last, batch_in,
                 signsgd):
    """Device time of each kernel at its path's shapes beside its plain
    version, its byte bound and (where one PyTorch call computes the same
    function) that call; the k-selections beside ``torch.topk``.  ``last``
    is the last lock-step round: the histogram is timed on its carried
    matrices (the main path's inputs) and on a normal matrix,
    ``pack_chunks`` on the chunks of its upstream batch; ``golomb_decode``
    on the last ingest lock-step round's batch; the sign-plane kernels on
    the last signSGD lock-step round's messages and batch (``signsgd``)."""
    from repro_torch.core.selection import bin_index
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rows, n = MAIN_ROWS, MAIN_N          # the encode phase's (P, n) launch
    x = torch.from_numpy(
        (rng.standard_normal((rows, n)) * 1e-3).astype(np.float32)).to(dev)
    k = max(int(n * P_STC), 1)
    scale = row_scale(torch, x)
    t, c, s = rk.hist_topk_threshold_batched(x, k)
    mu = s / c.to(torch.float32)
    carried = last["carried"].contiguous()
    c_scale = row_scale(torch, carried)
    c_bins = bin_index(carried.abs(), c_scale[:, None], 256)
    print(f"carried matrix of the last lock-step round {tuple(carried.shape)}"
          f": share in bin 0 {float((c_bins == 0).double().mean()):.6f}, "
          f"bin 1 {float((c_bins == 1).double().mean()):.6f}, bins 2-255 "
          f"{float((c_bins >= 2).double().mean()):.6f}")
    server = last["server_carried"].contiguous()
    hist_ms = time_histogram(torch, rk, {
        "carried": (carried, c_scale), "normal": (x, scale),
        "server_carried": (server, row_scale(torch, server))})
    vals, lens, offs, up_bits = upstream_chunks(np, last)
    up_words = up_bits // 32
    chunks = chunk_tensors(torch, np, vals, lens, offs)
    n_stats = shapes["bisect_select"][0]   # threshold_stats's own row
    x1 = x[0, :n_stats].contiguous()
    t1 = x1.abs().quantile(1 - P_STC)

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    # the histogram's library yardstick: two row-offset bincounts (counts;
    # sums through weights=) over the same bins
    a = carried.abs()
    flat_bins = (bin_index(a, c_scale[:, None], 256).to(torch.int64)
                 + 256 * torch.arange(rows, device=dev)[:, None]).reshape(-1)
    flat_a = a.reshape(-1)

    def bincount_hist():
        return (torch.bincount(flat_bins, minlength=256 * rows),
                torch.bincount(flat_bins, weights=flat_a,
                               minlength=256 * rows))

    def hist_bound(b):                   # x and scale read, 8 bytes a bin
        return bound(4 * b * n + 4 * b + 8 * 256 * b)

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
        "ms": hist_ms["carried"],
        "plain_ms": event_ms(
            torch, lambda: rk.magnitude_histogram_plain(carried, c_scale)),
        "bound_ms": hist_bound(rows), "bound_by": "bytes",
        "library_ms": event_ms(torch, bincount_hist),
        "ms_normal": hist_ms["normal"],
        "ms_server_b1": hist_ms["server_carried"],
        "bound_ms_b1": hist_bound(1)})
    out.append(select_row(torch, rk, launches, errs, last, bound))
    out.append({
        "name": "pack_chunks", "route": "cuda",
        "source": "src/repro_torch/csrc/pack_chunks.cu",
        "replaces": "src/repro/kernels/bitpack.py:59",
        "launches": launches["pack_chunks"],
        "max_abs_err": errs["pack_chunks"],
        "ms": event_ms(torch, lambda: rk.pack_chunks(*chunks, up_bits)),
        # the plain version sizes its bit plane on the host: host included
        "plain_ms": event_ms(
            torch, lambda: rk.pack_chunks_plain(*chunks, up_bits),
            iters=20, hold_stream=False),
        "bound_ms": bound(20 * len(vals) + 4 * up_words), "bound_by": "bytes",
        "library_ms": None, "chunks": len(vals), "words": up_words})
    out.extend(sign_plane_kernel_rows(torch, np, rk, shapes, launches, errs,
                                      signsgd, bound))
    out.append(golomb_row(torch, np, rk, launches, errs, batch_in, P_STC,
                          bound))
    out.append({
        "name": "threshold_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/threshold_stats.cu",
        "replaces": "src/repro/kernels/topk_threshold.py:38",
        "launches": launches["threshold_stats"],
        "max_abs_err": errs["threshold_stats"],
        "ms": event_ms(torch, lambda: rk.threshold_stats(x1, t1)),
        "plain_ms": event_ms(torch,
                             lambda: rk.threshold_stats_plain(x1, t1)),
        "bound_ms": bound(4 * n_stats + 4 + 4 + 4), "bound_by": "bytes",
        "library_ms": None, "on_path": False,
        "ms_host": event_ms(torch, lambda: rk.threshold_stats(x1, t1),
                            iters=20, hold_stream=False)})
    out.append(bisect_row(torch, rk, launches, errs, x1, bound))
    # every k-selection is timed with its host work, torch.topk beside them
    # (the bisection synchronizes; the histogram route on the carried
    # matrices is also timed in device time, in select_row)
    sel_ms = event_ms(torch, lambda: rk.hist_topk_threshold_batched(x, k),
                      iters=20, hold_stream=False)
    topk_ms = event_ms(torch, lambda: torch.topk(x.abs(), k, dim=1),
                       iters=20, hold_stream=False)
    print(f"selection at ({rows}, {n}), k={k}, host included: histogram "
          f"route {sel_ms:.4f} ms, torch.topk {topk_ms:.4f} ms")
    k1 = max(int(n_stats * P_STC), 1)
    bis_ms = event_ms(torch, lambda: rk.topk_threshold(x1, k1),
                      iters=20, hold_stream=False)
    bis_dev_ms = event_ms(torch, lambda: rk.topk_threshold(x1, k1))
    hist1_ms = event_ms(torch,
                        lambda: rk.hist_topk_threshold_batched(x1[None], k1),
                        iters=20, hold_stream=False)
    topk1_ms = event_ms(torch, lambda: torch.topk(x1.abs(), k1),
                        iters=20, hold_stream=False)
    print(f"selection at ({n_stats},), k={k1}, host included: bisection "
          f"(one bisect_select launch) {bis_ms:.4f} ms (device time "
          f"{bis_dev_ms:.4f} ms), histogram route {hist1_ms:.4f} ms, "
          f"torch.topk {topk1_ms:.4f} ms")
    for row in out:
        lib = (f", library {row['library_ms']:.4f} ms"
               if row["library_ms"] is not None else "")
        extra = {k: v for k, v in row.items() if k not in KERNEL_KEYS}
        print(f"kernel {row['name']}: {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms"
              f"{lib}){' ' + json.dumps(extra) if extra else ''}")
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


def time_decode_split(torch, np, rk, proto, batch, reps=21):
    """The ingest decode of one round's batch split into its steps, host
    clock after ``synchronize``, median of ``reps``, the two backends in
    turns: ``"kernel"`` = words up, decode (the wrapper: table up, three
    passes, status read), fields down, ``np.add.at``; ``"numpy"`` = the
    host field scan (unpack + ``_decode_stream_fields``), ``np.add.at``.
    The two accumulators must be identical."""
    from repro_torch.core import wire
    b = wire._b_star_checked(proto.sparsity_up)
    ws, bl, nnz = (np.asarray(a, np.int64)
                   for a in (batch.word_start, batch.bit_len, batch.nnz))
    table = [torch.from_numpy(a) for a in (ws, bl, nnz)]
    words = np.ascontiguousarray(batch.words, np.uint32).view(np.int32)
    weights = np.full(batch.n_msgs, 0.1)
    names = ("words_up", "decode", "fields_down", "add_at", "numpy_scan",
             "numpy_add_at")
    phases = {name: [] for name in names}

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(reps):
        ts = [sync_now()]
        w = torch.from_numpy(words).to("cuda")
        ts.append(sync_now())
        fields = rk.decode_golomb_fields(w, *table, batch.numel, b)
        ts.append(sync_now())
        seg, pos, sign = (f.cpu().numpy() for f in fields)
        ts.append(sync_now())
        acc = proto.make_ingest(batch.numel)
        acc.scatter_ternary_batch(seg, pos, sign, batch.mu, weights)
        ts.append(sync_now())
        fields_n = wire._decode_fields_numpy(batch.words, ws, bl, nnz,
                                             batch.numel, b)
        ts.append(sync_now())
        acc_n = proto.make_ingest(batch.numel)
        acc_n.scatter_ternary_batch(*fields_n, batch.mu, weights)
        ts.append(sync_now())
        require(np.array_equal(acc.sum, acc_n.sum),
                "the decode split's accumulators differ")
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print(f"ingest decode split (W={words.size}, {int(nnz.sum())} "
          f"codewords, median of {reps}, ms, host clock after synchronize): "
          + json.dumps({k: round(v, 4) for k, v in med.items()}))
    return med


def time_ingest_round(torch, np, tr):
    """One ingest round split into its phases, state left untouched, median
    of 5.  ``wire_encode`` + ``decode_scatter`` are the trainer's
    (``wire_backend="kernel"``: ``pack_chunks`` and ``golomb_decode`` on the
    card); the ``*_numpy`` pair runs the same messages through the host wire
    backend; ``ledger`` is the downstream message (the upstream batch is
    reused)."""
    from repro_torch.core.residual import take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    host = dataclasses.replace(proto, wire_backend="numpy")
    names = ("local_sgd", "encode", "wire_encode", "decode_scatter",
             "wire_encode_numpy", "decode_scatter_numpy", "finalize",
             "ledger")
    phases = {name: [] for name in names + ("round",)}
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(5):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        ts = [sync_now()]
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        ts.append(sync_now())
        msgs, _, _ = proto.encode_batch(deltas,
                                        take_states(tr.client_state, idx))
        ts.append(sync_now())
        batch = proto.encode_wire_batch(msgs, direction="up")
        ts.append(sync_now())
        acc = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc, batch, w, direction="up",
                                device=tr.device)
        ts.append(sync_now())
        batch_n = host.encode_wire_batch(msgs, direction="up")
        ts.append(sync_now())
        acc_n = host.make_ingest(tr.numel)
        host.ingest_wire_batch(acc_n, batch_n, w, direction="up")
        ts.append(sync_now())
        gd, _, _ = proto.aggregate_ingest(acc, tr.server_state)
        ts.append(sync_now())
        proto.encode_wire(gd, direction="down")
        ts.append(sync_now())
        require(np.array_equal(acc.sum, acc_n.sum),
                "the kernel and host wire backends ingest differently")
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    for _ in range(5):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print("ingest round phases (median of 5, ms, host clock after "
          "synchronize): " + json.dumps({k: round(v, 3)
                                         for k, v in med.items()}))
    return med


def time_signsgd_round(torch, np, tr, reps=5):
    """One signSGD ingest round split into its phases, state left
    untouched, median of ``reps``, host clock after ``synchronize``.
    ``wire_encode`` + ``tally`` are the trainer's (``wire_backend=
    "kernel"``); the ``*_numpy`` pair runs the same messages through the
    host wire backend, in turns with it; ``finalize`` is the sign of the
    accumulated mean, ``ledger`` the downstream message.  Uses only entry
    points that every slice of the port has, so it also times an older
    tree (``--signsgd-round``)."""
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    host = dataclasses.replace(proto, wire_backend="numpy")
    names = ("local_sgd", "encode", "wire_encode", "tally",
             "wire_encode_numpy", "tally_numpy", "finalize", "ledger")
    phases = {name: [] for name in names + ("round",)}
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(reps):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        ts = [sync_now()]
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        ts.append(sync_now())
        msgs, _, _ = proto.encode_batch(deltas, None)
        ts.append(sync_now())
        batch = proto.encode_wire_batch(msgs, direction="up")
        ts.append(sync_now())
        acc = proto.make_ingest(tr.numel)
        proto.ingest_wire_batch(acc, batch, w, direction="up",
                                device=tr.device)
        ts.append(sync_now())
        batch_n = host.encode_wire_batch(msgs, direction="up")
        ts.append(sync_now())
        acc_n = host.make_ingest(tr.numel)
        host.ingest_wire_batch(acc_n, batch_n, w, direction="up")
        ts.append(sync_now())
        gd, _, _ = proto.aggregate_ingest(acc, tr.server_state)
        gd = gd.to(tr.device)
        ts.append(sync_now())
        proto.encode_wire(gd, direction="down")
        ts.append(sync_now())
        require(np.array_equal(acc.sum, acc_n.sum),
                "the kernel and host wire backends tally differently")
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    for _ in range(reps):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print(f"signSGD ingest round phases (median of {reps}, ms, host clock "
          f"after synchronize): " + json.dumps({k: round(v, 3)
                                                for k, v in med.items()}))
    return med


def signsgd_round_only(torch, np) -> None:
    """``--signsgd-round``: the signSGD ingest round's phases alone, on the
    tree this file sits in (a parent unpacked beside the change runs this
    file's copy against its own package), then the card's line."""
    tr = make_trainer("cuda", torch, ingest=True, codec="signsgd")
    require(tr.ingest, "the signSGD trainer is not on the ingest path")
    tr.run(2, eval_every=2)                      # warm-up: builds, caches
    torch.cuda.synchronize()
    time_signsgd_round(torch, np, tr)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True).stdout.strip()
    print(f"card after the timing (SM clock, max SM clock, power draw, "
          f"temperature): {clocks}")
    print(card_line())


# ---------------------------------------------------------------- phase 7

PAPER_CODECS = ("baseline", "fedavg", "topk", "ternquant")
SELECTION_KERNELS = ("histogram", "bin_select")
CODEC_ITERS = 20       # local iterations a codec run (fedavg: 2 rounds of 10)
# at the demo's lr 0.05 the dense codecs' cnn training is unstable (FedAvg's
# ten local steps reach NaN in its first round, in the JAX package too, and
# baseline's accuracy swings between evaluations, so that card and CPU part
# ways); at 0.01 all four train stably
CODEC_LR = 0.01
LEDGER_COLS = ("bits_up", "bits_down", "bits_up_analytic",
               "bits_down_analytic")


def ulps_from(np, a, delta):
    """How many fp32 ulps of ``delta`` separate ``a`` from it."""
    return float((np.float64(a) - np.float64(delta))
                 / np.spacing(np.float32(delta)))


def check_codec_lockstep(torch, np, tr, rounds=3):
    """The card's encode and apply phases of a paper codec against the CPU's
    on the same inputs, round by round from the trained state: the card's
    local-SGD deltas, residuals and parameters, and (server side) the
    card's combined mean.  top-k: messages, masks, counts and residuals
    bitwise; baseline and FedAvg: messages bitwise; TernQuant: masks exact
    (a differing element is printed with its distance from Δ in ulps) and
    µ within rtol 1e-6, client and server side.  The trainer's state is
    left as it was; only its data stream advances."""
    from repro_torch.core.compression import ternary_quantize
    from repro_torch.core.residual import (ResidualState,
                                           compress_with_feedback)
    from repro_torch.core.selection import flush_subnormal
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    ones = torch.ones(p, device=tr.device)
    zeros = torch.zeros(p, device=tr.device)
    params = tr.params_vec.clone()
    client_res = (None if tr.client_state is None
                  else tr.client_state.residual.clone())
    server = tr.server_state
    worst = {"mu_rtol": 0.0}

    def bitwise(what, got, want):
        require(np.array_equal(got.cpu().numpy().view(np.int32),
                               want.numpy().view(np.int32)),
                f"{proto.name} lock-step round {r}: {what} differ")

    def same_ternary(what, got, want, st, st_c, carried):
        """Masks exact and µ within rtol 1e-6; ``carried`` (CPU) locates a
        differing element against Δ."""
        mask, mask_c = got.cpu() != 0, want != 0
        if not torch.equal(mask, mask_c):
            a = flush_subnormal(carried).abs().reshape(mask.shape)
            delta = proto.theta * (a.sum(-1, dtype=torch.float64)
                                   .to(torch.float32) / a.shape[-1])
            for row, col in (mask != mask_c).nonzero().tolist()[:20]:
                print(f"{proto.name} lock-step round {r}: {what} mask "
                      f"differs at ({row}, {col}): |x| = "
                      f"{float(a[row, col])!r}, Δ = {float(delta[row])!r}, "
                      f"{ulps_from(np, float(a[row, col]), float(delta[row])):+.2f} ulps")
        require(torch.equal(mask, mask_c),
                f"{proto.name} lock-step round {r}: {what} masks differ")
        require(torch.equal(torch.sign(got.cpu()), torch.sign(want)),
                f"{proto.name} lock-step round {r}: {what} signs differ")
        require(torch.equal(st.nnz.cpu(), st_c.nnz),
                f"{proto.name} lock-step round {r}: {what} counts differ")
        mu_c = st_c.mu.reshape(-1).double()
        rel = float(((st.mu.cpu().reshape(-1).double() - mu_c).abs()
                     / mu_c.abs().clamp(min=1e-300)).max())
        require(rel <= 1e-6, f"{proto.name} lock-step round {r}: {what} µ "
                             f"off by rtol {rel:.3e} > 1e-6")
        worst["mu_rtol"] = max(worst["mu_rtol"], rel)

    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        cs = cs_c = None
        if client_res is not None:
            cs = ResidualState(client_res[idx])
            cs_c = ResidualState(client_res[idx].cpu())
        msgs, cst, st = proto.encode_batch(deltas, cs)
        msgs_c, cst_c, st_c = proto.encode_batch(deltas.cpu(), cs_c)
        gd, sst, sg = proto.aggregate(msgs, server, mask=ones,
                                      staleness=zeros)
        if proto.name == "ternquant":
            carried = deltas.cpu() + cs_c.residual
            same_ternary("client messages", msgs, msgs_c, st, st_c, carried)
            # the server's quantization on the card's combined mean
            mean = proto.combine(msgs, ones, zeros)
            gd_c, _, sg_c = compress_with_feedback(
                mean.cpu(), ResidualState(server.residual.cpu()),
                lambda v: ternary_quantize(v, proto.theta))
            same_ternary("server message", gd[None], gd_c[None], sg, sg_c,
                         (mean.cpu() + server.residual.cpu())[None])
        else:
            bitwise("messages", msgs, msgs_c)
        if proto.name == "topk":
            require(torch.equal(msgs.cpu() != 0, msgs_c != 0)
                    and torch.equal(st.nnz.cpu(), st_c.nnz),
                    f"topk lock-step round {r}: masks or counts differ")
            bitwise("residuals", cst.residual, cst_c.residual)
        if client_res is not None:
            client_res[idx] = cst.residual
        server = sst
        params = params + gd
    print(f"{proto.name} lock-step ({rounds} rounds, card vs CPU from the "
          f"same inputs): "
          + ("messages bitwise" if proto.name in ("baseline", "fedavg")
             else "messages, masks, counts and residuals bitwise"
             if proto.name == "topk"
             else f"masks exact, {json.dumps(worst)}"))


def time_codec_round(torch, np, tr, reps=5):
    """One round of a paper codec split into its phases, host clock after
    ``synchronize``, median of ``reps``: ``local_sgd``, ``encode``,
    ``apply`` (the trainer's aggregate and update, state untouched) and
    ``ledger`` (the analytic bits and the update cache's push of the global
    delta, as the trainer books them), then whole rounds."""
    from repro_torch.core.residual import take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    names = ("local_sgd", "encode", "apply", "ledger")
    phases = {name: [] for name in names + ("round",)}

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(reps):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        ts = [sync_now()]
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        ts.append(sync_now())
        msgs, _, _ = proto.encode_batch(deltas,
                                        take_states(tr.client_state, idx))
        ts.append(sync_now())
        _, _, gd = tr._apply_fn(tr.params_vec, tr.server_state, msgs,
                                torch.ones(p, device=tr.device),
                                torch.zeros(p, device=tr.device))
        ts.append(sync_now())
        tr._account(sel, msgs, gd)
        ts.append(sync_now())
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    for _ in range(reps):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    print(f"{proto.name} round phases (median of {reps}, ms, host clock "
          f"after synchronize): " + json.dumps({k: round(v, 3)
                                                for k, v in med.items()}))
    return med


def run_paper_codecs(torch, np, rk):
    """The paper's comparison codecs on the cnn (``CODEC_ITERS`` local
    iterations each), on the card (counters set to 0 just before) and on the
    CPU from the same initial parameters: accuracy within 0.03 and the four
    (analytic) ledger columns equal; top-k launches the histogram and
    ``bin_select`` exactly once a round and nothing else, the others no
    kernel at all.  Then each codec's lock-step rounds and its round
    phases.  Returns the launch counts and shapes by codec."""
    out = {}
    for name in PAPER_CODECS:
        gpu = make_trainer("cuda", torch, codec=name, lr=CODEC_LR)
        require(gpu.numel == MAIN_N, f"cnn has {gpu.numel} parameters")
        rounds = max(CODEC_ITERS // gpu.protocol.local_iters, 1)
        rk.LAUNCHES.reset()
        t0 = time.perf_counter()
        h_gpu = gpu.run(rounds, eval_every=rounds)[-1]
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        launches = dict(rk.LAUNCHES.counts)
        shapes = dict(rk.LAUNCHES.shapes)
        require(bool(torch.isfinite(gpu.params_vec).all()),
                f"{name}: non-finite params")
        want = {k: (rounds if name == "topk" and k in SELECTION_KERNELS
                    else 0) for k in launches}
        require(launches == want,
                f"{name} launched {json.dumps(launches)} in {rounds} "
                f"rounds, not {json.dumps(want)}")
        cpu = make_trainer("cpu", torch, codec=name, lr=CODEC_LR)
        t0 = time.perf_counter()
        h_cpu = cpu.run(rounds, eval_every=rounds)[-1]
        cpu_s = time.perf_counter() - t0
        require(rk.LAUNCHES.counts == launches,
                f"{name}: the CPU run launched a CUDA kernel")
        d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
        print(f"{name} trainer: cnn, {rounds} rounds of "
              f"{gpu.protocol.local_iters} local iterations | card "
              f"acc={h_gpu['acc']:.4f} ({gpu_s:.1f} s) | cpu "
              f"acc={h_cpu['acc']:.4f} ({cpu_s:.1f} s) | ledger "
              f"{json.dumps({k: h_gpu[k] for k in LEDGER_COLS})} | "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}"
              f" shapes {json.dumps({k: list(v) for k, v in shapes.items()})}")
        require(d_acc <= 0.03, f"{name}: accuracy differs by {d_acc:.4f}")
        for col in LEDGER_COLS:
            require(h_gpu[col] == h_cpu[col],
                    f"{name}: {col} {h_gpu[col]} on the card, {h_cpu[col]} "
                    f"on the CPU")
        check_codec_lockstep(torch, np, gpu)
        time_codec_round(torch, np, gpu)
        out[name] = (launches, shapes)
    print(f"card: {card_line()}")
    return out


# ---------------------------------------------------------------- phase 8

BUFFERED_ROUNDS = 10
BUFFERED_DEADLINE = 0.5   # the default LatencyModel's median latency


def run_buffered(torch, np, rk):
    """STC (p = 1/50 both ways) under ``BufferedFederatedTrainer`` with the
    default ``LatencyModel`` and a deadline at its median latency, on the
    dense route and with ``TrainerConfig(ingest=True)``, ``BUFFERED_ROUNDS``
    rounds each on the card (counters set to 0 just before) and on the CPU:
    ``arrival_log`` identical, accuracy within 0.03 and ``bits_up`` within
    2 %.  Then ``deadline=inf`` against the synchronous trainer on the card,
    3 rounds: parameters and the ledger bitwise.  Returns the launch counts
    and shapes by route."""
    from repro_torch.fed import LatencyModel
    finite = {"latency": LatencyModel(), "deadline": BUFFERED_DEADLINE}
    out = {}
    for ingest in (False, True):
        route = "ingest" if ingest else "dense"
        gpu = make_trainer("cuda", torch, ingest=ingest, buffered=finite)
        require(gpu.ingest == ingest, f"buffered {route}: not on its route")
        rk.LAUNCHES.reset()
        t0 = time.perf_counter()
        h_gpu = gpu.run(BUFFERED_ROUNDS, eval_every=BUFFERED_ROUNDS)[-1]
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        launches = dict(rk.LAUNCHES.counts)
        shapes = dict(rk.LAUNCHES.shapes)
        log = gpu.arrival_log
        require(bool(torch.isfinite(gpu.params_vec).all()),
                f"buffered {route}: non-finite params")
        require(any(row["staleness_max"] > 0 for row in log)
                and any(row["arrived"] < row["dispatched"] for row in log),
                f"buffered {route}: no straggler in {BUFFERED_ROUNDS} rounds")
        cpu = make_trainer("cpu", torch, ingest=ingest, buffered=finite)
        t0 = time.perf_counter()
        h_cpu = cpu.run(BUFFERED_ROUNDS, eval_every=BUFFERED_ROUNDS)[-1]
        cpu_s = time.perf_counter() - t0
        require(rk.LAUNCHES.counts == launches,
                f"buffered {route}: the CPU run launched a CUDA kernel")
        require(cpu.arrival_log == log,
                f"buffered {route}: arrival logs differ card vs CPU")
        d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
        d_up = abs(h_gpu["bits_up"] / h_cpu["bits_up"] - 1.0)
        print(f"buffered {route}: cnn, STC, {BUFFERED_ROUNDS} rounds, "
              f"deadline {BUFFERED_DEADLINE} | card acc={h_gpu['acc']:.4f} "
              f"bits_up={h_gpu['bits_up']:.0f} ({gpu_s:.1f} s) | cpu "
              f"acc={h_cpu['acc']:.4f} bits_up={h_cpu['bits_up']:.0f} "
              f"({cpu_s:.1f} s) | |d acc|={d_acc:.4f} "
              f"|d bits_up|={d_up:.4%} | arrivals "
              f"{json.dumps([[r['arrived'], r['aggregated'], r['staleness_max']] for r in log])}"
              f" | launches {json.dumps({k: v for k, v in launches.items() if v})}"
              f" shapes {json.dumps({k: list(v) for k, v in shapes.items()})}")
        require(d_acc <= 0.03, f"buffered {route}: accuracy differs by "
                               f"{d_acc:.4f} > 0.03")
        require(d_up <= 0.02, f"buffered {route}: bits_up differs by "
                              f"{d_up:.4%} > 2%")
        # the clients' STC every round, the server's each round that
        # aggregated; one decode an ingested arrival
        agg = [row["aggregated"] for row in log]
        stc = BUFFERED_ROUNDS + sum(a > 0 for a in agg)
        want = {"histogram": stc, "bin_select": stc, "stc_apply": stc,
                "golomb_decode": sum(agg) if ingest else 0}
        got = {k: launches[k] for k in want}
        require(got == want, f"buffered {route}: launched {json.dumps(got)}"
                             f", not {json.dumps(want)}")
        require(launches["pack_chunks"] > 0 and launches["unpack_bits"] == 0
                and launches["pack_bits"] == 0,
                f"buffered {route}: the wire did not go through pack_chunks "
                f"alone")
        time_buffered_round(torch, gpu, route)
        out[route] = (launches, shapes)
    for ingest in (False, True):
        sync = make_trainer("cuda", torch, ingest=ingest)
        inf = make_trainer("cuda", torch, ingest=ingest,
                           buffered={"latency": LatencyModel()})
        sync.run(3, eval_every=3)
        inf.run(3, eval_every=3)
        torch.cuda.synchronize()
        require(torch.equal(sync.params_vec, inf.params_vec)
                and all(getattr(sync, c) == getattr(inf, c)
                        for c in LEDGER_COLS)
                and sync.wire_log == inf.wire_log,
                f"deadline=inf differs from the synchronous trainer on the "
                f"card ({'ingest' if ingest else 'dense'} route)")
    print("buffered deadline=inf: parameters, ledger and wire log bitwise "
          "the synchronous trainer's on the card, 3 rounds, dense and "
          "ingest routes")
    print(f"card: {card_line()}")
    return out


def time_buffered_round(torch, tr, route, reps=5):
    """Whole buffered rounds on the card, host clock after ``synchronize``,
    median of ``reps``."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_round()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"buffered {route} round (median of {reps}, ms, host clock after "
          f"synchronize): {statistics.median(times):.3f} "
          f"(all: {json.dumps([round(t, 3) for t in times])})")
    return statistics.median(times)


# ---------------------------------------------------------------- phase 9

CHUNK = 4096              # the cnn at 4096: 79 chunks in 6 width groups
# card against CPU compares accuracies only once the cnn has converged:
# at 10 and 20 rounds (accuracy 0.4-0.9) local SGD's ulp drift, and the
# card's own run-to-run variation, moved the two apart by 0.05-0.21
# (``--drift-witness`` shows one ulp on one device doing the same)
CHUNKED_ROUNDS = 40
WITNESS_ROUNDS = 20
CHUNKED_CONTROLLERS = (("residual_mass", {"budget": 1.0}),
                       ("snr_constant", {"snr": 3.0, "ema": 0.5}))
STC_KERNELS = ("histogram", "bin_select", "stc_apply")
BANNED_OPS = {"aten::topk", "aten::sort", "aten::kthvalue"}


class launch_log:
    """Every launch the wrappers record, as ``(name, shape)``, while the
    context is open (the counters count on as always)."""

    def __init__(self, rk):
        self.rk, self.log = rk, []

    def __enter__(self):
        real = type(self.rk.LAUNCHES).record
        counter = self.rk.LAUNCHES

        def record(name, shape):
            self.log.append((name, tuple(shape)))
            real(counter, name, shape)
        counter.record = record
        return self.log

    def __exit__(self, *exc):
        del self.rk.LAUNCHES.record


def chunked_shapes(tr):
    """The chunked STC selections' shapes: the clients' ``(P * C, W)`` and
    the server's ``(C, W)``."""
    spec, p = tr.protocol.spec, tr.env.participants_per_round
    return (p * spec.n_chunks, spec.chunk_numel), (spec.n_chunks,
                                                   spec.chunk_numel)


def require_stc_launches(log, tr, rounds, what):
    """Exactly one histogram, ``bin_select`` and ``stc_apply`` launch a
    round at each of the chunked selections' shapes, and none other."""
    up, down = chunked_shapes(tr)
    for name in STC_KERNELS:
        got = {}
        for n, shape in log:
            if n == name:
                got[shape] = got.get(shape, 0) + 1
        require(got == {up: rounds, down: rounds},
                f"{what}: {name} launched {got} in {rounds} rounds, not "
                f"once a round at {up} and at {down}")


def check_whole_vector(torch):
    """``chunks="whole"`` against the flat trainer on the card, 5 dense
    rounds: parameters, the four ledger columns and the wire log bitwise."""
    flat = make_trainer("cuda", torch)
    whole = make_trainer("cuda", torch, chunks="whole")
    require(whole.protocol.spec.is_whole_vector(),
            "chunks='whole' is not one whole-vector chunk")
    flat.run(5, eval_every=5)
    whole.run(5, eval_every=5)
    torch.cuda.synchronize()
    require(torch.equal(flat.params_vec, whole.params_vec)
            and all(getattr(flat, c) == getattr(whole, c)
                    for c in LEDGER_COLS)
            and flat.wire_log == whole.wire_log,
            "chunks='whole' differs from the flat trainer on the card")
    print("chunked whole vector: parameters, ledger and wire log bitwise the "
          "flat trainer's on the card, 5 rounds")


def count_nnz_up(np, tr):
    """Total the upstream messages' non-zeros of every round ``tr`` runs
    from now on; returns a one-element list that holds the total."""
    total, book = [0], tr._downstream_bits

    def counting(global_delta, up=None, nnz_up=None):
        if nnz_up is not None:
            total[0] += int(np.sum(np.asarray(nnz_up, np.int64)))
        return book(global_delta, up, nnz_up)
    tr._downstream_bits = counting
    return total


def chunked_kw(controller=None):
    """``TrainerConfig`` fields of phase 9's runs: ``chunks=4096`` and a new
    controller instance where one is named."""
    kw = {"chunks": CHUNK}
    if controller:
        from repro_torch.core import make_controller
        kw["controller"] = make_controller(controller[0], **controller[1])
    return kw


def run_chunked_trainers(torch, np, rk, ingest=False, controller=None,
                         rounds=CHUNKED_ROUNDS, lockstep=None):
    """The cnn at ``chunks=4096`` on the card (counters set to 0 just
    before) and on the CPU: accuracy within 0.03, ``bits_up`` within 2 %,
    the analytic columns equal, and with a fixed k a chunk the upstream
    non-zeros of the whole run within rtol 1e-4 (a wrong selection moves
    them by a count a row a round; only ties at a threshold may); one
    histogram, ``bin_select`` and ``stc_apply`` launch a round at each
    selection's shape, two ``pack_chunks`` a width group a round; on the
    ingest route one ``golomb_decode`` a width group a round.
    ``lockstep(tr)`` runs on the card's trained trainer before the CPU
    run.  Returns the card's trainer, its launches, what ``lockstep``
    returned and both runs' accuracies at each evaluation."""
    route = controller[0] if controller else ("ingest" if ingest else "dense")
    gpu = make_trainer("cuda", torch, ingest=ingest, **chunked_kw(controller))
    spec, groups = gpu.protocol.spec, gpu.protocol._groups()
    require(gpu.ingest == ingest and spec.n_chunks == 79 and len(groups) == 6,
            f"chunked {route}: {spec.n_chunks} chunks in {len(groups)} groups")
    evals = max(rounds // 4, 1)
    nnz_gpu = count_nnz_up(np, gpu)
    rk.LAUNCHES.reset()
    t0 = time.perf_counter()
    with launch_log(rk) as log:
        h_gpu = gpu.run(rounds, eval_every=evals)
        torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches, nnz_gpu = dict(rk.LAUNCHES.counts), nnz_gpu[0]
    require(bool(torch.isfinite(gpu.params_vec).all()),
            f"chunked {route}: non-finite params")
    require_stc_launches(log, gpu, rounds, f"chunked {route}")
    require(launches["pack_chunks"] == 2 * len(groups) * rounds
            and launches["pack_bits"] == 0 and launches["unpack_bits"] == 0,
            f"chunked {route}: the wire packed {launches['pack_chunks']} times "
            f"with pack_chunks in {rounds} rounds, not twice a width group a "
            f"round (up and down), {launches['pack_bits']} with pack_bits")
    if ingest:
        require(launches["golomb_decode"] == len(groups) * rounds,
                f"chunked ingest decoded {launches['golomb_decode']} times in "
                f"{rounds} rounds, not once a width group a round")
    params = gpu.params_vec.clone()
    checked = lockstep(gpu) if lockstep is not None else None
    before = dict(rk.LAUNCHES.counts)
    cpu = make_trainer("cpu", torch, ingest=ingest, **chunked_kw(controller))
    nnz_cpu = count_nnz_up(np, cpu)
    t0 = time.perf_counter()
    h_cpu = cpu.run(rounds, eval_every=evals)
    cpu_s = time.perf_counter() - t0
    require(rk.LAUNCHES.counts == before,
            f"chunked {route}: the CPU run launched a CUDA kernel")
    accs = [[round(h["acc"], 4) for h in hist] for hist in (h_gpu, h_cpu)]
    h_gpu, h_cpu = h_gpu[-1], h_cpu[-1]
    d_acc = abs(h_gpu["acc"] - h_cpu["acc"])
    d_up = abs(h_gpu["bits_up"] / h_cpu["bits_up"] - 1.0)
    d_nnz = abs(nnz_gpu / nnz_cpu[0] - 1.0)
    d_params = float((params.cpu() - cpu.params_vec).norm()
                     / cpu.params_vec.norm())
    print(f"chunked {route}: cnn, chunks={CHUNK} ({spec.n_chunks} chunks, "
          f"widths {[g[0] for g in groups]}), {rounds} rounds | card "
          f"acc={h_gpu['acc']:.4f} bits_up={h_gpu['bits_up']:.0f} "
          f"bits_down={h_gpu['bits_down']:.0f} ({gpu_s:.1f} s) | cpu "
          f"acc={h_cpu['acc']:.4f} bits_up={h_cpu['bits_up']:.0f} "
          f"({cpu_s:.1f} s) | |d acc|={d_acc:.4f} |d bits_up|={d_up:.4%} "
          f"nnz_up card {nnz_gpu} cpu {nnz_cpu[0]} (|d|={d_nnz:.3e}) "
          f"|d params|/|params|={d_params:.3e} | acc every {evals} rounds "
          f"card {accs[0]} cpu {accs[1]} | launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")
    require(d_acc <= 0.03, f"chunked {route}: accuracy differs by {d_acc:.4f}")
    require(d_up <= 0.02, f"chunked {route}: bits_up differs by {d_up:.4%}")
    if controller is None:
        require(d_nnz <= 1e-4,
                f"chunked {route}: the upstream non-zeros differ by "
                f"{d_nnz:.3e} ({nnz_gpu} on the card, {nnz_cpu[0]} on the "
                f"CPU)")
    for col in ("bits_up_analytic", "bits_down_analytic"):
        require(h_gpu[col] == h_cpu[col],
                f"chunked {route}: {col} {h_gpu[col]} on the card, "
                f"{h_cpu[col]} on the CPU")
    return gpu, launches, checked, accs


def perturbed(torch, tr, how):
    """Move ``tr``'s parameters by one ulp: ``"one"`` the first up, ``"all"``
    every non-zero one up or down by a sign drawn from a seeded generator."""
    v = tr.params_vec.clone()
    inf = torch.full_like(v, math.inf)
    if how == "one":
        require(float(v[0]) != 0.0, "the first parameter is zero")
        v[0] = torch.nextafter(v[0], inf[0])
    else:
        up = torch.rand(v.shape, generator=torch.Generator().manual_seed(7))
        away = torch.where(up.to(v.device) < 0.5, inf, -inf)
        v = torch.where(v != 0, torch.nextafter(v, away), v)
    tr.params_vec = v


WITNESS_RUNS = (("card", "cuda", None, None),
                ("card again", "cuda", None, None),
                ("card +1 ulp", "cuda", "one", None),
                ("card +-1 ulp all", "cuda", "all", None),
                ("cpu", "cpu", None, None),
                ("cpu +1 ulp", "cpu", "one", None),
                ("cpu +-1 ulp all", "cpu", "all", None),
                ("cpu 1 thread", "cpu", None, 1))


def drift_witness(torch, np, rk, rounds=WITNESS_ROUNDS):
    """How far runs part at the depths where phase 9 does not compare
    accuracies: the dense and ``residual_mass`` runs of phase 9, ``rounds``
    rounds, accuracy every 5, on the card twice, on the card and on the CPU
    with the first parameter moved up by one ulp and with every parameter
    moved by one ulp, on the CPU, and on the CPU with one thread (another
    reduction order in local SGD).  Prints the accuracies and each run's
    largest gap from the unperturbed run on its device and from the CPU's;
    checks only that every run stays finite."""
    t0 = time.perf_counter()
    out, threads = {}, torch.get_num_threads()
    for controller in (None, CHUNKED_CONTROLLERS[0]):
        route = controller[0] if controller else "dense"
        accs = {}
        for name, device, how, n_threads in WITNESS_RUNS:
            tr = make_trainer(device, torch, **chunked_kw(controller))
            if how:
                perturbed(torch, tr, how)
            torch.set_num_threads(n_threads or threads)
            try:
                hist = tr.run(rounds, eval_every=5)
            finally:
                torch.set_num_threads(threads)
            require(bool(torch.isfinite(tr.params_vec).all()),
                    f"drift witness {route} {name}: non-finite params")
            accs[name] = [round(h["acc"], 4) for h in hist]

        def gap(a, b):
            return round(max(abs(x - y) for x, y in zip(accs[a], accs[b])),
                         4)
        gaps = {"card": {"vs cpu": gap("cpu", "card")}}
        for name, device, *_ in WITNESS_RUNS[1:]:
            if name != "cpu":
                gaps[name] = {"vs cpu": gap("cpu", name)}
                if device == "cuda":
                    gaps[name]["vs card"] = gap("card", name)
        print(f"drift witness, chunked {route}: cnn, chunks={CHUNK}, "
              f"{rounds} rounds, accuracy every 5 rounds "
              f"{json.dumps(accs)} | largest gap "
              f"{json.dumps(gaps)}")
        out[route] = gaps
    print(f"drift witness took {time.perf_counter() - t0:.1f} s "
          f"({threads} CPU threads)")
    print(f"card: {card_line()}")
    return out


def profile_round(torch, tr, what):
    """One whole round under ``torch.profiler``: no ``topk``/``sort`` op,
    and (where the profiler sees the card) one histogram, one ``bin_select``
    final pass and one ``stc_apply`` kernel a selection, two selections."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.run_round()
        torch.cuda.synchronize()
    ops = {e.name for e in prof.events() if e.device_type != DeviceType.CUDA}
    require(not (BANNED_OPS & ops),
            f"{what}: a round called {sorted(BANNED_OPS & ops)}")
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    seen = {k: sum(k in n for n in kernels)
            for k in ("magnitude_histogram_kernel", "final_pass_kernel",
                      "stc_apply_kernel")}
    if kernels:
        require(all(v == 2 for v in seen.values()),
                f"{what}: the profiler saw {seen} in one round, not two each")
    print(f"{what} round under torch.profiler: no topk/sort op; device "
          f"kernels {json.dumps(seen) if kernels else 'not seen'}")


def check_chunked_lockstep(torch, np, rk, tr, rounds=3):
    """The chunked STC's encode, apply, ledger and ingest on the card
    against the CPU's on the same inputs, round by round from the trained
    state: thresholds and counts of both selections exact, masks and signs
    exact, µ within rtol 1e-6, residuals and parameters within 1e-6 of
    ``|value| + µ``, wire words identical to the host packer's and the
    ingest accumulator bitwise the CPU decode's and the host backend's.
    The server's CPU side runs on the card's combined mean.  Returns the
    last round's carried matrices and upstream batch."""
    from repro_torch.core.chunking import chunk_codec
    from repro_torch.core.compression import get_stc_backend
    from repro_torch.core.residual import (ResidualState, map_states,
                                           take_states)
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    spec, W = proto.spec, proto.spec.chunk_numel
    host = chunk_codec(dataclasses.replace(proto.base, wire_backend="numpy"),
                       spec)
    be = get_stc_backend("kernel")
    ks_up = np.tile(spec.chunk_ks(proto._chunk_ps("up")), p)
    ks_down = spec.chunk_ks(proto._chunk_ps("down"))
    ones = torch.ones(p, device=tr.device)
    zeros = torch.zeros(p, device=tr.device)
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))
    params = tr.params_vec.clone()
    cstate = map_states(torch.clone, tr.client_state)
    sstate = map_states(torch.clone, tr.server_state)
    cpu = lambda st: map_states(lambda x: x.cpu(), st)   # noqa: E731
    worst = {"mu_rtol": 0.0, "sum_rtol": 0.0, "residual_abs": 0.0}

    def same_selection(what, x, ks):
        got = be.select_batch(x, ks)
        want = be.select_batch(x.cpu(), ks)
        require(torch.equal(got[0].cpu(), want[0])
                and torch.equal(got[1].cpu(), want[1]),
                f"chunked lock-step round {r}: {what} thresholds or counts "
                f"differ card vs CPU")
        rel = float(((got[2].cpu() - want[2]).abs()
                     / want[2].abs().clamp(min=1e-30)).max())
        require(rel <= 1e-6, f"chunked lock-step round {r}: {what} sums off "
                             f"by rtol {rel:.3e}")
        worst["sum_rtol"] = max(worst["sum_rtol"], rel)

    def same_message(what, got, want):
        require(torch.equal(torch.sign(got.cpu()), torch.sign(want)),
                f"chunked lock-step round {r}: {what} masks or signs differ")
        mu = spec.split(got.cpu()).abs().amax(dim=-1)
        mu_c = spec.split(want).abs().amax(dim=-1)
        rel = float(((mu - mu_c).abs() / mu_c.clamp(min=1e-30)).max())
        require(rel <= 1e-6, f"chunked lock-step round {r}: {what} µ off by "
                             f"rtol {rel:.3e}")
        worst["mu_rtol"] = max(worst["mu_rtol"], rel)
        return mu_c

    def close(what, got, want, mu):
        gap = (got.cpu() - want).abs()
        tol = 1e-6 * (want.abs() + mu[..., None])
        require(bool((gap <= tol).all()), f"chunked lock-step round {r}: "
                f"{what} beyond 1e-6 of |value| + µ")
        worst["residual_abs"] = max(worst["residual_abs"],
                                    float(gap.max()))

    decodes = rk.LAUNCHES.counts["golomb_decode"]
    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        cs = take_states(cstate, idx)
        carried = (spec.split(deltas) + cs.residual).reshape(-1, W)
        same_selection("encode", carried, ks_up)
        msgs, cs_new, _ = proto.encode_batch(deltas, cs)
        msgs_c, cs_c, _ = proto.encode_batch(deltas.cpu(), cpu(cs))
        mu_c = same_message("client messages", msgs, msgs_c)
        close("client residuals", cs_new.residual, cs_c.residual, mu_c)

        # the card's combined mean, as the codec forms it (over the blocks)
        mean = spec.merge(proto.combine(spec.split(msgs), ones, zeros))
        server_carried = spec.split(mean) + sstate.residual
        same_selection("server", server_carried, ks_down)
        gd, ss_new, _ = proto.aggregate(msgs, sstate, mask=ones,
                                        staleness=zeros)
        # one row: the CPU's combine of the card's mean is that mean
        gd_c, ss_c, _ = proto.aggregate(mean.cpu()[None], cpu(sstate))
        mu_s = same_message("server message", gd[None], gd_c[None])
        close("server residual", ss_new.residual, ss_c.residual, mu_s[0])

        batch = proto.encode_wire_batch(msgs, direction="up")
        batch_h = host.encode_wire_batch(msgs.cpu().numpy(), direction="up")
        down = proto.encode_wire(gd, direction="down").batch
        down_h = host.encode_wire(gd.cpu().numpy(), direction="down").batch
        for got, want in ((batch, batch_h), (down, down_h)):
            require(all(np.array_equal(g.words, h.words)
                        and np.array_equal(g.bit_len, h.bit_len)
                        for g, h in zip(got.batches, want.batches)),
                    f"chunked lock-step round {r}: wire words differ from "
                    f"the host packer's")
        accs = []
        for codec, b, dev in ((proto, batch, tr.device), (proto, batch, "cpu"),
                              (host, batch_h, "cpu")):
            acc = codec.make_ingest(tr.numel)
            codec.ingest_wire_batch(acc, b, w, direction="up", device=dev)
            accs.append(acc)
        require(all(a.sum.tobytes() == accs[0].sum.tobytes()
                    and a.weight_mass == accs[0].weight_mass
                    and a.stream_bits == accs[0].stream_bits
                    for a in accs[1:]),
                f"chunked lock-step round {r}: ingest accumulators differ")
        cstate.residual[idx] = cs_new.residual
        sstate = ss_new
        params = params + gd
    require(rk.LAUNCHES.counts["golomb_decode"] > decodes,
            "the chunked lock-step ingest did not decode through "
            "golomb_decode")
    print(f"chunked lock-step ({rounds} rounds, card vs CPU from the same "
          f"inputs): thresholds, counts, masks, words and accumulator exact; "
          f"{json.dumps(worst)}")
    return {"carried": carried.contiguous(),
            "server_carried": server_carried.contiguous(),
            "ks_up": ks_up, "ks_down": ks_down, "batch": batch}


def check_chunked_selection(torch, rk, last):
    """On the last chunked lock-step round's matrices, (790, 4096) and (79,
    4096): ``bin_select`` against its plain version, then
    ``stc_compress_blocks`` with the fixed per-row ks and with ks as a
    device tensor under ``set_sync_debug_mode("error")`` (one histogram, one
    ``bin_select`` and one ``stc_apply`` launch a call; the device ks give
    the fixed ks' result), and the selection under ``torch.profiler``: no
    ``topk`` or ``sort``.  Returns the sums' largest abs difference."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.compression import stc_compress_blocks
    err = 0.0
    for name, ks in (("carried", last["ks_up"]),
                     ("server_carried", last["ks_down"])):
        x = last[name]
        err = max(err, check_bin_select(torch, rk, x, ks))
        kt = torch.as_tensor(ks, dtype=torch.int32).to(x.device)
        want = stc_compress_blocks(x, ks)
        torch.cuda.synchronize()
        before = dict(rk.LAUNCHES.counts)
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = stc_compress_blocks(x, ks)
            dyn = stc_compress_blocks(x, kt, k_cap=int(ks.max()))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(all(rk.LAUNCHES.counts[k] == before[k] + 2
                    for k in STC_KERNELS),
                f"stc_compress_blocks on the {name} matrix did not launch "
                f"each STC kernel once a call")
        require(all(torch.equal(g, w) for g, w in zip(got, want))
                and all(torch.equal(g, w) for g, w in zip(dyn, want)),
                f"stc_compress_blocks on the {name} matrix: fixed and device "
                f"ks differ, or two calls differ")
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            stc_compress_blocks(x, kt, k_cap=int(ks.max()))
            torch.cuda.synchronize()
        banned = BANNED_OPS & {e.name for e in prof.events()}
        require(not banned, f"the chunked selection called {sorted(banned)}")
        print(f"chunked selection on the {name} matrix {tuple(x.shape)}: "
              f"bin_select identical to its plain version; "
              f"stc_compress_blocks with host and device ks identical, one "
              f"launch of each kernel a call, under "
              f"set_sync_debug_mode('error'); no topk/sort")
    return err


def check_adaptive_lockstep(torch, np, rk, tr, rounds=2):
    """A controller's rounds on the card against the CPU from the same
    inputs: per-chunk ks and (SNR) the EMA state of clients and server
    identical, the dynamic selection's thresholds and counts exact, masks
    exact and µ within rtol 1e-6; the clients' adaptive block encode runs
    under ``set_sync_debug_mode("error")`` and launches one histogram, one
    ``bin_select`` and one ``stc_apply``."""
    from repro_torch.core.compression import get_stc_backend
    from repro_torch.core.residual import map_states, take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    spec, W, ctrl = proto.spec, proto.spec.chunk_numel, proto.controller
    be = get_stc_backend("kernel")
    base_up, caps_up = proto._ctrl_geometry("up")
    ones = torch.ones(p, device=tr.device)
    zeros = torch.zeros(p, device=tr.device)
    params = tr.params_vec.clone()
    cstate = map_states(torch.clone, tr.client_state)
    sstate = map_states(torch.clone, tr.server_state)
    cpu = lambda st: map_states(lambda x: x.cpu(), st)   # noqa: E731

    def same(what, got, want):
        require(got is None and want is None
                or got.cpu().numpy().tobytes() == want.numpy().tobytes(),
                f"{ctrl.name} lock-step round {r}: {what} differ card vs CPU")

    for r in range(rounds):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, params,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        cs = take_states(cstate, idx)
        base_st, ctrl_st = proto._split_ctrl(cs)
        blocks = spec.split(deltas)
        carried = blocks + base_st.residual
        ks, st_new = ctrl.chunk_ks(carried, ctrl_st, base_ks=base_up,
                                   caps=caps_up)
        ks_c, st_c = ctrl.chunk_ks(carried.cpu(), cpu(ctrl_st),
                                   base_ks=base_up, caps=caps_up)
        same("client ks", ks, ks_c)
        same("client controller states", st_new, st_c)
        k_cap = int(caps_up.max())
        got = be.select_batch_dynamic(carried.reshape(-1, W), ks.reshape(-1),
                                      k_cap)
        want = be.select_batch_dynamic(carried.reshape(-1, W).cpu(),
                                       ks_c.reshape(-1), k_cap)
        same("dynamic thresholds", got[0], want[0])
        same("dynamic counts", got[1], want[1])
        torch.cuda.synchronize()
        before = dict(rk.LAUNCHES.counts)
        torch.cuda.set_sync_debug_mode("error")
        try:
            proto.base.encode_chunk_blocks_adaptive(
                blocks, base_st, ctrl, ctrl_st, base_ks=base_up, caps=caps_up)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(all(rk.LAUNCHES.counts[k] == before[k] + 1
                    for k in STC_KERNELS),
                f"{ctrl.name}: the adaptive encode did not launch each STC "
                f"kernel once")
        msgs, cs_new, _ = proto.encode_batch(deltas, cs)
        msgs_c, _, _ = proto.encode_batch(deltas.cpu(), cpu(cs))
        require(torch.equal(torch.sign(msgs.cpu()), torch.sign(msgs_c)),
                f"{ctrl.name} lock-step round {r}: masks or signs differ")
        mean = spec.merge(proto.combine(spec.split(msgs), ones, zeros))
        gd, ss_new, _ = proto.aggregate(msgs, sstate, mask=ones,
                                        staleness=zeros)
        gd_c, ss_c, _ = proto.aggregate(mean.cpu()[None], cpu(sstate))
        require(torch.equal(torch.sign(gd.cpu()), torch.sign(gd_c)),
                f"{ctrl.name} lock-step round {r}: server masks differ")
        if ctrl.stateful:
            same("server controller states", ss_new["ctrl"], ss_c["ctrl"])
        map_states(lambda full, new: full.index_copy_(0, idx, new), cstate,
                   cs_new)
        sstate = ss_new
        params = params + gd
    print(f"{ctrl.name} lock-step ({rounds} rounds, card vs CPU from the same "
          f"inputs): per-chunk ks{', EMA states' if ctrl.stateful else ''}, "
          f"dynamic thresholds, counts and masks identical; the adaptive "
          f"encode ran under set_sync_debug_mode('error'), one launch of "
          f"each STC kernel")


def time_chunked_round(torch, np, tr, reps=5):
    """One chunked round (with the trainer's controller, if it has one)
    split into its phases, state left untouched, median of ``reps``, host
    clock after ``synchronize``: ``local_sgd``, ``encode``, ``apply`` and
    ``ledger`` (the upstream batch and the downstream message); on an
    ingest trainer ``wire_encode``,
    ``decode_scatter`` (the fused ingest), ``finalize`` and ``ledger`` (the
    downstream message) in place of ``apply``."""
    from repro_torch.core.residual import take_states
    from repro_torch.fed.loop import local_sgd
    proto, p = tr.protocol, tr.env.participants_per_round
    names = (("local_sgd", "encode", "wire_encode", "decode_scatter",
              "finalize", "ledger") if tr.ingest
             else ("local_sgd", "encode", "apply", "ledger"))
    phases = {name: [] for name in names + ("round",)}
    w = tr._participation_weights_np(np.ones(p), np.zeros(p))

    def sync_now():
        torch.cuda.synchronize()
        return time.perf_counter()

    for _ in range(reps):
        sel = tr.rng.choice(tr.env.n_clients, size=p, replace=False)
        xs, ys = tr._sample_batches(sel, proto.local_iters)
        idx = torch.as_tensor(sel, device=tr.device)
        ts = [sync_now()]
        deltas, _ = local_sgd(tr.apply_fn, tr.spec, tr.params_vec,
                              tr.client_mom[idx], xs, ys, tr.tcfg.lr,
                              tr.tcfg.momentum)
        ts.append(sync_now())
        msgs, _, _ = proto.encode_batch(deltas,
                                        take_states(tr.client_state, idx))
        ts.append(sync_now())
        if tr.ingest:
            batch = proto.encode_wire_batch(msgs, direction="up")
            ts.append(sync_now())
            acc = proto.make_ingest(tr.numel)
            proto.ingest_wire_batch(acc, batch, w, direction="up",
                                    device=tr.device)
            ts.append(sync_now())
            gd, _, _ = proto.aggregate_ingest(acc, tr.server_state)
            ts.append(sync_now())
            proto.encode_wire(gd, direction="down")
        else:
            _, _, gd = tr._apply_fn(tr.params_vec, tr.server_state, msgs,
                                    torch.ones(p, device=tr.device),
                                    torch.zeros(p, device=tr.device))
            ts.append(sync_now())
            proto.encode_wire_batch(msgs, direction="up")
            proto.encode_wire(gd, direction="down")
        ts.append(sync_now())
        for name, t0, t1 in zip(names, ts, ts[1:]):
            phases[name].append((t1 - t0) * 1e3)
    for _ in range(reps):
        t0 = sync_now()
        tr.run_round()
        phases["round"].append((sync_now() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in phases.items()}
    ctrl = proto.controller.name if proto.controller else None
    print(f"chunked {ctrl or ('ingest' if tr.ingest else 'dense')} round "
          f"phases (median of {reps}, ms, host clock after synchronize): "
          + json.dumps({k: round(v, 3) for k, v in med.items()}))
    return med


def time_chunked_kernels(torch, np, rk, last):
    """Device time of the STC kernels at the chunked selections' shapes
    (the last lock-step round's matrices) beside their plain versions,
    their byte bounds and the library call; ``golomb_decode`` on the
    largest width group's upstream sub-streams.  Returns, by kernel, the
    keys to add to its row of the ``kernels`` line."""
    from repro_torch.core.compression import get_stc_backend
    from repro_torch.core.selection import bin_index

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    out = {"histogram": {}, "bin_select": {}, "stc_apply": {}}
    for name, ks in (("carried", last["ks_up"]),
                     ("server_carried", last["ks_down"])):
        x = last[name]
        rows, n = x.shape
        tag = f"_{rows}x{n}"
        scale, b, r, _ = select_inputs(torch, x, ks)
        t, c, s = get_stc_backend("kernel").select_batch(x, ks)
        mu = s / torch.clamp(c, min=1).to(torch.float32)
        a = x.abs()
        k_max = int(ks.max())
        flat_bins = (bin_index(a, scale[:, None], 256).to(torch.int64)
                     + 256 * torch.arange(rows, device=x.device)[:, None]
                     ).reshape(-1)
        rows_out = {
            "histogram": (lambda: rk.magnitude_histogram_batched(x, scale),
                          lambda: rk.magnitude_histogram_plain(x, scale),
                          4 * rows * n + 4 * rows + 8 * 256 * rows,
                          lambda: (torch.bincount(flat_bins,
                                                  minlength=256 * rows),
                                   torch.bincount(flat_bins,
                                                  weights=a.reshape(-1),
                                                  minlength=256 * rows))),
            "bin_select": (lambda: rk.candidate_select_batched(x, scale, b,
                                                               r),
                           lambda: rk.candidate_select_plain(x, scale, b, r),
                           4 * rows * n + 20 * rows + 12 * rows,
                           lambda: torch.topk(a, k_max, dim=1)),
            "stc_apply": (lambda: rk.stc_apply_batched(x, t, mu),
                          lambda: rk.stc_apply_plain(x, t, mu),
                          3 * 4 * rows * n + 8 * rows, None)}
        for kname, (kernel, plain, nbytes, lib) in rows_out.items():
            out[kname].update({
                "ms" + tag: event_ms(torch, kernel),
                "plain_ms" + tag: event_ms(torch, plain, iters=10,
                                           hold_stream=False),
                "bound_ms" + tag: bound(nbytes),
                "library_ms" + tag: (event_ms(torch, lib) if lib is not None
                                     else None)})
        sel = {"host": event_ms(torch, lambda: rk.hist_topk_threshold_batched(
                   x, ks), iters=20, hold_stream=False),
               "device": event_ms(torch, lambda: rk.hist_topk_threshold_batched(
                   x, ks), iters=20)}
        out["bin_select"]["selection_ms" + tag] = sel
    batch = last["batch"]
    big = max(batch.batches, key=lambda wb: wb.words.size)
    row = golomb_row(torch, np, rk, {"golomb_decode": 0},
                     {"golomb_decode": 0.0}, big, P_STC,
                     lambda nbytes: nbytes / HBM_BYTES_PER_S * 1e3)
    out["golomb_decode"] = {
        "ms_chunked_group": row["ms"],
        "bound_ms_chunked_group": row["bound_ms"],
        "plain_ms_chunked_group": row["plain_ms"],
        "words_chunked_group": row["words"],
        "segments_chunked_group": row["segments"]}
    print(f"chunked kernel times (ms, device): {json.dumps(out)}")
    return out


def run_chunked(torch, np, rk):
    """Phase 9: the chunked ``(layer, chunk)`` STC codec and the adaptive
    controllers on the cnn at full width.  Returns ``(launches by path,
    keys by kernel for the kernels line, max errors)``."""
    t0 = time.perf_counter()
    check_whole_vector(torch)
    paths, errs = {}, {"bin_select": 0.0}
    tr_d, paths["chunked_dense"], last, _ = run_chunked_trainers(
        torch, np, rk, lockstep=lambda tr: (
            profile_round(torch, tr, "chunked dense"),
            check_chunked_lockstep(torch, np, rk, tr))[1])
    errs["bin_select"] = check_chunked_selection(torch, rk, last)
    tr_i, paths["chunked_ingest"], _, _ = run_chunked_trainers(
        torch, np, rk, ingest=True,
        lockstep=lambda tr: profile_round(torch, tr, "chunked ingest"))
    adaptive = []
    for controller in CHUNKED_CONTROLLERS:
        tr_a, paths[controller[0]], _, _ = run_chunked_trainers(
            torch, np, rk, controller=controller,
            lockstep=lambda tr: check_adaptive_lockstep(torch, np, rk, tr))
        adaptive.append(tr_a)
    for tr in (tr_d, tr_i, *adaptive):
        time_chunked_round(torch, np, tr)
    extra = time_chunked_kernels(torch, np, rk, last)
    print(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    print(f"card: {card_line()}")
    return paths, extra, errs


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
    alone = {"--signsgd-round": lambda: signsgd_round_only(torch, np),
             "--paper-codecs": lambda: run_paper_codecs(torch, np, rk),
             "--buffered": lambda: run_buffered(torch, np, rk),
             "--chunked": lambda: run_chunked(torch, np, rk),
             "--drift-witness": lambda: drift_witness(torch, np, rk)}
    if len(sys.argv) == 2 and sys.argv[1] in alone:
        try:
            alone[sys.argv[1]]()
            return 0
        except (Failure, RuntimeError, subprocess.SubprocessError) as exc:
            print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
            return 1
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}; options: "
              f"{', '.join(alone)}", file=sys.stderr)
        return 2
    try:
        t0 = time.perf_counter()
        rk.build_all()
        print(f"build: {time.perf_counter() - t0:.1f} s "
              f"(nvcc, one process per source)")
        print_build_notes()
        errs = check_kernels(torch, np, rk)
        print(f"kernel checks passed: {json.dumps(errs)}")
        tr, launches, shapes = run_trainers(torch, rk)
        last = check_lockstep(torch, np, rk, tr)
        chunks = upstream_chunks(np, last)
        errs["pack_chunks"] = max(errs["pack_chunks"], check_pack_chunks(
            torch, np, rk, *chunks))
        print(f"pack_chunks on a lock-step round's upstream batch "
              f"({len(chunks[0])} chunks, {chunks[3] // 32} words): words "
              f"identical to its plain version and the host packer")
        errs["bin_select"] = max(errs["bin_select"],
                                 check_carried_selection(torch, rk, last))
        tr_in, launches_in, shapes_in = run_trainers(torch, rk, ingest=True)
        _, batch_in = check_ingest_lockstep(torch, np, rk, tr_in)
        errs["golomb_decode"] = max(errs["golomb_decode"],
                                    check_golomb_at_path(
                                        torch, np, rk, tr_in.protocol,
                                        batch_in))
        launches_sg, shapes_sg, signsgd = check_signsgd_ingest(torch, np,
                                                              rk)
        msgs_sg = signsgd["msgs"].cpu().numpy()
        errs["pack_sign_planes"] = max(
            errs["pack_sign_planes"],
            check_pack_sign_planes(torch, np, rk, msgs_sg))
        words_sg = signsgd["batch"].words.reshape(msgs_sg.shape[0], -1)
        errs["sign_plane_tally"] = max(
            errs["sign_plane_tally"], check_sign_plane_tally(
                torch, np, rk, np.random.default_rng(4), words_sg,
                signsgd["weights"]))
        print(f"pack_sign_planes at the signSGD path's "
              f"{shapes_sg['pack_sign_planes']} and sign_plane_tally at its "
              f"{shapes_sg['sign_plane_tally']}, on a lock-step round's "
              f"messages and words: identical to their plain versions and "
              f"the host packer and accumulator")
        launches_bis, shapes_bis = run_bisection(torch, np, rk)
        launches = {**launches,
                    "golomb_decode": launches_in["golomb_decode"],
                    "unpack_bits": launches_sg["unpack_bits"],
                    "pack_bits": launches_sg["pack_bits"],
                    "pack_sign_planes": launches_sg["pack_sign_planes"],
                    "sign_plane_tally": launches_sg["sign_plane_tally"],
                    "threshold_stats": launches_bis["threshold_stats"],
                    "bisect_select": launches_bis["bisect_select"]}
        shapes = {**shapes,
                  "pack_sign_planes": shapes_sg["pack_sign_planes"],
                  "sign_plane_tally": shapes_sg["sign_plane_tally"],
                  "bisect_select": shapes_bis["bisect_select"]}
        rows = time_kernels(torch, np, rk, shapes, launches, errs, last,
                            batch_in, signsgd)
        time_round(torch, np, tr)
        time_ingest_round(torch, np, tr_in)
        time_decode_split(torch, np, rk, tr_in.protocol, batch_in)
        time_signsgd_round(torch, np, signsgd["trainer"])
        codecs = run_paper_codecs(torch, np, rk)
        buffered = run_buffered(torch, np, rk)
        chunked, chunked_ms, chunked_errs = run_chunked(torch, np, rk)
        # launches on the paths of phases 7, 8 and 9, beside each kernel's
        # main-path count; the kernels' times at the chunked shapes
        for row in rows:
            name = {"magnitude_histogram": "histogram"}.get(row["name"],
                                                            row["name"])
            row["launches_other_paths"] = {
                path: runs[path][0][name]
                for runs in (codecs, buffered) for path in runs
                if runs[path][0].get(name)}
            row["launches_other_paths"].update({
                path: counts[name] for path, counts in chunked.items()
                if counts.get(name)})
            row.update(chunked_ms.get(name, {}))
            if name in chunked_errs:
                row["max_abs_err"] = max(row["max_abs_err"],
                                         chunked_errs[name])
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
