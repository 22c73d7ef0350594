"""End-to-end driver: federated STC training of a transformer LM on the
mesh trainer (PyTorch port), the clients as ``torch.distributed`` ranks.

    PYTHONPATH=src python examples/train_federated_lm_torch.py \\
        [--arch smollm-135m] [--steps 200] [--protocol stc] [--full] \\
        [--ranks 2] [--device cpu]

The twin of ``examples/train_federated_lm.py`` on ``repro_torch``.  The
default trains a reduced variant of the chosen architecture (its smoke
config with a few more layers) for a few hundred steps on synthetic token
data; ``--full`` uses the full config (SmolLM-135M: 30 layers, d 576).
Every arch of ``repro_torch.configs.ARCH_IDS`` trains: whisper-medium
with zero stub audio frames, internvl2-2b with a zero patch prefix, as
the reference's train CLI feeds them.
Runs on the CUDA card unless ``--device cpu`` is given; the ranks (gloo,
all on that device) are spawned here.  The check that training learns
(the last 20 steps' mean loss below the first 5 steps') runs from 25
steps on.
"""

import argparse
import dataclasses
import socket
import time

import numpy as np
import torch

from repro_torch.configs import (ARCH_IDS, get_config, get_smoke_config,
                                 stand_in_inputs)
from repro_torch.core.protocols import get_protocol_class, registered_protocols
from repro_torch.data import make_lm_tokens
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import (TrainConfig, init_train_state,
                                      make_train_step)


def run(rank, args, port):
    device = resolve_device(args.device)
    if args.ranks > 1:
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=args.ranks, rank=rank)
    mesh = make_debug_mesh(data=args.ranks, model=1)
    if args.full:
        cfg = get_config(args.arch)
    else:
        # reduced variant: same family, a few more layers than the smoke
        # config (keeps head/dim divisibility of the family intact)
        smoke = get_smoke_config(args.arch)
        cfg = dataclasses.replace(smoke, n_layers=min(smoke.n_layers * 2, 6))
    if rank == 0:
        print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
              f"protocol={args.protocol} mesh={mesh.shape} device={device}")

    # demo-scale communication delay: cap the codec's default period at 4
    delay = min(get_protocol_class(args.protocol)().local_iters, 4)
    tc = TrainConfig(protocol=args.protocol, lr=args.lr,
                     sparsity_up=1 / 100, sparsity_down=1 / 100,
                     local_iters=delay)
    state = init_train_state(cfg, tc, n_clients=args.ranks, key=0,
                             device=device)
    step = make_train_step(cfg, mesh, tc, device=device)

    tokens = make_lm_tokens(seed=0, n_tokens=1 << 22, vocab=cfg.vocab_size)
    rng = np.random.default_rng(0)      # every rank draws the same batch

    def sample_batch():
        b, s = args.batch, args.seq
        starts = rng.integers(0, len(tokens) - s - 1, size=b)
        toks = np.stack([tokens[i: i + s] for i in starts])
        labs = np.stack([tokens[i + 1: i + s + 1] for i in starts])
        batch = {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labs)}
        return {**batch, **stand_in_inputs(cfg, b)}

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        state, metrics = step(state, sample_batch())
        losses.append(float(metrics["loss"]))
        if rank == 0 and ((i + 1) % args.eval_every == 0 or i == 0):
            window = np.mean(losses[-args.eval_every:])
            extras = {k: int(v) for k, v in metrics.items() if k != "loss"}
            print(f"step {i+1:4d}  loss {window:.4f}  {extras}  "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)", flush=True)

    if rank == 0:
        print(f"\nfinal loss {np.mean(losses[-20:]):.4f} "
              f"(started {np.mean(losses[:5]):.4f}) in "
              f"{time.time()-t0:.0f}s")
    if args.ranks > 1:
        torch.distributed.destroy_process_group()
    if args.steps >= 25:
        assert np.mean(losses[-20:]) < np.mean(losses[:5]), \
            "training must learn"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--protocol", default="stc",
                    choices=registered_protocols())
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ranks", type=int, default=2,
                    help="client ranks (processes), all on one device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--full", action="store_true",
                    help="use the full config (SmolLM-135M: 30 layers)")
    ap.add_argument("--eval-every", type=int, default=25)
    args = ap.parse_args()
    resolve_device(args.device)          # no card: raise before spawning
    if args.ranks == 1:
        run(0, args, 0)
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(run, args=(args, port), nprocs=args.ranks,
                                join=True)


if __name__ == "__main__":
    main()
