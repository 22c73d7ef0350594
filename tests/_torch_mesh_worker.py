"""Two client ranks on gloo, for the mesh-trainer tests (numpy and the
port only, no JAX):

    python tests/_torch_mesh_worker.py <case> <in.pt> <out.pt>

spawns two ranks on the CPU, runs the jobs of ``in.pt`` on each and writes
every rank's results to ``<out.pt>.<rank>``.  Cases: ``reduce`` (the codec
tree API's collectives and the sharded tree compressors) and ``step``
(``make_train_step`` on ``make_debug_mesh(data=2, model=1)``).
"""

import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2


def _reduce(rank, inp, group):
    from repro_torch.core.distributed import (stc_compress_tree,
                                              ternary_quantize_tree)
    from repro_torch.core.protocols import make_protocol
    msgs = inp["msgs"][rank]
    out = []
    for proto, rule, mask, stal in inp["jobs"]:
        kw = {} if rule is None else {"rule": rule}
        codec = make_protocol(proto, **kw)
        m = None if mask is None else torch.tensor(mask[rank:rank + 1])
        s = None if stal is None else torch.tensor(stal[rank:rank + 1])
        out.append(codec.tree_reduce(msgs, group, WORLD, mask=m,
                                     staleness=s))
    numel = inp["numel"]
    shard = inp["shards"][rank]
    tern, st = stc_compress_tree(shard, inp["p"], manual_axes=group,
                                 numel=numel, backend="torch")
    tq, tq_st = ternary_quantize_tree(shard, 0.75, manual_axes=group,
                                      numel=numel)
    return {"reduce": out, "stc": (tern, tuple(st)), "tq": (tq, tuple(tq_st))}


def _step(rank, inp, group):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step)
    cfg = get_smoke_config(inp["arch"])
    mesh = make_debug_mesh(data=WORLD, model=1)
    out = []
    for kw, mask, stal, overrides in inp["jobs"]:
        tc = TrainConfig(compute_dtype=torch.float32, **kw)
        state = init_train_state(cfg, tc, WORLD, device="cpu",
                                 params=inp["params"])
        for key, tree in overrides.items():
            state[key] = tree
        step = make_train_step(cfg, mesh, tc, device="cpu")
        args = () if mask is None else (torch.tensor(mask),
                                        torch.tensor(stal))
        new_state, metrics = step(state, inp["batch"], *args)
        out.append((new_state, metrics))
    return out


def _rank(rank, case, inp_path, out_path, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        inp = torch.load(inp_path, weights_only=False)
        fn = {"reduce": _reduce, "step": _step}[case]
        torch.save(fn(rank, inp, dist.group.WORLD), f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def main():
    case, inp_path, out_path = sys.argv[1:4]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(case, inp_path, out_path, port), nprocs=WORLD,
             join=True)


if __name__ == "__main__":
    main()
