"""Gloo ranks on the CPU, for the mesh-trainer tests (numpy and the port
only, no JAX):

    python tests/_torch_mesh_worker.py <case> <in.pt> <out.pt> [ranks]

spawns ``ranks`` ranks (default 2), one torch thread each, runs the jobs of
``in.pt`` on each and writes every rank's results to ``<out.pt>.<rank>``.
Cases (``a+b`` runs several in one spawn, ``in.pt``
a dict of their inputs): ``reduce`` (the codec tree API's collectives and the sharded tree
compressors) and ``step`` (``make_train_step`` on ``make_debug_mesh(data=2,
model=1)``); tensor parallelism's ``tp_blocks`` (the split MLP, attention,
vocab-parallel embedding and cross-entropy with their gradients),
``tp_select`` (the split k-selection and the tree STC over a model group),
``tp_ops`` (``gather_from`` and ``scatter_to`` around split products),
``tp_moe`` (the MoE FFN on the rank's blocks of the experts, both
dispatches, with its gradients and expert choices),
``tp_step`` (``make_train_step`` on ``make_debug_mesh(data, model)``,
the state joined back after each job, and on request one step under
``FlopCounterMode`` with what it hands gloo counted, and on request every
MoE layer's expert choices a step) and ``tp_serve``
(``make_prefill_step`` and ``make_decode_step`` on ``make_debug_mesh(1,
model)`` from head-sharded caches, or whole caches where the KV heads do
not split, with what a step hands gloo counted).
The ranks meet through a ``file://`` rendezvous beside ``<out.pt>``.
"""

import os
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


def _tp(rank, group):
    from repro_torch.sharding.tensor_parallel import TensorParallel
    return TensorParallel(group, rank, dist.get_world_size(group))


def _tp_blocks(rank, inp, group):
    """Each block on this rank's parameter blocks: its output and the
    gradients of ``sum(out * cot)`` for its inputs and blocks."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.attention import attn_apply
    from repro_torch.models import params_from_jax
    from repro_torch.models.layers import mlp_apply
    from repro_torch.sharding.tensor_parallel import (
        vocab_parallel_ce, vocab_parallel_embedding)
    cfg = get_smoke_config(inp["arch"])
    tp = _tp(rank, group)
    mesh = make_debug_mesh(1, tp.size)
    params = params_from_jax(inp["params"], mesh=mesh, model_rank=rank)

    def leaf(t):
        return t.detach().clone().requires_grad_(True)

    out = {}
    x = leaf(inp["x"])
    mlp = {k: leaf(v) for k, v in params["blocks"][0]["mlp"].items()}
    y = mlp_apply(mlp, x, cfg.mlp_act, tp)
    (y * inp["cot"]).sum().backward()
    out["mlp"] = (y.detach(), x.grad, {k: v.grad for k, v in mlp.items()})
    x = leaf(inp["x"])
    mix = {k: leaf(v) for k, v in params["blocks"][0]["mix"].items()}
    y = attn_apply(mix, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                   chunk=inp["chunk"], tp=tp)
    (y * inp["cot"]).sum().backward()
    out["attention"] = (y.detach(), x.grad,
                        {k: v.grad for k, v in mix.items()})
    table = leaf(params["embed"])
    y = vocab_parallel_embedding(inp["tokens"], table, tp, torch.float32)
    (y * inp["cot"]).sum().backward()
    out["embedding"] = (y.detach(), None, {"embed": table.grad})
    v_local = inp["logits"].shape[-1] // tp.size
    logits = leaf(inp["logits"][..., rank * v_local:(rank + 1) * v_local])
    y = vocab_parallel_ce(logits, inp["labels"], tp)
    (y * inp["cot_ce"]).sum().backward()
    out["ce"] = (y.detach(), None, {"logits": logits.grad})
    return out


def _tp_select(rank, inp, group):
    """The split selection of each case's parts, and the tree STC of each
    tree case over the model group."""
    from repro_torch.core.distributed import (ModelShards,
                                              stc_compress_tree_with_residual)
    from repro_torch.kernels.hist_select import hist_topk_threshold_split
    rows = [hist_topk_threshold_split(torch.from_numpy(parts[rank])[None],
                                      k, group)
            for parts, k in inp["rows"]]
    trees = []
    for shards, replicated, p, numel in inp["trees"]:
        tern, res, st = stc_compress_tree_with_residual(
            shards[rank], p, numel=numel,
            model=ModelShards(group, rank, tuple(replicated)))
        trees.append((tern, res, tuple(st)))
    return {"rows": rows, "trees": trees}


class _Handed:
    """Counts what the process hands gloo: ``(group, op, dtype)`` ->
    ``[calls, bytes]`` (an all_gather's bytes: what it gathers)."""

    def __init__(self, groups):
        self.groups, self.log = groups, {}
        self.saved = dist.all_reduce, dist.all_gather

    def __enter__(self):
        reduce_, gather = self.saved

        def all_reduce(t, op=dist.ReduceOp.SUM, group=None, **kw):
            self._add(group, "all_reduce", t, t.numel() * t.element_size())
            return reduce_(t, op=op, group=group, **kw)

        def all_gather(parts, t, group=None, **kw):
            self._add(group, "all_gather", t,
                      len(parts) * t.numel() * t.element_size())
            return gather(parts, t, group=group, **kw)

        dist.all_reduce, dist.all_gather = all_reduce, all_gather
        return self

    def _add(self, group, op, t, nbytes):
        name = self.groups.get(id(group), "other")
        rec = self.log.setdefault((name, op, str(t.dtype)), [0, 0])
        rec[0] += 1
        rec[1] += nbytes

    def __exit__(self, *exc):
        dist.all_reduce, dist.all_gather = self.saved


def _tp_ops(rank, inp, group):
    """``gather_from`` and ``scatter_to`` around each case's split product:
    the output and the gradients of ``sum(out * cot)``."""
    from repro_torch.sharding.tensor_parallel import (copy_to, gather_from,
                                                      reduce_from, scatter_to)
    tp = _tp(rank, group)
    out = {}
    for name, (x, w, cot, dim) in inp.items():
        x = x.clone().requires_grad_(True)
        if name == "column":        # Megatron's f, then gather_from
            n = w.shape[1] // tp.size
            blk = w[:, rank * n:(rank + 1) * n].clone().requires_grad_(True)
            y = gather_from(copy_to(x, tp) @ blk, tp, dim)
        elif name == "row":         # scatter_to, then Megatron's g
            n = w.shape[0] // tp.size
            blk = w[rank * n:(rank + 1) * n].clone().requires_grad_(True)
            y = reduce_from(scatter_to(x, tp, dim) @ blk, tp)
        else:                       # the blocks of another dimension
            n = x.shape[dim] // tp.size
            blk = x.detach().narrow(dim, rank * n, n).clone() \
                .requires_grad_(True)
            y = gather_from(blk * w, tp, dim)
        (y * cot).sum().backward()
        out[name] = (y.detach(), None if x.grad is None else x.grad,
                     blk.grad)
    return out


def _tp_moe(rank, inp, group):
    """Each case's MoE block (the last block's ``moe`` of the arch's smoke
    config, ``dispatch`` set) on this rank's blocks: its output, aux loss,
    the gradients of ``sum(out * cot) + aux`` for ``x`` and every leaf, and
    the router's expert choices."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import params_from_jax
    from repro_torch.models.moe import moe_apply, route
    tp = _tp(rank, group)
    mesh = make_debug_mesh(1, tp.size)
    out = {}
    for arch, dispatch in inp["cases"]:
        cfg = get_smoke_config(arch)
        moe_cfg = dataclasses.replace(cfg.moe, dispatch=dispatch)
        blk = params_from_jax(inp["params"][arch], mesh=mesh,
                              model_rank=rank)["blocks"][-1]["moe"]
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _moe_leaves(blk)}
        x = inp["x"][arch].clone().requires_grad_(True)
        y, aux = moe_apply(_moe_tree(leaves), x, moe_cfg, cfg.mlp_act, tp)
        ((y * inp["cot"][arch]).sum() + aux).backward()
        choices = route(blk, x.detach().reshape(-1, cfg.d_model), moe_cfg)[2]
        out[(arch, dispatch)] = (y.detach(), aux.detach(), x.grad,
                                 {k: v.grad for k, v in leaves.items()},
                                 choices)
    return out


def _moe_leaves(blk):
    """A MoE block's leaves as ``(path, tensor)``, a shared expert's under
    ``shared_i/name``."""
    for k, v in blk.items():
        if isinstance(v, dict):
            yield from ((f"{k}/{n}", w) for n, w in v.items())
        else:
            yield k, v


def _moe_tree(leaves):
    tree = {}
    for path, v in leaves.items():
        if "/" in path:
            k, n = path.split("/")
            tree.setdefault(k, {})[n] = v
        else:
            tree[path] = v
    return tree


class RouterCalls:
    """Records every call of :func:`repro_torch.models.moe.route` (a MoE
    layer's, remat's recompute included) while entered: its expert
    choices and router probabilities, on their device (``chip_smoke.py``
    records the card's with it too)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.saved, self.log = moe, moe.route, []

    def __enter__(self):
        def route(*args, **kw):
            res = self.saved(*args, **kw)
            self.log.append((res[2].detach().clone(),
                             res[0].detach().clone()))
            return res

        self.moe.route = route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.saved

    def digests(self):
        """SHA-256 of each call's expert choices."""
        import hashlib
        return [hashlib.sha256(idx.cpu().numpy().tobytes()).hexdigest()
                for idx, _ in self.log]


def _tp_step(rank, inp, group):
    """Each job's steps on ``make_debug_mesh(*inp["mesh"])``: the metrics
    a step, this rank's replicated leaves a step, the state joined back
    over the model group; a job with ``count`` runs one more step under
    ``FlopCounterMode`` and ``_Handed``.  A job may name its own
    ``arch``, ``params``, ``batch`` and ``mesh`` (every rank builds every
    job's groups in the same order)."""
    import dataclasses
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compression import tree_leaves, tree_map
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import (TrainConfig, init_train_state,
                                          make_train_step, unshard_tree)
    from repro_torch.sharding.rules import replicated_leaves
    out = []
    for job in inp["jobs"]:
        mesh = make_debug_mesh(*job.get("mesh", inp["mesh"]))
        cfg = dataclasses.replace(get_smoke_config(job.get("arch",
                                                           inp["arch"])),
                                  **job.get("cfg", {}))
        params, batch = job.get("params", inp["params"]), job.get(
            "batch", inp["batch"])
        tc = TrainConfig(**{"compute_dtype": torch.float32, **job["tc"]})
        state = init_train_state(cfg, tc, mesh.n_clients, device="cpu",
                                 params=params, mesh=mesh)
        step = make_train_step(cfg, mesh, tc, device="cpu")
        flags = replicated_leaves(params, mesh)
        args = () if job.get("mask") is None else (
            torch.tensor(job["mask"]), torch.zeros(len(job["mask"])))
        metrics, replicated, wire, choices = [], [], [], []
        for _ in range(job.get("steps", 1)):
            with RouterCalls() as chosen:
                res = step(state, batch, *args)
            if job.get("choices"):
                choices.append(chosen.log)
            state, m = res[0], res[1]
            if tc.measure_wire:
                wire.append(res[2])
            metrics.append({k: float(v) for k, v in m.items()})
            replicated.append(torch.cat([
                x.reshape(-1) for x, r in zip(
                    tree_leaves(state["params"]), flags) if r]))
        whole = {}
        for key, tree in state.items():
            if key == "step":
                continue
            lead = key in ("client_res", "momentum")
            t = tree_map(lambda x: x[0], tree) if lead else tree
            t = unshard_tree(t, cfg, mesh, mesh.model_group())
            whole[key] = tree_map(lambda x: x[None], t) if lead else t
        counted = None
        if job.get("count"):
            groups = {id(mesh.model_group()): "model",
                      id(mesh.client_group()): "client"}
            with FlopCounterMode(display=False) as flops, \
                    _Handed(groups) as handed:
                step(state, batch, *args)
            counted = (flops.get_total_flops(), handed.log)
        out.append({"metrics": metrics, "replicated": replicated,
                    "state": whole, "wire": wire, "counted": counted,
                    "choices": choices})
    return out


def _tp_serve(rank, inp, group):
    """Each arch's serve steps on ``make_debug_mesh(1, M)``, ``M`` the
    world's ranks, from this rank's blocks of ``params``: the fp32 prefill
    of ``prompt``, and the fp32 decode teacher-forced through ``prompt``
    then ``tail`` from the rank's caches (their shapes and bytes kept;
    whole where the KV heads do not split ``M`` ways), the first step with what
    it hands gloo counted; then one bf16 prefill and one bf16 decode step,
    each counted."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.compression import tree_leaves
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache, params_from_jax
    mesh = make_debug_mesh(1, dist.get_world_size(group))
    m = mesh.shape["model"]
    names = {id(mesh.model_group()): "model"}
    out = {}
    for arch, job in inp.items():
        cfg = get_smoke_config(arch)
        params = params_from_jax(job["params"], mesh=mesh, model_rank=rank)
        toks = torch.cat([job["prompt"], job["tail"]], dim=1)
        b, steps = toks.shape
        rec = {"prefill": make_prefill_step(cfg, mesh, torch.float32,
                                            device="cpu")(
            params, {"tokens": job["prompt"]})}
        decode = make_decode_step(cfg, mesh, torch.float32, device="cpu")
        caches = init_cache(cfg, b, steps, torch.float32, device="cpu",
                            model=m)
        rec["cache"] = [[tuple(x.shape) for x in (c.k, c.v, c.idx)]
                        for c in caches]
        rec["cache_bytes"] = sum(x.numel() * x.element_size()
                                 for x in tree_leaves(caches)
                                 if isinstance(x, torch.Tensor))
        logits = []
        for t in range(steps):
            with _Handed(names) as handed:
                lg, caches = decode(params, toks[:, t:t + 1], caches)
            if t == 0:
                rec["decode_handed"] = handed.log
            logits.append(lg)
        rec["decode"] = torch.cat(logits, dim=1)
        with _Handed(names) as handed:
            make_prefill_step(cfg, mesh, device="cpu")(
                params, {"tokens": job["prompt"]})
        rec["bf16_prefill_handed"] = handed.log
        caches = init_cache(cfg, b, steps, device="cpu", model=m)
        with _Handed(names) as handed:
            make_decode_step(cfg, mesh, device="cpu")(
                params, job["prompt"][:, :1], caches)
        rec["bf16_decode_handed"] = handed.log
        out[arch] = rec
    return out


def _rank(rank, case, inp_path, out_path, rendezvous, world):
    if case.startswith("tp_"):
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            world_size=world, rank=rank)
    try:
        inp = torch.load(inp_path, weights_only=False)
        fns = {"reduce": _reduce, "step": _step, "tp_blocks": _tp_blocks,
               "tp_select": _tp_select, "tp_ops": _tp_ops,
               "tp_moe": _tp_moe, "tp_step": _tp_step,
               "tp_serve": _tp_serve}
        if "+" in case:             # several cases, ``inp`` a dict of inputs
            out = {c: fns[c](rank, inp[c], dist.group.WORLD)
                   for c in case.split("+")}
        else:
            out = fns[case](rank, inp, dist.group.WORLD)
        torch.save(out, f"{out_path}.{rank}")
    finally:
        dist.destroy_process_group()


def main():
    case, inp_path, out_path = sys.argv[1:4]
    world = int(sys.argv[4]) if len(sys.argv) > 4 else WORLD
    # the ranks meet through a fresh file beside the outputs, which no other
    # world can name (a port from a closed socket can be taken in between)
    rendezvous = f"{out_path}.rendezvous"
    if os.path.exists(rendezvous):
        os.remove(rendezvous)
    try:
        mp.spawn(_rank, args=(case, inp_path, out_path, rendezvous, world),
                 nprocs=world, join=True)
    finally:
        if os.path.exists(rendezvous):
            os.remove(rendezvous)


if __name__ == "__main__":
    main()
