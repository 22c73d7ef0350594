"""The federated train_step of the mesh trainer, over ``torch.distributed``
client ranks.

Counterpart of ``repro/launch/train.py``.  The paper's protocol at LLM
scale:

* the client axes (``pod``, ``data``) carry the CLIENTS, one
  ``torch.distributed`` rank each (the reference's manual ``shard_map``
  axes); each rank holds its own client's state, with a leading client axis
  of 1, as inside ``shard_map``;
* each client computes grads on its own rows of the global batch ONLY (no
  gradient all-reduce -- that is the point of federated learning);
* upstream: the codec's ``tree_encode`` (per client, with error feedback
  where the codec keeps one -- Eqs. 8-11);
* aggregation + downstream: the codec's ``tree_reduce`` collective over the
  client ranks (the only protocol-level collective), then ``tree_decode``
  with the server residual (Eqs. 10/12), computed identically on every
  rank, so the broadcast is implicit;
* every codec registered in :mod:`repro_torch.core.protocols` runs; there
  is no protocol dispatch in this module.

The ``model`` axis is tensor parallelism inside a client, for the
attention family, dense or MoE (the experts split on their hidden dim):
with ``model = M > 1`` a client is ``M`` ranks (rank ``d·M + m``,
:class:`~repro_torch.launch.mesh.Mesh`), each holding its
:func:`~repro_torch.sharding.rules.shard_leaf` block of every parameter,
residual and momentum (:func:`state_shardings`' layout); the forward and
backward are Megatron's split products
(:mod:`repro_torch.sharding.tensor_parallel`), the codecs take their
global statistics over the client's model group (STC's k-selection split
across the shards, never gathering the tree), and ``tree_reduce`` runs
over the ranks that share ``m``.  The function computed is the
reference's step on the same mesh (GSPMD's automatic ``model`` axis), on
every split that ``fit_spec`` makes: heads cut mid-head take the
attention's gather route, and leaves kept whole run replicated.  Other
families and the chunked STC raise (:func:`tensor_parallel_gap`).  The
step runs on the card unless ``device="cpu"`` is passed; on the card the
local SGD runs under PyTorch's deterministic algorithms, so that reruns
and ranks are bitwise (the MoE blocks' dispatch moves rows by gathers
both ways, with no atomic adds).  A MoE layer reads its experts' group
sizes to the host, one sync a layer in the forward and one in remat's
recompute.  Momentum defaults OFF per the paper's lesson (6).

Run as a script; it spawns its ranks itself (gloo, every rank on the same
device; ``--ranks / --model`` clients of ``--model`` shards each):

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        [--ranks 2] [--model 1] [--device cpu]
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any

import numpy as np
import torch

from ..core.compression import _rebuild, tree_leaves, tree_map
from ..core.distributed import ModelShards, all_gather, psum
from ..core.protocols import Codec, get_protocol_class
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import init_model, lm_loss
from ..sharding.rules import (Sharding, batch_entry, batch_rows, fit_spec,
                              map_tree, param_specs, replicated_leaves,
                              shard_tree, unshard_leaf)
from ..sharding.tensor_parallel import TensorParallel, arch_gap

__all__ = ["TrainConfig", "WireLedger", "codec_for", "init_train_state",
           "make_train_step", "state_shardings", "batch_shardings",
           "tensor_parallel_gap", "unshard_tree", "main"]


class WireLedger:
    """Host-side measured-bits accounting for the mesh trainer.

    Feed it the ``(msgs_tree, global_delta_tree)`` extra output of a
    ``measure_wire=True`` train step; it serializes every client's message
    and the downstream update through the codec's wire format
    (:mod:`repro_torch.core.wire`) and accumulates EXACT bits, alongside
    the analytic Eq. 1 model as a cross-check.  Codecs without a wire
    format fall back to analytic in both columns.  ``device`` is where a
    device wire backend (``"kernel"``) packs the host messages; None packs
    them on its default device (the card).
    """

    def __init__(self, codec: Codec, numel: int, device=None):
        self.codec, self.numel, self.device = codec, numel, device
        self.rounds = 0
        self.bits_up = self.bits_down = 0.0
        self.bits_up_analytic = self.bits_down_analytic = 0.0

    def record_round(self, msgs_tree, global_delta_tree, mask=None) -> None:
        """Account one round.  ``mask`` (per-client 0/1, masked mode) keeps
        the ledger honest under dropped clients: only messages that reached
        the server count as upstream bits."""
        leaves = [leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
                  else np.asarray(leaf) for leaf in tree_leaves(msgs_tree)]
        n_clients = leaves[0].shape[0]
        msgs = np.concatenate(
            [leaf.reshape(n_clients, -1).astype(np.float32)
             for leaf in leaves], axis=1)
        if mask is not None:
            keep = np.asarray(mask, dtype=bool).reshape(-1)
            msgs = msgs[keep]
            n_clients = int(keep.sum())
        gd = np.concatenate(
            [(leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor)
              else np.asarray(leaf)).reshape(-1).astype(np.float32)
             for leaf in tree_leaves(global_delta_tree)])
        if n_clients:
            self.bits_up += self.codec.measured_upload_bits(
                msgs, device=self.device)
        self.bits_down += self.codec.measured_download_bits(
            gd, n_participating=max(n_clients, 1), device=self.device)
        self.bits_up_analytic += n_clients * self.codec.upload_bits(self.numel)
        self.bits_down_analytic += self.codec.download_bits(
            self.numel, n_participating=max(n_clients, 1))
        self.rounds += 1

    def summary(self) -> dict:
        return {"rounds": self.rounds, "bits_up": self.bits_up,
                "bits_down": self.bits_down,
                "bits_up_analytic": self.bits_up_analytic,
                "bits_down_analytic": self.bits_down_analytic}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    protocol: str = "stc"           # any codec registered in core.protocols
    lr: float = 0.1
    momentum: float = 0.0           # paper lesson (6): keep 0 in fed settings
    sparsity_up: float = 1 / 400
    sparsity_down: float = 1 / 400
    sign_step: float = 2e-4
    local_iters: int = 1            # fedavg delay period n
    compute_dtype: Any = torch.bfloat16
    stc_iters: int = 32             # the reference's bisection rounds (the
                                    # port's selection is exact without)
    chunks: int | None = None       # chunked (leaf, chunk) selection: each
                                    # leaf splits into ceil(size/chunks)
                                    # blocks with their own k-selection/µ
    p_fn: Any = None                # per-layer sparsity schedule hook:
                                    # p_fn(layer_name, depth) -> p | None
    controller: Any = None          # adaptive per-chunk sparsity controller
                                    # (core.adaptive name or instance) for
                                    # the chunked tree path
    measure_wire: bool = False      # also return (msgs, global_delta) trees
                                    # so a host WireLedger can account the
                                    # REAL serialized bits per round
    rule: Any = None                # server AggregationRule (name or
                                    # instance, core.aggregation); None =
                                    # the codec default ("mean")
    masked: bool = False            # masked mode: train_step takes the
                                    # per-client (mask, staleness) vectors; a
                                    # masked-out client's message gets zero
                                    # weight and its residual / momentum
                                    # stay frozen


def codec_for(tc: TrainConfig) -> Codec:
    """Instantiate the registered codec named by ``tc.protocol``, forwarding
    exactly the TrainConfig hyperparameters the codec declares as fields."""
    cls = get_protocol_class(tc.protocol)
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = dict(sparsity_up=tc.sparsity_up, sparsity_down=tc.sparsity_down,
              sign_step=tc.sign_step, local_iters=tc.local_iters,
              chunk_size=tc.chunks, p_fn=tc.p_fn, controller=tc.controller)
    kw = {k: v for k, v in kw.items() if k in fields}
    if tc.rule is not None:
        kw["rule"] = tc.rule
    return cls(**kw)


def init_train_state(cfg: ModelConfig, tc: TrainConfig, n_clients: int = 1,
                     key=0, *, device=None, params=None, mesh=None,
                     model_rank: int | None = None):
    """The train state of THIS rank: the parameters (from ``key``, a seed
    or a CPU ``torch.Generator``, unless ``params`` are given) and the step,
    with this rank's client residual and momentum (fp32, a leading client
    axis of 1: one client a rank, whatever ``n_clients``) and the server
    residual where the codec keeps them.

    On a ``mesh`` with a ``model`` axis > 1 the parameters (drawn or given
    whole, on the host) are cut to model rank ``model_rank``'s blocks
    (default: this process's, ``mesh.model_rank()``) and only the blocks
    reach ``device``; every buffer is then block-sized."""
    if n_clients < 1:
        raise ValueError(f"n_clients must be >= 1, got {n_clients}")
    device = resolve_device(device)
    codec = codec_for(tc)
    split = mesh is not None and mesh.shape.get("model", 1) > 1
    if params is None:
        params = init_model(cfg, key, None if split else device)
    else:
        params = tree_map(lambda t: (t if isinstance(t, torch.Tensor)
                                     else torch.from_numpy(np.array(t)))
                          .to("cpu" if split else device), params)
    if split:
        m = mesh.model_rank() if model_rank is None else model_rank
        params = tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype,
                                  device=device).copy_(t),
            shard_tree(params, mesh, m))
    state = {"params": params,
             "step": torch.zeros((), dtype=torch.int32, device=device)}

    def stacked(p):
        return torch.zeros((1,) + tuple(p.shape), dtype=torch.float32,
                           device=device)

    if codec.has_client_state():
        state["client_res"] = tree_map(stacked, params)
    if codec.has_server_state():
        state["server_res"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=device), params)
    if tc.momentum > 0:
        state["momentum"] = tree_map(stacked, params)
    return state


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------


def state_shardings(state, mesh):
    """:class:`~repro_torch.sharding.rules.Sharding` s of the train state
    on ``mesh``, over its GLOBAL shapes: the parameters and the server
    residual model-sharded; the client-major buffers (client residual,
    momentum: ``(n_clients,) + shape``) split over the client axes too, so
    a device holds one client's row -- what a rank's state holds, its
    leading client axis of 1.  Only the parameters' shapes are read:
    ``state`` may be a rank's state or its ``meta`` stand-ins."""
    ca = mesh.client_axes
    n = mesh.n_clients
    params = state["params"]
    pspecs = param_specs(params)

    def shard(_, p, s):
        return Sharding(mesh, fit_spec(s, tuple(p.shape), mesh))

    def shard_stacked(_, p, s):
        return Sharding(mesh, fit_spec((ca,) + s, (n,) + tuple(p.shape),
                                       mesh))

    sh = {"params": map_tree(shard, params, pspecs),
          "step": Sharding(mesh, ())}
    for name in ("client_res", "momentum"):
        if name in state:
            sh[name] = map_tree(shard_stacked, params, pspecs)
    if "server_res" in state:
        sh["server_res"] = map_tree(shard, params, pspecs)
    return sh


def batch_shardings(batch, mesh, global_batch: int):
    """Every entry of the batch split on its first dimension over the
    client axes (:func:`repro_torch.sharding.rules.batch_spec`)."""
    spec = (batch_entry(mesh, global_batch),)
    return {name: Sharding(mesh, spec) for name in batch}


@contextlib.contextmanager
def _deterministic(device: torch.device):
    """PyTorch's deterministic algorithms on the card (the tied
    embedding's backward adds many rows into one table), restored after."""
    if device.type != "cuda":
        yield
        return
    import torch.utils.deterministic as det
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def tensor_parallel_gap(cfg: ModelConfig, mesh, tc: TrainConfig):
    """Why the step cannot run ``cfg`` with ``mesh``'s ``model`` axis, or
    None where it can: the split products' configs
    (:func:`~repro_torch.sharding.tensor_parallel.arch_gap`), but for the
    chunked STC, whose blocks cut across the shards.  The message names
    the ROADMAP item that would run it."""
    gap = arch_gap(cfg, mesh)
    if gap or mesh.shape.get("model", 1) == 1 or not tc.chunks:
        return gap
    return (f"tensor parallelism (a mesh 'model' axis of "
            f"{mesh.shape['model']}) runs the attention family, dense or "
            f"MoE; {cfg.name}: the chunked STC's blocks cut across the shards "
            f"(ROADMAP.md Queue 1, item 4d)")


def unshard_tree(tree, cfg: ModelConfig, mesh, group):
    """A parameter-shaped tree of model blocks joined back into global
    leaves over the model ``group``
    (:func:`~repro_torch.sharding.rules.unshard_leaf`, leaf by leaf in
    ``tree_leaves`` order on every rank)."""
    meta = init_model(cfg, device="meta")
    return map_tree(lambda _, x, p, s: unshard_leaf(x, s, p.shape, mesh,
                                                    group),
                    tree, meta, param_specs(meta))


def make_train_step(cfg: ModelConfig, mesh, tc: TrainConfig, device=None):
    """Returns ``train_step(state, batch, mask=None, staleness=None) ->
    (state, metrics)`` (``(state, metrics, (msgs, global_delta))`` with
    ``measure_wire``) for THIS rank's client.

    ``batch`` is the global batch (``tokens``, ``labels``: (B, S); an
    encoder-decoder's ``frames`` (B, F, d), a VLM's ``prefix`` (B, P, d));
    the rank takes its rows of every entry
    (:func:`repro_torch.sharding.rules.batch_rows`).
    ``mask`` / ``staleness`` are the global per-client vectors (masked mode
    only); the rank takes its entry.  Metrics stay on the device.

    With a ``model`` axis > 1 the state is this rank's blocks
    (:func:`init_train_state` with the ``mesh``); a client's rows go to
    each of its model ranks, and the step raises
    ``NotImplementedError`` where :func:`tensor_parallel_gap` names a
    gap.  Under ``measure_wire`` the messages and the downstream update
    come back whole, joined over the model group."""
    device = resolve_device(device)
    gap = tensor_parallel_gap(cfg, mesh, tc)
    if gap:
        raise NotImplementedError(gap)
    group = mesh.client_group()
    rank = mesh.client_rank()
    n_clients = mesh.n_clients
    numel = cfg.param_count()
    codec = codec_for(tc)
    tp, split = None, {}
    if mesh.shape.get("model", 1) > 1:
        tp = TensorParallel(mesh.model_group(), mesh.model_rank(),
                            mesh.shape["model"])
        split = {"model": ModelShards(tp.group, tp.rank, tuple(
            replicated_leaves(init_model(cfg, device="meta"), mesh)))}

    def value_and_grad(params, batch):
        leaves = [leaf.detach().requires_grad_(True)
                  for leaf in tree_leaves(params)]
        loss = lm_loss(_rebuild(params, iter(leaves)), cfg, batch["tokens"],
                       batch["labels"], prefix=batch.get("prefix"),
                       frames=batch.get("frames"),
                       compute_dtype=tc.compute_dtype, tp=tp)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _rebuild(params, iter(grads))

    def update(mom, g):
        """(new momentum, the update) for grads ``g``."""
        if tc.momentum > 0:
            mom = tree_map(lambda vv, gg: tc.momentum * vv +
                           gg.to(torch.float32), mom, g)
            return mom, mom
        return mom, g

    def local_delta(params, mom, batch):
        """One client's update ΔW (and new momentum).  A codec with a
        communication-delay period runs ``local_iters`` sequential SGD
        steps over microbatches."""
        if codec.local_iters > 1:
            n = tc.local_iters
            b_local = batch["tokens"].shape[0]
            if b_local % n:
                raise ValueError(f"a client's {b_local} rows do not split "
                                 f"into {n} microbatches")
            micro = {k: v.reshape((n, b_local // n) + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            p, losses = params, []
            for i in range(n):
                loss, g = value_and_grad(p, {k: v[i]
                                             for k, v in micro.items()})
                mom, upd = update(mom, g)
                p = tree_map(lambda pp, uu: (pp.to(torch.float32) -
                                             tc.lr * uu.to(torch.float32))
                             .to(pp.dtype), p, upd)
                losses.append(loss)
            delta = tree_map(lambda a, b: a.to(torch.float32) -
                             b.to(torch.float32), p, params)
            return delta, mom, torch.stack(losses).mean()
        loss, g = value_and_grad(params, batch)
        mom, upd = update(mom, g)
        delta = tree_map(lambda u: -tc.lr * u.to(torch.float32), upd)
        return delta, mom, loss

    def where(cond, new, old):
        return tree_map(lambda a, b: torch.where(cond, a, b), new, old)

    def step_fn(state, batch, mask=None, staleness=None):
        if not tc.masked and (mask is not None or staleness is not None):
            raise ValueError(
                "train_step got mask/staleness but TrainConfig.masked is "
                "False; rebuild the step with TrainConfig(masked=True)")
        b = batch["tokens"].shape[0]
        if b % n_clients:
            raise ValueError(f"the global batch of {b} rows does not split "
                             f"over {n_clients} clients")
        rows = batch_rows(mesh, b, rank)
        batch = {k: torch.as_tensor(v)[rows].to(device)
                 for k, v in batch.items()}
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.float32).reshape(-1)[
                rank:rank + 1].to(device)
        if staleness is not None:
            staleness = torch.as_tensor(
                staleness, dtype=torch.float32).reshape(-1)[
                rank:rank + 1].to(device)

        params = state["params"]
        mom = None
        if "momentum" in state:
            mom = tree_map(lambda x: x[0], state["momentum"])
        with _deterministic(device):
            delta, mom, loss = local_delta(params, mom, batch)
        if group is not None:
            loss = psum(loss, group) / torch.tensor(float(n_clients),
                                                    device=device)
        metrics = {"loss": loss}
        new_state = dict(state)
        new_state["step"] = state["step"] + 1
        # a masked-out (dropped) client's local state must not advance: its
        # message never reached the server, so momentum / residual stay
        # frozen until it participates again
        arrived = None if mask is None else mask.sum() > 0
        if mom is not None:
            if arrived is not None:
                mom = where(arrived, mom, tree_map(lambda x: x[0],
                                                   state["momentum"]))
            new_state["momentum"] = tree_map(lambda x: x[None], mom)

        # ---- the entire protocol: three codec calls, zero dispatch ------
        cres = (tree_map(lambda x: x[0], state["client_res"])
                if "client_res" in state else None)
        msg, new_cres, m_up = codec.tree_encode(delta, cres, numel=numel,
                                                iters=tc.stc_iters, **split)
        del delta                   # one model-sized copy less at the decode
        if "client_res" in state:
            if arrived is not None:
                new_cres = where(arrived, new_cres,
                                 tree_map(lambda x: x[0],
                                          state["client_res"]))
            new_state["client_res"] = tree_map(lambda x: x[None], new_cres)
        # ---- upload: the ONLY protocol-level collective -----------------
        combined = codec.tree_reduce(msg, group, n_clients, mask=mask,
                                     staleness=staleness)
        global_delta, new_sres, m_down = codec.tree_decode(
            combined, state.get("server_res"), numel=numel,
            iters=tc.stc_iters, **split)
        if mask is not None:
            # zero-arrival step: the server must not move either -- without
            # this gate a stateful codec (stc) would still drain its server
            # residual into a parameter update off the all-zero combined tree
            any_arrived = psum(mask.sum(), group) > 0
            global_delta = tree_map(
                lambda d: torch.where(any_arrived, d, torch.zeros_like(d)),
                global_delta)
            if new_sres is not None:
                new_sres = where(any_arrived, new_sres, state["server_res"])
        if "server_res" in state:
            new_state["server_res"] = new_sres
        metrics.update(m_up)
        metrics.update(m_down)

        new_state["params"] = tree_map(
            lambda p, d: (p.to(torch.float32) + d.to(torch.float32))
            .to(p.dtype), params, global_delta)
        if tc.measure_wire:
            # every client's message (leading client axis, gathered from
            # the ranks) + the replicated downstream update, whole
            if tp is not None:
                msg = unshard_tree(msg, cfg, mesh, tp.group)
                global_delta = unshard_tree(global_delta, cfg, mesh,
                                            tp.group)
            msgs = tree_map(lambda x: all_gather(x, group), msg)
            return new_state, metrics, (msgs, global_delta)
        return new_state, metrics

    return step_fn


# ---------------------------------------------------------------------------
# CLI driver
# ---------------------------------------------------------------------------


def _run(rank: int, args, rendezvous: str) -> None:
    from ..configs import get_config, get_smoke_config, stand_in_inputs
    from ..data import make_lm_tokens
    from .mesh import make_debug_mesh

    device = resolve_device(args.device)
    if args.ranks > 1:
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                                world_size=args.ranks, rank=rank)
    try:
        cfg = (get_config if args.full else get_smoke_config)(args.arch)
        mesh = make_debug_mesh(data=args.ranks // args.model,
                               model=args.model)
        tc = TrainConfig(protocol=args.protocol, lr=0.05,
                         sparsity_up=1 / 50, sparsity_down=1 / 50,
                         measure_wire=args.measure_wire, chunks=args.chunks)
        state = init_train_state(cfg, tc, n_clients=mesh.n_clients, key=0,
                                 device=device, mesh=mesh)
        toks = make_lm_tokens(n_tokens=4 * 128 + 1, vocab=cfg.vocab_size)
        batch = {"tokens": torch.as_tensor(toks[:-1].reshape(4, 128)),
                 "labels": torch.as_tensor(toks[1:].reshape(4, 128))}
        batch.update(stand_in_inputs(cfg, 4))
        ledger = WireLedger(codec_for(tc), cfg.param_count())
        step = make_train_step(cfg, mesh, tc, device=device)
        for i in range(args.steps):
            if tc.measure_wire:
                state, metrics, (msgs, gd) = step(state, batch)
                ledger.record_round(msgs, gd)
            else:
                state, metrics = step(state, batch)
            if rank == 0:
                print(f"step {i}: loss={float(metrics['loss']):.4f}",
                      {k: int(v) for k, v in metrics.items() if k != "loss"},
                      flush=True)
        if tc.measure_wire and rank == 0:
            s = ledger.summary()
            print(f"wire ledger over {s['rounds']} rounds: "
                  f"up {s['bits_up']/8e6:.3f} MB (analytic "
                  f"{s['bits_up_analytic']/8e6:.3f}), down "
                  f"{s['bits_down']/8e6:.3f} MB (analytic "
                  f"{s['bits_down_analytic']/8e6:.3f})")
    finally:
        if args.ranks > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--protocol", default="stc")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks (processes), all on one device: "
                         "ranks / model clients")
    ap.add_argument("--model", type=int, default=1,
                    help="tensor-parallel shards a client (the mesh's "
                         "'model' axis)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config (default: its smoke config)")
    ap.add_argument("--measure-wire", action="store_true",
                    help="serialize every message through the real wire "
                         "format and print measured vs analytic bits")
    ap.add_argument("--chunks", type=int, default=None,
                    help="chunked per-(leaf, chunk) selection block size "
                         "(default: one global flat selection)")
    args = ap.parse_args(argv)
    resolve_device(args.device)          # no card: raise before spawning
    if args.ranks < 1 or args.model < 1 or args.ranks % args.model:
        raise SystemExit("--ranks must be a positive multiple of --model")
    if args.ranks == 1:
        _run(0, args, "")
        return
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    # the ranks meet through a file no other world can name (a port taken
    # from a closed socket can be taken again before rank 0 binds it)
    where = tempfile.mkdtemp(prefix="repro_torch_rendezvous_")
    try:
        mp.spawn(_run, args=(args, os.path.join(where, "store")),
                 nprocs=args.ranks, join=True)
    finally:
        shutil.rmtree(where, ignore_errors=True)


if __name__ == "__main__":
    main()
