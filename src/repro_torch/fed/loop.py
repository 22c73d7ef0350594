"""Federated trainers -- Algorithm 2 of the paper, end to end.

Counterpart of ``repro/fed/loop.py``: the synchronous
:class:`FederatedTrainer` and the deadline-buffered
:class:`BufferedFederatedTrainer`.  A round has two phases, as in the
reference:

* ``encode`` (:func:`build_encode_phase`) -- local SGD on every sampled
  client, the whole cohort at once through ``torch.func.vmap`` over
  ``torch.func.grad`` (:func:`local_sgd`), then upstream compression with
  error feedback (``Codec.encode_batch``);
* ``apply`` (:func:`build_apply_phase`) -- the codec's aggregate (combine,
  server-side compression with the server residual) and the parameter
  update.

Partial participation, the server-side update cache (Sec. V-B) and the bit
ledger live in the host loop.  When the codec has a wire format the
ledger is MEASURED -- every message is serialized through
:mod:`repro_torch.core.wire` -- with the analytic Eq. 1 model kept in the
``*_analytic`` columns as a cross-check.

Client sampling and mini-batches draw from the same
``np.random.default_rng(seed + 1)`` stream as the reference, so both
trainers see the same data.  The trainer runs on CUDA unless it is given
``device="cpu"``; on the card it turns TF32 off for matmuls and
convolutions, so that fp32 stays fp32.

With ``TrainerConfig(ingest=True)`` the apply phase is the fused server
ingest instead: the round's messages are encoded to the wire, decoded
(through the ``"kernel"`` wire backend's decode kernels on the trainer's
device, or on the host) and scattered into one host
:class:`~repro_torch.core.ingest.IngestAccumulator`, and the codec
finalizes the round from it; the ledger reuses the encoded batch.  A codec
without a wire format (``ternquant``) ingests its messages densely, and its
ledger is analytic.

:class:`BufferedFederatedTrainer` puts the
:mod:`repro_torch.fed.arrivals` simulator between the two phases: the
server aggregates whatever landed by the round's deadline,
staleness-weighted.  With ``deadline=inf`` it is the synchronous trainer
bit for bit.

``TrainerConfig(chunks=...)`` wraps the codec into per-``(layer, chunk)``
block states (:mod:`repro_torch.core.chunking`): independent k-selection,
µ, residuals and wire sub-streams per chunk, with ``p_fn(layer_name,
depth)`` as the per-layer sparsity schedule and ``controller`` an adaptive
per-chunk sparsity controller (:mod:`repro_torch.core.adaptive`);
``chunks="whole"`` runs the chunked machinery over one whole-vector chunk,
bit for bit the flat path.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core.caching import UpdateCache
from repro_torch.core.chunking import (chunk_codec, chunk_spec_from_tree,
                                       whole_vector_spec)
from repro_torch.core.compression import (flatten_pytree, tree_leaves,
                                          tree_map, unflatten_pytree)
from repro_torch.core.protocols import Codec
from repro_torch.core.residual import (scatter_states, stack_states,
                                       take_states)
from repro_torch.data.synthetic import Dataset
from repro_torch.device import resolve_device
from repro_torch.fed.arrivals import ArrivalSimulator, LatencyModel
from repro_torch.fed.environment import FedEnvironment, split_data

__all__ = ["FederatedTrainer", "BufferedFederatedTrainer", "TrainerConfig",
           "build_encode_phase", "build_apply_phase", "local_sgd"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    lr: float = 0.04
    momentum: float = 0.0
    seed: int = 0
    eval_batch: int = 512
    # Measure real wire bits whenever the codec has a wire format (the
    # analytic Eq. 1 ledger is always kept alongside); False forces
    # analytic-only accounting.
    measure_bits: bool | None = None
    # Chunked (layer, chunk) codec states: an int chunk size splits every
    # layer into chunks of at most that many parameters (independent
    # selection, µ, residuals and wire sub-stream per chunk); "whole" runs
    # the chunked machinery over ONE whole-vector chunk (the flat path, bit
    # for bit); None is the plain flat codec.  ``p_fn(layer_name, depth) ->
    # p | None`` is the per-layer sparsity schedule (only with chunks).
    chunks: int | str | None = None
    p_fn: Optional[Callable] = None
    # Adaptive per-chunk sparsity controller (repro_torch.core.adaptive): a
    # registered name ("fixed", "residual_mass", "snr_constant") or a
    # SparsityController instance; requires ``chunks``.  "fixed" (or None)
    # keeps the static p_fn schedule.
    controller: object = None
    # Fused decode→aggregate server ingest (repro_torch.core.ingest): the
    # round's wire messages scatter into one O(numel) host accumulator
    # instead of a dense (P, numel) combine.  Opt-in, as in the reference.
    ingest: bool = False


def _cross_entropy(logits, y):
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, y[:, None])[:, 0]
    return (logz - gold).mean()


def _flatten_rows(tree) -> torch.Tensor:
    """A tree of cohort-stacked leaves ``(P, ...)`` as ``(P, numel)`` fp32,
    in the leaf order of :func:`flatten_pytree`."""
    return torch.cat([leaf.reshape(leaf.shape[0], -1).to(torch.float32)
                      for leaf in tree_leaves(tree)], dim=1)


def local_sgd(apply_fn: Callable, spec, params_vec: torch.Tensor,
              mom_sel: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
              lr: float, momentum: float):
    """Every client of the cohort takes ``xs.shape[1]`` SGD steps from the
    same global model (``lax.scan`` in the reference, a loop here).
    ``xs: (P, iters, b, ...)``, ``mom_sel: (P, numel)``.  Returns the flat
    ``(P, numel)`` deltas and the new momentum."""
    params = unflatten_pytree(params_vec[None].expand(xs.shape[0], -1), spec)
    mom = unflatten_pytree(mom_sel, spec)

    def loss(p, x, y):
        return _cross_entropy(apply_fn(p, x), y)

    cohort_grad = vmap(grad(loss))
    for it in range(xs.shape[1]):
        g = cohort_grad(params, xs[:, it], ys[:, it])
        mom = tree_map(lambda v, gi: momentum * v + gi, mom, g)
        params = tree_map(lambda p, v: p - lr * v, params, mom)
    return _flatten_rows(params) - params_vec[None], _flatten_rows(mom)


def build_encode_phase(codec: Codec, apply_fn: Callable, spec, lr: float,
                       momentum: float):
    """Client phase: local SGD on the dispatched cohort + upstream
    compression.  Returns ``(params_vec, mom_sel, cstate_sel, xs, ys) ->
    (msgs, new_mom, new_cstate)``."""
    def encode_fn(params_vec, mom_sel, cstate_sel, xs, ys):
        deltas, new_mom = local_sgd(apply_fn, spec, params_vec, mom_sel,
                                    xs, ys, lr, momentum)
        msgs, new_cstate, _ = codec.encode_batch(deltas, cstate_sel)
        return msgs, new_mom, new_cstate

    return encode_fn


def build_apply_phase(codec: Codec):
    """Server phase: masked staleness-weighted aggregation + downstream
    compression + the parameter update.  Returns ``(params_vec,
    server_state, msgs, mask, staleness) -> (new_params_vec,
    new_server_state, global_delta)``."""
    def apply_fn(params_vec, server_state, msgs, mask, staleness):
        global_delta, server_state, _ = codec.aggregate(
            msgs, server_state, mask=mask, staleness=staleness)
        return params_vec + global_delta, server_state, global_delta

    return apply_fn


class FederatedTrainer:
    """Simulates Algorithm 2 on one host (fully synchronous rounds).

    ``model`` is an ``(init_fn, apply_fn)`` pair; ``init_fn`` takes a
    ``torch.Generator`` seeded with ``tcfg.seed``.
    """

    def __init__(self, model: tuple[Callable, Callable], train: Dataset,
                 test: Dataset, env: FedEnvironment, protocol: Codec,
                 tcfg: TrainerConfig = TrainerConfig(), *, device=None):
        params = model[0](torch.Generator().manual_seed(tcfg.seed))
        vec, self.spec = flatten_pytree(params)
        self.numel = int(vec.numel())
        if tcfg.chunks is not None:
            cspec = (whole_vector_spec(self.numel) if tcfg.chunks == "whole"
                     else chunk_spec_from_tree(params, int(tcfg.chunks)))
            protocol = chunk_codec(protocol, cspec, p_fn=tcfg.p_fn,
                                   controller=tcfg.controller)
        elif tcfg.controller is not None:
            raise ValueError(
                "TrainerConfig(controller=...) needs per-chunk states; set "
                "TrainerConfig(chunks=...) (e.g. chunks='whole')")
        self.ingest = bool(tcfg.ingest)
        if self.ingest and not protocol.supports_ingest:
            raise ValueError(
                f"codec {protocol.name!r} has no ingest path "
                "(supports_ingest=False); drop TrainerConfig(ingest=True)")
        if self.ingest and not protocol.rule.supports_streaming:
            # order-statistic rules need every client's coordinates at
            # once: the round aggregates dense, loudly
            warnings.warn(
                f"aggregation rule {protocol.rule.name!r} cannot stream "
                "(supports_streaming=False); TrainerConfig(ingest=True) "
                "falls back to the dense combine for this codec",
                RuntimeWarning, stacklevel=2)
            self.ingest = False
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.apply_fn = model[1]
        self.env = env
        self.tcfg = tcfg
        self.train = train
        self.test = test
        self.protocol = protocol
        self.params_vec = vec.to(self.device)

        self.splits = split_data(train.y, env, seed=tcfg.seed)
        self.rng = np.random.default_rng(tcfg.seed + 1)

        c = env.n_clients
        self.client_mom = torch.zeros((c, self.numel), dtype=torch.float32,
                                      device=self.device)
        self.client_state = stack_states(
            protocol.init_client_state(self.numel, self.device), c)
        self.server_state = protocol.init_server_state(self.numel,
                                                       self.device)
        self.last_seen = np.zeros(c, dtype=np.int64)
        self.cache = UpdateCache(self.numel, max_rounds=64)

        self.round = 0
        # MEASURED wire bits when the codec has a wire format (unless
        # disabled), analytic otherwise; ``*_analytic`` is always Eq. 1
        self.measure_bits = protocol.wire_format and (
            tcfg.measure_bits if tcfg.measure_bits is not None
            else not protocol.wire_static_size)
        self.bits_up = 0.0
        self.bits_down = 0.0
        self.bits_up_analytic = 0.0
        self.bits_down_analytic = 0.0
        self.wire_log: list[dict] = []
        self.history: list[dict] = []

        self._encode_fn = build_encode_phase(protocol, self.apply_fn,
                                             self.spec, tcfg.lr,
                                             tcfg.momentum)
        self._apply_fn = build_apply_phase(protocol)

    # ----------------------------------------------------------------- host
    def _sample_batches(self, client_ids, local_iters):
        b = self.env.batch_size
        xs, ys = [], []
        for cid in client_ids:
            idx_pool = self.splits[cid]
            need = local_iters * b
            idx = self.rng.choice(idx_pool, size=need,
                                  replace=len(idx_pool) < need)
            xs.append(self.train.x[idx].reshape((local_iters, b) +
                                                self.train.x.shape[1:]))
            ys.append(self.train.y[idx].reshape(local_iters, b))
        return (torch.from_numpy(np.stack(xs)).to(self.device),
                torch.from_numpy(np.stack(ys).astype(np.int64))
                .to(self.device))

    def _dispatch(self, sel, xs, ys):
        """Run the cohort's local updates + encoding against the current
        model; client-side state (momentum, residuals) commits here."""
        idx = torch.as_tensor(sel, device=self.device)
        msgs, new_mom, new_cstate = self._encode_fn(
            self.params_vec, self.client_mom[idx],
            take_states(self.client_state, idx), xs, ys)
        self.client_mom[idx] = new_mom
        self.client_state = scatter_states(self.client_state, idx, new_cstate)
        return msgs

    def _apply_update(self, msgs, mask, staleness):
        """Aggregate + apply; returns the global delta."""
        (self.params_vec, self.server_state,
         global_delta) = self._apply_fn(
            self.params_vec, self.server_state, msgs,
            torch.as_tensor(mask, dtype=torch.float32, device=self.device),
            torch.as_tensor(staleness, dtype=torch.float32,
                            device=self.device))
        return global_delta

    def _participation_weights_np(self, mask, staleness) -> np.ndarray:
        """The codec's fp32 combining weights, resolved on the host as fp64
        (the ingest accumulator's weights)."""
        return self.protocol.participation_weights(
            torch.as_tensor(mask, dtype=torch.float32),
            torch.as_tensor(staleness, dtype=torch.float32)
        ).numpy().astype(np.float64)

    def _ingest_round(self, msgs, mask, staleness):
        """Fused streaming aggregation: the round's messages scatter into an
        O(numel) host accumulator instead of a dense combine -- wire codecs
        through their decoded fields (decoded on the trainer's device by
        the ``"kernel"`` wire backend), the others densely.  Returns the
        applied global delta and the encoded batch (None for a wire-less
        codec), which the measured ledger reuses."""
        proto = self.protocol
        w = self._participation_weights_np(mask, staleness)
        acc = proto.make_ingest(self.numel)
        batch = None
        if proto.wire_format:
            batch = proto.encode_wire_batch(msgs, direction="up")
            proto.ingest_wire_batch(acc, batch, w, direction="up",
                                    device=self.device)
        else:
            host = msgs.detach().cpu().numpy()
            for i in range(host.shape[0]):
                proto.ingest_dense(acc, host[i], float(w[i]))
        return self._finalize_ingest(acc), batch

    def _finalize_ingest(self, acc):
        """Finalize a round from its accumulator and apply it; returns the
        global delta on the trainer's device."""
        gd, self.server_state, _ = self.protocol.aggregate_ingest(
            acc, self.server_state)
        gd = gd.to(self.device)
        self.params_vec = self.params_vec + gd
        return gd

    def run_round(self):
        p = self.env.participants_per_round
        sel = self.rng.choice(self.env.n_clients, size=p, replace=False)
        xs, ys = self._sample_batches(sel, self.protocol.local_iters)
        msgs = self._dispatch(sel, xs, ys)
        mask, staleness = np.ones(p, np.float32), np.zeros(p, np.float32)
        batch = None
        if self.ingest:
            global_delta, batch = self._ingest_round(msgs, mask, staleness)
        else:
            global_delta = self._apply_update(msgs, mask, staleness)
        self._account(sel, msgs, global_delta, batch)
        self.round += 1

    def _account(self, sel, msgs, global_delta, batch=None):
        """Bit ledger + partial-participation sync cost of one round;
        ``batch`` is the round's encoded upstream batch where the ingest
        path already built it."""
        proto = self.protocol
        up_analytic = len(sel) * proto.upload_bits(self.numel)
        up, per_update = up_analytic, None
        if self.measure_bits:
            if batch is None:
                batch = proto.encode_wire_batch(msgs, direction="up")
            up = proto.measured_batch_bits(batch)
            per_update = self._downstream_bits(global_delta, up,
                                               np.asarray(batch.nnz))
        self._book(sel, up, up_analytic, per_update, global_delta)

    def _downstream_bits(self, global_delta, up=None, nnz_up=None):
        """Measured bits of the round's downstream message; given the
        upstream ``nnz_up`` it also logs the round's wire row."""
        down_msg = self.protocol.encode_wire(global_delta, direction="down")
        per_update = self.protocol.measured_message_bits(down_msg)
        if nnz_up is not None:
            self._log_wire_round(nnz_up, down_msg, up, per_update)
        return per_update

    def _book(self, sel, up, up_analytic, per_update, global_delta):
        """Add a round's upstream bits and the cohort ``sel``'s download
        cost through the update cache; ``per_update`` None is the analytic
        downstream message."""
        proto = self.protocol
        per_update_analytic = proto.download_bits(self.numel,
                                                  n_participating=len(sel))
        if per_update is None:
            per_update = per_update_analytic
        model_bits = 32.0 * self.numel
        self.bits_up += up
        self.bits_up_analytic += up_analytic
        skipped = self.round - self.last_seen[sel]
        self.bits_down += self.cache.sync_bits_batch(skipped, per_update,
                                                     model_bits)
        self.bits_down_analytic += self.cache.sync_bits_batch(
            skipped, per_update_analytic, model_bits)
        self.last_seen[sel] = self.round
        self.cache.push(global_delta.detach().cpu().numpy())

    def _log_wire_round(self, nnz_up, down_msg, up, per_update):
        """Per-round measured-vs-ceiling row (Eq. 13 / Eq. 15 cross-check)."""
        proto = self.protocol
        up_bound = None
        dn_bound = proto.wire_bound_bits(self.numel, down_msg.nnz, "down")
        bounds = [proto.wire_bound_bits(self.numel, int(z), "up")
                  for z in nnz_up]
        if bounds and all(b is not None for b in bounds):
            up_bound = float(sum(bounds))
        self.wire_log.append({
            "round": self.round, "bits_up": up, "bits_up_bound": up_bound,
            "bits_down_per_update": per_update,
            "bits_down_per_update_bound": dn_bound,
        })

    def _history_extra(self) -> dict:
        """Trainer-specific columns appended to every history record."""
        return {}

    @torch.no_grad()
    def evaluate(self) -> float:
        params = unflatten_pytree(self.params_vec, self.spec)
        n = len(self.test.y)
        bs = self.tcfg.eval_batch
        correct = 0
        for i in range(0, n, bs):
            x = torch.from_numpy(self.test.x[i:i + bs]).to(self.device)
            y = torch.from_numpy(self.test.y[i:i + bs].astype(np.int64)) \
                .to(self.device)
            correct += int((self.apply_fn(params, x).argmax(-1) == y).sum())
        return correct / n

    def run(self, n_rounds: int, eval_every: int = 10, verbose: bool = False):
        for r in range(n_rounds):
            self.run_round()
            if (r + 1) % eval_every == 0 or r == n_rounds - 1:
                acc = self.evaluate()
                rec = {
                    "round": self.round,
                    "iterations": self.round * self.protocol.local_iters,
                    "acc": acc,
                    "bits_up": self.bits_up,
                    "bits_down": self.bits_down,
                    "bits_up_analytic": self.bits_up_analytic,
                    "bits_down_analytic": self.bits_down_analytic,
                    "measured": self.measure_bits,
                }
                rec.update(self._history_extra())
                self.history.append(rec)
                if verbose:
                    print(f"round {self.round:5d} acc={acc:.4f} "
                          f"upMB={self.bits_up/8e6:.1f}")
        return self.history


class BufferedFederatedTrainer(FederatedTrainer):
    """Deadline-based buffered (async) aggregation -- the low-participation
    regime of the paper's §V.

    Per round a fresh cohort is dispatched (downloading the current model:
    its sync cost is accounted here, through the update cache), computes
    and encodes against the model at dispatch time, and hands its messages
    to the :class:`~repro_torch.fed.arrivals.ArrivalSimulator`.  The server
    aggregates everything that landed by this round's deadline -- on-time
    updates plus stragglers buffered from earlier rounds -- each weighted
    by the codec's staleness decay:

    * dense route: the arrivals' rows, kept on the trainer's device, in a
      buffer of ``p·ceil(kept/p)`` rows whose zero-weight padding the
      codec's masked ``aggregate`` ignores;
    * ingest route (``TrainerConfig(ingest=True)``): each arrival scatters
      into the host accumulator as it lands -- a wire codec ships its wire
      messages through the simulator and ingests each with
      ``ingest_wire`` (the ``"kernel"`` wire backend decodes it on the
      trainer's device), the others with ``ingest_dense``.

    Messages staler than ``max_staleness`` rounds are dropped; their upload
    bits are still accounted on arrival.  A round where nothing arrives
    leaves the model and the server codec state untouched and uploads zero
    bits.  ``deadline=math.inf`` makes every update punctual: the trainer
    is then the synchronous :class:`FederatedTrainer` bit for bit.
    """

    def __init__(self, model, train: Dataset, test: Dataset,
                 env: FedEnvironment, protocol: Codec,
                 tcfg: TrainerConfig = TrainerConfig(),
                 latency: Optional[LatencyModel] = None,
                 deadline: float = math.inf, max_staleness: int = 8, *,
                 device=None):
        super().__init__(model, train, test, env, protocol, tcfg,
                         device=device)
        self.deadline = float(deadline)
        self.max_staleness = int(max_staleness)
        self.sim = ArrivalSimulator(latency or LatencyModel(),
                                    n_clients=env.n_clients,
                                    deadline=deadline, seed=tcfg.seed + 2)
        self.n_dropped = 0               # arrivals past the buffer horizon
        self.arrival_log: list[dict] = []

    def run_round(self):
        proto, p = self.protocol, self.env.participants_per_round
        sel = self.rng.choice(self.env.n_clients, size=p, replace=False)
        xs, ys = self._sample_batches(sel, proto.local_iters)
        msgs = self._dispatch(sel, xs, ys)
        wire_payloads = self.ingest and proto.wire_format
        if wire_payloads:
            # the wire messages travel: what a fleet server receives
            batch = proto.encode_wire_batch(msgs, direction="up")
            payloads = [batch.message(i) for i in range(batch.n_msgs)]
        else:
            payloads = list(msgs)
        self.sim.dispatch(self.round, sel, payloads)
        arrivals = self.sim.collect(self.round)
        kept = [a for a in arrivals
                if self.round - a.sent_round <= self.max_staleness]
        dropped = len(arrivals) - len(kept)
        self.n_dropped += dropped
        staleness = np.asarray([self.round - a.sent_round for a in kept],
                               np.float32)

        if kept and self.ingest:
            w = self._participation_weights_np(
                np.ones(len(kept), np.float32), staleness)
            acc = proto.make_ingest(self.numel)
            for a, wi in zip(kept, w):
                if wire_payloads:
                    proto.ingest_wire(acc, a.payload, float(wi),
                                      direction="up", device=self.device)
                else:
                    proto.ingest_dense(acc, a.payload.cpu().numpy(),
                                       float(wi))
            global_delta = self._finalize_ingest(acc)
        elif kept:
            # a multiple of the cohort size (== p when everyone is on
            # time); zero-weight padding rows are invisible to the masked
            # aggregate
            kpad = p * math.ceil(len(kept) / p)
            buf = torch.zeros((kpad, self.numel), dtype=msgs.dtype,
                              device=self.device)
            buf[:len(kept)] = torch.stack([a.payload for a in kept])
            mask = np.zeros(kpad, np.float32)
            mask[:len(kept)] = 1.0
            stale = np.zeros(kpad, np.float32)
            stale[:len(kept)] = staleness
            global_delta = self._apply_update(buf, mask, stale)
        else:
            # nothing reached the server: params + server codec state frozen
            global_delta = torch.zeros(self.numel, dtype=torch.float32,
                                       device=self.device)

        # upstream bits are accounted when the bytes reach the server
        # (dropped stragglers included); the downstream sync cost at
        # dispatch, when the cohort pulled the current model
        up_analytic = len(arrivals) * proto.upload_bits(self.numel)
        up, per_update = up_analytic, None
        if self.measure_bits:
            if arrivals and wire_payloads:
                up = float(sum(proto.measured_message_bits(a.payload)
                               for a in arrivals))
                nnz_up = [a.payload.nnz for a in arrivals]
            elif arrivals:
                batch = proto.encode_wire_batch(
                    torch.stack([a.payload for a in arrivals]),
                    direction="up")
                up = proto.measured_batch_bits(batch)
                nnz_up = np.asarray(batch.nnz)
            else:
                up, nnz_up = 0.0, None   # no arrivals: no wire row
            per_update = self._downstream_bits(global_delta, up, nnz_up)
        self._book(sel, up, up_analytic, per_update, global_delta)
        self.arrival_log.append({
            "round": self.round, "dispatched": p, "arrived": len(arrivals),
            "aggregated": len(kept), "dropped": dropped,
            "staleness_max": int(staleness.max()) if kept else 0,
            "pending": self.sim.pending_count(),
        })
        self.round += 1

    def _history_extra(self) -> dict:
        last = self.arrival_log[-1] if self.arrival_log else {}
        return {"n_dropped": self.n_dropped,
                "pending": self.sim.pending_count(),
                "aggregated": last.get("aggregated", 0)}
