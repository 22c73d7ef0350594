"""Event-driven federated serving: aggregate on K arrivals, not on a clock.

Counterpart of the reference's ``fed/events.py``.  The deadline-buffered
trainer (:mod:`repro_torch.fed.loop`) still thinks in rounds; this module
replaces the round clock with a deterministic, seeded event queue of
in-flight updates (dispatch / arrival / drop / lost events) and a
FedBuff-style count trigger: the server aggregates the moment its buffer
holds ``k_arrivals`` updates, bumps the model version, and re-dispatches
clients (chosen by a :mod:`repro_torch.fed.sampling` sampler) as in-flight
slots free up.  The fleet is a registered :mod:`repro_torch.fed.scenarios`
scenario, and a registered :mod:`repro_torch.fed.faults` model may mangle
what travels.

Three layers:

* :class:`EventClock` -- a priority queue with a strict (time,
  push-sequence) order, so equal-time events pop in push order.
* :class:`EventLoop` -- the payload-agnostic server mechanics: in-flight
  tracking, staleness (model versions behind) drops at the buffer horizon,
  scenario latency and loss, fault injection at dispatch and admission
  control at arrival (duplicate / replay rejection keyed on ``(client,
  dispatch_version)``, the staleness screen, payload validation that
  quarantines on :class:`WireDecodeError`).  :func:`simulate_scenario`
  drives it model-free (numpy only).
* :class:`EventDrivenTrainer` -- :class:`FederatedTrainer` over the event
  loop, reusing its encode phase at dispatch, its masked aggregate (or the
  fused ingest, ``TrainerConfig(ingest=True)``) at each trigger, and its
  ledger.  With ``k_arrivals`` = cohort and the default concurrency every
  aggregation consumes exactly one dispatch cohort in dispatch order, and
  the trainer is the synchronous :class:`FederatedTrainer` bit for bit.

Payloads travel as host objects, as in the reference: at dispatch the
cohort's messages are copied to the host (numpy rows on the dense route;
on the ingest route the :class:`WireMessage` s of one wire batch, packed
where the messages lie), the fault models rewrite them there and
admission validates them (the ``"kernel"`` wire backend's validation
decodes the fields on the trainer's device).  At a dense trigger the kept
payloads fill a padded host buffer that goes to the trainer's device
once.  So the event log, the quarantine log and the ledger are the
reference's on the same seeds.

Bits bill per event when the bytes reach the server: arrivals, staleness
drops and rejected (duplicate / quarantined) arrivals count, lost updates
bill zero.  The trainer checkpoints crash-consistently every
``ckpt_every`` served events through :mod:`repro_torch.checkpoint`, and a
kill-and-resume run is bitwise an uninterrupted one.
"""

from __future__ import annotations

import heapq
import math
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.checkpoint import restore_state, save_state
from repro_torch.core.residual import ResidualState
from repro_torch.core.wire import (ChunkedWireBatch, ChunkedWireMessage,
                                   WireBatch, WireDecodeError, WireMessage)
from repro_torch.fed.environment import FedEnvironment
from repro_torch.fed.faults import CorruptPayload, FaultModel, make_fault
from repro_torch.fed.loop import FederatedTrainer, TrainerConfig
from repro_torch.fed.sampling import ClientSampler, SamplerView, make_sampler
from repro_torch.fed.scenarios import Scenario, make_scenario

__all__ = ["EventClock", "EventLoop", "EventRecord", "EventDrivenTrainer",
           "simulate_scenario"]

# Safety valve: a scenario that starves the buffer (e.g. everything lost)
# must fail loudly, not dispatch forever.
_MAX_COHORTS_PER_AGG = 256


class EventClock:
    """Deterministic priority queue of timestamped entries.

    Entries pop in ``(time, push-sequence)`` order: pushes at the SAME
    simulation time drain in push order, and payloads are never compared --
    the heap-tie-breaking invariant that makes every event trace
    reproducible from the seed alone.
    """

    def __init__(self) -> None:
        self._heap: list = []
        self._seq = 0
        self.now = 0.0          # time of the latest popped entry

    def push(self, t: float, item) -> None:
        if not (math.isfinite(t) and t >= 0.0):
            raise ValueError(f"event time must be finite and >= 0, got {t}")
        heapq.heappush(self._heap, (float(t), self._seq, item))
        self._seq += 1

    def peek_time(self) -> float:
        if not self._heap:
            raise IndexError("peek_time on an empty EventClock")
        return self._heap[0][0]

    def pop(self):
        """(time, seq, item) of the next due entry; advances ``now``."""
        if not self._heap:
            raise IndexError("pop on an empty EventClock")
        t, seq, item = heapq.heappop(self._heap)
        self.now = max(self.now, t)
        return t, seq, item

    def __len__(self) -> int:
        return len(self._heap)


class _InFlight(NamedTuple):
    """One dispatched update travelling toward the server."""

    client: int
    dseq: int           # global dispatch sequence (dispatch order)
    sent_at: float
    sent_version: int   # server model version the client encoded against
    dversion: int       # per-client dispatch version (the dedup key)
    payload: object
    lost: bool          # network loss / client-side abort: never arrives


class EventRecord(NamedTuple):
    """One served event: ``kind`` is "arrival", "drop", "lost",
    "duplicate" (an already-admitted ``(client, dispatch_version)`` key
    re-delivered) or "quarantine" (payload failed admission validation)."""

    kind: str
    t: float
    client: int
    staleness: int      # model versions behind at arrival (FedBuff measure)
    dseq: int
    sent_at: float
    sent_version: int
    payload: object


class EventLoop:
    """Payload-agnostic event-driven server mechanics.

    The caller alternates two calls until :meth:`ready`:
    :meth:`dispatch` whenever :attr:`wants_dispatch` (the in-flight pool has
    room for a full cohort), else :meth:`step` (serve the next due event).
    ``take_round()`` then consumes the buffer -- oldest dispatch first --
    and bumps the server version.  Staleness of an update is
    ``version_now - version_at_dispatch``; anything staler than
    ``max_staleness`` is dropped at arrival.  Updates flagged lost by the
    scenario occupy their in-flight slot until their would-be arrival time,
    then vanish (the server only learns by timeout).

    Admission control (``step``): a delivered update is rejected as
    "duplicate" when its ``(client, dispatch_version)`` key was already
    admitted (duplicate delivery or a stale replay of an admitted
    dispatch), then screened for staleness, then -- when a ``validator``
    is installed -- its payload is validated; a ``WireDecodeError`` there
    quarantines the message (one ``quarantine_log`` row with the typed
    reason).  ``faults`` is an optional
    :class:`repro_torch.fed.faults.FaultModel`
    applied at dispatch time: its per-dispatch decisions come from its own
    counter-based generator keyed on the dispatch sequence number, so the
    loop's latency RNG never sees the faults and a ``faults=None`` run is
    bit-identical to one with the neutral model.
    """

    def __init__(self, scenario: Scenario, n_clients: int, *, cohort: int,
                 k_arrivals: int, concurrency: int, max_staleness: int,
                 seed: int = 0, faults: Optional[FaultModel] = None,
                 validator=None) -> None:
        if k_arrivals < 1:
            raise ValueError(f"k_arrivals must be >= 1, got {k_arrivals}")
        if not 1 <= cohort <= n_clients:
            raise ValueError(f"cohort must be in [1, {n_clients}], "
                             f"got {cohort}")
        if concurrency < cohort:
            raise ValueError("concurrency must admit at least one cohort "
                             f"({cohort}), got {concurrency}")
        if max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {max_staleness}")
        self.scenario = scenario
        self.n_clients = int(n_clients)
        self.cohort = int(cohort)
        self.k_arrivals = int(k_arrivals)
        self.concurrency = int(concurrency)
        self.max_staleness = int(max_staleness)
        self.clock = EventClock()
        self.rng = np.random.default_rng(seed)          # latency/loss draws
        self.scales = scenario.latency.client_scales(n_clients, seed=seed + 1)
        self.faults = faults
        self.validator = validator
        self.version = 0                                # aggregations so far
        self.last_agg_t = 0.0                           # last take_round time
        self.buffer: List[EventRecord] = []
        self._inflight_n = np.zeros(n_clients, np.int32)
        self.n_inflight = 0
        self._dseq = 0
        # admission-control state: per-client dispatch version counter, the
        # set of already-admitted (client, dversion) keys, and each client's
        # last in-flight record (what a replay fault re-delivers)
        self._dispatch_count = np.zeros(n_clients, np.int64)
        self._seen: set = set()
        self._last_sent: dict = {}
        self.quarantine_log: List[dict] = []
        self.n_dispatched = 0
        self.n_arrived = 0
        self.n_dropped = 0
        self.n_lost = 0
        self.n_duplicates = 0
        self.n_quarantined = 0
        self.n_injected = 0         # fault-injected extra deliveries
        self.staleness_sum = 0

    # ------------------------------------------------------------- driving
    @property
    def inflight(self) -> np.ndarray:
        """(n_clients,) bool: at least one update of theirs is in the air."""
        return self._inflight_n > 0

    @property
    def wants_dispatch(self) -> bool:
        """True when the buffer still needs arrivals and the in-flight pool
        has room for one more full cohort."""
        return (len(self.buffer) < self.k_arrivals
                and self.n_inflight + self.cohort <= self.concurrency)

    def ready(self) -> bool:
        return len(self.buffer) >= self.k_arrivals

    def dispatch(self, client_ids, payloads=None):
        """File one cohort at the current simulation time.

        Latencies and loss flags come from the scenario; returns
        ``(latencies, lost)`` so the caller can log them.  ``payloads=None``
        dispatches opaque placeholders (the model-free simulator).
        """
        ids = np.asarray(client_ids, np.int64)
        if payloads is None:
            payloads = [None] * ids.size
        if len(payloads) != ids.size:
            raise ValueError(f"{ids.size} clients but {len(payloads)} "
                             "payloads")
        t = self.clock.now
        lats, lost = self.scenario.sample(t, ids, self.scales, self.rng)
        for cid, lat, lo, payload in zip(ids, lats, lost, payloads):
            dv = int(self._dispatch_count[cid])
            self._dispatch_count[cid] += 1
            fl = _InFlight(int(cid), self._dseq, t, self.version, dv,
                           payload, bool(lo))
            self._dseq += 1
            arrive = t + float(lat)
            if self.faults is not None:
                fl, arrive = self._apply_faults(fl, arrive, float(lat))
            self.clock.push(arrive, fl)
            self._inflight_n[cid] += 1
        self.n_inflight += ids.size
        self.n_dispatched += ids.size
        return lats, lost

    def _apply_faults(self, fl: _InFlight, arrive: float, lat: float):
        """One dispatch through the fault model's hooks, in fixed order
        (crash -> byzantine -> corrupt -> duplicate -> replay), all drawing
        from the model's own per-``dseq`` generator -- the loop's latency
        RNG is untouched, so the fault-free trace is preserved exactly."""
        frng = self.faults.rng(fl.dseq)
        if self.faults.crash(frng):
            fl = fl._replace(lost=True)
        if not fl.lost:
            # Byzantine rewrite first: the adversary crafts a VALID payload
            # (it must survive admission), which corruption may then mangle
            # like any honest bytes on the wire
            newp = self.faults.byzantine(fl.payload, fl.client, frng)
            if newp is not fl.payload:
                fl = fl._replace(payload=newp)
            newp = self.faults.corrupt(fl.payload, frng)
            if newp is not fl.payload:
                fl = fl._replace(payload=newp)
        if self.faults.duplicate(frng) and not fl.lost:
            # a second copy of the SAME delivery, some extra transit later
            self._inject(fl, arrive + lat * (1.0 + frng.uniform()))
        if self.faults.replay(frng):
            prev = self._last_sent.get(fl.client)
            if prev is not None:
                # a stale copy of the client's previous dispatch resurfaces
                # (even one originally lost: the network kept the bytes)
                self._inject(prev._replace(lost=False),
                             arrive + lat * (1.0 + frng.uniform()))
        self._last_sent[fl.client] = fl     # post-fault: replays re-deliver
        return fl, arrive                   # what was actually on the wire

    def _inject(self, fl: _InFlight, t: float) -> None:
        """File one fault-injected extra delivery (full in-flight
        bookkeeping, but not counted as a dispatch)."""
        self.clock.push(t, fl)
        self._inflight_n[fl.client] += 1
        self.n_inflight += 1
        self.n_injected += 1

    def step(self) -> EventRecord:
        """Serve the next due event through the admission pipeline:
        duplicate/replay rejection, staleness screen, payload validation
        (quarantine), then the buffer."""
        t, _, f = self.clock.pop()
        self.n_inflight -= 1
        self._inflight_n[f.client] -= 1
        stal = self.version - f.sent_version
        if f.lost:
            self.n_lost += 1
            return EventRecord("lost", t, f.client, stal, f.dseq, f.sent_at,
                               f.sent_version, None)
        key = (f.client, f.dversion)
        if key in self._seen:
            self.n_duplicates += 1
            return EventRecord("duplicate", t, f.client, stal, f.dseq,
                               f.sent_at, f.sent_version, f.payload)
        self._seen.add(key)     # whatever happens next, this key is spent
        if stal > self.max_staleness:
            self.n_dropped += 1
            return EventRecord("drop", t, f.client, stal, f.dseq, f.sent_at,
                               f.sent_version, f.payload)
        if self.validator is not None:
            try:
                self.validator(f.payload)
            except WireDecodeError as e:
                self.n_quarantined += 1
                self.quarantine_log.append({
                    "t": t, "client": f.client, "dseq": f.dseq,
                    "reason": str(e)})
                return EventRecord("quarantine", t, f.client, stal, f.dseq,
                                   f.sent_at, f.sent_version, f.payload)
        rec = EventRecord("arrival", t, f.client, stal, f.dseq, f.sent_at,
                          f.sent_version, f.payload)
        self.buffer.append(rec)
        self.n_arrived += 1
        self.staleness_sum += stal
        return rec

    def take_round(self) -> List[EventRecord]:
        """Consume the buffer for one aggregation and bump the version.

        Returned oldest dispatch first (global dispatch order), the same
        convention as ``ArrivalSimulator.collect`` -- with K = cohort this
        makes the aggregation batch EXACTLY the dispatch batch, whatever
        order the arrivals raced in.
        """
        if not self.buffer:
            raise RuntimeError("take_round with an empty buffer: the server "
                               "only aggregates on arrivals")
        kept = sorted(self.buffer, key=lambda r: r.dseq)
        self.buffer = []
        self.version += 1
        self.last_agg_t = self.clock.now
        return kept

    def stats(self) -> dict:
        """Counters + rates for scenario smoke stats and dry-run records.

        Every rate is guarded against its zero denominator (a run with no
        served events, or a quiescent clock, reports 0.0 rates rather than
        dividing by zero).
        """
        def _rate(num, den):
            return num / den if den > 0 else 0.0

        now = self.clock.now
        served = (self.n_arrived + self.n_dropped + self.n_lost
                  + self.n_duplicates + self.n_quarantined)
        return {
            "aggregations": self.version,
            "dispatched": self.n_dispatched,
            "arrived": self.n_arrived,
            "dropped": self.n_dropped,
            "lost": self.n_lost,
            "duplicates": self.n_duplicates,
            "quarantined": self.n_quarantined,
            "injected": self.n_injected,
            "pending": self.n_inflight,
            "sim_time": now,
            # rate against the LAST aggregation's timestamp, not the full
            # clock: post-final-aggregation quiescent drain (advance_to)
            # advances the clock without aggregating and must not deflate
            # the rate
            "aggs_per_time": _rate(self.version, self.last_agg_t),
            "drop_rate": _rate(self.n_dropped + self.n_lost, served),
            "duplicate_rate": _rate(self.n_duplicates, served),
            "quarantine_rate": _rate(self.n_quarantined, served),
            "mean_staleness": _rate(self.staleness_sum, self.n_arrived),
        }


def _placeholder_validator(payload) -> None:
    """Admission validator for the model-free simulator: its payloads are
    opaque ``None`` placeholders, so the only detectable corruption is the
    fault layer's :class:`CorruptPayload` marker."""
    if isinstance(payload, CorruptPayload):
        raise WireDecodeError("opaque payload corrupted in transit")


def simulate_scenario(scenario: Union[str, Scenario], *, n_clients: int = 256,
                      cohort: int = 16, k_arrivals: Optional[int] = None,
                      concurrency: Optional[int] = None,
                      max_staleness: int = 4, aggregations: int = 8,
                      sampler: Union[str, ClientSampler] = "uniform",
                      faults: Union[str, FaultModel, None] = None,
                      seed: int = 0) -> dict:
    """Model-free event-loop run of one scenario: numpy only, no payloads.

    Drives :class:`EventLoop` through ``aggregations`` K-arrival triggers
    with placeholder payloads and returns :meth:`EventLoop.stats` -- the
    per-scenario event statistics the dry-run records and the scenario
    smoke tests read.  ``faults`` layers a registered fault model on top
    (corrupted placeholders quarantine via the CorruptPayload marker).
    Deterministic in ``seed``.
    """
    scen = make_scenario(scenario)
    smp = make_sampler(sampler)
    fm = None if faults is None else make_fault(faults)
    k = int(k_arrivals) if k_arrivals else cohort
    conc = int(concurrency) if concurrency else max(k, cohort)
    loop = EventLoop(scen, n_clients, cohort=cohort, k_arrivals=k,
                     concurrency=conc, max_staleness=max_staleness, seed=seed,
                     faults=fm,
                     validator=None if fm is None else _placeholder_validator)
    rng = np.random.default_rng(seed + 7)               # sampler draws
    last_seen = np.zeros(n_clients, np.int64)
    seen = np.zeros(n_clients, bool)
    for _ in range(aggregations):
        cohorts = 0
        while not loop.ready():
            if loop.wants_dispatch:
                if cohorts >= _MAX_COHORTS_PER_AGG:
                    raise RuntimeError(
                        f"scenario {scen.name!r} starved the buffer: "
                        f"{cohorts} cohorts dispatched without reaching "
                        f"k_arrivals={k}")
                view = SamplerView(loop.version, last_seen, loop.inflight,
                                   seen)
                ids = np.asarray(smp.select(rng, view, cohort), np.int64)
                seen[ids] = True
                loop.dispatch(ids)
                cohorts += 1
            else:
                loop.step()
        for rec in loop.take_round():
            last_seen[rec.client] = loop.version
    return {"scenario": scen.name, **loop.stats()}


class EventDrivenTrainer(FederatedTrainer):
    """K-arrival-triggered (FedBuff-style) federated training.

    One ``run_round()`` = one aggregation: the event loop dispatches
    sampler-chosen cohorts whenever the in-flight pool has room, serves
    arrival / drop / lost events in time order, and the moment
    ``k_arrivals`` updates sit in the buffer the codec's masked
    ``aggregate`` (or the fused ingest) fires with each update weighted by
    its FedBuff staleness -- model versions behind, not rounds.  The encode
    and apply phases are the synchronous trainer's own; clients encode
    against the model at dispatch time.

    With ``k_arrivals`` = cohort size (the default) and the default
    concurrency of one cohort, every aggregation consumes exactly one
    dispatch cohort in dispatch order and the trainer is bit-identical to
    :class:`FederatedTrainer` under any scenario that loses and drops
    nothing -- parameters, measured and analytic ledgers, ``wire_log``.

    Ledger semantics (per event): upstream bits bill at arrival, at
    staleness drop and at rejection (the bytes reached the server), never
    for lost or aborted updates; the downstream ``UpdateCache`` sync cost
    bills per dispatched cohort at the next aggregation's measured
    per-update size.  ``event_log`` has one row per event, ``agg_log`` one
    per aggregation.  Runs on CUDA unless given ``device="cpu"``.
    """

    def __init__(self, model, train, test, env: FedEnvironment, protocol,
                 tcfg: TrainerConfig = TrainerConfig(),
                 scenario: Union[str, Scenario] = "steady",
                 sampler: Union[str, ClientSampler] = "uniform",
                 k_arrivals: Optional[int] = None,
                 concurrency: Optional[int] = None, max_staleness: int = 8,
                 faults: Union[str, FaultModel, None] = None,
                 ckpt_path: Optional[str] = None, ckpt_every: int = 0, *,
                 device=None):
        super().__init__(model, train, test, env, protocol, tcfg,
                         device=device)
        self.scenario = make_scenario(scenario)
        self.sampler = make_sampler(sampler)
        self.faults = None if faults is None else make_fault(faults)
        self.ckpt_path = ckpt_path
        self.ckpt_every = int(ckpt_every)
        p = env.participants_per_round
        self.k_arrivals = int(k_arrivals) if k_arrivals else p
        self.concurrency = (int(concurrency) if concurrency
                            else max(self.k_arrivals, p))
        self.max_staleness = int(max_staleness)
        self._wire_payloads = self.ingest and self.protocol.wire_format
        self.loop = EventLoop(self.scenario, env.n_clients, cohort=p,
                              k_arrivals=self.k_arrivals,
                              concurrency=self.concurrency,
                              max_staleness=self.max_staleness,
                              seed=tcfg.seed + 2, faults=self.faults,
                              validator=self._validate_payload)
        self.n_dropped = 0
        self.n_lost = 0
        self.n_events_served = 0
        self.event_log: list[dict] = []
        self.agg_log: list[dict] = []
        self._billed: list[EventRecord] = []    # reached server, unledgered
        self._pending_down: list[np.ndarray] = []   # cohorts since last agg
        # rejected (duplicate / quarantined) arrivals: bits bill at the next
        # flush, but their payloads never join the aggregation buffer
        self._rejected_bits = 0.0
        self._rejected_n = 0

    # ----------------------------------------------------------- event side
    def _dispatch_cohort(self) -> None:
        """Sampler-chosen cohort: local SGD and the encode against the
        current model, the payloads to the host, then into the queue."""
        p = self.env.participants_per_round
        view = SamplerView(self.round, self.last_seen, self.loop.inflight,
                           self.seen_mask)
        sel = np.asarray(self.sampler.select(self.rng, view, p), np.int64)
        self.seen_mask[sel] = True
        xs, ys = self._sample_batches(sel, self.protocol.local_iters)
        msgs = self._dispatch(sel, xs, ys)
        _, lost = self.loop.dispatch(sel, self._host_payloads(msgs))
        self._pending_down.append(sel)
        self.event_log.append({
            "kind": "dispatch", "t": self.loop.clock.now,
            "version": self.round,
            "clients": int(sel.size), "lost_in_flight": int(lost.sum())})

    def _host_payloads(self, msgs) -> list:
        """The cohort's messages as host payloads: on the ingest route the
        wire messages of one ``encode_wire_batch`` (packed where the
        messages lie), else numpy rows."""
        if self._wire_payloads:
            batch = self.protocol.encode_wire_batch(msgs, direction="up")
            return [batch.message(i) for i in range(batch.n_msgs)]
        return list(msgs.detach().cpu().numpy())

    def _validate_payload(self, payload) -> None:
        """Admission validation of one delivered payload; raises
        :class:`WireDecodeError` on every detectable corruption class (a
        wire payload through the codec's ``validate_wire`` on the trainer's
        device)."""
        if isinstance(payload, CorruptPayload):
            raise WireDecodeError("opaque payload corrupted in transit")
        if self._wire_payloads:
            self.protocol.validate_wire(payload, direction="up",
                                        device=self.device)
            return
        v = np.asarray(payload)
        if v.size != self.numel:
            raise WireDecodeError(
                f"dense payload has {v.size} elements, expected "
                f"{self.numel}")
        if not np.all(np.isfinite(v)):
            raise WireDecodeError("dense payload has non-finite values")

    def _record_event(self, ev: EventRecord) -> None:
        proto = self.protocol
        row = {"kind": ev.kind, "t": ev.t, "client": ev.client,
               "staleness": ev.staleness, "version": self.round}
        if ev.kind == "lost":
            self.n_lost += 1
            row["bits_up"] = 0.0        # the bytes never reached the server
        elif ev.kind in ("duplicate", "quarantine"):
            # rejected at admission: the bytes reached the server, so the
            # upstream bits bill -- but the payload never aggregates (and a
            # corrupt / duplicate stream must not enter the wire log or the
            # dense re-encode stack), so it is ledgered apart
            if (self._wire_payloads and self.measure_bits
                    and not isinstance(ev.payload, CorruptPayload)):
                bits = float(proto.measured_message_bits(ev.payload))
            else:
                bits = proto.upload_bits(self.numel)
            self._rejected_bits += bits
            self._rejected_n += 1
            row["bits_up"] = bits
        else:
            self._billed.append(ev)
            if ev.kind == "drop":
                self.n_dropped += 1
            # exact per-event bits when the payload is the wire stream;
            # dense rounds measure the batch at the aggregation flush
            # (identical totals) and bill the analytic size per event here
            row["bits_up"] = (proto.measured_message_bits(ev.payload)
                              if self._wire_payloads and self.measure_bits
                              else proto.upload_bits(self.numel))
        self.event_log.append(row)

    def _serve_one(self) -> None:
        """Serve ONE event: the fault model's kill check (before serving,
        so the last checkpoint is a consistent boundary), the admission
        pipeline, then the periodic crash-consistency checkpoint."""
        if self.faults is not None:
            self.faults.kill_check(self.n_events_served)
        self._record_event(self.loop.step())
        self.n_events_served += 1
        if (self.ckpt_path and self.ckpt_every
                and self.n_events_served % self.ckpt_every == 0):
            self.save_checkpoint(self.ckpt_path)

    # ------------------------------------------------------------ round API
    def run_round(self):
        """Advance the event loop to the next K-arrival aggregation."""
        loop = self.loop
        cohorts = 0
        while not loop.ready():
            if loop.wants_dispatch:
                if cohorts >= _MAX_COHORTS_PER_AGG:
                    raise RuntimeError(
                        f"scenario {self.scenario.name!r} starved the "
                        f"buffer: {cohorts} cohorts dispatched without "
                        f"reaching k_arrivals={self.k_arrivals}")
                self._dispatch_cohort()
                cohorts += 1
            else:
                self._serve_one()
        self._aggregate_round()

    def advance_to(self, t: float) -> int:
        """Serve every event due by simulation time ``t`` without
        dispatching; aggregations still trigger whenever the buffer fills.
        Zero due events -- quiescence -- leaves parameters, codec state and
        every ledger untouched.  Returns the number of events served."""
        served = 0
        while len(self.loop.clock) and self.loop.clock.peek_time() <= t:
            self._serve_one()
            served += 1
            if self.loop.ready():
                self._aggregate_round()
        return served

    # ---------------------------------------------------------- aggregation
    def _aggregate_round(self) -> None:
        kept = self.loop.take_round()       # oldest dispatch first
        staleness = np.asarray([r.staleness for r in kept], np.float32)
        if self.ingest:
            gd = self._ingest_kept(kept, staleness)
        else:
            gd = self._combine_kept(kept, staleness)
        self._flush_ledger(kept, staleness, gd)
        self.round += 1

    def _ingest_kept(self, kept, staleness) -> torch.Tensor:
        """The fused ingest of the kept arrivals, in dispatch order: each
        scatters into the host accumulator (a wire payload decoded on the
        trainer's device); returns the applied global delta."""
        proto = self.protocol
        w = self._participation_weights_np(np.ones(len(kept), np.float32),
                                           staleness)
        acc = proto.make_ingest(self.numel)
        for r, wi in zip(kept, w):
            if self._wire_payloads:
                proto.ingest_wire(acc, r.payload, float(wi), direction="up",
                                  device=self.device)
            else:
                proto.ingest_dense(acc, np.asarray(r.payload), float(wi))
        return self._finalize_ingest(acc)

    def _combine_kept(self, kept, staleness) -> torch.Tensor:
        """The dense aggregate of the kept arrivals: a host buffer padded to
        a multiple of the cohort (== p in the K = cohort configuration;
        zero-weight padding rows are invisible to the masked aggregate),
        sent to the trainer's device once."""
        p = self.env.participants_per_round
        kpad = p * math.ceil(len(kept) / p)
        buf = np.zeros((kpad, self.numel), np.float32)
        mask = np.zeros(kpad, np.float32)
        stale = np.zeros(kpad, np.float32)
        for i, r in enumerate(kept):
            buf[i] = np.asarray(r.payload)
            mask[i] = 1.0
        stale[:len(kept)] = staleness
        return self._apply_update(torch.from_numpy(buf).to(self.device),
                                  mask, stale)

    def _flush_ledger(self, kept, staleness, gd) -> None:
        """Bill everything that reached the server since the last
        aggregation: admitted payloads (arrivals and staleness drops, in
        ``_billed``) and rejected ones (their bits only); then the
        downstream sync cost of every cohort dispatched since, and the
        aggregation's ``agg_log`` row."""
        proto = self.protocol
        p = self.env.participants_per_round
        billed, self._billed = self._billed, []
        rej_bits, self._rejected_bits = self._rejected_bits, 0.0
        rej_n, self._rejected_n = self._rejected_n, 0
        up_analytic = (len(billed) + rej_n) * proto.upload_bits(self.numel)
        per_update_analytic = proto.download_bits(self.numel,
                                                  n_participating=p)
        model_bits = 32.0 * self.numel
        if self.measure_bits and billed and self._wire_payloads:
            up = float(sum(proto.measured_message_bits(r.payload)
                           for r in billed)) + rej_bits
            per_update = self._downstream_bits(
                gd, up - rej_bits, [r.payload.nnz for r in billed])
        elif self.measure_bits and billed:
            arr = np.stack([np.asarray(r.payload) for r in billed])
            batch = proto.encode_wire_batch(arr, direction="up",
                                            device=self.device)
            up = proto.measured_batch_bits(batch) + rej_bits
            per_update = self._downstream_bits(gd, up - rej_bits,
                                               np.asarray(batch.nnz))
        elif self.measure_bits:
            up = rej_bits
            per_update = self._downstream_bits(gd)
        else:
            up, per_update = up_analytic, per_update_analytic
        self.bits_up += up
        self.bits_up_analytic += up_analytic
        # downstream sync cost per dispatched cohort, in dispatch order --
        # cohorts may repeat a client, so last_seen commits between cohorts
        for sel in self._pending_down:
            skipped = self.round - self.last_seen[sel]
            self.bits_down += self.cache.sync_bits_batch(
                skipped, per_update, model_bits)
            self.bits_down_analytic += self.cache.sync_bits_batch(
                skipped, per_update_analytic, model_bits)
            self.last_seen[sel] = self.round
        self._pending_down = []
        self.cache.push(gd.detach().cpu().numpy())
        stats = self.loop.stats()
        self.agg_log.append({
            "agg": self.loop.version, "t": self.loop.clock.now,
            "aggregated": len(kept), "billed": len(billed) + rej_n,
            "staleness_max": int(staleness.max(initial=0.0)),
            "dropped_total": self.n_dropped, "lost_total": self.n_lost,
            "quarantined_total": stats["quarantined"],
            "duplicates_total": stats["duplicates"],
            "pending": stats["pending"],
        })

    def _history_extra(self) -> dict:
        now = self.loop.clock.now
        last = self.agg_log[-1] if self.agg_log else {}
        last_agg = self.loop.last_agg_t      # drain must not deflate the rate
        return {"n_dropped": self.n_dropped, "n_lost": self.n_lost,
                "n_quarantined": self.loop.n_quarantined,
                "n_duplicates": self.loop.n_duplicates,
                "sim_time": now,
                "aggs_per_time": (self.round / last_agg
                                  if last_agg > 0 else 0.0),
                "pending": self.loop.n_inflight,
                "aggregated": last.get("aggregated", 0)}

    # ------------------------------------------------ crash-consistent resume
    def save_checkpoint(self, path: str) -> None:
        """Write every mutable piece of the trainer and the event loop
        (model, per-client states, RNG streams, the event clock with its
        in-flight payloads, admission state, ledgers, logs) so that a fresh,
        identically configured trainer resumes bit-identically mid-round.
        Written atomically, so a kill during the write leaves the previous
        checkpoint intact."""
        loop = self.loop
        save_state(path, {
            "base": self._base_state(),
            "loop": {
                "heap": list(loop.clock._heap),
                "clock_seq": loop.clock._seq,
                "now": loop.clock.now,
                "rng": loop.rng.bit_generator.state,
                "version": loop.version,
                "last_agg_t": loop.last_agg_t,
                "buffer": list(loop.buffer),
                "inflight_n": loop._inflight_n.copy(),
                "n_inflight": loop.n_inflight,
                "dseq": loop._dseq,
                "dispatch_count": loop._dispatch_count.copy(),
                "seen": loop._seen,
                "last_sent": loop._last_sent,
                "quarantine_log": list(loop.quarantine_log),
                "counters": [loop.n_dispatched, loop.n_arrived,
                             loop.n_dropped, loop.n_lost, loop.n_duplicates,
                             loop.n_quarantined, loop.n_injected,
                             loop.staleness_sum],
            },
            "trainer": {
                "n_dropped": self.n_dropped,
                "n_lost": self.n_lost,
                "n_events_served": self.n_events_served,
                "event_log": list(self.event_log),
                "agg_log": list(self.agg_log),
                "billed": list(self._billed),
                "pending_down": [np.asarray(s) for s in self._pending_down],
                "rejected": [self._rejected_bits, self._rejected_n],
            },
        })

    def restore_checkpoint(self, path: str) -> None:
        """Inverse of :meth:`save_checkpoint` into an identically configured
        trainer (same model, environment, protocol, scenario, sampler and
        seed; the fault model may differ -- resume a killed run with
        ``faults="none"``).  Host state is restored as saved; the trainer's
        tensors go to its device once (``_load_base_state``)."""
        st = restore_state(path, classes=_CKPT_CLASSES)
        self._load_base_state(st["base"])
        ls = st["loop"]
        loop = self.loop
        loop.clock._heap = list(ls["heap"])     # heap order is preserved
        loop.clock._seq = int(ls["clock_seq"])
        loop.clock.now = float(ls["now"])
        loop.rng.bit_generator.state = ls["rng"]
        loop.version = int(ls["version"])
        loop.last_agg_t = float(ls["last_agg_t"])
        loop.buffer = list(ls["buffer"])
        loop._inflight_n = np.asarray(ls["inflight_n"], np.int32).copy()
        loop.n_inflight = int(ls["n_inflight"])
        loop._dseq = int(ls["dseq"])
        loop._dispatch_count = np.asarray(ls["dispatch_count"],
                                          np.int64).copy()
        loop._seen = set(ls["seen"])
        loop._last_sent = dict(ls["last_sent"])
        loop.quarantine_log = list(ls["quarantine_log"])
        (loop.n_dispatched, loop.n_arrived, loop.n_dropped, loop.n_lost,
         loop.n_duplicates, loop.n_quarantined, loop.n_injected,
         loop.staleness_sum) = [int(c) for c in ls["counters"]]
        tr = st["trainer"]
        self.n_dropped = int(tr["n_dropped"])
        self.n_lost = int(tr["n_lost"])
        self.n_events_served = int(tr["n_events_served"])
        self.event_log = list(tr["event_log"])
        self.agg_log = list(tr["agg_log"])
        self._billed = list(tr["billed"])
        self._pending_down = [np.asarray(s, np.int64)
                              for s in tr["pending_down"]]
        self._rejected_bits = float(tr["rejected"][0])
        self._rejected_n = int(tr["rejected"][1])


# NamedTuple classes the tagged checkpoint must be able to rebuild (payloads
# in the clock, buffer and billed lists; codec residual states).
_CKPT_CLASSES = {c.__name__: c for c in (
    _InFlight, EventRecord, WireMessage, WireBatch, ChunkedWireBatch,
    ChunkedWireMessage, CorruptPayload, ResidualState)}
