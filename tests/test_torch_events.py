"""Port parity of the event-driven server (``repro_torch.fed.events``), the
scenario library and the client samplers; twins of tests/test_events.py.

* The event clock, the event loop's traces, ``simulate_scenario``'s
  statistics, every scenario's latencies and loss masks and every
  sampler's cohorts are the reference's, byte for byte, on the same seeds
  (numpy only on both sides).
* Inside the port, ``EventDrivenTrainer`` at K = cohort is the synchronous
  ``FederatedTrainer`` bit for bit (parameters, the four ledger columns,
  ``wire_log``, the shared history columns) on the dense and the ingest
  route, under homogeneous and racing latencies; quiescence freezes the
  server; staleness drops bill bits but never aggregate; the ingest route
  agrees with the dense one to summation order.
* Against the reference's trainer (logreg from the reference's initial
  parameters, 10 clients, STC p = 1/50, K = 5 of a cohort of 10,
  concurrency 10, 8 aggregations, dense and ingest): ``event_log`` and
  ``agg_log`` identical, accuracy and the four ledger columns equal, and
  parameters within 1e-7, as tests/test_torch_fed_loop.py holds the
  synchronous trainers (``test_settings_agree_with_reference_exactly``).
"""

import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import make_protocol as ref_make_protocol
from repro.data import make_classification as ref_make_classification
from repro.fed import EventDrivenTrainer as RefEventTrainer
from repro.fed import EventLoop as RefEventLoop
from repro.fed import FedEnvironment as RefEnv
from repro.fed import LatencyModel as RefLatency
from repro.fed import TrainerConfig as RefConfig
from repro.fed import make_sampler as ref_make_sampler
from repro.fed import make_scenario as ref_make_scenario
from repro.fed import simulate_scenario as ref_simulate_scenario
from repro.fed.sampling import SamplerView as RefSamplerView
from repro.models.paper_models import MODEL_ZOO as REF_ZOO
from repro_torch.core import Codec, make_protocol
from repro_torch.data import make_classification
from repro_torch.fed import (EventClock, EventDrivenTrainer, EventLoop,
                             FederatedTrainer, FedEnvironment, LatencyModel,
                             TrainerConfig, make_fault, make_sampler,
                             make_scenario, registered_samplers,
                             registered_scenarios, simulate_scenario)
from repro_torch.fed.sampling import SamplerView
from repro_torch.fed.scenarios import Scenario, SteadyScenario
from repro_torch.models import MODEL_ZOO, params_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

LEDGER = ("bits_up", "bits_down", "bits_up_analytic", "bits_down_analytic")


@pytest.fixture(scope="module")
def data():
    return make_classification(seed=0, n=900, n_test=240)


def _env(n_clients=6, participation=0.5):
    return FedEnvironment(n_clients=n_clients, participation=participation,
                          classes_per_client=2, batch_size=10)


def _stc():
    return make_protocol("stc", sparsity_up=1 / 20, sparsity_down=1 / 20)


def _trainer(data, proto=None, env=None, cfg=None, model=None, **kw):
    return EventDrivenTrainer(model or MODEL_ZOO["logreg"], *data,
                              env or _env(),
                              proto or _stc(),
                              cfg or TrainerConfig(lr=0.05, seed=0),
                              device="cpu", **kw)


# ---------------------------------------------------------------------------
# event clock + event loop determinism
# ---------------------------------------------------------------------------


class TestEventClock:
    def test_equal_times_pop_in_push_order(self):
        clock = EventClock()
        for i, t in enumerate([2.0, 1.0, 1.0, 3.0, 1.0]):
            clock.push(t, {"i": i})      # dicts are unorderable: seq decides
        got = [(t, item["i"]) for t, _, item in
               (clock.pop() for _ in range(5))]
        assert got == [(1.0, 1), (1.0, 2), (1.0, 4), (2.0, 0), (3.0, 3)]
        assert clock.now == 3.0

    def test_rejects_bad_times_and_empty_pops(self):
        clock = EventClock()
        with pytest.raises(ValueError, match="finite"):
            clock.push(math.inf, "x")
        with pytest.raises(ValueError, match="finite"):
            clock.push(-1.0, "x")
        with pytest.raises(IndexError):
            clock.pop()
        with pytest.raises(IndexError):
            clock.peek_time()


def _trace(loop_cls, scen, seed, faults=None):
    loop = loop_cls(scen, 32, cohort=4, k_arrivals=4, concurrency=8,
                    max_staleness=1, seed=seed, faults=faults)
    rng = np.random.default_rng(123)        # sampler rng, fixed across seeds
    trace = []
    for _ in range(6):
        while not loop.ready():
            if loop.wants_dispatch:
                loop.dispatch(rng.choice(32, size=4, replace=False))
            else:
                ev = loop.step()
                trace.append((ev.kind, ev.t, ev.client, ev.staleness,
                              ev.dseq))
        loop.take_round()
    return trace, loop.stats()


def _lossy(make, latency):
    return make("regional-outage", latency=latency(
        mean=0.8, sigma=0.6, hetero=0.5, straggler_frac=0.2))


class TestEventLoopDeterminism:
    def test_same_seed_same_trace_and_the_reference_trace(self):
        a = _trace(EventLoop, _lossy(make_scenario, LatencyModel), 5)
        assert a == _trace(EventLoop, _lossy(make_scenario, LatencyModel), 5)
        assert a == _trace(RefEventLoop,
                           _lossy(ref_make_scenario, RefLatency), 5)

    def test_different_seed_different_trace(self):
        assert (_trace(EventLoop, _lossy(make_scenario, LatencyModel), 5)
                != _trace(EventLoop, _lossy(make_scenario, LatencyModel), 6))

    def test_take_round_orders_by_dispatch_sequence(self):
        scen = SteadyScenario(latency=LatencyModel(mean=1.0, sigma=1.5))
        loop = EventLoop(scen, 16, cohort=8, k_arrivals=8, concurrency=8,
                         max_staleness=0, seed=0)
        loop.dispatch(np.arange(8))
        while not loop.ready():
            loop.step()
        kept = loop.take_round()
        assert [r.dseq for r in kept] == list(range(8))
        assert loop.version == 1 and loop.buffer == []

    def test_drain_after_final_agg_does_not_deflate_rate(self):
        scen = SteadyScenario(latency=LatencyModel(mean=1.0, sigma=0.5))
        loop = EventLoop(scen, 16, cohort=4, k_arrivals=4, concurrency=8,
                         max_staleness=1, seed=0)
        loop.dispatch(np.arange(4))
        while not loop.ready():
            loop.step()
        loop.take_round()
        t_agg = loop.last_agg_t
        assert t_agg == loop.clock.now > 0.0
        rate = loop.stats()["aggs_per_time"]
        assert rate == pytest.approx(1.0 / t_agg)
        loop.dispatch(np.arange(4, 8))
        for _ in range(3):
            loop.step()
        assert loop.clock.now > t_agg and loop.version == 1
        assert loop.stats()["aggs_per_time"] == pytest.approx(rate)

    def test_loop_validates_configuration(self):
        scen = SteadyScenario()
        with pytest.raises(ValueError, match="k_arrivals"):
            EventLoop(scen, 8, cohort=2, k_arrivals=0, concurrency=4,
                      max_staleness=1)
        with pytest.raises(ValueError, match="concurrency"):
            EventLoop(scen, 8, cohort=4, k_arrivals=2, concurrency=2,
                      max_staleness=1)
        with pytest.raises(ValueError, match="max_staleness"):
            EventLoop(scen, 8, cohort=2, k_arrivals=2, concurrency=4,
                      max_staleness=-1)
        with pytest.raises(ValueError, match="cohort"):
            EventLoop(scen, 8, cohort=9, k_arrivals=2, concurrency=16,
                      max_staleness=1)


# ---------------------------------------------------------------------------
# event trainer inside the port
# ---------------------------------------------------------------------------


def _assert_same_run(sync, ev):
    assert torch.equal(sync.params_vec, ev.params_vec)
    for col in LEDGER:
        assert getattr(sync, col) == getattr(ev, col), col
    assert sync.wire_log == ev.wire_log


class TestEventDrivenTrainer:
    @pytest.mark.parametrize("name,ingest", [("stc", False), ("stc", True),
                                             ("signsgd", False),
                                             ("signsgd", True)])
    def test_k_cohort_bit_identical_to_synchronous(self, data, name, ingest):
        kw = {"stc": dict(sparsity_up=1 / 20, sparsity_down=1 / 20)}
        cfg = TrainerConfig(lr=0.05, seed=0, ingest=ingest)
        sync = FederatedTrainer(MODEL_ZOO["logreg"], *data, _env(),
                                make_protocol(name, **kw.get(name, {})), cfg,
                                device="cpu")
        sync.run(4, eval_every=2)
        ev = _trainer(data, make_protocol(name, **kw.get(name, {})), cfg=cfg,
                      scenario=SteadyScenario(latency=LatencyModel(
                          mean=3.0, sigma=0.0)))
        assert ev.ingest == ingest
        ev.run(4, eval_every=2)
        _assert_same_run(sync, ev)
        assert torch.equal(sync.server_state.residual,
                           ev.server_state.residual) if name == "stc" else 1
        for hs, hb in zip(sync.history, ev.history):
            for key in hs:
                assert hs[key] == hb[key], key
        assert ev.n_dropped == 0 and ev.n_lost == 0

    def test_k_cohort_bit_identical_under_heterogeneous_latency(self, data):
        sync = FederatedTrainer(MODEL_ZOO["logreg"], *data, _env(), _stc(),
                                TrainerConfig(lr=0.05, seed=0), device="cpu")
        sync.run(3, eval_every=3)
        ev = _trainer(data, scenario=SteadyScenario(latency=LatencyModel(
            mean=0.7, sigma=0.9, hetero=0.8)))
        ev.run(3, eval_every=3)
        _assert_same_run(sync, ev)

    def test_zero_arrival_quiescence_freezes_server(self, data):
        tr = _trainer(data)
        params0 = tr.params_vec.clone()
        res0 = tr.server_state.residual.clone()
        assert tr.advance_to(1e9) == 0
        assert tr.bits_up == 0.0 and tr.bits_down == 0.0
        assert tr.wire_log == [] and tr.agg_log == [] and tr.round == 0
        tr._dispatch_cohort()
        served = 0
        while served < tr.k_arrivals - 1:
            served += tr.advance_to(tr.loop.clock.peek_time())
        assert tr.round == 0 and len(tr.loop.buffer) == tr.k_arrivals - 1
        assert torch.equal(tr.params_vec, params0)
        assert torch.equal(tr.server_state.residual, res0)

    def test_advance_to_quiesces_under_lossy_scenario(self, data):
        for faults in (None, make_fault("duplicate", prob=0.8)):
            tr = _trainer(data, scenario="regional-outage", k_arrivals=2,
                          concurrency=4, max_staleness=2, faults=faults)
            for _ in range(3):
                tr._dispatch_cohort()
            served = tr.advance_to(1e9)
            loop = tr.loop
            assert len(loop.clock) == 0 and loop.n_inflight == 0
            assert loop.n_dispatched + loop.n_injected == served
            assert served == (loop.n_arrived + loop.n_dropped + loop.n_lost
                              + loop.n_duplicates + loop.n_quarantined)
            assert tr.advance_to(2e9) == 0
            st = loop.stats()
            assert 0.0 <= st["drop_rate"] <= 1.0
            assert 0.0 <= st["duplicate_rate"] <= 1.0

    def test_total_loss_scenario_fails_loudly(self, data):
        @dataclasses.dataclass(frozen=True)
        class BlackHole(Scenario):
            name = "black-hole-test"

            def loss_prob(self, t, ids):
                return np.ones(np.asarray(ids).size, np.float64)

        tr = _trainer(data, scenario=BlackHole())
        with pytest.raises(RuntimeError, match="starved"):
            tr.run_round()
        assert tr.n_lost > 0 and tr.bits_up == 0.0

    def test_staleness_drops_bill_bits_but_never_aggregate(self, data):
        scen = SteadyScenario(latency=LatencyModel(mean=1.0, sigma=2.0,
                                                   hetero=1.0))
        tr = _trainer(data, env=_env(n_clients=8, participation=0.25),
                      scenario=scen, k_arrivals=2, concurrency=8,
                      max_staleness=0)
        tr.run(8, eval_every=8)
        drops = [r for r in tr.event_log if r["kind"] == "drop"]
        assert tr.n_dropped == len(drops) > 0
        assert all(r["staleness"] > 0 and r["bits_up"] > 0.0 for r in drops)
        assert bool(torch.isfinite(tr.params_vec).all())
        billed = [r for r in tr.event_log if r["kind"] in ("arrival", "drop")]
        assert sum(r["aggregated"] for r in tr.agg_log) + tr.n_dropped == \
            len(billed)

    def test_event_ingest_matches_dense_aggregation(self, data):
        """From the reference's initial parameters (its test's setting):
        the fp64 ingest and the fp32 dense combine of staleness-weighted
        rows differ in last ulps, and from other parameters a near-tie at
        the server's top-k can turn that into a different selection (R8)."""
        init = jax.tree.map(np.asarray,
                            REF_ZOO["logreg"][0](jax.random.PRNGKey(0)))
        kw = dict(scenario=SteadyScenario(latency=LatencyModel(mean=0.8,
                                                               sigma=0.4)),
                  k_arrivals=3, concurrency=6, max_staleness=4,
                  model=(lambda gen: params_from_jax(init),
                         MODEL_ZOO["logreg"][1]))
        dense = _trainer(data, **kw)
        dense.run(4, eval_every=4)
        fused = _trainer(data, cfg=TrainerConfig(lr=0.05, seed=0,
                                                 ingest=True), **kw)
        fused.run(4, eval_every=4)
        torch.testing.assert_close(dense.params_vec, fused.params_vec,
                                   rtol=1e-5, atol=1e-7)
        assert dense.bits_up == pytest.approx(fused.bits_up)
        # the same events; a dense row bills the analytic size, an ingest
        # row the measured one
        assert ([{k: v for k, v in r.items() if k != "bits_up"}
                 for r in dense.event_log]
                == [{k: v for k, v in r.items() if k != "bits_up"}
                    for r in fused.event_log])
        assert dense.n_dropped == fused.n_dropped
        assert dense.n_lost == fused.n_lost

    def test_legacy_codec_without_mask_api_is_rejected(self):
        from repro_torch.core.protocols import _REGISTRY

        with pytest.raises(TypeError, match="masked aggregation API"):
            @dataclasses.dataclass(frozen=True)
            class LegacyMeanEv(Codec):
                name = "legacy-mean-events-test"

                def aggregate(self, msgs, server_state):     # pre-mask
                    return msgs, server_state, None

        assert "legacy-mean-events-test" not in _REGISTRY

    def test_the_card_is_the_default_device(self, data):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError):
            EventDrivenTrainer(MODEL_ZOO["logreg"], *data, _env(), _stc(),
                               TrainerConfig(lr=0.05, seed=0))


# ---------------------------------------------------------------------------
# against the reference's trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ingest", [False, True], ids=["dense", "ingest"])
def test_event_trainer_agrees_with_reference(ingest):
    kw = dict(n_clients=10, participation=1.0, classes_per_client=2,
              batch_size=20)
    ev_kw = dict(k_arrivals=5, concurrency=10, max_staleness=8)
    p = 1 / 50
    train, test = make_classification(seed=0, n=2000)
    ref_train, ref_test = ref_make_classification(seed=0, n=2000)
    init = jax.tree.map(np.asarray,
                        REF_ZOO["logreg"][0](jax.random.PRNGKey(0)))
    ref = RefEventTrainer(REF_ZOO["logreg"], ref_train, ref_test,
                          RefEnv(**kw),
                          ref_make_protocol("stc", sparsity_up=p,
                                            sparsity_down=p),
                          RefConfig(lr=0.05, seed=0, ingest=ingest), **ev_kw)
    h_ref = ref.run(8, eval_every=8)[-1]
    port = EventDrivenTrainer(
        (lambda gen: params_from_jax(init), MODEL_ZOO["logreg"][1]),
        train, test, FedEnvironment(**kw),
        make_protocol("stc", sparsity_up=p, sparsity_down=p,
                      wire_backend="kernel"),
        TrainerConfig(lr=0.05, seed=0, ingest=ingest), device="cpu",
        **ev_kw)
    h = port.run(8, eval_every=8)[-1]
    assert port.event_log == ref.event_log
    assert port.agg_log == ref.agg_log
    assert any(r["staleness"] > 0 for r in port.event_log
               if r["kind"] == "arrival")
    assert h["acc"] == h_ref["acc"]
    for col in LEDGER:
        assert h[col] == h_ref[col], col
    np.testing.assert_allclose(port.params_vec.numpy(),
                               np.asarray(ref.params_vec), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# scenario library
# ---------------------------------------------------------------------------


class TestScenarios:
    def test_registry_matches_the_reference_and_is_loud(self):
        assert registered_scenarios() == tuple(sorted(
            ref_make_scenario.__globals__["_REGISTRY"]))
        with pytest.raises(KeyError, match="steady"):
            make_scenario("no-such-scenario")

    @pytest.mark.parametrize("name", sorted(registered_scenarios()))
    def test_scenario_draws_byte_identical_to_reference(self, name):
        lat = dict(mean=0.9, sigma=0.7, hetero=0.5, straggler_frac=0.2)
        port = make_scenario(name, latency=LatencyModel(**lat)) \
            if name not in ("flash-outage",) else make_scenario(name)
        ref = ref_make_scenario(name, latency=RefLatency(**lat)) \
            if name not in ("flash-outage",) else ref_make_scenario(name)
        scales = port.latency.client_scales(40, seed=3)
        np.testing.assert_array_equal(
            scales, ref.latency.client_scales(40, seed=3))
        g1, g2 = np.random.default_rng(0), np.random.default_rng(0)
        ids = np.arange(40)
        for t in (0.0, 0.5, 1.7, 3.2, 9.0):
            a, b = port.sample(t, ids, scales, g1), ref.sample(t, ids,
                                                               scales, g2)
            np.testing.assert_array_equal(a[0].view(np.uint64),
                                          b[0].view(np.uint64))
            np.testing.assert_array_equal(a[1], b[1])

    @pytest.mark.parametrize("name", sorted(registered_scenarios()))
    def test_simulate_scenario_stats_equal_reference(self, name):
        kw = dict(n_clients=48, cohort=6, concurrency=12, max_staleness=2,
                  aggregations=3, seed=3)
        a = simulate_scenario(name, **kw)
        assert a == simulate_scenario(name, **kw)
        assert a == ref_simulate_scenario(name, **kw)
        assert a["aggregations"] == 3
        assert (a["arrived"] + a["dropped"] + a["lost"] + a["pending"]
                == a["dispatched"]), name
        assert a["sim_time"] > 0.0 and a["aggs_per_time"] > 0.0
        b = simulate_scenario(name, sampler="staleness", **kw)
        assert b == ref_simulate_scenario(name, sampler="staleness", **kw)

    @pytest.mark.parametrize("name", sorted(registered_scenarios()))
    def test_every_registered_scenario_trains_3_rounds(self, data, name):
        tr = _trainer(data, env=_env(n_clients=8, participation=0.25),
                      scenario=name, k_arrivals=2, concurrency=4,
                      max_staleness=3)
        hist = tr.run(3, eval_every=3)
        assert tr.round == 3 and len(hist) == 1
        assert bool(torch.isfinite(tr.params_vec).all())
        assert hist[-1]["sim_time"] > 0.0

    def test_scenario_hooks_shape_the_fleet(self):
        rng = np.random.default_rng(0)
        ids = np.arange(64)
        scales = np.ones(64)
        di = make_scenario("diurnal", latency=LatencyModel(sigma=0.0))
        lat0, _ = di.sample(0.0, ids, scales, rng)
        lat_mid, _ = di.sample(di.period / 2.0, ids, scales, rng)
        np.testing.assert_allclose(lat_mid, lat0 * (1.0 + di.amp))
        fc = make_scenario("flash-crowd", latency=LatencyModel(sigma=0.0))
        inside, _ = fc.sample(fc.start, ids, scales, rng)
        outside, _ = fc.sample(fc.start + fc.width, ids, scales, rng)
        np.testing.assert_allclose(inside, outside * fc.surge)
        ro = make_scenario("regional-outage", loss=1.0)
        _, lost = ro.sample(0.0, ids, scales, rng)
        assert set(ids[lost] % ro.regions) == {0}
        assert not ro.sample(ro.width, ids, scales, rng)[1].any()
        sd = make_scenario("straggler-drift",
                           latency=LatencyModel(sigma=0.0))
        early, _ = sd.sample(0.0, ids, scales, rng)
        late, _ = sd.sample(10.0, ids, scales, rng)
        slow = late > early * 1.5
        assert 0 < slow.sum() < ids.size
        ad = make_scenario("adaptive-deadline",
                           latency=LatencyModel(sigma=0.8))
        lats, lost = ad.sample(0.0, ids, scales, rng)
        np.testing.assert_array_equal(
            lost, lats > ad.factor * scales * ad.latency.mean)
        assert 0 < lost.sum() < ids.size

    def test_scenario_validation_is_typed(self):
        with pytest.raises(ValueError, match="period"):
            make_scenario("diurnal", period=0.0)
        with pytest.raises(ValueError, match="loss"):
            make_scenario("regional-outage", loss=1.5)
        with pytest.raises(ValueError, match="frac"):
            make_scenario("straggler-drift", frac=-0.1)
        with pytest.raises(ValueError, match="factor"):
            make_scenario("adaptive-deadline", factor=0.0)


# ---------------------------------------------------------------------------
# client sampler registry
# ---------------------------------------------------------------------------


class TestSamplers:
    def test_registry_rejects_unknown_names_loudly(self):
        with pytest.raises(KeyError, match="uniform"):
            make_sampler("no-such-sampler")
        assert set(registered_samplers()) >= {"uniform", "staleness"}

    def test_uniform_matches_synchronous_selection_exactly(self):
        view = SamplerView(0, np.zeros(20, np.int64), np.zeros(20, bool))
        got = make_sampler("uniform").select(
            np.random.default_rng(9), view, 5)
        want = np.random.default_rng(9).choice(20, size=5, replace=False)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("bias", [0.0, 1.0, 3.0])
    def test_staleness_sampler_cohorts_equal_reference(self, bias):
        rng = np.random.default_rng(5)
        g1, g2 = np.random.default_rng(1), np.random.default_rng(1)
        port = make_sampler("staleness", bias=bias)
        ref = ref_make_sampler("staleness", bias=bias)
        for rnd in range(20):
            last = rng.integers(0, rnd + 1, 30)
            inflight = rng.random(30) < 0.3
            seen = rng.random(30) < 0.7
            a = port.select(g1, SamplerView(rnd, last, inflight, seen), 6)
            b = ref.select(g2, RefSamplerView(rnd, last, inflight, seen), 6)
            np.testing.assert_array_equal(a, b)

    def test_staleness_sampler_prefers_unseen_and_skips_inflight(self):
        n = 40
        last_seen = np.zeros(n, np.int64)
        last_seen[: n // 2] = 99
        inflight = np.zeros(n, bool)
        inflight[0] = True
        view = SamplerView(100, last_seen, inflight)
        smp = make_sampler("staleness", bias=3.0)
        rng = np.random.default_rng(0)
        picks = np.concatenate([smp.select(rng, view, 8) for _ in range(40)])
        assert not (picks == 0).any()
        assert (picks >= n // 2).mean() > 0.9
        assert len(set(smp.select(rng, view, 8).tolist())) == 8

    def test_staleness_sampler_readmits_inflight_when_starved(self):
        view = SamplerView(5, np.zeros(4, np.int64), np.ones(4, bool))
        got = make_sampler("staleness").select(
            np.random.default_rng(1), view, 3)
        assert len(set(got.tolist())) == 3

    def test_staleness_sampler_never_starves_unseen_clients(self):
        n = 10
        last_seen = np.zeros(n, np.int64)
        seen = np.ones(n, bool)
        seen[-1] = False
        view = SamplerView(0, last_seen, np.zeros(n, bool), seen)
        smp = make_sampler("staleness", bias=6.0)
        rng = np.random.default_rng(3)
        picks = np.concatenate([smp.select(rng, view, 1)
                                for _ in range(200)])
        assert (picks == n - 1).mean() > 0.5

    def test_event_trainer_marks_seen_and_reaches_every_client(self, data):
        tr = _trainer(data, env=_env(n_clients=8, participation=0.25),
                      sampler=make_sampler("staleness", bias=8.0))
        tr.run(5, eval_every=5)
        assert tr.seen_mask.all()

    def test_event_trainer_runs_with_staleness_sampler(self, data):
        tr = _trainer(data, env=_env(n_clients=8, participation=0.25),
                      sampler="staleness", k_arrivals=2, concurrency=4,
                      max_staleness=3)
        tr.run(3, eval_every=3)
        assert bool(torch.isfinite(tr.params_vec).all())
