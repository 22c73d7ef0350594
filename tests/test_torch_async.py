"""Port parity of the buffered (async) trainer and its arrival simulator.

* ``fed/arrivals.py`` is the reference's numpy code: latencies, client
  scales, deadline bucketing and the collect order are byte-identical on
  the same seeds and dispatches.
* Inside the port, ``deadline=inf`` is the synchronous trainer bit for bit
  (parameters, both ledgers, the wire log, every shared history column)
  for all six codecs on the dense route, and for the ingest codecs with
  ``TrainerConfig(ingest=True)``.
* A round where nothing arrives freezes the parameters and the server
  state; updates staler than the horizon are dropped, their bits billed.
* Against the reference with a finite deadline and stragglers (logreg, 10
  rounds, from the reference's initial parameters), on the dense and the
  ingest route: ``arrival_log``, accuracy and the four ledger columns
  equal, parameters within 1e-7 (as the synchronous parity tests), for
  every codec but STC; STC keeps the schedule and the analytic columns
  and stays within the sync trainers' limits (R8, ROADMAP Queue 3).  The
  staleness-weighted mean itself is the reference's bit for bit.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_protocol as ref_make_protocol
from repro.data import make_classification as ref_make_classification
from repro.fed import ArrivalSimulator as RefSimulator
from repro.fed import BufferedFederatedTrainer as RefBuffered
from repro.fed import FedEnvironment as RefEnv
from repro.fed import LatencyModel as RefLatency
from repro.fed import TrainerConfig as RefConfig
from repro.models.paper_models import MODEL_ZOO as REF_ZOO
from repro_torch.core import make_protocol
from repro_torch.data import make_classification
from repro_torch.fed import (ArrivalSimulator, BufferedFederatedTrainer,
                             FedEnvironment, FederatedTrainer, LatencyModel,
                             TrainerConfig)
from repro_torch.models import MODEL_ZOO, params_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

KW = {"stc": dict(sparsity_up=1 / 20, sparsity_down=1 / 20),
      "topk": dict(sparsity_up=1 / 20), "fedavg": dict(local_iters=2)}
NAMES = ["baseline", "fedavg", "signsgd", "topk", "stc", "ternquant"]
LEDGER = ("bits_up", "bits_down", "bits_up_analytic", "bits_down_analytic")
LOSSY = dict(mean=1.2, sigma=0.6, hetero=0.5, straggler_frac=0.2,
             straggler_scale=4.0)


# -------------------------------------------------------------- arrivals

@pytest.mark.parametrize("lat,deadline", [
    ({}, math.inf), ({}, 0.4), (LOSSY, 1.0),
    (dict(mean=0.3, sigma=0.0), 0.1),         # exact multiples snap
    (dict(mean=2.0, sigma=1.5, hetero=1.0), 0.7)])
def test_arrivals_byte_identical_to_reference(lat, deadline):
    sims = [cls(lat_cls(**lat), n_clients=12, deadline=deadline, seed=5)
            for cls, lat_cls in ((ArrivalSimulator, LatencyModel),
                                 (RefSimulator, RefLatency))]
    np.testing.assert_array_equal(sims[0].scales.view(np.uint64),
                                  sims[1].scales.view(np.uint64))
    cohorts = np.random.default_rng(0)
    for rnd in range(12):
        ids = cohorts.choice(12, size=5, replace=False)
        payloads = [f"{rnd}:{c}" for c in ids]
        lats = [sim.dispatch(rnd, ids, payloads) for sim in sims]
        np.testing.assert_array_equal(lats[0].view(np.uint64),
                                      lats[1].view(np.uint64))
        got, want = (sim.collect(rnd) for sim in sims)
        assert [tuple(a) for a in got] == [tuple(a) for a in want]
        assert sims[0].pending_count() == sims[1].pending_count()
    np.testing.assert_array_equal(
        sims[0].rounds_late(np.array([0.3, 0.7, 1.0, 2.1])),
        sims[1].rounds_late(np.array([0.3, 0.7, 1.0, 2.1])))


@pytest.mark.parametrize("kw", [dict(mean=0.0), dict(sigma=-1.0),
                                dict(hetero=-0.1), dict(straggler_frac=1.5),
                                dict(straggler_scale=0.0)])
def test_latency_model_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        RefLatency(**kw)
    with pytest.raises(ValueError, match=next(iter(kw))):
        LatencyModel(**kw)


def test_simulator_rejects_bad_deadline_and_mismatched_payloads():
    with pytest.raises(ValueError, match="deadline"):
        ArrivalSimulator(LatencyModel(), n_clients=2, deadline=0.0)
    sim = ArrivalSimulator(LatencyModel(), n_clients=2)
    with pytest.raises(ValueError, match="payloads"):
        sim.dispatch(0, [0, 1], ["only-one"])


# ------------------------------------------------ inside the port: sync

def _parts():
    train, test = make_classification(seed=0, n=900, n_test=240)
    env = FedEnvironment(n_clients=6, participation=0.5,
                         classes_per_client=2, batch_size=10)
    return train, test, env


def _codec(name, **kw):
    return make_protocol(name, **{**KW.get(name, {}), **kw})


@pytest.mark.parametrize("name,ingest", [(n, False) for n in NAMES] + [
    ("stc", True), ("signsgd", True), ("ternquant", True)])
def test_deadline_inf_bit_identical_to_synchronous(name, ingest):
    train, test, env = _parts()
    cfg = TrainerConfig(lr=0.05, seed=0, ingest=ingest)
    sync = FederatedTrainer(MODEL_ZOO["logreg"], train, test, env,
                            _codec(name), cfg, device="cpu")
    buf = BufferedFederatedTrainer(
        MODEL_ZOO["logreg"], train, test, env, _codec(name), cfg,
        latency=LatencyModel(mean=3.0, sigma=1.0), deadline=math.inf,
        device="cpu")
    assert sync.ingest == buf.ingest == ingest
    sync.run(4, eval_every=2)
    buf.run(4, eval_every=2)
    assert torch.equal(sync.params_vec, buf.params_vec)
    if sync.server_state is not None:
        assert torch.equal(sync.server_state.residual,
                           buf.server_state.residual)
    for col in LEDGER:
        assert getattr(sync, col) == getattr(buf, col), col
    assert sync.wire_log == buf.wire_log
    for hs, hb in zip(sync.history, buf.history):
        for key in hs:
            assert hs[key] == hb[key], key
        assert hb["n_dropped"] == 0 and hb["aggregated"] == 3
    assert all(row["arrived"] == row["aggregated"] == 3
               for row in buf.arrival_log)


@pytest.mark.parametrize("ingest", [False, True])
def test_zero_arrival_round_freezes_server(ingest):
    train, test, env = _parts()
    tr = BufferedFederatedTrainer(
        MODEL_ZOO["logreg"], train, test, env, _codec("stc"),
        TrainerConfig(lr=0.05, seed=0, ingest=ingest),
        latency=LatencyModel(mean=50.0, sigma=0.0), deadline=1.0,
        max_staleness=100, device="cpu")
    params0 = tr.params_vec.clone()
    res0 = tr.server_state.residual.clone()
    tr.run_round()
    assert tr.bits_up == 0.0 and tr.bits_up_analytic == 0.0
    assert tr.wire_log == []
    assert torch.equal(tr.params_vec, params0)
    assert torch.equal(tr.server_state.residual, res0)
    assert tr.sim.pending_count() == env.participants_per_round
    assert tr.arrival_log[-1]["arrived"] == 0
    assert tr.bits_down > 0.0               # the cohort still downloaded


@pytest.mark.parametrize("ingest", [False, True])
def test_staleness_beyond_horizon_is_dropped(ingest):
    train, test, env = _parts()

    def run(horizon):
        tr = BufferedFederatedTrainer(
            MODEL_ZOO["logreg"], train, test, env, _codec("stc"),
            TrainerConfig(lr=0.05, seed=0, ingest=ingest),
            latency=LatencyModel(mean=1.5, sigma=0.0), deadline=1.0,
            max_staleness=horizon, device="cpu")
        params0 = tr.params_vec.clone()
        tr.run(3, eval_every=3)
        return tr, params0

    tr, params0 = run(0)
    assert tr.n_dropped == 2 * env.participants_per_round
    assert torch.equal(tr.params_vec, params0)
    assert tr.bits_up > 0.0                 # dropped arrivals still uploaded
    assert tr.history[-1]["n_dropped"] == tr.n_dropped
    tr2, params0 = run(1)
    assert tr2.n_dropped == 0
    assert not torch.equal(tr2.params_vec, params0)
    assert tr2.arrival_log[-1]["staleness_max"] == 1
    assert tr2.bits_up == tr.bits_up


# ------------------------------------------ against the reference: finite

def _both_buffered(name, ingest, rounds=10):
    kw = dict(n_clients=10, participation=0.5, classes_per_client=2,
              batch_size=20)
    train, test = make_classification(seed=0, n=2000)
    ref_train, ref_test = ref_make_classification(seed=0, n=2000)
    init = jax.tree.map(np.asarray,
                        REF_ZOO["logreg"][0](jax.random.PRNGKey(0)))
    ref = RefBuffered(REF_ZOO["logreg"], ref_train, ref_test, RefEnv(**kw),
                      ref_make_protocol(name, **KW.get(name, {})),
                      RefConfig(lr=0.05, ingest=ingest),
                      latency=RefLatency(**LOSSY), deadline=1.0,
                      max_staleness=2)
    h_ref = ref.run(rounds, eval_every=rounds)[-1]
    port = BufferedFederatedTrainer(
        (lambda gen: params_from_jax(init), MODEL_ZOO["logreg"][1]),
        train, test, FedEnvironment(**kw), _codec(name),
        TrainerConfig(lr=0.05, ingest=ingest), latency=LatencyModel(**LOSSY),
        deadline=1.0, max_staleness=2, device="cpu")
    return ref, port, h_ref, port.run(rounds, eval_every=rounds)[-1]


def _same_schedule(ref, port, h_ref, h):
    assert port.arrival_log == ref.arrival_log
    log = port.arrival_log
    assert any(r["aggregated"] < r["arrived"] for r in log)   # drops
    assert any(r["staleness_max"] > 0 for r in log)           # stragglers
    for col in ("bits_up_analytic", "bits_down_analytic", "n_dropped",
                "pending", "aggregated"):
        assert h[col] == h_ref[col], col


@pytest.mark.parametrize("name,ingest", [
    ("baseline", False), ("fedavg", False), ("signsgd", False),
    ("topk", False), ("ternquant", False), ("ternquant", True),
    ("signsgd", True)])
def test_finite_deadline_matches_reference(name, ingest):
    ref, port, h_ref, h = _both_buffered(name, ingest)
    _same_schedule(ref, port, h_ref, h)
    assert h["acc"] == h_ref["acc"]
    for col in LEDGER:
        assert h[col] == h_ref[col], col
    np.testing.assert_allclose(port.params_vec.numpy(),
                               np.asarray(ref.params_vec), rtol=0, atol=1e-7)


@pytest.mark.parametrize("ingest", [False, True])
def test_finite_deadline_stc_holds_what_holds(ingest):
    """R8 (ROADMAP Queue 3): STC's µ differs from the reference's in the
    last ulp (the selection routes reduce in other orders), and under
    staleness weights the server's top-k of the weighted mean then meets
    near-ties that the ulp decides, so a selected coordinate can differ
    from the second stale round on.  The schedule, the analytic columns
    and the first round's wire row are equal; accuracy is within 0.03 and
    the measured bits within 2 %, the sync trainers' limits."""
    ref, port, h_ref, h = _both_buffered("stc", ingest)
    _same_schedule(ref, port, h_ref, h)
    assert port.wire_log[0] == ref.wire_log[0]
    assert len(port.wire_log) == len(ref.wire_log)
    assert abs(h["acc"] - h_ref["acc"]) <= 0.03
    for col in ("bits_up", "bits_down"):
        assert abs(h[col] / h_ref[col] - 1) <= 0.02, col


def test_stale_weighted_combine_bitwise_reference():
    """The staleness-weighted mean of the same messages is the reference's
    bit for bit: the weight mass is summed in arrival order, one fp32 add
    at a time, as XLA sums a cohort-sized vector."""
    rng = np.random.default_rng(0)
    msgs = (rng.standard_normal((10, 5000))
            * (rng.random((10, 5000)) < 0.05)).astype(np.float32)
    mask = np.float32([1, 1, 1, 1, 1, 1, 0, 0, 0, 0])
    stale = np.float32([2, 1, 1, 0, 0, 0, 0, 0, 0, 0])
    want = np.asarray(ref_make_protocol("stc").combine(
        jnp.asarray(msgs), jnp.asarray(mask), jnp.asarray(stale)))
    got = make_protocol("stc").combine(
        torch.from_numpy(msgs), torch.from_numpy(mask),
        torch.from_numpy(stale)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
