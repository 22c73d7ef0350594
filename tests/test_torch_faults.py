"""Port parity of the fault layer and the server's hardening
(``repro_torch.fed.faults`` / ``events``); twins of tests/test_faults.py.

* Every fault decision and every corrupted payload is the reference's,
  byte for byte, from the same seeds; ``simulate_scenario`` under every
  fault gives the reference's statistics; a no-fault run is bitwise
  ``faults=None``.
* Wire fuzz: the port's ternary decoder (the ``"numpy"`` backend and the
  ``"kernel"`` backend's plain version, which the CPU runs) raises
  ``WireDecodeError`` on exactly the mutations on which the reference's
  raises, and decodes the others to the reference's fields.  (The CUDA
  decoder is held to its plain version on the same streams in
  tests/test_torch_cuda_kernels.py.)
* Admission control, quarantine billing and kill-and-resume hold inside the
  port: a resumed run is bitwise an uninterrupted one (parameters, the
  four ledger columns, event, aggregation, wire and quarantine logs), and
  under a truncating fault from the reference's initial parameters the
  event and quarantine logs are the reference's.
* Norm screening: clip and reject on the streaming ingest agree with the
  combine oracle, the wire-norm screen rejects an outlier STC message, a
  screened wire batch is bitwise its per-message dense oracle and the
  reference's accumulator, and with no screen the combine is bitwise the
  reference's ``jnp.mean``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_protocol as ref_make_protocol
from repro.core import wire as ref_wire
from repro.core.aggregation import \
    NormScreenedMeanRule as RefNormScreenedMeanRule
from repro.data import make_classification as ref_make_classification
from repro.fed import EventDrivenTrainer as RefEventTrainer
from repro.fed import FedEnvironment as RefEnv
from repro.fed import TrainerConfig as RefConfig
from repro.fed import make_fault as ref_make_fault
from repro.fed import registered_faults as ref_registered_faults
from repro.fed import simulate_scenario as ref_simulate_scenario
from repro.models.paper_models import MODEL_ZOO as REF_ZOO
from repro_torch.core import NormScreenedMeanRule, make_protocol
from repro_torch.core import wire
from repro_torch.core.wire import WireDecodeError
from repro_torch.data import make_classification
from repro_torch.fed import (EventDrivenTrainer, EventLoop, FedEnvironment,
                             ServerKilled, TrainerConfig, make_fault,
                             registered_faults, simulate_scenario)
from repro_torch.fed.faults import BitFlipFault, CorruptPayload, \
    DuplicateFault
from repro_torch.fed.scenarios import (ComposedScenario, FlashCrowdScenario,
                                       RegionalOutageScenario,
                                       SteadyScenario, make_scenario)
from repro_torch.models import MODEL_ZOO, params_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    return make_classification(seed=0, n=900, n_test=240)


def _env(n_clients=8, participation=0.25):
    return FedEnvironment(n_clients=n_clients, participation=participation,
                          classes_per_client=2, batch_size=10)


def _proto(protocol):
    return (make_protocol("stc", sparsity_up=1 / 20, sparsity_down=1 / 20)
            if protocol == "stc" else make_protocol(protocol))


_EV_KW = dict(scenario="flash-outage", k_arrivals=2, concurrency=4,
              max_staleness=3)


def _trainer(data, protocol="stc", *, ingest=True, faults=None, model=None,
             **kw):
    return EventDrivenTrainer(
        model or MODEL_ZOO["logreg"], *data, _env(), _proto(protocol),
        TrainerConfig(seed=0, ingest=ingest), faults=faults, device="cpu",
        **_EV_KW, **kw)


# ---------------------------------------------------------------------------
# fault registry + per-class determinism
# ---------------------------------------------------------------------------


class TestFaultRegistry:
    def test_all_classes_registered_as_in_the_reference(self):
        assert registered_faults() == ref_registered_faults()
        assert set(registered_faults()) >= {
            "none", "bit-flip", "truncate", "duplicate", "replay",
            "client-crash", "server-kill"}

    def test_unknown_fault_is_loud(self):
        with pytest.raises(KeyError, match="unknown fault"):
            make_fault("nope")

    def test_typed_validation(self):
        with pytest.raises(ValueError, match="prob"):
            make_fault("bit-flip", prob=1.5)
        with pytest.raises(ValueError, match="n_bits"):
            make_fault("bit-flip", n_bits=0)
        with pytest.raises(ValueError, match="at_event"):
            make_fault("server-kill", at_event=-1)

    def test_decisions_deterministic_and_the_reference(self):
        fm = make_fault("client-crash", prob=0.5, seed=9)
        ref = ref_make_fault("client-crash", prob=0.5, seed=9)
        a = [fm.crash(fm.rng(d)) for d in range(64)]
        assert a == [fm.crash(fm.rng(d)) for d in range(64)]
        assert a == [ref.crash(ref.rng(d)) for d in range(64)]
        assert any(a) and not all(a)
        other = make_fault("client-crash", prob=0.5, seed=10)
        assert a != [other.crash(other.rng(d)) for d in range(64)]

    @pytest.mark.parametrize("fault", sorted(registered_faults()))
    def test_every_fault_simulates_as_the_reference(self, fault):
        kw = dict(n_clients=64, cohort=8, max_staleness=3, aggregations=6,
                  faults=fault, seed=3)
        s1 = simulate_scenario("flash-outage", **kw)
        assert s1 == simulate_scenario("flash-outage", **kw)
        assert s1 == ref_simulate_scenario("flash-outage", **kw)
        assert (s1["arrived"] + s1["dropped"] + s1["lost"] + s1["duplicates"]
                + s1["quarantined"] + s1["pending"]
                == s1["dispatched"] + s1["injected"])

    def test_no_fault_is_bit_identical_to_none(self):
        kw = dict(n_clients=32, cohort=4, aggregations=4, seed=1)
        assert (simulate_scenario("steady", **kw)
                == simulate_scenario("steady", faults="none", **kw))

    def test_corrupt_hooks_cover_payload_types(self):
        fm = BitFlipFault(prob=1.0, seed=0)
        rng = fm.rng(0)
        msg = wire.encode_ternary_words(
            np.asarray([0, 1, 0, -1, 0, 0, 1, 0] * 8, np.float32), 1 / 8)
        assert not np.array_equal(fm.corrupt(msg, fm.rng(0)).words,
                                  msg.words)
        dense = fm.corrupt(np.zeros(32, np.float32), rng)
        assert not np.all(np.isfinite(dense))
        assert isinstance(fm.corrupt(object(), rng), CorruptPayload)

    @pytest.mark.parametrize("fault", ["bit-flip", "truncate"])
    def test_corruptions_are_the_reference_bytes(self, fault):
        fm = make_fault(fault, prob=0.7, seed=4)
        ref = ref_make_fault(fault, prob=0.7, seed=4)
        rng = np.random.default_rng(0)
        for d in range(40):
            x = np.zeros(700, np.float32)
            x[rng.choice(700, 30, replace=False)] = rng.choice([-1.0, 1.0],
                                                               30)
            msg = wire.encode_ternary_words(x, 1 / 20)
            got = fm.corrupt(msg, fm.rng(d))
            want = ref.corrupt(ref_wire.WireMessage(*msg), ref.rng(d))
            np.testing.assert_array_equal(got.words, want.words)
            assert (got.bit_len, got.nnz) == (want.bit_len, want.nnz)
            dense = rng.standard_normal(64).astype(np.float32)
            np.testing.assert_array_equal(
                fm.corrupt(dense, fm.rng(d)).view(np.int32),
                ref.corrupt(dense, ref.rng(d)).view(np.int32))


class TestComposedScenario:
    def test_flash_outage_registered_and_composes_hooks(self):
        s = make_scenario("flash-outage")
        assert isinstance(s, ComposedScenario)
        fc, ro = FlashCrowdScenario(), RegionalOutageScenario()
        t = fc.start + 0.1
        assert s.latency_scale(t) == fc.latency_scale(t) * ro.latency_scale(t)
        ids = np.arange(16)
        pa = np.asarray(fc.loss_prob(t, ids))
        pb = np.asarray(ro.loss_prob(t, ids))
        np.testing.assert_allclose(np.asarray(s.loss_prob(t, ids)),
                                   1.0 - (1.0 - pa) * (1.0 - pb))

    def test_loss_union_not_product(self):
        s = ComposedScenario(a=SteadyScenario(),
                             b=RegionalOutageScenario(loss=0.9))
        lp = np.asarray(s.loss_prob(0.1, np.arange(8)))
        assert lp.max() == pytest.approx(0.9)

    def test_typed_validation(self):
        with pytest.raises(TypeError, match="must be a Scenario"):
            ComposedScenario(a="steady", b=SteadyScenario())

    def test_deadline_elementwise_min(self):
        base = make_scenario("adaptive-deadline", factor=2.0)
        tight = make_scenario("adaptive-deadline", factor=1.0)
        comp = ComposedScenario(a=base, b=tight)
        ids, scales = np.arange(4), np.ones(4)
        np.testing.assert_allclose(
            comp.client_deadline(ids, scales),
            np.minimum(base.client_deadline(ids, scales),
                       tight.client_deadline(ids, scales)))
        none_side = ComposedScenario(a=SteadyScenario(), b=tight)
        np.testing.assert_allclose(none_side.client_deadline(ids, scales),
                                   tight.client_deadline(ids, scales))


# ---------------------------------------------------------------------------
# wire fuzz: the same typed error on the same mutations as the reference
# ---------------------------------------------------------------------------


def _decode_or_error(fn, msg):
    try:
        return fn(msg)
    except (WireDecodeError, ref_wire.WireDecodeError) as exc:
        return type(exc).__name__


class TestWireFuzz:
    @pytest.mark.parametrize("backend", ["numpy", "kernel"])
    def test_mutations_fail_as_the_reference(self, backend):
        """Random word and field mutations of valid payloads: the port's
        decoder raises ``WireDecodeError`` where the reference's does, and
        otherwise returns the reference's fields (well formed: sorted unique
        in-range positions, +-1 signs, count == nnz)."""
        rng = np.random.default_rng(0)
        p = 1 / 16
        caught = 0
        for trial in range(60):
            n = int(rng.integers(64, 2048))
            x = np.zeros(n, np.float32)
            k = max(1, int(n * p))
            x[rng.choice(n, size=k, replace=False)] = rng.choice(
                [-1.0, 1.0], size=k)
            msg = wire.encode_ternary_words(x, p)
            words = np.asarray(msg.words).copy()
            mode = trial % 3
            if mode == 0 and words.size:
                i = rng.integers(0, words.size, 4)
                words[i] ^= (np.uint32(1) << rng.integers(0, 32, 4)
                             .astype(np.uint32))
                bad = msg._replace(words=words)
            elif mode == 1 and words.size:
                bad = msg._replace(words=words[: words.size // 2])
            else:
                bad = msg._replace(nnz=int(msg.nnz) + int(rng.integers(1, 5)))
            got = _decode_or_error(lambda m: wire.decode_ternary_fields(
                m, p, backend=backend, device="cpu"), bad)
            want = _decode_or_error(lambda m: ref_wire.decode_ternary_fields(
                m, p), ref_wire.WireMessage(*bad))
            if isinstance(want, str):
                assert got == "WireDecodeError", trial
                caught += 1
                continue
            assert not isinstance(got, str), trial
            pos, signs = got
            np.testing.assert_array_equal(pos, want[0])
            np.testing.assert_array_equal(signs, want[1])
            assert pos.size == int(bad.nnz)
            assert np.all((pos >= 0) & (pos < bad.numel))
            assert np.all(np.diff(pos) > 0)
            assert np.all(np.isin(signs, [-1.0, 1.0]))
        assert caught > 0

    @pytest.mark.parametrize("backend", ["numpy", "kernel"])
    def test_corruption_classes_same_typed_error(self, backend):
        x = np.zeros(512, np.float32)
        x[[3, 77, 301]] = 1.0
        msg = wire.encode_ternary_words(x, 1 / 64)
        words = np.asarray(msg.words)
        for bad in (msg._replace(words=words[: words.size // 2]),
                    msg._replace(nnz=int(msg.nnz) + 3),
                    msg._replace(bit_len=int(msg.bit_len) + 64)):
            with pytest.raises(WireDecodeError):
                wire.decode_ternary_fields(bad, 1 / 64, backend=backend,
                                           device="cpu")
            with pytest.raises(ref_wire.WireDecodeError):
                ref_wire.decode_ternary_fields(ref_wire.WireMessage(*bad),
                                               1 / 64)

    def test_sign_plane_validation(self):
        sp = make_protocol("signsgd")
        msg = sp.encode_wire(np.ones(100, np.float32))
        sp.validate_wire(msg, device="cpu")
        with pytest.raises(WireDecodeError, match="bit_len != numel"):
            sp.validate_wire(msg._replace(bit_len=64), device="cpu")


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


class TestAdmissionControl:
    def test_duplicate_rejected_by_dispatch_version(self):
        loop = EventLoop(SteadyScenario(), 16, cohort=4, k_arrivals=4,
                         concurrency=16, max_staleness=8, seed=0,
                         faults=DuplicateFault(prob=1.0, seed=0))
        rng = np.random.default_rng(1)
        for _ in range(4):
            loop.dispatch(rng.choice(16, size=4, replace=False))
        admitted = set()
        while len(loop.clock):
            ev = loop.step()
            if ev.kind in ("arrival", "drop"):
                assert (ev.client, ev.dseq) not in admitted
                admitted.add((ev.client, ev.dseq))
        assert loop.n_injected == 16 and loop.n_duplicates == 16
        assert loop.n_arrived + loop.n_dropped == 16

    def test_replay_of_lost_original_is_not_duplicate(self):
        loop = EventLoop(SteadyScenario(), 8, cohort=8, k_arrivals=64,
                         concurrency=64, max_staleness=8, seed=0,
                         faults=make_fault("replay", prob=1.0))
        loop.dispatch(np.arange(8))
        loop.dispatch(np.arange(8))
        while len(loop.clock):
            loop.step()
        assert loop.n_injected == 8
        assert (loop.n_arrived + loop.n_dropped + loop.n_lost
                + loop.n_duplicates == 24)
        assert loop.n_duplicates == 8

    def test_quarantine_bills_bits_but_never_aggregates(self, data):
        tr = _trainer(data, faults=make_fault("truncate", prob=0.5))
        for _ in range(4):
            tr.run_round()
        quar = [r for r in tr.event_log if r["kind"] == "quarantine"]
        assert quar and tr.loop.n_quarantined == len(quar)
        assert all(r["bits_up"] > 0 for r in quar)
        assert len(tr.loop.quarantine_log) == len(quar)
        assert all("corrupt" in q["reason"] or "truncated" in q["reason"]
                   for q in tr.loop.quarantine_log)
        billed = sum(r["bits_up"] for r in tr.event_log
                     if r["kind"] != "dispatch")
        assert tr.bits_up == pytest.approx(billed)
        assert sum(a["aggregated"] for a in tr.agg_log) == tr.loop.n_arrived

    @pytest.mark.parametrize("fault", sorted(registered_faults()))
    def test_trainer_survives_every_fault_class(self, data, fault):
        fm = (make_fault(fault) if fault != "server-kill"
              else make_fault(fault, at_event=10 ** 9))
        tr = _trainer(data, faults=fm)
        for _ in range(3):
            tr.run_round()
        assert tr.round == 3
        assert bool(torch.isfinite(tr.params_vec).all())

    def test_dense_mode_quarantines_without_stack_crash(self, data):
        tr = _trainer(data, ingest=False,
                      faults=make_fault("bit-flip", prob=0.7))
        for _ in range(3):
            tr.run_round()
        assert tr.loop.n_quarantined > 0
        assert bool(torch.isfinite(tr.params_vec).all())

    @pytest.mark.parametrize("ingest", [False, True], ids=["dense", "ingest"])
    def test_fault_run_event_log_is_the_reference(self, data, ingest):
        """Under truncation (ingest) or bit flips (dense), from the
        reference's initial parameters: the event, aggregation and
        quarantine logs are the reference's."""
        init = jax.tree.map(np.asarray,
                            REF_ZOO["logreg"][0](jax.random.PRNGKey(0)))
        fault = "truncate" if ingest else "bit-flip"
        port = _trainer(data, ingest=ingest,
                        faults=make_fault(fault, prob=0.5),
                        model=(lambda gen: params_from_jax(init),
                               MODEL_ZOO["logreg"][1]))
        ref = RefEventTrainer(
            REF_ZOO["logreg"],
            *ref_make_classification(seed=0, n=900, n_test=240),
            RefEnv(n_clients=8, participation=0.25, classes_per_client=2,
                   batch_size=10),
            ref_make_protocol("stc", sparsity_up=1 / 20, sparsity_down=1 / 20),
            RefConfig(seed=0, ingest=ingest),
            faults=ref_make_fault(fault, prob=0.5), **_EV_KW)
        for _ in range(4):
            port.run_round()
            ref.run_round()
        assert port.loop.n_quarantined > 0
        assert port.event_log == ref.event_log
        assert port.agg_log == ref.agg_log
        assert port.loop.quarantine_log == ref.loop.quarantine_log


# ---------------------------------------------------------------------------
# kill + crash-consistent resume
# ---------------------------------------------------------------------------


def _same_run(a, b):
    assert torch.equal(a.params_vec, b.params_vec)
    assert (a.bits_up, a.bits_down, a.bits_up_analytic,
            a.bits_down_analytic) == (b.bits_up, b.bits_down,
                                      b.bits_up_analytic,
                                      b.bits_down_analytic)
    assert a.event_log == b.event_log
    assert a.agg_log == b.agg_log
    assert a.wire_log == b.wire_log
    assert a.loop.quarantine_log == b.loop.quarantine_log
    assert a.loop.stats() == b.loop.stats()


class TestKillAndResume:
    @pytest.mark.parametrize("ingest", [True, False], ids=["ingest", "dense"])
    @pytest.mark.parametrize("protocol", ["stc", "signsgd"])
    def test_kill_and_resume_bit_identical(self, data, protocol, ingest,
                                           tmp_path):
        ck = str(tmp_path / f"{protocol}.ck")
        ref = _trainer(data, protocol, ingest=ingest, faults="none")
        for _ in range(4):
            ref.run_round()
        killed = _trainer(data, protocol, ingest=ingest,
                          faults=make_fault("server-kill", at_event=9),
                          ckpt_path=ck, ckpt_every=2)
        with pytest.raises(ServerKilled, match="at_event=9"):
            while killed.round < 4:
                killed.run_round()
        resumed = _trainer(data, protocol, ingest=ingest, faults="none")
        resumed.restore_checkpoint(ck)
        assert resumed.n_events_served in (8, 9)
        while resumed.round < 4:
            resumed.run_round()
        _same_run(ref, resumed)
        if protocol == "stc":
            assert torch.equal(ref.server_state.residual,
                               resumed.server_state.residual)
            assert torch.equal(ref.client_state.residual,
                               resumed.client_state.residual)

    def test_checkpoint_roundtrip_mid_chaos(self, data, tmp_path):
        ck = str(tmp_path / "chaos.ck")
        fm = make_fault("truncate", prob=0.5)
        a = _trainer(data, faults=fm)
        for _ in range(2):
            a.run_round()
        a.save_checkpoint(ck)
        for _ in range(2):
            a.run_round()
        b = _trainer(data, faults=fm)
        b.restore_checkpoint(ck)
        for _ in range(2):
            b.run_round()
        _same_run(a, b)

    def test_checkpoint_needs_neither_msgpack_nor_zstandard(self, data,
                                                            tmp_path):
        """The written file is a zlib frame, restored by the port's own
        decoder with ``msgpack`` and ``zstandard`` unimportable."""
        import subprocess
        import sys
        ck = tmp_path / "plain.ck"
        tr = _trainer(data)
        tr.run_round()
        tr.save_checkpoint(str(ck))
        assert ck.read_bytes()[:1] == b"\x78"          # zlib header
        code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("msgpack", "zstandard", "jax", "repro"):
            raise ImportError(name)
sys.meta_path.insert(0, Block())
from repro_torch.checkpoint import restore_state
from repro_torch.fed.events import _CKPT_CLASSES
st = restore_state({str(ck)!r}, classes=_CKPT_CLASSES)
print(st["base"]["round"], len(st["trainer"]["event_log"]))
"""
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "PYTHONPATH": "src"})
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["1", str(len(tr.event_log))]


# ---------------------------------------------------------------------------
# norm screening
# ---------------------------------------------------------------------------


class TestNormScreening:
    def test_policy_validation(self):
        with pytest.raises(ValueError, match="norm_policy"):
            make_protocol("stc", norm_bound=1.0, norm_policy="zap")
        with pytest.raises(ValueError, match="norm_bound"):
            make_protocol("stc", norm_bound=-1.0)

    @pytest.mark.filterwarnings("ignore::DeprecationWarning")
    def test_clip_and_reject_match_combine_oracle(self):
        rng = np.random.default_rng(0)
        numel = 256
        msgs = np.zeros((4, numel), np.float32)
        for i, scale in enumerate([0.1, 0.5, 2.0, 8.0]):
            idx = rng.choice(numel, size=16, replace=False)
            msgs[i, idx] = scale * rng.choice([-1.0, 1.0], size=16)
        bound = float(np.linalg.norm(msgs[1]) * 1.01)
        for policy in ("clip", "reject"):
            proto = make_protocol("ternquant", norm_bound=bound,
                                  norm_policy=policy)
            combined = proto.combine(torch.from_numpy(msgs),
                                     mask=torch.ones(4),
                                     staleness=torch.zeros(4)).numpy()
            acc = proto.make_ingest(numel)
            for row in msgs:
                proto.ingest_dense(acc, row, 1.0)
            np.testing.assert_allclose(np.asarray(acc.combined()), combined,
                                       atol=1e-6)
            if policy == "reject":
                assert acc.n_screened == 2

    @pytest.mark.filterwarnings("ignore::DeprecationWarning")
    def test_wire_norm_screen_rejects_outlier_stc(self):
        numel, k = 512, 8
        proto = make_protocol("stc", sparsity_up=k / numel,
                              norm_bound=0.5, norm_policy="reject")
        small = np.zeros(numel, np.float32)
        small[:k] = 0.05 * np.asarray([1, -1] * (k // 2))
        big = np.zeros(numel, np.float32)
        big[:k] = 9.0 * np.asarray([1, -1] * (k // 2))
        acc = proto.make_ingest(numel)
        proto.ingest_wire(acc, proto.encode_wire(small), 1.0, device="cpu")
        proto.ingest_wire(acc, proto.encode_wire(big), 1.0, device="cpu")
        assert acc.n_screened == 1
        assert acc.weight_mass == pytest.approx(1.0)
        assert acc.stream_bits > 0
        assert np.abs(np.asarray(acc.combined())).max() == \
            pytest.approx(0.05, rel=1e-5)

    @pytest.mark.parametrize("policy", ["clip", "reject"])
    @pytest.mark.parametrize("wire_backend", ["numpy", "kernel"])
    def test_screened_batch_is_its_oracle_and_the_reference(
            self, policy, wire_backend):
        """A screened STC round through ``ingest_wire_batch`` (the
        per-message path) is bitwise its dense oracle (decode, then
        ``ingest_dense``) and the reference's accumulator."""
        rng = np.random.default_rng(7)
        n, P, p = 3000, 6, 1 / 50
        x = rng.standard_normal((P, n)).astype(np.float32)
        x *= np.asarray([0.1, 1, 1, 8, 1, 30], np.float32)[:, None]
        rule = dict(bound=40.0, policy=policy)
        port = make_protocol("stc", sparsity_up=p, wire_backend=wire_backend,
                             rule=NormScreenedMeanRule(**rule))
        ref = ref_make_protocol("stc", sparsity_up=p,
                                rule=RefNormScreenedMeanRule(**rule))
        msgs, _, _ = port.encode_batch(
            torch.from_numpy(x), port.init_client_state(n, "cpu")._replace(
                residual=torch.zeros(P, n)))
        batch = port.encode_wire_batch(msgs, direction="up", device="cpu")
        w = np.asarray([1.0, 0.5, 1.0, 0.7, 1.0, 1.0])
        acc = port.make_ingest(n)
        port.ingest_wire_batch(acc, batch, w, device="cpu")
        oracle = port.make_ingest(n)
        for i in range(P):
            port.ingest_dense(oracle, port.decode_wire(batch.message(i)),
                              float(w[i]))
        ref_acc = ref.make_ingest(n)
        ref.ingest_wire_batch(ref_acc, ref_wire.WireBatch(*batch), w)
        assert acc.n_screened == ref_acc.n_screened
        assert (acc.n_screened > 0) == (policy == "reject")
        np.testing.assert_array_equal(acc.sum.view(np.int64),
                                      ref_acc.sum.view(np.int64))
        assert acc.weight_mass == ref_acc.weight_mass
        np.testing.assert_allclose(acc.combined(), oracle.combined(),
                                   rtol=1e-6, atol=1e-9)
        assert acc.n_screened == oracle.n_screened

    def test_screen_off_is_the_reference_mean(self):
        rng = np.random.default_rng(3)
        msgs = rng.standard_normal((5, 64)).astype(np.float32)
        base = make_protocol("stc")
        assert base.norm_bound is None
        np.testing.assert_array_equal(
            base.combine(torch.from_numpy(msgs)).numpy().view(np.int32),
            np.asarray(jnp.mean(jnp.asarray(msgs), axis=0)).view(np.int32))


class TestStatsGuards:
    def test_zero_arrival_stats_are_finite(self):
        loop = EventLoop(SteadyScenario(), 8, cohort=2, k_arrivals=2,
                         concurrency=4, max_staleness=1, seed=0)
        st = loop.stats()
        assert st["mean_staleness"] == 0.0
        assert st["drop_rate"] == 0.0
        assert st["quarantine_rate"] == 0.0
        assert st["duplicate_rate"] == 0.0
        assert st["aggs_per_time"] == 0.0
        assert all(np.isfinite(v) for v in st.values()
                   if isinstance(v, (int, float)))
