"""Port parity of the aggregation rules (``repro_torch.core.aggregation``)
and their adversarial complement (the Byzantine faults of
``repro_torch.fed.faults``); twins of tests/test_aggregation.py.

* Every rule's ``combine`` is the reference's bit for bit on the same
  numpy messages, at unit weights, at staleness weights ``(1+s)^-0.5``,
  with zero-weight rows, at zero mass and on sparse ternary rows full of
  ties and ``-0.0`` (up to 32 rows: the port adds rows in the order of the
  reference's CPU lowering; ``norm_screened_mean`` is the exception: its
  row norms sum a row's squares in another order than XLA, so its clipped
  rows are held to rtol 1e-6 and its reject decisions exactly).
* The rule algebra (permutation, zero-weight rows, masked == compacted,
  staleness as reweighting, zero mass), the statistics (median at unit
  weights, beta = 0, the breakdown point, the norm screen) and the
  registry hold in the port as in the reference.
* ``rule="mean"`` is bitwise the default in the synchronous, buffered and
  event trainers; the ``norm_bound`` shim warns, is bitwise its rule,
  raises on a conflict and stays silent under ``dataclasses.replace``; a
  non-streaming rule makes ``ingest=True`` fall back to the dense combine.
* The Byzantine rewrites are the reference's byte for byte (membership,
  dense, STC wire, sign plane, collusion direction), stay valid wire
  messages, and the coordinate median holds where the mean collapses.
"""

import dataclasses
import os
import warnings
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_protocol as ref_make_protocol
from repro.core.aggregation import make_rule as ref_make_rule
from repro.core.wire import WireMessage as RefWireMessage
from repro.fed import make_fault as ref_make_fault
from repro.fed.faults import _rewrite_valid as ref_rewrite_valid
from repro_torch.core import make_protocol
from repro_torch.core.aggregation import (AggregationRule,
                                          CoordinateMedianRule, MeanRule,
                                          NormScreenedMeanRule,
                                          TrimmedMeanRule, get_rule_class,
                                          make_rule, register_rule,
                                          registered_rules)
from repro_torch.core.registry import resolve
from repro_torch.data import make_classification
from repro_torch.fed import (BufferedFederatedTrainer, CollusionFault,
                             EventDrivenTrainer, FedEnvironment,
                             FederatedTrainer, LatencyModel,
                             ScaleAttackFault, SignFlipFault, TrainerConfig,
                             make_fault, make_sampler, make_scenario)
from repro_torch.fed.faults import _rewrite_valid
from repro_torch.fed.scenarios import SteadyScenario
from repro_torch.models import MODEL_ZOO

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

RULES = registered_rules()


def _msgs(p=7, d=24, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((p, d)).astype(np.float32))


def _weights(p=7, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(0.2, 2.0, p).astype(np.float32))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


# ---------------------------------------------------------------------------
# every rule against the reference
# ---------------------------------------------------------------------------


def _inputs(kind, P, rng):
    x = rng.standard_normal((P, 300)).astype(np.float32)
    w = None
    if kind == "sparse":            # STC-like rows: ties, +-mu, -0.0
        x = (np.sign(x) * (rng.random((P, 300)) < 0.05)
             * np.float32(0.37)).astype(np.float32)
        x[rng.random((P, 300)) < 0.3] *= -1
    elif kind == "stale":
        s = rng.integers(0, 8, P).astype(np.float32)
        w = np.array((1.0 + jnp.asarray(s)) ** -0.5)
    elif kind == "zero_rows":
        w = (rng.random(P) < 0.5).astype(np.float32)
        w[0] = 1.0
    elif kind == "zero_mass":
        w = np.zeros(P, np.float32)
    return x, w


@pytest.mark.parametrize("kind", ["unit", "sparse", "stale", "zero_rows",
                                  "zero_mass"])
@pytest.mark.parametrize("name", RULES)
def test_combine_bitwise_reference(name, kind):
    """Each rule's combine against the reference's on the same inputs, at
    2 to 32 rows (the cumulative mass crosses its 16-row tile at 17)."""
    rng = np.random.default_rng(zlib.crc32(f"{name}/{kind}".encode()))
    for P in (1, 2, 5, 10, 11, 17, 20, 32):
        x, w = _inputs(kind, P, rng)
        want = np.asarray(ref_make_rule(name).combine(
            jnp.asarray(x), None if w is None else jnp.asarray(w)))
        got = make_rule(name).combine(
            torch.from_numpy(x), None if w is None else torch.from_numpy(w))
        if name == "norm_screened_mean":
            # the row norms sum 300 squares in another order than XLA:
            # a clip scale may move by an ulp
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-7)
        else:
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"P={P}")


@pytest.mark.parametrize("policy", ["clip", "reject"])
def test_norm_screen_decisions_match_reference(policy):
    """The screen's reject decisions are the reference's exactly (no norm
    within an ulp of the bound here); clipped rows within rtol 1e-6."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 1000)).astype(np.float32)
    x *= rng.uniform(0.1, 3.0, (9, 1))
    bound = 30.0
    rule = make_rule("norm_screened_mean", bound=bound, policy=policy)
    ref = ref_make_rule("norm_screened_mean", bound=bound, policy=policy)
    m, w = rule.screen(torch.from_numpy(x), None)
    rm, rw = ref.screen(jnp.asarray(x), None)
    np.testing.assert_allclose(m.numpy(), np.asarray(rm), rtol=1e-6)
    if policy == "reject":
        np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
        assert 0 < float(w.sum()) < 9


# ---------------------------------------------------------------------------
# rule algebra: every registered rule
# ---------------------------------------------------------------------------


class TestRuleAlgebra:
    @pytest.mark.parametrize("name", RULES)
    def test_permutation_invariance(self, name):
        rule, msgs, w = make_rule(name), _msgs(), _weights()
        perm = torch.from_numpy(
            np.random.default_rng(2).permutation(msgs.shape[0]))
        torch.testing.assert_close(rule.combine(msgs[perm], w[perm]),
                                   rule.combine(msgs, w), rtol=1e-5,
                                   atol=1e-6)

    @pytest.mark.parametrize("name", RULES)
    def test_zero_weight_row_is_invisible(self, name):
        rule, msgs, w = make_rule(name), _msgs(), _weights()
        msgs2 = torch.cat([msgs, 1e6 * torch.ones((1, msgs.shape[1]))])
        w2 = torch.cat([w, torch.zeros(1)])
        torch.testing.assert_close(rule.combine(msgs2, w2),
                                   rule.combine(msgs, w), rtol=1e-5,
                                   atol=1e-6)

    @pytest.mark.parametrize("name", RULES)
    def test_masked_equals_compacted(self, name):
        codec = make_protocol("baseline", rule=make_rule(name))
        msgs = _msgs(p=8)
        mask = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], dtype=torch.float32)
        kept = msgs[mask > 0]
        torch.testing.assert_close(
            codec.combine(msgs, mask),
            codec.combine(kept, torch.ones(kept.shape[0])), rtol=1e-5,
            atol=1e-6)

    @pytest.mark.parametrize("name", RULES)
    def test_staleness_decay_reweights(self, name):
        codec = make_protocol("baseline", rule=make_rule(name),
                              staleness_decay=1.0)
        msgs = _msgs(p=5)
        mask = torch.ones(5)
        stale = torch.tensor([0, 1, 3, 0, 7], dtype=torch.float32)
        w = codec.participation_weights(mask, stale)
        torch.testing.assert_close(codec.combine(msgs, mask, stale),
                                   codec.rule.combine(msgs, w), rtol=1e-5,
                                   atol=1e-6)

    @pytest.mark.parametrize("name", RULES)
    def test_zero_total_weight_combines_to_zero(self, name):
        out = make_rule(name).combine(_msgs(p=4), torch.zeros(4))
        assert torch.equal(out, torch.zeros_like(out))


class TestRuleStatistics:
    @pytest.mark.parametrize("p", [5, 8])
    def test_median_matches_numpy_at_unit_weights(self, p):
        msgs = _msgs(p=p)
        np.testing.assert_allclose(
            make_rule("coordinate_median").combine(msgs).numpy(),
            np.median(msgs.numpy(), axis=0), rtol=1e-6, atol=1e-7)

    def test_trimmed_beta0_is_the_weighted_mean(self):
        msgs, w = _msgs(), _weights()
        torch.testing.assert_close(TrimmedMeanRule(beta=0.0).combine(msgs, w),
                                   MeanRule().combine(msgs, w), rtol=1e-5,
                                   atol=1e-6)

    def test_trimmed_clips_an_outlier_mean_does_not(self):
        msgs = torch.cat([_msgs(p=9), 1e4 * torch.ones((1, 24))])
        t = TrimmedMeanRule(beta=0.2).combine(msgs)
        m = MeanRule().combine(msgs)
        assert float(t.abs().max()) < 10.0 < float(m.abs().min())

    @pytest.mark.parametrize("f", [1, 2, 3, 4, 5])
    def test_median_breakdown_point(self, f):
        p, d = 11, 16
        rng = np.random.default_rng(3)
        honest = 1.0 + 0.1 * rng.standard_normal((p - f, d))
        byz = -10.0 * (1.0 + 0.1 * rng.standard_normal((f, d)))
        msgs = torch.from_numpy(
            np.concatenate([honest, byz]).astype(np.float32))
        med = make_rule("coordinate_median").combine(msgs).numpy()
        assert np.all(med >= honest.min(axis=0) - 1e-6)
        assert np.all(med <= honest.max(axis=0) + 1e-6)
        assert np.all(med > 0)
        mean = MeanRule().combine(msgs).numpy()
        if f >= 2:
            assert np.all(mean < 0)
        else:
            assert np.all(mean < 0.5)

    def test_norm_screen_reject_drops_only_oversized(self):
        msgs = torch.cat([_msgs(p=6), 1e3 * torch.ones((1, 24))])
        rule = NormScreenedMeanRule(bound=50.0, policy="reject")
        torch.testing.assert_close(rule.combine(msgs),
                                   MeanRule().combine(msgs[:6],
                                                      torch.ones(6)),
                                   rtol=1e-5, atol=1e-6)

    def test_norm_screen_clip_rescales(self):
        msgs = 10.0 * torch.ones((2, 4))                # norm 20 a row
        rule = NormScreenedMeanRule(bound=10.0, policy="clip")
        torch.testing.assert_close(rule.combine(msgs), 5.0 * torch.ones(4),
                                   rtol=1e-5, atol=0.0)

    def test_rule_validation(self):
        with pytest.raises(ValueError, match="policy"):
            NormScreenedMeanRule(policy="zap")
        with pytest.raises(ValueError, match="bound"):
            NormScreenedMeanRule(bound=0.0)
        with pytest.raises(ValueError, match="beta"):
            TrimmedMeanRule(beta=0.5)


class TestRuleRegistry:
    def test_paper_rules_registered(self):
        assert RULES == ("coordinate_median", "mean", "norm_screened_mean",
                         "trimmed_mean")
        assert get_rule_class("mean") is MeanRule

    def test_unknown_rule_lists_registered(self):
        with pytest.raises(KeyError) as ei:
            make_rule("nope")
        assert "unknown aggregation rule 'nope'" in str(ei.value)
        for name in RULES:
            assert name in str(ei.value)

    def test_instance_passes_through_untouched(self):
        r = TrimmedMeanRule(beta=0.3)
        assert make_rule(r) is r

    def test_overrides_on_an_instance_are_loud(self):
        with pytest.raises(TypeError, match="already-constructed"):
            make_rule(TrimmedMeanRule(), beta=0.3)

    def test_non_string_non_instance_is_loud(self):
        with pytest.raises(TypeError, match="aggregation rule"):
            make_rule(3.14)

    def test_duplicate_registration_is_loud(self):
        with pytest.raises(ValueError, match="already registered"):
            @register_rule
            @dataclasses.dataclass(frozen=True)
            class Impostor(AggregationRule):
                name = "mean"

    def test_every_registry_shares_the_error_shape(self):
        for factory, kind in ((make_protocol, "protocol"),
                              (make_scenario, "scenario"),
                              (make_sampler, "client sampler"),
                              (make_fault, "fault model"),
                              (make_rule, "aggregation rule")):
            with pytest.raises(KeyError) as ei:
                factory("definitely-not-registered")
            assert (f"unknown {kind} 'definitely-not-registered'; "
                    "registered:") in str(ei.value)

    def test_resolve_instantiates_with_overrides(self):
        out = resolve("aggregation rule", "trimmed_mean",
                      {"trimmed_mean": TrimmedMeanRule}, AggregationRule,
                      beta=0.25)
        assert out == TrimmedMeanRule(beta=0.25)

    def test_custom_rule_registration_roundtrip(self):
        from repro_torch.core.aggregation import _REGISTRY

        @register_rule
        @dataclasses.dataclass(frozen=True)
        class MidrangeRule(AggregationRule):
            name = "midrange-test"

            def combine_weighted(self, msgs, weights):
                return 0.5 * (msgs.max(dim=0).values + msgs.min(dim=0).values)

        try:
            codec = make_protocol("baseline", rule="midrange-test")
            out = codec.combine(torch.tensor([[0.0], [1.0], [5.0]]))
            assert float(out[0]) == pytest.approx(2.5)
        finally:
            _REGISTRY.pop("midrange-test", None)

    def test_make_protocol_builds_every_rule_as_the_reference(self):
        for name in RULES:
            assert (type(make_protocol("stc", rule=name).rule).__name__
                    == type(ref_make_protocol("stc", rule=name)
                            .rule).__name__)


# ---------------------------------------------------------------------------
# mean bit identity in the trainers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    return make_classification(seed=0, n=900, n_test=240)


def _env(n_clients=6, participation=0.5):
    return FedEnvironment(n_clients=n_clients, participation=participation,
                          classes_per_client=2, batch_size=10)


def _proto(name, rule=None):
    kw = {"stc": dict(sparsity_up=1 / 20, sparsity_down=1 / 20)}.get(name, {})
    if rule is not None:
        kw["rule"] = rule
    return make_protocol(name, **kw)


def _assert_identical(a, b):
    assert torch.equal(a.params_vec, b.params_vec)
    assert a.bits_up == b.bits_up and a.bits_down == b.bits_down
    assert a.bits_up_analytic == b.bits_up_analytic
    assert a.bits_down_analytic == b.bits_down_analytic
    assert a.wire_log == b.wire_log


class TestMeanBitIdentity:
    @pytest.mark.parametrize("name", ["stc", "signsgd"])
    def test_synchronous(self, data, name):
        runs = []
        for rule in (None, "mean"):
            tr = FederatedTrainer(MODEL_ZOO["logreg"], *data, _env(),
                                  _proto(name, rule),
                                  TrainerConfig(lr=0.05, seed=0),
                                  device="cpu")
            tr.run(3, eval_every=3)
            runs.append(tr)
        _assert_identical(*runs)

    @pytest.mark.parametrize("name", ["stc", "signsgd"])
    def test_buffered(self, data, name):
        runs = []
        for rule in (None, "mean"):
            tr = BufferedFederatedTrainer(
                MODEL_ZOO["logreg"], *data, _env(), _proto(name, rule),
                TrainerConfig(lr=0.05, seed=0),
                latency=LatencyModel(mean=1.0, sigma=0.6), deadline=1.5,
                max_staleness=3, device="cpu")
            tr.run(3, eval_every=3)
            runs.append(tr)
        _assert_identical(*runs)

    @pytest.mark.parametrize("name", ["stc", "signsgd"])
    def test_event_driven(self, data, name):
        runs = []
        for rule in (None, "mean"):
            tr = EventDrivenTrainer(
                MODEL_ZOO["logreg"], *data, _env(), _proto(name, rule),
                TrainerConfig(lr=0.05, seed=0),
                scenario=SteadyScenario(latency=LatencyModel(mean=0.7,
                                                             sigma=0.9)),
                device="cpu")
            tr.run(3, eval_every=3)
            runs.append(tr)
        _assert_identical(*runs)


# ---------------------------------------------------------------------------
# norm_bound deprecation shim
# ---------------------------------------------------------------------------


class TestNormBoundShim:
    def test_shim_warns_and_builds_the_rule(self):
        with pytest.warns(DeprecationWarning, match="norm_screened_mean"):
            codec = make_protocol("stc", norm_bound=2.0, norm_policy="reject")
        assert codec.rule == NormScreenedMeanRule(bound=2.0, policy="reject")
        with pytest.warns(DeprecationWarning):
            assert make_protocol("stc", norm_bound=1.0).rule == \
                NormScreenedMeanRule(bound=1.0)

    def test_shim_is_bit_identical_to_the_rule(self, data):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            old = make_protocol("stc", sparsity_up=1 / 20,
                                sparsity_down=1 / 20, norm_bound=0.5)
        new = _proto("stc", NormScreenedMeanRule(bound=0.5, policy="clip"))
        runs = []
        for proto in (old, new):
            tr = FederatedTrainer(MODEL_ZOO["logreg"], *data, _env(), proto,
                                  TrainerConfig(lr=0.05, seed=0),
                                  device="cpu")
            tr.run(3, eval_every=3)
            runs.append(tr)
        _assert_identical(*runs)

    def test_conflicting_shim_and_rule_is_loud(self):
        with pytest.raises(ValueError, match="norm_bound/norm_policy"):
            make_protocol("stc", norm_bound=2.0, rule="coordinate_median")

    def test_replace_on_a_shimmed_codec_stays_silent(self):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            codec = make_protocol("stc", norm_bound=2.0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            replaced = dataclasses.replace(codec, sparsity_up=1 / 10)
        assert replaced.rule == codec.rule


# ---------------------------------------------------------------------------
# streaming declaration
# ---------------------------------------------------------------------------


class TestStreamingFallback:
    def test_rule_streaming_flags(self):
        assert MeanRule.supports_streaming
        assert NormScreenedMeanRule.supports_streaming
        assert NormScreenedMeanRule.screens and not MeanRule.screens
        assert not CoordinateMedianRule.supports_streaming
        assert not TrimmedMeanRule.supports_streaming

    def test_make_ingest_refuses_non_streaming_rules(self):
        codec = _proto("stc", "coordinate_median")
        with pytest.raises(NotImplementedError, match="cannot stream"):
            codec.make_ingest(100)

    def test_make_ingest_accepts_a_screening_rule(self):
        acc = _proto("stc", "norm_screened_mean").make_ingest(100)
        assert acc.n_screened == 0

    def test_trainer_falls_back_loudly_and_identically(self, data):
        with pytest.warns(RuntimeWarning, match="cannot stream"):
            fused = FederatedTrainer(
                MODEL_ZOO["logreg"], *data, _env(),
                _proto("stc", "coordinate_median"),
                TrainerConfig(lr=0.05, seed=0, ingest=True), device="cpu")
        assert fused.ingest is False
        dense = FederatedTrainer(
            MODEL_ZOO["logreg"], *data, _env(),
            _proto("stc", "coordinate_median"),
            TrainerConfig(lr=0.05, seed=0), device="cpu")
        fused.run(2, eval_every=2)
        dense.run(2, eval_every=2)
        _assert_identical(fused, dense)

    def test_streaming_rule_keeps_the_ingest_path(self, data):
        tr = FederatedTrainer(MODEL_ZOO["logreg"], *data, _env(),
                              _proto("stc"),
                              TrainerConfig(lr=0.05, seed=0, ingest=True),
                              device="cpu")
        assert tr.ingest is True


# ---------------------------------------------------------------------------
# Byzantine valid-update faults
# ---------------------------------------------------------------------------


class TestByzantineFaults:
    def test_membership_is_the_reference_and_calibrated(self):
        f, ref = SignFlipFault(fraction=0.3), ref_make_fault("sign-flip",
                                                             fraction=0.3)
        ids = range(20000)
        member = [f.is_byzantine(c) for c in ids]
        assert member == [ref.is_byzantine(c) for c in ids]
        assert abs(np.mean(member) - 0.3) < 0.02

    def test_fraction_bounds_validated(self):
        with pytest.raises(ValueError, match="fraction"):
            SignFlipFault(fraction=1.5)

    def test_honest_clients_untouched_and_no_rng_draws(self):
        f = SignFlipFault(fraction=0.5)
        honest = next(c for c in range(100) if not f.is_byzantine(c))
        byz = next(c for c in range(100) if f.is_byzantine(c))
        v = np.ones(8, np.float32)
        assert f.byzantine(v, honest, None) is v
        np.testing.assert_array_equal(f.byzantine(v, byz, None), -v)

    def test_rewrite_dense_scales_as_the_reference(self):
        v = np.random.default_rng(0).standard_normal(50).astype(np.float32)
        for factor in (-2.0, -10.0, 100.0):
            np.testing.assert_array_equal(
                _bits(_rewrite_valid(v, factor)),
                _bits(ref_rewrite_valid(v, factor)))

    def test_rewrite_stc_wire_stays_valid(self):
        p = make_protocol("stc", sparsity_up=0.1, sparsity_down=0.1)
        ref = ref_make_protocol("stc", sparsity_up=0.1, sparsity_down=0.1)
        vec = np.random.default_rng(0).standard_normal(400).astype(np.float32)
        msg, _, _ = p.encode(torch.from_numpy(vec),
                             p.init_client_state(400, "cpu"))
        wm = p.encode_wire(msg.numpy(), direction="up")
        flipped = _rewrite_valid(wm, -1.0)
        p.validate_wire(flipped, direction="up", device="cpu")
        np.testing.assert_allclose(p.decode_wire(flipped, direction="up"),
                                   -msg.numpy(), rtol=1e-5, atol=1e-7)
        assert flipped.bit_len == wm.bit_len
        want = ref_rewrite_valid(RefWireMessage(*wm), -1.0)
        assert flipped.mu == want.mu
        np.testing.assert_array_equal(flipped.words, want.words)
        ref.validate_wire(flipped, direction="up")

    def test_rewrite_sign_plane_stays_valid(self):
        p = make_protocol("signsgd")
        vec = np.random.default_rng(1).standard_normal(200).astype(np.float32)
        wm = p.encode_wire(np.sign(vec), direction="up")
        flipped = _rewrite_valid(wm, -1.0)
        p.validate_wire(flipped, direction="up", device="cpu")
        np.testing.assert_allclose(p.decode_wire(flipped, direction="up"),
                                   -p.decode_wire(wm, direction="up"))
        np.testing.assert_array_equal(
            flipped.words, ref_rewrite_valid(RefWireMessage(*wm), -1.0).words)
        assert _rewrite_valid(wm, 2.0) is wm

    def test_negated_mu_cannot_sneak_past_the_norm_screen(self):
        p = make_protocol("stc", sparsity_up=0.1, sparsity_down=0.1)
        vec = np.random.default_rng(2).standard_normal(400).astype(np.float32)
        msg, _, _ = p.encode(torch.from_numpy(vec),
                             p.init_client_state(400, "cpu"))
        wm = p.encode_wire(msg.numpy(), direction="up")
        assert p.wire_norm(_rewrite_valid(wm, -1.0)) == p.wire_norm(wm) > 0
        assert p.wire_norm(wm) == ref_make_protocol(
            "stc", sparsity_up=0.1).wire_norm(wm)

    def test_collusion_cohort_shares_the_reference_direction(self):
        f = CollusionFault(fraction=0.5, scale=1.0)
        ref = ref_make_fault("collusion", fraction=0.5, scale=1.0)
        byz = [c for c in range(40) if f.is_byzantine(c)][:2]
        v1 = np.random.default_rng(3).standard_normal(50).astype(np.float32)
        v2 = np.random.default_rng(4).standard_normal(50).astype(np.float32)
        a1 = np.asarray(f.byzantine(v1, byz[0], None))
        a2 = np.asarray(f.byzantine(v2, byz[1], None))
        cos = np.dot(a1, a2) / (np.linalg.norm(a1) * np.linalg.norm(a2))
        assert cos == pytest.approx(1.0, abs=1e-5)
        assert np.linalg.norm(a1) == pytest.approx(np.linalg.norm(v1),
                                                   rel=1e-5)
        np.testing.assert_array_equal(
            _bits(a1), _bits(ref.byzantine(v1, byz[0], None)))

    def test_scale_attack_scales(self):
        f = ScaleAttackFault(fraction=0.5, factor=100.0)
        byz = next(c for c in range(100) if f.is_byzantine(c))
        v = np.ones(4, np.float32)
        np.testing.assert_allclose(f.byzantine(v, byz, None), 100.0 * v)

    def test_median_holds_under_20pct_signflip_mean_collapses(self, data):
        env = FedEnvironment(n_clients=20, participation=0.5,
                             classes_per_client=10, batch_size=10)
        accs = {}
        for rname in ("mean", "coordinate_median", "trimmed_mean"):
            tr = EventDrivenTrainer(
                MODEL_ZOO["logreg"], *data, env,
                make_protocol("baseline", rule=rname),
                TrainerConfig(lr=0.06, seed=0), scenario="steady",
                faults=make_fault("sign-flip", scale=10.0, fraction=0.2),
                device="cpu")
            accs[rname] = tr.run(12, eval_every=12)[-1]["acc"]
        assert accs["coordinate_median"] > 0.75
        assert accs["mean"] < 0.4


@pytest.mark.parametrize("name", ["mean", "trimmed_mean"])
@pytest.mark.parametrize("P", [33, 48])
def test_r10_past_32_rows_within_rtol(name, P):
    """R10 (ROADMAP Queue 3): past 32 rows XLA's CPU reduction over the
    client axis tiles the rows, where the port adds them one at a time;
    the combines then agree within rtol 1e-6 (the order statistics
    themselves, the coordinate median, stay bitwise)."""
    rng = np.random.default_rng(P)
    x, _ = _inputs("unit", P, rng)
    s = rng.integers(0, 8, P).astype(np.float32)
    w = np.array((1.0 + jnp.asarray(s)) ** -0.5)
    for weights in (None, w):
        want = np.asarray(ref_make_rule(name).combine(
            jnp.asarray(x), None if weights is None
            else jnp.asarray(weights)))
        got = make_rule(name).combine(
            torch.from_numpy(x), None if weights is None
            else torch.from_numpy(weights)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    med = make_rule("coordinate_median").combine(torch.from_numpy(x),
                                                 torch.from_numpy(w))
    np.testing.assert_array_equal(
        _bits(med), _bits(ref_make_rule("coordinate_median").combine(
            jnp.asarray(x), jnp.asarray(w))))
