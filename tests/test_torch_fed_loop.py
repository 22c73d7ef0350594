"""Port parity of one full STC round and of the trainer.

* Lock-step codec: both packages' ``StcCodec`` take the same numpy deltas
  for 3 rounds, each carrying its own client and server residuals.  Masks,
  positions, signs, counts, wire words and every ledger figure are exact;
  µ within rtol 1e-6, residuals within 1e-6 of ``|residual| + µ``.
* Local SGD: the cohort's vmapped gradient step equals the reference's.
* End to end: logreg from the reference's initial parameters, 20 rounds;
  final accuracy within 0.03 and measured upstream bits within 2 % of the
  JAX trainer (local SGD differs at the ulp level, so positions may drift
  after the first round); the same with ``TrainerConfig(ingest=True)`` on
  both sides.
* Fused ingest: ``ingest=True`` reproduces the port's dense run (accuracy
  and ``bits_up`` equal after 2 rounds, as tests/test_ingest.py asserts for
  the reference) for ``stc`` and ``signsgd``; a non-streaming rule warns and
  falls back to the dense combine.
* Exact agreement over 10 rounds (momentum 0.9, three local steps, half
  participation, signSGD with and without measured bits): accuracy and
  the four ledger columns equal, parameters within 1e-7.
* R4 (ROADMAP Queue 3): when the server carries fewer non-zeros than k,
  µ is a sum of equal magnitudes whose last ulp depends on the reduction
  order, and the residual it leaves moves the downlink ledger.  What holds
  is pinned: thresholds, counts and masks exact against ``"jnp"``, µ within
  rtol 1e-6, residuals zero or within 1e-6 of µ; in the trainers' setting
  the analytic columns and the first round's ledger are equal and
  ``bits_up`` is within the trainers' 2 % limit.
"""

import dataclasses
import os
from typing import ClassVar

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_protocol as ref_make_protocol
from repro.core.compression import get_stc_backend as ref_backend
from repro.core.residual import init_residual as ref_init_residual
from repro.core.residual import stack_states as ref_stack_states
from repro.data import make_classification as ref_make_classification
from repro.fed import FedEnvironment as RefEnv
from repro.fed import FederatedTrainer as RefTrainer
from repro.fed import TrainerConfig as RefConfig
from repro.fed.loop import build_encode_phase as ref_build_encode
from repro.core.compression import flatten_pytree as ref_flatten
from repro.models.paper_models import MODEL_ZOO as REF_ZOO
from repro_torch.core import make_protocol
from repro_torch.core.aggregation import MeanRule
from repro_torch.core.compression import flatten_pytree, get_stc_backend
from repro_torch.core.residual import ResidualState
from repro_torch.data import make_classification
from repro_torch.fed import FedEnvironment, FederatedTrainer, TrainerConfig
from repro_torch.fed.environment import split_data
from repro_torch.fed.loop import local_sgd
from repro_torch.models import MODEL_ZOO, params_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _close_residual(got, want, mu):
    """(R, n) residuals within 1e-6 of ``|residual| + µ_row``."""
    tol = 1e-6 * (np.abs(want) + np.abs(np.asarray(mu))[:, None]) + 1e-6
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("wire_backend", ["numpy", "kernel"])
def test_lockstep_codec_three_rounds(backend, wire_backend):
    P, n, p = 5, 3000, 1 / 50
    ref = ref_make_protocol("stc", sparsity_up=p, sparsity_down=p,
                            backend="jnp")
    port = make_protocol("stc", sparsity_up=p, sparsity_down=p,
                         backend=backend, wire_backend=wire_backend)
    ref_cs = ref_stack_states(ref.init_client_state(n), P)
    ref_ss = ref.init_server_state(n)
    cs = port.init_client_state(n, "cpu")
    cs = type(cs)(cs.residual[None].repeat(P, 1))
    ss = port.init_server_state(n, "cpu")
    rng = np.random.default_rng(0)
    ones, zeros = np.ones(P, np.float32), np.zeros(P, np.float32)
    for _ in range(3):
        deltas = (rng.standard_normal((P, n)) * 1e-2).astype(np.float32)
        m_ref, ref_cs, st_ref = ref.encode_batch(jnp.asarray(deltas), ref_cs)
        m_port, cs, st_port = port.encode_batch(torch.from_numpy(deltas), cs)
        m_ref = np.asarray(m_ref)
        np.testing.assert_array_equal(np.sign(m_port.numpy()),
                                      np.sign(m_ref))
        np.testing.assert_array_equal(st_port.nnz.numpy(),
                                      np.asarray(st_ref.nnz))
        np.testing.assert_allclose(st_port.mu.numpy(), np.asarray(st_ref.mu),
                                   rtol=1e-6)
        _close_residual(cs.residual.numpy(), np.asarray(ref_cs.residual),
                        st_ref.mu)

        g_ref, ref_ss, sg_ref = ref.aggregate(
            jnp.asarray(m_ref), ref_ss, mask=jnp.asarray(ones),
            staleness=jnp.asarray(zeros))
        g_port, ss, sg_port = port.aggregate(
            m_port, ss, mask=torch.from_numpy(ones),
            staleness=torch.from_numpy(zeros))
        g_ref = np.asarray(g_ref)
        np.testing.assert_array_equal(np.sign(g_port.numpy()),
                                      np.sign(g_ref))
        assert int(sg_port.nnz) == int(sg_ref.nnz)
        np.testing.assert_allclose(float(sg_port.mu), float(sg_ref.mu),
                                   rtol=1e-6)
        _close_residual(ss.residual.numpy()[None],
                        np.asarray(ref_ss.residual)[None],
                        np.asarray([sg_ref.mu]))

        # the ledger: wire words and every bit count exact
        b_ref = ref.encode_wire_batch(m_ref, direction="up")
        b_port = port.encode_wire_batch(m_port, direction="up")
        np.testing.assert_array_equal(b_port.words, b_ref.words)
        np.testing.assert_array_equal(b_port.bit_len, b_ref.bit_len)
        np.testing.assert_array_equal(b_port.nnz, b_ref.nnz)
        assert port.measured_batch_bits(b_port) == \
            ref.measured_batch_bits(b_ref)
        d_ref = ref.encode_wire(g_ref, direction="down")
        d_port = port.encode_wire(g_port, direction="down")
        np.testing.assert_array_equal(d_port.words, d_ref.words)
        assert port.measured_message_bits(d_port) == \
            ref.measured_message_bits(d_ref)
        for z in b_ref.nnz:
            assert port.wire_bound_bits(n, int(z), "up") == \
                ref.wire_bound_bits(n, int(z), "up")
        assert port.upload_bits(n) == ref.upload_bits(n)
        assert port.download_bits(n, P) == ref.download_bits(n, P)


@pytest.mark.parametrize("name", ["logreg", "mlp", "cnn", "lstm"])
def test_local_sgd_matches_reference_encode_phase(name):
    """One local step for a cohort of 3 through the reference's jitted
    encode phase (with an identity codec) and the port's local_sgd."""
    shapes = {"logreg": (784,), "mlp": (784,), "cnn": (32, 32, 3),
              "lstm": (28, 28)}
    P, b = 3, 4
    params = REF_ZOO[name][0](jax.random.PRNGKey(2))
    vec, spec = ref_flatten(params)
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((P, 1, b) + shapes[name]).astype(np.float32)
    ys = rng.integers(0, 10, (P, 1, b)).astype(np.int32)
    identity = ref_make_protocol("baseline")
    enc = ref_build_encode(identity, REF_ZOO[name][1], spec, 0.05, 0.0)
    want, _, _ = enc(vec, jnp.zeros((P, vec.size)), None, jnp.asarray(xs),
                     jnp.asarray(ys))

    pvec, pspec = flatten_pytree(params_from_jax(
        jax.tree.map(np.asarray, params)))
    got, mom = local_sgd(MODEL_ZOO[name][1], pspec, pvec,
                         torch.zeros((P, pvec.numel())),
                         torch.from_numpy(xs),
                         torch.from_numpy(ys.astype(np.int64)), 0.05, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-4)
    np.testing.assert_allclose(-0.05 * mom.numpy(), got.numpy(), atol=1e-6,
                               rtol=1e-4)


def _data():
    return make_classification(seed=0, n=2000), \
        ref_make_classification(seed=0, n=2000)


def test_data_and_splits_identical():
    (train, test), (ref_train, ref_test) = _data()
    np.testing.assert_array_equal(train.x, ref_train.x)
    np.testing.assert_array_equal(test.y, ref_test.y)
    env = FedEnvironment(n_clients=10, participation=1.0,
                         classes_per_client=2, batch_size=20)
    from repro.fed.environment import split_data as ref_split
    for a, b in zip(split_data(train.y, env, seed=0),
                    ref_split(ref_train.y, env, seed=0)):
        np.testing.assert_array_equal(a, b)


def _end_to_end_logreg(backend, ingest):
    """20 rounds of both trainers from the reference's initial
    parameters; returns (reference history row, port history row, port)."""
    (train, test), (ref_train, ref_test) = _data()
    kw = dict(n_clients=10, participation=1.0, classes_per_client=2,
              batch_size=20)
    p = 1 / 50
    init = jax.tree.map(np.asarray,
                        REF_ZOO["logreg"][0](jax.random.PRNGKey(0)))
    ref = RefTrainer(REF_ZOO["logreg"], ref_train, ref_test, RefEnv(**kw),
                     ref_make_protocol("stc", sparsity_up=p, sparsity_down=p),
                     RefConfig(lr=0.05, ingest=ingest))
    h_ref = ref.run(20, eval_every=20)[-1]
    port = FederatedTrainer(
        (lambda gen: params_from_jax(init), MODEL_ZOO["logreg"][1]),
        train, test, FedEnvironment(**kw),
        make_protocol("stc", sparsity_up=p, sparsity_down=p,
                      backend=backend, wire_backend="kernel"),
        TrainerConfig(lr=0.05, ingest=ingest), device="cpu")
    return h_ref, port.run(20, eval_every=20)[-1], port


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_end_to_end_logreg_matches_reference(backend):
    h_ref, h, port = _end_to_end_logreg(backend, ingest=False)
    assert abs(h["acc"] - h_ref["acc"]) <= 0.03
    assert abs(h["bits_up"] / h_ref["bits_up"] - 1) <= 0.02
    assert abs(h["bits_down"] / h_ref["bits_down"] - 1) <= 0.02
    assert h["bits_up_analytic"] == h_ref["bits_up_analytic"]
    assert len(port.wire_log) == 20
    for row in port.wire_log:
        assert row["bits_up"] <= row["bits_up_bound"]
        assert row["bits_down_per_update"] <= \
            row["bits_down_per_update_bound"]
    assert h["acc"] > 0.5                  # it learns


def _tiny_trainer(**cfg):
    train, test = make_classification(seed=0, n=200, n_test=50)
    env = FedEnvironment(n_clients=4, participation=0.5,
                         classes_per_client=2, batch_size=5)
    return FederatedTrainer(MODEL_ZOO["logreg"], train, test, env,
                            make_protocol("stc", sparsity_up=0.01,
                                          sparsity_down=0.01),
                            TrainerConfig(**cfg), device="cpu")


def test_end_to_end_ingest_matches_reference_ingest():
    """``ingest=True`` in both packages: the port's fused ingest (decode
    through the "kernel" wire backend on the CPU) against the reference's."""
    h_ref, h, port = _end_to_end_logreg("kernel", ingest=True)
    assert port.ingest
    assert abs(h["acc"] - h_ref["acc"]) <= 0.03
    assert abs(h["bits_up"] / h_ref["bits_up"] - 1) <= 0.02
    assert h["bits_up_analytic"] == h_ref["bits_up_analytic"]
    assert len(port.wire_log) == 20
    assert h["acc"] > 0.5


def _ingest_parts():
    train, test = make_classification(seed=0, n=600, n_test=160)
    env = FedEnvironment(n_clients=6, participation=0.5,
                         classes_per_client=2, batch_size=10)
    return train, test, env


@pytest.mark.parametrize("wire_backend", ["numpy", "kernel"])
@pytest.mark.parametrize("name", ["stc", "signsgd"])
def test_ingest_matches_dense(name, wire_backend):
    train, test, env = _ingest_parts()
    kw = dict(sparsity_up=1 / 8, sparsity_down=1 / 8) if name == "stc" \
        else {}
    accs, bits = [], []
    for ingest in (False, True):
        tr = FederatedTrainer(MODEL_ZOO["logreg"], train, test, env,
                              make_protocol(name, wire_backend=wire_backend,
                                            **kw),
                              TrainerConfig(lr=0.05, seed=0, ingest=ingest),
                              device="cpu")
        assert tr.ingest == ingest
        hist = tr.run(2, eval_every=2)
        accs.append(hist[-1]["acc"])
        bits.append(tr.bits_up)
        assert torch.isfinite(tr.params_vec).all()
    assert accs[0] == accs[1]
    assert bits[0] == bits[1]


def test_ingest_with_non_streaming_rule_warns_and_falls_back():
    @dataclasses.dataclass(frozen=True)
    class GatheredMean(MeanRule):
        name: ClassVar[str] = "gathered-mean"
        supports_streaming: ClassVar[bool] = False

    train, test, env = _ingest_parts()
    runs = []
    for rule, ingest in ((GatheredMean(), True), ("mean", False)):
        proto = make_protocol("stc", sparsity_up=1 / 8, sparsity_down=1 / 8,
                              rule=rule)
        cfg = TrainerConfig(lr=0.05, ingest=ingest)
        if ingest:
            with pytest.warns(RuntimeWarning, match="cannot stream"):
                tr = FederatedTrainer(MODEL_ZOO["logreg"], train, test, env,
                                      proto, cfg, device="cpu")
            assert not tr.ingest
        else:
            tr = FederatedTrainer(MODEL_ZOO["logreg"], train, test, env,
                                  proto, cfg, device="cpu")
        tr.run(2, eval_every=2)
        runs.append(tr)
    assert torch.equal(runs[0].params_vec, runs[1].params_vec)
    assert runs[0].bits_up == runs[1].bits_up


def test_ingest_on_codec_without_ingest_path_is_loud():
    from repro_torch.core import StcCodec

    @dataclasses.dataclass(frozen=True)
    class NoIngest(StcCodec):
        supports_ingest: ClassVar[bool] = False

    train, test, env = _ingest_parts()
    with pytest.raises(ValueError, match="no ingest path"):
        FederatedTrainer(MODEL_ZOO["logreg"], train, test, env, NoIngest(),
                         TrainerConfig(ingest=True), device="cpu")


@pytest.mark.parametrize("cfg", [{"chunks": "whole"}, {"chunks": 64},
                                 {"controller": "fixed"},
                                 {"p_fn": lambda name, depth: None}])
def test_unported_options_raise(cfg):
    """The options that raised NotImplementedError before the chunked
    codecs were ported now behave as the reference's: chunks wrap the
    codec, a controller without chunks is a ValueError, and a p_fn without
    chunks is ignored.  None raises NotImplementedError."""
    if "controller" in cfg:
        with pytest.raises(ValueError, match="chunks"):
            _tiny_trainer(**cfg)
        return
    tr = _tiny_trainer(lr=0.05, **cfg)
    assert (tr.protocol.name == "chunked") == ("chunks" in cfg)
    tr.run(1, eval_every=1)
    assert torch.isfinite(tr.params_vec).all() and tr.bits_up > 0


def test_partial_participation_round_and_ledger():
    tr = _tiny_trainer(lr=0.05)
    hist = tr.run(3, eval_every=1)
    assert [h["round"] for h in hist] == [1, 2, 3]
    assert tr.bits_up > 0 and tr.bits_down > 0
    assert torch.isfinite(tr.params_vec).all()
    assert tr.client_state.residual.shape == (4, tr.numel)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    train, test = make_classification(seed=0, n=200, n_test=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FederatedTrainer(MODEL_ZOO["logreg"], train, test,
                         FedEnvironment(n_clients=4),
                         make_protocol("stc"), TrainerConfig())


def test_residual_state_layout():
    """The reference's residual init and the port's agree in layout."""
    ref_state = ref_init_residual(jnp.zeros((10,), jnp.float32))
    port_state = make_protocol("stc").init_client_state(10, "cpu")
    np.testing.assert_array_equal(port_state.residual.numpy(),
                                  np.asarray(ref_state.residual))


def _both_trainers(codec, proto_kw, env_kw, cfg_kw, *, backend="kernel",
                   data_n=2000, rounds=10, ref_cfg_kw=None):
    """Both packages' trainers on logreg from the reference's initial
    parameters (``ref_cfg_kw``: the reference's config keywords where they
    differ from ``cfg_kw``); returns (reference, port, their last history
    rows)."""
    kw = dict(n_clients=10, participation=1.0, classes_per_client=2,
              batch_size=20)
    kw.update(env_kw)
    n_kw = {} if data_n is None else {"n": data_n}
    train, test = make_classification(seed=0, **n_kw)
    ref_train, ref_test = ref_make_classification(seed=0, **n_kw)
    init = jax.tree.map(np.asarray,
                        REF_ZOO["logreg"][0](jax.random.PRNGKey(0)))
    ref = RefTrainer(REF_ZOO["logreg"], ref_train, ref_test, RefEnv(**kw),
                     ref_make_protocol(codec, **proto_kw),
                     RefConfig(lr=0.05, **(cfg_kw if ref_cfg_kw is None
                                           else ref_cfg_kw)))
    h_ref = ref.run(rounds, eval_every=rounds)[-1]
    extra = {"backend": backend} if codec == "stc" else {}
    port = FederatedTrainer(
        (lambda gen: params_from_jax(init), MODEL_ZOO["logreg"][1]),
        train, test, FedEnvironment(**kw),
        make_protocol(codec, **proto_kw, **extra),
        TrainerConfig(lr=0.05, **cfg_kw), device="cpu")
    return ref, port, h_ref, port.run(rounds, eval_every=rounds)[-1]


_LEDGER = ("bits_up", "bits_down", "bits_up_analytic", "bits_down_analytic")
_P50 = dict(sparsity_up=1 / 50, sparsity_down=1 / 50)


@pytest.mark.parametrize("codec,proto_kw,env_kw,cfg_kw", [
    ("stc", _P50, {}, {"momentum": 0.9}),
    ("stc", dict(_P50, local_iters=3), {}, {}),
    ("stc", _P50, {"participation": 0.5}, {}),
    ("signsgd", {}, {}, {}),
    ("signsgd", {}, {}, {"measure_bits": False}),
], ids=["momentum", "local_iters", "participation", "signsgd",
        "signsgd_analytic"])
def test_settings_agree_with_reference_exactly(codec, proto_kw, env_kw,
                                               cfg_kw):
    ref, port, h_ref, h = _both_trainers(codec, proto_kw, env_kw, cfg_kw)
    assert h["acc"] == h_ref["acc"]
    for col in _LEDGER:
        assert h[col] == h_ref[col], col
    np.testing.assert_allclose(port.params_vec.numpy(),
                               np.asarray(ref.params_vec), rtol=0,
                               atol=1e-7)


_R4_PROTO = dict(sparsity_up=1 / 400, sparsity_down=1 / 20)


@pytest.mark.parametrize("data_n", [2000, None], ids=["n2000", "n_default"])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_r4_trainers_agree_on_what_holds(backend, data_n):
    """R4's setting (P = 1, k_up = 19 < k_down = 392): the downlink takes
    one of two modes (the ulp residuals of µ either stack up or do not),
    so ``bits_down`` is not compared.  The analytic columns and the first
    round's measured ledger are equal and ``bits_up`` is within 2 %."""
    ref, port, h_ref, h = _both_trainers(
        "stc", _R4_PROTO, {"participation": 0.1}, {}, backend=backend,
        data_n=data_n)
    assert h["bits_up_analytic"] == h_ref["bits_up_analytic"]
    assert h["bits_down_analytic"] == h_ref["bits_down_analytic"]
    assert port.wire_log[0] == ref.wire_log[0]
    assert abs(h["bits_up"] / h_ref["bits_up"] - 1) <= 0.02


def _r4_rows(rows, n, nnz, seed):
    """``rows`` rows of ``nnz`` non-zeros of one magnitude (one a row) with
    random signs: the server's carried vector of R4."""
    rng = np.random.default_rng(seed)
    x = np.zeros((rows, n), np.float32)
    mags = rng.uniform(1e-4, 1.0, rows).astype(np.float32)
    for row in range(rows):
        at = rng.choice(n, nnz, replace=False)
        x[row, at] = mags[row] * np.sign(rng.standard_normal(nnz))
    return x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_r4_fewer_nonzeros_than_k_contract(backend, seed):
    """300 rows of 19 equal magnitudes at n = 7850, p = 1/20 (k = 392):
    thresholds, counts and masks exact against ``"jnp"``, µ within rtol
    1e-6, and every residual zero or within 1e-6 of µ (on both sides)."""
    n, p = 7850, 1 / 20
    x = _r4_rows(300, n, 19, seed)
    zeros = np.zeros_like(x)
    jnp_be = ref_backend("jnp")
    tern_j, res_j, st_j = jnp_be.compress_with_residual_batch(
        jnp.asarray(x), jnp.asarray(zeros), p)
    t_j, c_j, _ = jnp_be.select_batch(jnp.asarray(x), int(n * p))
    be = get_stc_backend(backend)
    tern, res, st = be.compress_with_residual_batch(
        torch.from_numpy(x), torch.from_numpy(zeros), p)
    t, c, _ = be.select_batch(torch.from_numpy(x), int(n * p))
    np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
    assert (c.numpy() == 19).all()
    np.testing.assert_array_equal(np.sign(tern.numpy()),
                                  np.sign(np.asarray(tern_j)))
    np.testing.assert_array_equal(st.nnz.numpy(), np.asarray(st_j.nnz))
    mu, mu_j = st.mu.numpy(), np.asarray(st_j.mu)
    np.testing.assert_allclose(mu, mu_j, rtol=1e-6)
    for got, m in ((res.numpy(), mu), (np.asarray(res_j), mu_j)):
        assert np.all(np.abs(got) <= 1e-6 * m[:, None])


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_r4_lockstep_thresholds_and_counts(backend):
    """The R4 codec setting (one client, p_up = 1/400, p_down = 1/20) for
    10 rounds, the port fed the reference's residuals each round: client
    and server thresholds, counts and masks exact, µ within rtol 1e-6."""
    n = 7850
    ref = ref_make_protocol("stc", backend="jnp", **_R4_PROTO)
    port = make_protocol("stc", backend=backend, **_R4_PROTO)
    sel, sel_j = get_stc_backend(backend).select_batch, \
        ref_backend("jnp").select_batch
    k_up = max(int(n * _R4_PROTO["sparsity_up"]), 1)
    k_down = max(int(n * _R4_PROTO["sparsity_down"]), 1)

    def same_selection(x, k):
        t, c, _ = sel(torch.from_numpy(x), k)
        t_j, c_j, _ = sel_j(jnp.asarray(x), k)
        np.testing.assert_array_equal(t.numpy(), np.asarray(t_j))
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
        return int(c[0])

    ref_cs = ref_stack_states(ref.init_client_state(n), 1)
    ref_ss = ref.init_server_state(n)
    one, zero = np.ones(1, np.float32), np.zeros(1, np.float32)
    rng = np.random.default_rng(4)
    for _ in range(10):
        delta = (rng.standard_normal((1, n)) * 1e-2).astype(np.float32)
        client_res = np.array(ref_cs.residual)
        same_selection(delta + client_res, k_up)
        m_port, _, st = port.encode_batch(
            torch.from_numpy(delta),
            ResidualState(torch.from_numpy(client_res)))
        m_ref, ref_cs, st_j = ref.encode_batch(jnp.asarray(delta), ref_cs)
        m_ref = np.array(m_ref)
        np.testing.assert_array_equal(np.sign(m_port.numpy()),
                                      np.sign(m_ref))
        np.testing.assert_array_equal(st.nnz.numpy(), np.asarray(st_j.nnz))
        np.testing.assert_allclose(st.mu.numpy(), np.asarray(st_j.mu),
                                   rtol=1e-6)

        server_res = np.array(ref_ss.residual)
        assert same_selection((m_ref[0] + server_res)[None], k_down) \
            < k_down                                      # R4's regime
        g_port, _, sg = port.aggregate(
            torch.from_numpy(m_ref),
            ResidualState(torch.from_numpy(server_res)),
            mask=torch.from_numpy(one), staleness=torch.from_numpy(zero))
        g_ref, ref_ss, sg_j = ref.aggregate(
            jnp.asarray(m_ref), ref_ss, mask=jnp.asarray(one),
            staleness=jnp.asarray(zero))
        np.testing.assert_array_equal(np.sign(g_port.numpy()),
                                      np.sign(np.asarray(g_ref)))
        assert int(sg.nnz) == int(sg_j.nnz)
        np.testing.assert_allclose(float(sg.mu), float(sg_j.mu), rtol=1e-6)
