"""Port parity of the adaptive per-chunk sparsity controllers.

Held against the JAX package on numpy inputs made from a seed:

* the registry (names, hyphen/underscore resolution, instances passing
  through, overrides), the hyperparameter validation and
  ``validate_sparsity`` raise and accept as the reference does, and
  ``caps`` is the reference's;
* both controllers' per-chunk ks and the SNR controller's EMA state equal
  the reference's exactly, for client states ``(R, C)``, the server's
  ``(C,)`` and no state, on carried blocks with padded, all-zero and
  subnormal chunks (the port sums the energies in fp64 and rounds once;
  on these inputs the reference's fp32 sums round to the same ks);
* the adaptive STC codec in lock-step with the reference's for 3 rounds,
  on the ``"kernel"`` and ``"torch"`` routes: per-chunk counts and masks
  exact, µ within rtol 1e-6, the controller state exact;
* trainers (logreg, 10 rounds, from the reference's initial parameters)
  with each controller, dense and ingest: accuracy and the four ledger
  columns equal, parameters within 1e-7; ``controller="fixed"`` is the
  static chunked path bit for bit, and the measured bits stay under the
  wire bound every round.
"""

import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive as ref_adaptive
from repro.core import chunk_codec as ref_chunk_codec
from repro.core import chunk_spec_from_sizes as ref_spec_from_sizes
from repro.core import make_protocol as ref_make_protocol
from repro.core.residual import stack_states as ref_stack_states
from repro_torch.core import adaptive
from repro_torch.core import make_protocol
from repro_torch.core.chunking import chunk_codec, chunk_spec_from_sizes
from repro_torch.core.residual import map_states, stack_states
from repro_torch.data import make_classification
from repro_torch.fed import FederatedTrainer, FedEnvironment, TrainerConfig
from repro_torch.models import MODEL_ZOO
from test_torch_fed_loop import _LEDGER, _P50, _both_trainers

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _error(fn):
    try:
        fn()
    except Exception as exc:                 # noqa: BLE001 -- compared
        return type(exc)
    return None


# ---------------------------------------------------------------------------
# registry, validation, geometry
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert adaptive.registered_controllers() == \
        ref_adaptive.registered_controllers()
    for name in ("fixed", "residual-mass", "residual_mass", "snr-constant",
                 "snr_constant"):
        got = adaptive.make_controller(name)
        want = ref_adaptive.make_controller(name)
        assert got.name == want.name
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.adapts, got.stateful) == (want.adapts, want.stateful)
    ctrl = adaptive.ResidualMassController(budget=0.5)
    assert adaptive.make_controller(ctrl) is ctrl
    assert adaptive.make_controller("residual_mass", budget=0.25).budget \
        == 0.25
    for bad in (("no-such-controller", {}), (ctrl, {"budget": 1.0}),
                (3, {})):
        assert _error(lambda: adaptive.make_controller(bad[0], **bad[1])) \
            is _error(lambda: ref_adaptive.make_controller(bad[0], **bad[1]))


@pytest.mark.parametrize("cls,kw", [
    ("ResidualMassController", dict(budget=0.0)),
    ("ResidualMassController", dict(budget=-1.0)),
    ("ResidualMassController", dict(budget=math.nan)),
    ("ResidualMassController", dict(budget=math.inf)),
    ("SnrConstantController", dict(snr=0.0)),
    ("SnrConstantController", dict(snr=math.nan)),
    ("SnrConstantController", dict(ema=1.0)),
    ("SnrConstantController", dict(ema=-0.1)),
    ("ResidualMassController", dict(k_max_scale=0.5)),
    ("ResidualMassController", dict(k_max_scale=math.inf)),
    ("SnrConstantController", dict(snr=2.0, ema=0.0, k_max_scale=1.0)),
])
def test_hyperparameter_validation_as_reference(cls, kw):
    got = _error(lambda: getattr(adaptive, cls)(**kw))
    want = _error(lambda: getattr(ref_adaptive, cls)(**kw))
    assert got is want


@pytest.mark.parametrize("p", [0.0, -0.25, 1.5, math.nan, math.inf, "dense",
                               None, 1.0, 1e-6, np.float32(0.5)])
def test_validate_sparsity_as_reference(p):
    got = _error(lambda: adaptive.validate_sparsity(p, "conv", 3))
    assert got is _error(lambda: ref_adaptive.validate_sparsity(p, "conv", 3))
    if got is None:
        assert adaptive.validate_sparsity(p, "c", 0) == \
            ref_adaptive.validate_sparsity(p, "c", 0)


def test_caps_geometry_matches_reference():
    rng = np.random.default_rng(0)
    base = rng.integers(1, 50, size=20)
    valid = base * rng.integers(1, 8, size=20)
    for name, kw in (("fixed", {}), ("residual_mass", {"k_max_scale": 3.0}),
                     ("snr_constant", {"k_max_scale": 1.5})):
        np.testing.assert_array_equal(
            adaptive.make_controller(name, **kw).caps(base, valid),
            ref_adaptive.make_controller(name, **kw).caps(base, valid))


# ---------------------------------------------------------------------------
# the controllers' ks and state
# ---------------------------------------------------------------------------


VALID = np.asarray([64, 64, 40, 64, 17, 64, 1, 64, 33])


def _carried(seed, R):
    """(R, C, W) carried blocks, zero past each chunk's valid length, with
    an all-zero chunk, a chunk a thousand times smaller than the rest and
    subnormals in another."""
    rng = np.random.default_rng(seed)
    C, W = len(VALID), int(VALID.max())
    x = (rng.standard_normal((R, C, W)) * 1e-2).astype(np.float32)
    x *= (np.arange(W)[None, None, :] < VALID[None, :, None])
    x[:, 3] = 0.0
    x[:, 5] *= np.float32(1e-3)
    x[:, 7, ::3] = np.float32(1e-39)
    x[:, 1] *= rng.standard_t(1.5, (R, W)).astype(np.float32)
    return x


CONTROLLERS = [("residual_mass", {}), ("residual_mass", {"budget": 0.5}),
               ("residual_mass", {"budget": 2.5, "k_max_scale": 2.0}),
               ("snr_constant", {}), ("snr_constant", {"snr": 1.0,
                                                       "ema": 0.0}),
               ("snr_constant", {"snr": 10.0, "ema": 0.9})]


@pytest.mark.parametrize("name,kw", CONTROLLERS)
def test_controller_ks_and_state_match_reference(name, kw):
    port = adaptive.make_controller(name, **kw)
    ref = ref_adaptive.make_controller(name, **kw)
    base_ks = np.maximum(VALID // 8, 1)
    caps = ref.caps(base_ks, VALID)
    np.testing.assert_array_equal(port.caps(base_ks, VALID), caps)
    for seed, R, state_kind in ((0, 4, "client"), (1, 1, "server"),
                                (2, 3, None)):
        x = _carried(seed, R)
        r_state = p_state = None
        if state_kind is not None and ref.stateful:
            r_state = ref.init_state(base_ks)
            p_state = port.init_state(base_ks, "cpu")
            np.testing.assert_array_equal(p_state.numpy(),
                                          np.asarray(r_state))
            if state_kind == "client":
                r_state = jnp.broadcast_to(r_state, (R, len(VALID)))
                p_state = p_state[None].expand(R, -1)
        for _ in range(3):               # the EMA state threads
            r_ks, r_state = ref.chunk_ks(jnp.asarray(x), r_state,
                                         base_ks=base_ks, caps=caps)
            p_ks, p_state = port.chunk_ks(torch.from_numpy(x), p_state,
                                          base_ks=base_ks, caps=caps)
            assert p_ks.dtype == torch.int32
            np.testing.assert_array_equal(p_ks.numpy(), np.asarray(r_ks))
            if r_state is None:
                assert p_state is None
            else:
                assert p_state.numpy().tobytes() == \
                    np.asarray(r_state).tobytes()
            x = x * np.float32(0.7) + _carried(seed + 5, R) * np.float32(0.3)
    assert np.all(p_ks.numpy() >= 1) and np.all(p_ks.numpy() <= caps)


def test_fixed_controller_ks_are_the_schedule():
    base_ks = np.asarray([3, 1, 4])
    x = torch.zeros((2, 3, 8))
    ks, st = adaptive.make_controller("fixed").chunk_ks(
        x, None, base_ks=base_ks, caps=base_ks)
    assert st is None and ks.shape == (2, 3)
    np.testing.assert_array_equal(ks.numpy(), [[3, 1, 4], [3, 1, 4]])


# ---------------------------------------------------------------------------
# the adaptive STC codec in lock-step with the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("controller", ["residual_mass", "snr_constant"])
@pytest.mark.parametrize("route", ["kernel", "torch"])
def test_adaptive_codec_lockstep(route, controller):
    sizes, P = [300, 0, 170, 33, 257], 4
    p = dict(sparsity_up=1 / 20, sparsity_down=1 / 20)
    ref_cc = ref_chunk_codec(ref_make_protocol("stc", **p),
                             ref_spec_from_sizes(sizes, chunk_size=64),
                             controller=controller)
    cc = chunk_codec(make_protocol("stc", backend=route, **p),
                     chunk_spec_from_sizes(sizes, chunk_size=64),
                     controller=controller)
    n = cc.spec.numel
    r_cs = ref_stack_states(ref_cc.init_client_state(n), P)
    r_ss = ref_cc.init_server_state(n)
    cs = stack_states(cc.init_client_state(n, "cpu"), P)
    ss = cc.init_server_state(n, "cpu")
    rng = np.random.default_rng(11)
    ones, zeros = np.ones(P, np.float32), np.zeros(P, np.float32)
    spec = cc.spec

    def per_chunk_nnz(m):
        return (spec.split(np.asarray(m)) != 0).sum(axis=-1)

    for _ in range(3):
        d = (rng.standard_normal((P, n)) * 1e-2).astype(np.float32)
        r_m, r_cs, _ = ref_cc.encode_batch(jnp.asarray(d), r_cs)
        m, cs, _ = cc.encode_batch(torch.from_numpy(d), cs)
        np.testing.assert_array_equal(np.sign(m.numpy()),
                                      np.sign(np.asarray(r_m)))
        np.testing.assert_array_equal(per_chunk_nnz(m.numpy()),
                                      per_chunk_nnz(r_m))
        np.testing.assert_allclose(m.numpy(), np.asarray(r_m), rtol=1e-6)
        r_g, r_ss, _ = ref_cc.aggregate(r_m, r_ss, mask=jnp.asarray(ones),
                                        staleness=jnp.asarray(zeros))
        g, ss, _ = cc.aggregate(m, ss, mask=torch.from_numpy(ones),
                                staleness=torch.from_numpy(zeros))
        np.testing.assert_array_equal(np.sign(g.numpy()),
                                      np.sign(np.asarray(r_g)))
        np.testing.assert_allclose(g.numpy(), np.asarray(r_g), rtol=1e-6)
        if controller == "snr_constant":
            for got, want in ((cs["ctrl"], r_cs["ctrl"]),
                              (ss["ctrl"], r_ss["ctrl"])):
                assert got.numpy().tobytes() == np.asarray(want).tobytes()


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,cfg", [
    ("kernel", {"chunks": 32, "controller": "residual_mass"}),
    ("torch", {"chunks": 32, "controller": "snr_constant"}),
    ("kernel", {"chunks": 4096, "controller": "snr_constant",
                "ingest": True}),
    ("torch", {"chunks": 32, "ingest": True,
               "controller": adaptive.ResidualMassController(budget=0.6)}),
], ids=["kernel_residual_mass", "torch_snr", "kernel_snr_ingest",
        "torch_residual_mass_ingest"])
def test_adaptive_trainer_agrees_with_reference_exactly(backend, cfg):
    ref_cfg = None
    if isinstance(cfg["controller"], adaptive.SparsityController):
        # each package takes its own controller instance
        ref_cfg = dict(cfg, controller=ref_adaptive.ResidualMassController(
            budget=cfg["controller"].budget))
    ref, port, h_ref, h = _both_trainers("stc", _P50, {}, cfg,
                                         backend=backend,
                                         ref_cfg_kw=ref_cfg)
    assert h["acc"] == h_ref["acc"]
    for col in _LEDGER:
        assert h[col] == h_ref[col], col
    assert port.wire_log == ref.wire_log
    for row in port.wire_log:
        assert row["bits_up"] <= row["bits_up_bound"]
    np.testing.assert_allclose(port.params_vec.numpy(),
                               np.asarray(ref.params_vec), rtol=0,
                               atol=1e-7)
    if port.protocol.controller.stateful:
        st = port.client_state
        assert set(st) == {"base", "ctrl"}
        assert st["ctrl"].shape == (10, port.protocol.spec.n_chunks)
        assert st["ctrl"].numpy().tobytes() == \
            np.asarray(ref.client_state["ctrl"]).tobytes()
        assert port.server_state["ctrl"].numpy().tobytes() == \
            np.asarray(ref.server_state["ctrl"]).tobytes()


def _tiny(cfg):
    train, test = make_classification(seed=0, n=600, n_test=120)
    env = FedEnvironment(n_clients=6, participation=0.5,
                         classes_per_client=2, batch_size=10)
    tr = FederatedTrainer(MODEL_ZOO["logreg"], train, test, env,
                          make_protocol("stc", sparsity_up=1 / 20,
                                        sparsity_down=1 / 20,
                                        wire_backend="kernel"),
                          TrainerConfig(lr=0.05, seed=0, **cfg),
                          device="cpu")
    tr.run(3, eval_every=3)
    return tr


def test_fixed_controller_is_the_static_chunked_path():
    static, fixed = _tiny({"chunks": 32}), _tiny({"chunks": 32,
                                                  "controller": "fixed"})
    assert torch.equal(static.params_vec, fixed.params_vec)
    for col in _LEDGER:
        assert getattr(static, col) == getattr(fixed, col)
    assert static.wire_log == fixed.wire_log


def test_adaptive_controllers_change_the_bit_spend():
    fixed = _tiny({"chunks": 256, "controller": "fixed"})
    lean = _tiny({"chunks": 256,
                  "controller": adaptive.ResidualMassController(budget=0.5)})
    assert lean.bits_up < fixed.bits_up
    snr = _tiny({"chunks": 256, "controller": "snr-constant"})
    assert snr.bits_up != fixed.bits_up
    for tr in (lean, snr):
        for row in tr.wire_log:
            assert row["bits_up"] <= row["bits_up_bound"]
    assert map_states(lambda x: x.shape, snr.client_state)["ctrl"] == \
        (6, snr.protocol.spec.n_chunks)
