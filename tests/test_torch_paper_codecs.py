"""Port parity of the paper's comparison codecs (Table I): ``baseline``,
``fedavg``, ``topk`` and ``ternquant``, their operators, and
``make_protocol``'s keyword handling.

Operators on seeded numpy rows (normal, heavy-tailed, fewer non-zeros
than k, all-zero, subnormals among a few normals), each against the
reference on the same row:

* ``top_k_sparsify`` and ``TopKCodec`` bitwise: message, mask, count and
  the error-feedback residual (3 lock-step rounds);
* ``ternary_quantize`` and ``TernQuantCodec``: masks exact, µ within
  rtol 1e-6.  The port sums |x| and the kept magnitudes in fp64 and rounds
  once; the reference reduces in fp32 in XLA's order, so µ (and Δ) may
  differ in the last ulps (ROADMAP R7).  Messages and residuals are held
  to 1e-6 of ``|value| + µ``.

The analytic ledger of every codec, registration, and the three override
behaviours of ``make_protocol`` (declared fields pass, inert legacy fields
drop, a legacy field contradicting a ClassVar raises ``ValueError``,
anything else ``TypeError``) are compared with the reference's.

Trainers (logreg, 10 rounds, from the reference's initial parameters):
accuracy and the four ledger columns equal to the reference's, parameters
within 1e-7, TernQuant's too (its ulp-level µ moved them by at most 3.7e-9
here).  The example twin runs every codec for 2 rounds on the CPU.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as ref
from repro.core import make_protocol as ref_make_protocol
from repro.core import registered_protocols as ref_registered
from repro.core.residual import stack_states as ref_stack_states
from repro_torch.core import compression as port
from repro_torch.core import make_protocol, registered_protocols
from repro_torch.core.residual import ResidualState
from test_torch_fed_loop import _LEDGER, _both_trainers

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CASES = ["normal", "heavy", "sparse", "zeros", "subnormal"]
MU_RTOL = 1e-6


def _row(case, rng, n):
    if case == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if case == "heavy":
        return rng.standard_t(1.5, n).astype(np.float32)
    x = np.zeros(n, np.float32)
    if case == "sparse":                      # 3 non-zeros, fewer than k
        x[rng.choice(n, 3, replace=False)] = rng.standard_normal(3)
    elif case == "subnormal":                 # 5 normals among subnormals
        x = (rng.standard_normal(n) * 1e-40).astype(np.float32)
        x[rng.choice(n, 5, replace=False)] = rng.standard_normal(5)
    return x


def _rows(case, seed, rows, n):
    rng = np.random.default_rng(seed)
    return np.stack([_row(case, rng, n) for _ in range(rows)])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ------------------------------------------------------------- operators

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("p", [1 / 50, 1 / 400])
def test_top_k_sparsify_bitwise(case, p):
    x = _rows(case, 0, 3, 3000)
    out, st = port.top_k_sparsify_batch(torch.from_numpy(x), p)
    for i in range(x.shape[0]):
        want, wst = ref.top_k_sparsify(jnp.asarray(x[i]), p)
        np.testing.assert_array_equal(_bits(out[i].numpy()), _bits(want))
        assert int(st.nnz[i]) == int(wst.nnz)
        got1, st1 = port.top_k_sparsify(torch.from_numpy(x[i]), p)
        np.testing.assert_array_equal(_bits(got1.numpy()), _bits(want))
        assert int(st1.nnz) == int(wst.nnz) and float(st1.mu) == 0.0
    if case == "sparse":
        assert (st.nnz.numpy() == 3).all()


@pytest.mark.parametrize("case", CASES)
def test_ternary_quantize_masks_exact_mu_close(case):
    x = _rows(case, 1, 3, 3000)
    out, st = port.ternary_quantize_batch(torch.from_numpy(x))
    for i in range(x.shape[0]):
        want, wst = ref.ternary_quantize(jnp.asarray(x[i]))
        want = np.asarray(want)
        got = out[i].numpy()
        np.testing.assert_array_equal(got != 0, want != 0)
        np.testing.assert_array_equal(np.sign(got), np.sign(want))
        assert int(st.nnz[i]) == int(wst.nnz)
        np.testing.assert_allclose(float(st.mu[i]), float(wst.mu),
                                   rtol=MU_RTOL)
        got1, st1 = port.ternary_quantize(torch.from_numpy(x[i]))
        assert torch.equal(got1, out[i]) and torch.equal(st1.mu, st.mu[i])


def test_ternary_quantize_mask_is_strictly_above_delta():
    """``|x| > Δ``: a magnitude exactly at Δ = 0.75 · mean|x| stays out."""
    x = np.float32([4.0, -4.0, 1.0, 3.0])        # mean 3, Δ = 2.25
    x[2] = 2.25
    out, st = port.ternary_quantize(torch.from_numpy(x))
    want, _ = ref.ternary_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert int(st.nnz) == 3


def _close(got, want, mu):
    tol = MU_RTOL * (np.abs(want) + np.abs(np.asarray(mu))[..., None])
    assert np.all(np.abs(got - want) <= tol + 1e-30)


def _lockstep(name, case, rounds=3, P=4, n=3000):
    """Both packages' codecs on the same deltas for ``rounds`` rounds, each
    carrying its own client and server state; yields the round's outputs
    as numpy (reference, port)."""
    kw = {"topk": dict(sparsity_up=1 / 50)}.get(name, {})
    rcodec, pcodec = ref_make_protocol(name, **kw), make_protocol(name, **kw)
    rcs = ref_stack_states(rcodec.init_client_state(n), P)
    rss = rcodec.init_server_state(n)
    pcs = (ResidualState(torch.zeros((P, n))) if pcodec.error_feedback
           else None)
    pss = pcodec.init_server_state(n, "cpu")
    for r in range(rounds):
        d = _rows(case, 10 + r, P, n)
        rm, rcs, rst = rcodec.encode_batch(jnp.asarray(d), rcs)
        pm, pcs, pst = pcodec.encode_batch(torch.from_numpy(d), pcs)
        rg, rss, rsg = rcodec.aggregate(rm, rss)
        pg, pss, psg = pcodec.aggregate(pm, pss)
        yield ({"msgs": np.asarray(rm),
                "res": None if rcs is None else np.asarray(rcs.residual),
                "nnz": np.asarray(rst.nnz), "mu": np.asarray(rst.mu),
                "gd": np.asarray(rg),
                "sres": None if rss is None else np.asarray(rss.residual),
                "smu": np.asarray(rsg.mu)},
               {"msgs": pm.numpy(),
                "res": None if pcs is None else pcs.residual.numpy(),
                "nnz": pst.nnz.numpy(), "mu": pst.mu.numpy(),
                "gd": pg.numpy(),
                "sres": None if pss is None else pss.residual.numpy(),
                "smu": psg.mu.numpy()})


@pytest.mark.parametrize("case", CASES)
def test_topk_codec_lockstep_bitwise(case):
    for want, got in _lockstep("topk", case):
        np.testing.assert_array_equal(_bits(got["msgs"]), _bits(want["msgs"]))
        np.testing.assert_array_equal(got["msgs"] != 0, want["msgs"] != 0)
        np.testing.assert_array_equal(got["nnz"], want["nnz"])
        np.testing.assert_array_equal(_bits(got["res"]), _bits(want["res"]))
        # topk aggregates by the plain mean, no downstream compression
        np.testing.assert_array_equal(_bits(got["gd"]), _bits(want["gd"]))


@pytest.mark.parametrize("case", CASES)
def test_ternquant_codec_lockstep(case):
    for want, got in _lockstep("ternquant", case):
        for key, res, mu in (("msgs", "res", "mu"), ("gd", "sres", "smu")):
            np.testing.assert_array_equal(got[key] != 0, want[key] != 0)
            np.testing.assert_array_equal(np.sign(got[key]),
                                          np.sign(want[key]))
            np.testing.assert_allclose(got[mu], want[mu], rtol=MU_RTOL)
            _close(got[key], want[key], want[mu])
            _close(got[res], want[res], want[mu])
        np.testing.assert_array_equal(got["nnz"], want["nnz"])


@pytest.mark.parametrize("name", ["baseline", "fedavg"])
def test_dense_codecs_lockstep_bitwise(name):
    for want, got in _lockstep(name, "heavy"):
        assert got["res"] is None and want["res"] is None
        np.testing.assert_array_equal(_bits(got["msgs"]), _bits(want["msgs"]))
        np.testing.assert_array_equal(_bits(got["gd"]), _bits(want["gd"]))
        np.testing.assert_array_equal(got["nnz"], want["nnz"])


def test_ternquant_dense_ingest_is_its_aggregate():
    """TernQuant's dense ingest (accumulator, then ``finalize_ingest``)
    against the reference's on the same messages and fp64 weights: the
    accumulator bitwise, the finalized masks exact and µ within rtol."""
    rcodec, pcodec = ref_make_protocol("ternquant"), make_protocol(
        "ternquant")
    msgs = _rows("heavy", 5, 4, 2000)
    w = np.array([1.0, 0.5, 2 ** -0.5, 1.0])
    accs = [rcodec.make_ingest(2000), pcodec.make_ingest(2000)]
    for codec, acc in zip((rcodec, pcodec), accs):
        for m, wi in zip(msgs, w):
            codec.ingest_dense(acc, m, float(wi))
    np.testing.assert_array_equal(accs[0].sum, accs[1].sum)
    rg, _, rst = rcodec.aggregate_ingest(accs[0],
                                         rcodec.init_server_state(2000))
    pg, _, pst = pcodec.aggregate_ingest(accs[1],
                                         pcodec.init_server_state(2000, "cpu"))
    np.testing.assert_array_equal(pg.numpy() != 0, np.asarray(rg) != 0)
    np.testing.assert_allclose(float(pst.mu), float(rst.mu), rtol=MU_RTOL)


# ------------------------------------------------ registry and the ledger

NAMES = ["baseline", "fedavg", "signsgd", "topk", "stc", "ternquant"]


def test_registered_protocols_match_reference():
    assert registered_protocols() == ref_registered()
    from repro.core.protocols import _REGISTRY as ref_registry
    from repro_torch.core.protocols import _REGISTRY as port_registry
    assert list(port_registry) == list(ref_registry) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_analytic_ledger_matches_reference(name):
    kw = {"topk": dict(sparsity_up=1 / 50),
          "stc": dict(sparsity_up=1 / 50, sparsity_down=1 / 400)}.get(
              name, {})
    rc, pc = ref_make_protocol(name, **kw), make_protocol(name, **kw)
    for numel in (1, 17, 1000, 79_510, 307_434):
        assert pc.upload_bits(numel) == rc.upload_bits(numel)
        for n_part in (1, 10, 100, 10_000):
            assert pc.download_bits(numel, n_participating=n_part) == \
                rc.download_bits(numel, n_participating=n_part)


def _outcome(factory, name, kw):
    try:
        codec = factory(name, **kw)
    except (TypeError, ValueError) as exc:
        return type(exc).__name__, str(exc)
    return "ok", {k: getattr(codec, k) for k in
                  ("local_iters", "staleness_decay", "error_feedback")}


@pytest.mark.parametrize("name,kw,kind", [
    ("signsgd", dict(sparsity_up=0.1), "ok"),            # legacy, inert
    ("topk", dict(backend="jnp", sparsity_down=0.1), "ok"),
    ("fedavg", dict(local_iters=10, sign_step=1e-3), "ok"),
    ("stc", dict(error_feedback=True), "ok"),            # legacy, agrees
    ("stc", dict(error_feedback=False), "ValueError"),   # contradicts
    ("baseline", dict(error_feedback=True), "ValueError"),
    ("stc", dict(sparsity=0.1), "TypeError"),            # unknown
    ("ternquant", dict(theta=0.5, wire_backend="kernel"), "TypeError"),
])
def test_make_protocol_overrides_match_reference(name, kw, kind):
    got, want = _outcome(make_protocol, name, kw), _outcome(
        ref_make_protocol, name, kw)
    assert got[0] == want[0] == kind
    if kind == "TypeError":
        # the declared fields differ (the reference keeps its deprecated
        # norm_bound / norm_policy); the message names the field and them
        bad = next(k for k in kw if k not in ("theta",))
        assert repr(bad) in got[1] and "declared fields" in got[1]
    else:
        assert got[1] == want[1]


def test_make_protocol_keeps_declared_fields():
    codec = make_protocol("topk", sparsity_up=1 / 50, sparsity_down=0.5,
                          local_iters=3)
    assert codec.sparsity_up == 1 / 50 and codec.local_iters == 3
    assert not hasattr(codec, "sparsity_down")
    assert make_protocol("ternquant", theta=0.5).theta == 0.5


# ---------------------------------------------------------------- trainers

@pytest.mark.parametrize("codec,proto_kw,cfg_kw", [
    ("baseline", {}, {}),
    ("fedavg", dict(local_iters=3), {}),
    ("topk", dict(sparsity_up=1 / 50), {}),
    ("ternquant", {}, {}),
    ("ternquant", {}, {"ingest": True}),
], ids=["baseline", "fedavg", "topk", "ternquant", "ternquant_ingest"])
def test_trainers_agree_with_reference(codec, proto_kw, cfg_kw):
    ref_tr, tr, h_ref, h = _both_trainers(codec, proto_kw, {}, cfg_kw)
    assert tr.ingest == bool(cfg_kw.get("ingest"))
    assert h["acc"] == h_ref["acc"]
    for col in _LEDGER:
        assert h[col] == h_ref[col], col
    assert not h["measured"]                   # wire-less: analytic ledger
    np.testing.assert_allclose(tr.params_vec.numpy(),
                               np.asarray(ref_tr.params_vec), rtol=0,
                               atol=1e-7)


def test_ternquant_ingest_equals_its_dense_run():
    """Inside the port, TernQuant's dense ingest reproduces its dense
    aggregate: the fp64 accumulator's mean rounds to the fp32 weighted
    mean of the dense combine on these rounds."""
    runs = [_both_trainers("ternquant", {}, {}, {"ingest": ingest},
                           rounds=3)[1] for ingest in (False, True)]
    np.testing.assert_allclose(runs[0].params_vec.numpy(),
                               runs[1].params_vec.numpy(), rtol=0, atol=1e-6)
    assert runs[0].bits_up == runs[1].bits_up


# ----------------------------------------------------------------- example

def test_example_twin_runs_every_codec():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "federated_noniid_torch.py"),
         "--rounds", "2", "--model", "logreg", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    rows = [line.split() for line in out.stdout.splitlines()]
    names = [r[0] for r in rows if r and r[0] in NAMES]
    assert names == sorted(NAMES)
    for r in rows:
        if r and r[0] in NAMES:
            assert 0.0 <= float(r[1]) <= 1.0
