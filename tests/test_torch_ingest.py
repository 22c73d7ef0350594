"""Port parity of the fused decode→aggregate ingest (core/ingest.py and the
codec ingest API), carrying over the contracts of tests/test_ingest.py.

Inside the port:

* fused == dense oracle, bitwise (accumulator sum, weight mass, global
  delta, server residual) for ``stc`` and ``signsgd`` on both wire
  backends (the ``"kernel"`` decode asked for the CPU), with a Hypothesis
  property (or its deterministic stub);
* the blocked decode equals the one-shot decode; the empty round is
  finite; corrupt payloads raise ``WireDecodeError`` on both backends;
  long unary runs and µ = 0 decode exactly.

Across packages, on the same messages and the same fp64 weights (numpy,
so no fp32 ``pow`` can differ): wire words byte-identical; the
accumulator's ``sum``, ``weight_mass`` and ``combined()`` bitwise the
reference's; after ``finalize_ingest`` the threshold and count exact
against the reference's ``"jnp"`` backend and µ within rtol 1e-6.
``sign_compress`` and ``majority_vote_sign`` are bitwise the reference's.
"""

import dataclasses
import os
from typing import ClassVar

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # minimal deterministic fallback (see the stub)
    from _hypothesis_stub import given, settings, strategies as st

from repro.core import make_protocol as ref_make_protocol
from repro.core.compression import get_stc_backend as ref_stc_backend
from repro.core.compression import majority_vote_sign as ref_vote
from repro.core.compression import sign_compress as ref_sign
from repro_torch.core import (IngestAccumulator, StcCodec, make_protocol,
                              registered_protocols, wire)
from repro_torch.core.aggregation import AggregationRule, MeanRule
from repro_torch.core.compression import (get_stc_backend,
                                          majority_vote_sign, sign_compress)
from repro_torch.core.wire import WireDecodeError

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

DEMO = {"stc": dict(sparsity_up=1 / 8, sparsity_down=1 / 8)}
WIRE_BACKENDS = ["numpy", "kernel"]


def _codec(name, wire_backend="numpy", **kw):
    return make_protocol(name, wire_backend=wire_backend,
                         **{**DEMO.get(name, {}), **kw})


def _ref_codec(name):
    """The reference codec; its STC backend is ``"jnp"`` (Algorithm 1)."""
    kw = dict(DEMO[name], backend="jnp") if name in DEMO else {}
    return ref_make_protocol(name, **kw)


def _ingest_codecs():
    return [n for n in registered_protocols()
            if make_protocol(n).supports_ingest]


def _round_msgs(codec, P, numel, seed):
    """One round of real client messages (``torch`` STC backend); client
    P-1 is empty (an all-zero update, an empty wire message for stc)."""
    rng = np.random.default_rng(seed)
    deltas = rng.standard_normal((P, numel)).astype(np.float32)
    deltas[P - 1] = 0.0
    states = codec.init_client_state(numel, "cpu")
    if states is not None:
        states = type(states)(states.residual[None].repeat(P, 1))
    msgs, _, _ = codec.encode_batch(torch.from_numpy(deltas), states)
    return msgs


def _weights(P, seed, decay=0.5):
    """Masked + staleness-decayed combining weights, fp64 on the host."""
    rng = np.random.default_rng(seed + 7)
    mask = (rng.random(P) < 0.7).astype(np.float64)
    mask[0] = 1.0                       # at least one arrival
    stal = rng.integers(0, 4, size=P)
    return mask * (1.0 + stal) ** -decay


def _server_state(codec, numel):
    return codec.init_server_state(numel, "cpu")


def _assert_fused_is_oracle(codec, numel, seed, P=4):
    msgs = _round_msgs(codec, P, numel, seed)
    w = _weights(P, seed)
    batch = codec.encode_wire_batch(msgs, direction="up")
    fused = codec.make_ingest(numel)
    codec.ingest_wire_batch(fused, batch, w, direction="up", device="cpu")
    oracle = codec.make_ingest(numel)
    for i in range(P):
        codec.ingest_dense(oracle,
                           codec.decode_wire(batch.message(i), direction="up"),
                           float(w[i]))
    assert np.array_equal(fused.sum, oracle.sum)
    assert fused.weight_mass == oracle.weight_mass
    gd_f, st_f, _ = codec.aggregate_ingest(fused, _server_state(codec, numel))
    gd_o, st_o, _ = codec.aggregate_ingest(oracle,
                                           _server_state(codec, numel))
    assert torch.equal(gd_f, gd_o)
    if st_f is not None:
        assert torch.equal(st_f.residual, st_o.residual)


class TestFusedMatchesOracle:
    def test_ingest_codecs_registered(self):
        assert _ingest_codecs() == ["signsgd", "stc", "ternquant"]

    @pytest.mark.parametrize("wire_backend", WIRE_BACKENDS)
    @pytest.mark.parametrize("name", ["signsgd", "stc"])
    def test_registry_codecs(self, name, wire_backend):
        _assert_fused_is_oracle(_codec(name, wire_backend), numel=257, seed=0)

    @given(st.integers(40, 400), st.integers(0, 10 ** 6))
    @settings(max_examples=15, deadline=None)
    def test_stc_property(self, numel, seed):
        _assert_fused_is_oracle(_codec("stc", "kernel"), numel, seed)

    def test_empty_round(self):
        codec = _codec("stc")
        acc = codec.make_ingest(64)
        gd, _, _ = codec.aggregate_ingest(acc, _server_state(codec, 64))
        # no arrivals: the combined mean is zero (guarded denominator)
        assert torch.isfinite(gd).all() and not gd.any()

    def test_blocked_decode_matches_one_shot(self):
        codec = _codec("stc", "kernel")
        msgs = _round_msgs(codec, 4, 300, 3)
        w = _weights(4, 3)
        batch = codec.encode_wire_batch(msgs, direction="up")
        one = codec.make_ingest(300)
        codec.ingest_wire_batch(one, batch, w, direction="up", device="cpu")
        small = codec.make_ingest(300)
        try:
            type(codec).ingest_block_words = 1
            codec.ingest_wire_batch(small, batch, w, direction="up",
                                    device="cpu")
        finally:
            type(codec).ingest_block_words = 1 << 16
        assert np.array_equal(one.sum, small.sum)
        seq = codec.make_ingest(300)
        for i in range(4):
            codec.ingest_wire(seq, batch.message(i), float(w[i]),
                              direction="up", device="cpu")
        assert np.array_equal(one.sum, seq.sum)
        assert one.stream_bits == seq.stream_bits == \
            codec.measured_batch_bits(batch)

    def test_unsupported_codec_and_rule_are_loud(self):
        @dataclasses.dataclass(frozen=True)
        class NoIngest(StcCodec):
            supports_ingest: ClassVar[bool] = False

        with pytest.raises(NotImplementedError):
            NoIngest().make_ingest(8)

        @dataclasses.dataclass(frozen=True)
        class Gathered(AggregationRule):
            name: ClassVar[str] = "gathered"

        with pytest.raises(NotImplementedError, match="cannot stream"):
            _codec("stc", rule=Gathered()).make_ingest(8)

        @dataclasses.dataclass(frozen=True)
        class Screened(MeanRule):
            name: ClassVar[str] = "screened"
            screens: ClassVar[bool] = True

        with pytest.raises(NotImplementedError, match="screens"):
            _codec("stc", rule=Screened()).make_ingest(8)


class TestKernelDecode:
    @given(st.integers(64, 2048), st.integers(0, 10 ** 6))
    @settings(max_examples=10, deadline=None)
    def test_bit_identity_vs_numpy(self, numel, seed):
        rng = np.random.default_rng(seed)
        x = np.zeros(numel, np.float32)
        k = max(numel // 20, 1)
        x[rng.choice(numel, size=k, replace=False)] = \
            rng.choice((-1.0, 1.0), size=k)
        msg = wire.encode_ternary_words(x, 0.05)
        pa, sa = wire.decode_ternary_fields(msg, 0.05, backend="numpy")
        pb, sb = wire.decode_ternary_fields(msg, 0.05, backend="kernel",
                                            device="cpu")
        assert np.array_equal(pa, pb) and np.array_equal(sa, sb)

    @pytest.mark.parametrize("backend", WIRE_BACKENDS)
    def test_long_unary_run(self, backend):
        # one nonzero at the very end: a unary run far past one word
        n = 1 << 15
        x = np.zeros(n, np.float32)
        x[n - 1] = 1.0
        p = 1 / 400
        msg = wire.encode_ternary_words(x, p)
        out = wire.decode_ternary_words(msg, p, backend=backend, device="cpu")
        assert np.array_equal(out, np.sign(x) * np.float32(msg.mu))

    @pytest.mark.parametrize("backend", WIRE_BACKENDS)
    def test_mu_zero(self, backend):
        x = np.zeros(128, np.float32)
        x[[3, 77]] = (1.0, -1.0)
        msg = wire.encode_ternary_words(x, 1 / 8)._replace(mu=0.0)
        pos, signs = wire.decode_ternary_fields(msg, 1 / 8, backend=backend,
                                                device="cpu")
        assert np.array_equal(pos, [3, 77])
        assert np.array_equal(
            wire.decode_ternary_words(msg, 1 / 8, backend=backend,
                                      device="cpu"),
            np.zeros(128, np.float32))


class TestWireDecodeError:
    def _msg(self):
        x = np.zeros(200, np.float32)
        x[[5, 60, 150]] = (1.0, -1.0, 1.0)
        return wire.encode_ternary_words(x, 1 / 16)

    @pytest.mark.parametrize("backend", WIRE_BACKENDS)
    def test_truncated_codeword(self, backend):
        msg = self._msg()._replace(bit_len=3)
        with pytest.raises(WireDecodeError):
            wire.decode_ternary_fields(msg, 1 / 16, backend=backend,
                                       device="cpu")

    @pytest.mark.parametrize("backend", WIRE_BACKENDS)
    def test_no_terminator(self, backend):
        msg = self._msg()
        bad = msg._replace(
            words=np.full_like(msg.words, np.uint32(0xFFFFFFFF)))
        with pytest.raises(WireDecodeError):
            wire.decode_ternary_fields(bad, 1 / 16, backend=backend,
                                       device="cpu")

    @pytest.mark.parametrize("backend", WIRE_BACKENDS)
    def test_position_overflow(self, backend):
        msg = self._msg()._replace(numel=32)
        with pytest.raises(WireDecodeError):
            wire.decode_ternary_fields(msg, 1 / 16, backend=backend,
                                       device="cpu")

    @pytest.mark.parametrize("backend", WIRE_BACKENDS)
    def test_bit_len_past_buffer(self, backend):
        msg = self._msg()
        bad = msg._replace(bit_len=32 * msg.words.size + 1)
        with pytest.raises(WireDecodeError):
            wire.decode_ternary_fields(bad, 1 / 16, backend=backend,
                                       device="cpu")

    @pytest.mark.parametrize("backend", WIRE_BACKENDS)
    def test_batch_raises_too(self, backend):
        batch = wire.concat_messages([self._msg(), self._msg()])
        bad = batch._replace(bit_len=np.asarray([batch.bit_len[0], 3]))
        with pytest.raises(WireDecodeError):
            wire.decode_ternary_fields_batch(bad, 1 / 16, backend=backend,
                                             device="cpu")

    @pytest.mark.parametrize("backend", WIRE_BACKENDS)
    def test_validate_wire(self, backend):
        stc = _codec("stc", backend, sparsity_up=1 / 16)
        stc.validate_wire(self._msg(), device="cpu")
        with pytest.raises(WireDecodeError):
            stc.validate_wire(self._msg()._replace(bit_len=3), device="cpu")
        sign = _codec("signsgd", backend)
        plane = sign.encode_wire(torch.ones(100))
        sign.validate_wire(plane, device="cpu")
        with pytest.raises(WireDecodeError):
            sign.validate_wire(plane._replace(bit_len=99), device="cpu")

    def test_error_is_a_valueerror(self):
        assert issubclass(WireDecodeError, ValueError)


def test_wire_norms():
    msg = TestWireDecodeError()._msg()._replace(mu=-0.5)
    assert _codec("stc").wire_norm(msg) == 0.5 * np.sqrt(3)
    plane = _codec("signsgd").encode_wire(torch.ones(100))
    assert _codec("signsgd").wire_norm(plane) == 2e-4 * 10


# ---------------------------------------------------------------- packages

def _ref_msgs(ref, P, numel, seed):
    """The reference codec's messages for one round (numpy)."""
    import jax
    rng = np.random.default_rng(seed)
    deltas = rng.standard_normal((P, numel)).astype(np.float32)
    deltas[P - 1] = 0.0
    states = ref.init_client_state(numel)
    if states is not None:
        states = jax.tree.map(lambda leaf: jnp.stack([leaf] * P), states)
    msgs, _, _ = ref.encode_batch(jnp.asarray(deltas), states)
    return np.array(msgs)                       # a writable host copy


@pytest.mark.parametrize("wire_backend", WIRE_BACKENDS)
@pytest.mark.parametrize("name", ["stc", "signsgd"])
def test_accumulator_bitwise_reference(name, wire_backend):
    P, numel = 5, 3001
    ref = _ref_codec(name)
    port = _codec(name, wire_backend)
    msgs = _ref_msgs(ref, P, numel, 11)
    w = _weights(P, 11)

    b_ref = ref.encode_wire_batch(msgs, direction="up")
    b_port = port.encode_wire_batch(torch.from_numpy(msgs), direction="up")
    np.testing.assert_array_equal(b_port.words, b_ref.words)
    np.testing.assert_array_equal(b_port.bit_len, b_ref.bit_len)

    acc_ref = ref.make_ingest(numel)
    ref.ingest_wire_batch(acc_ref, b_ref, w, direction="up")
    acc = port.make_ingest(numel)
    assert isinstance(acc, IngestAccumulator)
    port.ingest_wire_batch(acc, b_port, w, direction="up", device="cpu")
    assert np.array_equal(acc.sum, acc_ref.sum)
    assert acc.weight_mass == acc_ref.weight_mass
    assert (acc.n_msgs, acc.nnz, acc.stream_bits) == \
        (acc_ref.n_msgs, acc_ref.nnz, acc_ref.stream_bits)
    combined = acc.combined()
    np.testing.assert_array_equal(combined.view(np.uint32),
                                  acc_ref.combined().view(np.uint32))

    gd_ref, _, st_ref = ref.aggregate_ingest(acc_ref,
                                             ref.init_server_state(numel))
    gd, _, stats = port.aggregate_ingest(acc, _server_state(port, numel))
    gd_ref = np.asarray(gd_ref)
    np.testing.assert_array_equal(np.sign(gd.numpy()), np.sign(gd_ref))
    if name == "signsgd":
        np.testing.assert_array_equal(gd.numpy(), gd_ref)
        return
    # threshold and count exact against "jnp"; µ within rtol 1e-6
    k = max(int(numel * port.sparsity_down), 1)
    t_ref, c_ref, _ = ref_stc_backend("jnp").select_batch(
        jnp.asarray(combined[None]), k)
    t, c, _ = get_stc_backend(port.backend).select_batch(
        torch.from_numpy(combined[None]), k)
    assert float(t[0]) == float(t_ref[0])
    assert int(stats.nnz) == int(c[0]) == int(c_ref[0]) == int(st_ref.nnz)
    np.testing.assert_allclose(float(stats.mu), float(st_ref.mu), rtol=1e-6)


@pytest.mark.parametrize("shape", [(7,), (4, 33)])
def test_sign_compress_bitwise_reference(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x.reshape(-1)[0] = 0.0
    out, stats = sign_compress(torch.from_numpy(x), 2e-4)
    out_r, stats_r = ref_sign(jnp.asarray(x), 2e-4)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(out_r).view(np.uint32))
    assert int(stats.nnz) == int(stats_r.nnz) == x.size
    assert float(stats.mu) == float(stats_r.mu)


@pytest.mark.parametrize("weighted", [False, True])
def test_majority_vote_bitwise_reference(weighted):
    rng = np.random.default_rng(2)
    msgs = (np.sign(rng.standard_normal((6, 301))) * 2e-4).astype(np.float32)
    msgs[:, :5] = 0.0                               # tied / empty votes
    w = _weights(6, 2).astype(np.float32) if weighted else None
    got = majority_vote_sign(torch.from_numpy(msgs), 2e-4,
                             weights=None if w is None
                             else torch.from_numpy(w))
    want = ref_vote(jnp.asarray(msgs), 2e-4,
                    weights=None if w is None else jnp.asarray(w))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_signsgd_codec_round_matches_reference():
    """Encode, aggregate (weighted vote) and the wire planes of one round."""
    P, n = 5, 1001
    ref, port = _ref_codec("signsgd"), _codec("signsgd", "kernel")
    deltas = np.random.default_rng(3).standard_normal((P, n)) \
        .astype(np.float32)
    m_ref, _, st_ref = ref.encode_batch(jnp.asarray(deltas), None)
    m_port, _, st_port = port.encode_batch(torch.from_numpy(deltas), None)
    np.testing.assert_array_equal(m_port.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(st_port.nnz.numpy(), np.asarray(st_ref.nnz))
    mask = np.array([1, 1, 0, 1, 1], np.float32)
    g_ref, _, _ = ref.aggregate(m_ref, None, mask=jnp.asarray(mask),
                                staleness=jnp.zeros(P))
    g_port, _, _ = port.aggregate(m_port, None, mask=torch.from_numpy(mask),
                                  staleness=torch.zeros(P))
    np.testing.assert_array_equal(g_port.numpy(), np.asarray(g_ref))
    plane = port.encode_wire(g_port, direction="down")
    want = ref.encode_wire(np.asarray(g_ref), direction="down")
    np.testing.assert_array_equal(plane.words, want.words)
    np.testing.assert_array_equal(port.decode_wire(plane),
                                  ref.decode_wire(want))
    assert port.upload_bits(n) == ref.upload_bits(n)
    assert port.wire_bound_bits(n, n) == ref.wire_bound_bits(n, n)


def test_signsgd_non_mean_rule_requantizes_the_combine():
    """A rule outside the mean family combines the ±step messages, then
    the result is re-quantized to the sign plane (no majority vote)."""
    @dataclasses.dataclass(frozen=True)
    class Median(AggregationRule):
        name: ClassVar[str] = "test-median"

        def combine_weighted(self, msgs, weights):
            return msgs.median(dim=0).values

    msgs = (np.sign(np.random.default_rng(5).standard_normal((5, 64)))
            * 2e-4).astype(np.float32)
    port = _codec("signsgd", rule=Median())
    out, _, stats = port.aggregate(torch.from_numpy(msgs), None)
    want = np.float32(2e-4) * np.sign(np.median(msgs, axis=0))
    np.testing.assert_array_equal(out.numpy(), want.astype(np.float32))
    assert int(stats.nnz) == 64
