"""signSGD's sign planes through the ``"kernel"`` wire backend, on the CPU
(the plain versions), against the JAX package.

* ``pack_sign_planes`` (fp32 ``x > 0``) against the reference's
  ``pack_sign_words`` on rows of ±step, 0, -0.0, subnormals, ±inf and NaN,
  n from 1 to the cnn's 307,434 (its ragged last word);
* ``pack_bits_batched`` against ``pack_bits_words_batched`` in interpret
  mode; its flattened words are the concatenation of the per-row packs;
* ``unpack_words_batched`` rows against the reference's unpack;
* the codec's ``encode_wire`` / ``encode_wire_batch`` against the
  reference codec's, field for field;
* ``ingest_wire_batch`` (one ``sign_plane_tally``) against the reference
  codec's ingest into the reference accumulator, bitwise: ``sum``, ``nnz``,
  ``n_msgs``, ``weight_mass``, ``stream_bits``; corrupt messages raise
  with the accumulator untouched;
* the signSGD ingest trainer on the ``"kernel"`` backend against the
  reference over 10 rounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_protocol as ref_make_protocol
from repro.core import wire as ref_wire
from repro.data import make_classification as ref_make_classification
from repro.fed import FedEnvironment as RefEnv
from repro.fed import FederatedTrainer as RefTrainer
from repro.fed import TrainerConfig as RefConfig
from repro.kernels import pack_bits_words_batched as ref_pack_batched
from repro.kernels import unpack_words_with_counts as ref_unpack
from repro.models.paper_models import MODEL_ZOO as REF_ZOO
from repro_torch import kernels as rk
from repro_torch.core import IngestAccumulator, make_protocol, wire
from repro_torch.core.selection import PASSES
from repro_torch.core.wire import WireDecodeError
from repro_torch.data import make_classification
from repro_torch.fed import FedEnvironment, FederatedTrainer, TrainerConfig
from repro_torch.models import MODEL_ZOO, params_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

STEP = 2e-4
EDGE = np.array([STEP, -STEP, 0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -1.4e-45,
                 np.inf, -np.inf, np.nan, -np.nan, 1.1754944e-38,
                 3.4028235e38], np.float32)


def _edge_rows(rows, n, seed):
    """``rows`` fp32 rows of length ``n``: the edge values of ``EDGE`` (a
    NaN with its sign bit set among them) and random draws of them, with
    normal values between."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    pick = rng.random((rows, n)) < 0.5
    x[pick] = rng.choice(EDGE, int(pick.sum()))
    x.reshape(-1)[:min(EDGE.size, x.size)] = EDGE[:x.size]
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    x.reshape(-1)[-1] = neg_nan
    return x


@pytest.mark.parametrize("n", [1, 31, 32, 33, 1000, 307_434])
def test_pack_sign_planes_plain_matches_reference(n):
    rows = 2 if n > 10_000 else 5
    x = _edge_rows(rows, n, n)
    got = rk.pack_sign_planes(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (rows, -(-n // 32))
    for i in range(rows):
        want = ref_wire.pack_sign_words(x[i], STEP)
        np.testing.assert_array_equal(got[i].numpy().view(np.uint32),
                                      want.words)
    # the flattened batch is the concatenation of the per-row packs
    np.testing.assert_array_equal(
        got.numpy().reshape(-1).view(np.uint32),
        np.concatenate([ref_wire.pack_sign_words(r, STEP).words
                        for r in x]))


def test_pack_sign_planes_reads_subnormals_unflushed():
    """numpy's ``x > 0`` does not flush: a positive subnormal is a 1."""
    x = np.array([[1e-45, -1e-45, 1e-40, 0.0, -0.0, np.nan, np.inf]],
                 np.float32)
    words = rk.pack_sign_planes(torch.from_numpy(x)).numpy().view(np.uint32)
    assert int(words[0, 0]) == 0b1010001 << 25
    assert np.array_equal(words, rk.pack_sign_planes_plain(
        torch.from_numpy(x)).numpy().view(np.uint32))


@pytest.mark.parametrize("m", [1, 333])
@pytest.mark.parametrize("rows", [1, 3, 10])
def test_pack_bits_batched_matches_reference_kernel(rows, m):
    bits = (np.random.default_rng(rows * m).random((rows, m)) < 0.4) \
        .astype(np.uint8)
    bits[:, 0] = 7                       # any non-zero byte is a 1
    got = rk.pack_bits_batched(torch.from_numpy(bits))
    want = np.asarray(ref_pack_batched(jnp.asarray(bits != 0),
                                       interpret=True))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        got.numpy().reshape(-1).view(np.uint32),
        np.concatenate([ref_wire._pack_bits_numpy(r != 0) for r in bits]))
    np.testing.assert_array_equal(got[0].numpy(),
                                  rk.pack_bits(torch.from_numpy(bits[0])))


@pytest.mark.parametrize("rows,n_words", [(1, 5), (4, 301)])
def test_unpack_words_batched_rows_match_reference(rows, n_words):
    w = np.random.default_rng(n_words).integers(
        0, 1 << 32, (rows, n_words), dtype=np.uint64).astype(np.uint32)
    w[0, :4] = np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32)[:n_words]
    bits, zeros = rk.unpack_words_batched(torch.from_numpy(w.view(np.int32)))
    assert bits.shape == (rows, 32 * n_words) and zeros.shape == w.shape
    for i in range(rows):
        b_ref, z_ref = ref_unpack(jnp.asarray(w[i]), interpret=True)
        np.testing.assert_array_equal(bits[i].numpy(), np.asarray(b_ref))
        np.testing.assert_array_equal(zeros[i].numpy(), np.asarray(z_ref))


def test_sign_plane_tally_plain_is_the_host_loop():
    """The plain tally against ``IngestAccumulator.add_sign_plane`` message
    by message, bitwise, onto a sum that already holds values."""
    rng = np.random.default_rng(8)
    n, rows = 1003, 4
    bits = (rng.random((rows, n)) < 0.5).astype(np.uint8)
    words = np.stack([ref_wire._pack_bits_numpy(b) for b in bits])
    weights = np.array([1 / 3, 0.7, 1e-300, 3.0])
    acc = IngestAccumulator(n)
    acc.sum[:] = rng.standard_normal(n) * 1e-4
    total = torch.from_numpy(acc.sum.copy())
    for b, w in zip(bits, weights):
        acc.add_sign_plane(b, 1 / 3, w)
    rk.sign_plane_tally(torch.from_numpy(words.view(np.int32)), 1 / 3,
                        torch.from_numpy(weights), total)
    np.testing.assert_array_equal(total.numpy().view(np.uint64),
                                  acc.sum.view(np.uint64))


def test_new_wrappers_validate_and_never_launch_on_the_cpu():
    rk.LAUNCHES.reset()
    PASSES.reset()
    rk.pack_sign_planes(torch.ones((2, 40)))
    rk.pack_bits_batched(torch.ones((2, 40), dtype=torch.uint8))
    rk.unpack_words_batched(torch.ones((2, 3), dtype=torch.int32))
    rk.sign_plane_tally(torch.ones((2, 2), dtype=torch.int32), STEP,
                        torch.ones(2, dtype=torch.float64),
                        torch.zeros(40, dtype=torch.float64))
    assert all(v == 0 for v in rk.LAUNCHES.counts.values())
    assert PASSES.counts == {"pack_sign_planes": 1, "pack_bits": 1,
                             "unpack_bits": 1, "sign_plane_tally": 1}
    with pytest.raises(ValueError):
        rk.pack_sign_planes(torch.ones(40))
    with pytest.raises(ValueError):
        rk.pack_sign_planes(torch.ones((2, 40), dtype=torch.float64))
    with pytest.raises(ValueError):
        rk.pack_bits_batched(torch.ones((2, 40)))
    with pytest.raises(ValueError):
        rk.unpack_words_batched(torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError):              # 2 words hold 33-64 bits
        rk.sign_plane_tally(torch.ones((2, 2), dtype=torch.int32), STEP,
                            torch.ones(2, dtype=torch.float64),
                            torch.zeros(80, dtype=torch.float64))
    with pytest.raises(ValueError):
        rk.sign_plane_tally(torch.ones((2, 2), dtype=torch.int32), STEP,
                            torch.ones(3, dtype=torch.float64),
                            torch.zeros(40, dtype=torch.float64))
    with pytest.raises(ValueError, match="unsupported device"):
        rk.pack_sign_planes(torch.ones((2, 40), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        rk.sign_plane_tally(
            torch.ones((2, 2), dtype=torch.int32, device="meta"), STEP,
            torch.ones(2, dtype=torch.float64, device="meta"),
            torch.zeros(40, dtype=torch.float64, device="meta"))


# ------------------------------------------------------------------ codec

def _codecs():
    return (ref_make_protocol("signsgd"),
            make_protocol("signsgd", wire_backend="kernel"))


def _same_batch(got, want):
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        if field == "numel":
            assert type(g) is int and g == w
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, field
        np.testing.assert_array_equal(g, w, err_msg=field)


@pytest.mark.parametrize("n", [33, 3001])
def test_encode_wire_batch_matches_reference_field_for_field(n):
    ref, port = _codecs()
    msgs = _edge_rows(6, n, 3)
    PASSES.reset()
    got = port.encode_wire_batch(torch.from_numpy(msgs), direction="up")
    assert PASSES.counts == {"pack_sign_planes": 1}
    _same_batch(got, ref.encode_wire_batch(msgs, direction="up"))
    for i in (0, 5):
        one = port.encode_wire(torch.from_numpy(msgs[i]), direction="down")
        want = ref.encode_wire(msgs[i], direction="down")
        assert (one.bit_len, one.mu, one.numel, one.nnz) == \
            (want.bit_len, want.mu, want.numel, want.nnz)
        assert type(one.bit_len) is int and type(one.mu) is float
        np.testing.assert_array_equal(one.words, want.words)


def _ingest_both(msgs, weights, prior=None):
    """The reference codec's ingest into the reference accumulator and the
    port's ``"kernel"`` ingest on the CPU, of the same messages, each on
    top of the same prior message (a sign plane at weight 0.25)."""
    ref, port = _codecs()
    numel = msgs.shape[1]
    acc_ref, acc = ref.make_ingest(numel), port.make_ingest(numel)
    if prior is not None:
        ref.ingest_wire(acc_ref, ref.encode_wire(prior), 0.25)
        port.ingest_wire(acc, port.encode_wire(torch.from_numpy(prior)),
                         0.25, device="cpu")
    ref.ingest_wire_batch(acc_ref, ref.encode_wire_batch(msgs), weights)
    rk.LAUNCHES.reset()
    PASSES.reset()
    port.ingest_wire_batch(acc, port.encode_wire_batch(
        torch.from_numpy(msgs)), weights, device="cpu")
    assert PASSES.counts == {"pack_sign_planes": 1, "sign_plane_tally": 1}
    assert all(v == 0 for v in rk.LAUNCHES.counts.values())
    return acc_ref, acc


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("n", [1, 64, 3001])
def test_ingest_wire_batch_bitwise_reference(n, prior):
    rng = np.random.default_rng(n)
    msgs = (np.sign(rng.standard_normal((5, n))) * STEP).astype(np.float32)
    msgs[1, ::3] = 0.0                      # ties pack as -step
    weights = np.array([1 / 3, 0.7, 1.0, 0.0, 2 / 7])
    acc_ref, acc = _ingest_both(
        msgs, weights, _edge_rows(1, n, 4)[0] if prior else None)
    np.testing.assert_array_equal(acc.sum.view(np.uint64),
                                  np.asarray(acc_ref.sum).view(np.uint64))
    assert (acc.nnz, acc.n_msgs, acc.weight_mass, acc.stream_bits) == \
        (acc_ref.nnz, acc_ref.n_msgs, acc_ref.weight_mass,
         acc_ref.stream_bits)
    np.testing.assert_array_equal(acc.combined().view(np.uint32),
                                  acc_ref.combined().view(np.uint32))


@pytest.mark.parametrize("corrupt", ["bit_len_short", "bit_len_long",
                                     "words_short"])
def test_corrupt_sign_plane_raises_before_anything_is_added(corrupt):
    _, port = _codecs()
    msgs = (np.sign(np.random.default_rng(6).standard_normal((3, 100)))
            * STEP).astype(np.float32)
    batch = port.encode_wire_batch(torch.from_numpy(msgs))
    if corrupt == "bit_len_short":          # fits its words, != numel
        batch = batch._replace(bit_len=np.array([100, 99, 100]))
    elif corrupt == "bit_len_long":         # past its words
        batch = batch._replace(bit_len=np.array([100, 100, 129]))
    else:                                   # words cut under bit_len
        batch = batch._replace(word_count=np.array([4, 4, 3]))
    acc = port.make_ingest(100)
    acc.sum[:] = 0.5
    before = acc.sum.copy()
    with pytest.raises(WireDecodeError):
        port.ingest_wire_batch(acc, batch, np.ones(3), device="cpu")
    np.testing.assert_array_equal(acc.sum, before)
    assert (acc.n_msgs, acc.nnz, acc.weight_mass) == (0, 0, 0.0)


def test_numpy_backend_keeps_the_default_loop():
    """The ``"numpy"`` backend still packs per message on the host and
    ingests through the default loop: no sign-plane entry runs."""
    port = make_protocol("signsgd")
    msgs = torch.from_numpy(_edge_rows(3, 70, 5))
    PASSES.reset()
    batch = port.encode_wire_batch(msgs)
    port.ingest_wire_batch(port.make_ingest(70), batch, np.ones(3))
    assert "pack_sign_planes" not in PASSES.counts
    assert "sign_plane_tally" not in PASSES.counts
    _same_batch(batch, _codecs()[1].encode_wire_batch(msgs))


# ---------------------------------------------------------------- trainer

@pytest.mark.parametrize("measure_bits", [None, True],
                         ids=["analytic", "measured"])
def test_signsgd_ingest_trainer_kernel_backend_matches_reference(
        measure_bits):
    """10 rounds of the signSGD ingest trainer (logreg, the reference's
    initial parameters) on the ``"kernel"`` wire backend on the CPU: the
    accuracy and all four ledger columns equal the reference's, the
    parameters within 1e-7."""
    kw = dict(n_clients=10, participation=1.0, classes_per_client=2,
              batch_size=20)
    cfg = dict(lr=0.05, ingest=True, measure_bits=measure_bits)
    train, test = make_classification(seed=0, n=2000)
    ref_train, ref_test = ref_make_classification(seed=0, n=2000)
    init = jax.tree.map(np.asarray,
                        REF_ZOO["logreg"][0](jax.random.PRNGKey(0)))
    ref = RefTrainer(REF_ZOO["logreg"], ref_train, ref_test, RefEnv(**kw),
                     ref_make_protocol("signsgd"), RefConfig(**cfg))
    h_ref = ref.run(10, eval_every=10)[-1]
    port = FederatedTrainer(
        (lambda gen: params_from_jax(init), MODEL_ZOO["logreg"][1]),
        train, test, FedEnvironment(**kw),
        make_protocol("signsgd", wire_backend="kernel"),
        TrainerConfig(**cfg), device="cpu")
    assert port.ingest
    PASSES.reset()
    h = port.run(10, eval_every=10)[-1]
    assert PASSES.counts["sign_plane_tally"] == 10
    assert PASSES.counts["pack_sign_planes"] == \
        (20 if measure_bits else 10)
    assert "unpack_bits" not in PASSES.counts
    assert h["acc"] == h_ref["acc"]
    for col in ("bits_up", "bits_down", "bits_up_analytic",
                "bits_down_analytic"):
        assert h[col] == h_ref[col], col
    np.testing.assert_allclose(port.params_vec.numpy(),
                               np.asarray(ref.params_vec), rtol=0, atol=1e-7)
