"""Port parity of the chunked ``(layer, chunk)`` codec states.

Held against the JAX package (STC on its ``"jnp"`` backend; ROADMAP R1
says why not its Pallas ``"kernel"``) on numpy inputs made from a seed:

* ``ChunkSpec``: fields, layer names (the reference's ``keystr`` strings),
  ``split``, ``merge``, ``valid_mask`` and ``chunk_ks`` equal to the
  reference's for the four paper models at chunk sizes None, 32, 4096 and
  "whole".
* The per-chunk flat oracle for all six codecs on adversarial layouts
  (chunk = 1, chunk = numel, ragged, whole vector), on the port's
  ``"kernel"`` and ``"torch"`` STC routes: the chunked messages and the
  server's output are the base codec's on every chunk's unpadded slice
  (STC: masks exact, values within 1e-6; the others bitwise), the wire
  round-trip is exact, and the messages agree with the reference's
  chunked codec (signs exact, values within rtol 1e-6).
* ``stc_compress_blocks`` and ``select_batch_dynamic`` against the
  reference's: thresholds and counts exact, sums and µ within rtol 1e-6.
* The chunked ingest: wire words and accumulator (sum, weight mass, bits,
  nnz) bitwise the reference's per-(message, chunk) loop.
* ``chunks="whole"`` (and ``controller="fixed"``) is the port's flat path
  bit for bit -- parameters, the four ledger columns, the wire log -- for
  all six codecs, in the synchronous and the buffered trainer, on the
  dense and the ingest routes.
* Trainers (logreg, 10 rounds, from the reference's initial parameters):
  chunked with and without a ``p_fn``, dense and ingest, accuracy and the
  four ledger columns equal to the reference's and parameters within 1e-7.
* The reference's error types for a bad ``p_fn``, a controller without
  chunks, an adaptive controller over a codec without the block path and
  a double wrap.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunk_codec as ref_chunk_codec
from repro.core import chunk_spec_from_sizes as ref_spec_from_sizes
from repro.core import chunk_spec_from_tree as ref_spec_from_tree
from repro.core import make_protocol as ref_make_protocol
from repro.core import whole_vector_spec as ref_whole
from repro.core import compression as ref_comp
from repro.core.ingest import IngestAccumulator as RefAcc
from repro.core.residual import stack_states as ref_stack_states
from repro.data import make_classification as ref_make_classification
from repro.fed import FederatedTrainer as RefTrainer
from repro.fed import FedEnvironment as RefEnv
from repro.fed import TrainerConfig as RefConfig
from repro.models.paper_models import MODEL_ZOO as REF_ZOO
from repro_torch.core import compression as port_comp
from repro_torch.core import make_protocol
from repro_torch.core.chunking import (ChunkedCodec, chunk_codec,
                                       chunk_spec_from_sizes,
                                       chunk_spec_from_tree,
                                       whole_vector_spec)
from repro_torch.core.ingest import IngestAccumulator
from repro_torch.core.residual import map_states, stack_states
from repro_torch.data import make_classification
from repro_torch.fed import (BufferedFederatedTrainer, FederatedTrainer,
                             FedEnvironment, LatencyModel, TrainerConfig)
from repro_torch.models import MODEL_ZOO, params_from_jax
from test_torch_fed_loop import _LEDGER, _P50, _both_trainers

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CODECS = ("baseline", "fedavg", "signsgd", "topk", "stc", "ternquant")
# demo-scale hyperparameters so tiny test vectors keep a few non-zeros
DEMO = {"stc": dict(sparsity_up=1 / 8, sparsity_down=1 / 8),
        "topk": dict(sparsity_up=1 / 8),
        "fedavg": dict(local_iters=2)}
LAYOUTS = ([64], [40, 0, 33, 27], [7, 19, 5], [2, 61])
MODES = ("chunk1", "numel", "ragged", "whole")


def _spec(make_sizes, make_whole, sizes, mode):
    numel = sum(sizes)
    if mode == "whole":
        return make_whole(numel)
    size = {"chunk1": 1, "numel": numel, "ragged": 13}[mode]
    return make_sizes(sizes, chunk_size=size)


# ---------------------------------------------------------------------------
# ChunkSpec geometry
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model_trees(name):
    ref_tree = REF_ZOO[name][0](jax.random.PRNGKey(0))
    return ref_tree, MODEL_ZOO[name][0](torch.Generator().manual_seed(0))


@pytest.mark.parametrize("chunks", [None, 32, 4096, "whole"])
@pytest.mark.parametrize("model", ["logreg", "mlp", "cnn", "lstm"])
def test_chunk_spec_matches_reference(model, chunks):
    ref_tree, tree = _model_trees(model)
    if chunks == "whole":
        numel = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref_tree))
        ref, spec = ref_whole(numel), whole_vector_spec(numel)
    else:
        ref = ref_spec_from_tree(ref_tree, chunks)
        spec = chunk_spec_from_tree(tree, chunks)
    assert tuple(spec) == tuple(ref)           # every field, names included
    if model == "lstm" and chunks is None:
        assert spec.layer_names[0] == "['layers'][0]['b']"
    if model == "cnn" and chunks is None:
        assert spec.layer_names[0] == "['conv0']"
        assert spec.layer_names[-1] == "['fc2b']"
    np.testing.assert_array_equal(spec.valid_mask(), ref.valid_mask())
    for p in (1 / 50, 1 / 7, [0.3] * spec.n_chunks):
        np.testing.assert_array_equal(spec.chunk_ks(p), ref.chunk_ks(p))
    x = np.random.default_rng(0).standard_normal(
        (2, spec.numel)).astype(np.float32)
    blocks = spec.split(x)
    np.testing.assert_array_equal(blocks, ref.split(x))
    t_blocks = spec.split(torch.from_numpy(x))
    np.testing.assert_array_equal(t_blocks.numpy(), blocks)
    np.testing.assert_array_equal(spec.merge(blocks), x)
    np.testing.assert_array_equal(spec.merge(t_blocks).numpy(), x)


def test_layer_boundaries_and_bad_inputs_as_reference():
    spec = chunk_spec_from_sizes([10, 0, 7], chunk_size=4)
    assert tuple(spec) == tuple(ref_spec_from_sizes([10, 0, 7],
                                                    chunk_size=4))
    assert spec.n_chunks == 5 and not spec.is_whole_vector()
    assert whole_vector_spec(33).is_whole_vector()
    for kw, sizes in ((dict(chunk_size=0), [4]), (dict(chunk_size=4),
                                                   [0, 0])):
        with pytest.raises(ValueError):
            ref_spec_from_sizes(sizes, **kw)
        with pytest.raises(ValueError):
            chunk_spec_from_sizes(sizes, **kw)


# ---------------------------------------------------------------------------
# the per-chunk flat oracle, and the reference's chunked codec
# ---------------------------------------------------------------------------


def _oracle_round(cc, deltas, states):
    """The base codec on every chunk's unpadded slice; ``states`` a list
    (per chunk) of stacked base states, threaded across rounds."""
    spec = cc.spec
    msgs = torch.zeros_like(deltas)
    for ci in range(spec.n_chunks):
        codec = cc.layer_codecs[spec.chunk_layer[ci]]
        lo, v = spec.chunk_start[ci], spec.chunk_valid[ci]
        m, states[ci], _ = codec.encode_batch(deltas[:, lo:lo + v],
                                              states[ci])
        msgs[:, lo:lo + v] = m
    return msgs, states


def _oracle_aggregate(cc, msgs, states, mask, stal):
    spec = cc.spec
    out = torch.zeros(spec.numel)
    for ci in range(spec.n_chunks):
        codec = cc.layer_codecs[spec.chunk_layer[ci]]
        lo, v = spec.chunk_start[ci], spec.chunk_valid[ci]
        out[lo:lo + v], states[ci], _ = codec.aggregate(
            msgs[:, lo:lo + v], states[ci], mask=mask, staleness=stal)
    return out, states


def _same(name, got, want, exact):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(np.sign(got), np.sign(want))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _run_chunked(name, route, sizes, mode, d_np, rounds=2):
    """Two rounds of the port's chunked codec beside its per-chunk flat
    oracle (held to it); returns the chunked codec and each round's
    ``(messages, server output)``."""
    P = d_np.shape[0]
    kw = dict(DEMO.get(name, {}), **({"backend": route}
                                     if name == "stc" else {}))
    base = make_protocol(name, **kw)
    cc = chunk_codec(base, _spec(chunk_spec_from_sizes, whole_vector_spec,
                                 sizes, mode))
    spec = cc.spec
    states = stack_states(cc.init_client_state(spec.numel, "cpu"), P)
    server = cc.init_server_state(spec.numel, "cpu")
    o_states = [stack_states(base.init_client_state(v, "cpu"), P)
                for v in spec.chunk_valid]
    o_server = [base.init_server_state(v, "cpu") for v in spec.chunk_valid]
    mask, stal = torch.from_numpy(_MASK), torch.from_numpy(_STAL)
    exact = name != "stc"
    out = []
    for rnd in range(rounds):             # states must thread
        d = torch.from_numpy(d_np * np.float32(0.5 ** rnd))
        msgs, states, _ = cc.encode_batch(d, states)
        o_msgs, o_states = _oracle_round(cc, d, o_states)
        _same(name, msgs.numpy(), o_msgs.numpy(), exact)
        if cc.wire_format:                # the wire round-trip is exact
            dec = cc.decode_wire_batch(cc.encode_wire_batch(
                msgs, direction="up"), direction="up")
            if name == "stc":
                np.testing.assert_allclose(dec, msgs.numpy(), rtol=1e-6,
                                           atol=0)
            else:
                np.testing.assert_array_equal(dec, msgs.numpy())
        g, server, _ = cc.aggregate(msgs, server, mask=mask, staleness=stal)
        o_g, o_server = _oracle_aggregate(cc, msgs, o_server, mask, stal)
        _same(name, g.numpy(), o_g.numpy(), exact)
        out.append((msgs, g))
    if states is not None:                # client state threads identically
        for ci, v in enumerate(spec.chunk_valid):
            np.testing.assert_allclose(states.residual[:, ci, :v].numpy(),
                                       o_states[ci].residual.numpy(),
                                       rtol=1e-6, atol=1e-7)
    return cc, out


_MASK = np.asarray([1.0, 0.0, 1.0], np.float32)
_STAL = np.asarray([0.0, 0.0, 2.0], np.float32)


def _deltas(li, numel, P=3):
    return np.random.default_rng(li).standard_normal((P, numel)) \
        .astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CODECS)
def test_chunked_is_per_chunk_oracle(name, mode):
    routes = ("kernel", "torch") if name == "stc" else ("kernel",)
    for li, sizes in enumerate(LAYOUTS):
        for route in routes:
            _run_chunked(name, route, sizes, mode, _deltas(li, sum(sizes)))


@pytest.mark.parametrize("name", CODECS)
def test_chunked_codec_matches_reference(name):
    """On a ragged layout (four chunk widths, so four groups), two rounds
    of the port's chunked codec against the reference's: messages, wire
    round-trip and server output (signs exact, values within rtol
    1e-6)."""
    sizes = [40, 0, 33, 27]
    d_np = _deltas(7, sum(sizes))
    ref_cc = ref_chunk_codec(ref_make_protocol(name, **DEMO.get(name, {})),
                             _spec(ref_spec_from_sizes, ref_whole, sizes,
                                   "ragged"))
    r_states = ref_stack_states(ref_cc.init_client_state(ref_cc.spec.numel),
                                3)
    r_server = ref_cc.init_server_state(ref_cc.spec.numel)
    for route in (("kernel", "torch") if name == "stc" else ("kernel",)):
        cc, out = _run_chunked(name, route, sizes, "ragged", d_np)
        assert tuple(cc.spec) == tuple(ref_cc.spec)
        st, srv = r_states, r_server
        for rnd, (msgs, g) in enumerate(out):
            r_msgs, st, _ = ref_cc.encode_batch(
                jnp.asarray(d_np * np.float32(0.5 ** rnd)), st)
            _same(name, msgs.numpy(), np.asarray(r_msgs), False)
            if cc.wire_format:
                np.testing.assert_array_equal(
                    cc.decode_wire_batch(cc.encode_wire_batch(msgs)),
                    ref_cc.decode_wire_batch(ref_cc.encode_wire_batch(
                        msgs.numpy())))
            r_g, srv, _ = ref_cc.aggregate(
                jnp.asarray(msgs.numpy()), srv, mask=jnp.asarray(_MASK),
                staleness=jnp.asarray(_STAL))
            _same(name, g.numpy(), np.asarray(r_g), False)


@pytest.mark.parametrize("name", CODECS)
def test_bit_ledger_equality_at_whole_vector(name):
    base = make_protocol(name, **DEMO.get(name, {}))
    numel, P = 96, 3
    cc = chunk_codec(base, whole_vector_spec(numel))
    assert cc.upload_bits(numel) == base.upload_bits(numel)
    for npart in (1, 4):
        assert cc.download_bits(numel, n_participating=npart) == \
            base.download_bits(numel, n_participating=npart)
    if not base.wire_format:
        return
    d = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (P, numel)).astype(np.float32))
    msgs, _, _ = cc.encode_batch(
        d, stack_states(cc.init_client_state(numel, "cpu"), P))
    assert cc.measured_batch_bits(cc.encode_wire_batch(msgs)) == \
        base.measured_batch_bits(base.encode_wire_batch(msgs))
    m1, b1 = cc.encode_wire(msgs[0]), base.encode_wire(msgs[0])
    assert cc.measured_message_bits(m1) == base.measured_message_bits(b1)
    assert m1.nnz == b1.nnz and m1.bit_len == b1.bit_len
    assert cc.wire_bound_bits(numel, m1.nnz) == \
        base.wire_bound_bits(numel, b1.nnz)


# ---------------------------------------------------------------------------
# STC over blocks: static and per-row ks as a tensor
# ---------------------------------------------------------------------------


def _block_rows(seed, rows=12, n=64):
    """Normal rows, a row of ties, one with fewer non-zeros than most ks,
    an all-zero row and one of subnormals among normals."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x[1] = np.float32(0.5) * np.sign(x[1])
    x[2, 3:] = 0.0
    x[3] = 0.0
    x[4, ::2] = np.float32(1e-40)
    return x


@pytest.mark.parametrize("route", ["kernel", "torch"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_batch_dynamic_matches_reference(route, seed):
    x = _block_rows(seed)
    rng = np.random.default_rng(seed + 10)
    ks = rng.integers(-2, 40, size=x.shape[0]).astype(np.int32)
    for k_cap in (8, 33, 64, 100):
        want = ref_comp.select_batch_dynamic(jnp.asarray(x), jnp.asarray(ks),
                                             k_cap)
        got = port_comp.select_batch_dynamic(
            torch.from_numpy(x), torch.from_numpy(ks), k_cap, backend=route)
        # the reference returns a subnormal k-th magnitude where the port
        # flushes it (ROADMAP R5/F2); compare thresholds as XLA reads them
        t_want = np.where(np.abs(np.asarray(want[0])) < np.finfo(
            np.float32).tiny, 0.0, np.asarray(want[0])).astype(np.float32)
        np.testing.assert_array_equal(got[0].numpy(), t_want)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="k_cap"):
        port_comp.select_batch_dynamic(torch.from_numpy(x),
                                       torch.from_numpy(ks), 0, backend=route)


@pytest.mark.parametrize("route", ["kernel", "torch"])
@pytest.mark.parametrize("dynamic", [False, True])
def test_stc_compress_blocks_matches_reference(route, dynamic):
    x = _block_rows(3)
    x[4] = 0.0           # the reference's subnormal carried is its own case
    ks = np.random.default_rng(4).integers(1, 20, size=x.shape[0])
    if dynamic:
        want = ref_comp.stc_compress_blocks(jnp.asarray(x),
                                            jnp.asarray(ks, jnp.int32),
                                            k_cap=20)
        got = port_comp.stc_compress_blocks(
            torch.from_numpy(x), torch.from_numpy(ks.astype(np.int32)),
            backend=route, k_cap=20)
    else:
        want = ref_comp.stc_compress_blocks(jnp.asarray(x), ks)
        got = port_comp.stc_compress_blocks(torch.from_numpy(x), ks,
                                            backend=route)
    np.testing.assert_array_equal(np.sign(got[0].numpy()),
                                  np.sign(np.asarray(want[0])))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="k_cap"):
        port_comp.stc_compress_blocks(torch.from_numpy(x),
                                      torch.from_numpy(ks), backend=route)


# ---------------------------------------------------------------------------
# the chunked wire and ingest against the reference's per-chunk loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire_backend", ["numpy", "kernel"])
@pytest.mark.parametrize("name,case", [("stc", "fused"),
                                       ("stc", "per_client"),
                                       ("signsgd", "fused")])
def test_chunked_ingest_bitwise_reference_loop(name, case, wire_backend):
    """``per_client``: the widest group's sub-streams hold more non-zeros
    than the wire's fused-batch limit, so both packages pack them row by
    row (with µ as the row's fp32 mean, where the fused pass sums in
    fp64)."""
    sizes, chunk, P = [300, 0, 170, 33, 257], 64, 5
    if case == "per_client":
        sizes, chunk = [9000, 0, 48 * 4096 + 77, 10], 4096
    kw = dict(DEMO.get(name, {}), wire_backend=wire_backend)
    ref_cc = ref_chunk_codec(ref_make_protocol(name, **DEMO.get(name, {})),
                             ref_spec_from_sizes(sizes, chunk_size=chunk))
    cc = chunk_codec(make_protocol(name, **kw),
                     chunk_spec_from_sizes(sizes, chunk_size=chunk))
    cc_small = chunk_codec(make_protocol(name, **kw),
                           chunk_spec_from_sizes(sizes, chunk_size=chunk))
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.standard_normal((P, cc.spec.numel))
                         .astype(np.float32))
    msgs, _, _ = cc.encode_batch(
        d, stack_states(cc.init_client_state(cc.spec.numel, "cpu"), P))
    w = np.asarray([1.0, 0.5, 0.25, 1.0, 0.7071067690849304])
    batch = cc.encode_wire_batch(msgs, direction="up", device="cpu")
    r_batch = ref_cc.encode_wire_batch(msgs.numpy(), direction="up")
    assert len(batch.batches) == len(r_batch.batches)
    if case == "per_client":
        from repro_torch.core import wire
        assert max(int(g.nnz.sum()) for g in batch.batches) > \
            wire._FUSED_NNZ_MAX
    for g, rg in zip(batch.batches, r_batch.batches):
        for field in ("words", "bit_len", "mu", "nnz"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(rg, field))
    acc = cc.make_ingest(cc.spec.numel)
    cc.ingest_wire_batch(acc, batch, w, direction="up", device="cpu")
    ref_acc = RefAcc(cc.spec.numel)
    ref_cc.ingest_wire_batch(ref_acc, r_batch, w, direction="up")
    assert acc.sum.tobytes() == ref_acc.sum.tobytes()
    assert (acc.weight_mass, acc.n_msgs, acc.nnz, acc.stream_bits) == \
        (ref_acc.weight_mass, ref_acc.n_msgs, ref_acc.nnz,
         ref_acc.stream_bits)
    # one message at a time (the buffered trainer's arrivals) is the same
    acc1 = cc_small.make_ingest(cc.spec.numel)
    for i in range(P):
        cc_small.ingest_wire(acc1, batch.message(i), float(w[i]),
                             direction="up", device="cpu")
    assert acc1.sum.tobytes() == acc.sum.tobytes()
    if name == "stc":                     # bounded decode blocks: same sum
        object.__setattr__(cc.base, "ingest_block_words", 3)
        acc2 = cc.make_ingest(cc.spec.numel)
        cc.ingest_wire_batch(acc2, batch, w, direction="up", device="cpu")
        assert acc2.sum.tobytes() == acc.sum.tobytes()
    np.testing.assert_array_equal(
        cc.decode_wire_batch(batch), ref_cc.decode_wire_batch(r_batch))


# ---------------------------------------------------------------------------
# chunks="whole" is the flat path, bit for bit
# ---------------------------------------------------------------------------


def _parts():
    train, test = make_classification(seed=0, n=600, n_test=120)
    env = FedEnvironment(n_clients=6, participation=0.5,
                         classes_per_client=2, batch_size=10)
    return train, test, env


_WHOLE_KW = {"stc": dict(sparsity_up=1 / 20, sparsity_down=1 / 20,
                         wire_backend="kernel"),
             "signsgd": dict(wire_backend="kernel"),
             "fedavg": dict(local_iters=2), "topk": dict(sparsity_up=1 / 20)}


@pytest.mark.parametrize("trainer", ["sync", "buffered"])
@pytest.mark.parametrize("name", CODECS)
def test_whole_vector_chunking_is_flat_path(name, trainer):
    train, test, env = _parts()
    routes = (False, True) if make_protocol(name).supports_ingest \
        else (False,)
    for ingest in routes:
        runs = []
        for cfg in ({}, {"chunks": "whole"},
                    {"chunks": "whole", "controller": "fixed"}):
            args = (MODEL_ZOO["logreg"], train, test, env,
                    make_protocol(name, **_WHOLE_KW.get(name, {})),
                    TrainerConfig(lr=0.05, seed=0, ingest=ingest,
                                  measure_bits=True if name == "signsgd"
                                  else None, **cfg))
            if trainer == "buffered":
                tr = BufferedFederatedTrainer(*args, latency=LatencyModel(),
                                              deadline=0.5, device="cpu")
            else:
                tr = FederatedTrainer(*args, device="cpu")
            assert isinstance(tr.protocol, ChunkedCodec) == bool(cfg)
            tr.run(3, eval_every=3)
            runs.append(tr)
        flat = runs[0]
        for tr in runs[1:]:
            assert torch.equal(flat.params_vec, tr.params_vec)
            for col in _LEDGER:
                assert getattr(flat, col) == getattr(tr, col), col
            assert flat.wire_log == tr.wire_log
            assert flat.history == tr.history
            if trainer == "buffered":
                assert flat.arrival_log == tr.arrival_log


# ---------------------------------------------------------------------------
# trainers against the reference
# ---------------------------------------------------------------------------


def _b_layers(name, depth):
    return 1 / 10 if "b" in name else None


@pytest.mark.parametrize("backend,cfg", [
    ("kernel", {"chunks": 32}), ("torch", {"chunks": 32, "p_fn": _b_layers}),
    ("kernel", {"chunks": 4096, "ingest": True})],
    ids=["kernel_c32", "torch_c32_p_fn", "kernel_c4096_ingest"])
def test_chunked_trainer_agrees_with_reference_exactly(backend, cfg):
    ref, port, h_ref, h = _both_trainers("stc", _P50, {}, cfg,
                                         backend=backend)
    assert isinstance(port.protocol, ChunkedCodec)
    assert port.protocol.spec == ref.protocol.spec
    assert h["acc"] == h_ref["acc"]
    for col in _LEDGER:
        assert h[col] == h_ref[col], col
    assert port.wire_log == ref.wire_log
    np.testing.assert_allclose(port.params_vec.numpy(),
                               np.asarray(ref.params_vec), rtol=0,
                               atol=1e-7)


def test_trainer_multi_chunk_trains_and_ledger_counts_headers():
    """``tests/test_chunked.py``'s setting (logreg at chunks=32 with a
    per-layer ``p_fn``), both packages from the reference's initial
    parameters, 3 rounds: the same accuracy, ledger and wire log."""
    env_kw = dict(n_clients=6, participation=0.5, classes_per_client=2,
                  batch_size=10)
    train, test = make_classification(seed=0, n=600, n_test=120)
    r_train, r_test = ref_make_classification(seed=0, n=600, n_test=120)
    cfg = dict(lr=0.05, seed=0, chunks=32,
               p_fn=lambda name, d: 1 / 10 if "b" in name else None)
    p = dict(sparsity_up=1 / 20, sparsity_down=1 / 20)
    init = jax.tree.map(np.asarray,
                        REF_ZOO["logreg"][0](jax.random.PRNGKey(0)))
    ref = RefTrainer(REF_ZOO["logreg"], r_train, r_test, RefEnv(**env_kw),
                     ref_make_protocol("stc", **p), RefConfig(**cfg))
    port = FederatedTrainer(
        (lambda gen: params_from_jax(init), MODEL_ZOO["logreg"][1]), train,
        test, FedEnvironment(**env_kw), make_protocol("stc", **p),
        TrainerConfig(**cfg), device="cpu")
    h_ref, h = ref.run(3, eval_every=3)[-1], port.run(3, eval_every=3)[-1]
    assert torch.isfinite(port.params_vec).all()
    assert port.protocol.spec.n_chunks == ref.protocol.spec.n_chunks > 1
    assert h["acc"] == h_ref["acc"]
    for col in _LEDGER:
        assert h[col] == h_ref[col], col
    assert port.wire_log == ref.wire_log
    for row in port.wire_log:
        assert row["bits_up_bound"] is None or \
            row["bits_up"] <= row["bits_up_bound"]
    # every chunk pays its own 32-bit µ header in the measured ledger
    n = port.protocol.spec.n_chunks
    assert port.protocol.measured_message_bits(
        port.protocol.encode_wire(torch.zeros(port.numel))) == 32.0 * n


# ---------------------------------------------------------------------------
# error types
# ---------------------------------------------------------------------------


def _error(fn):
    try:
        fn()
    except Exception as exc:                 # noqa: BLE001 -- compared
        return type(exc)
    return None


@pytest.mark.parametrize("p", [0.0, -0.1, 1.5, math.nan, math.inf, "x"])
def test_bad_p_fn_raises_as_reference(p):
    sizes = [16, 16]
    got = _error(lambda: chunk_codec(
        make_protocol("stc"), chunk_spec_from_sizes(sizes, chunk_size=8),
        p_fn=lambda name, d: p))
    want = _error(lambda: ref_chunk_codec(
        ref_make_protocol("stc"), ref_spec_from_sizes(sizes, chunk_size=8),
        p_fn=lambda name, d: p))
    assert got is want is ValueError


def test_wrap_errors_as_reference():
    spec, r_spec = whole_vector_spec(10), ref_whole(10)
    cases = [
        (lambda: chunk_codec(chunk_codec(make_protocol("stc"), spec), spec),
         lambda: ref_chunk_codec(ref_chunk_codec(ref_make_protocol("stc"),
                                                 r_spec), r_spec)),
        (lambda: chunk_codec(make_protocol("signsgd"), spec,
                             controller="snr_constant"),
         lambda: ref_chunk_codec(ref_make_protocol("signsgd"), r_spec,
                                 controller="snr_constant")),
        (lambda: chunk_codec(make_protocol("stc"), spec, controller="nope"),
         lambda: ref_chunk_codec(ref_make_protocol("stc"), r_spec,
                                 controller="nope")),
    ]
    for port_fn, ref_fn in cases:
        got, want = _error(port_fn), _error(ref_fn)
        assert got is want and got is not None
    train, test, env = _parts()
    got = _error(lambda: FederatedTrainer(
        MODEL_ZOO["logreg"], train, test, env, make_protocol("stc"),
        TrainerConfig(controller="residual_mass"), device="cpu"))
    r_train, r_test = ref_make_classification(seed=0, n=600, n_test=120)
    want = _error(lambda: RefTrainer(
        REF_ZOO["logreg"], r_train, r_test,
        RefEnv(n_clients=6, participation=0.5, classes_per_client=2,
               batch_size=10), ref_make_protocol("stc"),
        RefConfig(controller="residual_mass")))
    assert got is want is ValueError


def test_forwards_base_knobs_and_states():
    base = make_protocol("fedavg")
    cc = chunk_codec(base, whole_vector_spec(10))
    assert cc.local_iters == base.local_iters == 400
    assert (cc.wire_format, cc.error_feedback, cc.supports_ingest) == \
        (base.wire_format, base.error_feedback, base.supports_ingest)
    stc = chunk_codec(make_protocol("stc"),
                      chunk_spec_from_sizes([16, 16], chunk_size=8),
                      controller="snr_constant")
    st = stc.init_client_state(32, "cpu")
    assert set(st) == {"base", "ctrl"}
    assert st["base"].residual.shape == (4, 8) and st["ctrl"].shape == (4,)
    stacked = stack_states(st, 3)
    assert map_states(lambda x: x.shape, stacked)["ctrl"] == (3, 4)


def test_r9_chunked_ternquant_holds_what_holds():
    """R9 (ROADMAP Queue 3): chunked TernQuant at ``chunks=32`` amplifies
    R7's last-ulp µ and Δ into client mask flips after a few rounds, so the
    trainers' parameters part.  What holds, over 8 logreg rounds from the
    reference's initial parameters: the four ledger columns equal (the
    ledger is analytic) and accuracy within 0.03; and on identical round
    inputs (the port's trained client and server states, fresh deltas,
    3 lock-step rounds), the signs of the messages and of the server's
    output exact, their values (±µ) within rtol 1e-6."""
    from repro.core.residual import ResidualState as RefResidualState
    ref, port, h_ref, h = _both_trainers("ternquant", {}, {},
                                         {"chunks": 32}, rounds=8)
    assert isinstance(port.protocol, ChunkedCodec)
    for col in _LEDGER:
        assert h[col] == h_ref[col], col
    assert abs(h["acc"] - h_ref["acc"]) <= 0.03
    pc, rc = port.protocol, ref.protocol
    states, server = port.client_state, port.server_state

    def to_ref(st):
        return RefResidualState(residual=jnp.asarray(st.residual.numpy()))

    rng = np.random.default_rng(9)
    P = states.residual.shape[0]
    ones, zeros = np.ones(P, np.float32), np.zeros(P, np.float32)
    for _ in range(3):
        deltas = (rng.standard_normal((P, port.numel)) * 1e-2).astype(
            np.float32)
        m_p, new_states, _ = pc.encode_batch(torch.from_numpy(deltas),
                                             states)
        m_r, _, _ = rc.encode_batch(jnp.asarray(deltas), to_ref(states))
        np.testing.assert_array_equal(np.sign(m_p.numpy()),
                                      np.sign(np.asarray(m_r)))
        np.testing.assert_allclose(m_p.numpy(), np.asarray(m_r), rtol=1e-6)
        g_p, new_server, _ = pc.aggregate(m_p, server,
                                          mask=torch.from_numpy(ones),
                                          staleness=torch.from_numpy(zeros))
        g_r, _, _ = rc.aggregate(jnp.asarray(m_p.numpy()), to_ref(server),
                                 mask=jnp.asarray(ones),
                                 staleness=jnp.asarray(zeros))
        np.testing.assert_array_equal(np.sign(g_p.numpy()),
                                      np.sign(np.asarray(g_r)))
        np.testing.assert_allclose(g_p.numpy(), np.asarray(g_r), rtol=1e-6)
        states, server = new_states, new_server
