"""Port parity of the ternary wire's Golomb field decode.

``decode_golomb_fields`` on the CPU (its plain version, the reference's
field scan transcribed to torch), reached through the ``"kernel"`` wire
backend with ``device="cpu"``, against the JAX package's
``repro.core.wire.decode_ternary_fields_batch`` and
``decode_ternary_fields`` on the same words: ``seg``, positions and signs
bitwise, and ``WireDecodeError`` raised on exactly the inputs where the
reference raises -- valid batches over the P grid and b = 30, one cnn-width
round, the card decoder's traps (runs over chunks and compose tiles, codewords
ending on chunk ends, ``bit_len % 32 == 0``, empty segments, b = 0), the
decode-error cases of ``tests/test_torch_ingest.py``, the 60 mutations of
``tests/test_faults.py::TestWireFuzz`` and further corrupt batches.  The
card kernel is held to this plain version in
``tests/test_torch_cuda_kernels.py``.
"""

import os
import re

import numpy as np
import pytest
import torch

import _golomb_cases as cases
from repro.core import wire as ref_wire
from repro_torch import kernels as rk
from repro_torch.core import wire
from repro_torch.core.selection import PASSES
from repro_torch.core.wire import WireDecodeError
from repro_torch.kernels import _build, wiredecode

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _ref_batch(batch):
    return ref_wire.WireBatch(*batch)


def _outcome(fn):
    try:
        return fn()
    except (WireDecodeError, ref_wire.WireDecodeError):
        return "raised"


def _same_outcome(got, want, what):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want, (what, got if isinstance(got, str) else "decoded",
                             want if isinstance(want, str) else "decoded")
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, what
        np.testing.assert_array_equal(g, w, err_msg=what)


def _check_batch(batch, p, what):
    got = _outcome(lambda: wire.decode_ternary_fields_batch(
        batch, p, backend="kernel", device="cpu"))
    want = _outcome(lambda: ref_wire.decode_ternary_fields_batch(
        _ref_batch(batch), p))
    _same_outcome(got, want, what)
    return got


@pytest.mark.parametrize("case", cases.valid_cases(), ids=lambda c: c[0])
def test_valid_batches_bitwise_reference(case):
    name, batch, p = case
    got = _check_batch(batch, p, name)
    assert not isinstance(got, str)
    assert got[1].size == int(batch.nnz.sum()) > 0
    numpy_backend = wire.decode_ternary_fields_batch(batch, p)
    _same_outcome(got, numpy_backend, name)


def test_cnn_round_bitwise_reference():
    batch, p = cases.cnn_round()
    got = _check_batch(batch, p, "cnn round")
    assert got[1].size == int(batch.nnz.sum())


@pytest.mark.parametrize("case", cases.trap_cases(), ids=lambda c: c[0])
def test_chunk_traps_bitwise_reference(case):
    name, batch, p = case
    assert not isinstance(_check_batch(batch, p, name), str)


def test_traps_cover_what_they_name():
    traps = cases.trap_cases()
    assert any(b.bit_len[0] % 32 == 0 for name, b, _ in traps
               if name.startswith("bit_len"))
    b0 = traps[0][1]
    assert wire._b_star_checked(traps[0][2]) == 0
    assert b0.bit_len[2] == 0 and b0.word_count[2] == 0       # empty row
    # unary runs of 150,000 ones (over a thousand chunks) in a segment that
    # spans several compose tiles of the card decoder
    assert b0.bit_len[0] > 500_000
    assert wire._b_star_checked(cases.valid_cases()[-1][2]) == 30


@pytest.mark.parametrize("case", cases.corrupt_cases(120),
                         ids=lambda c: c[0])
def test_corrupt_batches_same_verdict(case):
    name, batch, p = case
    _check_batch(batch, p, name)


def test_corrupt_batches_mostly_raise():
    raised = sum(isinstance(_outcome(lambda: wire.decode_ternary_fields_batch(
        b, p, backend="kernel", device="cpu")), str)
        for _, b, p in cases.corrupt_cases(120))
    assert 60 <= raised < 120


def test_fuzz_mutations_same_verdict():
    """The 60 mutations of the reference's wire fuzz test, single-message
    API."""
    raised = 0
    for trial, msg, p in cases.fuzz_messages():
        got = _outcome(lambda: wire.decode_ternary_fields(
            msg, p, backend="kernel", device="cpu"))
        want = _outcome(lambda: ref_wire.decode_ternary_fields(
            ref_wire.WireMessage(*msg), p))
        _same_outcome(got, want, f"fuzz trial {trial}")
        raised += isinstance(got, str)
    assert raised > 0


def _decode_error_cases():
    x = np.zeros(200, np.float32)
    x[[5, 60, 150]] = (1.0, -1.0, 1.0)
    msg = wire.encode_ternary_words(x, 1 / 16)
    return {
        "truncated_codeword": msg._replace(bit_len=3),
        "no_terminator": msg._replace(
            words=np.full_like(msg.words, np.uint32(0xFFFFFFFF))),
        "position_overflow": msg._replace(numel=32),
        "bit_len_past_buffer": msg._replace(bit_len=32 * msg.words.size + 1),
        "valid": msg,
    }


@pytest.mark.parametrize("name", sorted(_decode_error_cases()))
def test_decode_error_cases_same_verdict(name):
    msg = _decode_error_cases()[name]
    got = _outcome(lambda: wire.decode_ternary_fields(
        msg, 1 / 16, backend="kernel", device="cpu"))
    want = _outcome(lambda: ref_wire.decode_ternary_fields(
        ref_wire.WireMessage(*msg), 1 / 16))
    _same_outcome(got, want, name)
    assert isinstance(got, str) == (name != "valid")


def test_batch_with_one_truncated_row_raises():
    msg = _decode_error_cases()["valid"]
    batch = wire.concat_messages([msg, msg])
    bad = batch._replace(bit_len=np.asarray([batch.bit_len[0], 3]))
    assert _check_batch(bad, 1 / 16, "batch") == "raised"


def _table(batch):
    w = torch.from_numpy(np.ascontiguousarray(batch.words).view(np.int32))
    return (w, torch.from_numpy(batch.word_start.astype(np.int64)),
            torch.from_numpy(batch.bit_len.astype(np.int64)),
            torch.from_numpy(batch.nnz.astype(np.int64)))


def test_wrapper_plain_on_cpu_counts_a_pass_and_no_launch():
    batch, p = cases.valid_cases()[1][1:]
    b = wire._b_star_checked(p)
    rk.LAUNCHES.reset()
    PASSES.reset()
    seg, pos, signs = rk.decode_golomb_fields(*_table(batch), batch.numel, b)
    assert rk.LAUNCHES.counts["golomb_decode"] == 0
    assert PASSES.counts == {"golomb_decode": 1}
    assert (seg.dtype, pos.dtype, signs.dtype) == (torch.int64, torch.int64,
                                                   torch.float32)
    want = rk.decode_golomb_fields_plain(*_table(batch), batch.numel, b)
    assert all(torch.equal(g, w) for g, w in zip((seg, pos, signs), want))


def test_wrapper_validates_inputs():
    batch, p = cases.valid_cases()[1][1:]
    w, ws, bl, nnz = _table(batch)
    numel, b = batch.numel, wire._b_star_checked(p)
    bad_inputs = [
        ((w.to(torch.int64), ws, bl, nnz, numel, b), "flat int32"),
        ((w.reshape(1, -1), ws, bl, nnz, numel, b), "flat int32"),
        ((w, ws.to(torch.int32), bl, nnz, numel, b), "host segment table"),
        ((w, ws, bl[None], nnz, numel, b), "host segment table"),
        ((w, ws, bl[:-1], nnz, numel, b), "differ in length"),
        ((w, ws.flip(0), bl, nnz, numel, b), "in order"),
        ((w, ws, bl, nnz, numel, 31), r"\[0, 30\]"),
        ((w, ws, bl, nnz, numel, -1), r"\[0, 30\]"),
        ((w.to("meta"), ws, bl, nnz, numel, b), "unsupported device"),
    ]
    for args, match in bad_inputs:
        with pytest.raises(ValueError, match=match):
            rk.decode_golomb_fields(*args)


def test_segment_table_corruption_raises():
    batch, p = cases.valid_cases()[1][1:]
    w, ws, bl, nnz = _table(batch)
    numel, b = batch.numel, wire._b_star_checked(p)
    over = bl.clone()
    over[0] = 32 * int(ws[1]) + 1                # into the next segment
    with pytest.raises(WireDecodeError, match="past the word buffer"):
        rk.decode_golomb_fields(w, ws, over, nnz, numel, b)
    many = nnz.clone()
    many[0] = int(bl[0]) // (b + 2) + 1          # more than the bits hold
    with pytest.raises(WireDecodeError, match="nnz mismatch"):
        rk.decode_golomb_fields(w, ws, bl, many, numel, b)


@pytest.mark.parametrize("case", cases.synthetic_cases(), ids=lambda c: c[0])
def test_synthetic_batches_bitwise_reference(case):
    """The shapes the card decode's plans turn on (740 tiny segments, empty
    segments first and last, a tile of a cluster and one chunk more,
    segments longer than a cluster's tile, b = 0 and b = 30)."""
    name, batch, p = case
    got = _check_batch(batch, p, name)
    assert not isinstance(got, str)
    assert got[1].size == int(batch.nnz.sum()) > 0


def test_synthetic_cases_cover_what_they_name():
    by_name = {name: (batch, p) for name, batch, p in cases.synthetic_cases()}
    tiny = by_name["740 tiny segments"][0]
    assert tiny.bit_len.size == 740
    assert tiny.bit_len.max() <= 8 * wiredecode._CHUNK_BITS
    empties = by_name["empty first, between and last"][0].bit_len
    assert empties[0] == empties[2] == empties[-1] == 0 < empties[1]
    for n_chunks in (512, 513, 1024, 1025):
        bl = by_name[f"one segment of {n_chunks} chunks"][0].bit_len
        assert -(-int(bl[0]) // wiredecode._CHUNK_BITS) == n_chunks
    longest = (wiredecode._MAX_DECODE_CLUSTER * wiredecode._TILE_CHUNKS
               * wiredecode._CHUNK_BITS)
    for name, b in (("long runs over tiles b=0", 0),
                    ("long runs over tiles b=5", 5), ("b=30 over tiles", 30)):
        batch, p = by_name[name]
        assert batch.bit_len.max() > longest
        assert wire._b_star_checked(p) == b
    b0 = by_name["long runs over tiles b=0"][0]
    assert b0.bit_len.size == 3 and b0.bit_len.max() > 3 * longest


def _cu_constant(name):
    src = (_build.CSRC / "golomb_decode.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_decode_plan_constants_are_the_kernels():
    assert wiredecode._CHUNK_BITS == _cu_constant("CHUNK_BITS")
    assert wiredecode._TILE_CHUNKS == _cu_constant("TILE")
    assert wiredecode._MAX_DECODE_CLUSTER == _cu_constant("MAX_CLUSTER")
    assert _cu_constant("MAX_STATES") == 32 == wire._MAX_B_STAR + 2
    assert cases.CHUNK_BITS == wiredecode._CHUNK_BITS


# (n_chunks_max, plan): the paths' shapes and the tiled route
@pytest.mark.parametrize("shape,want", [
    # a cnn ingest round: 10 segments of ~395 chunks; 8 CTAs of ~50
    ((395,), ("cluster", 8, 512, 50)),
    # one cnn message (event server, buffered ingest)
    ((391,), ("cluster", 8, 512, 49)),
    # the chunked codec's widest width group: 740 segments of <= 7 chunks
    ((7,), ("cluster", 1, 64, 7)),
    # one segment longer than 16 CTAs of 64 chunks: walked in tiles
    ((2530,), ("tiled", 16, 512, 64)),
    ((1024,), ("cluster", 16, 512, 64)),
    ((1025,), ("tiled", 16, 512, 64)),
    ((0,), ("cluster", 1, 64, 1)),              # empty segments only
    ((64,), ("cluster", 1, 512, 64)),
    ((65,), ("cluster", 2, 512, 33)),
    ((129,), ("cluster", 4, 512, 33)),
])
def test_decode_plan_at_the_paths_shapes(shape, want):
    assert tuple(wiredecode.decode_plan(*shape)) == want


def test_decode_plan_forced_cluster_and_its_limits():
    assert tuple(wiredecode._cluster_plan(391, 4)) == ("tiled", 4, 512, 64)
    assert tuple(wiredecode._cluster_plan(395, 16)) == ("cluster", 16, 256,
                                                        25)
    for n_max in (0, 1, 7, 64, 65, 389, 1024, 1025, 10**6):
        plan = wiredecode.decode_plan(n_max)
        assert plan == wiredecode._cluster_plan(n_max, plan.cluster)
        assert plan.cluster in (1, 2, 4, 8, 16)
        assert plan.threads in (64, 128, 256, 512)
        assert 1 <= plan.tile <= wiredecode._TILE_CHUNKS
        assert plan.threads >= min(512, 8 * plan.tile)
        fits = n_max <= plan.cluster * plan.tile
        assert plan.route == ("cluster" if fits else "tiled")
        # the smallest cluster that holds the longest segment
        if plan.cluster > 1:
            assert n_max > plan.cluster // 2 * wiredecode._TILE_CHUNKS


def test_host_decode_on_cpu_returns_the_plain_fields_as_numpy():
    """The kernel wire backend's decode on CPU words: the plain version's
    fields as numpy arrays, and its errors."""
    batch, p = cases.valid_cases()[1][1:]
    b = wire._b_star_checked(p)
    backend = wire.get_wire_backend("kernel", "cpu")
    args = (batch.words, batch.word_start, batch.bit_len, batch.nnz)
    got = backend.decode_fields(*args, batch.numel, b)
    want = rk.decode_golomb_fields_plain(*_table(batch), batch.numel, b)
    assert all(isinstance(g, np.ndarray) for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    with pytest.raises(WireDecodeError, match="overflows"):
        backend.decode_fields(*args, 3, b)


def test_field_views_share_one_buffer():
    """The card's one buffer: positions, the status rows, then the signs'
    float32 pairs; a view of a tensor and of its numpy copy alike."""
    n_out, n_seg = 5, 3
    buf = torch.arange(n_out + 3 * n_seg + 3, dtype=torch.int64)
    (pos, sign), status = wiredecode._field_views(buf, n_out, n_seg)
    assert pos.tolist() == list(range(5))
    assert status.tolist() == list(range(5, 14))
    assert sign.dtype == torch.float32 and sign.numel() == n_out
    assert sign.untyped_storage().data_ptr() == buf.untyped_storage() \
        .data_ptr()
    (pos_h, sign_h), status_h = wiredecode._field_views(
        buf.numpy(), n_out, n_seg)
    np.testing.assert_array_equal(pos_h, pos.numpy())
    np.testing.assert_array_equal(sign_h, sign.numpy())
    np.testing.assert_array_equal(status_h, status.numpy())
