"""The port's checkpoint module (``repro_torch.checkpoint``).

* Its msgpack encoder is byte-identical to ``msgpack.packb`` on every
  type and size class of the subset it writes, and on the event trainer's
  tagged state composites (dense and ingest routes, mid-run); its decoder
  reads ``msgpack.packb``'s bytes.  (Skipped where ``msgpack`` is absent.)
* Tensors round-trip in dtype, shape and bits and come back on the CPU.
* A ``save_state`` file written by the reference (zstd and zlib frames)
  restores through the port's ``restore_state`` to equal values.
* The port writes zlib frames, and reads a zstd frame only where
  ``zstandard`` imports.
* The pytree ``save_checkpoint`` / ``restore_checkpoint``: the treedef
  string is ``str(jax.tree.flatten(tree)[1])`` on the smoke LMs' params
  (smollm; qwen2 with QKV bias; deepseek's MLA and MoE blocks), a paper
  model's, the mesh trainer's
  ``init_train_state`` and odd shapes of tree; files restore bitwise
  across the port and the reference both ways (the reference's in zstd
  and in zlib frames); a mismatched template raises ``ValueError``.
"""

import os
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import msgpack_ckpt as ref_ckpt
from repro.launch import train as ref_train
from repro.models import init_model as ref_init_model
from repro.models import paper_models as ref_paper_models
from repro_torch import configs
from repro_torch.checkpoint import (msgpack_ckpt, restore_checkpoint,
                                    restore_state, save_checkpoint,
                                    save_state)
from repro_torch.checkpoint.msgpack_ckpt import packb, unpackb
from repro_torch.core import make_protocol
from repro_torch.core.residual import ResidualState
from repro_torch.core.wire import WireMessage
from repro_torch.data import make_classification
from repro_torch.fed import EventDrivenTrainer, FedEnvironment, TrainerConfig
from repro_torch.fed import events
from repro_torch.launch import train as port_train
from repro_torch.models import MODEL_ZOO, init_model

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SCALARS = [None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536,
           2 ** 32 - 1, 2 ** 32, 2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128,
           -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.0, -0.0,
           1.5, float("inf"), np.float64(2.5), "", "a" * 31, "a" * 32,
           "é" * 200, "x" * 70000, b"", b"x" * 255, b"x" * 256,
           b"y" * 70000, [], list(range(15)), list(range(16)),
           list(range(70000)), (1, 2), {}, {str(i): i for i in range(15)},
           {str(i): i for i in range(16)}, {1: [2, {"a": None}]}]


@pytest.mark.parametrize("i", range(len(SCALARS)))
def test_packb_bytes_are_msgpacks(i):
    msgpack = pytest.importorskip("msgpack")
    v = SCALARS[i]
    assert packb(v) == msgpack.packb(v)
    assert repr(unpackb(packb(v))) == repr(
        msgpack.unpackb(msgpack.packb(v), strict_map_key=False))


def test_packb_refuses_what_the_format_has_no_tag_for():
    with pytest.raises(TypeError):
        packb(object())
    with pytest.raises(OverflowError):
        packb(2 ** 64)
    with pytest.raises(ValueError, match="extra bytes"):
        unpackb(packb(1) + b"\x00")
    with pytest.raises(ValueError, match="subset"):
        unpackb(b"\xd4\x00\x00")          # fixext1


def _composite(ingest, tmp_path, monkeypatch, faults=None):
    """The composite the event trainer checkpoints after 2 aggregations."""
    train, test = make_classification(seed=0, n=900, n_test=240)
    tr = EventDrivenTrainer(
        MODEL_ZOO["logreg"], train, test,
        FedEnvironment(n_clients=8, participation=0.25, classes_per_client=2,
                       batch_size=10),
        make_protocol("stc", sparsity_up=1 / 20, sparsity_down=1 / 20),
        TrainerConfig(seed=0, ingest=ingest), scenario="flash-outage",
        k_arrivals=2, concurrency=4, max_staleness=3, faults=faults,
        device="cpu")
    tr.run(2, eval_every=2)
    seen = []
    monkeypatch.setattr(events, "save_state",
                        lambda path, obj: seen.append(obj))
    tr.save_checkpoint(str(tmp_path / "unused"))
    return seen[0]


@pytest.mark.parametrize("ingest", [False, True], ids=["dense", "ingest"])
def test_trainer_composites_pack_as_msgpack(ingest, tmp_path, monkeypatch):
    msgpack = pytest.importorskip("msgpack")
    obj = _composite(ingest, tmp_path, monkeypatch,
                     faults="duplicate" if ingest else "bit-flip")
    tagged = msgpack_ckpt._tag_state(obj)
    raw = packb(tagged)
    assert raw == msgpack.packb(tagged)
    assert unpackb(raw) == msgpack.unpackb(raw, strict_map_key=False)
    assert len(raw) > 10_000            # parameters, payloads, logs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int64,
                                   torch.int32, torch.uint8, torch.bool,
                                   torch.float16, torch.bfloat16])
@pytest.mark.parametrize("shape", [(), (0,), (3, 4), (2, 1, 5)])
def test_tensors_roundtrip_in_dtype_shape_and_bits(dtype, shape, tmp_path):
    g = torch.Generator().manual_seed(0)
    t = (torch.randn(shape, generator=g, dtype=torch.float64) * 100).to(dtype)
    if dtype.is_floating_point and t.numel():
        t.view(-1)[0] = -0.0
    path = str(tmp_path / "t.ck")
    save_state(path, {"t": t, "nt": ResidualState(residual=t), "l": [t]})
    st = restore_state(path, classes={"ResidualState": ResidualState})
    for got in (st["t"], st["nt"].residual, st["l"][0]):
        assert got.dtype == dtype and tuple(got.shape) == shape
        assert got.device.type == "cpu"
        if dtype == torch.bfloat16:
            assert torch.equal(got.view(torch.int16), t.view(torch.int16))
        else:
            np.testing.assert_array_equal(
                got.numpy().reshape(-1).view(np.uint8),
                t.numpy().reshape(-1).view(np.uint8))


def _reference_state():
    rng = np.random.default_rng(0)
    return {
        "round": 7, "big": 2 ** 100 + 3, "neg": -5, "f": 0.25,
        "arr": rng.standard_normal((3, 4)).astype(np.float32),
        "ints": np.arange(5, dtype=np.int64), "mask": np.ones(4, bool),
        "scalar": np.float32(1.5), "i64": np.int64(9),
        "rng": np.random.default_rng(3).bit_generator.state,
        "msg": WireMessage(np.arange(4, dtype=np.uint32), 100, 0.5, 64, 9),
        "t": (1, "a"), "s": {3, 1, 2}, "d": {(1, 2): [np.float64(0.5)]},
        "log": [{"kind": "arrival", "t": 0.3, "bits_up": 10.0}],
    }


def _assert_equal_states(got, want, dtypes=True):
    """Equal composites; ``dtypes=False`` for the reference's restore,
    which goes through ``jnp.asarray`` (int64 arrays come back int32)."""
    if dtypes:
        assert type(got) is type(want) or (isinstance(want, np.generic)
                                           and np.asarray(got).dtype
                                           == np.asarray(want).dtype)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_equal_states(got[k], want[k], dtypes)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_equal_states(a, b, dtypes)
    elif isinstance(want, np.ndarray):
        assert got.shape == want.shape
        assert got.dtype == want.dtype or not dtypes
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("frame", ["zstd", "zlib"])
def test_reference_files_restore_through_the_port(frame, tmp_path,
                                                  monkeypatch):
    if frame == "zstd":
        pytest.importorskip("zstandard")
    else:
        monkeypatch.setattr(ref_ckpt, "zstandard", None)
    path = str(tmp_path / "ref.ck")
    want = _reference_state()
    ref_ckpt.save_state(path, want)
    with open(path, "rb") as f:
        head = f.read(4)
    assert (head == b"\x28\xb5\x2f\xfd") == (frame == "zstd")
    got = restore_state(path, classes={"WireMessage": WireMessage})
    _assert_equal_states(got, want)


def test_port_files_are_zlib_and_restore_in_the_reference(tmp_path):
    path = str(tmp_path / "port.ck")
    want = _reference_state()
    save_state(path, want)
    with open(path, "rb") as f:
        raw = f.read()
    assert zlib.decompress(raw)              # a zlib frame, not zstd
    _assert_equal_states(restore_state(
        path, classes={"WireMessage": WireMessage}), want)
    pytest.importorskip("msgpack")
    back = ref_ckpt.restore_state(path, classes={"WireMessage": WireMessage})
    _assert_equal_states(back, want, dtypes=False)


def test_zstd_frames_need_zstandard(tmp_path, monkeypatch):
    pytest.importorskip("zstandard")
    path = str(tmp_path / "ref.ck")
    ref_ckpt.save_state(path, {"a": 1})
    assert restore_state(path) == {"a": 1}
    monkeypatch.setitem(sys.modules, "zstandard", None)    # not importable
    with pytest.raises(ImportError, match="zstandard"):
        restore_state(path)
    save_state(path, {"a": 2})                # zlib needs no zstandard
    assert restore_state(path) == {"a": 2}


def test_unknown_namedtuple_is_loud(tmp_path):
    path = str(tmp_path / "nt.ck")
    save_state(path, {"m": WireMessage(np.zeros(1, np.uint32), 0, 0.0, 1, 0)})
    with pytest.raises(KeyError, match="WireMessage"):
        restore_state(path)


# -- the pytree checkpoint ----------------------------------------------------

TREE_ARCHS = ("smollm-135m", "qwen2-0.5b", "deepseek-v2-lite-16b")


def _port_tree(which):
    if which in TREE_ARCHS:
        return init_model(configs.get_smoke_config(which), 0)
    if which == "lstm":
        return MODEL_ZOO["lstm"][0](torch.Generator().manual_seed(0))
    cfg = configs.get_smoke_config("smollm-135m")
    tc = port_train.TrainConfig(protocol="stc", momentum=0.9)
    return port_train.init_train_state(cfg, tc, 1, key=0, device="cpu")


def _ref_tree(which):
    key = jax.random.PRNGKey(0)
    if which in TREE_ARCHS:
        return ref_init_model(ref_configs.get_smoke_config(which), key)
    if which == "lstm":
        return ref_paper_models.MODEL_ZOO["lstm"][0](key)
    cfg = ref_configs.get_smoke_config("smollm-135m")
    tc = ref_train.TrainConfig(protocol="stc", momentum=0.9)
    return ref_train.init_train_state(cfg, tc, 1, key)   # one rank's shapes


TREES = TREE_ARCHS + ("lstm", "train_state")


@pytest.mark.parametrize("which", TREES)
def test_treedef_string_is_jaxs(which):
    leaves, treedef = msgpack_ckpt._tree_flatten(_port_tree(which))
    ref_leaves, ref_treedef = jax.tree.flatten(_ref_tree(which))
    assert treedef == str(ref_treedef)
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(x.shape) for x in ref_leaves]


ODD_TREES = [None, (), [], {}, [[[]]], ((),), {"b": [1, (2, None)], "a": {}},
             {"it's": 0, 'q"': [0]}, {2: 0, 1: [0]}, (0,), 0]


@pytest.mark.parametrize("i", range(len(ODD_TREES)))
def test_treedef_string_on_odd_trees(i):
    def leafy(t, make):
        if isinstance(t, int) and not isinstance(t, bool):
            return make()
        if isinstance(t, dict):
            return {k: leafy(v, make) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(leafy(v, make) for v in t)
        return t
    tree = ODD_TREES[i]
    _, treedef = msgpack_ckpt._tree_flatten(leafy(tree, lambda: torch.zeros(2)))
    assert treedef == str(jax.tree.flatten(leafy(tree,
                                                 lambda: np.zeros(2)))[1])


@pytest.mark.parametrize("bad", [1.5, "s", object(), {"a": 3}])
def test_checkpoint_refuses_other_node_types(bad, tmp_path):
    with pytest.raises(TypeError, match=type(bad if not isinstance(bad, dict)
                                             else 3).__name__):
        save_checkpoint(str(tmp_path / "x.ck"), [torch.zeros(1), bad])
    from repro_torch.models.attention import KVCache
    with pytest.raises(TypeError, match="KVCache"):
        save_checkpoint(str(tmp_path / "x.ck"),
                        KVCache(torch.zeros(1), torch.zeros(1),
                                torch.zeros(()), False))


def _mixed_tree():
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 5), generator=g)
    x[0, 0] = -0.0
    return {"w": x, "h": x.to(torch.bfloat16), "i": torch.arange(4),
            "step": torch.zeros((), dtype=torch.int32),
            "m": torch.tensor([True, False]),
            "l": [torch.randn((2,), generator=g, dtype=torch.float64),
                  (torch.empty((0, 3)), None)]}


def _bits(x):
    x = np.asarray(x.view(torch.int16) if (isinstance(x, torch.Tensor) and
                                           x.dtype == torch.bfloat16)
                   else x)
    return x.dtype.str, x.shape, x.tobytes()


def _assert_bitwise(got, want):
    got_leaves, got_def = msgpack_ckpt._tree_flatten(got)
    want_leaves, want_def = msgpack_ckpt._tree_flatten(want)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        assert isinstance(g, torch.Tensor)
        assert g.dtype == w.dtype
        assert _bits(g) == _bits(w)


@pytest.mark.parametrize("which", TREES[:1] + ("mixed",))
def test_pytree_checkpoint_roundtrips_bitwise(which, tmp_path):
    tree = _mixed_tree() if which == "mixed" else _port_tree(which)
    path = str(tmp_path / "p.ck")
    save_checkpoint(path, tree)
    with open(path, "rb") as f:
        assert zlib.decompress(f.read())          # a zlib frame
    _assert_bitwise(restore_checkpoint(path, tree), tree)


@pytest.mark.parametrize("which", TREES)
def test_port_checkpoints_restore_bitwise_in_the_reference(which, tmp_path):
    pytest.importorskip("msgpack")
    tree = _port_tree(which)
    path = str(tmp_path / "port.ck")
    save_checkpoint(path, tree)
    back = ref_ckpt.restore_checkpoint(path, _ref_tree(which))
    got, _ = jax.tree.flatten(back)
    want, _ = msgpack_ckpt._tree_flatten(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.shape == tuple(w.shape)
        assert g.tobytes() == w.numpy().tobytes()


def test_bf16_leaves_cross_both_ways(tmp_path):
    pytest.importorskip("msgpack")
    tree = {"h": _mixed_tree()["h"]}
    path = str(tmp_path / "bf16.ck")
    save_checkpoint(path, tree)
    ref_like = {"h": jnp.zeros((3, 5), jnp.bfloat16)}
    back = ref_ckpt.restore_checkpoint(path, ref_like)["h"]
    assert back.dtype == jnp.bfloat16
    assert np.asarray(back).view(np.uint16).tobytes() == \
        tree["h"].view(torch.int16).numpy().tobytes()
    ref_ckpt.save_checkpoint(path, {"h": back})
    _assert_bitwise(restore_checkpoint(path, tree), tree)


@pytest.mark.parametrize("frame", ["zstd", "zlib"])
@pytest.mark.parametrize("which", TREES)
def test_reference_checkpoints_restore_bitwise_through_the_port(
        which, frame, tmp_path, monkeypatch):
    if frame == "zstd":
        pytest.importorskip("zstandard")
    else:
        monkeypatch.setattr(ref_ckpt, "zstandard", None)
    ref = _ref_tree(which)
    path = str(tmp_path / "ref.ck")
    ref_ckpt.save_checkpoint(path, ref)
    with open(path, "rb") as f:
        assert (f.read(4) == b"\x28\xb5\x2f\xfd") == (frame == "zstd")
    got = restore_checkpoint(path, _port_tree(which))
    got_leaves, _ = msgpack_ckpt._tree_flatten(got)
    want, _ = jax.tree.flatten(ref)
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        w = np.asarray(w)
        assert g.device.type == "cpu"
        assert str(g.numpy().dtype) == str(w.dtype)
        assert g.numpy().tobytes() == w.tobytes()


def test_restore_puts_leaves_on_the_template_devices(tmp_path):
    tree = _mixed_tree()
    path = str(tmp_path / "d.ck")
    save_checkpoint(path, tree)
    like = dict(tree, w=tree["w"].numpy())       # a numpy template leaf
    got = restore_checkpoint(path, like)
    assert isinstance(got["w"], torch.Tensor)
    assert list(got) == sorted(like)             # as jax.tree.unflatten


@pytest.mark.parametrize("how", ["count", "structure"])
def test_mismatched_template_raises_as_the_reference(how, tmp_path):
    tree = _port_tree("smollm-135m")
    path = str(tmp_path / "m.ck")
    save_checkpoint(path, tree)
    if how == "count":
        like = dict(tree, extra=torch.zeros(1))
        ref_like = dict(_ref_tree("smollm-135m"), extra=jnp.zeros(1))
        match = "leaves"
    else:
        like = dict(tree)
        ref_like = dict(_ref_tree("smollm-135m"))
        like["final_norm"] = [like.pop("final_norm")["g"]]
        ref_like["final_norm"] = [ref_like.pop("final_norm")["g"]]
        match = "structure"
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(path, like)
    pytest.importorskip("msgpack")
    with pytest.raises(ValueError, match=match):
        ref_ckpt.restore_checkpoint(path, ref_like)
