"""Pytree and tagged state checkpoints in a msgpack subset, compressed
with zlib.

Counterpart of the reference's ``checkpoint/msgpack_ckpt.py``.

``save_checkpoint`` / ``restore_checkpoint`` store a pytree (dicts,
lists, tuples, None; tensor or numpy leaves) as the reference does: its
leaves in ``jax.tree.flatten`` order (dict keys sorted), each as dtype,
shape and raw bytes (bfloat16 as a uint16 view), beside a ``"treedef"``
string that is the one ``str(jax.tree.flatten(tree)[1])`` gives, built
here without JAX.  So a file of either package restores through the
other's.

``save_state`` / ``restore_state`` store a template-free composite.  The
format is the reference's: a
composite of Python scalars, numpy arrays, lists, tuples, sets, dicts and
NamedTuples becomes a tree of msgpack values, every non-native value a
``[tag, ...]`` list:

  "I"  big int (hex string -- PCG64 carries 128-bit state words)
  "a"  ndarray      "a0" numpy scalar     "l" list     "t" tuple
  "nt" NamedTuple (by class name)         "s" set (sorted)
  "d"  dict with non-string or tagged keys

and one tag of the port's own:

  "T"  ``torch.Tensor``: copied to the host, stored as dtype, shape and
       raw bytes; restored as a CPU tensor of the same dtype and shape (the
       caller moves it to its device once).

The machine with the card has no ``msgpack`` package, so :func:`packb` and
:func:`unpackb` here are the port's own encoder and decoder for the subset
the format uses: nil, bool, int, float64, str, bin, array and map.  Their
bytes are those of ``msgpack.packb`` (its defaults) on the same object.
Files are written with ``zlib`` (level 6), atomically (a temporary file,
then a rename).  A zstd-compressed file (as the reference writes where
``zstandard`` is installed) is read where ``zstandard`` imports; elsewhere
it raises ``ImportError``, as the reference does.
"""

from __future__ import annotations

import os
import struct
import tempfile
import zlib
from typing import Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "save_state",
           "restore_state", "packb", "unpackb"]

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"  # little-endian 0xFD2FB528 frame header
_BF16 = "bfloat16"

# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


def _pack_int(x: int, out: bytearray) -> None:
    if x < -(1 << 5):
        if x < -(1 << 15):
            if x < -(1 << 31):
                if x < -(1 << 63):
                    raise OverflowError("int too small for msgpack")
                out += b"\xd3" + struct.pack(">q", x)
            else:
                out += b"\xd2" + struct.pack(">i", x)
        elif x < -(1 << 7):
            out += b"\xd1" + struct.pack(">h", x)
        else:
            out += b"\xd0" + struct.pack(">b", x)
    elif x < (1 << 7):
        out += struct.pack(">b", x)          # positive and negative fixint
    elif x < (1 << 16):
        if x < (1 << 8):
            out += b"\xcc" + struct.pack(">B", x)
        else:
            out += b"\xcd" + struct.pack(">H", x)
    elif x < (1 << 32):
        out += b"\xce" + struct.pack(">I", x)
    elif x < (1 << 64):
        out += b"\xcf" + struct.pack(">Q", x)
    else:
        raise OverflowError("int too big for msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes, out: bytearray) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes`` names them; None where the type has no such form)."""
    if n < fix_max and fix is not None:
        out.append(fix | n)
    elif n < (1 << 8) and codes[0] is not None:
        out += bytes([codes[0], n])
    elif n < (1 << 16):
        out += bytes([codes[1]]) + struct.pack(">H", n)
    elif n < (1 << 32):
        out += bytes([codes[2]]) + struct.pack(">I", n)
    else:
        raise ValueError("msgpack object too large")


def _pack(x, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, int):
        _pack_int(int(x), out)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", float(x))
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(len(b), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += b
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        _pack_len(len(x), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(x).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` (None, bool, int, float, str, bytes, list, tuple, dict) as
    msgpack bytes, as ``msgpack.packb(obj)`` gives them."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}


def _unpack(buf: bytes, i: int):
    """The value starting at ``buf[i]`` and the offset past it."""
    c = buf[i]
    i += 1
    if c <= 0x7F:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0xA0 <= c <= 0xBF:
        n = c & 0x1F
        return buf[i:i + n].decode("utf-8"), i + n
    if 0x90 <= c <= 0x9F:
        return _unpack_array(buf, i, c & 0x0F)
    if 0x80 <= c <= 0x8F:
        return _unpack_map(buf, i, c & 0x0F)
    if c == 0xC0:
        return None, i
    if c == 0xC2:
        return False, i
    if c == 0xC3:
        return True, i
    if c in _FIXED:
        fmt = _FIXED[c]
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[i:i + size])[0], i + size
    for codes, kind in (((0xD9, 0xDA, 0xDB), "str"),
                        ((0xC4, 0xC5, 0xC6), "bin"),
                        ((None, 0xDC, 0xDD), "array"),
                        ((None, 0xDE, 0xDF), "map")):
        if c in codes:
            fmt = (">B", ">H", ">I")[codes.index(c)]
            size = struct.calcsize(fmt)
            n = struct.unpack(fmt, buf[i:i + size])[0]
            i += size
            if kind == "str":
                return buf[i:i + n].decode("utf-8"), i + n
            if kind == "bin":
                return bytes(buf[i:i + n]), i + n
            if kind == "array":
                return _unpack_array(buf, i, n)
            return _unpack_map(buf, i, n)
    raise ValueError(f"msgpack type 0x{c:02x} is outside the checkpoint "
                     "subset")


def _unpack_array(buf, i, n):
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _unpack_map(buf, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        v, i = _unpack(buf, i)
        out[k] = v
    return out, i


def unpackb(data: bytes):
    """Inverse of :func:`packb` (arrays as lists, str as str, bin as
    bytes, maps with any hashable key)."""
    data = bytes(data)
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} extra bytes after the object")
    return obj


# ---------------------------------------------------------------------------
# the pytree checkpoint
# ---------------------------------------------------------------------------


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _flatten(tree, leaves: list) -> str:
    """Append ``tree``'s leaves to ``leaves`` in ``jax.tree.flatten`` order
    and return its structure as ``str(PyTreeDef)`` spells it inside the
    parentheses."""
    if _is_leaf(tree):
        leaves.append(tree)
        return "*"
    if tree is None:
        return "None"
    if type(tree) is dict:
        return "{" + ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                               for k in sorted(tree)) + "}"
    if type(tree) is list:
        return "[" + ", ".join(_flatten(v, leaves) for v in tree) + "]"
    if type(tree) is tuple:
        inner = [_flatten(v, leaves) for v in tree]
        return "(" + ", ".join(inner) + ("," if len(inner) == 1 else "") + ")"
    raise TypeError(f"a checkpoint tree holds dicts, lists, tuples, None and "
                    f"tensor or array leaves, not {type(tree).__name__}")


def _tree_flatten(tree) -> tuple:
    """``(leaves, treedef string)``, as ``jax.tree.flatten`` and ``str``."""
    leaves: list = []
    return leaves, f"PyTreeDef({_flatten(tree, leaves)})"


def _unflatten(like, leaves):
    if _is_leaf(like):
        return next(leaves)
    if like is None:
        return None
    if type(like) is dict:
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return type(like)(_unflatten(v, leaves) for v in like)


def _pack_tree_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:   # stored as the reference's uint16 view
            return {"d": _BF16, "s": list(x.shape),
                    "b": x.view(torch.int16).numpy().tobytes()}
        x = x.numpy()
    return _pack_leaf(x)


def _unpack_tree_leaf(rec, like) -> torch.Tensor:
    if rec["d"] == _BF16:
        raw = np.frombuffer(rec["b"], np.uint16).reshape(rec["s"]).copy()
        t = torch.from_numpy(raw).view(torch.bfloat16)
    else:
        t = torch.from_numpy(_unpack_leaf(rec))
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


def save_checkpoint(path: str, tree) -> None:
    """Write ``tree`` to ``path``: the treedef string and the leaves as
    msgpack bytes, zlib-compressed, written atomically."""
    leaves, treedef = _tree_flatten(tree)
    payload = packb({"treedef": treedef,
                     "leaves": [_pack_tree_leaf(x) for x in leaves]})
    _write_atomic(path, zlib.compress(payload, 6))


def restore_checkpoint(path: str, like):
    """Restore into the structure of ``like`` (validates the leaf count and
    the treedef string, raising ``ValueError`` as the reference does).
    Leaves come back as tensors of the stored dtype and shape, each on its
    template leaf's device (the CPU for a numpy template leaf)."""
    with open(path, "rb") as f:
        raw = f.read()
    obj = unpackb(_decompress(path, raw))
    template, treedef = _tree_flatten(like)
    if len(obj["leaves"]) != len(template):
        raise ValueError(
            f"checkpoint has {len(obj['leaves'])} leaves, template has "
            f"{len(template)}")
    if obj["treedef"] != treedef:
        raise ValueError("checkpoint tree structure mismatch")
    restored = [_unpack_tree_leaf(r, t)
                for r, t in zip(obj["leaves"], template)]
    return _unflatten(like, iter(restored))


# ---------------------------------------------------------------------------
# the tagged composite
# ---------------------------------------------------------------------------

_MSGPACK_INT_MAX = (1 << 64) - 1
_MSGPACK_INT_MIN = -(1 << 63)
_DICT_TAGS = ("I", "a", "a0", "nt", "t", "l", "s", "d")


def _pack_leaf(arr: np.ndarray) -> dict:
    return {"d": str(arr.dtype), "s": list(arr.shape), "b": arr.tobytes()}


def _unpack_leaf(rec) -> np.ndarray:
    return np.frombuffer(rec["b"], np.dtype(rec["d"])).reshape(
        rec["s"]).copy()


def _pack_tensor(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return {"d": _BF16, "s": list(t.shape),
                "b": t.view(torch.int16).numpy().tobytes()}
    return _pack_leaf(t.numpy())


def _unpack_tensor(rec) -> torch.Tensor:
    if rec["d"] == _BF16:
        raw = np.frombuffer(rec["b"], np.int16).reshape(rec["s"]).copy()
        return torch.from_numpy(raw).view(torch.bfloat16)
    return torch.from_numpy(_unpack_leaf(rec))


def _tag_state(x):
    if x is None or isinstance(x, (bool, float, str, bytes)):
        return x
    if isinstance(x, int):
        if _MSGPACK_INT_MIN <= x <= _MSGPACK_INT_MAX:
            return x
        return ["I", hex(x)]
    if isinstance(x, np.ndarray):
        return ["a", _pack_leaf(x)]
    if isinstance(x, np.generic):
        return ["a0", _pack_leaf(np.asarray(x))]
    if isinstance(x, torch.Tensor):
        return ["T", _pack_tensor(x)]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return ["nt", type(x).__name__, [_tag_state(v) for v in x]]
    if isinstance(x, tuple):
        return ["t", [_tag_state(v) for v in x]]
    if isinstance(x, list):
        return ["l", [_tag_state(v) for v in x]]
    if isinstance(x, (set, frozenset)):
        return ["s", [_tag_state(v) for v in sorted(x)]]
    if isinstance(x, dict):
        if all(isinstance(k, str) and k not in _DICT_TAGS for k in x):
            return {k: _tag_state(v) for k, v in x.items()}
        return ["d", [[_tag_state(k), _tag_state(v)] for k, v in x.items()]]
    raise TypeError(f"save_state cannot serialize {type(x).__name__}")


def _untag_state(x, classes: dict):
    if isinstance(x, dict):
        return {k: _untag_state(v, classes) for k, v in x.items()}
    if not isinstance(x, list):
        return x
    tag = x[0]
    if tag == "I":
        return int(x[1], 16)
    if tag == "a":
        return _unpack_leaf(x[1])
    if tag == "a0":
        return _unpack_leaf(x[1]).reshape(())[()]
    if tag == "T":
        return _unpack_tensor(x[1])
    if tag == "nt":
        cls = classes.get(x[1])
        if cls is None:
            raise KeyError(
                f"restore_state needs the NamedTuple class {x[1]!r} in "
                "`classes` to rebuild this checkpoint")
        return cls(*[_untag_state(v, classes) for v in x[2]])
    if tag == "t":
        return tuple(_untag_state(v, classes) for v in x[1])
    if tag == "l":
        return [_untag_state(v, classes) for v in x[1]]
    if tag == "s":
        return set(_untag_state(v, classes) for v in x[1])
    if tag == "d":
        return {_untag_state(k, classes): _untag_state(v, classes)
                for k, v in x[1]}
    raise ValueError(f"unknown state tag {tag!r}")


def _write_atomic(path: str, data: bytes) -> None:
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _decompress(path: str, raw: bytes) -> bytes:
    if raw[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError:
            raise ImportError(
                f"{path} is zstd-compressed but the 'zstandard' package is "
                "not installed") from None
        return zstandard.ZstdDecompressor().decompress(raw)
    return zlib.decompress(raw)


def save_state(path: str, obj) -> None:
    """Serialize a composite (see the module docstring) to ``path``: the
    tagged tree as msgpack bytes, zlib-compressed, written atomically."""
    _write_atomic(path, zlib.compress(packb(_tag_state(obj)), 6))


def restore_state(path: str, classes: Optional[dict] = None):
    """Inverse of :func:`save_state` (and of the reference's).  ``classes``
    maps NamedTuple class names to their classes (needed to rebuild "nt"
    records).  Arrays come back as numpy arrays and tensors as CPU
    tensors."""
    with open(path, "rb") as f:
        raw = f.read()
    return _untag_state(unpackb(_decompress(path, raw)), classes or {})
