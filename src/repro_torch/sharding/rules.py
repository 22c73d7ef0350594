"""Partition rules: parameter trees, KV / latent / recurrent caches, the
batch.

Counterpart of ``repro/sharding/rules.py``.  The ``model`` axis carries
tensor parallelism: attention heads, FFN hidden, expert hidden, vocab.  The
client axes (``pod``, ``data``) carry the federated clients (train) or the
request batch (serve).  The global batch splits over the client axes, rank
r taking rows ``[r·b/n, (r+1)·b/n)`` as ``P(client_axes)`` places them.

A spec is a plain tuple with one entry a dimension: an axis name, a tuple
of names, or ``None`` (the reference's ``PartitionSpec``, entry for
entry); a tree of specs holds them where the parameter or cache tree holds
its tensors.  A :class:`Sharding` pairs a spec with a mesh and gives the
shard of a global shape that one device holds, so the dry run sizes every
device's bytes with no device and no allocation.  :func:`shard_leaf`
cuts a rank's block out of a global tensor along the ``model`` entry of
its fitted spec and :func:`unshard_leaf` joins the blocks back over the
model group: the mesh trainer's tensor-parallel state is laid out so
(:mod:`repro_torch.launch.train`), and so are the serve steps'
parameters, their KV caches split on the heads
(:mod:`repro_torch.launch.serve`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

__all__ = ["param_specs", "param_shardings", "cache_specs", "batch_spec",
           "tree_shardings", "fit_spec", "batch_entry", "batch_rows",
           "Sharding", "StandIn", "map_tree", "CACHE_SHARD_MODE",
           "model_dim", "shard_leaf", "unshard_leaf", "shard_tree",
           "replicated_leaves"]

# How decode caches shard over the "model" axis:
#   "heads": shard the KV-head dim (falls back to replication where the
#            head count does not divide the axis, e.g. qwen2's 2 KV heads);
#   "hd":    shard head_dim (64 / 128 / 256 divide 16).
CACHE_SHARD_MODE = "heads"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh: which axes split each dimension of a global
    array."""

    mesh: Any
    spec: tuple

    def shard_shape(self, shape) -> tuple:
        """The shape of the block of a ``shape`` array that one device
        holds; raises where an axis does not divide its dimension (a spec
        from :func:`fit_spec` always divides)."""
        shape = tuple(shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {shape} has dimensions")
        out = []
        for i, size in enumerate(shape):
            factor = _factor(self.spec[i] if i < len(self.spec) else None,
                             self.mesh)
            if size % factor:
                raise ValueError(f"dimension {i} of {shape} does not split "
                                 f"{factor} ways ({self.spec})")
            out.append(size // factor)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class StandIn:
    """A shape stand-in: a ``meta`` tensor (the global shape and dtype, no
    storage) and its :class:`Sharding`."""

    tensor: Any
    sharding: Sharding

    @property
    def shape(self) -> tuple:
        return tuple(self.tensor.shape)

    @property
    def dtype(self):
        return self.tensor.dtype

    def device_bytes(self) -> int:
        """The bytes of the shard one device holds."""
        return (math.prod(self.sharding.shard_shape(self.shape)) *
                self.tensor.element_size())


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _factor(entry, mesh) -> int:
    return math.prod(mesh.shape[n] for n in _names(entry))


def _is_spec(x) -> bool:
    """A spec is a plain tuple; a NamedTuple (a cache) is a container."""
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def map_tree(fn, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over dicts, lists and NamedTuples
    (a cache); a spec, a tensor or any other object is a leaf, and
    ``path`` holds the keys, indices and field names down to it."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest),
                            path=path + (k,)) for k in tree}
    if isinstance(tree, list):
        return [map_tree(fn, t, *(r[i] for r in rest), path=path + (i,))
                for i, t in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*[
            map_tree(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                     path=path + (f,)) for f in tree._fields])
    return fn(path, tree, *rest)


def _leaf_spec(path: tuple, leaf) -> tuple:
    """The spec of one parameter leaf, keyed on its tree path."""
    name = path[-1] if path else None
    ndim = leaf.ndim

    # --- embeddings / head: vocab sharded ---------------------------------
    if name in ("embed", "lm_head"):
        return ("model", None)
    if name == "prefix_proj":
        return (None, "model")

    # --- MoE stacked experts ----------------------------------------------
    if name in ("w_gate", "w_up") and ndim == 3:   # (E, d, f)
        return (None, None, "model")
    if name == "w_down" and ndim == 3:             # (E, f, d)
        return (None, "model", None)
    if name == "router":
        return (None, None)

    # --- attention / MLA ----------------------------------------------------
    if name in ("wq", "wk", "wv", "w_uk", "w_uv"):
        return (None, "model")
    if name == "wo":
        return ("model", None)
    if name in ("bq", "bk", "bv"):
        return ("model",)
    if name in ("w_dkv", "w_kr"):                  # small latent projections
        return (None, None)

    # --- dense MLP ----------------------------------------------------------
    if name in ("w_gate", "w_up"):                 # (d, f)
        return (None, "model")
    if name == "w_down":                           # (f, d)
        return ("model", None)

    # --- SSD / RG-LRU --------------------------------------------------------
    if name == "w_in":                             # (d, d_proj)
        return (None, "model")
    if name == "w_out":                            # (d_in, d)
        return ("model", None)
    if name == "conv_w":                           # (k, channels)
        return (None, "model")
    if name in ("w_a", "w_x"):                     # (w, w) RG-LRU gates
        return (None, "model")
    if name in ("A_log", "D", "dt_bias", "lam", "norm_g"):
        return (None,)

    # --- norms, biases, scalars: replicated ----------------------------------
    return (None,) * ndim


def fit_spec(spec: tuple, shape, mesh) -> tuple:
    """Drop the sharded axes that do not divide their dimension.

    Where a dimension does not split evenly (whisper's 51,865-row vocab
    over a 16-way model axis, a 2-KV-head cache), the rule falls back to
    replication for that dimension, as the reference does."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        out.append(entry if shape[i] % _factor(entry, mesh) == 0 else None)
    return tuple(out)


def model_dim(spec: tuple, shape, mesh):
    """The dimension that the ``model`` axis splits in ``spec`` fitted to
    ``shape`` on ``mesh``, or None where the leaf is whole on every model
    rank (a norm, or a dimension the axis does not divide)."""
    if mesh.shape.get("model", 1) == 1:
        return None
    for i, entry in enumerate(fit_spec(spec, shape, mesh)):
        if "model" in _names(entry):
            return i
    return None


def shard_leaf(leaf, spec: tuple, mesh, model_rank: int):
    """Model rank ``model_rank``'s block of the global tensor ``leaf``
    along the ``model`` entry of ``fit_spec(spec)``: the
    ``model_rank``-th of ``M`` equal slices of that dimension (a view), or
    ``leaf`` itself where the leaf is replicated."""
    dim = model_dim(spec, tuple(leaf.shape), mesh)
    if dim is None:
        return leaf
    size = leaf.shape[dim] // mesh.shape["model"]
    return leaf.narrow(dim, model_rank * size, size)


def unshard_leaf(block, spec: tuple, shape, mesh, group):
    """The global ``shape`` tensor from every model rank's ``block``: an
    ``all_gather`` over the model ``group``, joined along the dimension
    :func:`shard_leaf` cut (``block`` itself where the leaf is
    replicated)."""
    dim = model_dim(spec, tuple(shape), mesh)
    if dim is None or group is None:
        return block
    import torch
    import torch.distributed as dist
    block = block.contiguous()
    parts = [torch.empty_like(block)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, block, group=group)
    return torch.cat(parts, dim=dim)


def shard_tree(params, mesh, model_rank: int):
    """:func:`shard_leaf` over a parameter tree with its
    :func:`param_specs`."""
    return map_tree(lambda _, p, s: shard_leaf(p, s, mesh, model_rank),
                    params, param_specs(params))


def replicated_leaves(params, mesh) -> list:
    """Per leaf of ``params`` (global shapes), in the trees' leaf order:
    True where every model rank holds the whole leaf."""
    from ..core.compression import tree_leaves
    return tree_leaves(map_tree(
        lambda _, p, s: model_dim(s, tuple(p.shape), mesh) is None, params,
        param_specs(params)))


def param_specs(params) -> Any:
    """The tree of specs matching the parameter tree."""
    return map_tree(_leaf_spec, params)


def param_shardings(params, mesh) -> Any:
    """The parameter tree's :class:`Sharding` tree: each leaf's spec,
    fitted to its shape."""
    return map_tree(
        lambda _, p, s: Sharding(mesh, fit_spec(s, p.shape, mesh)),
        params, param_specs(params))


def batch_spec(mesh, global_batch: int) -> tuple:
    """The axes the batch dim splits over: every client axis, falling back
    to ``("data",)`` and then to none (every rank the whole batch) when the
    batch is too small to split."""
    used = mesh.client_axes
    if global_batch % math.prod(mesh.shape[a] for a in used) == 0:
        return used
    if "data" in mesh.axis_names and global_batch % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def batch_entry(mesh, global_batch: int):
    """The batch dimension's spec entry, in the reference's
    (``PartitionSpec``'s) form: ``None``, one axis name, or a tuple of
    names."""
    axes = batch_spec(mesh, global_batch)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def batch_rows(mesh, global_batch: int, rank: int) -> slice:
    """The rows of the global batch that client ``rank`` takes."""
    spec = batch_spec(mesh, global_batch)
    if not spec:
        return slice(0, global_batch)
    # the client index on the split axes: pod-major, as the mesh lays out
    # its ranks
    sizes = [mesh.shape[a] for a in mesh.client_axes]
    idx, coords = rank, []
    for size in reversed(sizes):
        coords.append(idx % size)
        idx //= size
    coords = dict(zip(reversed(mesh.client_axes), coords))
    shard, n = 0, 1
    for a in spec:
        shard = shard * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    per = global_batch // n
    return slice(shard * per, (shard + 1) * per)


def _cache_leaf_spec(cache, field: str, dp, mode: str) -> tuple:
    from ..models.attention import KVCache
    from ..models.mla import MLACache
    from ..models.rglru import RGLRUCache
    from ..models.ssm import SSMCache
    if isinstance(cache, KVCache):
        kv = ((dp, None, None, "model") if mode == "hd" else
              (dp, None, "model", None))
        return {"k": kv, "v": kv}.get(field, ())
    if isinstance(cache, MLACache):
        return {"c_kv": (dp, None, None),
                "k_rope": (dp, None, None)}.get(field, ())
    if isinstance(cache, SSMCache):
        return {"state": (dp, "model", None, None),
                "conv": (dp, None, "model")}.get(field, ())
    if isinstance(cache, RGLRUCache):
        return {"h": (dp, "model"),
                "conv": (dp, None, "model")}.get(field, ())
    raise TypeError(type(cache))


def cache_specs(caches: list, mesh, global_batch: int,
                mode: str | None = None) -> list:
    """Per-layer cache spec trees (the caches' NamedTuples, a spec a
    field; ``()`` for the scalar ``idx`` and the ``ring`` flag).  ``mode``
    is ``"heads"`` or ``"hd"`` (default :data:`CACHE_SHARD_MODE`)."""
    mode = mode or CACHE_SHARD_MODE
    dp = batch_entry(mesh, global_batch)
    out = []
    for c in caches:
        out.append(type(c)(*[
            _cache_leaf_spec(c, f, dp, mode)
            if getattr(getattr(c, f), "ndim", 0) > 0 else ()
            for f in c._fields]))
    return out


def tree_shardings(tree_of_specs, mesh):
    """A :class:`Sharding` for every spec of the tree."""
    return map_tree(lambda _, s: Sharding(mesh, s) if _is_spec(s) else s,
                tree_of_specs)
