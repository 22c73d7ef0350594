"""Tree-level codecs for the mesh trainer: STC, ternary quantization and
signSGD over a parameter tree, and the collectives over the client ranks.

Counterpart of ``repro/core/distributed.py``.  Global top-k over the whole
model is per-leaf masking with ONE global magnitude threshold, and µ is the
mean kept magnitude over every leaf.  The reference finds that threshold
leaf by leaf with jnp sweeps; the port copies the leaves, in
``jax.tree.flatten`` order, into one fp32 ``(1, numel)`` row and runs the
flat STC on it: on the ``"kernel"`` route
:func:`repro_torch.kernels.ops.stc_compress_rows` (one histogram, one
``bin_select`` and one ``stc_apply`` launch, no host synchronization), on
the ``"torch"`` route its plain version.  The leaves come back as views of
the ternary row.  Both select exactly what flattening-and-sorting selects.

Where fewer than k coordinates are non-zero the threshold is 0.  The
reference then counts zeros of its candidate gathers into ``nnz`` and µ;
the port counts non-zeros only, as its flat STC does (ROADMAP Queue 3,
R11).

``manual_axes`` is a ``torch.distributed`` process group over which the
leaves are sharded (``None``: each caller holds the whole tree), with
``psum`` as ``all_reduce(SUM)`` and ``all_gather``.  The sharded STC
gathers the shards' rows and selects over their concatenation, so it needs
no ``pmax``.  The gloo backend takes CUDA tensors for ``all_reduce`` and
``all_gather``, so two ranks on one card need no host copies.

``model`` (a :class:`ModelShards`) is the mesh trainer's tensor
parallelism: each rank of a client's model group holds its block of the
sharded leaves and the whole of the replicated ones (the norms, and any
leaf ``fit_spec`` leaves whole).  The selection is exact over the whole
tree and never gathers it: the rank's row puts its sharded leaves first,
model rank 0 counts the replicated ones once, and
:func:`~repro_torch.kernels.hist_select.hist_topk_threshold_split` selects
over the model group's parts; every rank then ternarizes its own row with
the global threshold and µ, the replicated leaves alike on every rank.
TernQuant sums its statistics the same way.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .compression import (_rebuild, _torch_apply_batch, _torch_select_batch,
                          flatten_pytree, stc_compress_blocks, tree_leaves,
                          tree_map, unflatten_pytree)
from .selection import DEFAULT_CAP, NBINS, flush_subnormal

__all__ = ["TreeStats", "ModelShards", "tree_numel", "stc_compress_tree",
           "stc_compress_tree_chunked", "ternary_quantize_tree",
           "sign_compress_tree", "tree_add", "tree_scale", "psum",
           "all_gather"]


class TreeStats(NamedTuple):
    nnz: torch.Tensor
    numel: int
    mu: torch.Tensor
    thresh: torch.Tensor


class ModelShards(NamedTuple):
    """A client's model group under tensor parallelism: the group, this
    rank's index in it, and per leaf (``tree_leaves`` order) whether every
    rank holds the whole leaf."""

    group: Any
    rank: int
    replicated: tuple


def tree_numel(tree) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(tree))


def tree_add(a, b):
    return tree_map(lambda x, y: x + y, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


# ---------------------------------------------------------------------------
# collectives over the client ranks
# ---------------------------------------------------------------------------

def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (``x`` itself for None)."""
    if group is None:
        return x
    import torch.distributed as dist
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group``, stacked along a new leading axis
    in rank order (``x[None]`` for None)."""
    if group is None:
        return x[None]
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


# ---------------------------------------------------------------------------
# STC over a tree
# ---------------------------------------------------------------------------


def _compress_row(row: torch.Tensor, k: int, backend: str, cap: int):
    """STC over a ``(1, n)`` carried row: ``(tern, residual, mu, thresh,
    nnz)``, the statistics of shape (1,)."""
    if backend == "kernel":
        from ..kernels.ops import stc_compress_rows
        return stc_compress_rows(row, k, cap=cap)
    if backend != "torch":
        raise ValueError(f"unknown STC backend {backend!r}; options: "
                         "['kernel', 'torch']")
    thresh, cnt, sums = _torch_select_batch(row, k)
    mu = sums / torch.clamp(cnt, min=1).to(torch.float32)
    tern, res = _torch_apply_batch(row, thresh, mu)
    return tern, res, mu, thresh, cnt


def _gathered_row(vec: torch.Tensor, group):
    """Every rank's flat row, concatenated in rank order, and where this
    rank's part starts and ends in it."""
    n = torch.tensor([vec.numel()], dtype=torch.int64, device=vec.device)
    sizes = [int(s) for s in all_gather(n, group).reshape(-1).tolist()]
    padded = F.pad(vec, (0, max(sizes) - vec.numel()))
    rows = all_gather(padded, group)
    import torch.distributed as dist
    me = dist.get_rank(group)
    start = sum(sizes[:me])
    return (torch.cat([rows[r, :s] for r, s in enumerate(sizes)]), start,
            start + vec.numel())


def _model_row(tree, model: ModelShards):
    """This rank's fp32 row with its sharded leaves first and its
    replicated leaves after them, the number of its elements that it
    counts (all on model rank 0, the sharded ones elsewhere), and the
    leaves' order in the row."""
    leaves = tree_leaves(tree)
    order = ([i for i, r in enumerate(model.replicated) if not r] +
             [i for i, r in enumerate(model.replicated) if r])
    row = torch.cat([leaves[i].reshape(-1).to(torch.float32)
                     for i in order])
    owned = row.numel() if model.rank == 0 else sum(
        leaves[i].numel() for i, r in enumerate(model.replicated) if not r)
    return row, owned, order


def _from_model_row(tree, vec, order):
    """The leaves of ``tree`` back from a :func:`_model_row` layout: views
    of ``vec``, in ``tree``'s dtypes."""
    leaves = tree_leaves(tree)
    out = [None] * len(leaves)
    start = 0
    for i in order:
        n = leaves[i].numel()
        out[i] = vec[start:start + n].reshape(leaves[i].shape).to(
            leaves[i].dtype)
        start += n
    return _rebuild(tree, iter(out))


def _split_compress_tree(tree, p: float, numel: int, model: ModelShards,
                         backend: str, cap: int):
    """STC of a tree split over the model group: the global selection of
    the owned rows, then each rank's own row ternarized."""
    from ..kernels.hist_select import hist_topk_threshold_split
    if backend not in ("kernel", "torch"):
        raise ValueError(f"unknown STC backend {backend!r}; options: "
                         "['kernel', 'torch']")
    row, owned, order = _model_row(tree, model)
    thresh, cnt, sums = hist_topk_threshold_split(
        row[None, :owned], max(int(numel * p), 1), model.group, cap=cap)
    mu = sums / torch.clamp(cnt, min=1).to(torch.float32)
    if backend == "kernel":
        from ..kernels.stc_compress import stc_apply_batched
        tern, res = stc_apply_batched(row[None], thresh, mu)
    else:
        tern, res = _torch_apply_batch(row[None], thresh, mu)
    stats = TreeStats(nnz=cnt[0], numel=numel, mu=mu[0], thresh=thresh[0])
    return (_from_model_row(tree, tern[0], order),
            _from_model_row(tree, res[0], order), stats)


def stc_compress_tree_with_residual(tree, p: float, *, manual_axes=None,
                                    numel: int | None = None,
                                    cap: int = DEFAULT_CAP,
                                    backend: str = "kernel", model=None):
    """:func:`stc_compress_tree` that also returns the new residual tree
    ``tree - ternary`` (the apply's second output): ``(ternary, residual,
    stats)``.  ``model`` (a :class:`ModelShards`) selects over the tree
    split across a model group; ``numel`` is then the global size."""
    numel = numel if numel is not None else tree_numel(tree)
    if model is not None:
        if manual_axes is not None:
            raise ValueError("manual_axes and model are exclusive")
        return _split_compress_tree(tree, p, numel, model, backend, cap)
    k = max(int(numel * p), 1)
    vec, spec = flatten_pytree(tree)
    if manual_axes is None:
        tern, res, mu, thresh, cnt = _compress_row(vec[None], k, backend, cap)
        tern, res = tern[0], res[0]
    else:
        full, lo, hi = _gathered_row(vec, manual_axes)
        tern, res, mu, thresh, cnt = _compress_row(full[None], k, backend,
                                                   cap)
        tern, res = tern[0, lo:hi], res[0, lo:hi]
    stats = TreeStats(nnz=cnt[0], numel=numel, mu=mu[0], thresh=thresh[0])
    return unflatten_pytree(tern, spec), unflatten_pytree(res, spec), stats


def stc_compress_tree(tree, p: float, *, manual_axes=None, iters: int = 32,
                      numel: int | None = None, bins: int = NBINS,
                      cap: int = DEFAULT_CAP, backend: str = "kernel",
                      model=None):
    """STC over a tree: returns ``(ternary_tree, stats)``.

    ``k = max(int(numel·p), 1)`` with ``numel`` the tree's size unless
    given (a sharded caller passes the global size).  ``iters`` and
    ``bins`` are the reference's; the selection here is exact at any bin
    population, so no bisection fallback is needed and ``bins`` is the
    kernels' 256.
    """
    if bins != NBINS:
        raise ValueError(f"the selection has {NBINS} bins, got {bins}")
    tern, _, stats = stc_compress_tree_with_residual(
        tree, p, manual_axes=manual_axes, numel=numel, cap=cap,
        backend=backend, model=model)
    return tern, stats


def stc_compress_tree_chunked(tree, p: float, chunk_size: int, *,
                              p_fn=None, backend: str = "kernel",
                              controller=None):
    """Per-``(leaf, chunk)`` STC: independent selection and µ per block.

    Each leaf is cut into ``ceil(size / chunk_size)`` zero-padded blocks
    and every block gets its own exact k-selection and ternary magnitude
    through :func:`~repro_torch.core.compression.stc_compress_blocks` (on
    the ``"kernel"`` route one selection and one apply a leaf).  No
    collectives.  ``p_fn(layer_name, depth) -> p | None`` is the per-layer
    sparsity schedule (names as ``jax.tree_util.keystr`` gives them);
    ``controller`` (a :mod:`repro_torch.core.adaptive` name or instance)
    picks per-chunk k; the tree path is stateless, so stateful controllers
    run their instantaneous rule.  Returns ``(ternary_tree, stats)`` with
    the aggregate nnz and µ of all blocks.
    """
    from .adaptive import make_controller, validate_sparsity
    from .chunking import _leaf_paths

    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    ctrl = make_controller(controller) if controller is not None else None
    if ctrl is not None and not ctrl.adapts:
        ctrl = None                      # "fixed": exactly the static path
    paths = list(_leaf_paths(tree))
    device = paths[0][1].device if paths else None
    out_leaves = []
    nnz_tot = torch.zeros((), dtype=torch.int32, device=device)
    mu_num = torch.zeros((), dtype=torch.float32, device=device)
    numel = 0
    for depth, (lname, leaf) in enumerate(paths):
        numel += leaf.numel()
        if leaf.numel() == 0:
            out_leaves.append(leaf)
            continue
        p_leaf = None if p_fn is None else p_fn(lname, depth)
        p_leaf = p if p_leaf is None \
            else validate_sparsity(p_leaf, lname, depth)
        flat = leaf.to(torch.float32).reshape(-1)
        w = min(chunk_size, flat.numel())
        n_chunks = -(-flat.numel() // w)
        blocks = F.pad(flat, (0, n_chunks * w - flat.numel())).reshape(
            n_chunks, w)
        valid = np.full(n_chunks, w, np.int64)
        valid[-1] = flat.numel() - (n_chunks - 1) * w
        ks = np.maximum((valid * p_leaf).astype(np.int64), 1)
        if ctrl is not None:
            caps = ctrl.caps(ks, valid)
            dyn_ks, _ = ctrl.chunk_ks(blocks[None], None, base_ks=ks,
                                      caps=caps)
            tern, cnt, mu = stc_compress_blocks(
                blocks, dyn_ks.reshape(n_chunks), backend=backend,
                k_cap=int(caps.max()))
        else:
            tern, cnt, mu = stc_compress_blocks(blocks, ks, backend=backend)
        out_leaves.append(tern.reshape(-1)[: flat.numel()]
                          .reshape(leaf.shape).to(leaf.dtype))
        nnz_tot = nnz_tot + cnt.sum(dtype=torch.int32)
        mu_num = mu_num + torch.sum(mu * cnt.to(torch.float32))
    out = _rebuild(tree, iter(out_leaves))
    mu = mu_num / torch.clamp(nnz_tot, min=1).to(torch.float32)
    return out, TreeStats(nnz=nnz_tot, numel=numel, mu=mu,
                          thresh=torch.zeros((), dtype=torch.float32,
                                             device=device))


def ternary_quantize_tree(tree, theta: float, *, manual_axes=None,
                          numel: int | None = None, model=None):
    """Dense ternary quantization over a tree (the tree twin of
    :func:`~repro_torch.core.compression.ternary_quantize`): Δ = θ·mean|x|
    over every leaf, µ = the mean kept magnitude.  Both sums are taken in
    fp64 and rounded once, as the flat operator does (ROADMAP Queue 3, R7);
    subnormals count as zeros.  ``model`` (a :class:`ModelShards`) sums
    over a model group, its replicated leaves counted on model rank 0
    only."""
    if model is not None:
        if manual_axes is not None:
            raise ValueError("manual_axes and model are exclusive")
        manual_axes = model.group
    numel = numel if numel is not None else tree_numel(tree)
    leaves = tree_leaves(tree)
    device = leaves[0].device
    abs_leaves = [flush_subnormal(leaf.to(torch.float32)).abs()
                  for leaf in leaves]
    counted = [a for i, a in enumerate(abs_leaves)
               if model is None or model.rank == 0
               or not model.replicated[i]]
    total = torch.zeros((), dtype=torch.float64, device=device)
    for a in counted:                                           # sweep 1
        total = total + a.sum(dtype=torch.float64)
    total = psum(total, manual_axes)
    mean = (total / torch.full_like(total, numel)).to(torch.float32)
    delta = flush_subnormal(theta * mean)

    cnt = torch.zeros((), dtype=torch.int64, device=device)     # sweep 2
    kept = torch.zeros((), dtype=torch.float64, device=device)
    for a in counted:
        m = a > delta
        cnt = cnt + m.sum()
        kept = kept + torch.where(m, a, torch.zeros_like(a)).sum(
            dtype=torch.float64)
    cnt = psum(cnt, manual_axes).to(torch.int32)
    kept = psum(kept, manual_axes).to(torch.float32)
    mu = flush_subnormal(kept / torch.clamp(cnt, min=1).to(torch.float32))

    def tern_leaf(x):
        xf = flush_subnormal(x.to(torch.float32))
        return torch.where(xf.abs() > delta, mu * torch.sign(xf),
                           torch.zeros_like(xf)).to(x.dtype)

    return tree_map(tern_leaf, tree), TreeStats(nnz=cnt, numel=numel, mu=mu,
                                                thresh=delta)


def sign_compress_tree(tree, step: float):
    """``step·sign(x)`` on every leaf; a subnormal coordinate has sign 0."""
    return tree_map(
        lambda x: (step * torch.sign(flush_subnormal(x.to(torch.float32))))
        .to(x.dtype), tree)
