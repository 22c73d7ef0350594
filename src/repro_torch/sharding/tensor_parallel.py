"""Tensor parallelism's collectives as autograd functions (Megatron-LM's
split products, Shoeybi et al. 2019).

The reference runs a mesh ``model`` axis > 1 as GSPMD's automatic axis:
XLA splits each product and inserts the collectives.  The port writes
them out.  A rank holds its :func:`~repro_torch.sharding.rules.shard_leaf`
block of every parameter; a column-parallel product's input passes
through :func:`copy_to` (identity forward, ``all_reduce`` of the gradient
backward: Megatron's *f*) and a row-parallel product's partial output
through :func:`reduce_from` (``all_reduce`` forward, identity backward:
*g*).  Where a split does not fall on whole heads, the attention joins the
rank's column blocks of q, k and v with :func:`gather_from` (``all_gather``
forward, the rank's block of the gradient backward), runs on whole heads
on every rank, and hands ``wo`` its row block with :func:`scatter_to` (the
rank's block forward, ``all_gather`` of the gradient backward): an
activation that every rank holds whole has a gradient that every rank holds
whole.  A leaf that ``fit_spec`` keeps whole is whole on every rank and its
product runs replicated, with none of these operators.  The vocabulary
splits the embedding table and the tied head:
:func:`vocab_parallel_embedding` looks up the ids of the rank's range
and sums the rows over the ranks, and :func:`vocab_parallel_ce` takes the
cross-entropy of logits split over the vocabulary with one ``all_reduce``
MAX of the row maxima and one ``all_reduce`` SUM of the exp-sums and the
gold logits; its backward is local.  Serving takes no gradient:
:func:`gather_vocab` joins the vocab-parallel head's logits with one
``all_gather``.  The MoE FFN adds nothing here: its experts are split
products, its gates' gradient a :func:`copy_to`.  :func:`arch_gap` says
which configs these splits run.

A :class:`TensorParallel` names the model group, this rank's index in it
and its size.  ``None`` in place of it (or of its group) makes every
function here the identity of one rank.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["TensorParallel", "copy_to", "reduce_from", "gather_from",
           "scatter_to", "vocab_parallel_embedding", "vocab_parallel_ce",
           "gather_vocab", "arch_gap"]


class TensorParallel(NamedTuple):
    """The model group of a client's ranks, this rank's index in it and
    the group's size."""

    group: Any
    rank: int
    size: int


def _all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` in place (``x`` is the caller's
    buffer)."""
    import torch.distributed as dist
    dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                    else dist.ReduceOp.SUM, group=group)
    return x


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The ranks' equal blocks ``x`` joined along ``dim`` in rank order."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _block(x: torch.Tensor, rank: int, size: int, dim: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``size`` equal blocks of ``x`` along
    ``dim``."""
    n = x.shape[dim] // size
    return x.narrow(dim, rank * n, n).contiguous()


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.block = (rank, size, dim)
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, *ctx.block), None, None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.group, ctx.size, ctx.dim = group, size, dim
        return _block(x, rank, size, dim)

    @staticmethod
    def backward(ctx, grad):
        return (_all_gather(grad, ctx.group, ctx.size, ctx.dim), None, None,
                None, None)


def _group(tp):
    return None if tp is None else tp.group


def copy_to(x: torch.Tensor, tp) -> torch.Tensor:
    """Megatron's *f*: ``x`` unchanged; its gradient summed over the model
    group."""
    group = _group(tp)
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, tp) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over the model group; the gradient
    passes unchanged."""
    group = _group(tp)
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, tp, dim: int = -1) -> torch.Tensor:
    """The model group's equal blocks ``x`` joined along ``dim`` in rank
    order (one ``all_gather``), held whole on every rank; the backward takes
    this rank's block of the whole gradient, with no collective."""
    group = _group(tp)
    if group is None:
        return x
    return _GatherFrom.apply(x, group, tp.rank, tp.size, dim % x.ndim)


def scatter_to(x: torch.Tensor, tp, dim: int = -1) -> torch.Tensor:
    """This rank's block of ``tp.size`` equal blocks of the whole ``x``
    along ``dim``; the backward joins the blocks' gradients with one
    ``all_gather``, so the whole gradient is on every rank."""
    group = _group(tp)
    if group is None:
        return x
    return _ScatterTo.apply(x, group, tp.rank, tp.size, dim % x.ndim)


def vocab_parallel_embedding(ids: torch.Tensor, table: torch.Tensor, tp,
                             dtype) -> torch.Tensor:
    """The rows of ``ids`` from a table split over the vocabulary: this
    rank's ``table`` holds rows ``[rank·V_l, (rank+1)·V_l)``.  Ids outside
    that range give zero rows; the rows, in ``dtype``, are summed over the
    model group (each id's row comes from exactly one rank, so the sum is
    exact)."""
    ids = ids.long()
    if _group(tp) is None:
        return torch.nn.functional.embedding(ids, table).to(dtype)
    v_local = table.shape[0]
    local = ids - tp.rank * v_local
    valid = (local >= 0) & (local < v_local)
    rows = torch.nn.functional.embedding(torch.clamp(local, 0, v_local - 1),
                                         table)
    rows = torch.where(valid[..., None], rows, torch.zeros_like(rows))
    return reduce_from(rows.to(dtype), tp)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group, rank):
        v_local = logits.shape[-1]
        row_max = logits.amax(dim=-1)
        _all_reduce(row_max, group, "max")
        e = torch.exp(logits - row_max[..., None])
        local = labels.long() - rank * v_local
        valid = (local >= 0) & (local < v_local)
        local = torch.clamp(local, 0, v_local - 1)
        gold = torch.take_along_dim(logits, local[..., None], dim=-1)[..., 0]
        gold = torch.where(valid, gold, torch.zeros_like(gold))
        sums = _all_reduce(torch.stack([e.sum(dim=-1), gold]), group)
        ctx.save_for_backward(e, sums[0], local, valid)
        return torch.log(sums[0]) + row_max - sums[1]

    @staticmethod
    def backward(ctx, grad):
        e, total, local, valid = ctx.saved_tensors
        p = e / total[..., None]
        p.scatter_add_(-1, local[..., None],
                       -valid[..., None].to(p.dtype))
        return grad[..., None] * p, None, None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      tp) -> torch.Tensor:
    """Per-position ``logsumexp(logits) - logits[label]`` over the whole
    vocabulary, from fp32 ``logits`` split over it (this rank's columns
    ``[rank·V_l, (rank+1)·V_l)``).  One ``all_reduce`` MAX of the row
    maxima, one ``all_reduce`` SUM of the exp-sums and the gold logits
    (which one rank holds); the backward, ``softmax - onehot`` on the
    rank's columns, needs no collective."""
    if _group(tp) is None:
        gold = torch.take_along_dim(logits, labels.long()[..., None],
                                    dim=-1)[..., 0]
        return torch.logsumexp(logits, dim=-1) - gold
    return _VocabParallelCE.apply(logits, labels, tp.group, tp.rank)


def gather_vocab(logits: torch.Tensor, tp) -> torch.Tensor:
    """The whole vocabulary's logits from each rank's columns ``[rank·V_l,
    (rank+1)·V_l)`` of the last dimension: one ``all_gather`` over the
    model group, joined in rank order.  Forward only (serving)."""
    if _group(tp) is None:
        return logits
    return _all_gather(logits, tp.group, tp.size, logits.ndim - 1)


def arch_gap(cfg, mesh):
    """Why the split products cannot run ``cfg`` with ``mesh``'s ``model``
    axis, or None where they can: ``model = 1``, or the attention family,
    dense or MoE (the experts split on their hidden dim,
    :func:`repro_torch.models.moe.moe_apply`), on every split that
    ``fit_spec`` makes (whole heads, heads cut mid-head, leaves kept
    whole).  The message names the ROADMAP item that would run it."""
    m = mesh.shape.get("model", 1)
    if m == 1:
        return None
    kinds = {cfg.layer_kind(i) for i in range(cfg.n_layers)}
    family = [name for name, there in (
        ("MLA blocks", "mla" in kinds),
        ("SSD blocks", "ssd" in kinds), ("RG-LRU blocks", "rglru" in kinds),
        ("an encoder", cfg.encoder is not None),
        ("a prefix", bool(cfg.n_prefix_tokens))) if there]
    if family:
        return (f"tensor parallelism (a mesh 'model' axis of {m}) runs the "
                f"attention family, dense or MoE; {cfg.name} has "
                f"{', '.join(family)} (ROADMAP.md Queue 1, item 4c)")
    return None
