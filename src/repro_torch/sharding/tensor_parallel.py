"""Tensor parallelism's collectives as autograd functions (Megatron-LM's
split products, Shoeybi et al. 2019).

The reference runs a mesh ``model`` axis > 1 as GSPMD's automatic axis:
XLA splits each product and inserts the collectives.  The port writes
them out.  A rank holds its :func:`~repro_torch.sharding.rules.shard_leaf`
block of every parameter; a column-parallel product's input passes
through :func:`copy_to` (identity forward, ``all_reduce`` of the gradient
backward: Megatron's *f*) and a row-parallel product's partial output
through :func:`reduce_from` (``all_reduce`` forward, identity backward:
*g*).  The vocabulary splits the embedding table and the tied head:
:func:`vocab_parallel_embedding` looks up the ids of the rank's range
and sums the rows over the ranks, and :func:`vocab_parallel_ce` takes the
cross-entropy of logits split over the vocabulary with one ``all_reduce``
MAX of the row maxima and one ``all_reduce`` SUM of the exp-sums and the
gold logits; its backward is local.

A :class:`TensorParallel` names the model group, this rank's index in it
and its size.  ``None`` in place of it (or of its group) makes every
function here the identity of one rank.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = ["TensorParallel", "copy_to", "reduce_from",
           "vocab_parallel_embedding", "vocab_parallel_ce"]


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
