"""Core compression operators of the STC paper (Sattler et al., 2019).

Counterpart of ``repro/core/compression.py``, in PyTorch:

* ``top_k_mask``  -- the mask of the k largest magnitudes (ties kept)
* ``top_k_sparsify`` -- top-k magnitude sparsification (Aji & Heafield '17)
* ``ternarize``   -- Algorithm 1 lines 6-8: kept entries -> ``{-µ, 0, +µ}``
* ``ternary_quantize`` -- dense TWN ternary quantization (T-FedAvg)
* ``stc_compress`` -- sparsify + ternarize in one call (the STC operator)
* ``sign_compress`` / ``majority_vote_sign`` -- signSGD and its
  (weighted) majority vote
* ``flatten_pytree`` / ``unflatten_pytree`` -- one fp32 vector over every
  leaf of a parameter tree, in ``jax.tree.flatten`` order (sorted dict keys,
  lists in order), so the paper's *global* top-k selects the same
  coordinates as the reference
* the ``StcBackend`` registry: ``"torch"`` (``torch.topk`` selection, the
  counterpart of the reference's ``"jnp"`` and the tests' oracle) and
  ``"kernel"`` (the histogram selection and fused apply kernels of
  :mod:`repro_torch.kernels`, the default);
* ``stc_compress_blocks`` / ``select_batch_dynamic`` -- STC over
  independent rows with a k per row, the core of the chunked ``(layer,
  chunk)`` codecs (:mod:`repro_torch.core.chunking`); the ks may be a
  tensor computed on the device (the adaptive controllers of
  :mod:`repro_torch.core.adaptive`), which the ``"kernel"`` route selects
  by without reading them back.

Subnormal fp32 values (``|x| < FLT_MIN``) count as zero, as the reference
computes them under XLA's flush-to-zero: never selected or counted, no part
of µ, a residual of 0 and a sign of 0 (``core.selection.flush_subnormal``).
The ``"torch"`` route flushes the operands and the result of every fp32 sum
as XLA does, so its residuals are the reference's bit for bit.

The top-k operators select through the ``"kernel"`` backend's exact
k-selection (the histogram and ``bin_select`` kernels on the card, their
plain versions on the CPU), one launch of each for a ``(B, n)`` batch.
Each operator has a batched form over the rows of a ``(B, n)`` matrix
(``*_batch``); the single-vector form is a batch of one row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .selection import flush_subnormal

__all__ = [
    "CompressionStats",
    "top_k_mask",
    "top_k_mask_batch",
    "top_k_sparsify",
    "top_k_sparsify_batch",
    "ternarize",
    "ternary_quantize",
    "ternary_quantize_batch",
    "stc_compress",
    "sign_compress",
    "majority_vote_sign",
    "flatten_pytree",
    "unflatten_pytree",
    "tree_leaves",
    "tree_map",
    "StcBackend",
    "select_batch_dynamic",
    "stc_compress_blocks",
    "register_stc_backend",
    "get_stc_backend",
    "STC_BACKENDS",
]


class CompressionStats(NamedTuple):
    """Side information produced by a compression op (for the bit ledger)."""

    nnz: torch.Tensor       # number of non-zero elements communicated
    numel: torch.Tensor     # total number of elements
    mu: torch.Tensor        # ternary magnitude


def _k_from_p(n: int, p: float) -> int:
    """Paper Algorithm 1 line 3: ``k <- max(np, 1)``."""
    return max(int(n * p), 1)


def top_k_mask_batch(x: torch.Tensor, k):
    """Per row of ``(B, n)`` ``x``: the mask of ``|x| >= v`` with v the
    k-th largest magnitude (ties kept, as in Algorithm 1 line 5; zeros and
    subnormals never kept), and its count.  ``k`` is an int or one per
    row.  The selection is the ``"kernel"`` backend's: no top-k or sort on
    the card."""
    a = flush_subnormal(x.to(torch.float32)).abs()
    thresh, cnt, _ = get_stc_backend("kernel").select_batch(a, k)
    return (a >= thresh[:, None]) & (a > 0.0), cnt


def top_k_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """The mask of :func:`top_k_mask_batch` over flattened ``x``."""
    return top_k_mask_batch(x.reshape(1, -1), k)[0].reshape(x.shape)


def top_k_sparsify_batch(x: torch.Tensor, p: float):
    """``top_p%`` operator of Eq. (8) on every row of ``(B, n)`` ``x``:
    keep the fraction-p largest magnitudes (``k = max(int(n·p), 1)``) with
    their values.  A row with fewer non-zeros than k keeps its non-zeros.
    Returns ``(out, CompressionStats)`` with ``(B,)`` statistics (µ = 0)."""
    rows, n = x.shape
    mask, cnt = top_k_mask_batch(x, _k_from_p(n, p))
    out = torch.where(mask, x, torch.zeros_like(x))
    stats = CompressionStats(
        nnz=cnt, numel=torch.full((rows,), n),
        mu=torch.zeros(rows, dtype=x.dtype, device=x.device))
    return out, stats


def top_k_sparsify(x: torch.Tensor, p: float):
    """:func:`top_k_sparsify_batch` over flattened ``x``."""
    out, stats = top_k_sparsify_batch(x.reshape(1, -1), p)
    return out.reshape(x.shape), CompressionStats(*(s[0] for s in stats))


def ternarize(x: torch.Tensor, mask: torch.Tensor):
    """Algorithm 1 lines 6-8: ``(T*, µ)`` with µ the mean kept magnitude."""
    k = torch.clamp(mask.sum(), min=1)
    masked = torch.where(mask, x, torch.zeros_like(x))
    mu = masked.abs().sum() / k.to(x.dtype)
    return mu * torch.sign(masked), mu


def stc_compress(x: torch.Tensor, p: float):
    """Sparse Ternary Compression: Algorithm 1 of the paper."""
    k = _k_from_p(x.numel(), p)
    mask = top_k_mask(x, k)
    tern, mu = ternarize(x, mask)
    stats = CompressionStats(nnz=mask.sum(), numel=torch.tensor(x.numel()),
                             mu=mu)
    return tern, stats


def ternary_quantize_batch(x: torch.Tensor, theta: float = 0.75):
    """Dense ternary quantization (TWN thresholding; T-FedAvg, Xu et al.
    '20) of every row of ``(B, n)`` ``x``: keep ``|x| > Δ`` with
    ``Δ = θ·mean(|x|)`` and map the survivors to ``{-µ, +µ}``, µ the mean
    kept magnitude.  Both sums are taken in fp64; the mean is divided in
    fp64 by a tensor (CUDA divides by a Python scalar through its
    reciprocal, which is not correctly rounded) and rounded once to fp32,
    µ divided in fp32 as the reference divides it.  So the card and the CPU
    agree on Δ and µ; against the reference's fp32 reductions they may
    differ in the last ulp (ROADMAP R7).  Subnormals count as zeros.
    Returns ``(out, CompressionStats)`` with ``(B,)`` statistics."""
    xf = flush_subnormal(x.to(torch.float32))
    a = xf.abs()
    total = a.sum(dim=-1, dtype=torch.float64)
    mean = (total / torch.full_like(total, a.shape[-1])).to(torch.float32)
    delta = flush_subnormal(theta * mean)
    mask = a > delta[:, None]
    cnt = mask.sum(dim=-1, dtype=torch.int32)
    kept = torch.where(mask, a, torch.zeros_like(a)).sum(
        dim=-1, dtype=torch.float64).to(torch.float32)
    mu = flush_subnormal(kept / torch.clamp(cnt, min=1).to(torch.float32))
    out = torch.where(mask, mu[:, None] * torch.sign(xf),
                      torch.zeros_like(xf)).to(x.dtype)
    stats = CompressionStats(nnz=cnt, numel=torch.full((x.shape[0],),
                                                       x.shape[-1]),
                             mu=mu.to(x.dtype))
    return out, stats


def ternary_quantize(x: torch.Tensor, theta: float = 0.75):
    """:func:`ternary_quantize_batch` over flattened ``x``."""
    out, stats = ternary_quantize_batch(x.reshape(1, -1), theta)
    return out.reshape(x.shape), CompressionStats(*(s[0] for s in stats))


def sign_compress(x: torch.Tensor, step: float):
    """signSGD with a coordinate-wise step size δ (paper Section VI uses
    δ = 2e-4).  A subnormal coordinate has sign 0 (the reference's flush);
    ``torch.sign`` gives +0 where ``jnp.sign`` keeps -0."""
    out = (step * torch.sign(flush_subnormal(x))).to(x.dtype)
    stats = CompressionStats(nnz=torch.tensor(x.numel()),
                             numel=torch.tensor(x.numel()),
                             mu=torch.tensor(step, dtype=x.dtype))
    return out, stats


def majority_vote_sign(stacked_signs: torch.Tensor, step: float,
                       weights=None) -> torch.Tensor:
    """signSGD-with-majority-vote server aggregation (Bernstein et al. '18).

    ``stacked_signs``: (n_clients, ...) tensor of ±step (or ±1) client
    updates.  Returns the ±step majority direction per coordinate.
    ``weights`` (a per-client vector, e.g. participation mask × staleness
    decay) turns the vote into a weighted vote; None is the plain vote.
    """
    signs = torch.sign(stacked_signs)
    if weights is not None:
        w = torch.as_tensor(weights, dtype=signs.dtype, device=signs.device)
        signs = signs * w.reshape((-1,) + (1,) * (signs.ndim - 1))
    vote = torch.sign(signs.sum(dim=0))
    return (step * vote).to(stacked_signs.dtype)


# ---------------------------------------------------------------------------
# Parameter trees: the paper compresses the *flattened* update of the whole
# network, so top-k competes globally across layers.
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree.flatten`` order: dict keys sorted, lists and
    tuples in order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more trees of equal structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def _skeleton(tree):
    """The tree's structure with every leaf replaced by None."""
    if isinstance(tree, dict):
        return {key: _skeleton(tree[key]) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(sub) for sub in tree)
    return None


def _rebuild(template, leaves):
    if isinstance(template, dict):
        return {key: _rebuild(template[key], leaves) for key in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(sub, leaves) for sub in template)
    return next(leaves)


def flatten_pytree(tree):
    """Concatenate every leaf into one fp32 vector; returns ``(vector,
    spec)`` with the spec that :func:`unflatten_pytree` takes."""
    leaves = tree_leaves(tree)
    shapes = [(tuple(leaf.shape), leaf.dtype) for leaf in leaves]
    vec = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    return vec, (_skeleton(tree), shapes)


def unflatten_pytree(vec: torch.Tensor, spec):
    """Inverse of :func:`flatten_pytree`.  Leading dimensions of ``vec``
    (a stacked cohort, ``(P, numel)``) carry over onto every leaf."""
    template, shapes = spec
    lead = tuple(vec.shape[:-1])
    leaves, offset = [], 0
    for shape, dtype in shapes:
        size = int(np.prod(shape, dtype=np.int64))
        leaves.append(vec[..., offset:offset + size].reshape(lead + shape)
                      .to(dtype))
        offset += size
    return _rebuild(template, iter(leaves))


# ---------------------------------------------------------------------------
# Compressor backend registry: the codec picks its STC implementation by
# name.  Both backends give the same masks, thresholds and counts; µ agrees
# to fp32 rounding (the kernel route assembles Σ from histogram bins).
# ---------------------------------------------------------------------------


class StcBackend(NamedTuple):
    """STC with error feedback in single and batched (client-axis) forms.

    ``compress_with_residual(delta (n,), residual (n,), p)`` and
    ``compress_with_residual_batch(deltas (B, n), residuals (B, n), p)``
    return ``(msg, new_residual, CompressionStats)``.  ``select_batch(x (B,
    n), ks)`` is the per-row exact k-selection, ``(thresh, count, sum_abs)``
    of shape (B,), for ks given on the host; ``select_batch_dynamic(x, ks,
    k_cap)`` the same for a ``(B,)`` integer tensor of ks (the adaptive
    controllers' ks), clipped into ``[1, k_cap]``.  ``carry(deltas,
    residuals)`` is the route's carried sum and ``compress_rows(carried,
    ks, k_cap)`` its STC over the carried rows with per-row ks (a tensor
    of ks needs ``k_cap``), ``(tern, residual, count, mu)``.
    """

    name: str
    compress_with_residual: object
    compress_with_residual_batch: object
    select_batch: object = None
    select_batch_dynamic: object = None
    carry: object = None
    compress_rows: object = None


def _static_ks(ks, n_rows: int, n: int) -> np.ndarray:
    """Normalize a static per-row k spec to a (B,) numpy int array."""
    arr = np.broadcast_to(np.asarray(ks, np.int64), (n_rows,))
    if arr.size and not (1 <= int(arr.min()) and int(arr.max()) <= n):
        raise ValueError(f"per-row k out of range [1, {n}]: {arr}")
    return arr


def _k_cap(k_cap: int, n: int) -> int:
    k_cap = min(int(k_cap), n)
    if k_cap < 1:
        raise ValueError(f"k_cap must be >= 1, got {k_cap}")
    return k_cap


def _mask_stats(a: torch.Tensor, v: torch.Tensor):
    """Count and mass of ``a >= v`` and ``> 0`` per row, mask-then-reduce
    as the reference's ``"jnp"`` selection reduces them."""
    mask = (a >= v[:, None]) & (a > 0.0)
    cnt = mask.sum(dim=1, dtype=torch.int32)
    sums = torch.where(mask, a, torch.zeros_like(a)).sum(dim=1)
    return v, cnt, sums


def _torch_select_batch(x: torch.Tensor, ks):
    """Per-row exact k-selection via one ``torch.topk`` gather; count and
    sum are mask-then-reduce, as in the reference's ``_jnp_select_batch``."""
    bsz, n = x.shape
    ks = _static_ks(ks, bsz, n)
    a = flush_subnormal(x.to(torch.float32)).abs()
    topc = torch.topk(a, min(int(ks.max()), n), dim=1).values
    kj = torch.tensor(ks, dtype=torch.int64, device=x.device)
    return _mask_stats(a, topc.gather(1, (kj - 1)[:, None])[:, 0])


def _torch_select_batch_dynamic(x: torch.Tensor, ks, k_cap: int):
    """Per-row k-selection with per-row ks that may live on the device, as
    the reference's ``_jnp_select_batch_dynamic``: one ``torch.topk`` of
    width ``k_cap``, then each row's threshold gathered at ``ks[b] - 1``
    (ks clipped into ``[1, k_cap]``)."""
    bsz, n = x.shape
    k_cap = _k_cap(k_cap, n)
    a = flush_subnormal(x.to(torch.float32)).abs()
    topc = torch.topk(a, k_cap, dim=1).values
    kj = torch.clamp(torch.as_tensor(ks, device=x.device).to(torch.int64)
                     .reshape(-1).expand(bsz), 1, k_cap)
    return _mask_stats(a, topc.gather(1, (kj - 1)[:, None])[:, 0])


def _torch_carry(deltas, residuals):
    """The carried sum with its operands and result flushed, as XLA
    computes it."""
    return flush_subnormal(flush_subnormal(deltas.to(torch.float32))
                           + flush_subnormal(residuals.to(torch.float32)))


def _torch_apply_batch(carried, thresh, mu):
    """``(tern, residual)``: kept entries ``|c| >= t & |c| > 0`` become
    ``µ·sign(c)``; the residual is ``c - tern``, flushed."""
    c = flush_subnormal(carried)
    a = c.abs()
    mask = (a >= thresh[:, None]) & (a > 0.0)
    tern = torch.where(mask, mu[:, None] * torch.sign(c), torch.zeros_like(c))
    return tern, flush_subnormal(c - tern)


def _torch_compress_rows(carried: torch.Tensor, ks, k_cap=None):
    """The ``"torch"`` route's STC over the rows of ``carried`` with
    per-row ks: ``(tern, residual, count, mu)``.  A tensor of ks takes the
    dynamic selection, bounded by ``k_cap``."""
    if isinstance(ks, torch.Tensor):
        if k_cap is None:
            raise ValueError(
                "per-row ks computed as a tensor (adaptive controller) "
                "require a static k_cap bound; pass k_cap=int(caps.max())")
        thresh, cnt, sums = _torch_select_batch_dynamic(carried, ks,
                                                        int(k_cap))
    else:
        thresh, cnt, sums = _torch_select_batch(carried, ks)
    mu = sums / torch.clamp(cnt, min=1).to(torch.float32)
    tern, res = _torch_apply_batch(carried, thresh, mu)
    return tern, res, cnt, mu


def _stc_rows(be: StcBackend, carried: torch.Tensor, ks, k_cap=None):
    """STC over the rows of ``carried`` with per-row ks through backend
    ``be``'s ``compress_rows``: ``(tern, residual, count, mu)``."""
    if be.compress_rows is None:
        raise NotImplementedError(
            f"STC backend {be.name!r} does not implement compress_rows; "
            "chunked (layer, chunk) selection requires it -- see "
            "StcBackend.compress_rows")
    return be.compress_rows(carried, ks, k_cap)


def _torch_compress_with_residual_batch(deltas, residuals, p: float):
    carried = _torch_carry(deltas, residuals)
    tern, res, cnt, mu = _torch_compress_rows(
        carried, _k_from_p(carried.shape[1], p))
    numel = torch.full((carried.shape[0],), carried.shape[1])
    return tern, res, CompressionStats(nnz=cnt, numel=numel, mu=mu)


def _single(batch_fn):
    """The single-vector form of a batched compressor: a row batch of one."""
    def single(delta, residual, p: float):
        tern, res, stats = batch_fn(delta.reshape(1, -1),
                                    residual.reshape(1, -1), p)
        return tern[0], res[0], CompressionStats(*(s[0] for s in stats))
    return single


def select_batch_dynamic(x: torch.Tensor, ks, k_cap: int, *,
                         backend: str = "kernel"):
    """Registry dispatch for the selection with per-row ks that may live on
    the device: ``(thresh, count, sum_abs)`` of shape (B,), ks clipped into
    ``[1, min(k_cap, n)]``."""
    return get_stc_backend(backend).select_batch_dynamic(x, ks, k_cap)


def stc_compress_blocks(carried: torch.Tensor, ks, *, backend: str = "kernel",
                        k_cap=None):
    """STC over independent ``(B, block_numel)`` rows with a k per row.

    The chunked-codec core: every row (one ``(layer, chunk)`` block,
    zero-padded past its valid length -- padding is never selected, since
    zeros are not) gets its own threshold and ternary magnitude.  Returns
    ``(tern, count, mu)`` with ``tern`` of the input shape and (B,)
    count and µ.  A single whole-vector row is the flat operator's.

    ``ks`` is a static int or per-row host array, or an integer tensor
    (the adaptive controllers', on the device), which needs the static
    ceiling ``k_cap``.  The ``"kernel"`` route is
    ``kernels/ops.py::stc_compress_rows``, the flat round's composition: a
    device tensor of ks is clipped where it lies and never read back, and
    the selection is the histogram and ``bin_select`` kernels and the
    ternarize ``stc_apply``, one launch each."""
    be = get_stc_backend(backend)
    tern, _, cnt, mu = _stc_rows(be, carried.to(torch.float32), ks, k_cap)
    return tern, cnt, mu


STC_BACKENDS: dict[str, StcBackend] = {
    "torch": StcBackend("torch",
                        _single(_torch_compress_with_residual_batch),
                        _torch_compress_with_residual_batch,
                        _torch_select_batch, _torch_select_batch_dynamic,
                        _torch_carry, _torch_compress_rows),
}


def register_stc_backend(backend: StcBackend) -> None:
    STC_BACKENDS[backend.name] = backend


def _make_kernel_backend() -> StcBackend:
    # lazy: keeps core import-light (layering: kernels -> core, never back)
    from repro_torch.kernels import (hist_topk_threshold_batched,
                                     stc_compress_batch, stc_compress_rows)

    def batch(deltas, residuals, p: float):
        tern, new_res, mu, _, nnz = stc_compress_batch(deltas, residuals, p)
        numel = torch.full((deltas.shape[0],), deltas.shape[1])
        return tern, new_res, CompressionStats(nnz=nnz, numel=numel, mu=mu)

    def rows(carried, ks, k_cap=None):
        tern, res, mu, _, cnt = stc_compress_rows(carried, ks, k_cap=k_cap)
        return tern, res, cnt, mu

    def select(x, ks):
        arr = _static_ks(ks, x.shape[0], x.shape[1])
        # a shared k stays an int: the selection fills it on the device
        return hist_topk_threshold_batched(x, ks if np.ndim(ks) == 0
                                           else arr)

    def select_dynamic(x, ks, k_cap: int):
        # the same exact histogram route: for ks <= k_cap it is the static
        # selection, so no top-k of width k_cap is needed
        k_cap = _k_cap(k_cap, x.shape[1])
        if not isinstance(ks, torch.Tensor):
            return select(x, np.clip(np.asarray(ks, np.int64), 1, k_cap))
        kj = torch.clamp(ks.to(device=x.device, dtype=torch.int64)
                         .reshape(-1), 1, k_cap)
        return hist_topk_threshold_batched(x, kj)

    def carry(deltas, residuals):
        # one add, as kernels/ops.py::stc_compress_batch forms it (ROADMAP
        # Queue 3, R5)
        return deltas.to(torch.float32) + residuals.to(torch.float32)

    return StcBackend("kernel", _single(batch), batch, select,
                      select_dynamic, carry, rows)


def get_stc_backend(name: str) -> StcBackend:
    """Look up a registered STC backend ("torch" / "kernel") by name."""
    if name == "kernel" and name not in STC_BACKENDS:
        register_stc_backend(_make_kernel_backend())
    if name not in STC_BACKENDS:
        raise ValueError(
            f"unknown STC backend {name!r}; options: "
            f"{sorted(set(STC_BACKENDS) | {'kernel'})}")
    return STC_BACKENDS[name]
