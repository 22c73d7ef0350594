"""Mixture-of-Experts FFN: token-choice top-k router, shared + routed
experts, and the switch-style load-balance auxiliary loss.

Counterpart of ``repro/models/moe.py``.  Two dispatches, as there:

* ``"ragged"`` (exact, no token dropped): the ``T·k`` (token, expert)
  rows are sorted by expert and go through one product a non-empty expert
  over its slice of the sorted rows (:class:`_GroupedMM`, the twin of
  ``jax.lax.ragged_dot``).  The slices' sizes are read to the host: ONE
  host synchronization a call (a MoE layer's forward; remat's recompute
  reads them again).
* ``"capacity"``: the rows go into fixed ``(E, C, d)`` buffers, one
  batched product a matmul, and a row past its expert's capacity ``C`` is
  dropped, with the reference's capacity and drop set.  No host sync.

What the port fixes that the reference leaves to XLA:

* the router's top-k breaks ties toward the lower expert index, as
  ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk``
  promises no order for ties, and in bf16 the rounded logits tie often);
* the sorts are stable, as ``jnp.argsort`` is, so the capacity
  dispatch's ranks and drop set are the reference's;
* the k rows of a token are gathered back through the inverse permutation
  and added in a fixed order (top-k slot 0 first, one add in the rows'
  dtype a slot).  On the ragged dispatch every row movement is a gather
  both ways (:class:`_Rows`, :class:`_GroupedMM`): no atomic scatter-add,
  so the result and its gradients are the same on every run on the card,
  as the mesh trainer's deterministic local SGD needs.  The capacity
  dispatch (on none of the configs' paths) scatters into its buffers with
  ``index_copy``, whose gradient is an index add.

Under tensor parallelism (``tp``, a
:class:`~repro_torch.sharding.tensor_parallel.TensorParallel`) a rank
holds every expert's block of the hidden dim (``w_gate`` / ``w_up``
``(E, d, f/M)``, ``w_down`` ``(E, f/M, d)``, the shared experts split as a
dense MLP) and the whole router, as the reference's rules place them; no
row crosses ranks.  The router, its top-k and the aux loss run replicated
on the block's input as it comes (a replicated product's input gradient
is whole on every rank already); the experts' input passes
:func:`~repro_torch.sharding.tensor_parallel.copy_to`.  Each rank's
experts give a partial output; the gather back, the gate product, the
slot-order adds and the shared experts' partials are linear, so ONE
:func:`~repro_torch.sharding.tensor_parallel.reduce_from` after them
makes the output whole.  The gate's gradient needs the whole expert
output, which no rank holds: the ``(T, k)`` gates pass ``copy_to`` too,
so their partial gradients are summed over the model group (``T·k`` fp32
values a layer, not the ``T·k·d`` rows).  A step issues one collective a
MoE layer forward and two backward; the group sizes are the same on
every rank, whose block inputs are bitwise equal.  Where ``fit_spec``
keeps the experts whole (a ``d_expert`` that does not divide ``model``)
the block runs replicated, with no collective.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import MoEConfig
from .layers import dense_init, mlp_apply, mlp_init
from ..sharding.tensor_parallel import copy_to, reduce_from

__all__ = ["moe_init", "moe_apply", "route"]


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             act: str = "swiglu"):
    d_e, e = cfg.d_expert, cfg.n_experts
    scale = 1.0 / math.sqrt(d_model)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32)

    p = {
        "router": dense_init(gen, d_model, e, scale=0.02),
        # stacked expert weights: (E, d, f) / (E, f, d)
        "w_gate": normal(e, d_model, d_e) * scale,
        "w_up": normal(e, d_model, d_e) * scale,
        "w_down": normal(e, d_e, d_model) * (1.0 / math.sqrt(d_e)),
    }
    for i in range(cfg.n_shared):
        p[f"shared_{i}"] = mlp_init(gen, d_model, d_e, act)
    return p


def route(params, xt: torch.Tensor, cfg: MoEConfig):
    """The router on ``(T, d)`` tokens: ``(probs (T, E) fp32, gate_vals (T,
    k) fp32, normalized, expert_idx (T, k) int64)``.  The k largest
    probabilities of a token in descending order, ties toward the lower
    expert index (``jax.lax.top_k``'s order)."""
    logits = xt @ params["router"].to(xt.dtype)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    expert_idx = torch.argsort(probs, dim=-1, descending=True,
                               stable=True)[:, :cfg.top_k]
    gate_vals = torch.gather(probs, 1, expert_idx)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    return probs, gate_vals, expert_idx


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig, act: str = "swiglu",
              tp=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar fp32).  ``tp``: the
    rank's blocks of the experts (see the module's docstring)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    k, e = cfg.top_k, cfg.n_experts
    if params["w_up"].shape[2] == cfg.d_expert:
        tp = None                       # experts kept whole: replicated
    probs, gate_vals, expert_idx = route(params, xt, cfg)

    # ---- load-balance aux loss (switch-transformer style) -----------------
    one_hot = (expert_idx[..., None] == torch.arange(
        e, device=x.device)).to(torch.float32)                   # (T, k, E)
    me = torch.mean(probs, dim=0)                                # (E,)
    ce = torch.mean(torch.sum(one_hot, dim=1), dim=0)            # tokens/expert
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce) / k
    counts = torch.sum(one_hot, dim=(0, 1)).to(torch.int64)      # (E,)

    xc, gates = copy_to(xt, tp), copy_to(gate_vals, tp)
    dispatch = (_capacity_dispatch if cfg.dispatch == "capacity"
                else _ragged_dispatch)
    out = dispatch(params, xc, expert_idx, gates, counts, cfg, act)
    for i in range(cfg.n_shared):
        shared = {n: w.to(x.dtype) for n, w in params[f"shared_{i}"].items()}
        out = out + mlp_apply(shared, xc, act)
    return reduce_from(out, tp).reshape(b, s, d), aux


class _Rows(torch.autograd.Function):
    """``x[perm]`` for a permutation ``perm`` of the rows, with gradient
    ``g[inv]`` (``inv`` its inverse): a gather both ways."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g.index_select(0, inv), None, None


class _GroupedMM(torch.autograd.Function):
    """``out[rows of group j] = x[rows of group j] @ w[j]`` over consecutive
    groups of ``sizes`` (host integers) rows: ``jax.lax.ragged_dot``.  One
    product a non-empty group each way; an empty group's weight gradient
    is zero."""

    @staticmethod
    def forward(ctx, x, w, sizes):
        ctx.save_for_backward(x, w)
        ctx.sizes = sizes
        out = x.new_empty((x.shape[0], w.shape[2]))
        for j, (r0, r1) in enumerate(_spans(sizes)):
            if r1 > r0:
                torch.mm(x[r0:r1], w[j], out=out[r0:r1])
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = torch.zeros_like(x)
        dw = torch.zeros_like(w)
        for j, (r0, r1) in enumerate(_spans(ctx.sizes)):
            if r1 > r0:
                torch.mm(g[r0:r1], w[j].T, out=dx[r0:r1])
                torch.mm(x[r0:r1].T, g[r0:r1], out=dw[j])
        return dx, dw, None


def _spans(sizes):
    r0 = 0
    for n in sizes:
        yield r0, r0 + n
        r0 += n


def _expert_ffn(params, xs, act, dtype, grouped):
    """The expert FFN on rows grouped by expert; ``grouped(x, w)`` is the
    grouped product."""
    up_h = grouped(xs, params["w_up"].to(dtype))
    if act == "swiglu":
        h = F.silu(grouped(xs, params["w_gate"].to(dtype))) * up_h
    else:
        h = F.gelu(up_h, approximate="tanh")
    return grouped(h, params["w_down"].to(dtype))


def _combine(out_s, sort_idx, inv, gate_vals):
    """Sorted rows back to their tokens: each (token, slot) row by the
    inverse permutation, times its gate, and a token's k rows added in
    slot order.  (T·k, d) -> (T, d)."""
    t, k = gate_vals.shape
    rows = _Rows.apply(out_s, inv, sort_idx)
    rows = (rows * gate_vals.reshape(-1, 1).to(rows.dtype)).reshape(t, k, -1)
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def _sorted_rows(xt, expert_idx):
    """The (token, slot) rows of ``xt`` sorted by expert, stably:
    ``(xs (T·k, d), sort_idx, inv)``."""
    t, d = xt.shape
    k = expert_idx.shape[1]
    sort_idx = torch.argsort(expert_idx.reshape(-1), stable=True)
    inv = torch.argsort(sort_idx)
    x_rep = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    return _Rows.apply(x_rep, sort_idx, inv), sort_idx, inv


def _ragged_dispatch(params, xt, expert_idx, gate_vals, counts,
                     cfg: MoEConfig, act: str):
    """Sort-based exact dispatch, one product a non-empty expert."""
    xs, sort_idx, inv = _sorted_rows(xt, expert_idx)
    sizes = counts.tolist()                     # the one host sync
    out_s = _expert_ffn(params, xs, act, xt.dtype,
                        lambda x, w: _GroupedMM.apply(x, w, sizes))
    return _combine(out_s, sort_idx, inv, gate_vals)


def capacity(cfg: MoEConfig, t: int) -> int:
    """Rows an expert takes in the capacity dispatch, the reference's
    integer: ``max(int(t·k·cf/E + 0.999), 8)``, at most ``t·k``."""
    cap = max(int(t * cfg.top_k * cfg.capacity_factor / cfg.n_experts
                  + 0.999), 8)
    return min(cap, t * cfg.top_k)


def _capacity_dispatch(params, xt, expert_idx, gate_vals, counts,
                       cfg: MoEConfig, act: str):
    """Fixed-capacity dispatch: the sorted rows into ``(E, C, d)`` buffers,
    one batched product a matmul, back out; a row whose rank inside its
    expert's group reaches ``C`` is dropped (its contribution is zero)."""
    t, d = xt.shape
    k, e = cfg.top_k, cfg.n_experts
    cap = capacity(cfg, t)
    xs, sort_idx, inv = _sorted_rows(xt, expert_idx)
    grp = expert_idx.reshape(-1)[sort_idx]                      # sorted ids
    starts = torch.cumsum(counts, dim=0) - counts               # (E,)
    rank = torch.arange(t * k, device=xt.device) - starts[grp]  # pos in group
    keep = rank < cap
    dest = torch.where(keep, grp * cap + rank, e * cap)          # pad slot
    buf = xs.new_zeros((e * cap + 1, d)).index_copy(0, dest, xs)
    xe = buf[:e * cap].reshape(e, cap, d)

    out_e = _expert_ffn(params, xe, act, xt.dtype, torch.bmm)
    oe_flat = torch.cat([out_e.reshape(e * cap, d),
                         out_e.new_zeros((1, d))], dim=0)
    out_s = oe_flat.index_select(0, dest)
    return _combine(out_s, sort_idx, inv, gate_vals)
