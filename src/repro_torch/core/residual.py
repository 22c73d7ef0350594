"""Error-feedback residual accumulation (paper Eqs. 9, 11, 12).

Counterpart of ``repro/core/residual.py``.  Clients and the server keep a
residual ``A`` holding the part of the update that compression dropped:

    client:  A_i <- A_i + ΔW_i - STC(ΔW_i + A_i)        (Eq. 11)
    server:  A   <- A   + ΔW   - STC(ΔW   + A)          (Eq. 12)

The residual is kept in fp32 whatever the model's dtype.

The stacked-state helpers keep a whole cohort's codec state as one state
with a leading ``(n_clients,)`` axis, so the trainer never inspects the
codec's state type.  A state is a tensor, a NamedTuple or dict of states,
or None (a stateless codec).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .selection import flush_subnormal

__all__ = ["ResidualState", "init_residual", "compress_with_feedback",
           "map_states", "stack_states", "take_states", "scatter_states"]


class ResidualState(NamedTuple):
    """fp32 residual, a flat vector (or a stack of them)."""

    residual: torch.Tensor


def init_residual(numel: int, device=None) -> ResidualState:
    return ResidualState(residual=torch.zeros(numel, dtype=torch.float32,
                                              device=device))


def compress_with_feedback(update: torch.Tensor, state: ResidualState,
                           compress_fn: Callable):
    """One error-feedback step: ``ΔW~ = C(ΔW + A)``, ``A' = (ΔW + A) -
    ΔW~``.  ``update`` and ``state.residual`` are ``(n,)`` with a
    single-vector ``compress_fn`` or ``(B, n)`` with a batched one.  Each
    operand and result of the two fp32 sums is flushed as XLA flushes it
    (subnormals count as zeros), so the residual is the reference's bit for
    bit given the same compressed message.  Returns ``(compressed,
    new_state, stats)``."""
    carried = flush_subnormal(flush_subnormal(update.to(torch.float32))
                              + flush_subnormal(state.residual))
    compressed, stats = compress_fn(carried)
    new_res = flush_subnormal(carried - compressed.to(torch.float32))
    return compressed, ResidualState(residual=new_res), stats


def map_states(fn, *states):
    """Apply ``fn`` leaf-wise across one or more states of equal structure."""
    first = states[0]
    if first is None:
        return None
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(map_states(fn, *parts) for parts in zip(*states)))
    if isinstance(first, dict):
        return {key: map_states(fn, *(s[key] for s in states)) for key in first}
    return fn(*states)


def stack_states(state, n: int):
    """Replicate one client's state along a leading (n,) client axis."""
    return map_states(lambda x: x[None].expand((n,) + tuple(x.shape)).clone(),
                state)


def take_states(states, idx):
    """The per-client slices ``states[idx]`` of a stacked state."""
    return map_states(lambda x: x[idx], states)


def scatter_states(states, idx, new):
    """Write updated per-client slices back into the stacked state (in
    place: the stacked state is the trainer's own)."""
    def put(full, upd):
        full[idx] = upd
        return full
    return map_states(put, states, new)
