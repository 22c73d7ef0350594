"""SGD with momentum (the paper's client optimizer) and AdamW.

Counterpart of ``repro/optim/sgd.py``.  The state is fp32 whatever the
parameters' dtype, and each update is computed in fp32 and cast back to
the parameter's dtype.  ``lr`` is a Python number or a 0-d tensor (a
schedule's value).
"""

from __future__ import annotations

import torch

from ..core.compression import tree_leaves, tree_map

__all__ = ["sgd_init", "sgd_apply", "adamw_init", "adamw_apply"]


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd_init(params):
    """Momentum buffers, fp32, like params."""
    return tree_map(_zeros, params)


def sgd_apply(params, grads, state, lr, momentum: float = 0.9):
    """Classical (heavy-ball) momentum:  v' = m·v + g;  p' = p - lr·v'."""
    new_v = tree_map(lambda v, g: momentum * v + g.to(torch.float32),
                     state, grads)
    new_p = tree_map(lambda p, v: (p.to(torch.float32) - lr * v).to(p.dtype),
                     params, new_v)
    return new_p, new_v


def adamw_init(params):
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": tree_map(_zeros, params), "v": tree_map(_zeros, params),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_apply(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8,
                weight_decay=0.0):
    t = state["t"] + 1
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                 state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
        g.to(torch.float32)), state["v"], grads)
    tf = t.to(torch.float32)
    bc1 = 1 - torch.pow(b1, tf)
    bc2 = 1 - torch.pow(b2, tf)

    def upd(p, m, v):
        step = lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        if weight_decay:
            step = step + lr * weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - step).to(p.dtype)

    return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}
