"""Learning-rate schedules (the paper uses constant LR throughout).

Counterpart of ``repro/optim/schedules.py``: each schedule maps a step (a
Python integer or an integer tensor) to an fp32 tensor, computed in fp32
as the reference computes it.  The cosine is the C library's ``cosf``,
the function XLA's CPU backend calls (``torch.cos`` is off by an ulp at
about 5 % of arguments), so a schedule's values are bitwise the
reference's; where no C math library is found, ``torch.cos``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import torch

__all__ = ["constant_lr", "cosine_lr", "warmup_cosine_lr"]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    name = ctypes.util.find_library("m")
    if name is None:
        return None
    fn = ctypes.CDLL(name).cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def _cos(t: torch.Tensor) -> torch.Tensor:
    cosf = _libm_cosf()
    if cosf is None:
        return torch.cos(t)
    return torch.tensor([cosf(v) for v in t.reshape(-1).tolist()],
                        dtype=torch.float32).reshape(t.shape).to(t.device)


def constant_lr(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_lr(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / _f32(total_steps), 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac) * 0.5 *
                     (1 + _cos(math.pi * t)))
    return f


def warmup_cosine_lr(lr: float, warmup: int, total_steps: int,
                     final_frac: float = 0.1):
    cos = cosine_lr(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        w = torch.clamp(_f32(step) / _f32(max(warmup, 1)), 0.0, 1.0)
        return torch.where(_f32(step) < warmup, lr * w, cos(step - warmup))
    return f
