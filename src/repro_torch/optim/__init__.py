"""Optimizers: momentum SGD, AdamW and learning-rate schedules, as plain
functions on trees of tensors.

Counterpart of ``repro/optim``.  Functional interface:

    state = init(params)
    new_params, new_state = apply(params, grads, state, lr)
"""

from .schedules import constant_lr, cosine_lr, warmup_cosine_lr
from .sgd import adamw_apply, adamw_init, sgd_apply, sgd_init

__all__ = ["sgd_init", "sgd_apply", "adamw_init", "adamw_apply",
           "constant_lr", "cosine_lr", "warmup_cosine_lr"]
