"""Checkpoints: the pytree ``save_checkpoint`` / ``restore_checkpoint``
(a parameter tree against a template, keyed by the string of its JAX
treedef: files restore across the port and the reference) and
crash-consistent trainer state, ``save_state`` / ``restore_state``.

The latter is the template-free tagged composite of the reference's
``checkpoint/msgpack_ckpt.py`` (event clock, in-flight payloads, RNG
states, codec states, ledgers, logs), with a tag for ``torch.Tensor``.
Both are serialized by the port's own encoder for the msgpack subset they
use and compressed with stdlib ``zlib``.
"""

from .msgpack_ckpt import (restore_checkpoint, restore_state,
                           save_checkpoint, save_state)

__all__ = ["save_checkpoint", "restore_checkpoint", "save_state",
           "restore_state"]
