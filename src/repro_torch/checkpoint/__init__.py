"""Crash-consistent trainer state: ``save_state`` / ``restore_state``.

The template-free tagged composite of the reference's
``checkpoint/msgpack_ckpt.py`` (event clock, in-flight payloads, RNG
states, codec states, ledgers, logs), with a tag for ``torch.Tensor``,
serialized by the port's own encoder for the msgpack subset it uses and
compressed with stdlib ``zlib``.  The pytree ``save_checkpoint`` /
``restore_checkpoint`` pair is still to port.
"""

from .msgpack_ckpt import restore_state, save_state

__all__ = ["save_state", "restore_state"]
