"""The four assigned input shapes and their ShapeDtypeStruct input specs.

Decode shapes (decode_32k, long_500k) lower ``serve_step`` -- one new token
with a KV/state cache of ``seq_len`` -- not ``train_step``.  long_500k
requires sub-quadratic attention: SSM/hybrid run natively; full-attention
archs run their sliding-window variant (see configs.registry / DESIGN.md).
"""

from __future__ import annotations

import dataclasses

__all__ = ["InputShape", "INPUT_SHAPES"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
