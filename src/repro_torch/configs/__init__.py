"""Selectable architecture configs (``--arch <id>``) and input shapes.

Counterpart of ``repro/configs``: the ten arch modules are copied as data.
"""

from .registry import (ARCH_IDS, INPUT_SHAPES, TensorSpec, get_config,
                       get_smoke_config, input_specs, stand_in_inputs)
from .shapes import InputShape

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "get_config", "get_smoke_config",
           "input_specs", "stand_in_inputs", "InputShape", "TensorSpec"]
