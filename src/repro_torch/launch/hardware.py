"""The roofline terms of the card the port runs on: one NVIDIA H100 SXM5
(``NVIDIA H100 80GB HBM3``, power limit 700 W), from NVIDIA's data sheet,
dense rates without sparsity.  A card set below 700 W runs slower under
load than these rates."""

from __future__ import annotations

__all__ = ["CARD", "POWER_LIMIT_W", "PEAK_BF16_FLOPS", "HBM_BYTES_PER_S",
           "NVLINK_BYTES_PER_S", "HBM_BYTES"]

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
PEAK_BF16_FLOPS = 989e12        # dense bf16 / fp16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12       # HBM3
NVLINK_BYTES_PER_S = 450e9      # NVLink 4, one direction
HBM_BYTES = 80e9                # device memory
