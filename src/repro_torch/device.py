"""Where the port runs: CUDA unless the caller names the CPU.

Every entry point of the package (trainer, wire ``"kernel"`` packer) takes a
``device`` argument and resolves it here.  ``None`` means the card; with no
card that raises instead of carrying on silently on the CPU.  The tests pass
``device="cpu"`` explicitly, and on a CPU tensor each kernel wrapper runs its
plain PyTorch version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when no card is visible); anything else
    is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
