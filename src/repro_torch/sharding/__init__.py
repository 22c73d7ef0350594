"""How a step's inputs split over the client ranks."""

from .rules import batch_rows, batch_spec

__all__ = ["batch_spec", "batch_rows"]
