"""The paper's models, functional over dicts of tensors."""

from .paper_models import MODEL_ZOO, params_from_jax

__all__ = ["MODEL_ZOO", "params_from_jax"]
