"""Synthetic datasets (numpy), identical to the reference's for a seed."""

from .synthetic import (Dataset, make_classification,
                        make_image_classification,
                        make_sequence_classification)

__all__ = ["Dataset", "make_classification", "make_image_classification",
           "make_sequence_classification"]
