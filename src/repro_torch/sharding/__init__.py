"""Partition rules: how parameters, caches and a step's inputs split over
a mesh's axes; tensor parallelism's split products and collectives."""

from .rules import (CACHE_SHARD_MODE, Sharding, StandIn, batch_entry,
                    batch_rows, batch_spec, cache_specs, fit_spec, map_tree,
                    model_dim, param_shardings, param_specs,
                    replicated_leaves, shard_leaf, shard_tree,
                    tree_shardings, unshard_leaf)
from .tensor_parallel import TensorParallel

__all__ = ["param_specs", "param_shardings", "cache_specs", "batch_spec",
           "tree_shardings", "fit_spec", "batch_entry", "batch_rows",
           "Sharding", "StandIn", "map_tree", "CACHE_SHARD_MODE",
           "model_dim", "shard_leaf", "unshard_leaf", "shard_tree",
           "replicated_leaves", "TensorParallel"]
