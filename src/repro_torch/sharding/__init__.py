"""Partition rules: how parameters, caches and a step's inputs split over
a mesh's axes."""

from .rules import (CACHE_SHARD_MODE, Sharding, StandIn, batch_entry,
                    batch_rows, batch_spec, cache_specs, fit_spec, map_tree,
                    param_shardings, param_specs, tree_shardings)

__all__ = ["param_specs", "param_shardings", "cache_specs", "batch_spec",
           "tree_shardings", "fit_spec", "batch_entry", "batch_rows",
           "Sharding", "StandIn", "map_tree", "CACHE_SHARD_MODE"]
