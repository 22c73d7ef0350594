"""Partition rules: the batch over the client ranks.

Counterpart of ``repro/sharding/rules.py`` for ``batch_spec`` only: the
global batch splits over the client axes (``pod``, ``data``), rank r taking
rows ``[r·b/n, (r+1)·b/n)`` as ``P(client_axes)`` places them.  The
parameter, cache and tree shardings of tensor parallelism wait with it
(ROADMAP Queue 1).
"""

from __future__ import annotations

import math

__all__ = ["batch_spec", "batch_rows"]


def batch_spec(mesh, global_batch: int) -> tuple:
    """The axes the batch dim splits over: every client axis, falling back
    to ``("data",)`` and then to none (every rank the whole batch) when the
    batch is too small to split."""
    used = mesh.client_axes
    if global_batch % math.prod(mesh.shape[a] for a in used) == 0:
        return used
    if "data" in mesh.axis_names and global_batch % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def batch_rows(mesh, global_batch: int, rank: int) -> slice:
    """The rows of the global batch that client ``rank`` takes."""
    spec = batch_spec(mesh, global_batch)
    if not spec:
        return slice(0, global_batch)
    # the client index on the split axes: pod-major, as the mesh lays out
    # its ranks
    sizes = [mesh.shape[a] for a in mesh.client_axes]
    idx, coords = rank, []
    for size in reversed(sizes):
        coords.append(idx % size)
        idx //= size
    coords = dict(zip(reversed(mesh.client_axes), coords))
    shard, n = 0, 1
    for a in spec:
        shard = shard * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    per = global_batch // n
    return slice(shard * per, (shard + 1) * per)
