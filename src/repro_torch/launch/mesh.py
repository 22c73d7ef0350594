"""Meshes: the axes of a run and the process group of its client ranks.

Counterpart of ``repro/launch/mesh.py``.  ``data`` (x ``pod``) carries the
federated clients, one ``torch.distributed`` rank each; ``model`` is tensor
parallelism inside a client: the sharding rules and the dry run size it
(:mod:`repro_torch.sharding.rules`, :mod:`repro_torch.launch.dryrun`),
and the steps do not run it yet
(:func:`repro_torch.launch.train.make_train_step` raises for ``model >
1``).  Constructing a mesh touches no device and no process group: the
client ranks' group is looked up when a step is built, so the production
meshes are descriptors the dry run reads with no devices.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["Mesh", "make_production_mesh", "make_debug_mesh"]

CLIENT_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and sizes; ``shape`` maps each name to its size."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def client_axes(self) -> tuple:
        return tuple(a for a in CLIENT_AXES if a in self.axis_names)

    @property
    def n_clients(self) -> int:
        return math.prod(self.shape[a] for a in self.client_axes)

    def client_group(self):
        """The process group of the client ranks: None for one client;
        otherwise the default group, which must hold exactly one rank a
        client (``torch.distributed.init_process_group`` with world size
        ``n_clients``)."""
        if self.n_clients == 1:
            return None
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {self.n_clients} clients needs one "
                "torch.distributed rank a client: call "
                "init_process_group(world_size=n_clients) first")
        if dist.get_world_size() != self.n_clients:
            raise RuntimeError(
                f"the mesh has {self.n_clients} clients but the process "
                f"group has {dist.get_world_size()} ranks")
        return dist.group.WORLD

    def client_rank(self) -> int:
        """This process's client index (0 for one client)."""
        if self.n_clients == 1:
            return 0
        import torch.distributed as dist
        return dist.get_rank()


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0) -> Mesh:
    """A small mesh: ``data`` (x ``pod``) client ranks, ``model`` ranks of
    tensor parallelism inside each."""
    if pod:
        return Mesh(("pod", "data", "model"), (pod, data, model))
    return Mesh(("data", "model"), (data, model))
