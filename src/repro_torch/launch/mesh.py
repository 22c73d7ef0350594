"""Meshes: the axes of a run and the process groups of its ranks.

Counterpart of ``repro/launch/mesh.py``.  ``data`` (x ``pod``) carries the
federated clients; ``model`` is tensor parallelism inside a client.  A
mesh of ``n_clients`` clients and ``model = M`` runs on ``n_clients·M``
``torch.distributed`` ranks: rank ``d·M + m`` is model shard ``m`` of
client ``d``, the reference's row-major device order.  The ranks that share
``m`` form a client group (the codec's ``tree_reduce`` runs over it); the
ranks of one client form its model group (tensor parallelism's collectives
and the split k-selection run over it).  With ``model = 1`` the client
group is the default group and there is no model group.  Constructing a
mesh touches no device and no process group: the groups are made when a
step is built (every rank makes every group, in the same order), so the
production meshes are descriptors the dry run reads with no devices.
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

    @property
    def model(self) -> int:
        return self.shape.get("model", 1)

    def _groups(self):
        """``(client group, model group)`` of this rank: None where the
        group would hold one rank.  Made once a default process group, every
        client group then every model group, in the same order on every
        rank."""
        if self.n_clients * self.model == 1:
            return None, None
        import torch.distributed as dist
        world = self.n_clients * self.model
        if not dist.is_initialized():
            raise RuntimeError(
                f"a mesh of {self.n_clients} clients x model {self.model} "
                f"needs one torch.distributed rank a shard: call "
                f"init_process_group(world_size={world}) first")
        if dist.get_world_size() != world:
            raise RuntimeError(
                f"the mesh has {self.n_clients} clients x model "
                f"{self.model} = {world} shards but the process group has "
                f"{dist.get_world_size()} ranks")
        key = (self.axis_names, self.sizes)
        cached = _GROUPS.get(key)
        if cached is not None and cached[0] is dist.group.WORLD:
            return cached[1]
        m_size, n = self.model, self.n_clients
        if m_size == 1:
            groups = dist.group.WORLD, None
        elif n == 1:
            groups = None, dist.group.WORLD
        else:
            clients = [dist.new_group([d * m_size + m for d in range(n)])
                       for m in range(m_size)]
            models = [dist.new_group([d * m_size + m for m in range(m_size)])
                      for d in range(n)]
            d, m = divmod(dist.get_rank(), m_size)
            groups = clients[m], models[d]
        _GROUPS[key] = (dist.group.WORLD, groups)
        return groups

    def client_group(self):
        """The process group of the ranks that share this rank's model
        shard, one a client: None for one client; with ``model = 1`` the
        default group, which must hold exactly one rank a client."""
        return self._groups()[0]

    def model_group(self):
        """The process group of this client's model shards: None for
        ``model = 1``."""
        return self._groups()[1]

    def client_rank(self) -> int:
        """This process's client index ``d`` (0 for one rank)."""
        return self._rank() // self.model

    def model_rank(self) -> int:
        """This process's model shard ``m`` (0 for ``model = 1``)."""
        return self._rank() % self.model

    def _rank(self) -> int:
        if self.n_clients * self.model == 1:
            return 0
        import torch.distributed as dist
        return dist.get_rank()


# (axis names, sizes) -> (the default group they were made under, groups)
_GROUPS: dict = {}


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
