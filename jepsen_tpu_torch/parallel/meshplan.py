"""The frontier-sharded engine's mesh, over `torch.distributed`.

A port of the flat part of `jepsen_tpu.parallel.meshplan`: the sharded
engine runs on a 1-D `DeviceMesh` whose one dimension is the frontier
axis. Each rank of the mesh owns the configurations whose owner hash,
modulo the ranks, is its index; the exchange and the all-reduces ride
the mesh's process group (NCCL across cards, gloo on the CPU).

`local_mesh` is the one-rank mesh of this process — the counterpart of
the reference's `Mesh(np.array(jax.devices()), ("frontier",))` on one
device. A mesh over several ranks is the caller's, from
`torch.distributed.device_mesh.init_device_mesh` in every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from jepsen_tpu_torch.parallel.bitdense import resolve_device

AXIS = "frontier"


class MeshPlan:
    """A 1-D mesh and what the sharded engine reads of it: the number
    of ranks, this rank's index on the frontier axis, the process group
    and the device this rank computes on."""

    def __init__(self, mesh: DeviceMesh):
        if mesh.ndim != 1:
            raise NotImplementedError("hierarchical exchange: a later slice")
        self.mesh = mesh
        self.group = mesh.get_group()
        self.n_dev = mesh.size()
        self.my_idx = mesh.get_local_rank()
        if mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(mesh.device_type)

    @classmethod
    def from_mesh(cls, mesh: DeviceMesh, exchange: str = "route"
                  ) -> "MeshPlan":
        """The reference's topology decision, flat part: a 1-D mesh runs
        either exchange; a 2-D mesh (the reference's hierarchical
        multi-slice exchange) is not ported yet."""
        if exchange not in ("route", "gather"):
            raise ValueError(f"unknown exchange {exchange!r}")
        return cls(mesh)


def local_mesh(device=None) -> DeviceMesh:
    """The one-rank mesh of this process on `device`: None means the
    card (NCCL; RuntimeError without one), "cpu" the CPU (gloo). The
    process group is made here when there is none, from an in-process
    store, so nothing opens a socket; a process that already belongs to
    a group of one rank reuses it, if its backend is the wanted one."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif dist.get_world_size() != 1:
        raise ValueError(
            f"local_mesh: this process is one of {dist.get_world_size()} "
            f"ranks; build their mesh with init_device_mesh in every rank")
    elif dist.get_backend() != backend:
        raise ValueError(
            f"local_mesh: this process's group runs {dist.get_backend()}, "
            f"not the {backend} that {dev.type} needs")
    return DeviceMesh.from_group(dist.group.WORLD, dev.type,
                                 mesh_dim_names=(AXIS,))
