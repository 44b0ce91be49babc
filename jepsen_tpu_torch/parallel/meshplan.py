"""The sharded engines' mesh, over `torch.distributed`.

A port of `jepsen_tpu.parallel.meshplan`: one place that decides how a
set of ranks becomes a sharded-engine topology. The reference drives
every device of a `jax.sharding.Mesh` from one process; here every rank
is a process of its own, and every rank of a plan calls the same entry
point with the same arguments.

  * The topology decision (`MeshPlan.from_mesh`): a 2-D `DeviceMesh`
    whose two dims are both > 1, under the owner-routed exchange, is
    hierarchical — dims ("slice", "chip"), the exchange in two stages,
    one over each axis's process groups; any other mesh is flattened
    onto one axis of its ranks in row-major order.
  * The elastic re-shard ladder (`slice_plan`, `promoted`, `ladder`):
    the rungs a search recruits, wider 1-D within the first slice, then
    whole extra slices through the 2-D exchange.
  * The multi-host seam: `host_slices` (the ranks of each node),
    `local_devices`, `n_processes`, and `key_home` / `key_partition`,
    which every process computes alike from the same key list.
  * `distributed_init`, behind the strict JEPSEN_TPU_TORCH_DIST flags:
    `torch.distributed.init_process_group` over a TCP rendezvous.

A plan's process groups come from `torch.distributed.new_group`, which
every rank of the world must call, in the same order, even for a group
it is not in. So a plan builds its groups when it is made, and
`ladder` makes every rung's up front; nothing builds a group inside a
collective section. A plan's device index of a rank is its row-major
position in the plan's ranks, which must ascend (as
`init_device_mesh`'s do), so that it is also the rank's index in the
plan's process groups.

`local_mesh` is the one-rank mesh of this process — the counterpart of
the reference's `Mesh(np.array(jax.devices()), ("frontier",))` on one
device. A mesh over several ranks is the caller's, from
`torch.distributed.device_mesh.init_device_mesh` in every rank.
"""

from __future__ import annotations

import logging
import socket
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from jepsen_tpu_torch import envflags
from jepsen_tpu_torch.parallel.bitdense import resolve_device

_log = logging.getLogger(__name__)

AXIS = "frontier"
AX_SLICE, AX_CHIP = "slice", "chip"

# process groups by their (ascending) global ranks, for the world they
# were made in: every rank makes the same plans in the same order, so
# every rank's cache agrees
_GROUPS: dict = {}
_GROUPS_WORLD: list = [None]


def _groups() -> dict:
    """The group cache of the current world (emptied when the default
    group was destroyed and made anew)."""
    if _GROUPS_WORLD[0] is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS_WORLD[0] = dist.group.WORLD
    return _GROUPS


def _group(ranks):
    """The process group of `ranks`, made once (every rank of the world
    makes it, member or not)."""
    key = tuple(int(r) for r in ranks)
    if list(key) != sorted(key):
        raise ValueError(f"a plan's ranks must ascend in row-major order "
                         f"(as init_device_mesh lays them out), got "
                         f"{list(key)}")
    cache = _groups()
    if key not in cache:
        if key == tuple(range(dist.get_world_size())):
            cache[key] = dist.group.WORLD
        else:
            cache[key] = dist.new_group(list(key))
    return cache[key]


class MeshPlan:
    """A set of ranks plus the topology the sharded engine runs them
    with. `ranks` is kept 2-D exactly when the plan is hierarchical
    (axis 0 = slices, axis 1 = chips); every other shape is flattened.
    `member` says whether this process is one of the ranks; `my_idx`
    is its device index (-1 outside), `group` the process group of all
    the ranks, and on a hierarchical plan `chip_group` / `slice_group`
    this rank's row and column, `slice_idx` / `chip_idx` its place."""

    def __init__(self, ranks, device_type: str, hierarchical: bool = False):
        ranks = np.asarray(ranks, dtype=np.int64)
        if hierarchical:
            if ranks.ndim != 2 or ranks.shape[0] < 2 or ranks.shape[1] < 2:
                raise ValueError(
                    "hierarchical MeshPlan needs a 2-D rank array with "
                    "both dims > 1")
        else:
            ranks = ranks.reshape(-1)
        self.ranks = ranks
        self.hierarchical = bool(hierarchical)
        self.device_type = device_type
        flat = ranks.reshape(-1)
        me = dist.get_rank()
        pos = np.nonzero(flat == me)[0]
        self.member = bool(pos.size)
        self.my_idx = int(pos[0]) if self.member else -1
        self.group = _group(flat)
        self.chip_group = self.slice_group = None
        self.slice_idx, self.chip_idx = 0, self.my_idx
        if self.hierarchical:
            # every row's and every column's group, in the same order on
            # every rank
            rows = [_group(r) for r in ranks]
            cols = [_group(c) for c in ranks.T]
            if self.member:
                self.slice_idx, self.chip_idx = divmod(self.my_idx,
                                                       self.n_chip)
                self.chip_group = rows[self.slice_idx]
                self.slice_group = cols[self.chip_idx]
        if device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(device_type)

    # -- construction -------------------------------------------------

    @classmethod
    def from_mesh(cls, mesh: DeviceMesh, exchange: str = "route"
                  ) -> "MeshPlan":
        """The reference's topology decision: a 2-D mesh with both dims
        > 1 under the owner-routed exchange is hierarchical; anything
        else — and always the all-gather A/B exchange — flattens."""
        if exchange not in ("route", "gather"):
            raise ValueError(f"unknown exchange {exchange!r}")
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"a mesh is a torch.distributed DeviceMesh, "
                            f"not {type(mesh).__name__}")
        ranks = mesh.mesh.cpu().numpy()
        if ranks.ndim == 1:
            # a 1-D mesh's group already exists: no new one to agree on
            _groups().setdefault(tuple(int(r) for r in ranks),
                                 mesh.get_group())
        hier = (exchange == "route" and ranks.ndim == 2
                and ranks.shape[0] > 1 and ranks.shape[1] > 1)
        return cls(ranks if hier else ranks.reshape(-1), mesh.device_type,
                   hier)

    @classmethod
    def flat(cls, mesh: DeviceMesh) -> "MeshPlan":
        """Every rank of `mesh` on one axis, row-major: the key axis of a
        mesh-sharded batch."""
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"a mesh is a torch.distributed DeviceMesh, "
                            f"not {type(mesh).__name__}")
        return cls(mesh.mesh.cpu().numpy().reshape(-1), mesh.device_type)

    @classmethod
    def auto(cls, device=None) -> "MeshPlan":
        """The process-global plan: after the gated handshake
        (`distributed_init`) every rank of the world on one flat axis,
        else this process alone (`local_mesh`). `device` None means the
        card."""
        if distributed_init(device):
            dev = resolve_device(device)
            return cls(np.arange(dist.get_world_size()), dev.type)
        return cls.from_mesh(local_mesh(device))

    # -- shape --------------------------------------------------------

    @property
    def n_dev(self) -> int:
        return int(self.ranks.size)

    @property
    def n_slice(self) -> int:
        return int(self.ranks.shape[0]) if self.hierarchical else 1

    @property
    def n_chip(self) -> int:
        return int(self.ranks.shape[1] if self.hierarchical
                   else self.ranks.size)

    def __repr__(self) -> str:
        shape = (f"{self.n_slice}x{self.n_chip}" if self.hierarchical
                 else str(self.n_dev))
        return (f"MeshPlan({shape} {self.device_type}"
                f"{', hierarchical' if self.hierarchical else ''})")

    # -- the key axis -------------------------------------------------

    def keys_of(self, K: int, ranks=None) -> list:
        """This rank's keys of a K-key batch: a contiguous block of
        ceil(K / n_dev) keys, so that a ragged K leaves the last ranks
        shorter blocks (or none), or, given `ranks`, the keys whose entry
        there is this rank's index."""
        if ranks is not None:
            return [j for j, d in enumerate(ranks) if d == self.my_idx]
        Q = -(-K // self.n_dev)
        return list(range(min(K, self.my_idx * Q),
                          min(K, (self.my_idx + 1) * Q)))

    def gather_keys(self, K: int, idx: list, results: list) -> list:
        """Every rank's results of its keys (`idx`, as `keys_of` gave
        them) back into the batch's order: one all-gather of Python
        objects over the plan's group."""
        every = [None] * self.n_dev
        dist.all_gather_object(every, (list(idx), list(results)),
                               group=self.group)
        out = [None] * K
        for ks, rs in every:
            for j, r in zip(ks, rs):
                out[j] = r
        return out

    # -- multi-host seam ----------------------------------------------

    def host_slices(self) -> dict:
        """{host index: [rank, ...]}: the plan's ranks by the node they
        run on, hosts numbered in the order of their first rank. A
        collective over the plan's group on the first call (every rank
        of the plan calls it), cached after."""
        if getattr(self, "_hosts", None) is None:
            names = [None] * self.n_dev
            dist.all_gather_object(names, socket.gethostname(),
                                   group=self.group)
            order: dict = {}
            out: dict = {}
            for r, name in zip(self.ranks.reshape(-1), names):
                h = order.setdefault(name, len(order))
                out.setdefault(h, []).append(int(r))
            self._hosts = out
        return self._hosts

    def local_devices(self) -> list:
        """The ranks of this process's node (:meth:`host_slices`)."""
        me = dist.get_rank()
        for ranks in self.host_slices().values():
            if me in ranks:
                return list(ranks)
        return []

    @property
    def n_processes(self) -> int:
        """The nodes the plan spans, the reference's processes (one per
        host)."""
        return len(self.host_slices())

    @staticmethod
    def key_home(key, n_parts: int) -> int:
        """Deterministic key -> partition: crc32 of the key's repr,
        stable across processes and runs, and the reference's."""
        return zlib.crc32(repr(key).encode()) % max(1, int(n_parts))

    def key_partition(self, keys, n_parts: Optional[int] = None) -> dict:
        """{part: [key, ...]} over `n_parts` (None: the nodes): every
        process computes the same map from the same key list, so no
        coordinator round is needed to agree who checks what."""
        n = self.n_processes if n_parts is None else int(n_parts)
        out = {p: [] for p in range(max(1, n))}
        for k in keys:
            out[self.key_home(k, max(1, n))].append(k)
        return out

    # -- the elastic re-shard ladder ----------------------------------

    def slice_plan(self, n: int) -> "MeshPlan":
        """A flat plan over the first `n` ranks (row-major): the 1-D
        rungs of the ladder."""
        n = max(1, min(int(n), self.n_dev))
        return MeshPlan(self.ranks.reshape(-1)[:n], self.device_type)

    def promoted(self, n_slice: int) -> "MeshPlan":
        """A hierarchical plan over the first `n_slice` slices: the 2-D
        rungs of the ladder."""
        if not self.hierarchical:
            raise ValueError("promoted() needs a hierarchical plan")
        n_slice = max(2, min(int(n_slice), self.n_slice))
        return MeshPlan(self.ranks[:n_slice, :], self.device_type, True)

    def ladder(self, start_devices: int = 1) -> list:
        """The re-shard rungs, narrowest first: widen 1-D within the
        first slice by doubling, then — on a hierarchical plan — recruit
        whole extra slices through the 2-D exchange. The last rung is
        always the full plan. Every rung's groups are made here, on
        every rank."""
        rungs = []
        n = max(1, min(int(start_devices), self.n_chip))
        while n < self.n_chip:
            rungs.append(self.slice_plan(n))
            n *= 2
        rungs.append(self.slice_plan(self.n_chip))
        if self.hierarchical:
            s = 2
            while s < self.n_slice:
                rungs.append(self.promoted(s))
                s *= 2
            rungs.append(self)
        return rungs


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


# ------------------------------------------------------- the handshake

_initialized = False


def distributed_enabled() -> bool:
    return bool(envflags.env_bool("JEPSEN_TPU_TORCH_DIST", default=False))


def distributed_init(device=None) -> bool:
    """The gated multi-process handshake: a no-op (False) unless
    JEPSEN_TPU_TORCH_DIST=1. With the flag set, its three companions are
    required and strictly checked — a half-configured run fails here,
    not in a hung collective: JEPSEN_TPU_TORCH_DIST_COORD (host:port of
    rank 0's rendezvous), _NPROC (>= 1) and _PROC (in [0, NPROC)). Then
    `init_process_group(init_method="tcp://COORD")` with NCCL on the
    card (this rank's card: PROC modulo the cards) or gloo on the CPU.
    Idempotent: a second call in the process is a no-op (True)."""
    global _initialized
    if not distributed_enabled():
        return False
    if _initialized:
        return True
    coord = envflags.env_raw("JEPSEN_TPU_TORCH_DIST_COORD")
    nproc = envflags.env_int("JEPSEN_TPU_TORCH_DIST_NPROC", min_value=1,
                             what="process count")
    proc = envflags.env_int("JEPSEN_TPU_TORCH_DIST_PROC", min_value=0,
                            what="process id")
    missing = [n for n, v in (("JEPSEN_TPU_TORCH_DIST_COORD", coord),
                              ("JEPSEN_TPU_TORCH_DIST_NPROC", nproc),
                              ("JEPSEN_TPU_TORCH_DIST_PROC", proc))
               if v is None]
    if missing:
        raise envflags.EnvFlagError(
            f"JEPSEN_TPU_TORCH_DIST=1 needs {', '.join(missing)} set — a "
            f"half-configured distributed plan must not fall back to a "
            f"silent single-process run")
    host, _, port = coord.strip().rpartition(":")
    if not host or not port.isdigit():
        raise envflags.EnvFlagError(
            f"JEPSEN_TPU_TORCH_DIST_COORD={coord!r}: must be host:port")
    if proc >= nproc:
        raise envflags.EnvFlagError(
            f"JEPSEN_TPU_TORCH_DIST_PROC={proc} out of range for "
            f"JEPSEN_TPU_TORCH_DIST_NPROC={nproc}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(proc % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://{coord.strip()}",
                                world_size=nproc, rank=proc)
    _initialized = True
    _log.info("torch.distributed initialized: process %d/%d via %s", proc,
              nproc, coord)
    return True
