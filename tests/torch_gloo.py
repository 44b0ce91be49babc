"""Spawned gloo ranks for the port's multi-rank CPU tests.

`Group(D, target, args)` starts D processes (the "spawn" context: each
re-imports the test module, so that module keeps its JAX imports inside
the functions that run the reference). Rank r joins a gloo process group
of D ranks through a FileStore, runs `target(rank, *args)` — a
module-level function of the test module — and sends its return value
back; `results()` waits for every rank and returns their values in rank
order, re-raising a rank's traceback. One thread of torch per rank.
Meshes are the target's to build (`mesh(shape)` below), every rank
building the same ones in the same order.

`shared(name, fn)` runs a test file's expensive setup (its groups and
the reference) once per pytest run: under pytest-xdist every worker
that draws a test of the file would otherwise run it again, so the
first one computes it under a file lock and the others read its pickle
(keyed by the run's PYTEST_XDIST_TESTRUNUID, in the temporary
directory). Without xdist it just calls `fn`.
"""

import fcntl
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import traceback

GROUP_TIMEOUT_S = 300


def mesh(shape, names=None):
    """A CPU DeviceMesh of `shape` over the world's ranks, row-major
    (1-D: ("frontier",); 2-D: ("slice", "chip"))."""
    from torch.distributed.device_mesh import init_device_mesh
    if names is None:
        names = ("frontier",) if len(shape) == 1 else ("slice", "chip")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def _rank_main(rank: int, D: int, store: str, target, args, out) -> None:
    try:
        import torch
        import torch.distributed as dist
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, D),
                                rank=rank, world_size=D)
        res = target(rank, *args)
        dist.destroy_process_group()
        out.put((rank, res, None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))


class Group:
    """D spawned gloo ranks running `target`; `results()` waits."""

    def __init__(self, D: int, target, args=()):
        ctx = mp.get_context("spawn")
        self.dir = tempfile.TemporaryDirectory()
        self.out = ctx.Queue()
        store = os.path.join(self.dir.name, "store")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, D, store, target, tuple(args),
                                        self.out),
                                  daemon=True) for r in range(D)]
        for p in self.procs:
            p.start()

    def results(self) -> list:
        try:
            got = [self.out.get(timeout=GROUP_TIMEOUT_S)
                   for _ in self.procs]
        except queue.Empty:
            raise AssertionError("a rank of the group never answered")
        finally:
            for p in self.procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.terminate()
            self.dir.cleanup()
        errors = [tb for _, _, tb in got if tb]
        assert not errors, errors[0]
        return [res for _, res, _ in sorted(got, key=lambda g: g[0])]


def shared(name: str, fn):
    """fn(), computed once per pytest-xdist run and shared by its
    workers through a pickle under a file lock (see the module's
    docstring)."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return fn()
    base = os.path.join(tempfile.gettempdir(), f"jt-shared-{run}-{name}")
    with open(base + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(base + ".pkl"):
                with open(base + ".pkl", "rb") as f:
                    return pickle.load(f)
            out = fn()
            with open(base + ".tmp", "wb") as f:
                pickle.dump(out, f)
            os.replace(base + ".tmp", base + ".pkl")
            return out
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
