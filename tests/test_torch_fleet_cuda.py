"""The replica ring's rehome and migration on the card against the same
on the CPU.

On the card (`cuda`): two `serve.CheckerService` replicas behind a
`serve.ring.Router`, a few register and unordered-queue keys fed in
three deltas; after delta 2 one replica is closed without drain (the
in-process stand-in for a kill), the survivor adopts its keys through
`Router.rehome`, one surviving key moves to another replica through
`Router.migrate_key` (freeze, transfer, thaw), and the keys are
finalized. Every answer, plan and pin equals the same run on the CPU but
the route tag ("closure"), and the adopted keys' replays launched K2
on the card (and K4 where the route's budget is cut).

This file imports no JAX, so the card's run needs none.
"""

import pytest
import torch

from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.parallel import sparse_kernels as sk
from jepsen_tpu_torch.serve import CheckerService
from jepsen_tpu_torch.serve.ring import HashRing, Router
from jepsen_tpu_torch.serve.stdio import jsonable

CPU = torch.device("cpu")
# a budget that sends the queue keys' hash closure past K2's gate from
# capacity 256 on
TILED_BUDGET = 16384


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


class _Budgeted(CheckerService):
    """The service with its sessions' closure route cut to `budget`
    bytes of shared memory (the route's test seam)."""

    budget = None

    def _new_session(self, key, device=None):
        s = super()._new_session(key, device)
        s.smem_budget = self.budget
        return s


def _streams(model):
    if model == "CASRegister":
        hs = [histories.rand_register_history(
            n_ops=60, n_processes=6, n_values=4, crash_p=0.02, seed=s)
            for s in (1, 2, 3, 4, 5)]
    else:
        hs = [histories.rand_queue_history(
            n_ops=100 + 10 * s, n_processes=8, n_values=4, crash_p=0.01,
            seed=10 + s) for s in range(5)]
    hs.append(histories.corrupt_history(hs[0], seed=0))
    return {f"k{i}": [dict(o) for o in h] for i, h in enumerate(hs)}


def _delta(h, d, deltas=3):
    return [Op(o) for o in h[len(h) * d // deltas:
                             len(h) * (d + 1) // deltas]]


def _fleet_run(tmp_path, model, budget, dev):
    streams = _streams(model)
    names = ("A", "B")
    dirs = {n: str(tmp_path / dev.type / n) for n in names}
    cls = type("S", (_Budgeted,), {"budget": budget})
    svcs = {n: cls(getattr(models, model)(), wal_dir=dirs[n], capacity=64,
                   dedupe="hash", device=dev) for n in names}
    router = Router(svcs, dirs)
    dead = router.owner("k0")
    survivor = next(n for n in names if n != dead)
    out = {"answers": []}
    try:
        for d in (0, 1):
            out["answers"] += [router.submit(k, _delta(h, d), timeout=600)
                               for k, h in streams.items()]
            out["answers"] += [router.result(k, timeout=600)
                               for k in streams]
        svcs[dead].close(drain=False)
        sk.reset_launches()
        out["plan"] = router.rehome(dead)
        out["rehomed"] = [router.result(k, timeout=600) for k in streams]
        assert router.services[survivor].drain(timeout=600)
        n = dict(sk.launches)
        # a third replica joins and takes one key gracefully
        dirs["C"] = str(tmp_path / dev.type / "C")
        router.services["C"] = cls(getattr(models, model)(),
                                   wal_dir=dirs["C"], capacity=64,
                                   dedupe="hash", device=dev)
        router.wal_dirs["C"] = dirs["C"]
        out["migrate"] = router.migrate_key("k1", "C")
        out["last"] = [router.submit(k, _delta(h, 2), wait=True,
                                     timeout=600)
                       for k, h in streams.items()]
        out["finals"] = [router.finalize(k, timeout=600) for k in streams]
        out["pins"] = dict(router.pins)
    finally:
        for s in router.services.values():
            s.close()
    return out, n


def _same(want, got):
    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items() if k != "closure"}
        if isinstance(x, list):
            return [clean(v) for v in x]
        return x
    assert clean(jsonable(got)) == clean(jsonable(want))


@pytest.mark.cuda
@pytest.mark.parametrize("model,budget", [
    ("CASRegister", None), ("UnorderedQueue", None),
    ("UnorderedQueue", TILED_BUDGET)],
    ids=["register-K2", "uqueue-K2", "uqueue-K2-then-K4"])
def test_cuda_router_rehome_and_migrate_equal_the_cpu(tmp_path, model,
                                                      budget):
    dev = _cuda()
    cpu, _ = _fleet_run(tmp_path, model, budget, CPU)
    cuda, n = _fleet_run(tmp_path, model, budget, dev)
    _same(cpu, cuda)
    assert n["frontier_closure_batch"] + n["frontier_closure"] > 0, n
    if budget:
        assert n["tiled_insert_batch"] + n["tiled_insert"] > 0, n
    assert any(r.get("valid?") is False for r in cuda["finals"])


def test_router_run_shape_on_the_cpu(tmp_path):
    """The run above on the CPU alone (no card): the dead replica's keys
    re-home and pin to the survivor, the migrated key pins to the
    joiner, every key finalizes with all three deltas."""
    out, _n = _fleet_run(tmp_path, "CASRegister", None, CPU)
    dead = HashRing(["A", "B"]).owner("k0")
    assert list(out["plan"]) == [n for n in ("A", "B") if n != dead]
    assert "k0" in next(iter(out["plan"].values()))
    assert out["migrate"]["to"] == "C" and out["pins"]["k1"] == "C"
    assert dead not in out["pins"].values()
    assert all(r["seq"] == 3 for r in out["finals"])
    assert any(r["valid?"] is False for r in out["finals"])
