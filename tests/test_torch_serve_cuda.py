"""The streaming checker service on the card against the same service
on the CPU.

On the card (`cuda`): `serve.CheckerService` fed the same deltas of a
few register and unordered-queue keys, a round of one delta a key at a
time and every key's verdict read after each round, then finalized:
every answer equal to the CPU service's but the route tag ("closure"),
with batched K2 (and batched K4 where the route's budget is cut)
launched by the service's worker; a restart on the WAL and an eviction
with its thaw give the CPU's answers too.

This file imports no JAX, so the card's run needs none.
"""

import pytest
import torch

from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.parallel import sparse_kernels as sk
from jepsen_tpu_torch.serve import CheckerService
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
            for s in (1, 2, 3)]
    else:
        hs = [histories.rand_queue_history(
            n_ops=100 + 10 * s, n_processes=8, n_values=4, crash_p=0.01,
            seed=10 + s) for s in range(3)]
    hs.append(histories.corrupt_history(hs[0], seed=0))
    return {f"k{i}": [dict(o) for o in h] for i, h in enumerate(hs)}


def _answers(svc, streams, deltas=3):
    """Each round submits one delta of every key, then reads every key's
    verdict: the worker takes a round's keys as one batch."""
    out = []
    for d in range(deltas):
        for k, h in streams.items():
            lo, hi = len(h) * d // deltas, len(h) * (d + 1) // deltas
            out.append(svc.submit(k, [Op(o) for o in h[lo:hi]],
                                  timeout=600))
        out += [svc.result(k, timeout=600) for k in streams]
    out += [svc.finalize(k, timeout=600) for k in streams]
    return out


def _same(want, got):
    def clean(x):
        return [{k: v for k, v in r.items() if k != "closure"}
                for r in jsonable(x)]
    assert clean(got) == clean(want)


@pytest.mark.cuda
@pytest.mark.parametrize("model,budget", [
    ("CASRegister", None), ("UnorderedQueue", None),
    ("UnorderedQueue", TILED_BUDGET)],
    ids=["register-K2", "uqueue-K2", "uqueue-K2-then-K4"])
def test_cuda_service_equals_the_cpu(tmp_path, model, budget):
    dev = _cuda()
    streams = _streams(model)
    runs = {}
    for d in (CPU, dev):
        cls = type("S", (_Budgeted,), {"budget": budget})
        svc = cls(getattr(models, model)(), wal_dir=str(tmp_path / d.type),
                  capacity=64, dedupe="hash", device=d)
        try:
            sk.reset_launches()
            runs[d.type] = _answers(svc, streams)
            assert svc.drain(timeout=600)
            n = dict(sk.launches)
        finally:
            svc.close()
    _same(runs["cpu"], runs["cuda"])
    assert n["frontier_closure_batch"] > 0, n
    if budget:
        assert n["tiled_insert_batch"] + n["tiled_insert"] > 0, n
    assert any(r.get("valid?") is False for r in runs["cuda"])


@pytest.mark.cuda
def test_cuda_service_restart_and_eviction_equal_the_cpu(tmp_path):
    dev = _cuda()
    streams = _streams("UnorderedQueue")
    runs = {}
    for d in (CPU, dev):
        wal = str(tmp_path / d.type)
        kw = dict(wal_dir=wal, capacity=64, dedupe="hash", device=d)
        svc = CheckerService(models.UnorderedQueue(), **kw)
        try:
            out = _answers(svc, {k: h[:len(h) // 2]
                                 for k, h in streams.items()}, deltas=1)[:8]
            assert svc.drain(timeout=600)
            out += [svc.freeze_key(k) for k in ("k0", "k1")]
        finally:
            svc.close()
        svc = CheckerService(models.UnorderedQueue(), **kw)
        try:
            out += [svc.result(k, timeout=600) for k in streams]
            out += [svc.submit(k, [Op(o) for o in h[len(h) // 2:]],
                               wait=True, timeout=600)
                    for k, h in streams.items()]
        finally:
            svc.close()
        runs[d.type] = out
    assert runs["cuda"][8:10] == [True, True]
    _same([r for r in runs["cpu"] if isinstance(r, dict)],
          [r for r in runs["cuda"] if isinstance(r, dict)])
