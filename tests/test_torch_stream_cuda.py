"""The resumable check, the streaming sessions and the pipelined batch on
the card against the same calls on the CPU.

On the card (`cuda`): `engine.check_encoded_resumable` (K2, and K4 past
K2's gate with the route's budget cut) from every checkpoint equal,
array for array, to the CPU's; a `HistorySession` fed deltas and
`extend.advance_sessions` over several keys (batched K2 and batched K4
from resumed carries, their launches counted) equal to the CPU's; and
`pipeline.check_batch_pipelined` over dense and sparse buckets (K1's
persistent batched scan issued a chunk at a time) equal to the CPU's
and to the serial `check_batch` on the card. On the CPU: the cases take
the routes their names say.

This file imports no JAX, so the card's run needs none.
"""

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import closure_kernels as ck
from jepsen_tpu_torch.parallel import encode, engine, extend, pipeline
from jepsen_tpu_torch.parallel import sparse
from jepsen_tpu_torch.parallel import sparse_kernels as sk

CPU = torch.device("cpu")
FIELDS = ("valid?", "fail-event", "op", "max-frontier", "capacity",
          "configs-stepped", "explored", "dedupe", "config-pack", "stream",
          "stats")
# a budget that sends the queue case's hash closure past K2's gate from
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


def _queue(seed=1, n_ops=120, corrupt=False):
    h = histories.rand_queue_history(n_ops=n_ops, n_processes=8,
                                     n_values=4, crash_p=0.01, seed=seed)
    return histories.corrupt_history(h, seed=0) if corrupt else h


def _ops(h):
    return [dict(o) for o in h]


def _same(a, b):
    assert {k: a.get(k) for k in FIELDS} == {k: b.get(k) for k in FIELDS}


def test_cases_take_the_routes_they_name():
    """The queue case climbs from capacity 64 to 512, fused (K2) all the
    way, or past K2's gate (K4) from 256 under the cut budget."""
    e = encode.encode(models.UnorderedQueue(), _queue())
    C = e.slot_f.shape[1]
    r = sparse.check_encoded(e, capacity=64, device=CPU, dedupe="hash")
    assert r["capacity"] == 512
    assert [sparse._route(N, C, "hash", CPU) for N in (64, 512)] == \
        ["fused", "fused"]
    assert [sparse._route(N, C, "hash", CPU, TILED_BUDGET)
            for N in (64, 128, 256, 512)] == \
        ["fused", "fused", "tiled", "tiled"]


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, TILED_BUDGET],
                         ids=["K2", "K2-then-K4"])
@pytest.mark.parametrize("corrupt", [False, True],
                         ids=["clean", "corrupt"])
def test_cuda_resumable_equals_the_cpu(budget, corrupt):
    dev = _cuda()
    e = encode.encode(models.UnorderedQueue(), _queue(corrupt=corrupt))
    kw = dict(capacity=64, checkpoint_every=16, dedupe="hash",
              search_stats=True, smem_budget=budget)
    cc, gc = [], []
    want = engine.check_encoded_resumable(e, checkpoint_cb=cc.append,
                                          device=CPU, **kw)
    sk.reset_launches()
    got = engine.check_encoded_resumable(e, checkpoint_cb=gc.append,
                                         device=dev, **kw)
    assert sk.launches["frontier_closure_stats"] > 0
    if budget:
        assert got["capacity"] >= 256 and sk.launches["tiled_insert"] > 0
    _same(want, got)
    assert len(cc) == len(gc)
    for a, b in zip(cc, gc):
        for f in ("st", "ml", "mh", "live"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.event_index, a.capacity, a.maxf, a.stepped) == \
            (b.event_index, b.capacity, b.maxf, b.stepped)
    # a resume on the card from the CPU's second checkpoint
    r = engine.check_encoded_resumable(e, resume=cc[1], device=dev, **kw)
    for k in ("valid?", "fail-event", "max-frontier", "capacity",
              "configs-stepped"):
        assert r.get(k) == want.get(k), k


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, TILED_BUDGET],
                         ids=["K2", "K2-then-K4"])
def test_cuda_session_equals_the_cpu(budget):
    dev = _cuda()
    ops = _ops(_queue(seed=2, corrupt=True))
    on = [extend.HistorySession(models.UnorderedQueue(), capacity=64,
                                dedupe="hash", device=d, search_stats=True,
                                smem_budget=budget) for d in (CPU, dev)]
    for i in range(0, len(ops), 30):
        for s in on:
            s.extend(_ops(ops[i:i + 30]))
        _same(*(s.check() for s in on))
    final = [s.finalize() for s in on]
    assert final[0]["final-paths"] == final[1]["final-paths"]


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, TILED_BUDGET],
                         ids=["K2", "K2-then-K4"])
def test_cuda_advance_sessions_equals_the_cpu(budget):
    dev = _cuda()
    keys = [_ops(_queue(seed=10 + k, n_ops=80 + 10 * k)) for k in range(4)]
    keys.append(_ops(_queue(seed=10, n_ops=80, corrupt=True)))
    groups = [[extend.HistorySession(models.UnorderedQueue(), capacity=64,
                                     dedupe="hash", device=d,
                                     smem_budget=budget) for _ in keys]
              for d in (CPU, dev)]
    sk.reset_launches()
    for step in range(3):
        for g in groups:
            for s, o in zip(g, keys):
                lo, hi = len(o) * step // 3, len(o) * (step + 1) // 3
                s.extend(_ops(o[lo:hi]))
        want = extend.advance_sessions(groups[0])
        got = extend.advance_sessions(groups[1])
        for a, b in zip(want, got):
            _same(a, b)
    assert sk.launches["frontier_closure_batch"] > 0
    if budget:
        assert sk.launches["tiled_insert_batch"] > 0


@pytest.mark.cuda
def test_cuda_pipelined_batch_equals_the_cpu():
    dev = _cuda()
    regs = [histories.rand_register_history(
        n_ops=80, n_processes=8, n_values=5, crash_p=0.005, fail_p=0.05,
        busy=0.8, seed=2024 + k) for k in range(10)]
    regs[3] = histories.corrupt_history(regs[3], seed=1)
    want = engine.check_batch(models.CASRegister(), regs, device=CPU)
    serial = engine.check_batch(models.CASRegister(), regs, device=dev)
    ck.reset_launches()
    stats = {}
    got = pipeline.check_batch_pipelined(
        models.CASRegister(), [History.wrap(_ops(h)) for h in regs],
        chunk_keys=3, depth=2, stats=stats, cache=False, device=dev)
    assert ck.batch_launches >= 4      # a launch a chunk at least
    strip = [{k: v for k, v in r.items() if k != "closure"} for r in want]
    assert [{k: v for k, v in r.items() if k != "closure"}
            for r in got] == strip
    assert got == serial
    assert all(b["device_secs"] > 0 for b in stats["buckets"])
    qs = [_queue(seed=30 + k, n_ops=60) for k in range(3)]
    want = engine.check_batch(models.UnorderedQueue(), qs, device=CPU)
    got = pipeline.check_batch_pipelined(models.UnorderedQueue(), qs,
                                         cache=False, device=dev)
    assert [{k: v for k, v in r.items() if k != "closure"}
            for r in got] == [{k: v for k, v in r.items() if k != "closure"}
                              for r in want]
