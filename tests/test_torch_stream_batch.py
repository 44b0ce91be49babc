"""The port's cross-key streaming batch (jepsen_tpu_torch.parallel.extend.
advance_sessions, on the CPU: the batched scan `sparse._BatchScan` from
each key's own carry, with batched K2's plain version or the batched
sort closure) against one-by-one `check()` of the same sessions and
against the reference's advance_sessions fed the same deltas. Also that
the group really ran batched legs (counted), that keys of different
delta lengths share one leg, that an overflowed member falls back to
its own check alone, and that a fault in a batched leg surfaces and the
sessions resume from where they were."""

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.parallel import extend as ref_extend
from jepsen_tpu_torch import models
from jepsen_tpu_torch.parallel import extend, sparse
from torch_jax_cache import release_compiled_programs  # noqa: F401

CPU = "cpu"
KEYS = ("valid?", "fail-event", "op", "max-frontier", "capacity",
        "configs-stepped", "explored", "dedupe", "stream", "error")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ops(h):
    return [dict(o) for o in h]


def _queue_keys():
    hs = [ref_histories.rand_queue_history(
        n_ops=40 + 10 * k, n_processes=5, n_values=3, crash_p=0.05,
        seed=10 + k) for k in range(3)]
    hs.append(ref_histories.corrupt_history(hs[0], seed=2))
    return "UnorderedQueue", [_ops(h) for h in hs]


def _register_keys():
    hs = [ref_histories.rand_register_history(
        n_ops=30 + 8 * k, n_processes=4, n_values=3, crash_p=0.03,
        seed=60 + k) for k in range(3)]
    hs.append(ref_histories.corrupt_history(hs[1], seed=4))
    return "CASRegister", [_ops(h) for h in hs]


def _one_tier_keys():
    """Register keys of 4 processes and no crashes: at most 4 slots, one
    slot-window bucket."""
    return "CASRegister", [_ops(ref_histories.rand_register_history(
        n_ops=36 + 6 * k, n_processes=4, n_values=3, crash_p=0.0,
        seed=80 + k)) for k in range(3)]


def _count_batched(monkeypatch):
    """Count the batched legs, and the keys of each."""
    legs = []
    real = sparse._BatchScan.run

    def counting(self):
        legs.append(self.K)
        return real(self)

    monkeypatch.setattr(sparse._BatchScan, "run", counting)
    return legs


def _sessions(name, n, **kw):
    return [extend.HistorySession(getattr(models, name)(), device=CPU, **kw)
            for _ in range(n)]


@pytest.mark.parametrize("keys,variant", [
    ("queue", ("hash", False, True)), ("queue", ("sort", True, False)),
    ("queue", ("hash", True, True)), ("register", ("hash", False, False)),
    ("register", ("sort", False, True))],
    ids=["queue-hash-stats", "queue-sort-packed", "queue-hash-packed-stats",
         "register-hash", "register-sort-stats"])
def test_advance_sessions_matches_check_and_reference(keys, variant,
                                                      monkeypatch):
    dedupe, pack, stats = variant
    name, ops = _queue_keys() if keys == "queue" else _register_keys()
    kw = dict(capacity=64, dedupe=dedupe, config_pack=pack,
              search_stats=stats)
    ref = [ref_extend.HistorySession(getattr(ref_models, name)(), **kw)
           for _ in ops]
    port = _sessions(name, len(ops), **kw)
    solo = _sessions(name, len(ops), **kw)
    legs = _count_batched(monkeypatch)
    for step in range(4):
        for k, o in enumerate(ops):
            lo, hi = len(o) * step // 4, len(o) * (step + 1) // 4
            for s in (ref[k], port[k], solo[k]):
                s.extend(_ops(o[lo:hi]))
        n_legs = len(legs)
        want = ref_extend.advance_sessions(ref)
        got = extend.advance_sessions(port)
        assert len(legs) > n_legs   # the group ran batched
        one = [s.check() for s in solo]
        for k in range(len(ops)):
            assert {f: got[k].get(f) for f in KEYS} == \
                {f: want[k].get(f) for f in KEYS}
            assert {f: got[k].get(f) for f in KEYS} == \
                {f: one[k].get(f) for f in KEYS}
            # the batched leg runs the group's one layout at the group's
            # width, as the reference's does
            assert got[k].get("config-pack") == want[k].get("config-pack")
            if stats and "stats" in want[k]:
                assert got[k]["stats"] == want[k]["stats"]
            if stats:
                # a packed leg hashes the group's layout: its probes are
                # its own
                skip = ("probe-hist", "probes") if pack else ()
                assert {f: v for f, v in got[k]["stats"].items()
                        if f not in skip} == \
                    {f: v for f, v in one[k]["stats"].items()
                     if f not in skip}
    assert got[-1]["valid?"] is False
    assert max(legs) == len(ops)


def test_keys_of_different_delta_lengths_share_one_leg(monkeypatch):
    name, ops = _one_tier_keys()
    sessions = _sessions(name, 3, capacity=64, dedupe="hash")
    legs = _count_batched(monkeypatch)
    for k, s in enumerate(sessions):
        s.extend(_ops(ops[k][: 10 + 12 * k]))
    got = extend.advance_sessions(sessions)
    assert legs and legs[0] == 3     # the first leg takes all three
    events = [r["stream"]["events"] for r in got]
    assert len(set(events)) == 3
    solo = _sessions(name, 3, capacity=64, dedupe="hash")
    for k, s in enumerate(solo):
        s.extend(_ops(ops[k][: 10 + 12 * k]))
        assert {f: s.check().get(f) for f in KEYS} == \
            {f: got[k].get(f) for f in KEYS}


def test_an_overflowed_member_falls_back_alone(monkeypatch):
    """Of three register keys the one whose frontier outgrows capacity 64
    leaves the batched leg and climbs its own capacity ladder through its
    own check(); the others stay batched at 64."""
    grow = _ops(ref_histories.rand_register_history(
        n_ops=60, n_processes=5, n_values=3, crash_p=0.06, seed=31))
    small = [_ops(ref_histories.rand_register_history(
        n_ops=40, n_processes=5, n_values=3, crash_p=0.0, seed=70 + k))
        for k in range(2)]
    ops = [grow] + small
    sessions = _sessions("CASRegister", 3, capacity=64, dedupe="hash")
    for s, o in zip(sessions, ops):
        s.extend(_ops(o))
    solo_runs = []
    real = sparse._Scan.run_range

    def recording(self, lo, hi):
        solo_runs.append(self.e.n_returns)
        return real(self, lo, hi)

    monkeypatch.setattr(sparse._Scan, "run_range", recording)
    legs = _count_batched(monkeypatch)
    got = extend.advance_sessions(sessions)
    assert legs and legs[0] == 3
    assert set(solo_runs) == {sessions[0].enc.n_returns}
    assert got[0]["capacity"] > 64
    assert [r["capacity"] for r in got[1:]] == [64, 64]
    ref = [ref_extend.HistorySession(ref_models.CASRegister(), capacity=64,
                                     dedupe="hash") for _ in ops]
    for s, o in zip(ref, ops):
        s.extend(_ops(o))
    want = ref_extend.advance_sessions(ref)
    for k in range(3):
        for f in ("valid?", "max-frontier", "capacity", "configs-stepped"):
            assert got[k].get(f) == want[k].get(f), (k, f)


def test_a_fault_in_a_batched_leg_surfaces(monkeypatch):
    name, ops = _one_tier_keys()
    sessions = _sessions(name, 3, capacity=64, dedupe="hash")
    for s, o in zip(sessions, ops):
        s.extend(_ops(o[:20]))
    extend.advance_sessions(sessions)
    before = [s.resume_event for s in sessions]
    for s, o in zip(sessions, ops):
        s.extend(_ops(o[20:]))

    def broken(self):
        raise RuntimeError("CUDA error: launch failure")

    monkeypatch.setattr(sparse._BatchScan, "run", broken)
    with pytest.raises(RuntimeError, match="launch failure"):
        extend.advance_sessions(sessions)
    monkeypatch.undo()
    assert [s.resume_event for s in sessions] == before
    got = extend.advance_sessions(sessions)
    solo = _sessions(name, 3, capacity=64, dedupe="hash")
    for k, (s, o) in enumerate(zip(solo, ops)):
        s.extend(_ops(o))
        assert {f: s.check().get(f) for f in KEYS if f != "stream"} == \
            {f: got[k].get(f) for f in KEYS if f != "stream"}


def test_host_only_and_unchanged_sessions_pass_through():
    name, ops = _register_keys()
    a, b = _sessions(name, 2, dedupe="hash")
    wide = [{"process": p, "type": "invoke", "f": "write", "value": 1}
            for p in range(65)]
    a.extend(wide)
    b.extend(_ops(ops[0]))
    first = extend.advance_sessions([a, b, b])
    assert a.host_only and first[0]["fallback"]
    assert first[1] == first[2]
    assert extend.advance_sessions([b]) == [first[1]]
