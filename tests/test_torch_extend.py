"""The port's streaming sessions (jepsen_tpu_torch.parallel.extend, on
the CPU with the plain closures) against the reference's
(jepsen_tpu.parallel.extend) fed the same deltas, and against the
port's one-shot check of each prefix: verdict, op/fail-event,
max-frontier, configs-stepped, capacity, the "stream" block and the
lifetime stats block, per model family, clean and corrupted. Also
settled_events/stable_events, that a session resumes forward (its
resume_event, and the events each check scans), capacity growth
mid-stream, finalize's counterexample paths, a malformed delta, a key
the encoder cannot take, freeze/thaw (and a thaw whose digest differs),
SearchStats.splice and extend_encoded."""

import numpy as np
import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu.parallel import extend as ref_extend
from jepsen_tpu_torch import models
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import encode, engine, extend, sparse
from jepsen_tpu_torch.parallel import search_stats as st
from test_torch_sparse import _to_port
from torch_jax_cache import release_compiled_programs  # noqa: F401

CPU = "cpu"
KEYS = ("valid?", "fail-event", "op", "max-frontier", "capacity",
        "configs-stepped", "explored", "dedupe", "config-pack", "stream",
        "error")
ONE_SHOT = ("valid?", "fail-event", "op", "max-frontier", "capacity",
            "configs-stepped")
SAME_TRAJECTORY = ("events", "frontier-width", "closure-iters",
                   "configs-stepped-per-event", "closure-peak",
                   "frontier-peak")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = {
    "register": ("CASRegister", lambda: ref_histories.rand_register_history(
        n_ops=60, n_processes=5, n_values=3, crash_p=0.05, fail_p=0.05,
        seed=41)),
    "uqueue": ("UnorderedQueue", lambda: ref_histories.rand_queue_history(
        n_ops=80, n_processes=5, n_values=3, crash_p=0.05, seed=3)),
    "fifo": ("FIFOQueue", lambda: ref_histories.rand_fifo_history(
        n_ops=60, n_processes=4, n_values=3, crash_p=0.04, seed=35)),
    "gset": ("GSet", lambda: ref_histories.rand_gset_history(
        n_ops=50, n_processes=4, n_elements=8, crash_p=0.05, seed=33)),
}
# a register history whose frontier outgrows capacity 64 (to 1,024)
GROWTH = lambda: ref_histories.rand_register_history(  # noqa: E731
    n_ops=60, n_processes=5, n_values=3, crash_p=0.06, seed=31)

VARIANTS = (("hash", False, True), ("sort", True, True),
            ("hash", True, False), ("sort", False, False))


def _ops(h):
    return [dict(o) for o in h]


def _sessions(model_name, **kw):
    kw.setdefault("dedupe", "hash")    # the reference's default is sort
    ref = ref_extend.HistorySession(getattr(ref_models, model_name)(), **kw)
    port = extend.HistorySession(getattr(models, model_name)(), device=CPU,
                                 **kw)
    return ref, port


def _one_shot(model_name, ops, **kw):
    e = encode.encode(getattr(models, model_name)(), History.wrap(ops))
    return sparse.check_encoded(e, device=CPU, **kw)


def _same(want, got):
    assert {k: want.get(k) for k in KEYS} == {k: got.get(k) for k in KEYS}
    assert ("stats" in want) == ("stats" in got)
    if "stats" in want:
        assert got["stats"] == want["stats"]


CASES = [(f, c, VARIANTS[i % len(VARIANTS)]) for i, (f, c) in enumerate(
    (f, c) for f in FAMILIES for c in (False, True))]


@pytest.mark.parametrize(
    "family,corrupt,variant", CASES,
    ids=[f"{f}-{'corrupt' if c else 'clean'}-{v[0]}"
         f"{'-packed' if v[1] else ''}{'-stats' if v[2] else ''}"
         for f, c, v in CASES])
def test_session_matches_reference_and_one_shot(family, corrupt, variant):
    dedupe, pack, stats = variant
    name, gen = FAMILIES[family]
    h = gen()
    if corrupt:
        h = ref_histories.corrupt_history(h, seed=5)
    ops = _ops(h)
    ref, port = _sessions(name, capacity=64, dedupe=dedupe,
                          config_pack=pack, search_stats=stats)
    step = 17
    for i in range(0, len(ops), step):
        ref.extend(_ops(ops[i:i + step]))
        port.extend(_ops(ops[i:i + step]))
        want, got = ref.check(), port.check()
        _same(want, got)
        if i // step in (2, (len(ops) - 1) // step):   # mid-stream, final
            one = _one_shot(name, ops[:i + step], capacity=64,
                            dedupe=dedupe, config_pack=pack,
                            search_stats=stats)
            assert {k: got.get(k) for k in ONE_SHOT} == \
                {k: one.get(k) for k in ONE_SHOT}
            if stats and got.get("valid?") is not False:
                # the lifetime trajectories are the one-shot check's of
                # the prefix (the probes and the tiers climbed depend on
                # the capacity each leg ran at)
                assert {k: got["stats"][k] for k in SAME_TRAJECTORY} == \
                    {k: one["stats"][k] for k in SAME_TRAJECTORY}
    if corrupt:
        assert got["valid?"] is False


def _scanned(monkeypatch):
    """Record the (lo, hi) of every chunk a single-key scan runs."""
    runs = []
    real = sparse._Scan.run_range

    def recording(self, lo, hi):
        runs.append((lo, hi))
        return real(self, lo, hi)

    monkeypatch.setattr(sparse._Scan, "run_range", recording)
    return runs


def test_session_resumes_forward(monkeypatch):
    """Each check scans only past the checkpoint it resumes from: the
    stable boundary the last check kept. (A register's packing is fixed
    by the values seen so far; a queue's grows with its enqueues, and a
    delta that widens it settles nothing.)"""
    name, gen = FAMILIES["register"]
    ops = _ops(gen())
    runs = _scanned(monkeypatch)
    s = extend.HistorySession(models.CASRegister(), capacity=64,
                              device=CPU)
    s.extend(_ops(ops[:40]))
    r1 = s.check()
    assert runs[0][0] == 0 and r1["stream"]["resumed-from-event"] == 0
    boundary = s.resume_event
    assert 0 < boundary <= r1["stream"]["events"]
    runs.clear()
    s.extend(_ops(ops[40:]))
    assert s.resume_event == boundary
    r2 = s.check()
    assert r2["stream"]["resumed-from-event"] == boundary
    assert runs and min(lo for lo, _ in runs) == boundary
    ref = ref_extend.HistorySession(ref_models.CASRegister(), capacity=64,
                                    dedupe="hash")
    ref.extend(_ops(ops[:40]))
    ref.check()
    assert ref.resume_event == boundary
    ref.extend(_ops(ops[40:]))
    _same(ref.check(), r2)


def test_capacity_grows_midstream():
    ops = _ops(GROWTH())
    ref, port = _sessions("CASRegister", capacity=64, dedupe="hash",
                          search_stats=True)
    for i in range(0, len(ops), 20):
        ref.extend(_ops(ops[i:i + 20]))
        port.extend(_ops(ops[i:i + 20]))
        _same(ref.check(), port.check())
    got = port.check()
    assert got["capacity"] > 64 and port.capacity == got["capacity"]
    one = _one_shot("CASRegister", ops, capacity=64, dedupe="hash")
    assert {k: got.get(k) for k in ONE_SHOT} == \
        {k: one.get(k) for k in ONE_SHOT}


def test_overflow_past_max_capacity_is_unknown():
    ops = _ops(GROWTH())
    ref, port = _sessions("CASRegister", capacity=64, max_capacity=128,
                          dedupe="hash")
    ref.extend(_ops(ops))
    port.extend(_ops(ops))
    want, got = ref.check(), port.check()
    assert got["valid?"] == "unknown"
    _same(want, got)
    for f in ("event_index", "capacity", "maxf", "stepped"):
        assert getattr(got["checkpoint"], f) == \
            getattr(want["checkpoint"], f)


def test_finalize_gives_the_final_paths():
    name, gen = FAMILIES["register"]
    ops = _ops(ref_histories.corrupt_history(gen(), seed=5))
    ref, port = _sessions(name, capacity=64)
    for i in range(0, len(ops), 25):
        ref.extend(_ops(ops[i:i + 25]))
        port.extend(_ops(ops[i:i + 25]))
    want, got = ref.finalize(), port.finalize()
    assert got["valid?"] is False and got["final-paths"]
    for k in ("final-paths", "configs", "op", "fail-event"):
        assert got[k] == want[k], k
    one = engine.analysis(models.CASRegister(), History.wrap(ops),
                          device=CPU, capacity=64)
    assert got["final-paths"] == one["final-paths"]
    with pytest.raises(RuntimeError, match="finalized"):
        port.extend([{"process": 0, "type": "invoke", "f": "read",
                      "value": None}])


def test_malformed_delta_raises_before_mutating():
    name, gen = FAMILIES["uqueue"]
    ops = _ops(gen())
    s = extend.HistorySession(models.UnorderedQueue(), device=CPU)
    s.extend(_ops(ops[:20]))
    r = s.check()
    enc, n = s.enc, s.n_ops
    with pytest.raises(ValueError, match="type must be one of"):
        s.extend(_ops(ops[20:25]) + [{"process": 1, "type": "bogus"}])
    with pytest.raises(ValueError, match="type must be one of"):
        s.extend(["not an op"])
    assert s.n_ops == n and s.enc is enc and s.check() == r


def test_an_unencodable_key_goes_host_only():
    """65 crashed writes pass the 64-slot window: EncodeError, and the
    key is checked by the host WGL engine from then on, as the
    reference's session does."""
    ops = [{"process": p, "type": "invoke", "f": "write", "value": p % 3}
           for p in range(65)]
    ops += [{"process": p, "type": "info", "f": "write", "value": p % 3}
            for p in range(65)]
    ref, port = _sessions("CASRegister")
    ref.extend(_ops(ops))
    port.extend(_ops(ops))
    assert port.host_only and port.enc is None
    want, got = ref.check(), port.check()
    assert got["valid?"] == want["valid?"] is True
    assert got["fallback"] == want["fallback"]
    port.extend([{"process": 70, "type": "invoke", "f": "read",
                  "value": None},
                 {"process": 70, "type": "ok", "f": "read", "value": 1}])
    assert port.host_only and port.check()["valid?"] is True


def test_freeze_thaw_resumes_without_rescanning(tmp_path, monkeypatch):
    name, gen = FAMILIES["register"]
    ops = _ops(gen())
    half = len(ops) // 2
    whole = extend.HistorySession(models.CASRegister(), capacity=64,
                                  device=CPU)
    whole.extend(_ops(ops[:half]))
    whole.check()
    meta = whole.freeze(str(tmp_path / "key"))
    assert meta["checkpoint"].endswith(".npz") and meta["event_index"] > 0
    cp = engine.FrontierCheckpoint.load(meta["checkpoint"])
    runs = _scanned(monkeypatch)
    thawed = extend.HistorySession(models.CASRegister(), capacity=64,
                                   device=CPU)
    thawed.thaw(_ops(ops[:half]), cp)
    assert thawed.resume_event == meta["event_index"]
    thawed.extend(_ops(ops[half:]))
    whole.extend(_ops(ops[half:]))
    got = thawed.check()
    assert runs and min(lo for lo, _ in runs) > 0
    want = whole.check()
    assert {k: got.get(k) for k in ONE_SHOT} == \
        {k: want.get(k) for k in ONE_SHOT}
    # the reference's session thaws the port's file the same way
    ref = ref_extend.HistorySession(ref_models.CASRegister(), capacity=64)
    ref.thaw(_ops(ops[:half]), ref_engine.FrontierCheckpoint.load(
        meta["checkpoint"]))
    assert ref.resume_event == meta["event_index"]
    with pytest.raises(RuntimeError, match="fresh session"):
        thawed.thaw(_ops(ops), cp)


def test_thaw_with_another_digest_rescans(tmp_path):
    name, gen = FAMILIES["fifo"]
    ops = _ops(gen())
    other = extend.HistorySession(models.FIFOQueue(), capacity=64,
                                  device=CPU)
    other.extend(_ops(ref_histories.corrupt_history(gen(), seed=9)))
    other.check()
    cp = engine.FrontierCheckpoint.load(
        other.freeze(str(tmp_path / "other"))["checkpoint"])
    s = extend.HistorySession(models.FIFOQueue(), capacity=64, device=CPU)
    s.thaw(_ops(ops), cp)
    assert s.resume_event == 0
    r = s.check()
    assert r["stream"]["resumed-from-event"] == 0
    one = _one_shot("FIFOQueue", ops, capacity=64)
    assert {k: r.get(k) for k in ONE_SHOT} == \
        {k: one.get(k) for k in ONE_SHOT}


def test_settled_and_stable_events_match_reference():
    for name, gen in FAMILIES.values():
        ops = _ops(gen())
        old = ref_old = None
        for cut in range(7, len(ops) + 7, 7):
            prefix = ops[:cut]
            e = ref_enc.encode(getattr(ref_models, name)(),
                               _ref_wrap(prefix))
            pe = _to_port(e)
            assert extend.settled_events(old, pe) == \
                ref_extend.settled_events(ref_old, e)
            assert extend.stable_events(prefix, pe) == \
                ref_extend.stable_events(prefix, e)
            old, ref_old = pe, e


def _ref_wrap(ops):
    from jepsen_tpu.history import History as RefHistory
    return RefHistory.wrap(_ops(ops))


def test_extend_encoded_matches_reference():
    name, gen = FAMILIES["gset"]
    ops = _ops(gen())
    e0, n0 = extend.extend_encoded(models.GSet(), None, [], ops[:20])
    e1, n1 = extend.extend_encoded(models.GSet(), e0, ops[:20], ops[20:])
    r0, m0 = ref_extend.extend_encoded(ref_models.GSet(), None, [],
                                       _ops(ops[:20]))
    r1, m1 = ref_extend.extend_encoded(ref_models.GSet(), r0,
                                       _ops(ops[:20]), _ops(ops[20:]))
    assert (n0, n1) == (m0, m1) and n1 > 0
    assert engine.history_digest(e1) == ref_engine.history_digest(r1)


def test_splice_gives_the_references_lifetime_block():
    """SearchStats.splice on the same legs gives the reference's block."""
    rng = np.random.default_rng(3)

    def leg(cls, n, cap, seed):
        r = np.random.default_rng(seed)
        acc = cls("hash")
        acc.add_chunk({"width": r.integers(-1, 9, n),
                       "peak": r.integers(0, 30, n),
                       "iters": r.integers(0, 5, n),
                       "stepped": r.integers(0, 40, n),
                       "swork": r.integers(0, 60, n),
                       "phist": r.integers(0, 4, (n, st.N_PROBE_BUCKETS))},
                      cap)
        return acc

    for cls_port, cls_ref in ((st.SearchStats, ref_engine.SearchStats),):
        a, b = cls_port("hash"), cls_ref("hash")
        resume = 0
        for i, n in enumerate((12, 9, 15)):
            seed = int(rng.integers(1 << 30))
            lp, lr = leg(cls_port, n, 64 << i, seed), \
                leg(cls_ref, n, 64 << i, seed)
            lp.escalations = lr.escalations = i
            a.splice(resume, lp)
            b.splice(resume, lr)
            assert a.block() == b.block()
            resume = max(0, len(a.width) - 4)


def test_migrate_and_the_card_default(monkeypatch):
    s = extend.HistorySession(models.UnorderedQueue(), device=CPU)
    s.migrate("cpu")
    assert s.device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        extend.HistorySession(models.UnorderedQueue())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s.migrate(None)
