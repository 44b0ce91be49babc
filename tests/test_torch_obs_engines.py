"""Every engine path's telemetry against the reference's, on the CPU.

For each path — dense single and batch, sparse sort, hash and tiled,
the pipelined batch, the sharded check at 1 and 2 gloo ranks, the
resumable check, the streaming session (solo and batched), the stealing
executor and `independent` — the same seeded inputs run through the
reference (jepsen_tpu) and the port (jepsen_tpu_torch) with tracing on,
and these are held equal:

* the multiset of (span name, parent span's name, track, non-timing
  args);
* each counter's, gauge's and histogram count's registry delta;
* the search-stats records (``obs.drain_search_stats``).

The only names the reference has and the port may lack are
`REFERENCE_ONLY`'s, each with its reason; the port has no name the
reference lacks. The results are bit-identical with the port's tracing
on and off.

The sharded ranks are spawned gloo processes that re-import this module,
so it imports nothing of JAX at its top: the reference is imported
inside the functions that run it.
"""

import collections
import json
import types

import numpy as np
import pytest
import torch

import torch_gloo
from jepsen_tpu_torch import histories, models, obs
from jepsen_tpu_torch.history import History
from torch_jax_cache import release_compiled_programs  # noqa: F401

CPU = "cpu"

_FAULT = ("no device-fault degradation: a device error raises to the "
          "caller (ROADMAP, Decisions that differ)")
#: names the reference has and the port does not, by design
REFERENCE_ONLY = {
    "resilience.retries": _FAULT,
    "resilience.device_resume": _FAULT,
    "engine.sparse_pallas_fallbacks": _FAULT + "; no closure fallback",
    "bitdense.pallas_fallbacks": _FAULT + "; no closure fallback",
    "pipeline.chunks_degraded": _FAULT,
    "stream.degraded_checks": _FAULT,
    "elastic.rounds_degraded": _FAULT,
    "serve.compile_secs": "the port compiles no .jprog programs",
    "resilience.breaker.cpu.state":
        "independent has no circuit breaker: it catches EncodeError only "
        "(ROADMAP, Decisions that differ)",
}
#: span args whose values differ by design: (span, arg) -> reason
ARG_DIFFS = {
    ("stream.batch_scan", "events"):
        "the reference pads a batched leg to its jit cache's event "
        "quantum; the port runs the longest member's rows",
}


@pytest.fixture(autouse=True)
def _clean():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for o in (obs, _ref().obs):
        o.reset()
        o.drain_search_stats()
    yield
    for o in (obs, _ref().obs):
        o.reset()
        o.drain_search_stats()
    torch.set_num_threads(n)


def _ref():
    """The reference's modules (imported here, not at the top)."""
    from jepsen_tpu import histories as h, independent, models as m, obs as o
    from jepsen_tpu.checker.linearizable import linearizable
    from jepsen_tpu.history import History as H, Op
    from jepsen_tpu.parallel import encode, engine, extend, pipeline
    return types.SimpleNamespace(
        obs=o, histories=h, models=m, History=H, Op=Op, encode=encode,
        engine=engine, extend=extend, pipeline=pipeline,
        independent=independent, linearizable=linearizable)


def _port():
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.parallel import (elastic, encode, engine, extend,
                                           pipeline, sparse)
    return types.SimpleNamespace(
        obs=obs, histories=histories, models=models, History=History,
        encode=encode, engine=engine, extend=extend, pipeline=pipeline,
        sparse=sparse, elastic=elastic, independent=independent,
        linearizable=linearizable)


# ------------------------------------------------------------ capture


def _plain(x):
    """JSON-comparable: numpy scalars as Python numbers, tuples as
    lists."""
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    return x


def _tree(spans) -> collections.Counter:
    by_id = {s.sid: s for s in spans}
    out = collections.Counter()
    for s in spans:
        parent = by_id[s.parent].name if s.parent in by_id else None
        args = tuple(sorted(
            (k, json.dumps(_plain(v), sort_keys=True, default=str))
            for k, v in s.args.items() if (s.name, k) not in ARG_DIFFS))
        out[(s.name, parent, s.track, args)] += 1
    return out


def _moved(delta: dict) -> dict:
    out = {}
    for name, m in delta.items():
        if m["type"] == "counter":
            out[name] = m["value"]
        elif m["type"] == "gauge":
            out[name] = ("gauge", m["value"], m["nops"])
        else:
            out[name] = ("histogram", m["count"])
    return out


def traced(o, fn) -> dict:
    """fn() with `o`'s tracing on: its result, span tree, registry
    delta and search-stats records."""
    o.drain_search_stats()
    tr = o.configure(True)
    before = o.registry().snapshot()
    try:
        out = fn()
    finally:
        o.reset()
    return {"result": out, "tree": _tree(tr.spans()),
            "moved": _moved(o.registry().delta(before)),
            "records": _plain(o.drain_search_stats())}


def _names(tree) -> set:
    return {k[0] for k in tree}


def assert_same_telemetry(got: dict, want: dict) -> None:
    """The port's capture `got` against the reference's `want`."""
    extra = (_names(got["tree"]) | set(got["moved"])) \
        - (_names(want["tree"]) | set(want["moved"]))
    assert not extra, f"names the reference lacks: {sorted(extra)}"
    missing = (_names(want["tree"]) | set(want["moved"])) \
        - (_names(got["tree"]) | set(got["moved"]))
    assert missing <= set(REFERENCE_ONLY), sorted(missing)
    want_tree = collections.Counter(
        {k: n for k, n in want["tree"].items()
         if k[0] not in REFERENCE_ONLY})
    assert got["tree"] == want_tree, (
        sorted((got["tree"] - want_tree).items()),
        sorted((want_tree - got["tree"]).items()))
    want_moved = {k: v for k, v in want["moved"].items()
                  if k not in REFERENCE_ONLY}
    assert got["moved"] == want_moved
    assert got["records"] == want["records"]


def run_both(case: str) -> tuple:
    """(port capture, reference capture) of one path, and the port's
    untraced result held equal to its traced one."""
    R, P = _ref(), _port()
    want = traced(R.obs, lambda: CASES[case](R, "ref"))
    untraced = CASES[case](P, "port")
    got = traced(obs, lambda: CASES[case](P, "port"))
    assert got["result"] == untraced, "tracing changed a result"
    return got, want


# ------------------------------------------------------------ inputs


def _dicts(h) -> list:
    return [{f: o.get(f) for f in ("process", "type", "f", "value")}
            for o in h]


def _register_ops(n_ops: int, seed: int, corrupt=None, n_processes=4):
    h = histories.rand_register_history(n_ops=n_ops,
                                        n_processes=n_processes,
                                        crash_p=0.05, fail_p=0.05,
                                        seed=seed)
    if corrupt is not None:
        h = histories.corrupt_history(h, seed=corrupt)
    return _dicts(h)


def _queue_ops(n_ops: int, seed: int, crash_p: float = 0.06):
    return _dicts(histories.rand_queue_history(
        n_ops=n_ops, n_processes=5, n_values=3, crash_p=crash_p, seed=seed))


def _many_states_ops(n_writes: int = 140, read=7):
    """Sequential writes of distinct values and a read: past the dense
    engine's 128 states, so the sparse engine checks it."""
    ops = []
    for v in range(n_writes):
        ops += [{"process": 0, "type": "invoke", "f": "write", "value": v},
                {"process": 0, "type": "ok", "f": "write", "value": v}]
    return ops + [{"process": 1, "type": "invoke", "f": "read",
                   "value": None},
                  {"process": 1, "type": "ok", "f": "read", "value": read}]


def _wrap(M, ops):
    return M.History.wrap([dict(o) for o in ops]).index()


def _enc(M, model_name, ops):
    return M.encode.encode(getattr(M.models, model_name)(), _wrap(M, ops))


def _dev(pkg) -> dict:
    return {"device": CPU} if pkg == "port" else {}


REGS = [_register_ops(40, 300 + s, corrupt=(s if s % 3 == 1 else None))
        for s in range(6)]
QUEUES = [_queue_ops(30, 80 + s) for s in range(4)]
# a crash-riddled queue key that climbs the capacity ladder 64 -> 256
HEAVY = _dicts(histories.rand_queue_history(
    n_ops=32, n_processes=6, n_values=3, crash_p=0.22, seed=1))


# ------------------------------------------------------------ paths


def _dense_single(M, pkg):
    out = []
    for ops in (_register_ops(80, 11), _register_ops(80, 12, corrupt=2)):
        out.append(M.engine.analysis(M.models.CASRegister(), _wrap(M, ops),
                                     search_stats=True, **_dev(pkg)))
    return out


def _dense_batch(M, pkg):
    return M.engine.check_batch(M.models.CASRegister(),
                                [_wrap(M, o) for o in REGS],
                                search_stats=True, **_dev(pkg))


def _sparse(dedupe, tiled=False):
    def run(M, pkg):
        kw = dict(capacity=64, max_capacity=1 << 16, dedupe=dedupe,
                  search_stats=True, **_dev(pkg))
        check = M.sparse.check_encoded if pkg == "port" \
            else M.engine.check_encoded
        if tiled and pkg == "port":
            kw["smem_budget"] = 512        # the tiled route's seam
        out = [check(_enc(M, "UnorderedQueue", ops), **kw)
               for ops in (QUEUES[0], HEAVY)]
        if tiled and pkg == "port":
            assert {r["closure"] for r in out} == {"torch-tiled"}
        # past 128 states: analysis routes to the sparse engine
        out.append(M.engine.analysis(
            M.models.CASRegister(), _wrap(M, _many_states_ops()),
            dedupe=dedupe, search_stats=True, **_dev(pkg)))
        return out
    return run


def _pipelined(M, pkg):
    kw = dict(cache=False, chunk_keys=2, depth=2, dedupe="hash",
              search_stats=True, capacity=64, max_capacity=4096,
              **_dev(pkg))
    dense = M.pipeline.check_batch_pipelined(
        M.models.CASRegister(), [_wrap(M, o) for o in REGS], **kw)
    sparse = M.pipeline.check_batch_pipelined(
        M.models.UnorderedQueue(), [_wrap(M, o) for o in QUEUES], **kw)
    return dense, sparse


def _resumable(M, pkg):
    return [M.engine.check_encoded_resumable(
        _enc(M, "UnorderedQueue", ops), capacity=64, checkpoint_every=8,
        dedupe="hash", search_stats=True, **_dev(pkg))
        for ops in (QUEUES[0], HEAVY)]


def _stream(M, pkg):
    def session(k):
        return M.extend.HistorySession(
            M.models.UnorderedQueue(), capacity=64, dedupe="hash",
            search_stats=True, key=k, **_dev(pkg))

    out = []
    # a register key resumes past its settled prefix; the heavy queue
    # key climbs the capacity ladder
    for k, model, ops in (("reg", M.models.CASRegister(), REGS[0]),
                          ("heavy", M.models.UnorderedQueue(), HEAVY)):
        solo = M.extend.HistorySession(model, capacity=64, dedupe="hash",
                                       search_stats=True, key=k,
                                       **_dev(pkg))
        n = len(ops)
        for lo, hi in ((0, n // 3), (n // 3, 2 * n // 3), (2 * n // 3, n)):
            solo.extend([dict(o) for o in ops[lo:hi]])
            out.append(solo.check())
        out.append(solo.finalize())
    group = [session(f"k{i}") for i in range(3)]
    for lo, hi in ((0, 24), (24, 60)):
        for s, q in zip(group, QUEUES[1:]):
            s.extend([dict(o) for o in q[lo:hi]])
        out.append(M.extend.advance_sessions(group))
    return out


def _stealing(M, pkg):
    out = []
    for name, hs, cap in (("CASRegister", REGS, 64),
                          ("UnorderedQueue", QUEUES, 32)):
        acc: dict = {}
        out.append(M.engine.check_batch(
            getattr(M.models, name)(), [_wrap(M, o) for o in hs],
            steal=True, steal_stats=acc, search_stats=True, dedupe="hash",
            capacity=cap, max_capacity=4096, **_dev(pkg)))
        out.append(acc["buckets"])
    return out


def _op(p, t, f, v):
    return {"process": p, "type": t, "f": f, "value": v}


def _keyed(M, per_key: dict):
    lists = [[dict(o, process=o["process"] + 100 * i,
                   value=M.independent.KV(k, o["value"])) for o in ops]
             for i, (k, ops) in enumerate(per_key.items())]
    out = []
    for j in range(max(map(len, lists))):
        out += [ops[j] for ops in lists if j < len(ops)]
    return M.History.wrap(out).index()


def _independent(M, pkg):
    algo = "torch" if pkg == "port" else "jax"
    regs = {f"r{i}": ops for i, ops in enumerate(REGS[:4])}
    out = [M.independent.checker(M.linearizable(
        M.models.CASRegister(), algorithm=algo, **_dev(pkg))).check(
            {}, _keyed(M, regs))]
    big = []
    for v in range(40):           # past a set's lanes: not encodable
        big += [_op(0, "invoke", "add", v), _op(0, "ok", "add", v)]
    small = [_op(1, "invoke", "add", 1), _op(1, "ok", "add", 1),
             _op(1, "invoke", "read", None), _op(1, "ok", "read", [1])]
    r = M.independent.checker(M.linearizable(
        M.models.GSet(), algorithm=algo, **_dev(pkg))).check(
            {}, _keyed(M, {"big": big, "small": small}))
    r["resilience"].pop("backend")
    out.append(r)
    return out


CASES = {
    "dense-single": _dense_single,
    "dense-batch": _dense_batch,
    "sparse-sort": _sparse("sort"),
    "sparse-hash": _sparse("hash"),
    "sparse-tiled": _sparse("hash", tiled=True),
    "pipelined": _pipelined,
    "resumable": _resumable,
    "stream": _stream,
    "stealing": _stealing,
    "independent": _independent,
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_telemetry_equals_reference(case):
    got, want = run_both(case)
    assert_same_telemetry(got, want)
    # the resumable check has no span in the reference: its sinks only
    assert got["tree"] or case == "resumable", "the path recorded no span"
    assert got["moved"], "the path moved no metric"


def test_the_paths_cover_the_reference_sites():
    """The names the paths above exercise, spans and metrics together:
    every site of the tentpole's list fires on some path."""
    seen = set()
    for case in ("dense-single", "sparse-hash", "pipelined", "stream",
                 "stealing", "independent"):
        got, _ = run_both(case)
        seen |= _names(got["tree"]) | set(got["moved"])
    for name in (
            "engine.encode", "engine.search", "engine.check_batch",
            "engine.encode_batch", "engine.sparse_batch",
            "engine.configs_stepped", "engine.capacity_escalations",
            "engine.host_fallbacks", "bitdense.check", "bitdense.finalize",
            "bitdense.pad_place", "bitdense.dispatches", "pipeline.run",
            "pipeline.prepare", "pipeline.encode", "pipeline.dispatch",
            "pipeline.finalize", "pipeline.sparse", "device.search",
            "pipeline.keys", "pipeline.chunks", "pipeline.inflight",
            "pipeline.encode_secs", "pipeline.transfer_secs",
            "pipeline.device_wait_secs", "stream.encode", "stream.check",
            "stream.batch_scan", "stream.batched_keys",
            "stream.resumed_events", "elastic.check_batch",
            "elastic.round", "independent.check", "independent.key",
            "independent.device_batch", "independent.keys",
            "independent.device_fallbacks",
            "independent.device_fallbacks.not-encodable",
            "engine.search.events", "engine.search.frontier_peak"):
        assert name in seen, name


# ------------------------------------------------------ sharded, 1-2 ranks


SHARDED_CASES = {
    "hash": (_register_ops(60, 77, corrupt=0), dict(dedupe="hash")),
    "sort": (_register_ops(50, 81), dict(dedupe="sort")),
}


def _sharded_rank(rank: int, D: int):
    """One gloo rank: each sharded case with tracing on, then the
    elastic ladder; returns what the rank recorded."""
    from jepsen_tpu_torch.parallel import encode, sharded
    mesh = torch_gloo.mesh((D,))
    out = {}
    for cid, (ops, kw) in SHARDED_CASES.items():
        e = encode.encode(models.CASRegister(), _wrap(_port(), ops))

        def check():
            return sharded.check_encoded_sharded(
                e, mesh, capacity=64 * D, max_capacity=1 << 16,
                search_stats=True, **kw)

        untraced = check()
        obs.drain_search_stats()
        got = traced(obs, check)
        assert got["result"] == untraced, "tracing changed a result"
        out[cid] = got
    e = encode.encode(models.CASRegister(), _wrap(_port(), REGS[0]))
    out["elastic"] = traced(obs, lambda: sharded.check_encoded_sharded_elastic(
        e, mesh, capacity=64, max_capacity=1 << 14, dedupe="hash"))
    for got in out.values():
        got["result"] = _plain({k: v for k, v in got["result"].items()
                                if k != "checkpoint"})
    return out


def _sharded_ref(D: int) -> dict:
    import jax
    from jax.sharding import Mesh
    from jepsen_tpu.parallel import sharded
    R = _ref()
    mesh = Mesh(np.array(jax.devices()[:D]), ("frontier",))
    out = {}
    for cid, (ops, kw) in SHARDED_CASES.items():
        e = _enc(R, "CASRegister", ops)
        out[cid] = traced(R.obs, lambda: sharded.check_encoded_sharded(
            e, mesh, capacity=64 * D, max_capacity=1 << 16,
            search_stats=True, **kw))
    e = _enc(R, "CASRegister", REGS[0])
    out["elastic"] = traced(R.obs, lambda: sharded.check_encoded_sharded_elastic(
        e, mesh, capacity=64, max_capacity=1 << 14, dedupe="hash"))
    return out


@pytest.mark.parametrize("D", [1, 2])
def test_sharded_telemetry_equals_reference(D):
    group = torch_gloo.Group(D, _sharded_rank, (D,))
    want = _sharded_ref(D)
    ranks = group.results()
    for cid in want:
        for got in ranks:      # every rank records the reference's tree
            assert_same_telemetry(got[cid], want[cid])
        assert ranks[0][cid]["result"]["valid?"] \
            == bool(want[cid]["result"]["valid?"])
