"""The port's pipelined batch executor (jepsen_tpu_torch.parallel.pipeline,
on the CPU) against the port's serial `engine.check_batch` and the
reference's pipelined executor on the same histories: key for key, in
order, over the register (dense buckets), queue and set (sparse
buckets) families, small chunk_keys and depth 1-3, the exact bucket
policy, search stats and the empty batch; `independent` with
pipeline=True. Also the encode cache (hits, misses, the LRU and byte
bounds, the mutation guard, store_dir across caches, a cache that is
off), `engine.analysis(encode_cache=...)`, the JEPSEN_TPU_TORCH_PIPELINE
flag, the serial path's refusal of the pipeline's arguments, and the
mesh/stealing arguments, which are not ported."""

import copy

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.parallel import pipeline as ref_pipeline
from jepsen_tpu_torch import independent, models
from jepsen_tpu_torch.checker.linearizable import Linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import engine, pipeline
from torch_jax_cache import release_compiled_programs  # noqa: F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _registers():
    hs = [ref_histories.rand_register_history(
        n_ops=36 + 4 * k, n_processes=3 + k % 4, n_values=3, crash_p=0.03,
        seed=100 + k) for k in range(7)]
    hs[2] = ref_histories.corrupt_history(hs[2], seed=1)
    return "CASRegister", hs


def _queues():
    hs = [ref_histories.rand_queue_history(
        n_ops=30, n_processes=4, n_values=3, crash_p=0.05, seed=200 + k)
        for k in range(3)]
    hs.append(ref_histories.corrupt_history(hs[1], seed=3))
    return "UnorderedQueue", hs


def _sets():
    return "GSet", [ref_histories.rand_gset_history(
        n_ops=24, n_processes=3, n_elements=8, crash_p=0.05, seed=300 + k)
        for k in range(3)]


FAMILIES = {"register": _registers, "queue": _queues, "set": _sets}
ENGINES = {"register": "bitdense", "queue": "sparse", "set": "sparse"}


def _port(hs):
    return [History.wrap(dict(o) for o in h) for h in hs]


def _strip(rs):
    return [{k: v for k, v in r.items() if k != "closure"} for r in rs]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pipelined_equals_serial_and_reference(family):
    name, hs = FAMILIES[family]()
    model = getattr(models, name)()
    serial = engine.check_batch(model, _port(hs), device=CPU,
                                search_stats=True)
    want = ref_pipeline.check_batch_pipelined(
        getattr(ref_models, name)(), hs, cache=False, chunk_keys=2,
        dedupe="hash", search_stats=True)
    for chunk_keys, depth in ((1, 1), (2, 2), (3, 3), (32, 2)):
        stats = {}
        got = pipeline.check_batch_pipelined(
            model, _port(hs), cache=pipeline.EncodeCache(),
            chunk_keys=chunk_keys, depth=depth, stats=stats, device=CPU,
            search_stats=True)
        assert got == serial, (chunk_keys, depth)
        assert stats["n_keys"] == len(hs)
        assert sum(b["keys"] for b in stats["buckets"]) == len(hs)
        for b in stats["buckets"]:
            assert b["encode_secs"] >= 0
            assert b["engine"] == ENGINES[family]
            if b["engine"] == "bitdense":
                assert b["chunks"] == -(-b["keys"] // chunk_keys)
                assert b["device_secs"] is None     # not on a card
            else:
                assert b["chunks"] == 1 and b["search_secs"] >= 0
    assert _strip(got) == _strip(want)


def test_exact_buckets_and_the_flag(monkeypatch):
    name, hs = _registers()
    model = models.CASRegister()
    serial = engine.check_batch(model, _port(hs), device=CPU, bucket="exact")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PIPELINE", "1")
    stats = {}
    got = engine.check_batch(model, _port(hs), device=CPU, bucket="exact",
                             pipeline_stats=stats,
                             cache=pipeline.EncodeCache())
    assert got == serial and stats["bucket"] == "exact"
    assert len(stats["buckets"]) == len({max(5, e) for e in (
        engine.enc_mod.encode(model, h).n_slots for h in _port(hs))})
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PIPELINE", "yes")
    with pytest.raises(ValueError, match="JEPSEN_TPU_TORCH_PIPELINE"):
        engine.check_batch(model, _port(hs), device=CPU)


def test_empty_batch():
    stats = {}
    assert pipeline.check_batch_pipelined(models.CASRegister(), [],
                                          stats=stats, device=CPU) == []
    assert stats["n_keys"] == 0 and stats["buckets"] == []


def test_independent_with_the_pipeline():
    name, hs = _registers()
    keyed = []
    for k, h in enumerate(hs[:4]):
        for o in h:
            o2 = dict(o)
            if isinstance(o2.get("process"), int):
                o2["value"] = independent.KV(k, o2.get("value"))
            keyed.append(o2)
    c = Linearizable(models.CASRegister(), device=CPU)
    want = independent.checker(c).check({}, History.wrap(keyed))
    got = independent.checker(c, pipeline=True).check({},
                                                      History.wrap(keyed))
    assert got == want and got["results"]
    assert got["valid?"] is False and got["failures"] == [2]


def test_cache_hits_and_zero_re_encodes():
    name, hs = _registers()
    cache = pipeline.EncodeCache()
    first, second = {}, {}
    a = pipeline.check_batch_pipelined(models.CASRegister(), _port(hs),
                                       cache=cache, stats=first, device=CPU)
    b = pipeline.check_batch_pipelined(models.CASRegister(), _port(hs),
                                       cache=cache, stats=second, device=CPU)
    assert a == b
    assert first["cache"] == {"hits": 0, "disk_hits": 0, "misses": 7,
                              "encodes": 7, "entries": 7}
    assert second["cache"] == {"hits": 7, "disk_hits": 0, "misses": 0,
                               "encodes": 0, "entries": 7}
    # cache=False: no cache, no counters
    off = {}
    pipeline.check_batch_pipelined(models.CASRegister(), _port(hs),
                                   cache=False, stats=off, device=CPU)
    assert "cache" not in off


def test_cache_bounds_and_mutation_guard():
    model = models.CASRegister()
    name, hs = _registers()
    ph = _port(hs)
    encs = [engine.enc_mod.encode(model, h) for h in ph]
    keys = [pipeline.encode_cache_key(model, h) for h in ph]
    assert len(set(keys)) == len(keys)
    lru = pipeline.EncodeCache(max_entries=2)
    for k, e in zip(keys[:3], encs[:3]):
        lru.put(k, e)
    assert lru.get(keys[0]) is None and lru.get(keys[2]) is encs[2]
    assert lru.counters()["entries"] == 2
    one = pipeline.EncodeCache._entry_bytes(encs[0])
    small = pipeline.EncodeCache(max_bytes=one + 1)
    small.put(keys[0], encs[0])
    small.put(keys[1], encs[1])
    assert small.counters()["entries"] == 1 and small.get(keys[1])
    # a history mutated in place gets a new key: a miss, not a stale hit
    h = copy.deepcopy(ph[0])
    cache = pipeline.EncodeCache()
    e0 = pipeline.encode_cached(model, h, cache)
    for o in h:
        if o.get("type") == "ok" and o.get("f") == "read":
            o["value"] = 99
            break
    e1 = pipeline.encode_cached(model, h, cache)
    assert e1 is not e0 and cache.counters()["encodes"] == 2
    assert pipeline.encode_cached(model, h, cache) is e1
    # a cache that is off keeps nothing
    off = pipeline.EncodeCache(max_entries=0)
    pipeline.encode_cached(model, h, off)
    assert off.counters()["entries"] == 0
    with pytest.raises(ValueError, match="max_entries"):
        pipeline.EncodeCache(max_entries=-1)


@pytest.mark.parametrize("name", ["CASRegister", "GSet", "UnorderedQueue"])
def test_store_dir_round_trip(name, tmp_path):
    """Entries written by one cache load in another on the same
    directory, with the prepared spec rebuilt: the same encode, and the
    same result on the device engine."""
    gen = {"CASRegister": _registers, "GSet": _sets,
           "UnorderedQueue": _queues}[name]
    _, hs = gen()
    model = getattr(models, name)()
    h = _port(hs)[0]
    a = pipeline.EncodeCache(store_dir=str(tmp_path))
    e0 = pipeline.encode_cached(model, h, a)
    b = pipeline.EncodeCache(store_dir=str(tmp_path))
    e1 = pipeline.encode_cached(model, h, b)
    assert b.counters()["disk_hits"] == 1 and b.counters()["encodes"] == 0
    assert engine.history_digest(e1) == engine.history_digest(e0)
    assert e1.spec is not None and e1.n_states == e0.n_states
    r0 = engine.analysis(model, h, device=CPU)
    r1 = engine.analysis(model, h, device=CPU, encode_cache=b)
    assert r1 == r0


def test_analysis_encode_cache():
    name, hs = _queues()
    model = models.UnorderedQueue()
    h = _port(hs)[3]
    cache = pipeline.EncodeCache()
    r0 = engine.analysis(model, h, device=CPU)
    r1 = engine.analysis(model, h, device=CPU, encode_cache=cache)
    r2 = engine.analysis(model, h, device=CPU, encode_cache=cache)
    assert r0 == r1 == r2
    assert cache.counters()["hits"] == 1 and cache.counters()["encodes"] == 1
    assert engine.analysis(model, h, device=CPU, encode_cache=True) == r0


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"steal": True},
                                {"reshard": True}, {"steal_stats": {}}])
def test_mesh_and_stealing_arguments_raise(kw):
    """The mesh and work-stealing arguments are ported: `steal`,
    `reshard` and `steal_stats` (with stealing) run and give the
    reference's pipelined results on the same keys — a dense and a
    sparse bucket — and the scheduler's accounting; a `mesh` that is not
    a torch.distributed DeviceMesh raises TypeError (the mesh runs are
    tests/test_torch_mesh_batch.py's)."""
    if "mesh" in kw:
        with pytest.raises(TypeError, match="DeviceMesh"):
            pipeline.check_batch_pipelined(models.CASRegister(), [],
                                           device=CPU, **kw)
        return
    stats = "steal_stats" in kw
    for family in (_registers, _queues):
        name, hs = family()
        if stats:
            kw = {"steal": True, "steal_stats": {}}
        ref_kw = {k: ({} if k == "steal_stats" else v)
                  for k, v in kw.items()}
        want = ref_pipeline.check_batch_pipelined(
            getattr(ref_models, name)(), hs, cache=False, dedupe="hash",
            **ref_kw)
        got = pipeline.check_batch_pipelined(
            getattr(models, name)(), _port(hs), cache=False, device=CPU,
            dedupe="hash", **kw)
        assert _strip(got) == _strip(want)
        if stats:
            keys = ("tier", "engine", "keys", "rounds", "steals",
                    "per_device_cost", "cohort_pred")
            assert [{k: b.get(k) for k in keys}
                    for b in kw["steal_stats"]["buckets"]] == \
                [{k: b.get(k) for k in keys}
                 for b in ref_kw["steal_stats"]["buckets"]]


def test_serial_path_refuses_pipeline_arguments():
    h = _port(_registers()[1])[:1]
    with pytest.raises(ValueError, match="pipelined-executor"):
        engine.check_batch(models.CASRegister(), h, device=CPU,
                           cache=pipeline.EncodeCache())
    with pytest.raises(ValueError, match="pipelined-executor"):
        engine.check_batch(models.CASRegister(), h, device=CPU,
                           pipeline=False, pipeline_stats={})
    # cache=False asks for nothing, and the serial path gives it
    assert engine.check_batch(models.CASRegister(), h, device=CPU,
                              cache=False)
    with pytest.raises(ValueError, match="depth"):
        pipeline.check_batch_pipelined(models.CASRegister(), h, depth=0,
                                       device=CPU)
