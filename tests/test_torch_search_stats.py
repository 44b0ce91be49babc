"""The search-stats block (JEPSEN_TPU_TORCH_SEARCH_STATS) against the
reference's (JEPSEN_TPU_SEARCH_STATS) on the CPU, field for field: the
dense engine single and batched (`closure-iters` from the plain
closure's counted double expansions, as the reference's counted
`xla-while` closure), the sparse engine's sort, hash (K2's plain
version) and tiled (K4's) routes, packed rows, the sparse batch with its
pad extras, the escalation, the truncation at SEARCH_STATS_MAX_EVENTS,
the flag's validation, and — with stats off — results with no "stats"
key, equal to the stats-on results in every other field."""

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker.linearizable import Linearizable
from jepsen_tpu_torch.parallel import encode, engine, search_stats, sparse
from torch_jax_cache import release_compiled_programs  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(gen: str, model: str, **kw):
    """(reference model, reference history, port model, port history)
    from the same generator and seed."""
    return (getattr(ref_models, model)(), getattr(ref_histories, gen)(**kw),
            getattr(models, model)(), getattr(histories, gen)(**kw))


def _corrupt(pair, seed=0):
    rm, rh, pm, ph = pair
    return (rm, ref_histories.corrupt_history(rh, seed=seed), pm,
            histories.corrupt_history(ph, seed=seed))


DENSE = {
    "register-80": ("rand_register_history", "CASRegister",
                    {"n_ops": 80, "n_processes": 5, "crash_p": 0.05,
                     "fail_p": 0.05, "seed": 3}),
    "register-200": ("rand_register_history", "CASRegister",
                     {"n_ops": 200, "n_processes": 6, "crash_p": 0.02,
                      "seed": 9}),
    "adversarial-120-k6": ("adversarial_register_history", "CASRegister",
                           {"n_ops": 120, "k_crashed": 6}),
}
SPARSE = {
    "uqueue-80": ("rand_queue_history", "UnorderedQueue",
                  {"n_ops": 80, "n_processes": 6, "crash_p": 0.02,
                   "seed": 5}),
    "fifo-80": ("rand_fifo_history", "FIFOQueue",
                {"n_ops": 80, "n_processes": 5, "crash_p": 0.02, "seed": 7}),
    "gset-60": ("rand_gset_history", "GSet",
                {"n_ops": 60, "n_processes": 6, "n_elements": 8,
                 "crash_p": 0.02, "seed": 2}),
}


@pytest.mark.parametrize("name", sorted(DENSE))
@pytest.mark.parametrize("corrupt", [False, True])
def test_dense_block_matches_the_reference(name, corrupt):
    gen, model, kw = DENSE[name]
    pair = _pair(gen, model, **kw)
    rm, rh, pm, ph = _corrupt(pair) if corrupt else pair
    want = ref_engine.analysis(rm, rh, search_stats=True)
    got = engine.analysis(pm, ph, device="cpu", search_stats=True)
    assert got["engine"] == want["engine"] == "bitdense"
    assert got["stats"] == want["stats"]
    assert any(i > 2 for i in got["stats"]["closure-iters"])


@pytest.mark.parametrize("name", sorted(SPARSE))
@pytest.mark.parametrize("route", ["sort", "hash", "tiled"])
def test_sparse_block_matches_the_reference(name, route):
    """Sort (swork = the stepped configurations, no histogram), hash
    (K2's plain version) and the tiled route (K4's plain version, the
    histogram bucketed from its offsets), from capacity 64 so that the
    tiers climb."""
    gen, model, kw = SPARSE[name]
    rm, rh, pm, ph = _pair(gen, model, **kw)
    dedupe = "sort" if route == "sort" else "hash"
    want = ref_engine.check_encoded(ref_enc.encode(rm, rh), capacity=64,
                                    dedupe=dedupe, search_stats=True)
    got = sparse.check_encoded(encode.encode(pm, ph), capacity=64,
                               dedupe=dedupe, device="cpu",
                               search_stats=True,
                               smem_budget=2048 if route == "tiled"
                               else None)
    assert got["closure"] == {"sort": "torch", "hash": "torch",
                              "tiled": "torch-tiled"}[route]
    assert got["stats"] == want["stats"]
    assert got["stats"]["engine"] == "sparse"


def test_capacity_tier_counts_the_doublings():
    rm, rh, pm, ph = _pair(*SPARSE["fifo-80"][:2], **SPARSE["fifo-80"][2])
    want = ref_engine.check_encoded(ref_enc.encode(rm, rh), capacity=8,
                                    dedupe="hash", search_stats=True)
    got = sparse.check_encoded(encode.encode(pm, ph), capacity=8,
                               dedupe="hash", device="cpu",
                               search_stats=True)
    assert got["stats"] == want["stats"]
    assert got["stats"]["capacity-tier"] >= 1


@pytest.mark.parametrize("name", ["uqueue-80", "gset-60"])
def test_packed_rows_block_matches_the_reference(name):
    gen, model, kw = SPARSE[name]
    rm, rh, pm, ph = _pair(gen, model, **kw)
    want = ref_engine.analysis(rm, rh, dedupe="hash", config_pack=True,
                               search_stats=True)
    got = engine.analysis(pm, ph, device="cpu", dedupe="hash",
                          config_pack=True, search_stats=True)
    assert got["config-pack"] == want["config-pack"]
    assert got["stats"] == want["stats"]


def test_invalid_sparse_check_keeps_its_block():
    rm, rh, pm, ph = _corrupt(_pair(*SPARSE["uqueue-80"][:2],
                                    **SPARSE["uqueue-80"][2]), seed=1)
    want = ref_engine.analysis(rm, rh, dedupe="hash", search_stats=True)
    got = engine.analysis(pm, ph, device="cpu", dedupe="hash",
                          search_stats=True)
    assert got["valid?"] is False
    assert got["stats"] == want["stats"]


def _dense_keys(n=4):
    pairs = [_pair("rand_register_history", "CASRegister", n_ops=40,
                   n_processes=5, crash_p=0.03, fail_p=0.05, seed=s)
             for s in range(n)]
    pairs.append(_corrupt(pairs[1], seed=2))
    return pairs


def test_dense_batch_blocks_with_pad_extras():
    pairs = _dense_keys()
    rm, pm = pairs[0][0], pairs[0][2]
    want = ref_engine.check_batch_encoded(
        rm, [ref_enc.encode(rm, p[1]) for p in pairs], search_stats=True)
    got = engine.check_batch(pm, [p[3] for p in pairs], device="cpu",
                             search_stats=True)
    assert [g["stats"] for g in got] == [w["stats"] for w in want]
    assert any(g["stats"]["pad-events"] > 0 for g in got)


def _queue_keys():
    pairs = [_pair("rand_queue_history", "UnorderedQueue", n_ops=40,
                   n_processes=6, crash_p=0.02, seed=s) for s in range(4)]
    pairs.append(_corrupt(pairs[0], seed=1))
    return pairs


@pytest.mark.parametrize("route", ["sort", "hash", "tiled"])
def test_sparse_batch_blocks_with_pad_extras(route):
    pairs = _queue_keys()
    rm, pm = pairs[0][0], pairs[0][2]
    dedupe = "sort" if route == "sort" else "hash"
    want = ref_engine.check_batch_encoded(
        rm, [ref_enc.encode(rm, p[1]) for p in pairs], capacity=64,
        dedupe=dedupe, search_stats=True)
    got = engine._check_batch_sparse(
        [encode.encode(pm, p[3]) for p in pairs], 64, 1 << 18,
        dedupe=dedupe, device="cpu", search_stats=True,
        smem_budget=3000 if route == "tiled" else None)
    assert [g["stats"] for g in got] == [w["stats"] for w in want]
    assert any(g["stats"]["pad-waste"] > 0 for g in got)
    assert any(g["stats"]["capacity-tier"] > 0 for g in got)


def test_escalated_key_reports_the_single_rungs_block():
    pairs = _queue_keys()
    rm, pm = pairs[0][0], pairs[0][2]
    want = ref_engine.check_batch_encoded(
        rm, [ref_enc.encode(rm, p[1]) for p in pairs], capacity=64,
        max_capacity=64, dedupe="hash", search_stats=True)
    got = engine.check_batch(pm, [p[3] for p in pairs], capacity=64,
                             max_capacity=64, dedupe="hash", device="cpu",
                             search_stats=True)
    assert [g.get("escalated") for g in got] == \
        [w.get("escalated") for w in want]
    assert "single" in [g.get("escalated") for g in got]
    assert [g["stats"] for g in got] == [w["stats"] for w in want]


def _keyed(per_key: list, kv):
    """One history of per-key op lists, keys interleaved op by op, each
    key's processes its own, values wrapped with `kv`."""
    lists = [[dict(o, process=o["process"] + 100 * k,
                   value=kv(k, o.get("value"))) for o in ops
              if isinstance(o.get("process"), int)]
             for k, ops in enumerate(per_key)]
    out = []
    for j in range(max(map(len, lists))):
        out += [ops[j] for ops in lists if j < len(ops)]
    return out


def test_independent_gives_each_key_its_block():
    from jepsen_tpu import independent as ref_independent
    from jepsen_tpu_torch.history import History
    pairs = _queue_keys()
    ref_subs = ref_independent.split_history(ref_independent.kv_history(
        ref_histories.History.wrap(_keyed([p[1] for p in pairs],
                                          ref_independent.KV)).index()))
    rm = pairs[0][0]
    want = ref_engine.check_batch_encoded(
        rm, [ref_enc.encode(rm, ref_subs[k]) for k in ref_subs],
        dedupe="hash", search_stats=True)
    c = independent.checker(Linearizable(pairs[0][2], device="cpu",
                                         dedupe="hash", search_stats=True))
    got = c.check({}, History.wrap(_keyed([p[3] for p in pairs],
                                          independent.KV)).index())
    assert list(got["results"]) == list(ref_subs)
    assert [r["analyzer"] for r in got["results"].values()] == \
        ["torch"] * len(pairs)
    assert [r["stats"] for r in got["results"].values()] == \
        [w["stats"] for w in want]


def test_truncation_at_the_event_cap(monkeypatch):
    monkeypatch.setattr(ref_engine, "SEARCH_STATS_MAX_EVENTS", 7)
    monkeypatch.setattr(search_stats, "SEARCH_STATS_MAX_EVENTS", 7)
    rm, rh, pm, ph = _pair(*SPARSE["uqueue-80"][:2], **SPARSE["uqueue-80"][2])
    want = ref_engine.check_encoded(ref_enc.encode(rm, rh), capacity=64,
                                    dedupe="hash", search_stats=True)
    got = sparse.check_encoded(encode.encode(pm, ph), capacity=64,
                               dedupe="hash", device="cpu",
                               search_stats=True)
    assert got["stats"]["truncated"] is True
    assert got["stats"]["events"] == 7
    assert got["stats"] == want["stats"]


def test_search_stats_accumulator_edges():
    acc = search_stats.SearchStats("hash")
    empty = acc.block()
    assert empty["events"] == 0 and empty["frontier-peak"] == 0
    assert empty["peak-occupancy"] is None and empty["probes"] is None
    acc.add_chunk({"width": [3, -1, 2], "peak": [5, 0, 4],
                   "iters": [2, 0, 1], "stepped": [4, 0, 3],
                   "swork": [8, 0, 3], "phist": [[1] * 7, [0] * 7,
                                                 [2] * 7]}, 64)
    b = search_stats.block_of(acc, extra={"pad-waste": 0.5})
    assert b["engine"] == "sparse" and b["pad-waste"] == 0.5
    assert b["frontier-width"] == [3, 2] and b["probes"] == 21
    assert b["table-capacity"] == 128 and b["delta-split-ratio"] == 0.636364


def test_probe_hist_buckets():
    off = torch.tensor([0, 1, 2, 3, 4, 7, 8, 15, 16, 31, 32, 200])
    att = torch.ones(12, dtype=torch.bool)
    assert search_stats._probe_hist(off, att).tolist() == [1, 1, 2, 2, 2,
                                                           2, 2]
    att[0] = False
    assert search_stats._probe_hist(off, att).tolist()[0] == 0


@pytest.mark.parametrize("raw,want", [("", False), ("0", False),
                                      ("1", True), (" 1 ", True)])
def test_flag_values(monkeypatch, raw, want):
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SEARCH_STATS", raw)
    assert search_stats._resolve_search_stats(None) is want
    assert search_stats._resolve_search_stats(not want) is (not want)


@pytest.mark.parametrize("raw", ["yes", "true", "2", "on"])
def test_flag_validation(monkeypatch, raw):
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SEARCH_STATS", raw)
    with pytest.raises(ValueError, match="JEPSEN_TPU_TORCH_SEARCH_STATS"):
        search_stats._resolve_search_stats(None)
    with pytest.raises(ValueError):
        engine.check_batch(models.CASRegister(), [], device="cpu")


def test_env_flag_drives_the_result(monkeypatch):
    rm, rh, pm, ph = _pair(*DENSE["register-80"][:2], **DENSE["register-80"][2])
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SEARCH_STATS", "1")
    assert "stats" in engine.analysis(pm, ph, device="cpu")
    assert "stats" not in engine.analysis(pm, ph, device="cpu",
                                          search_stats=False)
    monkeypatch.delenv("JEPSEN_TPU_TORCH_SEARCH_STATS")
    assert "stats" not in engine.analysis(pm, ph, device="cpu")


@pytest.mark.parametrize("name", ["register-80", "uqueue-80"])
def test_stats_off_results_are_unchanged(name):
    gen, model, kw = {**DENSE, **SPARSE}[name]
    rm, rh, pm, ph = _corrupt(_pair(gen, model, **kw))
    off = Linearizable(pm, device="cpu").check({}, ph)
    on = Linearizable(pm, device="cpu", search_stats=True).check({}, ph)
    assert "stats" not in off
    assert {k: v for k, v in on.items() if k != "stats"} == off
    pairs = _queue_keys()
    rs = engine.check_batch(pairs[0][2], [p[3] for p in pairs],
                            device="cpu")
    assert all("stats" not in r for r in rs)
