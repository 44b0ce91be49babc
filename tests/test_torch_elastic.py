"""The port's work-stealing executor (jepsen_tpu_torch.parallel.elastic)
against the reference's (jepsen_tpu.parallel.elastic).

  * `KeyScheduler`: the placement of every round and `stats()` after
    every `observe` equal the reference's scheduler's on the same cost
    sequences (hypothesis-drawn), and `key_cost` the reference's.
  * Steal parity (the reference's test_steal_parity_* cases): stealing
    on and off give the reference's static batch, key for key in
    `STEAL_PIN`, over the packable families clean and corrupted, both
    dedupes, a mutex-invalid batch packed and unpacked, and the forced
    skew's per-key capacity ladder — at one rank (this process) and two
    (spawned gloo ranks); at two ranks the scheduler's accounting equals
    the reference's on two devices.
  * `check_batch(steal=True)`'s routing and its stats guard, the flags'
    resolution, and `steal_ab`'s two arms agreeing (no wall-clock
    assertion: a wall claim needs paired runs on the card).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

import torch_gloo
from jepsen_tpu_torch import envflags, histories, models
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import elastic, engine, meshplan
from jepsen_tpu_torch.parallel import encode as enc
from torch_jax_cache import release_compiled_programs  # noqa: F401

PIN = elastic.STEAL_PIN
SCHED_KEYS = ("rounds", "steals", "observed_keys", "per_device_cost",
              "per_device_busy", "busy_frac", "per_device_load_factor_peak",
              "load_factor_spread", "cohort_pred")
# (name, model class name, generator name, its keyword arguments): the
# reference's FAMILIES
FAMILIES = [
    ("cas-register", "CASRegister", "rand_register_history",
     {"n_ops": 40, "n_processes": 5, "n_values": 3, "crash_p": 0.06,
      "fail_p": 0.08, "seed": 31}),
    ("gset", "GSet", "rand_gset_history",
     {"n_ops": 36, "n_processes": 4, "n_elements": 9, "crash_p": 0.06,
      "seed": 33}),
    ("uqueue", "UnorderedQueue", "rand_queue_history",
     {"n_ops": 26, "n_processes": 4, "n_values": 3, "crash_p": 0.06,
      "seed": 34}),
    ("fifo", "FIFOQueue", "rand_fifo_history",
     {"n_ops": 24, "n_processes": 4, "n_values": 3, "crash_p": 0.05,
      "seed": 35}),
]
DEDUPES = ("sort", "hash")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pin(r: dict) -> dict:
    return {k: r.get(k) for k in PIN}


# -------------------------------------------------------------- scheduler

def _drive(Sched, n_keys, n_dev, round_keys, steal, costs) -> list:
    """Every round's placement and the stats after every observe of a
    scheduler fed `costs` (one entry per key, None for no signal)."""
    s = Sched(list(range(n_keys)), n_dev=n_dev, round_keys=round_keys,
              steal=steal)
    trail = []
    while True:
        p = s.next_round()
        if p is None:
            break
        s.observe({i: costs[i] for i, _d in p}, p,
                  lf={i: (None if costs[i] is None else costs[i] / 1e4)
                      for i, _d in p})
        trail.append((p, s.stats()))
    return trail


@settings(max_examples=60, deadline=None)
@given(n_keys=hs.integers(0, 24), n_dev=hs.integers(1, 5),
       round_keys=hs.integers(1, 3), steal=hs.booleans(),
       data=hs.data())
def test_scheduler_matches_reference(n_keys, n_dev, round_keys, steal,
                                     data):
    from jepsen_tpu.parallel.elastic import KeyScheduler as RefSched
    costs = data.draw(hs.lists(
        hs.one_of(hs.none(), hs.floats(0, 1e6, allow_nan=False)),
        min_size=n_keys, max_size=n_keys))
    assert _drive(elastic.KeyScheduler, n_keys, n_dev, round_keys, steal,
                  costs) == _drive(RefSched, n_keys, n_dev, round_keys,
                                   steal, costs)


def test_key_cost_matches_reference():
    from jepsen_tpu.parallel import elastic as ref_elastic
    results = [
        {"capacity": 64, "configs-stepped": 10},
        {"capacity": 256, "configs-stepped": 10},
        {"capacity": 64, "configs-stepped": 10,
         "stats": {"closure-iters": [2, 3]}},
        {"valid?": True},
        {"capacity": 96, "stats": {"events": 7}},
        {"capacity": 0, "configs-stepped": 3},
        "not a dict",
    ]
    for base in (0, 32, 64):
        assert [elastic.key_cost(r, base) for r in results] \
            == [ref_elastic.key_cost(r, base) for r in results]
    assert elastic.key_cost(results[1], 64) == 3 * 256 + 10


# ----------------------------------------------------------------- parity

def _family_encs(pkg_histories, pkg_models, pkg_enc, fam) -> list:
    """The family's clean and corrupted histories, encoded (those that
    encode), eight keys as the reference's test makes them."""
    _, model_name, gen, kw = fam
    model = getattr(pkg_models, model_name)()
    h = getattr(pkg_histories, gen)(**kw)
    pres = []
    for variant in (h, pkg_histories.corrupt_history(h, seed=7,
                                                     n_corruptions=2)):
        try:
            pres.append(pkg_enc.encode(model, variant))
        except pkg_enc.EncodeError:
            continue
    return (pres * 8)[:8]


def _mutex_history(History_):
    return History_.wrap([
        {"type": "invoke", "process": 0, "f": "acquire", "value": None},
        {"type": "ok", "process": 0, "f": "acquire", "value": None},
        {"type": "invoke", "process": 1, "f": "acquire", "value": None},
        {"type": "ok", "process": 1, "f": "acquire", "value": None},
    ]).index()


def _encs(spec, pkg_histories, pkg_models, pkg_enc, History_,
          pkg_elastic) -> tuple:
    """(model, encoded keys) of a case's spec in one package: ("family",
    index), ("mutex",) or ("skew",)."""
    if spec[0] == "family":
        fam = FAMILIES[spec[1]]
        return (getattr(pkg_models, fam[1])(),
                _family_encs(pkg_histories, pkg_models, pkg_enc, fam))
    if spec[0] == "mutex":
        model = pkg_models.Mutex()
        return model, [pkg_enc.encode(model, _mutex_history(History_))] * 8
    model, hs_ = pkg_elastic.forced_skew_histories(n_heavy=2, n_light=6)
    return model, [pkg_enc.encode(model, h) for h in hs_]


def _cases() -> dict:
    """id -> (spec, keyword arguments of both packages)."""
    out = {}
    for j, fam in enumerate(FAMILIES):
        for d in DEDUPES:
            out[f"{fam[0]}-{d}"] = (("family", j),
                                    {"capacity": 128, "dedupe": d})
    for pack in (False, True):
        out[f"mutex-{'packed' if pack else 'unpacked'}"] = (
            ("mutex",), {"capacity": 64, "config_pack": pack,
                         "dedupe": "hash"})
    out["skew-ladder"] = (("skew",), {"capacity": elastic.SKEW_CAPACITY,
                                      "max_capacity": 1 << 16,
                                      "dedupe": "hash"})
    return out


def _run_case(mesh, case) -> dict:
    spec, kw = case
    model, pre = _encs(spec, histories, models, enc, History, elastic)
    out = {}
    for steal in (True, False):
        st: dict = {}
        rs = elastic.check_batch_stealing(model, pre, mesh=mesh,
                                          steal=steal, stats=st, **kw)
        out[steal] = ([_pin(r) for r in rs], st["buckets"])
    return out


def _rank(rank: int, D: int, cases) -> dict:
    mesh = meshplan.local_mesh("cpu") if D == 1 else torch_gloo.mesh((D,))
    return {cid: _run_case(mesh, case) for cid, case in cases.items()}


def _ref(case):
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import elastic as ref_elastic
    from jepsen_tpu.parallel import encode as ref_enc
    return _encs(case[0], ref_histories, ref_models, ref_enc, RefHistory,
                 ref_elastic)


def _ref_static(case) -> list:
    """The reference's static batch (check_batch_encoded) of a case."""
    from jepsen_tpu.parallel import engine as ref_engine
    model, pre = _ref(case)
    return [_pin(r) for r in
            ref_engine.check_batch_encoded(model, pre, **case[1])]


def _ref_two_device_stats(case) -> list:
    import jax
    from jax.sharding import Mesh
    from jepsen_tpu.parallel import elastic as ref_elastic
    model, pre = _ref(case)
    st: dict = {}
    ref_elastic.check_batch_stealing(
        model, pre, mesh=Mesh(np.array(jax.devices()[:2]), ("key",)),
        stats=st, **case[1])
    return st["buckets"]


def _compute() -> dict:
    cases = _cases()
    g2 = torch_gloo.Group(2, _rank, (2, cases))
    port = {1: [_rank(0, 1, cases)]}
    ref = {cid: _ref_static(c) for cid, c in cases.items()}
    ref_stats = _ref_two_device_stats(cases["skew-ladder"])
    port[2] = g2.results()
    return {"port": port, "ref": ref, "ref_stats": ref_stats}


_RESULTS: dict = {}


def _results() -> dict:
    if not _RESULTS:
        _RESULTS.update(torch_gloo.shared("elastic", _compute))
    return _RESULTS


@pytest.mark.parametrize("D", (1, 2))
@pytest.mark.parametrize("cid", [f"{f[0]}-{d}" for f in FAMILIES
                                 for d in DEDUPES])
def test_steal_parity_clean_and_corrupted(cid, D):
    res = _results()
    ranks = [r[cid] for r in res["port"][D]]
    assert all(r == ranks[0] for r in ranks[1:]), "ranks disagree"
    want = res["ref"][cid]
    assert ranks[0][True][0] == want
    assert ranks[0][False][0] == want
    assert ranks[0][False][1][0]["steals"] == 0


@pytest.mark.parametrize("D", (1, 2))
@pytest.mark.parametrize("pack", ("unpacked", "packed"))
def test_steal_parity_mutex_invalid_and_packed(pack, D):
    res = _results()
    got = res["port"][D][0][f"mutex-{pack}"]
    assert got[True][0] == got[False][0] == res["ref"][f"mutex-{pack}"]
    assert got[True][0][0]["valid?"] is False


@pytest.mark.parametrize("D", (1, 2))
def test_steal_capacity_ladder_parity_per_key(D):
    """Per-key capacities are placement-independent: a heavy key lands
    the same tier whether it shares its round with light keys or not;
    at two ranks the scheduler's accounting is the reference's on two
    devices."""
    res = _results()
    ranks = [r["skew-ladder"] for r in res["port"][D]]
    assert all(r == ranks[0] for r in ranks[1:])
    got = ranks[0][True]
    assert got[0] == res["ref"]["skew-ladder"]
    assert max(r["capacity"] for r in got[0]) > elastic.SKEW_CAPACITY
    assert got[1][0]["engine"] == "sparse"
    if D == 2:
        want = res["ref_stats"]
        assert [{k: b[k] for k in SCHED_KEYS} for b in got[1]] \
            == [{k: b[k] for k in SCHED_KEYS} for b in want]


def test_check_batch_steal_routing_and_stats_guard():
    model = models.CASRegister()
    hs_ = [histories.rand_register_history(n_ops=30, n_processes=4,
                                           n_values=3, crash_p=0.05,
                                           seed=40 + i) for i in range(8)]
    mesh = meshplan.local_mesh("cpu")
    ref = engine.check_batch(model, hs_, mesh=mesh)
    st: dict = {}
    got = engine.check_batch(model, hs_, mesh=mesh, steal=True,
                             steal_stats=st)
    assert [_pin(r) for r in got] == [_pin(r) for r in ref]
    assert st["steal"] is True and st["buckets"]
    # the loud-misuse contract, on both routes
    with pytest.raises(ValueError, match="steal_stats"):
        engine.check_batch(model, hs_, device="cpu", steal_stats={})
    with pytest.raises(ValueError, match="steal_stats"):
        engine.check_batch(model, hs_, device="cpu", pipeline=True,
                           cache=False, steal_stats={})
    ragged = hs_[:5]
    ref_r = engine.check_batch(model, ragged, mesh=mesh)
    got_r = engine.check_batch(model, ragged, mesh=mesh, steal=True)
    assert [_pin(r) for r in got_r] == [_pin(r) for r in ref_r]


def test_steal_env_flag_resolution(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_TORCH_STEAL", raising=False)
    assert engine._resolve_steal(None) is False
    monkeypatch.setenv("JEPSEN_TPU_TORCH_STEAL", "1")
    assert engine._resolve_steal(None) is True
    assert engine._resolve_steal(False) is False   # the argument wins
    monkeypatch.setenv("JEPSEN_TPU_TORCH_STEAL", "yes")
    with pytest.raises(envflags.EnvFlagError):
        engine._resolve_steal(None)
    monkeypatch.delenv("JEPSEN_TPU_TORCH_STEAL", raising=False)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_RESHARD", "2")
    with pytest.raises(envflags.EnvFlagError):
        engine._resolve_reshard(None)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_RESHARD", "1")
    assert engine._resolve_reshard(None) is True
    monkeypatch.delenv("JEPSEN_TPU_TORCH_RESHARD", raising=False)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_STEAL_ROUND", "0")
    with pytest.raises(envflags.EnvFlagError):
        elastic._resolve_round_keys(0)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_STEAL_ROUND", "3")
    assert elastic._resolve_round_keys(0) == 3
    assert elastic._resolve_round_keys(5) == 5   # explicit arg wins
    assert "JEPSEN_TPU_TORCH_STEAL_ROUND" in envflags.MESH_FLAGS


def test_steal_ab_arms_agree():
    model, hs_ = elastic.forced_skew_histories(n_heavy=2, n_light=6)
    pre = [enc.encode(model, h) for h in hs_]
    ab = elastic.steal_ab(model, pre, meshplan.local_mesh("cpu"),
                          warm=False)
    assert ab["verdicts_identical"] is True
    assert ab["static"][0]["steals"] == 0
    assert set(ab) >= {"static_secs", "steal_secs", "steal_speedup"}
