"""Packed configuration rows (config_pack) in the port's per-key sparse
batch and its sharded engine, against the reference's config_pack=True
results on the same encoded input.

The batch: its one packed layout is `pack_spec_for` of every key at the
batch's first (widest) C and stays fixed; each retry tier re-pads C to
its pending keys, so a tier's lanes follow its own C (two lanes at the
first tier of these keys, one at the later ones), while every key's tag
names the batch's C. A key past the ceiling escalates to the single-key
engine with the request, and its own layout decides. Dense buckets
ignore the request. `engine.check_batch`, the port's `Linearizable` and
`independent` forward it.

The sharded engine at D = 1, 2 and 4 ranks (D = 1 in this process, 2 and
4 as spawned gloo ranks) against the reference's on 1, 2 and 4 virtual
CPU devices: a packed row crosses the owner exchange as its one or two
lanes and its live flag. The ranks import nothing of JAX: this module
imports the reference only inside the functions that run it.
"""

import dataclasses
import multiprocessing as mp
import os
import queue
import tempfile
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from jepsen_tpu_torch import models
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import engine, meshplan, sharded, sparse
from torch_jax_cache import release_compiled_programs  # noqa: F401

GROUP_TIMEOUT_S = 240
RANKS = (1, 2, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parts(e) -> tuple:
    """A reference EncodedHistory as the plain data `encoded_from_arrays`
    takes."""
    arrays = {k: np.asarray(getattr(e, k)) for k in enc.ARRAY_FIELDS}
    calls = [dataclasses.asdict(c) for c in e.calls]
    meta = {k: getattr(e, k) for k in ("state0", "step_name", "n_calls",
                                       "n_slots", "state_lo", "n_states",
                                       "model_pruned")}
    meta["intern"] = list(e.intern._values)
    return arrays, calls, meta


def _strip(r: dict) -> dict:
    return {k: v for k, v in r.items() if k != "closure"}


# ---------------------------------------------------------------- batch

def _gset_keys():
    """(reference encodings, port encodings) of six set keys: a
    30-element one (27 state bits and 6 slots: 33 bits, two lanes at the
    batch's C) and five of 14 elements and 4-5 slots."""
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.parallel import encode as ref_enc
    hs = [ref_histories.rand_gset_history(n_ops=44, n_processes=6,
                                          n_elements=30, crash_p=0.05,
                                          seed=45)]
    hs += [ref_histories.rand_gset_history(n_ops=30, n_processes=4,
                                           n_elements=14, crash_p=0.1,
                                           seed=s)
           for s in (50, 52, 54, 57, 59)]
    hs.append(ref_histories.corrupt_history(hs[1], seed=3))
    ref = [ref_enc.encode(ref_models.GSet(), h) for h in hs]
    return ref, [enc.encoded_from_arrays(*_parts(e)) for e in ref]


class _Tiers:
    """Each `sparse._BatchScan` of a run: (N, K, C, lanes, pack)."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = sparse._BatchScan.__init__

        def init(sc, *a, **kw):
            real(sc, *a, **kw)
            self.seen.append((sc.N, sc.K, sc.C, sc.rep.lanes, sc.rep.pack))

        monkeypatch.setattr(sparse._BatchScan, "__init__", init)


def _port_batch(encs, max_capacity, dedupe, smem_budget=None):
    def escalate(e, n):
        return engine._escalate_overflow(e, n, device="cpu", dedupe=dedupe,
                                         smem_budget=smem_budget,
                                         config_pack=True)
    return sparse.check_batch_sparse(encs, 64, max_capacity, dedupe, "cpu",
                                     smem_budget, escalate=escalate,
                                     probe_limit=2, config_pack=True)


def _ref_batch(ref, max_capacity, dedupe):
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.parallel import engine as ref_engine
    return ref_engine._check_batch_sparse(
        ref_models.GSet(), ref, 64, max_capacity, dedupe=dedupe,
        probe_limit=2, config_pack=True)


ROUTES = {"fused": ("hash", None, "torch"),
          "tiled": ("hash", 1, "torch-tiled"),
          "sort": ("sort", None, "torch")}


@pytest.mark.parametrize("route", list(ROUTES))
def test_batch_layout_is_fixed_at_the_first_C(route, monkeypatch):
    """probe_limit 2 sends keys up the capacity tiers: the first tier pads
    to C = 6 (33 bits, two lanes), the later ones to their pending keys'
    C = 5 (32 bits, one lane), on the one layout (27, 0); every key is
    tagged with the batch's 33 bits and two lanes, and equals the
    reference's packed result."""
    dedupe, budget, tag = ROUTES[route]
    ref, encs = _gset_keys()
    tiers = _Tiers(monkeypatch)
    got = _port_batch(encs, 1 << 12, dedupe, budget)
    want = _ref_batch(ref, 1 << 12, dedupe)
    assert [_strip(r) for r in got] == [_strip(r) for r in want]
    assert {r["closure"] for r in got} == {tag}
    assert {r["config-pack"] for r in got} == {"packed:33b/2-lane"}
    assert {t[4] for t in tiers.seen} == {(27, 0)}
    if dedupe == "hash":
        assert [t[2:4] for t in tiers.seen][:2] == [(6, 2), (5, 1)]


def test_batch_escalation_carries_the_request():
    """Past max_capacity 128 the hot keys go to the single-key engine with
    the request: their own layout (and C) decides their tag."""
    ref, encs = _gset_keys()
    got = _port_batch(encs, 128, "hash")
    want = _ref_batch(ref, 128, "hash")
    assert [_strip(r) for r in got] == [_strip(r) for r in want]
    esc = [r for r in got if r.get("escalated") == "single"]
    assert esc and all(r["config-pack"].startswith("packed:") for r in esc)


def test_dense_buckets_ignore_the_request():
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.parallel import encode as ref_enc
    from jepsen_tpu.parallel import engine as ref_engine
    hs = [ref_histories.rand_register_history(n_ops=30, n_processes=4,
                                              seed=s) for s in (1, 2)]
    ref = [ref_enc.encode(ref_models.CASRegister(), h) for h in hs]
    encs = [enc.encoded_from_arrays(*_parts(e)) for e in ref]
    want = ref_engine.check_batch_encoded(ref_models.CASRegister(), ref,
                                          config_pack=True)
    got = engine.check_batch_encoded(models.CASRegister(), encs,
                                     device="cpu", config_pack=True)
    assert all(r["dedupe"] == "dense" and "config-pack" not in r
               for r in got)
    assert [_strip(r) for r in got] == [_strip(r) for r in want]


def test_check_batch_linearizable_and_independent_forward_it(monkeypatch):
    from jepsen_tpu_torch import histories, independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.history import History
    hs = [histories.rand_queue_history(26, n_processes=4, n_values=3,
                                       crash_p=0.06, seed=s)
          for s in (34, 35)]
    model = models.UnorderedQueue()
    plain = engine.check_batch(model, hs, device="cpu", capacity=64)
    rs = engine.check_batch(model, hs, device="cpu", capacity=64,
                            config_pack=True)
    assert all("config-pack" not in r for r in plain)
    assert all(r["config-pack"].startswith("packed:") for r in rs)
    assert [{k: v for k, v in r.items() if k != "config-pack"}
            for r in rs] == plain
    r = linearizable(model, device="cpu", config_pack=True).check({}, hs[0])
    assert r["config-pack"] == rs[0]["config-pack"]
    ops = []
    for k, h in enumerate(hs):
        for o in h:
            o = dict(o)
            o["value"] = independent.KV(k, o.get("value"))
            ops.append(o)
    out = independent.checker(linearizable(
        model, device="cpu", config_pack=True)).check(
        {}, History.wrap(ops).index())
    assert [out["results"][k]["config-pack"] for k in (0, 1)] == \
        [r["config-pack"] for r in rs]
    monkeypatch.setenv("JEPSEN_TPU_TORCH_CONFIG_PACK", "bad")
    with pytest.raises(ValueError, match="CONFIG_PACK"):
        engine.check_batch(model, [], device="cpu")


# -------------------------------------------------------------- sharded

# id -> (history spec, keyword arguments of both packages)
CASES = {
    "register-77-clean": (("register", 77, None),
                          {"capacity": 512, "dedupe": "hash"}),
    "register-77-corrupt": (("register", 77, 0),
                            {"capacity": 512, "dedupe": "hash"}),
    "register-77-gather": (("register", 77, None),
                           {"capacity": 512, "dedupe": "hash",
                            "exchange": "gather"}),
    "register-81-sort": (("register", 81, 4),
                         {"capacity": 512, "dedupe": "sort"}),
    "wide-8-grows": (("wide", 8, 3), {"capacity": 256, "dedupe": "hash"}),
    "gset30-two-lane": (("gset30",), {"capacity": 256, "dedupe": "hash"}),
}


def _ref_encoded(spec):
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import encode as ref_enc
    if spec[0] == "register":
        h = ref_histories.rand_register_history(
            n_ops=60, n_processes=5, crash_p=0.06, fail_p=0.06, seed=spec[1])
        if spec[2] is not None:
            h = ref_histories.corrupt_history(h, seed=spec[2])
        return ref_enc.encode(ref_models.CASRegister(), h)
    if spec[0] == "wide":
        n, v = spec[1], spec[2]
        ops = [{"type": "invoke", "process": i, "f": "write", "value": i}
               for i in range(1, n + 1)]
        ops += [{"type": "info", "process": i, "f": "write", "value": i}
                for i in range(1, n + 1)]
        ops += [{"type": "invoke", "process": 0, "f": "read", "value": None},
                {"type": "ok", "process": 0, "f": "read", "value": v}]
        return ref_enc.encode(ref_models.CASRegister(),
                              RefHistory.wrap(ops).index())
    h = ref_histories.rand_gset_history(n_ops=44, n_processes=6,
                                        n_elements=30, crash_p=0.05, seed=45)
    return ref_enc.encode(ref_models.GSet(), h)


def _port_case(mesh, cid: str, payload):
    return sharded.check_encoded_sharded(
        enc.encoded_from_arrays(*payload), mesh, config_pack=True,
        **CASES[cid][1])


def _ref_case(D: int, cid: str) -> dict:
    import jax
    from jax.sharding import Mesh
    from jepsen_tpu.parallel import sharded as ref_sharded
    spec, kw = CASES[cid]
    mesh = Mesh(np.array(jax.devices()[:D]), ("frontier",))
    return ref_sharded.check_encoded_sharded(_ref_encoded(spec), mesh,
                                             config_pack=True, **kw)


def _rank_main(rank: int, D: int, store: str, payloads: dict, out) -> None:
    """One spawned gloo rank: run every case on the D-rank mesh."""
    try:
        from torch.distributed.device_mesh import init_device_mesh
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, D),
                                rank=rank, world_size=D)
        mesh = init_device_mesh("cpu", (D,), mesh_dim_names=("frontier",))
        res = {cid: _port_case(mesh, cid, p) for cid, p in payloads.items()}
        dist.destroy_process_group()
        out.put((rank, res, None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))


class _Group:
    """D spawned ranks running every case; `results()` waits for them."""

    def __init__(self, D: int, payloads: dict):
        ctx = mp.get_context("spawn")
        self.dir = tempfile.TemporaryDirectory()
        self.out = ctx.Queue()
        store = os.path.join(self.dir.name, "store")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, D, store, payloads, self.out),
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


_RESULTS: dict = {}


def _results(D: int):
    """(port results per rank, reference results) of every case at D: the
    groups of 2 and 4 ranks run while this process runs one rank and the
    reference at every D."""
    if not _RESULTS:
        payloads = {cid: _parts(_ref_encoded(spec))
                    for cid, (spec, _) in CASES.items()}
        groups = {d: _Group(d, payloads) for d in RANKS if d > 1}
        mesh = meshplan.local_mesh("cpu")
        ranks = {1: [{cid: _port_case(mesh, cid, p)
                      for cid, p in payloads.items()}]}
        with ThreadPoolExecutor(len(RANKS)) as pool:
            ref = dict(zip(RANKS, pool.map(
                lambda d: {cid: _ref_case(d, cid) for cid in CASES},
                RANKS)))
        ranks.update((d, g.results()) for d, g in groups.items())
        _RESULTS.update((d, (ranks[d], ref[d])) for d in RANKS)
    return _RESULTS[D]


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("cid", list(CASES))
def test_packed_sharded_matches_the_reference(cid, D):
    ranks, ref = _results(D)
    want, got = ref[cid], ranks[0][cid]
    assert all(r[cid] == got for r in ranks[1:]), "ranks disagree"
    assert _strip(got) == _strip(want)
    assert got["devices"] == D and got["closure"] == "torch"
    lanes = "2-lane" if cid == "gset30-two-lane" else "1-lane"
    assert got["config-pack"].endswith(lanes)
