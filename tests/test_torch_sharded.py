"""The port's frontier-sharded engine (jepsen_tpu_torch.parallel.sharded,
on the CPU with the plain insert) against the reference's
(jepsen_tpu.parallel.sharded) at D = 1, 2 and 4 ranks.

The port runs D = 1 in this process on `meshplan.local_mesh("cpu")`,
and D = 2 and 4 as spawned gloo ranks — one group per D, every case
inside it — on a mesh from `init_device_mesh`. The reference runs on
`Mesh(jax.devices()[:D], ("frontier",))` on the same encoded arrays,
handed to the port through `encoded_from_arrays`; it is computed in this
process while the groups run. Every rank must return the same result,
and it must equal the reference's in `valid?`, `op`, `fail-event`,
`max-frontier`, `capacity`, `devices` and `configs-stepped` (and
`final-paths` from `analysis`): exactly.

The cases are those of the reference's tests/test_sharded.py: the 60-op
register differential with a corrupted twin, the 4-op counterexample,
the wide-frontier capacity growth, sort against hash and route against
gather; and `analysis` of an invalid history. The group of four also
builds a 2x2 mesh: its topology decision and one check on it.

The ranks import nothing of JAX: this module imports the reference only
inside the functions that run it.
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

import torch_gloo
from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import meshplan, sharded
from torch_jax_cache import release_compiled_programs  # noqa: F401

KEYS = ("valid?", "op", "fail-event", "max-frontier", "capacity", "devices",
        "configs-stepped")
RANKS = (1, 2, 4)
GROUP_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ cases

def _wide_ops(n_crashed: int, read_value: int) -> list:
    """n_crashed concurrent crashed writes of distinct values, then one ok
    read: the closure at the read explores every subset of the writes
    (the reference's `_wide_frontier_history`)."""
    ops = [{"type": "invoke", "process": v, "f": "write", "value": v}
           for v in range(1, n_crashed + 1)]
    ops += [{"type": "info", "process": v, "f": "write", "value": v}
            for v in range(1, n_crashed + 1)]
    ops += [{"type": "invoke", "process": 0, "f": "read", "value": None},
            {"type": "ok", "process": 0, "f": "read", "value": read_value}]
    return ops


def _history(pkg_histories, History_, spec: tuple):
    """A history of one package from its spec: ("register", seed, corrupt
    seed or None), ("wide", n_crashed, read) or ("cex",)."""
    kind = spec[0]
    if kind == "register":
        _, n_ops, seed, corrupt = spec
        h = pkg_histories.rand_register_history(
            n_ops=n_ops, n_processes=5, crash_p=0.06, fail_p=0.06, seed=seed)
        if corrupt is not None:
            h = pkg_histories.corrupt_history(h, seed=corrupt)
        return h
    if kind == "wide":
        return History_.wrap(_wide_ops(spec[1], spec[2])).index()
    return History_.wrap([
        {"type": "invoke", "process": 0, "f": "write", "value": 1},
        {"type": "ok", "process": 0, "f": "write", "value": 1},
        {"type": "invoke", "process": 0, "f": "read", "value": None},
        {"type": "ok", "process": 0, "f": "read", "value": 2}]).index()


# id -> (history spec, entry point, keyword arguments of both packages)
CASES = {}
for _c in (None, 0):
    CASES[f"diff-77-{'corrupt' if _c is not None else 'clean'}"] = (
        ("register", 60, 77, _c), "check", {"capacity": 512,
                                            "dedupe": "hash"})
CASES["counterexample-4op"] = (("cex",), "check",
                               {"capacity": 256, "dedupe": "hash"})
CASES["wide-grows"] = (("wide", 8, 3), "check",
                       {"capacity": 256, "dedupe": "hash"})
CASES["wide-invalid"] = (("wide", 8, 99), "check",
                         {"capacity": 256, "dedupe": "hash"})
for _c in (None, 4):
    for _d in ("sort", "hash"):
        CASES[f"dedupe-{_d}-{'corrupt' if _c is not None else 'clean'}"] = (
            ("register", 50, 81, _c), "check", {"capacity": 512,
                                                "dedupe": _d})
# the routed twin of this case is diff-77-clean
CASES["exchange-gather"] = (("register", 60, 77, None), "check",
                            {"capacity": 512, "exchange": "gather",
                             "dedupe": "hash"})
CASES["analysis-invalid"] = (("register", 60, 77, 0), "analysis",
                             {"capacity": 512, "dedupe": "hash"})


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


def _payloads() -> dict:
    """What every rank needs per case: the encoded arrays of a check, or
    the history spec of an analysis. Encoded by the reference."""
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import encode as ref_enc
    out = {}
    for cid, (spec, entry, _) in CASES.items():
        if entry == "analysis":
            out[cid] = spec
        else:
            h = _history(ref_histories, RefHistory, spec)
            out[cid] = _parts(ref_enc.encode(ref_models.CASRegister(), h))
    return out


def _port_case(mesh, cid: str, payload):
    _, entry, kw = CASES[cid]
    if entry == "analysis":
        h = _history(histories, History, payload)
        return sharded.analysis(models.CASRegister(), h, mesh, **kw)
    e = enc.encoded_from_arrays(*payload)
    return sharded.check_encoded_sharded(e, mesh, **kw)


def _ref_case(D: int, cid: str) -> dict:
    import jax
    from jax.sharding import Mesh
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import encode as ref_enc
    from jepsen_tpu.parallel import sharded as ref_sharded
    spec, entry, kw = CASES[cid]
    mesh = Mesh(np.array(jax.devices()[:D]), ("frontier",))
    h = _history(ref_histories, RefHistory, spec)
    if entry == "analysis":
        return ref_sharded.analysis(ref_models.CASRegister(), h, mesh, **kw)
    return ref_sharded.check_encoded_sharded(
        ref_enc.encode(ref_models.CASRegister(), h), mesh, **kw)


def _two_d(mesh2, payloads) -> dict:
    """What a 2x2 mesh gives: the topology decision under each exchange,
    and the routed check of diff-77-clean on it."""
    route = meshplan.MeshPlan.from_mesh(mesh2)
    gather = meshplan.MeshPlan.from_mesh(mesh2, exchange="gather")
    return {"route": (route.hierarchical, route.n_slice, route.n_chip),
            "gather": (gather.hierarchical, gather.n_slice, gather.n_chip),
            "check": _port_case(mesh2, "diff-77-clean",
                                payloads["diff-77-clean"])}


def _ref_two_d() -> dict:
    import jax
    from jax.sharding import Mesh
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import encode as ref_enc
    from jepsen_tpu.parallel import sharded as ref_sharded
    spec, _, kw = CASES["diff-77-clean"]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("slice", "chip"))
    h = _history(ref_histories, RefHistory, spec)
    return ref_sharded.check_encoded_sharded(
        ref_enc.encode(ref_models.CASRegister(), h), mesh, **kw)


# ------------------------------------------------------------ the ranks

def _rank_main(rank: int, D: int, store: str, payloads: dict, out) -> None:
    """One spawned gloo rank: run every case on the D-rank mesh."""
    try:
        from torch.distributed.device_mesh import init_device_mesh
        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, D),
                                rank=rank, world_size=D)
        mesh = init_device_mesh("cpu", (D,), mesh_dim_names=("frontier",))
        res = {cid: _port_case(mesh, cid, p) for cid, p in payloads.items()}
        if D == 4:
            res["2d"] = _two_d(init_device_mesh(
                "cpu", (2, 2), mesh_dim_names=("slice", "chip")), payloads)
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
    """(port results per rank, reference results) of every case at D.
    The first call starts the groups of 2 and 4 ranks, runs one rank in
    this process and the reference at every D meanwhile, then collects
    the groups."""
    if not _RESULTS:
        _RESULTS.update(torch_gloo.shared("sharded", _compute))
    return _RESULTS[D]


def _compute() -> dict:
    payloads = _payloads()
    groups = {d: _Group(d, payloads) for d in RANKS if d > 1}
    mesh = meshplan.local_mesh("cpu")
    ranks = {1: [{cid: _port_case(mesh, cid, p)
                  for cid, p in payloads.items()}]}
    # the reference compiles one program per mesh size: in threads
    with ThreadPoolExecutor(len(RANKS)) as pool:
        ref = dict(zip(RANKS, pool.map(
            lambda d: {cid: _ref_case(d, cid) for cid in CASES}, RANKS)))
    ref[4]["2d"] = _ref_two_d()
    ranks.update((d, g.results()) for d, g in groups.items())
    return {d: (ranks[d], ref[d]) for d in RANKS}


def _pin(r: dict) -> dict:
    return {k: r.get(k) for k in KEYS}


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("cid", list(CASES))
def test_sharded_matches_reference(cid, D):
    ranks, ref = _results(D)
    want = ref[cid]
    got = ranks[0][cid]
    assert all(r[cid] == got for r in ranks[1:]), "ranks disagree"
    assert _pin(got) == _pin(want)
    assert got["devices"] == D and got["dedupe"] == CASES[cid][2]["dedupe"]
    assert got["closure"] == "torch"
    if CASES[cid][1] == "analysis":
        assert want["valid?"] is False
        assert got["final-paths"] == want["final-paths"]
        assert got["configs"] == want["configs"]


@pytest.mark.parametrize("D", RANKS)
def test_capacity_grows_past_one_rank(D):
    """The wide frontier outgrows the starting capacity and, past one
    rank, any one rank's share of the final one (the reference's
    test_sharded_frontier_past_one_device_grows_capacity)."""
    got = _results(D)[0][0]["wide-grows"]
    assert got["valid?"] is True and got["capacity"] > 256
    if D > 1:
        assert got["max-frontier"] > got["capacity"] // D


@pytest.mark.parametrize("D", RANKS)
def test_sort_and_hash_agree_and_hash_steps_less(D):
    ranks, _ = _results(D)
    for kind in ("clean", "corrupt"):
        s, h = (ranks[0][f"dedupe-{d}-{kind}"] for d in ("sort", "hash"))
        assert {k: s.get(k) for k in KEYS if k != "configs-stepped"} == \
            {k: h.get(k) for k in KEYS if k != "configs-stepped"}
        assert h["configs-stepped"] <= s["configs-stepped"]


@pytest.mark.parametrize("D", RANKS)
def test_route_and_gather_agree(D):
    ranks, _ = _results(D)
    assert ranks[0]["diff-77-clean"] == ranks[0]["exchange-gather"]


def test_unported_options_raise():
    """The options an earlier slice refused now run, and agree with the
    reference: search_stats gives the sharded block, reshard on one rank
    keeps the plain ladder (the reference delegates only past one
    device), packed rows name their layout; an unknown exchange still
    raises."""
    import jax
    from jax.sharding import Mesh
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import encode as ref_enc
    from jepsen_tpu.parallel import sharded as ref_sharded
    mesh = meshplan.local_mesh("cpu")
    e = enc.encoded_from_arrays(*_payloads()["counterexample-4op"])
    ref_e = ref_enc.encode(ref_models.CASRegister(),
                           _history(None, RefHistory, ("cex",)))
    ref_mesh = Mesh(np.array(jax.devices()[:1]), ("frontier",))
    for kw in ({"reshard": True, "dedupe": "hash"},
               {"search_stats": True, "dedupe": "hash"}):
        got = sharded.check_encoded_sharded(e, mesh, **kw)
        want = ref_sharded.check_encoded_sharded(ref_e, ref_mesh, **kw)
        assert _pin(got) == _pin(want)
        assert got.get("stats") == want.get("stats")
        assert "reshard" not in got
    # packed rows are ported: the check runs and names its layout
    r = sharded.check_encoded_sharded(e, mesh, config_pack=True)
    assert r["config-pack"].startswith("packed:")
    with pytest.raises(ValueError, match="exchange"):
        sharded.check_encoded_sharded(e, mesh, exchange="bcast")


def test_two_dimensional_mesh_raises():
    """A 2-D mesh no longer raises: with both dims > 1 the routed
    exchange makes it hierarchical (2x2) and the gather exchange flattens
    it (the reference's topology decision), and the check on it equals
    the reference's on its 2x2 mesh; a mesh that is not a DeviceMesh
    raises TypeError."""
    ranks, ref = _results(4)
    got = ranks[0]["2d"]
    assert all(r["2d"] == got for r in ranks[1:])
    assert got["route"] == (True, 2, 2)
    assert got["gather"] == (False, 1, 4)
    assert _pin(got["check"]) == _pin(ref["2d"])
    assert got["check"]["mesh"] == ref["2d"]["mesh"]

    class Mesh2D:
        ndim = 2
    with pytest.raises(TypeError, match="DeviceMesh"):
        meshplan.MeshPlan.from_mesh(Mesh2D())


def test_analysis_unpackable_history_falls_back_to_host_wgl():
    """An EncodeError (70 crashed writes: past the 64 open-call slots)
    goes to the host WGL search with a `fallback` note, as in the
    reference."""
    import jax
    from jax.sharding import Mesh
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu.models import CASRegister as RefCAS
    from jepsen_tpu.parallel import sharded as ref_sharded
    kw = {"n_ops": 80, "k_crashed": 70}
    want = ref_sharded.analysis(
        RefCAS(None), ref_histories.adversarial_register_history(**kw),
        Mesh(np.array(jax.devices()[:1]), ("frontier",)))
    got = sharded.analysis(models.CASRegister(None),
                           histories.adversarial_register_history(**kw),
                           meshplan.local_mesh("cpu"))
    assert "fallback" in want
    assert got == want
