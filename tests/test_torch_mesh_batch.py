"""The port's mesh-sharded key batch (jepsen_tpu_torch.parallel.engine.
check_batch(mesh=...)) against the reference's batch on the same keys.

  * Dense and sparse buckets at 1, 2 and 4 ranks (this process, then
    spawned gloo ranks), ragged key counts included (a rank with no
    keys still joins the gather), with search stats: every key's pinned
    fields and its stats block — the batch's pad extras too — equal the
    reference's one program over the whole batch.
  * The second escalation rung at 2 and 4 ranks: keys past the single
    rung's ceiling, placed on different ranks of one batch, escalate on
    every rank together to the frontier-sharded engine ("escalated":
    "sharded"), as the reference's on 2 and 4 devices; at one rank the
    rung does not run and the key stays "unknown".
  * `check_batch_pipelined` with `mesh`, and with `mesh` and `steal`.
  * `independent` with a mesh on the test map.
"""

import numpy as np
import pytest
import torch

import torch_gloo
from jepsen_tpu_torch import histories, independent, models
from jepsen_tpu_torch.checker.linearizable import Linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import engine, meshplan
from torch_jax_cache import release_compiled_programs  # noqa: F401

PIN = ("valid?", "op", "fail-event", "max-frontier", "capacity",
       "configs-stepped", "dedupe", "escalated", "stats")
RANKS = (1, 2, 4)
# (generator, model, its keyword arguments per key, corrupt seeds)
CASES = {
    # 7 keys: blocks of 2, 2, 2, 1 on four ranks
    "dense": ("rand_register_history", "CASRegister",
              [{"n_ops": 40, "n_processes": 5, "crash_p": 0.05,
                "fail_p": 0.05, "seed": s} for s in range(6)], (2,),
              {"search_stats": True}),
    # 5 keys: blocks of 2, 2, 1, 0 on four ranks; the capacity climbs
    "sparse": ("rand_queue_history", "UnorderedQueue",
               [{"n_ops": 40, "n_processes": 6, "crash_p": 0.02, "seed": s}
                for s in range(4)], (0,),
               {"capacity": 64, "dedupe": "hash", "search_stats": True}),
}
ESC_KW = {"capacity": 64, "max_capacity": 64, "dedupe": "hash"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pin(r: dict) -> dict:
    return {k: r.get(k) for k in PIN}


def _keys(pkg_histories, pkg_models, cid):
    gen, model, kws, corrupt, _ = CASES[cid]
    hs = [getattr(pkg_histories, gen)(**kw) for kw in kws]
    hs += [pkg_histories.corrupt_history(hs[c], seed=c + 1) for c in corrupt]
    return getattr(pkg_models, model)(), hs


def _wide_queue(History_, n: int, v0: int):
    """n concurrent crashed enqueues, then a dequeue of the first: the
    closure explores every subset of the enqueues."""
    ops = [{"type": "invoke", "process": i, "f": "enqueue", "value": v0 + i}
           for i in range(n)]
    ops += [{"type": "info", "process": i, "f": "enqueue", "value": v0 + i}
            for i in range(n)]
    ops += [{"type": "invoke", "process": 99, "f": "dequeue", "value": None},
            {"type": "ok", "process": 99, "f": "dequeue", "value": v0}]
    return History_.wrap(ops).index()


def _esc_keys(pkg_histories, pkg_models, History_):
    """Two 8-wide keys (past the single rung's ceiling of 256 at batch
    capacity 64) in one bucket, so on different ranks, two light keys
    and a 7-wide key that the dense engine takes."""
    light = [pkg_histories.rand_queue_history(n_ops=30, n_processes=4,
                                              crash_p=0.0, seed=s)
             for s in (11, 12)]
    return pkg_models.UnorderedQueue(), [
        _wide_queue(History_, 8, 1), light[0], _wide_queue(History_, 8, 20),
        light[1], _wide_queue(History_, 7, 40)]


def _kv_history(pkg_histories, pkg_indep, History_):
    """A keyed register history of six keys, ops interleaved."""
    per_key = [pkg_histories.rand_register_history(
        n_ops=24, n_processes=3, crash_p=0.05, seed=60 + k)
        for k in range(6)]
    lists = [[dict(o, process=o["process"] + 100 * k,
                   value=pkg_indep.ktuple(k, o.get("value")))
              for o in h if isinstance(o.get("process"), int)]
             for k, h in enumerate(per_key)]
    out = []
    for j in range(max(map(len, lists))):
        out += [ops[j] for ops in lists if j < len(ops)]
    return History_.wrap(out).index()


def _port_all(mesh) -> dict:
    out = {}
    for cid in CASES:
        model, hs = _keys(histories, models, cid)
        out[cid] = [_pin(r) for r in engine.check_batch(model, hs, mesh=mesh,
                                                        **CASES[cid][4])]
    model, hs = _esc_keys(histories, models, History)
    out["escalate"] = [_pin(r) for r in engine.check_batch(
        model, hs, mesh=mesh, **ESC_KW)]
    for name, kw in (("pipeline", {}), ("pipeline-steal", {"steal": True})):
        for cid in CASES:
            model, hs = _keys(histories, models, cid)
            out[(name, cid)] = [_pin(r) for r in engine.check_batch(
                model, hs, mesh=mesh, pipeline=True, cache=False,
                **CASES[cid][4], **kw)]
    r = independent.checker(Linearizable(models.CASRegister())).check(
        {"mesh": mesh}, _kv_history(histories, independent, History))
    out["independent"] = (r["valid?"], {str(k): _pin(v) for k, v in
                                        r["results"].items()})
    return out


def _rank(rank: int, D: int) -> dict:
    return _port_all(torch_gloo.mesh((D,)))


def _ref_all() -> dict:
    """The reference's results: its one-program batch (no mesh) for every
    case but the escalation, which runs on 1, 2 and 4 devices."""
    import jax
    from jax.sharding import Mesh
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import independent as ref_indep
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.checker.linearizable import Linearizable as RefLin
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import engine as ref_engine
    out = {}
    for cid in CASES:
        model, hs = _keys(ref_histories, ref_models, cid)
        out[cid] = [_pin(r) for r in ref_engine.check_batch(
            model, hs, **CASES[cid][4])]
    model, hs = _esc_keys(ref_histories, ref_models, RefHistory)
    for D in RANKS:
        mesh = Mesh(np.array(jax.devices()[:D]), ("key",))
        out[("escalate", D)] = [_pin(r) for r in ref_engine.check_batch(
            model, hs, mesh=mesh, **ESC_KW)]
    r = ref_indep.checker(RefLin(ref_models.CASRegister())).check(
        {}, _kv_history(ref_histories, ref_indep, RefHistory))
    out["independent"] = (r["valid?"], {str(k): _pin(v) for k, v in
                                        r["results"].items()})
    return out


def _compute() -> dict:
    groups = {D: torch_gloo.Group(D, _rank, (D,)) for D in RANKS if D > 1}
    port = {1: [_port_all(meshplan.local_mesh("cpu"))]}
    ref = _ref_all()
    port.update((D, g.results()) for D, g in groups.items())
    return {"port": port, "ref": ref}


_RESULTS: dict = {}


def _results() -> dict:
    if not _RESULTS:
        _RESULTS.update(torch_gloo.shared("mesh_batch", _compute))
    return _RESULTS


def _ranks(D: int, name: str) -> list:
    ranks = [r[name] for r in _results()["port"][D]]
    assert all(r == ranks[0] for r in ranks[1:]), "ranks disagree"
    return ranks[0]


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("cid", list(CASES))
def test_mesh_batch_matches_reference(cid, D):
    got = _ranks(D, cid)
    want = _results()["ref"][cid]
    assert got == want
    # the pad extras are the whole bucket's: some key carries some
    assert any(g["stats"]["pad-events"] > 0 or g["stats"]["pad-slots"] > 0
               for g in got)


@pytest.mark.parametrize("D", RANKS)
def test_sharded_escalation_rung(D):
    got = _ranks(D, "escalate")
    want = _results()["ref"][("escalate", D)]
    assert got == want
    esc = [g["escalated"] for g in got]
    if D == 1:
        # one rank: the sharded ceiling does not pass the single one
        assert got[0]["valid?"] == "unknown" and esc[0] is None
    else:
        # keys 0 and 2 overflowed on different ranks and escalated
        # together to the sharded engine
        assert esc[0] == esc[2] == "sharded"
        assert got[0]["valid?"] is True and got[2]["valid?"] is True


@pytest.mark.parametrize("D", RANKS)
@pytest.mark.parametrize("name", ("pipeline", "pipeline-steal"))
def test_pipelined_with_mesh(name, D):
    """The pipelined executor with a mesh gives the static batch's
    results; with stealing too, in every pinned field but the stats
    block, whose pad extras are then the rounds' (each padded to the
    bucket's dims), as the reference's stealing rounds give them."""
    for cid in CASES:
        got, want = _ranks(D, (name, cid)), _results()["ref"][cid]
        if name == "pipeline-steal":
            got = [dict(g, stats=None) for g in got]
            want = [dict(w, stats=None) for w in want]
        assert got == want


@pytest.mark.parametrize("D", RANKS)
def test_independent_with_mesh_on_the_test_map(D):
    got = _ranks(D, "independent")
    assert got == _results()["ref"]["independent"]
    assert len(got[1]) == 6
