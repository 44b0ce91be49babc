"""The port's hierarchical 2-D exchange and its sharded search-stats block
(jepsen_tpu_torch.parallel.sharded) against the reference's on the same
encoded arrays.

  * Every case of tests/test_torch_sharded.py at a 2x2 mesh (four
    spawned gloo ranks, `init_device_mesh("cpu", (2, 2))`) against the
    reference's `Mesh(devices[:4].reshape(2, 2), ("slice", "chip"))`.
  * One register differential at 2x4 and at 4x2 (eight ranks, both
    meshes in one group), as the reference's
    test_sharded_hierarchical_2d_mesh has them.
  * The sharded "stats" block at D = 1, 2 and 4 (flat) and 2x2, with
    the plain insert's probe histogram, against the reference's
    non-fused block, field for field.

Exact in `valid?`, `op`, `fail-event`, `max-frontier`, `capacity`,
`devices`, `configs-stepped`, `mesh` (and `final-paths` from
`analysis`), every rank returning the same result. The ranks import
nothing of JAX.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import test_torch_sharded as base
import torch_gloo
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import meshplan, sharded
from torch_jax_cache import release_compiled_programs  # noqa: F401

KEYS = base.KEYS + ("mesh",)
WIDE_SHAPES = ((2, 4), (4, 2))
WIDE_SPEC = ("register", 50, 303, None)
# id -> (history spec, keyword arguments of both packages)
STATS_CASES = {
    "register-hash": (("register", 60, 77, None),
                      {"capacity": 512, "dedupe": "hash"}),
    "register-sort": (("register", 60, 77, None),
                      {"capacity": 512, "dedupe": "sort"}),
    "corrupt-hash": (("register", 60, 77, 0),
                     {"capacity": 512, "dedupe": "hash"}),
    "wide-grows-hash": (("wide", 8, 3), {"capacity": 256,
                                         "dedupe": "hash"}),
}
STATS_MESHES = ((1,), (2,), (4,), (2, 2))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _encoded(spec):
    """The reference's encoding of a register history spec, as the plain
    data `encoded_from_arrays` takes."""
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import encode as ref_enc
    h = base._history(ref_histories, RefHistory, spec)
    return base._parts(ref_enc.encode(ref_models.CASRegister(), h))


def _payloads() -> dict:
    return {"cases": base._payloads(), "wide": _encoded(WIDE_SPEC),
            "stats": {cid: _encoded(spec)
                      for cid, (spec, _) in STATS_CASES.items()}}


def _stats_run(mesh, payloads) -> dict:
    return {cid: sharded.check_encoded_sharded(
        enc.encoded_from_arrays(*payloads["stats"][cid]), mesh,
        search_stats=True, **kw) for cid, (_, kw) in STATS_CASES.items()}


def _rank(rank: int, D: int, payloads) -> dict:
    """One rank of a group of D: the 2x2 cases and stats at D = 4, the
    flat stats at D = 2, the wide differential at D = 8."""
    out = {}
    if D == 4:
        m2 = torch_gloo.mesh((2, 2))
        out["cases"] = {cid: base._port_case(m2, cid, p)
                        for cid, p in payloads["cases"].items()}
        out[("stats", (2, 2))] = _stats_run(m2, payloads)
        out[("stats", (4,))] = _stats_run(torch_gloo.mesh((4,)), payloads)
    elif D == 2:
        out[("stats", (2,))] = _stats_run(torch_gloo.mesh((2,)), payloads)
    else:
        e = enc.encoded_from_arrays(*payloads["wide"])
        for shape in WIDE_SHAPES:
            m = torch_gloo.mesh(shape)
            out[("wide", shape)] = sharded.check_encoded_sharded(
                e, m, capacity=512, dedupe="hash")
    return out


def _ref_mesh(shape):
    import jax
    from jax.sharding import Mesh
    n = int(np.prod(shape))
    devs = np.array(jax.devices()[:n])
    if len(shape) == 1:
        return Mesh(devs, ("frontier",))
    return Mesh(devs.reshape(shape), ("slice", "chip"))


def _ref_encoded(spec):
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import encode as ref_enc
    return ref_enc.encode(ref_models.CASRegister(),
                          base._history(ref_histories, RefHistory, spec))


def _ref_cases() -> dict:
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.history import History as RefHistory
    from jepsen_tpu.parallel import sharded as ref_sharded
    mesh = _ref_mesh((2, 2))
    out = {}
    for cid, (spec, entry, kw) in base.CASES.items():
        if entry == "analysis":
            h = base._history(ref_histories, RefHistory, spec)
            out[cid] = ref_sharded.analysis(ref_models.CASRegister(), h,
                                            mesh, **kw)
        else:
            out[cid] = ref_sharded.check_encoded_sharded(
                _ref_encoded(spec), mesh, **kw)
    return out


def _ref_stats(shape) -> dict:
    from jepsen_tpu.parallel import sharded as ref_sharded
    mesh = _ref_mesh(shape)
    return {cid: ref_sharded.check_encoded_sharded(
        _ref_encoded(spec), mesh, search_stats=True, **kw)
        for cid, (spec, kw) in STATS_CASES.items()}


def _ref_wide(shape) -> dict:
    from jepsen_tpu.parallel import sharded as ref_sharded
    return ref_sharded.check_encoded_sharded(
        _ref_encoded(WIDE_SPEC), _ref_mesh(shape), capacity=512,
        dedupe="hash")


def _compute() -> dict:
    """{"port": {name: [per-rank result]}, "ref": {name: result}}: the
    groups of 2, 4 and 8 ranks run while this process runs the one-rank
    stats and the reference."""
    payloads = _payloads()
    groups = {D: torch_gloo.Group(D, _rank, (D, payloads))
              for D in (4, 2, 8)}
    port = {("stats", (1,)): [_stats_run(meshplan.local_mesh("cpu"),
                                         payloads)]}
    jobs = {"cases": _ref_cases}
    for shape in STATS_MESHES:
        jobs[("stats", shape)] = lambda s=shape: _ref_stats(s)
    for shape in WIDE_SHAPES:
        jobs[("wide", shape)] = lambda s=shape: _ref_wide(s)
    with ThreadPoolExecutor(3) as pool:
        futs = {k: pool.submit(f) for k, f in jobs.items()}
        ref = {k: f.result() for k, f in futs.items()}
    for g in groups.values():
        ranks = g.results()
        for name in ranks[0]:
            port[name] = [r[name] for r in ranks]
    return {"port": port, "ref": ref}


_RESULTS: dict = {}


def _results() -> dict:
    if not _RESULTS:
        _RESULTS.update(torch_gloo.shared("sharded2d", _compute))
    return _RESULTS


def _pin(r: dict) -> dict:
    return {k: r.get(k) for k in KEYS}


@pytest.mark.parametrize("cid", list(base.CASES))
def test_two_by_two_matches_reference(cid):
    res = _results()
    ranks = [r[cid] for r in res["port"]["cases"]]
    want = res["ref"]["cases"][cid]
    got = ranks[0]
    assert all(r == got for r in ranks[1:]), "ranks disagree"
    assert _pin(got) == _pin(want)
    # the gather exchange flattens the mesh, as in the reference
    assert got.get("mesh") == (None if cid == "exchange-gather"
                               else "2x2 (hierarchical exchange)")
    assert got["devices"] == 4 and got["closure"] == "torch"
    if base.CASES[cid][1] == "analysis":
        assert want["valid?"] is False
        assert got["final-paths"] == want["final-paths"]
        assert got["configs"] == want["configs"]


@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=lambda s: "x".join(
    map(str, s)))
def test_eight_rank_hierarchical_matches_reference(shape):
    res = _results()
    ranks = res["port"][("wide", shape)]
    want = res["ref"][("wide", shape)]
    assert all(r == ranks[0] for r in ranks[1:]), "ranks disagree"
    assert _pin(ranks[0]) == _pin(want)
    assert ranks[0]["mesh"] == f"{shape[0]}x{shape[1]} (hierarchical " \
                               f"exchange)"
    assert ranks[0]["devices"] == 8


@pytest.mark.parametrize("shape", STATS_MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("cid", list(STATS_CASES))
def test_stats_block_matches_reference(cid, shape):
    res = _results()
    ranks = [r[cid] for r in res["port"][("stats", shape)]]
    want = res["ref"][("stats", shape)][cid]
    got = ranks[0]
    assert all(r == got for r in ranks[1:]), "ranks disagree"
    assert _pin(got) == _pin(want)
    assert got["stats"] == want["stats"]
    if got["dedupe"] == "hash":
        # the plain insert filled the histogram, as the reference's
        # non-fused insert does
        assert got["stats"]["probes"] > 0


def test_stats_off_has_no_block():
    e = enc.encoded_from_arrays(*_payloads()["stats"]["register-hash"])
    r = sharded.check_encoded_sharded(e, meshplan.local_mesh("cpu"),
                                      capacity=512, dedupe="hash",
                                      search_stats=False)
    assert "stats" not in r
