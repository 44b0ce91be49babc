"""The port's resumable and elastic sharded arms
(jepsen_tpu_torch.parallel.sharded.check_encoded_sharded_resumable /
_elastic) against the reference's on the same encoded arrays.

  * Every checkpoint at D = 1, 2 and 4 (spawned gloo ranks) equals the
    reference's on 1, 2 and 4 devices, array for array: the k6
    adversarial register history from capacity 128, a checkpoint every
    16 events, so that the frontier overflows inside chunks and the
    chunk runs again at twice the capacity.
  * A checkpoint taken on 4 devices resumes on 2 ranks (the reference's
    test_sharded_checkpoint_resumes_on_smaller_mesh) with the
    reference's result.
  * The .npz interchange both ways: a port checkpoint resumes in the
    reference and a reference checkpoint in the port.
  * The elastic ladder at 4 ranks from start_devices 1 and 2, the 2-D
    promotion at 2x2 (the reference's test_reshard_2d_promotion_parity)
    and an overflow on the full mesh that stays "unknown": the verdict
    fields and the "reshard" block equal the reference's.

The ranks import nothing of JAX.
"""

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import test_torch_sharded as base
import torch_gloo
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import engine, meshplan, sharded
from torch_jax_cache import release_compiled_programs  # noqa: F401

KEYS = ("valid?", "op", "fail-event", "max-frontier", "capacity", "devices",
        "configs-stepped", "error")
RES_KW = {"capacity": 128, "max_capacity": 1 << 16, "checkpoint_every": 16,
          "dedupe": "hash"}
ELASTIC_KW = {"capacity": 128, "max_capacity": 1 << 16,
              "checkpoint_every": 16, "dedupe": "hash"}
FULL_MESH_MAX = 256     # below what the history needs on four ranks


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_encoded():
    from jepsen_tpu import histories as ref_histories
    from jepsen_tpu import models as ref_models
    from jepsen_tpu.parallel import encode as ref_enc
    h = ref_histories.adversarial_register_history(n_ops=60, k_crashed=6,
                                                   seed=7)
    return ref_enc.encode(ref_models.CASRegister(), h)


def _digest(cp) -> list:
    h = hashlib.sha256()
    for a in (cp.st, cp.ml, cp.mh, cp.live):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return [cp.event_index, cp.capacity, cp.ok, cp.fail_r, cp.maxf,
            cp.steps_n, cp.stepped, h.hexdigest()[:16]]


def _cp_arrays(cp) -> tuple:
    return (cp.event_index, cp.capacity, cp.step_name, cp.history_digest,
            cp.st, cp.ml, cp.mh, cp.live, cp.ok, cp.fail_r, cp.maxf,
            cp.steps_n, cp.stepped)


def _pin(r: dict) -> dict:
    return {k: r.get(k) for k in KEYS}


def _resumable(e, mesh) -> dict:
    cps = []
    r = sharded.check_encoded_sharded_resumable(
        e, mesh, checkpoint_cb=cps.append, **RES_KW)
    return {"result": _pin(r), "cps": [_digest(c) for c in cps]}


def _elastic(e, mesh, **kw) -> dict:
    r = sharded.check_encoded_sharded_elastic(e, mesh, **{**ELASTIC_KW,
                                                          **kw})
    return {"result": _pin(r), "reshard": r["reshard"]}


def _rank(rank: int, D: int, payload, resume=None) -> dict:
    e = enc.encoded_from_arrays(*payload)
    mesh = meshplan.local_mesh("cpu") if D == 1 else torch_gloo.mesh((D,))
    out = {"resumable": _resumable(e, mesh)}
    if D == 4:
        for s in (1, 2):
            out[("elastic", s)] = _elastic(e, mesh, start_devices=s)
        out["full-mesh"] = _elastic(e, mesh, start_devices=2,
                                    max_capacity=FULL_MESH_MAX)
        out["promotion"] = _elastic(e, torch_gloo.mesh((2, 2)),
                                    start_devices=1)
    if resume is not None:
        cp = engine.FrontierCheckpoint(*resume)
        r = sharded.check_encoded_sharded_resumable(e, mesh, resume=cp,
                                                    **RES_KW)
        out["resumed"] = _pin(r)
    return out


def _ref_mesh(shape):
    import jax
    from jax.sharding import Mesh
    devs = np.array(jax.devices()[:int(np.prod(shape))])
    if len(shape) == 1:
        return Mesh(devs, ("frontier",))
    return Mesh(devs.reshape(shape), ("slice", "chip"))


def _ref_resumable(e, D: int, resume=None):
    from jepsen_tpu.parallel import sharded as ref_sharded
    cps = []
    r = ref_sharded.check_encoded_sharded_resumable(
        e, _ref_mesh((D,)), checkpoint_cb=cps.append, resume=resume,
        **RES_KW)
    return r, cps


def _ref_elastic(e, shape, **kw) -> dict:
    from jepsen_tpu.parallel import sharded as ref_sharded
    r = ref_sharded.check_encoded_sharded_elastic(
        e, _ref_mesh(shape), **{**ELASTIC_KW, **kw})
    return {"result": _pin(r), "reshard": r["reshard"]}


def _ref_rows(out) -> tuple:
    """A reference resumable run as plain data: its pinned result and
    its checkpoints' rows."""
    r, cps = out
    return _pin(r), [_digest(c) for c in cps]


def _compute() -> dict:
    """The port's results per rank count and the reference's, as plain
    data. The group of 4 starts first; the reference's 4-device
    checkpoints come next, and the middle one is the resume point handed
    to the group of 2."""
    e_ref = _ref_encoded()
    payload = base._parts(e_ref)
    g4 = torch_gloo.Group(4, _rank, (4, payload))
    r4, cps4 = _ref_resumable(e_ref, 4)
    mid = cps4[len(cps4) // 2]
    g2 = torch_gloo.Group(2, _rank, (2, payload, _cp_arrays(mid)))
    port = {1: [_rank(0, 1, payload)]}
    jobs = {
        ("resumable", 1): lambda: _ref_rows(_ref_resumable(e_ref, 1)),
        ("resumable", 2): lambda: _ref_rows(_ref_resumable(e_ref, 2)),
        "resumed-2": lambda: _pin(_ref_resumable(e_ref, 2, resume=mid)[0]),
        ("elastic", 1): lambda: _ref_elastic(e_ref, (4,), start_devices=1),
        ("elastic", 2): lambda: _ref_elastic(e_ref, (4,), start_devices=2),
        "full-mesh": lambda: _ref_elastic(
            e_ref, (4,), start_devices=2, max_capacity=FULL_MESH_MAX),
        "promotion": lambda: _ref_elastic(e_ref, (2, 2), start_devices=1),
    }
    with ThreadPoolExecutor(3) as pool:
        futs = {k: pool.submit(f) for k, f in jobs.items()}
        ref = {k: f.result() for k, f in futs.items()}
    ref[("resumable", 4)] = _ref_rows((r4, cps4))
    port[4] = g4.results()
    port[2] = g2.results()
    return {"port": port, "ref": ref, "payload": payload,
            "mid": _cp_arrays(mid)}


_RESULTS: dict = {}


def _results() -> dict:
    if not _RESULTS:
        _RESULTS.update(torch_gloo.shared("sharded_resumable", _compute))
    return _RESULTS


@pytest.mark.parametrize("D", (1, 2, 4))
def test_checkpoints_match_reference(D):
    res = _results()
    ranks = res["port"][D]
    want_result, want_cps = res["ref"][("resumable", D)]
    got = ranks[0]["resumable"]
    assert all(x["resumable"] == got for x in ranks[1:]), "ranks disagree"
    assert got["result"] == want_result
    assert got["cps"] == want_cps
    # the capacity doubled inside a chunk (otherwise this pins no
    # overflow re-run)
    assert got["cps"][-1][1] > RES_KW["capacity"]


def test_checkpoint_resumes_on_smaller_mesh():
    """A checkpoint taken on 4 devices resumes on 2 ranks: the restore
    route spreads the rows over the new owners, and the result is the
    reference's resume of the same checkpoint on 2 devices (and the
    one-shot verdict)."""
    res = _results()
    got = [x["resumed"] for x in res["port"][2]]
    assert all(g == got[0] for g in got[1:])
    assert got[0] == res["ref"]["resumed-2"]
    assert got[0]["valid?"] == res["ref"][("resumable", 4)][0]["valid?"]


def test_npz_interchange_both_ways(tmp_path):
    """A port checkpoint saved to .npz resumes in the reference, and a
    reference checkpoint resumes in the port, with equal results."""
    from jepsen_tpu.parallel import engine as ref_engine
    res = _results()
    e_ref = _ref_encoded()
    e = enc.encoded_from_arrays(*res["payload"])
    mesh = meshplan.local_mesh("cpu")
    cps = []
    sharded.check_encoded_sharded_resumable(e, mesh,
                                            checkpoint_cb=cps.append,
                                            **RES_KW)
    mine = cps[len(cps) // 2].save(str(tmp_path / "port"))
    want, _ = _ref_resumable(e_ref, 1,
                             resume=ref_engine.FrontierCheckpoint.load(mine))
    ref_mid = ref_engine.FrontierCheckpoint(*res["mid"])
    theirs = ref_mid.save(str(tmp_path / "ref"))
    got = sharded.check_encoded_sharded_resumable(
        e, mesh, resume=engine.FrontierCheckpoint.load(theirs), **RES_KW)
    r1, _ = _ref_resumable(e_ref, 1)
    assert _pin(want) == _pin(r1)
    assert _pin(got) == _pin(_ref_resumable(e_ref, 1, resume=ref_mid)[0])


@pytest.mark.parametrize("start", (1, 2))
def test_elastic_matches_reference(start):
    res = _results()
    ranks = [x[("elastic", start)] for x in res["port"][4]]
    want = res["ref"][("elastic", start)]
    assert all(r == ranks[0] for r in ranks[1:]), "ranks disagree"
    assert ranks[0] == want
    assert ranks[0]["reshard"]["events"], "no rung was recruited"


def test_reshard_2d_promotion_parity():
    res = _results()
    ranks = [x["promotion"] for x in res["port"][4]]
    want = res["ref"]["promotion"]
    assert all(r == ranks[0] for r in ranks[1:])
    assert ranks[0] == want
    # the trail crossed into the 2-D rung (past one slice's 2 ranks)
    assert any(ev["devices"][1] > 2 for ev in
               ranks[0]["reshard"]["events"])


def test_reshard_overflow_at_full_mesh_stays_unknown():
    res = _results()
    ranks = [x["full-mesh"] for x in res["port"][4]]
    want = res["ref"]["full-mesh"]
    assert all(r == ranks[0] for r in ranks[1:])
    assert ranks[0] == want
    assert ranks[0]["result"]["valid?"] == "unknown"
    assert "frontier overflow" in ranks[0]["result"]["error"]
    assert ranks[0]["reshard"]["events"]


def test_resume_of_another_history_raises():
    res = _results()
    e = enc.encoded_from_arrays(*res["payload"])
    mid = res["mid"]
    bad = engine.FrontierCheckpoint(*mid[:3], "0" * 16, *mid[4:])
    with pytest.raises(ValueError, match="different history"):
        sharded.check_encoded_sharded_resumable(
            e, meshplan.local_mesh("cpu"), resume=bad)
