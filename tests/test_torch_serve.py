"""The port's streaming checker service (jepsen_tpu_torch.serve.service,
on the CPU with the plain closures) against the reference's
(jepsen_tpu.serve.service) on the same deltas.

Each scenario runs once against each service, and every answer it
collects (acks, sheds, errors, verdicts, finalize results, stats,
status and health documents) must be equal, field for field and
exactly, but for two named lists: TIMES, the fields measured in
seconds (the per-tenant ack and verdict quantiles, a slow-delta record's
total and stages, and the stage it names slowest), compared by presence,
key set and type since they differ from run to run; and PORT_ONLY, the
port's route tag ("closure"). OBS_ONLY, the reference's fields the port
leaves out, is empty. Covered: stream parity,
drain and accounting; duplicate, gap and finalized answers; restart
replay and the torn tail; backpressure and the high-water shed;
concurrent same-seq submitters; eviction and thaw mid-stream (the thaw
resumes, it does not rescan); tenant auth, isolation, quotas, the WAL
quota and its lifting, the fairness flood, DRR take order, a threaded
hammer, finalize under DRR, recovery re-homing ownership; adopt_keys
with fences, steal_key and freeze_key; status and health; the device
fault decision (a scan error gives each key of its batch the loud
unknown: with a WAL the next delta gives the one-shot verdict, without
one the key is poisoned); the card-less service. ``replicator=`` (WAL
segment replication) is held to the reference in
tests/test_torch_fleet.py."""

import json
import os
import shutil
import threading
import time

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu.serve import CheckerService as RefService
from jepsen_tpu.serve import Tenant as RefTenant
from jepsen_tpu.serve import service as ref_svc_mod
from jepsen_tpu_torch import models
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.serve import CheckerService, Tenant
from jepsen_tpu_torch.serve import service as svc_mod
from jepsen_tpu_torch.serve.stdio import jsonable
from torch_fleet_cases import unarmed
from torch_jax_cache import release_compiled_programs  # noqa: F401

# the reference's fields the port leaves out: none
OBS_ONLY = ()
# the fields measured in seconds: compared by presence, key set and type
TIMES = ("ack_p50", "ack_p99", "verdict_p50", "verdict_p99",
         "total_secs", "stages", "slowest_stage")
# the port's route tag: which closure ran ("torch" on the CPU)
PORT_ONLY = ("closure",)
PIN = ("valid?", "op", "fail-event", "max-frontier", "configs-stepped")


@pytest.fixture(autouse=True)
def _unarmed(monkeypatch):
    unarmed(monkeypatch)
    yield
    unarmed(monkeypatch)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(v):
    """A time field's presence, key set and type."""
    if isinstance(v, dict):
        return {k: type(x).__name__ for k, x in v.items()}
    return type(v).__name__


def _norm(x, drop):
    if isinstance(x, dict):
        return {k: ("wal" if k == "dir" else _shape(v) if k in TIMES
                    else _norm(v, drop))
                for k, v in x.items() if k not in drop}
    if isinstance(x, list):
        return [_norm(v, drop) for v in x]
    return x


def _same(ref_answers, port_answers):
    want = _norm(jsonable(ref_answers), OBS_ONLY)
    got = _norm(jsonable(port_answers), PORT_ONLY)
    assert got == want


def _service(pkg, tmp_path=None, model="CASRegister", tenants=None, **kw):
    """`pkg`'s service ("ref" or "port"), dedupe "hash" and capacity 128
    on both, its WAL under tmp_path/<pkg>/wal when tmp_path is given;
    `tenants` as (name, dict(token=..., ...)) pairs."""
    if tmp_path is not None:
        kw["wal_dir"] = str(tmp_path / pkg / "wal")
    if tenants is not None:
        T = RefTenant if pkg == "ref" else Tenant
        kw["tenants"] = [T(name, **spec) for name, spec in tenants]
    kw.setdefault("capacity", 128)
    kw.setdefault("dedupe", "hash")
    if pkg == "ref":
        return RefService(getattr(ref_models, model)(), **kw)
    return CheckerService(getattr(models, model)(), device="cpu", **kw)


def _ops(pkg, ops):
    O = RefOp if pkg == "ref" else Op
    return [O(o) for o in ops]


def _both(scenario, *args, **kw):
    """Run `scenario(pkg, *args, **kw)` for each package and hold the
    answers it returns equal."""
    ref = scenario("ref", *args, **kw)
    port = scenario("port", *args, **kw)
    _same(ref, port)
    return ref, port


def _register_streams():
    h1 = [dict(o) for o in ref_histories.rand_register_history(
        n_ops=24, n_processes=4, n_values=3, crash_p=0.05, seed=1)]
    h2 = [dict(o) for o in ref_histories.corrupt_history(
        ref_histories.rand_register_history(n_ops=24, n_processes=4,
                                            n_values=3, crash_p=0.05,
                                            seed=2),
        seed=1, n_corruptions=2)]
    return h1, h2


def _queue_streams():
    h1 = [dict(o) for o in ref_histories.rand_queue_history(
        n_ops=36, n_processes=4, n_values=3, crash_p=0.04, seed=34)]
    h2 = [dict(o) for o in ref_histories.corrupt_history(
        ref_histories.rand_queue_history(n_ops=36, n_processes=4,
                                         n_values=3, crash_p=0.04,
                                         seed=35), seed=0)]
    return h1, h2


def _ref_one_shot(ops):
    e = ref_enc.encode(ref_models.CASRegister(), RefHistory.wrap(ops))
    return ref_engine.check_encoded(e, capacity=128, dedupe="hash")


# ---------------------------------------------------------- streaming


@pytest.mark.parametrize("model", ["CASRegister", "UnorderedQueue"])
def test_service_stream_parity_drain_and_accounting(tmp_path, model):
    h1, h2 = (_register_streams() if model == "CASRegister"
              else _queue_streams())

    def scenario(pkg):
        svc = _service(pkg, tmp_path, model=model)
        out = []
        try:
            n = len(h1) // 3
            for a in range(3):
                for k, h in (("k1", h1), ("k2", h2)):
                    r = svc.submit(k, _ops(pkg, h[a * n:(a + 1) * n]),
                                   wait=True, timeout=120)
                    assert "valid?" in r, r
                    out.append(r)
            out.append(svc.finalize("k1", timeout=120))
            out.append(svc.finalize("k2", timeout=120))
            assert svc.drain(timeout=60)
            out += [svc.stats(), svc.status(), svc.health()]
        finally:
            svc.close()
        return out

    ref, port = _both(scenario)
    f1, f2 = port[-5], port[-4]
    # every admitted delta accounted for — no silent drops
    assert f1["seq"] == 3 and f2["seq"] == 3
    assert port[-3]["pending_ops"] == 0
    assert f2["valid?"] is False and "final-paths" in f2


def test_service_duplicate_gap_and_finalized(tmp_path):
    h1, _ = _register_streams()

    def scenario(pkg):
        svc = _service(pkg, tmp_path)
        try:
            out = [svc.submit("k", _ops(pkg, h1[:16]), seq=1),
                   svc.submit("k", _ops(pkg, h1[:16]), seq=1),
                   svc.submit("k", _ops(pkg, h1[16:]), seq=5),
                   svc.submit("k", [{"type": "bogus"}]),
                   svc.result("nope"),
                   svc.finalize("k", timeout=120),
                   svc.submit("k", _ops(pkg, h1[16:]))]
        finally:
            svc.close()
        return out

    _, port = _both(scenario)
    assert port[0]["accepted"] and port[1] == {"duplicate": True, "seq": 1,
                                               "key": "k"}
    assert "sequence gap" in port[2]["error"]
    assert "type must be one of" in port[3]["error"]
    assert "finalized" in port[6]["error"]


def test_service_restart_replays_wal_to_identical_verdicts(tmp_path):
    h1, h2 = _register_streams()

    def scenario(pkg):
        svc = _service(pkg, tmp_path)
        try:
            for a, b in ((0, 12), (12, 24)):
                svc.submit("k1", _ops(pkg, h1[a:b]), wait=True, timeout=120)
                svc.submit("k2", _ops(pkg, h2[a:b]), wait=True, timeout=120)
            before = [svc.result("k1", timeout=60),
                      svc.result("k2", timeout=60)]
        finally:
            svc.close()
        # kill-and-restart: replay lands identical verdicts and detects
        # duplicate deltas by seq
        svc2 = _service(pkg, tmp_path)
        try:
            after = [svc2.result("k1", timeout=120),
                     svc2.result("k2", timeout=120),
                     svc2.submit("k1", _ops(pkg, h1[12:24]), seq=2),
                     svc2.status()]
        finally:
            svc2.close()
        for b, a in zip(before, after):
            assert {k: b.get(k) for k in PIN} == {k: a.get(k) for k in PIN}
            assert b["seq"] == a["seq"]
        return before + after

    _, port = _both(scenario)
    assert port[4]["duplicate"]
    assert port[5]["keys"]['"k1"']["acct"]["replays"] == 2


def test_service_wal_torn_tail_tolerated(tmp_path):
    h1, _ = _register_streams()

    def scenario(pkg):
        wal = tmp_path / pkg / "wal"
        svc = _service(pkg, tmp_path)
        try:
            ref = svc.submit("k1", _ops(pkg, h1), wait=True, timeout=120)
        finally:
            svc.close()
        # a mid-write kill: a torn, unacknowledged trailing line
        fname = [n for n in os.listdir(wal) if n.endswith(".wal")][0]
        with open(wal / fname, "a") as fh:
            fh.write('{"seq": 2, "ops": ["trunc')
        svc2 = _service(pkg, tmp_path)
        try:
            q = svc2.result("k1", timeout=120)
            assert q["seq"] == 1   # the torn delta was never admitted
            # the next append repairs the tail first
            r2 = svc2.submit("k1", _ops(pkg, h1[:2]), seq=2)
        finally:
            svc2.close()
        return [ref, q, r2]

    _both(scenario)


def test_service_backpressure_bounds_memory_and_sheds():
    """A producer outpacing the device (the worker starts stopped):
    memory stays bounded, overload answers are structured sheds, and
    every accepted delta is accounted for."""
    h = [dict(o) for o in ref_histories.rand_register_history(
        n_ops=40, n_processes=4, n_values=3, seed=21)]

    def scenario(pkg):
        svc = _service(pkg, per_key_queue=2, global_bound=24,
                       high_water=16, start_worker=False)
        try:
            out = {"acks": [svc.submit(f"key-{(i // 4) % 3}",
                                       _ops(pkg, h[i:i + 4]), timeout=0.02)
                            for i in range(0, len(h) - 3, 4)],
                   "flooded": svc.stats()}
            svc.start_worker()
            assert svc.drain(timeout=120)
            out["results"] = [svc.result(f"key-{k}", timeout=60)
                              for k in range(3)]
            out["drained"] = svc.stats()
        finally:
            svc.close()
        return out

    _, port = _both(scenario)
    sheds = [r for r in port["acks"] if r.get("shed")]
    assert sheds and all(r["reason"] for r in sheds)
    assert any("high-water" in r["reason"] for r in sheds)
    assert port["flooded"]["pending_ops"] <= 16
    assert port["flooded"]["max_pending_seen"] <= 24
    assert sum(r["seq"] for r in port["results"]) \
        == sum(1 for r in port["acks"] if r.get("accepted"))
    assert port["drained"]["pending_ops"] == 0


def test_service_concurrent_same_seq_submitters_one_wins():
    """Two producers racing one explicit seq while the queue is full:
    exactly one is admitted, the other gets a duplicate after its wait."""
    h = [dict(o) for o in ref_histories.rand_register_history(
        n_ops=12, n_processes=3, seed=8)]
    svc = _service("port", per_key_queue=1, start_worker=False)
    try:
        assert svc.submit("k", _ops("port", h[:4]), seq=1)["accepted"]
        outs = [None, None]

        def racer(i):
            outs[i] = svc.submit("k", _ops("port", h[4:8]), seq=2,
                                 timeout=5)

        ts = [threading.Thread(target=racer, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        time.sleep(0.2)
        svc.start_worker()
        for t in ts:
            t.join(timeout=30)
        kinds = sorted("accepted" if o.get("accepted") else "rejected"
                       for o in outs)
        assert kinds == ["accepted", "rejected"], outs
        assert svc.drain(timeout=60)
        r = svc.result("k", timeout=30)
        assert r["seq"] == 2
    finally:
        svc.close()
    assert {k: r.get(k) for k in PIN} \
        == {k: _ref_one_shot(h[:8]).get(k) for k in PIN}


def test_service_evict_thaw_midstream(tmp_path):
    """An idle key is evicted to the checkpoint store and thawed by its
    next delta: the thaw resumes from the frozen frontier (the result's
    resumed-from-event, the reference's), and nothing is rescanned."""
    h1, _ = _register_streams()

    def scenario(pkg):
        svc = _service(pkg, tmp_path, evict_idle_secs=0.1)
        try:
            out = [svc.submit("k", _ops(pkg, h1[:24]), wait=True,
                              timeout=120)]
            deadline = time.time() + 30
            while svc.stats()["keys_live"] > 0 and time.time() < deadline:
                time.sleep(0.02)
            assert svc.stats()["keys_live"] == 0, "idle key never evicted"
            cps = os.listdir(tmp_path / pkg / "wal" / "checkpoints")
            assert any(n.endswith(".npz") for n in cps), cps
            out.append(svc.status()["keys"]['"k"']["state"])
            with open(svc._cps._paths("k")[1]) as fh:
                out.append(json.load(fh)["event_index"])
            out.append(svc.submit("k", _ops(pkg, h1[24:]), wait=True,
                                  timeout=120))
            out.append(svc.status()["keys"]['"k"']["acct"])
        finally:
            svc.close()
        return out

    _, port = _both(scenario)
    assert port[1] == "evicted"
    # resumed at the frozen event, not rescanned from event 0
    assert port[3]["stream"]["resumed-from-event"] == port[2] > 0
    assert port[4]["replays"] == 1
    assert {k: port[3].get(k) for k in PIN} \
        == {k: _ref_one_shot(h1).get(k) for k in PIN}


# ------------------------------------------------------------- tenants

TWO = [("ten-a", {"token": "tok-a"}), ("ten-b", {"token": "tok-b"})]


def test_service_tenant_auth_and_isolation():
    h1, _ = _register_streams()

    def scenario(pkg):
        svc = _service(pkg, tenants=TWO)
        try:
            return [svc.submit("ka", _ops(pkg, h1[:8]), token="tok-a"),
                    svc.submit("ka", _ops(pkg, h1[8:]), token="zz"),
                    svc.submit("ka", _ops(pkg, h1[8:])),
                    svc.submit("ka", _ops(pkg, h1[8:]), tenant="nobody"),
                    svc.submit("ka", _ops(pkg, h1[8:]), token="tok-b"),
                    svc.result("ka", token="tok-b"),
                    svc.finalize("ka", token="tok-b"),
                    svc.result("ka", timeout=60, token="tok-a"),
                    svc.result("ka", timeout=60, tenant="ten-a"),
                    svc.result("ka"),
                    svc.finalize("ka")]
        finally:
            svc.close()

    _, port = _both(scenario)
    assert port[0]["accepted"] and port[0]["tenant"] == "ten-a"
    assert "unauthorized" in port[1]["error"]
    assert "tenant required" in port[2]["error"]
    assert "unknown tenant" in port[3]["error"]
    assert all("another tenant" in r["error"] for r in port[4:7])
    assert port[7]["valid?"] is not None
    assert "tenant required" in port[9]["error"]


def test_service_tenant_quota_sheds_immediately():
    h = [dict(o) for o in ref_histories.rand_register_history(
        n_ops=40, n_processes=4, n_values=3, seed=22)]

    def scenario(pkg):
        svc = _service(pkg, tenants=[("ten-q", {"token": "tq",
                                                "max_pending_ops": 8,
                                                "max_keys": 1})],
                       start_worker=False)
        try:
            t0 = time.monotonic()
            out = [svc.submit("q1", _ops(pkg, h[:8]), token="tq"),
                   svc.submit("q1", _ops(pkg, h[8:16]), token="tq",
                              timeout=30)]
            assert time.monotonic() - t0 < 5   # never sat out the timeout
            out += [svc.submit("q2", _ops(pkg, h[:4]), token="tq"),
                    svc.status()]
        finally:
            svc.close(drain=False)   # the worker never ran, by design
        return out

    _, port = _both(scenario)
    assert port[1]["shed"] and "pending-ops quota" in port[1]["reason"]
    assert port[2]["shed"] and "key quota" in port[2]["reason"]
    assert '"q2"' not in port[3]["keys"]
    st = port[3]["tenants"]["ten-q"]
    assert st["acct"]["sheds"] == 2 and st["pending_ops"] == 8


def test_service_tenant_wal_quota_and_its_lifting_after_archiving(tmp_path):
    h = [dict(o) for o in ref_histories.rand_register_history(
        n_ops=24, n_processes=3, seed=27)]

    def scenario(pkg):
        svc = _service(pkg, tmp_path, tenants=[
            ("ten-w", {"token": "tw", "max_wal_bytes": 64})])
        wal = tmp_path / pkg / "wal"
        try:
            out = [svc.submit("wk", _ops(pkg, h[:8]), token="tw",
                              timeout=60)]
            svc.drain(timeout=60)
            out += [svc.submit("wk", _ops(pkg, h[8:16]), token="tw",
                               timeout=30),
                    svc.status()["tenants"]["ten-w"]]
            # the operator archives the key's segments
            for name in os.listdir(wal):
                if name.endswith(".wal"):
                    os.remove(wal / name)
            out.append(svc.submit("wk", _ops(pkg, h[8:16]), token="tw",
                                  timeout=60))
            svc.drain(timeout=60)
        finally:
            svc.close()
        return out

    _, port = _both(scenario)
    assert port[1]["shed"] and "WAL-bytes quota" in port[1]["reason"]
    assert port[2]["wal_bytes"] > 64
    assert port[3]["accepted"]


def test_tenant_flood_never_sheds_the_quiet_tenant():
    h = [dict(o) for o in ref_histories.rand_register_history(
        n_ops=200, n_processes=4, n_values=3, seed=24)]

    def scenario(pkg):
        svc = _service(pkg, tenants=[("fp-flood", {"token": "tf"}),
                                     ("fp-quiet", {"token": "tq2"})],
                       global_bound=200, high_water=100,
                       start_worker=False)
        try:
            out = [svc.submit("fkey", _ops(pkg, h[i:i + 4]), token="tf",
                              timeout=0.05) for i in range(0, 160, 4)]
            out += [svc.submit("qkey", _ops(pkg, h[i:i + 4]), token="tq2",
                               timeout=5) for i in range(0, 40, 4)]
            out += [svc.status()["tenants"], svc.stats()]
            svc.start_worker()
            assert svc.drain(timeout=120)
            out.append(svc.result("qkey", timeout=60, token="tq2"))
        finally:
            svc.close()
        return out

    _, port = _both(scenario)
    flood = [r for r in port[:40] if r.get("shed")]
    assert flood and all(r["tenant"] == "fp-flood" for r in flood)
    assert all(r.get("accepted") for r in port[40:50])
    assert port[50]["fp-quiet"]["acct"]["sheds"] == 0
    assert port[51]["pending_ops"] <= 100
    assert port[52]["seq"] == 10


def test_tenant_drr_take_order_respects_weights():
    """With equal backlogs one worker cycle takes ops in proportion to
    the tenants' weights (3:1), and the rest stays queued."""
    h = [dict(o) for o in ref_histories.rand_register_history(
        n_ops=96, n_processes=4, seed=25)]

    def scenario(pkg):
        svc = _service(pkg, tenants=[("drr-big", {"token": "b3",
                                                  "weight": 3}),
                                     ("drr-small", {"token": "s1"})],
                       global_bound=4096, high_water=0, drr_quantum=4,
                       start_worker=False)
        try:
            for i in range(0, 48, 4):
                assert svc.submit("bk", _ops(pkg, h[i:i + 4]),
                                  token="b3")["accepted"]
                assert svc.submit("sk", _ops(pkg, h[i:i + 4]),
                                  token="s1")["accepted"]
            with svc._cond:
                batch = svc._take_work_locked()
            took = {e[0].tenant: [len(e[1]), e[2], e[3]] for e in batch}
            return [took, svc.status()["tenants"]]
        finally:
            svc.close(drain=False)

    _, port = _both(scenario)
    assert port[0] == {"drr-big": [12, 3, False],
                       "drr-small": [4, 1, False]}
    assert port[1]["drr-big"]["pending_ops"] == 36
    assert port[1]["drr-small"]["pending_ops"] == 44


def test_tenant_hammer_never_reorders_a_key(tmp_path):
    """Two tenants' producers interleave deltas on one service from four
    threads: every key's stream applies in order, and each final verdict
    is the reference's one-shot check of the key's whole stream."""
    streams = {key: [dict(o) for o in ref_histories.rand_register_history(
        n_ops=20, n_processes=3, n_values=3, seed=40 + i)]
        for i, key in enumerate(("h-a1", "h-a2", "h-b1", "h-b2"))}
    svc = _service("port", tmp_path,
                   tenants=[("hm-a", {"token": "ha"}),
                            ("hm-b", {"token": "hb"})],
                   global_bound=4096, high_water=0)
    errs = []

    def producer(key, token):
        ops = streams[key]
        step = -(-len(ops) // 10)
        for seq in range(1, 11):
            lo = (seq - 1) * step
            r = svc.submit(key, _ops("port", ops[lo:lo + step]), seq=seq,
                           token=token, timeout=120)
            if not r.get("accepted"):
                errs.append((key, seq, r))
                return

    try:
        threads = [threading.Thread(target=producer, args=(k, t))
                   for k, t in (("h-a1", "ha"), ("h-a2", "ha"),
                                ("h-b1", "hb"), ("h-b2", "hb"))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs, errs
        assert svc.drain(timeout=120)
        for key, ops in streams.items():
            r = svc.result(key, timeout=60,
                           token="ha" if "-a" in key else "hb")
            assert r["seq"] == 10, (key, r)
            assert {k: r.get(k) for k in PIN} \
                == {k: _ref_one_shot(ops).get(k) for k in PIN}, key
    finally:
        svc.close()


def test_tenant_drr_finalize_waits_for_queue_drain():
    """A finalize requested while the tenant's deficit ran out mid-drain
    does not seal the key over admitted but unapplied deltas."""
    h = [dict(o) for o in ref_histories.rand_register_history(
        n_ops=48, n_processes=4, seed=26)]

    def scenario(pkg):
        svc = _service(pkg, tenants=[("fin-t", {"token": "ft"})],
                       global_bound=4096, high_water=0, drr_quantum=4,
                       start_worker=False)
        try:
            for i in range(0, len(h), 8):
                assert svc.submit("fk", _ops(pkg, h[i:i + 8]), token="ft",
                                  timeout=30)["accepted"]
            out = {}

            def fin():
                out["r"] = svc.finalize("fk", timeout=120, token="ft")

            t = threading.Thread(target=fin)
            t.start()
            time.sleep(0.1)
            svc.start_worker()   # quantum 4 against 8-op deltas
            t.join(timeout=120)
            return [out["r"]]
        finally:
            svc.close()

    _, port = _both(scenario)
    assert port[0]["seq"] == -(-len(h) // 8)
    assert {k: port[0].get(k) for k in PIN} \
        == {k: _ref_one_shot(h).get(k) for k in PIN}


def test_service_tenant_recovery_rehomes_ownership(tmp_path):
    h1, _ = _register_streams()

    def scenario(pkg):
        svc = _service(pkg, tmp_path, tenants=TWO)
        try:
            out = [svc.submit("rka", _ops(pkg, h1[:12]), token="tok-a",
                              wait=True, timeout=120)]
        finally:
            svc.close()
        # the restarted service's status before its worker starts: the
        # recovered key's row does not depend on whether the worker has
        # published the replay's verdict yet
        svc2 = _service(pkg, tmp_path, tenants=TWO, start_worker=False)
        try:
            out.append(svc2.status())
            svc2.start_worker()
            out += [svc2.submit("rka", _ops(pkg, h1[12:]), token="tok-b"),
                    svc2.result("rka", timeout=120, token="tok-a")]
        finally:
            svc2.close()
        return out

    _, port = _both(scenario)
    assert port[1]["keys"]['"rka"']["tenant"] == "ten-a"
    assert port[1]["tenants"]["ten-a"]["wal_bytes"] > 0
    assert "another tenant" in port[2]["error"]


# ------------------------------------------- ownership, migration, ops


def test_adopt_keys_then_fence_the_old_owner(tmp_path):
    """A's keys (WAL segments and frozen checkpoint pairs) copied into a
    live B: adopt_keys replays them at epoch 2 to A's verdicts, B takes
    the next delta, and A, fenced, refuses its producers."""
    h1, h2 = _register_streams()

    def scenario(pkg):
        a = _service(pkg, tmp_path / "a")
        try:
            for k, h in (("k1", h1), ("k2", h2)):
                a.submit(k, _ops(pkg, h[:12]), wait=True, timeout=120)
            assert a.freeze_key("k1")
            before = [a.result("k1", timeout=60), a.result("k2", timeout=60)]
        finally:
            a.close()
        b = _service(pkg, tmp_path / "b")
        try:
            src, dst = tmp_path / "a" / pkg / "wal", tmp_path / "b" / pkg
            shutil.copytree(src, dst / "wal", dirs_exist_ok=True)
            adopted = sorted(b.adopt_keys())
            out = [adopted, b.adopt_keys(), before,
                   b.result("k1", timeout=120), b.result("k2", timeout=120),
                   b.submit("k1", _ops(pkg, h1[12:]), wait=True,
                            timeout=120),
                   {k: r["epoch"] for k, r in b.status()["keys"].items()}]
        finally:
            b.close()
        a2 = _service(pkg, tmp_path / "a")
        try:
            fence = a2.fence_key_ownership("k1", owner="replica-b")
            out += [fence, a2.submit("k1", _ops(pkg, h1[12:])),
                    a2.result("k1"), a2.finalize("k1"),
                    a2.status()["keys"]['"k1"']["state"]]
        finally:
            a2.close()
        return out

    _, port = _both(scenario)
    assert port[0] == ["k1", "k2"] and port[1] == []
    assert {k: port[3].get(k) for k in PIN} \
        == {k: port[2][0].get(k) for k in PIN}
    assert port[6] == {'"k1"': 2, '"k2"': 2}
    assert port[7]["epoch"] == 2
    assert all(r["fenced"] for r in port[8:11])
    assert port[11] == "fenced"


def test_freeze_key_and_steal_key(tmp_path):
    h1, _ = _register_streams()

    def scenario(pkg):
        dev = None if pkg == "ref" else "cpu"
        svc = _service(pkg, tmp_path, start_worker=False)
        try:
            svc.submit("k", _ops(pkg, h1[:12]))
            out = [svc.freeze_key("k"), svc.steal_key("k", dev),
                   svc.freeze_key("nope"), svc.steal_key("nope", dev)]
            svc.start_worker()
            assert svc.drain(timeout=120)
            out += [svc.freeze_key("k"), svc.status()["keys"]['"k"'],
                    svc.freeze_key("k"),
                    svc.submit("k", _ops(pkg, h1[12:18]), wait=True,
                               timeout=120),
                    svc.steal_key("k", dev), svc.stats()["keys_live"],
                    svc.submit("k", _ops(pkg, h1[18:]), wait=True,
                               timeout=120)]
        finally:
            svc.close()
        return out

    _, port = _both(scenario)
    assert port[:4] == [False, False, False, False]
    assert port[4] is True and port[5]["state"] == "evicted"
    assert port[6] is False and port[8] is True and port[9] == 0
    assert {k: port[10].get(k) for k in PIN} \
        == {k: _ref_one_shot(h1).get(k) for k in PIN}
    # without a checkpoint store an idle session moves in memory
    svc = _service("port")
    try:
        svc.submit("k", _ops("port", h1[:12]), wait=True, timeout=120)
        assert svc.steal_key("k", "cpu")
        assert svc._keys["k"].session.device == torch.device("cpu")
        assert svc.submit("k", _ops("port", h1[12:]), wait=True,
                          timeout=120)["valid?"] is not None
    finally:
        svc.close()


def test_status_rows_and_health_checks(tmp_path):
    h1, h2 = _register_streams()

    def scenario(pkg):
        svc = _service(pkg, tmp_path, tenants=TWO, start_worker=False)
        try:
            out = [svc.health(), svc.status()]   # the worker not started
            svc.submit("a1", _ops(pkg, h1[:12]), token="tok-a")
            svc.submit("b1", _ops(pkg, h2[:12]), token="tok-b")
            out += [svc.status(), svc.health()]
            svc.start_worker()
            assert svc.drain(timeout=120)
            svc.finalize("b1", timeout=120, token="tok-b")
            out += [svc.status(), svc.health()]
        finally:
            svc.close()
        out.append(svc.health())   # stopped
        return out

    _, port = _both(scenario)
    assert port[0]["ok"] is False and port[0]["checks"]["worker"]["ok"] \
        is False
    assert set(port[3]["checks"]) == {"worker", "wal", "queue", "breakers",
                                      "keys"}
    assert port[3]["checks"]["breakers"] == {"ok": True, "states": {}}
    assert port[5]["ok"] is True
    rows = port[4]["keys"]
    assert rows['"a1"']["state"] == "live" and rows['"b1"']["finalized"]
    assert rows['"b1"']["verdict"] is not None \
        and rows['"a1"']["wal_bytes"] > 0
    assert port[6]["ok"] is False


# ------------------------------------------------- device faults, etc.


def _fail_once(module):
    """Make `module.ext.advance_sessions` raise on its next call only,
    as a device error in a batch's scan would."""
    real = module.ext.advance_sessions
    calls = []

    def advance(sessions, bucket=None):
        calls.append(len(sessions))
        if len(calls) == 1:
            raise RuntimeError("CUDA error: an illegal memory access "
                               "(injected)")
        return real(sessions, bucket=bucket)

    return advance, calls


@pytest.mark.parametrize("wal", [True, False], ids=["wal", "no-wal"])
def test_device_error_gives_the_batch_the_loud_unknown(tmp_path,
                                                       monkeypatch, wal):
    """A device error in one batch's scan: each key of the batch gets the
    loud unknown and loses its session. With a WAL the next delta
    thaw-replays the key to the one-shot verdict; without one the key is
    poisoned and refuses further deltas. The port has no host fallback:
    the reference's service, fed the same fault at the same seam, answers
    the same."""
    h1, h2 = _register_streams()

    def scenario(pkg):
        mod = ref_svc_mod if pkg == "ref" else svc_mod
        advance, calls = _fail_once(mod)
        monkeypatch.setattr(mod.ext, "advance_sessions", advance)
        svc = _service(pkg, tmp_path if wal else None, start_worker=False)
        try:
            svc.submit("k1", _ops(pkg, h1[:12]))
            svc.submit("k2", _ops(pkg, h2[:12]))
            svc.start_worker()
            out = [svc.result("k1", timeout=120),
                   svc.result("k2", timeout=120), svc.status()]
            out += [svc.submit("k1", _ops(pkg, h1[12:]), wait=True,
                               timeout=120),
                    svc.submit("k2", _ops(pkg, h2[12:]), wait=True,
                               timeout=120),
                    svc.health()["checks"]["keys"]]
        finally:
            svc.close()
            monkeypatch.undo()
        assert calls[0] == 2   # one batch, both keys
        return out

    _, port = _both(scenario)
    for r in port[:2]:
        assert r["valid?"] == "unknown"
        assert r["error"] == ("serve worker crashed on this key: "
                              "RuntimeError: CUDA error: an illegal "
                              "memory access (injected)")
    if wal:
        assert {k: port[3].get(k) for k in PIN} \
            == {k: _ref_one_shot(h1).get(k) for k in PIN}
        assert {k: port[4].get(k) for k in PIN} \
            == {k: _ref_one_shot(h2).get(k) for k in PIN}
        assert port[5]["poisoned"] == 0
    else:
        assert port[2]["keys"]['"k1"']["state"] == "poisoned"
        assert all("new key" in r["error"] for r in port[3:5])
        assert port[5] == {"ok": False, "total": 2, "poisoned": 2}


def test_service_on_no_card_raises(monkeypatch):
    """device=None is the card: without one the service refuses to
    start instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckerService(models.CASRegister())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckerService(models.CASRegister(), device="cuda")
