"""The port's delta tracing (jepsen_tpu_torch.serve with
JEPSEN_TPU_TORCH_TRACE / _FLIGHT_RECORDER / _SLOW_DELTA_SECS) against the
reference's (jepsen_tpu.serve under the JEPSEN_TPU_* flags), on the same
deltas: tests/test_delta_trace.py's cases that need neither the fleet
trace merge nor the CLI.

* Unarmed, acks carry no ``delta_id``, WAL records no ``"id"`` and
  ``status()`` no slow-delta keys: the acks and the WAL bytes are the
  reference's unarmed service's, and the record keys those the service
  wrote before tracing existed.
* Armed, with explicit ids, the acks, the ``wait=True`` answers and the
  WAL bytes equal the reference's exactly; each package's armed WAL
  replays in the other with its ids, and the synthesized
  ``wal-{digest}-{seq}`` ids of records without one are equal on the
  same files, both ways.
* The span chains (``serve.admit``, ``serve.wal``, ``serve.apply``,
  ``serve.advance``, ``serve.publish``, ``serve.thaw``, the transports'
  request spans, the ring's transfer) are equal as (name, parent name,
  delta id) sets — through a migration, and under the HTTP ingress,
  whose request span parents the service's chain across the executor
  hop.
* Slow-delta records (stage breakdown, worst-offender flight dump), the
  ring's bound and scopes, the flag's validation, ``/trace`` off, on and
  flight-only, and a dump's trigger block.

Fields measured in seconds are compared by presence, key set and type
(``torch_fleet_cases.TIMES``); every other field exactly."""

import json
import os
import urllib.request
from io import StringIO

import pytest
import torch

from torch_fleet_cases import (
    PKGS, armed, register_history, same, serve_chain, service, unarmed,
)
from torch_jax_cache import release_compiled_programs  # noqa: F401

from jepsen_tpu.serve import ingress as ref_ingress
from jepsen_tpu.serve import stdio as ref_stdio
from jepsen_tpu_torch.serve import ingress as ingress_mod
from jepsen_tpu_torch.serve import stdio as stdio_mod
from jepsen_tpu_torch.serve.stdio import jsonable

INGRESS = {"ref": ref_ingress, "port": ingress_mod}
STDIO = {"ref": ref_stdio, "port": stdio_mod}


@pytest.fixture(autouse=True)
def _unarmed(monkeypatch):
    unarmed(monkeypatch)
    for P in PKGS.values():
        P.obs.drain_slow_deltas()
    yield
    unarmed(monkeypatch)
    for P in PKGS.values():
        P.obs.drain_slow_deltas()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _h(n=16, seed=11):
    return register_history(seed=seed, corrupt=False, n_ops=n)


def _ops(pkg, op_dicts):
    return [PKGS[pkg].Op(o) for o in op_dicts]


def _wal_bytes(pkg, wal_dir, key) -> list:
    return [open(p, "rb").read()
            for p in PKGS[pkg].WAL(str(wal_dir)).segments(key)]


# ------------------------------------------------------ id lifecycle


def test_unarmed_service_equals_reference_and_parent(tmp_path):
    """Every tracing flag unset: acks without ``delta_id`` (an explicit
    one is ignored), WAL records of exactly the fields the service wrote
    before tracing, no slow-delta keys on ``status()`` and no ``slo``
    check — and the acks, the WAL bytes, ``status()`` and ``health()``
    equal the reference's unarmed service's."""
    h = _h()

    def scenario(pkg):
        # both deltas queue before the worker starts: the status's
        # max_pending_seen does not depend on when the worker wakes
        svc = service(pkg, tmp_path / pkg, start_worker=False)
        try:
            out = [svc.submit("k", _ops(pkg, h[:8]), timeout=30),
                   svc.submit("k", _ops(pkg, h[8:]), timeout=30,
                              delta_id="should-vanish")]
            svc.start_worker()
            assert svc.drain(timeout=120)
            out += [svc.status(), svc.health()]
        finally:
            svc.close()
        out.append(_wal_bytes(pkg, tmp_path / pkg, "k"))
        return out

    ref, port = (scenario("ref"), scenario("port"))
    assert port[4] == ref[4]            # the WAL bytes
    same(ref[:4], port[:4])
    assert all(a["accepted"] and "delta_id" not in a for a in port[:2])
    assert "slow_deltas" not in port[2] and "slow_delta_secs" not in port[2]
    assert "slo" not in port[3]["checks"]
    for seg in port[4]:
        for line in seg.decode().splitlines()[1:]:
            assert sorted(json.loads(line)) == ["ops", "seq"]


def test_armed_acks_wal_bytes_and_span_chain(tmp_path, monkeypatch):
    """Tracing on, every delta with an explicit id: the acks and the
    ``wait=True`` answers carry it, the WAL records persist it, and the
    acks, the WAL bytes and the span chains equal the reference's. A
    delta without an id gets a minted one, the same on its ack, its WAL
    record and its spans."""
    armed(monkeypatch, TRACE="1")
    h = _h(24)

    def scenario(pkg):
        svc = service(pkg, tmp_path / pkg)
        try:
            out = [svc.submit("k", _ops(pkg, h[:8]), wait=True,
                              timeout=120, delta_id="id-1"),
                   svc.submit("k", _ops(pkg, h[8:16]), timeout=60,
                              delta_id="id-2"),
                   svc.result("k", timeout=120),
                   svc.submit("k", _ops(pkg, h[8:16]), seq=2,
                              delta_id="id-dup")]
            chain = serve_chain(pkg)
            minted = svc.submit("k", _ops(pkg, h[16:]), wait=True,
                                timeout=120)
        finally:
            svc.close()
        ids = PKGS[pkg].WAL(str(tmp_path / pkg)).delta_ids("k")
        return out, chain, minted, ids, _wal_bytes(pkg, tmp_path / pkg,
                                                   "k")[:1]

    ref, port = scenario("ref"), scenario("port")
    same(ref[0], port[0])
    assert port[0][0]["delta_id"] == "id-1"
    assert port[0][1] == {"accepted": True, "seq": 2, "key": "k",
                          "delta_id": "id-2"}
    assert port[0][3] == {"duplicate": True, "seq": 2, "key": "k"}
    assert port[1] == ref[1]
    names = {t[0] for t in port[1]}
    assert {"serve.admit", "serve.wal", "serve.apply", "serve.advance",
            "serve.publish"} <= names
    assert ("serve.admit", None, "id-1") in port[1]
    assert ("serve.wal", None, "id-2") in port[1]
    assert ("serve.apply", None, ("id-2",)) in port[1]
    minted = port[2]["delta_id"]
    assert len(minted) == 16 and int(minted, 16) >= 0
    assert port[3] == {1: "id-1", 2: "id-2", 3: minted}
    assert ref[3][3] == ref[2]["delta_id"] != minted
    # the first segment's bytes (header and the id-1/id-2 records)
    assert b'"id": "id-1"' in port[4][0]
    assert port[4][0].split(b"\n")[:3] == ref[4][0].split(b"\n")[:3]


@pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                           ("ref", "port")])
def test_ids_replay_in_the_other_package(tmp_path, monkeypatch, writer,
                                         reader):
    """A WAL written unarmed (records without ids) and then armed: the
    synthesized ``wal-{digest}-{seq}`` ids and the stamped ones read
    equal by both packages' ``delta_ids`` and ``replay_with_ids`` on the
    same files, and the other package's armed service, restarted on
    them, re-tags its replay spans with those ids."""
    h = _h(24)
    wal = tmp_path / "wal"
    svc = service(writer, wal)
    try:
        svc.submit("k", _ops(writer, h[:8]), wait=True, timeout=120)
    finally:
        svc.close()
    armed(monkeypatch, TRACE="1")
    svc = service(writer, wal)
    try:
        svc.submit("k", _ops(writer, h[8:16]), timeout=60,
                   delta_id="stamped-2")
    finally:
        svc.close(drain=False)
    ids = {pkg: PKGS[pkg].WAL(str(wal)).delta_ids("k") for pkg in PKGS}
    replayed = {pkg: PKGS[pkg].WAL(str(wal)).replay_with_ids("k")[1]
                for pkg in PKGS}
    assert ids["port"] == ids["ref"] == replayed["port"] \
        == replayed["ref"]
    assert ids["port"][1].startswith("wal-") \
        and ids["port"][2] == "stamped-2"
    PKGS[reader].obs.reset()
    svc = service(reader, wal)
    try:
        r = svc.submit("k", _ops(reader, h[16:]), wait=True, timeout=120,
                       delta_id="after-3")
    finally:
        svc.close()
    assert r["seq"] == 3 and r["delta_id"] == "after-3"
    applied = {i for name, _p, tagged in serve_chain(reader)
               if name == "serve.apply" for i in tagged}
    assert {ids["port"][1], "stamped-2", "after-3"} <= applied
    assert PKGS[reader].WAL(str(wal)).delta_ids("k") \
        == {**ids["port"], 3: "after-3"}


def test_migrated_delta_chain_reads_across_replicas(tmp_path,
                                                    monkeypatch):
    """A key admitted on one replica and migrated to another: the
    destination's thaw/apply spans carry the id the source stamped (it
    rode the transferred WAL segments), and the chain, the ring's
    transfer span included, equals the reference's."""
    armed(monkeypatch, TRACE="1")
    h = _h(24)

    def scenario(pkg):
        P = PKGS[pkg]
        dirs = {n: str(tmp_path / pkg / n) for n in ("ra", "rb")}
        svcs = {n: service(pkg, d) for n, d in dirs.items()}
        router = P.ring.Router(svcs, dirs)
        try:
            key = "mig-k"
            src = router.owner(key)
            dst = [n for n in svcs if n != src][0]
            r = router.submit(key, _ops(pkg, h[:12]), wait=True,
                              timeout=120, delta_id="mig-1")
            router.migrate_key(key, dst)
            r2 = router.submit(key, _ops(pkg, h[12:]), wait=True,
                               timeout=120, delta_id="mig-2")
        finally:
            for s in svcs.values():
                s.close()
        return [r, r2], serve_chain(pkg)

    ref, port = scenario("ref"), scenario("port")
    same(ref[0], port[0])
    assert port[1] == ref[1]
    tagged = [t for t in port[1] if t[0] in ("serve.thaw", "serve.apply")
              and "mig-1" in (t[2] or ())]
    assert len(tagged) >= 2, port[1]
    assert ("serve.ring.transfer", None, None) in port[1]


# ------------------------------------------------ slow-delta forensics


def test_slow_delta_records_on_status_and_export(tmp_path, monkeypatch):
    """A tiny threshold makes every delta slow: the threshold alone arms
    ids, ``status()`` carries the ring with each record's stage
    breakdown, and ``export_run`` drains it to slow_deltas.jsonl (tracing
    off) — the documents equal the reference's, times by shape."""
    armed(monkeypatch, SLOW_DELTA_SECS="0.00001")
    h = _h()

    def scenario(pkg):
        P = PKGS[pkg]
        svc = service(pkg, tmp_path / pkg / "w")
        try:
            out = [svc.submit("slow-k", _ops(pkg, h[:8]), wait=True,
                              timeout=120, delta_id="s-1"),
                   svc.submit("slow-k", _ops(pkg, h[8:]), wait=True,
                              timeout=120, delta_id="s-2")]
            assert svc.drain(timeout=60)
            out.append(svc.status())
        finally:
            svc.close()
        run = tmp_path / pkg / "run"
        arts = P.obs.export_run(str(run))
        lines = [json.loads(ln) for ln in
                 open(os.path.join(str(run), "slow_deltas.jsonl"))]
        again = P.obs.export_run(str(tmp_path / pkg / "run2"))
        return out, sorted(arts), lines, again

    ref, port = scenario("ref"), scenario("port")
    same(ref[:2], port[:2])
    assert port[1] == ref[1] and port[3] is None and ref[3] is None
    st = port[0][2]
    assert st["slow_delta_secs"] == pytest.approx(0.00001)
    recs = st["slow_deltas"]
    assert [r["delta_id"] for r in recs] == ["s-1", "s-2"]
    rec = recs[0]
    assert rec["key"] == "slow-k" and rec["seq"] == 1 \
        and rec["verdict"] is True
    assert set(rec["stages"]) == {"backpressure", "wal", "queue",
                                  "device", "publish"}
    assert rec["slowest_stage"] in rec["stages"]
    # the wal stage is an fsync duration concurrent with queue/device
    assert rec["total_secs"] >= (sum(rec["stages"].values())
                                 - rec["stages"]["wal"] - 1e-3)
    same(ref[2], port[2])
    assert [r["delta_id"] for r in port[2]] == ["s-1", "s-2"]


def test_slow_delta_worst_offender_flight_dump(tmp_path, monkeypatch):
    """The worst offender dumps the flight ring with a trigger block
    naming the slow-delta record; the dumps and triggers equal the
    reference's, times by shape."""
    armed(monkeypatch, SLOW_DELTA_SECS="0.00001", FLIGHT_RECORDER="1")
    h = _h()

    def scenario(pkg):
        P = PKGS[pkg]
        P.obs.flight_reset()
        flight = tmp_path / pkg / "flight"
        P.obs.set_flight_dir(str(flight))
        svc = service(pkg)
        try:
            svc.submit("fk", _ops(pkg, h[:8]), wait=True, timeout=120,
                       delta_id="f-1")
        finally:
            svc.close()
        dumps = sorted(f for f in os.listdir(flight)
                       if f.startswith("flight_slow-delta"))
        return dumps, json.load(open(flight / dumps[0]))["flight"][
            "trigger"]

    ref, port = scenario("ref"), scenario("port")
    same(ref, port)
    trig = port[1]
    assert trig["key"] == "fk" and trig["delta_id"] == "f-1" \
        and trig["stages"]["device"] >= 0


def test_slow_delta_ring_bounded_and_scoped():
    """The ring keeps the newest records past its bound, and two scopes
    neither read each other's records nor mute each other's worst
    offender; the drain stays process-wide — as the reference's."""
    def run(P):
        from importlib import import_module
        mod = import_module(P.obs.__name__ + ".export")
        P.obs.drain_slow_deltas()
        n = mod.SLOW_DELTA_MAX_RECORDS
        for i in range(n + 10):
            P.obs.record_slow_delta({"delta_id": f"d{i}",
                                     "total_secs": 0.001})
        recs = P.obs.slow_delta_records()
        out = [n, len(recs), recs[0], recs[-1],
               bool(P.obs.drain_slow_deltas()), P.obs.slow_delta_records()]
        s1, s2 = object(), object()
        out += [P.obs.record_slow_delta({"key": "k1", "total_secs": 10.0},
                                        scope=s1),
                P.obs.record_slow_delta({"key": "k2", "total_secs": 8.0},
                                        scope=s2),
                P.obs.record_slow_delta({"key": "k3", "total_secs": 9.0},
                                        scope=s1),
                P.obs.slow_delta_records(s1), P.obs.slow_delta_records(s2),
                len(P.obs.slow_delta_records()),
                P.obs.drain_slow_deltas(), P.obs.slow_delta_records()]
        return out

    port, ref = run(PKGS["port"]), run(PKGS["ref"])
    assert port == ref
    assert port[2]["delta_id"] == "d10" and port[6:9] == [True, True,
                                                          False]


@pytest.mark.parametrize("value", ["quick", "-1", "nan"])
def test_slow_delta_flag_is_validated(monkeypatch, value):
    errs = {}
    for pkg, P in PKGS.items():
        monkeypatch.setenv(P.FLAG + "SLOW_DELTA_SECS", value)
        with pytest.raises(ValueError) as ei:
            service(pkg, start_worker=False)
        errs[pkg] = str(ei.value)
        monkeypatch.delenv(P.FLAG + "SLOW_DELTA_SECS")
    assert errs["port"] == errs["ref"].replace("JEPSEN_TPU_",
                                               "JEPSEN_TPU_TORCH_")


# ------------------------------------------------ the transports


def test_ingress_span_parents_service_chain(tmp_path, monkeypatch):
    """Over the HTTP ingress, the service's ``serve.admit`` span is a
    descendant of ``serve.ingress.request`` (the per-call Context.copy
    across the executor hop), the request span carries the ack's id,
    and the chain equals the reference's."""
    armed(monkeypatch, TRACE="1")
    h = _h()

    def scenario(pkg):
        svc = service(pkg, tmp_path / pkg)
        ing = INGRESS[pkg].DeltaIngress(svc, port=0).start()
        try:
            body = "".join(json.dumps(line) + "\n" for line in (
                {"key": "ik", "ops": h[:8], "wait": True, "timeout": 120,
                 "delta_id": "in-1"},
                {"key": "ik", "ops": h[8:], "wait": True,
                 "timeout": 120}))
            req = urllib.request.Request(ing.url("/v1/deltas"),
                                         data=body.encode())
            with urllib.request.urlopen(req, timeout=120) as resp:
                out = [json.loads(ln)
                       for ln in resp.read().decode().splitlines()]
        finally:
            ing.close()
            svc.close()
        spans = {s.sid: s for s in PKGS[pkg].obs.tracer().spans()}
        admit = [s for s in spans.values() if s.name == "serve.admit"
                 and s.args.get("delta_id") == "in-1"]
        assert admit, pkg
        cur = admit[0]
        while cur.name != "serve.ingress.request":
            cur = spans[cur.parent]
        minted = out[1]["delta_id"]

        def named(i):
            if isinstance(i, tuple):
                return tuple(named(x) for x in i)
            return "minted" if i == minted else i

        chain = {(n, p, named(i)) for n, p, i in serve_chain(pkg)}
        return [{k: v for k, v in r.items() if k != "delta_id"}
                for r in out], cur.args["delta_id"], chain, minted

    ref, port = scenario("ref"), scenario("port")
    same(ref[0], port[0])
    assert port[1:3] == ref[1:3]
    assert port[1] == "in-1"
    assert ("serve.admit", "serve.ingress.request", "in-1") in port[2]
    assert ("serve.wal", "serve.ingress.request", "in-1") in port[2]
    assert ("serve.admit", "serve.ingress.request", "minted") in port[2]
    assert len(port[3]) == 16


def test_stdio_span_carries_the_delta_id(monkeypatch):
    """A stdio line's ``"delta_id"`` rides through to the ack, and the
    line's ``serve.stdio.request`` span carries it: answers and chain
    equal the reference's."""
    armed(monkeypatch, TRACE="1")
    h = _h()

    def scenario(pkg):
        out = StringIO()
        lines = [json.dumps({"key": "sk", "ops": h[:8],
                             "delta_id": "st-1"}),
                 json.dumps({"op": "drain", "timeout": 120}),
                 json.dumps({"op": "result", "key": "sk"}),
                 json.dumps({"op": "stop"})]
        rc = STDIO[pkg].run_stdio(service(pkg), lines, out)
        return rc, [json.loads(ln) for ln in out.getvalue().splitlines()], \
            serve_chain(pkg)

    ref, port = scenario("ref"), scenario("port")
    same(ref[:2], port[:2])
    assert port[1][0] == {"accepted": True, "seq": 1, "key": "sk",
                          "delta_id": "st-1"}
    assert port[2] == ref[2]
    assert ("serve.stdio.request", None, "st-1") in port[2]
    assert ("serve.admit", "serve.stdio.request", "st-1") in port[2]


# ------------------------------------------------ /trace and the dumps


def _trace(pkg):
    """GET /trace of a bare ops server -> (status, the document with
    its replica name, the server's address, replaced by "rep")."""
    srv = PKGS[pkg].httpd.OpsServer().start()
    addr = f"{srv.host}:{srv.port}"
    try:
        with urllib.request.urlopen(f"http://{addr}/trace",
                                    timeout=30) as resp:
            doc = json.loads(resp.read().decode())
    finally:
        srv.close()
    assert doc["trace"]["replica"] == addr
    doc["trace"]["replica"] = "rep"
    return resp.status, doc


def test_trace_endpoint_off_on_and_flight_only(monkeypatch):
    """``GET /trace``: tracing off answers the empty trace with the
    replica's address; on, the spans with their ids and the wall-clock
    epoch; with only the flight recorder, the ring's spans — each
    document's shape the reference's."""
    docs = {}
    for mode, flags in (("off", {}), ("on", {"TRACE": "1"}),
                        ("flight", {"FLIGHT_RECORDER": "16"})):
        armed(monkeypatch, **flags)
        for pkg, P in PKGS.items():
            with P.obs.span("serve.admit", key="k", delta_id=f"t-{mode}"):
                pass
            docs[mode, pkg] = _trace(pkg)
    assert docs["off", "port"] == docs["off", "ref"] == (200, {
        "traceEvents": [],
        "trace": {"enabled": False, "replica": "rep"}})
    for mode in ("on", "flight"):
        for pkg in PKGS:
            code, doc = docs[mode, pkg]
            assert code == 200 and doc["trace"]["enabled"] is True
            assert doc["trace"]["replica"] == "rep" \
                and doc["trace"]["epoch_unix"] > 0
            xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
            assert [e["args"]["delta_id"] for e in xs] == [f"t-{mode}"]
            assert xs[0]["name"] == "serve.admit"
        assert sorted(docs[mode, "port"][1]["trace"]) \
            == sorted(docs[mode, "ref"][1]["trace"])


def test_flight_dump_context_rides_the_flight_block(tmp_path,
                                                    monkeypatch):
    armed(monkeypatch, FLIGHT_RECORDER="1")
    out = {}
    for pkg, P in PKGS.items():
        with P.obs.span("some.work"):
            pass
        d = tmp_path / pkg
        p1 = P.obs.flight_dump("unit-test", dest_dir=str(d),
                               context={"delta_id": "d1", "key": "k1",
                                        "tenant": "t1"})
        p2 = P.obs.flight_dump("unit-test-2", dest_dir=str(d))
        out[pkg] = [os.path.basename(p1), json.load(open(p1))["flight"],
                    os.path.basename(p2),
                    "trigger" in json.load(open(p2))["flight"]]
    port, ref = out["port"], out["ref"]
    assert port[1]["trigger"] == ref[1]["trigger"] == {
        "delta_id": "d1", "key": "k1", "tenant": "t1"}
    assert port[0] == ref[0] and port[2] == ref[2]
    assert port[3] is ref[3] is False
    assert jsonable(port[1]["reason"]) == "unit-test"
