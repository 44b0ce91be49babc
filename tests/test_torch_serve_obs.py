"""The port's serve telemetry, SLO tracker and breaker registry
(jepsen_tpu_torch.serve.service, obs.slo, resilience.breaker, the ops
server's refresh hook) against the reference's, on the same deltas:

* the ``serve.*`` counters, gauges and histograms a scenario moves (each
  package's registry delta: counters and gauge levels exactly, a
  histogram's count), the /metrics names they render to, and the
  refreshed gauges; a scrape during a worker batch never waits on it;
* the /metrics half of tests/test_serve.py's fairness pin: the quiet
  tenant's labeled ack histogram and the flood's labeled sheds;
* tests/test_ledger.py's SLO cases on a fake clock (burn rates equal),
  and the service's armed-only ``slo`` check;
* the breaker registry (tests/test_obs_httpd.py's /healthz flip and
  flight dump, the registry's snapshots and trip set, and
  tests/test_fleet.py's fleet breakers outside the trip set);
* the flight dumps ``serve-shed``, ``serve-worker-error`` and
  ``fleet-rehome-<name>``, and the WAL's counters;
* the entry point on the CPU with its ops endpoint: the refresh hook,
  ``/trace`` and ``GET /``.

Fields measured in seconds are compared by presence, key set and type
(``torch_fleet_cases.TIMES``); every other field exactly."""

import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from torch_fleet_cases import (
    PKGS, armed, register_history, same, service, unarmed,
)
from torch_jax_cache import release_compiled_programs  # noqa: F401

from jepsen_tpu.obs import slo as ref_slo
from jepsen_tpu.serve import Tenant as RefTenant
from jepsen_tpu.serve import service as ref_svc_mod
from jepsen_tpu_torch.obs import slo
from jepsen_tpu_torch.serve import Tenant
from jepsen_tpu_torch.serve import service as svc_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLO = {"ref": ref_slo, "port": slo}
SVC_MOD = {"ref": ref_svc_mod, "port": svc_mod}
TENANT = {"ref": RefTenant, "port": Tenant}


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


def _ops(pkg, op_dicts):
    return [PKGS[pkg].Op(o) for o in op_dicts]


def _tenants(pkg, specs):
    return [TENANT[pkg](name, **spec) for name, spec in specs]


def _serve_delta(pkg, before) -> dict:
    """What `pkg`'s registry moved since `before` under ``serve.``:
    counters and gauge levels exactly, a histogram's count (its times
    differ run to run)."""
    out = {}
    for name, m in PKGS[pkg].obs.registry().delta(before).items():
        if not name.startswith("serve."):
            continue
        if m["type"] == "histogram":
            out[name] = ("histogram", m["count"])
        else:
            out[name] = (m["type"], m["value"])
    return out


def _prom_names(pkg, names) -> set:
    """The /metrics sample names `names` render to (a histogram's
    ``_bucket``, ``_sum``, ``_count`` and ``_max``, labels stripped)."""
    P = PKGS[pkg]
    snap = P.obs.registry().snapshot()
    text = P.httpd.render_prometheus({n: snap[n] for n in names})
    return {re.split(r"[{ ]", ln, 1)[0] for ln in text.splitlines()
            if not ln.startswith("#")}


# ------------------------------------------------ counters and gauges


def test_unarmed_serve_metrics_equal_reference(tmp_path):
    """Every flag off: one scenario through admission (accepted,
    duplicate, gap, unauthorized, the pending-ops and key quota sheds),
    the worker, finalize, a restart's replay, adopt_keys, freeze and
    steal — the acks and documents, every ``serve.*`` counter, gauge
    level and histogram count, and the /metrics names equal the
    reference's."""
    h = register_history(corrupt=False, n_ops=24)
    specs = [("ta", {"token": "tok-a", "max_pending_ops": 12}),
             ("tb", {"token": "tok-b", "max_keys": 1})]

    def scenario(pkg):
        P = PKGS[pkg]
        before = P.obs.registry().snapshot()
        wal = tmp_path / pkg / "wal"
        svc = service(pkg, wal, tenants=_tenants(pkg, specs),
                      start_worker=False)
        try:
            out = [svc.submit("a", _ops(pkg, h[:8]), token="tok-a"),
                   svc.submit("a", _ops(pkg, h[8:16]), token="tok-a"),
                   svc.submit("a", _ops(pkg, h[:8]), seq=1, token="tok-a"),
                   svc.submit("a", _ops(pkg, h[:8]), seq=9, token="tok-a"),
                   svc.submit("a", _ops(pkg, h[:8]), token="nope"),
                   svc.submit("b", _ops(pkg, h[:8]), token="tok-b"),
                   svc.submit("b2", _ops(pkg, h[:8]), token="tok-b"),
                   svc.result("a", token="nope")]
            svc.start_worker()
            out += [svc.submit("a", _ops(pkg, h[8:16]), wait=True,
                               timeout=120, token="tok-a"),
                    svc.finalize("b", timeout=120, token="tok-b")]
            assert svc.drain(timeout=120)
            out += [svc.freeze_key("a"), svc.steal_key("a", None
                                                       if pkg == "ref"
                                                       else "cpu")]
            svc.refresh_gauges()
            out += [svc.status(), svc.health()]
        finally:
            svc.close()
        svc2 = service(pkg, wal, tenants=_tenants(pkg, specs))
        try:
            out += [svc2.submit("a", _ops(pkg, h[16:24]), wait=True,
                                timeout=120, token="tok-a"),
                    svc2.adopt_keys()]
            svc2.refresh_gauges()
            out.append(svc2.status())
        finally:
            svc2.close()
        delta = _serve_delta(pkg, before)
        return out, delta, _prom_names(pkg, [n for n in delta])

    ref, port = scenario("ref"), scenario("port")
    same(ref[0], port[0])
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    d = port[1]
    for name, want in (("serve.deltas", 4), ("serve.sheds", 2),
                       ("serve.unauthorized", 2), ("serve.keys_admitted", 2),
                       ("serve.duplicate_deltas", 1),
                       ("serve.evictions", 1), ("serve.keys_stolen", 1),
                       ("serve.replayed_deltas", 3)):
        assert d[name] == ("counter", want), (name, d.get(name))
    assert d["serve.ack_secs"] == ("histogram", 4)
    assert d["serve.ack_secs[tenant=ta]"] == ("histogram", 3)
    assert d["serve.verdict_secs"] == ("histogram", 4)
    assert d["serve.keys_live"][0] == "gauge"
    assert d["serve.wal_lag_deltas"] == ("gauge", 0)
    assert {"jepsen_serve_ack_secs_bucket", "jepsen_serve_sheds",
            "jepsen_serve_pending_ops"} <= port[2]
    st = port[0][12]["tenants"]["ta"]
    assert isinstance(st["ack_p50"], float) \
        and isinstance(st["verdict_p99"], float)
    assert port[0][13]["checks"]["breakers"] == {"ok": True, "states": {}}
    assert "slo" not in port[0][13]["checks"]


def test_tenant_fairness_flood_metrics_half():
    """tests/test_serve.py's fairness pin, its /metrics half: the quiet
    tenant's ack histogram and the flood's sheds render as labeled
    series, the quiet tenant's ack p99 stays within its SLO, and every
    labeled count equals the reference's."""
    h = register_history(corrupt=False, n_ops=200, seed=24)
    specs = [("fp-flood", {"token": "tf"}), ("fp-quiet", {"token": "tq2"})]

    def scenario(pkg):
        P = PKGS[pkg]
        before = P.obs.registry().snapshot()
        svc = service(pkg, tenants=_tenants(pkg, specs), global_bound=200,
                      high_water=100, start_worker=False)
        try:
            flood = [svc.submit("fkey", _ops(pkg, h[i:i + 4]), token="tf",
                                timeout=0.05) for i in range(0, 160, 4)]
            quiet = [svc.submit("qkey", _ops(pkg, h[i:i + 4]),
                                token="tq2", timeout=5)
                     for i in range(0, 40, 4)]
            svc.start_worker()
            assert svc.drain(timeout=120)
            res = svc.result("qkey", timeout=60, token="tq2")
        finally:
            svc.close()
        snap = P.obs.registry().snapshot()
        hq = snap[P.obs.labeled("serve.ack_secs", tenant="fp-quiet")]
        text = P.httpd.render_prometheus()
        return ([flood, quiet, res], _serve_delta(pkg, before),
                P.obs.hist_quantile(hq, 0.99), text)

    ref, port = scenario("ref"), scenario("port")
    same(ref[0], port[0])
    assert port[1] == ref[1]
    flood, quiet, res = port[0]
    n_shed = sum(1 for r in flood if r.get("shed"))
    assert n_shed > 0 and all(r.get("accepted") for r in quiet)
    assert res["seq"] == 10
    d = port[1]
    assert d["serve.sheds[tenant=fp-flood]"] == ("counter", n_shed)
    assert "serve.sheds[tenant=fp-quiet]" not in d
    assert d["serve.ack_secs[tenant=fp-quiet]"] == ("histogram", 10)
    assert port[2] <= 2.5
    text = port[3]
    assert 'jepsen_serve_ack_secs_bucket{tenant="fp-quiet"' in text
    assert 'jepsen_serve_sheds{tenant="fp-flood"}' in text


def test_refresh_gauges_and_a_scrape_during_a_worker_batch(tmp_path,
                                                           monkeypatch):
    """``refresh_gauges`` sets the queue depth, live sessions, WAL lag
    and per-tenant depths as the reference's does; and while the worker
    is inside a batch's advance, a scrape (refresh, status, health)
    answers without waiting for it."""
    h = register_history(corrupt=False, n_ops=24)
    specs = [("ga", {"token": "g-a"})]

    def scenario(pkg):
        P = PKGS[pkg]
        svc = service(pkg, tmp_path / pkg, tenants=_tenants(pkg, specs),
                      start_worker=False)
        try:
            svc.submit("g1", _ops(pkg, h[:8]), token="g-a")
            svc.submit("g2", _ops(pkg, h[:12]), token="g-a")
            before = P.obs.registry().snapshot()
            svc.refresh_gauges()
            out = [_serve_delta(pkg, before)]
            svc.start_worker()
            assert svc.drain(timeout=120)
            before = P.obs.registry().snapshot()
            svc.refresh_gauges()
            out.append(_serve_delta(pkg, before))
        finally:
            svc.close()
        return out

    ref, port = scenario("ref"), scenario("port")
    assert port == ref
    assert port[0]["serve.pending_ops"] == ("gauge", 20)
    assert port[0]["serve.pending_ops[tenant=ga]"] == ("gauge", 20)
    assert port[1]["serve.keys_live"] == ("gauge", 2)
    # the worker held inside advance_sessions: a scrape still answers
    entered, release = threading.Event(), threading.Event()
    real = svc_mod.ext.advance_sessions

    def held(sessions, bucket=None):
        entered.set()
        release.wait(60)
        return real(sessions, bucket=bucket)

    monkeypatch.setattr(svc_mod.ext, "advance_sessions", held)
    svc = service("port", tmp_path / "held")
    try:
        svc.submit("k", _ops("port", h[:8]))
        assert entered.wait(60)
        t0 = time.monotonic()
        svc.refresh_gauges()
        st, hl = svc.status(), svc.health()
        assert time.monotonic() - t0 < 5
        assert st["keys"]['"k"']["pending_deltas"] == 0 and hl["live"]
    finally:
        release.set()
        svc.close()


# ------------------------------------------------------------ the SLO


def _burns(pkg, name, target, values_by_step, **kw):
    S = SLO[pkg]
    tr = S.BurnRateTracker(hist_name=name, target_secs=target, **kw)
    out = [tr.armed]
    for now, values in values_by_step:
        h = PKGS[pkg].obs.histogram(name)
        for v in values:
            h.observe(v)
        out += [tr.sample(now=now), tr.check()]
    return out


@pytest.mark.parametrize("case", ["two-windows", "off-ladder"])
def test_burn_rates_equal_reference_on_a_fake_clock(case):
    """tests/test_ledger.py's burn-rate cases: the same observations at
    the same fake times give the reference's burn rates and checks."""
    if case == "two-windows":
        steps = [(0.0, []), (5.0, [0.01] * 98 + [5.0] * 2), (20.0, []),
                 (25.0, [5.0] * 10), (40.0, [])]
        kw = dict(burn_max=10.0, fast_window=10.0, slow_window=100.0)
        target = 0.1
    else:
        steps = [(0.0, []), (1.0, [0.12] * 100)]
        kw = dict(fast_window=10.0, slow_window=100.0)
        target = 0.15
    name = f"test.torch.slo.{case}"
    port = _burns("port", name, target, steps, **kw)
    ref = _burns("ref", name, target, steps, **kw)
    assert port == ref
    if case == "two-windows":
        assert port[3] == {"fast": 2.0, "slow": 2.0} and port[4]["ok"]
        assert port[7]["fast"] == 100.0 and not port[8]["ok"]
        assert port[9]["fast"] == 0.0 and port[10]["ok"]
        snap = PKGS["port"].obs.registry().snapshot()
        for w in ("fast", "slow"):
            assert slo._metrics.labeled("serve.slo.ack_burn_rate",
                                        window=w) in snap
    else:
        assert port[3]["fast"] == 100.0


def test_slo_unarmed_mints_nothing():
    before = {pkg: PKGS[pkg].obs.registry().snapshot() for pkg in PKGS}
    for pkg in PKGS:
        tr = SLO[pkg].BurnRateTracker(hist_name="test.torch.slo.unarmed")
        assert not tr.armed and tr.sample() is None
        moved = PKGS[pkg].obs.registry().delta(before[pkg])
        assert not any("slo" in k for k in moved)


def test_service_healthz_slo_arming(monkeypatch):
    """Unarmed, ``health()`` has no ``slo`` check; armed, the check after
    a refresh equals the reference's."""
    out = {}
    for pkg in PKGS:
        svc = service(pkg, start_worker=False)
        try:
            out[pkg] = ["slo" in svc.health()["checks"]]
        finally:
            svc.close(drain=False)
    armed(monkeypatch, SLO_ACK_SECS="0.5", SLO_BURN_MAX="5")
    for pkg in PKGS:
        svc = service(pkg, start_worker=False)
        try:
            svc.refresh_gauges()
            out[pkg].append(svc.health()["checks"]["slo"])
        finally:
            svc.close(drain=False)
    assert out["port"] == out["ref"] == [False, {
        "ok": True, "burn_fast": 0.0, "burn_slow": 0.0, "burn_max": 5.0,
        "target_secs": 0.5}]


@pytest.mark.parametrize("flag,value", [("SLO_ACK_SECS", "soon"),
                                        ("SLO_ACK_SECS", "-1"),
                                        ("SLO_BURN_MAX", "inf")])
def test_slo_flags_are_validated(monkeypatch, flag, value):
    errs = {}
    for pkg, P in PKGS.items():
        monkeypatch.setenv(P.FLAG + flag, value)
        with pytest.raises(ValueError) as ei:
            SLO[pkg].BurnRateTracker()
        errs[pkg] = str(ei.value)
        monkeypatch.delenv(P.FLAG + flag)
    assert errs["port"] == errs["ref"].replace("JEPSEN_TPU_",
                                               "JEPSEN_TPU_TORCH_")


# ------------------------------------------------ the breaker registry


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read().decode())


def test_healthz_flips_on_breaker_open():
    """tests/test_obs_httpd.py's pin: a registry breaker that opens
    makes /healthz answer 503 with its state, /metrics still answers,
    and a reset brings 200 back — every document the reference's."""
    def scenario(pkg):
        P = PKGS[pkg]
        svc = service(pkg)
        srv = P.httpd.OpsServer(health_fn=svc.health,
                                status_fn=svc.status,
                                refresh_fn=svc.refresh_gauges).start()
        url = f"http://{srv.host}:{srv.port}"
        try:
            out = [_get(url + "/healthz")]
            br = P.breaker.breaker_for("testbe", threshold=2,
                                       probe=lambda: False)
            br.record_failure("boom")
            br.record_failure("boom")
            out += [br.state, _get(url + "/healthz"),
                    urllib.request.urlopen(url + "/metrics",
                                           timeout=30).status]
            P.breaker.reset()
            out.append(_get(url + "/healthz"))
        finally:
            srv.close()
            svc.close()
        return out

    ref, port = scenario("ref"), scenario("port")
    same(ref, port)
    assert port[0][0] == 200 and port[1] == "open"
    assert port[2][0] == 503 and port[2][1]["ok"] is False
    assert port[2][1]["checks"]["breakers"] == {
        "ok": False, "states": {"testbe": "open"}}
    assert port[3] == 200 and port[4][0] == 200


def test_flight_dump_on_breaker_open(tmp_path, monkeypatch):
    armed(monkeypatch, FLIGHT_RECORDER="1")
    out = {}
    for pkg, P in PKGS.items():
        P.obs.flight_reset()
        P.obs.set_flight_dir(str(tmp_path / pkg))
        br = P.breaker.breaker_for("flightbe", threshold=1,
                                   probe=lambda: False)
        br.record_failure("boom")
        out[pkg] = sorted(f for f in os.listdir(tmp_path / pkg)
                          if "breaker-open" in f)
    assert out["port"] == out["ref"] == [
        "flight_breaker-open-flightbe_1.trace.json"]


def test_breaker_registry_snapshots_and_trip_set():
    """``breaker_for`` hands out one breaker a backend, ``snapshots``
    lists them, ``any_tripped`` follows every tracked breaker through
    open, half-open and closed, a ``track_global=False`` breaker stays
    out of it, and ``reset`` empties the registry: as the reference's,
    on one fake clock."""
    def scenario(pkg):
        B = PKGS[pkg].breaker
        clk = [0.0]
        healthy = [False]
        br = B.breaker_for("reg-a", threshold=1, backoff_base=1.0,
                           clock=lambda: clk[0], probe=lambda: healthy[0])
        out = [B.breaker_for("reg-a") is br, B.any_tripped()]
        br.record_failure("x")
        out += [B.any_tripped(), B.snapshots()]
        clk[0] += 5.0
        out += [br.allow(), B.any_tripped()]
        clk[0] += 50.0
        healthy[0] = True
        out += [br.allow(), B.any_tripped(), B.snapshots()]
        peer = B.CircuitBreaker("fleet:peer", threshold=1,
                                backoff_base=1.0, clock=lambda: clk[0],
                                probe=lambda: False, track_global=False)
        peer.record_failure("miss")
        out += [peer.state, B.any_tripped(),
                [s["backend"] for s in B.snapshots()]]
        B.breaker_for("")
        out.append(sorted(s["backend"] for s in B.snapshots()))
        B.reset()
        out += [B.snapshots(), B.any_tripped()]
        return out

    port, ref = scenario("port"), scenario("ref")
    assert port == ref
    assert port[:3] == [True, False, True]
    assert port[6] == (True, "") and port[7] is False
    assert port[9] == "open" and port[10] is False
    assert port[12] == ["default", "reg-a"] and port[13:] == [[], False]


class _Script:
    def __init__(self, names):
        self.alive = {n: True for n in names}

    def __call__(self, addr, _timeout):
        return self.alive[addr]


def test_fleet_breakers_stay_out_and_the_rehome_dumps(tmp_path,
                                                      monkeypatch):
    """A dead PEER opens its fleet breaker without tripping this
    process's registry (tests/test_fleet.py's pin), and its rehome dumps
    ``fleet-rehome-<name>`` with the replica and the plan in its
    trigger, after the breaker's own ``breaker-open-fleet:<name>``: as
    the reference's."""
    armed(monkeypatch, FLIGHT_RECORDER="1")
    h = register_history(corrupt=False, n_ops=12)

    def scenario(pkg):
        P = PKGS[pkg]
        P.obs.flight_reset()
        dirs = {f"n{i}": str(tmp_path / pkg / f"n{i}") for i in range(2)}
        svcs = {n: service(pkg, d) for n, d in dirs.items()}
        # after the services: each points the dumps at its own WAL dir
        flight = tmp_path / pkg / "flight"
        P.obs.set_flight_dir(str(flight))
        script = _Script(dirs)
        sup = P.fleet.FleetSupervisor(
            {n: None for n in dirs}, dirs, services=svcs, interval=1.0,
            threshold=1, fetch=script, clock=lambda: 0.0,
            sleep=lambda _s: None)
        try:
            key = "fleet-key"
            victim = sup.ring.owner(key)
            svcs[victim].submit(key, _ops(pkg, h), wait=True, timeout=120,
                                delta_id="fl-1")
            script.alive[victim] = False
            sup.tick()
            out = [victim, sup.status()["replicas"][victim]["dead"],
                   P.breaker.any_tripped(), P.breaker.snapshots()]
            # the registry reads the dead peer as nothing of its own
            out.append(svcs[sup.owner(key)].health()["checks"]["breakers"])
        finally:
            sup.stop()
            for s in svcs.values():
                s.close()
        dumps = sorted(os.listdir(flight))
        rehome = [d for d in dumps if d.startswith("flight_fleet-rehome")]
        trig = json.load(open(flight / rehome[0]))["flight"]["trigger"]
        return out, dumps, trig

    ref, port = scenario("ref"), scenario("port")
    assert port == ref
    victim = port[0][0]
    assert port[0][1:] == [True, False, [], {"ok": True, "states": {}}]
    # the peer's breaker opening dumps too (a fleet breaker is outside the
    # trip set, not outside the flight recorder), then the rehome
    assert port[1] == [f"flight_breaker-open-fleet-{victim}_1.trace.json",
                       f"flight_fleet-rehome-{victim}_2.trace.json"]
    survivor = "n1" if victim == "n0" else "n0"
    assert port[2] == {"replica": victim,
                       "plan": {survivor: ["fleet-key"]}}


# ------------------------------------------------ flight dumps, the WAL


def test_shed_and_worker_error_flight_dumps(tmp_path, monkeypatch):
    """An armed flight recorder dumps at a shed (``serve-shed``, its
    trigger the shed's key, reason and tenant) and at a worker error
    (``serve-worker-error``, the key, tenant and error), and counts
    ``serve.worker_errors``: the dumps, triggers and counters equal the
    reference's."""
    armed(monkeypatch, FLIGHT_RECORDER="1")
    h = register_history(corrupt=False, n_ops=24)

    def scenario(pkg):
        P = PKGS[pkg]
        mod = SVC_MOD[pkg]
        P.obs.flight_reset()
        before = P.obs.registry().snapshot()
        svc = service(pkg, tmp_path / pkg / "wal", high_water=10,
                      start_worker=False)
        real = mod.ext.advance_sessions

        def boom(sessions, bucket=None):
            raise RuntimeError("CUDA error: an illegal memory access "
                               "(injected)")

        monkeypatch.setattr(mod.ext, "advance_sessions", boom)
        try:
            out = [svc.submit("k", _ops(pkg, h[:8]), delta_id="w-1"),
                   svc.submit("k", _ops(pkg, h[8:16]), delta_id="w-2")]
            svc.start_worker()
            out.append(svc.result("k", timeout=120))
        finally:
            monkeypatch.setattr(mod.ext, "advance_sessions", real)
            svc.close()
        flight = tmp_path / pkg / "wal" / "flight"
        dumps = sorted(os.listdir(flight))
        trig = [json.load(open(flight / d))["flight"]["trigger"]
                for d in dumps]
        return out, dumps, trig, _serve_delta(pkg, before)

    ref, port = scenario("ref"), scenario("port")
    same(ref[0], port[0])
    assert port[1:3] == ref[1:3]
    assert port[3] == ref[3]
    assert port[1] == ["flight_serve-shed_1.trace.json",
                       "flight_serve-worker-error_2.trace.json"]
    assert port[2][0]["key"] == "k" and "high-water" in port[2][0]["reason"]
    assert port[2][1]["error"].startswith("RuntimeError: CUDA error")
    assert port[3]["serve.worker_errors"] == ("counter", 1)


def test_wal_counters_equal_reference(tmp_path):
    """``serve.wal_torn`` (a torn tail, replayed and repaired),
    ``serve.wal_rotations`` and ``serve.fences_written``, each moved as
    the reference's WAL moves it."""
    h = register_history(corrupt=False, n_ops=12)

    def scenario(pkg):
        P = PKGS[pkg]
        before = P.obs.registry().snapshot()
        wal = P.WAL(str(tmp_path / pkg))
        wal.append("k", 1, _ops(pkg, h[:4]))
        wal.rotate("k")
        wal.append("k", 2, _ops(pkg, h[4:8]))
        wal.close()
        seg = wal.segments("k")[-1]
        with open(seg, "a") as fh:
            fh.write('{"seq": 3, "ops": ["trunc')
        wal2 = P.WAL(str(tmp_path / pkg))
        out = [[s for s, _ops in wal2.replay("k")]]
        wal2.append("k", 3, _ops(pkg, h[8:]))
        wal2.write_fence("k", 2, owner="elsewhere")
        wal2.close()
        return out, _serve_delta(pkg, before)

    ref, port = scenario("ref"), scenario("port")
    assert port == ref
    assert port[1] == {"serve.wal_torn": ("counter", 2),
                       "serve.wal_rotations": ("counter", 1),
                       "serve.fences_written": ("counter", 1)}


# ------------------------------------------------ the entry point


def test_entry_point_serves_trace_and_refreshes(tmp_path):
    """``python -m jepsen_tpu_torch.serve --device cpu --ops-port 0``
    with tracing and the SLO armed: the delta's ack carries its id,
    ``/metrics`` shows the refreshed gauges and the burn rates,
    ``/healthz`` the ``breakers`` and ``slo`` checks, ``/trace`` the
    delta's chain, ``GET /`` the endpoints; stop exits 0."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JEPSEN_TPU_TORCH_")}
    env.update(PYTHONPATH=ROOT, JEPSEN_TPU_TORCH_TRACE="1",
               JEPSEN_TPU_TORCH_SLO_ACK_SECS="0.5",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.serve", "--device", "cpu",
         "--wal-dir", str(tmp_path / "wal"), "--host", "127.0.0.1",
         "--ops-port", "0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"ops endpoint: http://[^:]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                assert "/trace" in line
                break
        assert port, "no ops endpoint line"
        h = register_history(corrupt=False, n_ops=8)
        proc.stdin.write(json.dumps({"key": "ep", "ops": h, "wait": True,
                                     "timeout": 120,
                                     "delta_id": "ep-1"}) + "\n")
        proc.stdin.flush()
        ack = json.loads(proc.stdout.readline())
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            metrics = r.read().decode()
        code, health = _get(base + "/healthz")
        _, trace = _get(base + "/trace")
        _, root = _get(base + "/")
        _, missing = _get(base + "/nope")
        out, _ = proc.communicate(json.dumps({"op": "stop"}) + "\n",
                                  timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert ack["delta_id"] == "ep-1" and ack["valid?"] is True
    for name in ("jepsen_serve_keys_live ", "jepsen_serve_wal_lag_deltas ",
                 'jepsen_serve_slo_ack_burn_rate{window="fast"}',
                 "jepsen_serve_ack_secs_bucket"):
        assert name in metrics, name
    assert code == 200 and {"breakers", "slo"} <= set(health["checks"])
    names = {(e["name"], e["args"].get("delta_id"))
             for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {("serve.stdio.request", "ep-1"), ("serve.admit", "ep-1"),
            ("serve.wal", "ep-1")} <= names
    assert trace["trace"]["enabled"] is True
    assert root == {"endpoints": ["/metrics", "/healthz", "/status",
                                  "/trace"]}
    assert missing["endpoints"] == root["endpoints"]
    assert proc.returncode == 0 and out.splitlines()[-1] \
        == '{"stopped": true}'
