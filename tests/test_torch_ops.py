"""The port's ops surface (jepsen_tpu_torch.obs, resilience.breaker)
against the reference's (jepsen_tpu.obs, jepsen_tpu.resilience.breaker),
exactly:

* ``CircuitBreaker``: every snapshot (``open_until`` and its crc32-seeded
  jitter included) and every ``allow`` answer through scripted
  lifecycles under one fake clock, and the breaker's gauge and counter
  deltas;
* the registry's snapshot and delta formats, ``prom_name`` and
  ``render_prometheus`` on the same counters and gauges;
* ``OpsServer``'s routes over equivalent services (``/healthz`` 503 and
  200, ``/status``, ``/metrics``, ``POST /adopt``, the 404s) and
  ``fetch_replica``'s ready / degraded / unreachable, each package's
  client against each package's server;
* ``POST /adopt`` runs no scan off the service's worker thread.
"""

import json
import shutil
import socket
import threading
import urllib.error
import urllib.request

import pytest
import torch

from torch_fleet_cases import (
    OBS_ONLY, PKGS, PORT_ONLY, fleet_delta, norm, one_shot, ops, pin,
    register_history, service,
)
from torch_jax_cache import release_compiled_programs  # noqa: F401

from jepsen_tpu_torch.obs import httpd, metrics
from jepsen_tpu_torch.parallel import extend
from jepsen_tpu_torch.resilience.breaker import CircuitBreaker
from jepsen_tpu_torch.serve import service as svc_mod
from jepsen_tpu_torch.serve.stdio import jsonable


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- the breaker

# (op, argument): "fail" a reason, "ok", "allow", "advance" seconds on
# the fake clock, "probe" the next probe's answer ("raise": it raises)
LIFECYCLES = {
    "open-probe-close": [("fail", "a"), ("fail", "b"), ("allow", None),
                         ("fail", "c"), ("allow", None),
                         ("advance", 0.5), ("allow", None),
                         ("advance", 2.0), ("probe", True),
                         ("allow", None), ("allow", None)],
    "reopen-doubles": [("fail", "x")] * 3 + [
        ("advance", 1.2), ("probe", False), ("allow", None),
        ("advance", 1.0), ("allow", None), ("advance", 5.0),
        ("probe", "raise"), ("allow", None), ("advance", 30.0),
        ("probe", True), ("allow", None), ("fail", "y")],
    "success-resets": [("fail", "1"), ("fail", "2"), ("ok", None),
                       ("fail", "3"), ("fail", "4"), ("fail", "5"),
                       ("ok", None), ("allow", None)],
    "cap": [("fail", "z")] * 3 + [
        step for _ in range(8) for step in (
            ("advance", 70.0), ("probe", False), ("allow", None))],
}


def _drive(pkg, script, threshold, base):
    clk = [100.0]
    answer = [True]

    def probe():
        if answer[0] == "raise":
            raise RuntimeError("probe crashed")
        return answer[0]

    kw = dict(threshold=threshold, backoff_base=base,
              clock=lambda: clk[0], probe=probe)
    if pkg == "ref":
        br = PKGS["ref"].breaker.CircuitBreaker("fleet:r1",
                                                track_global=False, **kw)
    else:
        br = CircuitBreaker("fleet:r1", **kw)
    before = PKGS[pkg].obs.registry().snapshot()
    out = [br.snapshot()]
    for op, arg in script:
        if op == "fail":
            br.record_failure(arg)
        elif op == "ok":
            br.record_success()
        elif op == "allow":
            out.append(br.allow())
        elif op == "advance":
            clk[0] += arg
        else:
            answer[0] = arg
        out.append((br.state, br.snapshot()))
    return out, fleet_delta(pkg, before)


@pytest.mark.parametrize("name", sorted(LIFECYCLES))
@pytest.mark.parametrize("threshold,base", [(3, 1.0), (1, 0.05)])
def test_breaker_lifecycle_equals_reference(name, threshold, base):
    ref = _drive("ref", LIFECYCLES[name], threshold, base)
    port = _drive("port", LIFECYCLES[name], threshold, base)
    assert port == ref
    assert any(step[0] == "open" for step in port[0][1:])


def test_breaker_needs_a_probe():
    """A breaker always has a recovery probe: given none it takes the
    reference's default, the subprocess device probe."""
    from jepsen_tpu_torch.resilience import breaker
    br = CircuitBreaker("fleet:x", threshold=3, backoff_base=1.0)
    assert br.probe is breaker._default_probe


# --------------------------------------------- registry and Prometheus


def _fill(reg):
    reg.counter("fleet.heartbeats").inc(7)
    reg.counter("serve.repl_bytes").inc(12345)
    reg.counter("serve.deltas[tenant=alice]").inc(2)
    reg.counter("serve.deltas[tenant=bob\"q]").inc()
    reg.counter("serve.deltas").inc(3)
    g = reg.gauge("fleet.replicas_alive")
    g.set(3)
    g.set(2)
    reg.gauge("fleet.replica.n-0.alive").set(0)
    reg.gauge("serve.repl_lag_keys").set(1.5)
    reg.gauge("resilience.breaker.fleet:n0.state").set(2)
    reg.gauge("weird näme/x").set(3)
    return reg


def test_registry_snapshot_delta_and_prometheus_equal_reference():
    from jepsen_tpu.obs import metrics as ref_metrics
    port, ref = _fill(metrics.Registry()), _fill(ref_metrics.Registry())
    assert port.snapshot() == ref.snapshot()
    base_p, base_r = port.snapshot(), ref.snapshot()
    for reg in (port, ref):
        reg.counter("fleet.misses").inc()
        reg.gauge("fleet.replicas_alive").set(1)
        reg.gauge("fleet.replicas_alive").set(5)
    assert port.delta(base_p) == ref.delta(base_r)
    text = httpd.render_prometheus(port.snapshot())
    assert text == PKGS["ref"].httpd.render_prometheus(ref.snapshot())
    assert httpd.render_prometheus(ref.snapshot()) == text
    assert 'jepsen_serve_deltas{tenant="bob\\"q"} 1' in text
    assert "jepsen_fleet_replicas_alive_max 5" in text
    assert httpd.render_prometheus({}) == ""
    with pytest.raises(TypeError, match="already registered"):
        port.gauge("fleet.heartbeats")


@pytest.mark.parametrize("name", [
    "fleet.replicas_alive", "resilience.breaker.fleet:n0.state",
    "serve.repl-lag keys", "über.count", "a..b", ""])
def test_prom_name_equals_reference(name):
    assert httpd.prom_name(name) == PKGS["ref"].httpd.prom_name(name)


def test_ops_port_flag(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_TORCH_OPS_PORT", raising=False)
    assert httpd.resolve_ops_port() is None
    assert httpd.resolve_ops_port(0) == 0
    monkeypatch.setenv("JEPSEN_TPU_TORCH_OPS_PORT", "9100")
    assert httpd.resolve_ops_port() == 9100
    for bad in ("-1", "x"):
        monkeypatch.setenv("JEPSEN_TPU_TORCH_OPS_PORT", bad)
        with pytest.raises(ValueError, match="JEPSEN_TPU_TORCH_OPS_PORT"):
            httpd.resolve_ops_port()


# ---------------------------------------------------- the ops server


def _request(url, method="GET"):
    req = urllib.request.Request(url, method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers["Content-Type"], \
                resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.headers["Content-Type"], err.read().decode()


def _doc(answer):
    code, ctype, body = answer
    return code, ctype, json.loads(body)


def _url(srv, path: str) -> str:
    return f"http://{srv.host}:{srv.port}{path}"


def _server(pkg, svc):
    return PKGS[pkg].httpd.OpsServer(
        health_fn=svc.health, status_fn=svc.status,
        adopt_fn=svc.adopt_keys).start()


def test_ops_server_routes_equal_reference(tmp_path):
    """The same deltas into each package's service behind its own
    OpsServer: /healthz answers 503 before the worker runs and 200
    after, /status the key table, POST /adopt the keys transferred in
    (then none), the unknown routes 404 — every document equal."""
    h1 = register_history()
    h2 = register_history(seed=3, corrupt=False)

    def scenario(pkg):
        P = PKGS[pkg]
        donor = service(pkg, tmp_path / pkg / "donor")
        try:
            donor.submit(("moved", 1), ops(pkg, h2), wait=True, timeout=120)
        finally:
            donor.close()
        svc = service(pkg, tmp_path / pkg / "wal", start_worker=False)
        srv = _server(pkg, svc)
        try:
            out = [_doc(_request(_url(srv, "/healthz")))]
            svc.start_worker()
            # each delta waits for its verdict: the worker drains the
            # first before the second is queued, so /status's
            # max_pending_seen (30 of 40 ops) does not hang on when the
            # worker thread wakes, which a loaded host delays
            svc.submit("k", ops(pkg, h1[:10]), wait=True, timeout=120)
            svc.submit("k", ops(pkg, h1[10:]), wait=True, timeout=120)
            out += [_doc(_request(_url(srv, "/healthz/"))),
                    _doc(_request(_url(srv, "/status")))]
            P.ring.transfer_key(str(tmp_path / pkg / "donor"),
                                str(tmp_path / pkg / "wal"), ("moved", 1))
            out += [_doc(_request(_url(srv, "/adopt"), "POST")),
                    _doc(_request(_url(srv, "/adopt"), "POST")),
                    svc.result(("moved", 1), timeout=120),
                    _doc(_request(_url(srv, "/nope"), "POST"))[::2],
                    _request(_url(srv, "/nope"))[:2]]
            code, ctype, body = _request(_url(srv, "/metrics"))
            out.append((code, ctype, body.startswith("# TYPE jepsen_")))
        finally:
            srv.close()
            svc.close()
        return out

    ref = scenario("ref")
    port = scenario("port")
    assert norm(jsonable(port), PORT_ONLY) == norm(jsonable(ref), OBS_ONLY)
    assert port[0][0] == 503 and port[0][2]["ok"] is False
    assert port[1][0] == 200 and port[1][2]["ok"] is True
    assert port[2][2]["keys"]['"k"']["seq"] == 2
    assert port[2][2]["max_pending_seen"] == len(h1) - 10
    assert port[3][2] == {"adopted": ["('moved', 1)"]}
    assert port[4][2] == {"adopted": []}
    assert pin(jsonable(port[5])) == pin(jsonable(one_shot(h2)))
    assert port[6] == (404, {"error": "unknown POST '/nope'",
                             "endpoints": ["/adopt"]})
    assert port[7][0] == 404
    assert port[8] == (200, httpd.PROM_CONTENT_TYPE, True)


def test_ops_server_without_callbacks_and_bad_adopt():
    """A bare server still serves the registry; no adopt_fn is a 404, and
    an adopt_fn that raises answers 500 with the server alive."""
    def boom():
        raise RuntimeError("adopt_keys needs a WAL-backed service")

    for pkg in ("ref", "port"):
        bare = PKGS[pkg].httpd.OpsServer().start()
        bad = PKGS[pkg].httpd.OpsServer(adopt_fn=boom).start()
        try:
            assert _doc(_request(_url(bare, "/healthz"))) \
                == (200, "application/json", {"ok": True, "checks": {}})
            assert _doc(_request(_url(bare, "/status"))) \
                == (200, "application/json", {})
            assert _doc(_request(_url(bare, "/adopt"), "POST"))[::2] \
                == (404, {"error": "unknown POST '/adopt'",
                          "endpoints": []})
            assert _doc(_request(_url(bad, "/adopt"), "POST"))[::2] \
                == (500, {"error": "RuntimeError: adopt_keys needs a "
                                   "WAL-backed service"})
            assert _request(_url(bad, "/healthz"))[0] == 200
        finally:
            bare.close()
            bad.close()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_fetch_replica_ready_degraded_unreachable(tmp_path):
    """Each package's ``fetch_replica`` against each package's server:
    "ready" for a healthy service, "degraded" for an answered 503, and
    "unreachable" for no answer — the documents equal."""
    views = {}
    for pkg in ("ref", "port"):
        svc = service(pkg, tmp_path / pkg, start_worker=False)
        srv = _server(pkg, svc)
        try:
            addr = f"127.0.0.1:{srv.port}"
            degraded = [PKGS[c].httpd.fetch_replica(addr)
                        for c in ("ref", "port")]
            svc.start_worker()
            svc.submit("k", ops(pkg, register_history()[:8]), wait=True,
                       timeout=120)
            ready = [PKGS[c].httpd.fetch_replica(addr)
                     for c in ("ref", "port")]
        finally:
            srv.close()
            svc.close()
        gone = [PKGS[c].httpd.fetch_replica(addr, timeout=2)
                for c in ("ref", "port")]
        assert degraded[0] == degraded[1] and ready[0] == ready[1]
        assert gone[0] == gone[1]
        views[pkg] = [{k: v for k, v in d.items() if k != "addr"}
                      for d in (degraded[0], ready[0], gone[0])]
        assert [d["state"] for d in (degraded[0], ready[0], gone[0])] \
            == ["degraded", "ready", "unreachable"]
    assert norm(jsonable(views["port"]), PORT_ONLY) \
        == norm(jsonable(views["ref"]), OBS_ONLY)
    addr = f"127.0.0.1:{_free_port()}"
    assert httpd.fetch_replica(addr, timeout=2)["state"] == "unreachable"


def test_post_adopt_runs_no_scan_off_the_worker_thread(tmp_path,
                                                       monkeypatch):
    """``POST /adopt`` replays on the ops server's thread, and that is
    host work only (the re-encode and the checkpoint): every scan — the
    batched advance and each session's check and finalize — runs on the
    service's worker thread."""
    h = register_history(corrupt=False)
    donor = service("port", tmp_path / "donor")
    try:
        for k in ("a1", "a2"):
            donor.submit(k, ops("port", h[:10]), wait=True, timeout=120)
            donor.submit(k, ops("port", h[10:]), timeout=60)
        assert donor.drain(timeout=120) and donor.freeze_key("a1")
    finally:
        donor.close()
    threads = []

    def record(fn):
        def wrapped(*a, **kw):
            threads.append(threading.current_thread().name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(svc_mod.ext, "advance_sessions",
                        record(extend.advance_sessions))
    for name in ("check", "finalize"):
        monkeypatch.setattr(extend.HistorySession, name,
                            record(getattr(extend.HistorySession, name)))
    svc = service("port", tmp_path / "wal")
    srv = _server("port", svc)
    try:
        for k in ("a1", "a2"):
            PKGS["port"].ring.transfer_key(str(tmp_path / "donor"),
                                           str(tmp_path / "wal"), k)
        assert threads == []
        code, _ctype, doc = _doc(_request(_url(srv, "/adopt"), "POST"))
        assert code == 200 and sorted(doc["adopted"]) == ["a1", "a2"]
        for k in ("a1", "a2"):
            r = svc.finalize(k, timeout=120)
            assert r["seq"] == 2 and r["valid?"] is True
    finally:
        srv.close()
        svc.close()
    assert threads and set(threads) == {"jepsen-torch-serve-worker"}
    shutil.rmtree(tmp_path / "donor")
