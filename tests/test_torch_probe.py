"""The port's device probe (jepsen_tpu_torch.probe) against the
reference's (jepsen_tpu.probe), on the CPU: for the same scripted
``probe_once`` results the verdict lines, exit codes, ``probe_json``
documents and ``ProbeWatch`` status and gauges are the reference's,
with ``torch.cuda`` where the reference says ``jax.devices()`` and the
wedge line's explanation its own. The wedged and no-backend paths also
run real children (one that sleeps, one that raises); the healthy path
runs the real child with ``--device cpu``; the CUDA child on a machine
without a card is "no backend", exit 2. Also the breaker's default
probe and flags, and ``/healthz`` of ``python -m jepsen_tpu_torch.serve``
with the watch armed."""

import io
import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from unittest import mock

import pytest

from jepsen_tpu import obs as ref_obs
from jepsen_tpu import probe as ref_probe
from jepsen_tpu_torch import envflags, obs, probe
from jepsen_tpu_torch.resilience import breaker

_LINE = re.compile(r"^\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}Z probe: ")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(lines, port: bool):
    """Verdict lines without their timestamps, in the port's words: the
    child's name, and the wedge line cut before its explanation."""
    out = []
    for ln in lines:
        assert _LINE.match(ln), ln
        ln = ln.split(" ", 1)[1]
        if not port:
            ln = ln.replace("jax.devices()", "torch.cuda")
        if "WEDGED" in ln:
            ln = ln.split("s (", 1)[0]
        out.append(ln)
    return out


def _scripted(results):
    """A probe_once that answers `results` in turn (both signatures)."""
    it = iter(results)

    def once(timeout, device="cuda"):
        return dict(next(it))
    return once


def _run_both(results, **kw):
    out = {}
    for name, mod in (("port", probe), ("ref", ref_probe)):
        buf = io.StringIO()
        rec = []
        with mock.patch.object(mod, "probe_once", _scripted(results)):
            rc = mod.run_probe(out=buf, record=rec, **kw)
        out[name] = (rc, _norm(buf.getvalue().splitlines(),
                               name == "port"), rec)
    return out


HEALTHY = {"status": "healthy", "secs": 1.25, "platforms": ["cuda"],
           "n_devices": 1}
HUNG = {"status": "hung", "secs": 5.0}
FAILED = {"status": "failed", "secs": 0.4, "rc": 1,
          "err": "Traceback ...\nRuntimeError: no plugin"}
SCRIPTS = {
    "healthy": ([HEALTHY], dict(timeout=5.0, retries=3)),
    "wedged": ([HUNG, HUNG, HUNG], dict(timeout=5.0, retries=3)),
    "no-backend": ([FAILED, HEALTHY], dict(timeout=5.0, retries=3)),
    "recovers": ([HUNG, {**HEALTHY, "n_devices": 4}],
                 dict(timeout=5.0, retries=3)),
    "one-retry": ([HUNG], dict(timeout=30.0, retries=1)),
    "no-retries": ([HUNG], dict(timeout=30.0, retries=0)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_verdict_lines_and_exit_codes_match_reference(name):
    results, kw = SCRIPTS[name]
    got = _run_both(results, **kw)
    assert got["port"] == got["ref"]
    want_rc = {"healthy": 0, "recovers": 0, "wedged": 1, "one-retry": 1,
               "no-retries": 1, "no-backend": 2}[name]
    assert got["port"][0] == want_rc
    if name == "no-backend":       # fail fast: no retry after a failure
        assert len(got["port"][2]) == 1


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_probe_json_matches_reference(name):
    results, kw = SCRIPTS[name]
    docs = []
    for mod in (probe, ref_probe):
        with mock.patch.object(mod, "probe_once", _scripted(results)):
            doc = mod.probe_json(**kw)
        doc.pop("elapsed_secs")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert list(docs[0]) == list(docs[1])


def test_wedged_child_is_killed_within_the_timeout():
    with mock.patch.object(probe, "_CHILD_CODE",
                           "import time; time.sleep(3600)"):
        t0 = time.monotonic()
        doc = probe.probe_json(timeout=0.8, retries=2)
    assert time.monotonic() - t0 < 30
    assert (doc["verdict"], doc["exit"]) == ("wedged", 1)
    assert [a["status"] for a in doc["attempts"]] == ["hung", "hung"]


def test_failing_child_fails_fast_without_retries():
    with mock.patch.object(probe, "_CHILD_CODE",
                           "raise RuntimeError('no plugin')"), \
            mock.patch.object(probe, "probe_once",
                              wraps=probe.probe_once) as spy:
        buf = io.StringIO()
        rc = probe.run_probe(timeout=30.0, retries=3, out=buf)
    assert rc == probe.EXIT_NO_BACKEND == 2
    assert spy.call_count == 1
    line = buf.getvalue().splitlines()[-1]
    assert "NO BACKEND — torch.cuda failed rc=1" in line
    assert "no plugin" in line


def test_healthy_child_on_the_cpu():
    buf = io.StringIO()
    rc = probe.run_probe(timeout=120.0, retries=1, out=buf, device="cpu")
    assert rc == 0
    line = buf.getvalue().splitlines()[-1]
    assert _LINE.match(line)
    assert "HEALTHY — torch.cpu -> ['cpu'] in " in line
    assert "(cpu platform, 1 device(s))" in line
    doc = probe.probe_json(timeout=120.0, retries=1, device="cpu")
    assert (doc["verdict"], doc["exit"]) == ("healthy", 0)
    assert doc["platforms"] == ["cpu"] and doc["n_devices"] == 1


def test_cuda_child_without_a_card_is_no_backend():
    """The CUDA probe never reports the CPU in the card's place."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the CUDA probe is healthy")
    buf = io.StringIO()
    rc = probe.run_probe(timeout=120.0, retries=3, out=buf)
    lines = buf.getvalue().splitlines()
    assert rc == 2 and len(lines) == 1
    assert "NO BACKEND — torch.cuda failed rc=1" in lines[0]
    assert "no CUDA device" in lines[0]


def test_cli_json_usage_and_cpu_healthy(capsys):
    rc = probe.main(["--json", "--device", "cpu", "--timeout", "120",
                     "--retries", "1"])
    cap = capsys.readouterr()
    doc = json.loads(cap.out)
    assert rc == doc["exit"] == 0 and doc["verdict"] == "healthy"
    assert any(_LINE.match(ln) for ln in cap.err.splitlines())
    assert probe.main(["--not-a-flag"]) == ref_probe.main(
        ["--not-a-flag"]) == 254
    assert probe.main(["--device", "tpu"]) == 254


@pytest.mark.parametrize("argv,expect", [
    (["--timeout", "7.5", "--retries", "2", "--interval", "1"],
     (7.5, 2, 1.0, "cuda")),
    ([], (100.0, 3, 0.0, "cuda")),
    (["--device", "cpu"], (100.0, 3, 0.0, "cpu")),
])
def test_flag_parsing(argv, expect, monkeypatch):
    seen = {}

    def fake(timeout, retries, interval, device="cuda"):
        seen.update(timeout=timeout, retries=retries, interval=interval,
                    device=device)
        return 0

    monkeypatch.setattr(probe, "run_probe", fake)
    assert probe.main(argv) == 0
    assert (seen["timeout"], seen["retries"], seen["interval"],
            seen["device"]) == expect
    if "--device" not in argv:
        ref_seen = {}
        monkeypatch.setattr(ref_probe, "run_probe",
                            lambda timeout, retries, interval:
                            ref_seen.update(t=(timeout, retries,
                                               interval)) or 0)
        assert ref_probe.main(argv) == 0
        assert ref_seen["t"] == expect[:3]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _watch_trace(mod, registry, docs, steps):
    clock = _Clock()
    it = iter(docs)

    def fake():
        d = next(it)
        if isinstance(d, Exception):
            raise d
        return d
    w = mod.ProbeWatch(2.0, timeout=10.0, probe=fake, clock=clock)
    trace = [w.status()]
    for advance, tick in steps:
        clock.t += advance
        if tick:
            w.tick()
        trace.append((w.status(),
                      registry.gauge("probe.chip_healthy").value,
                      registry.gauge("probe.last_ok_age_secs").value))
    return trace


def test_probe_watch_matches_reference():
    docs = [{"verdict": "healthy"}, {"verdict": "wedged"},
            RuntimeError("spawn failed"), {"verdict": "healthy"},
            {"verdict": "no-backend"}]
    steps = [(1.0, True), (3.0, False), (2.0, True), (2.0, True),
             (20.0, False), (1.0, True), (0.5, True), (30.0, False)]
    got = _watch_trace(probe, obs, docs, steps)
    want = _watch_trace(ref_probe, ref_obs, docs, steps)
    assert got == want
    assert got[0]["ok"] is True and got[0]["ticks"] == 0   # grace
    assert got[1][0]["ok"] is True and got[1][1:] == (1, 0.0)
    assert got[3][0]["verdict"] == "wedged" and got[3][0]["ok"] is False


def test_start_watch_from_env(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_TORCH_PROBE_INTERVAL", raising=False)
    assert probe.start_watch_from_env() is None
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROBE_INTERVAL", "0")
    assert probe.start_watch_from_env() is None
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROBE_INTERVAL", "soon")
    with pytest.raises(envflags.EnvFlagError, match="PROBE_INTERVAL"):
        probe.start_watch_from_env()
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROBE_INTERVAL", "30")
    calls = []
    monkeypatch.setattr(probe, "probe_json", lambda **kw: calls.append(kw)
                        or {"verdict": "healthy"})
    w = probe.start_watch_from_env(device="cpu")
    try:
        deadline = time.monotonic() + 30
        while w.ticks == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert w.interval == 30.0 and w.status()["ok"] is True
        assert calls[0] == {"timeout": 100.0, "retries": 1, "device": "cpu"}
    finally:
        w.stop()
    assert not w._thread.is_alive()
    assert set(envflags.HEALTH_FLAGS) == {
        "JEPSEN_TPU_TORCH_PROBE_INTERVAL",
        "JEPSEN_TPU_TORCH_BREAKER_THRESHOLD",
        "JEPSEN_TPU_TORCH_BREAKER_BACKOFF"}


def test_breaker_default_probe_is_probe_json(monkeypatch):
    seen = []
    answers = iter(["healthy", "wedged"])
    monkeypatch.setattr(probe, "probe_json", lambda **kw: seen.append(kw)
                        or {"verdict": next(answers)})
    b = breaker.CircuitBreaker("probe-test")
    assert b.probe is breaker._default_probe
    assert b.probe() is True and b.probe() is False
    assert seen == [{"timeout": 30.0, "retries": 1}] * 2
    assert breaker.PROBE_TIMEOUT_SECS == 30.0


def test_breaker_flags(monkeypatch):
    for name in ("THRESHOLD", "BACKOFF"):
        monkeypatch.delenv(f"JEPSEN_TPU_TORCH_BREAKER_{name}", raising=False)
    b = breaker.CircuitBreaker("flags-a", probe=lambda: True)
    assert (b.threshold, b.backoff_base) == (3, 1.0)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_BREAKER_THRESHOLD", "5")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_BREAKER_BACKOFF", "0.25")
    b = breaker.CircuitBreaker("flags-b", probe=lambda: True)
    assert (b.threshold, b.backoff_base) == (5, 0.25)
    # callers passing all three keep their behaviour
    b = breaker.CircuitBreaker("flags-c", probe=lambda: False, threshold=2,
                               backoff_base=4.0)
    assert (b.threshold, b.backoff_base) == (2, 4.0)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_BREAKER_THRESHOLD", "0")
    with pytest.raises(envflags.EnvFlagError, match="BREAKER_THRESHOLD"):
        breaker.CircuitBreaker("flags-d", probe=lambda: True)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_BREAKER_THRESHOLD", "3")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_BREAKER_BACKOFF", "-1")
    with pytest.raises(envflags.EnvFlagError, match="BREAKER_BACKOFF"):
        breaker.CircuitBreaker("flags-e", probe=lambda: True)


def _serve(env_extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("JEPSEN_TPU_TORCH_")}
    env.update(env_extra, PYTHONPATH=_ROOT)
    return subprocess.Popen(
        [sys.executable, "-m", "jepsen_tpu_torch.serve", "--device", "cpu",
         "--host", "127.0.0.1", "--ops-port", "0"],
        cwd=_ROOT, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _ops_port(child) -> int:
    for line in child.stderr:
        m = re.search(r"ops endpoint: http://[^:]+:(\d+)", line)
        if m:
            return int(m.group(1))
    raise AssertionError("the service printed no ops endpoint")


def _healthz(port):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())


@pytest.mark.parametrize("armed", [True, False])
def test_serve_healthz_carries_the_probe_watch(armed):
    child = _serve({"JEPSEN_TPU_TORCH_PROBE_INTERVAL": "0.5"} if armed
                   else {})
    try:
        port = _ops_port(child)
        doc = _healthz(port)
        deadline = time.monotonic() + 120
        while armed and doc["checks"]["probe"]["ticks"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.2)
            doc = _healthz(port)
        if armed:
            p = doc["checks"]["probe"]
            assert p["ticks"] >= 1 and p["verdict"] == "healthy"
            assert p["ok"] is True and doc["ok"] is True
            assert p["interval"] == 0.5
        else:
            assert "probe" not in doc["checks"]
        child.stdin.write('{"op": "stop"}\n')
        child.stdin.flush()
        assert child.wait(timeout=60) == 0
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
