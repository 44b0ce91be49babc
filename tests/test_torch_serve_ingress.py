"""The port's transports (jepsen_tpu_torch.serve.ingress / stdio) and
its entry point (python -m jepsen_tpu_torch.serve), against the
reference's (jepsen_tpu.serve.ingress / stdio) over services on the
same deltas: the streamed JSONL end to end, auth with tenants (401),
the shed carrying tenant and reason, an unknown endpoint and a bad key,
a bad timeout and a missing Content-Length, the port flag, stdio's
round trip and token passthrough; the entry point's --help, and its
exit without a card. Every answer is compared exactly, but for
test_torch_serve.py's TIMES (compared by presence, key set and type) and
PORT_ONLY fields."""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from io import StringIO

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu.serve import ingress as ref_ingress
from jepsen_tpu.serve import stdio as ref_stdio
from jepsen_tpu_torch.envflags import EnvFlagError
from jepsen_tpu_torch.serve import ingress as ingress_mod
from jepsen_tpu_torch.serve import stdio as stdio_mod
from jepsen_tpu_torch.serve.__main__ import SERVE_MODELS, parser
from test_torch_serve import _service, _same
from torch_fleet_cases import unarmed
from torch_jax_cache import release_compiled_programs  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _post(url, body, token=None, timeout=120):
    headers = {}
    if token is not None:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=body.encode(), headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _http_error(fn):
    with pytest.raises(urllib.error.HTTPError) as ei:
        fn()
    return ei.value.code, json.loads(ei.value.read())


def _lines(body):
    return [json.loads(ln) for ln in body.splitlines()]


def _history(seed=1):
    return [dict(o) for o in ref_histories.rand_register_history(
        n_ops=16, n_processes=3, n_values=3, seed=seed)]


def _ingress(pkg, svc):
    mod = ref_ingress if pkg == "ref" else ingress_mod
    return mod.DeltaIngress(svc, port=0)


def test_ingress_streamed_jsonl_end_to_end():
    """The whole grammar over one connection: submits (wait and not), an
    interleaved result, a finalize, a bad line; the answers stream back
    one JSONL line each, in order; GET /v1/result and / answer too."""
    h = _history()
    reqs = [{"key": "k", "ops": h[:8], "wait": True, "timeout": 120},
            {"key": "k", "ops": h[8:], "timeout": 60},
            {"op": "result", "key": "k", "timeout": 120},
            {"op": "finalize", "key": "k", "timeout": 120},
            {"key": ["reg", 1], "ops": [{"type": "nope"}]},
            {"key": "k2", "ops": [{"process": 0}]},
            {"bogus": 1},
            "not json at all"]
    body = "\n".join(r if isinstance(r, str) else json.dumps(r)
                     for r in reqs) + "\n"

    def scenario(pkg):
        svc = _service(pkg)
        with _ingress(pkg, svc) as ing:
            try:
                code, text = _post(ing.url("/v1/deltas"), body)
                with urllib.request.urlopen(ing.url('/v1/result?key="k"'),
                                            timeout=60) as resp:
                    got = json.loads(resp.read())
                with urllib.request.urlopen(ing.url("/"),
                                            timeout=30) as resp:
                    root = json.loads(resp.read())
            finally:
                svc.close()
        return [code, _lines(text), got, root]

    _, port = _same_both(scenario)
    outs = port[1]
    assert port[0] == 200 and len(outs) == 8
    assert outs[0]["valid?"] is not None and outs[0]["seq"] == 1
    assert outs[1]["accepted"] and outs[1]["seq"] == 2
    assert outs[2]["seq"] == 2 and outs[3]["seq"] == 2
    assert "type must be one of" in outs[4]["error"]
    assert "unknown request" in outs[6]["error"]
    assert "bad request line" in outs[7]["error"]
    assert port[2]["valid?"] == outs[3]["valid?"]
    assert "/v1/deltas" in port[3]["endpoints"]


def _same_both(scenario):
    ref = scenario("ref")
    port = scenario("port")
    _same(ref, port)
    return ref, port


TWO = [("ia", {"token": "tok-ia"}), ("ib", {"token": "tok-ib"})]


def test_ingress_auth_required_with_tenants():
    h = _history(seed=2)
    delta = json.dumps({"key": "k", "ops": h[:8], "timeout": 60}) + "\n"

    def scenario(pkg):
        svc = _service(pkg, tenants=TWO)
        with _ingress(pkg, svc) as ing:
            try:
                # no token / unknown token -> 401 before the service runs
                out = [_http_error(lambda t=t: _post(
                    ing.url("/v1/deltas"), delta, token=t))
                    for t in (None, "wrong")]
                out.append(_http_error(lambda: urllib.request.urlopen(
                    ing.url('/v1/result?key="k"'), timeout=30)))
                code, text = _post(ing.url("/v1/deltas"), delta,
                                   token="tok-ia")
                out += [code, _lines(text)]
                code, text = _post(ing.url("/v1/finalize"),
                                   json.dumps({"key": "k", "timeout": 60}),
                                   token="tok-ib")
                out += [code, json.loads(text)]
            finally:
                svc.close()
        return out

    _, port = _same_both(scenario)
    for code, doc in port[:3]:
        assert code == 401 and "unauthorized" in doc["error"]
    assert port[4][0]["accepted"] and port[4][0]["tenant"] == "ia"
    assert "another tenant" in port[6]["error"]


def test_ingress_shed_carries_tenant_and_reason():
    h = _history(seed=3)
    body = "".join(json.dumps({"key": "k", "ops": ops, "timeout": 30})
                   + "\n" for ops in (h[:8], h[8:16]))

    def scenario(pkg):
        svc = _service(pkg, tenants=[("iq", {"token": "tq",
                                             "max_pending_ops": 8})],
                       start_worker=False)
        with _ingress(pkg, svc) as ing:
            try:
                _code, text = _post(ing.url("/v1/deltas"), body,
                                    token="tq", timeout=60)
            finally:
                svc.close(drain=False)
        return _lines(text)

    _, port = _same_both(scenario)
    assert port[0]["accepted"]
    assert port[1]["shed"] is True and port[1]["tenant"] == "iq"
    assert "pending-ops quota" in port[1]["reason"]


def test_ingress_unknown_endpoint_and_bad_key():
    def scenario(pkg):
        svc = _service(pkg)
        with _ingress(pkg, svc) as ing:
            try:
                return [
                    _http_error(lambda: urllib.request.urlopen(
                        ing.url("/nope"), timeout=30)),
                    _http_error(lambda: urllib.request.urlopen(
                        ing.url("/v1/result?key=notjson"), timeout=30)),
                    _http_error(lambda: _post(ing.url("/v1/finalize"),
                                              "{not json")),
                    json.loads(urllib.request.urlopen(
                        ing.url("/v1/result?key=%22none%22"),
                        timeout=30).read())]
            finally:
                svc.close()

    _, port = _same_both(scenario)
    assert port[0][0] == 404 and port[1][0] == 400 and port[2][0] == 400
    assert port[3] == {"error": "unknown key", "key": "none"}


def test_ingress_bad_timeout_and_missing_content_length():
    import http.client

    def scenario(pkg):
        svc = _service(pkg)
        with _ingress(pkg, svc) as ing:
            try:
                out = [_http_error(lambda: urllib.request.urlopen(
                    ing.url('/v1/result?key="k"&timeout=abc'),
                    timeout=30))]
                conn = http.client.HTTPConnection("127.0.0.1", ing.port,
                                                  timeout=30)
                conn.putrequest("POST", "/v1/deltas",
                                skip_accept_encoding=True)
                conn.endheaders()   # no Content-Length, no body
                resp = conn.getresponse()
                out.append([resp.status, json.loads(resp.read())])
                conn.close()
            finally:
                svc.close()
        return out

    _, port = _same_both(scenario)
    assert port[0][0] == 400 and "timeout" in port[0][1]["error"]
    assert port[1][0] == 400 and "Content-Length" in port[1][1]["error"]


def test_ingress_port_flag(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_TORCH_INGRESS_PORT", raising=False)
    assert ingress_mod.resolve_ingress_port(None) is None
    assert ingress_mod.resolve_ingress_port(8181) == 8181
    monkeypatch.setenv("JEPSEN_TPU_TORCH_INGRESS_PORT", "7171")
    assert ingress_mod.resolve_ingress_port(None) == 7171
    assert ingress_mod.resolve_ingress_port(0) == 0
    monkeypatch.setenv("JEPSEN_TPU_TORCH_INGRESS_PORT", "nope")
    with pytest.raises(EnvFlagError, match="JEPSEN_TPU_TORCH_INGRESS_PORT"):
        ingress_mod.resolve_ingress_port(None)
    # the reference's flag is not the port's
    monkeypatch.delenv("JEPSEN_TPU_TORCH_INGRESS_PORT")
    monkeypatch.setenv("JEPSEN_TPU_INGRESS_PORT", "7272")
    assert ingress_mod.resolve_ingress_port(None) is None


def _stdio(pkg, svc, reqs):
    out = StringIO()
    run = ref_stdio.run_stdio if pkg == "ref" else stdio_mod.run_stdio
    rc = run(svc, StringIO("\n".join(
        r if isinstance(r, str) else json.dumps(r) for r in reqs) + "\n"),
        out)
    return [rc] + [json.loads(ln) for ln in out.getvalue().splitlines()]


def test_stdio_transport_roundtrip(tmp_path):
    h = [dict(o) for o in ref_histories.corrupt_history(
        ref_histories.rand_register_history(n_ops=24, n_processes=4,
                                            n_values=3, seed=2),
        seed=1, n_corruptions=2)]
    reqs = [{"key": "k", "ops": h[:24], "wait": True, "timeout": 120},
            {"key": ["k", 2], "ops": h[:10], "seq": 1},
            {"key": "k", "ops": h[24:], "wait": True, "timeout": 120},
            {"op": "drain", "timeout": 60},
            {"op": "result", "key": ["k", 2], "timeout": 60},
            {"op": "finalize", "key": "k", "timeout": 120},
            "{broken", {"what": 1}, "",
            {"op": "stop"},
            {"key": "k", "ops": h[:2]}]   # after stop: never read

    def scenario(pkg):
        return _stdio(pkg, _service(pkg, tmp_path), reqs)

    _, port = _same_both(scenario)
    assert port[0] == 0 and port[-1] == {"stopped": True}
    assert len(port) == 10
    assert port[6]["valid?"] is False and port[6]["seq"] == 2
    assert port[5]["key"] == ["k", 2]


def test_stdio_token_passthrough():
    """stdio is behind the same admission layer: a line's token resolves
    the tenant; with tenants configured and no token the line is
    refused."""
    h = _history(seed=4)
    reqs = [{"key": "k", "ops": h[:8], "token": "ts", "wait": True,
             "timeout": 120},
            {"key": "k", "ops": h[8:], "timeout": 30},
            {"op": "result", "key": "k", "token": "ts", "timeout": 60},
            {"op": "finalize", "key": "k", "timeout": 60},
            {"op": "stop"}]

    def scenario(pkg):
        return _stdio(pkg, _service(pkg, tenants=[("st", {"token": "ts"})]),
                      reqs)

    _, port = _same_both(scenario)
    assert port[1]["valid?"] is not None
    assert "tenant required" in port[2]["error"]
    assert port[3]["seq"] == 1
    assert "tenant required" in port[4]["error"]


# ------------------------------------------------------ the entry point


def test_entry_point_options():
    from jepsen_tpu import cli
    args = parser().parse_args(["--model", "fifo", "--wal-dir", "/tmp/x",
                                "--dedupe", "hash", "--host", "127.0.0.1",
                                "--ingress-port", "0"])
    assert (args.model, args.wal_dir, args.dedupe, args.host,
            args.ingress_port) == ("fifo", "/tmp/x", "hash", "127.0.0.1", 0)
    args = parser().parse_args([])
    assert (args.model, args.wal_dir, args.dedupe, args.ingress_port) \
        == ("cas-register", None, None, None)
    assert SERVE_MODELS == cli.SERVE_MODELS
    with pytest.raises(SystemExit):
        parser().parse_args(["--model", "nope"])


def _run_entry(*argv, env=None):
    return subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.serve", *argv], cwd=ROOT,
        capture_output=True, text=True, timeout=120, input="",
        env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})))


def test_entry_point_help_parses():
    proc = _run_entry("--help")
    assert proc.returncode == 0, proc.stderr
    for opt in ("--model", "--wal-dir", "--dedupe", "--host",
                "--ingress-port"):
        assert opt in proc.stdout


def test_entry_point_without_a_card_exits_nonzero(tmp_path):
    """No CPU run from the entry point: without a CUDA device it exits
    non-zero with the RuntimeError's text, and writes no WAL."""
    proc = _run_entry("--wal-dir", str(tmp_path / "wal"),
                      "--ingress-port", "0",
                      env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "delta ingress" not in proc.stderr and proc.stdout == ""
    assert not (tmp_path / "wal").exists()
