"""The replica's ops endpoint: ``/metrics``, ``/healthz``, ``/status``
and ``POST /adopt`` over a stdlib HTTP daemon thread, and the client
the fleet supervisor polls it with.

A trimmed copy of `jepsen_tpu.obs.httpd`, with the reference's JSON
documents and status codes:

    GET  /metrics   Prometheus text (format 0.0.4) rendered live from
                    the registry (a gauge's high-water mark as its
                    ``_max`` twin; a histogram as ``_bucket``, ``_sum``
                    and ``_count``)
    GET  /healthz   the service's health document; 200 when ``ok``,
                    503 when degraded
    GET  /status    the per-key service table
    POST /adopt     replay the WAL keys transferred into this replica's
                    WAL dir into live sessions (``adopt_keys``: a
                    re-encode and the checkpoint on this thread, host
                    work only; the scans run on the service's worker)

The server holds no service state of its own: every request renders
fresh from the registry and the injected callbacks. ``fetch_replica``
is the one read of a replica both an operator script and
``serve.fleet.FleetSupervisor`` use. Left out (items of a later
slice): ``/trace``, ``/ledger``, ``/plan``, the refresh hook of
computed gauges, and the ``jepsen status`` renderers.

Import-safe: no torch, no engine imports.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from jepsen_tpu_torch import envflags
from jepsen_tpu_torch.obs import metrics as _metrics

_log = logging.getLogger(__name__)

PROM_PREFIX = "jepsen_"

#: HTTP content type for Prometheus text exposition format 0.0.4
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

ENDPOINTS = ["/metrics", "/healthz", "/status"]


def resolve_ops_port(cli_value: Optional[int] = None) -> Optional[int]:
    """The ops-endpoint port: an explicit ``--ops-port`` wins, else
    ``JEPSEN_TPU_TORCH_OPS_PORT`` (0 = ephemeral); None when neither is
    set (the endpoint stays off)."""
    if cli_value is not None:
        return int(cli_value)
    return envflags.env_int("JEPSEN_TPU_TORCH_OPS_PORT", default=None,
                            min_value=0, what="ops endpoint port")


# ------------------------------------------------ Prometheus rendering


def prom_name(name: str) -> str:
    """A registry name as a Prometheus metric name: every character
    but ASCII alphanumerics and ``_`` becomes ``_``, under the
    ``jepsen_`` namespace (``fleet.replicas_alive`` ->
    ``jepsen_fleet_replicas_alive``)."""
    out = "".join(ch if (ch.isascii() and ch.isalnum()) or ch == "_"
                  else "_" for ch in name)
    return PROM_PREFIX + out


def _fmt(v) -> str:
    """A sample value in exposition format (integers stay integral)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def _esc_label(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _label_str(labels: Dict[str, str], extra: str = "") -> str:
    """A ``{k="v",...}`` block from a label dict (label names sanitized
    like metric names, values escaped); ``extra`` appends a rendered
    pair (a histogram's ``le``). Empty in, empty out."""
    pairs = [f'{prom_name(k)[len(PROM_PREFIX):]}="{_esc_label(v)}"'
             for k, v in sorted(labels.items())]
    if extra:
        pairs.append(extra)
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(snap: Optional[Dict[str, dict]] = None) -> str:
    """A registry snapshot (default: this process's) as Prometheus
    text: one ``# TYPE`` block per rendered name, its labeled series
    (``base[k=v]``, ``obs.labeled``) contiguous under it. Counters and
    gauges render as they are, a gauge's high-water mark as a
    ``<name>_max`` gauge twin; a histogram renders its cumulative
    ``_bucket{le=...}`` series up to ``+Inf``, ``_sum`` and ``_count``
    (the shape ``histogram_quantile()`` reads), and its streaming max
    as a ``_max`` twin."""
    if snap is None:
        snap = _metrics.registry().snapshot()
    by_base: Dict[str, list] = {}
    for name in sorted(snap):
        base, labels = _metrics.split_labels(name)
        by_base.setdefault(prom_name(base), []).append(
            (labels, snap[name]))
    lines = []
    for pn in sorted(by_base):
        series = by_base[pn]
        lines.append(f"# TYPE {pn} {series[0][1]['type']}")
        max_twins = []
        for labels, m in series:
            lab = _label_str(labels)
            if m["type"] in ("counter", "gauge"):
                lines.append(f"{pn}{lab} {_fmt(m['value'])}")
            else:
                for le, cum in m.get("buckets") or ():
                    le_pair = f'le="{_fmt(le)}"'
                    lines.append(
                        f"{pn}_bucket{_label_str(labels, le_pair)} "
                        f"{cum}")
                inf_pair = 'le="+Inf"'
                lines.append(
                    f"{pn}_bucket{_label_str(labels, inf_pair)} "
                    f"{m['count']}")
                lines.append(f"{pn}_sum{lab} {_fmt(m['total'])}")
                lines.append(f"{pn}_count{lab} {m['count']}")
            if m["type"] != "counter" and m.get("max") is not None:
                max_twins.append(f"{pn}_max{lab} {_fmt(m['max'])}")
        if max_twins:
            lines.append(f"# TYPE {pn}_max gauge")
            lines.extend(max_twins)
    return "\n".join(lines) + ("\n" if lines else "")


# --------------------------------------------------------- the server


class _OpsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    ops: "OpsServer" = None  # backref, set by OpsServer


class _Handler(BaseHTTPRequestHandler):
    server_version = "jepsen-ops/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: N802 — stdlib name
        _log.debug("ops httpd: " + fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, doc: dict):
        self._reply(code, (json.dumps(doc, default=str, sort_keys=True)
                           + "\n").encode(), "application/json")

    def _fail(self, what: str, err: Exception):
        # one bad render answers 500; the server lives on
        _log.exception("ops httpd: %s failed", what)
        try:
            self._json(500, {"error": f"{type(err).__name__}: {err}"})
        except OSError:
            pass

    def do_GET(self):  # noqa: N802 — stdlib name
        ops = self.server.ops
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._reply(200, render_prometheus().encode(),
                            PROM_CONTENT_TYPE)
            elif path == "/healthz":
                doc = (ops.health_fn() if ops.health_fn is not None
                       else {"ok": True, "checks": {}})
                self._json(200 if doc.get("ok") else 503, doc)
            elif path == "/status":
                self._json(200, ops.status_fn() if ops.status_fn
                           is not None else {})
            else:
                self._json(404, {"error": f"unknown path {path!r}",
                                 "endpoints": ENDPOINTS})
        except Exception as err:  # noqa: BLE001
            self._fail(path, err)

    def do_POST(self):  # noqa: N802 — stdlib name
        ops = self.server.ops
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        # drain the (unused) body so keep-alive framing survives
        clen = int(self.headers.get("Content-Length", 0) or 0)
        if clen:
            self.rfile.read(clen)
        try:
            if path == "/adopt" and ops.adopt_fn is not None:
                adopted = ops.adopt_fn()
                self._json(200, {"adopted": [str(k) for k in adopted]})
            else:
                self._json(404, {"error": f"unknown POST {path!r}",
                                 "endpoints": (["/adopt"] if ops.adopt_fn
                                               else [])})
        except Exception as err:  # noqa: BLE001
            self._fail(f"POST {path}", err)


class OpsServer:
    """The ops endpoint as an object: construct (binds — port 0 gets an
    OS-assigned one, readable as ``.port``), ``start()`` the daemon
    thread, ``close()`` to stop. Callbacks, all optional:

    health_fn   -> {"ok": bool, "checks": {...}}; not ok answers 503
    status_fn   -> the /status document
    adopt_fn    -> the POST /adopt handler (``CheckerService.
                   adopt_keys``): the live handoff a fleet supervisor
                   drives on a survivor"""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 health_fn: Optional[Callable[[], dict]] = None,
                 status_fn: Optional[Callable[[], dict]] = None,
                 adopt_fn: Optional[Callable[[], list]] = None):
        self.health_fn = health_fn
        self.status_fn = status_fn
        self.adopt_fn = adopt_fn
        self._httpd = _OpsHTTPServer((host, port), _Handler)
        self._httpd.ops = self
        self.host = self._httpd.server_address[0]
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "OpsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="jepsen-torch-ops-httpd")
            self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ------------------------------------------------------- the client


def _fetch(url: str, timeout: float = 10.0):
    """(HTTP status, decoded body) for a GET — a 503 from /healthz is an
    answer (degraded), not an error."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def fetch_replica(addr: str, timeout: float = 5.0) -> dict:
    """One replica's ops view over HTTP::

        {"addr": ..., "state": "ready" | "degraded" | "unreachable",
         "health": {...}?, "status": {...}?, "error": ...?}

    ``degraded`` is an answered /healthz that says not ok (the replica
    lives: its WAL still acks); ``unreachable`` is no answer at all
    (the fleet supervisor's miss)."""
    base = f"http://{addr}"
    try:
        hcode, hbody = _fetch(base + "/healthz", timeout)
        _scode, sbody = _fetch(base + "/status", timeout)
        health = json.loads(hbody)
        status = json.loads(sbody)
    except (OSError, ValueError) as err:
        return {"addr": addr, "state": "unreachable", "error": str(err)}
    state = ("ready" if hcode == 200 and health.get("ok")
             else "degraded")
    return {"addr": addr, "state": state, "health": health,
            "status": status}
