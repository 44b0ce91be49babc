"""HTTP delta ingress for the streaming checker service — the
network transport of ``python -m jepsen_tpu_torch.serve``.

A port of `jepsen_tpu.serve.ingress`. An
asyncio, stdlib-only HTTP/1.1 server that wraps the same blocking
:meth:`~jepsen_tpu_torch.serve.service.CheckerService.submit` the stdio
transport drives — the blocking call **is** the backpressure: each
request's submit runs on an executor thread via ``run_in_executor``,
so a producer past its queue blocks (then sheds) exactly like a local
caller while the event loop keeps serving every other connection.

Endpoints (all JSON; request bodies are **streamed JSONL** — one
request object per line, one response object per line, flushed as
chunked transfer as each submit lands, so a long stream acks
incrementally instead of buffering):

    POST /v1/deltas     body lines: {"key": K, "ops": [...],
                        "seq": N?, "timeout": S?, "wait": B?}
                        or {"op": "result"|"finalize", "key": K,
                        "timeout": S?} interleaved mid-stream
    GET  /v1/result?key=<json K>[&timeout=S]
    POST /v1/finalize   body: {"key": K, "timeout": S?}

Auth: with tenants configured (``serve.tenancy``), every request must
carry ``Authorization: Bearer <token>`` naming a tenant; an unknown
or missing token answers 401 before the service sees the request, and
the resolved tenant rides into ``submit`` so admission, quotas, and
the ``{shed, reason, tenant}`` answers are the service's own — one
admission layer for every transport. Without tenants, no auth.

The server runs its event loop on a daemon thread (construct binds,
``start()`` serves, ``close()`` stops, ``.port`` readable for port 0),
so the synchronous entry point and tests drive it without owning a
loop. The executor threads only call the service's blocking methods;
they never touch a tensor (the service's worker owns the device).

Every request counts ``serve.ingress.requests`` (a refused token
``serve.ingress.unauthorized`` too), and every delta line runs under
the ``serve.ingress.request`` span, which the service's
``serve.admit``/``serve.wal`` spans nest under across the executor hop
(``obs.ctx_runner``). A line's ``"delta_id"`` rides through to the
service; the span carries the ack's id.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from jepsen_tpu_torch import envflags, obs
from jepsen_tpu_torch.history import Op, _hashable
from jepsen_tpu_torch.serve.stdio import jsonable as _jsonable
from jepsen_tpu_torch.serve.stdio import wire_key as _key_of

_log = logging.getLogger(__name__)

#: request-line budget: one JSONL delta line must fit (64 ops of a
#: register history is ~4 KiB; 1 MiB leaves room for fat values)
MAX_LINE_BYTES = 1 << 20
#: executor threads = concurrently BLOCKED producers (backpressure
#: waits park here); past this, requests queue at the executor
INGRESS_WORKERS = 32

_JSONL_TYPE = "application/x-ndjson"


def resolve_ingress_port(cli_value: Optional[int] = None) \
        -> Optional[int]:
    """The delta-ingress port: ``--ingress-port`` wins, else
    ``JEPSEN_TPU_TORCH_INGRESS_PORT`` (0 = ephemeral); None when
    neither is set (stdio stays the only transport)."""
    if cli_value is not None:
        return int(cli_value)
    return envflags.env_int("JEPSEN_TPU_TORCH_INGRESS_PORT", default=None,
                            min_value=0, what="delta ingress port")


class DeltaIngress:
    """The HTTP ingress as an object: construct (binds — port 0 gets
    an OS-assigned one, readable as ``.port``), ``start()`` the loop
    thread, ``close()`` to stop. ``tenants`` defaults to the
    service's own table so both layers answer identically."""

    def __init__(self, service, port: int = 0,
                 host: str = "127.0.0.1", tenants=None):
        self.service = service
        self.tenants = (tenants if tenants is not None
                        else getattr(service, "_tenants", None))
        self.host = host
        self.port = None
        self._req_port = port
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._startup_err = None
        self._pool = ThreadPoolExecutor(
            max_workers=INGRESS_WORKERS,
            thread_name_prefix="jepsen-torch-ingress")

    # ------------------------------------------------ thread plumbing

    def start(self) -> "DeltaIngress":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="jepsen-torch-ingress-loop")
        self._thread.start()
        self._ready.wait(timeout=30)
        if self._startup_err is not None:
            raise self._startup_err
        if self.port is None:
            raise RuntimeError("ingress event loop failed to start")
        return self

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            self._server = loop.run_until_complete(
                asyncio.start_server(self._handle, self.host,
                                     self._req_port,
                                     limit=MAX_LINE_BYTES))
            self.port = self._server.sockets[0].getsockname()[1]
        except Exception as err:  # noqa: BLE001 — surfaced to start()
            self._startup_err = err
            self._ready.set()
            return
        self._ready.set()
        try:
            loop.run_forever()
        finally:
            self._server.close()
            loop.run_until_complete(self._server.wait_closed())
            loop.close()

    def url(self, path: str = "") -> str:
        return f"http://{self.host}:{self.port}{path}"

    def close(self) -> None:
        if self._loop is not None and self._loop.is_running():
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    # --------------------------------------------------- HTTP plumbing

    async def _call(self, fn, *args, **kw):
        """The blocking service call on an executor thread — the
        backpressure parks HERE while the loop serves everyone else.
        Executor threads do not inherit the request task's contextvars:
        the per-call ``Context.copy()`` (``obs.ctx_runner``; the
        identity wrap with tracing off) is what nests the service's
        spans under the request's."""
        loop = asyncio.get_running_loop()
        wrap = obs.ctx_runner()
        return await loop.run_in_executor(
            self._pool, wrap(lambda: fn(*args, **kw)))

    @staticmethod
    def _response(writer, code: int, body: bytes,
                  ctype: str = "application/json",
                  chunked: bool = False) -> None:
        reason = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
                  404: "Not Found", 405: "Method Not Allowed",
                  413: "Payload Too Large",
                  500: "Internal Server Error"}.get(code, "OK")
        head = [f"HTTP/1.1 {code} {reason}",
                f"Content-Type: {ctype}"]
        if chunked:
            head.append("Transfer-Encoding: chunked")
        else:
            head.append(f"Content-Length: {len(body)}")
        head.append("")
        head.append("")
        writer.write("\r\n".join(head).encode())
        if not chunked and body:
            writer.write(body)

    @staticmethod
    def _chunk(data: bytes) -> bytes:
        return f"{len(data):x}\r\n".encode() + data + b"\r\n"

    def _json_err(self, writer, code: int, msg: str) -> None:
        self._response(writer, code,
                       (json.dumps({"error": msg}) + "\n").encode())

    def _auth(self, headers) -> tuple:
        """(token, error message | None): with tenants configured a
        Bearer token is REQUIRED and must name a tenant; without, no
        auth (token passes through as None)."""
        auth = headers.get("authorization", "")
        token = None
        if auth.lower().startswith("bearer "):
            token = auth[7:].strip()
        if self.tenants is None:
            return None, None
        if not token:
            return None, ("unauthorized: Authorization: Bearer "
                          "<tenant token> required")
        if self.tenants.by_token(token) is None:
            return None, "unauthorized: unknown tenant token"
        return token, None

    async def _handle(self, reader, writer) -> None:
        try:
            while True:
                keep = await self._handle_one(reader, writer)
                await writer.drain()
                if not keep:
                    break
        except (asyncio.IncompleteReadError, ConnectionResetError,
                asyncio.LimitOverrunError):
            pass
        except Exception:  # noqa: BLE001 — one bad connection must
            # not kill the acceptor loop's handler task silently
            _log.exception("ingress: connection handler failed")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, OSError):
                pass

    async def _handle_one(self, reader, writer) -> bool:
        """One request/response exchange; returns False to close the
        connection (EOF, Connection: close, or a streamed body whose
        framing we did not fully consume)."""
        try:
            line = await reader.readline()
        except (asyncio.LimitOverrunError, ValueError):
            self._json_err(writer, 413, "request line too long")
            return False
        if not line:
            return False
        try:
            method, target, _version = line.decode().split()
        except ValueError:
            self._json_err(writer, 400, "malformed request line")
            return False
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, val = h.decode().partition(":")
            headers[name.strip().lower()] = val.strip()
        obs.counter("serve.ingress.requests").inc()
        token, auth_err = self._auth(headers)
        clen = int(headers.get("content-length", 0) or 0)
        if auth_err is not None:
            obs.counter("serve.ingress.unauthorized").inc()
            # drain the body so the connection stays framed
            if clen:
                await reader.readexactly(min(clen, MAX_LINE_BYTES))
            self._json_err(writer, 401, auth_err)
            return False
        path, _, query = target.partition("?")
        path = path.rstrip("/") or "/"
        keep = headers.get("connection", "").lower() != "close"
        try:
            if method == "POST" and path == "/v1/deltas":
                if clen <= 0:
                    # no Content-Length (e.g. a chunked request body,
                    # which this server does not frame): an empty
                    # 200 would silently ack nothing and the unread
                    # body would corrupt keep-alive framing
                    self._json_err(writer, 400,
                                   "Content-Length required (chunked "
                                   "request bodies unsupported)")
                    return False
                await self._deltas(reader, writer, token, clen)
                return keep
            if method == "GET" and path == "/v1/result":
                q = urllib.parse.parse_qs(query)
                try:
                    key = _hashable(json.loads(q.get("key", [""])[0]))
                except ValueError:
                    self._json_err(writer, 400,
                                   "key must be a JSON value")
                    return keep
                try:
                    timeout = (float(q["timeout"][0])
                               if "timeout" in q else None)
                except ValueError:
                    # a malformed query param is the client's bug and
                    # must answer 400, not drop the connection
                    self._json_err(writer, 400,
                                   "timeout must be a number")
                    return keep
                r = await self._call(self.service.result, key,
                                     timeout=timeout, token=token)
                self._response(writer, 200, (json.dumps(
                    _jsonable(r)) + "\n").encode())
                return keep
            if method == "POST" and path == "/v1/finalize":
                body = await reader.readexactly(clen)
                req = json.loads(body or b"{}")
                r = await self._call(self.service.finalize,
                                     _key_of(req),
                                     timeout=req.get("timeout"),
                                     token=token)
                self._response(writer, 200, (json.dumps(
                    _jsonable(r)) + "\n").encode())
                return keep
            if path == "/":
                self._response(writer, 200, (json.dumps(
                    {"endpoints": ["/v1/deltas", "/v1/result",
                                   "/v1/finalize"]}) + "\n").encode())
                return keep
            self._json_err(writer, 404 if method in ("GET", "POST")
                           else 405, f"unknown endpoint {method} "
                                     f"{path}")
            return keep
        except json.JSONDecodeError as err:
            self._json_err(writer, 400, f"bad request body: {err}")
            return keep

    async def _deltas(self, reader, writer, token, clen: int) -> None:
        """The streamed-JSONL delta endpoint: responses flush as
        chunked transfer per input line, in order, so a producer sees
        each ack (or shed) as its delta lands rather than after the
        whole body."""
        self._response(writer, 200, b"", ctype=_JSONL_TYPE,
                       chunked=True)
        remaining = clen
        while remaining > 0:
            line = await reader.readline()
            if not line:
                break
            remaining -= len(line)
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except ValueError as err:
                resp = {"error": f"bad request line: {err}"}
            else:
                resp = await self._one_delta(req, token)
            writer.write(self._chunk(
                (json.dumps(_jsonable(resp)) + "\n").encode()))
            await writer.drain()
        writer.write(b"0\r\n\r\n")

    async def _one_delta(self, req: dict, token) -> dict:
        op = req.get("op")
        if op == "result":
            return await self._call(self.service.result,
                                    _key_of(req),
                                    timeout=req.get("timeout"),
                                    token=token)
        if op == "finalize":
            return await self._call(self.service.finalize,
                                    _key_of(req),
                                    timeout=req.get("timeout"),
                                    token=token)
        if "ops" not in req:
            return {"error": f"unknown request {req!r}"}
        try:
            ops = [Op(o) for o in req["ops"]]
        except Exception as err:  # noqa: BLE001 — a malformed op map
            # is the producer's bug and must answer, not disconnect
            return {"error": f"bad ops: {type(err).__name__}: {err}"}
        # the ingress leg of the delta's chain: the service's admit and
        # WAL spans parent under this one (the Context.copy in _call)
        with obs.span("serve.ingress.request",
                      key=str(req.get("key"))) as sp:
            r = await self._call(
                self.service.submit, _key_of(req), ops,
                seq=req.get("seq"), timeout=req.get("timeout"),
                wait=bool(req.get("wait")), token=token,
                delta_id=req.get("delta_id"))
            if isinstance(r, dict) and r.get("delta_id"):
                sp.set(delta_id=r["delta_id"], seq=r.get("seq"))
            return r


def start_ingress(service, port: int, host: str = "127.0.0.1",
                  **kw) -> DeltaIngress:
    """Bind + start in one call (the module entry point's)."""
    return DeltaIngress(service, port=port, host=host, **kw).start()
