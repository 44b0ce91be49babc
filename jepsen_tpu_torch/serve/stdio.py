"""JSONL stdio front-end for the streaming checker service — the
transport ``python -m jepsen_tpu_torch.serve`` reads.

A port of `jepsen_tpu.serve.stdio`. One JSON request per input line,
one JSON response per output line. Requests::

    {"key": K, "ops": [<op map>, ...], "seq": N?,
     "wait": B?, "timeout": S?, "token": T?,
     "delta_id": D?}                                submit a delta
    {"op": "result",   "key": K}                    current verdict
    {"op": "finalize", "key": K}                    drain + final check
    {"op": "drain"}                                 apply everything
    {"op": "stop"}                                  graceful shutdown

Op maps are the history schema ({"type", "process", "f", "value",
...}); responses are the service's structured dicts (``accepted`` /
``shed`` / ``duplicate`` / verdicts) with non-JSON values stringified.
The HTTP ingress (``serve.ingress``) wraps the same
:class:`CheckerService` calls.

Multi-tenant mode sits BELOW the transport (the service's admission
layer), so stdio producers authenticate exactly like HTTP ones: each
submit/result/finalize line may carry ``"token": "<tenant token>"``
(forwarded verbatim to the service, which resolves and enforces it);
with tenants configured and no token, the request is refused with the
service's structured error.

Each delta line runs under the ``serve.stdio.request`` span, the same
shape as the HTTP ingress's, so a trace reads alike whichever transport
carried the delta; a line's ``"delta_id"`` rides through to the service
(armed only), and the span carries the ack's id.
"""

from __future__ import annotations

import json
import sys

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.history import Op, _hashable


def jsonable(obj):
    """A response dict with non-JSON values stringified — the wire
    form BOTH transports (stdio here, ``serve.ingress`` over HTTP)
    emit, shared so they cannot drift."""
    return json.loads(json.dumps(obj, default=str))


def wire_key(req):
    """A request's key, canonicalized: JSON list keys
    (jepsen.independent [k sub] tuples) arrive as lists — map to the
    hashable form the service keys on. Shared with the HTTP
    ingress."""
    return _hashable(req.get("key"))


def run_stdio(service, lines_in=None, out=None) -> int:
    """Drive ``service`` from a JSONL stream; returns an exit code.
    The service is closed (with drain) on EOF or ``stop``."""
    lines_in = sys.stdin if lines_in is None else lines_in
    out = sys.stdout if out is None else out

    def emit(obj):
        out.write(json.dumps(jsonable(obj)) + "\n")
        out.flush()

    try:
        for line in lines_in:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
            except ValueError as err:
                emit({"error": f"bad request line: {err}"})
                continue
            op = req.get("op")
            if op == "stop":
                emit({"stopped": True})
                break
            if op == "drain":
                emit({"drained": service.drain(
                    timeout=req.get("timeout"))})
            elif op == "result":
                emit(service.result(wire_key(req),
                                    timeout=req.get("timeout"),
                                    token=req.get("token")))
            elif op == "finalize":
                emit(service.finalize(wire_key(req),
                                      timeout=req.get("timeout"),
                                      token=req.get("token")))
            elif "ops" in req:
                with obs.span("serve.stdio.request",
                              key=str(req.get("key"))) as sp:
                    r = service.submit(wire_key(req),
                                       [Op(o) for o in req["ops"]],
                                       seq=req.get("seq"),
                                       timeout=req.get("timeout"),
                                       wait=bool(req.get("wait")),
                                       token=req.get("token"),
                                       delta_id=req.get("delta_id"))
                    if isinstance(r, dict) and r.get("delta_id"):
                        sp.set(delta_id=r["delta_id"], seq=r.get("seq"))
                emit(r)
            else:
                emit({"error": f"unknown request {req!r}"})
    finally:
        service.close(drain=True)
    return 0
