"""``python -m jepsen_tpu_torch.serve``: the streaming checker service
on the card — the port's counterpart of the reference's ``jepsen serve
--checker`` (jepsen_tpu/cli.py:332-430), trimmed to its model, WAL,
dedupe, host, replication, ops-port and ingress-port options.

Reads JSONL delta requests on stdin and answers on stdout
(``serve.stdio``); with ``--ingress-port`` (or
``JEPSEN_TPU_TORCH_INGRESS_PORT``) it also serves the HTTP ingress
and prints ``delta ingress: http://HOST:PORT`` on stderr, and with
``--ops-port`` (or ``JEPSEN_TPU_TORCH_OPS_PORT``) the ops endpoint
(``/metrics``, ``/healthz``, ``/status``, ``/trace``, ``POST /adopt``;
the service's ``refresh_gauges`` runs before each of the first three)
and prints ``ops endpoint: http://HOST:PORT`` (port 0: an OS-assigned
one). The tracing surface is armed from the environment:
``JEPSEN_TPU_TORCH_TRACE=1`` (spans, served on ``/trace``; delta ids on
acks and WAL records), ``JEPSEN_TPU_TORCH_FLIGHT_RECORDER`` (a span ring
and the dumps under ``<wal>/flight``), ``JEPSEN_TPU_TORCH_SLOW_DELTA_SECS``
(slow-delta records on ``/status``) and ``JEPSEN_TPU_TORCH_SLO_ACK_SECS``
/ ``_SLO_BURN_MAX`` (the burn-rate gauges and ``/healthz``'s ``slo``).
``--repl-dir PATH`` with ``JEPSEN_TPU_TORCH_SERVE_REPL=sync|async``
ships every key's WAL segments to PATH (a successor's ``repl/``
mirror); a mode without ``--repl-dir``, ``--repl-dir`` with the mode
off, or ``--repl-dir`` without a WAL are usage errors (exit 2).
``JEPSEN_TPU_TORCH_PROBE_INTERVAL`` (seconds) arms the device-health
watch (``probe.ProbeWatch``) on the service's device: ``/healthz`` then
carries its status as ``checks["probe"]`` and ANDs it into ``ok``, as
the reference CLI does (jepsen_tpu/cli.py:387-399).
``{"op": "stop"}`` on stdin drains and exits 0. Without a CUDA device
it exits non-zero with the RuntimeError's text unless ``--device cpu``
asks for the plain run on the CPU.
"""

from __future__ import annotations

import argparse
import sys

# model families the service can be started with; values are
# jepsen_tpu_torch.models class names, instantiated with their defaults
SERVE_MODELS = {
    "register": "Register",
    "cas-register": "CASRegister",
    "mutex": "Mutex",
    "gset": "GSet",
    "fifo": "FIFOQueue",
    "uqueue": "UnorderedQueue",
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jepsen_tpu_torch.serve",
        description="the streaming checker service on the card: JSONL "
                    "delta requests on stdin, verdict responses on "
                    "stdout")
    p.add_argument("--model", default="cas-register",
                   choices=sorted(SERVE_MODELS), help="model family")
    p.add_argument("--wal-dir", default=None,
                   help="delta WAL + checkpoint-store directory "
                        "(default: JEPSEN_TPU_TORCH_SERVE_WAL; unset = "
                        "no WAL)")
    p.add_argument("--dedupe", default=None, choices=("sort", "hash"),
                   help="frontier dedupe strategy (default: "
                        "JEPSEN_TPU_TORCH_DEDUPE, else hash)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the checks run (default: cuda, the card; "
                        "cpu: the plain PyTorch path)")
    p.add_argument("--host", default="0.0.0.0",
                   help="the ingress's bind address")
    p.add_argument("--repl-dir", default=None,
                   help="ship every key's WAL segments to this "
                        "directory (the successor replica's repl/ "
                        "mirror); the mode comes from "
                        "JEPSEN_TPU_TORCH_SERVE_REPL (sync|async)")
    p.add_argument("--ops-port", type=int, default=None,
                   help="serve the ops endpoint (GET /metrics, /healthz, "
                        "/status, /trace; POST /adopt) on this port (0 = "
                        "OS-assigned; default: JEPSEN_TPU_TORCH_OPS_PORT, "
                        "unset = off)")
    p.add_argument("--ingress-port", type=int, default=None,
                   help="accept streamed-JSONL delta requests over "
                        "HTTP on this port (POST /v1/deltas, GET "
                        "/v1/result, POST /v1/finalize; per-tenant "
                        "bearer-token auth when JEPSEN_TPU_TORCH_TENANTS "
                        "is set; 0 = OS-assigned; default: "
                        "JEPSEN_TPU_TORCH_INGRESS_PORT, unset = stdio "
                        "only)")
    return p


def _repl_usage(args, wal_dir, mode: str):
    """The reference's three usage errors of --repl-dir and the
    replication mode, or None."""
    if mode != "off" and not args.repl_dir:
        return (f"JEPSEN_TPU_TORCH_SERVE_REPL={mode!r} but no --repl-dir "
                f"names the successor's mirror — add --repl-dir PATH or "
                f"unset the flag")
    if args.repl_dir and mode == "off":
        return ("--repl-dir given but JEPSEN_TPU_TORCH_SERVE_REPL is "
                "off/unset — set the mode (async|sync) or drop the flag")
    if args.repl_dir and not wal_dir:
        return ("--repl-dir needs a WAL-backed service (--wal-dir / "
                "JEPSEN_TPU_TORCH_SERVE_WAL)")
    return None


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from jepsen_tpu_torch import models as model_ns
    from jepsen_tpu_torch import probe as probe_mod
    from jepsen_tpu_torch.envflags import EnvFlagError
    from jepsen_tpu_torch.obs import httpd as ops_httpd
    from jepsen_tpu_torch.parallel import bitdense
    from jepsen_tpu_torch.serve import CheckerService, default_wal_dir
    from jepsen_tpu_torch.serve import fleet
    from jepsen_tpu_torch.serve import ingress as ingress_mod
    from jepsen_tpu_torch.serve.stdio import run_stdio
    from jepsen_tpu_torch.serve.wal import DeltaWAL
    model = getattr(model_ns, SERVE_MODELS[args.model])()
    try:
        wal_dir = args.wal_dir or default_wal_dir()
        mode = fleet.resolve_repl_mode()
        usage = _repl_usage(args, wal_dir, mode)
        if usage is not None:
            print(f"jepsen_tpu_torch.serve: {usage}", file=sys.stderr)
            return 2
        iport = ingress_mod.resolve_ingress_port(args.ingress_port)
        oport = ops_httpd.resolve_ops_port(args.ops_port)
        dev = bitdense.resolve_device(args.device)  # before any file
        replicator = (fleet.SegmentReplicator(
            DeltaWAL(wal_dir), fleet.constant_dst(args.repl_dir),
            mode=mode) if args.repl_dir else None)
        svc = CheckerService(model, wal_dir=wal_dir, dedupe=args.dedupe,
                             device=dev, replicator=replicator)
    except (RuntimeError, EnvFlagError) as err:
        print(f"jepsen_tpu_torch.serve: {err}", file=sys.stderr)
        return 1
    ing = ops = watch = None
    try:
        watch = probe_mod.start_watch_from_env(device=dev.type)

        def health():
            doc = svc.health()
            if watch is not None:
                p = watch.status()
                doc["checks"]["probe"] = p
                doc["ok"] = doc["ok"] and p["ok"]
            return doc

        if oport is not None:
            # POST /adopt is the fleet supervisor's live handoff: a
            # WAL-backed service only (adopt_keys raises without one)
            ops = ops_httpd.OpsServer(
                oport, host=args.host, health_fn=health,
                status_fn=svc.status, refresh_fn=svc.refresh_gauges,
                adopt_fn=svc.adopt_keys if wal_dir else None).start()
            print(f"ops endpoint: http://{args.host}:{ops.port} "
                  f"(/metrics /healthz /status /trace, POST /adopt)",
                  file=sys.stderr, flush=True)
        if iport is not None:
            ing = ingress_mod.start_ingress(svc, iport, host=args.host)
            print(f"delta ingress: http://{args.host}:{ing.port} "
                  f"(POST /v1/deltas — streamed JSONL)", file=sys.stderr,
                  flush=True)
        return run_stdio(svc)
    except EnvFlagError as err:
        print(f"jepsen_tpu_torch.serve: {err}", file=sys.stderr)
        return 1
    finally:
        if watch is not None:
            watch.stop()
        if ing is not None:
            ing.close()
        if ops is not None:
            ops.close()
        svc.close(drain=False)


if __name__ == "__main__":
    sys.exit(main())
