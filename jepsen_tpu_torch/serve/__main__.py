"""``python -m jepsen_tpu_torch.serve``: the streaming checker service
on the card — the port's counterpart of the reference's ``jepsen serve
--checker`` (jepsen_tpu/cli.py:332-430), trimmed to its model, WAL,
dedupe, host and ingress-port options.

Reads JSONL delta requests on stdin and answers on stdout
(``serve.stdio``); with ``--ingress-port`` (or
``JEPSEN_TPU_TORCH_INGRESS_PORT``) it also serves the HTTP ingress
and prints ``delta ingress: http://HOST:PORT`` on stderr (port 0: an
OS-assigned one). ``{"op": "stop"}`` on stdin drains and exits 0.
Without a CUDA device it exits non-zero with the RuntimeError's text:
there is no CPU run from here.
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
    p.add_argument("--host", default="0.0.0.0",
                   help="the ingress's bind address")
    p.add_argument("--ingress-port", type=int, default=None,
                   help="accept streamed-JSONL delta requests over "
                        "HTTP on this port (POST /v1/deltas, GET "
                        "/v1/result, POST /v1/finalize; per-tenant "
                        "bearer-token auth when JEPSEN_TPU_TORCH_TENANTS "
                        "is set; 0 = OS-assigned; default: "
                        "JEPSEN_TPU_TORCH_INGRESS_PORT, unset = stdio "
                        "only)")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from jepsen_tpu_torch import models as model_ns
    from jepsen_tpu_torch.envflags import EnvFlagError
    from jepsen_tpu_torch.serve import CheckerService, default_wal_dir
    from jepsen_tpu_torch.serve import ingress as ingress_mod
    from jepsen_tpu_torch.serve.stdio import run_stdio
    model = getattr(model_ns, SERVE_MODELS[args.model])()
    try:
        iport = ingress_mod.resolve_ingress_port(args.ingress_port)
        svc = CheckerService(model,
                             wal_dir=args.wal_dir or default_wal_dir(),
                             dedupe=args.dedupe)
    except (RuntimeError, EnvFlagError) as err:
        print(f"jepsen_tpu_torch.serve: {err}", file=sys.stderr)
        return 1
    ing = None
    try:
        if iport is not None:
            ing = ingress_mod.start_ingress(svc, iport, host=args.host)
            print(f"delta ingress: http://{args.host}:{ing.port} "
                  f"(POST /v1/deltas — streamed JSONL)", file=sys.stderr,
                  flush=True)
        return run_stdio(svc)
    finally:
        if ing is not None:
            ing.close()
        svc.close(drain=False)


if __name__ == "__main__":
    sys.exit(main())
