"""Shared helpers of the fleet tests (tests/test_torch_{ring,fleet,ops}.py):
one scenario runs against the reference's serve stack ("ref",
jepsen_tpu.serve) and the port's ("port", jepsen_tpu_torch.serve, on the
CPU), and the answers it returns are held equal, field for field and
exactly, but for the fields measured in seconds (TIMES: compared by
presence, key set and type) and the port's route tag (PORT_ONLY) — the
same lists as tests/test_torch_serve.py's. OBS_ONLY, the reference's
fields the port leaves out, is empty."""

import types

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu import obs as ref_obs
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.obs import httpd as ref_httpd
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu.resilience import breaker as ref_breaker
from jepsen_tpu.serve import CheckerService as RefService
from jepsen_tpu.serve import fleet as ref_fleet
from jepsen_tpu.serve import ring as ref_ring
from jepsen_tpu.serve.wal import DeltaWAL as RefWAL
from jepsen_tpu_torch import models, obs
from jepsen_tpu_torch.history import Op
from jepsen_tpu_torch.obs import httpd
from jepsen_tpu_torch.resilience import breaker
from jepsen_tpu_torch.serve import CheckerService, fleet, ring
from jepsen_tpu_torch.serve.stdio import jsonable
from jepsen_tpu_torch.serve.wal import DeltaWAL

OBS_ONLY = ()
TIMES = ("ack_p50", "ack_p99", "verdict_p50", "verdict_p99",
         "total_secs", "stages", "slowest_stage")
PORT_ONLY = ("closure",)
PIN = ("valid?", "op", "fail-event", "max-frontier", "configs-stepped")
#: the metric families the fleet states its behaviour in
FLEET_METRICS = ("fleet.", "serve.repl_", "serve.ring.",
                 "resilience.breaker.")

PKGS = {
    "ref": types.SimpleNamespace(
        ring=ref_ring, fleet=ref_fleet, WAL=RefWAL, obs=ref_obs,
        httpd=ref_httpd, breaker=ref_breaker, Op=RefOp,
        FLAG="JEPSEN_TPU_"),
    "port": types.SimpleNamespace(
        ring=ring, fleet=fleet, WAL=DeltaWAL, obs=obs, httpd=httpd,
        breaker=breaker, Op=Op, FLAG="JEPSEN_TPU_TORCH_"),
}


def service(pkg, wal_dir=None, model="CASRegister", **kw):
    """`pkg`'s service, dedupe "hash" and capacity 128 on both (the
    reference's default dedupe is sort)."""
    kw.setdefault("capacity", 128)
    kw.setdefault("dedupe", "hash")
    if wal_dir is not None:
        kw["wal_dir"] = str(wal_dir)
    if pkg == "ref":
        return RefService(getattr(ref_models, model)(), **kw)
    return CheckerService(getattr(models, model)(), device="cpu", **kw)


def ops(pkg, op_dicts):
    return [PKGS[pkg].Op(o) for o in op_dicts]


def shape(v):
    """A time field's presence, key set and type."""
    if isinstance(v, dict):
        return {k: type(x).__name__ for k, x in v.items()}
    return type(v).__name__


def norm(x, drop):
    if isinstance(x, dict):
        return {k: ("wal" if k == "dir" else shape(v) if k in TIMES
                    else norm(v, drop))
                for k, v in x.items() if k not in drop}
    if isinstance(x, list):
        return [norm(v, drop) for v in x]
    return x


def same(ref_answers, port_answers):
    want = norm(jsonable(ref_answers), OBS_ONLY)
    got = norm(jsonable(port_answers), PORT_ONLY)
    assert got == want


def both(scenario, *args, **kw):
    """`scenario(pkg, ...)` for each package, the answers held equal."""
    ref = scenario("ref", *args, **kw)
    port = scenario("port", *args, **kw)
    same(ref, port)
    return ref, port


#: the tracing surface's flags, each package's spelling
OBS_FLAGS = ("TRACE", "FLIGHT_RECORDER", "SLOW_DELTA_SECS", "SLO_ACK_SECS",
             "SLO_BURN_MAX")


def unarmed(monkeypatch):
    """Both packages' tracing surface off (every flag unset, the tracers
    re-read, no flight dumps counted), both breaker registries and both
    metric registries empty: the state each unarmed parity case starts
    from. The metric registries matter because the reference's own tests
    reuse these tenant names: a labeled histogram an earlier test left
    would show in one package's per-tenant quantiles and not the
    other's."""
    for P in PKGS.values():
        for flag in OBS_FLAGS:
            monkeypatch.delenv(P.FLAG + flag, raising=False)
        P.obs.reset()
        P.obs.flight_reset()
        P.obs.registry().reset()
        P.breaker.reset()


def armed(monkeypatch, **flags):
    """Both packages' tracing surface armed with ``flags`` (names
    without the package prefix: ``TRACE="1"``, ...), the tracers
    re-read."""
    unarmed(monkeypatch)
    for P in PKGS.values():
        for flag, value in flags.items():
            monkeypatch.setenv(P.FLAG + flag, value)
        P.obs.reset()


def serve_chain(pkg) -> set:
    """`pkg`'s recorded ``serve.*`` spans as (name, parent's name,
    delta id or ids) triples: the shape of every delta's chain, without
    the raw span ids or times."""
    spans = PKGS[pkg].obs.tracer().spans()
    by_id = {s.sid: s for s in spans}
    out = set()
    for s in spans:
        if not s.name.startswith("serve."):
            continue
        parent = by_id.get(s.parent)
        ids = s.args.get("delta_id")
        if ids is None and s.args.get("delta_ids") is not None:
            ids = tuple(s.args["delta_ids"])
        out.add((s.name, parent.name if parent is not None else None, ids))
    return out


def fleet_delta(pkg, before):
    """What moved in `pkg`'s registry since `before`, the fleet's metric
    families only."""
    reg = PKGS[pkg].obs.registry()
    return {k: v for k, v in reg.delta(before).items()
            if k.startswith(FLEET_METRICS)}


def register_history(seed=2, corrupt=True, n_ops=20):
    h = ref_histories.rand_register_history(n_ops=n_ops, n_processes=4,
                                            n_values=3, crash_p=0.05,
                                            seed=seed)
    if corrupt:
        h = ref_histories.corrupt_history(h, seed=1, n_corruptions=2)
    return [dict(o) for o in h]


def one_shot(op_dicts, model="CASRegister"):
    """The reference's one-shot check (dedupe "hash", capacity 128)."""
    e = ref_enc.encode(getattr(ref_models, model)(),
                       RefHistory.wrap([RefOp(o) for o in op_dicts]))
    return ref_engine.check_encoded(e, capacity=128, dedupe="hash")


def pin(r):
    return {k: r.get(k) for k in PIN}
