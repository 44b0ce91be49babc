"""Telemetry exporters: JSONL events, Chrome trace-event JSON
(Perfetto-openable), the end-of-run summary table, the search-stats and
slow-delta collectors and the flight recorder's dump.

A copy of `jepsen_tpu.obs.export`, with the reference's record shapes,
so ``jepsen trace`` or a Perfetto view reads either package's files the
same way. Chrome trace format (the ``ui.perfetto.dev`` /
``chrome://tracing`` interchange): a JSON array of event objects —
complete events (``"ph": "X"``, ``ts``/``dur`` in microseconds),
``"M"`` metadata naming processes and threads, and counter ``"C"``
events:

  * pid 1 ("host"): one track per host thread that opened spans;
  * pid 2 ("device"): one track per device bucket (``bucket-{tier}``:
    spans recorded through ``Tracer.add_span(track=...)`` for each
    chunk's issue-to-finalize window, on the host's clock — no host
    thread "runs" them).

Open the file in Perfetto beside a ``torch.profiler`` capture of the
same run (``JEPSEN_TPU_TORCH_PROFILE``): the kernels carry the
``bitdense …`` and ``sharded …`` annotations of the host spans around
them.

The JSONL export is the machine-readable sibling: one span object per
line (``Span.to_dict``) followed by one ``{"type": "metric", ...}``
line per registry entry (``telemetry.jsonl`` in a run dir).

Import-safe: the standard library only.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from collections import deque
from typing import Dict, List, Optional

from jepsen_tpu_torch.obs import metrics as _metrics
from jepsen_tpu_torch.obs import tracer as _tracer

_log = logging.getLogger(__name__)

HOST_PID = 1
DEVICE_PID = 2


def chrome_trace(tr: Optional[_tracer.Tracer] = None,
                 spans: Optional[List] = None) -> List[dict]:
    """The trace-event array for the active (or given) tracer's spans.
    Empty list when tracing is off — a valid trace document either
    way. ``spans`` overrides the tracer's buffer read — the flight
    dump passes the ring's retained spans."""
    tr = tr or _tracer.tracer()
    if tr is None:
        return []
    if spans is None:
        spans = tr.spans()
    events: List[dict] = [
        {"ph": "M", "pid": HOST_PID, "name": "process_name",
         "args": {"name": "host"}},
        {"ph": "M", "pid": DEVICE_PID, "name": "process_name",
         "args": {"name": "device"}},
        # the wall-clock epoch stamp: ts 0 of this trace on the unix
        # clock, so `jepsen trace` can merge several replicas' exports
        # onto one aligned time axis (Perfetto ignores unknown "M"
        # records)
        {"ph": "M", "pid": HOST_PID, "name": "trace_epoch",
         "args": {"unix": round(tr.epoch_unix, 6)}},
    ]
    # stable synthetic tids for device-bucket tracks, in first-seen
    # order; host tracks use the real thread idents
    track_tid: Dict[str, int] = {}
    seen_threads: Dict[int, str] = {}
    for s in spans:
        if s.track is not None:
            if s.track not in track_tid:
                tid = len(track_tid) + 1
                track_tid[s.track] = tid
                events.append({"ph": "M", "pid": DEVICE_PID, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": s.track}})
            pid, tid = DEVICE_PID, track_tid[s.track]
        else:
            tid, tname = s.thread
            if tid not in seen_threads:
                seen_threads[tid] = tname
                events.append({"ph": "M", "pid": HOST_PID, "tid": tid,
                               "name": "thread_name",
                               "args": {"name": tname}})
            pid = HOST_PID
        args = dict(s.args)
        args["span_id"] = s.sid
        if s.parent is not None:
            args["parent_id"] = s.parent
        if s.cpu:
            args["cpu_secs"] = round(s.cpu, 6)
        events.append({
            "ph": "X", "pid": pid, "tid": tid, "name": s.name,
            "cat": s.name.split(".")[0],
            "ts": round((s.t0 - tr.epoch) * 1e6, 1),
            "dur": round(max(s.t1 - s.t0, 0.0) * 1e6, 1),
            "args": args,
        })
    # counter tracks ("C" events): gauge levels and search-stats
    # trajectories — Perfetto renders each name as an area chart
    # aligned with the span tracks above. Absent entirely when nothing sampled, so a
    # run that never touched a sampled gauge keeps its old trace file.
    for name, t, value in tr.counters():
        events.append({
            "ph": "C", "pid": HOST_PID, "tid": 0, "name": name,
            "cat": name.split(".")[0],
            "ts": round((t - tr.epoch) * 1e6, 1),
            "args": {"value": value},
        })
    return events


def write_chrome_trace(path: str,
                       tr: Optional[_tracer.Tracer] = None) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        json.dump(chrome_trace(tr), fh)
    return path


def jsonl_events(tr: Optional[_tracer.Tracer] = None,
                 reg: Optional[_metrics.Registry] = None,
                 snap: Optional[Dict[str, dict]] = None) -> List[dict]:
    """``snap`` overrides the registry read — export_run passes the
    per-run delta so artifacts describe one run, not the process."""
    tr = tr or _tracer.tracer()
    if snap is None:
        snap = (reg or _metrics.registry()).snapshot()
    out: List[dict] = []
    if tr is not None:
        out.extend(s.to_dict() for s in tr.spans())
    for name, m in snap.items():
        d = dict(m)
        # the metric's own kind moves aside so every JSONL line keys
        # uniformly on "type": "span" | "metric"
        d["metric_type"] = d.pop("type")
        out.append({"type": "metric", "name": name, **d})
    return out


def write_jsonl(path: str, tr: Optional[_tracer.Tracer] = None,
                reg: Optional[_metrics.Registry] = None,
                snap: Optional[Dict[str, dict]] = None) -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        for obj in jsonl_events(tr, reg, snap):
            fh.write(json.dumps(obj) + "\n")
    return path


def summary(tr: Optional[_tracer.Tracer] = None,
            reg: Optional[_metrics.Registry] = None,
            snap: Optional[Dict[str, dict]] = None) -> str:
    """The end-of-run human table: spans aggregated by name
    (count / total wall / mean / total CPU), then every registry
    metric. Plain text, aligned, stable column order — the thing a
    human reads before deciding whether to open the trace."""
    tr = tr or _tracer.tracer()
    if snap is None:
        snap = (reg or _metrics.registry()).snapshot()
    lines: List[str] = []
    if tr is not None:
        agg: Dict[str, list] = {}
        for s in tr.spans():
            a = agg.setdefault(s.name, [0, 0.0, 0.0])
            a[0] += 1
            a[1] += s.wall
            a[2] += s.cpu
        if agg:
            lines.append(f"{'span':<28} {'count':>7} {'total_s':>10} "
                         f"{'mean_ms':>10} {'cpu_s':>9}")
            for name in sorted(agg):
                n, wall, cpu = agg[name]
                lines.append(f"{name:<28} {n:>7} {wall:>10.4f} "
                             f"{wall / n * 1e3:>10.3f} {cpu:>9.4f}")
    if snap:
        if lines:
            lines.append("")
        lines.append(f"{'metric':<36} {'type':<10} value")
        for name, m in snap.items():
            if m["type"] == "counter":
                val = str(m["value"])
            elif m["type"] == "gauge":
                # max None: a per-run delta where the run's own peak
                # stayed below the process high-water (delta() doc)
                mx = "n/a" if m["max"] is None else m["max"]
                val = f"{m['value']} (max {mx})"
            else:
                val = (f"n={m['count']} total={m['total']} "
                       f"mean={m['mean']}")
            lines.append(f"{name:<36} {m['type']:<10} {val}")
    return "\n".join(lines) + ("\n" if lines else "")


# ------------------------------------------- search-stats collector

# Per-key device-search stats blocks (JEPSEN_TPU_TORCH_SEARCH_STATS — see
# parallel.search_stats), recorded by the engines as each search finishes and
# drained into <run_dir>/search_stats.jsonl by export_run — the record
# `jepsen report --search` renders. Bounded: a long soak must not grow
# host memory through its own telemetry.
SEARCH_STATS_MAX_RECORDS = 4096
_search_stats_lock = threading.Lock()
_search_stats: list = []
_search_stats_dropped = 0


def record_search_stats(rec: dict) -> None:
    """Append one per-key search-stats record (a JSON-serializable
    dict). Past the bound the OLDEST record is dropped (counted):
    streamed keys re-record their lifetime block every delta and the
    report keeps the newest per key, so the newest evidence must be
    the side that survives."""
    global _search_stats_dropped
    with _search_stats_lock:
        if len(_search_stats) >= SEARCH_STATS_MAX_RECORDS:
            _search_stats.pop(0)
            _search_stats_dropped += 1
            _metrics.counter("obs.search_stats_dropped").inc()
        _search_stats.append(dict(rec))


def search_stats_records() -> list:
    with _search_stats_lock:
        return [dict(r) for r in _search_stats]


def drain_search_stats() -> list:
    """Hand over the collected records and clear the buffer — the same
    per-run semantics as the span buffer."""
    global _search_stats
    with _search_stats_lock:
        out = _search_stats
        _search_stats = []
        return out


def _write_jsonl_records(path: str, records: list) -> str:
    """One record per line — the shared shape of every drained-ring
    run artifact (search stats, slow deltas)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(rec, default=str) + "\n")
    return path


def write_search_stats(path: str, records: list) -> str:
    return _write_jsonl_records(path, records)


# ------------------------------------------- slow-delta forensics

# Bounded newest-wins ring of slow-delta records (deltas whose
# ingest->verdict latency crossed a slow-delta threshold; the serve
# service does not feed it yet): each record is the delta's
# stage-by-stage timing breakdown plus its verdict/resilience/
# search-stats context. A deque
# with maxlen drops the OLDEST record past the bound — in a sustained
# slowdown the newest evidence is the side that must survive.
SLOW_DELTA_MAX_RECORDS = 256
_slow_lock = threading.Lock()
#: ring entries are ``(scope, record)`` — the collector is process-
#: global (like every obs sink) but the DATA is per CheckerService:
#: two services in one process (serve_smoke) must not read each
#: other's forensics on /status, and one service's huge offender must
#: not suppress another's flight dump. ``scope`` is the service's
#: opaque identity (None = unscoped callers, e.g. tests).
_slow_deltas: deque = deque(maxlen=SLOW_DELTA_MAX_RECORDS)
_slow_worst: Dict = {}        # scope -> worst total since arm/reset


def _slow_ring() -> deque:
    return _slow_deltas


def record_slow_delta(rec: dict, scope=None) -> bool:
    """Append one slow-delta record; returns True when this record is
    the WORST offender so far WITHIN ITS SCOPE (largest total) — the
    caller's cue to flight-dump it (``serve.service`` does, outside
    its lock)."""
    total = float(rec.get("total_secs") or 0.0)
    with _slow_lock:
        ring = _slow_ring()
        if len(ring) >= SLOW_DELTA_MAX_RECORDS:
            _metrics.counter("obs.slow_deltas_dropped").inc()
        ring.append((scope, dict(rec)))
        worst = total > _slow_worst.get(scope, 0.0)
        if worst:
            _slow_worst[scope] = total
    _metrics.counter("serve.slow_deltas").inc()
    return worst


def slow_delta_records(scope=None) -> list:
    """The retained slow-delta records, oldest first (the /status
    surface reads this without draining). ``scope`` filters to one
    recorder's records; None returns everything."""
    with _slow_lock:
        return [dict(r) for s, r in _slow_ring()
                if scope is None or s == scope]


def drain_slow_deltas() -> list:
    """Hand over ALL scopes' records and clear the ring (and every
    worst-offender high-water) — per-run semantics like the span
    buffer; the run artifact is process-wide like the trace."""
    with _slow_lock:
        out = [r for _s, r in _slow_ring()]
        _slow_ring().clear()
        _slow_worst.clear()
        return out


def write_slow_deltas(path: str, records: list) -> str:
    return _write_jsonl_records(path, records)


def _ledger_snapshot(run_dir: str) -> Optional[str]:
    """The decision ledger's run-dir snapshot (``ledger.jsonl``). The
    port has no decision ledger yet, so there is none: None, no file —
    run dirs stay as they are with the ledger off in the reference."""
    return None


# registry state at the last export_run, so each run's artifacts carry
# the metrics THIS run moved (counters as deltas), not the process's
# cumulative totals — a `--test-count 3` / test-all loop analyzes
# several runs in one process
_last_reg_snapshot: Dict[str, dict] = {}


def export_run(run_dir: str) -> Optional[dict]:
    """Write the run-dir telemetry artifacts — ``telemetry.jsonl``,
    ``trace.json`` (Chrome trace-event), ``telemetry.txt`` (summary) —
    and, when ``JEPSEN_TPU_TORCH_TRACE`` named an explicit path, the Chrome
    trace there too. Returns the artifact paths, or None when tracing
    is off (the registry alone does not warrant run-dir files: every
    run would grow three artifacts nobody asked for).

    Per-run semantics: the tracer's span buffer is DRAINED after the
    export and counters are reported as deltas since the previous
    export_run — in a process that analyzes several runs, each run
    dir describes that run alone (and span memory stays bounded)."""
    global _last_reg_snapshot
    tr = _tracer.tracer()
    stats_records = drain_search_stats()
    slow_records = drain_slow_deltas()
    if tr is None or tr.flight_only:
        # a flight-only recorder (JEPSEN_TPU_TORCH_FLIGHT_RECORDER with
        # tracing off) must not grow run-dir artifacts: its output
        # surface is the crash dump alone. EXCEPT search-stats and
        # slow-delta records: JEPSEN_TPU_TORCH_SEARCH_STATS and
        # the slow-delta threshold are their own opt-ins, and the
        # `jepsen report --search` / `--slow` inputs must land whether
        # or not tracing was also on (flags off -> no records -> still
        # None, byte-identical run dirs).
        arts = {}
        if stats_records:
            arts["search_stats"] = write_search_stats(
                os.path.join(run_dir, "search_stats.jsonl"),
                stats_records)
        if slow_records:
            arts["slow_deltas"] = write_slow_deltas(
                os.path.join(run_dir, "slow_deltas.jsonl"),
                slow_records)
        # the decision ledger is its own opt-in too (none yet in
        # the port: _ledger_snapshot is None)
        lg = _ledger_snapshot(run_dir)
        if lg:
            arts["ledger"] = lg
        return arts or None
    os.makedirs(run_dir, exist_ok=True)
    reg = _metrics.registry()
    # ONE snapshot serves both the per-run delta and the next
    # baseline — a counter bumped between two separate reads would
    # vanish from both this run's artifacts and the next's
    now = reg.snapshot()
    run_snap = reg.delta(_last_reg_snapshot, now)
    out = {
        "jsonl": write_jsonl(os.path.join(run_dir, "telemetry.jsonl"),
                             tr, snap=run_snap),
        "trace": write_chrome_trace(os.path.join(run_dir, "trace.json"),
                                    tr),
    }
    with open(os.path.join(run_dir, "telemetry.txt"), "w") as fh:
        fh.write(summary(tr, snap=run_snap))
    out["summary"] = os.path.join(run_dir, "telemetry.txt")
    if stats_records:
        out["search_stats"] = write_search_stats(
            os.path.join(run_dir, "search_stats.jsonl"), stats_records)
    if slow_records:
        out["slow_deltas"] = write_slow_deltas(
            os.path.join(run_dir, "slow_deltas.jsonl"), slow_records)
    lg = _ledger_snapshot(run_dir)
    if lg:
        out["ledger"] = lg
    if tr.path:
        # the buffer is drained per run, so one fixed destination would
        # only ever hold the LAST run's spans in a --test-count /
        # test-all process — run 2 onward gets a numbered sibling
        # (t.json, t.2.json, ...) instead of silently replacing run 1
        tr.flag_exports += 1
        dest = tr.path
        if tr.flag_exports > 1:
            root, ext = os.path.splitext(tr.path)
            dest = f"{root}.{tr.flag_exports}{ext or '.json'}"
        out["flag_trace"] = write_chrome_trace(dest, tr)
    _last_reg_snapshot = now
    tr.drain()
    return out


# --------------------------------------------------- flight recorder

# where crash dumps land when the caller doesn't say (the serve
# service points this at its WAL directory so postmortem evidence
# lives next to the WAL it explains)
_flight_dir = os.path.join("store", "flight")
_flight_lock = threading.Lock()
_flight_seq = 0
# a shed storm or a flapping breaker must not fill the disk with
# near-identical dumps: past the cap, dumps are counted but skipped
FLIGHT_MAX_DUMPS = 25


def set_flight_dir(path: str) -> None:
    """Redirect flight-recorder dumps (default ``store/flight``)."""
    global _flight_dir
    _flight_dir = path


def flight_reset() -> None:
    """Test isolation: restart the dump sequence (and therefore the
    per-process cap) and restore the default destination."""
    global _flight_seq, _flight_dir
    with _flight_lock:
        _flight_seq = 0
        _flight_dir = os.path.join("store", "flight")


def flight_dump(reason: str,
                dest_dir: Optional[str] = None,
                context: Optional[dict] = None) -> Optional[str]:
    """Dump the flight ring as a Chrome-trace file — the postmortem
    artifact for a crashed or degraded service when nobody had tracing
    on. Returns the path written, or None when no recorder is armed
    (the common case: JEPSEN_TPU_TORCH_FLIGHT_RECORDER unset costs exactly
    this None check at the hook sites) or the per-process dump cap is
    reached.

    The file is the Perfetto-openable object form: ``traceEvents``
    (the ring's retained spans) plus a ``flight`` block carrying the
    trigger reason and the registry delta since the recorder was
    armed — spans show WHERE the time went, the delta shows WHAT
    moved (sheds, watchdog kills, breaker opens) before the trigger.
    ``context`` (JSON-serializable) rides the ``flight`` block as
    ``trigger`` — the serve hook sites pass the triggering
    ``delta_id``/``key``/``tenant`` so a ``flight_*.trace.json``
    cross-references the slow-delta or shed record that explains it.
    """
    global _flight_seq
    tr = _tracer.tracer()
    if tr is None or not _tracer.flight_active():
        return None
    with _flight_lock:
        if _flight_seq >= FLIGHT_MAX_DUMPS:
            _metrics.counter("obs.flight_dumps_skipped").inc()
            return None
        _flight_seq += 1
        seq = _flight_seq
    # NOTHING below may raise out of here: every hook site is a
    # failure path (a wedge about to become DispatchWedged, a breaker
    # opening, a shed response, a worker-error handler), and an
    # observability dump that crashes — unwritable dir, disk full on
    # the very sick node being diagnosed — would replace the
    # structured error the resilience machinery depends on
    try:
        reg = _metrics.registry()
        doc = {
            "traceEvents": chrome_trace(tr, spans=tr.ring_spans()),
            "flight": {
                "reason": reason,
                "seq": seq,
                "metrics_delta": reg.delta(tr.flight_baseline or {}),
            },
        }
        if context:
            # JSON-proof the trigger context defensively: a dump must
            # never die on an exotic key object in the context dict
            doc["flight"]["trigger"] = json.loads(
                json.dumps(context, default=str))
        safe = "".join(ch if ch.isalnum() or ch in "-_" else "-"
                       for ch in reason) or "dump"
        d = dest_dir or _flight_dir
        path = os.path.join(d, f"flight_{safe}_{seq}.trace.json")
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(doc, fh)
    except Exception:  # noqa: BLE001 — see above
        _metrics.counter("obs.flight_dump_errors").inc()
        _log.exception("flight-recorder dump failed (reason %r)",
                       reason)
        return None
    _metrics.counter("obs.flight_dumps").inc()
    return path
