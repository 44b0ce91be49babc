"""Metrics registry: counters, gauges and histograms under stable
dotted names.

A copy of `jepsen_tpu.obs.metrics`, under the reference's names and in
its ``snapshot()`` and ``delta()`` formats, so a scraper, a test or the
end-of-run summary reads one process's metrics the same way whichever
package runs it. The engines count under ``engine.*``, ``bitdense.*``,
``pipeline.*``, ``stream.*``, ``elastic.*`` and ``independent.*``; the
serve fleet under ``fleet.*``, ``serve.repl_*``, ``serve.ring.*`` and
``resilience.breaker.*``; the search-stats sink under
``engine.search.*``. Histograms share one fixed bucket ladder
(:data:`BUCKET_LADDER`), so ``/metrics`` renders them as Prometheus
histograms and :func:`hist_quantile` answers from any snapshot or delta.

Always on: an increment is a lock and an integer add. ``snapshot()``
and ``delta()`` give a consistent point-in-time read; tests read a
window with ``delta`` instead of resetting the process-wide registry.

Import-safe: the standard library only.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional

# The fixed histogram bucket ladder: log-spaced upper bounds (seconds
# for the latency histograms, but unitless here), 100µs .. 60s, with
# +Inf implied by ``count``. Fixed and shared so (a) Prometheus
# exposition (obs/httpd.py) can render a proper ``histogram`` type with
# cumulative ``le`` buckets, and (b) "p99 delta latency" SLO questions
# are answerable from any snapshot without per-metric configuration.
# Values outside the ladder still land in count/total/min/max — the
# ladder only loses resolution, never observations.
BUCKET_LADDER = (0.0001, 0.00025, 0.001, 0.0025, 0.01, 0.025,
                 0.1, 0.25, 1.0, 2.5, 10.0, 60.0)


class Counter:
    """Monotonic count (events, retries, cache hits)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1):
        with self._lock:
            self.value += n

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """A level (in-flight depth, bytes resident) with a high-water
    mark — the max is what the summary table reports for depths.
    ``nops`` counts level movements: it is how ``Registry.delta``
    tells "this gauge moved during the window and returned to the
    same level" apart from "nothing happened" (a value/max-only
    snapshot cannot)."""

    __slots__ = ("name", "value", "max", "nops", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self.max = 0
        self.nops = 0
        self._lock = threading.Lock()

    def set(self, v):
        with self._lock:
            self.value = v
            self.nops += 1
            if v > self.max:
                self.max = v

    def inc(self, n=1):
        with self._lock:
            self.value += n
            self.nops += 1
            if self.value > self.max:
                self.max = self.value

    def dec(self, n=1):
        with self._lock:
            self.value -= n
            self.nops += 1

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value, "max": self.max,
                "nops": self.nops}


class Histogram:
    """Streaming aggregate of observations (seconds, sizes):
    count/total/min/max plus a fixed log-spaced bucket ladder
    (:data:`BUCKET_LADDER`). The scalar fields keep their historical
    meaning (the summary table and bench split lines read them
    unchanged); ``buckets`` is additive — cumulative ``[le, count]``
    pairs in the snapshot, the shape Prometheus exposition and
    quantile estimation need."""

    __slots__ = ("name", "count", "total", "vmin", "vmax", "_buckets",
                 "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self._buckets = [0] * len(BUCKET_LADDER)
        self._lock = threading.Lock()

    def observe(self, v: float):
        with self._lock:
            self.count += 1
            self.total += v
            if self.vmin is None or v < self.vmin:
                self.vmin = v
            if self.vmax is None or v > self.vmax:
                self.vmax = v
            i = bisect_left(BUCKET_LADDER, v)
            if i < len(BUCKET_LADDER):
                self._buckets[i] += 1

    def snapshot(self) -> dict:
        with self._lock:
            raw = list(self._buckets)
            count, total = self.count, self.total
            vmin, vmax = self.vmin, self.vmax
        cum: List[list] = []
        running = 0
        for le, n in zip(BUCKET_LADDER, raw):
            running += n
            cum.append([le, running])
        return {"type": "histogram", "count": count,
                "total": round(total, 6),
                "min": vmin, "max": vmax,
                "mean": round(total / count, 6) if count else None,
                "buckets": cum}


def labeled(name: str, **labels) -> str:
    """A registry name carrying label pairs: ``base[k=v,...]``. The
    registry itself treats the whole string as one opaque name (every
    label set is its own metric object); the Prometheus renderer
    (``obs.httpd``) splits the suffix back into real exposition labels
    — ``serve.ack_secs[tenant=alice]`` renders as
    ``jepsen_serve_ack_secs_bucket{tenant="alice",le=...}``. Keep
    label VALUES inside ``[A-Za-z0-9_.:-]`` (tenant names, backend
    ids); the renderer escapes anything else but dashboards read
    cleaner without the escapes."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}[{inner}]"


def split_labels(name: str):
    """``base[k=v,...]`` -> (base, {k: v}); a plain name -> (name, {})."""
    if not name.endswith("]"):
        return name, {}
    i = name.find("[")
    if i < 0:
        return name, {}
    out = {}
    for pair in name[i + 1:-1].split(","):
        k, eq, v = pair.partition("=")
        if eq:
            out[k] = v
    return name[:i], out


def hist_quantile(snap: dict, q: float) -> Optional[float]:
    """Approximate quantile from a histogram snapshot (or delta): the
    upper bound of the first cumulative bucket covering ``q`` of the
    observations — the Prometheus-style answer, without interpolation.
    Observations past the ladder answer with the streaming ``max``
    (exact only when the window owns it, i.e. ``max`` is not None)."""
    n = snap.get("count") or 0
    if not n:
        return None
    target = q * n
    for le, cumc in snap.get("buckets") or ():
        if cumc >= target:
            return le
    return snap.get("max")


class Registry:
    """Name -> metric, minted on first use. Type collisions raise: a
    name cannot be a counter in one layer and a gauge in another —
    that is exactly the drift this registry exists to end."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            ms = list(self._metrics.values())
        return {m.name: m.snapshot() for m in
                sorted(ms, key=lambda m: m.name)}

    def delta(self, before: Dict[str, dict],
              now: Optional[Dict[str, dict]] = None) -> Dict[str, dict]:
        """Type-aware diff against an earlier snapshot() — how the
        per-run export (and the bench) reports what THIS window moved
        without resetting global state mid-run. A metric with no
        activity in the window is omitted.

        counters: the value difference. histograms: count/total
        differences with the mean recomputed; min/max only when every
        observation is the window's own (no prior count) — a window
        slice of a streaming min/max is otherwise unknowable. gauges:
        included when the level moved (``nops`` advanced), reporting
        the current value; ``max`` carries the high-water only when
        this window raised it, else None — the window's own peak is
        not recoverable from level snapshots.

        Pass ``now`` (a snapshot captured by the caller) to diff two
        fixed points and reuse ``now`` as the next baseline — leaving
        no gap for concurrent increments to fall into."""
        if now is None:
            now = self.snapshot()
        out = {}
        for name, snap in now.items():
            prev = before.get(name)
            if snap["type"] == "counter":
                d = snap["value"] - (prev["value"] if prev else 0)
                if d:
                    out[name] = {"type": "counter", "value": d}
            elif snap["type"] == "gauge":
                pn = prev["nops"] if prev else 0
                if snap["nops"] != pn:
                    raised = prev is None or snap["max"] > prev["max"]
                    out[name] = {"type": "gauge", "value": snap["value"],
                                 "max": snap["max"] if raised else None,
                                 "nops": snap["nops"] - pn}
            else:
                pc = prev["count"] if prev else 0
                dc = snap["count"] - pc
                if dc:
                    dt = round(snap["total"]
                               - (prev["total"] if prev else 0.0), 6)
                    # buckets subtract pairwise: the difference of two
                    # cumulative ladders is the window's own cumulative
                    # ladder (same fixed bounds), so a per-run delta
                    # answers quantile questions exactly like a fresh
                    # registry would
                    pb = {le: c for le, c in
                          (prev.get("buckets") or ())} if prev else {}
                    db = [[le, c - pb.get(le, 0)]
                          for le, c in snap.get("buckets") or ()]
                    out[name] = {"type": "histogram", "count": dc,
                                 "total": dt,
                                 "min": snap["min"] if pc == 0 else None,
                                 "max": snap["max"] if pc == 0 else None,
                                 "mean": round(dt / dc, 6),
                                 "buckets": db}
        return out

    def reset(self):
        with self._lock:
            self._metrics.clear()


_default = Registry()


def registry() -> Registry:
    return _default


def counter(name: str) -> Counter:
    return _default.counter(name)


def gauge(name: str) -> Gauge:
    return _default.gauge(name)


def histogram(name: str) -> Histogram:
    return _default.histogram(name)
