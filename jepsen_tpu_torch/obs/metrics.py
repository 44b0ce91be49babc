"""Metrics registry: counters and gauges under stable dotted names.

A trimmed copy of `jepsen_tpu.obs.metrics`: the counters and gauges
the serve fleet states its behaviour in (``fleet.*``, ``serve.repl_*``,
``serve.ring.*``, ``resilience.breaker.*``), under the reference's
names and in its ``snapshot()`` format, so a scraper or a test reads
one process's fleet the same way whichever package runs it. Left out:
histograms (they come with the SLO tracker), spans, the tracer and the
flight recorder.

Always on: an increment is a lock and an integer add. ``snapshot()``
and ``delta()`` give a consistent point-in-time read; tests read a
window with ``delta`` instead of resetting the process-wide registry.
"""

from __future__ import annotations

import threading
from typing import Dict


class Counter:
    """Monotonic count (events, retries, bytes shipped)."""

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
    """A level with a high-water mark; ``nops`` counts level movements
    (how ``Registry.delta`` tells a gauge that moved and came back from
    one that never moved)."""

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

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self.value, "max": self.max,
                "nops": self.nops}


class Registry:
    """Name -> metric, minted on first use. A name is one type for
    life: asking for a gauge under a counter's name raises."""

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

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            ms = list(self._metrics.values())
        return {m.name: m.snapshot() for m in
                sorted(ms, key=lambda m: m.name)}

    def delta(self, before: Dict[str, dict]) -> Dict[str, dict]:
        """What moved since an earlier ``snapshot()``, metric by metric
        (an idle one is omitted): a counter's difference; a gauge's
        current value when its level moved, ``max`` only when this
        window raised the high-water mark, else None."""
        out = {}
        for name, snap in self.snapshot().items():
            prev = before.get(name)
            if snap["type"] == "counter":
                d = snap["value"] - (prev["value"] if prev else 0)
                if d:
                    out[name] = {"type": "counter", "value": d}
            else:
                pn = prev["nops"] if prev else 0
                if snap["nops"] != pn:
                    raised = prev is None or snap["max"] > prev["max"]
                    out[name] = {"type": "gauge", "value": snap["value"],
                                 "max": snap["max"] if raised else None,
                                 "nops": snap["nops"] - pn}
        return out


_default = Registry()


def registry() -> Registry:
    return _default


def counter(name: str) -> Counter:
    return _default.counter(name)


def gauge(name: str) -> Gauge:
    return _default.gauge(name)
