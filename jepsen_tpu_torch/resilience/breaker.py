"""Circuit breakers: one per backend in the process registry, and the
fleet supervisor's one per peer replica.

A port of `jepsen_tpu.resilience.breaker`:

    closed     calls flow; consecutive failures are counted
    open       after `threshold` consecutive failures: refused until
               an exponential backoff (base doubling per re-open,
               deterministic jitter, capped) elapses
    half-open  one caller per window runs the recovery ``probe``; a
               healthy answer closes the breaker, anything else
               re-opens it with a doubled backoff

The jitter is seeded from the crc32 of the breaker's name, so under
the same clock a breaker's ``open_until`` sequence equals the
reference's. State changes set the ``resilience.breaker.<name>.state``
gauge (0 closed / 1 half-open / 2 open) and its trace counter track;
every open counts ``resilience.breaker.opens`` and, with the flight
recorder armed, dumps it as ``breaker-open-<name>`` (outside the
breaker's lock: the dump is file I/O).

The registry (``breaker_for``, ``snapshots``, ``any_tripped``,
``reset``) is what ``CheckerService.health()``'s ``breakers`` check
reads. A breaker made with ``track_global=False`` — the fleet
supervisor's, watching a PEER replica — stays out of the trip set.

Defaults as the reference's: the recovery probe is the port's
subprocess device probe (``probe.probe_json``: the card, healthy or
not, in a child that takes any hang), ``threshold`` and
``backoff_base`` come from ``JEPSEN_TPU_TORCH_BREAKER_THRESHOLD`` (3)
and ``JEPSEN_TPU_TORCH_BREAKER_BACKOFF`` (1.0 s).

Left out: the injectable jitter source and backoff cap, and the
dispatch supervisor that would consult the registry before a launch (a
device fault surfaces to the caller in the port).
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

from jepsen_tpu_torch import envflags
from jepsen_tpu_torch import obs

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_GAUGE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

BACKOFF_CAP_SECS = 60.0
JITTER_FRAC = 0.1
PROBE_TIMEOUT_SECS = 30.0


def _default_probe() -> bool:
    """The half-open recovery check: the same subprocess contract as
    ``python -m jepsen_tpu_torch.probe`` (probe_json), so external
    automation and the breaker read one health surface."""
    from jepsen_tpu_torch import probe
    r = probe.probe_json(timeout=PROBE_TIMEOUT_SECS, retries=1)
    return r["verdict"] == "healthy"


def _resolve_threshold() -> int:
    return envflags.env_int("JEPSEN_TPU_TORCH_BREAKER_THRESHOLD",
                            default=3, min_value=1,
                            what="breaker threshold")


def _resolve_backoff() -> float:
    return envflags.env_float("JEPSEN_TPU_TORCH_BREAKER_BACKOFF",
                              default=1.0, min_value=0.0,
                              what="breaker backoff")


class CircuitBreaker:
    """One health signal's breaker. Thread-safe; all timing through
    the injected clock, so the open/half-open/close lifecycle is
    testable without sleeping."""

    def __init__(self, backend: str, *,
                 probe: Optional[Callable[[], bool]] = None,
                 threshold: Optional[int] = None,
                 backoff_base: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 track_global: bool = True):
        self.backend = backend
        # track_global=False keeps this breaker out of the registry's
        # trip set: a FLEET breaker watching a PEER replica must not
        # read as this process's own health
        self._track_global = track_global
        self.threshold = (threshold if threshold is not None
                          else _resolve_threshold())
        self.backoff_base = (backoff_base if backoff_base is not None
                             else _resolve_backoff())
        self.clock = clock
        self.probe = probe if probe is not None else _default_probe
        # seeded per name (crc32: str hashing is randomized per process),
        # so a reproduced run reproduces its backoff schedule
        self.rng = random.Random(
            zlib.crc32(("jepsen-breaker:" + backend).encode()))
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opens = 0
        self._open_until = 0.0
        self._last_reason = ""
        self._gauge()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {"backend": self.backend, "state": self._state,
                    "failures": self._failures, "opens": self._opens,
                    "open_until": self._open_until,
                    "reason": self._last_reason}

    def _gauge(self):
        obs.gauge(f"resilience.breaker.{self.backend}.state").set(
            _STATE_GAUGE[self._state])
        # the trace's counter track: flips line up with the spans that
        # caused them (a no-op with tracing off)
        obs.counter_sample(f"resilience.breaker.{self.backend}.state",
                           _STATE_GAUGE[self._state])

    def _backoff(self) -> float:
        """Exponential in the re-open count, jittered, capped."""
        base = self.backoff_base * (2 ** max(0, self._opens - 1))
        jitter = 1.0 + JITTER_FRAC * self.rng.random()
        return min(base * jitter, BACKOFF_CAP_SECS)

    def _open_locked(self):
        """The one open transition (callers hold the lock and dump the
        flight recorder after releasing it)."""
        self._state = OPEN
        self._opens += 1
        self._open_until = self.clock() + self._backoff()
        obs.counter("resilience.breaker.opens").inc()
        self._gauge()

    def _note(self, tripped: bool) -> None:
        if self._track_global:
            _note_state(self.backend, tripped)

    def record_failure(self, reason: str = ""):
        opened = False
        with self._lock:
            self._failures += 1
            self._last_reason = reason
            if self._state == HALF_OPEN \
                    or (self._state != OPEN
                        and self._failures >= self.threshold):
                # the threshold is reached, or the probed call itself
                # failed during half-open: (re-)open now
                self._open_locked()
                opened = True
            else:
                self._gauge()
            tripped = self._state != CLOSED
        self._note(tripped)
        if opened:
            obs.flight_dump(f"breaker-open-{self.backend}")

    def record_success(self):
        with self._lock:
            self._failures = 0
            self._opens = 0   # the incident is over: the next one starts
            self._state = CLOSED   # at the base backoff
            self._last_reason = ""
            self._gauge()
        self._note(False)

    def allow(self) -> Tuple[bool, str]:
        """Whether a call may proceed now. Closed: yes. Open: no until
        the backoff elapses; then ONE caller runs the probe (half-open):
        healthy closes the breaker and admits the call, anything else
        re-opens it with a doubled backoff."""
        with self._lock:
            if self._state == CLOSED:
                return True, ""
            if self._state == HALF_OPEN:
                return False, (
                    f"circuit breaker half-open for backend "
                    f"{self.backend!r}: recovery probe in flight")
            if self.clock() < self._open_until:
                return False, (
                    f"circuit breaker open for backend "
                    f"{self.backend!r} (last failure: "
                    f"{self._last_reason or '?'}; retry in "
                    f"{max(0.0, self._open_until - self.clock()):.1f}s)")
            self._state = HALF_OPEN
            self._gauge()
            probe = self.probe
        self._note(True)
        try:
            healthy = bool(probe())
        except Exception:  # noqa: BLE001 — a crashed probe is not health
            healthy = False
        with self._lock:
            if healthy:
                self._state = CLOSED
                self._failures = 0
                self._opens = 0
                self._gauge()
            else:
                self._open_locked()
        self._note(not healthy)
        if healthy:
            return True, ""
        obs.flight_dump(f"breaker-open-{self.backend}")
        return False, (f"circuit breaker re-opened for backend "
                       f"{self.backend!r}: recovery probe unhealthy")


# ------------------------------------------------------------ registry

_registry_lock = threading.Lock()
_breakers: Dict[str, CircuitBreaker] = {}
# backends currently NOT closed: the fast-path check is one truthiness
# read of this set
_tripped: set = set()


def _note_state(backend: str, tripped: bool):
    with _registry_lock:
        if tripped:
            _tripped.add(backend)
        else:
            _tripped.discard(backend)


def breaker_for(backend: str, **kw) -> CircuitBreaker:
    """The process breaker for `backend` (made on first use)."""
    backend = backend or "default"
    with _registry_lock:
        br = _breakers.get(backend)
        if br is None:
            br = _breakers[backend] = CircuitBreaker(backend, **kw)
        return br


def any_tripped() -> bool:
    """Is any tracked backend's breaker not closed?"""
    return bool(_tripped)


def snapshots() -> list:
    """Every registered breaker's :meth:`CircuitBreaker.snapshot` — what
    /healthz's ``breakers`` check reads (empty: healthy)."""
    with _registry_lock:
        brs = list(_breakers.values())
    return [b.snapshot() for b in brs]


def reset():
    """Drop every breaker (test isolation)."""
    with _registry_lock:
        _breakers.clear()
        _tripped.clear()
