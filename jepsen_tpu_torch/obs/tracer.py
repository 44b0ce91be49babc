"""Span tracing for the checker pipeline — Dapper-style nested spans
(Sigelman et al., 2010) over the host phases of a check.

A copy of `jepsen_tpu.obs.tracer`, with the reference's span names,
args, Chrome-trace and JSONL shapes (``obs.export``), so a Perfetto view
or a trace merge reads either package's output the same way. A span is
a named, attributed wall-clock + CPU-time interval:

    with obs.span("pipeline.dispatch", tier=8, chunk=2):
        ...

Spans nest through a ``contextvars.ContextVar``: the span active when a
child opens becomes its parent. A worker-pool thread does not inherit
contextvars; :func:`ctx_runner` captures the submitting thread's
context so a span opened on the pool thread still hangs off the
submitting span (one ``Context.copy()`` a task).

Gating: ``JEPSEN_TPU_TORCH_TRACE`` (``envflags.env_path``): unset/``0``
off, ``1`` on, ``<path>`` on and the Chrome trace also written there at
export. Off, ``span()`` returns a process-wide no-op singleton: no span
object, no clock read, no lock. ``JEPSEN_TPU_TORCH_FLIGHT_RECORDER``
arms a bounded ring of the last closed spans (the crash dump's input)
with or without full tracing. A span adds no device synchronisation:
its clock reads are the host's, at issue and at the host read the
traced code makes anyway.

The profiler bridge (``JEPSEN_TPU_TORCH_PROFILE``) is the counterpart
of the reference's ``jax.profiler`` bridge: :func:`maybe_torch_profile`
wraps a whole check in one ``torch.profiler`` capture (CPU and CUDA
activities, written by ``tensorboard_trace_handler``) and
:func:`device_annotation` names a kernel launch with
``torch.profiler.record_function``, so the card's kernels line up with
the host's spans by the profiler's correlation ids. The bridge imports
``torch.profiler`` inside its factories: this module loads no torch, so
a probe's parent and the ops server keep working while a card is
wedged.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
from collections import deque
from time import perf_counter, process_time
from time import time as wall_time
from typing import Callable, Dict, List, Optional

from jepsen_tpu_torch import envflags

_current: contextvars.ContextVar = contextvars.ContextVar(
    "jepsen_tpu_torch_obs_span", default=None)

# default flight-recorder ring capacity (closed spans) when
# JEPSEN_TPU_TORCH_FLIGHT_RECORDER=1; N>=2 sets the capacity explicitly
FLIGHT_DEFAULT_SPANS = 256


class Tracer:
    """Collects finished spans for one tracing session.

    Two retention modes, combinable:

    * the ordinary unbounded per-run buffer (``spans()``/``drain()``),
      exported into store run dirs — full tracing;
    * a bounded ring of the last ``ring`` CLOSED spans (the flight
      recorder, ``JEPSEN_TPU_TORCH_FLIGHT_RECORDER``) that survives drains —
      what a crash dump reads. ``flight_only=True`` records into the
      ring ALONE (no unbounded list: a long-lived serve process must
      stay bounded-memory with tracing off), and is invisible to
      ``enabled()``/``export_run`` so run-dir artifacts and bench trace
      pointers keep their tracing-off behavior byte-identical.
    """

    def __init__(self, path: str = "", ring: Optional[int] = None,
                 flight_only: bool = False):
        self.path = path            # JEPSEN_TPU_TORCH_TRACE=<path> ("" = none)
        self.epoch = perf_counter()  # trace time origin (ts 0 in exports)
        # the same origin on the WALL clock: exports stamp it so the
        # fleet trace merge (`jepsen trace`) can align several
        # replicas' traces on one time axis — perf_counter epochs are
        # per-process and incomparable across machines/restarts
        self.epoch_unix = wall_time()
        self.flag_exports = 0       # export_run count, for <path> runs
        self.flight_only = flight_only
        self._lock = threading.Lock()
        self._spans: List["Span"] = []
        # counter-track samples: (name, t, value) triples exported as
        # Chrome "C" events (Perfetto counter tracks) — gauge levels
        # (pipeline.inflight, breaker state, serve queue depth) and the
        # search-stats trajectories line up with the span tracks
        self._counters: List[tuple] = []
        self._ring: Optional[deque] = (deque(maxlen=ring)
                                       if ring else None)
        self.flight_baseline: Optional[dict] = None
        if self._ring is not None:
            # metrics state at arm time, so a crash dump reports what
            # moved SINCE the recorder started, not process totals
            # (import here, not at module scope: metrics has no deps,
            # and tracer must stay importable first)
            from jepsen_tpu_torch.obs import metrics as _metrics
            self.flight_baseline = _metrics.registry().snapshot()
        self._ids = itertools.count(1)

    def next_id(self) -> int:
        return next(self._ids)

    def record(self, span: "Span"):
        with self._lock:
            if self._ring is not None:
                self._ring.append(span)
            if not self.flight_only:
                self._spans.append(span)

    def ring_spans(self) -> List["Span"]:
        """The flight ring's retained spans, oldest first (empty when
        no ring is configured). NOT cleared by :meth:`drain` — the
        recorder must still answer after a per-run export."""
        with self._lock:
            return list(self._ring) if self._ring is not None else []

    def spans(self) -> List["Span"]:
        with self._lock:
            return list(self._spans)

    def record_counter(self, name: str, t: float, value) -> None:
        """Record one counter-track sample. Flight-only recorders skip
        it: the ring retains spans alone, and counter samples must not
        grow unbounded state in a tracing-off process."""
        if self.flight_only:
            return
        with self._lock:
            self._counters.append((name, t, value))

    def counters(self) -> List[tuple]:
        with self._lock:
            return list(self._counters)

    def drain(self) -> List["Span"]:
        """Hand over the finished spans and clear the buffer — how
        export_run keeps artifacts per-run (and memory bounded) in a
        process that analyzes several runs (`--test-count`,
        test-all). Counter samples clear with the spans: they share
        the per-run window."""
        with self._lock:
            out = self._spans
            self._spans = []
            self._counters = []
            return out

    def add_span(self, name: str, t0: float, t1: float,
                 track: Optional[str] = None, parent: Optional[int] = None,
                 **args) -> "Span":
        """Record an interval measured elsewhere (e.g. a device
        program's dispatch->finalize window) as a finished span on an
        explicit `track` — these become the per-device-bucket rows in
        the Chrome trace, since no host thread "runs" them."""
        s = Span(self, name, args)
        s.sid = self.next_id()
        s.parent = parent
        s.t0, s.t1 = t0, t1
        s.cpu = 0.0
        s.track = track if track is not None else "device"
        s.thread = None
        self.record(s)
        return s


class Span:
    """One open (then finished) span. Context-manager protocol; also
    usable pre-populated via Tracer.add_span. ``wall``/``cpu`` are
    valid after ``__exit__`` — :func:`timer` exploits that to make the
    recorded span and the caller's measured number one and the same
    clock read."""

    __slots__ = ("tracer", "name", "args", "sid", "parent", "t0", "t1",
                 "cpu", "_cpu0", "_tok", "thread", "track")

    def __init__(self, tracer: Optional[Tracer], name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.sid = 0
        self.parent = None
        self.t0 = self.t1 = 0.0
        self.cpu = 0.0
        self.thread = None
        self.track = None

    def __enter__(self) -> "Span":
        tr = self.tracer
        if tr is not None:
            self.sid = tr.next_id()
            par = _current.get()
            self.parent = par.sid if par is not None else None
            self._tok = _current.set(self)
        else:
            self._tok = None
        t = threading.current_thread()
        self.thread = (t.ident, t.name)
        self._cpu0 = process_time()
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = perf_counter()
        self.cpu = process_time() - self._cpu0
        if self._tok is not None:
            _current.reset(self._tok)
        if self.tracer is not None:
            self.tracer.record(self)
        return False

    def set(self, **kw):
        """Attach attributes discovered mid-span (e.g. the resolved
        capacity tier)."""
        self.args.update(kw)

    @property
    def wall(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        d = {"type": "span", "name": self.name, "id": self.sid,
             "parent": self.parent,
             "t0": round(self.t0, 6), "wall": round(self.wall, 6),
             "cpu": round(self.cpu, 6)}
        if self.thread is not None:
            d["thread"] = self.thread[1]
            d["tid"] = self.thread[0]
        if self.track is not None:
            d["track"] = self.track
        if self.args:
            d["args"] = dict(self.args)
        return d


class _NoopSpan:
    """The disabled-path singleton: enters/exits without touching a
    clock, a lock, or the heap. `set` swallows attributes (they were
    built by the caller either way)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw):
        pass

    wall = 0.0
    cpu = 0.0


_NOOP = _NoopSpan()

# module tracer state: None = disabled; _UNSET = not yet resolved from
# the env (first span()/enabled() call resolves — import stays cheap
# and monkeypatched env in tests is honored if they reset() first)
_UNSET = object()
_state = _UNSET
_state_lock = threading.Lock()


def _flight_capacity() -> int:
    """JEPSEN_TPU_TORCH_FLIGHT_RECORDER: unset/0 -> 0 (off), 1 -> the
    default ring capacity, N>=2 -> that capacity in spans."""
    v = envflags.env_int("JEPSEN_TPU_TORCH_FLIGHT_RECORDER", default=0,
                         min_value=0, what="flight-recorder capacity")
    if v == 1:
        return FLIGHT_DEFAULT_SPANS
    return v or 0


def _resolve():
    global _state
    with _state_lock:
        if _state is _UNSET:
            path = envflags.env_path("JEPSEN_TPU_TORCH_TRACE",
                                     what="trace output path")
            ring = _flight_capacity()
            if path is not None:
                _state = Tracer(path, ring=ring or None)
            elif ring:
                # flight recorder alone: spans land in the bounded
                # ring only, invisible to enabled()/export_run
                _state = Tracer("", ring=ring, flight_only=True)
            else:
                _state = None
    return _state


def enabled() -> bool:
    """Full tracing on? A flight-only recorder answers False — every
    tracing-gated consumer (run-dir export, bench trace pointers,
    ctx_runner) must keep its tracing-off behavior when only the
    crash ring is armed."""
    st = _state
    if st is _UNSET:
        st = _resolve()
    return st is not None and not st.flight_only


def flight_active() -> bool:
    """Is a flight-recorder ring retaining spans (with or without full
    tracing)? The hook sites (supervisor wedge, breaker open, serve
    shed/worker-error) check this before dumping."""
    st = _state
    if st is _UNSET:
        st = _resolve()
    return st is not None and st._ring is not None


def tracer() -> Optional[Tracer]:
    """The active Tracer, or None when tracing is off."""
    st = _state
    if st is _UNSET:
        st = _resolve()
    return st


def span(name: str, **args):
    """A traced interval — the hot-path entry point. Disabled: returns
    the no-op singleton (nothing allocated beyond the caller's own
    kwargs, nothing timed)."""
    st = _state
    if st is _UNSET:
        st = _resolve()
    if st is None:
        return _NOOP
    return Span(st, name, args)


def timer(name: str, **args) -> Span:
    """An ALWAYS-measuring interval: the context manager's
    ``wall``/``cpu`` are valid whether tracing is on or off, and when
    it is on the recorded span is the SAME clock reads — the mechanism
    by which bench split lines and trace spans can never disagree
    (one measurement site). Not for hot paths: it allocates a Span per
    call even when disabled; use :func:`span` there."""
    st = _state
    if st is _UNSET:
        st = _resolve()
    return Span(st, name, args)


def counter_sample(name: str, value, t: Optional[float] = None) -> None:
    """Record one sample on a Perfetto counter track (a Chrome "C"
    event at export time): a gauge level, a queue depth, a breaker
    state, a frontier width. No-op when full tracing is off — the
    disabled path is one attribute load and a None/flight check, the
    same hot-path standard as span(). ``t`` (a perf_counter() read)
    backdates the sample — the search-stats exporter synthesizes a
    time axis across a device search's span window."""
    st = _state
    if st is _UNSET:
        st = _resolve()
    if st is None or st.flight_only:
        return
    st.record_counter(name, t if t is not None else perf_counter(),
                      value)


def configure(on: bool = True, path: str = "",
              ring: Optional[int] = None,
              flight_only: bool = False) -> Optional[Tracer]:
    """Programmatic gate (tests, embedding): force tracing on/off
    regardless of the env flag. Returns the new tracer (or None).
    ``ring``/``flight_only`` arm the flight recorder the way the
    JEPSEN_TPU_TORCH_FLIGHT_RECORDER flag would."""
    global _state
    with _state_lock:
        _state = (Tracer(path, ring=ring, flight_only=flight_only)
                  if on else None)
    return _state


def reset():
    """Drop the session and re-resolve from the env on next use —
    how tests flip JEPSEN_TPU_TORCH_TRACE mid-process."""
    global _state
    with _state_lock:
        _state = _UNSET


def current_span() -> Optional[Span]:
    return _current.get()


def ctx_runner() -> Callable:
    """Span-context propagation for worker pools. Captures the calling
    thread's context ONCE; returns ``wrap(fn) -> fn'`` where each
    ``fn'`` call runs under a fresh copy of that context, so spans
    opened on the pool thread nest under the span active at capture
    time. Disabled tracing returns the identity wrap (zero overhead).
    One ``Context.copy()`` per call is mandatory, not defensive: a
    Context raises if entered concurrently from two threads."""
    if not enabled():
        return lambda fn: fn
    ctx = contextvars.copy_context()

    def wrap(fn):
        def run(*a, **kw):
            return ctx.copy().run(fn, *a, **kw)
        return run
    return wrap


# ----------------------------------------------- torch.profiler bridge


def torch_profile_dir() -> Optional[str]:
    """The JEPSEN_TPU_TORCH_PROFILE directory, or None when off. "1"
    maps to the default capture dir (``store/torch_profile``)."""
    d = envflags.env_path("JEPSEN_TPU_TORCH_PROFILE", what="profile dir")
    if d == "":
        return "store/torch_profile"
    return d


class _MaybeCtx:
    """Context manager that delegates to a lazily-built inner context
    (or nothing). Exists so the obs module never imports torch at
    import time — the probe's parent and the ops server must stay
    import-safe under a wedged card."""

    __slots__ = ("_factory", "_inner")

    def __init__(self, factory):
        self._factory = factory
        self._inner = None

    def __enter__(self):
        if self._factory is not None:
            self._inner = self._factory()
            self._inner.__enter__()
        return self

    def __exit__(self, *exc):
        if self._inner is not None:
            return bool(self._inner.__exit__(*exc))
        return False


def _profiler_activities(profiler) -> list:
    acts = [profiler.ProfilerActivity.CPU]
    import torch
    if torch.cuda.is_available():
        acts.append(profiler.ProfilerActivity.CUDA)
    return acts


def maybe_torch_profile() -> _MaybeCtx:
    """``torch.profiler.profile`` (CPU and CUDA activities, the capture
    written to the profile dir by ``tensorboard_trace_handler``) when
    JEPSEN_TPU_TORCH_PROFILE is set, else a no-op — wraps a whole check
    so the card's capture and the host spans share a session. One
    capture directory a run, as the reference's ``jax.profiler.trace``.
    The sites never nest, and inside a capture that is already open (a
    caller's around several checks) a site adds none: ``torch.profiler``
    refuses a second active profiler, and the open one records the
    check."""
    d = torch_profile_dir()
    if d is None:
        return _MaybeCtx(None)

    def make():
        from torch import autograd, profiler
        if autograd._profiler_enabled():
            return contextlib.nullcontext()
        return profiler.profile(
            activities=_profiler_activities(profiler),
            on_trace_ready=profiler.tensorboard_trace_handler(d))
    return _MaybeCtx(make)


def device_annotation(name: str) -> _MaybeCtx:
    """``torch.profiler.record_function(name)`` when profiling is on,
    else a no-op — names the launches inside it in the capture, so a
    kernel correlates to its annotation and the host span around it."""
    if torch_profile_dir() is None:
        return _MaybeCtx(None)

    def make():
        from torch import profiler
        return profiler.record_function(name)
    return _MaybeCtx(make)
