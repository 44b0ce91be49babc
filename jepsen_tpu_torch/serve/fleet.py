"""Self-healing for the serve fleet: failure detection, automatic
re-homing, ownership fencing and WAL segment replication.

A port of `jepsen_tpu.serve.fleet`. Three pieces:

:class:`FleetSupervisor`
    Polls every replica's ``/healthz`` (``obs.httpd.fetch_replica``)
    and runs a circuit breaker PER REPLICA: ``threshold`` consecutive
    misses open it — the replica is declared dead and its keys are
    re-homed onto the survivors by :func:`serve.ring.
    rehome_dead_replica`, with bounded retry and backoff and a
    ``fleet-rehome-<name>`` flight-recorder dump a rehome. A dead
    replica that answers again is admitted back through the breaker's
    half-open probe, for NEW keys only: the keys it lost stay PINNED to
    their adopters, and the epoch fence refuses it those regardless.

:class:`SegmentReplicator`
    Ships a key's WAL segments to its ring successor's ``repl/`` mirror
    on every durable append. ``JEPSEN_TPU_TORCH_SERVE_REPL`` picks the
    mode: ``sync`` acks only after the successor copy is fsynced (a
    dead node WITH a dead disk then loses nothing acknowledged);
    ``async`` ships from a background thread (``serve.repl_lag_keys``
    is the lag gauge, and the loss window is exactly that lag). A
    mid-copy kill can leave a torn last line on the mirror, which the
    WAL replay tolerates (one torn tail a segment).

The epoch fence (in ``serve.wal`` and ``serve.service``; driven from
here): every segment header carries an ownership epoch, ``adopt_keys``
bumps it, and the rehome writes a fence marker in the dead replica's
dir BEFORE copying segments, so a paused replica that resumes refuses
its producers instead of acking deltas the new owner never replays.

Every counter and gauge the reference bumps (``fleet.*``,
``serve.repl_*``, and through ring and breaker ``serve.ring.*`` and
``resilience.breaker.*``) is bumped here under the same name, and every
ship runs under the ``serve.repl_ship`` span. Left out: the
compiled-program manifests of a warm handoff (the port has no program
cache).

Import-safe: no torch — the supervisor is a coordinator that must run
(and rehome) while a replica's device is wedged.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Callable, Dict, Optional

from jepsen_tpu_torch import envflags, obs
from jepsen_tpu_torch.resilience import breaker as breaker_mod
from jepsen_tpu_torch.serve import ring as ring_mod
from jepsen_tpu_torch.serve.wal import DeltaWAL

_log = logging.getLogger(__name__)

REPL_MODES = ("off", "async", "sync")

#: cap on the supervisor's per-attempt rehome backoff
REHOME_BACKOFF_CAP_SECS = 30.0
#: how long a survivor's ``POST /adopt`` may take (its replay is host
#: work: re-encodes and checkpoint loads; the scans follow on its worker)
ADOPT_TIMEOUT_SECS = 60.0


def resolve_repl_mode(v: Optional[str] = None) -> str:
    """The WAL segment replication mode: ``off`` (default) | ``async`` |
    ``sync`` (``JEPSEN_TPU_TORCH_SERVE_REPL``; strictly validated)."""
    if v is not None:
        if v not in REPL_MODES:
            raise envflags.EnvFlagError(
                f"replication mode {v!r}: expected one of {REPL_MODES}")
        return v
    return envflags.env_choice("JEPSEN_TPU_TORCH_SERVE_REPL", REPL_MODES,
                               default="off", what="WAL replication mode")


# ------------------------------------------------ segment replication


def constant_dst(path: str) -> Callable:
    """A fixed replication destination (``python -m
    jepsen_tpu_torch.serve --repl-dir PATH``: the successor's ``repl/``
    dir)."""
    return lambda _key: path


def ring_successor_dst(ring: ring_mod.HashRing, wal_dirs: Dict[str, str],
                       self_node: str) -> Callable:
    """Per-key destination: the key's ring successor's ``repl/``
    mirror — where :func:`serve.ring.rehome_dead_replica` looks when the
    dead node's own disk is gone."""
    def dst(key) -> Optional[str]:
        succ = ring.successor(key)
        if succ is None or succ == self_node:
            return None
        d = wal_dirs.get(succ)
        return (os.path.join(d, ring_mod.REPL_SUBDIR)
                if d is not None else None)
    return dst


class SegmentReplicator:
    """Ships one service's WAL segments to per-key destinations (module
    docstring). ``after_append(key)`` is the service's hook: ``sync``
    ships inline and returns False when the successor copy did not land
    (the ack then carries ``replicated: False``); ``async`` enqueues for
    the shipper thread and returns None; ``off`` does nothing.

    Copies are size-compared and INCREMENTAL (append-only files: the
    destination's size is the resume offset): a first ship lands the
    whole file through a tmp file and ``os.replace`` (a reader never
    sees a partial first copy), every later one appends only the suffix
    — one delta's bytes an ack. ``sync`` fsyncs the data and, for a new
    file, the mirror directory before the ack."""

    def __init__(self, wal: DeltaWAL, dst_for_key: Callable,
                 mode: Optional[str] = None):
        self.wal = wal
        self.dst_for_key = dst_for_key
        self.mode = resolve_repl_mode(v=mode)
        self._cond = threading.Condition()
        self._pending: Dict[object, bool] = {}   # insertion-ordered
        self._inflight = 0
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        # per-key ship serialization: two producers acking different
        # seqs of one key must not interleave suffix appends into the
        # same mirror file
        self._ship_locks: Dict[object, threading.Lock] = {}

    def _fsync_path(self, path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def ship(self, key) -> int:
        """Copy the key's out-of-date segment bytes to its destination
        now; returns the number of files touched. Raises OSError on an
        unreachable destination (callers count and degrade)."""
        dst = self.dst_for_key(key)
        if dst is None:
            return 0
        with self._cond:
            lock = self._ship_locks.setdefault(key, threading.Lock())
        with lock:
            return self._ship_files(key, dst)

    def _ship_files(self, key, dst: str) -> int:
        # the replication leg of a delta's chain: sync mode runs it in
        # the producer's ack window (under serve.wal's parent), async
        # mode on the shipper thread
        with obs.span("serve.repl_ship", key=str(key)):
            return self._copy_segments(key, dst)

    def _copy_segments(self, key, dst: str) -> int:
        os.makedirs(dst, exist_ok=True)
        shipped = 0
        for src in self.wal.segments(key):
            dpath = os.path.join(dst, os.path.basename(src))
            try:
                ssize = os.path.getsize(src)
            except OSError:
                continue   # rotated away mid-scan
            try:
                dsize = os.path.getsize(dpath)
            except OSError:
                dsize = -1
            if dsize == ssize:
                continue   # already current
            if 0 <= dsize < ssize:
                # incremental: append the suffix past the shipped offset
                with open(src, "rb") as sf, open(dpath, "ab") as df:
                    sf.seek(dsize)
                    shutil.copyfileobj(sf, df)
                    df.flush()
                    if self.mode == "sync":
                        os.fsync(df.fileno())
                new_bytes = ssize - dsize
            else:
                # first copy (or a shrunk source: repair) lands whole
                tmp = dpath + ".tmp"
                shutil.copyfile(src, tmp)
                if self.mode == "sync":
                    self._fsync_path(tmp)
                os.replace(tmp, dpath)
                if self.mode == "sync":
                    # the directory entry must survive the successor's
                    # power cut too
                    self._fsync_path(dst)
                new_bytes = ssize
            shipped += 1
            obs.counter("serve.repl_segments_shipped").inc()
            obs.counter("serve.repl_bytes").inc(new_bytes)
        return shipped

    def after_append(self, key) -> Optional[bool]:
        if self.mode == "off":
            return None
        if self.mode == "sync":
            if self.dst_for_key(key) is None:
                # no successor (a one-node ring, every peer dead): the
                # ack must not imply successor durability
                obs.counter("serve.repl_no_destination").inc()
                return False
            try:
                self.ship(key)
                return True
            except OSError as err:
                obs.counter("serve.repl_errors").inc()
                _log.warning("sync replication of key %r failed (%r) — "
                             "ack is primary-durable only", key, err)
                return False
        self.notify(key)
        return None

    # -- the async shipper

    def notify(self, key) -> None:
        with self._cond:
            self._pending[key] = True
            obs.gauge("serve.repl_lag_keys").set(len(self._pending)
                                                 + self._inflight)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True,
                    name="jepsen-torch-repl-shipper")
                self._thread.start()
            self._cond.notify_all()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait(timeout=0.5)
                if self._stop and not self._pending:
                    return
                key = next(iter(self._pending))
                del self._pending[key]
                self._inflight = 1
                obs.gauge("serve.repl_lag_keys").set(
                    len(self._pending) + self._inflight)
            try:
                self.ship(key)
            except Exception as err:  # noqa: BLE001 — the shipper must
                # survive a sick destination; the lag gauge and the
                # error counter are the operator's signal
                obs.counter("serve.repl_errors").inc()
                _log.warning("async replication of key %r failed (%r)",
                             key, err)
            finally:
                with self._cond:
                    self._inflight = 0
                    obs.gauge("serve.repl_lag_keys").set(
                        len(self._pending))
                    self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until the async queue is empty (True) or the timeout
        passes (False)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending or self._inflight:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(timeout=0.5 if rem is None
                                else min(rem, 0.5))
            return True

    def close(self, drain: bool = True) -> None:
        if drain:
            self.drain(timeout=30)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


# --------------------------------------------------- remote adoption


class HttpReplica:
    """A survivor in another process, as the rehome path sees it: its
    one method ``adopt_keys`` is the replica's ``POST /adopt``
    (``obs.httpd``), so a coordinator drives live adoption without
    importing the engine or touching the survivor's device."""

    def __init__(self, addr: str):
        self.addr = addr

    def adopt_keys(self) -> list:
        import urllib.request
        req = urllib.request.Request(f"http://{self.addr}/adopt", data=b"",
                                     method="POST")
        with urllib.request.urlopen(req,
                                    timeout=ADOPT_TIMEOUT_SECS) as resp:
            return json.loads(resp.read().decode()).get("adopted", [])


def _default_fetch(addr: str, timeout: float) -> bool:
    """Liveness through the ops endpoint (``obs.httpd.fetch_replica``).
    ANY HTTP answer counts as alive (a degraded replica still acks into
    its WAL, so rehoming it would fork the stream); only "unreachable"
    is a miss."""
    from jepsen_tpu_torch.obs import httpd as ops_httpd
    return ops_httpd.fetch_replica(
        addr, timeout=timeout)["state"] != "unreachable"


class _Replica:
    __slots__ = ("name", "addr", "breaker", "dead", "rehomed")

    def __init__(self, name, addr, breaker):
        self.name = name
        self.addr = addr
        self.breaker = breaker
        self.dead = False
        self.rehomed = False


class FleetSupervisor:
    """Automatic failure detection and re-homing for a serve fleet
    (module docstring).

    ``replicas`` maps name -> ops-endpoint address (``host:port``), or
    to None with an injected ``fetch``. ``services`` maps name -> an
    object with ``adopt_keys()`` (a local :class:`CheckerService` or an
    :class:`HttpReplica`). ``wal_dirs`` maps name -> that replica's WAL
    dir (the transfer's source and destination).

    Drive it with ``start()`` (a daemon loop every ``interval`` seconds)
    or with ``tick()`` calls; all timing goes through the injected
    ``clock`` and ``sleep``."""

    def __init__(self, replicas: Dict[str, Optional[str]],
                 wal_dirs: Dict[str, str],
                 services: Optional[Dict[str, object]] = None,
                 interval: float = 2.0,
                 threshold: int = 3,
                 rehome_retries: int = 3,
                 fetch: Optional[Callable] = None,
                 fetch_timeout: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep):
        if set(replicas) != set(wal_dirs):
            raise ValueError("replicas and wal_dirs must name the same "
                             "fleet")
        self.interval = float(interval)
        self.threshold = int(threshold)
        self.rehome_retries = int(rehome_retries)
        self.wal_dirs = dict(wal_dirs)
        self.services = dict(services or {})
        self.ring = ring_mod.HashRing(sorted(replicas))
        self.pins: Dict[object, str] = {}
        self._fetch = fetch if fetch is not None else _default_fetch
        self._fetch_timeout = fetch_timeout
        self._clock = clock
        self._sleep = sleep
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._reps: Dict[str, _Replica] = {}
        for name in sorted(replicas):
            # one breaker a replica: the consecutive-miss threshold opens
            # it (dead), its half-open probe is the rejoin. Outside the
            # registry's trip set: a PEER replica's health must not show
            # on this process's own /healthz breaker check
            br = breaker_mod.CircuitBreaker(
                f"fleet:{name}", threshold=self.threshold,
                backoff_base=max(self.interval, 0.05), clock=clock,
                probe=self._make_probe(name, replicas[name]),
                track_global=False)
            self._reps[name] = _Replica(name, replicas[name], br)
            obs.gauge(f"fleet.replica.{name}.alive").set(1)
        self._gauges()

    # -- health checks

    def _make_probe(self, name: str, addr: Optional[str]):
        def probe() -> bool:
            return self._alive(name, addr)
        return probe

    def _alive(self, name: str, addr: Optional[str]) -> bool:
        try:
            return bool(self._fetch(addr if addr is not None else name,
                                    self._fetch_timeout))
        except Exception:  # noqa: BLE001 — unreachable IS the signal
            return False

    # -- the heartbeat round

    def tick(self) -> None:
        """One supervision round: heartbeat the live replicas, drive the
        breakers, rehome the newly dead, re-admit the recovered."""
        for r in list(self._reps.values()):
            if r.dead:
                if not r.rehomed:
                    # an earlier attempt exhausted its budget: one
                    # bounded burst a tick until it lands
                    self._try_rehome(r)
                ok, _why = r.breaker.allow()
                if ok:
                    self._rejoin(r)
                continue
            obs.counter("fleet.heartbeats").inc()
            if self._alive(r.name, r.addr):
                r.breaker.record_success()
            else:
                obs.counter("fleet.misses").inc()
                r.breaker.record_failure("healthz miss")
                if r.breaker.state == breaker_mod.OPEN:
                    self._declare_dead(r)
        self._gauges()

    def _declare_dead(self, r: _Replica) -> None:
        r.dead = True
        obs.counter("fleet.deaths").inc()
        obs.gauge(f"fleet.replica.{r.name}.alive").set(0)
        _log.warning("fleet: replica %r declared dead after %d "
                     "consecutive healthz misses — rehoming its keys",
                     r.name, self.threshold)
        self._try_rehome(r)

    def _survivors(self) -> Dict[str, str]:
        return {n: d for n, d in self.wal_dirs.items()
                if not self._reps[n].dead}

    def _try_rehome(self, r: _Replica) -> Optional[Dict[str, list]]:
        """Bounded-retry rehome with exponential backoff; on success pins
        the moved keys, counts ``fleet.rehomes`` and dumps the flight
        recorder (the postmortem moment an armed ring exists for)."""
        survivors = self._survivors()
        if not survivors:
            _log.error("fleet: no survivors to rehome %r onto", r.name)
            obs.counter("fleet.rehome_failures").inc()
            return None
        for attempt in range(self.rehome_retries):
            if attempt:
                self._sleep(min(self.interval * (2 ** (attempt - 1)),
                                REHOME_BACKOFF_CAP_SECS))
            try:
                plan = ring_mod.rehome_dead_replica(
                    self.wal_dirs[r.name], self.ring, r.name, survivors,
                    {n: s for n, s in self.services.items()
                     if n in survivors})
            except Exception as err:  # noqa: BLE001 — a failed attempt
                # is retried; a failed budget stays pending for the next
                # tick
                obs.counter("fleet.rehome_failures").inc()
                _log.warning("fleet: rehome of %r failed (attempt %d/%d): "
                             "%r", r.name, attempt + 1, self.rehome_retries,
                             err)
                continue
            with self._lock:
                for node, keys in plan.items():
                    for k in keys:
                        self.pins[k] = node
            r.rehomed = True
            obs.counter("fleet.rehomes").inc()
            obs.flight_dump(f"fleet-rehome-{r.name}", context={
                "replica": r.name,
                "plan": {n: [str(k) for k in ks]
                         for n, ks in plan.items()}})
            _log.info("fleet: rehomed %d key(s) from %r: %s",
                      sum(len(v) for v in plan.values()), r.name,
                      {n: len(v) for n, v in plan.items()})
            return plan
        return None

    def _rejoin(self, r: _Replica) -> None:
        """A dead replica's half-open probe answered: admit it back for
        NEW keys; its old keys stay pinned to their adopters."""
        r.dead = False
        r.rehomed = False
        self.ring.add(r.name)
        obs.counter("fleet.rejoins").inc()
        obs.gauge(f"fleet.replica.{r.name}.alive").set(1)
        _log.info("fleet: replica %r rejoined (new keys only)", r.name)

    def _gauges(self) -> None:
        obs.gauge("fleet.replicas_alive").set(
            sum(1 for r in self._reps.values() if not r.dead))

    # -- routing and introspection

    def owner(self, key) -> str:
        """Where producers send the key now: its pinned adopter after a
        rehome, else the ring owner."""
        with self._lock:
            pinned = self.pins.get(key)
        if pinned is not None:
            return pinned
        return self.ring.owner(key)

    def status(self) -> dict:
        return {"replicas": {r.name: {"dead": r.dead,
                                      "rehomed": r.rehomed,
                                      "addr": r.addr,
                                      "breaker": r.breaker.snapshot()}
                             for r in self._reps.values()},
                "pins": {str(k): v for k, v in self.pins.items()}}

    # -- the loop

    def start(self) -> "FleetSupervisor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="jepsen-torch-fleet-supervisor")
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the supervisor outlives
                # one bad round; the next tick re-reads the truth
                _log.exception("fleet: supervision tick failed")
            self._stop.wait(self.interval)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
