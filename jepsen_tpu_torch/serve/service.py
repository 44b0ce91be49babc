"""The streaming checker service: crash-safe incremental checking of
per-key history deltas, with backpressure, shedding, and eviction.

A port of `jepsen_tpu.serve.service` over the port's streaming
sessions. ``jepsen.core/run!`` interleaves test execution with analysis
(PAPER.md L6/L7); this is that loop as a long-lived service. Producers
submit per-key deltas; the service extends each key's frontier
incrementally (``parallel.extend.HistorySession``), batches
shape-compatible keys into one batched scan a leg
(``parallel.extend.advance_sessions``: batched K2, and batched K4 past
K2's gate, on the card), and serves verdicts equal to a one-shot check
of the same prefix.

* **No admitted delta is ever silently dropped.** ``submit`` appends
  to the per-key WAL (``serve.wal.DeltaWAL``) BEFORE acknowledging;
  the final verdict's ``seq`` accounts for every accepted delta.
* **Bounded memory.** Per-key queues are bounded in deltas, the
  global backlog in ops; a slow producer BLOCKS (backpressure), and
  past the high-water mark new deltas are shed with a structured
  ``{"shed": True, "reason": ...}`` instead of buffering.
* **Crash safety.** A kill-and-restart replays the WAL through the
  deterministic encode + scan: identical verdicts, duplicate deltas
  detected by sequence number (idempotent replay).
* **Eviction.** Idle keys freeze their frontier to the checkpoint
  store and drop their in-memory state; the next delta thaws them
  (digest-guarded: a mismatch rescans, never trusts a stale frontier).
* **Device faults surface.** The port has no degradation of a device
  fault to the host (ROADMAP, "Decisions that differ"): a device error
  in a batch's scan gives each key of the batch the loud
  ``{"valid?": "unknown", "error": "serve worker crashed on this key:
  ..."}`` and drops its session. With a WAL the next delta thaw-replays
  the key to the right verdict; without one the key is poisoned.
* **Tenant isolation** (``serve.tenancy``; off when no tenants are
  configured). Every submit resolves to a tenant (token or name); keys
  are owned by the tenant that admitted them; per-tenant pending-ops /
  key-count / WAL-bytes quotas shed a flooding tenant *immediately*
  with ``{"shed": ..., "tenant": ...}`` while other tenants keep
  admitting; the worker drains tenants by deficit round-robin so device
  time follows weights, not arrival order; and the ``serve.ack_secs`` /
  ``serve.verdict_secs`` SLO histograms grow per-tenant labeled twins,
  whose p50 and p99 ``status()`` reports a tenant.

* **WAL segment replication** (``replicator=``, a
  ``serve.fleet.SegmentReplicator``; mode ``JEPSEN_TPU_TORCH_SERVE_REPL``).
  After a key's WAL fsync and before the ack, the replicator ships the
  key's segments to its successor's mirror; a ``sync`` ship that did not
  land makes the ack (and a ``wait=True`` answer) carry
  ``"replicated": False``. ``close`` drains it.

* **Telemetry, always on.** Every ``serve.*`` counter, gauge and
  histogram of the reference under its name (sheds, refusals, deltas,
  ``ack_secs``, ``verdict_secs``, worker errors, evictions, ...), with
  per-tenant ``labeled`` twins; ``refresh_gauges`` (the ops endpoint
  calls it before each render); ``health()``'s ``breakers`` check over
  the breaker registry; and the flight-recorder dumps ``serve-shed``
  and ``serve-worker-error`` (a None check when the recorder is off).
* **Delta tracing, armed only** (``JEPSEN_TPU_TORCH_TRACE``,
  ``JEPSEN_TPU_TORCH_FLIGHT_RECORDER`` or
  ``JEPSEN_TPU_TORCH_SLOW_DELTA_SECS``): each admitted delta gets a
  ``delta_id`` (the producer's, or minted), returned on the ack, stamped
  into its WAL record and carried through recovery, replay and
  ``adopt_keys``; the spans ``serve.admit``, ``serve.wal``,
  ``serve.thaw``, ``serve.apply``, ``serve.advance``, ``serve.publish``
  and ``serve.evict`` tag it; with the slow-delta threshold, a delta
  past it lands a stage-breakdown record on ``status()`` and the worst
  so far a ``slow-delta`` flight dump. ``JEPSEN_TPU_TORCH_SLO_ACK_SECS``
  arms the burn-rate tracker (``obs.slo``) and ``health()``'s ``slo``
  check. Unarmed, acks, WAL bytes, ``status()`` and ``health()`` are
  the reference's unarmed service's.

Left out of the port: the decision ledger's publish record (the
reference's ``led.record("publish", ...)``; it comes with the ledger
and the planner), and the compiled-program manifests (the port compiles
no programs at run time: its kernels are built once per source hash and
loaded through ctypes, and a service on the card builds and loads them
all when it starts, so its first delta pays no nvcc and no load — the
counterpart of the reference's ``_prewarm_programs``).

Threading: producers call ``submit``/``result`` from any thread; one
worker thread owns every session and the device (the kernels launch
on the worker's current stream). ``asyncio`` fronts wrap the blocking
calls with ``run_in_executor`` (``serve.ingress``); those threads never
touch a tensor.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, Optional

from jepsen_tpu_torch import edn, envflags, obs
from jepsen_tpu_torch.history import TYPES
from jepsen_tpu_torch.obs import slo as _slo
from jepsen_tpu_torch.parallel import bitdense
from jepsen_tpu_torch.parallel import extend as ext
from jepsen_tpu_torch.serve import tenancy
from jepsen_tpu_torch.serve.wal import CheckpointStore, DeltaWAL

_log = logging.getLogger(__name__)

DEFAULT_PER_KEY_QUEUE = 64       # pending deltas per key
DEFAULT_GLOBAL_BOUND = 65536     # pending ops across all keys
DEFAULT_EVICT_SECS = 300.0


def _resolve_per_key_queue(v: Optional[int]) -> int:
    if v is not None:
        return int(v)
    return envflags.env_int("JEPSEN_TPU_TORCH_SERVE_QUEUE",
                            default=DEFAULT_PER_KEY_QUEUE, min_value=1,
                            what="per-key queue bound")


def _resolve_global_bound(v: Optional[int]) -> int:
    if v is not None:
        return int(v)
    return envflags.env_int("JEPSEN_TPU_TORCH_SERVE_GLOBAL",
                            default=DEFAULT_GLOBAL_BOUND, min_value=1,
                            what="global pending-ops bound")


def _resolve_high_water(v: Optional[int], global_bound: int) -> int:
    if v is None:
        v = envflags.env_int("JEPSEN_TPU_TORCH_SERVE_HIGH_WATER",
                             default=-1, min_value=0,
                             what="shed high-water")
        if v == -1:
            v = (global_bound * 3) // 4   # shed before the hard block
    return int(v)


def _resolve_evict_secs(v: Optional[float]) -> float:
    if v is not None:
        return float(v)
    return envflags.env_float("JEPSEN_TPU_TORCH_SERVE_EVICT_SECS",
                              default=DEFAULT_EVICT_SECS, min_value=0.0,
                              what="eviction idle seconds")


def _resolve_slow_delta(v: Optional[float]) -> float:
    if v is not None:
        return float(v)
    return envflags.env_float("JEPSEN_TPU_TORCH_SLOW_DELTA_SECS",
                              default=0.0, min_value=0.0,
                              what="slow-delta threshold seconds") \
        or 0.0


def _mint_delta_id() -> str:
    """A fleet-unique trace identity for one admitted delta: minted at
    admission (whichever transport carried it), persisted in the WAL
    record, and tagged on every span leg of the delta's chain."""
    return uuid.uuid4().hex[:16]


def default_wal_dir() -> Optional[str]:
    """The JEPSEN_TPU_TORCH_SERVE_WAL flag: unset/0 -> no WAL (in-memory
    service), 1 -> ``store/serve_wal``, path -> that directory."""
    v = envflags.env_path("JEPSEN_TPU_TORCH_SERVE_WAL",
                          what="WAL directory")
    if v == "":
        return os.path.join("store", "serve_wal")
    return v


class _Key:
    """Per-key service state; every field is guarded by the service
    condition except ``session``, which only the worker touches."""

    __slots__ = ("key", "session", "pending", "enq_seq", "applied_seq",
                 "last_result", "last_activity", "finalized",
                 "finalize_requested", "needs_check", "pending_ops",
                 "wal_next", "broken", "wal_dead", "acct",
                 "pending_times", "tenant", "epoch", "fenced",
                 "delta_recs", "device")

    def __init__(self, key, tenant: str = tenancy.DEFAULT_TENANT):
        self.key = key
        self.tenant = tenant   # the admitting tenant owns the key for
        # life: cross-tenant submits are refused (isolation), and the
        # name is the WAL-header stamp recovery re-homes by
        self.session = None
        self.pending: deque = deque()     # (seq, [Op, ...])
        self.enq_seq = 0
        self.applied_seq = 0
        self.last_result: Optional[dict] = None
        self.last_activity = 0.0
        self.finalized = False
        self.finalize_requested = False
        self.needs_check = False
        self.pending_ops = 0
        # per-key accounting for /status: admitted deltas/ops, sheds
        # this key ate, WAL deltas replayed at recovery/thaw
        self.acct = {"deltas": 0, "ops": 0, "sheds": 0, "replays": 0}
        # (seq, t_submit) of admitted-but-unapplied deltas — drained
        # whenever applied_seq advances, feeding the ingest->verdict SLO
        # histogram; bounded by the per-key queue bound
        self.pending_times: deque = deque()
        # per-delta trace records (delta tracing armed only, empty
        # otherwise): {"id", "seq", "tenant", "ops", "t_in", ...stage
        # stamps...}, seq-ordered because admission is; popped by the
        # worker at take time, closed out at verdict publish (the
        # slow-delta breakdown). Bounded by the per-key queue bound.
        self.delta_recs: deque = deque()
        self.wal_next = 1   # next seq allowed to write the WAL (the
        # per-key seq-ordered handoff that keeps file order == seq
        # order without holding the service lock across an fsync)
        self.broken = False     # worker crash lost state and no WAL
        # can rebuild it: the key refuses further deltas instead of
        # silently restarting from a truncated history
        self.wal_dead = False   # a WAL append for this key stalled or
        # failed: later seqs must not write (no holes below an
        # acknowledged delta) — producers get durable=False answers
        self.epoch = 1      # ownership epoch, stamped into every WAL
        # segment header this service opens; bumped by adopt_keys so
        # the fence below can tell a stale owner from the current one
        self.fenced = None  # the key's fence marker once observed:
        # ownership moved to another replica — submit/result/finalize
        # answer a structured refusal instead of letting this replica
        # become a second writer
        self.device = None  # device pin (steal_key): when set, this
        # key's session places its scans here instead of the
        # service-wide device


class _TenantState:
    """Per-tenant admission accounting (multi-tenant mode only);
    every field is guarded by the service condition. ``bound`` is the
    tenant's effective pending-ops quota (0 = unlimited), ``deficit``
    its deficit-round-robin credit in ops — refilled ``weight x
    quantum`` per worker cycle with backlog, spent as the batch takes
    deltas (debt allowed so an oversized delta still drains), reset
    when the tenant's queues empty (no banking while idle)."""

    __slots__ = ("name", "weight", "bound", "max_keys",
                 "max_wal_bytes", "pending_ops", "keys", "wal_bytes",
                 "deficit", "acct")

    def __init__(self, tenant: tenancy.Tenant, bound: int):
        self.name = tenant.name
        self.weight = tenant.weight
        self.bound = bound
        self.max_keys = tenant.max_keys
        self.max_wal_bytes = tenant.max_wal_bytes
        self.pending_ops = 0
        self.keys = 0
        self.wal_bytes = 0
        self.deficit = 0
        self.acct = {"deltas": 0, "ops": 0, "sheds": 0}


class CheckerService:
    """The streaming checker (module docstring). Construct, submit
    deltas, read results; ``close(drain=True)`` is the graceful
    shutdown. Usable as a context manager.

    ``device`` None means the card (RuntimeError without one; tests
    pass ``"cpu"``). ``tenants`` opts into multi-tenant mode: a
    ``tenancy.TenantTable``, a list of ``tenancy.Tenant``, or None to
    read ``JEPSEN_TPU_TORCH_TENANTS`` (unset = single-tenant)."""

    def __init__(self, model, wal_dir: Optional[str] = None, *,
                 capacity: int = 1024, max_capacity: int = 1 << 20,
                 dedupe: Optional[str] = None, probe_limit: int = 0,
                 device=None, bucket: Optional[str] = None,
                 per_key_queue: Optional[int] = None,
                 global_bound: Optional[int] = None,
                 high_water: Optional[int] = None,
                 evict_idle_secs: Optional[float] = None,
                 tenants=None, drr_quantum: Optional[int] = None,
                 replicator=None,
                 slow_delta_secs: Optional[float] = None,
                 recover: bool = True, start_worker: bool = True,
                 clock=time.monotonic):
        self.model = model
        self.capacity = capacity
        self.max_capacity = max_capacity
        self.dedupe = dedupe
        self.probe_limit = probe_limit
        self.device = bitdense.resolve_device(device)
        self.bucket = bucket
        self.per_key_queue = _resolve_per_key_queue(per_key_queue)
        self.global_bound = _resolve_global_bound(global_bound)
        self.high_water = _resolve_high_water(high_water,
                                              self.global_bound)
        self.evict_idle_secs = _resolve_evict_secs(evict_idle_secs)
        self.slow_delta_secs = _resolve_slow_delta(slow_delta_secs)
        # delta trace identity armed? Tracing on, a flight ring
        # retaining spans, or the slow-delta threshold: each consumes
        # per-delta ids and stage records. Unarmed (the default) keeps
        # acks, WAL bytes and the /status schema those of the service
        # without tracing.
        self._delta_obs = bool(self.slow_delta_secs) \
            or obs.enabled() or obs.flight_active()
        # this service's identity in the process-wide slow-delta ring:
        # two services in one process must not read each other's
        # records or suppress each other's worst-offender dumps (a
        # sentinel, not self: ring entries must not pin the sessions)
        self._slow_scope = object()
        if tenants is None:
            tenants = tenancy.resolve_tenants()
        elif isinstance(tenants, (list, tuple)):
            tenants = tenancy.TenantTable(list(tenants))
        self._tenants: Optional[tenancy.TenantTable] = tenants
        self._tstate: Dict[str, _TenantState] = {}
        self._drr_idx = 0
        self._drr_quantum = (int(drr_quantum) if drr_quantum
                             else tenancy.resolve_quantum()
                             if tenants is not None else 0)
        if tenants is not None:
            budget = self.high_water or self.global_bound
            for name in tenants.names():
                self._tstate[name] = _TenantState(
                    tenants.get(name),
                    tenants.pending_bound(name, budget))
        self._clock = clock
        self._wal = DeltaWAL(wal_dir) if wal_dir else None
        # WAL segment replication: a configured mode with no target to
        # ship to protects nothing — refuse it at construction
        from jepsen_tpu_torch.serve.fleet import resolve_repl_mode
        mode = resolve_repl_mode()
        if replicator is not None and getattr(replicator, "mode",
                                              None) == "off":
            replicator = None
        if mode != "off" and replicator is None:
            raise ValueError(
                f"JEPSEN_TPU_TORCH_SERVE_REPL={mode!r} but no replication "
                f"target is wired — pass replicator= (a serve.fleet."
                f"SegmentReplicator) or `python -m jepsen_tpu_torch.serve "
                f"--repl-dir PATH`, or unset the flag")
        if replicator is not None and self._wal is None:
            raise ValueError("WAL segment replication needs a "
                             "WAL-backed service (wal_dir)")
        self._repl = replicator
        self._cps = (CheckpointStore(wal_dir + "/checkpoints")
                     if wal_dir else None)
        if wal_dir and obs.flight_active():
            # postmortem dumps land next to the WAL they explain
            obs.set_flight_dir(os.path.join(wal_dir, "flight"))
        self._keys: Dict = {}
        # ack-latency SLO burn tracking (obs.slo): unarmed (the default,
        # JEPSEN_TPU_TORCH_SLO_ACK_SECS unset) it mints nothing
        self._slo = _slo.BurnRateTracker(clock=clock)
        self._cond = threading.Condition()
        self._pending_ops = 0
        self._inflight = 0
        self._stop = False
        self.max_pending_seen = 0   # high-water mark, for bound tests
        if self.device.type == "cuda":
            self._prewarm_kernels()
        if recover and self._wal is not None:
            self._recover()
        self._worker = None
        if start_worker:
            self.start_worker()

    @staticmethod
    def _prewarm_kernels() -> None:
        """Build every kernel library not yet built (one nvcc each, all
        started together) and load each, before the first delta."""
        from jepsen_tpu_torch import kernels
        kernels.build_all()
        for name in kernels.SOURCES:
            kernels.load(name)

    def start_worker(self) -> None:
        """Spawn the worker thread (the constructor's default).
        ``start_worker=False`` + a later call makes producer-side
        behavior — admission, backpressure, shedding — exactly
        observable in tests: nothing drains until the worker runs."""
        if self._worker is not None:
            return
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="jepsen-torch-serve-worker")
        self._worker.start()

    # ------------------------------------------------- producer API

    def _resolve_tenant(self, tenant: Optional[str],
                        token: Optional[str]):
        """(tenant name, None) or (None, error dict). Single-tenant
        mode maps everything onto the implicit default tenant; with a
        table configured a token wins over a name (the transports
        authenticate by token; a bare name is the trusted in-process
        path), and an unidentified producer is refused — tenancy on
        means auth on."""
        if self._tenants is None:
            return tenancy.DEFAULT_TENANT, None
        if token is not None:
            t = self._tenants.by_token(token)
            if t is None:
                return None, {"error": "unauthorized: unknown tenant "
                                       "token"}
            return t.name, None
        if tenant is not None:
            if self._tenants.get(tenant) is None \
                    and tenant not in self._tstate:
                return None, {"error": f"unknown tenant {tenant!r}"}
            return tenant, None
        return None, {"error": "tenant required: the service is "
                               "multi-tenant — authenticate with a "
                               "tenant token (or name, in-process)"}

    def _tenant_state_locked(self, name: str) -> \
            Optional[_TenantState]:
        """The tenant's admission state (multi-tenant mode), minted
        ad hoc for a recovered key whose tenant left today's table —
        acknowledged data is never orphaned by a config change."""
        if self._tenants is None:
            return None
        ts = self._tstate.get(name)
        if ts is None:
            budget = self.high_water or self.global_bound
            bound = max(1, budget
                        // max(1, self._tenants.total_weight + 1))
            ts = self._tstate[name] = _TenantState(
                tenancy.Tenant(name=name), bound)
        return ts

    @staticmethod
    def _shed_locked(ks: Optional["_Key"], ts: Optional[_TenantState],
                     reason: str, key) -> dict:
        """Build one structured shed answer + its accounting (callers
        hold the service condition and dump outside it)."""
        obs.counter("serve.sheds").inc()
        if ks is not None:
            ks.acct["sheds"] += 1
        out = {"shed": True, "reason": reason, "key": key}
        if ts is not None:
            ts.acct["sheds"] += 1
            obs.counter(obs.labeled("serve.sheds", tenant=ts.name)).inc()
            out["tenant"] = ts.name
        return out

    # ------------------------------------------ epoch fence (ownership
    # moved to another replica: docs/streaming.md "Fleet self-healing")

    def _read_fence(self, key):
        """The key's on-disk fence marker (one stat; None when
        unfenced or WAL-less). Callers run this OUTSIDE the service
        condition — it is file I/O."""
        return self._wal.fence(key) if self._wal is not None else None

    @staticmethod
    def _fence_locked(ks, fence):
        """Fold a freshly-read fence marker into the key's state and
        return the active fence (callers hold the condition). A fence
        at OR ABOVE this replica's epoch wins: adoption persists its
        bump immediately, but a fence computed against a header the
        bump has not reached yet can legitimately TIE the stale owner's
        in-memory epoch — and a tie still means someone else took the
        key."""
        if ks is not None and ks.fenced is not None:
            return ks.fenced
        if fence is not None \
                and (ks is None or fence.get("epoch", 0) >= ks.epoch):
            if ks is not None:
                ks.fenced = fence
            return fence
        return None

    @staticmethod
    def _fence_refusal(key, fence) -> dict:
        """The structured split-brain refusal: this replica's
        ownership epoch is over — the producer must re-route to the
        owner the fence names."""
        obs.counter("serve.fenced_refusals").inc()
        return {"error": "key ownership fenced: this replica's epoch "
                         "is over (it was rehomed while this replica "
                         "was presumed dead) — re-route to the "
                         "current owner",
                "fenced": True, "epoch": fence.get("epoch"),
                "owner": fence.get("owner"), "key": key}

    def fence_key_ownership(self, key, owner: Optional[str] = None) \
            -> dict:
        """Fence THIS service's ownership of ``key`` now (the
        graceful-migration finisher, after the destination adopts):
        writes the durable fence marker at epoch+1 and marks the
        in-memory key, so producers still pointed here get the
        structured refusal instead of a second writer."""
        if self._wal is None:
            raise RuntimeError("fencing needs a WAL-backed service")
        with self._cond:
            ks = self._keys.get(key)
            epoch = (ks.epoch if ks is not None
                     else self._wal.epoch(key)) + 1
        doc = self._wal.write_fence(key, epoch, owner=owner)
        with self._cond:
            if ks is not None:
                ks.fenced = doc
            self._cond.notify_all()
        return doc

    def submit(self, key, ops, seq: Optional[int] = None,
               timeout: Optional[float] = None,
               wait: bool = False, tenant: Optional[str] = None,
               token: Optional[str] = None,
               delta_id: Optional[str] = None) -> dict:
        """Admit one delta for ``key``. Returns one of::

            {"accepted": True, "seq": n, "key": k}
            {"duplicate": True, "seq": n, "key": k}   idempotent replay
            {"shed": True, "reason": ..., "key": k}   overload
            {"error": ..., "key": k}                  malformed request

        With delta tracing armed (``JEPSEN_TPU_TORCH_TRACE`` /
        ``_FLIGHT_RECORDER`` / ``_SLOW_DELTA_SECS``) every admitted
        delta gets a trace identity — ``delta_id`` (the caller's, or
        minted here), returned on the ack, stamped into the WAL record
        and tagged on each span leg of the delta's chain. Unarmed,
        ``delta_id`` is ignored and every answer and byte is the
        service's without tracing.

        Blocks (backpressure) while the key's queue or the global
        backlog is full, up to ``timeout`` seconds (then sheds). With
        ``wait=True``, additionally blocks until this delta's verdict
        is computed and returns it.

        Multi-tenant mode (``tenants`` configured): ``token`` (or the
        in-process ``tenant`` name) identifies the producer; shed and
        accepted answers carry ``"tenant"``; a tenant past its
        pending-ops / key-count / WAL-bytes quota is shed IMMEDIATELY
        (no blocking — a flooding tenant must not camp on the queue
        other tenants feed), while the global-bound backpressure
        below still blocks fairly."""
        ops = list(ops)
        for o in ops:
            t = o.get("type") if hasattr(o, "get") else None
            if t not in TYPES:
                return {"error": f"delta op {o!r}: type must be one of "
                                 f"{TYPES}", "key": key}
        tname, auth_err = self._resolve_tenant(tenant, token)
        if auth_err is not None:
            obs.counter("serve.unauthorized").inc()
            return {**auth_err, "key": key}
        # epoch fence, first look (one stat, outside the lock): a
        # replica whose key was rehomed away while it was paused must
        # refuse — and must not even MINT the key fresh at epoch 1
        fence = self._read_fence(key)
        t_in = self._clock()
        deadline = None if timeout is None else t_in + timeout
        # the delta's trace identity (armed only): filled in and queued
        # on the key at admission, closed out by the worker at verdict
        # publish (the slow-delta stage breakdown)
        rec = ({"id": str(delta_id) if delta_id else _mint_delta_id()}
               if self._delta_obs else None)
        shed = None   # set instead of returning inside the lock: the
        # flight dump a shed triggers is file I/O and runs AFTER the
        # service lock is released (as the WAL fsync below does)
        with self._cond, \
                obs.span("serve.admit", key=str(key)) as adm_sp:
            ts = self._tenant_state_locked(tname)
            ks = self._keys.get(key)
            f = self._fence_locked(ks, fence)
            if f is not None:
                return self._fence_refusal(key, f)
            if ks is None:
                if ts is not None and ts.max_keys \
                        and ts.keys >= ts.max_keys:
                    # refused BEFORE minting the key: a quota'd tenant
                    # must not grow the key table it is over-budget on
                    shed = self._shed_locked(
                        None, ts,
                        f"tenant {tname!r} key quota ({ts.keys} >= "
                        f"{ts.max_keys})", key)
                else:
                    ks = self._keys[key] = _Key(key, tenant=tname)
                    if ts is not None:
                        ts.keys += 1
                    obs.counter("serve.keys_admitted").inc()
            if shed is None and ks.tenant != tname:
                # tenant isolation: a key belongs to the tenant that
                # admitted it — no cross-tenant appends, no
                # cross-tenant seq probing
                return {"error": f"key is owned by another tenant "
                                 f"(not {tname!r})", "key": key,
                        "tenant": tname}
            # validate-then-wait-then-REVALIDATE: every check runs
            # again after a cond.wait released the lock — a concurrent
            # producer may have taken the seq or finalized the key
            # while this one slept
            while shed is None:
                if ks.fenced is not None:
                    return self._fence_refusal(key, ks.fenced)
                if ks.broken:
                    return {"error": "key state was lost to a worker "
                                     "crash and no WAL is configured "
                                     "to rebuild it — restart the "
                                     "stream under a new key",
                            "key": key}
                if ks.finalized or ks.finalize_requested:
                    return {"error": "key is finalized", "key": key}
                my_seq = int(seq) if seq is not None else ks.enq_seq + 1
                if my_seq <= ks.enq_seq:
                    obs.counter("serve.duplicate_deltas").inc()
                    return {"duplicate": True, "seq": my_seq,
                            "key": key}
                if my_seq != ks.enq_seq + 1:
                    return {"error": f"sequence gap: expected "
                                     f"{ks.enq_seq + 1}, got {my_seq}",
                            "key": key}
                if ts is not None and ts.max_wal_bytes \
                        and ts.wal_bytes > ts.max_wal_bytes:
                    # before shedding, re-sync the meter from disk: the
                    # operator relief is archiving/deleting rotated
                    # segments, so stat() the tenant's files and let
                    # that lift the quota without a restart
                    if self._wal is not None:
                        ts.wal_bytes = sum(
                            self._wal.size_bytes(k.key)
                            for k in self._keys.values()
                            if k.tenant == tname)
                    if ts.wal_bytes > ts.max_wal_bytes:
                        shed = self._shed_locked(
                            ks, ts,
                            f"tenant {tname!r} WAL-bytes quota "
                            f"({ts.wal_bytes} > {ts.max_wal_bytes})",
                            key)
                        break
                if ts is not None and ts.bound \
                        and ts.pending_ops + len(ops) > ts.bound:
                    # the weighted-fair line: this tenant is past its
                    # share, so it sheds NOW — the global queue keeps
                    # room for every other tenant's deltas
                    shed = self._shed_locked(
                        ks, ts,
                        f"tenant {tname!r} pending-ops quota "
                        f"({ts.pending_ops}+{len(ops)} > {ts.bound})",
                        key)
                    break
                if self.high_water \
                        and self._pending_ops + len(ops) \
                        > self.high_water:
                    shed = self._shed_locked(
                        ks, ts,
                        f"pending ops past high-water "
                        f"({self._pending_ops}+{len(ops)} > "
                        f"{self.high_water})", key)
                    break
                if len(ks.pending) < self.per_key_queue \
                        and self._pending_ops + len(ops) \
                        <= self.global_bound:
                    break   # admitted
                if self._stop:
                    shed = self._shed_locked(ks, ts,
                                             "service stopping", key)
                    break
                rem = (None if deadline is None
                       else deadline - self._clock())
                if rem is not None and rem <= 0:
                    shed = self._shed_locked(
                        ks, ts, "backpressure timeout (queue full)",
                        key)
                    break
                self._cond.wait(0.5 if rem is None else min(rem, 0.5))
            if shed is None:
                # reserve the seq + queue slot under the lock (pending
                # stays seq-ordered because reservations are), then
                # write the WAL OUTSIDE it — an fsync must not
                # serialize every other key's producers and the worker
                # on one lock
                ks.pending.append((my_seq, ops))
                ks.enq_seq = my_seq
                ks.pending_ops += len(ops)
                ks.acct["deltas"] += 1
                ks.acct["ops"] += len(ops)
                ks.pending_times.append((my_seq, t_in))
                if rec is not None:
                    rec.update(seq=my_seq, tenant=tname,
                               ops=len(ops), t_in=t_in,
                               t_admit=self._clock())
                    ks.delta_recs.append(rec)
                    adm_sp.set(delta_id=rec["id"], seq=my_seq,
                               tenant=tname)
                self._pending_ops += len(ops)
                self.max_pending_seen = max(self.max_pending_seen,
                                            self._pending_ops)
                obs.counter("serve.deltas").inc()
                obs.counter("serve.delta_ops").inc(len(ops))
                obs.gauge("serve.pending_ops").set(self._pending_ops)
                if ts is not None:
                    ts.pending_ops += len(ops)
                    ts.acct["deltas"] += 1
                    ts.acct["ops"] += len(ops)
                    obs.counter(obs.labeled(
                        "serve.deltas", tenant=tname)).inc()
                    obs.gauge(obs.labeled(
                        "serve.pending_ops",
                        tenant=tname)).set(ts.pending_ops)
                # the trace's counter track: queue depth over time
                # lines up with the spans (a no-op untraced)
                obs.counter_sample("serve.pending_ops",
                                   self._pending_ops)
                self._cond.notify_all()
        if shed is not None:
            # overload is the postmortem moment: an armed flight
            # recorder dumps here, outside the service lock (file I/O;
            # the per-process cap bounds a shed storm)
            obs.flight_dump("serve-shed", context={
                "key": str(key), "reason": shed.get("reason"),
                "tenant": shed.get("tenant")})
            return shed
        durable = self._wal is not None
        durable_replica = None   # False: a sync ship of this ack's
        # bytes did not land (None: no replicator, or nothing appended)
        if self._wal is not None:
            # per-key seq-ordered handoff: seq N's bytes land before
            # N+1's, so a crash can truncate the WAL only at the tail,
            # never leave a hole below an acknowledged delta. The wait
            # honors the caller deadline and shutdown — one stalled
            # fsync must not block later producers forever; it instead
            # marks the key's WAL dead so no later seq writes (no
            # holes), and answers carry durable=False.
            give_up = False
            with self._cond:
                while ks.wal_next != my_seq and not ks.wal_dead \
                        and ks.fenced is None:
                    if self._stop:
                        give_up = True
                        break
                    rem = (None if deadline is None
                           else deadline - self._clock())
                    if rem is not None and rem <= 0:
                        give_up = True
                        break
                    self._cond.wait(0.5 if rem is None
                                    else min(rem, 0.5))
                if ks.fenced is not None:
                    # fenced while parked in the handoff: nothing may
                    # write below a fence — refuse instead of ack
                    return self._fence_refusal(key, ks.fenced)
                if give_up or ks.wal_dead:
                    ks.wal_dead = True
                    durable = False
                    self._cond.notify_all()
                elif rec is not None:
                    # the WAL stage's start stamp: a DURATION, not a
                    # timeline split — the fsync below runs outside the
                    # lock, concurrently with the queue and device
                    # stages (the worker may take, even publish, this
                    # delta while its fsync is in flight)
                    rec["t_wal_start"] = self._clock()
            if durable:
                try:
                    with obs.span("serve.wal", key=str(key),
                                  seq=my_seq,
                                  delta_id=(rec or {}).get("id")):
                        nbytes = self._wal.append(
                            key, my_seq, ops,
                            tenant=(tname if ts is not None else None),
                            delta_id=(rec or {}).get("id"))
                except Exception as err:  # noqa: BLE001 — a failed
                    # append must not hold the handoff or hide the
                    # durability loss from the producer
                    durable = False
                    obs.counter("serve.wal_errors").inc()
                    _log.warning("WAL append failed for key %r seq "
                                 "%d (%r) — delta applies in-process "
                                 "only", key, my_seq, err)
                    with self._cond:
                        ks.wal_dead = True
                        if rec is not None:
                            rec["t_wal_end"] = self._clock()
                        self._cond.notify_all()
                else:
                    with self._cond:
                        ks.wal_next = my_seq + 1
                        if rec is not None:
                            # the end stamp, under the condition
                            # (_finish_recs_locked reads it there)
                            rec["t_wal_end"] = self._clock()
                        if ts is not None:
                            # the WAL-bytes quota meter: the tenant
                            # pays for every byte its keys fsync
                            ts.wal_bytes += nbytes
                        self._cond.notify_all()
                    # fence recheck AFTER the fsync, before the ack: a
                    # rehome writes its fence BEFORE copying segments,
                    # so either this delta's bytes made the transfer or
                    # this stat sees the fence and the producer never
                    # gets the ack
                    fence2 = self._read_fence(key)
                    if fence2 is not None \
                            and fence2.get("epoch", 0) >= ks.epoch:
                        with self._cond:
                            if ks.fenced is None:
                                ks.fenced = fence2
                            self._cond.notify_all()
                        return self._fence_refusal(key, ks.fenced)
                    if self._repl is not None:
                        # ship the key's segments to its successor; sync
                        # mode answers False when the copy did not land
                        durable_replica = \
                            self._repl.after_append(key) is not False
        # ingest->ack SLO: admission (backpressure wait included)
        # through WAL durability — the producer-visible accept latency
        ack = max(0.0, self._clock() - t_in)
        obs.histogram("serve.ack_secs").observe(ack)
        if ts is not None:
            # the per-tenant twin (/metrics renders it as a real
            # {tenant="..."} label on the same histogram name)
            obs.histogram(obs.labeled("serve.ack_secs",
                                      tenant=tname)).observe(ack)
        if wait:
            rem = None if deadline is None else deadline - self._clock()
            r = self.result(key, min_seq=my_seq, timeout=rem,
                            tenant=tname)
            if rec is not None and isinstance(r, dict):
                r.setdefault("delta_id", rec["id"])
            if not durable and self._wal is not None:
                r["durable"] = False
            if durable_replica is False:
                r["replicated"] = False
            return r
        out = {"accepted": True, "seq": my_seq, "key": key}
        if rec is not None:
            # the producer learns its delta's trace identity: the
            # handle that cross-references spans, slow-delta records
            # and flight dumps fleet-wide
            out["delta_id"] = rec["id"]
        if ts is not None:
            out["tenant"] = tname
        if not durable and self._wal is not None:
            obs.counter("serve.nondurable_acks").inc()
            out["durable"] = False
        if durable_replica is False:
            # the sync promise not met this ack: primary-durable only
            out["replicated"] = False
        return out

    def _own_key_locked(self, key, tenant: Optional[str],
                        token: Optional[str]):
        """(ks, None) or (None, error dict): lookup + tenant ownership
        for the read paths. With tenants configured EVERY caller must
        identify itself and only sees its own keys — result/finalize
        are not a side door around the auth submit enforces."""
        ks = self._keys.get(key)
        if ks is None:
            return None, {"error": "unknown key", "key": key}
        if self._tenants is None:
            return ks, None
        tname, err = self._resolve_tenant(tenant, token)
        if err is not None:
            obs.counter("serve.unauthorized").inc()
            return None, {**err, "key": key}
        if ks.tenant != tname:
            return None, {"error": f"key is owned by another tenant "
                                   f"(not {tname!r})", "key": key,
                          "tenant": tname}
        return ks, None

    def result(self, key, min_seq: Optional[int] = None,
               timeout: Optional[float] = None,
               tenant: Optional[str] = None,
               token: Optional[str] = None) -> dict:
        """The verdict covering the key's applied deltas; blocks until
        at least ``min_seq`` (default: everything enqueued so far) has
        been applied."""
        deadline = None if timeout is None else self._clock() + timeout
        fence = self._read_fence(key)
        with self._cond:
            ks, err = self._own_key_locked(key, tenant, token)
            if err is not None:
                return err
            f = self._fence_locked(ks, fence)
            if f is not None:
                return self._fence_refusal(key, f)
            target = ks.enq_seq if min_seq is None else int(min_seq)
            while ks.applied_seq < target or ks.last_result is None \
                    or ks.needs_check:
                rem = (None if deadline is None
                       else deadline - self._clock())
                if rem is not None and rem <= 0:
                    return {"error": "timeout waiting for verdict",
                            "key": key, "applied-seq": ks.applied_seq}
                self._cond.wait(0.5 if rem is None else min(rem, 0.5))
            r = dict(ks.last_result)
            r["seq"] = ks.applied_seq
            r["key"] = key
            return r

    def finalize(self, key, timeout: Optional[float] = None,
                 tenant: Optional[str] = None,
                 token: Optional[str] = None) -> dict:
        """Drain the key's pending deltas, run the final check
        (counterexample extraction included), and seal the key —
        further deltas get ``{"error": "key is finalized"}``."""
        deadline = None if timeout is None else self._clock() + timeout
        fence = self._read_fence(key)
        with self._cond:
            ks, err = self._own_key_locked(key, tenant, token)
            if err is not None:
                return err
            f = self._fence_locked(ks, fence)
            if f is not None:
                # sealing is the owner's right
                return self._fence_refusal(key, f)
            ks.finalize_requested = True
            self._cond.notify_all()
            while not ks.finalized:
                rem = (None if deadline is None
                       else deadline - self._clock())
                if rem is not None and rem <= 0:
                    return {"error": "timeout waiting for finalize",
                            "key": key}
                self._cond.wait(0.5 if rem is None else min(rem, 0.5))
            r = dict(ks.last_result or {})
            r["seq"] = ks.applied_seq
            r["key"] = key
            return r

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every admitted delta has been applied (graceful
        shutdown's first half). True when drained."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while self._pending_ops > 0 or self._inflight > 0 \
                    or any(ks.needs_check
                           or (ks.finalize_requested
                               and not ks.finalized)
                           for ks in self._keys.values()):
                rem = (None if deadline is None
                       else deadline - self._clock())
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(0.5 if rem is None else min(rem, 0.5))
            return True

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Graceful shutdown: drain (unless told not to), stop the
        worker, close the WAL. Admitted-but-unapplied deltas survive
        in the WAL either way — the restart replays them."""
        if drain:
            self.drain(timeout=timeout)
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=30)
        if self._repl is not None:
            # flush the async queue before the WAL goes away: a graceful
            # shutdown leaves the successor's mirror current
            self._repl.close(drain=drain)
        if self._wal is not None:
            self._wal.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=not any(exc))
        return False

    def stats(self) -> dict:
        with self._cond:
            return {"keys": len(self._keys),
                    "keys_live": sum(1 for k in self._keys.values()
                                     if k.session is not None),
                    "pending_ops": self._pending_ops,
                    "max_pending_seen": self.max_pending_seen}

    # ----------------------------------------------- the ops surface

    def refresh_gauges(self) -> None:
        """Point-in-time refresh of the computed gauges (queue depth,
        live sessions, WAL lag, the SLO burn rates): the ops endpoint
        calls this before every render. The condition is held only to
        copy; the gauges are set outside it, so a scrape never waits on
        a worker's publish for longer than a copy."""
        with self._cond:
            pending = self._pending_ops
            live = sum(1 for k in self._keys.values()
                       if k.session is not None)
            wal_lag = sum(ks.enq_seq - (ks.wal_next - 1)
                          for ks in self._keys.values()) \
                if self._wal is not None else 0
            tpending = {name: ts.pending_ops
                        for name, ts in self._tstate.items()} \
                if self._tenants is not None else {}
        obs.gauge("serve.pending_ops").set(pending)
        obs.gauge("serve.keys_live").set(live)
        for name, v in tpending.items():
            obs.gauge(obs.labeled("serve.pending_ops",
                                  tenant=name)).set(v)
        if self._wal is not None:
            # admitted deltas whose WAL bytes have not landed yet:
            # nonzero is producers outrunning fsync, growing a sick disk
            obs.gauge("serve.wal_lag_deltas").set(wal_lag)
        # the burn rates ride the same refresh (a no-op returning None
        # when the target flag is unset)
        self._slo.sample()

    def status(self) -> dict:
        """The /status document: one row per key (seq, pending,
        frontier live/evicted, last verdict, WAL bytes, per-key
        accounting) plus service totals, the retained slow-delta
        records (armed only) and each tenant's ack and verdict p50/p99."""
        with self._cond:
            rows = []
            for ks in self._keys.values():
                r = ks.last_result or {}
                state = ("fenced" if ks.fenced is not None
                         else "poisoned" if ks.broken
                         else "live" if ks.session is not None
                         else "evicted" if ks.applied_seq
                         else "idle")   # admitted nothing yet (e.g.
                # every delta shed): no frontier was ever built, so
                # "evicted" would imply a checkpoint that isn't there
                row = {
                    "seq": ks.applied_seq,
                    "enq_seq": ks.enq_seq,
                    "pending_deltas": len(ks.pending),
                    "pending_ops": ks.pending_ops,
                    "state": state,
                    "finalized": ks.finalized,
                    "verdict": r.get("valid?"),
                    "error": r.get("error"),
                    "resilience": r.get("resilience"),
                    "wal_dead": ks.wal_dead,
                    "epoch": ks.epoch,
                    "fenced": ks.fenced,
                    "acct": dict(ks.acct),
                }
                if self._tenants is not None:
                    row["tenant"] = ks.tenant
                if r.get("stats"):
                    # JEPSEN_TPU_TORCH_SEARCH_STATS: the key's lifetime
                    # search telemetry, trajectories summarized (a
                    # /status scrape must stay small)
                    s = r["stats"]
                    row["stats"] = {
                        k: s.get(k) for k in
                        ("events", "frontier-peak", "peak-occupancy",
                         "capacity", "capacity-tier", "dedupe",
                         "delta-split-ratio", "load-factor-peak",
                         "probe-hist", "pad-waste")
                        if s.get(k) is not None}
                rows.append((ks.key, row))
            doc = {"pending_ops": self._pending_ops,
                   "max_pending_seen": self.max_pending_seen,
                   "high_water": self.high_water,
                   "global_bound": self.global_bound,
                   "keys_live": sum(1 for k in self._keys.values()
                                    if k.session is not None),
                   "worker_alive": self._worker is not None
                   and self._worker.is_alive()}
            trows = {name: {"weight": ts.weight,
                            "pending_ops": ts.pending_ops,
                            "pending_bound": ts.bound,
                            "keys": ts.keys,
                            "max_keys": ts.max_keys,
                            "wal_bytes": ts.wal_bytes,
                            "max_wal_bytes": ts.max_wal_bytes,
                            "acct": dict(ts.acct)}
                     for name, ts in self._tstate.items()} \
                if self._tenants is not None else None
        # WAL sizes are filesystem reads — outside the service lock
        keys = {}
        for key, row in rows:
            if self._wal is not None:
                row["wal_bytes"] = self._wal.size_bytes(key)
            keys[edn.dumps(key)] = row
        doc["keys"] = keys
        if self.slow_delta_secs:
            # slow-delta forensics (armed only: the key is absent, not
            # empty, when the threshold is off): the retained ring,
            # oldest first, each record a stage breakdown with its
            # verdict context
            doc["slow_delta_secs"] = self.slow_delta_secs
            doc["slow_deltas"] = obs.slow_delta_records(
                self._slow_scope)
        if trows is not None:
            # the per-tenant SLO answer without a /metrics scrape:
            # quantiles straight from the labeled histograms
            snap = obs.registry().snapshot()
            for name, t in trows.items():
                for which in ("ack", "verdict"):
                    h = snap.get(obs.labeled(f"serve.{which}_secs",
                                             tenant=name))
                    t[f"{which}_p50"] = (obs.hist_quantile(h, 0.5)
                                         if h else None)
                    t[f"{which}_p99"] = (obs.hist_quantile(h, 0.99)
                                         if h else None)
            doc["tenants"] = trows
        return doc

    def health(self) -> dict:
        """The /healthz document: ``ok`` is READINESS (serve this
        instance traffic?), degraded by a dead worker, an unwritable/
        dead WAL, any registered circuit breaker not closed, a poisoned
        key, the queue at/past the shed high-water, or (armed only) an
        SLO burning past its threshold. Liveness is the answer
        itself."""
        with self._cond:
            worker_ok = (self._worker is not None
                         and self._worker.is_alive()
                         and not self._stop)
            pending = self._pending_ops
            wal_dead = sum(1 for ks in self._keys.values()
                           if ks.wal_dead)
            poisoned = sum(1 for ks in self._keys.values()
                           if ks.broken)
            n_keys = len(self._keys)
        checks = {"worker": {"ok": worker_ok}}
        if self._wal is not None:
            writable = os.access(self._wal.root, os.W_OK)
            checks["wal"] = {"ok": writable and wal_dead == 0,
                             "dir": self._wal.root,
                             "writable": writable,
                             "dead_keys": wal_dead}
        queue_ok = not self.high_water or pending < self.high_water
        checks["queue"] = {"ok": queue_ok, "pending_ops": pending,
                           "high_water": self.high_water,
                           "global_bound": self.global_bound}
        # the breaker registry (imported here: an in-memory embedding
        # need not pull the breaker machinery in)
        from jepsen_tpu_torch.resilience import breaker as breaker_mod
        snaps = breaker_mod.snapshots()
        checks["breakers"] = {
            "ok": all(s["state"] == breaker_mod.CLOSED for s in snaps),
            "states": {s["backend"]: s["state"] for s in snaps}}
        checks["keys"] = {"ok": poisoned == 0, "total": n_keys,
                          "poisoned": poisoned}
        if self._slo.armed:
            # armed only: the key is absent, not ok:true, with
            # JEPSEN_TPU_TORCH_SLO_ACK_SECS unset; with
            # JEPSEN_TPU_TORCH_SLO_BURN_MAX=0 the check is informational
            checks["slo"] = self._slo.check()
        return {"ok": all(c["ok"] for c in checks.values()),
                "live": True, "checks": checks}

    # ------------------------------------------------------ recovery

    def _recover_key(self, key, bump_epoch: bool = False):
        """Build one key's state from its WAL segments + evicted
        checkpoint (no shared-state mutation — the caller installs
        under the condition). Returns (ks, wal_bytes) or None.

        ``bump_epoch`` is the ADOPTION path (``adopt_keys``): the new
        owner takes the key at epoch+1 and seals the transferred
        segments so its first append opens a fresh segment whose
        header carries the bump durably. A plain restart keeps the
        stored epoch (same owner, same epoch)."""
        deltas, wal_ids = self._wal.replay_with_ids(key)
        if not deltas:
            return None
        head = self._wal.header(key) or {}
        tname = (head.get("tenant") or tenancy.DEFAULT_TENANT) \
            if self._tenants is not None else tenancy.DEFAULT_TENANT
        cp, meta = (self._cps.load(key) if self._cps is not None
                    else (None, None))
        applied = int(meta.get("applied_seq", 0)) if meta else 0
        base = [op for seq, ops in deltas if seq <= applied
                for op in ops]
        rest = [(seq, ops) for seq, ops in deltas if seq > applied]
        ks = _Key(key, tenant=tname)
        # adoption bases its bump on the transferred segment HEADERS,
        # never on an in-process stamp an earlier ownership generation
        # of this key left behind
        ks.epoch = self._wal.header_epoch(key) \
            + (1 if bump_epoch else 0)
        self._wal.set_epoch(key, ks.epoch)
        if bump_epoch:
            # persist the bump NOW (fresh segment + fsynced header)
            self._wal.rotate(key)
            self._wal.touch(key, tenant=(tname if self._tenants
                                         is not None else None))
        fence = self._wal.fence(key)
        if fence is not None and fence.get("epoch", 0) >= ks.epoch:
            # this key was rehomed away while the replica was down:
            # recover it for forensics, refuse its producers
            ks.fenced = fence
        elif fence is not None and bump_epoch:
            # a stale fence from an earlier ownership generation (the
            # key migrated back here): our bumped epoch out-ranks it
            self._wal.clear_fence(key)
        # delta ids ride the transferred segments: the ids the previous
        # owner stamped (or synthesized stand-ins for records without
        # one) re-tag this replica's thaw and apply spans, collected in
        # the same segment scan as the deltas
        ids = wal_ids if self._delta_obs else {}
        sess = self._new_session(key)
        if base:
            # host work only (the re-encode; the checkpoint stays host
            # arrays): the scan runs on the worker
            sp_kw = {"key": str(key), "ops": len(base)}
            if ids:
                bids = [ids[seq] for seq, _ops in deltas
                        if seq <= applied and seq in ids]
                sp_kw["delta_ids"] = bids[-32:]
            with obs.span("serve.thaw", **sp_kw):
                sess.thaw(base, cp)
            ks.applied_seq = applied
            ks.needs_check = True
        ks.session = sess
        if meta and meta.get("finalized"):
            ks.finalize_requested = True
        ks.enq_seq = deltas[-1][0]
        ks.wal_next = deltas[-1][0] + 1
        ks.pending.extend(rest)
        if self._delta_obs:
            now = self._clock()
            for seq, dops in rest:
                ks.delta_recs.append(
                    {"id": ids.get(seq) or _mint_delta_id(),
                     "seq": seq, "tenant": tname, "ops": len(dops),
                     "t_in": now})
        ks.pending_ops = sum(len(ops) for _, ops in rest)
        ks.last_activity = self._clock()
        ks.acct["replays"] = len(deltas)
        return ks, self._wal.size_bytes(key)

    def _install_recovered_locked(self, ks: _Key,
                                  wal_bytes: int) -> None:
        """Admit a rebuilt key into the live tables (callers hold the
        condition, or run pre-worker where no one else can)."""
        self._keys[ks.key] = ks
        self._pending_ops += ks.pending_ops
        ts = self._tenant_state_locked(ks.tenant)
        if ts is not None:
            ts.keys += 1
            ts.pending_ops += ks.pending_ops
            ts.wal_bytes += wal_bytes
        obs.counter("serve.replayed_deltas").inc(ks.acct["replays"])

    def _recover(self) -> None:
        """Rebuild every key from its WAL (synchronously, before the
        worker starts): replay is deterministic, so the recomputed
        verdicts equal the pre-crash ones. An evicted checkpoint, when
        present and digest-matched, spares the replay its re-scan of
        the settled prefix."""
        for key in self._wal.keys():
            built = self._recover_key(key)
            if built is None:
                continue
            self._install_recovered_locked(*built)
        if self._keys:
            _log.info("serve: recovered %d key(s) from the WAL",
                      len(self._keys))

    def adopt_keys(self) -> list:
        """Recover any WAL keys not yet admitted, LIVE — the replica
        handoff entry point: a dead (or draining) replica's WAL
        segments and frozen checkpoint pair copied into this service's
        wal_dir replay into running sessions exactly like a restart
        would. Returns the adopted keys."""
        if self._wal is None:
            raise RuntimeError("adopt_keys needs a WAL-backed service")
        adopted = []

        def _replaceable(cur) -> bool:
            # an empty SHELL a producer's early retry minted while the
            # handoff was in flight, or a FENCED key whose local state
            # is forensics-only; real live state is an unfenced key
            # with admitted or applied deltas
            if cur.fenced is not None:
                return True
            return not (cur.enq_seq or cur.applied_seq or cur.pending
                        or cur.needs_check)

        for key in self._wal.keys():
            with self._cond:
                cur = self._keys.get(key)
                if cur is not None and not _replaceable(cur):
                    continue
            # replay + thaw outside the lock so live producers keep
            # admitting; the epoch bump is the ownership transition
            built = self._recover_key(key, bump_epoch=True)
            if built is None:
                continue
            with self._cond:
                cur = self._keys.get(key)
                if cur is not None:
                    if not _replaceable(cur):
                        _log.warning("adopt_keys: key %r gained live "
                                     "state during replay — keeping "
                                     "the live key", key)
                        continue
                    # replace the empty shell: release its quota slot,
                    # and fence the orphaned object so a waiter still
                    # holding it gets a structured answer
                    ts = self._tenant_state_locked(cur.tenant)
                    if ts is not None:
                        ts.keys -= 1
                    cur.fenced = {"epoch": built[0].epoch,
                                  "owner": None}
                self._install_recovered_locked(*built)
                self._cond.notify_all()
            adopted.append(key)
            obs.counter("serve.adopted_keys").inc()
        if adopted:
            _log.info("serve: adopted %d key(s) from transferred WAL "
                      "segments", len(adopted))
        return adopted

    # -------------------------------------------------- worker side

    def _new_session(self, key, device=None) -> ext.HistorySession:
        return ext.HistorySession(
            self.model, capacity=self.capacity,
            max_capacity=self.max_capacity, dedupe=self.dedupe,
            probe_limit=self.probe_limit,
            device=device if device is not None else self.device,
            key=key)

    def _session_for(self, ks: _Key) -> ext.HistorySession:
        if ks.session is not None:
            return ks.session
        # evicted: thaw transparently from checkpoint store + WAL —
        # onto the key's stolen device pin when one is set
        sess = self._new_session(ks.key, device=ks.device)
        cp, _meta = (self._cps.load(ks.key)
                     if self._cps is not None else (None, None))
        deltas, ids = (self._wal.replay_with_ids(ks.key)
                       if self._wal else ([], {}))
        applied = [(seq, dops) for seq, dops in deltas
                   if seq <= ks.applied_seq]
        ops = [op for _seq, dops in applied for op in dops]
        if ops:
            sp_kw = {"key": str(ks.key)}
            if self._delta_obs:
                sp_kw["delta_ids"] = [ids[seq] for seq, _d in applied
                                      if seq in ids][-32:]
            with obs.span("serve.thaw", **sp_kw):
                sess.thaw(ops, cp)
            obs.counter("serve.thaws").inc()
            ks.acct["replays"] += len(applied)
        ks.session = sess
        return sess

    def _work_available_locked(self) -> bool:
        return any(ks.pending or ks.needs_check
                   or (ks.finalize_requested and not ks.finalized)
                   for ks in self._keys.values())

    def _take_recs_locked(self, ks: _Key, last_seq) -> tuple:
        """Pop the per-delta trace records this batch covers (callers
        hold the condition) and stamp the queue->worker handoff time.
        The records move with the batch and are closed out at verdict
        publish. Empty when delta tracing is unarmed."""
        if last_seq is None or not ks.delta_recs:
            return ()
        now = self._clock()
        out = []
        while ks.delta_recs and ks.delta_recs[0]["seq"] <= last_seq:
            r = ks.delta_recs.popleft()
            r["t_take"] = now
            out.append(r)
        return tuple(out)

    def _take_work_locked(self) -> list:
        """Pop pending deltas (coalesced, seq order) as ``(ks, ops,
        last_seq, final, recs)`` and settle the backpressure accounting
        HERE — ops leave the queue exactly once, so no later error path
        can double-decrement.

        Single-tenant mode takes everything (FIFO drain). Multi-tenant
        mode is deficit round-robin: every backlogged tenant banks
        ``weight x quantum`` ops of credit per cycle and the batch
        takes whole deltas while credit lasts (debt allowed so an
        oversized delta still drains), so device time tracks weights
        even when one tenant's queues are always full."""
        if self._tenants is None:
            batch = []
            for ks in self._keys.values():
                if not (ks.pending or ks.needs_check
                        or (ks.finalize_requested
                            and not ks.finalized)):
                    continue
                ops = []
                last_seq = None
                while ks.pending:
                    seq, dops = ks.pending.popleft()
                    ops.extend(dops)
                    last_seq = seq
                ks.pending_ops -= len(ops)
                self._pending_ops -= len(ops)
                final = ks.finalize_requested and not ks.finalized
                batch.append((ks, ops, last_seq, final,
                              self._take_recs_locked(ks, last_seq)))
            if batch:
                obs.gauge("serve.pending_ops").set(self._pending_ops)
                obs.counter_sample("serve.pending_ops",
                                   self._pending_ops)
                self._cond.notify_all()   # queue space freed: release
                # blocked producers now, not after the device work
            return batch
        return self._take_drr_locked()

    def _take_drr_locked(self) -> list:
        batch = []
        by_tenant: Dict[str, list] = {}
        for ks in self._keys.values():
            if ks.pending or ks.needs_check \
                    or (ks.finalize_requested and not ks.finalized):
                by_tenant.setdefault(ks.tenant, []).append(ks)
        names = sorted(self._tstate)
        if names:
            # rotate the starting tenant each cycle so ties don't
            # always break for the alphabetically first name
            start = self._drr_idx % len(names)
            self._drr_idx += 1
            names = names[start:] + names[:start]
        took_ops = 0
        for tname in names:
            ts = self._tstate[tname]
            keys = by_tenant.get(tname, ())
            if not keys:
                ts.deficit = 0   # classic DRR: no banking while idle
                continue
            if any(ks.pending for ks in keys):
                ts.deficit += ts.weight * self._drr_quantum
            for ks in keys:
                ops = []
                last_seq = None
                while ks.pending and ts.deficit > 0:
                    seq, dops = ks.pending.popleft()
                    ops.extend(dops)
                    last_seq = seq
                    ts.deficit -= len(dops)
                # finalize only once the key's queue is EMPTY: a
                # deficit that ran out mid-drain must not seal the
                # key over acknowledged-but-unapplied deltas
                final = ks.finalize_requested and not ks.finalized \
                    and not ks.pending
                if not (ops or ks.needs_check or final):
                    continue
                if ops:
                    ks.pending_ops -= len(ops)
                    self._pending_ops -= len(ops)
                    ts.pending_ops -= len(ops)
                    took_ops += len(ops)
                    obs.gauge(obs.labeled(
                        "serve.pending_ops",
                        tenant=tname)).set(ts.pending_ops)
                batch.append((ks, ops, last_seq, final,
                              self._take_recs_locked(ks, last_seq)))
            if not any(ks.pending for ks in keys):
                ts.deficit = 0
        if took_ops:
            obs.gauge("serve.pending_ops").set(self._pending_ops)
            obs.counter_sample("serve.pending_ops", self._pending_ops)
        if batch:
            self._cond.notify_all()
        return batch

    def _observe_verdicts_locked(self, ks: _Key) -> None:
        """Drain the key's admitted-delta timestamps up to its applied
        seq into the ingest->verdict SLO histogram (callers hold the
        service condition)."""
        now = self._clock()
        h = obs.histogram("serve.verdict_secs")
        ht = (obs.histogram(obs.labeled("serve.verdict_secs",
                                        tenant=ks.tenant))
              if self._tenants is not None else None)
        while ks.pending_times and ks.pending_times[0][0] \
                <= ks.applied_seq:
            _seq, t_in = ks.pending_times.popleft()
            v = max(0.0, now - t_in)
            h.observe(v)
            if ht is not None:
                ht.observe(v)

    def _crashed_entry(self, ks: _Key, err) -> dict:
        """Per-entry failure isolation: a loud error verdict, and the
        in-memory session is DROPPED so the next delta thaw-replays
        the WAL instead of extending a session that may have missed
        acknowledged ops. Without a WAL there is nothing to replay —
        the key is POISONED (further deltas refused) rather than
        silently rebuilt from a truncated history. The flight recorder
        (armed or not: a None check) dumps the crash, its trigger
        naming the key."""
        obs.counter("serve.worker_errors").inc()
        _log.error("serve worker: key %r failed: %s: %s", ks.key,
                   type(err).__name__, err)
        obs.flight_dump("serve-worker-error", context={
            "key": str(ks.key), "tenant": ks.tenant,
            "error": f"{type(err).__name__}: {err}"})
        ks.session = None
        if self._wal is None:
            ks.broken = True
        return {"valid?": "unknown",
                "error": f"serve worker crashed on this key: "
                         f"{type(err).__name__}: {err}"}

    def _process(self, batch: list) -> None:
        # phase 1 (no lock): apply deltas (host: the re-encode); a
        # crash costs ONE key
        entries = []
        for ks, ops, last_seq, final, recs in batch:
            sess = err_r = None
            if ks.broken:
                # poisoned (worker crash, no WAL): keep serving the
                # error verdict; never rebuild from a truncated stream
                entries.append((ks, None, last_seq, final,
                                dict(ks.last_result or {
                                    "valid?": "unknown",
                                    "error": "key poisoned"}), recs))
                continue
            try:
                sess = self._session_for(ks)
                if ops:
                    sp_kw = {"key": str(ks.key), "ops": len(ops)}
                    if recs:
                        # the delta ids this apply advances: the
                        # worker-side link of each delta's chain
                        sp_kw["delta_ids"] = [r["id"] for r in recs]
                        sp_kw["tenant"] = ks.tenant
                    with obs.span("serve.apply", **sp_kw):
                        sess.extend(ops)
            except Exception as err:  # noqa: BLE001 — isolate per key
                err_r = self._crashed_entry(ks, err)
            entries.append((ks, sess, last_seq, final, err_r, recs))
        # phase 2 (no lock): one batched advance over the live ones.
        # A device error surfaces here (no host degradation in the
        # port): every key of the batch gets the loud verdict
        live = [e for e in entries if e[4] is None]
        try:
            with obs.span("serve.advance", keys=len(live)):
                rs = ext.advance_sessions([e[1] for e in live],
                                          bucket=self.bucket)
            results = dict(zip((id(e[0]) for e in live), rs))
        except Exception as err:  # noqa: BLE001
            results = {id(e[0]): self._crashed_entry(e[0], err)
                       for e in live}
        # phase 3 (no lock): finalization — counterexample extraction
        # is device work and must not stall every other key's
        # submit/result behind the service lock
        for ks, sess, _last_seq, final, err_r, _recs in entries:
            if final and err_r is None and id(ks) in results \
                    and sess is not None:
                try:
                    results[id(ks)] = sess.finalize()
                except Exception as err:  # noqa: BLE001
                    results[id(ks)] = self._crashed_entry(ks, err)
        # phase 4: publish under the lock. t_dev_end splits each
        # delta's device stage (apply/advance/finalize above) from its
        # publish stage (this lock acquisition and the bookkeeping)
        t_dev_end = self._clock()
        dump_ctx = None
        with self._cond:
            with obs.span("serve.publish", keys=len(entries)):
                for ks, sess, last_seq, final, err_r, recs in entries:
                    ks.last_result = (err_r if err_r is not None
                                      else results[id(ks)])
                    ks.needs_check = False
                    if final:
                        ks.finalized = True
                    if last_seq is not None:
                        ks.applied_seq = last_seq
                    self._observe_verdicts_locked(ks)
                    ctx = self._finish_recs_locked(ks, recs, t_dev_end)
                    if ctx is not None:
                        dump_ctx = ctx
                    ks.last_activity = self._clock()
            self._cond.notify_all()
        if dump_ctx is not None:
            # the worst slow delta so far gets the flight ring dumped
            # with it, outside the service lock (file I/O)
            obs.flight_dump("slow-delta", context=dump_ctx)

    def _finish_recs_locked(self, ks: _Key, recs,
                            t_dev_end: float) -> Optional[dict]:
        """Close out a batch's per-delta trace records at verdict
        publish (callers hold the condition): each delta's stage
        breakdown and, with ``JEPSEN_TPU_TORCH_SLOW_DELTA_SECS`` armed
        and crossed, its record in the bounded newest-wins ring
        (``obs.record_slow_delta``). Returns the record to flight-dump
        when one is the new worst offender (the CALLER dumps, outside
        the lock)."""
        if not recs:
            return None
        now = self._clock()
        worst_ctx = None
        r0 = ks.last_result or {}
        for r in recs:
            t_in = r["t_in"]
            t_admit = r.get("t_admit", t_in)
            t_take = r.get("t_take", t_admit)
            total = max(0.0, now - t_in)
            if not self.slow_delta_secs \
                    or total < self.slow_delta_secs:
                continue
            # the WAL stage is a measured fsync DURATION, concurrent
            # with queue and device (the worker takes a delta without
            # waiting for its fsync), so queue is the whole
            # admission->take wait and the stages need not sum to the
            # total. A verdict published while the fsync is in flight
            # attributes the window so far (end stamp missing).
            ws = r.get("t_wal_start")
            we = r.get("t_wal_end")
            # None checks, not truthiness: an injectable clock may
            # stamp 0.0
            wal_secs = (max(0.0, we - ws)
                        if ws is not None and we is not None
                        else max(0.0, now - ws) if ws is not None
                        else 0.0)
            stages = {
                "backpressure": max(0.0, t_admit - t_in),
                "wal": wal_secs,
                "queue": max(0.0, t_take - t_admit),
                "device": max(0.0, t_dev_end - t_take),
                "publish": max(0.0, now - t_dev_end),
            }
            doc = {"delta_id": r["id"], "key": str(ks.key),
                   "tenant": r.get("tenant"), "seq": r.get("seq"),
                   "ops": r.get("ops"),
                   "total_secs": round(total, 6),
                   "stages": {k: round(v, 6)
                              for k, v in stages.items()},
                   "slowest_stage": max(stages, key=stages.get),
                   "verdict": r0.get("valid?")}
            if r0.get("error"):
                doc["error"] = r0["error"]
            if r0.get("resilience"):
                doc["resilience"] = r0["resilience"]
            if r0.get("stats"):
                # the search-stats block (armed only): which device
                # program the delta ran, sized
                st = r0["stats"]
                doc["stats"] = {k: st.get(k) for k in
                                ("events", "frontier-peak",
                                 "capacity", "capacity-tier",
                                 "dedupe", "load-factor-peak",
                                 "probe-hist", "pad-waste")
                                if st.get(k) is not None}
            if obs.record_slow_delta(doc, scope=self._slow_scope):
                worst_ctx = doc
        return worst_ctx

    def _freeze_session(self, ks: _Key, locked: bool = False) -> None:
        """Freeze one key's live frontier to the checkpoint store and
        drop the in-memory session. Eviction (worker thread — the
        only session toucher, so it freezes lock-free) and graceful
        migration (any thread — the caller HOLDS the condition for
        the whole freeze so the worker cannot pick the key up
        mid-write) share this. The checkpoints are host arrays."""
        with obs.span("serve.evict", key=str(ks.key)):
            meta = ks.session.freeze(self._cps.checkpoint_path(ks.key))
        meta["applied_seq"] = ks.applied_seq
        meta["finalized"] = ks.finalized
        self._cps.save(ks.key, meta)
        if locked:
            ks.session = None
        else:
            with self._cond:
                ks.session = None
        obs.counter("serve.evictions").inc()

    def freeze_key(self, key) -> bool:
        """Freeze one key NOW (the graceful-migration primitive: the
        new owner thaws instead of re-scanning). False when there is
        nothing to freeze: no checkpoint store, no live session, or
        the key still has unapplied work (drain first). The whole
        freeze runs UNDER the service condition, so a producer racing
        the migration cannot land a delta the worker extends the
        session with while ``freeze()`` serializes it."""
        if self._cps is None:
            return False
        with self._cond:
            ks = self._keys.get(key)
            if ks is None or ks.session is None or ks.pending \
                    or ks.needs_check:
                return False
            self._freeze_session(ks, locked=True)
        return True

    def steal_key(self, key, device=None) -> bool:
        """Move a mid-stream key's device placement (the serve half of
        key work-stealing): whole KEYS move, never mid-search state.
        With a checkpoint store the live frontier freezes through the
        eviction path and the next delta thaws it onto ``device``;
        without one, an idle live session re-places in memory
        (``HistorySession.migrate``: its checkpoints are host arrays
        either way). False when the key does not exist or still has
        unapplied work (drain first)."""
        with self._cond:
            ks = self._keys.get(key)
            if ks is None:
                return False
            if ks.pending or ks.needs_check:
                return False
            if ks.session is not None:
                if self._cps is not None:
                    self._freeze_session(ks, locked=True)
                else:
                    ks.session.migrate(device if device is not None
                                       else self.device)
            ks.device = device
        obs.counter("serve.keys_stolen").inc()
        return True

    def _maybe_evict(self) -> None:
        if self._cps is None or self.evict_idle_secs <= 0:
            return
        now = self._clock()
        with self._cond:
            victims = [ks for ks in self._keys.values()
                       if ks.session is not None and not ks.pending
                       and not ks.needs_check
                       and not (ks.finalize_requested
                                and not ks.finalized)
                       and now - ks.last_activity
                       > self.evict_idle_secs]
        for ks in victims:
            self._freeze_session(ks)
        if victims:
            with self._cond:
                live = sum(1 for k in self._keys.values()
                           if k.session is not None)
            obs.gauge("serve.keys_live").set(live)

    def _run(self) -> None:
        poll = (min(0.25, max(0.01, self.evict_idle_secs / 4))
                if self._cps is not None and self.evict_idle_secs > 0
                else 0.5)
        while True:
            with self._cond:
                while not self._stop \
                        and not self._work_available_locked():
                    self._cond.wait(timeout=poll)
                    if self._cps is not None:
                        break   # wake to run the eviction sweep
                if self._stop and not self._work_available_locked():
                    return
                batch = self._take_work_locked()
                self._inflight = len(batch)
            try:
                if batch:
                    self._process(batch)
            except Exception as err:  # noqa: BLE001 — _process
                # isolates failures per key; anything reaching here is
                # a bug in the batching itself. The worker must
                # survive it: publish loud error verdicts (accounting
                # was settled at take time) and drop the sessions so
                # the WAL replay recovers the truth on the next delta.
                t_dev_end = self._clock()
                dump_ctx = None
                # the per-key dumps FIRST, outside the condition (file
                # I/O): the lock below covers bookkeeping only
                err_rs = {id(ks): self._crashed_entry(ks, err)
                          for ks, _ops, _seq, _final, _recs in batch}
                with self._cond:
                    for ks, _ops, last_seq, _final, recs in batch:
                        ks.last_result = err_rs[id(ks)]
                        ks.needs_check = False
                        if last_seq is not None:
                            ks.applied_seq = last_seq
                        self._observe_verdicts_locked(ks)
                        ctx = self._finish_recs_locked(ks, recs,
                                                       t_dev_end)
                        if ctx is not None:
                            dump_ctx = ctx
                    self._cond.notify_all()
                if dump_ctx is not None:
                    # a crashed batch's worst offender still raised the
                    # ring's high-water: dump it, outside the lock
                    obs.flight_dump("slow-delta", context=dump_ctx)
            finally:
                with self._cond:
                    self._inflight = 0
                    self._cond.notify_all()
            self._maybe_evict()
