"""The port's linearizability engine: routing and counterexamples.

A port of the single-history part of `jepsen_tpu.parallel.engine`:
`analysis` encodes the history on the host and checks it on the device
— with the bit-packed dense engine (`parallel.bitdense`, whose closure
is kernel K1) when the history fits it, else with the sparse frontier
engine (`parallel.sparse`, whose hash closure is kernel K2, or the
tiled insert K4 past K2's shared-memory gate). A failure is then
explained on the host by `extract_final_paths`, a WGL re-search of the
failing prefix — or, for histories over 500 calls, of a window before
the failure, seeded from the device's configurations at the window's
start.

Routes, as in the reference:
  * a history the encoder cannot pack (EncodeError) goes to the host
    WGL engine, with a `fallback` note;
  * a history that fits the dense engine (fits_bitdense) runs on it;
  * any other history runs on the sparse engine.

A device fault is not caught here: it surfaces to the caller.

The per-key batch (`check_batch`, `check_batch_encoded`; the reference's
jepsen.independent batch) buckets the keys by slot window and checks
each bucket whose padded dims fit the dense engine in one batched scan
(`bitdense.check_batch_bitdense`), and every other bucket in the sparse
batch with per-key capacity retry (`sparse.check_batch_sparse`, whose
closure is K2 or K4 batched over keys) and, past its ceiling, the
single-key escalation (`_escalate_overflow`). Results keep the input
order. `check_batch(pipeline=True)` overlaps the encode with the card's
scan (`parallel.pipeline`), `check_batch(steal=True)` runs the buckets
in rounds under the work-stealing scheduler (`parallel.elastic`), and
`check_batch(mesh=...)` shards the key axis over the ranks of a
`torch.distributed` DeviceMesh: every rank scans its block of each
bucket, padded to the whole bucket's dims, the results are all-gathered
into input order, and a key past the batch's ceiling escalates on every
rank together — the single-key rung, then the frontier-sharded engine
over the mesh (`parallel.sharded`).

`check_encoded_resumable` is the sparse engine's check in chunks of
events with a `FrontierCheckpoint` after each, which resumes it — and
the streaming sessions of `parallel.extend` — in this process or
another (the checkpoint's .npz is the reference's format).

`search_stats` (None: the JEPSEN_TPU_TORCH_SEARCH_STATS flag, off by
default) gives every result the reference's "stats" block
(`parallel.search_stats`): the dense engine's or the sparse engine's,
each key of a batch its own. With it off a result has no "stats" key.

Telemetry (`obs`), the reference's sites and names: the `engine.encode`
span, `engine.check_batch` around a serial or stealing batch with
`engine.encode_batch` inside it and the `torch.profiler` capture
(`obs.maybe_torch_profile`, the reference's `maybe_jax_profile`)
around both; the `engine.host_fallbacks`, `false_invalid`,
`final_paths_missing`, `capacity_escalations` and `escalation_errors`
counters. The sparse engine's `engine.search` span and its counters
live in `parallel.sparse`.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time as _time
from typing import Optional

import numpy as np
import torch

from jepsen_tpu_torch import envflags, obs
from jepsen_tpu_torch import models as model_ns
from jepsen_tpu_torch.checker import wgl
from jepsen_tpu_torch.history import Call, History
from jepsen_tpu_torch.parallel import bitdense, sparse
from jepsen_tpu_torch.parallel import search_stats as st
from jepsen_tpu_torch.parallel import encode as enc_mod
from jepsen_tpu_torch.parallel.encode import EncodedHistory, EncodeError

_log = logging.getLogger(__name__)


def analysis(model, history, device=None, capacity: int = 1024,
             max_capacity: int = 1 << 20, dedupe=None,
             config_pack=None, search_stats=None, cancel=None,
             encode_cache=None) -> dict:
    """knossos-style (model, history) -> result on the device engine.

    `device` None means the card and raises RuntimeError when there is
    none; the tests pass "cpu". `capacity`, `max_capacity`, `dedupe` and
    `config_pack` go to the sparse engine (`sparse.check_encoded`): past
    `max_capacity` the verdict is "unknown". The dense engine ignores
    `config_pack`, as the reference's does. `search_stats` (None: the
    flag) adds the engine's "stats" block. `cancel` (an object with
    `is_set()`, such as a threading.Event; polled once an event) stops
    the check early with {"valid?": "unknown", "error": "cancelled"},
    as the host checkers' `cancel` does: the competition race's device
    arm stops so when another arm has decided. `encode_cache` (a
    `pipeline.EncodeCache`, or True for the process's) keeps the encode
    for the next analysis of the same history; None or False: none."""
    dev = bitdense.resolve_device(device)
    h = history if isinstance(history, History) else History.wrap(history)
    try:
        with obs.span("engine.encode"):
            if encode_cache is not None and encode_cache is not False:
                from jepsen_tpu_torch.parallel import pipeline
                e = pipeline.encode_cached(
                    model, h,
                    cache=None if encode_cache is True else encode_cache)
            else:
                e = enc_mod.encode(model, h)
    except EncodeError as err:
        obs.counter("engine.host_fallbacks").inc()
        _log.warning(
            "history not device-checkable (%s) — using the host WGL "
            "engine; expect it to be orders of magnitude slower", err)
        r = wgl.analysis(model, h, cancel=cancel)
        r["fallback"] = str(err)
        return r
    try:
        if bitdense.fits_bitdense(bitdense.n_states(e), e.n_slots):
            r = bitdense.check_encoded_bitdense(
                e, device=dev, search_stats=search_stats, cancel=cancel)
        else:
            r = sparse.check_encoded(
                e, capacity=capacity, max_capacity=max_capacity,
                dedupe=dedupe, device=dev, config_pack=config_pack,
                search_stats=search_stats, cancel=cancel)
        bitdense.poll_cancel(cancel)
    except bitdense.Cancelled:
        return {"valid?": "unknown", "error": "cancelled"}
    if r["valid?"] is False:
        apply_final_paths(r, model, e, device=dev)
    return r


# --------------------------------------- counterexample extraction

# Host re-search window for long histories: events before the failure
# covered by the seeded re-search (the reference emits full paths but
# truncates to 10 — checker.clj:203-213; for histories the host could
# never search whole, a window ending at the failure is the useful part)
PATHS_WINDOW_EVENTS = 64
PATHS_MAX_SEEDS = 8

# Bounds for the full-host recheck run when the host path re-search
# CONTRADICTS a device-invalid (below).
DISAGREEMENT_RECHECK_MAX_STATES = 5_000_000
DISAGREEMENT_RECHECK_SECS = 30.0


def _disagreement_recheck(model, e: EncodedHistory, note: str) -> dict:
    """The host re-search contradicted a device-invalid. Before shipping
    "invalid, no paths", re-check the WHOLE key host-side under a
    bounded budget: a device false-invalid must not become the verdict
    when the host can decide the key. Decisive host verdicts win; an
    over-budget recheck keeps the device verdict, tagged."""
    n_history = max(c.complete_index for c in e.calls) + 1
    host = wgl.check_calls(
        model, list(e.calls), n_history,
        max_states=DISAGREEMENT_RECHECK_MAX_STATES,
        deadline=_time.monotonic() + DISAGREEMENT_RECHECK_SECS)
    if host.get("valid?") is False:
        out = {"final-paths": host.get("final-paths", []),
               "configs": host.get("configs", []),
               "engine-disagreement": note + "; full-host recheck "
                                             "confirms invalid"}
        if host.get("op"):
            out["op"] = host["op"]
        return out
    if host.get("valid?") is True:
        # counted, not just logged: the loudest device-engine signal
        obs.counter("engine.false_invalid").inc()
        _log.error("device engine false-invalid: %s, and the bounded "
                   "full-host recheck says VALID — overriding the device "
                   "verdict (this may hide a device-engine bug; please "
                   "report the history)", note)
        return {"valid?": True, "final-paths": [], "configs": [],
                "engine-disagreement": note + "; full-host recheck says "
                                              "valid — device verdict "
                                              "overridden"}
    _log.warning("final-paths: %s; the bounded full-host recheck was "
                 "indecisive (%s) — keeping the device verdict",
                 note, host.get("error", "?"))
    return {"final-paths": [], "configs": [],
            "final-paths-note": note + "; bounded full-host recheck "
                                       "indecisive — device verdict "
                                       "kept"}


def apply_final_paths(r: dict, model, e: EncodedHistory,
                      device=None) -> dict:
    """Merge extract_final_paths into a device-invalid result `r`, in
    place. When the disagreement recheck OVERRIDES the verdict to
    valid, the device's stale counterexample fields are dropped — a
    valid result must not carry a phantom failing op."""
    fp = extract_final_paths(model, e, int(r["fail-event"]), device=device)
    if fp.get("valid?") is True:
        for k in ("op", "fail-event"):
            r.pop(k, None)
    r.update(fp)
    return r


def extract_final_paths(model, e: EncodedHistory, fail_r: int,
                        window: int = PATHS_WINDOW_EVENTS,
                        max_seeds: int = PATHS_MAX_SEEDS,
                        device=None) -> dict:
    """knossos-style :final-paths / :configs for a failing return event.

    Short histories (<= 500 calls) re-search the whole failing prefix on
    the host. Longer ones re-run the device scan up to `window` return
    events before the failure, read the reachable set there as
    (model state, linearized-open-calls) seeds, and host-search only the
    window from the first `max_seeds` of them."""
    fail_idx = e.calls[int(e.ret_call[fail_r])].complete_index
    if e.n_calls <= 500:
        host = wgl.check_calls(model, _prefix_calls(e.calls, fail_idx),
                               fail_idx + 1)
        if host.get("valid?") is False:
            return {"final-paths": host.get("final-paths", []),
                    "configs": host.get("configs", [])}
        return _disagreement_recheck(
            model, e, "host re-search of the failing prefix came back "
                      "valid while the device said invalid")

    # the encoded history carries its *prepared* spec — for models with
    # history-dependent packing (gset lanes, queue widths) a fresh
    # pack_spec could not unpack device states
    spec = e.spec or model_ns.pack_spec(model, e.intern)
    if spec is None or spec.unpack_state is None:
        note = "model has no unpack_state; cannot seed a window re-search"
        obs.counter("engine.final_paths_missing").inc()
        _log.warning("final-paths extraction returned nothing for an "
                     "invalid history: %s", note)
        return {"final-paths": [], "configs": [], "final-paths-note": note}
    start_ev = max(0, fail_r - window)
    if start_ev == 0:
        seeds = [(e.state0, frozenset())]
    else:
        rows = _frontier_at(e, start_ev, device=device)
        if rows is None:
            note = "seed-frontier re-scan overflowed max capacity"
            obs.counter("engine.final_paths_missing").inc()
            _log.warning("final-paths extraction returned nothing for an "
                         "invalid history: %s", note)
            return {"final-paths": [], "configs": [],
                    "final-paths-note": note}
        occupants = _slot_occupants_before(e, start_ev)
        seeds = []
        for stc, ml, mh in rows[:max_seeds]:
            mask = ml | (mh << 32)
            seeds.append((stc, frozenset(
                cid for s, cid in occupants.items() if (mask >> s) & 1)))

    boundary = (e.calls[int(e.ret_call[start_ev])].complete_index
                if start_ev > 0 else -1)
    paths: list = []
    configs: list = []
    # Every sampled seed runs BEFORE any paths are trusted: a failing
    # seed may just be a dead-end config, while a seed that linearizes
    # through the failure contradicts the device's verdict.
    for seed_i, (stc, linearized) in enumerate(seeds):
        seed_model = spec.unpack_state(stc, e.intern)
        cs = _window_calls(e.calls, boundary, fail_idx, linearized)
        host = wgl.check_calls(seed_model, cs, fail_idx + 1)
        if host.get("valid?") is True:
            return _disagreement_recheck(
                model, e, "window re-search from device seed %d "
                          "linearized through the failure "
                          "(window [%d, %d])"
                          % (seed_i, start_ev, fail_r))
        if host.get("valid?") is False:
            paths.extend(host.get("final-paths", []))
            configs.extend(host.get("configs", []))
    if not paths:
        return _disagreement_recheck(
            model, e, "none of the %d window re-searches from device "
                      "seeds produced a verdict (window [%d, %d])"
                      % (len(seeds), start_ev, fail_r))
    out = {"final-paths": paths[:10], "configs": configs[:10]}
    if start_ev > 0:
        out["final-paths-window"] = [start_ev, fail_r]
    return out


def _frontier_at(e: EncodedHistory, start_ev: int, device=None):
    """The live configurations after return events [0, start_ev) as
    (state, mask_lo, mask_hi) rows, in the reference's order, or None
    when the re-scan overflows: the bitdense scan (sorted by state, then
    mask) for a history that fits it, else the sparse engine's sort-path
    re-scan (its carry order)."""
    if bitdense.fits_bitdense(bitdense.n_states(e), e.n_slots):
        return bitdense.frontier_rows(e, start_ev, device=device)
    return sparse.frontier_at(e, start_ev, device=device)


def _slot_occupants_before(e: EncodedHistory, r_target: int) -> dict:
    """slot -> call id of the snapshot taken just before return event
    r_target — the same walk encode() performs (same heap discipline,
    so slot numbers match the device masks)."""
    import heapq
    events = []
    for c in e.calls:
        events.append((c.invoke_index, 0, c.index))
        if not c.crashed:
            events.append((c.complete_index, 1, c.index))
    events.sort()
    free: list = []
    n_slots = 0
    slot_of: dict = {}
    occ: dict = {}
    r = 0
    for _, kind, cid in events:
        if kind == 0:
            s = heapq.heappop(free) if free else n_slots
            if s == n_slots:
                n_slots += 1
            slot_of[cid] = s
            occ[s] = cid
        else:
            if r == r_target:
                return dict(occ)
            s = slot_of[cid]
            del occ[s]
            heapq.heappush(free, s)
            r += 1
    return dict(occ)


def _window_calls(cs, boundary: int, fail_idx: int, linearized):
    """Calls active in the window (boundary, fail_idx]: drops calls
    fully completed before the boundary and calls the seed already
    linearized; clamps completions past fail_idx to still-open."""
    out = []
    for c in cs:
        if c.invoke_index > fail_idx:
            continue
        if (not c.crashed) and c.complete_index < boundary:
            continue  # returned before the window: effect is in the seed
        if c.index in linearized:
            continue  # already applied in the seed state
        if c.complete_index > fail_idx:
            c2 = Call(c.index, c.process, c.f, c.value, None,
                      c.invoke_index, fail_idx + 1, True)
        else:
            c2 = Call(c.index, c.process, c.f, c.value, c.result,
                      c.invoke_index, c.complete_index, c.crashed)
        out.append(c2)
    for j, c in enumerate(out):
        c.index = j
    return out


def _prefix_calls(cs, fail_idx):
    """Calls restricted to the failing prefix: everything invoked up to
    fail_idx, with completions after it treated as still-open (crashed)."""
    return _window_calls(cs, -1, fail_idx, frozenset())


# ------------------------------------------------ checkpoints and resume

class FrontierCheckpoint:
    """A resumable snapshot of the sparse engine's search: the frontier
    and the scan's carry after `event_index` return events, so that a
    long check that is stopped (a crash, a pre-emption) loses at most
    the chunk of events it was in, and a streaming session resumes a
    longer history from its settled prefix.

    The rows are the canonical (st int32, ml uint32, mh uint32) triple
    whatever row layout the scan ran (`carry` packs them for a packed
    scan, `sparse.carry_fields_np` unpacks them back), so a checkpoint
    resumes a packed search unpacked and the other way round. Saved as
    .npz in the reference's format (`jepsen_tpu.parallel.engine.
    FrontierCheckpoint`), so that either package resumes a checkpoint
    the other wrote: arrays st, ml, mh, live, meta (int64: event_index,
    capacity, ok, fail_r, maxf, steps_n, stepped; a v1 file's six load
    with stepped 0), step_name and history_digest. The digest (of the
    encoded event tables) guards against resuming another history."""

    def __init__(self, event_index: int, capacity: int, step_name: str,
                 history_digest: str, st, ml, mh, live, ok, fail_r,
                 maxf, steps_n, stepped: int = 0):
        self.event_index = int(event_index)
        self.capacity = int(capacity)
        self.step_name = step_name
        self.history_digest = history_digest
        self.st = np.asarray(st)
        self.ml = np.asarray(ml)
        self.mh = np.asarray(mh)
        self.live = np.asarray(live)
        self.ok = bool(ok)
        self.fail_r = int(fail_r)
        self.maxf = int(maxf)
        self.steps_n = int(steps_n)
        self.stepped = int(stepped)

    @classmethod
    def fresh(cls, e: EncodedHistory, capacity: int,
              digest: Optional[str] = None) -> "FrontierCheckpoint":
        """The checkpoint at event 0: one live configuration, the initial
        model state with nothing linearized, at capacity max(64,
        capacity)."""
        N = max(64, capacity)
        cp = cls(0, N, e.step_name,
                 digest if digest is not None else history_digest(e),
                 np.zeros(N, np.int32), np.zeros(N, np.uint32),
                 np.zeros(N, np.uint32), np.arange(N) < 1,
                 True, -1, 1, 0)
        cp.st[0] = e.state0
        return cp

    @classmethod
    def from_carry(cls, fields, capacity: int, step_name: str,
                   digest: str) -> "FrontierCheckpoint":
        """The checkpoint of a scan's carry as `carry_np` reads it: (st,
        ml, mh, live, ok, fail_r, event_index, maxf, steps_n, stepped)."""
        st_, ml, mh, live, ok, fail_r, r_idx, maxf, steps_n, stepped = \
            fields
        return cls(r_idx, capacity, step_name, digest, st_, ml, mh, live,
                   ok, fail_r, maxf, steps_n, stepped)

    def carry(self, device, pack=(), C: int = 0) -> tuple:
        """The scan carry on `device` that resumes from this checkpoint:
        the rows in the (pack, C) layout as int32 lanes (packed here,
        from the canonical triple), then live, ok, fail_r, the event
        index, maxf, steps_n and stepped (int64 scalars)."""
        dev = torch.device(device)
        rows = sparse._rows_from_canonical(pack, C, self.st, self.ml,
                                           self.mh, dev)
        scalars = tuple(torch.tensor(v, dtype=torch.int64, device=dev)
                        for v in (self.fail_r, self.event_index,
                                  self.maxf, self.steps_n, self.stepped))
        return rows + (torch.from_numpy(np.asarray(self.live, bool)
                                        .copy()).to(dev),
                       torch.tensor(self.ok, device=dev)) + scalars

    def grown(self, new_capacity: int) -> "FrontierCheckpoint":
        """The same frontier in a larger capacity (an overflow's
        doubling across a resume)."""
        pad = new_capacity - self.capacity
        if pad < 0:
            raise ValueError(f"cannot shrink a checkpoint from capacity "
                             f"{self.capacity} to {new_capacity}")
        return FrontierCheckpoint(
            self.event_index, new_capacity, self.step_name,
            self.history_digest,
            np.concatenate([self.st, np.zeros(pad, np.int32)]),
            np.concatenate([self.ml, np.zeros(pad, np.uint32)]),
            np.concatenate([self.mh, np.zeros(pad, np.uint32)]),
            np.concatenate([self.live, np.zeros(pad, bool)]),
            self.ok, self.fail_r, self.maxf, self.steps_n, self.stepped)

    def save(self, path: str) -> str:
        """Write the checkpoint to `path` (".npz" appended when it has
        another suffix) and return the path written."""
        if not path.endswith(".npz"):
            path = path + ".npz"
        np.savez_compressed(
            path, st=self.st, ml=self.ml, mh=self.mh, live=self.live,
            meta=np.array([self.event_index, self.capacity,
                           int(self.ok), self.fail_r, self.maxf,
                           self.steps_n, self.stepped], np.int64),
            step_name=np.array(self.step_name),
            history_digest=np.array(self.history_digest))
        return path

    @classmethod
    def load(cls, path: str) -> "FrontierCheckpoint":
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path, allow_pickle=False) as z:
            meta = z["meta"].tolist()
            # a v1 checkpoint has no configs-stepped counter: 6 scalars
            ev, cap, ok, fail_r, maxf, steps_n = meta[:6]
            stepped = meta[6] if len(meta) > 6 else 0
            return cls(ev, cap, str(z["step_name"]),
                       str(z["history_digest"]), z["st"], z["ml"],
                       z["mh"], z["live"], bool(ok), fail_r, maxf,
                       steps_n, stepped)


carry_fields_np = sparse.carry_fields_np


def history_digest(e: EncodedHistory) -> str:
    """The identity of an encoded history that a checkpoint carries: a
    digest of its event tables' bytes and its initial state, equal to
    the reference's for the same encoding."""
    h = hashlib.sha256()
    for a in (e.slot_f, e.slot_a0, e.slot_a1, e.slot_wild, e.slot_occ,
              e.ev_slot):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(str(e.state0).encode())
    return h.hexdigest()[:16]


def check_resume(e: EncodedHistory, resume, digest: str) -> None:
    """Raise ValueError unless checkpoint `resume` is of `e` (its digest)
    and of its model."""
    if resume.history_digest != digest:
        raise ValueError(f"checkpoint is for a different history (digest "
                         f"{resume.history_digest} != {digest})")
    if resume.step_name != e.step_name:
        raise ValueError("checkpoint is for a different model")


class FrontierOverflowError(RuntimeError):
    """The frontier outgrew max_capacity; carries the last checkpoint, for
    the "unknown" result the one-shot check gives."""

    def __init__(self, checkpoint):
        super().__init__(f"frontier overflow at capacity "
                         f"{checkpoint.capacity}")
        self.checkpoint = checkpoint


def advance_checkpoint(e: EncodedHistory, cp, target: int, *, dedupe: str,
                       probe_limit: int, device, max_capacity: int,
                       pack=(), xs=None, smem_budget=None, stats_acc=None):
    """Advance `cp` over return events [cp.event_index, target) of `e`: a
    sparse scan from its carry, run again from `cp` at twice the
    capacity while it overflows. -> (cp2, closure): the route that ran
    last (None when nothing ran). Past `max_capacity` raises
    FrontierOverflowError; a device fault raises with `.checkpoint`, the
    checkpoint in hand. `stats_acc` gets the stats of the scan that
    succeeded. The step of `check_encoded_resumable` and of the
    streaming sessions (`parallel.extend`)."""
    C = e.slot_f.shape[1]
    ss = stats_acc is not None
    closure = None
    while cp.event_index < target and cp.ok:
        lo = cp.event_index
        try:
            if xs is None:
                xs = sparse._xs(e, device)
            sc = sparse._Scan(e, cp.capacity, dedupe, probe_limit, device,
                              smem_budget, xs, pack, stats=ss,
                              carry=cp.carry(device, pack, C))
            closure = sc.closure
            fields, overflow = sc.run_range(lo, target).carry_np()
            ys = (st.trajectories_np(sc.traj[lo:target],
                                     sc.phist[lo:target]) if ss else None)
        except Exception as err:
            # the recovery point of a device fault
            err.checkpoint = cp
            raise
        if overflow:
            if cp.capacity * 2 > max_capacity:
                raise FrontierOverflowError(cp)
            cp = cp.grown(cp.capacity * 2)
            if ss:
                stats_acc.escalations += 1
            continue
        if ss:
            # a scan that overflowed and ran again counts once
            stats_acc.add_chunk(ys, cp.capacity)
        cp = FrontierCheckpoint.from_carry(fields, cp.capacity, e.step_name,
                                           cp.history_digest)
    return cp, closure


def check_encoded_resumable(e: EncodedHistory, capacity: int = 1024,
                            max_capacity: int = 1 << 20,
                            checkpoint_every: int = 256,
                            checkpoint_cb=None,
                            resume: Optional[FrontierCheckpoint] = None,
                            device=None, dedupe: Optional[str] = None,
                            probe_limit: int = 0,
                            search_stats: Optional[bool] = None,
                            config_pack: Optional[bool] = None,
                            smem_budget=None) -> dict:
    """`sparse.check_encoded` in chunks of `checkpoint_every` return
    events, with the reference's result schema: after each chunk the
    carry is read back as a `FrontierCheckpoint` and handed to
    `checkpoint_cb` (for example `cp.save(path)`); `resume` continues
    from one. A chunk that overflows runs again from the checkpoint
    before it at twice the capacity; past `max_capacity` the verdict is
    "unknown" with that checkpoint under "checkpoint". `search_stats`
    counts the successful chunks only. A checkpoint of another history
    (its digest) or another model raises ValueError.

    A device fault is not retried and not resumed on the host: the
    error raised inside a chunk gets `.checkpoint`, the checkpoint
    before the chunk, and surfaces to the caller, who may resume from
    it. `dedupe`, `probe_limit`, `config_pack`, `smem_budget` and
    `device` are `sparse.check_encoded`'s."""
    if e.n_returns == 0:
        return {"valid?": True, "max-frontier": 0, "capacity": 0}
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every={checkpoint_every} must be "
                         f">= 1")
    dev = bitdense.resolve_device(device)
    dedupe = sparse._resolve_dedupe(dedupe)
    probe_limit = sparse._resolve_probe_limit(probe_limit)
    ss = st._resolve_search_stats(search_stats)
    pack_req = sparse._resolve_config_pack(config_pack)
    C = e.slot_f.shape[1]
    pack = sparse.pack_spec_for(e) if pack_req else ()
    digest = history_digest(e)
    if resume is not None:
        check_resume(e, resume, digest)
        cp = resume
    else:
        cp = FrontierCheckpoint.fresh(e, capacity, digest)
    xs = sparse._xs(e, dev)
    R = e.n_returns
    acc = st.SearchStats(dedupe) if ss else None
    t0 = _time.perf_counter()
    closure = None
    while cp.event_index < R and cp.ok:
        try:
            cp, ran = advance_checkpoint(
                e, cp, min(R, cp.event_index + checkpoint_every),
                dedupe=dedupe, probe_limit=probe_limit, device=dev,
                max_capacity=max_capacity, pack=pack, xs=xs,
                smem_budget=smem_budget, stats_acc=acc)
        except FrontierOverflowError as err:
            top = err.checkpoint
            return {"valid?": "unknown", "error": str(err),
                    "capacity": top.capacity,
                    "closure": sparse.route_tag(top.capacity, C, dedupe,
                                                dev, smem_budget, pack),
                    "checkpoint": top}
        closure = ran or closure
        if checkpoint_cb is not None:
            checkpoint_cb(cp)
    out = {"valid?": cp.ok and bool(cp.live.any()),
           "max-frontier": cp.maxf,
           "capacity": cp.capacity,
           "dedupe": dedupe,
           "configs-stepped": cp.stepped,
           # approximate when the capacity grew mid-search: earlier
           # chunks' iterations ran at smaller capacities
           "explored": cp.steps_n * cp.capacity * C}
    out["closure"] = (sparse._closure_tag(closure, dev) if closure
                      else sparse.route_tag(cp.capacity, C, dedupe, dev,
                                            smem_budget, pack))
    if acc is not None:
        out["stats"] = st.finish_stats_block(st.block_of(acc), t0,
                                             _time.perf_counter())
    sparse._tag_config_pack(out, pack, pack_req, C)
    if not out["valid?"]:
        out.update(enc_mod.fail_op_fields(e, cp.fail_r))
    return out


# ----------------------------------------------------- batched (per-key)

def encode_batch(model, histories, pad_slots: Optional[int] = None,
                 encs: Optional[list] = None):
    """Encode many per-key histories to one padded batch (the reference's
    per-key data parallelism, jepsen.independent). -> (encs, xs, state0)
    with xs and state0 as `encode.pad_batch` gives them (numpy)."""
    if encs is None:
        encs = [enc_mod.encode(model, h, pad_slots=pad_slots)
                for h in histories]
    elif pad_slots is not None:
        # a pre-encoded key's slot tables are final: padding them here
        # would hand back a batch narrower than asked for
        if any(e.slot_f.shape[1] != pad_slots for e in encs):
            raise ValueError(
                "encode_batch: pad_slots conflicts with pre-encoded "
                "encs whose slot tables are at a different width (their "
                "tables are already final) — re-encode with pad_slots")
    xs, state0, _, _, _ = enc_mod.pad_batch(encs)
    return encs, xs, state0


def _resolve_bucket(bucket: Optional[str]) -> str:
    """"tier" (default) or "exact"; None reads JEPSEN_TPU_TORCH_BUCKET.
    A value outside those raises, on an empty batch too."""
    if bucket is None:
        raw = os.environ.get("JEPSEN_TPU_TORCH_BUCKET")
        if raw is None:
            return "tier"
        if raw not in ("tier", "exact"):
            raise ValueError(f"JEPSEN_TPU_TORCH_BUCKET={raw!r}: unknown "
                             f"bucket strategy (expected one of "
                             f"('tier', 'exact'))")
        return raw
    if bucket not in ("tier", "exact"):
        raise ValueError(f"unknown bucket strategy {bucket!r}")
    return bucket


def _resolve_steal(steal: Optional[bool]) -> bool:
    """Whether the batch runs under the work-stealing scheduler
    (`parallel.elastic`): an explicit argument wins, else the strict
    JEPSEN_TPU_TORCH_STEAL flag ("1" on, "0" or unset off)."""
    if steal is None:
        steal = envflags.env_bool("JEPSEN_TPU_TORCH_STEAL", default=False)
    return bool(steal)


def _resolve_reshard(reshard: Optional[bool]) -> bool:
    """Whether the sharded engine answers an overflow by recruiting
    ranks (`sharded.check_encoded_sharded_elastic`): an explicit argument
    wins, else the strict JEPSEN_TPU_TORCH_RESHARD flag."""
    if reshard is None:
        reshard = envflags.env_bool("JEPSEN_TPU_TORCH_RESHARD",
                                    default=False)
    return bool(reshard)


def _resolve_pipeline(pipeline: Optional[bool]) -> bool:
    """Whether the batch runs through the pipelined executor: an explicit
    argument wins, else JEPSEN_TPU_TORCH_PIPELINE, a strict tri-state:
    unset (or empty) is off, "1" on, "0" off, anything else raises
    ValueError."""
    if pipeline is not None:
        return bool(pipeline)
    raw = os.environ.get("JEPSEN_TPU_TORCH_PIPELINE", "").strip()
    if raw in ("", "0", "1"):
        return raw == "1"
    raise ValueError(f"JEPSEN_TPU_TORCH_PIPELINE={raw!r}: must be '1' "
                     f"(on) or '0' (off); unset it for the default (off)")


def bucket_key(n_slots: int, bucket: str) -> int:
    """The bucket a key with `n_slots` open-call slots lands in: "exact"
    one bucket per slot count (floored at the dense engine's C = 5),
    "tier" power-of-two slot-window tiers (at least 4), so that one wide
    key does not pad every narrow key to its mask space."""
    if bucket == "exact":
        return max(5, n_slots)
    return 1 << max(2, (max(1, n_slots) - 1).bit_length())


def check_batch(model, histories, capacity: int = 512,
                max_capacity: int = 1 << 18, device=None,
                bucket: Optional[str] = None, dedupe: Optional[str] = None,
                pipeline: Optional[bool] = None, cache=None,
                pipeline_stats: Optional[dict] = None,
                steal: Optional[bool] = None,
                config_pack: Optional[bool] = None,
                search_stats: Optional[bool] = None, mesh=None,
                reshard: Optional[bool] = None,
                steal_stats: Optional[dict] = None) -> list:
    """Check many per-key histories, one batched device scan per
    slot-window bucket (`check_batch_encoded`), results in input order.
    `device` None means the card (RuntimeError without one); the tests
    pass "cpu". `capacity`, `max_capacity`, `dedupe` and `config_pack`
    steer the sparse buckets, as the reference's do (a dense bucket
    ignores `config_pack`); an unknown `bucket` or `dedupe`, or a bad
    JEPSEN_TPU_TORCH_CONFIG_PACK or JEPSEN_TPU_TORCH_SEARCH_STATS,
    raises ValueError before the encode, on an empty batch too.
    `search_stats` gives each key's result its own "stats" block, with
    the batch's pad extras.

    `pipeline` (None: the JEPSEN_TPU_TORCH_PIPELINE flag, strict "0"/
    "1", unset off) runs the batch through the pipelined executor
    (`pipeline.check_batch_pipelined`): the encode of one chunk of keys
    overlaps the card's scan of the last, through the encode cache
    (`cache`: an EncodeCache, None the process's, False none), and
    `pipeline_stats`, a dict, gets its per-bucket encode / issue /
    device split. The results are the same either way. Without the
    pipeline, `cache` (other than False) or `pipeline_stats` raises
    ValueError, as the reference's serial path does.

    `mesh`, a `torch.distributed` DeviceMesh, shards the key axis over
    its ranks (every rank of it calls check_batch with the same
    arguments and gets the same results; `device` is then the mesh's)
    and gives a key past the batch's ceiling the sharded escalation
    rung over it (`_escalate_overflow`). `steal` (None: the strict
    JEPSEN_TPU_TORCH_STEAL flag) runs each bucket in rounds under the
    work-stealing scheduler (`elastic.check_batch_stealing`), whose
    accounting `steal_stats`, a dict, receives; without stealing
    `steal_stats` raises ValueError. `reshard` (None:
    JEPSEN_TPU_TORCH_RESHARD) makes the sharded rung recruit ranks
    before it grows its tables. The results are the same every way."""
    bucket = _resolve_bucket(bucket)   # fail fast: before the encode
    dedupe = sparse._resolve_dedupe(dedupe)   # likewise
    config_pack = sparse._resolve_config_pack(config_pack)   # likewise
    search_stats = st._resolve_search_stats(search_stats)    # likewise
    _check_mesh(mesh)
    run_steal = _resolve_steal(steal)
    if _resolve_pipeline(pipeline):
        from jepsen_tpu_torch.parallel import pipeline as pipe_mod
        return pipe_mod.check_batch_pipelined(
            model, histories, capacity=capacity,
            max_capacity=max_capacity, mesh=mesh, bucket=bucket,
            cache=cache, stats=pipeline_stats, dedupe=dedupe,
            search_stats=search_stats, config_pack=config_pack,
            steal=run_steal, reshard=reshard, steal_stats=steal_stats,
            device=device)
    if (cache is not None and cache is not False) \
            or pipeline_stats is not None:
        # the serial path reads no cache and fills no stats: the caller
        # wanted the pipelined executor, and must say so
        raise ValueError(
            "check_batch: cache/pipeline_stats are pipelined-executor "
            "arguments — pass pipeline=True (or set "
            "JEPSEN_TPU_TORCH_PIPELINE=1) to use them")
    if steal_stats is not None and not run_steal:
        # the static path runs no scheduler and would leave the dict
        # empty while the caller believes stealing was measured
        raise ValueError(
            "check_batch: steal_stats is an elastic-executor argument — "
            "pass steal=True (or set JEPSEN_TPU_TORCH_STEAL=1) to use it")
    with obs.span("engine.check_batch", keys=len(histories),
                  bucket=bucket), obs.maybe_torch_profile():
        with obs.span("engine.encode_batch", keys=len(histories)):
            pre = [enc_mod.encode(model, h) for h in histories]
        if run_steal:
            from jepsen_tpu_torch.parallel import elastic
            return elastic.check_batch_stealing(
                model, pre, capacity=capacity, max_capacity=max_capacity,
                mesh=mesh, bucket=bucket, dedupe=dedupe,
                search_stats=search_stats, config_pack=config_pack,
                reshard=reshard, stats=steal_stats, device=device)
        return check_batch_encoded(model, pre, capacity=capacity,
                                   max_capacity=max_capacity,
                                   device=device, bucket=bucket,
                                   dedupe=dedupe, config_pack=config_pack,
                                   search_stats=search_stats, mesh=mesh,
                                   reshard=reshard)


def _check_mesh(mesh) -> None:
    """A mesh is a torch.distributed DeviceMesh (or None)."""
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh: a torch.distributed DeviceMesh, not "
                            f"{type(mesh).__name__}")


def batch_device(device, mesh):
    """The device a batch runs on: the mesh's when there is one (this
    rank's card, or the CPU), else `device` (None: the card)."""
    if mesh is None:
        return bitdense.resolve_device(device)
    from jepsen_tpu_torch.parallel.meshplan import MeshPlan
    return MeshPlan.flat(mesh).device


def check_batch_encoded(model, pre, capacity: int = 512,
                        max_capacity: int = 1 << 18, device=None,
                        bucket: Optional[str] = None,
                        dedupe: Optional[str] = None,
                        config_pack: Optional[bool] = None,
                        search_stats: Optional[bool] = None, mesh=None,
                        reshard: Optional[bool] = None) -> list:
    """check_batch on already-encoded keys: bucket them by slot window
    (`bucket_key`), check each bucket whose padded dims fit the dense
    engine (`bitdense.fits_bitdense(S_max, C_max)`) in one batched dense
    scan and every other bucket in the sparse batch
    (`_check_batch_sparse`), and return the results in `pre`'s order.
    With `mesh` each bucket's keys are sharded over its ranks, as
    `check_batch`'s docstring says."""
    bucket = _resolve_bucket(bucket)
    dedupe = sparse._resolve_dedupe(dedupe)
    config_pack = sparse._resolve_config_pack(config_pack)
    search_stats = st._resolve_search_stats(search_stats)
    _check_mesh(mesh)
    if not pre:
        return []
    dev = batch_device(device, mesh)
    out: list = [None] * len(pre)
    buckets: dict = {}
    for i, e in enumerate(pre):
        buckets.setdefault(bucket_key(e.n_slots, bucket), []).append(i)
    for tier in sorted(buckets):
        idxs = buckets[tier]
        sub = [pre[i] for i in idxs]
        S_max = max(bitdense.n_states(e) for e in sub)
        C_max = max(e.n_slots for e in sub)
        if bitdense.fits_bitdense(S_max, C_max):
            rs = bitdense.check_batch_bitdense(sub, device=dev,
                                               search_stats=search_stats,
                                               mesh=mesh)
        else:
            rs = _check_batch_sparse(sub, capacity, max_capacity,
                                     dedupe=dedupe, device=dev,
                                     config_pack=config_pack,
                                     search_stats=search_stats, mesh=mesh,
                                     reshard=reshard)
        for i, r in zip(idxs, rs):
            out[i] = r
    return out


def _check_batch_sparse(pre, capacity: int, max_capacity: int,
                        dedupe: Optional[str] = None, device=None,
                        smem_budget=None,
                        config_pack: Optional[bool] = None,
                        search_stats: Optional[bool] = None, mesh=None,
                        reshard: Optional[bool] = None, pad=None,
                        pack=None, ranks=None) -> list:
    """The sparse batch with per-key capacity retry
    (`sparse.check_batch_sparse`), its keys past `max_capacity` escalated
    one by one (`_escalate_overflow`), the packing and stats requests
    with them. `smem_budget` is the test seam of the closure's route, in
    the batch and in the escalation. With `mesh` the keys are sharded
    over its ranks and the escalation runs on every rank together, with
    the sharded rung over the mesh; `pad`, `pack` and `ranks` are
    `sparse.check_batch_sparse`'s (the stealing rounds')."""
    dev = batch_device(device, mesh)
    dedupe = sparse._resolve_dedupe(dedupe)
    config_pack = sparse._resolve_config_pack(config_pack)
    search_stats = st._resolve_search_stats(search_stats)

    def escalate(e, batch_cap):
        return _escalate_overflow(e, batch_cap, device=dev, dedupe=dedupe,
                                  smem_budget=smem_budget,
                                  config_pack=config_pack,
                                  search_stats=search_stats, mesh=mesh,
                                  reshard=reshard)

    return sparse.check_batch_sparse(pre, capacity, max_capacity,
                                     dedupe=dedupe, device=dev,
                                     smem_budget=smem_budget,
                                     escalate=escalate,
                                     config_pack=config_pack,
                                     search_stats=search_stats, mesh=mesh,
                                     pad=pad, pack=pack, ranks=ranks)


def _escalate_overflow(e: EncodedHistory, batch_cap: int, device=None,
                       dedupe: str = "hash", smem_budget=None,
                       config_pack: bool = False,
                       search_stats: bool = False, mesh=None,
                       reshard: Optional[bool] = None) -> dict:
    """A key too wide for the batch escalates instead of dying as
    "unknown" (the reference's `_escalate_overflow_impl`). First rung:
    the single-key sparse engine on the batch's own device, from 2x the
    batch's ceiling up to 4x it (at most 2^21), with the batch's packing
    and stats requests (the key's own `pack_spec_for` decides its
    layout). Second rung, with a `mesh` whose ceiling min(batch_cap * 4
    * ranks, 2^24) passes the single rung's: the frontier-sharded engine
    over the mesh from min(batch_cap * 8, that ceiling), with `reshard`
    (its elastic ladder). A decided key is tagged "escalated": "single"
    or "sharded"; one neither decides keeps the last rung's "unknown"
    result with the reference's error. With a mesh every rank escalates
    the same key at once (the sharded rung is a collective), each
    running the single rung on its own device.

    A sharded rung that raises leaves the key "unknown" with
    "escalation-error", a warning and the `engine.escalation_errors`
    counter, as the reference's does: no other engine gives the key a
    verdict."""
    obs.counter("engine.capacity_escalations").inc()
    ceil_single = min(batch_cap * 4, 1 << 21)
    r = sparse.check_encoded(e, capacity=min(batch_cap * 2, ceil_single),
                             max_capacity=ceil_single, device=device,
                             dedupe=dedupe, smem_budget=smem_budget,
                             config_pack=config_pack,
                             search_stats=search_stats)
    if r["valid?"] != "unknown":
        r["escalated"] = "single"
        return r
    n_dev = 0 if mesh is None else mesh.size()
    if mesh is not None and min(batch_cap * 4 * n_dev, 1 << 24) \
            > ceil_single:
        ceil_sharded = min(batch_cap * 4 * n_dev, 1 << 24)
        try:
            from jepsen_tpu_torch.parallel import sharded
            rs = sharded.check_encoded_sharded(
                e, mesh, capacity=min(batch_cap * 8, ceil_sharded),
                max_capacity=ceil_sharded, dedupe=dedupe,
                search_stats=search_stats, config_pack=config_pack,
                reshard=reshard)
            if rs["valid?"] != "unknown":
                rs["escalated"] = "sharded"
                return rs
            r = rs
        except Exception as err:  # noqa: BLE001 — the reference's rule
            obs.counter("engine.escalation_errors").inc()
            _log.warning("sharded escalation tier crashed (%r) — key left "
                         "unknown; this may hide a sharded-engine "
                         "regression", err)
            r = dict(r)
            r["escalation-error"] = repr(err)
    r["error"] = (f"frontier overflow: batch capacity {batch_cap}, "
                  f"escalation tiers exhausted ({r.get('error')})")
    return r
