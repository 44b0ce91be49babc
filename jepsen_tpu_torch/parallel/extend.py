"""Streaming checks: append ops to a checked history and resume the
search from its settled prefix.

A port of `jepsen_tpu.parallel.extend`. A Jepsen test that is still
running hands its per-key history over in deltas; each delta's verdict
must equal a one-shot check of the current prefix, without searching
the settled prefix again. Three facts allow it:

  1. The sparse scan's carry after return event r depends only on rows
     [0, r] of the encoded event tables. Where those rows are the same
     in the old and the extended encode, a `FrontierCheckpoint` taken at
     r resumes the extended search exactly (`settled_events` is the
     array comparison that says how far).
  2. Appending ops changes rows only from the first return event after
     a still-open invocation (a completion tightens an observed value,
     or un-prunes a crashed call); `stable_events` finds that boundary
     from the op stream, so each scan leaves a checkpoint the next delta
     can resume from.
  3. Linearizability is prefix-closed: an invalid prefix stays invalid
     under any extension, so an early counterexample is final.

`HistorySession` is one key's state; `extend_encoded` the functional
core; `advance_sessions` runs the pending scans of shape-compatible
sessions as one batched scan a leg (`sparse._BatchScan` from each key's
own carry: batched K2, or the tiled closure around batched K4, past
K2's gate).

Telemetry, the reference's sites: the `stream.encode`, `stream.check`,
`stream.host_check` and `stream.batch_scan` spans; the `stream.*`
counters (host-only keys, rescans, resumed events, thaw rescans,
migrated and batched keys) and `engine.configs_stepped` and
`capacity_escalations`; a check's stats leg goes to the registry and the
counter tracks, its lifetime block to the run's search-stats record.

Not ported: the reference's decision ledger and strategy planner, and
the degradation of a device
fault to a host resume: a fault surfaces to the caller, the error
carrying `.checkpoint`, and the session keeps its checkpoint for the
next check. A delta the encoder cannot take (EncodeError) moves the key
to the host WGL engine for good, as `engine.analysis` does. The
reference pads chunks to an event quantum for its jit cache; the port
has no compiled shapes to share and runs each chunk's real rows (the
batched leg pads to its longest member).
"""

from __future__ import annotations

import bisect
import logging
from time import perf_counter
from typing import Optional

import numpy as np
import torch

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checker import wgl
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import bitdense, engine, sparse
from jepsen_tpu_torch.parallel import encode as enc_mod
from jepsen_tpu_torch.parallel import search_stats as st
from jepsen_tpu_torch.parallel.encode import EncodedHistory, EncodeError

_log = logging.getLogger(__name__)

# the op types a delta may carry
TYPES = ("invoke", "ok", "fail", "info")


# the frontier outgrew max_capacity (the error carries its checkpoint)
FrontierOverflowError = engine.FrontierOverflowError


# ------------------------------------------------------------ settling

def _pad_cols(a, C: int, fill):
    if a.shape[1] == C:
        return a
    out = np.full((a.shape[0], C), fill, a.dtype)
    out[:, : a.shape[1]] = a
    return out


def settled_events(old: Optional[EncodedHistory],
                   new: EncodedHistory) -> int:
    """The number of leading return events whose encoded rows are the
    same in `old` and `new`: how far a checkpoint taken against `old`
    may resume a search over `new`. A wider slot window is fine (the
    extra columns are empty); another model or initial state settles
    nothing."""
    if old is None or old.step_name != new.step_name \
            or old.state0 != new.state0:
        return 0
    R = min(old.n_returns, new.n_returns)
    if R == 0:
        return 0
    C = max(old.slot_f.shape[1], new.slot_f.shape[1])
    same = np.ones(R, bool)
    for attr, fill in (("slot_f", -1), ("slot_a0", -1), ("slot_a1", -1),
                       ("slot_wild", False), ("slot_occ", False)):
        a = _pad_cols(getattr(old, attr)[:R], C, fill)
        b = _pad_cols(getattr(new, attr)[:R], C, fill)
        same &= (a == b).all(axis=1)
    same &= old.ev_slot[:R] == new.ev_slot[:R]
    if same.all():
        return R
    return int(np.argmin(same))


def stable_events(ops, e: Optional[EncodedHistory]) -> int:
    """The boundary no future append can move: the largest r such that
    rows [0, r) of the current encode never change, whatever ops come.
    Future ops only complete invocations open now (or add calls whose
    rows lie past the tail), and a completion perturbs rows only from
    the first return event after its invocation."""
    if e is None:
        return 0
    open_at: dict = {}
    for i, o in enumerate(ops):
        p = o.get("process")
        if not isinstance(p, int):
            continue
        t = o.get("type")
        if t == "invoke":
            open_at[p] = i
        elif t in ("ok", "fail", "info"):
            # every completion is final: ok/fail fix the packing, info
            # leaves the call crashed for good
            open_at.pop(p, None)
    if not open_at:
        return e.n_returns
    completes = sorted(c.complete_index for c in e.calls if not c.crashed)
    return bisect.bisect_left(completes, min(open_at.values()))


def _restamp(cp, digest: str):
    """A checkpoint bound to an extended history whose settled prefix it
    covers (`settled_events` is the caller's proof): the same frontier
    under the new digest."""
    return engine.FrontierCheckpoint(
        cp.event_index, cp.capacity, cp.step_name, digest,
        cp.st, cp.ml, cp.mh, cp.live, cp.ok, cp.fail_r, cp.maxf,
        cp.steps_n, cp.stepped)


def extend_encoded(model, old_e: Optional[EncodedHistory], ops, new_ops,
                   pad_slots: Optional[int] = None):
    """Re-encode `ops + new_ops` (`prepare_encode`, `finish_encode`) and
    say how much of `old_e` the new encode settles: -> (new_e,
    n_settled), rows [0, n_settled) the same as `old_e`'s. Raises
    EncodeError where `encode` does."""
    full = list(ops) + list(new_ops)
    prep = enc_mod.prepare_encode(model, History.wrap(full))
    new_e = enc_mod.finish_encode(prep, pad_slots)
    return new_e, settled_events(old_e, new_e)


# ------------------------------------------------------------ scanning

def _xs_slice(e: EncodedHistory, lo: int, hi: int, R_pad: int,
              C_pad: int) -> dict:
    """Event rows [lo, hi) as an (R_pad, C_pad) chunk of numpy tables;
    pad rows return on slot -1 with empty slots, which a scan skips
    without advancing its event index."""
    n = hi - lo
    out = {}
    for attr, fill in (("slot_f", -1), ("slot_a0", -1), ("slot_a1", -1),
                       ("slot_wild", False), ("slot_occ", False)):
        a = getattr(e, attr)
        buf = np.full((R_pad, C_pad), fill, a.dtype)
        buf[:n, : a.shape[1]] = a[lo:hi]
        out[attr] = buf
    ev = np.full(R_pad, -1, np.int32)
    ev[:n] = e.ev_slot[lo:hi]
    out["ev_slot"] = ev
    return out


# ------------------------------------------------------------- session

class HistorySession:
    """One key's streaming check: the op stream so far, its encode, and
    the checkpoints from which each delta's check resumes.

    After any sequence of `extend` calls, `check` gives the verdict,
    counterexample fields, max-frontier and configs-stepped of the
    one-shot `sparse.check_encoded(encode(model, ops))` with the same
    dedupe: feeding deltas saves work and changes no result. An invalid
    verdict is an early counterexample, and final. `device` None means
    the card (RuntimeError without one). `smem_budget` is the test seam
    of the closure's route. Not thread-safe: its caller serialises the
    calls of one key."""

    def __init__(self, model, *, capacity: int = 1024,
                 max_capacity: int = 1 << 20, dedupe: Optional[str] = None,
                 probe_limit: int = 0, device=None, key=None,
                 search_stats: Optional[bool] = None,
                 config_pack: Optional[bool] = None, smem_budget=None):
        self.model = model
        self.key = key
        self.ops: list = []
        self.enc: Optional[EncodedHistory] = None
        self.dedupe = sparse._resolve_dedupe(dedupe)
        self.probe_limit = sparse._resolve_probe_limit(probe_limit)
        self.search_stats = st._resolve_search_stats(search_stats)
        # the packing request; the layout itself follows each scan's
        # encode, since a delta can widen the slot window
        self.config_pack = sparse._resolve_config_pack(config_pack)
        self.smem_budget = smem_budget
        # lifetime stats over every delta's legs; _leg_acc is the check
        # in flight's, spliced in by _finish at _leg_ev0. Not kept by
        # freeze/thaw: a thawed key's stats start again.
        self._stats_acc = (st.SearchStats(self.dedupe)
                           if self.search_stats else None)
        self._leg_acc = None
        self._leg_ev0 = 0
        self._leg_t0 = 0.0
        self.device = bitdense.resolve_device(device)
        self.capacity = max(64, capacity)
        self.max_capacity = max_capacity
        self.host_only: Optional[str] = None   # the EncodeError's text
        self.finalized = False
        self._cp = None          # the next scan's resume point
        self._cp_stable = None   # kept at the stable boundary
        self._cp_tail = None     # kept at the last scanned event
        self._scan_cp = None     # the cursor of a batched advance
        self._stable_ev = 0
        self._digest = None
        self._dirty = False
        self._last_result = None

    # -- introspection

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    @property
    def n_returns(self) -> int:
        return 0 if self.enc is None else self.enc.n_returns

    @property
    def resume_event(self) -> int:
        """Where the next scan resumes (0: from scratch)."""
        return self._cp.event_index if self._cp is not None else 0

    # -- extension

    def extend(self, new_ops) -> None:
        """Append a delta of invoke/ok/fail/info ops and re-encode: host
        work only, the scan waits for the next `check` or
        `advance_sessions`. A malformed delta raises ValueError before
        any state changes."""
        if self.finalized:
            raise RuntimeError("session is finalized; no more deltas")
        new_ops = list(new_ops)
        for o in new_ops:
            t = o.get("type") if hasattr(o, "get") else None
            if t not in TYPES:
                raise ValueError(
                    f"delta op {o!r}: type must be one of {TYPES}")
        self.ops.extend(new_ops)
        self._dirty = True
        if self.host_only is not None:
            return    # once unpackable, always checked on the host
        old_e = self.enc
        try:
            with obs.span("stream.encode", key=self.key,
                          ops=len(self.ops)):
                self.enc = enc_mod.encode(self.model,
                                          History.wrap(self.ops))
        except EncodeError as err:
            # as engine.analysis: not device-checkable goes to the host
            # WGL engine, and stays there (the window that overflowed
            # is history)
            self.host_only = str(err)
            self.enc = None
            self._cp = self._cp_stable = self._cp_tail = None
            obs.counter("stream.host_only_keys").inc()
            return
        if self.enc.n_returns == 0:
            self._cp = self._cp_stable = self._cp_tail = None
            self._stable_ev = 0
            return
        settled = settled_events(old_e, self.enc)
        self._digest = engine.history_digest(self.enc)
        self._stable_ev = stable_events(self.ops, self.enc)
        best = None
        for cp in (self._cp_tail, self._cp_stable, self._cp):
            if cp is not None and cp.event_index <= settled \
                    and (best is None or cp.event_index > best.event_index):
                best = cp
        if best is None:
            if self._cp_tail is not None or self._cp_stable is not None:
                # the delta changed rows below every kept checkpoint (the
                # packing moved as a whole): scan from scratch
                _log.info("key %r: delta unsettled every checkpoint; "
                          "rescanning from event 0", self.key)
                obs.counter("stream.rescans").inc()
            self._cp = None
        else:
            self._cp = _restamp(best, self._digest)
            obs.counter("stream.resumed_events").inc(best.event_index)
        self._cp_stable = self._cp_tail = None

    # -- checking

    def _fresh_cp(self):
        return engine.FrontierCheckpoint.fresh(self.enc, self.capacity,
                                               self._digest)

    def _host_check(self) -> dict:
        with obs.span("stream.host_check", key=self.key):
            r = wgl.analysis(self.model, History.wrap(self.ops))
        r["fallback"] = self.host_only
        self._last_result = dict(r)
        self._dirty = False
        return r

    def _result_from(self, cp, closure, resume_ev: int, pack=None,
                     pack_C: Optional[int] = None) -> dict:
        e = self.enc
        if pack is None:
            pack_C = e.slot_f.shape[1]
            pack = sparse.pack_spec_for(e, pack_C) if self.config_pack \
                else ()
        out = {"valid?": cp.ok and bool(np.asarray(cp.live).any()),
               "max-frontier": cp.maxf,
               "capacity": cp.capacity,
               "dedupe": self.dedupe,
               "configs-stepped": cp.stepped,
               "explored": cp.steps_n * cp.capacity * e.slot_f.shape[1],
               # the route of the last leg that ran, else of a scan here
               "closure": (sparse._closure_tag(closure, self.device)
                           if closure else sparse.route_tag(
                               cp.capacity, e.slot_f.shape[1], self.dedupe,
                               self.device, self.smem_budget, pack)),
               "stream": {"resumed-from-event": resume_ev,
                          "events": e.n_returns}}
        # the layout that ran: a batched leg passes its group's layout
        sparse._tag_config_pack(out, pack, self.config_pack, pack_C)
        if not out["valid?"]:
            out.update(enc_mod.fail_op_fields(e, cp.fail_r))
        return out

    def _leg_stats(self, ev0: int):
        """The stats accumulator of the check in flight (made at its
        first use, so that a batched advance's legs and a solo fallback
        share one; `ev0` is where its events start), or None with stats
        off."""
        if not self.search_stats:
            return None
        if self._leg_acc is None:
            self._leg_acc = st.SearchStats(self.dedupe)
            self._leg_ev0 = ev0
            self._leg_t0 = perf_counter()
        return self._leg_acc

    def _finish(self, tcp, closure, resume_ev: int, pack=None,
                pack_C: Optional[int] = None) -> dict:
        """What `check` and `advance_sessions` share once the tail leg's
        carry is in hand."""
        resume_stepped = self._cp.stepped if self._cp is not None else 0
        obs.counter("engine.configs_stepped").inc(
            max(0, tcp.stepped - resume_stepped))
        self.capacity = max(self.capacity, tcp.capacity)
        self._cp = self._cp_stable or tcp
        r = self._result_from(tcp, closure, resume_ev, pack, pack_C)
        if self._stats_acc is not None and self._leg_acc is not None:
            # the registry and the counter tracks get this check's leg
            # only (a stream republishing its lifetime totals every
            # delta would inflate every counter); the result and the
            # run's record carry the lifetime stats: the leg replaces
            # the re-opened tail from its first event, so they are a
            # one-shot check's of the prefix
            leg_block = st.block_of(self._leg_acc, engine="stream")
            st._publish_search_stats(leg_block)
            st._emit_stats_tracks(leg_block, self._leg_t0, perf_counter())
            self._stats_acc.splice(self._leg_ev0, self._leg_acc)
            block = st.block_of(self._stats_acc, engine="stream")
            block["resumed-from-event"] = resume_ev
            st.record_stats_block(block, self.key)
            r["stats"] = block
            self._leg_acc = None
        self._last_result = dict(r)
        self._dirty = False
        return r

    def _overflow_result(self, err: FrontierOverflowError) -> dict:
        self._leg_acc = None   # no stats for an undecided check
        cp = err.checkpoint
        r = {"valid?": "unknown",
             "error": f"frontier overflow at capacity {cp.capacity}",
             "capacity": cp.capacity, "dedupe": self.dedupe,
             "checkpoint": cp}
        self._last_result = dict(r)
        self._dirty = False
        return r

    def _advance(self, cp, target: int):
        e = self.enc
        # the layout follows the current encode (a delta that widens the
        # slot window moves the packed bits; the checkpoints are canonical)
        pack = (sparse.pack_spec_for(e, e.slot_f.shape[1])
                if self.config_pack else ())
        top = cp
        try:
            top, closure = engine.advance_checkpoint(
                e, cp, target, dedupe=self.dedupe,
                probe_limit=self.probe_limit, device=self.device,
                max_capacity=self.max_capacity, pack=pack,
                smem_budget=self.smem_budget,
                stats_acc=self._leg_stats(cp.event_index))
            return top, closure
        except Exception as err:
            top = getattr(err, "checkpoint", top)
            raise
        finally:
            # the reference counts the stream's capacity doublings (the
            # resumable check's it does not): the checkpoint in hand,
            # returned or raised with, says how many there were
            n = (int(top.capacity).bit_length()
                 - int(cp.capacity).bit_length())
            if n:
                obs.counter("engine.capacity_escalations").inc(n)

    def check(self) -> dict:
        """The current prefix's verdict, equal (verdict, op/fail-event,
        max-frontier, configs-stepped) to a one-shot check of it. Scans
        only [resume_event, R), and keeps checkpoints at the stable
        boundary and at the tail, so that the next delta resumes as far
        forward as its content allows. A device fault raises, with
        `.checkpoint` the checkpoint before the chunk it hit; the
        session's next check resumes from where this one started."""
        if self.host_only is not None:
            if not self._dirty and self._last_result is not None:
                return dict(self._last_result)
            return self._host_check()
        if self.enc is None or self.enc.n_returns == 0:
            r = {"valid?": True, "max-frontier": 0, "capacity": 0}
            self._last_result = dict(r)
            self._dirty = False
            return r
        if not self._dirty and self._last_result is not None:
            return dict(self._last_result)
        cp = self._cp if self._cp is not None else self._fresh_cp()
        resume_ev = cp.event_index
        self._leg_stats(resume_ev)
        R = self.enc.n_returns
        stable = max(self._stable_ev, cp.event_index)
        closure = None
        with obs.span("stream.check", key=self.key, returns=R,
                      resume=resume_ev):
            try:
                if cp.ok and cp.event_index < stable:
                    cp, closure = self._advance(cp, stable)
                self._cp_stable = cp
                tcp = cp
                if tcp.ok and tcp.event_index < R:
                    tcp, c2 = self._advance(tcp, R)
                    closure = c2 or closure
                self._cp_tail = tcp
            except FrontierOverflowError as err:
                return self._overflow_result(err)
            except Exception:
                self._abandon()
                raise
        return self._finish(tcp, closure, resume_ev)

    def _abandon(self) -> None:
        """After a device fault: the next check resumes from the
        checkpoint this one started from (the error carries the chunk's
        own as `.checkpoint`), and no partial leg counts in the stats."""
        self._leg_acc = None
        self._cp_stable = self._cp_tail = None

    def finalize(self, final_paths: bool = True) -> dict:
        """Mark the stream complete and return the final verdict, the
        one-shot check's of the whole history; with `final_paths` an
        invalid verdict also gets the counterexample paths
        (`engine.apply_final_paths`, as `engine.analysis` gives them)."""
        r = self.check()
        if final_paths and r.get("valid?") is False \
                and self.enc is not None and "final-paths" not in r:
            engine.apply_final_paths(r, self.model, self.enc,
                                     device=self.device)
            self._last_result = dict(r)
        self.finalized = True
        return r

    # -- eviction

    def freeze(self, path: str) -> dict:
        """Save the furthest resume checkpoint to `path` (.npz) and
        return what `thaw` needs besides the op stream, which the caller
        keeps."""
        best = None
        for cp in (self._cp_tail, self._cp_stable, self._cp):
            if cp is not None and (best is None
                                   or cp.event_index > best.event_index):
                best = cp
        meta = {"n_ops": len(self.ops), "capacity": self.capacity,
                "host_only": self.host_only, "finalized": self.finalized,
                "checkpoint": None}
        if best is not None:
            meta["checkpoint"] = best.save(path)
            meta["event_index"] = best.event_index
            meta["digest"] = best.history_digest
        return meta

    def thaw(self, ops, cp) -> None:
        """Restore a frozen session into a fresh one: the whole op stream
        and the frozen checkpoint. The re-encode is deterministic, so the
        checkpoint's digest must be the re-encoded history's; where it
        is not, the key is scanned again from scratch, never from a
        stale frontier."""
        if self.ops:
            raise RuntimeError("thaw into a fresh session only")
        self.extend(ops)
        if cp is None or self.host_only is not None or self.enc is None:
            return
        if cp.history_digest == self._digest \
                and cp.step_name == self.enc.step_name \
                and cp.event_index <= self.enc.n_returns:
            self._cp = cp
            self.capacity = max(self.capacity, cp.capacity)
        else:
            obs.counter("stream.thaw_rescans").inc()
            _log.warning(
                "thawed checkpoint does not match the replayed history "
                "(digest or model) — rescanning key %r from scratch",
                self.key)

    def migrate(self, device) -> None:
        """Move the session's search to `device`: its checkpoints are
        host arrays, so the next scan's carry lands there."""
        device = bitdense.resolve_device(device)
        if device == self.device:
            return
        self.device = device
        obs.counter("stream.migrated_keys").inc()


# ----------------------------------------------- cross-key batching

def _stack_carries(cps, device, pack=(), C: int = 0) -> tuple:
    """K checkpoints' carries stacked on `device`, as `sparse._BatchScan`
    takes them: row lanes and live [K, N], the rest [K] int64."""
    rows = sparse._rows_from_canonical(
        pack, C, *(np.stack([getattr(c, f) for c in cps])
                   for f in ("st", "ml", "mh")), device)
    live = torch.from_numpy(np.stack([np.asarray(c.live, bool)
                                      for c in cps])).to(device)
    ok = torch.tensor([c.ok for c in cps], device=device)
    rest = tuple(torch.tensor([getattr(c, f) for c in cps],
                              dtype=torch.int64, device=device)
                 for f in ("fail_r", "event_index", "maxf", "steps_n",
                           "stepped"))
    return rows + (live, ok) + rest


def _batch_leg(pairs, N: int, C_pad: int, dedupe: str, probe_limit: int,
               device, smem_budget=None, search_stats: bool = False,
               pack: tuple = ()):
    """One batched leg: advance each (session, target) pair's cursor
    over its own rows [cursor, target) in one `sparse._BatchScan`, the
    chunks padded to the longest. -> (closure, overflowed sessions);
    an overflowed member keeps its cursor (its capacity retry runs on
    its own). With `search_stats` each other member's stats rows feed
    its session's accumulator. `pack` is the group's one layout."""
    R_pad = max(t - s._scan_cp.event_index for s, t in pairs)
    chunks = [_xs_slice(s.enc, s._scan_cp.event_index, t, R_pad, C_pad)
              for s, t in pairs]
    xs = {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
    # `events` is the leg's padded rows: the reference pads them up to
    # its jit cache's event quantum, the port to the longest member
    with obs.span("stream.batch_scan", keys=len(pairs), events=R_pad,
                  capacity=N):
        sc = sparse._BatchScan(
            [s.enc for s, _ in pairs], xs, None, N, dedupe, probe_limit,
            device, smem_budget, pack, stats=search_stats,
            carry=_stack_carries([s._scan_cp for s, _ in pairs], device,
                                 pack, C_pad)).run()
        carries, overflow = sc.carry_np()
    ys = st.trajectories_np(sc.traj, sc.phist) if search_stats else None
    overflowed = []
    for k, (s, _t) in enumerate(pairs):
        if overflow[k]:
            overflowed.append(s)
            continue
        if search_stats:
            s._leg_stats(s._scan_cp.event_index).add_chunk(
                {f: v[k] for f, v in ys.items()}, N)
        s._scan_cp = engine.FrontierCheckpoint.from_carry(
            carries[k], N, s.enc.step_name, s._scan_cp.history_digest)
    return sc.closure, overflowed


def advance_sessions(sessions, bucket: Optional[str] = None) -> list:
    """Run every session's pending scan, batching shape-compatible keys
    (the same model step, capacity, slot-window bucket
    (`engine.bucket_key`), dedupe, probe limit, stats, packing request,
    route seam and device) into one batched scan a leg: first to each
    key's stable boundary, then to its tail. The results equal calling
    `check()` on each session one by one (the batched scan runs each
    key's own rows from its own carry; pads are skipped). A member that
    overflows leaves the group and runs its own `check()`, which owns
    the capacity ladder. A device fault raises; each member keeps the
    checkpoint it started from. Returns the results in `sessions`'
    order."""
    bucket = engine._resolve_bucket(bucket)
    results: dict = {}
    groups: dict = {}
    for s in sessions:
        if id(s) in results:
            continue
        if (s.host_only is not None or s.enc is None
                or s.enc.n_returns == 0
                or (not s._dirty and s._last_result is not None)):
            results[id(s)] = s.check()
            continue
        cp = s._cp if s._cp is not None else s._fresh_cp()
        s._scan_cp = cp
        s._leg_stats(cp.event_index)
        gk = (s.enc.step_name, cp.capacity,
              engine.bucket_key(s.enc.n_slots, bucket), s.dedupe,
              s.probe_limit, s.search_stats, s.config_pack,
              s.smem_budget, str(s.device))
        groups.setdefault(gk, []).append(s)

    for (_step, N, tier, dedupe, probe_limit, search_stats, config_pack,
         smem_budget, _dev), members in groups.items():
        if len(members) == 1:
            s = members[0]
            results[id(s)] = s.check()
            continue
        device = members[0].device
        C_pad = min(enc_mod.MAX_SLOTS,
                    max(tier, max(m.enc.slot_f.shape[1] for m in members)))
        # one layout for the whole group, before any leg
        pack = (sparse.pack_spec_for([m.enc for m in members], C_pad)
                if config_pack else ())
        obs.counter("stream.batched_keys").inc(len(members))
        live = list(members)
        resume = {id(s): s._scan_cp.event_index for s in live}
        closure = None
        try:
            for targets in ("stable", "tail"):
                pairs = []
                for s in live:
                    t = (max(s._stable_ev, s._scan_cp.event_index)
                         if targets == "stable" else s.enc.n_returns)
                    if s._scan_cp.ok and s._scan_cp.event_index < t:
                        pairs.append((s, t))
                if pairs:
                    closure, overflowed = _batch_leg(
                        pairs, N, C_pad, dedupe, probe_limit, device,
                        smem_budget, search_stats=search_stats, pack=pack)
                    for s in overflowed:
                        # the capacity ladder is a key's own: on from
                        # the cursor its earlier legs reached
                        s._cp = s._scan_cp
                        results[id(s)] = s.check()
                    live = [s for s in live if id(s) not in results]
                if targets == "stable":
                    for s in live:
                        s._cp_stable = s._scan_cp
        except Exception:
            for s in live:
                s._abandon()
            raise
        for s in live:
            s._cp_tail = s._scan_cp
            results[id(s)] = s._finish(s._scan_cp, closure, resume[id(s)],
                                       pack=pack, pack_C=C_pad)
    return [results[id(s)] for s in sessions]
