"""Host-side encoding: history -> static event/slot tables for the device.

The JIT-linearization search processes
only **return** events; between two returns the per-config state space is
closed under "linearize any open, unlinearized call". The set of *open*
calls at any moment is determined by the history alone — only *which are
linearized* varies per configuration. So all slot bookkeeping happens
here, once, on the host:

  * every call gets a **window slot** (smallest free at invoke; freed
    after its return filters the frontier; crashed calls hold their slot
    forever),
  * every return event r gets a snapshot of the slot table just before
    it: which slots are occupied and the packed op (f, a0, a1, wild) in
    each.

On device a configuration is then just (state: i32, mask: 2×u32) where
mask bit j = "the call in slot j has linearized" — the fixed-width
replacement for knossos.linear.config's per-config BitSet
(BASELINE.json north_star). Max window = 64 slots; histories needing
more (pathological crash pile-ups) fall back to the host engines
(SURVEY.md §7.3 hard part #1/#4).

A copy of `jepsen_tpu.parallel.encode` without the JAX batch placement
(`place_batch`; `pad_batch` returns numpy tables, which the batched scan
moves to its device once), plus `encoded_from_arrays`, which rebuilds
an `EncodedHistory` from plain arrays so that both engines can be fed
the identical encoded input.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Optional

import numpy as np

from jepsen_tpu_torch import models as model_ns
from jepsen_tpu_torch.history import (
    Call, History, Intern, calls as history_calls, prune_wildcard_calls,
)

MAX_SLOTS = 64


@dataclass
class EncodedHistory:
    """Static device input for one key's history. R return events, C slots."""

    slot_f: np.ndarray      # [R, C] i32, f-code of op in slot (-1 empty)
    slot_a0: np.ndarray     # [R, C] i32
    slot_a1: np.ndarray     # [R, C] i32
    slot_wild: np.ndarray   # [R, C] bool
    slot_occ: np.ndarray    # [R, C] bool
    ev_slot: np.ndarray     # [R] i32, slot of the returning call
    ret_call: np.ndarray    # [R] i32, dense call id returning (reporting)
    state0: int
    step_name: str
    n_calls: int
    n_slots: int            # C actually used (<= MAX_SLOTS)
    calls: list             # surviving Call records (host-side reporting)
    intern: Intern          # value table (host-side reporting)
    state_lo: int = -1      # dense state domain: [state_lo, state_lo + S)
    n_states: int = 0
    spec: object = None     # the *prepared* PackedSpec — models whose
    # packing is history-dependent (gset lanes, queue widths) need this
    # exact instance for unpack_state during counterexample extraction
    model_pruned: bool = False  # the model-specific wildcard prune
    # dropped calls AFTER spec.prepare ran — `calls` then no longer
    # equals the list the spec's lane tables were built from, so a
    # prepare re-run over `calls` may assign different lanes (the
    # encode cache refuses to persist such entries: a disk reload
    # could not rebuild an unpack-correct spec)

    @property
    def n_returns(self) -> int:
        return len(self.ev_slot)


class EncodeError(Exception):
    """History can't go to the device; callers fall back to host engines."""


# fs whose constraint is learned at completion, not invocation — the
# counterexample op should report what the system *returned*
OBSERVED_FS = ("read", "dequeue")


def fail_op_fields(e: "EncodedHistory", r: int) -> dict:
    """The knossos-style counterexample op fields for failing return
    event r — shared by every engine's reporting path."""
    c = e.calls[int(e.ret_call[int(r)])]
    v = c.result if (c.f in OBSERVED_FS and not c.crashed) else c.value
    return {"op": {"process": c.process, "f": c.f, "value": v,
                   "index": c.invoke_index},
            "fail-event": int(r)}


@dataclass
class PreparedHistory:
    """Stage-1 encode output: packed per-call ops + slot assignment —
    everything except the [R, C] snapshot tables. For any history,
    finish_encode(prepare_encode(model, h)) is array-identical to
    encode(model, h)."""

    cs: list
    intern: Intern
    spec: object
    enc_f: np.ndarray       # [n] per-call packed ops (post-prune)
    enc_a0: np.ndarray
    enc_a1: np.ndarray
    enc_wild: np.ndarray
    r_open: np.ndarray      # [n] first snapshot row while open
    r_close: np.ndarray     # [n] last row (own return / end)
    call_slot: np.ndarray   # [n]
    ev_slot: np.ndarray     # [R]
    ret_call: np.ndarray    # [R]
    n_slots: int
    n_returns: int
    model_pruned: bool = False  # see EncodedHistory.model_pruned

    @property
    def n_states(self) -> int:
        return (self.spec.n_states(self.intern) if self.spec.n_states
                else len(self.intern) + 1)


def prepare_encode(model, history, use_bulk: bool = True) -> PreparedHistory:
    """Stage 1 of encode(): pack the calls and assign window slots.

    Raises EncodeError exactly where encode() would (unpackable model,
    prepare budget, > MAX_SLOTS window). `use_bulk=False` forces the
    row-wise encode_call loop even when the spec has a bulk hook —
    both paths must produce identical arrays, including the interning
    order."""
    intern = Intern()
    spec = model_ns.pack_spec(model, intern)
    if spec is None:
        raise EncodeError(f"model {type(model).__name__} is not device-packable")

    h = history if isinstance(history, History) else History.wrap(history)
    cs = prune_wildcard_calls(history_calls(h))
    if spec.prepare is not None:
        spec.prepare(cs, intern)  # may raise EncodeError (host fallback)

    # per-call packed ops as arrays: the bulk hook when the family has
    # one (the per-call Python loop is the measured constant on the
    # batched e2e path), the row-wise loop otherwise
    if use_bulk and spec.encode_calls is not None:
        enc_f, enc_a0, enc_a1, enc_wild = spec.encode_calls(cs)
        enc_f = np.asarray(enc_f, np.int32)
        enc_a0 = np.asarray(enc_a0, np.int32)
        enc_a1 = np.asarray(enc_a1, np.int32)
        enc_wild = np.asarray(enc_wild, bool)
    else:
        packed = [spec.encode_call(c.f, c.value, c.result, c.crashed)
                  for c in cs]
        enc_f = np.fromiter((pk[0] for pk in packed), np.int32, len(packed))
        enc_a0 = np.fromiter((pk[1] for pk in packed), np.int32, len(packed))
        enc_a1 = np.fromiter((pk[2] for pk in packed), np.int32, len(packed))
        enc_wild = np.fromiter((pk[3] for pk in packed), bool, len(packed))

    # Prune crashed calls that pack to wildcards (identity step, always
    # ok, never returns): they may linearize at any point or never, so
    # dropping them is sound — and each one would otherwise double the
    # frontier's mask space forever. prune_wildcard_calls catches
    # crashed *reads* before the model is known; this generalizes to
    # whatever the model family declares unconstrained (e.g. crashed
    # dequeues with unknown results).
    crashed = np.fromiter((c.crashed for c in cs), bool, len(cs))
    drop = crashed & enc_wild
    model_pruned = bool(drop.any())
    if model_pruned:
        keep = ~drop
        cs = [c for c, k in zip(cs, keep) if k]
        enc_f, enc_a0, enc_a1, enc_wild = (
            enc_f[keep], enc_a0[keep], enc_a1[keep], enc_wild[keep])
        for j, c in enumerate(cs):
            c.index = j

    # events in history order; kind 0=invoke first on ties (an invoke at
    # the same index as a return cannot precede it in a real history —
    # indices are unique — so tie order is moot but deterministic)
    events = []
    for c in cs:
        events.append((c.invoke_index, 0, c.index))
        if not c.crashed:
            events.append((c.complete_index, 1, c.index))
    events.sort()

    # Slot assignment: smallest free slot at invoke, freed after the
    # call's own return row (crashed calls hold theirs to the end).
    free: list = []  # min-heap of free slots
    n_slots = 0
    n = len(cs)
    R = sum(1 for _, k, _ in events if k == 1)
    r_open = np.empty(n, np.int32)    # first snapshot row while open
    r_close = np.full(n, R - 1, np.int32)  # last row (own return / end)
    call_slot = np.empty(n, np.int32)
    ev_slot = np.empty(R, np.int32)
    ret_call = np.empty(R, np.int32)

    r = 0
    for _, kind, cid in events:
        if kind == 0:
            s = heapq.heappop(free) if free else n_slots
            if s == n_slots:
                n_slots += 1
                if n_slots > MAX_SLOTS:
                    raise EncodeError(
                        f"open-call window exceeds {MAX_SLOTS} slots "
                        f"(too many concurrent/crashed calls); use the "
                        f"host engine or partition the history per key")
            call_slot[cid] = s
            r_open[cid] = r
        else:
            s = int(call_slot[cid])
            ev_slot[r] = s
            ret_call[r] = cid
            r_close[cid] = r
            r += 1
            heapq.heappush(free, s)

    return PreparedHistory(
        cs=cs, intern=intern, spec=spec,
        enc_f=enc_f, enc_a0=enc_a0, enc_a1=enc_a1, enc_wild=enc_wild,
        r_open=r_open, r_close=r_close, call_slot=call_slot,
        ev_slot=ev_slot, ret_call=ret_call,
        n_slots=n_slots, n_returns=R, model_pruned=model_pruned)


def finish_encode(prep: PreparedHistory,
                  pad_slots: Optional[int] = None) -> EncodedHistory:
    """Stage 2 of encode(): build the per-return snapshot tables by
    INTERVAL FILL — a call occupying slot s appears identically in
    every snapshot row from the first return after its invoke through
    the row of its own return (snapshots are taken just before the
    returning call is removed, so its own row includes it; crashed
    calls stay to the end). One contiguous slice write per
    (call, column) replaces ten full-width numpy ops per return row —
    encode sits on the e2e bench path, so its constant matters."""
    spec, intern, cs = prep.spec, prep.intern, prep.cs
    n, R, n_slots = len(cs), prep.n_returns, prep.n_slots
    # allocate at the FINAL padded width (pad_slots may exceed n_slots)
    C = max(1, min(MAX_SLOTS, max(pad_slots or n_slots, n_slots)))
    slot_f = np.full((R, C), -1, np.int32)
    slot_a0 = np.full((R, C), -1, np.int32)
    slot_a1 = np.full((R, C), -1, np.int32)
    slot_wild = np.zeros((R, C), bool)
    slot_occ = np.zeros((R, C), bool)
    for cid in range(n):
        a, b = int(prep.r_open[cid]), int(prep.r_close[cid])
        if a > b:
            continue  # invoked after the last return: in no snapshot
        s = int(prep.call_slot[cid])
        slot_occ[a:b + 1, s] = True
        slot_f[a:b + 1, s] = prep.enc_f[cid]
        slot_a0[a:b + 1, s] = prep.enc_a0[cid]
        slot_a1[a:b + 1, s] = prep.enc_a1[cid]
        slot_wild[a:b + 1, s] = prep.enc_wild[cid]

    return EncodedHistory(
        slot_f=slot_f, slot_a0=slot_a0, slot_a1=slot_a1,
        slot_wild=slot_wild, slot_occ=slot_occ,
        ev_slot=prep.ev_slot, ret_call=prep.ret_call,
        state0=spec.state0, step_name=spec.step_name,
        n_calls=len(cs), n_slots=n_slots, calls=cs, intern=intern,
        state_lo=spec.state_lo,
        n_states=prep.n_states,
        spec=spec,
        model_pruned=prep.model_pruned,
    )


def encode(model, history, pad_slots: Optional[int] = None,
           use_bulk: bool = True) -> EncodedHistory:
    """Encode (model, history) for the device engine.

    Raises EncodeError if the model isn't packable or the open-call
    window exceeds MAX_SLOTS. This one-shot form is the exact
    composition of prepare_encode and finish_encode."""
    return finish_encode(prepare_encode(model, history, use_bulk=use_bulk),
                         pad_slots)


def place_batch(K: int, mesh, ranks=None) -> list:
    """This rank's keys of a K-key batch sharded over `mesh` (a
    DeviceMesh): the reference places the key axis on the mesh's
    devices; here every rank is a process and takes a contiguous block
    of ceil(K / ranks) keys, a ragged K leaving the last ranks shorter
    blocks. `ranks`, one mesh index per key, places each key instead."""
    from jepsen_tpu_torch.parallel.meshplan import MeshPlan
    return MeshPlan.flat(mesh).keys_of(K, ranks)


def pad_batch(encs: list, min_slots: int = 1, min_states: int = 0,
              min_returns: int = 0, mesh=None, ranks=None):
    """Pad per-key encoded histories to one (K, R, C) batch: the
    reference's `pad_batch` without the mesh placement. `min_slots`,
    `min_states` and `min_returns` floor C, S and R (the dense batch
    passes min_slots=5: one full 32-mask word). Pad slots are empty (f,
    a0, a1 = -1, unoccupied, not wild) and pad events return on slot -1.
    Returns (xs, state0, S, C, R): xs maps each table name to a numpy
    array ([K, R, C], `ev_slot` [K, R]), state0 is int32 [K]. With
    `mesh` the dims are the whole batch's and the arrays those of this
    rank's keys only (`place_batch(len(encs), mesh, ranks)`)."""
    S = max(min_states, max(e.n_states for e in encs))
    C = max(min_slots, max(e.slot_f.shape[1] for e in encs))
    R = max(min_returns, max(e.n_returns for e in encs))
    if mesh is not None:
        encs = [encs[j] for j in place_batch(len(encs), mesh, ranks)]
    K = len(encs)

    def pad(attr, fill, dtype):
        out = np.full((K, R, C), fill, dtype)
        for k, e in enumerate(encs):
            a = getattr(e, attr)
            out[k, : a.shape[0], : a.shape[1]] = a
        return out

    xs = {
        "slot_f": pad("slot_f", -1, np.int32),
        "slot_a0": pad("slot_a0", -1, np.int32),
        "slot_a1": pad("slot_a1", -1, np.int32),
        "slot_wild": pad("slot_wild", False, bool),
        "slot_occ": pad("slot_occ", False, bool),
    }
    ev = np.full((K, R), -1, np.int32)
    for k, e in enumerate(encs):
        ev[k, : e.n_returns] = e.ev_slot
    xs["ev_slot"] = ev
    state0 = np.array([e.state0 for e in encs], np.int32)
    return xs, state0, S, C, R


ARRAY_FIELDS = ("slot_f", "slot_a0", "slot_a1", "slot_wild", "slot_occ",
                "ev_slot", "ret_call")
CALL_FIELDS = ("index", "process", "f", "value", "result", "invoke_index",
               "complete_index", "crashed")


def encoded_from_arrays(arrays: dict, calls: list, meta: dict
                        ) -> EncodedHistory:
    """Rebuild an EncodedHistory from plain data: `arrays` holds the
    numpy tables named in ARRAY_FIELDS, `calls` one dict per call with
    the CALL_FIELDS keys, and `meta` the scalars `state0`, `step_name`,
    `n_calls`, `n_slots`, `state_lo`, `n_states` (plus, optionally,
    `intern`: the value table as a list, in code order, and
    `model_pruned`). The packed spec is not carried: a history rebuilt
    this way can be checked, and reports its failing op, but its
    counterexample paths cannot be seeded from device states."""
    dtypes = {"slot_wild": bool, "slot_occ": bool}
    a = {k: np.ascontiguousarray(np.asarray(arrays[k],
                                            dtypes.get(k, np.int32)))
         for k in ARRAY_FIELDS}
    intern = Intern()
    for v in meta.get("intern", ()):
        intern.code(v)
    cs = [Call(**{k: c[k] for k in CALL_FIELDS}) for c in calls]
    return EncodedHistory(
        **a, state0=int(meta["state0"]), step_name=str(meta["step_name"]),
        n_calls=int(meta["n_calls"]), n_slots=int(meta["n_slots"]),
        calls=cs, intern=intern, state_lo=int(meta["state_lo"]),
        n_states=int(meta["n_states"]),
        model_pruned=bool(meta.get("model_pruned", False)))
