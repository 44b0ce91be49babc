"""Bit-packed dense linearizability engine, in PyTorch.

A port of `jepsen_tpu.parallel.bitdense` (single history). The whole
configuration space of one history is a bitset

    B: int32[S, W],  W = 2^C / 32

where bit b of word w of row s says that (model state s + state_lo,
linearized-slot mask w*32 + b) is reachable. Per return event:

  * compute_sel: the model step over every (slot, state) gives the
    transition selects sel[j, s, t] (FULL where slot j's op steps s -> t);
  * the closure fixpoint (K1, `closure_kernels.closure_fixpoint`) adds
    every configuration reachable by linearizing open calls;
  * filter_at: the returning call must have linearized, so keep the
    masks with its slot's bit set and clear that bit (an intra-word
    shift for slots < 5, a word gather for the others);
  * an empty B is a failure at this event.

The carry (B, ok, fail_r) stays on the device; the host walks the
events, which it knows from the encoding, and reads the device once, at
the end. After a failure the kernel skips its work by reading `ok`
itself.

With `search_stats` each event also writes, on the device, its frontier
width (the popcount of B after the filter, -1 on an event that did not
run) and its closure iterations (`closure_kernels.closure_fixpoint`'s
`iters`: the plain version's counted double expansions, -1 where K1
ran) into a preallocated [R, 2] tensor, read once after the scan: the
reference's `_stats_block_bitdense`.

The batch (`check_batch_bitdense`, a port of the reference's
`check_batch_bitdense` and its vmapped `_check_bitdense_batch`) runs K
keys' scans as one: B is [K, S, W], and every chunk of event rows whose
selects the host builds at once is one launch of the batched scan for
all keys (`closure_kernels.closure_scan_batch`), in which each key
closes, filters on its own returning slot and tests for failure row
after row. A key past its last event or its failure does not run: its
carry is kept, so pad events change nothing. The single and the
batched scans build their selects from the same `_compute_sel`.

Telemetry, the reference's sites: the `bitdense.check` span around the
single scan, with the `bitdense single S{S} C{C}` profiler annotation
around its K1 launches; for a batch the `bitdense.dispatches` counter,
the `bitdense.pad_place` and `bitdense.finalize` timers and the
`bitdense K{K} S{S} C{C}` annotation around the persistent batched
scan's launches. A stats block goes through the search-stats sinks.
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.parallel import closure_kernels as ck
from jepsen_tpu_torch.parallel import search_stats as st
from jepsen_tpu_torch.parallel.encode import (
    EncodedHistory, fail_op_fields, pad_batch, place_batch,
)
from jepsen_tpu_torch.parallel.steps import STEPS

MAX_C = 24  # 2^24 masks = 512k words per state row
MAX_S = 128  # sel is [C, S, S] per event; cost O(C*S^2*W) per expansion

_I32 = torch.int32
FULL = -1  # 0xFFFFFFFF as an int32 bit pattern

# events whose [C, S, S] selects are built in one batch: at most this
# many int32 elements of sel at once
SEL_CHUNK_ELEMS = 1 << 24


def fits_bitdense(n_states: int, n_slots: int,
                  budget_words: int = 1 << 22) -> bool:
    if n_slots > MAX_C or n_states > MAX_S:
        return False
    W = max(1, (1 << n_slots) // 32)
    # bound both the reachable-set tensor and the per-round work
    return n_states * W <= budget_words \
        and n_slots * n_states * n_states * W <= (1 << 26)


def n_states(e: EncodedHistory) -> int:
    return e.n_states


_intra_clear = ck.intra_clear


def _plan(C: int):
    """Static per-slot tables for shift/filter/select, as numpy (the
    same tables as the reference's `_plan`, words as uint32), from the
    filter's tables (`closure_kernels.filter_tables`)."""
    widx, mask = ck.filter_tables(C, "cpu")
    clearw = mask.numpy().view(np.uint32)
    plan = []
    for j in range(C):
        if j < 5:
            plan.append({
                "intra": True,
                "clear": np.uint32(_intra_clear(j)),
                "shift": np.int32(1 << j),
            })
        else:
            plan.append({
                "intra": False,
                "clearw": clearw[j],
                "fwd_idx": widx[j].numpy().astype(np.int32),
                "setw": ~clearw[j],
            })
    return ck.n_words(C), plan


class _Tables:
    """The single scan's filter tables on a device
    (`closure_kernels.filter_tables`): for slot j >= 5 the word gather
    `widx[j]` and the word clear `mask[j]`, so that keeping the
    configurations in which slot j has linearized, with its bit cleared,
    is B[..., widx[j]] & mask[j] (`filter_at`; a slot j < 5 shifts within
    the word)."""

    def __init__(self, C: int, device):
        self.widx, self.mask = ck.filter_tables(C, device)

    def filter_at(self, s: int, B):
        """One key's filter, B [S, W], on a slot the host knows."""
        if s < 5:
            return (B >> (1 << s)) & _intra_clear(s)
        return torch.index_select(B, 1, self.widx[s]) & self.mask[s]


def _compute_sel(step, x: dict, states, t_idx, lo: int):
    """sel[..., j, s, t] = FULL where slot j's op is legal from state s
    and steps it to t, for slot tables x [..., C] (any leading dims):
    [..., C, S, S]."""
    x = {k: v[..., None] for k, v in x.items()}                 # [..., C, 1]
    nxt, okj = step(states, x["slot_f"], x["slot_a0"], x["slot_a1"],
                    x["slot_wild"])
    legal = okj & x["slot_occ"]                                 # [..., C, S]
    hit = legal[..., None] & ((nxt - lo)[..., None] == t_idx)
    return torch.where(hit, torch.tensor(FULL, dtype=_I32, device=hit.device),
                       torch.tensor(0, dtype=_I32, device=hit.device))


def _xs_dense(e: EncodedHistory, C: int) -> dict:
    """The event tables padded to C slot columns (empty slots: f = -1,
    unoccupied), as numpy."""
    def padc(a, fill):
        out = np.full((a.shape[0], C), fill, a.dtype)
        out[:, : a.shape[1]] = a
        return out

    return {
        "slot_f": padc(e.slot_f, -1),
        "slot_a0": padc(e.slot_a0, -1),
        "slot_a1": padc(e.slot_a1, -1),
        "slot_wild": padc(e.slot_wild, False),
        "slot_occ": padc(e.slot_occ, False),
        "ev_slot": np.asarray(e.ev_slot),
    }


def _stats_block_bitdense(ys, S: int, C: int, extra: dict = None) -> dict:
    """The dense engine's stats block (the reference's
    `_stats_block_bitdense`): the reachable set is a complete visited
    set, so the trajectory is the per-event popcount and occupancy is
    measured against the S * 2^C configuration space; the hash-table
    fields stay None. `ys` holds one key's [R] "width" and "iters"."""
    w = np.asarray(ys["width"]).reshape(-1)
    real = w >= 0
    widths = [int(x) for x in w[real]]
    iters = [int(x) for x in np.asarray(ys["iters"]).reshape(-1)[real]]
    peak = max(widths, default=0)
    space = S * (1 << C)
    block = {
        "engine": "bitdense",
        "events": len(widths),
        "frontier-width": widths,
        "closure-iters": iters,
        "frontier-peak": peak,
        "config-space": space,
        "peak-occupancy": round(peak / space, 9) if space else None,
        "dedupe": "dense",
        "delta-split-ratio": None,
        "table-capacity": None,
        "load-factor-peak": None,
        "probe-hist": None,
    }
    if extra:
        block.update(extra)
    return block


def _ys(traj) -> dict:
    t = traj.cpu().numpy()
    return {"width": t[..., 0], "iters": t[..., 1]}


class Cancelled(Exception):
    """A scan stopped at its caller's `cancel`."""


def poll_cancel(cancel) -> None:
    """Raise Cancelled once `cancel` (an object with `is_set()`, such as
    a threading.Event) is set: the scans call it once an event, on the
    host, with no read of the device."""
    if cancel is not None and cancel.is_set():
        raise Cancelled


def resolve_device(device) -> torch.device:
    """None means the card. There is no silent CPU run: without CUDA the
    caller must ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jepsen_tpu_torch: no CUDA device is available; pass "
            "device=\"cpu\" to run the plain PyTorch path on the CPU")
    return dev


class _Scan:
    """The per-event state of one history's scan on one device."""

    def __init__(self, e: EncodedHistory, S: int, C: int, device,
                 stats: bool = False, cancel=None):
        self.step = STEPS[e.step_name]
        self.cancel = cancel
        self.S, self.C, self.lo = S, C, e.state_lo
        self.device = device
        xs = _xs_dense(e, C)
        self.ev_slot = xs["ev_slot"]
        self.xs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in xs.items() if k != "ev_slot"}
        self.states = torch.arange(S, dtype=_I32, device=device) + self.lo
        self.t_idx = torch.arange(S, dtype=_I32, device=device)
        self.tables = _Tables(C, device)
        W = max(1, (1 << C) // 32)
        self.B = torch.zeros((S, W), dtype=_I32, device=device)
        self.B[e.state0 - self.lo, 0] = 1
        self.ok = torch.ones((), dtype=torch.bool, device=device)
        self.fail_r = torch.full((), -1, dtype=_I32, device=device)
        # per event (width, closure-iters); width -1: the event did not run
        # (the closure's `iters` output only with stats: the stats-off
        # call is the same as ever)
        self.traj, self._iters_kw = None, {}
        if stats:
            self.traj = torch.zeros((e.n_returns, 2), dtype=_I32,
                                    device=device)
            self.traj[:, 0] = -1
            self._iters = torch.zeros((), dtype=_I32, device=device)
            self._iters_kw = {"iters": self._iters}

    def compute_sel(self, r0: int, r1: int):
        """The selects of events r0..r1-1: [E, C, S, S]."""
        return _compute_sel(self.step,
                            {k: v[r0:r1] for k, v in self.xs.items()},
                            self.states, self.t_idx, self.lo)

    def filter_at(self, s: int, B):
        """Keep the configurations in which slot s has linearized, with
        its bit cleared (the slot is free after its return)."""
        return self.tables.filter_at(s, B)

    def run(self, n_events: int):
        """Scan events 0..n_events-1; the carry stays on the device."""
        C = self.C
        per_event = C * self.S * self.S
        chunk = max(1, SEL_CHUNK_ELEMS // per_event)
        for r0 in range(0, n_events, chunk):
            r1 = min(n_events, r0 + chunk)
            sel = self.compute_sel(r0, r1)
            for r in range(r0, r1):
                poll_cancel(self.cancel)
                s = int(self.ev_slot[r])
                # in place; skipped by the kernel once ok is False
                B2 = ck.closure_fixpoint(sel[r - r0], self.B, C,
                                         run=self.ok, out=self.B,
                                         **self._iters_kw)
                B3 = self.filter_at(s, B2)
                alive = B3.any()
                if self.traj is not None:
                    # width -1 (not run) drops the event's row, iters too
                    self.traj[r] = torch.stack([torch.where(
                        self.ok, ck.popcount(B3, (0, 1)), -1).to(_I32),
                        self._iters])
                # while ok holds no event has failed, so the first
                # event that empties B is the failing one
                self.fail_r = torch.where(self.ok & ~alive, r, self.fail_r)
                self.B = torch.where(self.ok, B3, B2)
                self.ok = self.ok & alive
        return self


def check_encoded_bitdense(e: EncodedHistory, device=None,
                           search_stats=None, cancel=None) -> dict:
    """Single-key bit-packed check, the result schema of
    `jepsen_tpu.parallel.bitdense.check_encoded_bitdense`. `closure`
    says which closure ran: "cuda" when the scan launched K1, "torch"
    when the plain version ran (on the CPU). `search_stats` (None: the
    JEPSEN_TPU_TORCH_SEARCH_STATS flag) adds the "stats" block. The scan
    raises Cancelled at the first event after `cancel` is set."""
    if e.n_returns == 0:
        return {"valid?": True, "engine": "bitdense"}
    dev = resolve_device(device)
    ss = st._resolve_search_stats(search_stats)
    S = n_states(e)
    C = max(5, e.n_slots)  # at least one full word
    before = ck.launches
    ts0 = perf_counter()
    with obs.span("bitdense.check", S=S, C=C), \
            obs.device_annotation(f"bitdense single S{S} C{C}"):
        sc = _Scan(e, S, C, dev, stats=ss, cancel=cancel).run(e.n_returns)
        valid = sc.ok & (sc.B != 0).any()
        # the one device read of the whole check
        valid_i, fail_r = torch.stack([valid.to(_I32), sc.fail_r]).tolist()
    out = {"valid?": bool(valid_i), "engine": "bitdense",
           "states": S, "slots": C,
           # the dense reachable-set tensor is a complete visited set
           "dedupe": "dense",
           "closure": "cuda" if ck.launches > before else "torch"}
    if ss:
        out["stats"] = st.finish_stats_block(
            _stats_block_bitdense(_ys(sc.traj), S, C), ts0, perf_counter())
    if not out["valid?"]:
        out.update(fail_op_fields(e, int(fail_r)))
    return out


def frontier_rows(e: EncodedHistory, start_ev: int, device=None) -> list:
    """The live configurations after return events [0, start_ev), as
    (state code, mask_lo, mask_hi) rows sorted by (state, mask) — the
    order the reference's sparse re-scan leaves them in after its sort
    dedupe. C <= 24, so mask_hi is always 0."""
    dev = resolve_device(device)
    S = n_states(e)
    C = max(5, e.n_slots)
    sc = _Scan(e, S, C, dev).run(start_ev)
    words = sc.B.cpu().numpy().astype("<i4", copy=False)
    bits = np.unpackbits(words.view(np.uint8).reshape(S, -1),
                         axis=1, bitorder="little")       # [S, 32*W]
    ss, ms = np.nonzero(bits)
    return [(int(s) + e.state_lo, int(m), 0) for s, m in zip(ss, ms)]


# ------------------------------------------------------ batched (per-key)

class _BatchScan:
    """K keys' scans as one, on one device, over a padded batch
    (`encode.pad_batch`): B [K, S, W], ok [K], fail_r [K]. Every key
    uses the first key's state offset and step family, as the
    reference's batch does (`encs[0].state_lo`, `encs[0].step_name`).

    Per chunk of event rows the host builds the rows' selects and issues
    one batched scan for all K keys (`closure_kernels.closure_scan_batch`);
    it reads nothing back. A key runs an event when it has not failed and
    the event is real (ev_slot >= 0): a key past its last event or its
    failure keeps its carry."""

    def __init__(self, encs, xs: dict, state0, S: int, C: int, R: int,
                 device, stats: bool = False, state_lo=None):
        e0 = encs[0]
        self.step = STEPS[e0.step_name]
        self.K, self.S, self.C, self.R = len(encs), S, C, R
        self.lo = e0.state_lo if state_lo is None else state_lo
        self.device = device
        # event-major [R, K, C], so that one row's selects are contiguous
        self.xs = {k: torch.from_numpy(np.ascontiguousarray(
            np.swapaxes(v, 0, 1))).to(device)
            for k, v in xs.items() if k != "ev_slot"}
        ev = torch.from_numpy(np.ascontiguousarray(xs["ev_slot"].T)) \
            .to(device)                                           # [R, K]
        self.real = ev >= 0
        self.slot = ev.clamp(0, C - 1)
        self.states = torch.arange(S, dtype=_I32, device=device) + self.lo
        self.t_idx = torch.arange(S, dtype=_I32, device=device)
        W = max(1, (1 << C) // 32)
        self.B = torch.zeros((self.K, S, W), dtype=_I32, device=device)
        keys = torch.arange(self.K, device=device)
        s0 = torch.from_numpy(np.asarray(state0, np.int64)).to(device)
        self.B[keys, s0 - self.lo, 0] = 1
        self.ok = torch.ones(self.K, dtype=torch.bool, device=device)
        self.fail_r = torch.full((self.K,), -1, dtype=_I32, device=device)
        # per key and event row (width, closure-iters), as _Scan's; every
        # row's pair is written by the scan
        self.traj = torch.empty((self.K, R, 2), dtype=_I32,
                                device=device) if stats else None

    def run(self):
        per_row = self.K * self.C * self.S * self.S
        chunk = max(1, SEL_CHUNK_ELEMS // per_row)
        for r0 in range(0, self.R, chunk):
            r1 = min(self.R, r0 + chunk)
            sel = _compute_sel(self.step,
                               {k: v[r0:r1] for k, v in self.xs.items()},
                               self.states, self.t_idx, self.lo)
            # the carry is updated in place
            ck.closure_scan_batch(sel, self.B, self.ok, self.fail_r,
                                  self.slot[r0:r1], self.real[r0:r1], r0,
                                  self.C, traj=self.traj)
        return self


class PendingBitdenseBatch:
    """A batched dense check that has been issued but not read: the
    constructor pads the keys, moves the tables to the device and issues
    the whole scan (on a card the host runs ahead of the device);
    `finalize()` makes the one device read and builds the per-key
    results. A trimmed port of the reference's class: no supervisor, no
    decision ledger, and no closure fallback — a launch the
    card refuses raises to the caller. With `search_stats` each key's
    result carries its stats block, with the reference's pad extras
    ("pad-waste", "pad-events", "pad-slots")."""

    def __init__(self, encs, device, search_stats: bool = False,
                 min_states: int = 0, min_slots: int = 5,
                 min_returns: int = 0, mesh=None, ranks=None):
        self.encs = encs
        self.device = device
        self.search_stats = search_stats
        # C >= 5: at least one full 32-mask word. The dims are the whole
        # batch's; with a mesh this rank pads and scans its keys only
        # one clock-read pair serves the recorded span and transfer_secs
        with obs.timer("bitdense.pad_place", keys=len(encs)) as tm:
            xs, state0, self.S, self.C, self.R = pad_batch(
                encs, min_slots=max(5, min_slots), min_states=min_states,
                min_returns=min_returns, mesh=mesh, ranks=ranks)
        self.transfer_secs = tm.wall
        self.plan = None
        self.mine = list(range(len(encs)))
        if mesh is not None:
            from jepsen_tpu_torch.parallel.meshplan import MeshPlan
            self.plan = MeshPlan.flat(mesh)
            self.mine = place_batch(len(encs), mesh, ranks)
        self._scan = None
        self._t_issue = perf_counter()
        if self.mine:
            # the whole batch's state offset: a block's first key may
            # have another
            with obs.device_annotation(
                    f"bitdense K{len(encs)} S{self.S} C{self.C}"):
                self._scan = _BatchScan(
                    [encs[j] for j in self.mine], xs, state0, self.S,
                    self.C, self.R, device, stats=search_stats,
                    state_lo=encs[0].state_lo).run()
        self._results = None

    def finalize(self) -> list:
        """The per-key results, in the batch's order; with a mesh an
        all-gather of every rank's keys (every rank calls it)."""
        if self._results is not None:
            return self._results
        with obs.timer("bitdense.finalize", keys=len(self.encs)):
            read = self._read() if self.mine else None
        t1 = perf_counter()
        out = self._finalize_mine(*read) if self.mine else []
        if self.plan is not None:
            out = self.plan.gather_keys(len(self.encs), self.mine, out)
        # every key's block through the sinks, on every rank of a mesh
        for k, r in enumerate(out):
            if r.get("stats") is not None:
                st.finish_stats_block(r["stats"], self._t_issue, t1, key=k)
        self._results = out
        return out

    def _read(self):
        """The one device read of the whole batch: (valid, fail_r)."""
        sc = self._scan
        valid = sc.ok & (sc.B != 0).flatten(1).any(1)
        return tuple(torch.stack([valid.to(_I32), sc.fail_r]).tolist())

    def _finalize_mine(self, valid_l, fail_l) -> list:
        sc = self._scan
        closure = "cuda" if self.device.type == "cuda" else "torch"
        ys = _ys(sc.traj) if self.search_stats else None
        out = []
        for k, e in enumerate([self.encs[j] for j in self.mine]):
            r = {"valid?": bool(valid_l[k]), "engine": "bitdense",
                 "dedupe": "dense", "closure": closure}
            if ys is not None:
                C_k = max(5, e.n_slots)
                waste = 1.0 - ((e.n_returns * C_k)
                               / max(1, self.R * self.C))
                r["stats"] = _stats_block_bitdense(
                    {"width": ys["width"][k], "iters": ys["iters"][k]},
                    self.S, self.C,
                    extra={"pad-waste": round(waste, 6),
                           "pad-events": int(self.R - e.n_returns),
                           "pad-slots": int(self.C - C_k)})
            if not r["valid?"]:
                r.update(fail_op_fields(e, int(fail_l[k])))
            out.append(r)
        return out


def dispatch_batch_bitdense(encs, device=None, search_stats=None,
                            min_states: int = 0, min_slots: int = 5,
                            min_returns: int = 0, mesh=None,
                            ranks=None) -> PendingBitdenseBatch:
    """Pad and issue a batched per-key check without reading its
    results: `finalize()` on the returned PendingBitdenseBatch reads
    them. `device` None means the card (RuntimeError without one);
    `search_stats` None reads JEPSEN_TPU_TORCH_SEARCH_STATS.
    `min_states`, `min_slots` and `min_returns` floor the padded S, C
    and R: the pipelined executor pads each chunk of a bucket to the
    whole bucket's dims, so that a chunk's results (its stats' pad
    extras too) are the whole bucket's. `mesh` (a DeviceMesh) shards the
    keys over its ranks (`encode.place_batch`; `ranks`, one mesh index
    per key, places them instead), each rank scanning its keys on its
    own device padded to the whole batch's dims, and `finalize()`
    all-gathers the results: every rank of the mesh calls both."""
    obs.counter("bitdense.dispatches").inc()
    if mesh is not None:
        from jepsen_tpu_torch.parallel.meshplan import MeshPlan
        device = MeshPlan.flat(mesh).device
    return PendingBitdenseBatch(encs, resolve_device(device),
                                st._resolve_search_stats(search_stats),
                                min_states=min_states, min_slots=min_slots,
                                min_returns=min_returns, mesh=mesh,
                                ranks=ranks)


def check_batch_bitdense(encs, device=None, search_stats=None,
                         mesh=None) -> list:
    """Batched per-key check, the result schema of the reference's
    batch: per key {"valid?", "engine": "bitdense", "dedupe": "dense",
    "closure"} plus the failing op's fields when the key is invalid
    (no `states`/`slots`, no counterexample paths). `closure` is "cuda"
    on the card, "torch" on the CPU. The caller makes sure the padded
    dims fit (`fits_bitdense(max S, max C)`); `engine.check_batch`
    does. `search_stats` adds each key's "stats" block."""
    if not encs:
        return []
    return dispatch_batch_bitdense(encs, device=device,
                                   search_stats=search_stats,
                                   mesh=mesh).finalize()
