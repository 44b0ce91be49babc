"""The sparse frontier engine, in PyTorch.

A port of the sparse half of `jepsen_tpu.parallel.engine` (single
history). A configuration is a row of three int32 lanes (state,
mask_lo, mask_hi): the model state and the 64-bit mask of linearized
open-call slots, the masks carried as int32 bit patterns. The frontier
is a fixed-capacity set of N rows with a live flag; per return event

  * the closure adds every configuration reachable by linearizing open
    calls, deduplicated either by a full sort of all N*(C+1) candidate
    rows per iteration (dedupe="sort") or by a delta-frontier closure
    over an open-addressed visited set (dedupe="hash", the port's
    default: its closure and its visited-set transaction are the
    kernels K2 and K4, `parallel.sparse_kernels`);
  * the filter keeps the rows in which the returning call linearized
    and clears its slot bit; an empty frontier is a failure;
  * a frontier or visited set that overflows aborts the scan, and the
    check runs again at twice the capacity.

The carry stays on the device. The host walks the events, which it
knows from the encoding; it reads the device where a loop's stop test
needs a value (the plain and tiled closures, the sort closure), and
otherwise once, at the end of the scan.

Only the unpacked row layout is ported (`config_pack=True` raises);
the search-stats block is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from jepsen_tpu_torch.parallel import sparse_kernels as sk
from jepsen_tpu_torch.parallel.bitdense import resolve_device
from jepsen_tpu_torch.parallel.encode import EncodedHistory, fail_op_fields
from jepsen_tpu_torch.parallel.steps import STEPS

_I32 = torch.int32
_I64 = torch.int64
_U32 = 0xFFFFFFFF

# the kernels keep a probe offset in one byte
MAX_PROBE_LIMIT = 255


def _env_int(name: str, default: int, lo: int, hi: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None
    if not lo <= v <= hi:
        raise ValueError(f"{name}={v} outside {lo}..{hi}")
    return v


def _resolve_probe_limit(probe_limit: int = 0) -> int:
    """Bounded linear-probe length of the hash visited set: a positive
    argument wins, else JEPSEN_TPU_TORCH_PROBE_LIMIT, default 32. At the
    table's <= 50% load a 32-probe run is rare; exhaustion raises the
    overflow flag and the check runs again at twice the capacity."""
    if probe_limit and probe_limit > 0:
        if probe_limit > MAX_PROBE_LIMIT:
            raise ValueError(f"probe_limit={probe_limit} exceeds "
                             f"{MAX_PROBE_LIMIT}")
        return int(probe_limit)
    return _env_int("JEPSEN_TPU_TORCH_PROBE_LIMIT", 32, 1, MAX_PROBE_LIMIT)


def _resolve_dedupe(dedupe=None) -> str:
    """"hash" (the delta-frontier closure, whose kernels are K2 and K4)
    or "sort"; None reads JEPSEN_TPU_TORCH_DEDUPE, default "hash"."""
    if dedupe is None:
        dedupe = os.environ.get("JEPSEN_TPU_TORCH_DEDUPE", "").strip() \
            or "hash"
    if dedupe not in ("sort", "hash"):
        raise ValueError(f"unknown dedupe strategy {dedupe!r}")
    return dedupe


def _next_pow2(n: int) -> int:
    return 1 << max(1, (int(n) - 1).bit_length())


def _i32(v: int) -> int:
    """A 32-bit pattern as a Python int in int32 range."""
    v &= _U32
    return v - (1 << 32) if v >= 1 << 31 else v


def _slot_bits(C: int, device=None):
    """Per-slot mask bits as ([C] int32 lo-lane, [C] int32 hi-lane) bit
    patterns."""
    lo = [_i32(1 << j) if j < 32 else 0 for j in range(C)]
    hi = [_i32(1 << (j - 32)) if j >= 32 else 0 for j in range(C)]
    return (torch.tensor(lo, dtype=_I32, device=device),
            torch.tensor(hi, dtype=_I32, device=device))


def _u32(x):
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    return x.to(_I64) & _U32


def _mul32(x, k: int):
    """(x * k) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant,
    with no int64 overflow: the constant is split at bit 16."""
    return (x * (k & 0xFFFF) + (((x * (k >> 16)) & 0xFFFF) << 16)) & _U32


def table_hash_u32(st, ml, mh):
    """The visited-set slot mix of three uint32 values (int64 tensors in
    [0, 2^32)); the reference's `_UnpackedRep.table_hash`, bit for
    bit."""
    h = _mul32(st, 0x85EBCA6B) ^ _mul32(ml, 0xC2B2AE35) \
        ^ _mul32(mh, 0x27D4EB2F)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x165667B1)
    return h ^ (h >> 13)


def owner_hash_u32(st, ml, mh):
    """The sharded engine's ownership mix of three uint32 values (int64
    tensors in [0, 2^32)); the reference's `_UnpackedRep.owner_hash`,
    bit for bit. A different mix from `table_hash_u32`: a rank's owned
    rows share their owner hash modulo the ranks, and must not share
    their table slots too."""
    h = _mul32(st, 0x9E3779B1) ^ _mul32(ml, 0x85EBCA77) \
        ^ _mul32(mh, 0xC2B2AE3D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


class _UnpackedRep:
    """The (state, mask_lo, mask_hi) row layout: three int32 lanes."""

    def __init__(self, C: int, device=None):
        self.C = C
        self.device = device
        self.bit_lo, self.bit_hi = _slot_bits(C, device)

    def zeros(self, n: int):
        return tuple(torch.zeros(n, dtype=_I32, device=self.device)
                     for _ in range(3))

    def initial_at0(self, state0: int, N: int):
        rows = self.zeros(N)
        rows[0][0] = state0
        return rows

    def state(self, rows):
        return rows[0]

    def table_hash(self, rows):
        """[n] int64 slot hash in [0, 2^32)."""
        return table_hash_u32(*(_u32(r) for r in rows))

    def owner_hash(self, rows):
        """[n] int64 ownership hash in [0, 2^32)."""
        return owner_hash_u32(*(_u32(r) for r in rows))

    def mask_test(self, rows):
        """[N, C] bool: slot j already linearized in row n."""
        _, ml, mh = rows
        return ((ml[:, None] & self.bit_lo[None, :])
                | (mh[:, None] & self.bit_hi[None, :])) != 0

    def candidates(self, rows, cand_st):
        """Flattened [N*C] candidate rows (index n*C + j): state from the
        model step, mask with slot j's bit set."""
        _, ml, mh = rows
        return (cand_st.reshape(-1),
                (ml[:, None] | self.bit_lo[None, :]).reshape(-1),
                (mh[:, None] | self.bit_hi[None, :]).reshape(-1))

    @staticmethod
    def event_bits(s: int):
        """(lo, hi) int32 bit patterns of slot s."""
        return (_i32(1 << s) if s < 32 else 0,
                _i32(1 << (s - 32)) if s >= 32 else 0)

    @staticmethod
    def has_event_bit(rows, bits):
        _, ml, mh = rows
        return ((ml & bits[0]) | (mh & bits[1])) != 0

    @staticmethod
    def clear_event_bit(rows, bits, where):
        st, ml, mh = rows
        return (st, torch.where(where, ml & ~bits[0], ml),
                torch.where(where, mh & ~bits[1], mh))


def _rep(pack, C: int, device=None):
    if pack:
        raise NotImplementedError(
            "config_pack: the packed row layout (_PackedRep) is not "
            "ported to jepsen_tpu_torch (ROADMAP Queue 1)")
    return _UnpackedRep(C, device)


def _rows_eq(a_rows, b_rows):
    acc = a_rows[0] == b_rows[0]
    for a, b in zip(a_rows[1:], b_rows[1:]):
        acc = acc & (a == b)
    return acc


def _rows_take(rows, idx):
    return tuple(r[idx] for r in rows)


def _rows_concat(a_rows, b_rows):
    return tuple(torch.cat([a, b]) for a, b in zip(a_rows, b_rows))


def _rows_where(cond, a_rows, b_rows):
    return tuple(torch.where(cond, a, b) for a, b in zip(a_rows, b_rows))


def _rows_at_set(rows, pos, vals):
    """rows[pos] = vals for the positions inside the lanes (the others
    are dropped), on copies."""
    n = rows[0].shape[0]
    keep = (pos >= 0) & (pos < n)
    p = pos[keep]
    out = []
    for r, v in zip(rows, vals):
        r = r.clone()
        r[p] = v[keep]
        out.append(r)
    return tuple(out)


def _empty_table(T: int, rep):
    return (rep.zeros(T), torch.zeros(T, dtype=torch.bool,
                                      device=rep.device))


# ------------------------------------------------- the visited-set insert

def _hash_insert(c_rows, c_live, table, probe_limit: int, rep=None,
                 h0=None, base=None, span=None):
    """Parallel bounded-linear-probe insert of candidate rows into the
    open-addressed visited set `table` ((rows, occ) of length T).

    Each live candidate probes slots base + ((h0 + off) & (span - 1)):
    by default h0 is its table hash (`rep`'s), base 0 and span T; the
    tiled insert passes the in-tile start, the tile's first slot and the
    tile size.
    Per round it drops on an equal occupant, claims an empty slot
    (racing claimants are arbitrated by a scatter-min of the candidate
    index; losers re-check the same slot next round, since the winner
    may hold an equal row) or advances past a different occupant, until
    every candidate resolved or spent `probe_limit` probes.

    Returns (table', fresh, overflow, off): `fresh` flags candidates
    that claimed a slot, `overflow` that some candidate exhausted its
    probes, `off` each candidate's final probe offset."""
    t_rows, t_occ = table
    M = c_live.shape[0]
    T = t_occ.shape[0]
    dev = c_live.device
    if h0 is None:
        h0 = rep.table_hash(c_rows)
    if span is None:
        span = T
    idx = torch.arange(M, dtype=_I64, device=dev)
    t_rows = tuple(r.clone() for r in t_rows)
    t_occ = t_occ.clone()
    pending = c_live.clone()
    off = torch.zeros(M, dtype=_I32, device=dev)
    fresh = torch.zeros(M, dtype=torch.bool, device=dev)
    while bool((pending & (off < probe_limit)).any()):
        act = pending & (off < probe_limit)
        slot = (h0 + off) & (span - 1)
        if base is not None:
            slot = slot + base
        occ = t_occ[slot]
        same = occ & _rows_eq(_rows_take(t_rows, slot), c_rows)
        try_claim = act & ~occ
        claim = torch.full((T + 1,), M, dtype=_I64, device=dev)
        claim.scatter_reduce_(0, torch.where(try_claim, slot, T), idx,
                              "amin")
        won = try_claim & (claim[slot] == idx)
        ws = slot[won]
        for r, c in zip(t_rows, c_rows):
            r[ws] = c[won]
        t_occ[ws] = True
        pending = pending & ~(act & same) & ~won
        off = off + (act & occ & ~same).to(_I32)
        fresh = fresh | won
    return (t_rows, t_occ), fresh, pending.any(), off


def _append_fresh(c_rows, fresh, f_rows, count, N: int):
    """The append half of one visited-set transaction: fresh rows land
    contiguously after `count` in the frontier lanes. Returns (rows2,
    count2, n_fresh, append_ovf)."""
    n_fresh = fresh.sum()
    pos = torch.where(fresh, count + torch.cumsum(fresh, 0) - 1, N)
    rows2 = _rows_at_set(f_rows, pos, c_rows)
    return (rows2, torch.clamp(count + n_fresh, max=N), n_fresh,
            count + n_fresh > N)


def _hash_insert_append(c_rows, c_live, f_rows, count, table,
                        probe_limit: int, N: int, rep):
    """One closure iteration's whole visited-set transaction: the insert
    and the append of its fresh rows. Returns (rows2, table2, count2,
    n_fresh, ovf), `ovf` being probe exhaustion or the append running
    past the N-row frontier."""
    table2, fresh, p_ovf, _ = _hash_insert(c_rows, c_live, table,
                                           probe_limit, rep)
    rows2, count2, n_fresh, a_ovf = _append_fresh(c_rows, fresh, f_rows,
                                                  count, N)
    return rows2, table2, count2, n_fresh, p_ovf | a_ovf


def _hash_event_closure(rep, step, ev, rows, live, run, N: int, T: int,
                        probe_limit: int, insert=None):
    """The whole per-event delta-frontier closure (dedupe="hash"), the
    plain version of K2: seed a fresh visited set with the live
    frontier (compacting it), then expand only the delta — the rows
    found by the last iteration — until no fresh row appears. With the
    `insert` hook each iteration's visited-set transaction is the tiled
    insert (K4) instead.

    Returns (rows2, count, ovf, iters, stepped), `stepped` counting the
    configurations expanded during this closure."""
    if insert is None:
        def insert(c_rows, c_live, f_rows, count, table):
            return _hash_insert_append(c_rows, c_live, f_rows, count,
                                       table, probe_limit, N, rep)
    dev = live.device
    zero = torch.zeros((), dtype=_I64, device=dev)
    rows, table, count, _, ovf = insert(rows, live, rep.zeros(N), zero,
                                        _empty_table(T, rep))
    n_old = zero
    iters = stepped = zero
    changed = bool(run)
    row = torch.arange(N, device=dev)
    while changed and not bool(ovf):
        cand_st, cand_ok = step(rep.state(rows)[:, None], ev["slot_f"],
                                ev["slot_a0"], ev["slot_a1"],
                                ev["slot_wild"])
        delta = (row >= n_old) & (row < count)
        legal = (delta[:, None] & ev["slot_occ"][None, :]
                 & ~rep.mask_test(rows) & cand_ok)
        rows, table, count2, n_fresh, ins_ovf = insert(
            rep.candidates(rows, cand_st), legal.reshape(-1), rows, count,
            table)
        stepped = stepped + (count - n_old)
        n_old, count = count, count2
        ovf = ovf | ins_ovf
        iters = iters + 1
        changed = bool(n_fresh > 0)
    return rows, count, ovf, iters, stepped


# ----------------------------------------------------------- sort dedupe

def _rows_prev_same(rows_s):
    acc = rows_s[0][1:] == rows_s[0][:-1]
    for r in rows_s[1:]:
        acc = acc & (r[1:] == r[:-1])
    return torch.cat([torch.zeros(1, dtype=torch.bool, device=acc.device),
                      acc])


def _dedupe_compact(rows, live, N: int, rep):
    """Sort rows by (dead, state, mask_lo, mask_hi) — the masks as
    unsigned — flag first occurrences and compact them into a fresh
    [N] frontier. Returns (rows, live, count, overflow). The order is
    the reference's lexsort, built from stable sorts from the minor key
    to the major one."""
    M = live.shape[0]
    st, ml, mh = rows
    order = torch.arange(M, device=live.device)
    for key in (_u32(mh), _u32(ml), st, (~live).to(_I32)):
        order = order[torch.sort(key[order], stable=True).indices]
    rows_s = _rows_take(rows, order)
    live_s = live[order]
    uniq = live_s & ~_rows_prev_same(rows_s)
    count = uniq.sum()
    pos = torch.where(uniq, torch.cumsum(uniq, 0) - 1, M + N)
    new_rows = _rows_at_set(rep.zeros(N), pos, rows_s)
    new_live = torch.arange(N, device=live.device) < count
    return new_rows, new_live, count, count > N


def _sort_event_closure(rep, step, ev, rows, live, run, N: int):
    """The per-event closure under dedupe="sort": every iteration steps
    the whole live frontier and deduplicates all N*(C+1) rows by sort.
    Returns (rows2, live2, ovf, iters, stepped)."""
    dev = live.device
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    iters = stepped = torch.zeros((), dtype=_I64, device=dev)
    changed = bool(run)
    while changed and not bool(ovf):
        cand_st, cand_ok = step(rep.state(rows)[:, None], ev["slot_f"],
                                ev["slot_a0"], ev["slot_a1"],
                                ev["slot_wild"])
        legal = (live[:, None] & ev["slot_occ"][None, :]
                 & ~rep.mask_test(rows) & cand_ok)
        old_count = live.sum()
        rows, live, count, ovf = _dedupe_compact(
            _rows_concat(rows, rep.candidates(rows, cand_st)),
            torch.cat([live, legal.reshape(-1)]), N, rep)
        iters = iters + 1
        stepped = stepped + old_count
        changed = bool(count > old_count)
    return rows, live, ovf, iters, stepped


# ------------------------------------------------------------------ scan

def _xs(e: EncodedHistory, device) -> dict:
    """The [R, C] event tables on the device; the returning slots stay
    on the host, which walks the events."""
    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)
    return {"slot_f": t(e.slot_f, _I32), "slot_a0": t(e.slot_a0, _I32),
            "slot_a1": t(e.slot_a1, _I32),
            "slot_wild": t(e.slot_wild, torch.bool),
            "slot_occ": t(e.slot_occ, torch.bool)}


def _route(N: int, C: int, dedupe: str, device, smem_budget=None):
    """-> (closure, plan): "sort", "fused" (K2) or "tiled" (K4), with
    the tiled insert's plan. The hash closure is fused while K2's
    shared-memory layout fits the budget, and tiled past it; the budget
    is the card's opt-in on a card, Hopper's on the CPU, or the test
    seam `smem_budget`."""
    if dedupe == "sort":
        return "sort", None
    budget = smem_budget or sk.smem_budget(device)
    if sk.supported(N, C, budget):
        return "fused", None
    plan = sk.tiled_plan(N, C, budget)
    if plan is None:
        raise RuntimeError(f"no tiled insert plan at capacity {N}, C={C} "
                           f"within {budget} bytes of shared memory")
    return "tiled", plan


class _Scan:
    """One history's scan at frontier capacity N on one device. The
    carry — rows, live, ok, fail_r, max-frontier, iterations,
    configs-stepped and the overflow flag — stays on the device."""

    def __init__(self, e: EncodedHistory, N: int, dedupe: str,
                 probe_limit: int, device, smem_budget=None, xs=None,
                 pack=()):
        C = e.slot_f.shape[1]
        self.e, self.N, self.C = e, N, C
        self.T = _next_pow2(2 * N)
        self.probe_limit = probe_limit
        self.device = device
        self.rep = _rep(pack, C, device)
        self.step = STEPS[e.step_name]
        self.xs = _xs(e, device) if xs is None else xs
        self.closure, self.plan = _route(N, C, dedupe, device, smem_budget)
        # the fused closure on a card is the one route that never needs
        # a value on the host during the scan
        self.synced = self.closure != "fused" or device.type != "cuda"
        z = torch.zeros((), dtype=_I64, device=device)
        self.rows = self.rep.initial_at0(e.state0, N)
        self.live = torch.arange(N, device=device) < 1
        self.ok = torch.ones((), dtype=torch.bool, device=device)
        self.overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.fail_r = z - 1
        self.maxf = z + 1
        self.steps_n = z
        self.stepped = z

    def _ev(self, r: int) -> dict:
        return {k: v[r] for k, v in self.xs.items()}

    def _closure(self, r: int, run):
        """-> (rows2, live2, ovf, iters, stepped) of event r."""
        ev = self._ev(r)
        N = self.N
        if self.closure == "sort":
            return _sort_event_closure(self.rep, self.step, ev, self.rows,
                                       self.live, run, N)
        if self.closure == "fused":
            rows2, meta = sk.frontier_closure(
                self.e.step_name, ev, self.rows, self.live, run,
                self.probe_limit)
        else:
            rows2, meta = sk.tiled_event_closure(
                self.rep, self.step, ev, self.rows, self.live, run, N,
                self.T, self.probe_limit, self.plan)
        live2 = torch.arange(N, device=self.device) < meta[0]
        return rows2, live2, meta[1] != 0, meta[2], meta[3]

    def run(self, n_events: int):
        """Scan return events 0..n_events-1. The fused closure never
        makes the host wait; the others read `ok` anyway, and stop the
        scan once it is False (nothing changes after that)."""
        ev_slot = self.e.ev_slot
        for r in range(n_events):
            if self.synced and not bool(self.ok):
                break
            run = self.ok
            rows2, live2, ovf, iters, d = self._closure(r, run)
            # a settled event's probe flag must not trigger escalation
            ovf = run & ovf
            bits = self.rep.event_bits(int(ev_slot[r]))
            live3 = live2 & self.rep.has_event_bit(rows2, bits)
            rows3 = self.rep.clear_event_bit(rows2, bits, live3)
            failed_here = run & ~live3.any()
            self.fail_r = torch.where(failed_here & (self.fail_r < 0), r,
                                      self.fail_r)
            self.ok = torch.where(run, ~failed_here & ~ovf, self.ok)
            self.rows = _rows_where(run, rows3, self.rows)
            self.live = torch.where(run, live3, self.live)
            self.maxf = torch.maximum(
                self.maxf, torch.where(run, live2.sum(), 0))
            self.steps_n = self.steps_n + torch.where(run, iters, 0)
            self.stepped = self.stepped + torch.where(run, d, 0)
            self.overflow = self.overflow | ovf
        return self

    def result(self):
        """(valid, fail_r, overflow, maxf, steps_n, stepped) as Python
        values: the scan's one read of the device."""
        valid = self.ok & self.live.any() & ~self.overflow
        vals = torch.stack([valid.to(_I64), self.fail_r,
                            self.overflow.to(_I64), self.maxf,
                            self.steps_n.to(_I64),
                            self.stepped.to(_I64)]).tolist()
        return (bool(vals[0]), vals[1], bool(vals[2]), vals[3], vals[4],
                vals[5])


def _closure_tag(closure: str, device) -> str:
    """The result's "closure": which implementation ran the closure —
    bitdense's vocabulary plus the tiled insert. The sort closure is
    plain PyTorch on any device."""
    kind = "cuda" if device.type == "cuda" and closure != "sort" \
        else "torch"
    return kind + "-tiled" if closure == "tiled" else kind


def check_encoded(e: EncodedHistory, capacity: int = 1024,
                  max_capacity: int = 1 << 20, device=None,
                  dedupe=None, probe_limit: int = 0,
                  config_pack=None, smem_budget=None) -> dict:
    """Check one encoded history on the sparse engine, doubling the
    frontier capacity on overflow, with the result schema of
    `jepsen_tpu.parallel.engine.check_encoded`.

    `dedupe` is "hash" (default; JEPSEN_TPU_TORCH_DEDUPE) or "sort";
    under "hash" the closure is K2 while its shared-memory layout fits,
    else K2's plain closure around the tiled insert K4 ("closure":
    "cuda" / "cuda-tiled" on a card, "torch" / "torch-tiled" on the
    CPU). `probe_limit` bounds the hash probes (0: the
    JEPSEN_TPU_TORCH_PROBE_LIMIT flag, default 32). `smem_budget` is a
    test seam that replaces the shared-memory budget of the route. Past
    `max_capacity` the verdict is "unknown"."""
    if e.n_returns == 0:
        return {"valid?": True, "max-frontier": 0, "capacity": 0}
    dev = resolve_device(device)
    dedupe = _resolve_dedupe(dedupe)
    probe_limit = _resolve_probe_limit(probe_limit)
    pack = ("packed",) if config_pack else ()
    xs = _xs(e, dev)
    N = max(64, capacity)
    while True:
        sc = _Scan(e, N, dedupe, probe_limit, dev, smem_budget, xs, pack)
        valid, fail_r, overflow, maxf, steps_n, stepped = \
            sc.run(e.n_returns).result()
        if not overflow:
            break
        if N * 2 > max_capacity:
            return {"valid?": "unknown",
                    "error": f"frontier overflow at capacity {N}",
                    "capacity": N, "dedupe": dedupe,
                    "closure": _closure_tag(sc.closure, dev)}
        N *= 2
    out = {"valid?": valid, "max-frontier": maxf, "capacity": N,
           "dedupe": dedupe, "configs-stepped": stepped,
           "explored": steps_n * N * e.slot_f.shape[1],
           "closure": _closure_tag(sc.closure, dev)}
    if not valid:
        out.update(fail_op_fields(e, fail_r))
    return out


def frontier_at(e: EncodedHistory, start_ev: int, device=None):
    """The live configurations after return events [0, start_ev) as
    (state, mask_lo, mask_hi) rows, the masks unsigned, in carry order —
    the reference's `_frontier_at`: a sort-path re-scan, capacity 1024
    doubling to 2^20, None past that."""
    dev = resolve_device(device)
    xs = _xs(e, dev)
    N = 1024
    while True:
        sc = _Scan(e, N, "sort", _resolve_probe_limit(0), dev, xs=xs)
        sc.run(start_ev)
        if not bool(sc.overflow):
            break
        if N * 2 > (1 << 20):
            return None
        N *= 2
    st, ml, mh = (r.cpu().numpy() for r in sc.rows)
    idx = np.nonzero(sc.live.cpu().numpy())[0]
    return [(int(st[i]), int(ml[i]) & _U32, int(mh[i]) & _U32)
            for i in idx]
