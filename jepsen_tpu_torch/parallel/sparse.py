"""The sparse frontier engine, in PyTorch.

A port of the sparse half of `jepsen_tpu.parallel.engine` (single
history). A configuration is a row of three int32 lanes (state,
mask_lo, mask_hi): the model state and the 64-bit mask of linearized
open-call slots, the masks carried as int32 bit patterns. With
`config_pack` it is instead the packed word (state - state_lo) | mask
<< state_bits in one or two int32 lanes (`_PackedRep`). The frontier
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

With `search_stats` each event also writes its stats (frontier width,
closure peak, iterations, configurations stepped, the sort-equivalent
work and the probe-length histogram: `parallel.search_stats`) into
preallocated tensors on the device, read once after the scan; with it
off the scan issues nothing more.

Telemetry, the reference's sites and names (its `check_encoded` and
sparse batch lived in `parallel.engine`): the `engine.search` span
around a single check's capacity ladder, the `engine.sparse_batch` span
around each tier of the batch, and the `engine.capacity_escalations`,
`configs_stepped` and `overflow_redispatch` counters; a stats block goes
through the search-stats sinks. The kernels' launches carry a
`sparse single N{N} C{C}` or `sparse K{K} N{N} C{C}` profiler annotation
(`obs.device_annotation`, a no-op without JEPSEN_TPU_TORCH_PROFILE): the
reference's TPU capture names a program by its jit function, where a
ctypes launch has no name on the host's side.
"""

from __future__ import annotations

import os
from time import perf_counter

import numpy as np
import torch

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.parallel import search_stats as st
from jepsen_tpu_torch.parallel import sparse_kernels as sk
from jepsen_tpu_torch.parallel.bitdense import poll_cancel, resolve_device
from jepsen_tpu_torch.parallel.encode import (
    EncodedHistory, fail_op_fields, pad_batch, place_batch,
)
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


# the lane constants of the visited-set and ownership mixes: lane k of a
# row is multiplied by the k-th, the products XORed (the triple's three
# lanes, or the packed word's one or two, take the first ones)
_TABLE_MIX = (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
_OWNER_MIX = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D)


def _mix(lanes, consts):
    h = _mul32(lanes[0], consts[0])
    for x, k in zip(lanes[1:], consts[1:]):
        h = h ^ _mul32(x, k)
    return h


def table_hash_u32(*lanes):
    """The visited-set slot mix of one to three uint32 lanes (int64
    tensors in [0, 2^32)): the reference's `_UnpackedRep.table_hash` of
    (state, mask_lo, mask_hi), or `_PackedRep.table_hash` of the packed
    word's one or two lanes, bit for bit."""
    h = _mix(lanes, _TABLE_MIX)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x165667B1)
    return h ^ (h >> 13)


def owner_hash_u32(*lanes):
    """The sharded engine's ownership mix of one to three uint32 lanes
    (int64 tensors in [0, 2^32)); the reference's `owner_hash` of either
    row layout, bit for bit. A different mix from `table_hash_u32`: a
    rank's owned rows share their owner hash modulo the ranks, and must
    not share their table slots too."""
    h = _mix(lanes, _OWNER_MIX)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    return h ^ (h >> 12)


def row_table_hash(rows):
    """[n] int64 visited-set hash in [0, 2^32) of rows of either layout:
    the lane count tells them apart (the triple has three lanes, the
    packed word one or two)."""
    return table_hash_u32(*(_u32(r) for r in rows))


def _has_bits(rows, bits):
    """Whether each row has the bit of `bits` (one int32 pattern a lane,
    None for a lane that carries no mask bit) in any lane."""
    acc = None
    for r, b in zip(rows, bits):
        if b is not None:
            acc = r & b if acc is None else acc | (r & b)
    return acc != 0


def _clear_bits(rows, bits, where):
    return tuple(r if b is None else torch.where(where, r & ~b, r)
                 for r, b in zip(rows, bits))


class _RowLayout:
    """What both row layouts share: `lanes` int32 lanes a row, the
    hashes (the lane count's, `row_table_hash`: an insert of rows of
    either layout needs no more of a layout than this), the initial rows
    and the event bit's test and clear over the lanes that carry one."""

    lanes = 3

    def zeros(self, n):
        return tuple(torch.zeros(n, dtype=_I32, device=self.device)
                     for _ in range(self.lanes))

    def initial_at0(self, state0: int, N: int):
        rows = self.zeros(N)
        rows[0][0] = self.field(state0)
        return rows

    def initial_full(self, state0: int, N: int):
        rows = self.zeros(N)
        rows[0].fill_(self.field(state0))
        return rows

    @staticmethod
    def table_hash(rows):
        """[n] int64 slot hash in [0, 2^32)."""
        return row_table_hash(rows)

    @staticmethod
    def owner_hash(rows):
        """[n] int64 ownership hash in [0, 2^32)."""
        return owner_hash_u32(*(_u32(r) for r in rows))

    @staticmethod
    def has_event_bit(rows, bits):
        return _has_bits(rows, bits)

    @staticmethod
    def clear_event_bit(rows, bits, where):
        return _clear_bits(rows, bits, where)


class _UnpackedRep(_RowLayout):
    """The (state, mask_lo, mask_hi) row layout: three int32 lanes."""

    pack = ()

    def __init__(self, C: int, device=None):
        self.C = C
        self.device = device
        self.bit_lo, self.bit_hi = _slot_bits(C, device)

    @staticmethod
    def field(st):
        return st

    @staticmethod
    def state(rows):
        return rows[0]

    @staticmethod
    def sort_keys(rows):
        """The dedupe sort's keys, minor to major: the masks unsigned,
        the state signed (the reference's lexsort of int32 and uint32
        lanes)."""
        return [_u32(rows[2]), _u32(rows[1]), rows[0]]

    def mask_test(self, rows):
        """[..., N, C] bool: slot j already linearized in row n (rows
        [..., N]: one frontier, or a key's each)."""
        _, ml, mh = rows
        return ((ml[..., None] & self.bit_lo)
                | (mh[..., None] & self.bit_hi)) != 0

    def candidates(self, rows, cand_st):
        """Flattened [..., N*C] candidate rows (index n*C + j): state
        from the model step ([..., N, C]), mask with slot j's bit set."""
        _, ml, mh = rows
        return (cand_st.flatten(-2),
                (ml[..., None] | self.bit_lo).flatten(-2),
                (mh[..., None] | self.bit_hi).flatten(-2))

    @staticmethod
    def event_bits(s: int):
        """Slot s's bit, an int32 pattern a lane (None: the state)."""
        return (None, _i32(1 << s) if s < 32 else 0,
                _i32(1 << (s - 32)) if s >= 32 else 0)

    @staticmethod
    def event_bits_t(s):
        """`event_bits` of an int64 tensor of slots, lane by lane."""
        return (None, _bit_lane(s, 0), _bit_lane(s, 32))


class _PackedRep(_RowLayout):
    """The packed word (config_pack): the state field (state - state_lo)
    in bits [0, s_bits), slot j's mask bit at s_bits + j, one int32 lane
    when the word fits 32 bits, else two (its low and high halves). The
    reference's `_PackedRep`, on int32 bit patterns: every right shift
    is masked, and the state field always goes through `smask`."""

    def __init__(self, state_bits: int, state_lo: int, C: int, device=None):
        self.s_bits = int(state_bits)
        self.state_lo = int(state_lo)
        self.C = C
        self.device = device
        self.width = self.s_bits + C
        if not (1 <= self.s_bits <= 32 and 1 <= C and self.width <= 64):
            raise ValueError(f"packed layout: {self.s_bits} state bits "
                             f"and {C} slots do not fit 64 bits")
        self.lanes = 1 if self.width <= 32 else 2
        self.pack = (self.s_bits, self.state_lo)
        self.smask = _i32((1 << self.s_bits) - 1)
        pos = [self.s_bits + j for j in range(C)]
        self.bits = tuple(
            torch.tensor([_i32(1 << (p - base)) if base <= p < base + 32
                          else 0 for p in pos], dtype=_I32, device=device)
            for base in (0, 32)[:self.lanes])

    def field(self, st):
        """The state field of states `st` (an int32 tensor or an int):
        (st - state_lo) & smask, which keeps any state out of the mask
        bits."""
        if isinstance(st, int):
            return _i32((st - self.state_lo) & ((1 << self.s_bits) - 1))
        return (st - self.state_lo) & self.smask

    def state(self, rows):
        return (rows[0] & self.smask) + self.state_lo

    @staticmethod
    def sort_keys(rows):
        """The word's lanes, unsigned, minor to major (the reference's
        lexsort of its uint32 lanes: the low lane is the major key)."""
        return [_u32(r) for r in reversed(rows)]

    def mask_test(self, rows):
        acc = rows[0][..., None] & self.bits[0]
        if self.lanes == 2:
            acc = acc | (rows[1][..., None] & self.bits[1])
        return acc != 0

    def candidates(self, rows, cand_st):
        lo = ((rows[0][..., None] & ~self.smask) | self.field(cand_st)
              | self.bits[0]).flatten(-2)
        if self.lanes == 1:
            return (lo,)
        return lo, (rows[1][..., None] | self.bits[1]).flatten(-2)

    def event_bits(self, s: int):
        p = s + self.s_bits
        return (_i32(1 << p) if p < 32 else 0,
                _i32(1 << (p - 32)) if p >= 32 else 0)[:self.lanes]

    def event_bits_t(self, s):
        p = s + self.s_bits
        return (_bit_lane(p, 0), _bit_lane(p, 32))[:self.lanes]


def _rep(pack, C: int, device=None):
    """The row layout of a (pack, C) pair: pack () is the triple,
    (state_bits, state_lo) the packed word."""
    if pack:
        return _PackedRep(pack[0], pack[1], C, device)
    return _UnpackedRep(C, device)


# ------------------------------------------------- the packed row layout

def _resolve_config_pack(config_pack=None) -> bool:
    """Whether packed rows are asked for: an explicit argument wins, else
    JEPSEN_TPU_TORCH_CONFIG_PACK, a strict tri-state: unset (or empty)
    is off, "1" on, "0" off, anything else raises ValueError. Whether a
    history then packs is `pack_spec_for`'s answer."""
    if config_pack is not None:
        return bool(config_pack)
    raw = os.environ.get("JEPSEN_TPU_TORCH_CONFIG_PACK", "").strip()
    if raw in ("", "0", "1"):
        return raw == "1"
    raise ValueError(f"JEPSEN_TPU_TORCH_CONFIG_PACK={raw!r}: must be '1' "
                     f"(on) or '0' (off); unset it for the default (off)")


def pack_layout(n_states: int, state_lo: int, C: int):
    """The packed word's (state_bits, state_lo) for states in [state_lo,
    state_lo + n_states) and C slots, or None when the word would not
    fit: state_bits + C <= 64 and state_bits <= 32."""
    if n_states <= 0 or C <= 0:
        return None
    state_bits = max(1, int(n_states - 1).bit_length())
    if state_bits > 32 or state_bits + C > 64:
        return None
    return (state_bits, int(state_lo))


def pack_spec_for(encs, C=None):
    """The one packed layout of one or more encoded histories that run as
    one program (a batch pads them to one slot width), or () when any of
    them cannot pack: the state field covers the union [min state_lo,
    max state_lo + n_states), at C (default: the widest key's slots)."""
    if not isinstance(encs, (list, tuple)):
        encs = [encs]
    if not encs or any(e.n_states <= 0 for e in encs):
        return ()
    lo = min(e.state_lo for e in encs)
    hi = max(e.state_lo + e.n_states for e in encs)
    Cw = C if C is not None else max(e.slot_f.shape[1] for e in encs)
    lay = pack_layout(hi - lo, lo, Cw)
    return lay if lay is not None else ()


def pack_lanes(pack, C: int) -> int:
    """int32 lanes of a row: 3 for the triple (pack ()), else 1 when
    state_bits + C fits 32 bits and 2 past that."""
    if not pack:
        return 3
    return 1 if pack[0] + C <= 32 else 2


def pack_rows_np(pack, C: int, st, ml, mh):
    """Canonical (state int32, mask_lo uint32, mask_hi uint32) numpy rows
    -> the packed word's uint32 lanes of the (pack, C) layout: one lane
    when state_bits + C fits 32 bits, else two. A checkpoint keeps the
    canonical triple whatever layout ran; a scan packs it when it
    starts from it."""
    s_bits, s_lo = pack
    word = ((np.asarray(st).astype(np.int64) - s_lo)
            .astype(np.uint64) & np.uint64((1 << s_bits) - 1))
    mask = (np.asarray(ml).astype(np.uint64)
            | (np.asarray(mh).astype(np.uint64) << np.uint64(32)))
    word = word | (mask << np.uint64(s_bits))
    lo = (word & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if s_bits + C <= 32:
        return (lo,)
    return lo, (word >> np.uint64(32)).astype(np.uint32)


def unpack_rows_np(pack, C: int, rows):
    """`pack_rows_np`'s inverse: uint32 lanes -> the canonical (state
    int32, mask_lo uint32, mask_hi uint32) numpy rows."""
    s_bits, s_lo = pack
    lo = np.asarray(rows[0]).astype(np.uint64)
    word = lo if len(rows) == 1 else \
        lo | (np.asarray(rows[1]).astype(np.uint64) << np.uint64(32))
    st = (word & np.uint64((1 << s_bits) - 1)).astype(np.int64) + s_lo
    mask = (word >> np.uint64(s_bits)) \
        & np.uint64((1 << C) - 1 if C < 64 else 0xFFFFFFFFFFFFFFFF)
    ml = (mask & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mh = (mask >> np.uint64(32)).astype(np.uint32)
    return st.astype(np.int32), ml, mh


def _rows_from_canonical(pack, C: int, st, ml, mh, device):
    """Canonical numpy rows ([..., N]) -> the layout's int32 lanes on
    `device` (the masks' uint32 as int32 bit patterns)."""
    if pack:
        lanes = pack_rows_np(pack, C, st, ml, mh)
    else:
        lanes = (np.asarray(st, np.int32), np.asarray(ml, np.uint32),
                 np.asarray(mh, np.uint32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                  .copy()).to(device) for a in lanes)


def carry_fields_np(carry, pack=(), C: int = 0):
    """A scan's carry — its row lanes (int32 tensors or arrays of the
    (pack, C) layout), then any further fields — with the lanes turned
    into the canonical numpy (st int32, ml uint32, mh uint32): the
    inverse of the packing a scan does when it starts from a
    checkpoint (`_rows_from_canonical`). The further fields pass
    through as they are."""
    L = pack_lanes(pack, C)
    lanes = [np.array(r.cpu().numpy() if torch.is_tensor(r) else r)
             .view(np.uint32) for r in carry[:L]]
    if pack:
        rows = unpack_rows_np(pack, C, lanes)
    else:
        rows = (lanes[0].view(np.int32), lanes[1], lanes[2])
    return tuple(rows) + tuple(carry[L:])


def _tag_config_pack(out: dict, pack, requested: bool, C: int) -> dict:
    """The result's "config-pack", only when packing was asked for:
    "packed:{state_bits + C}b/{lanes}-lane", or "unpacked" when the
    history's word would not fit 64 bits and the triple ran."""
    if not requested:
        return out
    if pack:
        out["config-pack"] = f"packed:{pack[0] + C}b/" \
                             f"{pack_lanes(pack, C)}-lane"
    else:
        out["config-pack"] = "unpacked"
    return out


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
    are dropped), on copies. Lanes [N] with pos [M], or [K, N] with pos
    [K, M]: each key's row of pos places into its own row of lanes."""
    n = rows[0].shape[-1]
    keep = (pos >= 0) & (pos < n)
    if pos.dim() == 1:
        at = (pos[keep],)
    else:
        keys = torch.arange(pos.shape[0], device=pos.device)[:, None]
        at = (keys.expand_as(pos)[keep], pos[keep])
    out = []
    for r, v in zip(rows, vals):
        r = r.clone()
        r[at] = v[keep]
        out.append(r)
    return tuple(out)


def _empty_table(T, rep):
    """An empty visited set of T slots (T a shape: (K, T) gives a table
    a key)."""
    return (rep.zeros(T), torch.zeros(T, dtype=torch.bool,
                                      device=rep.device))


# ------------------------------------------------- the visited-set insert

def _hash_insert(c_rows, c_live, table, probe_limit: int, rep):
    """Parallel bounded-linear-probe insert of candidate rows into the
    open-addressed visited set `table` ((rows, occ) of length T).

    Each live candidate probes slots (h + off) & (T - 1), h its table
    hash (`rep`'s).
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
    h0 = rep.table_hash(c_rows)
    idx = torch.arange(M, dtype=_I64, device=dev)
    t_rows = tuple(r.clone() for r in t_rows)
    t_occ = t_occ.clone()
    pending = c_live.clone()
    off = torch.zeros(M, dtype=_I32, device=dev)
    fresh = torch.zeros(M, dtype=torch.bool, device=dev)
    while bool((pending & (off < probe_limit)).any()):
        act = pending & (off < probe_limit)
        slot = (h0 + off) & (T - 1)
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
    count2, n_fresh, append_ovf). Batched: candidates and fresh [K, M],
    lanes [K, N], count [K], each key appending to its own lanes."""
    n_fresh = fresh.sum(-1)
    count_ = count[..., None] if fresh.dim() > 1 else count
    pos = torch.where(fresh, count_ + torch.cumsum(fresh, -1) - 1, N)
    rows2 = _rows_at_set(f_rows, pos, c_rows)
    return (rows2, torch.clamp(count + n_fresh, max=N), n_fresh,
            count + n_fresh > N)


def _hash_insert_append(c_rows, c_live, f_rows, count, table,
                        probe_limit: int, N: int, rep, stats: bool = False):
    """One closure iteration's whole visited-set transaction: the insert
    and the append of its fresh rows. Returns (rows2, table2, count2,
    n_fresh, ovf), `ovf` being probe exhaustion or the append running
    past the N-row frontier; with `stats` a sixth element, the
    probe-length histogram of the attempted (live) candidates."""
    table2, fresh, p_ovf, off = _hash_insert(c_rows, c_live, table,
                                             probe_limit, rep)
    rows2, count2, n_fresh, a_ovf = _append_fresh(c_rows, fresh, f_rows,
                                                  count, N)
    out = (rows2, table2, count2, n_fresh, p_ovf | a_ovf)
    if stats:
        return out + (st._probe_hist(off, c_live),)
    return out


def _hash_event_closure(rep, step, ev, rows, live, run, N: int, T: int,
                        probe_limit: int, insert=None, stats: bool = False):
    """The whole per-event delta-frontier closure (dedupe="hash"), the
    plain version of K2: seed a fresh visited set with the live
    frontier (compacting it), then expand only the delta — the rows
    found by the last iteration — until no fresh row appears. With the
    `insert` hook each iteration's visited-set transaction is K4's
    instead (with `stats` the hook returns the histogram too).

    Returns (rows2, count, ovf, iters, stepped), `stepped` counting the
    configurations expanded during this closure. With `stats` two more:
    `swork`, the configurations a sort closure would have stepped (the
    whole frontier at the start of each iteration), and the
    probe-length histogram [N_PROBE_BUCKETS] over the seed insert and
    every iteration's transaction."""
    if insert is None:
        def insert(c_rows, c_live, f_rows, count, table):
            return _hash_insert_append(c_rows, c_live, f_rows, count,
                                       table, probe_limit, N, rep, stats)
    dev = live.device
    zero = torch.zeros((), dtype=_I64, device=dev)
    seed = insert(rows, live, rep.zeros(N), zero, _empty_table(T, rep))
    rows, table, count, _, ovf = seed[:5]
    n_old = zero
    iters = stepped = swork = zero
    phist = seed[5] if stats else None
    changed = bool(run)
    row = torch.arange(N, device=dev)
    while changed and not bool(ovf):
        cand_st, cand_ok = step(rep.state(rows)[:, None], ev["slot_f"],
                                ev["slot_a0"], ev["slot_a1"],
                                ev["slot_wild"])
        delta = (row >= n_old) & (row < count)
        legal = (delta[:, None] & ev["slot_occ"][None, :]
                 & ~rep.mask_test(rows) & cand_ok)
        ins = insert(rep.candidates(rows, cand_st), legal.reshape(-1),
                     rows, count, table)
        rows, table, count2, n_fresh, ins_ovf = ins[:5]
        stepped = stepped + (count - n_old)
        if stats:
            swork = swork + count
            phist = phist + ins[5]
        n_old, count = count, count2
        ovf = ovf | ins_ovf
        iters = iters + 1
        changed = bool(n_fresh > 0)
    if stats:
        return rows, count, ovf, iters, stepped, swork, phist
    return rows, count, ovf, iters, stepped


def _step_batch(step, rep, rows, ev):
    """The model step of every row of every key ([K, N] lanes) through
    every slot of its key's event (ev: [K, C] tables) -> [K, N, C]."""
    return step(rep.state(rows)[:, :, None], ev["slot_f"][:, None, :],
                ev["slot_a0"][:, None, :], ev["slot_a1"][:, None, :],
                ev["slot_wild"][:, None, :])


def _hash_event_closure_batch(rep, step, ev, rows, live, run, N: int,
                              T: int, insert, stats: bool = False):
    """K keys' hash closures of one event row at once (ev: [K, C] slot
    tables, rows [K, N] lanes, live [K, N], run [K]): each key's is
    `_hash_event_closure`'s, with `insert` a batched visited-set
    transaction over [K, M] candidates and a table a key. A key closes
    while it has fresh rows and no overflow, as the reference's
    while_loop under vmap does: one whose closure has ended keeps its
    rows, table, count and counters, and its insert has no live
    candidate. A key whose `run` is False seeds nothing: zero rows and
    zero meta, as K2 writes. The host reads one flag an iteration (does
    any key still close).

    Returns (rows2, count, ovf, iters, stepped), each [K]-leading; with
    `stats` (the insert then returns each key's histogram [K, 7] too)
    also swork [K] and phist [K, N_PROBE_BUCKETS], as
    `_hash_event_closure` gives each key."""
    K = live.shape[0]
    dev = live.device
    zero = torch.zeros(K, dtype=_I64, device=dev)
    seed = insert(rows, live & run[:, None], rep.zeros((K, N)), zero,
                  _empty_table((K, T), rep))
    rows, table, count, _, ovf = seed[:5]
    n_old = iters = stepped = swork = zero
    phist = seed[5] if stats else None
    active = run & ~ovf
    row = torch.arange(N, device=dev)
    occ = ev["slot_occ"][:, None, :]
    while bool(active.any()):
        cand_st, cand_ok = _step_batch(step, rep, rows, ev)
        delta = (row >= n_old[:, None]) & (row < count[:, None]) \
            & active[:, None]
        legal = delta[:, :, None] & occ & ~rep.mask_test(rows) & cand_ok
        ins = insert(rep.candidates(rows, cand_st), legal.flatten(1), rows,
                     count, table)
        rows, table, count2, n_fresh, ins_ovf = ins[:5]
        stepped = stepped + torch.where(active, count - n_old, 0)
        if stats:
            swork = swork + torch.where(active, count, 0)
            phist = phist + ins[5]
        iters = iters + active.to(_I64)
        n_old = torch.where(active, count, n_old)
        count = count2
        ovf = ovf | ins_ovf
        active = active & (n_fresh > 0) & ~ovf
    if stats:
        return rows, count, ovf, iters, stepped, swork, phist
    return rows, count, ovf, iters, stepped


# ----------------------------------------------------------- sort dedupe

def _dedupe_compact(rows, live, N: int, rep):
    """Sort rows by (dead, lanes major to minor) — (state, mask_lo,
    mask_hi), the masks unsigned, for the triple; the packed word's
    lanes unsigned, the low one major — flag first occurrences and
    compact them into a fresh [N] frontier. Returns (rows, live, count,
    overflow). The order is the reference's lexsort, built from stable
    sorts from the minor key to the major one."""
    out = _dedupe_compact_batch(tuple(r[None] for r in rows), live[None],
                                N, rep)
    return tuple(r[0] for r in out[0]), out[1][0], out[2][0], out[3][0]


def _dedupe_compact_batch(rows, live, N: int, rep):
    """`_dedupe_compact` of K keys at once (lanes and live [K, M]): each
    key's rows sorted and compacted into its own [N] frontier, in the
    order of the reference's lexsort with the key as its most
    significant key (every sort runs along a key's row). Returns (rows
    [K, N], live [K, N], count [K], overflow [K])."""
    K, M = live.shape
    order = torch.arange(M, device=live.device).expand(K, M)
    for key in (*rep.sort_keys(rows), (~live).to(_I32)):
        order = order.gather(1, torch.sort(key.gather(1, order), dim=1,
                                           stable=True).indices)
    rows_s = tuple(r.gather(1, order) for r in rows)
    live_s = live.gather(1, order)
    same = rows_s[0][:, 1:] == rows_s[0][:, :-1]
    for r in rows_s[1:]:
        same = same & (r[:, 1:] == r[:, :-1])
    uniq = live_s.clone()
    uniq[:, 1:] &= ~same
    count = uniq.sum(1)
    pos = torch.where(uniq, torch.cumsum(uniq, 1) - 1, M + N)
    new_rows = _rows_at_set(rep.zeros((K, N)), pos, rows_s)
    new_live = torch.arange(N, device=live.device) < count[:, None]
    return new_rows, new_live, count, count > N


def _sort_event_closure(rep, step, ev, rows, live, run, N: int):
    """The per-event closure under dedupe="sort": every iteration steps
    the whole live frontier and deduplicates all N*(C+1) rows by sort.
    Returns (rows2, live2, ovf, iters, stepped)."""
    out = _sort_event_closure_batch(
        rep, step, {k: v[None] for k, v in ev.items()},
        tuple(r[None] for r in rows), live[None], run.reshape(1), N)
    return (tuple(r[0] for r in out[0]),) + tuple(x[0] for x in out[1:])


def _sort_event_closure_batch(rep, step, ev, rows, live, run, N: int):
    """`_sort_event_closure` of K keys at once (ev [K, C], rows and live
    [K, N], run [K]): a key iterates while its frontier grows and does
    not overflow, the others keep theirs. Plain PyTorch on any device;
    the host reads one flag an iteration. Returns (rows2, live2, ovf,
    iters, stepped), each [K]-leading."""
    K = live.shape[0]
    dev = live.device
    ovf = torch.zeros(K, dtype=torch.bool, device=dev)
    iters = stepped = torch.zeros(K, dtype=_I64, device=dev)
    occ = ev["slot_occ"][:, None, :]
    active = run.clone()
    while bool(active.any()):
        cand_st, cand_ok = _step_batch(step, rep, rows, ev)
        legal = live[:, :, None] & occ & ~rep.mask_test(rows) & cand_ok
        old_count = live.sum(1)
        rows2, live2, count, ovf2 = _dedupe_compact_batch(
            tuple(torch.cat([a, b], 1) for a, b in
                  zip(rows, rep.candidates(rows, cand_st))),
            torch.cat([live, legal.flatten(1)], 1), N, rep)
        go = active[:, None]
        rows = _rows_where(go, rows2, rows)
        live = torch.where(go, live2, live)
        ovf = torch.where(active, ovf2, ovf)
        iters = iters + active.to(_I64)
        stepped = stepped + torch.where(active, old_count, 0)
        active = active & (count > old_count) & ~ovf2
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


def _route(N: int, C: int, dedupe: str, device, smem_budget=None,
           lanes: int = 3):
    """-> "sort", "fused" (K2) or "tiled" (K4). The hash closure is fused
    while K2's shared-memory layout of `lanes`-lane rows fits the
    budget, and tiled past it; the budget is the card's opt-in on a
    card, Hopper's on the CPU, or the test seam `smem_budget`. Both hash
    routes run the reference's whole-table transaction, so both give
    the reference's results."""
    if dedupe == "sort":
        return "sort"
    budget = smem_budget or sk.smem_budget(device)
    return "fused" if sk.supported(N, C, budget, lanes) else "tiled"


def _sort_extra(d):
    """The stats a sort closure gives (swork, then the histogram): swork
    is the configurations it stepped, the histogram zeros."""
    return torch.cat([d.reshape(*d.shape, 1).to(_I64),
                      torch.zeros((*d.shape, st.N_PROBE_BUCKETS),
                                  dtype=_I64, device=d.device)], -1)


class _Scan:
    """One history's scan at frontier capacity N on one device. The
    carry — rows, live, ok, fail_r, max-frontier, iterations,
    configs-stepped and the overflow flag — stays on the device; the
    event index `r_idx` (the real events scanned so far) on the host.
    With `stats` each event writes its stats row into `traj` [R, 5] and
    `phist` [R, 7] (`search_stats.new_trajectories`), on the device.

    `carry` (`engine.FrontierCheckpoint.carry`'s tensors: the row lanes
    of this scan's layout, live, ok, fail_r, the event index, maxf,
    steps_n, stepped) starts the scan from it instead of the initial
    carry: the resumable check and the streaming sessions scan a chunk
    [lo, hi) of events from a checkpoint (`run_range`), and `carry_np`
    reads the carry back as a checkpoint's canonical arrays."""

    def __init__(self, e: EncodedHistory, N: int, dedupe: str,
                 probe_limit: int, device, smem_budget=None, xs=None,
                 pack=(), stats: bool = False, cancel=None, carry=None):
        C = e.slot_f.shape[1]
        self.e, self.N, self.C = e, N, C
        self.cancel = cancel
        self.T = _next_pow2(2 * N)
        self.probe_limit = probe_limit
        self.device = device
        self.rep = _rep(pack, C, device)
        self.step = STEPS[e.step_name]
        self.xs = _xs(e, device) if xs is None else xs
        self.closure = _route(N, C, dedupe, device, smem_budget,
                              self.rep.lanes)
        # the fused closure on a card is the one route that never needs
        # a value on the host during the scan
        self.synced = self.closure != "fused" or device.type != "cuda"
        self.overflow = torch.zeros((), dtype=torch.bool, device=device)
        if carry is None:
            z = torch.zeros((), dtype=_I64, device=device)
            self.rows = self.rep.initial_at0(e.state0, N)
            self.live = torch.arange(N, device=device) < 1
            self.ok = torch.ones((), dtype=torch.bool, device=device)
            self.fail_r = z - 1
            self.maxf = z + 1
            self.steps_n = z
            self.stepped = z
            self.r_idx = 0
        else:
            L = self.rep.lanes
            if len(carry) != L + 7 or carry[L].shape != (N,):
                raise ValueError(f"not a carry of {L}-lane rows at "
                                 f"capacity {N}")
            self.rows = tuple(carry[:L])
            (self.live, self.ok, self.fail_r, r_idx, self.maxf,
             self.steps_n, self.stepped) = carry[L:]
            self.r_idx = int(r_idx)
        self.stats = stats
        if stats:
            self.traj, self.phist = st.new_trajectories(e.n_returns, device)

    def _ev(self, r: int) -> dict:
        return {k: v[r] for k, v in self.xs.items()}

    def _closure(self, r: int, run):
        """-> (rows2, live2, ovf, iters, stepped, extra) of event r; with
        stats `extra` is [8]: swork, then the probe-length histogram."""
        ev = self._ev(r)
        N = self.N
        if self.closure == "sort":
            out = _sort_event_closure(self.rep, self.step, ev, self.rows,
                                      self.live, run, N)
            return out + ((_sort_extra(out[4]) if self.stats else None),)
        kw = {"stats": True} if self.stats else {}
        if self.closure == "fused":
            res = sk.frontier_closure(
                self.e.step_name, ev, self.rows, self.live, run,
                self.probe_limit, **_pack_kw(self.rep), **kw)
        else:
            res = sk.tiled_event_closure(
                self.rep, self.step, ev, self.rows, self.live, run, N,
                self.T, self.probe_limit, **kw)
        rows2, meta = res[:2]
        live2 = torch.arange(N, device=self.device) < meta[0]
        return (rows2, live2, meta[1] != 0, meta[2], meta[3],
                res[2] if self.stats else None)

    def run(self, n_events: int):
        """Scan return events 0..n_events-1 (`run_range(0, n_events)`)."""
        return self.run_range(0, n_events)

    def run_range(self, lo: int, hi: int):
        """Scan the event rows [lo, hi) of the tables from the carry. A
        pad row (ev_slot < 0) leaves the carry as it is, the event index
        too; every other row advances the index, whether or not it
        runs, and a failure records the index of its event. The fused
        closure never makes the host wait; the others read `ok` anyway,
        and stop the scan once it is False (nothing changes after that
        but the index)."""
        ev_slot = self.e.ev_slot
        for r in range(lo, hi):
            s = int(ev_slot[r])
            if s < 0:
                continue
            poll_cancel(self.cancel)
            if self.synced and not bool(self.ok):
                self.r_idx += int((ev_slot[r:hi] >= 0).sum())
                break
            run = self.ok
            rows2, live2, ovf, iters, d, extra = self._closure(r, run)
            # a settled event's probe flag must not trigger escalation
            ovf = run & ovf
            bits = self.rep.event_bits(s)
            live3 = live2 & self.rep.has_event_bit(rows2, bits)
            rows3 = self.rep.clear_event_bit(rows2, bits, live3)
            failed_here = run & ~live3.any()
            self.fail_r = torch.where(failed_here & (self.fail_r < 0),
                                      self.r_idx, self.fail_r)
            self.r_idx += 1
            self.ok = torch.where(run, ~failed_here & ~ovf, self.ok)
            self.rows = _rows_where(run, rows3, self.rows)
            self.live = torch.where(run, live3, self.live)
            self.maxf = torch.maximum(
                self.maxf, torch.where(run, live2.sum(), 0))
            self.steps_n = self.steps_n + torch.where(run, iters, 0)
            self.stepped = self.stepped + torch.where(run, d, 0)
            self.overflow = self.overflow | ovf
            if self.stats:
                # width -1 (not run) drops the event's whole row
                row = torch.cat([torch.stack([
                    torch.where(run, live3.sum(), -1), live2.sum(),
                    iters.to(_I64), d.to(_I64)]), extra.to(_I64)])
                self.traj[r] = row[:5]
                self.phist[r] = row[5:]
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

    def carry_np(self):
        """-> ((st, ml, mh, live, ok, fail_r, r_idx, maxf, steps_n,
        stepped), overflow): the carry as a checkpoint's canonical
        numpy arrays and Python values (`engine.FrontierCheckpoint`'s
        fields), and whether the scan overflowed."""
        st_, ml, mh = carry_fields_np(self.rows, self.rep.pack, self.C)
        ok, fail_r, maxf, steps_n, stepped, ovf = torch.stack([
            self.ok.to(_I64), self.fail_r.to(_I64), self.maxf.to(_I64),
            self.steps_n.to(_I64), self.stepped.to(_I64),
            self.overflow.to(_I64)]).tolist()
        return ((st_, ml, mh, self.live.cpu().numpy().copy(), bool(ok),
                 fail_r, self.r_idx, maxf, steps_n, stepped), bool(ovf))


def _pack_kw(rep) -> dict:
    """K2's layout argument: none for the triple (the wrappers' default),
    so that a call of the unpacked scan is the same call as ever."""
    return {"pack": rep.pack} if rep.pack else {}


def _closure_tag(closure: str, device) -> str:
    """The result's "closure": which implementation ran the closure —
    bitdense's vocabulary plus the tiled insert. The sort closure is
    plain PyTorch on any device."""
    kind = "cuda" if device.type == "cuda" and closure != "sort" \
        else "torch"
    return kind + "-tiled" if closure == "tiled" else kind


def route_tag(N: int, C: int, dedupe: str, device, smem_budget=None,
              pack=()) -> str:
    """The "closure" a scan at capacity N and slot width C would report
    (`_route`, then `_closure_tag`): what a resumed check that scans no
    event says."""
    return _closure_tag(_route(N, C, dedupe, device, smem_budget,
                               pack_lanes(pack, C)), device)


def check_encoded(e: EncodedHistory, capacity: int = 1024,
                  max_capacity: int = 1 << 20, device=None,
                  dedupe=None, probe_limit: int = 0,
                  config_pack=None, smem_budget=None,
                  search_stats=None, cancel=None) -> dict:
    """Check one encoded history on the sparse engine, doubling the
    frontier capacity on overflow, with the result schema of
    `jepsen_tpu.parallel.engine.check_encoded`.

    `dedupe` is "hash" (default; JEPSEN_TPU_TORCH_DEDUPE) or "sort";
    under "hash" the closure is K2 while its shared-memory layout fits,
    else K2's plain closure around the tiled insert K4 ("closure":
    "cuda" / "cuda-tiled" on a card, "torch" / "torch-tiled" on the
    CPU). `probe_limit` bounds the hash probes (0: the
    JEPSEN_TPU_TORCH_PROBE_LIMIT flag, default 32). `config_pack` (None:
    JEPSEN_TPU_TORCH_CONFIG_PACK, default off) carries each row as the
    packed word of `pack_spec_for(e)` (one or two lanes; the triple when
    the word would pass 64 bits) and tags the result's "config-pack".
    `smem_budget` is a test seam that replaces the shared-memory budget
    of the route. Past `max_capacity` the verdict is "unknown".
    `search_stats` (None: JEPSEN_TPU_TORCH_SEARCH_STATS, default off)
    adds the "stats" block of the deciding tier, "capacity-tier" the
    doublings before it. The scan raises `bitdense.Cancelled` at the
    first event after `cancel` is set."""
    if e.n_returns == 0:
        return {"valid?": True, "max-frontier": 0, "capacity": 0}
    dev = resolve_device(device)
    dedupe = _resolve_dedupe(dedupe)
    probe_limit = _resolve_probe_limit(probe_limit)
    pack_req = _resolve_config_pack(config_pack)
    ss = st._resolve_search_stats(search_stats)
    pack = pack_spec_for(e) if pack_req else ()
    xs = _xs(e, dev)
    N = max(64, capacity)
    n_esc = 0
    C = e.slot_f.shape[1]
    t0 = perf_counter()
    with obs.span("engine.search", returns=e.n_returns,
                  dedupe=dedupe) as sp:
        while True:
            sc = _Scan(e, N, dedupe, probe_limit, dev, smem_budget, xs,
                       pack, stats=ss, cancel=cancel)
            with obs.device_annotation(f"sparse single N{N} C{C}"):
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
            n_esc += 1
            obs.counter("engine.capacity_escalations").inc()
        sp.set(capacity=N)
        tag = _closure_tag(sc.closure, dev)
        if tag.startswith("cuda"):
            # only when a kernel ran: the plain run's trace schema is
            # the reference's with its kernel off
            sp.set(closure=tag)
    obs.counter("engine.configs_stepped").inc(int(stepped))
    out = {"valid?": valid, "max-frontier": maxf, "capacity": N,
           "dedupe": dedupe, "configs-stepped": stepped,
           "explored": steps_n * N * e.slot_f.shape[1],
           "closure": _closure_tag(sc.closure, dev)}
    _tag_config_pack(out, pack, pack_req, e.slot_f.shape[1])
    if ss:
        acc = st.SearchStats(dedupe)
        acc.escalations = n_esc
        acc.add_chunk(st.trajectories_np(sc.traj, sc.phist), N)
        out["stats"] = st.finish_stats_block(st.block_of(acc), t0,
                                             perf_counter())
    if not valid:
        out.update(fail_op_fields(e, fail_r))
    return out


# ------------------------------------------------------ batched (per-key)

class _BatchScan:
    """K keys' scans at frontier capacity N as one, on one device, over a
    padded batch (`encode.pad_batch`): rows [K, N] lanes, live [K, N],
    and per key ok, fail_r, max-frontier, configs-stepped and the
    overflow flag, all on the device. Every key uses the first key's
    step family, as the reference's batch does (`pre[0].step_name`).

    Per event row a key runs when it has not failed or overflowed and
    the event is real (ev_slot >= 0, else the key's carry stays as it
    is, its event index too); its closure is the route's —
    batched K2 ("fused": one launch for every key), the tiled closure
    around batched K4 ("tiled": one launch a closure iteration for
    every key) or the sort closure — then the filter and carry of
    `_Scan.run` on [K, ...] tensors. The fused route on a card reads
    nothing from the device until the end; the others read a flag a
    closure iteration, and skip a row no key runs. With `stats` each
    row writes every key's stats into `traj` [K, R, 5] and `phist`
    [K, R, 7], on the device.

    `carry` (K keys' carries stacked, as `_Scan`'s: lanes and live
    [K, N], the rest [K]) starts each key from its own: the streaming
    sessions' batched leg, whose keys' chunks of different real lengths
    share the padded rows; `carry_np` reads the carries back."""

    def __init__(self, encs, xs: dict, state0, N: int, dedupe: str,
                 probe_limit: int, device, smem_budget=None, pack=(),
                 stats: bool = False, carry=None):
        K, R, C = xs["slot_f"].shape
        self.K, self.R, self.N, self.C = K, R, N, C
        self.T = _next_pow2(2 * N)
        self.probe_limit = probe_limit
        self.device = device
        self.step_name = encs[0].step_name
        self.step = STEPS[self.step_name]
        # the batch's one layout, its lanes at this tier's C
        self.rep = _rep(pack, C, device)
        self.closure = _route(N, C, dedupe, device, smem_budget,
                              self.rep.lanes)
        self.synced = self.closure != "fused" or device.type != "cuda"
        # key-major [K, R, C]: batched K2 reads row r of key k in place
        self.xs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in xs.items() if k != "ev_slot"}
        ev = torch.from_numpy(np.ascontiguousarray(xs["ev_slot"].T)) \
            .to(device=device, dtype=_I64)                          # [R, K]
        self.real = ev >= 0
        # the returning slot's bit, as int32 bit patterns of each lane
        self.bits = self.rep.event_bits_t(ev.clamp(min=0))
        self.overflow = torch.zeros(K, dtype=torch.bool, device=device)
        if carry is None:
            z = torch.zeros(K, dtype=_I64, device=device)
            self.rows = self.rep.zeros((K, N))
            s0 = torch.from_numpy(np.asarray(state0, np.int32)).to(device)
            self.rows[0][:, 0] = self.rep.field(s0)
            self.live = (torch.arange(N, device=device) < 1).expand(K, N)
            self.ok = torch.ones(K, dtype=torch.bool, device=device)
            self.fail_r = z - 1
            self.maxf = z + 1
            self.steps_n = z
            self.stepped = z
            r_idx0 = z
        else:
            L = self.rep.lanes
            if len(carry) != L + 7 or carry[L].shape != (K, N):
                raise ValueError(f"not a carry of {K} keys' {L}-lane rows "
                                 f"at capacity {N}")
            self.rows = tuple(carry[:L])
            (self.live, self.ok, self.fail_r, r_idx0, self.maxf,
             self.steps_n, self.stepped) = carry[L:]
        # the event index of each key's event at each row (pad rows do
        # not advance it), and each key's index after the last row
        n_real = torch.cumsum(self.real.to(_I64), 0)
        self.ridx = r_idx0 + n_real - self.real.to(_I64)          # [R, K]
        self.r_idx = r_idx0 + n_real[-1] if R else r_idx0
        self.stats = stats
        if stats:
            self.traj, self.phist = st.new_trajectories(R, device, (K,))

    def _closure(self, r: int, run):
        """-> (rows2, live2, ovf, iters, stepped, extra) of event row r,
        [K]-leading; with stats `extra` is [K, 8] (swork, then the
        histogram)."""
        N = self.N
        if self.closure == "sort":
            ev = {k: v[:, r] for k, v in self.xs.items()}
            out = _sort_event_closure_batch(
                self.rep, self.step, ev, self.rows, self.live, run, N)
            return out + ((_sort_extra(out[4]) if self.stats else None),)
        kw = {"stats": True} if self.stats else {}
        if self.closure == "fused":
            res = sk.frontier_closure_batch(
                self.step_name, self.xs, r, self.rows, self.live, run,
                self.probe_limit, **_pack_kw(self.rep), **kw)
        else:
            ev = {k: v[:, r] for k, v in self.xs.items()}
            res = sk.tiled_event_closure_batch(
                self.rep, self.step, ev, self.rows, self.live, run, N,
                self.T, self.probe_limit, **kw)
        rows2, meta = res[:2]
        live2 = torch.arange(N, device=self.device) < meta[:, 0, None]
        return (rows2, live2, meta[:, 1] != 0, meta[:, 2].to(_I64),
                meta[:, 3].to(_I64), res[2] if self.stats else None)

    def run(self):
        for r in range(self.R):
            run = self.ok & self.real[r]
            if self.synced and not bool(run.any()):
                continue     # no key runs: the carry stays as it is
            rows2, live2, ovf, iters, d, extra = self._closure(r, run)
            # a settled or padded event's probe flag must not trigger
            # escalation
            ovf = run & ovf
            bits = tuple(None if b is None else b[r][:, None]
                         for b in self.bits)
            live3 = live2 & _has_bits(rows2, bits)
            rows3 = _clear_bits(rows2, bits, live3)
            failed_here = run & ~live3.any(1)
            self.fail_r = torch.where(failed_here & (self.fail_r < 0),
                                      self.ridx[r], self.fail_r)
            self.ok = torch.where(run, ~failed_here & ~ovf, self.ok)
            go = run[:, None]
            self.rows = _rows_where(go, rows3, self.rows)
            self.live = torch.where(go, live3, self.live)
            self.maxf = torch.maximum(
                self.maxf, torch.where(run, live2.sum(1), 0))
            self.steps_n = self.steps_n + torch.where(run, iters, 0)
            self.stepped = self.stepped + torch.where(run, d, 0)
            self.overflow = self.overflow | ovf
            if self.stats:
                row = torch.cat([torch.stack([
                    torch.where(run, live3.sum(1), -1), live2.sum(1), iters,
                    d], 1), extra.to(_I64)], 1)
                self.traj[:, r] = row[:, :5]
                self.phist[:, r] = row[:, 5:]
        return self

    def result(self):
        """(valid, fail_r, overflow, maxf, stepped), lists of K Python
        values: the scan's one read of the device."""
        valid = self.ok & self.live.any(1) & ~self.overflow
        vals = torch.stack([valid.to(_I64), self.fail_r,
                            self.overflow.to(_I64), self.maxf,
                            self.stepped]).tolist()
        return ([bool(v) for v in vals[0]], vals[1],
                [bool(v) for v in vals[2]], vals[3], vals[4])

    def carry_np(self):
        """-> (carries, overflow): each key's carry as `_Scan.carry_np`
        gives it (the canonical rows at this batch's C), and whether it
        overflowed; one read of the device."""
        st_, ml, mh = carry_fields_np(self.rows, self.rep.pack, self.C)
        live = self.live.cpu().numpy()
        vals = torch.stack([
            self.ok.to(_I64), self.fail_r, self.r_idx, self.maxf,
            self.steps_n, self.stepped, self.overflow.to(_I64)]).tolist()
        carries = [(st_[k].copy(), ml[k].copy(), mh[k].copy(),
                    live[k].copy(), bool(vals[0][k]), vals[1][k],
                    vals[2][k], vals[3][k], vals[4][k], vals[5][k])
                   for k in range(self.K)]
        return carries, [bool(v) for v in vals[6]]


def _bit_lane(s, base: int):
    """The int32 bit pattern of slot s's bit in the mask lane of slots
    [base, base + 32) (0 outside it), for an int64 tensor of slots."""
    b = s - base
    inside = (b >= 0) & (b < 32)
    v = torch.where(inside, torch.ones_like(b) << b.clamp(0, 31), 0)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(_I32)


def check_batch_sparse(encs, capacity: int = 512,
                       max_capacity: int = 1 << 18, dedupe=None,
                       device=None, smem_budget=None, *, escalate,
                       probe_limit: int = 0, config_pack=None,
                       search_stats=None, mesh=None, pad=None, pack=None,
                       ranks=None) -> list:
    """The reference's sparse per-key batch with per-key capacity retry
    (`jepsen_tpu.parallel.engine._check_batch_sparse`): every key runs
    in one batched scan (`_BatchScan`) at N = max(64, capacity); a key
    that overflows runs again at 2N with the other pending keys, padded
    anew to their own dims (R and C of the pending keys only). A key
    decided at N gets {"valid?", "max-frontier", "capacity": N, "dedupe",
    "configs-stepped", "closure"} (+ the failing op's fields); a key
    still pending when 2N passes `max_capacity` gets `escalate(e, N)`
    (engine._escalate_overflow). Results keep `encs`' order.

    `dedupe` "hash" (default; JEPSEN_TPU_TORCH_DEDUPE) or "sort";
    `smem_budget` is the test seam of `_route`, `probe_limit` the hash
    probes' bound (0: the flag). `config_pack` (None: the flag) asks for
    packed rows: the batch's one layout is `pack_spec_for` of every key
    at the batch's first (widest) C, fixed for every tier; a tier's
    lanes follow its own C, and the tag names the batch's C.
    `search_stats` (None: the flag) gives each key decided here the
    stats block of its tier ("capacity-tier" the tiers climbed) with the
    reference's pad extras against the tier's padded R and C.

    `mesh` (a DeviceMesh) shards every tier's pending keys over its ranks
    (`encode.place_batch`, `ranks` placing the first tier's instead):
    each rank scans its keys, padded to the dims of every pending key,
    and the results are all-gathered, so every rank knows the next
    tier's keys and escalates the same keys, in input order, together.
    Every rank of the mesh calls it. `pad` (C, R) fixes every tier's
    padded dims and `pack` the layout (the stealing executor's rounds
    pad to their bucket's). Each key's search-stats record carries its
    index in `encs`, but under `pad`: a stealing round's keys are not
    its batch's, and its records carry no key, as the reference's."""
    dev = resolve_device(device)
    dedupe = _resolve_dedupe(dedupe)
    probe_limit = _resolve_probe_limit(probe_limit)
    pack_req = _resolve_config_pack(config_pack)
    ss = st._resolve_search_stats(search_stats)
    C = max(e.slot_f.shape[1] for e in encs) if encs else 0
    if pad is not None:
        C = pad[0]
    if pack is None:
        pack = pack_spec_for(list(encs), C) if pack_req and encs else ()
    plan = None
    if mesh is not None:
        from jepsen_tpu_torch.parallel.meshplan import MeshPlan
        plan = MeshPlan.flat(mesh)
    out: list = [None] * len(encs)
    pending = list(range(len(encs)))
    N = max(64, capacity)
    n_tier = 0
    while pending:
        encs_t = [encs[i] for i in pending]
        # C is the widest pending key's, with no floor (the dense
        # batch's is 5); with a mesh, of every rank's pending keys
        at = ranks if n_tier == 0 else None
        xs, state0, _, C_pad, R_pad = pad_batch(
            encs_t, min_slots=pad[0] if pad else 1,
            min_returns=pad[1] if pad else 0, mesh=mesh, ranks=at)
        mine = list(range(len(pending)))
        if mesh is not None:
            mine = place_batch(len(pending), mesh, at)
        got = []
        t0 = perf_counter()
        with obs.span("engine.sparse_batch", keys=len(pending),
                      capacity=N, dedupe=dedupe):
            if mine:
                sub = [encs_t[j] for j in mine]
                with obs.device_annotation(
                        f"sparse K{len(pending)} N{N} C{C_pad}"):
                    sc = _BatchScan(sub, xs, state0, N, dedupe,
                                    probe_limit, dev, smem_budget, pack,
                                    stats=ss).run()
                    res = sc.result()
        t1 = perf_counter()
        if mine:
            valid, fail_r, overflow, maxf, stepped = res
            tag = _closure_tag(sc.closure, dev)
            ys = st.trajectories_np(sc.traj, sc.phist) if ss else None
            for j, e in enumerate(sub):
                if overflow[j]:
                    got.append(None)
                    continue
                r = {"valid?": valid[j], "max-frontier": maxf[j],
                     "capacity": N, "dedupe": dedupe,
                     "configs-stepped": stepped[j], "closure": tag}
                _tag_config_pack(r, pack, pack_req, C)
                if ys is not None:
                    acc = st.SearchStats(dedupe)
                    acc.escalations = n_tier
                    acc.add_chunk({k: v[j] for k, v in ys.items()}, N)
                    waste = 1.0 - ((e.n_returns * e.slot_f.shape[1])
                                   / max(1, R_pad * C_pad))
                    # the sinks take it below, on every rank
                    r["stats"] = st.block_of(
                        acc, extra={"pad-waste": round(waste, 6),
                                    "pad-events": int(R_pad - e.n_returns),
                                    "pad-slots": int(C_pad
                                                     - e.slot_f.shape[1])})
                if not valid[j]:
                    r.update(fail_op_fields(e, fail_r[j]))
                got.append(r)
        if plan is not None:
            got = plan.gather_keys(len(pending), mine, got)
        retry = []
        for i, r in zip(pending, got):
            if r is None:
                retry.append(i)
                continue
            # counted and recorded for every key of the mesh's batch on
            # every rank, as the reference's one program does
            obs.counter("engine.configs_stepped").inc(
                int(r["configs-stepped"]))
            if r.get("stats") is not None:
                st.finish_stats_block(r["stats"], t0, t1,
                                      key=i if pad is None else None)
            out[i] = r
        if not retry:
            break
        if N * 2 > max_capacity:
            for i in retry:
                out[i] = escalate(encs[i], N)
            break
        # keys that overflowed run again at the doubled tier
        obs.counter("engine.overflow_redispatch").inc(len(retry))
        pending = retry
        N *= 2
        n_tier += 1
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
