"""Seeded inputs on which the sparse kernels K2 and K4 are held against
their plain versions: by the CPU tests (the plain versions against each
other and against the reference) and by the `cuda` tests and
chip_smoke.py, which loads this file by its path (each kernel against
its plain version, bit for bit).

Every case is made from a fixed numpy seed, as CPU tensors; a caller
moves it to its device. Each one aims at a part of a kernel's design:

  * K2 (`k2_cases`): passes of at most 32 candidates (warp 0 alone), of
    more than 32 and more than 1,024 candidates (in registers, or past
    them in shared memory), a frontier that overflows past N, C = 33 and
    64, N = 2,048 and 4,096 (a seed past the registers), and
    probe_limit 2 with the probe overflow raised.
  * K4 (`k4_cases`): live candidates picked by their hash's low bits
    (the names say how the inputs were drawn: the hash-range tiles and
    512-candidate chunks of the TPU kernel's plan, which K4 does not
    take), so that many or few race for slots; equal rows near and far
    apart in the list; probe_limit 1 and 2 with the probe overflow
    raised; and a few live candidates among 50,000 on a table already
    half full. `k4_wide_case`: more live candidates than the grid's
    threads, so that their probe state lives in the scratch.
  * K4 batched over keys (`k4_batch_cases`): keys with their own tables
    side by side — one with no live candidate (a key whose closure has
    ended), two with the same candidates on different tables, one on a
    half-full table — at probe_limit 32 and 2.

Packed rows (config_pack: the word (state - state_lo) | mask <<
state_bits in one or two int32 lanes, `sparse._PackedRep`):

  * K2 (`packed_k2_cases`): one lane and two; slot bits on both sides of
    the lane boundary (bit 31 | 32); a state field at its top value
    (one lane of 4 state bits, and a 32-bit field whose lane 0 is the
    state alone, values >= 2^31 among them); equal words that differ only
    in the state field, and duplicates that meet from different rows;
    N = 4,096 at one lane (past the triple's gate), probe_limit 2.
  * K3 (`packed_k3_cases`) and K4 (`packed_k4_cases`,
    `packed_k4_batch_cases`): words over the whole 32-bit range at one
    lane and two, equal words near and far apart, tables already holding
    some of them, probe_limit 1 and 2, an append past N (K3).

`record_calls` keeps the inputs a check hands to a wrapper of
`sparse_kernels` (the batched K2 and K4 parity runs record theirs from
the sparse batch itself).
"""

from __future__ import annotations

import numpy as np
import torch

from jepsen_tpu_torch.models import F_ADD, F_DEQ, F_ENQ, F_READ, F_WRITE
from jepsen_tpu_torch.parallel import sparse as sp

_I32 = torch.int32


def _ev(f, a0, a1, wild, occ) -> dict:
    return {"slot_f": torch.tensor(f, dtype=_I32),
            "slot_a0": torch.tensor(a0, dtype=_I32),
            "slot_a1": torch.tensor(a1, dtype=_I32),
            "slot_wild": torch.tensor(wild, dtype=torch.bool),
            "slot_occ": torch.tensor(occ, dtype=torch.bool)}


def _frontier(N: int, rows: list):
    """An N-row frontier with `rows` ((index, state, mask bits)) live."""
    st, ml, mh = (np.zeros(N, np.int64) for _ in range(3))
    live = np.zeros(N, bool)
    for i, s, bits in rows:
        st[i] = s
        for b in bits:
            (ml if b < 32 else mh)[i] |= 1 << (b % 32)
        live[i] = True
    lanes = tuple(torch.from_numpy(np.where(x >= 1 << 31, x - (1 << 32), x)
                                   .astype(np.int32)) for x in (st, ml, mh))
    return lanes, torch.from_numpy(live)


def k2_cases() -> list:
    """[(name, step_name, ev, rows, live, run, probe_limit)]."""
    rng = np.random.default_rng(20261017)
    out = []
    # 33 writes of distinct values: every subset is reachable, so the
    # frontier runs past N = 2,048 in the second pass
    C = 33
    ev = _ev([F_WRITE] * C, list(range(1, C + 1)), [0] * C, [False] * C,
             [True] * C)
    rows, live = _frontier(2048, [(0, 0, []), (3, 5, [4]), (7, 9, [0, 32])])
    for pl in (32, 2):
        out.append((f"register N2048 C33 overflow pl{pl}", "register", ev,
                    rows, live, torch.tensor(True), pl))
    # 5 writes, 3 wild (crashed) reads, 55 reads nobody can see, an empty
    # slot: 648 rows, passes of up to ~12,000 candidates with a few
    # hundred live
    C = 64
    f = [F_WRITE] * 5 + [F_READ] * 58 + [F_READ]
    a0 = [10 + j for j in range(5)] + [999] * 59
    wild = [False] * 5 + [True] * 3 + [False] * 56
    occ = [True] * 63 + [False]
    rows, live = _frontier(1024, [(0, 0, []), (1, 10, [0])])
    for pl in (32, 2):
        out.append((f"register N1024 C64 pl{pl}", "register",
                    _ev(f, a0, [0] * C, wild, occ), rows, live,
                    torch.tensor(True), pl))
    # 6 adds of 3 elements and 2 reads of the full set among 64 slots
    f = [F_ADD] * 6 + [F_READ] * 2 + [F_READ] * 56
    a0 = [j % 3 for j in range(6)] + [7, 7] + [-1] * 56
    occ = [True] * 8 + [False] * 56
    rows, live = _frontier(1024, [(0, 0, []), (600, 1, [0])])
    out.append(("gset N1024 C64", "gset", _ev(f, a0, [0] * 64, [False] * 64,
                                               occ), rows, live,
                torch.tensor(True), 32))
    # passes of at most 24 candidates: two enqueues and a dequeue of one
    # value lane among 8 slots
    f = [F_ENQ, F_ENQ, F_DEQ] + [F_READ] * 5
    a0 = [0, 0, 0] + [-1] * 5
    a1 = [15, 15, 15] + [0] * 5
    occ = [True] * 3 + [False] * 5
    rows, live = _frontier(1024, [(int(i), 0, []) for i in
                                  sorted(rng.choice(1024, 1,
                                                    replace=False))])
    out.append(("uqueue N1024 C8 small passes", "uqueue",
                _ev(f, a0, a1, [False] * 8, occ), rows, live,
                torch.tensor(True), 32))
    # 300 live input rows, some of them equal: a seed probed by the
    # whole block, from registers
    st = rng.integers(0, 40, size=300)
    rows, live = _frontier(1024, [(int(i), int(s), [int(i) % 8])
                                  for i, s in zip(
                                      sorted(rng.choice(1024, 300,
                                                        replace=False)),
                                      st)])
    out.append(("uqueue N1024 C8 wide seed", "uqueue",
                _ev(f, a0, a1, [False] * 8, occ), rows, live,
                torch.tensor(True), 32))
    # N = 4,096 (C <= 5 fits the gate): a seed of 3,000 live rows, more
    # than the block's registers hold
    st = rng.integers(0, 1 << 20, size=3000)
    rows, live = _frontier(4096, [(int(i), int(s), [])
                                  for i, s in zip(
                                      sorted(rng.choice(4096, 3000,
                                                        replace=False)),
                                      st)])
    out.append(("uqueue N4096 C5 wide seed", "uqueue",
                _ev(f[:5], a0[:5], a1[:5], [False] * 5, occ[:5]), rows,
                live, torch.tensor(True), 32))
    return out


def _rand_rows(rng, n: int, pool: int):
    """n rows drawn from `pool` distinct random rows, lanes over the whole
    32-bit range (int32 bit patterns)."""
    base = rng.integers(0, 1 << 32, size=(3, pool), dtype=np.uint64)
    base = base.astype(np.uint32).view(np.int32)
    pick = rng.integers(0, pool, size=n)
    return tuple(torch.from_numpy(np.ascontiguousarray(base[k][pick]))
                 for k in range(3))


def _tiles(c_rows, n_tt: int):
    return sp.table_hash_u32(*(sp._u32(r) for r in c_rows)) & (n_tt - 1)


def k4_cases() -> list:
    """[(name, c_rows, c_live, table, probe_limit)]."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    rng = np.random.default_rng(20261018)
    rep = sp._rep((), 1)
    out = []
    # candidates whose hash's low 3 bits are not 5 (1,500, ~80% live)
    c_rows = _rand_rows(rng, 1500, 900)
    live = torch.from_numpy(rng.random(1500) < 0.8) & \
        (_tiles(c_rows, 8) != 5)
    out.append(("no live candidate in one tile, M=1500", c_rows, live,
                sp._empty_table(4096, rep), 32))
    # only those whose hash's low 3 bits are 0 (~150 of them)
    c_rows = _rand_rows(rng, 1200, 1200)
    live = torch.from_numpy(rng.random(1200) < 0.9) & \
        (_tiles(c_rows, 8) == 0)
    out.append(("all live candidates in one tile", c_rows, live,
                sp._empty_table(4096, rep), 32))
    # equal rows at 511 | 512 and 1023 | 1024, and at 100 and 600
    c_rows = tuple(r.clone() for r in _rand_rows(rng, 1536, 1000))
    for a, b in ((511, 512), (1023, 1024), (100, 600), (512, 1023)):
        for r in c_rows:
            r[b] = r[a]
    out.append(("equal rows across chunk boundaries", c_rows,
                torch.ones(1536, dtype=torch.bool),
                sp._empty_table(4096, rep), 32))
    # a loaded table: the probes run out
    for pl in (1, 2):
        c_rows = _rand_rows(rng, 1536, 700)
        out.append((f"probe_limit {pl}", c_rows,
                    torch.from_numpy(rng.random(1536) < 0.9),
                    sp._empty_table(1024, rep), pl))
    # 40 live of 50,000, some equal to each other or to rows already in
    # a half-full table
    fill = _rand_rows(rng, 30000, 30000)
    table = sk.tiled_insert_reference(
        fill, torch.ones(30000, dtype=torch.bool),
        sp._empty_table(65536, rep), 32)[0]
    c_rows = tuple(r.clone() for r in _rand_rows(rng, 50000, 50000))
    idx = np.sort(rng.choice(50000, 40, replace=False))
    for a, b in zip(idx[:6], idx[6:12]):
        for r in c_rows:
            r[b] = r[a]
    for a, b in zip(range(6), idx[12:18]):
        for r, fr in zip(c_rows, fill):
            r[b] = fr[a]
    live = torch.zeros(50000, dtype=torch.bool)
    live[torch.from_numpy(idx)] = True
    out.append(("40 live of 50,000 on a half-full table", c_rows, live,
                table, 32))
    return out


def k4_wide_case():
    """(name, c_rows, c_live, table, probe_limit): 600,000 candidates,
    ~400,000 live from a pool of 300,000 rows (equal rows near and far
    apart), on a table of 2^20 slots already holding 100,000 of the
    pool's rows. More live candidates than the threads of the H100's
    grid (264 or 132 blocks of 1,024), so K4 keeps their probe state in
    the scratch and rebuilds each row every phase. Built on the CPU."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    rng = np.random.default_rng(20261019)
    M, T = 600_000, 1 << 20
    pool = _rand_rows(rng, 300_000, 300_000)
    pick = torch.from_numpy(rng.integers(0, 300_000, size=M))
    c_rows = tuple(r[pick].contiguous() for r in pool)
    live = torch.from_numpy(rng.random(M) < 0.67)
    rep = sp._rep((), 1)
    table = sk.tiled_insert_reference(
        tuple(r[:100_000] for r in pool),
        torch.ones(100_000, dtype=torch.bool), sp._empty_table(T, rep),
        32)[0]
    return "600,000 candidates past the grid's threads", c_rows, live, \
        table, 32


def k4_batch_cases() -> list:
    """[(name, c_rows [K, M] lanes, c_live [K, M], table ([K, T] lanes,
    occupancy [K, T]), probe_limit)]: 4 keys of 1,536 candidates on
    tables of 2,048 slots. Key 0 has ~80% live from a pool of 900 rows
    (equal rows within it); key 1 none live; key 2 key 0's candidates on
    an empty table of its own; key 3 fresh rows on a table already
    holding 1,000 (at probe_limit 2 every key with live candidates
    overflows)."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    rng = np.random.default_rng(20261020)
    rep = sp._rep((), 1)
    M, T = 1536, 2048
    out = []
    for pl in (32, 2):
        k0 = _rand_rows(rng, M, 900)
        k3 = _rand_rows(rng, M, M)
        live0 = torch.from_numpy(rng.random(M) < 0.8)
        live3 = torch.from_numpy(rng.random(M) < 0.6)
        fill = sk.tiled_insert_reference(
            _rand_rows(rng, 1000, 1000), torch.ones(1000, dtype=torch.bool),
            sp._empty_table(T, rep), 32)[0]
        empty = sp._empty_table(T, rep)
        c_rows = tuple(torch.stack([a, a, a, b]) for a, b in zip(k0, k3))
        c_live = torch.stack([live0, torch.zeros(M, dtype=torch.bool),
                              live0, live3])
        tables = [empty, empty, empty, fill]
        table = (tuple(torch.stack([t[0][j] for t in tables])
                       for j in range(3)),
                 torch.stack([t[1] for t in tables]))
        out.append((f"4 keys, probe_limit {pl}", c_rows, c_live, table,
                    pl))
    return out


# ------------------------------------------------------------ packed rows

def _packed_frontier(N: int, pack, C: int, rows: list):
    """An N-row frontier of packed words with `rows` ((index, state, mask
    bits)) live: one lane when state_bits + C <= 32, else two."""
    s_bits, s_lo = pack
    L = 1 if s_bits + C <= 32 else 2
    words = np.zeros(N, np.uint64)
    live = np.zeros(N, bool)
    for i, st, bits in rows:
        w = (st - s_lo) & ((1 << s_bits) - 1)
        for b in bits:
            w |= 1 << (s_bits + b)
        words[i] = w
        live[i] = True
    lanes = [(words & np.uint64(0xFFFFFFFF)).astype(np.uint32),
             (words >> np.uint64(32)).astype(np.uint32)][:L]
    return (tuple(torch.from_numpy(x.view(np.int32).copy()) for x in lanes),
            torch.from_numpy(live))


def packed_k2_cases() -> list:
    """[(name, step_name, ev, rows, live, run, probe_limit, pack)]."""
    rng = np.random.default_rng(20261021)
    out = []
    # one lane, 4 state bits from state -1 (register values -1..14), 16
    # slots, N = 4,096 (past the triple's gate): writes of 10..14 (14 is
    # the field's top value, 15), reads of 14, two wild reads, 7 empty
    # slots
    pack, C = (4, -1), 16
    f = [F_WRITE] * 5 + [F_READ] * 2 + [F_READ] * 9
    a0 = [10, 11, 12, 13, 14, 14, 14] + [0] * 9
    wild = [False] * 7 + [True] * 2 + [False] * 7
    occ = [True] * 9 + [False] * 7
    ev = _ev(f, a0, [0] * C, wild, occ)
    rows, live = _packed_frontier(4096, pack, C, [(0, -1, []),
                                                   (5, 14, [0]),
                                                   (9, 3, [7, 8])])
    for pl in (32, 2):
        out.append((f"register L1 s4 C16 N4096 top field pl{pl}",
                    "register", ev, rows, live, torch.tensor(True), pl,
                    pack))
    # equal words that differ only in the state field: the same masks on
    # states 3 and 4 (and 3 twice), each writing 7 through slot 1, so
    # their candidates meet
    ev = _ev([F_WRITE, F_WRITE, F_READ], [9, 7, 7], [0] * 3,
             [False] * 3, [True] * 3)
    rows, live = _packed_frontier(
        64, pack, 3, [(0, 3, [0]), (1, 4, [0]), (2, 3, [0]), (7, 4, []),
                      (8, 3, [])])
    out.append(("register L1 s4 C3 equal masks", "register", ev, rows, live,
                torch.tensor(True), 32, pack))
    # two lanes: a 20-element set (20 state bits) and 14 slots, slot j's
    # bit at 20 + j: slots 0..11 in lane 0, 12 and 13 in lane 1. Adds of
    # 8 elements in slots 6..13 (across the boundary), a read in slot 5,
    # slots 0..4 empty
    pack, C = (20, 0), 14
    f = [F_READ] * 6 + [F_ADD] * 8
    a0 = [0] * 5 + [5] + [0, 3, 7, 11, 15, 19, 18, 16]
    ev = _ev(f, a0, [0] * C, [False] * C, [False] * 5 + [True] * 9)
    rows, live = _packed_frontier(2048, pack, C, [
        (0, 0, []), (3, 1 << 19, [11]), (4, (1 << 20) - 1, [12]),
        (6, 5, [13, 0])])
    for pl in (32, 2):
        out.append((f"gset L2 s20 C14 lane boundary pl{pl}", "gset", ev,
                    rows, live, torch.tensor(True), pl, pack))
    # two lanes, a 32-bit state field from -2^31: lane 0 is the field
    # alone (values >= 2^31 are negative int32 there), lane 1 the 30
    # slots' bits; writes of the extremes and reads
    pack, C = (32, -(1 << 31)), 30
    vals = [(1 << 31) - 1, -(1 << 31), 0, -5, 12345678, -987654321]
    f = [F_WRITE] * 6 + [F_READ] * 3 + [F_READ] * 21
    a0 = vals + [(1 << 31) - 1, 0, -5] + [0] * 21
    occ = [True] * 9 + [False] * 21
    ev = _ev(f, a0, [0] * C, [False] * C, occ)
    rows, live = _packed_frontier(2048, pack, C, [
        (0, -(1 << 31), []), (1, (1 << 31) - 1, [6]), (2, -1, [0, 29])])
    out.append(("register L2 s32 C30 extremes", "register", ev, rows, live,
                torch.tensor(True), 32, pack))
    # one lane at N = 4,096 (past the triple's gate at C = 12): an
    # unordered queue of 3 values in 6-bit counters (18 state bits), a
    # seed of 3,000 live rows (some equal), enqueues and dequeues
    pack, C = (18, 0), 12
    f = [F_ENQ] * 5 + [F_DEQ] * 4 + [F_READ] * 3
    a0 = [0, 6, 12, 0, 6, 0, 6, 12, 12] + [-1] * 3
    a1 = [63] * 9 + [0] * 3
    occ = [True] * 9 + [False] * 3
    ev = _ev(f, a0, a1, [False] * C, occ)
    idx = sorted(rng.choice(4096, 3000, replace=False))
    cnt = rng.integers(0, 4, size=(3000, 3))
    st = cnt[:, 0] | (cnt[:, 1] << 6) | (cnt[:, 2] << 12)
    masks = rng.integers(0, 1 << 9, size=3000)
    rows, live = _packed_frontier(4096, pack, C, [
        (int(i), int(s_), [b for b in range(9) if (int(m) >> b) & 1])
        for i, s_, m in zip(idx, st, masks)])
    out.append(("uqueue L1 s18 C12 N4096 wide seed", "uqueue", ev, rows,
                live, torch.tensor(True), 32, pack))
    return out


def _rand_words(rng, n: int, pool: int, L: int):
    """n L-lane words drawn from `pool` distinct random words, lanes over
    the whole 32-bit range (int32 bit patterns)."""
    base = rng.integers(0, 1 << 32, size=(L, pool), dtype=np.uint64)
    base = base.astype(np.uint32).view(np.int32)
    pick = rng.integers(0, pool, size=n)
    return tuple(torch.from_numpy(np.ascontiguousarray(base[k][pick]))
                 for k in range(L))


def _word_rep(L: int):
    """A packed layout of L lanes (its visited-set hash is the lane
    count's: state_bits and C do not enter it)."""
    return sp._rep((1, 0), 31 if L == 1 else 63)


def packed_k4_cases() -> list:
    """[(name, c_rows, c_live, table, probe_limit)] at one lane and two."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    rng = np.random.default_rng(20261022)
    out = []
    for L in (1, 2):
        rep = _word_rep(L)
        c_rows = _rand_words(rng, 3000, 1800, L)
        out.append((f"L{L} 3,000 words of 1,800", c_rows,
                    torch.from_numpy(rng.random(3000) < 0.8),
                    sp._empty_table(8192, rep), 32))
        for pl in (1, 2):
            out.append((f"L{L} probe_limit {pl}",
                        _rand_words(rng, 1536, 700, L),
                        torch.from_numpy(rng.random(1536) < 0.9),
                        sp._empty_table(1024, rep), pl))
        # 60 live of 20,000 on a half-full table, some equal to each
        # other or to rows already there
        fill = _rand_words(rng, 8000, 8000, L)
        table = sk.tiled_insert_reference(
            fill, torch.ones(8000, dtype=torch.bool),
            sp._empty_table(16384, rep), 32)[0]
        c_rows = tuple(r.clone() for r in _rand_words(rng, 20000, 20000, L))
        idx = np.sort(rng.choice(20000, 60, replace=False))
        for a, b in zip(idx[:8], idx[8:16]):
            for r in c_rows:
                r[b] = r[a]
        for a, b in zip(range(8), idx[16:24]):
            for r, fr in zip(c_rows, fill):
                r[b] = fr[a]
        live = torch.zeros(20000, dtype=torch.bool)
        live[torch.from_numpy(idx)] = True
        out.append((f"L{L} 60 live of 20,000 on a half-full table", c_rows,
                    live, table, 32))
    return out


def packed_k4_batch_cases() -> list:
    """[(name, c_rows [K, M] lanes, c_live, table, probe_limit)]: 3 keys
    of 1,536 candidates on tables of 2,048 slots, at one lane and two:
    key 0 from a pool of 900 words, key 1 none live, key 2 key 0's
    candidates on a table already holding 1,000 words."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    rng = np.random.default_rng(20261023)
    M, T = 1536, 2048
    out = []
    for L in (1, 2):
        rep = _word_rep(L)
        for pl in (32, 2):
            k0 = _rand_words(rng, M, 900, L)
            live0 = torch.from_numpy(rng.random(M) < 0.8)
            fill = sk.tiled_insert_reference(
                _rand_words(rng, 1000, 1000, L),
                torch.ones(1000, dtype=torch.bool),
                sp._empty_table(T, rep), 32)[0]
            empty = sp._empty_table(T, rep)
            c_rows = tuple(torch.stack([a, a, a]) for a in k0)
            c_live = torch.stack([live0, torch.zeros(M, dtype=torch.bool),
                                  live0])
            tables = [empty, empty, fill]
            table = (tuple(torch.stack([t[0][j] for t in tables])
                           for j in range(L)),
                     torch.stack([t[1] for t in tables]))
            out.append((f"L{L} 3 keys, probe_limit {pl}", c_rows, c_live,
                        table, pl))
    return out


def packed_k3_cases() -> list:
    """[(name, c_rows, c_live, f_rows, count, table, probe_limit, N)] at
    one lane and two: the frontier's first `count` rows already in the
    table, candidates drawn from a pool that holds some of them, on a
    table of 1,024 slots (the shared layout) and 32,768 (the device
    layout)."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    rng = np.random.default_rng(20261024)
    out = []
    for L in (1, 2):
        rep = _word_rep(L)
        for T, M, count, N, pl in ((1024, 2000, 100, 512, 32),
                                   (1024, 2000, 100, 160, 32),
                                   (1024, 1536, 200, 512, 2),
                                   (32768, 12000, 1000, 8192, 32)):
            pool = _rand_words(rng, 3 * M // 4, 3 * M // 4, L)
            f_rows = tuple(torch.zeros(N, dtype=torch.int32)
                           for _ in range(L))
            for fr, pr in zip(f_rows, pool):
                fr[:count] = pr[:count]
            table = sk.tiled_insert_reference(
                tuple(r[:count] for r in pool),
                torch.ones(count, dtype=torch.bool),
                sp._empty_table(T, rep), 32)[0]
            pick = torch.from_numpy(rng.integers(0, pool[0].shape[0],
                                                 size=M))
            c_rows = tuple(r[pick].contiguous() for r in pool)
            c_live = torch.from_numpy(rng.random(M) < 0.7)
            what = "append past N" if N < 200 else f"pl{pl}"
            out.append((f"L{L} T{T} M{M} {what}", c_rows, c_live, f_rows,
                        torch.tensor(count, dtype=torch.int32), table, pl,
                        N))
    return out


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def record_calls(name: str, run, keep=None) -> list:
    """Run `run()` with `sparse_kernels.<name>` recording: the arguments
    of its calls for which `keep(args)` holds (every call when None),
    cloned as the caller handed them over, in call order. The wrapper
    itself still runs, and its counters count as ever."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    real, kept = getattr(sk, name), []

    def recording(*args, **kw):
        if keep is None or keep(args):
            kept.append(_clone(args + tuple(kw.values())))
        return real(*args, **kw)

    setattr(sk, name, recording)
    try:
        run()
    finally:
        setattr(sk, name, real)
    return kept
