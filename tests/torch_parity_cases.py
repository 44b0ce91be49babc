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
  * K4 (`k4_cases`): a tile with no live candidate, every live candidate
    in one tile (more than 32: the block-wide insert), equal rows on
    both sides of a chunk boundary, probe_limit 1 and 2 with the probe
    overflow raised, M not a multiple of the chunk, and a few live
    candidates over many chunks on a table already half full (the
    one-warp insert).
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
    """[(name, c_rows, c_live, table, probe_limit, plan)]."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    rng = np.random.default_rng(20261018)
    rep = sp._rep((), 1)
    small = {"tile": 512, "chunk": 512}
    out = []
    # 8 tiles, 3 chunks (the last one short), tile 5 left empty
    c_rows = _rand_rows(rng, 1500, 900)
    live = torch.from_numpy(rng.random(1500) < 0.8) & \
        (_tiles(c_rows, 8) != 5)
    out.append(("no live candidate in one tile, M=1500", c_rows, live,
                sp._empty_table(4096, rep), 32, small))
    # every live candidate in tile 0 (~150 of them)
    c_rows = _rand_rows(rng, 1200, 1200)
    live = torch.from_numpy(rng.random(1200) < 0.9) & \
        (_tiles(c_rows, 8) == 0)
    out.append(("all live candidates in one tile", c_rows, live,
                sp._empty_table(4096, rep), 32, small))
    # equal rows at 511 | 512 and 1023 | 1024, and at 100 and 600
    c_rows = tuple(r.clone() for r in _rand_rows(rng, 1536, 1000))
    for a, b in ((511, 512), (1023, 1024), (100, 600), (512, 1023)):
        for r in c_rows:
            r[b] = r[a]
    out.append(("equal rows across chunk boundaries", c_rows,
                torch.ones(1536, dtype=torch.bool),
                sp._empty_table(4096, rep), 32, small))
    # a loaded table of 2 tiles: the probes run out
    for pl in (1, 2):
        c_rows = _rand_rows(rng, 1536, 700)
        out.append((f"probe_limit {pl}", c_rows,
                    torch.from_numpy(rng.random(1536) < 0.9),
                    sp._empty_table(1024, rep), pl, small))
    # 40 live of 50,000 (7 chunks of 8,192, the last short), some equal
    # to each other or to rows already in a half-full table of 8 tiles
    big = {"tile": 8192, "chunk": 8192}
    fill = _rand_rows(rng, 30000, 30000)
    table = sk.tiled_insert_reference(
        fill, torch.ones(30000, dtype=torch.bool),
        sp._empty_table(65536, rep), 32, big)[0]
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
                table, 32, big))
    return out
