"""The sparse engines' kernels: K2's, K3's and K4's wrappers, plain
versions and shared-memory gates.

  * K2, `frontier_closure` — one return event's whole delta-frontier
    hash closure in one launch (`kernels/frontier_closure.cu`; replaces
    `jepsen_tpu.parallel.sparse_kernels.frontier_closure_call`). Its
    plain version is `sparse._hash_event_closure`.
  * K4, `tiled_insert` — the probe/claim half of one visited-set
    transaction over a table split into hash-range tiles
    (`kernels/tiled_insert.cu`; replaces
    `jepsen_tpu.parallel.sparse_kernels.tiled_insert_call`): a bin of
    the live candidates by home tile over many blocks, then one block
    per tile walking only its own. Its plain version is
    `tiled_insert_reference`. The closure around it
    (`tiled_event_closure`) is the plain closure with K4 as its insert.
  * K3, `hash_insert` — one visited-set transaction of the sharded
    engine's closure iterations: probe, claim, loser re-check and the
    append of the fresh rows (`kernels/hash_insert.cu`; replaces
    `jepsen_tpu.parallel.sparse_kernels.hash_insert_call`). Its plain
    version is `sparse._hash_insert_append`. Its table lives in shared
    memory, under one block, while it fits the opt-in (`k3_layout`
    "shared"); else in device memory, under a cooperative grid of every
    block the card keeps resident (`k3_layout` "device", `k3_grid_blocks`),
    so it takes every shape.

The gates come from shared-memory layouts: K2 keeps the frontier (12
bytes a row), the table (T = next_pow2(2N) slots of 12 bytes of row, 4
of claim and 1 of occupancy) and two bytes per candidate (N*C of them)
in one block; K4 keeps a claim word per tile slot, one chunk of
gathered candidates and the bin's counters (`k4_smem_bytes`, whatever
the number of candidates), and its plan (`tiled_plan`) sizes the tile
and the chunk by a fixed split of the budget, which fixes each row's
probe sequence and so the results. The budget is the
card's opt-in on a card (232,448 bytes on the H100) and that Hopper
figure on the CPU, so the CPU tests take the routes the card would.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version, which the tests and `chip_smoke.py`
hold the kernel against. Each wrapper counts its launches, and nothing
else, in a plain integer: `launches["frontier_closure"]`,
`launches["hash_insert"]` and `launches["tiled_insert"]`; K3 also counts
them per table layout, in `hash_insert_launches["shared"]` and
`hash_insert_launches["device"]`.
"""

from __future__ import annotations

import ctypes

import torch

from jepsen_tpu_torch.parallel import sparse as sp

_I32 = torch.int32

# dynamic shared memory a Hopper block can opt in to (H100 and H200)
HOPPER_SMEM_OPTIN = 232_448

# model-step family -> the kernels' step code (sparse_common.cuh StepCode)
STEP_CODES = {"register": 0, "mutex": 1, "gset": 2, "uqueue": 3, "fifo": 4}

# kernel launches since the last reset, per wrapper
launches = {"frontier_closure": 0, "hash_insert": 0, "tiled_insert": 0}
# K3's launches since the last reset, per table layout
hash_insert_launches = {"shared": 0, "device": 0}

MAX_C = 64
# K2: the slot tables (3 int32 + 2 bytes per slot, for 64 slots) and 40
# words of scan scratch
K2_FIXED_BYTES = 3 * 4 * MAX_C + 40 * 4 + 2 * MAX_C
# K4's plan splits the budget as its first kernel's layout did (17 bytes
# a tile slot, 10 a chunk entry, 16 more): the tile fixes where each row
# probes, so the plan, and every result, stays what it was
K4_PLAN_SLOT_BYTES = 17
K4_PLAN_ENTRY_BYTES = 10
K4_PLAN_FIXED_BYTES = 16
TILE_MIN = CHUNK_MIN = 512
# K3: 40 words of scan scratch, and in the shared layout the table
K3_FIXED_BYTES = 40 * 4
K3_SLOT_BYTES = 17    # rows 12, claim 4, occupancy 1
# K3's device layout: the blocks of its cooperative grid, at most (the
# scratch keeps one count per block; hash_insert.cu kMaxGrid)
K3_MAX_GRID = 1024


def k2_smem_bytes(N: int, C: int) -> int:
    """K2's dynamic shared memory at frontier capacity N and C slots."""
    T = sp._next_pow2(2 * N)
    return 12 * N + 17 * T + 2 * N * C + K2_FIXED_BYTES


# K4's bin: threads a block, candidates a thread at most, and the (tile,
# group of 32) counters a block keeps at most (tiled_insert.cu)
K4_BIN_THREADS = 256
K4_BIN_MAX_K = 8
K4_BIN_GROUPS = 8192


def k4_bin_shape(tile_bits: int, chunk: int):
    """(candidates per bin block R, bin blocks a chunk spans at most) of
    K4 with 2^tile_bits tiles and chunk CH (tiled_insert.cu make_plan):
    R is 256 * kb with kb <= 8 a power of two, shrunk while the block's
    counters (R/32 per tile) pass 8,192 and until R divides the chunk
    (for a chunk of at least 256)."""
    n_tt = 1 << tile_bits
    kb = max(1, min(K4_BIN_MAX_K, K4_BIN_GROUPS // (8 * n_tt)))
    kb = _pow2_floor(kb)
    if kb * K4_BIN_THREADS > chunk:
        kb = max(1, chunk // K4_BIN_THREADS)
    R = kb * K4_BIN_THREADS
    return R, max(1, chunk // R)


def k4_smem_bytes(tile: int, chunk: int, tiles: int) -> int:
    """K4's dynamic shared memory with `tiles` tiles of `tile` slots and a
    chunk of `chunk` candidates, the larger of its two launches (M does
    not enter): the insert's claim words (4 a tile slot), a chunk's
    candidates (10 bytes each) and the places of a chunk's bin segments
    (8 a bin block it spans, and 8); or the bin's counters (4 a tile and
    group of 32 candidates) and 40 words of scan."""
    R, span = k4_bin_shape(tiles.bit_length() - 1, chunk)
    return max(4 * tile + 10 * chunk + 8 * (span + 1),
               4 * tiles * (R // 32) + 160)


def k3_smem_bytes(Nd: int) -> int:
    """K3's dynamic shared memory with the table of per-rank capacity Nd
    (Td = next_pow2(2 Nd) slots) in shared memory. The candidates and
    their probe state stay in device memory, so M does not enter."""
    return K3_SLOT_BYTES * sp._next_pow2(2 * Nd) + K3_FIXED_BYTES


def k3_layout(Nd: int, device=None) -> str:
    """Where K3 keeps the visited set at per-rank capacity Nd: "shared"
    (in one block's shared memory) while `k3_smem_bytes(Nd)` fits the
    block's opt-in (the card's on a card, Hopper's elsewhere: Nd <= 4,096
    on the H100), else "device" (in device memory, under the cooperative
    grid)."""
    device = torch.device("cpu" if device is None else device)
    budget = _device_optin("hash_insert", device) \
        if device.type == "cuda" else HOPPER_SMEM_OPTIN
    return "shared" if k3_smem_bytes(Nd) <= budget else "device"


def k3_grid_blocks(per_sm: int, n_sm: int) -> int:
    """Blocks of K3's cooperative grid (the device layout): every block
    the card keeps resident, `per_sm` of them on each of its `n_sm` SMs
    (132 on the H100), at most K3_MAX_GRID. A cooperative launch needs
    them all resident at once, so a card that keeps none raises."""
    if per_sm < 1 or n_sm < 1:
        raise RuntimeError(f"hash_insert: the card keeps {per_sm} blocks "
                           f"of the grid insert per SM on {n_sm} SMs; its "
                           f"cooperative launch needs at least one")
    return min(per_sm * n_sm, K3_MAX_GRID)


def supported(N: int, C: int, budget: int = HOPPER_SMEM_OPTIN) -> bool:
    """Whether K2 takes frontier capacity N with C slots: its layout
    fits `budget` bytes. On the H100 that is N = 1024 for every C <= 64
    and N = 2048 for C <= 33."""
    return 1 <= C <= MAX_C and k2_smem_bytes(N, C) <= budget


def _pow2_floor(n: int) -> int:
    return 1 << max(0, int(n).bit_length() - 1)


def tiled_plan(N: int, C: int, budget: int = HOPPER_SMEM_OPTIN):
    """{"tile", "chunk"} of K4 at frontier capacity N, or None when no
    tile and chunk of at least 512 come out of `budget` or the kernel's
    shared memory (`k4_smem_bytes`) does not fit it. Up to 3/5 of the
    budget at 17 bytes a slot goes to the tile (at most the whole table,
    T = next_pow2(2N)), the rest at 10 bytes an entry to the chunk: on
    the H100 a tile of 8,192 slots and a chunk of 8,192 candidates. The
    tile fixes where each row probes, so the split stays the one every
    result so far was computed with."""
    T = sp._next_pow2(2 * N)
    tile = min(T, _pow2_floor((budget * 3 // 5) // K4_PLAN_SLOT_BYTES))
    chunk = _pow2_floor(max(1, (budget - K4_PLAN_SLOT_BYTES * tile
                                - K4_PLAN_FIXED_BYTES)
                            // K4_PLAN_ENTRY_BYTES))
    if tile < TILE_MIN or chunk < CHUNK_MIN or \
            k4_smem_bytes(tile, chunk, T // tile) > budget:
        return None
    return {"tile": tile, "chunk": chunk}


# ----------------------------------------------------------- the libraries

_libs: dict = {}
# (kernel, device index) -> the block's shared-memory opt-in there, read
# by the kernel's init (which also grants it to the kernel there)
_optin: dict = {}
# device index -> the blocks of K3's cooperative grid there
_k3_grid: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name: str):
    lib = _libs.get(name)
    if lib is None:
        from jepsen_tpu_torch import kernels
        lib = kernels.load(name)
        if name == "frontier_closure":
            lib.jt_frontier_closure_launch.argtypes = \
                [_I] + [_P] * 14 + [_I, _I, _I, _P]
            lib.jt_frontier_closure_launch.restype = _I
            lib.jt_frontier_closure_smem.argtypes = [_I, _I]
            lib.jt_frontier_closure_smem.restype = ctypes.c_longlong
        elif name == "hash_insert":
            lib.jt_hash_insert_launch.argtypes = \
                [_P] * 4 + [_I] + [_P] * 3 + [_I, _P] + [_P] * 4 + [_I] \
                + [_P] * 8 + [_P, _I, _I, _I, _P]
            lib.jt_hash_insert_launch.restype = _I
            lib.jt_hash_insert_grid_shape.argtypes = \
                [ctypes.POINTER(_I), ctypes.POINTER(_I)]
            lib.jt_hash_insert_grid_shape.restype = _I
            lib.jt_hash_insert_scratch.argtypes = [_I, _I, _I]
            lib.jt_hash_insert_scratch.restype = ctypes.c_longlong
            lib.jt_hash_insert_smem.argtypes = [_I, _I]
            lib.jt_hash_insert_smem.restype = ctypes.c_longlong
        else:
            lib.jt_tiled_insert_launch.argtypes = \
                [_P] * 4 + [_I] + [_P] * 8 + [_I] * 5 + [_P]
            lib.jt_tiled_insert_launch.restype = _I
            lib.jt_tiled_insert_smem.argtypes = [_I] * 3
            lib.jt_tiled_insert_smem.restype = ctypes.c_longlong
            lib.jt_tiled_insert_scratch.argtypes = [_I] * 3
            lib.jt_tiled_insert_scratch.restype = ctypes.c_longlong
        init = getattr(lib, f"jt_{name}_init")
        init.argtypes = []
        init.restype = _I
        _libs[name] = lib
    return lib


def _device_optin(name: str, device) -> int:
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    v = _optin.get((name, index))
    if v is None:
        with torch.cuda.device(index):
            v = getattr(_lib(name), f"jt_{name}_init")()
        if v <= 0:
            raise RuntimeError(f"{name} kernel: cannot set up device "
                               f"{index}: CUDA error {-v}")
        _optin[(name, index)] = v
    return v


def k3_grid(device) -> int:
    """The blocks of K3's cooperative grid on `device`, from what
    jt_hash_insert_init read there once (blocks per SM and SMs)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    v = _k3_grid.get(index)
    if v is None:
        _device_optin("hash_insert", torch.device("cuda", index))
        per_sm, n_sm = _I(0), _I(0)
        with torch.cuda.device(index):
            err = _lib("hash_insert").jt_hash_insert_grid_shape(
                ctypes.byref(per_sm), ctypes.byref(n_sm))
        if err != 0:
            raise RuntimeError(f"hash_insert kernel: cannot read the grid "
                               f"shape on device {index}: CUDA error {err}")
        v = _k3_grid[index] = k3_grid_blocks(per_sm.value, n_sm.value)
    return v


def smem_budget(device) -> int:
    """The shared-memory budget of the routes on `device`: the card's
    opt-in, or Hopper's on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return min(_device_optin("frontier_closure", device),
                   _device_optin("tiled_insert", device))
    return HOPPER_SMEM_OPTIN


def reset_launches() -> None:
    for counts in (launches, hash_insert_launches):
        for k in counts:
            counts[k] = 0


def _ptr(t) -> int:
    return t.data_ptr()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)


def _dev(t):
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"sparse kernels: no kernel for device "
                           f"{t.device}")
    return t.device


# --------------------------------------------------------------------- K2

def _check_closure_args(step_name, ev, rows, live, run, probe_limit):
    _check(step_name in STEP_CODES, f"frontier_closure: unknown step "
                                    f"family {step_name!r}")
    C = ev["slot_f"].shape[0]
    N = live.shape[0]
    _check(1 <= C <= MAX_C, f"frontier_closure: C={C} outside 1..{MAX_C}")
    _check(1 <= probe_limit <= sp.MAX_PROBE_LIMIT,
           f"frontier_closure: probe_limit={probe_limit} outside "
           f"1..{sp.MAX_PROBE_LIMIT}")
    for k in ("slot_f", "slot_a0", "slot_a1"):
        _check(ev[k].dtype == _I32 and tuple(ev[k].shape) == (C,),
               f"frontier_closure: {k} must be int32 [{C}]")
    for k in ("slot_wild", "slot_occ"):
        _check(ev[k].dtype == torch.bool and tuple(ev[k].shape) == (C,),
               f"frontier_closure: {k} must be bool [{C}]")
    _check(len(rows) == 3 and all(r.dtype == _I32 and tuple(r.shape) == (N,)
                                  for r in rows),
           f"frontier_closure: rows must be three int32 [{N}] lanes")
    _check(live.dtype == torch.bool and run.dtype == torch.bool
           and run.numel() == 1,
           "frontier_closure: live must be bool [N], run one bool")
    devs = {t.device for t in (*ev.values(), *rows, live, run)}
    _check(len(devs) == 1, f"frontier_closure: tensors on {devs}")
    return N, C


def frontier_closure_reference(step_name, ev, rows, live, run,
                               probe_limit: int):
    """K2's plain version: `sparse._hash_event_closure` -> (rows2, meta
    int32[4] = count, ovf, iters, stepped). With `run` False the event
    is skipped: zero rows and zero meta, as the kernel writes."""
    N = live.shape[0]
    rep = sp._rep((), ev["slot_f"].shape[0], live.device)
    if not bool(run):
        return rep.zeros(N), torch.zeros(4, dtype=_I32, device=live.device)
    rows2, count, ovf, iters, stepped = sp._hash_event_closure(
        rep, sp.STEPS[step_name], ev, rows, live, run, N,
        sp._next_pow2(2 * N), probe_limit)
    return rows2, torch.stack([count, ovf.to(count.dtype), iters,
                               stepped]).to(_I32)


def frontier_closure(step_name: str, ev: dict, rows, live, run,
                     probe_limit: int):
    """K2: one return event's whole hash closure.

    ev     the event's slot tables: slot_f/slot_a0/slot_a1 int32 [C],
           slot_wild/slot_occ bool [C]
    rows   the frontier, three int32 lanes [N]; live bool [N]
    run    one bool: False skips the event (zero rows and meta)
    ->     (rows2, meta int32[4] = count, ovf, iters, stepped), rows2 the
           closed frontier compacted into rows [0, count), zeros after.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel on the current stream, after the shape gate
    (`supported(N, C)` against the card's opt-in)."""
    N, C = _check_closure_args(step_name, ev, rows, live, run, probe_limit)
    dev = _dev(live)
    if dev.type == "cpu":
        return frontier_closure_reference(step_name, ev, rows, live, run,
                                          probe_limit)
    if not supported(N, C, _device_optin("frontier_closure", dev)):
        raise ValueError(f"frontier_closure: N={N} C={C} needs "
                         f"{k2_smem_bytes(N, C)} bytes of shared memory, "
                         f"past the card's opt-in")
    ins = [ev[k].contiguous() for k in ("slot_f", "slot_a0", "slot_a1",
                                        "slot_wild", "slot_occ")]
    ins += [r.contiguous() for r in rows] + [live.contiguous(),
                                             run.reshape(1).contiguous()]
    out = [torch.empty(N, dtype=_I32, device=dev) for _ in range(3)]
    meta = torch.empty(4, dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        err = _lib("frontier_closure").jt_frontier_closure_launch(
            STEP_CODES[step_name], *map(_ptr, ins), *map(_ptr, out),
            _ptr(meta), N, C, probe_limit,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"frontier_closure kernel launch failed: CUDA "
                           f"error {err}")
    launches["frontier_closure"] += 1
    return tuple(out), meta


# --------------------------------------------------------------------- K3

def hash_insert_reference(c_rows, c_live, f_rows, count, table,
                          probe_limit: int, N: int):
    """K3's plain version, on any device: `sparse._hash_insert_append`."""
    return sp._hash_insert_append(c_rows, c_live, f_rows, count, table,
                                  probe_limit, N,
                                  sp._rep((), 1, c_live.device))


def hash_insert(c_rows, c_live, f_rows, count, table, probe_limit: int,
                N: int):
    """K3: one visited-set transaction — insert the live candidates into
    the open-addressed table by bounded linear probing (racing claims go
    to the lowest candidate index; losers re-check the slot), then append
    the fresh ones, in candidate order, after the first `count` frontier
    rows.

    c_rows  candidates, three int32 lanes [M]; c_live bool [M]
    f_rows  the frontier, three int32 lanes [N]
    count   integer tensor, one value: the frontier rows in use
    table   (three int32 lanes [T], occupancy bool [T]), T a power of two
    ->      (rows2, table2, count2, n_fresh, ovf): count2 = min(count +
            n_fresh, N), ovf a probe run past `probe_limit` or an append
            past N (the rows past N are dropped).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel on the current stream, with the table in shared memory under
    one block or in device memory under a cooperative grid, as
    `k3_layout` says."""
    t_rows, t_occ = table
    M, T = c_live.shape[0], t_occ.shape[0]
    _check(M >= 1 and N >= 1 and T >= 2 and T & (T - 1) == 0,
           f"hash_insert: M={M} N={N} T={T} (T a power of two)")
    _check(1 <= probe_limit <= sp.MAX_PROBE_LIMIT,
           f"hash_insert: probe_limit={probe_limit} outside "
           f"1..{sp.MAX_PROBE_LIMIT}")
    _check(len(c_rows) == 3 and len(f_rows) == 3 and len(t_rows) == 3
           and all(r.dtype == _I32 and tuple(r.shape) == (n,)
                   for rows, n in ((c_rows, M), (f_rows, N), (t_rows, T))
                   for r in rows)
           and c_live.dtype == torch.bool and t_occ.dtype == torch.bool
           and count.numel() == 1 and not count.is_floating_point(),
           "hash_insert: rows must be three int32 lanes, flags bool, "
           "count one integer")
    devs = {t.device for t in (*c_rows, c_live, *f_rows, count, *t_rows,
                               t_occ)}
    _check(len(devs) == 1, f"hash_insert: tensors on {devs}")
    dev = _dev(c_live)
    if dev.type == "cpu":
        return hash_insert_reference(c_rows, c_live, f_rows, count, table,
                                     probe_limit, N)
    return _hash_insert_launch(c_rows, c_live, f_rows, count, table,
                               probe_limit, N, k3_layout(T // 2, dev))


def _hash_insert_launch(c_rows, c_live, f_rows, count, table,
                        probe_limit: int, N: int, layout_name: str):
    """K3's launch on CUDA tensors in the table layout named (the
    wrapper's is `k3_layout`'s; chip_smoke.py also times the grid on a
    table the shared layout takes). Raises on a launch the card
    refuses."""
    t_rows, t_occ = table
    M, T = c_live.shape[0], t_occ.shape[0]
    dev = c_live.device
    lib = _lib("hash_insert")
    layout = {"shared": 0, "device": 1}[layout_name]
    grid = k3_grid(dev) if layout_name == "device" else 0
    scratch = torch.empty(lib.jt_hash_insert_scratch(M, T, layout),
                          dtype=torch.uint8, device=dev)
    ins = [r.contiguous() for r in c_rows] + [c_live.contiguous()]
    fins = [r.contiguous() for r in f_rows]
    tins = [r.contiguous() for r in t_rows] + [t_occ.contiguous()]
    out = [torch.empty(N, dtype=_I32, device=dev) for _ in range(3)]
    t_out = [torch.empty(T, dtype=_I32, device=dev) for _ in range(3)]
    occ_out = torch.empty(T, dtype=torch.bool, device=dev)
    meta = torch.empty(3, dtype=_I32, device=dev)
    cnt = count.reshape(1).to(_I32)
    with torch.cuda.device(dev):
        err = lib.jt_hash_insert_launch(
            *map(_ptr, ins), M, *map(_ptr, fins), N, _ptr(cnt),
            *map(_ptr, tins), T, *map(_ptr, out), *map(_ptr, t_out),
            _ptr(occ_out), _ptr(meta), _ptr(scratch), probe_limit, layout,
            grid, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_insert kernel launch failed ({layout_name}"
                           f" layout): CUDA error {err}")
    launches["hash_insert"] += 1
    hash_insert_launches[layout_name] += 1
    return (tuple(out), (tuple(t_out), occ_out), meta[0], meta[1],
            meta[2] != 0)


# --------------------------------------------------------------------- K4

def _tiling(T: int, M: int, plan: dict):
    """(tiles, tile size, log2 tiles, chunk) of `plan` on a table of T
    slots and M candidates — the reference's arithmetic."""
    n_tt = max(1, T // plan["tile"])
    CH = min(plan["chunk"], 1 << max(0, (M - 1).bit_length()))
    return n_tt, T // n_tt, n_tt.bit_length() - 1, CH


def tiled_insert_reference(c_rows, c_live, table, probe_limit: int,
                           plan: dict):
    """K4's plain version: chunk by chunk, in order, one round-synchronous
    insert of the chunk's live candidates, each probing inside its home
    tile (`sparse._hash_insert` with the tile's slots). Every tile is
    independent, so one insert per chunk serves all tiles at once.
    Returns (table2, fresh bool[M], off int32[M], probe_ovf bool)."""
    t_rows, t_occ = table
    M = c_live.shape[0]
    T = t_occ.shape[0]
    n_tt, TS, tt_bits, CH = _tiling(T, M, plan)
    h0 = sp.table_hash_u32(*(sp._u32(r) for r in c_rows))
    base = (h0 & (n_tt - 1)) * TS
    start = (h0 >> tt_bits) & (TS - 1)
    fresh, off, pend = [], [], []
    for c0 in range(0, M, CH):
        s = slice(c0, min(M, c0 + CH))
        table, f, p, o = sp._hash_insert(
            tuple(r[s] for r in c_rows), c_live[s], table, probe_limit,
            h0=start[s], base=base[s], span=TS)
        fresh.append(f)
        off.append(o)
        pend.append(p)
    return (table, torch.cat(fresh), torch.cat(off),
            torch.stack(pend).any())


def tiled_insert(c_rows, c_live, table, probe_limit: int, plan: dict):
    """K4: the probe/claim half of one visited-set transaction on a
    table split into hash-range tiles.

    c_rows  candidates, three int32 lanes [M]; c_live bool [M]
    table   (three int32 lanes [T], occupancy bool [T]), T a power of two
    plan    {"tile", "chunk"} (tiled_plan)
    ->      (table2, fresh bool[M], off int32[M], probe_ovf bool [])

    A CPU tensor runs the plain version, which leaves `table` as it is.
    A CUDA tensor launches the kernel on the current stream, after
    checking that its shared memory fits the card's opt-in; the kernel
    updates the table in place, so `table` is consumed: table2 is the
    same tensors (their copies, where a lane was not contiguous), and a
    caller that needs the old table clones it first. The only caller,
    `tiled_event_closure`, never reads a table after inserting into
    it."""
    t_rows, t_occ = table
    M, T = c_live.shape[0], t_occ.shape[0]
    _check(M >= 1 and T >= 1 and T & (T - 1) == 0,
           f"tiled_insert: M={M} T={T} (T must be a power of two)")
    _check(1 <= probe_limit <= sp.MAX_PROBE_LIMIT,
           f"tiled_insert: probe_limit={probe_limit} outside "
           f"1..{sp.MAX_PROBE_LIMIT}")
    _check(all(r.dtype == _I32 and tuple(r.shape) == (M,) for r in c_rows)
           and all(r.dtype == _I32 and tuple(r.shape) == (T,)
                   for r in t_rows)
           and c_live.dtype == torch.bool and t_occ.dtype == torch.bool
           and len(c_rows) == 3 and len(t_rows) == 3,
           "tiled_insert: rows must be three int32 lanes, flags bool")
    devs = {t.device for t in (*c_rows, c_live, *t_rows, t_occ)}
    _check(len(devs) == 1, f"tiled_insert: tensors on {devs}")
    dev = _dev(c_live)
    if dev.type == "cpu":
        return tiled_insert_reference(c_rows, c_live, table, probe_limit,
                                      plan)
    return _tiled_insert_launch(c_rows, c_live, table, probe_limit,
                                plan)[:4]


def _tiled_insert_launch(c_rows, c_live, table, probe_limit: int,
                         plan: dict, stages: int = 3, work=None):
    """K4's launches on CUDA tensors: `stages` 1 the bin alone, 2 the
    insert alone (on `work` from an earlier bin of the same candidates),
    3 both (the wrapper's). chip_smoke.py and kernel_ab.py time the two
    apart. -> (table2, fresh, off, probe_ovf, work); one launch counted
    per insert."""
    t_rows, t_occ = table
    M, T = c_live.shape[0], t_occ.shape[0]
    dev = c_live.device
    n_tt, TS, tt_bits, CH = _tiling(T, M, plan)
    smem = k4_smem_bytes(TS, CH, n_tt)
    if smem > _device_optin("tiled_insert", dev):
        raise ValueError(f"tiled_insert: {n_tt} tiles of {TS} and chunk "
                         f"{CH} need {smem} bytes of shared memory, past "
                         f"the card's opt-in")
    lib = _lib("tiled_insert")
    ins = [r.contiguous() for r in c_rows] + [c_live.contiguous()]
    tins = [r.contiguous() for r in t_rows] + [t_occ.contiguous()]
    if work is None:
        work = (torch.empty(M, dtype=torch.bool, device=dev),
                torch.empty(M, dtype=_I32, device=dev),
                torch.empty((), dtype=torch.bool, device=dev),
                torch.empty(lib.jt_tiled_insert_scratch(M, tt_bits, CH),
                            dtype=torch.uint8, device=dev))
    fresh, off, pend, scratch = work
    with torch.cuda.device(dev):
        err = lib.jt_tiled_insert_launch(
            *map(_ptr, ins), M, *map(_ptr, tins), _ptr(fresh), _ptr(off),
            _ptr(pend), _ptr(scratch), TS, tt_bits, CH, probe_limit,
            stages, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled_insert kernel launch failed: CUDA "
                           f"error {err}")
    if stages & 2:
        launches["tiled_insert"] += 1
    return (tuple(tins[:3]), tins[3]), fresh, off, pend, work


def tiled_event_closure(rep, step, ev, rows, live, run, N: int, T: int,
                        probe_limit: int, plan: dict):
    """The hash closure of one event with K4 as its visited-set insert:
    `sparse._hash_event_closure` whose insert hook is `tiled_insert`
    followed by the plain append. -> (rows2, meta int32[4])."""
    def insert(c_rows, c_live, f_rows, count, table):
        table2, fresh, _, p_ovf = tiled_insert(c_rows, c_live, table,
                                               probe_limit, plan)
        rows2, count2, n_fresh, a_ovf = sp._append_fresh(
            c_rows, fresh, f_rows, count, N)
        return rows2, table2, count2, n_fresh, p_ovf | a_ovf

    rows2, count, ovf, iters, stepped = sp._hash_event_closure(
        rep, step, ev, rows, live, run, N, T, probe_limit, insert=insert)
    return rows2, torch.stack([count, ovf.to(count.dtype), iters,
                               stepped]).to(_I32)
