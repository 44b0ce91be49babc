"""The sparse engine's kernels: K2's and K4's wrappers, plain versions
and shared-memory gates.

  * K2, `frontier_closure` — one return event's whole delta-frontier
    hash closure in one launch (`kernels/frontier_closure.cu`; replaces
    `jepsen_tpu.parallel.sparse_kernels.frontier_closure_call`). Its
    plain version is `sparse._hash_event_closure`.
  * K4, `tiled_insert` — the probe/claim half of one visited-set
    transaction over a table split into hash-range tiles, one block per
    tile (`kernels/tiled_insert.cu`; replaces
    `jepsen_tpu.parallel.sparse_kernels.tiled_insert_call`). Its plain
    version is `tiled_insert_reference`. The closure around it
    (`tiled_event_closure`) is the plain closure with K4 as its insert.

The gates come from each kernel's own shared-memory layout: K2 keeps
the frontier (12 bytes a row), the table (T = next_pow2(2N) slots of 12
bytes of row, 4 of claim and 1 of occupancy) and two bytes per
candidate (N*C of them) in one block; K4 keeps one tile (17 bytes a
slot) and one chunk of gathered candidates (10 bytes each). The budget
is the card's opt-in on a card (232,448 bytes on the H100) and that
Hopper figure on the CPU, so the CPU tests take the routes the card
would.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version, which the tests and `chip_smoke.py`
hold the kernel against. Each wrapper counts its launches, and nothing
else, in a plain integer: `launches["frontier_closure"]` and
`launches["tiled_insert"]`.
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
launches = {"frontier_closure": 0, "tiled_insert": 0}

MAX_C = 64
# K2: the slot tables (3 int32 + 2 bytes per slot, for 64 slots) and 40
# words of scan scratch
K2_FIXED_BYTES = 3 * 4 * MAX_C + 40 * 4 + 2 * MAX_C
K4_FIXED_BYTES = 16
K4_SLOT_BYTES = 17    # rows 12, claim 4, occupancy 1
K4_ENTRY_BYTES = 10   # index 4, start 4, offset 1, flags 1
TILE_MIN = CHUNK_MIN = 512


def k2_smem_bytes(N: int, C: int) -> int:
    """K2's dynamic shared memory at frontier capacity N and C slots."""
    T = sp._next_pow2(2 * N)
    return 12 * N + 17 * T + 2 * N * C + K2_FIXED_BYTES


def k4_smem_bytes(tile: int, chunk: int) -> int:
    return K4_SLOT_BYTES * tile + K4_ENTRY_BYTES * chunk + K4_FIXED_BYTES


def supported(N: int, C: int, budget: int = HOPPER_SMEM_OPTIN) -> bool:
    """Whether K2 takes frontier capacity N with C slots: its layout
    fits `budget` bytes. On the H100 that is N = 1024 for every C <= 64
    and N = 2048 for C <= 33."""
    return 1 <= C <= MAX_C and k2_smem_bytes(N, C) <= budget


def _pow2_floor(n: int) -> int:
    return 1 << max(0, int(n).bit_length() - 1)


def tiled_plan(N: int, C: int, budget: int = HOPPER_SMEM_OPTIN):
    """{"tile", "chunk"} of K4 at frontier capacity N, or None when no
    tile and chunk of at least 512 fit `budget`. Up to 3/5 of the budget
    goes to the tile (at most the whole table, T = next_pow2(2N)), the
    rest to the chunk: on the H100 a tile of 8,192 slots and a chunk of
    8,192 candidates. Fewer, larger tiles mean fewer blocks reading every
    candidate; larger chunks, fewer rounds of barriers."""
    T = sp._next_pow2(2 * N)
    tile = min(T, _pow2_floor((budget * 3 // 5) // K4_SLOT_BYTES))
    chunk = _pow2_floor(max(1, (budget - K4_SLOT_BYTES * tile
                                - K4_FIXED_BYTES) // K4_ENTRY_BYTES))
    if tile < TILE_MIN or chunk < CHUNK_MIN:
        return None
    return {"tile": tile, "chunk": chunk}


# ----------------------------------------------------------- the libraries

_libs: dict = {}
# (kernel, device index) -> the block's shared-memory opt-in there, read
# by the kernel's init (which also grants it to the kernel there)
_optin: dict = {}

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
        else:
            lib.jt_tiled_insert_launch.argtypes = \
                [_P] * 4 + [_I] + [_P] * 11 + [_I] * 4 + [_P]
            lib.jt_tiled_insert_launch.restype = _I
            lib.jt_tiled_insert_smem.argtypes = [_I, _I]
            lib.jt_tiled_insert_smem.restype = ctypes.c_longlong
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


def smem_budget(device) -> int:
    """The shared-memory budget of the routes on `device`: the card's
    opt-in, or Hopper's on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return min(_device_optin("frontier_closure", device),
                   _device_optin("tiled_insert", device))
    return HOPPER_SMEM_OPTIN


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel on the current stream, after checking that the plan fits the
    card's opt-in."""
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
    n_tt, TS, tt_bits, CH = _tiling(T, M, plan)
    smem = k4_smem_bytes(TS, CH)
    if smem > _device_optin("tiled_insert", dev):
        raise ValueError(f"tiled_insert: tile {TS} and chunk {CH} need "
                         f"{smem} bytes of shared memory, past the "
                         f"card's opt-in")
    ins = [r.contiguous() for r in c_rows] + [c_live.contiguous()]
    tins = [r.contiguous() for r in t_rows] + [t_occ.contiguous()]
    t_out = [torch.empty(T, dtype=_I32, device=dev) for _ in range(3)]
    occ_out = torch.empty(T, dtype=torch.bool, device=dev)
    fresh = torch.zeros(M, dtype=torch.bool, device=dev)
    off = torch.zeros(M, dtype=_I32, device=dev)
    pend = torch.zeros(1, dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        err = _lib("tiled_insert").jt_tiled_insert_launch(
            *map(_ptr, ins), M, *map(_ptr, tins), *map(_ptr, t_out),
            _ptr(occ_out), _ptr(fresh), _ptr(off), _ptr(pend), TS, tt_bits,
            CH, probe_limit, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled_insert kernel launch failed: CUDA "
                           f"error {err}")
    launches["tiled_insert"] += 1
    return (tuple(t_out), occ_out), fresh, off, pend[0] != 0


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
