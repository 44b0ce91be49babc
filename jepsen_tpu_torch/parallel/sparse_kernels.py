"""The sparse engines' kernels: K2's, K3's and K4's wrappers, plain
versions and shared-memory gates.

  * K2, `frontier_closure` — one return event's whole delta-frontier
    hash closure in one launch (`kernels/frontier_closure.cu`; replaces
    `jepsen_tpu.parallel.sparse_kernels.frontier_closure_call`). Its
    plain version is `sparse._hash_event_closure`. Batched over keys,
    `frontier_closure_batch`: one event row of K keys in one launch, a
    block a key (the reference's K2 under vmap); its plain version is
    `frontier_closure_batch_reference`, the single key's key by key.
    With `stats=True` both also return the reference's stats outputs,
    int32 [8] a key (`swork`, then the probe-length histogram), from the
    kernel's Stats instantiation.
  * K4, `tiled_insert` — the probe/claim half of the visited-set
    transaction past K2's gate (`kernels/tiled_insert.cu`; replaces
    `jepsen_tpu.parallel.sparse_kernels.tiled_insert_call`): the
    reference's transaction over the whole table, run by a cooperative
    grid (`k4_grid`) over the live candidates, as K3's device layout
    runs it (one body, sparse_common.cuh's grid_rounds). Its plain
    version is `tiled_insert_reference`. The closure around it
    (`tiled_event_closure`) is the plain closure with K4 as its insert.
    Batched over keys, `tiled_insert_batch`: K keys' transactions, a
    table each, in one launch (plain version
    `tiled_insert_batch_reference`), inside `tiled_event_closure_batch`.
  * K3, `hash_insert` — one visited-set transaction of the sharded
    engine's closure iterations: probe, claim, loser re-check and the
    append of the fresh rows (`kernels/hash_insert.cu`; replaces
    `jepsen_tpu.parallel.sparse_kernels.hash_insert_call`). Its plain
    version is `sparse._hash_insert_append`. Its table lives in shared
    memory, under one block, while it fits the opt-in (`k3_layout`
    "shared"); else in device memory, under a cooperative grid of every
    block the card keeps resident (`k3_layout` "device", `k3_grid_blocks`),
    so it takes every shape.

Each kernel takes rows of one, two or three int32 lanes: the triple
(state, mask_lo, mask_hi), or the packed word of `config_pack`
(`sparse._PackedRep`: one lane up to 32 bits, two up to 64). The lane
count picks the visited-set hash (the triple's, or the packed word's),
and K2, which also runs the model step, takes the word's layout
(state_bits, state_lo).

The gate comes from K2's shared-memory layout: it keeps the frontier
(4L bytes a row of L lanes), the table (T = next_pow2(2N) slots of 4L
bytes of row, 4 of claim and 1 of occupancy) and two bytes per
candidate (N*C of them) in one block. The budget is the card's opt-in on
a card (232,448 bytes on the H100) and that Hopper figure on the CPU,
so the CPU tests take the routes the card would.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version, which the tests and `chip_smoke.py`
hold the kernel against. Each wrapper counts its launches, and nothing
else, in a plain integer: `launches["frontier_closure"]`,
`launches["frontier_closure_batch"]` (K2's stats instantiation counts
apart, in `launches["frontier_closure_stats"]` and
`launches["frontier_closure_batch_stats"]`), `launches["hash_insert"]`,
`launches["tiled_insert"]` and `launches["tiled_insert_batch"]` (its
three kernels count once); K3 also counts them per table layout, in
`hash_insert_launches["shared"]` and `hash_insert_launches["device"]`.
"""

from __future__ import annotations

import ctypes

import torch

from jepsen_tpu_torch.parallel import sparse as sp
from jepsen_tpu_torch.parallel.search_stats import _probe_hist

_I32 = torch.int32

# dynamic shared memory a Hopper block can opt in to (H100 and H200)
HOPPER_SMEM_OPTIN = 232_448

# model-step family -> the kernels' step code (sparse_common.cuh StepCode)
STEP_CODES = {"register": 0, "mutex": 1, "gset": 2, "uqueue": 3, "fifo": 4}

# kernel launches since the last reset, per wrapper
launches = {"frontier_closure": 0, "frontier_closure_batch": 0,
            "frontier_closure_stats": 0, "frontier_closure_batch_stats": 0,
            "hash_insert": 0, "tiled_insert": 0, "tiled_insert_batch": 0}
# K3's launches since the last reset, per table layout
hash_insert_launches = {"shared": 0, "device": 0}

MAX_C = 64
# K2: the slot tables (3 int32 + 2 bytes per slot, for 64 slots) and 40
# words of scan scratch
K2_FIXED_BYTES = 3 * 4 * MAX_C + 40 * 4 + 2 * MAX_C
# K3: 40 words of scan scratch, and in the shared layout the table
K3_FIXED_BYTES = 40 * 4
# K3's device layout: the blocks of its cooperative grid, at most (the
# scratch keeps one count per block; hash_insert.cu kMaxGrid)
K3_MAX_GRID = 1024


def slot_bytes(lanes: int = 3) -> int:
    """Shared memory of one table slot of `lanes`-lane rows: the row, a
    claim word and an occupancy byte."""
    return 4 * lanes + 5


def k2_smem_bytes(N: int, C: int, lanes: int = 3) -> int:
    """K2's dynamic shared memory at frontier capacity N, C slots and
    rows of `lanes` lanes."""
    T = sp._next_pow2(2 * N)
    return 4 * lanes * N + slot_bytes(lanes) * T + 2 * N * C \
        + K2_FIXED_BYTES


def k3_smem_bytes(Nd: int, lanes: int = 3) -> int:
    """K3's dynamic shared memory with the table of per-rank capacity Nd
    (Td = next_pow2(2 Nd) slots of `lanes`-lane rows) in shared memory.
    The candidates and their probe state stay in device memory, so M
    does not enter."""
    return slot_bytes(lanes) * sp._next_pow2(2 * Nd) + K3_FIXED_BYTES


def k3_layout(Nd: int, device=None, lanes: int = 3) -> str:
    """Where K3 keeps the visited set at per-rank capacity Nd: "shared"
    (in one block's shared memory) while `k3_smem_bytes(Nd, lanes)` fits
    the block's opt-in (the card's on a card, Hopper's elsewhere: Nd <=
    4,096 on the H100 for the triple, 8,192 for one or two lanes), else
    "device" (in device memory, under the cooperative grid)."""
    device = torch.device("cpu" if device is None else device)
    budget = _device_optin("hash_insert", device) \
        if device.type == "cuda" else HOPPER_SMEM_OPTIN
    return "shared" if k3_smem_bytes(Nd, lanes) <= budget else "device"


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


def supported(N: int, C: int, budget: int = HOPPER_SMEM_OPTIN,
              lanes: int = 3) -> bool:
    """Whether K2 takes frontier capacity N with C slots and rows of
    `lanes` lanes: its layout fits `budget` bytes. On the H100, for the
    triple, that is N = 1024 for every C <= 64 and N = 2048 for C <= 33;
    for one lane N = 2048 for every C <= 64 and N = 4096 for C <= 17."""
    return 1 <= C <= MAX_C and lanes in (1, 2, 3) \
        and k2_smem_bytes(N, C, lanes) <= budget


# ----------------------------------------------------------- the libraries

_libs: dict = {}
# (kernel, device index) -> the block's shared-memory opt-in there, read
# by the kernel's init (which also grants it to the kernel there)
_optin: dict = {}
# device index -> the blocks of K3's cooperative grid there
_k3_grid: dict = {}
# device index -> the blocks of K4's cooperative grid there
_k4_grid: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name: str):
    lib = _libs.get(name)
    if lib is None:
        from jepsen_tpu_torch import kernels
        lib = kernels.load(name)
        if name == "frontier_closure":
            lib.jt_frontier_closure_launch.argtypes = \
                [_I] + [_P] * 5 + [_I] * 2 + [_P] * 10 + [_I] * 7 + [_P]
            lib.jt_frontier_closure_launch.restype = _I
            lib.jt_frontier_closure_smem.argtypes = [_I, _I, _I]
            lib.jt_frontier_closure_smem.restype = ctypes.c_longlong
        elif name == "hash_insert":
            lib.jt_hash_insert_launch.argtypes = \
                [_P] * 4 + [_I] + [_P] * 3 + [_I, _P] + [_P] * 4 + [_I] \
                + [_P] * 8 + [_P, _I, _I, _I, _I, _P]
            lib.jt_hash_insert_launch.restype = _I
            lib.jt_hash_insert_grid_shape.argtypes = \
                [ctypes.POINTER(_I), ctypes.POINTER(_I)]
            lib.jt_hash_insert_grid_shape.restype = _I
            lib.jt_hash_insert_scratch.argtypes = [_I, _I, _I]
            lib.jt_hash_insert_scratch.restype = ctypes.c_longlong
            lib.jt_hash_insert_smem.argtypes = [_I, _I, _I]
            lib.jt_hash_insert_smem.restype = ctypes.c_longlong
        else:
            lib.jt_tiled_insert_launch.argtypes = \
                [_P] * 4 + [_I] + [_P] * 4 + [_I] + [_P] * 4 + [_I] * 4 \
                + [_P]
            lib.jt_tiled_insert_launch.restype = _I
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


def k4_grid(device) -> int:
    """The blocks of K4's cooperative grid on `device`: every block of
    its insert the card keeps resident (blocks per SM x SMs), read once
    there by jt_tiled_insert_init."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    v = _k4_grid.get(index)
    if v is None:
        with torch.cuda.device(index):
            v = _lib("tiled_insert").jt_tiled_insert_init()
        if v <= 0:
            raise RuntimeError(f"tiled_insert kernel: cannot set up device "
                               f"{index}: CUDA error {-v}")
        _k4_grid[index] = v
    return v


def smem_budget(device) -> int:
    """The shared-memory budget of the routes on `device`: K2's opt-in on
    the card, or Hopper's on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return _device_optin("frontier_closure", device)
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

_LANE_WORDS = {1: "one", 2: "two", 3: "three"}


def _lanes_ok(rows, L: int, shape) -> bool:
    return len(rows) == L and all(r.dtype == _I32 and tuple(r.shape) ==
                                  tuple(shape) for r in rows)


def _lane_ptrs(rows) -> list:
    """The lanes' device pointers, null past the row's lanes (the C
    entry points take three)."""
    return [_ptr(r) for r in rows] + [None] * (3 - len(rows))


def _row_lanes(pack, C: int) -> int:
    """The lanes of a row of layout `pack` at C slots, the layout checked
    (a packed word must fit 64 bits)."""
    if pack:
        return sp._PackedRep(pack[0], pack[1], C).lanes
    return 3


def _check_closure_args(step_name, ev, rows, live, run, probe_limit,
                        pack):
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
    L = _row_lanes(pack, C)
    _check(_lanes_ok(rows, L, (N,)),
           f"frontier_closure: rows must be {L} int32 [{N}] lanes (layout "
           f"{pack or 'triple'} at C={C})")
    _check(live.dtype == torch.bool and run.dtype == torch.bool
           and run.numel() == 1,
           "frontier_closure: live must be bool [N], run one bool")
    devs = {t.device for t in (*ev.values(), *rows, live, run)}
    _check(len(devs) == 1, f"frontier_closure: tensors on {devs}")
    return N, C


def _meta(out, stats: bool):
    """(rows2, meta int32 [..., 4]) of a closure's (rows2, count, ovf,
    iters, stepped), + its stats int32 [..., 8] (swork, then the
    histogram) with `stats`."""
    rows2, count, ovf, iters, stepped = out[:5]
    meta = torch.stack([count, ovf.to(count.dtype), iters, stepped],
                       -1).to(_I32)
    if not stats:
        return rows2, meta
    return rows2, meta, torch.cat([out[5][..., None].to(_I32),
                                   out[6].to(_I32)], -1)


def frontier_closure_reference(step_name, ev, rows, live, run,
                               probe_limit: int, pack=(),
                               stats: bool = False):
    """K2's plain version: `sparse._hash_event_closure` over rows of
    layout `pack` -> (rows2, meta int32[4] = count, ovf, iters, stepped),
    + with `stats` the int32 [8] stats (swork, then the probe-length
    histogram). With `run` False the event is skipped: zero rows, zero
    meta and zero stats, as the kernel writes."""
    N = live.shape[0]
    rep = sp._rep(pack, ev["slot_f"].shape[0], live.device)
    if not bool(run):
        zeros = rep.zeros(N), torch.zeros(4, dtype=_I32, device=live.device)
        return zeros + ((torch.zeros(8, dtype=_I32, device=live.device),)
                        if stats else ())
    return _meta(sp._hash_event_closure(
        rep, sp.STEPS[step_name], ev, rows, live, run, N,
        sp._next_pow2(2 * N), probe_limit, stats=stats), stats)


def frontier_closure(step_name: str, ev: dict, rows, live, run,
                     probe_limit: int, pack=(), stats: bool = False):
    """K2: one return event's whole hash closure.

    ev     the event's slot tables: slot_f/slot_a0/slot_a1 int32 [C],
           slot_wild/slot_occ bool [C]
    rows   the frontier, int32 lanes [N] of layout `pack`: () the triple
           (three lanes), (state_bits, state_lo) the packed word (one or
           two, `sparse.pack_lanes`); live bool [N]
    run    one bool: False skips the event (zero rows and meta)
    stats  True: also the reference's stats outputs
    ->     (rows2, meta int32[4] = count, ovf, iters, stepped), rows2 the
           closed frontier compacted into rows [0, count), zeros after;
           with `stats` + int32 [8]: swork (the frontier count at the
           start of each pass, summed), then the histogram of the final
           probe offsets of the attempted candidates of the seed and
           every pass (buckets `search_stats.PROBE_HIST_LABELS`).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (its stats-off or its stats instantiation) on the current
    stream, after the shape gate (`supported(N, C, lanes=L)` against
    the card's opt-in)."""
    _check_closure_args(step_name, ev, rows, live, run, probe_limit, pack)
    if _dev(live).type == "cpu":
        return frontier_closure_reference(step_name, ev, rows, live, run,
                                          probe_limit, pack, stats)
    out = _frontier_closure_launch(step_name, ev, 0, 1, rows, live, run,
                                   probe_limit, pack, stats)
    launches["frontier_closure_stats" if stats else "frontier_closure"] += 1
    return out


SLOT_TABLES = ("slot_f", "slot_a0", "slot_a1", "slot_wild", "slot_occ")


def _frontier_closure_launch(step_name, xs, r: int, R: int, rows, live,
                             run, probe_limit: int, pack=(),
                             stats: bool = False):
    """K2's launch on CUDA tensors after the shape gate: one key's event
    (slot tables [C], rows and live [N], one run flag) or event row r of
    K keys' (tables [K, R, C], rows and live [K, N], run [K]); the
    outputs take live's shape and the rows' lanes, with `stats` a third,
    [..., 8], from the kernel's stats instantiation. Raises on a launch
    the card refuses; counts nothing (its callers do)."""
    C, N = xs["slot_f"].shape[-1], live.shape[-1]
    K = live.numel() // N
    L = len(rows)
    dev = live.device
    if not supported(N, C, _device_optin("frontier_closure", dev), L):
        raise ValueError(f"frontier_closure: N={N} C={C} with {L}-lane rows "
                         f"needs {k2_smem_bytes(N, C, L)} bytes of shared "
                         f"memory, past the card's opt-in")
    s_bits, state_lo = pack if pack else (0, 0)
    ins = [xs[k].contiguous() for k in SLOT_TABLES]
    rows = [x.contiguous() for x in rows]
    flags = [live.contiguous(), run.contiguous()]
    out = [torch.empty(live.shape, dtype=_I32, device=dev)
           for _ in range(L)]
    meta = torch.empty((*live.shape[:-1], 4), dtype=_I32, device=dev)
    st = torch.empty((*live.shape[:-1], 8), dtype=_I32, device=dev) \
        if stats else None
    with torch.cuda.device(dev):
        err = _lib("frontier_closure").jt_frontier_closure_launch(
            STEP_CODES[step_name], *map(_ptr, ins), r, R, *_lane_ptrs(rows),
            *map(_ptr, flags), *_lane_ptrs(out), _ptr(meta),
            None if st is None else _ptr(st), K, N, C, probe_limit, L,
            s_bits, state_lo, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"frontier_closure kernel launch failed: CUDA "
                           f"error {err}")
    return (tuple(out), meta) + ((st,) if stats else ())


def frontier_closure_batch_reference(step_name, xs, r: int, rows, live,
                                     run, probe_limit: int, pack=(),
                                     stats: bool = False):
    """Batched K2's plain version: `frontier_closure_reference` key by
    key on event row r -> (rows2 [K, N] lanes, meta int32 [K, 4]), + with
    `stats` int32 [K, 8]. A key whose `run` is False gets zero rows, zero
    meta and zero stats."""
    outs = [frontier_closure_reference(
        step_name, {k: xs[k][i, r] for k in SLOT_TABLES},
        tuple(x[i] for x in rows), live[i], run[i], probe_limit, pack,
        stats)
        for i in range(live.shape[0])]
    return (tuple(torch.stack([o[0][j] for o in outs])
                  for j in range(len(rows))),
            *(torch.stack([o[m] for o in outs])
              for m in range(1, len(outs[0]))))


def frontier_closure_batch(step_name: str, xs: dict, r: int, rows, live,
                           run, probe_limit: int, pack=(),
                           stats: bool = False):
    """Batched K2: event row r's whole hash closure for each of K keys,
    in one launch (a block a key).

    xs     the padded batch's slot tables: slot_f/slot_a0/slot_a1 int32
           [K, R, C], slot_wild/slot_occ bool [K, R, C] (read in place;
           other entries are ignored)
    r      the event row, 0 <= r < R
    rows   int32 lanes [K, N] of layout `pack` (as `frontier_closure`'s);
           live bool [K, N]
    run    bool [K]: False skips that key (zero rows and meta)
    stats  True: also each key's stats outputs
    ->     (rows2 int32 lanes [K, N], meta int32 [K, 4] = count, ovf,
           iters, stepped per key), + with `stats` int32 [K, 8], as
           `frontier_closure` gives each key.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel on the current stream, after the shape gate (`supported(N,
    C, lanes=L)` against the card's opt-in), or raises."""
    _check(step_name in STEP_CODES, f"frontier_closure_batch: unknown "
                                    f"step family {step_name!r}")
    _check(xs["slot_f"].dim() == 3, "frontier_closure_batch: slot tables "
                                    "must be [K, R, C]")
    K, R, C = xs["slot_f"].shape
    N = live.shape[-1]
    _check(1 <= C <= MAX_C and 0 <= r < R and K >= 1,
           f"frontier_closure_batch: C={C} outside 1..{MAX_C}, or row "
           f"{r} outside 0..{R - 1}")
    _check(1 <= probe_limit <= sp.MAX_PROBE_LIMIT,
           f"frontier_closure_batch: probe_limit={probe_limit} outside "
           f"1..{sp.MAX_PROBE_LIMIT}")
    for k in SLOT_TABLES:
        dt = _I32 if k in ("slot_f", "slot_a0", "slot_a1") else torch.bool
        _check(xs[k].dtype == dt and tuple(xs[k].shape) == (K, R, C),
               f"frontier_closure_batch: {k} must be {dt} [{K}, {R}, {C}]")
    L = _row_lanes(pack, C)
    _check(_lanes_ok(rows, L, (K, N))
           and live.dtype == torch.bool and tuple(live.shape) == (K, N)
           and run.dtype == torch.bool and tuple(run.shape) == (K,),
           f"frontier_closure_batch: rows must be {L} int32 [{K}, N] "
           f"lanes (layout {pack or 'triple'} at C={C}), live bool "
           f"[{K}, N], run bool [{K}]")
    devs = {t.device for t in (*(xs[k] for k in SLOT_TABLES), *rows, live,
                               run)}
    _check(len(devs) == 1, f"frontier_closure_batch: tensors on {devs}")
    if _dev(live).type == "cpu":
        return frontier_closure_batch_reference(step_name, xs, r, rows,
                                                live, run, probe_limit, pack,
                                                stats)
    out = _frontier_closure_launch(step_name, xs, r, R, rows, live, run,
                                   probe_limit, pack, stats)
    launches["frontier_closure_batch_stats" if stats
             else "frontier_closure_batch"] += 1
    return out


# --------------------------------------------------------------------- K3

def hash_insert_reference(c_rows, c_live, f_rows, count, table,
                          probe_limit: int, N: int):
    """K3's plain version, on any device: `sparse._hash_insert_append`."""
    return sp._hash_insert_append(c_rows, c_live, f_rows, count, table,
                                  probe_limit, N, sp._RowLayout())


def hash_insert(c_rows, c_live, f_rows, count, table, probe_limit: int,
                N: int):
    """K3: one visited-set transaction — insert the live candidates into
    the open-addressed table by bounded linear probing (racing claims go
    to the lowest candidate index; losers re-check the slot), then append
    the fresh ones, in candidate order, after the first `count` frontier
    rows.

    c_rows  candidates, L int32 lanes [M] (L = 3: the triple; 1 or 2: the
            packed word); c_live bool [M]
    f_rows  the frontier, L int32 lanes [N]
    count   integer tensor, one value: the frontier rows in use
    table   (L int32 lanes [T], occupancy bool [T]), T a power of two
    ->      (rows2, table2, count2, n_fresh, ovf): count2 = min(count +
            n_fresh, N), ovf a probe run past `probe_limit` or an append
            past N (the rows past N are dropped).

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel on the current stream, with the table in shared memory under
    one block or in device memory under a cooperative grid, as
    `k3_layout` says."""
    t_rows, t_occ = table
    M, T = c_live.shape[0], t_occ.shape[0]
    L = len(c_rows)
    _check(M >= 1 and N >= 1 and T >= 2 and T & (T - 1) == 0,
           f"hash_insert: M={M} N={N} T={T} (T a power of two)")
    _check(1 <= probe_limit <= sp.MAX_PROBE_LIMIT,
           f"hash_insert: probe_limit={probe_limit} outside "
           f"1..{sp.MAX_PROBE_LIMIT}")
    _check(L in (1, 2, 3) and _lanes_ok(c_rows, L, (M,))
           and _lanes_ok(f_rows, L, (N,)) and _lanes_ok(t_rows, L, (T,))
           and c_live.dtype == torch.bool and t_occ.dtype == torch.bool
           and count.numel() == 1 and not count.is_floating_point(),
           f"hash_insert: rows must be {_LANE_WORDS.get(L, L)} int32 lanes "
           f"(1-3, as many in the candidates, the frontier and the table; "
           f"[{M}], [{N}], [{T}]), flags bool, count one integer")
    devs = {t.device for t in (*c_rows, c_live, *f_rows, count, *t_rows,
                               t_occ)}
    _check(len(devs) == 1, f"hash_insert: tensors on {devs}")
    dev = _dev(c_live)
    if dev.type == "cpu":
        return hash_insert_reference(c_rows, c_live, f_rows, count, table,
                                     probe_limit, N)
    return _hash_insert_launch(c_rows, c_live, f_rows, count, table,
                               probe_limit, N, k3_layout(T // 2, dev, L))


def _hash_insert_launch(c_rows, c_live, f_rows, count, table,
                        probe_limit: int, N: int, layout_name: str):
    """K3's launch on CUDA tensors in the table layout named (the
    wrapper's is `k3_layout`'s; chip_smoke.py also times the grid on a
    table the shared layout takes). Raises on a launch the card
    refuses."""
    t_rows, t_occ = table
    M, T = c_live.shape[0], t_occ.shape[0]
    L = len(c_rows)
    dev = c_live.device
    lib = _lib("hash_insert")
    layout = {"shared": 0, "device": 1}[layout_name]
    grid = k3_grid(dev) if layout_name == "device" else 0
    scratch = torch.empty(lib.jt_hash_insert_scratch(M, T, layout),
                          dtype=torch.uint8, device=dev)
    c_rows = [r.contiguous() for r in c_rows]
    f_rows = [r.contiguous() for r in f_rows]
    t_rows = [r.contiguous() for r in t_rows]
    out = [torch.empty(N, dtype=_I32, device=dev) for _ in range(L)]
    t_out = [torch.empty(T, dtype=_I32, device=dev) for _ in range(L)]
    occ_out = torch.empty(T, dtype=torch.bool, device=dev)
    meta = torch.empty(3, dtype=_I32, device=dev)
    cnt = count.reshape(1).to(_I32)
    with torch.cuda.device(dev):
        err = lib.jt_hash_insert_launch(
            *_lane_ptrs(c_rows), _ptr(c_live.contiguous()), M,
            *_lane_ptrs(f_rows), N, _ptr(cnt), *_lane_ptrs(t_rows),
            _ptr(t_occ.contiguous()), T, *_lane_ptrs(out),
            *_lane_ptrs(t_out), _ptr(occ_out), _ptr(meta), _ptr(scratch),
            probe_limit, layout, grid, L,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_insert kernel launch failed ({layout_name}"
                           f" layout): CUDA error {err}")
    launches["hash_insert"] += 1
    hash_insert_launches[layout_name] += 1
    return (tuple(out), (tuple(t_out), occ_out), meta[0], meta[1],
            meta[2] != 0)


# --------------------------------------------------------------------- K4

def tiled_insert_reference(c_rows, c_live, table, probe_limit: int):
    """K4's plain version: the reference's visited-set transaction over
    the whole table (`sparse._hash_insert`). Returns (table2, fresh
    bool[M], off int32[M], probe_ovf bool) and leaves `table` as it
    is."""
    table2, fresh, p_ovf, off = sp._hash_insert(
        c_rows, c_live, table, probe_limit, sp._RowLayout())
    return table2, fresh, off, p_ovf


def _check_k4_args(what, c_rows, c_live, table, probe_limit, K):
    t_rows, t_occ = table
    M, T = c_live.shape[-1], t_occ.shape[-1]
    lead = tuple(c_live.shape[:-1])
    L = len(c_rows)
    _check(M >= 1 and T >= 2 and T & (T - 1) == 0,
           f"{what}: M={M} T={T} (T must be a power of two)")
    _check(K * M < 2 ** 31 - 1,
           f"{what}: {K} x {M} candidates, past the kernel's int32 list")
    _check(1 <= probe_limit <= sp.MAX_PROBE_LIMIT,
           f"{what}: probe_limit={probe_limit} outside "
           f"1..{sp.MAX_PROBE_LIMIT}")
    _check(L in (1, 2, 3) and _lanes_ok(c_rows, L, (*lead, M))
           and _lanes_ok(t_rows, L, (*lead, T))
           and c_live.dtype == torch.bool and t_occ.dtype == torch.bool
           and tuple(t_occ.shape) == (*lead, T),
           f"{what}: rows must be {_LANE_WORDS.get(L, L)} int32 lanes (1-3, "
           f"as many in the candidates and the table), flags bool")
    devs = {t.device for t in (*c_rows, c_live, *t_rows, t_occ)}
    _check(len(devs) == 1, f"{what}: tensors on {devs}")
    return _dev(c_live)


def tiled_insert(c_rows, c_live, table, probe_limit: int):
    """K4: the probe/claim half of one visited-set transaction, over the
    whole table (the reference's transaction).

    c_rows  candidates, L int32 lanes [M] (L = 3: the triple; 1 or 2: the
            packed word); c_live bool [M]
    table   (L int32 lanes [T], occupancy bool [T]), T a power of two
    ->      (table2, fresh bool[M], off int32[M], probe_ovf bool [])

    A CPU tensor runs the plain version, which leaves `table` as it is.
    A CUDA tensor launches the kernel on the current stream; the kernel
    updates the table in place, so `table` is consumed: table2 is the
    same tensors (their copies, where a lane was not contiguous), and a
    caller that needs the old table clones it first. The only caller,
    `tiled_event_closure`, never reads a table after inserting into
    it."""
    _check(c_live.dim() == 1, "tiled_insert: candidates [M]")
    if _check_k4_args("tiled_insert", c_rows, c_live, table, probe_limit,
                      1).type == "cpu":
        return tiled_insert_reference(c_rows, c_live, table, probe_limit)
    out = _tiled_insert_launch(c_rows, c_live, table, probe_limit)
    launches["tiled_insert"] += 1
    return out


def _tiled_insert_launch(c_rows, c_live, table, probe_limit: int):
    """K4's launches on CUDA tensors, one key's ([M] candidates, a [T]
    table) or K keys' ([K, M] and [K, T]: `tiled_insert_batch`) ->
    (table2, fresh, off, probe_ovf). Raises on a launch the card
    refuses; counts nothing (its callers do)."""
    t_rows, t_occ = table
    M, T = c_live.shape[-1], t_occ.shape[-1]
    K = c_live.shape[0] if c_live.dim() == 2 else 1
    L = len(c_rows)
    dev = c_live.device
    lib = _lib("tiled_insert")
    grid = k4_grid(dev)
    c_rows = [r.contiguous() for r in c_rows]
    t_rows = [r.contiguous() for r in t_rows]
    t_occ = t_occ.contiguous()
    fresh = torch.empty(c_live.shape, dtype=torch.bool, device=dev)
    off = torch.empty(c_live.shape, dtype=_I32, device=dev)
    pend = torch.empty(c_live.shape[:-1], dtype=torch.bool, device=dev)
    scratch = torch.empty(lib.jt_tiled_insert_scratch(K, M, T),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.jt_tiled_insert_launch(
            *_lane_ptrs(c_rows), _ptr(c_live.contiguous()), M,
            *_lane_ptrs(t_rows), _ptr(t_occ), T, _ptr(fresh), _ptr(off),
            _ptr(pend), _ptr(scratch), K, probe_limit, grid, L,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled_insert kernel launch failed: CUDA "
                           f"error {err}")
    return (tuple(t_rows), t_occ), fresh, off, pend


def _tiled_hook(insert_fn, probe_limit: int, N: int, stats: bool):
    """The closure's insert hook around K4 (`insert_fn`: `tiled_insert`
    or `tiled_insert_batch`) and the plain append; with `stats` its
    probe-length histogram, bucketed in torch from K4's `off` output, as
    the reference's `make_tiled_insert` does."""
    def insert(c_rows, c_live, f_rows, count, table):
        table2, fresh, off, p_ovf = insert_fn(c_rows, c_live, table,
                                              probe_limit)
        rows2, count2, n_fresh, a_ovf = sp._append_fresh(
            c_rows, fresh, f_rows, count, N)
        out = (rows2, table2, count2, n_fresh, p_ovf | a_ovf)
        if stats:
            return out + (_probe_hist(off, c_live),)
        return out
    return insert


def tiled_event_closure(rep, step, ev, rows, live, run, N: int, T: int,
                        probe_limit: int, stats: bool = False):
    """The hash closure of one event with K4 as its visited-set insert:
    `sparse._hash_event_closure` whose insert hook is `tiled_insert`
    followed by the plain append. -> (rows2, meta int32[4]), + with
    `stats` int32 [8] as `frontier_closure`'s."""
    return _meta(sp._hash_event_closure(
        rep, step, ev, rows, live, run, N, T, probe_limit,
        insert=_tiled_hook(tiled_insert, probe_limit, N, stats),
        stats=stats), stats)


def tiled_insert_batch_reference(c_rows, c_live, table, probe_limit: int):
    """Batched K4's plain version: `tiled_insert_reference` key by key ->
    (table2 ([K, T] lanes, occupancy), fresh [K, M], off [K, M],
    probe_ovf [K]). Leaves `table` as it is."""
    t_rows, t_occ = table
    outs = [tiled_insert_reference(
        tuple(x[i] for x in c_rows), c_live[i],
        (tuple(x[i] for x in t_rows), t_occ[i]), probe_limit)
        for i in range(c_live.shape[0])]
    return ((tuple(torch.stack([o[0][0][j] for o in outs])
                   for j in range(len(c_rows))),
             torch.stack([o[0][1] for o in outs])),
            *(torch.stack([o[j] for o in outs]) for j in (1, 2, 3)))


def tiled_insert_batch(c_rows, c_live, table, probe_limit: int):
    """Batched K4: K keys' visited-set transactions, each into its own
    table, in one launch (the list of every key's live candidates, then
    one cooperative grid). What key k gets is `tiled_insert` on its own
    candidates and table.

    c_rows  candidates, L int32 lanes [K, M] (as `tiled_insert`'s);
            c_live bool [K, M]
    table   (L int32 lanes [K, T], occupancy bool [K, T]), T a power of
            two
    ->      (table2, fresh bool [K, M], off int32 [K, M], probe_ovf bool
            [K])

    A CPU tensor runs the plain version, which leaves `table` as it is;
    a CUDA tensor launches the kernels on the current stream and updates
    the tables in place (`table` is consumed, as `tiled_insert`'s), or
    raises."""
    _check(c_live.dim() == 2, "tiled_insert_batch: candidates [K, M], "
                              "tables [K, T]")
    if _check_k4_args("tiled_insert_batch", c_rows, c_live, table,
                      probe_limit, c_live.shape[0]).type == "cpu":
        return tiled_insert_batch_reference(c_rows, c_live, table,
                                            probe_limit)
    out = _tiled_insert_launch(c_rows, c_live, table, probe_limit)
    launches["tiled_insert_batch"] += 1
    return out


def tiled_event_closure_batch(rep, step, ev, rows, live, run, N: int,
                              T: int, probe_limit: int, stats: bool = False):
    """The hash closures of one event row for K keys with batched K4 as
    their visited-set insert: `sparse._hash_event_closure_batch` whose
    insert is `tiled_insert_batch` followed by the plain append, one
    launch an iteration for every key. ev [K, C] slot tables, rows
    and live [K, N], run [K] -> (rows2 [K, N] lanes, meta int32 [K, 4]),
    + with `stats` int32 [K, 8]; a key whose closure ended early is
    frozen, one that does not run gets zero rows and meta."""
    return _meta(sp._hash_event_closure_batch(
        rep, step, ev, rows, live, run, N, T,
        _tiled_hook(tiled_insert_batch, probe_limit, N, stats),
        stats=stats), stats)
