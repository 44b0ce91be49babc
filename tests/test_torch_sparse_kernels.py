"""The sparse engine's kernels K2 and K4 (jepsen_tpu_torch.parallel.
sparse_kernels): their plain versions against the reference's Pallas
kernels run in interpret mode (`jepsen_tpu.parallel.sparse_kernels.
frontier_closure_call` and `tiled_insert_call`), bit for bit — rows in
order, counts, flags, table layout and probe offsets — on closure inputs
recorded from the port's own scans of every step family and on random
inserts with duplicates and lanes >= 2^31. Also the Hopper gates' arithmetic,
the wrappers' CPU contract and argument checks.

The CUDA kernels run only on the card: their tests are marked `cuda`
and skip here; chip_smoke.py holds them against the plain versions on
every run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import sparse_kernels as ref_sk
from jepsen_tpu_torch.parallel import sparse
from jepsen_tpu_torch.parallel import sparse_kernels as sk
from test_torch_sparse import CASES, _to_port


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# one small history per step family: the engine tests' cases (the
# reference's sparse-kernel parity generators)
FAMILIES = CASES


def _record(e, N, probe_limit):
    """Run the port's scan at capacity N and keep every K2 call's inputs
    and plain outputs."""
    calls = []
    real = sk.frontier_closure

    def recording(step_name, ev, rows, live, run, pl):
        out = real(step_name, ev, rows, live, run, pl)
        calls.append((step_name, dict(ev), tuple(r.clone() for r in rows),
                      live.clone(), run.clone(), out))
        return out

    sk.frontier_closure = recording
    try:
        sc = sparse._Scan(e, N, "hash", probe_limit, torch.device("cpu"))
        assert sc.closure == "fused"
        sc.run(e.n_returns)
    finally:
        sk.frontier_closure = real
    return calls


@functools.lru_cache(maxsize=None)
def _ref_closure(step_name, N, C, probe_limit):
    return jax.jit(functools.partial(
        ref_sk.frontier_closure_call, step_name, N=N, C=C,
        probe_limit=probe_limit, interpret=True))


def _u32(t):
    return jnp.asarray(t.numpy().view(np.uint32))


def _ref_frontier_closure(step_name, ev, rows, live, run, probe_limit):
    N, C = live.shape[0], ev["slot_f"].shape[0]
    ev_j = {k: jnp.asarray(v.numpy()) for k, v in ev.items()}
    rows_j = (jnp.asarray(rows[0].numpy()), _u32(rows[1]), _u32(rows[2]))
    rows2, count, ovf, iters, stepped = _ref_closure(
        step_name, N, C, probe_limit)(ev_j, rows_j, jnp.asarray(live.numpy()),
                                      jnp.asarray(run.numpy()))
    lanes = [np.asarray(r).view(np.int32) for r in rows2]
    return lanes, [int(count), int(bool(ovf)), int(iters), int(stepped)]


def _assert_closure_equal(call, probe_limit):
    step_name, ev, rows, live, run, (rows2, meta) = call
    want_rows, want_meta = _ref_frontier_closure(step_name, ev, rows, live,
                                                 run, probe_limit)
    assert meta.tolist() == want_meta
    for got, want in zip(rows2, want_rows):
        assert np.array_equal(got.numpy(), want)


def _largest(calls, k=3):
    """The k recorded events with the largest closure (by rows out)."""
    return sorted(calls, key=lambda c: -int(c[5][1][0]))[:k]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_k2_matches_interpret_pallas(family):
    Model, gen = FAMILIES[family]
    e = _to_port(ref_enc.encode(Model(), gen()))
    assert e.step_name == {"register": "register", "gset": "gset",
                           "uqueue": "uqueue", "fifo": "fifo",
                           "mutex": "mutex"}[family]
    calls = _record(e, 64, 32)
    assert calls
    for call in _largest(calls):
        assert int(call[5][1][2]) >= 1     # the closure ran
        _assert_closure_equal(call, 32)


def test_plain_k2_matches_interpret_pallas_on_probe_overflow():
    """probe_limit=2 on a 128-slot table: the closure stops on probe
    exhaustion, with the reference's rows, count and counters."""
    Model, gen = FAMILIES["fifo"]
    e = _to_port(ref_enc.encode(Model(), gen()))
    calls = _record(e, 64, 2)
    ovf = [c for c in calls if int(c[5][1][1]) == 1]
    assert ovf, "no event overflowed its probes"
    _assert_closure_equal(ovf[0], 2)
    _assert_closure_equal(_largest(calls, 1)[0], 2)


def test_k2_wrapper_skips_an_event_that_does_not_run():
    Model, gen = FAMILIES["uqueue"]
    e = _to_port(ref_enc.encode(Model(), gen()))
    step_name, ev, rows, live, run, _ = _largest(_record(e, 64, 32), 1)[0]
    rows2, meta = sk.frontier_closure(step_name, ev, rows, live,
                                      torch.tensor(False), 32)
    assert meta.tolist() == [0, 0, 0, 0]
    assert all(not r.any() for r in rows2)


def _rand_rows(rng, n, pool):
    """n rows drawn from `pool` distinct random rows, lanes over the whole
    32-bit range (int32 bit patterns)."""
    base = rng.integers(0, 1 << 32, size=(3, pool), dtype=np.uint64)
    base = base.astype(np.uint32).view(np.int32)
    pick = rng.integers(0, pool, size=n)
    return tuple(np.ascontiguousarray(base[k][pick]) for k in range(3))


def _ref_tiled(c_rows, c_live, table, probe_limit, plan):
    (t_rows, t_occ) = table
    j = jax.jit(functools.partial(ref_sk.tiled_insert_call,
                                  probe_limit=probe_limit, plan=plan,
                                  pack=(), C=1, interpret=True))
    (tr, tocc), fresh, off, pend = j(
        (jnp.asarray(c_rows[0]), jnp.asarray(c_rows[1].view(np.uint32)),
         jnp.asarray(c_rows[2].view(np.uint32))), jnp.asarray(c_live),
        ((jnp.asarray(t_rows[0]), jnp.asarray(t_rows[1].view(np.uint32)),
          jnp.asarray(t_rows[2].view(np.uint32))), jnp.asarray(t_occ)))
    return ([np.asarray(r).view(np.int32) for r in tr], np.asarray(tocc),
            np.asarray(fresh), np.asarray(off), bool(pend))


def _port_tiled(c_rows, c_live, table, probe_limit, plan):
    (t_rows, t_occ) = table
    (tr, tocc), fresh, off, pend = sk.tiled_insert(
        tuple(torch.from_numpy(r) for r in c_rows), torch.from_numpy(c_live),
        (tuple(torch.from_numpy(r) for r in t_rows),
         torch.from_numpy(t_occ)), probe_limit, plan)
    return ([r.numpy() for r in tr], tocc.numpy(), fresh.numpy(),
            off.numpy(), bool(pend))


@pytest.mark.parametrize("probe_limit", [32, 2])
def test_plain_k4_matches_interpret_pallas(probe_limit):
    """Two transactions in a row on a 2048-slot table: 4 tiles of 512, 3
    chunks of 512 candidates, duplicates inside and across chunks and
    against the table."""
    plan = {"tile": 512, "chunk": 512}
    rng = np.random.default_rng(7)
    T, M = 2048, 1536
    table = (tuple(np.zeros(T, np.int32) for _ in range(3)),
             np.zeros(T, bool))
    sk.reset_launches()
    for _ in range(2):
        c_rows = _rand_rows(rng, M, 700)
        c_live = rng.random(M) < 0.8
        want = _ref_tiled(c_rows, c_live, table, probe_limit, plan)
        got = _port_tiled(c_rows, c_live, table, probe_limit, plan)
        for g, w in zip(got[0], want[0]):
            assert np.array_equal(g, w)
        for g, w in zip(got[1:4], want[1:4]):
            assert np.array_equal(g, w)
        assert got[4] == want[4]
        table = (tuple(got[0]), got[1])
    assert got[1].any() and got[2].any()
    assert (got[4] is True) == (probe_limit == 2)
    assert sk.launches["tiled_insert"] == 0


def test_plain_k4_one_tile_equals_the_untiled_insert():
    """With one tile and one chunk the tiled insert is `_hash_insert`."""
    rng = np.random.default_rng(3)
    c_rows = tuple(torch.from_numpy(r) for r in _rand_rows(rng, 300, 120))
    c_live = torch.from_numpy(rng.random(300) < 0.9)
    rep = sparse._rep((), 4)
    table = sparse._empty_table(1024, rep)
    a = sparse._hash_insert(c_rows, c_live, table, 32, rep)
    b = sk.tiled_insert(c_rows, c_live, table, 32, {"tile": 1024,
                                                    "chunk": 512})
    for x, y in zip(a[0][0], b[0][0]):
        assert torch.equal(x, y)
    assert torch.equal(a[0][1], b[0][1]) and torch.equal(a[1], b[1])
    assert torch.equal(a[3], b[2]) and bool(a[2]) == bool(b[3])


def test_hopper_gate_arithmetic():
    """K2 keeps 12N + 17T + 2NC + 1056 bytes (T = 2N): N = 1024 fits the
    H100's 232,448-byte opt-in for every C <= 64, N = 2048 up to C = 33,
    N = 4096 up to C = 5. K4's plan takes a tile and a chunk of 8,192."""
    assert sk.HOPPER_SMEM_OPTIN == 232_448
    assert sk.k2_smem_bytes(1024, 8) == 12 * 1024 + 17 * 2048 \
        + 2 * 1024 * 8 + 1056
    assert all(sk.supported(1024, C) for C in range(1, 65))
    assert not sk.supported(1024, 65)
    assert sk.supported(2048, 33) and not sk.supported(2048, 34)
    assert sk.supported(4096, 5) and not sk.supported(4096, 6)
    assert not sk.supported(8192, 1)
    assert sk.tiled_plan(32768, 12) == {"tile": 8192, "chunk": 8192}
    assert sk.k4_smem_bytes(8192, 8192, 8) == \
        4 * 8192 + 10 * 8192 + 8 * 5 <= sk.HOPPER_SMEM_OPTIN
    # a table smaller than the budget's tile is one tile
    assert sk.tiled_plan(1024, 40) == {"tile": 2048, "chunk": 16384}
    assert sk.tiled_plan(256, 8, budget=16384) == {"tile": 512,
                                                  "chunk": 512}
    assert sk.tiled_plan(64, 8) is None          # T = 128 < 512
    assert sk.tiled_plan(4096, 8, budget=8000) is None
    # every plan the gate makes fits its budget
    for N in (256, 1024, 4096, 32768, 1 << 20):
        for b in (16384, 65536, sk.HOPPER_SMEM_OPTIN):
            p = sk.tiled_plan(N, 8, b)
            if p is not None:
                T = 1 << (2 * N - 1).bit_length()
                assert sk.k4_smem_bytes(p["tile"], p["chunk"],
                                        T // p["tile"]) <= b


def test_routes_follow_the_gate():
    assert sparse._route(1024, 12, "hash", torch.device("cpu")) == \
        ("fused", None)
    assert sparse._route(4096, 12, "hash", torch.device("cpu")) == \
        ("tiled", {"tile": 8192, "chunk": 8192})
    assert sparse._route(512, 8, "hash", torch.device("cpu"),
                         smem_budget=16384) == \
        ("tiled", {"tile": 512, "chunk": 512})
    assert sparse._route(4096, 12, "sort", torch.device("cpu")) == \
        ("sort", None)
    with pytest.raises(RuntimeError, match="no tiled insert plan"):
        sparse._route(128, 8, "hash", torch.device("cpu"),
                      smem_budget=4000)


def _closure_args(C=3, N=8):
    ev = {"slot_f": torch.zeros(C, dtype=torch.int32),
          "slot_a0": torch.zeros(C, dtype=torch.int32),
          "slot_a1": torch.zeros(C, dtype=torch.int32),
          "slot_wild": torch.zeros(C, dtype=torch.bool),
          "slot_occ": torch.ones(C, dtype=torch.bool)}
    rows = tuple(torch.zeros(N, dtype=torch.int32) for _ in range(3))
    live = torch.arange(N) < 1
    return ev, rows, live, torch.tensor(True)


@pytest.mark.parametrize("bad", ["family", "dtype", "shape", "probe", "C"])
def test_k2_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ev, rows, live, run = _closure_args()
    name, pl = "register", 32
    if bad == "family":
        name = "stack"
    elif bad == "dtype":
        ev["slot_f"] = ev["slot_f"].long()
    elif bad == "shape":
        rows = (rows[0][:4],) + rows[1:]
    elif bad == "probe":
        pl = 256
    else:
        ev, rows, live, run = _closure_args(C=65)
    with pytest.raises(ValueError):
        sk.frontier_closure(name, ev, rows, live, run, pl)


def test_wrappers_have_no_fallback_for_other_devices():
    ev, rows, live, run = _closure_args()
    meta = {k: v.to("meta") for k, v in ev.items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        sk.frontier_closure("register", meta,
                            tuple(r.to("meta") for r in rows),
                            live.to("meta"), run.to("meta"), 32)
    with pytest.raises(RuntimeError, match="no kernel"):
        sk.tiled_insert(tuple(r.to("meta") for r in rows), live.to("meta"),
                        (tuple(torch.zeros(16, dtype=torch.int32,
                                           device="meta")
                               for _ in range(3)),
                         torch.zeros(16, dtype=torch.bool, device="meta")),
                        32, {"tile": 512, "chunk": 512})


def test_cpu_wrappers_run_the_plain_versions_and_count_nothing():
    Model, gen = FAMILIES["gset"]
    e = _to_port(ref_enc.encode(Model(), gen()))
    sk.reset_launches()
    r = sparse.check_encoded(e, device="cpu")
    r2 = sparse.check_encoded(e, device="cpu", capacity=512,
                              smem_budget=16384)
    assert r["closure"] == "torch" and r2["closure"] == "torch-tiled"
    assert sk.launches["frontier_closure"] == 0
    assert sk.launches["tiled_insert"] == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("probe_limit", [32, 2])
def test_cuda_k2_matches_plain(family, probe_limit):
    dev = _cuda()
    Model, gen = FAMILIES[family]
    e = _to_port(ref_enc.encode(Model(), gen()))
    for step_name, ev, rows, live, run, (rows2, meta) in \
            _record(e, 64, probe_limit):
        before = sk.launches["frontier_closure"]
        g_rows, g_meta = sk.frontier_closure(
            step_name, {k: v.to(dev) for k, v in ev.items()},
            tuple(r.to(dev) for r in rows), live.to(dev), run.to(dev),
            probe_limit)
        torch.cuda.synchronize()
        assert sk.launches["frontier_closure"] == before + 1
        assert g_meta.cpu().tolist() == meta.tolist()
        for g, w in zip(g_rows, rows2):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("probe_limit", [32, 2])
def test_cuda_k4_matches_plain(probe_limit):
    dev = _cuda()
    plan = {"tile": 512, "chunk": 512}
    rng = np.random.default_rng(7)
    c_rows = tuple(torch.from_numpy(r) for r in _rand_rows(rng, 1536, 700))
    c_live = torch.from_numpy(rng.random(1536) < 0.8)
    rep = sparse._rep((), 1)
    table = sparse._empty_table(2048, rep)
    want = sk.tiled_insert(c_rows, c_live, table, probe_limit, plan)
    before = sk.launches["tiled_insert"]
    got = sk.tiled_insert(tuple(r.to(dev) for r in c_rows), c_live.to(dev),
                          (tuple(r.to(dev) for r in table[0]),
                           table[1].to(dev)), probe_limit, plan)
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert"] == before + 1
    for g, w in zip(got[0][0], want[0][0]):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got[0][1].cpu(), want[0][1])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    assert bool(got[3]) == bool(want[3])


# --------------------------------------- the binned K4 and the new cases

import torch_parity_cases as parity_cases  # noqa: E402


@functools.lru_cache(maxsize=None)
def _k4_cases():
    return {c[0]: c for c in parity_cases.k4_cases()}


@functools.lru_cache(maxsize=None)
def _k2_cases():
    return {c[0]: c for c in parity_cases.k2_cases()}


def tiled_bin_reference(c_rows, c_live, T: int, plan: dict):
    """The order K4's bin puts the live candidates in, as plain ops: their
    indices sorted by home tile (h & (tiles - 1)), stably, so in index
    order inside a tile; with each tile's count and offset into that
    list. The kernel's per-block segments, read in block order, are
    this list. -> (order int64[live], counts int64[tiles], offsets
    int64[tiles])."""
    M = c_live.shape[0]
    n_tt = sk._tiling(T, M, plan)[0]
    h = sparse.table_hash_u32(*(sparse._u32(r) for r in c_rows))
    tile = h & (n_tt - 1)
    live = torch.nonzero(c_live).flatten()
    order = live[torch.sort(tile[live], stable=True).indices]
    counts = torch.bincount(tile[live], minlength=n_tt)
    return order, counts, torch.cumsum(counts, 0) - counts


def tiled_insert_binned_reference(c_rows, c_live, table, probe_limit: int,
                                  plan: dict):
    """`tiled_insert_reference`'s function computed K4's way, as plain
    ops: the bin (`tiled_bin_reference`), then each tile's list walked
    chunk by chunk in order, a chunk with none of the tile's candidates
    skipped, each one round-synchronous insert inside the tile. Every
    field equals `tiled_insert_reference`'s, table layout and `off`
    included. Returns (table2, fresh bool[M], off int32[M], probe_ovf
    bool)."""
    M, T = c_live.shape[0], table[1].shape[0]
    dev = c_live.device
    _, TS, tt_bits, CH = sk._tiling(T, M, plan)
    order, counts, offsets = tiled_bin_reference(c_rows, c_live, T, plan)
    h = sparse.table_hash_u32(*(sparse._u32(r) for r in c_rows))
    start = (h >> tt_bits) & (TS - 1)
    fresh = torch.zeros(M, dtype=torch.bool, device=dev)
    off = torch.zeros(M, dtype=torch.int32, device=dev)
    pend = torch.zeros((), dtype=torch.bool, device=dev)
    for t, (o, n) in enumerate(zip(offsets.tolist(), counts.tolist())):
        mine = order[o:o + n]
        chunk = mine // CH
        for c in torch.unique_consecutive(chunk).tolist():
            idx = mine[chunk == c]
            table, f, p, o_ = sparse._hash_insert(
                tuple(r[idx] for r in c_rows),
                torch.ones(idx.shape[0], dtype=torch.bool, device=dev),
                table, probe_limit, h0=start[idx], base=t * TS, span=TS)
            fresh[idx] = f
            off[idx] = o_
            pend = pend | p
    return table, fresh, off, pend


K4_CASES = ["no live candidate in one tile, M=1500",
            "all live candidates in one tile",
            "equal rows across chunk boundaries", "probe_limit 1",
            "probe_limit 2", "40 live of 50,000 on a half-full table"]
K2_CASES = ["register N2048 C33 overflow pl32",
            "register N2048 C33 overflow pl2", "register N1024 C64 pl32",
            "register N1024 C64 pl2", "gset N1024 C64",
            "uqueue N1024 C8 small passes", "uqueue N1024 C8 wide seed",
            "uqueue N4096 C5 wide seed"]


def test_case_lists_name_every_case():
    assert sorted(K4_CASES) == sorted(_k4_cases())
    assert sorted(K2_CASES) == sorted(_k2_cases())


@pytest.mark.parametrize("name", K4_CASES)
def test_bin_order_matches_a_python_loop(name):
    """K4's bin: every live candidate once, grouped by home tile in tile
    order and in index order inside a tile; counts and offsets of each
    tile's run."""
    _, c_rows, c_live, table, _, plan = _k4_cases()[name]
    T, M = table[1].shape[0], c_live.shape[0]
    n_tt, TS, tt_bits, _ = sk._tiling(T, M, plan)
    order, counts, offsets = tiled_bin_reference(c_rows, c_live, T, plan)
    lanes = [r.numpy().view(np.uint32) for r in c_rows]
    mine = [[] for _ in range(n_tt)]
    for i in range(M):
        if c_live[i]:
            h = _hash_py(int(lanes[0][i]), int(lanes[1][i]),
                         int(lanes[2][i]))
            mine[h & (n_tt - 1)].append(i)
    assert order.tolist() == [i for t in mine for i in t]
    assert counts.tolist() == [len(t) for t in mine]
    assert offsets.tolist() == list(np.cumsum([0] + counts.tolist())[:-1])


def _hash_py(st, ml, mh):
    """The visited-set hash on Python ints (sparse_common.cuh table_hash)."""
    m = 0xFFFFFFFF
    h = ((st * 0x85EBCA6B) ^ (ml * 0xC2B2AE35) ^ (mh * 0x27D4EB2F)) & m
    h ^= h >> 16
    h = (h * 0x165667B1) & m
    return h ^ (h >> 13)


def _assert_k4_equal(got, want):
    for g, w in zip(got[0][0], want[0][0]):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got[0][1].cpu(), want[0][1])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    assert bool(got[3]) == bool(want[3])


@pytest.mark.parametrize("name", K4_CASES)
def test_binned_reference_equals_the_tiled_reference(name):
    """The kernel's decomposition — bin by tile, then each tile's chunks in
    order, empty ones skipped — is the reference's chunk-by-chunk insert,
    field for field: table layout, fresh, off and the probe flag."""
    _, c_rows, c_live, table, pl, plan = _k4_cases()[name]
    want = sk.tiled_insert_reference(c_rows, c_live, table, pl, plan)
    got = tiled_insert_binned_reference(c_rows, c_live, table, pl, plan)
    _assert_k4_equal(got, want)
    if name.startswith("probe_limit"):
        assert bool(want[3])
    if "one tile" in name:
        n_tt = sk._tiling(table[1].shape[0], c_live.shape[0], plan)[0]
        counts = tiled_bin_reference(c_rows, c_live, table[1].shape[0],
                                        plan)[1]
        assert int((counts == 0).sum()) == (1 if "no live" in name
                                            else n_tt - 1)


@pytest.mark.parametrize("name", K4_CASES[:5])
def test_plain_k4_matches_interpret_pallas_on_the_new_cases(name):
    _, c_rows, c_live, table, pl, plan = _k4_cases()[name]
    np_rows = tuple(r.numpy() for r in c_rows)
    np_table = (tuple(r.numpy() for r in table[0]), table[1].numpy())
    want = _ref_tiled(np_rows, c_live.numpy(), np_table, pl, plan)
    got = _port_tiled(np_rows, c_live.numpy(), np_table, pl, plan)
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g, w)
    for g, w in zip(got[1:4], want[1:4]):
        assert np.array_equal(g, w)
    assert got[4] == want[4]


def test_k4_bin_shape():
    """A bin block takes R = 256 * kb candidates (kb <= 8, a power of
    two), keeps at most 8,192 (bin, group) counters while it can, and
    divides the chunk, so a chunk spans CH / R bin blocks; a bin is a
    tile up to 4,096 tiles (every capacity up to 2^24) and a group of
    tiles past that, so K4's shared memory does not grow with the number
    of candidates M, and stops growing with the tile count there."""
    assert sk.k4_bin_shape(3, 8192) == (2048, 4)
    assert sk.k4_bin_shape(3, 512) == (512, 1)
    assert sk.k4_bin_shape(0, 128) == (256, 1)
    assert sk.k4_bin_shape(8, 8192) == (1024, 8)
    assert sk.k4_bin_shape(12, 8192) == (256, 32)
    # 8,192 tiles and more: 4,096 bins of 2^(bits - 12) tiles
    assert sk.k4_bin_shape(13, 8192) == (256, 32)
    assert [sk.k4_bins(b) for b in (0, 3, 9, 10, 12, 13, 17)] == \
        [1, 8, 512, 1024, 4096, 4096, 4096]
    for bits, CH in ((3, 8192), (3, 512), (7, 8192), (1, 1024), (8, 16384),
                     (12, 512), (13, 8192), (17, 8192)):
        R, span = sk.k4_bin_shape(bits, CH)
        assert CH % R == 0 and span == CH // R
        assert sk.k4_bins(bits) * R // 32 <= max(8192,
                                                 8 * sk.k4_bins(bits))
    # the fifo-1000 tier's insert fits the H100 with room to spare, and
    # so does the default top tier (N = 2^20: T = 2^21, 256 tiles) at any
    # M: the shared memory has no term in M
    assert sk.k4_smem_bytes(8192, 8192, 8) == \
        4 * 8192 + 10 * 8192 + 8 * 5 <= sk.HOPPER_SMEM_OPTIN
    assert sk.k4_smem_bytes(8192, 8192, 256) == \
        4 * 8192 + 10 * 8192 + 8 * 9 <= sk.HOPPER_SMEM_OPTIN
    for N, C in ((1 << 20, 15), (1 << 20, 64), (1 << 19, 58)):
        assert sk.tiled_plan(N, C) == {"tile": 8192, "chunk": 8192}


def test_tiled_plan_at_every_capacity():
    """K4 has a plan within the H100's opt-in at every frontier capacity
    N (a power of two) with N * C < 2^31, the int32 candidate index's
    range, from N = 256 (T = 512, one tile of the least size; below it
    K2's gate takes every C). Up to N = 2^24 the plan is what it was
    before the bin grouped tiles: it decides where rows probe, so every
    result stays as it was."""
    before = {256: (512, 16384), 512: (1024, 16384), 1024: (2048, 16384),
              2048: (4096, 8192)}
    assert sk.supported(128, sk.MAX_C)
    for C in (2, 8, 12, 24):
        N = 256
        while N * C < 1 << 31:
            p = sk.tiled_plan(N, C)
            T = 1 << (2 * N - 1).bit_length()
            assert p is not None, (N, C)
            assert sk.k4_smem_bytes(p["tile"], p["chunk"], T // p["tile"]) \
                <= sk.HOPPER_SMEM_OPTIN, (N, C)
            if N <= 1 << 24:
                assert (p["tile"], p["chunk"]) == \
                    before.get(N, (8192, 8192)), (N, C)
            N *= 2


def test_route_is_tiled_past_capacity_2_24():
    """Past N = 2^24 (8,192 tiles and more) the hash route still has a
    plan: the bin groups tiles, so its counters stay in shared memory."""
    cpu = torch.device("cpu")
    big = {"tile": 8192, "chunk": 8192}
    assert sparse._route(1 << 24, 2, "hash", cpu) == ("tiled", big)
    assert sparse._route(1 << 25, 2, "hash", cpu) == ("tiled", big)
    assert sparse._route(1 << 26, 24, "hash", cpu) == ("tiled", big)
    assert sparse._route(1 << 29, 2, "hash", cpu) == ("tiled", big)


def tiled_group_bin_reference(c_rows, c_live, T: int, plan: dict,
                              bin_bits: int) -> list:
    """K4's bin past 2^12 tiles as plain ops, with `bin_bits` in place
    of 12: the live candidates sorted stably by bin (tile >> gshift), then
    each tile's candidates taken from its bin's list in list order.
    -> one int64 index list per tile."""
    M = c_live.shape[0]
    n_tt, _, tt_bits, _ = sk._tiling(T, M, plan)
    gshift = max(0, tt_bits - bin_bits)
    h = sparse.table_hash_u32(*(sparse._u32(r) for r in c_rows))
    tile = h & (n_tt - 1)
    live = torch.nonzero(c_live).flatten()
    order = live[torch.sort(tile[live] >> gshift, stable=True).indices]
    return [order[tile[order] == t] for t in range(n_tt)]


@pytest.mark.parametrize("name", K4_CASES)
def test_grouped_bin_gives_each_tile_its_candidates_in_order(name):
    """A bin of a group of tiles, filtered by tile, is the tile's list of
    the bin by tile: every live candidate of the tile, in index order.
    So K4 past 4,096 tiles walks what it walks below."""
    _, c_rows, c_live, table, _, plan = _k4_cases()[name]
    T = table[1].shape[0]
    order, counts, offsets = tiled_bin_reference(c_rows, c_live, T, plan)
    n_tt = counts.shape[0]
    for bin_bits in range(max(1, n_tt.bit_length() - 1)):
        got = tiled_group_bin_reference(c_rows, c_live, T, plan, bin_bits)
        for t in range(n_tt):
            o, n = int(offsets[t]), int(counts[t])
            assert torch.equal(got[t], order[o:o + n]), (bin_bits, t)


def test_k2_cases_reach_their_shapes():
    """On the plain closure: the C=33 writes overflow the frontier, and
    at probe_limit 2 its probes; the C=64 cases close without overflow
    after passes of more than 1,024 candidates; the small-pass case
    never has more than 32 candidates in a pass."""
    got = {}
    for name, step_name, ev, rows, live, run, pl in _k2_cases().values():
        got[name] = sk.frontier_closure(step_name, ev, rows, live, run,
                                        pl)[1].tolist()
    assert got["register N2048 C33 overflow pl32"][:2] == [2048, 1]
    assert got["register N2048 C33 overflow pl2"][1] == 1
    count, ovf, iters, stepped = got["register N1024 C64 pl32"]
    assert (count, ovf) == (648, 0) and stepped * 64 > 1024 * iters
    assert got["gset N1024 C64"][1] == 0
    count, ovf, iters, stepped = got["uqueue N1024 C8 small passes"]
    assert ovf == 0 and count * 8 <= 32 * iters


def _dev_tiled(dev, c_rows, c_live, table):
    return (tuple(r.to(dev) for r in c_rows), c_live.to(dev),
            (tuple(r.to(dev) for r in table[0]), table[1].to(dev)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", K4_CASES)
def test_cuda_k4_matches_plain_on_the_new_cases(name):
    dev = _cuda()
    _, c_rows, c_live, table, pl, plan = _k4_cases()[name]
    want = sk.tiled_insert_reference(c_rows, c_live, table, pl, plan)
    before = sk.launches["tiled_insert"]
    got = sk.tiled_insert(*_dev_tiled(dev, c_rows, c_live, table), pl, plan)
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert"] == before + 1
    _assert_k4_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", K4_CASES[:3])
def test_cuda_k4_bin_and_insert_apart_equal_both(name):
    """The bin and the insert launched one at a time (as the timings do)
    give what one call gives; the insert updates the table in place."""
    dev = _cuda()
    _, c_rows, c_live, table, pl, plan = _k4_cases()[name]
    want = sk.tiled_insert_reference(c_rows, c_live, table, pl, plan)
    rows, live, dtable = _dev_tiled(dev, c_rows, c_live, table)
    work = sk._tiled_insert_launch(rows, live, dtable, pl, plan,
                                   stages=1)[-1]
    got = sk._tiled_insert_launch(rows, live, dtable, pl, plan, stages=2,
                                  work=work)
    torch.cuda.synchronize()
    _assert_k4_equal(got[:4], want)
    assert got[0][1].data_ptr() == dtable[1].data_ptr()
    assert torch.equal(dtable[1].cpu(), want[0][1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", K2_CASES)
def test_cuda_k2_matches_plain_on_the_new_cases(name):
    dev = _cuda()
    _, step_name, ev, rows, live, run, pl = _k2_cases()[name]
    w_rows, w_meta = sk.frontier_closure(step_name, ev, rows, live, run, pl)
    before = sk.launches["frontier_closure"]
    g_rows, g_meta = sk.frontier_closure(
        step_name, {k: v.to(dev) for k, v in ev.items()},
        tuple(r.to(dev) for r in rows), live.to(dev), run.to(dev), pl)
    torch.cuda.synchronize()
    assert sk.launches["frontier_closure"] == before + 1
    assert g_meta.cpu().tolist() == w_meta.tolist()
    for g, w in zip(g_rows, w_rows):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", K2_CASES)
def test_plain_k2_matches_interpret_pallas_on_the_new_cases(name):
    _, step_name, ev, rows, live, run, pl = _k2_cases()[name]
    rows2, meta = sk.frontier_closure(step_name, ev, rows, live, run, pl)
    _assert_closure_equal((step_name, ev, rows, live, run, (rows2, meta)),
                          pl)


@pytest.mark.cuda
def test_cuda_k4_matches_plain_on_8192_tiles():
    """K4 at frontier capacity 2^25's table (8,192 tiles of 8,192; a bin
    is a group of 2 tiles) equals its plain version, bit for bit."""
    dev = _cuda()
    _, c_rows, c_live, table, pl, plan = parity_cases.k4_wide_case(8192)
    rows, live, dtable = _dev_tiled(dev, c_rows, c_live, table)
    want = sk.tiled_insert_reference(rows, live, dtable, pl, plan)
    before = sk.launches["tiled_insert"]
    got = sk.tiled_insert(rows, live, dtable, pl, plan)
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert"] == before + 1
    _assert_k4_equal(got, tuple(
        x.cpu() if torch.is_tensor(x) else
        (tuple(r.cpu() for r in x[0]), x[1].cpu()) for x in want))
    assert int(want[1].sum()) > 100
