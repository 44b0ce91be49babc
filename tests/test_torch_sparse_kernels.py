"""The sparse engine's kernels K2 and K4 (jepsen_tpu_torch.parallel.
sparse_kernels): their plain versions against the reference's Pallas
kernels run in interpret mode (`jepsen_tpu.parallel.sparse_kernels.
frontier_closure_call`, and `tiled_insert_call` on one tile and one
chunk: the whole table, as K4 runs it), bit for bit — rows in order,
counts, flags, table layout and probe offsets — on closure inputs
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
from torch_jax_cache import release_compiled_programs  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compilation_cache():
    """The reference's interpret-mode Pallas calls compile here without
    JAX's persistent compilation cache: the suite's workers share one
    cache directory, and a worker died inside its read. JAX decides once
    a process whether it uses the cache, so its decision is reset both
    ways; the old setting comes back after this file."""
    from jax.experimental.compilation_cache import compilation_cache as cc
    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", old)
    cc.reset_cache()


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


def _whole(T: int, M: int) -> dict:
    """The reference kernel's plan of one tile and one chunk: the whole
    table of T slots and all M candidates, K4's transaction."""
    return {"tile": T, "chunk": 1 << max(0, (M - 1).bit_length())}


def _port_tiled(c_rows, c_live, table, probe_limit):
    (t_rows, t_occ) = table
    (tr, tocc), fresh, off, pend = sk.tiled_insert(
        tuple(torch.from_numpy(r) for r in c_rows), torch.from_numpy(c_live),
        (tuple(torch.from_numpy(r) for r in t_rows),
         torch.from_numpy(t_occ)), probe_limit)
    return ([r.numpy() for r in tr], tocc.numpy(), fresh.numpy(),
            off.numpy(), bool(pend))


@pytest.mark.parametrize("probe_limit", [32, 2])
def test_plain_k4_matches_interpret_pallas(probe_limit):
    """Two transactions in a row on a 2048-slot table, 1,536 candidates
    with duplicates among them and against the table; the reference's
    kernel on one tile and one chunk."""
    rng = np.random.default_rng(7)
    T, M = 2048, 1536
    plan = _whole(T, M)
    table = (tuple(np.zeros(T, np.int32) for _ in range(3)),
             np.zeros(T, bool))
    sk.reset_launches()
    for _ in range(2):
        c_rows = _rand_rows(rng, M, 700)
        c_live = rng.random(M) < 0.8
        want = _ref_tiled(c_rows, c_live, table, probe_limit, plan)
        got = _port_tiled(c_rows, c_live, table, probe_limit)
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
    """K4's plain version is the whole table's `_hash_insert`."""
    rng = np.random.default_rng(3)
    c_rows = tuple(torch.from_numpy(r) for r in _rand_rows(rng, 300, 120))
    c_live = torch.from_numpy(rng.random(300) < 0.9)
    rep = sparse._rep((), 4)
    table = sparse._empty_table(1024, rep)
    a = sparse._hash_insert(c_rows, c_live, table, 32, rep)
    b = sk.tiled_insert(c_rows, c_live, table, 32)
    for x, y in zip(a[0][0], b[0][0]):
        assert torch.equal(x, y)
    assert torch.equal(a[0][1], b[0][1]) and torch.equal(a[1], b[1])
    assert torch.equal(a[3], b[2]) and bool(a[2]) == bool(b[3])


def test_hopper_gate_arithmetic():
    """K2 keeps 12N + 17T + 2NC + 1056 bytes (T = 2N): N = 1024 fits the
    H100's 232,448-byte opt-in for every C <= 64, N = 2048 up to C = 33,
    N = 4096 up to C = 5. Off the card the budget is that opt-in."""
    assert sk.HOPPER_SMEM_OPTIN == 232_448
    assert sk.k2_smem_bytes(1024, 8) == 12 * 1024 + 17 * 2048 \
        + 2 * 1024 * 8 + 1056
    assert all(sk.supported(1024, C) for C in range(1, 65))
    assert not sk.supported(1024, 65)
    assert sk.supported(2048, 33) and not sk.supported(2048, 34)
    assert sk.supported(4096, 5) and not sk.supported(4096, 6)
    assert not sk.supported(8192, 1)
    assert sk.smem_budget("cpu") == sk.HOPPER_SMEM_OPTIN


def test_routes_follow_the_gate():
    """The hash closure is fused (K2) while K2's layout fits the budget
    and tiled (K4, the whole table) past it, however small the budget;
    dedupe "sort" takes the sort closure."""
    cpu = torch.device("cpu")
    assert sparse._route(1024, 12, "hash", cpu) == "fused"
    assert sparse._route(4096, 12, "hash", cpu) == "tiled"
    assert sparse._route(512, 8, "hash", cpu, smem_budget=16384) == "tiled"
    assert sparse._route(4096, 12, "sort", cpu) == "sort"
    assert sparse._route(128, 8, "hash", cpu, smem_budget=4000) == "tiled"


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
                        32)


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
    rng = np.random.default_rng(7)
    c_rows = tuple(torch.from_numpy(r) for r in _rand_rows(rng, 1536, 700))
    c_live = torch.from_numpy(rng.random(1536) < 0.8)
    rep = sparse._rep((), 1)
    table = sparse._empty_table(2048, rep)
    want = sk.tiled_insert(c_rows, c_live, table, probe_limit)
    before = sk.launches["tiled_insert"]
    got = sk.tiled_insert(tuple(r.to(dev) for r in c_rows), c_live.to(dev),
                          (tuple(r.to(dev) for r in table[0]),
                           table[1].to(dev)), probe_limit)
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert"] == before + 1
    for g, w in zip(got[0][0], want[0][0]):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got[0][1].cpu(), want[0][1])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    assert bool(got[3]) == bool(want[3])


# ---------------------------------------------------------- the new cases

import torch_parity_cases as parity_cases  # noqa: E402


@functools.lru_cache(maxsize=None)
def _k4_cases():
    return {c[0]: c for c in parity_cases.k4_cases()}


@functools.lru_cache(maxsize=None)
def _k2_cases():
    return {c[0]: c for c in parity_cases.k2_cases()}


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


def _assert_k4_equal(got, want):
    for g, w in zip(got[0][0], want[0][0]):
        assert torch.equal(g.cpu(), w)
    assert torch.equal(got[0][1].cpu(), want[0][1])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    assert bool(got[3]) == bool(want[3])


@pytest.mark.parametrize("name", K4_CASES)
def test_plain_k4_matches_interpret_pallas_on_the_new_cases(name):
    _, c_rows, c_live, table, pl = _k4_cases()[name]
    np_rows = tuple(r.numpy() for r in c_rows)
    np_table = (tuple(r.numpy() for r in table[0]), table[1].numpy())
    want = _ref_tiled(np_rows, c_live.numpy(), np_table, pl,
                      _whole(table[1].shape[0], c_live.shape[0]))
    got = _port_tiled(np_rows, c_live.numpy(), np_table, pl)
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g, w)
    for g, w in zip(got[1:4], want[1:4]):
        assert np.array_equal(g, w)
    assert got[4] == want[4]


def test_route_is_tiled_past_capacity_2_24():
    """Past N = 2^24 the hash route is still the tiled closure over K4's
    whole table; K4 takes up to 2^31 - 2 candidates a launch (its list
    of live candidates is int32), and past that its wrapper raises
    before touching the card."""
    cpu = torch.device("cpu")
    for N, C in ((1 << 24, 2), (1 << 25, 2), (1 << 26, 24), (1 << 29, 2)):
        assert sparse._route(N, C, "hash", cpu) == "tiled"
    M, T = 1 << 31, 1 << 27
    rows = tuple(torch.empty(M, dtype=torch.int32, device="meta")
                 for _ in range(3))
    table = (tuple(torch.empty(T, dtype=torch.int32, device="meta")
                   for _ in range(3)),
             torch.empty(T, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="int32 list"):
        sk.tiled_insert(rows, torch.empty(M, dtype=torch.bool,
                                          device="meta"), table, 32)
    with pytest.raises(ValueError, match="int32 list"):
        sk.tiled_insert_batch(
            tuple(r.reshape(2, M // 2) for r in rows),
            torch.empty((2, M // 2), dtype=torch.bool, device="meta"),
            (tuple(torch.empty((2, T), dtype=torch.int32, device="meta")
                   for _ in range(3)),
             torch.empty((2, T), dtype=torch.bool, device="meta")), 32)


@pytest.mark.parametrize("case", [c[0] for c in
                                  parity_cases.k4_batch_cases()])
def test_plain_batched_k4_matches_interpret_pallas_key_by_key(case):
    """Batched K4's plain version gives each key what the reference's
    kernel gives it on its own candidates and table (one tile, one
    chunk)."""
    _, c_rows, c_live, table, pl = {
        c[0]: c for c in parity_cases.k4_batch_cases()}[case]
    got = sk.tiled_insert_batch(c_rows, c_live, table, pl)
    K, M = c_live.shape
    T = table[1].shape[1]
    for k in range(K):
        want = _ref_tiled(tuple(r[k].numpy() for r in c_rows),
                          c_live[k].numpy(),
                          (tuple(r[k].numpy() for r in table[0]),
                           table[1][k].numpy()), pl, _whole(T, M))
        for g, w in zip(got[0][0], want[0]):
            assert np.array_equal(g[k].numpy(), w)
        assert np.array_equal(got[0][1][k].numpy(), want[1])
        assert np.array_equal(got[1][k].numpy(), want[2])
        assert np.array_equal(got[2][k].numpy(), want[3])
        assert bool(got[3][k]) == want[4]


def test_k4_wide_case_is_past_the_grids_threads():
    """The wide case has more live candidates than the H100's K4 grid has
    threads (132 SMs x 2 blocks of 1,024 at most), so its probe state
    lives in the scratch; its plain insert settles without a probe
    overflow and finds both fresh rows and rows already visited."""
    _, c_rows, c_live, table, pl = parity_cases.k4_wide_case()
    live = int(c_live.sum())
    assert live > 132 * 2 * 1024
    _, fresh, off, ovf = sk.tiled_insert_reference(c_rows, c_live, table,
                                                   pl)
    assert not bool(ovf) and 0 < int(fresh.sum()) < live
    assert int(off.max()) > 0


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
    _, c_rows, c_live, table, pl = _k4_cases()[name]
    want = sk.tiled_insert_reference(c_rows, c_live, table, pl)
    before = sk.launches["tiled_insert"]
    got = sk.tiled_insert(*_dev_tiled(dev, c_rows, c_live, table), pl)
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert"] == before + 1
    _assert_k4_equal(got, want)


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
def test_cuda_k4_matches_plain_past_the_grids_threads():
    """K4 with more live candidates than its grid has threads (their
    probe state in the scratch) equals its plain version, bit for bit."""
    dev = _cuda()
    _, c_rows, c_live, table, pl = parity_cases.k4_wide_case()
    rows, live, dtable = _dev_tiled(dev, c_rows, c_live, table)
    assert int(c_live.sum()) > 1024 * sk.k4_grid(dev)
    want = sk.tiled_insert_reference(rows, live, dtable, pl)
    before = sk.launches["tiled_insert"]
    got = sk.tiled_insert(rows, live, dtable, pl)
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert"] == before + 1
    _assert_k4_equal(got, tuple(
        x.cpu() if torch.is_tensor(x) else
        (tuple(r.cpu() for r in x[0]), x[1].cpu()) for x in want))
    assert int(want[1].sum()) > 100
