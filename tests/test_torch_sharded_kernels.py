"""The sharded engine's parts and kernel K3 (jepsen_tpu_torch.parallel.
sharded, sparse, sparse_kernels) against the reference's, bit for bit:
the owner hash on values >= 2^31, the owned sort-dedupe at 1 and 4 ranks
for every rank index, one owner-routing stage at one rank (the
reference's under shard_map on a one-device mesh — an unstable sort
would reorder the buckets), and K3's plain version against
`engine._hash_insert_append` and against the reference's Pallas kernel
`hash_insert_call` in interpret mode, with duplicates, forced collisions,
probe exhaustion and an append past the frontier. Also K3's layout gate
and the wrapper's CPU contract.

The CUDA kernel runs only on the card: its tests are marked `cuda` and
skip here; chip_smoke.py holds it against the plain version on every
run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu.parallel import sharded as ref_sharded
from jepsen_tpu.parallel import sparse_kernels as ref_sk
from jepsen_tpu_torch.parallel import meshplan, sharded, sparse
from jepsen_tpu_torch.parallel import sparse_kernels as sk
from torch_jax_cache import release_compiled_programs  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(rng, n: int, pool: int):
    """n rows drawn from `pool` distinct random rows (duplicates when n >
    pool), each lane over the whole 32-bit range, as uint32 numpy."""
    base = rng.integers(0, 1 << 32, size=(3, pool), dtype=np.uint64) \
        .astype(np.uint32)
    base[:, :3] = [[0, 0x80000000, 0xFFFFFFFF]] * 3
    pick = rng.integers(0, pool, size=n)
    return tuple(np.ascontiguousarray(base[k][pick]) for k in range(3))


def _port(lanes):
    return tuple(torch.from_numpy(a.view(np.int32).copy()) for a in lanes)


def _ref(lanes):
    # the reference's state lane is int32, its mask lanes uint32
    return (jnp.asarray(lanes[0].view(np.int32)), jnp.asarray(lanes[1]),
            jnp.asarray(lanes[2]))


def _np32(lanes):
    return [np.asarray(a).view(np.int32) for a in lanes]


def test_owner_hash_matches_reference():
    rng = np.random.default_rng(11)
    lanes = _lanes(rng, 4096, 4096)
    want = np.asarray(ref_engine._UnpackedRep(8).owner_hash(_ref(lanes)))
    got = sparse._UnpackedRep(8).owner_hash(_port(lanes))
    assert (np.stack(lanes) >= 1 << 31).any()
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    # a different mix from the table hash
    assert not np.array_equal(
        got.numpy(), sparse._UnpackedRep(8).table_hash(_port(lanes)).numpy())


@pytest.mark.parametrize("n_dev", [1, 4])
def test_owned_dedupe_compact_matches_reference(n_dev):
    """Every rank's owned, deduplicated, compacted rows, row for row;
    Nd=24 is short of a rank's distinct rows at one rank, so there the
    tail drops and overflow is set."""
    rng = np.random.default_rng(12)
    lanes = _lanes(rng, 300, 60)
    live = rng.random(300) < 0.7
    for my_idx in range(n_dev):
        want = ref_sharded._owned_dedupe_compact(
            _ref(lanes), jnp.asarray(live), 24, n_dev, jnp.uint32(my_idx),
            ref_engine._UnpackedRep(4))
        got = sharded._owned_dedupe_compact(
            _port(lanes), torch.from_numpy(live), 24, n_dev, my_idx,
            sparse._UnpackedRep(4))
        for g, w in zip(got[0], _np32(want[0])):
            assert np.array_equal(g.numpy(), w)
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[2]) == int(want[2])
        assert bool(got[3]) == bool(want[3])


@functools.lru_cache(maxsize=None)
def _ref_route(B: int):
    mesh = Mesh(np.array(jax.devices()[:1]), ("frontier",))

    def stage(st, ml, mh, live, dest):
        return ref_sharded._route_stage((st, ml, mh), live, dest, 1, B,
                                        "frontier")
    return jax.jit(ref_sharded._shard_map(
        stage, mesh, in_specs=(P(),) * 5,
        out_specs=((P(), P(), P()), P(), P())))


@pytest.mark.parametrize("B", [512, 160])
def test_route_stage_matches_reference_at_one_rank(B):
    """300 rows, ~200 live, into one bucket of B: at B=512 the live rows
    arrive in their original order, dead ones after; at B=160 the bucket
    cuts them and raises the overflow flag."""
    rng = np.random.default_rng(13)
    lanes = _lanes(rng, 300, 300)
    live = rng.random(300) < 0.67
    dest = np.zeros(300, np.uint32)
    w_rows, w_live, w_ovf = _ref_route(B)(*_ref(lanes), jnp.asarray(live),
                                          jnp.asarray(dest))
    group = meshplan.local_mesh("cpu").get_group()
    g_rows, g_live, g_ovf = sharded._route_stage(
        _port(lanes), torch.from_numpy(live), torch.from_numpy(
            dest.astype(np.int64)), 1, B, group)
    for g, w in zip(g_rows, _np32(w_rows)):
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(g_live.numpy(), np.asarray(w_live))
    assert bool(g_ovf) == bool(w_ovf) == (B == 160)
    # the live rows, in their original order, first
    k = int(live.sum()) if B == 512 else B
    assert np.array_equal(g_rows[0][:k].numpy(),
                          lanes[0].view(np.int32)[live][:k])


def _insert_case(rng, M, pool, T, N, count, prefill):
    """Candidates (duplicates inside), a frontier with `count` rows in
    use, and a table of T slots already holding `prefill` of the pool's
    rows (so some candidates find themselves, some collide)."""
    c = _lanes(rng, M, pool)
    live = rng.random(M) < 0.75
    f = _lanes(rng, N, N)
    t_rows = [np.zeros(T, np.uint32) for _ in range(3)]
    t_occ = np.zeros(T, bool)
    ref_rep = ref_engine._UnpackedRep(1)
    if prefill:
        (tr, tocc), _, _, _ = ref_engine._hash_insert(
            _ref(tuple(a[:prefill] for a in c)), jnp.ones(prefill, bool),
            (_ref(tuple(t_rows)), jnp.asarray(t_occ)), 32, ref_rep)
        t_rows = [np.asarray(a).astype(np.uint32) for a in tr]
        t_occ = np.array(tocc)
    return c, live, f, count, (tuple(t_rows), t_occ)


CASES = {
    # (M, pool, T, N, count, prefill, probe_limit)
    "roomy": (400, 150, 512, 256, 20, 30, 32),
    "crowded-table": (300, 200, 256, 256, 0, 100, 32),
    "probe-exhaustion": (300, 200, 256, 256, 0, 100, 2),
    "append-past-N": (400, 300, 1024, 160, 100, 0, 32),
}


def _args(name):
    M, pool, T, N, count, prefill, pl = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return _insert_case(rng, M, pool, T, N, count, prefill), N, pl


def _port_insert(case, N, pl, fn=None):
    c, live, f, count, (t_rows, t_occ) = case
    fn = fn or sk.hash_insert
    return fn(_port(c), torch.from_numpy(live), _port(f),
              torch.tensor(count, dtype=torch.int32),
              (_port(t_rows), torch.from_numpy(t_occ)), pl, N)


def _assert_insert_equal(got, want):
    rows2, (t_rows, t_occ), count2, n_fresh, ovf = got
    w_rows2, (w_trows, w_tocc), w_count2, w_fresh, w_ovf = want
    for g, w in zip(rows2, _np32(w_rows2)):
        assert np.array_equal(g.numpy(), w)
    for g, w in zip(t_rows, _np32(w_trows)):
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(t_occ.numpy(), np.asarray(w_tocc))
    assert (int(count2), int(n_fresh), bool(ovf)) == \
        (int(w_count2), int(w_fresh), bool(w_ovf))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_k3_matches_reference_insert(name):
    (c, live, f, count, (t_rows, t_occ)), N, pl = _args(name)
    want = ref_engine._hash_insert_append(
        _ref(c), jnp.asarray(live), _ref(f), jnp.int32(count),
        (_ref(t_rows), jnp.asarray(t_occ)), pl, N,
        ref_engine._UnpackedRep(1))
    got = _port_insert((c, live, f, count, (t_rows, t_occ)), N, pl)
    _assert_insert_equal(got, want)
    if name == "probe-exhaustion":
        assert bool(got[4]) and int(got[2]) < N
    if name == "append-past-N":
        assert bool(got[4]) and int(got[2]) == N


@pytest.mark.parametrize("name", ["crowded-table", "probe-exhaustion"])
def test_plain_k3_matches_interpret_pallas(name):
    """The reference's K3 (hash_insert_call) in interpret mode."""
    (c, live, f, count, (t_rows, t_occ)), N, pl = _args(name)
    want = jax.jit(functools.partial(
        ref_sk.hash_insert_call, probe_limit=pl, N=N, C=1,
        interpret=True))(_ref(c), jnp.asarray(live), _ref(f),
                         jnp.int32(count), (_ref(t_rows), jnp.asarray(t_occ)))
    got = _port_insert((c, live, f, count, (t_rows, t_occ)), N, pl)
    _assert_insert_equal(got, want)


def test_k3_layout_gate():
    """The table goes to shared memory while 17 T + 160 bytes fit the
    opt-in: up to Nd = 4,096 (T = 8,192) on Hopper."""
    assert sk.k3_smem_bytes(4096) == 17 * 8192 + 160
    assert sk.k3_layout(4096) == sk.k3_layout(4096, "cpu") == "shared"
    assert sk.k3_layout(4097) == "device"
    assert sk.k3_layout(1 << 17) == "device"
    assert sk.k3_layout(1) == "shared"


@pytest.mark.parametrize("per_sm,n_sm,want", [
    (1, 132, 132),     # H100, one 1,024-thread block resident per SM
    (2, 132, 264),
    (1, 114, 114),     # H100 PCIe
    (8, 132, 1024),    # capped: the scratch keeps a count per block
])
def test_k3_grid_blocks(per_sm, n_sm, want):
    """K3's cooperative grid: every block the card keeps resident."""
    assert sk.k3_grid_blocks(per_sm, n_sm) == want <= sk.K3_MAX_GRID


@pytest.mark.parametrize("per_sm,n_sm", [(0, 132), (1, 0)])
def test_k3_grid_blocks_refuses_a_card_that_keeps_none(per_sm, n_sm):
    with pytest.raises(RuntimeError, match="cooperative launch"):
        sk.k3_grid_blocks(per_sm, n_sm)


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    sk.reset_launches()
    got = _port_insert(_args("roomy")[0], 256, 32)
    want = _port_insert(_args("roomy")[0], 256, 32,
                        fn=sk.hash_insert_reference)
    assert sk.launches["hash_insert"] == 0
    assert sk.hash_insert_launches == {"shared": 0, "device": 0}
    for a, b in zip(got[0] + got[1][0] + (got[1][1],),
                    want[0] + want[1][0] + (want[1][1],)):
        assert torch.equal(a, b)


def test_wrapper_checks_its_arguments():
    case = _args("roomy")[0]
    with pytest.raises(ValueError, match="probe_limit"):
        _port_insert(case, 256, 0)
    c, live, f, count, (t_rows, t_occ) = case
    with pytest.raises(ValueError, match="power of two"):
        _port_insert((c, live, f, count, (tuple(a[:300] for a in t_rows),
                                          t_occ[:300])), 256, 32)
    with pytest.raises(ValueError, match="three int32 lanes"):
        _port_insert(case, 255, 32)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("T", [None, 1 << 14])
def test_cuda_k3_matches_plain(name, T):
    """Both layouts: the case's own table (shared memory) and one of
    16,384 slots (device memory)."""
    dev = _cuda()
    M, pool, T0, N, count, prefill, pl = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    case = _insert_case(rng, M, pool, T or T0, N, count, prefill)
    want = _port_insert(case, N, pl)
    c, live, f, count, (t_rows, t_occ) = case
    sk.reset_launches()
    got = sk.hash_insert(
        tuple(r.to(dev) for r in _port(c)), torch.from_numpy(live).to(dev),
        tuple(r.to(dev) for r in _port(f)),
        torch.tensor(count, dtype=torch.int32, device=dev),
        (tuple(r.to(dev) for r in _port(t_rows)),
         torch.from_numpy(t_occ).to(dev)), pl, N)
    torch.cuda.synchronize()
    layout = "shared" if T is None else "device"
    assert sk.launches["hash_insert"] == 1
    assert sk.k3_layout((T or T0) // 2, dev) == layout
    assert sk.hash_insert_launches == {"shared": 0, "device": 0,
                                       layout: 1}
    for g, w in zip(got[0] + got[1][0] + (got[1][1],),
                    want[0] + want[1][0] + (want[1][1],)):
        assert torch.equal(g.cpu(), w)
    assert (int(got[2]), int(got[3]), bool(got[4])) == \
        (int(want[2]), int(want[3]), bool(want[4]))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["registers", "scratch"])
@pytest.mark.parametrize("past_n", [False, True])
def test_cuda_k3_grid_matches_plain_over_many_blocks(path, past_n):
    """The grid insert at the sharded check's width: hundreds of
    thousands of candidates, most live and many repeated, into a table of
    2^19 slots already holding 20,000 rows, so every block of the grid
    claims, loses and appends (a fifth of the table full at the end).
    The live count sits below the grid's
    threads (each thread keeps its candidate in registers) or above them
    (the candidates' state lives in the scratch); with past_n the append
    passes N and raises the overflow."""
    dev = _cuda()
    threads = sk.k3_grid(dev) * 1024
    M = threads // 2 if path == "registers" else threads * 3 // 2
    rng = np.random.default_rng(M + past_n)
    pool, T, N = M // 4, 1 << 19, 1 << 18
    c = _lanes(rng, M, pool)
    live = rng.random(M) < 0.8
    f = _lanes(rng, N, N)
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    table = (tuple(d(np.zeros(T, np.int32)) for _ in range(3)),
             d(np.zeros(T, bool)))
    frontier = tuple(d(a.view(np.int32)) for a in f)
    _, table, _, _, _ = sk.hash_insert_reference(
        tuple(d(a[:20_000].view(np.int32)) for a in c),
        torch.ones(20_000, dtype=torch.bool, device=dev), frontier,
        torch.tensor(0, dtype=torch.int32, device=dev), table, 32, N)
    count = N - 1000 if past_n else 1000
    args = (tuple(d(a.view(np.int32)) for a in c), d(live), frontier,
            torch.tensor(count, dtype=torch.int32, device=dev), table, 32,
            N)
    assert sk.k3_layout(T // 2, dev) == "device"
    assert (int(live.sum()) <= threads) == (path == "registers")
    sk.reset_launches()
    got = sk.hash_insert(*args)
    want = sk.hash_insert_reference(*args)
    torch.cuda.synchronize()
    assert sk.hash_insert_launches == {"shared": 0, "device": 1}
    for g, w in zip(got[0] + got[1][0] + (got[1][1],),
                    want[0] + want[1][0] + (want[1][1],)):
        assert torch.equal(g, w)
    assert (int(got[2]), int(got[3]), bool(got[4])) == \
        (int(want[2]), int(want[3]), bool(want[4]))
    assert int(want[3]) > 1000
    assert bool(want[4]) == past_n
