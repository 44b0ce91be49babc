"""Batched K2 and K4 at the edges of their layouts.

On the CPU: the cluster size batched K2 takes from the shape
(`sparse_kernels.k2_cluster_size`), and the edge-case inputs built below
are what their names say. On the card (`cuda`): each batched kernel bit
for bit against its plain version on those inputs; K2 at the cluster
size the wrapper picks and at the others it can take (forced through
`_frontier_closure_launch(..., cluster=)`):

  * batched K4 (`tiled_insert_batch`): K = 1 (the seeded single-key
    cases, probe_limit 1 and 2 among them), K = 2 with a key with no
    live candidate, K = 140 with empty keys and equal rows in two keys,
    hundreds of candidates of one key on one slot, one and two lanes;
    more live candidates than one block takes over (the grid's rounds,
    then the block's) and fewer (the block's alone);
  * batched K2 (`frontier_closure_batch`): K = 1, K = 3 with a key not
    running and a key on part of the rows, K = 140, the seeded cases'
    passes of more than 2,048 candidates (split over the cluster) and
    probe_limit 2, the triple and the packed word at one and two lanes,
    stats off and on.

This file imports no JAX, so the card's run needs none.
"""

import numpy as np
import pytest
import torch

import torch_parity_cases as pc
from jepsen_tpu_torch.parallel import sparse
from jepsen_tpu_torch.parallel import sparse_kernels as sk


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ K4 inputs

def _stack(keys):
    """[(c_rows, c_live, table)] a key -> batched (c_rows, c_live,
    table)."""
    L = len(keys[0][0])
    return (tuple(torch.stack([k[0][j] for k in keys]) for j in range(L)),
            torch.stack([k[1] for k in keys]),
            (tuple(torch.stack([k[2][0][j] for k in keys])
                   for j in range(L)),
             torch.stack([k[2][1] for k in keys])))


def _one_slot_rows(rng, n: int, T: int, slot: int):
    """n rows (with repeats) whose table hash's low bits are `slot`: all
    of them race for one slot of a T-slot table."""
    pool = pc._rand_rows(rng, 400 * T, 400 * T)
    h = sparse._RowLayout().table_hash(pool) & (T - 1)
    on = torch.nonzero(h == slot).flatten()
    pick = on[torch.from_numpy(rng.integers(0, on.numel(), size=n))]
    return tuple(r[pick].contiguous() for r in pool)


def k4_edge_cases() -> dict:
    """name -> (c_rows [K, M], c_live [K, M], table [K, T], probe_limit)."""
    rng = np.random.default_rng(20261101)
    rep = sparse._rep((), 1)
    out = {}
    for name, c_rows, c_live, table, pl in pc.k4_cases():
        out[f"K1 {name}"] = (tuple(r[None] for r in c_rows), c_live[None],
                             (tuple(r[None] for r in table[0]),
                              table[1][None]), pl)
    name, c_rows, c_live, table, pl = pc.k4_batch_cases()[0]
    out["K2 a key with no live candidate"] = (
        tuple(r[:2] for r in c_rows), c_live[:2],
        (tuple(r[:2] for r in table[0]), table[1][:2]), pl)
    # 140 keys of 256 candidates on 512-slot tables: every 7th has none
    # live, odd keys repeat the key before them (equal rows in two keys)
    M, T, keys = 256, 512, []
    for k in range(140):
        if k % 2 and keys:
            keys.append(keys[-1])
            continue
        rows = pc._rand_rows(rng, M, 150)
        live = torch.from_numpy(rng.random(M) < 0.7)
        if k % 7 == 0:
            live[:] = False
        keys.append((rows, live, sparse._empty_table(T, rep)))
    out["K140 empty keys, equal rows in two keys"] = _stack(keys) + (32,)
    # one key's 600 candidates on one slot of 1,024 (repeats among them),
    # a key with none, and the first again at probe_limit 2
    T = 1024
    rows = _one_slot_rows(rng, 600, T, 5)
    rows = tuple(torch.cat([r, r[:424]]) for r in rows)
    live = torch.ones(1024, dtype=torch.bool)
    none = torch.zeros(1024, dtype=torch.bool)
    for pl in (32, 2):
        out[f"K3 600 candidates on one slot, pl{pl}"] = _stack([
            (rows, live, sparse._empty_table(T, rep)),
            (rows, none, sparse._empty_table(T, rep)),
            (rows, live, sparse._empty_table(T, rep))]) + (pl,)
    for name, c_rows, c_live, table, pl in pc.packed_k4_batch_cases():
        out[name] = (c_rows, c_live, table, pl)
    return out


K4_EDGES = k4_edge_cases()


# ------------------------------------------------------------ K2 inputs

def _k2_batch(case, K: int):
    """A seeded K2 case as a batch of K keys on one event row: key 0 the
    case, every third key not running, every other one on the even live
    rows only."""
    name, step_name, ev, rows, live, run, pl, pack = case
    N = live.shape[0]
    xs = {k: v[None, None].expand(K, 1, v.shape[0]).contiguous()
          for k, v in ev.items()}
    half = live & (torch.arange(N) % 2 == 0)
    lives = torch.stack([live if k % 2 == 0 else half for k in range(K)])
    runs = torch.tensor([k % 3 != 1 for k in range(K)]) & run
    return (step_name, xs, 0, tuple(r[None].expand(K, N).contiguous()
                                    for r in rows), lives, runs, pl, pack)


def k2_edge_cases() -> dict:
    """name -> frontier_closure_batch's arguments (step_name, xs, r, rows,
    live, run, probe_limit, pack)."""
    singles = [c[:7] + ((),) for c in pc.k2_cases()] + pc.packed_k2_cases()
    out = {}
    for case in singles:
        out[f"K1 {case[0]}"] = _k2_batch(case, 1)
        out[f"K3 {case[0]}"] = _k2_batch(case, 3)
    small = {c[0]: c for c in singles}["uqueue N1024 C8 small passes"]
    out["K140 uqueue N1024 C8 small passes"] = _k2_batch(small, 140)
    return out


K2_EDGES = k2_edge_cases()


# ------------------------------------------------------------- CPU tests

@pytest.mark.parametrize("K, N, C, most, want", [
    (1, 1024, 15, 8, 1), (2, 512, 8, 8, 1), (26, 512, 15, 8, 8),
    (26, 1024, 15, 8, 8), (19, 2048, 15, 8, 8), (17, 4096, 15, 8, 8),
    (140, 1024, 8, 8, 8), (26, 256, 16, 8, 1), (26, 1024, 2, 8, 1),
    (26, 512, 15, 4, 4)])
def test_k2_cluster_size(K, N, C, most, want):
    """Batched K2 takes the card's largest cluster where its passes can
    outgrow the split threshold (N * C > 4,096 candidates); one key, and
    shapes whose passes do not, keep one block."""
    assert sk.k2_cluster_size(K, N, C, most) == want


def test_edge_cases_are_what_they_say():
    rep = sparse._RowLayout()
    c_rows, c_live, table, _ = K4_EDGES["K3 600 candidates on one slot, pl32"]
    h = rep.table_hash(tuple(r[0] for r in c_rows)) & 1023
    assert bool((h == 5).all()) and not c_live[1].any()
    c_rows, c_live, _, _ = K4_EDGES["K140 empty keys, equal rows in two keys"]
    assert c_live.shape[0] == 140 > 132 and not c_live[0].any()
    assert all(torch.equal(r[2], r[3]) for r in c_rows)
    step_name, xs, r, rows, live, run, pl, pack = \
        K2_EDGES["K3 register N1024 C64 pl32"]
    assert run.tolist() == [True, False, True]
    # a pass past 2,048 candidates: the split path runs
    ev = {k: v[0, 0] for k, v in xs.items()}
    widths = []
    N = live.shape[1]
    rep2 = sparse._rep(pack, xs["slot_f"].shape[2])

    def insert(c_rows, c_live, f_rows, count, table):
        widths.append(int(count))
        return sparse._hash_insert_append(c_rows, c_live, f_rows, count,
                                          table, pl, N, rep2)
    sparse._hash_event_closure(rep2, sparse.STEPS[step_name], ev,
                               tuple(x[0] for x in rows), live[0], run[0],
                               N, sparse._next_pow2(2 * N), pl,
                               insert=insert)
    C = xs["slot_f"].shape[2]
    assert max((b - a) * C for a, b in zip(widths[1:], widths[2:])) > 2048


@pytest.mark.parametrize("case", sorted(K4_EDGES))
def test_plain_batched_k4_is_the_single_keys_on_the_edges(case):
    """The plain versions the card tests hold the kernel to agree key by
    key on every edge case."""
    c_rows, c_live, table, pl = K4_EDGES[case]
    got = sk.tiled_insert_batch(c_rows, c_live, table, pl)
    for k in range(0, c_live.shape[0], max(1, c_live.shape[0] // 8)):
        want = sk.tiled_insert(tuple(x[k] for x in c_rows), c_live[k],
                               (tuple(x[k] for x in table[0]),
                                table[1][k]), pl)
        assert torch.equal(got[1][k], want[1])
        assert torch.equal(got[2][k], want[2])
        assert bool(got[3][k]) == bool(want[3])


# ------------------------------------------------------------ card tests

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def _fresh_table(table):
    return (tuple(r.clone() for r in table[0]), table[1].clone())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K4_EDGES))
def test_cuda_batched_k4_on_the_edges(case):
    """Batched K4 bit for bit against its plain version, twice on fresh
    copies of the table (the claim words of the second launch are the
    first's scratch, freed by their winners)."""
    dev = _cuda()
    c_rows, c_live, table, pl = _to(K4_EDGES[case], dev)
    want = sk.tiled_insert_batch_reference(c_rows, c_live, table, pl)
    n0 = sk.launches["tiled_insert_batch"]
    runs = [sk.tiled_insert_batch(c_rows, c_live, _fresh_table(table), pl)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert_batch"] == n0 + 2
    for got in runs:
        for g, w in zip(got[0][0], want[0][0]):
            assert torch.equal(g, w)
        for g, w in zip((got[0][1],) + tuple(got[1:]),
                        (want[0][1],) + tuple(want[1:])):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("case", sorted(K2_EDGES))
def test_cuda_batched_k2_on_the_edges(case, stats):
    """Batched K2 (stats off and on) bit for bit against its plain
    version, at the cluster the wrapper picks and at 1, 2, 4 and 8
    blocks a key (passes of more than 2,048 candidates split over
    them)."""
    dev = _cuda()
    step_name, xs, r, rows, live, run, pl, pack = _to(K2_EDGES[case], dev)
    want = sk.frontier_closure_batch_reference(step_name, xs, r, rows, live,
                                               run, pl, pack, stats)
    n0 = sk.launches["frontier_closure_batch_stats" if stats
                     else "frontier_closure_batch"]
    runs = [sk.frontier_closure_batch(step_name, xs, r, rows, live, run, pl,
                                      pack, stats)]
    for c in (1, 2, 4, 8):
        runs.append(sk._frontier_closure_launch(
            step_name, xs, r, xs["slot_f"].shape[1], rows, live, run, pl,
            pack, stats, cluster=c))
    torch.cuda.synchronize()
    assert sk.launches["frontier_closure_batch_stats" if stats
                       else "frontier_closure_batch"] == n0 + 1
    for got in runs:
        for g, w in zip(got[0], want[0]):
            assert torch.equal(g, w)
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w)
