"""The batched closures of the port's sparse per-key batch, key by key,
on the CPU: batched K2's plain version (`frontier_closure_batch`) against
the single key's (`frontier_closure`), the tiled closure over batched K4
(`tiled_event_closure_batch`: a key whose closure ended stays frozen)
against the single key's, the batched sort closure and sort dedupe
against theirs, and batched K4's plain version (`tiled_insert_batch`)
against `tiled_insert`, on the rows the sparse batch itself hands them
(the reference's escalation keys, recorded with
`torch_parity_cases.record_calls`) and on the seeded `k4_batch_cases`.
Plain-ops models of the orders the kernels run a transaction in, each
held against the plain versions on the seeded cases: the grid
transaction over K tables (K3's device layout), K4's (the grid's
rounds, then one block's with the rounds skipped while every candidate
left walks past occupied slots) and batched K2's split passes (a pass
over a cluster's blocks, the append's places from the cluster's
prefix).
On the card only (`cuda`): batched K2 and K4 bit for bit against their
plain versions, and the batch on the card against the batch on the
CPU (more card cases in `test_torch_sparse_batch_cuda.py`)."""

import dataclasses

import numpy as np
import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import engine, sparse
from jepsen_tpu_torch.parallel import sparse_kernels as sk

import torch_parity_cases as cases

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(e):
    arrays = {k: getattr(e, k) for k in enc.ARRAY_FIELDS}
    calls = [dataclasses.asdict(c) for c in e.calls]
    meta = {k: getattr(e, k) for k in ("state0", "step_name", "n_calls",
                                       "n_slots", "state_lo", "n_states",
                                       "model_pruned")}
    meta["intern"] = list(e.intern._values)
    return enc.encoded_from_arrays(arrays, calls, meta)


def _strip(rs):
    return [{k: v for k, v in r.items() if k != "closure"} for r in rs]


def _port_fifo_keys(seeds=(5, 1, 3, 4)):
    """The reference's escalation shapes (test_torch_sparse_batch.py):
    C 6, 8, 12 and 11; 30, 31, 30 and 28 return events."""
    return [_to_port(ref_enc.encode(
        ref_models.FIFOQueue(), ref_histories.rand_fifo_history(
            n_ops=40, n_processes=6, n_values=3, crash_p=0.15, seed=s)))
        for s in seeds]


@pytest.fixture(scope="module")
def k2_batch_inputs():
    """The batched K2 calls of the first two escalation keys' batch at
    capacity 512 (C = 8, R = 31) on the CPU, at rows 0, 15, 30 (the
    first past key 0's last event, and the last)."""
    encs = _port_fifo_keys((5, 1))
    R = max(e.n_returns for e in encs)
    picks = {0, R // 2, min(e.n_returns for e in encs), R - 1}
    kept = cases.record_calls(
        "frontier_closure_batch",
        lambda: sparse.check_batch_sparse(encs, 512, 512, dedupe="hash",
                                          device=CPU,
                                          escalate=lambda e, n: None),
        keep=lambda a: a[2] in picks)
    assert [a[2] for a in kept] == sorted(picks)
    return kept


def test_batched_k2_plain_version_is_the_single_keys(k2_batch_inputs):
    """`frontier_closure_batch` on CPU tensors: each key's rows and meta
    are `frontier_closure`'s on that key's event; a key that does not run
    gets zero rows and zero meta."""
    idle = 0
    for step_name, xs, r, rows, live, run, pl in k2_batch_inputs:
        got = sk.frontier_closure_batch(step_name, xs, r, rows, live, run,
                                        pl)
        for k in range(live.shape[0]):
            ev = {n: xs[n][k, r] for n in sk.SLOT_TABLES}
            want = sk.frontier_closure(step_name, ev,
                                       tuple(x[k] for x in rows), live[k],
                                       run[k], pl)
            for g, w in zip(got[0], want[0]):
                assert torch.equal(g[k], w)
            assert torch.equal(got[1][k], want[1])
            if not bool(run[k]):
                idle += 1
                assert not got[1][k].any()
                assert not any(g[k].any() for g in got[0])
    assert idle > 0


def test_batched_tiled_closure_freezes_each_key(k2_batch_inputs):
    """The tiled closure of a row for all keys at once equals each key's
    own tiled closure; keys whose closures take fewer iterations than
    the row's longest stay as they ended (iterations, rows, table),
    and a key that does not run gets zero rows and meta."""
    iters_seen = set()
    for step_name, xs, r, rows, live, run, pl in k2_batch_inputs:
        K, N = live.shape
        C = xs["slot_f"].shape[2]
        rep = sparse._rep((), C)
        step = sparse.STEPS[step_name]
        T = sparse._next_pow2(2 * N)
        ev = {n: xs[n][:, r] for n in sk.SLOT_TABLES}
        got = sk.tiled_event_closure_batch(rep, step, ev, rows, live, run,
                                           N, T, pl)
        for k in range(K):
            if not bool(run[k]):
                assert not got[1][k].any()
                continue
            want = sk.tiled_event_closure(
                rep, step, {n: v[k] for n, v in ev.items()},
                tuple(x[k] for x in rows), live[k], run[k], N, T, pl)
            for g, w in zip(got[0], want[0]):
                assert torch.equal(g[k], w)
            assert torch.equal(got[1][k], want[1])
            iters_seen.add((r, int(want[1][2])))
    rows_with = {}
    for r, it in iters_seen:
        rows_with.setdefault(r, set()).add(it)
    assert any(len(v) > 1 for v in rows_with.values())


def test_batched_sort_closure_is_the_single_keys(k2_batch_inputs):
    for step_name, xs, r, rows, live, run, pl in k2_batch_inputs:
        C = xs["slot_f"].shape[2]
        rep = sparse._rep((), C)
        step = sparse.STEPS[step_name]
        ev = {n: xs[n][:, r] for n in sk.SLOT_TABLES}
        N = live.shape[1]
        got = sparse._sort_event_closure_batch(rep, step, ev, rows, live,
                                               run, N)
        for k in range(live.shape[0]):
            want = sparse._sort_event_closure(
                rep, step, {n: v[k] for n, v in ev.items()},
                tuple(x[k] for x in rows), live[k], run[k], N)
            for g, w in zip(got[0], want[0]):
                assert torch.equal(g[k], w)
            assert torch.equal(got[1][k], want[1])
            assert [int(x[k]) for x in got[2:]] == [int(x) for x in want[2:]]


@pytest.mark.parametrize("N", [300, 40])
def test_dedupe_compact_batch_is_the_single_keys(N):
    """Each key sorted and compacted on its own, masks as unsigned; N=40
    is short of some keys' distinct rows (their overflow set)."""
    rng = np.random.default_rng(3)
    K, M = 3, 400
    st = torch.from_numpy(rng.integers(-3, 4, (K, M)).astype(np.int32))
    ml = torch.from_numpy(rng.choice(np.array(
        [0, 1, 0x80000000, 0xFFFFFFFF], np.uint32), (K, M)).view(np.int32))
    mh = torch.from_numpy(rng.choice(np.array(
        [0, 2, 0x90000000], np.uint32), (K, M)).view(np.int32))
    live = torch.from_numpy(rng.random((K, M)) < np.array([[0.7], [0.02],
                                                            [0.0]]))
    rep = sparse._UnpackedRep(4)
    got = sparse._dedupe_compact_batch((st, ml, mh), live, N, rep)
    for k in range(K):
        want = sparse._dedupe_compact((st[k], ml[k], mh[k]), live[k], N, rep)
        for g, w in zip(got[0], want[0]):
            assert torch.equal(g[k], w)
        assert torch.equal(got[1][k], want[1])
        assert int(got[2][k]) == int(want[2])
        assert bool(got[3][k]) == bool(want[3])
    assert bool(got[3][0]) == (N == 40) and not got[3][1:].any()


@pytest.mark.parametrize("case", [c[0] for c in cases.k4_batch_cases()])
def test_batched_k4_plain_version_is_the_single_keys(case):
    """`tiled_insert_batch` on CPU tensors: each key's table, fresh, off
    and probe flag are `tiled_insert`'s on its own candidates and table."""
    name, c_rows, c_live, table, pl = {
        c[0]: c for c in cases.k4_batch_cases()}[case]
    got = sk.tiled_insert_batch(c_rows, c_live, table, pl)
    for k in range(c_live.shape[0]):
        want = sk.tiled_insert(tuple(x[k] for x in c_rows), c_live[k],
                               (tuple(x[k] for x in table[0]),
                                table[1][k]), pl)
        for g, w in zip(got[0][0], want[0][0]):
            assert torch.equal(g[k], w)
        assert torch.equal(got[0][1][k], want[0][1])
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g[k], w)
    # the same candidates on two empty tables; no live candidate: nothing
    # fresh, no overflow; at 2 probes every key with live candidates
    # overflows, at 32 none
    assert torch.equal(got[1][0], got[1][2]) and not got[1][1].any()
    assert got[3].tolist() == ([False, False, False, False] if pl == 32
                               else [True, False, True, True])




@pytest.mark.parametrize("case", [c[0] for c in cases.k4_batch_cases()])
def test_whole_plan_is_the_references_one_table_insert(case):
    """K4 is the reference's transaction, `sparse._hash_insert` over each
    key's whole table: the same table, fresh, off and probe flag."""
    name, c_rows, c_live, table, pl = {
        c[0]: c for c in cases.k4_batch_cases()}[case]
    got = sk.tiled_insert_batch(c_rows, c_live, table, pl)
    rep = sparse._rep((), 1)
    for k in range(c_live.shape[0]):
        want = sparse._hash_insert(
            tuple(x[k] for x in c_rows), c_live[k],
            (tuple(x[k] for x in table[0]), table[1][k]), pl, rep)
        for g, w in zip(got[0][0], want[0][0]):
            assert torch.equal(g[k], w)
        assert torch.equal(got[0][1][k], want[0][1])
        assert torch.equal(got[1][k], want[1])
        assert bool(got[3][k]) == bool(want[2])
        assert torch.equal(got[2][k], want[3])


def grid_insert_model(c_rows, c_live, table, probe_limit: int):
    """The grid transaction's order (sparse_common.cuh's grid_rounds, K3's
    device layout) over K tables as plain ops: every key's
    live candidates in one list, key-major and in index order; probe
    rounds over the K tables laid end to end, listed candidate li of key
    k probing slot k * T + ((h + off) & (T - 1)), a claim race won by the
    lowest list index. -> (table2, fresh [K, M], off [K, M], probe_ovf
    [K]), as `tiled_insert_batch` returns them."""
    t_rows, t_occ = table
    K, M = c_live.shape
    T = t_occ.shape[1]
    listed = torch.nonzero(c_live.reshape(-1)).flatten()
    L = listed.numel()
    key = listed // M
    rows = tuple(r.reshape(-1)[listed] for r in c_rows)
    h = sparse._rep((), 1).table_hash(rows)
    f_rows = tuple(r.reshape(-1).clone() for r in t_rows)
    f_occ = t_occ.reshape(-1).clone()
    li = torch.arange(L)
    pending = torch.ones(L, dtype=torch.bool)
    off = torch.zeros(L, dtype=torch.int32)
    won_any = torch.zeros(L, dtype=torch.bool)
    while bool((pending & (off < probe_limit)).any()):
        act = pending & (off < probe_limit)
        slot = key * T + ((h + off) & (T - 1))
        occ = f_occ[slot]
        same = occ & (f_rows[0][slot] == rows[0]) & \
            (f_rows[1][slot] == rows[1]) & (f_rows[2][slot] == rows[2])
        try_claim = act & ~occ
        claim = torch.full((K * T + 1,), L, dtype=torch.int64)
        claim.scatter_reduce_(0, torch.where(try_claim, slot, K * T), li,
                              "amin")
        won = try_claim & (claim[slot] == li)
        for fr, r in zip(f_rows, rows):
            fr[slot[won]] = r[won]
        f_occ[slot[won]] = True
        pending = pending & ~(act & same) & ~won
        off = off + (act & occ & ~same).to(torch.int32)
        won_any = won_any | won
    fresh = torch.zeros(K * M, dtype=torch.bool)
    fresh[listed] = won_any
    off_all = torch.zeros(K * M, dtype=torch.int32)
    off_all[listed] = off
    pend = torch.zeros(K, dtype=torch.bool)
    pend[key[pending]] = True
    return ((tuple(r.reshape(K, T) for r in f_rows), f_occ.reshape(K, T)),
            fresh.reshape(K, M), off_all.reshape(K, M), pend)


def _k4_as_batches():
    out = {c[0]: c[1:] for c in cases.k4_batch_cases()}
    for name, c_rows, c_live, table, pl in cases.k4_cases():
        out[name] = (tuple(r[None] for r in c_rows), c_live[None],
                     (tuple(r[None] for r in table[0]), table[1][None]), pl)
    return out


@pytest.mark.parametrize("case", [c[0] for c in cases.k4_batch_cases()]
                         + [c[0] for c in cases.k4_cases()])
def test_k4_grid_order_is_each_keys_own_transaction(case):
    """The order the grid transaction runs in over K tables — one list
    of every key's live candidates, claims won by the lowest list index,
    each key on its own table — gives each key what its own transaction
    gives:
    table, fresh, off and probe flag (single keys: the seeded K4 cases
    as K = 1)."""
    c_rows, c_live, table, pl = _k4_as_batches()[case]
    want = sk.tiled_insert_batch_reference(c_rows, c_live, table, pl)
    got = grid_insert_model(c_rows, c_live, table, pl)
    for g, w in zip(got[0][0], want[0][0]):
        assert torch.equal(g, w)
    for g, w in zip((got[0][1],) + got[1:], (want[0][1],) + want[1:]):
        assert torch.equal(g, w)


K4_LOCAL = 1024      # tiled_insert.cu kLocal
K4_WINDOW_MAX = 8    # tiled_insert.cu kWindowMax


def k4_handoff_model(c_rows, c_live, table, probe_limit: int,
                     local: int = K4_LOCAL, rounds=None):
    """K4's order (tiled_insert.cu) as plain ops: every key's live
    candidates in one list, key-major and in index order, a claim won by
    the lowest list index, each key on its own table; round-synchronous
    rounds over every key while more than `local` candidates still probe
    (the grid); then the ones left on a clock that jumps to the earliest
    round one of them is due (one block): a candidate due reads `win`
    slots from its offset (1, doubling each time it walks past all of
    them, at most 8), walks past the occupied ones holding other rows and
    then drops (an equal row), exhausts (probe_limit), claims (an empty
    slot now; a loser is due again next round) or is due again in the
    round it reaches the first slot it has not read. -> (table2, fresh
    [K, M], off [K, M], probe_ovf [K]), as `tiled_insert_batch` returns
    them; `rounds`, a list, gets the grid's rounds and the block's."""
    t_rows, t_occ = table
    K, M = c_live.shape
    T = t_occ.shape[1]
    listed = torch.nonzero(c_live.reshape(-1)).flatten()
    n = listed.numel()
    key = listed // M
    rows = tuple(r.reshape(-1)[listed] for r in c_rows)
    h = sparse._RowLayout().table_hash(rows).to(torch.int64) & 0xFFFFFFFF
    f_rows = tuple(r.reshape(-1).clone() for r in t_rows)
    f_occ = t_occ.reshape(-1).clone()
    li = torch.arange(n)
    off = torch.zeros(n, dtype=torch.int64)
    pend = torch.ones(n, dtype=torch.bool)
    won_any = torch.zeros(n, dtype=torch.bool)

    def claim(try_claim, slot):
        cl = torch.full((K * T + 1,), 1 << 40, dtype=torch.int64)
        cl.scatter_reduce_(0, torch.where(try_claim, slot, K * T), li,
                           "amin")
        won = try_claim & (cl[slot] == li)
        for fr, r in zip(f_rows, rows):
            fr[slot[won]] = r[won]
        f_occ[slot[won]] = True
        return won

    grid = 0
    while int((pend & (off < probe_limit)).sum()) > local:
        grid += 1
        act = pend & (off < probe_limit)
        slot = key * T + ((h + off) & (T - 1))
        occ = f_occ[slot]
        same = occ.clone()
        for fr, r in zip(f_rows, rows):
            same &= fr[slot] == r
        won = claim(act & ~occ, slot)
        pend = pend & ~(act & same) & ~won
        off = off + (act & occ & ~same).to(torch.int64)
        won_any |= won
    wake = torch.full((n,), grid, dtype=torch.int64)
    win = torch.ones(n, dtype=torch.int64)
    js = torch.arange(K4_WINDOW_MAX)
    block = 0
    while True:
        act = pend & (off < probe_limit)
        if not bool(act.any()):
            break
        block += 1
        rnd = int(wake[act].min())
        due = act & (wake == rnd)
        span = torch.minimum(win, probe_limit - off)
        slots = key[:, None] * T + ((h[:, None] + off[:, None] + js[None, :])
                                    & (T - 1))
        in_span = js[None, :] < span[:, None]
        occ = f_occ[slots] & in_span
        same = occ.clone()
        for fr, r in zip(f_rows, rows):
            same &= fr[slots] == r[:, None]
        stop = in_span & (~occ | same)
        j = torch.where(stop.any(1), stop.int().argmax(1), span)
        at_end = j == span
        eq = same.gather(1, torch.clamp(j, max=K4_WINDOW_MAX - 1)[:, None])
        eq = eq[:, 0] & ~at_end
        claim_now = due & ~at_end & ~eq & (j == 0)
        walk_on = due & at_end & (off + j < probe_limit)
        sleep = due & ((~at_end & ~eq & (j > 0)) | walk_on)
        off = torch.where(due, off + j, off)
        pend = pend & ~(due & eq)
        wake = torch.where(sleep, rnd + j, wake)
        win = torch.where(walk_on, torch.clamp(2 * win, max=K4_WINDOW_MAX),
                          win)
        won = claim(claim_now, slots[:, 0])
        pend = pend & ~won
        won_any |= won
        wake = torch.where(claim_now & ~won, rnd + 1, wake)
    if rounds is not None:
        rounds += [grid, block]
    fresh = torch.zeros(K * M, dtype=torch.bool)
    fresh[listed] = won_any
    off_all = torch.zeros(K * M, dtype=torch.int32)
    off_all[listed] = off.to(torch.int32)
    pend_all = torch.zeros(K, dtype=torch.bool)
    pend_all[key[pend]] = True
    return ((tuple(r.reshape(K, T) for r in f_rows), f_occ.reshape(K, T)),
            fresh.reshape(K, M), off_all.reshape(K, M), pend_all)


def _k4_all_batches():
    out = _k4_as_batches()
    for name, c_rows, c_live, table, pl in cases.packed_k4_batch_cases():
        out[name] = (c_rows, c_live, table, pl)
    return out


K4_ALL = _k4_all_batches()


@pytest.mark.parametrize("local", [0, 64, K4_LOCAL])
@pytest.mark.parametrize("case", sorted(K4_ALL))
def test_k4_handoff_order_is_each_keys_own_transaction(case, local):
    """The order K4 runs the transaction in — one list of every key's
    live candidates, claims by list index, grid rounds while more than
    `local` still probe, then rounds skipped while every one left walks
    past occupied slots — gives each key what its own transaction gives:
    table, fresh, off and probe flag, wherever the hand-off falls (0:
    the grid's rounds alone; the kernel's 1,024: most cases in the block
    from the start). Single keys: the seeded K4 cases as K = 1; one and
    two lanes: the packed batch cases."""
    c_rows, c_live, table, pl = K4_ALL[case]
    want = sk.tiled_insert_batch_reference(c_rows, c_live, table, pl)
    got = k4_handoff_model(c_rows, c_live, table, pl, local)
    for g, w in zip(got[0][0], want[0][0]):
        assert torch.equal(g, w)
    for g, w in zip((got[0][1],) + got[1:], (want[0][1],) + want[1:]):
        assert torch.equal(g, w)


def test_k4_block_rounds_skip_the_walks():
    """The skipped rounds are real: on the seeded batch whose fourth key
    fills a table already holding 1,000 rows of 2,048, and on the 40
    live candidates on a half-full table, the block's clock (every
    candidate handed off at once) runs fewer rounds than the
    transaction takes (the grid's rounds alone)."""
    fewer = 0
    for case in ("4 keys, probe_limit 32",
                 "40 live of 50,000 on a half-full table"):
        c_rows, c_live, table, pl = K4_ALL[case]
        grid_only, block_only = [], []
        k4_handoff_model(c_rows, c_live, table, pl, 0, rounds=grid_only)
        k4_handoff_model(c_rows, c_live, table, pl, 1 << 30,
                         rounds=block_only)
        assert grid_only[1] == 0 and block_only[0] == 0
        assert 0 < block_only[1] <= grid_only[0]
        fewer += block_only[1] < grid_only[0]
    assert fewer > 0


K2_CASES = {c[0]: c[:7] + ((),) for c in cases.k2_cases()}
K2_CASES.update({c[0]: c for c in cases.packed_k2_cases()})


def split_insert_model(c: int, threads: int = 512):
    """A split pass of K2's cluster (frontier_closure.cu split_pass) as
    plain ops, as a visited-set insert hook of `sparse._hash_event_closure`:
    the pass's M candidates spread over c blocks of `threads` threads,
    global thread g holding the contiguous run [g * per, (g + 1) * per),
    per = ceil(M / (c * threads)); round-synchronous probes on one table,
    a claim won by the lowest candidate index; the fresh rows' places
    from the blocks' totals, a prefix over the cluster's blocks, then
    each block's own prefix in candidate order."""
    def insert(c_rows, c_live, f_rows, count, table, probe_limit, N, rep):
        M = c_live.shape[0]
        table2, fresh, p_ovf, _ = sparse._hash_insert(
            c_rows, c_live, table, probe_limit, rep)
        per = -(-M // (c * threads))
        block = torch.arange(M) // (per * threads)
        totals = torch.zeros(c, dtype=torch.int64).index_add_(
            0, block, fresh.to(torch.int64))
        before = torch.cumsum(totals, 0) - totals
        in_block = torch.zeros(M, dtype=torch.int64)
        for b in range(c):
            sel = block == b
            in_block[sel] = torch.cumsum(fresh[sel].to(torch.int64), 0) - 1
        pos = torch.where(fresh, count + before[block] + in_block, N)
        n_fresh = totals.sum()
        rows2 = sparse._rows_at_set(f_rows, pos, c_rows)
        return (rows2, table2, torch.clamp(count + n_fresh, max=N), n_fresh,
                p_ovf | (count + n_fresh > N))
    return insert


@pytest.mark.parametrize("c", [2, 8])
@pytest.mark.parametrize("case", sorted(K2_CASES))
def test_k2_split_pass_order_is_the_closures(case, c):
    """The order batched K2's split passes run a transaction in — the
    candidates over c blocks, claims by the lowest candidate index, the
    append's places from the cluster's prefix of the block totals —
    closes every seeded K2 case (triple and packed, probe_limit 32 and 2,
    overflow included) as the plain closure does: rows, count, overflow,
    passes and stepped."""
    name, step_name, ev, rows, live, run, pl, pack = K2_CASES[case]
    N = live.shape[0]
    rep = sparse._rep(pack, ev["slot_f"].shape[0])
    hook = split_insert_model(c)
    got = sparse._hash_event_closure(
        rep, sparse.STEPS[step_name], ev, rows, live, run, N,
        sparse._next_pow2(2 * N), pl,
        insert=lambda cr, cl, fr, cnt, tb: hook(cr, cl, fr, cnt, tb, pl, N,
                                                rep))
    want = sk.frontier_closure_reference(step_name, ev, rows, live, run, pl,
                                         pack)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert [int(x) for x in got[1:5]] == want[1].tolist()


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_batched_k2_matches_plain():
    """Batched K2 on every row the card's own batch hands it (the four
    escalation keys at capacity 512: keys past their last event, and
    keys that overflowed, do not run), bit for bit against its plain
    version on the same CUDA tensors."""
    dev = _cuda()
    kept = cases.record_calls(
        "frontier_closure_batch",
        lambda: sparse.check_batch_sparse(_port_fifo_keys(), 512, 512,
                                          dedupe="hash", device=dev,
                                          escalate=lambda e, n: None))
    assert len(kept) > 20 and any(not a[5].all() for a in kept)
    for args in kept:
        n0 = sk.launches["frontier_closure_batch"]
        got = sk.frontier_closure_batch(*args)
        want = sk.frontier_closure_batch_reference(*args)
        torch.cuda.synchronize()
        assert sk.launches["frontier_closure_batch"] == n0 + 1
        for g, w in zip(got[0], want[0]):
            assert torch.equal(g, w)
        assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c[0] for c in cases.k4_batch_cases()])
def test_cuda_batched_k4_matches_plain(case):
    """Batched K4 bit for bit against its plain version."""
    dev = _cuda()
    name, c_rows, c_live, table, pl = {
        c[0]: c for c in cases.k4_batch_cases()}[case]
    args = (tuple(r.to(dev) for r in c_rows), c_live.to(dev),
            (tuple(r.to(dev) for r in table[0]), table[1].to(dev)), pl)
    want = sk.tiled_insert_batch_reference(*args)
    n0 = sk.launches["tiled_insert_batch"]
    got = sk.tiled_insert_batch(*args)    # consumes args' tables
    torch.cuda.synchronize()
    assert sk.launches["tiled_insert_batch"] == n0 + 1
    for g, w in zip(got[0][0], want[0][0]):
        assert torch.equal(g, w)
    for g, w in zip((got[0][1],) + tuple(got[1:]),
                    (want[0][1],) + tuple(want[1:])):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("smem_budget", [None, 16384])
def test_cuda_sparse_batch_equals_the_cpu(smem_budget):
    """Two escalation keys' batch on the card (batched K2, or batched K4
    through the budget seam) gives the CPU's results field for field but
    `closure`, and launches its kernel."""
    dev = _cuda()
    encs = _port_fifo_keys((5, 1))
    want = engine._check_batch_sparse(encs, 512, 512, device=CPU,
                                      smem_budget=smem_budget)
    sk.reset_launches()
    got = engine._check_batch_sparse(encs, 512, 512, device=dev,
                                     smem_budget=smem_budget)
    assert _strip(got) == _strip(want)
    kernel = "frontier_closure_batch" if smem_budget is None \
        else "tiled_insert_batch"
    assert sk.launches[kernel] > 0
