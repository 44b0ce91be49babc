"""The batched dense scan as one call a chunk of event rows
(`closure_kernels.closure_scan_batch`, its plain version on the CPU and
its persistent kernel on the card) and `closure_plan_batch`.

On the CPU: the plain scan equals the per-row composition the batched
scan issued before it was one call (the batched closure of every
running key, each key's filter on its own slot through the reference's
stacked word tables, the failure bookkeeping, the stats rows), carried
row by row over seeded chunks that hold every slot j < 5 and j >= 5,
pad rows, keys failed before the chunk and keys that fail inside it,
with stats on and off, and whether the rows come in one call or in
several; `check_batch_bitdense` equals the reference's (jepsen_tpu,
its XLA closure) with sel built one, a few or all rows at a time, and
with stats its blocks equal the reference's; and the layouts the plan
picks. On the card (`cuda`-marked, skipped here): the kernel bit for bit
against the plain scan in every layout each shape can take — among them
a cluster whose filter pairs straddle its blocks — with stats on and
off, and a chunk split over two launches."""

import numpy as np
import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.parallel import bitdense as ref_bd
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu_torch.parallel import bitdense as bd
from jepsen_tpu_torch.parallel import closure_kernels as ck
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import engine
from torch_jax_cache import release_compiled_programs  # noqa: F401

I32 = torch.int32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ the per-row composition

def _row_tables(C: int):
    """The batched filter's stacked word tables, as the scan kept them
    when it issued a row at a time: per slot j the word gather, the right
    shift and the mask, from the reference's `bitdense._plan`."""
    W, plan = ref_bd._plan(C)
    widx = np.tile(np.arange(W, dtype=np.int64), (C, 1))
    mask = np.full((C, W), 0xFFFFFFFF, np.uint32)
    shift = np.zeros(C, np.int32)
    for j, pj in enumerate(plan):
        if pj["intra"]:
            shift[j] = pj["shift"]
            mask[j] = pj["clear"]
        else:
            widx[j] = pj["fwd_idx"]
            mask[j] = pj["clearw"]
    return (torch.from_numpy(widx), torch.from_numpy(shift),
            torch.from_numpy(mask.view(np.int32)))


def _popcount(B, dims):
    shifts = torch.arange(32, dtype=I32)
    return ((B.unsqueeze(-1) >> shifts) & 1).sum([*dims, -1])


def _rows(sel, B, ok, fail_r, slot, real, r0, C, traj=None):
    """The per-row batched scan, row by row: the carry after the rows."""
    widx, shift, mask = _row_tables(C)
    K, S, W = B.shape
    for i in range(sel.shape[0]):
        r = r0 + i
        run = ok & real[i]
        B2, n = ck._batch_reference_counted(sel[i], B, C, run)
        s = slot[i].long()
        g = torch.gather(B2, 2, widx[s].unsqueeze(1).expand(K, S, W))
        B3 = (g >> shift[s].view(K, 1, 1)) & mask[s].unsqueeze(1)
        if traj is not None:
            traj[:, r] = torch.stack([
                torch.where(run, _popcount(B3, (1, 2)), -1).to(I32),
                torch.tensor(n, dtype=I32)], 1)
        failed = run & ~B3.flatten(1).any(1)
        fail_r = torch.where(failed, r, fail_r)
        B = torch.where(run.view(K, 1, 1), B3, B2)
        ok = ok & ~failed
    return B, ok, fail_r


def _scan_case(seed: int, K: int, S: int, C: int, E: int, r0: int = 3,
               p_step: float = 0.6):
    """A seeded chunk: register-like selects (most (j, s) step to one t),
    each key's B a few configurations, every slot among the rows, key k
    real for its first n_k rows (pad rows after), key 1 failed before the
    chunk, and keys 2 and K - 2 failing inside it: their masks start
    empty and their slot j_f never steps, so the row that returns on j_f
    (row E // 2 - 1 and row 1, or an earlier one on j_f) empties them."""
    rng = np.random.default_rng(seed)
    W = ck.n_words(C)
    sel = np.zeros((E, K, C, S, S), np.int32)
    t = rng.integers(S, size=(E, K, C, S))
    e, k, j, s = np.nonzero(rng.random((E, K, C, S)) < p_step)
    sel[e, k, j, s, t[e, k, j, s]] = -1
    slot = (np.arange(E)[:, None] * 3 + np.arange(K)[None] * 5
            + rng.integers(C, size=(E, K))) % C
    B = np.zeros((K, S, W), np.uint32)
    failing = {kk: e_f for kk, e_f in ((2, E // 2 - 1), (K - 2, 1))
               if 1 < kk < K}
    for kk in range(K):
        for _ in range(1 + kk % 3):
            st = rng.integers(S)
            m = 0 if kk in failing else rng.integers(1 << C)
            B[kk, st, m // 32] |= np.uint32(1) << np.uint32(m % 32)
    for kk, e_f in failing.items():
        sel[:, kk, slot[e_f, kk]] = 0
    n_real = rng.integers(E // 2, E + 1, size=K)
    n_real[0] = E
    n_real[-1] = E // 2
    real = np.arange(E)[:, None] < n_real[None]
    ok = np.ones(K, bool)
    fail_r = np.full(K, -1, np.int32)
    ok[1], fail_r[1] = False, r0 - 1
    return (torch.from_numpy(sel), torch.from_numpy(B.view(np.int32)),
            torch.from_numpy(ok), torch.from_numpy(fail_r),
            torch.from_numpy(slot.astype(np.int32)), torch.from_numpy(real))


SHAPES = [(3, 5), (4, 7), (6, 9)]   # (S, C): one word; W = 4; W = 16


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("S,C", SHAPES)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_scan_equals_the_rows(seed, S, C, stats):
    K, E, r0 = 7, 10, 3
    sel, B, ok, fail_r, slot, real = _scan_case(seed + 10 * C, K, S, C, E,
                                                r0)
    R = r0 + E + 2
    want_traj = torch.full((K, R, 2), 7, dtype=I32) if stats else None
    want = _rows(sel, B, ok, fail_r, slot, real, r0, C, want_traj)
    got = [B.clone(), ok.clone(), fail_r.clone()]
    traj = torch.full((K, R, 2), 7, dtype=I32) if stats else None
    before = (ck.launches, ck.batch_launches)
    ck.closure_scan_batch(sel, *got, slot, real, r0, C, traj=traj)
    assert (ck.launches, ck.batch_launches) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if stats:
        assert torch.equal(traj, want_traj)
        assert (traj[:, :r0] == 7).all()          # rows outside the chunk
    # the case holds what it is for: keys failing inside the chunk, keys
    # left alive, pad rows, a key failed before it, slots both sides of 5
    failed = (want[2] >= r0) & ~want[1]
    assert failed.any() and want[1].any() and (~real).any()
    assert not got[1][1] and int(got[2][1]) == r0 - 1
    assert (slot < 5).any() and ((slot >= 5).any() or C == 5)


def test_the_cases_hold_every_slot():
    for S, C in SHAPES:
        seen = set()
        for seed in (0, 1):
            seen |= set(_scan_case(seed + 10 * C, 7, S, C, 10)[4]
                        .flatten().tolist())
        assert seen == set(range(C)), (S, C)


@pytest.mark.parametrize("cuts", [[1], [2, 5], [3, 4, 9]])
def test_plain_scan_carries_across_chunks(cuts):
    """The rows in one call, or cut into several calls at `cuts` (r0
    counting on): the same carry and trajectory."""
    K, S, C, E, r0 = 6, 4, 7, 10, 0
    sel, B, ok, fail_r, slot, real = _scan_case(5, K, S, C, E, r0)
    whole = [B.clone(), ok.clone(), fail_r.clone()]
    traj = torch.zeros((K, E, 2), dtype=I32)
    ck.closure_scan_batch(sel, *whole, slot, real, r0, C, traj=traj)
    parts = [B.clone(), ok.clone(), fail_r.clone()]
    traj_p = torch.zeros((K, E, 2), dtype=I32)
    for a, b in zip([0] + cuts, cuts + [E]):
        ck.closure_scan_batch(sel[a:b], *parts, slot[a:b], real[a:b], a, C,
                              traj=traj_p)
    for g, w in zip(parts, whole):
        assert torch.equal(g, w)
    assert torch.equal(traj_p, traj)


@pytest.mark.parametrize("C", [5, 6, 7, 9, 10])
def test_filter_keys_equals_the_word_tables(C):
    rng = np.random.default_rng(C)
    W = ck.n_words(C)
    B = torch.from_numpy(rng.integers(0, 1 << 32, size=(C, 3, W),
                                      dtype=np.uint64).astype(np.uint32)
                         .view(np.int32))
    slot = torch.arange(C, dtype=I32)            # key k on slot k
    widx, shift, mask = _row_tables(C)
    s = slot.long()
    g = torch.gather(B, 2, widx[s].unsqueeze(1).expand(C, 3, W))
    want = (g >> shift[s].view(C, 1, 1)) & mask[s].unsqueeze(1)
    assert torch.equal(ck.filter_keys(B, slot, C), want)


# ------------------------------------------------- through the batch

def _port(e):
    import dataclasses
    arrays = {k: getattr(e, k) for k in enc.ARRAY_FIELDS}
    calls = [dataclasses.asdict(c) for c in e.calls]
    meta = {k: getattr(e, k) for k in ("state0", "step_name", "n_calls",
                                       "n_slots", "state_lo", "n_states",
                                       "model_pruned")}
    meta["intern"] = list(e.intern._values)
    return enc.encoded_from_arrays(arrays, calls, meta)


@pytest.fixture(scope="module")
def batch_keys():
    """Six keys of the bench's multi-key shape cut to 40 ops (two of
    them corrupted: they fail), encoded by the reference, and the
    reference's batch results, stats off and on."""
    hs = [ref_histories.rand_register_history(
        n_ops=40, n_processes=6, n_values=5, crash_p=0.005, fail_p=0.05,
        busy=0.8, seed=2024 + k) for k in range(6)]
    hs[1] = ref_histories.corrupt_history(hs[1], seed=1)
    hs[4] = ref_histories.corrupt_history(hs[4], seed=4)
    pre = [ref_enc.encode(ref_models.CASRegister(), h) for h in hs]
    return (pre, ref_bd.check_batch_bitdense(pre),
            ref_bd.check_batch_bitdense(pre, search_stats=True))


@pytest.mark.parametrize("rows", [None, 1, 3])
def test_check_batch_matches_the_reference(monkeypatch, batch_keys, rows):
    """sel built `rows` event rows at a time (None: the default, one
    chunk): one scan call a chunk, the reference's results, stats off and
    on (its blocks: widths, closure-iters, the pad extras)."""
    pre, want, want_stats = batch_keys
    encs = [_port(e) for e in pre]
    _, _, S, C, R = enc.pad_batch(encs, min_slots=5)
    if rows is not None:
        monkeypatch.setattr(bd, "SEL_CHUNK_ELEMS",
                            rows * len(encs) * C * S * S)
    calls = []
    real = ck.closure_scan_batch

    def counting(sel, *a, **kw):
        calls.append(sel.shape[0])
        return real(sel, *a, **kw)

    monkeypatch.setattr(ck, "closure_scan_batch", counting)
    strip = [{k: v for k, v in r.items() if k != "closure"}
             for r in want]
    got = bd.check_batch_bitdense(encs, device="cpu")
    assert [{k: v for k, v in r.items() if k != "closure"}
            for r in got] == strip
    assert not all(r["valid?"] for r in got)
    n = rows or R
    assert calls == [n] * (R // n) + ([R % n] if R % n else [])
    got = bd.check_batch_bitdense(encs, device="cpu", search_stats=True)
    assert [r["stats"] for r in got] == [r["stats"] for r in want_stats]
    assert any(r["stats"]["pad-events"] > 0 for r in got)


# --------------------------------------------------------------- the plan

def test_closure_plan_batch_choices():
    # the bench's 84 keys: one block a key
    p = ck.closure_plan_batch(84, 6, 15)
    assert (p["layout"], p["cluster"], p["threads"]) == ("shared", 1, 1024)
    assert p["smem"] == ck.k1_block_bytes(6, 15, 1024, 2)
    assert ck.closure_plan_batch(90, 7, 15)["layout"] == "shared"
    # the 92-key mix's wide bucket: 2 keys of 377 KB of B, a cluster of 16
    p = ck.closure_plan_batch(2, 23, 17)
    assert (p["layout"], p["cluster"], p["block_words"]) == \
        ("cluster", 16, 256)
    assert p["smem"] <= ck.HOPPER_SMEM_OPTIN
    # one key with SMs to spare: spread while a block keeps 1,024 words
    p = ck.closure_plan_batch(1, 6, 15)
    assert (p["layout"], p["cluster"]) == ("cluster", 4)
    # past every cluster (B twice over in 16 blocks' 227 KB): global
    assert ck.closure_plan_batch(1, 4, 22)["layout"] == "global"
    assert ck.closure_plan_batch(3, 23, 17, max_cluster=2)["layout"] == \
        "global"
    # a narrow card: the least cluster whose blocks hold their shares
    p = ck.closure_plan_batch(84, 6, 15, optin=30_000)
    assert (p["layout"], p["cluster"]) == ("cluster", 2)
    # no split below 16 words a state
    assert ck.closure_plan_batch(1, 40, 8)["layout"] == "shared"


def test_closure_plans_batch_lists_every_layout():
    plans = ck.closure_plans_batch(84, 6, 15)
    assert sorted(plans) == ["cluster", "global", "shared"]
    assert plans["cluster"]["cluster"] == 2
    assert plans["shared"] == ck.closure_plan_batch(84, 6, 15)
    plans = ck.closure_plans_batch(2, 23, 17)
    assert sorted(plans) == ["cluster", "global"]
    assert plans["cluster"]["cluster"] == 16
    assert sorted(ck.closure_plans_batch(1, 4, 22)) == ["global"]
    for p in ck.closure_plans_batch(5, 40, 12).values():
        assert p["smem"] <= ck.HOPPER_SMEM_OPTIN


# -------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plain_on(dev, case, r0, C):
    """The plain scan of `case` on `dev` (the card runs the plain torch
    closure far faster than the host at the wide shapes): the carry
    after it and its trajectory (width -1 on a row a key did not run)."""
    carry = [t.to(dev) for t in case[1:4]]
    K = carry[0].shape[0]
    traj = torch.full((K, r0 + case[0].shape[0], 2), 7, dtype=I32,
                      device=dev)
    ck.closure_scan_batch_reference(case[0].to(dev), *carry,
                                    case[4].to(dev), case[5].to(dev), r0, C,
                                    traj)
    return carry, traj


def _held(got, got_traj, want, want_traj, r0, what):
    for g, w, n in zip(got, want, ("B", "ok", "fail_r")):
        assert torch.equal(g, w), f"{what}: {n}"
    if want_traj is not None:
        # the widths; the kernel's iterations are -1 (they never leave it)
        assert torch.equal(got_traj[..., 0], want_traj[..., 0]), what
        assert (got_traj[:, r0:, 1] == -1).all(), what
        assert (got_traj[:, :r0] == 7).all(), what


CUDA_SHAPES = [(6, 6, 15), (4, 23, 17), (5, 4, 7), (4, 40, 12), (4, 3, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("K,S,C", CUDA_SHAPES)
def test_cuda_scan_matches_plain_in_every_layout(K, S, C, stats):
    """Every layout the shape can take, and every cluster size whose
    blocks hold their shares — at S=23 C=17 clusters of 4 to 16, whose
    filter pairs for j >= 15 (4 blocks) to j >= 13 (16 blocks) straddle
    its blocks: key 0 returns on slots 13-16 in rows 1-4; at S=6 C=15 a
    cluster of 2 (j = 14); keys failing inside the chunk (keys 2 and
    K - 2) and pad rows."""
    dev = _cuda()
    E, r0 = 9, 2
    case = _scan_case(K * 100 + C, K, S, C, E, r0, p_step=0.35)
    straddle = list(range(13, C))
    case[4][1:1 + len(straddle), 0] = torch.tensor(straddle, dtype=I32)
    want, want_traj = _plain_on(dev, case, r0, C)
    # the case holds what it is for: the straddling slots on rows a key
    # runs, a key failing inside the chunk
    ran = (want_traj[:, r0:, 0] >= 0).cpu()
    assert set(straddle) <= set(case[4].T[ran].tolist())
    assert ((want[2] >= r0) & ~want[1]).any()
    limits = ck.card_limits(dev)
    plans = {"gate": None, **ck.closure_plans_batch(K, S, C, *limits,
                                                    ck.sm_count(dev))}
    W = ck.n_words(C)
    for k in (2, 4, 8, 16):
        if k <= min(limits[1], W // ck.MIN_BLOCK_WORDS) and \
                ck.k1_block_bytes(S, C, W // k, 2) <= limits[0]:
            plans[f"cluster of {k}"] = ck._scan_split_plan(S, C, k)
    if not stats:
        want_traj = None
    for name, plan in plans.items():
        got = [t.to(dev) for t in case[1:4]]
        traj = torch.full_like(want_traj, 7) if stats else None
        before = ck.batch_launches
        ck._launch_scan(case[0].to(dev), *got, case[4].to(dev),
                        case[5].to(dev), r0, C, traj=traj, plan=plan)
        torch.cuda.synchronize()
        assert ck.batch_launches == before + 1
        _held(got, traj, want, want_traj, r0, f"{name} K{K} S{S} C{C}")


@pytest.mark.cuda
@pytest.mark.parametrize("K,S,C", [(6, 6, 15), (4, 23, 17)])
def test_cuda_chunk_split_in_two_launches(K, S, C):
    """The rows in two launches (the carry crossing between them) equal
    the rows in one and the plain scan."""
    dev = _cuda()
    E = 10
    case = _scan_case(K + S + C, K, S, C, E, 0, p_step=0.35)
    want, want_traj = _plain_on(dev, case, 0, C)
    sel, B, ok, fail_r, slot, real = [t.to(dev) for t in case]
    for cut in (E, 4):
        got = [B.clone(), ok.clone(), fail_r.clone()]
        traj = torch.full_like(want_traj, 7)
        for a, b in ((0, cut), (cut, E)):
            if a < b:
                ck.closure_scan_batch(sel[a:b].contiguous(), *got,
                                      slot[a:b].contiguous(),
                                      real[a:b].contiguous(), a, C,
                                      traj=traj)
        torch.cuda.synchronize()
        _held(got, traj, want, want_traj, 0, f"cut {cut}")


def _chunks(encs) -> int:
    """The chunks of event rows of the batch's buckets: one scan call
    each."""
    buckets: dict = {}
    for e in encs:
        buckets.setdefault(engine.bucket_key(e.n_slots, "tier"), []).append(e)
    n = 0
    for sub in buckets.values():
        _, _, S, C, R = enc.pad_batch(sub, min_slots=5)
        n += -(-R // max(1, bd.SEL_CHUNK_ELEMS // (len(sub) * C * S * S)))
    return n


@pytest.mark.cuda
def test_cuda_check_batch_equals_the_cpu(monkeypatch):
    dev = _cuda()
    hs = [ref_histories.rand_register_history(
        n_ops=60, n_processes=8, n_values=5, crash_p=0.005, fail_p=0.05,
        busy=0.8, seed=2024 + k) for k in range(10)]
    hs[3] = ref_histories.corrupt_history(hs[3], seed=3)
    encs = [_port(ref_enc.encode(ref_models.CASRegister(), h)) for h in hs]
    want = engine.check_batch_encoded(None, encs, device="cpu",
                                      search_stats=True)
    _, _, S, C, _ = enc.pad_batch(encs, min_slots=5)
    for rows in (None, 7):
        if rows is not None:
            monkeypatch.setattr(bd, "SEL_CHUNK_ELEMS",
                                rows * len(encs) * C * S * S)
        ck.reset_launches()
        got = engine.check_batch_encoded(None, encs, device=dev,
                                         search_stats=True)
        assert ck.batch_launches == _chunks(encs)
        assert ck.launches == 0
        for g, w in zip(got, want):
            assert g["closure"] == "cuda"
            gs, ws = g.pop("stats"), dict(w["stats"])
            assert gs["frontier-width"] == ws["frontier-width"]
            assert set(gs["closure-iters"]) <= {-1}
            assert {k: v for k, v in g.items() if k != "closure"} == \
                {k: v for k, v in w.items() if k not in ("closure", "stats")}
