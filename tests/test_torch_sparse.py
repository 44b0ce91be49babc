"""The port's sparse frontier engine (jepsen_tpu_torch.parallel.sparse,
on the CPU with the plain closures) against the reference's
(jepsen_tpu.parallel.engine.check_encoded) on the identical encoded
input: for dedupe "sort" and "hash", over the five step families, clean
and corrupted, every order-independent result field must match — and
the hash closure forced through the tiled insert (K4's plain version)
too. Also the row hash, the sort dedupe row for row, capacity
escalation, the "unknown" verdict past max_capacity, probe exhaustion,
the seed frontier of long counterexamples, and the flags."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import info_op, invoke_op, ok_op
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import sparse
from jepsen_tpu_torch.parallel import sparse_kernels as sk
from torch_jax_cache import release_compiled_programs  # noqa: F401

KEYS = ("valid?", "fail-event", "op", "max-frontier", "capacity",
        "configs-stepped", "explored", "dedupe")


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


def _mutex_history():
    ops = [invoke_op(p, "acquire", None) for p in range(4)]
    ops += [ok_op(0, "acquire", None), invoke_op(0, "release", None),
            info_op(3, "acquire", None), ok_op(0, "release", None),
            ok_op(1, "acquire", None), invoke_op(1, "release", None),
            ok_op(1, "release", None), ok_op(2, "acquire", None)]
    return RefHistory.wrap(ops).index()


CASES = {
    "register": (ref_models.CASRegister, lambda: ref_histories
                 .rand_register_history(n_ops=40, n_processes=5, n_values=3,
                                        crash_p=0.06, fail_p=0.08, seed=31)),
    "gset": (ref_models.GSet, lambda: ref_histories.rand_gset_history(
        n_ops=36, n_processes=4, n_elements=9, crash_p=0.06, seed=33)),
    "uqueue": (ref_models.UnorderedQueue, lambda: ref_histories
               .rand_queue_history(n_ops=26, n_processes=4, n_values=3,
                                   crash_p=0.06, seed=34)),
    "fifo": (ref_models.FIFOQueue, lambda: ref_histories.rand_fifo_history(
        n_ops=24, n_processes=4, n_values=3, crash_p=0.05, seed=35)),
    "mutex": (ref_models.Mutex, _mutex_history),
}


def _encoded(name, corrupt=False):
    Model, gen = CASES[name]
    h = gen()
    if corrupt:
        h = ref_histories.corrupt_history(h, seed=7, n_corruptions=2)
    e = ref_enc.encode(Model(), h)
    return e, _to_port(e)


def _pin(r):
    return {k: r.get(k) for k in KEYS}


# the mutex history has no read to corrupt
VARIANTS = [(n, c) for n in sorted(CASES) for c in (False, True)
            if not (n == "mutex" and c)]


@pytest.mark.parametrize("dedupe", ["sort", "hash"])
@pytest.mark.parametrize("name,corrupt", VARIANTS,
                         ids=[f"{n}-{'corrupt' if c else 'clean'}"
                              for n, c in VARIANTS])
def test_check_encoded_matches_reference(name, corrupt, dedupe):
    re_, pe = _encoded(name, corrupt)
    want = ref_engine.check_encoded(re_, capacity=64, dedupe=dedupe)
    got = sparse.check_encoded(pe, capacity=64, dedupe=dedupe,
                               device="cpu")
    assert _pin(got) == _pin(want)
    assert got["closure"] == "torch"


@pytest.mark.parametrize("name", ["register", "uqueue", "fifo"])
def test_tiled_route_matches_reference_hash(name):
    """A budget too small for K2's layout at capacity 512 sends the hash
    closure through the tiled insert (2 tiles of 512): the same result
    as the reference's hash path, which has one table."""
    re_, pe = _encoded(name, corrupt=True)
    want = ref_engine.check_encoded(re_, capacity=512, dedupe="hash")
    got = sparse.check_encoded(pe, capacity=512, dedupe="hash",
                               device="cpu", smem_budget=16384)
    assert got["closure"] == "torch-tiled"
    assert _pin(got) == _pin(want)


def test_capacity_escalates_from_64():
    re_, pe = _encoded("register")
    want = ref_engine.check_encoded(re_, capacity=16, dedupe="hash")
    got = sparse.check_encoded(pe, capacity=16, dedupe="hash",
                               device="cpu")
    assert got["capacity"] > 64
    assert _pin(got) == _pin(want)


@pytest.mark.parametrize("dedupe", ["sort", "hash"])
def test_unknown_past_max_capacity(dedupe):
    re_, pe = _encoded("register")
    want = ref_engine.check_encoded(re_, capacity=64, max_capacity=64,
                                    dedupe=dedupe)
    got = sparse.check_encoded(pe, capacity=64, max_capacity=64,
                               dedupe=dedupe, device="cpu")
    assert want["valid?"] == "unknown"
    assert {k: v for k, v in got.items() if k != "closure"} == want


def test_probe_exhaustion_escalates_like_the_reference():
    """probe_limit=1 makes every collision an overflow: the capacity at
    which the check settles is the reference's."""
    re_, pe = _encoded("register", corrupt=True)
    want = ref_engine.check_encoded(re_, capacity=64, dedupe="hash",
                                    probe_limit=1, max_capacity=1 << 14)
    got = sparse.check_encoded(pe, capacity=64, dedupe="hash",
                               probe_limit=1, max_capacity=1 << 14,
                               device="cpu")
    assert got["capacity"] > 64
    assert _pin(got) == _pin(want)


def test_table_hash_matches_reference():
    rng = np.random.default_rng(1)
    lanes = rng.integers(0, 1 << 32, size=(3, 4096), dtype=np.uint64) \
        .astype(np.uint32)
    lanes[:, :4] = [[0, 0xFFFFFFFF, 0x80000000, 1]] * 3
    want = np.asarray(ref_engine._UnpackedRep(8).table_hash(
        (jnp.asarray(lanes[0].view(np.int32)), jnp.asarray(lanes[1]),
         jnp.asarray(lanes[2]))))
    got = sparse._UnpackedRep(8).table_hash(
        tuple(torch.from_numpy(a.view(np.int32)) for a in lanes))
    assert (lanes >= 1 << 31).any()
    assert np.array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("N", [300, 50])
def test_dedupe_compact_matches_reference(N):
    """Row for row, dead rows last, masks ordered as unsigned; N=50 is
    short of the distinct rows, so the tail drops and overflow is set."""
    rng = np.random.default_rng(2)
    M = 400
    st = rng.integers(-3, 4, M).astype(np.int32)
    ml = rng.choice(np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32), M)
    mh = rng.choice(np.array([0, 2, 0x90000000], np.uint32), M)
    live = rng.random(M) < 0.7
    want = ref_engine._dedupe_compact(
        (jnp.asarray(st), jnp.asarray(ml), jnp.asarray(mh)),
        jnp.asarray(live), N, ref_engine._UnpackedRep(4))
    got = sparse._dedupe_compact(
        (torch.from_numpy(st), torch.from_numpy(ml.view(np.int32)),
         torch.from_numpy(mh.view(np.int32))), torch.from_numpy(live), N,
        sparse._UnpackedRep(4))
    for g, w in zip(got[0], want[0]):
        assert np.array_equal(g.numpy(), np.asarray(w).view(np.int32))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    assert bool(got[3]) == bool(want[3]) == (N == 50)


def test_frontier_at_matches_reference():
    """The seed rows of a long counterexample: the reference's sort
    re-scan, in its carry order."""
    h = ref_histories.rand_queue_history(n_ops=60, n_processes=6,
                                         crash_p=0.02, seed=5)
    re_ = ref_enc.encode(ref_models.UnorderedQueue(), h)
    pe = _to_port(re_)
    for start in (10, 40):
        want = ref_engine._frontier_at(re_, start)
        got = sparse.frontier_at(pe, start, device="cpu")
        assert len(got) > 1 and got == want


def test_empty_history_and_config_pack():
    re_, pe = _encoded("uqueue")
    pe.ev_slot = pe.ev_slot[:0]
    assert sparse.check_encoded(pe, device="cpu") == {
        "valid?": True, "max-frontier": 0, "capacity": 0}
    assert sparse.check_encoded(pe, device="cpu", config_pack=True) == {
        "valid?": True, "max-frontier": 0, "capacity": 0}
    # packed rows are ported: the reference's packed result, tagged
    re_, pe = _encoded("uqueue")
    want = ref_engine.check_encoded(re_, capacity=64, dedupe="hash",
                                    config_pack=True)
    got = sparse.check_encoded(pe, capacity=64, dedupe="hash",
                               device="cpu", config_pack=True)
    assert _pin(got) == _pin(want)
    assert got["config-pack"] == want["config-pack"] == "packed:13b/1-lane"


def test_flags(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_TORCH_DEDUPE", raising=False)
    monkeypatch.delenv("JEPSEN_TPU_TORCH_PROBE_LIMIT", raising=False)
    assert sparse._resolve_dedupe() == "hash"
    assert sparse._resolve_probe_limit() == 32
    assert sparse._resolve_probe_limit(5) == 5
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DEDUPE", "sort")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROBE_LIMIT", "7")
    assert sparse._resolve_dedupe() == "sort"
    assert sparse._resolve_dedupe("hash") == "hash"
    assert sparse._resolve_probe_limit() == 7
    for bad in ("0", "256", "x"):
        monkeypatch.setenv("JEPSEN_TPU_TORCH_PROBE_LIMIT", bad)
        with pytest.raises(ValueError):
            sparse._resolve_probe_limit()
    with pytest.raises(ValueError):
        sparse._resolve_probe_limit(256)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DEDUPE", "lexsort")
    with pytest.raises(ValueError, match="dedupe"):
        sparse._resolve_dedupe()
    _, pe = _encoded("uqueue")
    monkeypatch.delenv("JEPSEN_TPU_TORCH_PROBE_LIMIT")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DEDUPE", "sort")
    assert sparse.check_encoded(pe, device="cpu")["dedupe"] == "sort"


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pe = _encoded("fifo")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        sparse.check_encoded(pe)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        sparse.frontier_at(pe, 3)


def _tiled_layout_insert(tile: int):
    """A visited-set insert laid out as the TPU kernel's hash-range tiles
    of `tile` slots (a candidate's home tile its hash's low bits, its
    probes wrapping inside the tile from the next bits), one chunk: what
    K4 computed on such a plan before it took the whole table."""
    def insert(c_rows, c_live, table, probe_limit):
        (t_rows, t_occ), M = table, c_live.shape[0]
        n_tt = t_occ.shape[0] // tile
        h = sparse.table_hash_u32(*(sparse._u32(r) for r in c_rows))
        base = (h & (n_tt - 1)) * tile
        start = (h >> (n_tt.bit_length() - 1)) & (tile - 1)
        t_rows = tuple(r.clone() for r in t_rows)
        t_occ = t_occ.clone()
        idx = torch.arange(M)
        pending, off = c_live.clone(), torch.zeros(M, dtype=torch.int32)
        fresh = torch.zeros(M, dtype=torch.bool)
        while bool((pending & (off < probe_limit)).any()):
            act = pending & (off < probe_limit)
            slot = base + ((start + off) & (tile - 1))
            occ = t_occ[slot]
            same = occ & (t_rows[0][slot] == c_rows[0]) & \
                (t_rows[1][slot] == c_rows[1]) & (t_rows[2][slot] == c_rows[2])
            try_claim = act & ~occ
            claim = torch.full((t_occ.shape[0] + 1,), M, dtype=torch.int64)
            claim.scatter_reduce_(0, torch.where(try_claim, slot,
                                                 t_occ.shape[0]), idx, "amin")
            won = try_claim & (claim[slot] == idx)
            for r, c in zip(t_rows, c_rows):
                r[slot[won]] = c[won]
            t_occ[slot[won]] = True
            pending = pending & ~(act & same) & ~won
            off = off + (act & occ & ~same).to(torch.int32)
            fresh = fresh | won
        return (t_rows, t_occ), fresh, off, pending.any()
    return insert


def test_tiled_route_takes_the_references_whole_table(monkeypatch):
    """A fault of ROADMAP Queue 3, now closed: the tiled closure probed
    K4's hash-range tiles, whose table layout, and so where a probe run
    is exhausted, differ from the reference's one table. At probe_limit
    3 this queue history settled at capacity 512 on tiles of 512; the
    reference needs 1,024. K4 now runs the whole table, the reference's
    own transaction."""
    h = ref_histories.rand_queue_history(n_ops=40, n_processes=6,
                                         n_values=3, crash_p=0.1, seed=1)
    re_ = ref_enc.encode(ref_models.UnorderedQueue(), h)
    pe = _to_port(re_)
    want = ref_engine.check_encoded(re_, capacity=256, dedupe="hash",
                                    probe_limit=3)
    kw = dict(capacity=256, dedupe="hash", probe_limit=3,
              smem_budget=16384, device="cpu")
    got = sparse.check_encoded(pe, **kw)
    assert got["closure"] == "torch-tiled"
    assert _pin(got) == _pin(want) and want["capacity"] == 1024
    monkeypatch.setattr(sk, "tiled_insert", _tiled_layout_insert(512))
    old = sparse.check_encoded(pe, **kw)
    assert old["closure"] == "torch-tiled" and old["capacity"] == 512
