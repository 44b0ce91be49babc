"""The port's per-key batch on the dense engine (jepsen_tpu_torch:
`encode.pad_batch`, `closure_kernels.closure_scan_batch`,
`bitdense.check_batch_bitdense`, `engine.check_batch` and
`check_batch_encoded`), on the CPU with the plain closure, against the
reference's (jepsen_tpu, its XLA closure) on the identical encoded input,
carried across with `encoded_from_arrays`. Every field but `closure`
must match, key for key and in input order. Also the padding hazards
(pad events and pad slots change nothing, C's floor of 5, the first
key's state offset and step family, sel's chunk counting the keys), the
bucketing and its flag, the raises for what is not ported, and — on the
card only — the batched scan against its plain version in every
layout."""

import dataclasses
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.parallel import bitdense as ref_bd
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu_torch import models
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import bitdense as bd
from jepsen_tpu_torch.parallel import closure_kernels as ck
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import engine

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


def _port_history(h):
    return History.wrap(dict(o) for o in h)


def _strip(rs):
    return [{k: v for k, v in r.items() if k != "closure"} for r in rs]


def _same_as_reference(ref_model, hs, **kw):
    """check_batch_encoded of both packages on the same encodings."""
    pre = [ref_enc.encode(ref_model, h) for h in hs]
    want = ref_engine.check_batch_encoded(ref_model, pre, **kw)
    got = engine.check_batch_encoded(None, [_to_port(e) for e in pre],
                                     device=CPU, **kw)
    assert all(r["closure"] == "torch" for r in got)
    assert _strip(got) == _strip(want)
    return got


def _bench_keys(n_keys, n_ops, seed=2024, n_processes=14):
    """The reference bench's multi-key shape (bench.py sec_multikey)."""
    return [ref_histories.rand_register_history(
        n_ops=n_ops, n_processes=n_processes, n_values=5, crash_p=0.005,
        fail_p=0.05, busy=0.8, seed=seed + k) for k in range(n_keys)]


# ------------------------------------------------------------- pad_batch

@pytest.mark.parametrize("floors", [{}, {"min_slots": 5},
                                    {"min_slots": 9, "min_states": 11,
                                     "min_returns": 70}])
def test_pad_batch_matches_reference(floors):
    hs = [ref_histories.rand_register_history(
        n_ops=20 + 10 * s, n_processes=2 + s % 3, crash_p=0.05, seed=s)
        for s in range(5)]
    pre = [ref_enc.encode(ref_models.CASRegister(), h) for h in hs]
    xs_r, s0_r, *dims_r = ref_enc.pad_batch(pre, **floors)
    xs, s0, *dims = enc.pad_batch([_to_port(e) for e in pre], **floors)
    assert dims == dims_r
    assert sorted(xs) == sorted(xs_r)
    for k in xs:
        assert isinstance(xs[k], np.ndarray)
        assert xs[k].dtype == np.asarray(xs_r[k]).dtype, k
        assert np.array_equal(xs[k], np.asarray(xs_r[k])), k
    assert np.array_equal(s0, np.asarray(s0_r))
    if floors.get("min_returns"):
        assert dims[2] == 70 and (xs["ev_slot"][:, -1] == -1).all()


def test_encode_batch_matches_reference():
    hs = _bench_keys(3, 30, n_processes=3)
    encs_r, xs_r, s0_r = ref_engine.encode_batch(ref_models.CASRegister(),
                                                 hs)
    encs, xs, s0 = engine.encode_batch(models.CASRegister(),
                                       [_port_history(h) for h in hs])
    assert [e.n_returns for e in encs] == [e.n_returns for e in encs_r]
    for k in xs_r:
        assert np.array_equal(xs[k], np.asarray(xs_r[k])), k
    assert np.array_equal(s0, np.asarray(s0_r))
    # pre-encoded keys are final: another width is refused
    wide = engine.encode_batch(None, None, pad_slots=8, encs=[
        enc.encode(models.CASRegister(), _port_history(hs[0]),
                   pad_slots=8)])[0]
    assert wide[0].slot_f.shape[1] == 8
    with pytest.raises(ValueError, match="pad_slots"):
        engine.encode_batch(None, None, pad_slots=9, encs=wide)


# ------------------------------------------------------- the batched K1

def _rand_batch(rng, K, S, C, density=0.3):
    W = ck.n_words(C)
    sel = np.where(rng.random((K, C, S, S)) < density, -1, 0)
    B = rng.integers(0, 1 << 32, size=(K, S, W), dtype=np.uint64) \
        .astype(np.uint32)
    B[rng.random((K, S, W)) >= 0.05] = 0
    return (torch.from_numpy(sel.astype(np.int32)),
            torch.from_numpy(B.view(np.int32)))


@pytest.mark.parametrize("S,C", [(6, 7), (3, 5), (5, 2)])
def test_batch_reference_equals_single_calls(S, C):
    rng = np.random.default_rng(S * 100 + C)
    sel, B = _rand_batch(rng, 5, S, C)
    run = torch.tensor([True, False, True, True, False])
    got = ck.closure_fixpoint_batch_reference(sel, B, C, run)
    for k in range(5):
        want = ck.closure_fixpoint_reference(sel[k], B[k], C) if run[k] \
            else B[k]
        assert torch.equal(got[k], want), k
    # the CPU scan of one row runs the plain closure, filters the running
    # keys, in place, and counts nothing
    before = (ck.launches, ck.batch_launches)
    out, ok = B.clone(), run.clone()
    fail_r = torch.full((5,), -1, dtype=torch.int32)
    slot = (torch.arange(5, dtype=torch.int32) % C)[None]
    ck.closure_scan_batch(sel[None], out, ok, fail_r, slot,
                          torch.ones((1, 5), dtype=torch.bool), 0, C)
    assert torch.equal(out, torch.where(
        run.view(5, 1, 1), ck.filter_keys(got, slot[0], C), got))
    assert (ck.launches, ck.batch_launches) == before


def test_batch_wrapper_checks_its_arguments():
    sel, B = _rand_batch(np.random.default_rng(1), 3, 4, 6)
    sel = sel[None]
    ok = torch.ones(3, dtype=torch.bool)
    fail_r = torch.full((3,), -1, dtype=torch.int32)
    slot = torch.zeros((1, 3), dtype=torch.int32)
    real = torch.ones((1, 3), dtype=torch.bool)

    def scan(C=6, r0=0, traj=None, **kw):
        args = dict(zip(("sel", "B", "ok", "fail_r", "slot", "real"),
                        (sel, B, ok, fail_r, slot, real)))
        args.update(kw)
        ck.closure_scan_batch(*args.values(), r0, C, traj=traj)

    with pytest.raises(ValueError, match="ok must be"):
        scan(ok=torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match=r"\[E, K, C, S, S\]"):
        scan(sel=sel[0])
    with pytest.raises(ValueError, match=r"\[K, C, S, S\]"):
        scan(sel=sel[:, :2])
    with pytest.raises(ValueError, match="closure"):
        scan(C=7)
    with pytest.raises(ValueError, match="slot must be"):
        scan(slot=slot.long())
    with pytest.raises(ValueError, match="real must be"):
        scan(real=real[:, :2])
    with pytest.raises(ValueError, match="traj must be"):
        scan(r0=4, traj=torch.zeros((3, 4, 2), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="no kernel"):
        scan(sel=sel.to("meta"), B=B.to("meta"), ok=ok.to("meta"),
             fail_r=fail_r.to("meta"), slot=slot.to("meta"),
             real=real.to("meta"))


# ------------------------------------------------------------ the batch

def test_check_batch_matches_reference():
    """The reference's tests/test_engine.py::test_check_batch shapes, one
    key corrupted, through both packages' check_batch."""
    hs = [ref_histories.rand_register_history(
        n_ops=30, n_processes=3, crash_p=0.05, seed=s) for s in range(8)]
    hs[3] = ref_histories.corrupt_history(hs[3], seed=3, n_corruptions=2)
    want = ref_engine.check_batch(ref_models.CASRegister(), hs)
    got = engine.check_batch(models.CASRegister(),
                             [_port_history(h) for h in hs], device=CPU)
    assert _strip(got) == _strip(want)
    assert got[3]["valid?"] is False and "op" in got[3]
    assert set(got[0]) == {"valid?", "engine", "dedupe", "closure"}


def test_exact_bucketing_matches_tier_and_reference():
    """The reference's test_check_batch_exact_bucketing_matches_tier
    shapes: "exact" equals "tier", both equal the reference, results in
    input order; the bucket flag JEPSEN_TPU_TORCH_BUCKET and its bogus
    values."""
    hs = [ref_histories.rand_register_history(
        n_ops=40, n_processes=3 + (s % 4), crash_p=0.04, seed=500 + s)
        for s in range(8)]
    hs[5] = ref_histories.corrupt_history(hs[5], seed=3, n_corruptions=2)
    tier = _same_as_reference(ref_models.CASRegister(), hs)
    exact = _same_as_reference(ref_models.CASRegister(), hs, bucket="exact")
    assert _strip(tier) == _strip(exact)
    assert exact[5]["valid?"] is False
    pre = [ref_enc.encode(ref_models.CASRegister(), h) for h in hs]

    def groups(b):
        out = {}
        for i, e in enumerate(pre):
            out.setdefault(engine.bucket_key(e.n_slots, b), set()).add(i)
        return sorted(map(sorted, out.values()))

    assert groups("exact") != groups("tier")
    for n in range(1, 26):
        for b in ("tier", "exact"):
            assert engine.bucket_key(n, b) == ref_engine.bucket_key(n, b)
    port = [_port_history(h) for h in hs]
    with pytest.raises(ValueError, match="bucket"):
        engine.check_batch(models.CASRegister(), [], bucket="bogus")
    with mock.patch.dict(os.environ, {"JEPSEN_TPU_TORCH_BUCKET": "exact"}):
        env = engine.check_batch(models.CASRegister(), port[:2], device=CPU)
        assert engine._resolve_bucket(None) == "exact"
    assert _strip(env) == _strip(tier[:2])
    with mock.patch.dict(os.environ, {"JEPSEN_TPU_TORCH_BUCKET": "bogus"}), \
            pytest.raises(ValueError, match="bucket"):
        engine.check_batch(models.CASRegister(), [])
    # the reference's flag does not steer the port
    with mock.patch.dict(os.environ, {"JEPSEN_TPU_BUCKET": "bogus"}):
        assert engine._resolve_bucket(None) == "tier"
    assert engine.check_batch_encoded(models.CASRegister(), []) == []


def test_bench_smoke_shape_matches_reference():
    """The bench's multi-key shape at BENCH_SMOKE size: 8 keys x 40 ops,
    14 processes, seeds 2024 + k."""
    got = _same_as_reference(ref_models.CASRegister(), _bench_keys(8, 40))
    assert all(r["valid?"] is True for r in got)


def test_corrupted_keys_match_reference():
    hs = _bench_keys(6, 60, seed=77, n_processes=5)
    hs = [ref_histories.corrupt_history(h, seed=k) if k % 2 == 0 else h
          for k, h in enumerate(hs)]
    got = _same_as_reference(ref_models.CASRegister(), hs)
    assert [r["valid?"] for r in got].count(False) >= 2


def test_unequal_lengths_leave_every_key_as_alone():
    """Keys of 8 to 90 returns in one bucket: pad events (run = False)
    change nothing, so each key's verdict, failing op and event equal
    its single-key check's and the reference's batch."""
    hs = [ref_histories.rand_register_history(
        n_ops=n, n_processes=3, crash_p=0.02, seed=40 + n)
        for n in (10, 90, 40, 70)]
    hs[1] = ref_histories.corrupt_history(hs[1], seed=2)
    hs[2] = ref_histories.corrupt_history(hs[2], seed=5)
    pre = [ref_enc.encode(ref_models.CASRegister(), h) for h in hs]
    assert len({e.n_returns for e in pre}) == 4
    assert len({engine.bucket_key(e.n_slots, "tier") for e in pre}) == 1
    got = _same_as_reference(ref_models.CASRegister(), hs)
    for e, r in zip(pre, got):
        alone = bd.check_encoded_bitdense(_to_port(e), device=CPU)
        assert {k: alone.get(k) for k in ("valid?", "op", "fail-event")} \
            == {k: r.get(k) for k in ("valid?", "op", "fail-event")}


def test_zero_return_keys_get_the_batch_schema():
    """A batch in which no key returns (R = 0), and a 0-return key among
    others: each gets the batch's schema, not the single check's early
    {"valid?": True, "engine": "bitdense"}."""
    crashed = RefHistory.wrap([
        {"process": 0, "type": "invoke", "f": "write", "value": 1},
        {"process": 0, "type": "info", "f": "write", "value": 1}]).index()
    empty = RefHistory()
    got = _same_as_reference(ref_models.CASRegister(), [crashed, empty])
    assert got[0] == {"valid?": True, "engine": "bitdense",
                      "dedupe": "dense", "closure": "torch"}
    mixed = _same_as_reference(ref_models.CASRegister(),
                               [crashed] + _bench_keys(2, 30, n_processes=3))
    assert set(mixed[0]) == {"valid?", "engine", "dedupe", "closure"}


def test_one_key():
    h = ref_histories.corrupt_history(_bench_keys(1, 50, n_processes=4)[0],
                                      seed=1)
    got = _same_as_reference(ref_models.CASRegister(), [h])
    assert got[0]["valid?"] is False


FAMILIES = {
    # name: (generator, kwargs, model) — tests/test_torch_bitdense.py's
    "register": ("rand_register_history", {"n_ops": 120},
                 ref_models.CASRegister),
    "register-crashy": ("rand_register_history",
                        {"n_ops": 150, "crash_p": 0.12},
                        ref_models.CASRegister),
    "gset": ("rand_gset_history", {"n_ops": 80, "n_elements": 6},
             ref_models.GSet),
    "uqueue": ("rand_queue_history",
               {"n_ops": 20, "n_values": 2, "deq_p": 0.45},
               ref_models.UnorderedQueue),
    "fifo": ("rand_fifo_history", {"n_ops": 16, "n_values": 2, "deq_p": 0.6},
             ref_models.FIFOQueue),
    "adversarial": ("adversarial_register_history",
                    {"n_ops": 160, "k_crashed": 7}, ref_models.CASRegister),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_every_dense_family_matches_reference(name):
    gen, kw, model = FAMILIES[name]
    hs = [getattr(ref_histories, gen)(seed=s, **kw) for s in (3, 4, 5)]
    hs[1] = ref_histories.corrupt_history(hs[1], seed=4)
    pre = [ref_enc.encode(model(), h) for h in hs]
    assert all(bd.fits_bitdense(e.n_states, e.n_slots) for e in pre)
    _same_as_reference(model(), hs)


def test_bucket_past_the_dense_engine_raises():
    """26 concurrent reads need C = 26 > 24: that bucket is past the
    dense engine. It used to raise NotImplementedError; since the sparse
    batch (ROADMAP Queue 1 item 7) it runs there, beside the narrow key's
    dense bucket, with the reference's batch results (every field but
    `closure`), in input order. No read can linearize (nothing was
    written), so the key fails at its first return, at the batch's
    default capacity of 512."""
    ops = [{"process": p, "type": "invoke", "f": "read", "value": None}
           for p in range(26)]
    ops += [{"process": p, "type": "ok", "f": "read", "value": 1000 + p}
            for p in range(26)]
    narrow = _bench_keys(1, 20, n_processes=3)[0]
    wide = RefHistory.wrap(ops).index()
    want = ref_engine.check_batch(ref_models.CASRegister(), [narrow, wide],
                                  dedupe="hash")
    got = engine.check_batch(models.CASRegister(),
                             [_port_history(narrow), _port_history(wide)],
                             device=CPU)
    assert _strip(got) == _strip(want)
    assert got[0]["engine"] == "bitdense" and "engine" not in got[1]
    assert got[1]["valid?"] is False and got[1]["capacity"] == 512


@pytest.mark.parametrize("kw,item", [({"pipeline": True}, "item 8"),
                                     ({"cache": {}}, "item 8"),
                                     ({"pipeline_stats": {}}, "item 8"),
                                     ({"steal": True}, "item 9b")])
def test_unported_executors_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        engine.check_batch(models.CASRegister(), [], device=CPU, **kw)


def test_batch_needs_a_device_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = _port_history(_bench_keys(1, 20, n_processes=3)[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.check_batch(models.CASRegister(), [h])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bd.check_batch_bitdense([engine.enc_mod.encode(
            models.CASRegister(), h)])


# --------------------------------------------------------- the hazards

def test_first_key_sets_the_state_offset_and_step_family():
    """The reference runs every key with encs[0].state_lo and
    encs[0].step_name; so does the port, on keys that disagree."""
    hs = _bench_keys(3, 40, seed=9, n_processes=4)
    hs[2] = ref_histories.corrupt_history(hs[2], seed=1)
    pre = [ref_enc.encode(ref_models.CASRegister(), h) for h in hs]
    pre[1] = dataclasses.replace(pre[1], state_lo=0, step_name="mutex")
    want = ref_bd.check_batch_bitdense(pre)
    got = bd.check_batch_bitdense([_to_port(e) for e in pre], device=CPU)
    assert _strip(got) == _strip(want)
    # the same batch led by the odd key runs every key as mutex steps
    led = [pre[1], pre[0], pre[2]]
    assert _strip(bd.check_batch_bitdense([_to_port(e) for e in led],
                                          device=CPU)) == \
        _strip(ref_bd.check_batch_bitdense(led))


def test_pad_slots_select_nothing_and_c_has_a_floor_of_five():
    hs = [ref_histories.rand_register_history(
        n_ops=30, n_processes=p, crash_p=0.0, seed=p) for p in (1, 2, 3)]
    encs = [_to_port(ref_enc.encode(ref_models.CASRegister(), h))
            for h in hs]
    assert max(e.n_slots for e in encs) < 5
    pend = bd.dispatch_batch_bitdense(encs, device=CPU)
    assert pend.C == 5
    xs, state0, S, C, R = enc.pad_batch(encs, min_slots=5)
    sc = bd._BatchScan(encs, xs, state0, S, C, R, torch.device(CPU))
    sel = bd._compute_sel(sc.step, {k: v[:R] for k, v in sc.xs.items()},
                          sc.states, sc.t_idx, sc.lo)     # [R, K, C, S, S]
    for k, e in enumerate(encs):
        assert not sel[:, k, e.slot_f.shape[1]:].any()
        assert not sel[e.n_returns:, k].any()            # pad events
    assert _strip(pend.finalize()) == _strip(ref_bd.check_batch_bitdense(
        [ref_enc.encode(ref_models.CASRegister(), h) for h in hs]))


def test_sel_chunks_count_the_keys(monkeypatch):
    """sel is built a few event rows at a time: at most SEL_CHUNK_ELEMS
    int32s of [rows, K, C, S, S] at once, K counted."""
    hs = _bench_keys(4, 40, n_processes=4)
    encs = [_to_port(ref_enc.encode(ref_models.CASRegister(), h))
            for h in hs]
    want = bd.check_batch_bitdense(encs, device=CPU)
    xs, _, S, C, R = enc.pad_batch(encs, min_slots=5)
    calls = []
    real = bd._compute_sel

    def counting(step, x, *a):
        calls.append(x["slot_f"].shape[0])
        return real(step, x, *a)

    monkeypatch.setattr(bd, "_compute_sel", counting)
    monkeypatch.setattr(bd, "SEL_CHUNK_ELEMS", 3 * len(encs) * C * S * S)
    assert bd.check_batch_bitdense(encs, device=CPU) == want
    assert calls == [3] * (R // 3) + ([R % 3] if R % 3 else [])


def test_dispatch_then_finalize():
    hs = _bench_keys(3, 30, n_processes=3)
    encs = [_to_port(ref_enc.encode(ref_models.CASRegister(), h))
            for h in hs]
    pend = bd.dispatch_batch_bitdense(encs, device=CPU)
    assert (pend.S, pend.C, pend.R) == (
        max(e.n_states for e in encs), max(5, max(e.n_slots for e in encs)),
        max(e.n_returns for e in encs))
    rs = pend.finalize()
    assert pend.finalize() is rs
    assert _strip(rs) == _strip(bd.check_batch_bitdense(encs, device=CPU))
    # pad event rows and pad states past every key's own change nothing
    xs, state0, S, C, R = enc.pad_batch(encs, min_slots=5, min_states=8,
                                        min_returns=40)
    assert (S, R) == (8, 40) and C == pend.C
    sc = bd._BatchScan(encs, xs, state0, S, C, R, torch.device(CPU)).run()
    assert torch.equal(sc.B[:, :pend.S], pend._scan.B)
    assert not sc.B[:, pend.S:].any()
    assert torch.equal(sc.ok, pend._scan.ok)
    assert torch.equal(sc.fail_r, pend._scan.fail_r)
    assert bd.check_batch_bitdense([]) == []


# -------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,C", [(6, 15), (22, 17), (6, 7), (40, 12)])
def test_cuda_batched_k1_matches_plain_in_every_layout(S, C):
    """One row of the batched scan (the closure, then each key's filter
    on its own slot) bit for bit against its plain version, in every
    layout, two keys not running."""
    dev = _cuda()
    rng = np.random.default_rng(S + C)
    sel, B = _rand_batch(rng, 5, S, C, density=0.15)
    run = torch.tensor([True, False, True, True, False])
    slot = torch.tensor([[0, 1, C - 1, 5 % C, C // 2]], dtype=torch.int32)
    real = torch.ones((1, 5), dtype=torch.bool)
    carry = (B, run, torch.full((5,), -1, dtype=torch.int32))
    want = [t.clone() for t in carry]
    ck.closure_scan_batch(sel[None], *want, slot, real, 0, C)
    d = [t.to(dev) for t in (sel[None], slot, real)]
    plans = {"gate": None,
             **ck.closure_plans_batch(5, S, C, *ck.card_limits(dev),
                                      ck.sm_count(dev))}
    for name, plan in plans.items():
        got = [t.to(dev) for t in carry]
        before = ck.batch_launches
        ck._launch_scan(d[0], *got, d[1], d[2], 0, C, plan=plan)
        torch.cuda.synchronize()
        assert ck.batch_launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), name


@pytest.mark.cuda
def test_cuda_check_batch_equals_the_cpu():
    dev = _cuda()
    hs = _bench_keys(8, 40)
    hs[2] = ref_histories.corrupt_history(hs[2], seed=2)
    encs = [_to_port(ref_enc.encode(ref_models.CASRegister(), h))
            for h in hs]
    ck.reset_launches()
    got = engine.check_batch_encoded(None, encs, device=dev)
    assert ck.batch_launches == 1        # one chunk of event rows
    assert all(r["closure"] == "cuda" for r in got)
    assert _strip(got) == _strip(engine.check_batch_encoded(None, encs,
                                                            device=CPU))
