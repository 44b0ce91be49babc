"""The port's resumable check (jepsen_tpu_torch.parallel.engine.
check_encoded_resumable, on the CPU with the plain closures) against the
reference's (jepsen_tpu.parallel.engine.check_encoded_resumable) on the
identical encoded input: the result and every checkpoint it hands out,
array for array, for the register, queue and set families, clean and
corrupted, at checkpoint_every 1, 7 and all events, over both dedupes,
packed rows and search stats. Also capacity growth inside a chunk, the
"unknown" verdict past max_capacity, the .npz format both ways (either
package resumes the other's checkpoint), v1 files, the digest and model
guards, the history digest, the row packing, and a device fault in a
chunk, which surfaces with the checkpoint a resume continues from."""

import numpy as np
import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu_torch.parallel import engine, sparse
from test_torch_sparse import _to_port
from torch_jax_cache import release_compiled_programs  # noqa: F401

CPU = "cpu"
KEYS = ("valid?", "fail-event", "op", "max-frontier", "capacity",
        "configs-stepped", "explored", "dedupe", "config-pack", "error")
CP_ARRAYS = ("st", "ml", "mh", "live")
CP_FIELDS = ("event_index", "capacity", "step_name", "ok", "fail_r",
             "maxf", "steps_n", "stepped")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAMILIES = {
    "register": (ref_models.CASRegister, lambda: ref_histories
                 .rand_register_history(n_ops=50, n_processes=5, n_values=3,
                                        crash_p=0.05, fail_p=0.05, seed=41)),
    "uqueue": (ref_models.UnorderedQueue, lambda: ref_histories
               .rand_queue_history(n_ops=60, n_processes=5, n_values=3,
                                   crash_p=0.05, seed=3)),
    "fifo": (ref_models.FIFOQueue, lambda: ref_histories.rand_fifo_history(
        n_ops=44, n_processes=4, n_values=3, crash_p=0.04, seed=35)),
    "gset": (ref_models.GSet, lambda: ref_histories.rand_gset_history(
        n_ops=40, n_processes=4, n_elements=8, crash_p=0.05, seed=33)),
}

# a register history whose frontier outgrows capacity 64 (to 1,024)
GROWTH = (ref_models.CASRegister, lambda: ref_histories
          .rand_register_history(n_ops=60, n_processes=5, n_values=3,
                                 crash_p=0.06, seed=31))

# (dedupe, config_pack, search_stats), taken in turn by the cases
VARIANTS = (("hash", False, True), ("sort", True, False),
            ("hash", True, True), ("sort", False, True))


def _encoded(family, corrupt=False):
    Model, gen = GROWTH if family == "growth" else FAMILIES[family]
    h = gen()
    if corrupt:
        h = ref_histories.corrupt_history(h, seed=5)
    e = ref_enc.encode(Model(), h)
    return e, _to_port(e)


def _same_cp(a, b):
    for f in CP_ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in CP_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def _same_result(want, got):
    assert {k: want.get(k) for k in KEYS} == {k: got.get(k) for k in KEYS}
    assert ("stats" in want) == ("stats" in got)
    if "stats" in want:
        assert got["stats"] == want["stats"]
    if "checkpoint" in want:
        _same_cp(want["checkpoint"], got["checkpoint"])


def _both(e, pe, **kw):
    """Both packages' resumable checks with their checkpoints."""
    rc, pc = [], []
    want = ref_engine.check_encoded_resumable(e, checkpoint_cb=rc.append,
                                              **kw)
    got = engine.check_encoded_resumable(pe, checkpoint_cb=pc.append,
                                         device=CPU, **kw)
    return want, got, rc, pc


CASES = [(f, c, every, VARIANTS[i % len(VARIANTS)])
         for i, (f, c, every) in enumerate(
             (f, c, every) for f in FAMILIES for c in (False, True)
             for every in (1, 7, 1000))]


@pytest.mark.parametrize(
    "family,corrupt,every,variant", CASES,
    ids=[f"{f}-{'corrupt' if c else 'clean'}-every{n}-{v[0]}"
         f"{'-packed' if v[1] else ''}{'-stats' if v[2] else ''}"
         for f, c, n, v in CASES])
def test_resumable_matches_reference(family, corrupt, every, variant):
    dedupe, pack, stats = variant
    e, pe = _encoded(family, corrupt)
    want, got, rc, pc = _both(e, pe, capacity=64, checkpoint_every=every,
                              dedupe=dedupe, config_pack=pack,
                              search_stats=stats)
    _same_result(want, got)
    assert len(pc) == len(rc) >= 1
    for a, b in zip(rc, pc):
        _same_cp(a, b)
    # one checkpoint a chunk, up to the history's end or its failure
    assert pc[-1].event_index == pe.n_returns or not pc[-1].ok
    one = sparse.check_encoded(pe, capacity=64, device=CPU, dedupe=dedupe,
                               config_pack=pack)
    for k in ("valid?", "fail-event", "op", "max-frontier", "capacity",
              "configs-stepped"):
        assert got.get(k) == one.get(k), k


def test_capacity_grows_inside_a_chunk():
    """A chunk that overflows runs again from the checkpoint before it at
    twice the capacity: every checkpoint, the growth's too, is the
    reference's, and the stats count the re-run chunk once."""
    e, pe = _encoded("growth")
    want, got, rc, pc = _both(e, pe, capacity=64, checkpoint_every=5,
                              dedupe="hash", search_stats=True)
    _same_result(want, got)
    caps = [cp.capacity for cp in pc]
    assert caps[0] == 64 and caps[-1] > 64 and caps == sorted(caps)
    assert got["stats"]["capacity-tier"] > 0
    assert got["stats"]["events"] == pe.n_returns
    for a, b in zip(rc, pc):
        _same_cp(a, b)


def test_unknown_past_max_capacity():
    e, pe = _encoded("growth")
    want, got, rc, pc = _both(e, pe, capacity=64, max_capacity=128,
                              checkpoint_every=4, dedupe="hash")
    assert got["valid?"] == "unknown" and got["capacity"] == 128
    _same_result(want, got)
    assert isinstance(got["checkpoint"], engine.FrontierCheckpoint)
    # the unknown result's checkpoint resumes at a higher ceiling to the
    # one-shot verdict
    r = engine.check_encoded_resumable(pe, resume=got["checkpoint"],
                                       checkpoint_every=4, device=CPU,
                                       dedupe="hash")
    one = sparse.check_encoded(pe, capacity=64, device=CPU, dedupe="hash")
    assert (r["valid?"], r["capacity"]) == (one["valid?"], one["capacity"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_checkpoint_resumes_in_the_other_package(writer, tmp_path):
    """A checkpoint one package saved mid-search resumes in the other to
    the one-shot result; the file's arrays are the reference's format."""
    e, pe = _encoded("uqueue", corrupt=False)
    kw = dict(capacity=64, checkpoint_every=9, dedupe="hash")
    cps = []
    if writer == "reference":
        full = ref_engine.check_encoded_resumable(e, checkpoint_cb=cps.append,
                                                  **kw)
        path = cps[1].save(str(tmp_path / "cp"))
        cp = engine.FrontierCheckpoint.load(path)
        got = engine.check_encoded_resumable(pe, resume=cp, device=CPU, **kw)
    else:
        full = engine.check_encoded_resumable(pe, checkpoint_cb=cps.append,
                                              device=CPU, **kw)
        path = cps[1].save(str(tmp_path / "cp"))
        cp = ref_engine.FrontierCheckpoint.load(path)
        got = ref_engine.check_encoded_resumable(e, resume=cp, **kw)
    assert path.endswith(".npz") and cp.event_index == 18
    assert {k: got.get(k) for k in KEYS} == {k: full.get(k) for k in KEYS}
    with np.load(path) as z:
        assert sorted(z.files) == ["history_digest", "live", "meta", "mh",
                                   "ml", "st", "step_name"]
        assert (z["st"].dtype, z["ml"].dtype, z["mh"].dtype,
                z["live"].dtype, z["meta"].dtype, z["meta"].shape) == (
            np.int32, np.uint32, np.uint32, np.bool_, np.int64, (7,))


def test_v1_meta_loads_with_stepped_zero(tmp_path):
    e, pe = _encoded("gset")
    cp = engine.FrontierCheckpoint.fresh(pe, 64)
    path = str(tmp_path / "v1.npz")
    np.savez_compressed(
        path, st=cp.st, ml=cp.ml, mh=cp.mh, live=cp.live,
        meta=np.array([0, 64, 1, -1, 1, 0], np.int64),
        step_name=np.array(cp.step_name),
        history_digest=np.array(cp.history_digest))
    got = engine.FrontierCheckpoint.load(path)
    assert got.stepped == 0 and got.capacity == 64 and got.ok
    r = engine.check_encoded_resumable(pe, resume=got, device=CPU)
    assert r["valid?"] == sparse.check_encoded(pe, device=CPU)["valid?"]


def test_wrong_history_or_model_raises():
    e, pe = _encoded("uqueue")
    _, other = _encoded("uqueue", corrupt=True)
    cp = engine.FrontierCheckpoint.fresh(other, 64)
    with pytest.raises(ValueError, match="different history"):
        engine.check_encoded_resumable(pe, resume=cp, device=CPU)
    cp = engine.FrontierCheckpoint.fresh(pe, 64)
    cp.step_name = "fifo"
    with pytest.raises(ValueError, match="different model"):
        engine.check_encoded_resumable(pe, resume=cp, device=CPU)
    with pytest.raises(ValueError, match="checkpoint_every"):
        engine.check_encoded_resumable(pe, checkpoint_every=0, device=CPU)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_history_digest_matches_reference(family):
    for corrupt in (False, True):
        e, pe = _encoded(family, corrupt)
        assert engine.history_digest(pe) == ref_engine.history_digest(e)
        ref_cp = ref_engine.FrontierCheckpoint.fresh(e, 100)
        _same_cp(ref_cp, engine.FrontierCheckpoint.fresh(pe, 100))


@pytest.mark.parametrize("family", ["register", "gset", "fifo"])
def test_row_packing_matches_reference(family):
    """pack_rows_np / unpack_rows_np on a checkpoint's rows, and the carry
    a packed scan starts from, against the reference's."""
    e, pe = _encoded(family)
    want = ref_engine.check_encoded_resumable(e, capacity=64,
                                              checkpoint_every=1000)
    cps = []
    ref_engine.check_encoded_resumable(e, capacity=64, checkpoint_every=3,
                                       checkpoint_cb=cps.append)
    assert want["valid?"] in (True, False)
    cp = cps[len(cps) // 2]
    pack = sparse.pack_spec_for(pe)
    assert pack == ref_engine.pack_spec_for(e)
    C = pe.slot_f.shape[1]
    lanes = sparse.pack_rows_np(pack, C, cp.st, cp.ml, cp.mh)
    ref_lanes = ref_engine.pack_rows_np(pack, C, cp.st, cp.ml, cp.mh)
    assert len(lanes) == len(ref_lanes) == sparse.pack_lanes(pack, C)
    for a, b in zip(lanes, ref_lanes):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    live = cp.live
    back = sparse.unpack_rows_np(pack, C, lanes)
    for a, b in zip(back, (cp.st, cp.ml, cp.mh)):
        assert np.array_equal(a[live], b[live])
    port_cp = engine.FrontierCheckpoint(
        cp.event_index, cp.capacity, cp.step_name, cp.history_digest,
        cp.st, cp.ml, cp.mh, cp.live, cp.ok, cp.fail_r, cp.maxf,
        cp.steps_n, cp.stepped)
    carry = port_cp.carry(CPU, pack, C)
    assert len(carry) == len(lanes) + 7
    for a, b in zip(carry, lanes):
        assert np.array_equal(a.numpy().view(np.uint32), b)
    fields = engine.carry_fields_np(carry, pack, C)
    for a, b in zip(fields[:3], back):
        assert np.array_equal(a, b)


def test_grown_pads_the_frontier():
    _, pe = _encoded("uqueue")
    cp = engine.FrontierCheckpoint.fresh(pe, 64)
    g = cp.grown(256)
    assert g.capacity == 256 and len(g.st) == 256 and g.live.sum() == 1
    assert (g.st.dtype, g.ml.dtype, g.live.dtype) == (np.int32, np.uint32,
                                                      np.bool_)
    with pytest.raises(ValueError, match="shrink"):
        g.grown(128)


def test_a_device_fault_surfaces_with_its_checkpoint(monkeypatch):
    """A fault inside a chunk is not retried and not resumed on the host:
    it raises, carrying the checkpoint before the chunk, from which a
    resume gives the full verdict."""
    e, pe = _encoded("uqueue", corrupt=True)
    one = engine.check_encoded_resumable(pe, capacity=64, checkpoint_every=6,
                                         device=CPU)
    real = sparse._Scan.run_range
    calls = {"n": 0}

    def flaky(self, lo, hi):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(self, lo, hi)

    monkeypatch.setattr(sparse._Scan, "run_range", flaky)
    with pytest.raises(RuntimeError, match="illegal memory") as info:
        engine.check_encoded_resumable(pe, capacity=64, checkpoint_every=6,
                                       device=CPU)
    cp = info.value.checkpoint
    assert cp.event_index == 12 and cp.history_digest == \
        engine.history_digest(pe)
    monkeypatch.setattr(sparse._Scan, "run_range", real)
    got = engine.check_encoded_resumable(pe, resume=cp, checkpoint_every=6,
                                         device=CPU)
    assert {k: got.get(k) for k in KEYS} == {k: one.get(k) for k in KEYS}


def test_empty_history_and_the_card_default(monkeypatch):
    e, pe = _encoded("uqueue")
    empty = engine.enc_mod.encode(engine.model_ns.UnorderedQueue(), [])
    assert engine.check_encoded_resumable(empty, device=CPU) == {
        "valid?": True, "max-frontier": 0, "capacity": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.check_encoded_resumable(pe)
