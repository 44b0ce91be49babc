"""The port's service WAL, checkpoint store, tenancy and flags
(jepsen_tpu_torch.serve.wal / tenancy, jepsen_tpu_torch.envflags) and
its EDN writer, against the reference's (jepsen_tpu.serve).

Host only: the WAL round trip, duplicate drop, rotation and
auto-rotation, sizes, the torn tail in one segment and across segments,
WALError on a hole before a segment's tail, epochs and fences (an
unreadable fence counting as fenced), delta ids, the tenant grammar and
its errors, pending_bound and the quantum, the flags' validation, and
edn.dumps / op_to_edn_str on the golden corpus's ops. Then the
interchange: the same appends give the same files, byte for byte, in
both packages, and a WAL directory with its checkpoint pair written by
either package's CheckerService replays in the other's to the same
results, the thaw resuming from the other's frozen event."""

import json
import os
import pathlib
import shutil

import pytest
import torch

from jepsen_tpu import edn as ref_edn
from jepsen_tpu import history as ref_history
from jepsen_tpu_torch import edn, envflags
from jepsen_tpu_torch.envflags import EnvFlagError
from jepsen_tpu_torch.history import Op, op_from_edn, op_to_edn_str
from jepsen_tpu_torch.serve import (DeltaWAL, Tenant, TenantSpecError,
                                    WALError, parse_tenants,
                                    resolve_tenants, tenancy)
from jepsen_tpu_torch.serve import service as svc_mod
from jepsen_tpu_torch.serve.stdio import jsonable
from torch_jax_cache import release_compiled_programs  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden"
OPS = [Op({"type": "invoke", "process": 0, "f": "write", "value": 1}),
       Op({"type": "ok", "process": 0, "f": "write", "value": 1})]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(root) -> dict:
    return {name: pathlib.Path(root, name).read_bytes()
            for name in sorted(os.listdir(root))
            if os.path.isfile(os.path.join(root, name))}


# ------------------------------------------------------------ the WAL


def test_wal_roundtrip_and_duplicate_drop(tmp_path):
    w = DeltaWAL(str(tmp_path))
    w.append(("reg", 7), 1, OPS)
    w.append(("reg", 7), 2, OPS)
    w.append(("reg", 7), 2, OPS)   # duplicate line: replay drops it
    w.close()
    w2 = DeltaWAL(str(tmp_path))
    deltas = w2.replay(("reg", 7))
    assert [s for s, _ in deltas] == [1, 2]
    got = deltas[0][1]
    assert got[0]["type"] == "invoke" and got[0]["value"] == 1
    assert got == OPS
    assert w2.keys() == [("reg", 7)]
    assert w2.last_seq(("reg", 7)) == 2 and w2.last_seq("nope") == 0


def test_wal_append_after_torn_tail_repairs_first(tmp_path):
    """A restart that appends after a mid-write kill truncates the torn
    trailing line first: the new record never concatenates onto it."""
    w = DeltaWAL(str(tmp_path))
    w.append("k", 1, OPS)
    w.close()
    fname = [n for n in os.listdir(str(tmp_path)) if n.endswith(".wal")][0]
    with open(os.path.join(str(tmp_path), fname), "a") as fh:
        fh.write('{"seq": 2, "ops": ["torn')   # no newline: mid-write
    assert [s for s, _ in DeltaWAL(str(tmp_path)).replay("k")] == [1]
    w2 = DeltaWAL(str(tmp_path))
    w2.append("k", 2, OPS)   # must repair, not concatenate
    w2.close()
    assert [s for s, _ in DeltaWAL(str(tmp_path)).replay("k")] == [1, 2]


def test_wal_rotate_segments_replay_and_sizes(tmp_path):
    w = DeltaWAL(str(tmp_path))
    w.append("k", 1, OPS)
    w.rotate("k")
    w.append("k", 2, OPS)
    w.append("k", 3, OPS)
    w.close()
    w2 = DeltaWAL(str(tmp_path))
    segs = w2.segments("k")
    assert len(segs) == 2 and segs[0].endswith(".wal") \
        and segs[1].endswith(".wal.1")
    assert [s for s, _ in w2.replay("k")] == [1, 2, 3]
    assert w2.keys() == ["k"]
    assert w2.size_bytes("k") == sum(os.path.getsize(p) for p in segs)
    # appends continue into the newest segment, never a sealed one
    w2.append("k", 4, OPS)
    assert [s for s, _ in w2.replay("k")] == [1, 2, 3, 4]
    assert os.path.getsize(segs[0]) == w2.size_bytes("k") \
        - os.path.getsize(segs[1])
    assert w2.size_bytes("nope") == 0
    w2.close()
    # rotating a never-written key is a no-op, not an orphaned file
    w3 = DeltaWAL(str(tmp_path / "fresh"))
    w3.rotate("nope")
    w3.append("nope", 1, OPS)
    assert len(w3.segments("nope")) == 1
    w3.close()


def test_wal_auto_rotation_by_size(tmp_path, monkeypatch):
    w = DeltaWAL(str(tmp_path), segment_bytes=150)
    for seq in range(1, 6):
        w.append("k", seq, OPS)
    w.close()
    assert len(DeltaWAL(str(tmp_path)).segments("k")) >= 2
    assert [s for s, _ in DeltaWAL(str(tmp_path)).replay("k")] \
        == [1, 2, 3, 4, 5]
    # the flag rotates too, and is validated like every other flag
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_WAL_SEGMENT_BYTES", "150")
    assert DeltaWAL(str(tmp_path / "y")).segment_bytes == 150
    for bad in ("nope", "-1"):
        monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_WAL_SEGMENT_BYTES", bad)
        with pytest.raises(EnvFlagError,
                           match="JEPSEN_TPU_TORCH_SERVE_WAL_SEGMENT_BYTES"):
            DeltaWAL(str(tmp_path / "x"))


def test_wal_torn_tail_tolerated_across_segment_boundary(tmp_path):
    """A torn trailing line in a NON-final segment (a kill mid-write,
    then a restart that rotated) is an unacknowledged kill and is
    tolerated; a corrupt line BEFORE any segment's tail is a WALError."""
    w = DeltaWAL(str(tmp_path))
    w.append("k", 1, OPS)
    w.close()
    base = DeltaWAL(str(tmp_path)).segments("k")[0]
    with open(base, "a") as fh:
        fh.write('{"seq": 2, "ops": ["torn')   # mid-write kill
    with open(base + ".1", "w") as fh:
        fh.write(json.dumps({"key": '"k"', "segment": 1}) + "\n")
        fh.write(json.dumps(
            {"seq": 3, "ops": [op_to_edn_str(o) for o in OPS]}) + "\n")
    assert [s for s, _ in DeltaWAL(str(tmp_path)).replay("k")] == [1, 3]
    with open(base + ".1", "a") as fh:
        fh.write(json.dumps(
            {"seq": 4, "ops": [op_to_edn_str(o) for o in OPS]}) + "\n")
    lines = open(base + ".1").read().splitlines()
    lines[1] = '{"seq": 3, "ops": ["broken'
    with open(base + ".1", "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with pytest.raises(WALError, match="not the tail"):
        DeltaWAL(str(tmp_path)).replay("k")


def test_wal_hole_before_the_tail_raises(tmp_path):
    w = DeltaWAL(str(tmp_path))
    for seq in (1, 2, 3):
        w.append("k", seq, OPS)
    w.close()
    seg = DeltaWAL(str(tmp_path)).segments("k")[0]
    lines = open(seg).read().splitlines()
    lines[2] = lines[2][:10]   # seq 2's record cut mid-line
    with open(seg, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with pytest.raises(WALError, match="corrupt WAL line 3"):
        DeltaWAL(str(tmp_path)).replay("k")
    # an unreadable header is acknowledged data too
    with open(seg, "w") as fh:
        fh.write("not json\n")
    with pytest.raises(WALError, match="unreadable WAL header"):
        DeltaWAL(str(tmp_path)).keys()


def test_wal_epochs_and_fences(tmp_path):
    w = DeltaWAL(str(tmp_path))
    assert w.epoch("k") == 1 and w.fence("k") is None
    w.append("k", 1, OPS, tenant="ten-a")
    assert w.header("k") == {"key": '"k"', "segment": 0, "epoch": 1,
                             "tenant": "ten-a"}
    w.set_epoch("k", 3)
    assert w.epoch("k") == 3 and w.header_epoch("k") == 1
    w.rotate("k")
    w.touch("k")   # the bump lands in the fresh segment's header now
    assert DeltaWAL(str(tmp_path)).header_epoch("k") == 3
    # a rotation inherits the newest header's epoch
    w.rotate("k")
    w.append("k", 2, OPS)
    w.close()
    w2 = DeltaWAL(str(tmp_path))
    assert w2.header_epoch("k") == 3 and len(w2.segments("k")) == 3
    assert [s for s, _ in w2.replay("k")] == [1, 2]
    doc = w2.write_fence("k", 4, owner="replica-b")
    assert doc == {"key": '"k"', "epoch": 4, "owner": "replica-b"}
    assert w2.fence("k") == doc
    w2.clear_fence("k")
    assert w2.fence("k") is None
    w2.clear_fence("k")   # clearing twice is fine
    # an unreadable fence fails SAFE: fenced at an unbeatable epoch
    with open(os.path.join(str(tmp_path), os.path.basename(
            w2.segments("k")[0])[:-4] + ".fence"), "w") as fh:
        fh.write("{garbage")
    f = w2.fence("k")
    assert f["epoch"] == 1 << 62 and "unreadable fence" in f["error"]
    w2.close()


def test_wal_delta_ids_and_records_with_ids(tmp_path):
    """Records without an id get the stable stand-in wal-<digest>-<seq>;
    a record stamped with one (the reference's traced WAL) keeps it, and
    replay ignores the field."""
    w = DeltaWAL(str(tmp_path))
    w.append("k", 1, OPS)
    w.append("k", 2, OPS, delta_id="abc123")
    w.close()
    seg = DeltaWAL(str(tmp_path)).segments("k")[0]
    lines = open(seg).read().splitlines()
    assert '"id"' not in lines[1] and json.loads(lines[2])["id"] == "abc123"
    w2 = DeltaWAL(str(tmp_path))
    digest = os.path.basename(seg)[:-4].rsplit("_", 1)[-1]
    ids = {1: f"wal-{digest}-1", 2: "abc123"}
    deltas, got = w2.replay_with_ids("k")
    assert got == ids and w2.delta_ids("k") == ids
    assert deltas == w2.replay("k") and [s for s, _ in deltas] == [1, 2]


# --------------------------------------------------- tenancy and flags


def test_tenant_spec_grammar(monkeypatch):
    ts = parse_tenants("alice:token=aa:weight=3:ops=100:keys=2:wal=64,"
                       "bob:token=bb")
    assert ts[0] == Tenant("alice", token="aa", weight=3,
                           max_pending_ops=100, max_keys=2,
                           max_wal_bytes=64)
    assert ts[1] == Tenant("bob", token="bb")
    monkeypatch.delenv("JEPSEN_TPU_TORCH_TENANTS", raising=False)
    assert resolve_tenants() is None
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TENANTS", "x:nope=1")
    with pytest.raises(EnvFlagError):
        resolve_tenants()
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TENANTS", "x:token=t:weight=2,y")
    tt = resolve_tenants()
    assert tt.names() == ["x", "y"] and tt.by_token("t").name == "x"
    assert len(tt) == 2 and tt.get("z") is None
    # the quota defaults come from the port's flags
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TENANT_KEYS", "5")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TENANT_WAL_BYTES", "99")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TENANT_OPS", "7")
    assert parse_tenants("z")[0] == Tenant("z", max_pending_ops=7,
                                           max_keys=5, max_wal_bytes=99)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TENANT_KEYS", "-1")
    with pytest.raises(EnvFlagError, match="JEPSEN_TPU_TORCH_TENANT_KEYS"):
        parse_tenants("z")


@pytest.mark.parametrize("bad", [
    "al ice:token=t", "a:bogus=1", "a:weight=0", "a:ops=x", "a:token=",
    "a,a", "a:token=t,b:token=t", "a:keys=-2", "a:weight"])
def test_tenant_spec_errors_are_the_references(bad):
    from jepsen_tpu.serve import tenancy as ref_tenancy
    with pytest.raises(ref_tenancy.TenantSpecError) as want:
        ref_tenancy.parse_tenants(bad)
    with pytest.raises(TenantSpecError) as got:
        parse_tenants(bad)
    assert isinstance(got.value, EnvFlagError)
    assert str(got.value) == str(want.value).replace(
        "JEPSEN_TPU_TENANTS", "JEPSEN_TPU_TORCH_TENANTS")


def test_tenant_table_pending_bound_and_quantum(monkeypatch):
    from jepsen_tpu.serve import tenancy as ref_tenancy
    spec = "x:token=t:weight=2,y,z:ops=17:weight=5"
    tt = tenancy.TenantTable(parse_tenants(spec))
    rt = ref_tenancy.TenantTable(ref_tenancy.parse_tenants(spec))
    assert tt.total_weight == rt.total_weight == 8
    for budget in (1, 90, 1000):
        for name in ("x", "y", "z"):
            assert tt.pending_bound(name, budget) \
                == rt.pending_bound(name, budget)
    assert tt.pending_bound("x", 90) == 22 and tt.pending_bound("z", 90) == 17
    with pytest.raises(TenantSpecError):
        tenancy.TenantTable([])
    with pytest.raises(TenantSpecError, match="reuses"):
        tenancy.TenantTable([Tenant("a", token="t"), Tenant("b", token="t")])
    monkeypatch.delenv("JEPSEN_TPU_TORCH_TENANT_QUANTUM", raising=False)
    assert tenancy.resolve_quantum() == 512
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TENANT_QUANTUM", "64")
    assert tenancy.resolve_quantum() == 64
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TENANT_QUANTUM", "0")
    with pytest.raises(EnvFlagError,
                       match="JEPSEN_TPU_TORCH_TENANT_QUANTUM"):
        tenancy.resolve_quantum()


@pytest.mark.parametrize("flag,value,resolve", [
    ("JEPSEN_TPU_TORCH_SERVE_QUEUE", "banana",
     lambda: svc_mod._resolve_per_key_queue(None)),
    ("JEPSEN_TPU_TORCH_SERVE_QUEUE", "0",
     lambda: svc_mod._resolve_per_key_queue(None)),
    ("JEPSEN_TPU_TORCH_SERVE_GLOBAL", "0",
     lambda: svc_mod._resolve_global_bound(None)),
    ("JEPSEN_TPU_TORCH_SERVE_HIGH_WATER", "lots",
     lambda: svc_mod._resolve_high_water(None, 100)),
    ("JEPSEN_TPU_TORCH_SERVE_EVICT_SECS", "-2",
     lambda: svc_mod._resolve_evict_secs(None)),
    ("JEPSEN_TPU_TORCH_SERVE_EVICT_SECS", "inf",
     lambda: svc_mod._resolve_evict_secs(None)),
    ("JEPSEN_TPU_TORCH_SERVE_WAL", " ", svc_mod.default_wal_dir),
])
def test_serve_env_flags_validated(monkeypatch, flag, value, resolve):
    """A malformed flag raises, naming the flag (the reference's
    test_serve_env_flags_validated, on the port's flags)."""
    monkeypatch.setenv(flag, value)
    with pytest.raises(EnvFlagError, match=flag):
        resolve()


def test_serve_env_flag_values(monkeypatch):
    for flag in ("JEPSEN_TPU_TORCH_SERVE_QUEUE",
                 "JEPSEN_TPU_TORCH_SERVE_GLOBAL",
                 "JEPSEN_TPU_TORCH_SERVE_HIGH_WATER",
                 "JEPSEN_TPU_TORCH_SERVE_EVICT_SECS",
                 "JEPSEN_TPU_TORCH_SERVE_WAL"):
        monkeypatch.delenv(flag, raising=False)
    assert svc_mod._resolve_per_key_queue(None) == 64
    assert svc_mod._resolve_global_bound(None) == 65536
    assert svc_mod._resolve_high_water(None, 100) == 75
    assert svc_mod._resolve_evict_secs(None) == 300.0
    assert svc_mod.default_wal_dir() is None
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_QUEUE", "3")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_GLOBAL", "40")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_HIGH_WATER", "0")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_EVICT_SECS", "0.5")
    assert svc_mod._resolve_per_key_queue(None) == 3
    assert svc_mod._resolve_global_bound(None) == 40
    assert svc_mod._resolve_high_water(None, 40) == 0
    assert svc_mod._resolve_evict_secs(None) == 0.5
    assert svc_mod._resolve_per_key_queue(9) == 9   # an argument wins
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_WAL", "1")
    assert svc_mod.default_wal_dir() == os.path.join("store", "serve_wal")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_WAL", "/some/dir")
    assert svc_mod.default_wal_dir() == "/some/dir"
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_WAL", "0")
    assert svc_mod.default_wal_dir() is None


def test_envflags_accessors(monkeypatch):
    with pytest.raises(EnvFlagError, match="not a JEPSEN_TPU_TORCH_"):
        envflags.env_raw("JEPSEN_TPU_SERVE_QUEUE")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_T", "2.5")
    assert envflags.env_float("JEPSEN_TPU_TORCH_T") == 2.5
    with pytest.raises(EnvFlagError, match="JEPSEN_TPU_TORCH_T"):
        envflags.env_int("JEPSEN_TPU_TORCH_T")
    with pytest.raises(EnvFlagError, match="must be >= 3"):
        envflags.env_float("JEPSEN_TPU_TORCH_T", min_value=3)
    monkeypatch.setenv("JEPSEN_TPU_TORCH_T", "nan")
    with pytest.raises(EnvFlagError, match="finite"):
        envflags.env_float("JEPSEN_TPU_TORCH_T")
    monkeypatch.delenv("JEPSEN_TPU_TORCH_T")
    assert envflags.env_int("JEPSEN_TPU_TORCH_T", default=4) == 4
    assert envflags.env_path("JEPSEN_TPU_TORCH_T") is None


# ------------------------------------------------------ the EDN writer


@pytest.mark.parametrize("path", sorted(GOLDEN.glob("*.edn")),
                         ids=lambda p: p.name)
def test_edn_writer_matches_reference_on_the_golden_corpus(path):
    text = path.read_text()
    ref_forms = ref_edn.loads_all(text)
    forms = edn.loads_all(text)
    assert len(forms) == len(ref_forms) > 0
    for f, rf in zip(forms, ref_forms):
        assert edn.dumps(f) == ref_edn.dumps(rf)
        ro = ref_history.op_from_edn(rf)
        assert op_to_edn_str(op_from_edn(f)) \
            == ref_history.op_to_edn_str(ro)
        # an op the port built from the reference's dict writes the same
        assert op_to_edn_str(Op(dict(ro))) == ref_history.op_to_edn_str(ro)
    # the keys a service writes into its WAL headers
    for key in ("k", 7, ("reg", 7), None, 2.5, ["a", [1, 2]],
                'quo"te\n', frozenset({1}), {"a": 1}):
        assert edn.dumps(key) == ref_edn.dumps(key)


# ---------------------------------------------------------- interchange


@pytest.mark.parametrize("key", ["k", 42, ("reg", 7)], ids=str)
def test_wal_files_are_the_references_byte_for_byte(tmp_path, key):
    from jepsen_tpu.serve import wal as ref_wal
    files = {}
    for name, W in (("ref", ref_wal.DeltaWAL), ("port", DeltaWAL)):
        root = str(tmp_path / name)
        w = W(root, segment_bytes=300)
        for seq in range(1, 5):
            w.append(key, seq, OPS, tenant="ten-a")
        w.rotate(key)
        w.set_epoch(key, 2)
        w.append(key, 5, OPS)
        w.write_fence(key, 3, owner="b")
        w.close()
        files[name] = _files(root)
    assert files["port"] == files["ref"] and len(files["ref"]) >= 3
    # and each package reads the other's directory
    assert DeltaWAL(str(tmp_path / "ref")).replay(key) \
        == DeltaWAL(str(tmp_path / "port")).replay(key)
    assert ref_wal.DeltaWAL(str(tmp_path / "port")).keys() \
        == DeltaWAL(str(tmp_path / "ref")).keys()


def _register_streams():
    from jepsen_tpu import histories
    h1 = [dict(o) for o in histories.rand_register_history(
        n_ops=48, n_processes=4, n_values=3, crash_p=0.05, seed=1)]
    h2 = [dict(o) for o in histories.corrupt_history(
        histories.rand_register_history(n_ops=48, n_processes=4,
                                        n_values=3, crash_p=0.05, seed=2),
        seed=1, n_corruptions=2)]
    return {"k1": h1, "k2": h2}


def _service(pkg, wal, **kw):
    if pkg == "ref":
        from jepsen_tpu.models import CASRegister
        from jepsen_tpu.serve import CheckerService
    else:
        from jepsen_tpu_torch.models import CASRegister
        from jepsen_tpu_torch.serve import CheckerService
        kw["device"] = "cpu"
    return CheckerService(CASRegister(), wal_dir=wal, capacity=64,
                          dedupe="hash", **kw)


def _clean(r: dict) -> dict:
    """A result on the wire, less the port's route tag."""
    return {k: v for k, v in jsonable(r).items() if k != "closure"}


def _write_and_freeze(pkg, wal, streams) -> dict:
    """Two deltas a key through `pkg`'s service, drained, every key
    frozen (the checkpoint pair): -> each key's meta record."""
    a = _service(pkg, wal)
    metas = {}
    try:
        for d in range(2):
            for k, h in streams.items():
                # one delta a worker batch: the checkpoints a key keeps
                # follow how its deltas were coalesced
                assert "valid?" in a.submit(k, h[d * 16:(d + 1) * 16],
                                            wait=True, timeout=120)
        assert a.drain(timeout=120)
        for k in streams:
            assert a.freeze_key(k)
            metas[k] = json.loads(pathlib.Path(
                a._cps._paths(k)[1]).read_text())
    finally:
        a.close()
    assert all(m["checkpoint"] and m["event_index"] > 0
               for m in metas.values()), metas
    return metas


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_wal_and_checkpoint_pair_replay_in_the_other_package(
        tmp_path, writer, reader):
    """One package's service takes two deltas a key and freezes each key;
    the other's service, started on a copy of that directory, recovers
    every key from the pair and the WAL: the recovered session resumes
    at the frozen event, and its verdicts, then the third delta's and the
    finalize's, equal those of the reader's package restarted on its own
    frozen directory, field for field ("stream" included)."""
    streams = _register_streams()
    metas = _write_and_freeze(writer, str(tmp_path / "written"), streams)
    own = _write_and_freeze(reader, str(tmp_path / "own"), streams)
    assert own == {k: dict(m, checkpoint=own[k]["checkpoint"])
                   for k, m in metas.items()}
    moved = str(tmp_path / "moved")
    shutil.copytree(str(tmp_path / "written"), moved)
    b = _service(reader, moved, start_worker=False)
    clean = _service(reader, str(tmp_path / "own"))
    try:
        for k in streams:
            assert b._keys[k].session.resume_event \
                == metas[k]["event_index"], k
        b.start_worker()
        for k, h in streams.items():
            assert _clean(b.result(k, timeout=120)) \
                == _clean(clean.result(k, timeout=120))
            assert b.submit(k, h[16:32], seq=2)["duplicate"]
            r3 = b.submit(k, h[32:], wait=True, timeout=120)
            assert _clean(r3) \
                == _clean(clean.submit(k, h[32:], wait=True, timeout=120))
            assert _clean(b.finalize(k, timeout=120)) \
                == _clean(clean.finalize(k, timeout=120))
    finally:
        b.close()
        clean.close()


def test_services_write_the_same_files(tmp_path):
    """Both services fed the same deltas and frozen leave the same WAL
    bytes and the same checkpoint pair: the .npz's arrays and the meta
    record (but its path)."""
    import numpy as np
    streams = _register_streams()
    for pkg in ("ref", "port"):
        s = _service(pkg, str(tmp_path / pkg))
        try:
            for d in range(3):
                for k, h in streams.items():
                    s.submit(k, h[d * 16:(d + 1) * 16], wait=True,
                             timeout=120)
            assert s.drain(timeout=120)
            for k in streams:
                assert s.freeze_key(k)
        finally:
            s.close()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    cps = {pkg: str(tmp_path / pkg / "checkpoints") for pkg in ("ref", "port")}
    names = sorted(os.listdir(cps["ref"]))
    assert names == sorted(os.listdir(cps["port"])) and len(names) == 4
    for name in names:
        a, b = (os.path.join(cps[p], name) for p in ("ref", "port"))
        if name.endswith(".json"):
            ma, mb = json.loads(open(a).read()), json.loads(open(b).read())
            assert ma.pop("checkpoint").endswith(name[:-5] + ".npz")
            assert mb.pop("checkpoint").endswith(name[:-5] + ".npz")
            assert ma == mb
        else:
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for f in za.files:
                assert np.array_equal(za[f], zb[f]), f
