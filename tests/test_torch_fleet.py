"""The port's self-healing fleet (jepsen_tpu_torch.serve.fleet, and the
service's ``replicator=``) against the reference's (jepsen_tpu.serve.
fleet), mirroring tests/test_fleet.py's cases. Every scenario runs on
both packages and the answers, mirror bytes, supervisor statuses,
backoff sleeps and counter deltas (``fleet.*``, ``serve.repl_*``,
``serve.ring.*``, ``resilience.breaker.*``) are held equal, exactly:

* flag validation (the reference's defaults, bounds and error texts
  under the ``JEPSEN_TPU_TORCH_`` prefix);
* a service armed without a target, a replicator without a WAL, an
  ``off`` replicator;
* sync replication: a rehome from the mirror with the primary's disk
  gone, equal to a one-shot check; async lag, drain and off; a sync
  failure and no destination answering ``replicated: False``; a torn
  mirror tail; the incremental suffix copy; the mirror fallback never
  re-homing a live survivor's keys;
* the supervisor under a scripted fetch and a fake clock: detect,
  rehome, pin, rejoin, and the bounded retry with backoff — ``status()``
  (breaker snapshots and their ``open_until`` included) after every tick;
* byte interchange: a mirror shipped by either package rehomes into the
  other package's service, to the one-shot verdicts.
"""

import os
import shutil
import time

import pytest
import torch

from torch_fleet_cases import (
    PKGS, both, fleet_delta, one_shot, ops, pin, register_history, service,
    unarmed,
)
from torch_jax_cache import release_compiled_programs  # noqa: F401

from jepsen_tpu_torch import envflags
from jepsen_tpu_torch.serve import fleet
from jepsen_tpu_torch.serve.stdio import jsonable


@pytest.fixture(autouse=True)
def _unarmed(monkeypatch):
    unarmed(monkeypatch)
    yield
    unarmed(monkeypatch)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_repl_flags(monkeypatch):
    for name in ("SERVE_REPL", "FLEET_INTERVAL", "FLEET_THRESHOLD",
                 "FLEET_REHOME_RETRIES"):
        for pre in ("JEPSEN_TPU_", "JEPSEN_TPU_TORCH_"):
            monkeypatch.delenv(pre + name, raising=False)


# ------------------------------------------------- knob validation


def test_repl_mode_and_knob_defaults(monkeypatch, tmp_path):
    assert fleet.resolve_repl_mode() == "off"
    for v in ("async", "sync", "off"):
        monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_REPL", v)
        assert fleet.resolve_repl_mode() == v
    # the supervisor's knobs are constructor arguments with the
    # reference's defaults (its flags unset)
    knobs = {}
    for pkg in ("ref", "port"):
        sup = PKGS[pkg].fleet.FleetSupervisor({"a": None},
                                              {"a": str(tmp_path)})
        knobs[pkg] = (sup.interval, sup.threshold, sup.rehome_retries)
    assert knobs["port"] == knobs["ref"] == (2.0, 3, 3)
    # the reference's own flags are not the port's
    monkeypatch.setenv("JEPSEN_TPU_SERVE_REPL", "sync")
    monkeypatch.delenv("JEPSEN_TPU_TORCH_SERVE_REPL")
    assert fleet.resolve_repl_mode() == "off"


@pytest.mark.parametrize("flag,value,resolve", [
    ("SERVE_REPL", "on", "resolve_repl_mode"),
    ("SERVE_REPL", "SYNC", "resolve_repl_mode"),
    ("SERVE_REPL", "", "resolve_repl_mode"),
])
def test_fleet_flag_errors_equal_reference(monkeypatch, flag, value,
                                           resolve):
    """A malformed flag raises EnvFlagError with the reference's text,
    under the port's prefix."""
    from jepsen_tpu import envflags as ref_envflags
    errs = {}
    for pkg, mod in (("ref", PKGS["ref"].fleet), ("port", fleet)):
        name = PKGS[pkg].FLAG + flag
        monkeypatch.setenv(name, value)
        cls = ref_envflags.EnvFlagError if pkg == "ref" \
            else envflags.EnvFlagError
        with pytest.raises(cls, match=name) as ei:
            getattr(mod, resolve)()
        errs[pkg] = str(ei.value)
        monkeypatch.delenv(name)
    assert errs["port"] == errs["ref"].replace("JEPSEN_TPU_",
                                               "JEPSEN_TPU_TORCH_")


def test_repl_mode_argument_error_equals_reference():
    from jepsen_tpu import envflags as ref_envflags
    with pytest.raises(envflags.EnvFlagError, match="replication") as got:
        fleet.resolve_repl_mode(v="mirror")
    with pytest.raises(ref_envflags.EnvFlagError) as want:
        PKGS["ref"].fleet.resolve_repl_mode(v="mirror")
    assert str(got.value) == str(want.value)


# ------------------------------------------- the service's replicator


def test_service_rejects_armed_repl_without_target(tmp_path, monkeypatch):
    """A configured mode with nothing to ship to protects nothing: loud,
    at construction. A replicator needs a WAL; an ``off`` one is none."""
    monkeypatch.setenv("JEPSEN_TPU_TORCH_SERVE_REPL", "sync")
    with pytest.raises(ValueError, match="JEPSEN_TPU_TORCH_SERVE_REPL"):
        service("port", tmp_path / "w")
    monkeypatch.delenv("JEPSEN_TPU_TORCH_SERVE_REPL")
    repl = fleet.SegmentReplicator(PKGS["port"].WAL(str(tmp_path / "w")),
                                   fleet.constant_dst(str(tmp_path / "m")),
                                   mode="sync")
    with pytest.raises(ValueError, match="WAL-backed"):
        service("port", replicator=repl)
    off = fleet.SegmentReplicator(PKGS["port"].WAL(str(tmp_path / "w")),
                                  fleet.constant_dst(str(tmp_path / "m")),
                                  mode="off")
    svc = service("port", tmp_path / "w", replicator=off)
    try:
        assert svc._repl is None
        assert svc.submit("k", ops("port", register_history()[:6]),
                          timeout=60) == {"accepted": True, "seq": 1,
                                          "key": "k"}
        assert not (tmp_path / "m").exists()
    finally:
        svc.close()


def _replicated(pkg, wal_dir, dst, mode="sync"):
    repl = PKGS[pkg].fleet.SegmentReplicator(
        PKGS[pkg].WAL(str(wal_dir)), PKGS[pkg].fleet.constant_dst(str(dst)),
        mode=mode)
    return service(pkg, wal_dir, replicator=repl)


def _mirror_bytes(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))}


def test_sync_replication_rehome_from_replica(tmp_path):
    """A replica killed mid-stream WITH ITS WAL DIR DELETED is re-homed
    from the sync-shipped mirror on the survivor; the adopted key's
    verdict equals a one-shot check, the delta acked after the last
    rotation included. Mirror bytes, answers and counters equal the
    reference's."""
    h = register_history()

    def scenario(pkg):
        P = PKGS[pkg]
        before = P.obs.registry().snapshot()
        surv_dir = tmp_path / pkg / "surv"
        mirror = surv_dir / P.ring.REPL_SUBDIR
        dead_dir = tmp_path / pkg / "dead"
        svc = _replicated(pkg, dead_dir, mirror)
        out = [svc.submit("repl-key", ops(pkg, h[:14]), timeout=60)]
        svc._wal.rotate("repl-key")
        out.append(svc.submit("repl-key", ops(pkg, h[14:]), timeout=60))
        svc.close(drain=False)
        out.append(_mirror_bytes(mirror))
        shutil.rmtree(dead_dir)
        surv = service(pkg, surv_dir)
        try:
            ring = P.ring.HashRing(["dead", "surv"])
            out += [P.ring.rehome_dead_replica(
                str(dead_dir), ring, "dead", {"surv": str(surv_dir)},
                {"surv": surv}),
                surv.result("repl-key", timeout=120),
                surv.finalize("repl-key", timeout=120)]
        finally:
            surv.close()
        out.append(fleet_delta(pkg, before))
        return out

    _, port = both(scenario)
    assert port[1] == {"accepted": True, "seq": 2, "key": "repl-key"}
    assert len(port[2]) == 2   # both segments shipped
    assert port[3] == {"surv": ["repl-key"]}
    assert pin(port[4]) == pin(port[5]) == pin(jsonable(one_shot(h)))
    assert port[4]["seq"] == 2
    assert port[6]["serve.ring.rehomes_from_replica"]["value"] == 1


def test_async_replication_lag_drain_and_off(tmp_path):
    h = register_history(corrupt=False)

    def scenario(pkg):
        P = PKGS[pkg]
        before = P.obs.registry().snapshot()
        mirror = tmp_path / pkg / "mirror"
        svc = _replicated(pkg, tmp_path / pkg / "src", mirror, mode="async")
        try:
            # a drain after each append: how many appends one shipper
            # pass coalesces is timing, and so are its counters
            out = [svc.submit("ak", ops(pkg, h[:8]), timeout=60),
                   svc._repl.drain(timeout=30),
                   svc.submit("ak", ops(pkg, h[8:]), timeout=60),
                   svc._repl.drain(timeout=30),
                   P.obs.registry().snapshot()["serve.repl_lag_keys"][
                       "value"],
                   P.WAL(str(mirror)).replay("ak")
                   == svc._wal.replay("ak")]
        finally:
            svc.close()
        out.append(_mirror_bytes(mirror))
        off = P.fleet.SegmentReplicator(
            P.WAL(str(tmp_path / pkg / "o")),
            P.fleet.constant_dst(str(tmp_path / pkg / "om")), mode="off")
        out += [off.after_append("k"),
                os.path.exists(tmp_path / pkg / "om")]
        d = fleet_delta(pkg, before)
        # how many times the shipper's lag gauge moved is timing
        out.append({k: v for k, v in d.items()
                    if k != "serve.repl_lag_keys"})
        return out

    _, port = both(scenario)
    assert port[1] is port[3] is True and port[4] == 0 and port[5] is True
    assert port[-3] is None and port[-2] is False


@pytest.mark.parametrize("why", ["ship-fails", "no-destination"])
def test_sync_replication_not_landed_degrades_ack(tmp_path, monkeypatch,
                                                  why):
    """An unreachable successor (or none: a one-node ring) must not block
    the primary ack — it degrades it: acks and ``wait=True`` answers carry
    ``replicated: False``, and ``serve.repl_errors`` (or
    ``serve.repl_no_destination``) moves."""
    h = register_history(corrupt=False)

    def scenario(pkg):
        P = PKGS[pkg]
        before = P.obs.registry().snapshot()
        wal_dir = tmp_path / pkg / "solo"
        if why == "ship-fails":
            svc = _replicated(pkg, wal_dir, tmp_path / pkg / "m2")

            def broken(key):
                raise OSError("mirror disk gone")

            monkeypatch.setattr(svc._repl, "ship", broken)
        else:
            dst = P.fleet.ring_successor_dst(
                P.ring.HashRing(["solo"]), {"solo": str(wal_dir)}, "solo")
            svc = service(pkg, wal_dir, replicator=P.fleet.SegmentReplicator(
                P.WAL(str(wal_dir)), dst, mode="sync"))
        try:
            out = [svc.submit("fk", ops(pkg, h[:10]), timeout=60),
                   svc.submit("fk", ops(pkg, h[10:]), wait=True,
                              timeout=120)]
        finally:
            svc.close()
        return out + [fleet_delta(pkg, before)]

    _, port = both(scenario)
    assert port[0] == {"accepted": True, "seq": 1, "key": "fk",
                       "replicated": False}
    assert port[1]["replicated"] is False and port[1]["seq"] == 2
    name = ("serve.repl_errors" if why == "ship-fails"
            else "serve.repl_no_destination")
    assert port[2] == {name: {"type": "counter", "value": 2}}


def test_rehome_from_replica_with_torn_mirror_tail(tmp_path):
    """The WAL's one-torn-tail-a-segment tolerance on the replication
    path: a mirror copy torn mid-line loses its last delta; the rehome
    replays the acknowledged prefix, and the stream resumes past the
    tear."""
    h = register_history(corrupt=False)

    def scenario(pkg):
        P = PKGS[pkg]
        surv_dir = tmp_path / pkg / "tsurv"
        mirror = surv_dir / P.ring.REPL_SUBDIR
        dead_dir = tmp_path / pkg / "tdead"
        svc = _replicated(pkg, dead_dir, mirror)
        out = [svc.submit("torn-key", ops(pkg, h[:10]), timeout=60),
               svc.submit("torn-key", ops(pkg, h[10:]), timeout=60)]
        svc.close(drain=False)
        shutil.rmtree(dead_dir)
        seg = P.WAL(str(mirror)).segments("torn-key")[-1]
        with open(seg) as fh:
            lines = fh.read().splitlines(keepends=True)
        with open(seg, "w") as fh:
            fh.writelines(lines[:-1])
            fh.write(lines[-1][:len(lines[-1]) // 2])
        surv = service(pkg, surv_dir)
        try:
            out += [P.ring.rehome_dead_replica(
                str(dead_dir), P.ring.HashRing(["tdead", "tsurv"]), "tdead",
                {"tsurv": str(surv_dir)}, {"tsurv": surv}),
                surv.result("torn-key", timeout=120),
                surv.submit("torn-key", ops(pkg, h[10:]), seq=2,
                            timeout=60),
                surv.finalize("torn-key", timeout=120)]
        finally:
            surv.close()
        return out

    _, port = both(scenario)
    assert port[2] == {"tsurv": ["torn-key"]}
    assert port[3]["seq"] == 1
    assert pin(port[3]) == pin(jsonable(one_shot(h[:10])))
    assert port[4]["accepted"] is True
    assert pin(port[5]) == pin(jsonable(one_shot(h)))


def test_ship_is_incremental_suffix_copy(tmp_path):
    """Later ships append only the suffix (the destination's size is the
    resume offset): the mirror converges byte for byte and
    ``serve.repl_bytes`` grows by the delta's bytes, not the segment's."""
    h = register_history(corrupt=False)

    def scenario(pkg):
        P = PKGS[pkg]
        wal = P.WAL(str(tmp_path / pkg / "inc"))
        mirror = tmp_path / pkg / "inc-mirror"
        repl = P.fleet.SegmentReplicator(
            wal, P.fleet.constant_dst(str(mirror)), mode="sync")
        before = P.obs.registry().snapshot()
        n1 = wal.append("ik", 1, ops(pkg, h[:10]))
        out = [n1, repl.ship("ik")]
        mid = P.obs.registry().snapshot()
        n2 = wal.append("ik", 2, ops(pkg, h[10:]))
        out += [n2, repl.ship("ik"), fleet_delta(pkg, mid),
                repl.ship("ik"), fleet_delta(pkg, before),
                _mirror_bytes(mirror)]
        src = wal.segments("ik")[0]
        with open(src, "rb") as fh:
            out.append(fh.read() == (mirror / os.path.basename(
                src)).read_bytes())
        wal.close()
        return out

    _, port = both(scenario)
    n1, s1, n2, s2, grew, s3, total, mirrored, identical = port
    assert (s1, s2, s3) == (1, 1, 0) and identical
    assert grew["serve.repl_bytes"]["value"] == n2
    # the first ship carried the segment's header line too
    assert total["serve.repl_bytes"]["value"] \
        == sum(len(b) for b in mirrored.values()) > n1 + n2
    assert total["serve.repl_segments_shipped"]["value"] == 2


def test_mirror_fallback_never_rehomes_live_survivors_keys(tmp_path):
    """The survivors' mirrors hold EVERY replica's shipped keys; with the
    dead node's disk gone the rehome moves only the dead node's keys, and
    a live survivor's WAL is untouched."""
    h = register_history(corrupt=False)

    def scenario(pkg):
        P = PKGS[pkg]
        root = tmp_path / pkg
        dirs = {n: str(root / n) for n in ("la", "lb", "lc")}
        for d in dirs.values():
            os.makedirs(d)
        svc_b = service(pkg, dirs["lb"])
        try:
            svc_b.submit("live-key", ops(pkg, h[:10]), timeout=60)
            lagging = os.path.join(dirs["lc"], P.ring.REPL_SUBDIR)
            P.ring.transfer_key(dirs["lb"], lagging, "live-key")
            svc_b.submit("live-key", ops(pkg, h[10:]), timeout=60)
            svc_b.result("live-key", timeout=120)
            live = P.WAL(dirs["lb"]).replay("live-key")
            stage = P.WAL(str(root / "stage"))
            stage.append("dead-key", 1, ops(pkg, h[:10]))
            stage.close()
            P.ring.transfer_key(str(root / "stage"), os.path.join(
                dirs["la"], P.ring.REPL_SUBDIR), "dead-key")
            sources = P.ring._key_sources(str(root / "gone"), dirs)
            plan = P.ring.rehome_dead_replica(
                str(root / "gone"), P.ring.HashRing(["la", "lb", "lc",
                                                     "dead"]),
                "dead", dirs)
            out = [sorted(sources), plan,
                   P.WAL(dirs["lb"]).replay("live-key") == live]
        finally:
            svc_b.close()
        return out

    _, port = both(scenario)
    assert port[0] == ["dead-key"]
    assert [k for ks in port[1].values() for k in ks] == ["dead-key"]
    assert port[2] is True


# ------------------------------------------------- the supervisor


class _Script:
    """A deterministic fetch: each replica's liveness flips on command."""

    def __init__(self, names):
        self.alive = {n: True for n in names}

    def __call__(self, addr, _timeout):
        return self.alive[addr]


def _fleet(pkg, root, n, **kw):
    P = PKGS[pkg]
    dirs = {f"n{i}": str(root / pkg / f"n{i}") for i in range(n)}
    svcs = {name: service(pkg, d) for name, d in dirs.items()}
    script = _Script(dirs)
    clk = [0.0]
    sleeps = []
    sup = P.fleet.FleetSupervisor(
        {name: None for name in dirs}, dirs, services=svcs, fetch=script,
        clock=lambda: clk[0], sleep=sleeps.append, **kw)
    return sup, svcs, dirs, script, clk, sleeps


def test_supervisor_detects_rehomes_pins_and_rejoins(tmp_path):
    """Two misses -> dead -> rehome -> pin, then the breaker's half-open
    probe re-admits the replica for new keys only: ``status()`` after
    every tick, the adopter's verdict and the counter deltas equal the
    reference's."""
    h = register_history(corrupt=False)

    def scenario(pkg):
        P = PKGS[pkg]
        sup, svcs, dirs, script, clk, sleeps = _fleet(
            pkg, tmp_path, 3, interval=1.0, threshold=2, rehome_retries=2)
        before = P.obs.registry().snapshot()
        try:
            key = "supkey"
            victim = sup.ring.owner(key)
            svcs[victim].submit(key, ops(pkg, h), timeout=60)
            svcs[victim].result(key, timeout=120)
            out = [victim, sup.status()]
            script.alive[victim] = False
            for _ in range(2):
                sup.tick()
                out.append(sup.status())
            adopter = sup.owner(key)
            out += [adopter, svcs[adopter].result(key, timeout=120),
                    P.WAL(dirs[victim]).fence(key)]
            script.alive[victim] = True
            sup.tick()             # still inside the backoff window
            out.append(sup.status())
            clk[0] += 3600.0
            sup.tick()             # the half-open probe answers
            out += [sup.status(), sup.owner(key),
                    sorted({sup.owner(("newkey", i)) for i in range(200)}),
                    sleeps, fleet_delta(pkg, before)]
        finally:
            sup.stop()
            for s in svcs.values():
                s.close()
        return out

    _, port = both(scenario)
    victim, adopter = port[0], port[4]
    assert port[2]["replicas"][victim]["dead"] is False
    assert port[3]["replicas"][victim] == {
        **port[3]["replicas"][victim], "dead": True, "rehomed": True}
    assert port[3]["pins"] == {"supkey": adopter} and adopter != victim
    assert pin(port[5]) == pin(jsonable(one_shot(h)))
    assert port[6]["epoch"] == 2
    assert port[7]["replicas"][victim]["dead"] is True
    assert port[8]["replicas"][victim]["dead"] is False
    assert port[9] == adopter and victim in port[10]
    d = port[12]
    assert d["fleet.deaths"]["value"] == d["fleet.rehomes"]["value"] \
        == d["fleet.rejoins"]["value"] == 1
    assert d["fleet.misses"]["value"] == 2


def test_supervisor_rehome_retry_backoff_and_next_tick(tmp_path):
    """An adopter that fails retries with bounded backoff inside the
    tick; an exhausted budget stays pending and the next tick tries
    again. The backoff sleeps, statuses and failure counts equal the
    reference's."""
    h = register_history(corrupt=False)

    def scenario(pkg):
        sup, svcs, dirs, script, clk, sleeps = _fleet(
            pkg, tmp_path, 2, interval=1.0, threshold=1, rehome_retries=3)
        before = PKGS[pkg].obs.registry().snapshot()
        try:
            key = "rbkey"
            victim = sup.ring.owner(key)
            surv = next(n for n in dirs if n != victim)
            svcs[victim].submit(key, ops(pkg, h), timeout=60)
            svcs[victim].result(key, timeout=120)
            calls = []
            real_adopt = svcs[surv].adopt_keys

            def flaky_adopt():
                calls.append(1)
                if len(calls) < 5:
                    raise OSError("adopter disk hiccup")
                return real_adopt()

            svcs[surv].adopt_keys = flaky_adopt
            script.alive[victim] = False
            sup.tick()     # dead, then 3 failed attempts
            out = [sup.status(), list(sleeps), len(calls)]
            sup.tick()     # attempts 4 (fails) and 5 (lands)
            out += [sup.status(), list(sleeps), len(calls),
                    sup.owner(key), svcs[surv].result(key, timeout=120),
                    fleet_delta(pkg, before)]
        finally:
            sup.stop()
            for s in svcs.values():
                s.close()
        return out

    _, port = both(scenario)
    assert port[1] == [1.0, 2.0] and port[2] == 3
    assert port[0]["replicas"]["n0" if port[0]["replicas"]["n0"]["dead"]
                               else "n1"]["rehomed"] is False
    assert port[4] == [1.0, 2.0, 1.0] and port[5] == 5
    assert port[8]["fleet.rehome_failures"]["value"] == 4
    assert port[8]["fleet.rehomes"]["value"] == 1


def test_supervisor_validates_fleet_shape(tmp_path):
    with pytest.raises(ValueError, match="same fleet"):
        fleet.FleetSupervisor({"a": None}, {"b": str(tmp_path)})


def test_supervisor_start_stop_loop(tmp_path):
    """The daemon loop ticks on its own every ``interval`` and stops."""
    sup, svcs, dirs, script, clk, sleeps = _fleet("port", tmp_path, 2,
                                                  interval=0.01, threshold=1)
    try:
        victim = sorted(dirs)[0]
        script.alive[victim] = False
        with sup:
            deadline = time.time() + 30
            while not sup.status()["replicas"][victim]["rehomed"]:
                assert time.time() < deadline
                time.sleep(0.01)
        assert sup._thread is None
    finally:
        for s in svcs.values():
            s.close()


# ------------------------------------------------- byte interchange


@pytest.mark.parametrize("shipper,adopter", [("port", "ref"),
                                             ("ref", "port")])
def test_mirror_interchange_between_packages(tmp_path, shipper, adopter):
    """A mirror sync-shipped by one package's service (its primary's disk
    then deleted) rehomes into the other package's service, through the
    other package's ``rehome_dead_replica``, to the one-shot verdicts of
    every key; both packages ship the same bytes."""
    h1 = register_history(seed=2)
    h2 = register_history(seed=6, corrupt=False)
    mirrors = {}
    for pkg in ("ref", "port"):
        mirror = tmp_path / pkg / "surv" / PKGS[pkg].ring.REPL_SUBDIR
        svc = _replicated(pkg, tmp_path / pkg / "dead", mirror)
        for k, h in (("x1", h1), (("reg", 7), h2)):
            svc.submit(k, ops(pkg, h[:10]), timeout=60)
            svc.submit(k, ops(pkg, h[10:]), timeout=60)
        svc.close(drain=False)
        mirrors[pkg] = _mirror_bytes(mirror)
    assert mirrors["port"] == mirrors["ref"]
    shutil.rmtree(tmp_path / shipper / "dead")
    surv_dir = tmp_path / shipper / "surv"
    A = PKGS[adopter]
    surv = service(adopter, surv_dir)
    try:
        plan = A.ring.rehome_dead_replica(
            str(tmp_path / shipper / "dead"), A.ring.HashRing(["d", "s"]),
            "d", {"s": str(surv_dir)}, {"s": surv})
        assert sorted(map(str, plan["s"])) == sorted(["x1", str(("reg", 7))])
        for k, h in (("x1", h1), (("reg", 7), h2)):
            f = jsonable(surv.finalize(k, timeout=120))
            assert pin(f) == pin(jsonable(one_shot(h))) and f["seq"] == 2
    finally:
        surv.close()


# ------------------------------------------------------ the entry point

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_entry(*argv, env=None):
    import subprocess
    import sys
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("JEPSEN_TPU_TORCH_")}
    return subprocess.run(
        [sys.executable, "-m", "jepsen_tpu_torch.serve", *argv], cwd=ROOT,
        capture_output=True, text=True, timeout=120, input="",
        env=dict(base, PYTHONPATH=ROOT, **(env or {})))


@pytest.mark.parametrize("argv,mode,says", [
    ([], "sync", "no --repl-dir names the successor's mirror"),
    (["--repl-dir", "MIRROR"], None, "JEPSEN_TPU_TORCH_SERVE_REPL is "
                                     "off/unset"),
    (["--repl-dir", "MIRROR"], "async", "needs a WAL-backed service"),
], ids=["mode-without-dir", "dir-with-mode-off", "dir-without-wal"])
def test_entry_point_repl_usage_errors_exit_2(tmp_path, argv, mode, says):
    """The reference's three usage errors of ``--repl-dir`` and the mode
    (jepsen_tpu/cli.py:343-381), each at exit 2 before anything starts:
    no WAL, mirror or ops endpoint is made, with a card or without."""
    argv = [str(tmp_path / "m") if a == "MIRROR" else a for a in argv]
    if says != "needs a WAL-backed service":
        argv += ["--wal-dir", str(tmp_path / "wal")]
    env = {"JEPSEN_TPU_TORCH_SERVE_REPL": mode} if mode else {}
    proc = _run_entry(*argv, "--ops-port", "0", env=env)
    assert proc.returncode == 2, proc.stderr
    assert says in proc.stderr and "ops endpoint" not in proc.stderr
    assert proc.stdout == "" and not os.listdir(tmp_path)


def test_entry_point_fleet_options(tmp_path):
    from jepsen_tpu_torch.serve.__main__ import parser
    args = parser().parse_args(["--repl-dir", "/m", "--ops-port", "0"])
    assert (args.repl_dir, args.ops_port) == ("/m", 0)
    args = parser().parse_args([])
    assert (args.repl_dir, args.ops_port) == (None, None)
    proc = _run_entry("--help")
    assert proc.returncode == 0
    assert "--repl-dir" in proc.stdout and "--ops-port" in proc.stdout
    # a sound replication setup on a box without a card: the card is
    # refused first, before any WAL or mirror is written
    proc = _run_entry("--wal-dir", str(tmp_path / "wal"), "--repl-dir",
                      str(tmp_path / "m"), "--ops-port", "0",
                      env={"JEPSEN_TPU_TORCH_SERVE_REPL": "sync",
                           "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1
    assert "no CUDA device is available" in proc.stderr
    assert "ops endpoint" not in proc.stderr and not os.listdir(tmp_path)
