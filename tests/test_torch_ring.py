"""The port's replica ring (jepsen_tpu_torch.serve.ring) against the
reference's (jepsen_tpu.serve.ring), exactly:

* ``HashRing``: owner, successor and assignments over a few thousand
  seeded keys of every type that reaches the ring (ints, negative and
  past 2^31; strings with unicode and quotes; tuples from JSON lists,
  nested), on 1-5 nodes at vnodes 1 and 64, through ``remove`` and
  ``add`` — the identity is ``sha1(edn.dumps(key))``, so any difference
  in the EDN text would send a key to another owner;
* ``Router``'s crash rehome and graceful ``migrate_key`` over two
  services each, in process: every answer, plan, fence and pin equal;
* ``transfer_key`` on a reference replica's checkpoint files;
* a real kill -9 across processes on the CPU: two replica children
  (the port's service with its ops endpoint and ingress), the supervisor
  over HTTP detecting the death and re-homing through ``POST /adopt``,
  with the dead replica's disk kept or deleted (then the sync mirror is
  the source). Each key equals the reference's in-process
  ``Router.rehome`` on the same deltas and the one-shot check.
"""

import json
import os
import random
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from torch_fleet_cases import (
    PKGS, both, one_shot, ops, pin, register_history, service, unarmed,
)
from torch_jax_cache import release_compiled_programs  # noqa: F401

from jepsen_tpu.serve import ring as ref_ring
from jepsen_tpu_torch.serve import ring
from jepsen_tpu_torch.serve.fleet import FleetSupervisor, HttpReplica
from jepsen_tpu_torch.serve.stdio import jsonable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# ------------------------------------------------------------- the ring


def _ring_keys(n=2400, seed=14):
    """Seeded keys of every type the ring sees: ints (negative, past
    2^31), strings (unicode, quotes, backslashes, newlines) and tuples
    as a JSON list key becomes (nested too)."""
    rng = random.Random(seed)
    alphabet = "abcxyz09 \"\\\né中\U0001f600:#{}[]"
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            out.append(rng.choice([rng.randint(-2 ** 63, 2 ** 63),
                                   rng.randint(-1000, 1000),
                                   2 ** 31 + rng.randint(0, 1 << 20)]))
        elif kind == 1:
            out.append("".join(rng.choice(alphabet)
                               for _ in range(rng.randint(0, 12))))
        elif kind == 2:
            out.append(("reg", rng.randint(-2 ** 40, 2 ** 40)))
        else:
            out.append((rng.randint(0, 9), ("sub", str(i), (i, -i)),
                        "kéy"))
    return out


@pytest.mark.parametrize("vnodes", [1, 64])
@pytest.mark.parametrize("n_nodes", [1, 2, 3, 4, 5])
def test_hash_ring_equals_reference(n_nodes, vnodes):
    keys = _ring_keys()
    names = [f"replica-{i}" for i in range(n_nodes)]
    port, ref = ring.HashRing(names, vnodes), ref_ring.HashRing(names,
                                                                  vnodes)

    def same():
        assert port.nodes == ref.nodes
        assert [port.owner(k) for k in keys] == [ref.owner(k) for k in keys]
        assert [port.successor(k) for k in keys] \
            == [ref.successor(k) for k in keys]
        assert port.assignments(keys) == ref.assignments(keys)

    same()
    for r in (port, ref):
        r.remove(names[0])
        r.add("joiner")
    same()
    for r in (port, ref):
        r.add(names[0])
        r.remove("joiner")
    same()


def test_hash_ring_stable_under_remove_and_add():
    r = ring.HashRing(["a", "b", "c"])
    keys = [("reg", i) for i in range(200)]
    owners = {k: r.owner(k) for k in keys}
    assert all(ring.HashRing(["c", "a", "b"]).owner(k) == o
               for k, o in owners.items())
    r.remove("b")
    assert all(r.owner(k) == o for k, o in owners.items() if o != "b")
    r.add("b")
    assert all(r.owner(k) == o for k, o in owners.items())
    assert ring.HashRing(["solo"]).successor("k") is None
    with pytest.raises(ValueError, match="no nodes"):
        ring.HashRing([]).owner("k")
    with pytest.raises(ValueError, match="vnodes"):
        ring.HashRing(["a"], vnodes=0)


# ------------------------------------------------- in-process rehoming


def _key_owned_by(names, node, prefix):
    r = ring.HashRing(names)
    return next(f"{prefix}-{i}" for i in range(1000)
                if r.owner(f"{prefix}-{i}") == node)


def test_router_crash_rehome_equals_reference(tmp_path):
    """One replica dies (closed without drain: the in-process stand-in
    for a kill), the survivor adopts its WAL, and every answer — acks,
    the plan, the re-homed verdict, a replayed delta's duplicate, the
    finalize, the dead dir's fence and the pins — equals the
    reference's."""
    h = register_history()
    names = ["r1", "r2"]
    key = _key_owned_by(names, "r1", "mig")

    def scenario(pkg):
        dirs = {n: tmp_path / pkg / n for n in names}
        svcs = {n: service(pkg, d) for n, d in dirs.items()}
        router = PKGS[pkg].ring.Router(svcs, {n: str(d)
                                              for n, d in dirs.items()})
        try:
            out = [router.owner(key),
                   router.submit(key, ops(pkg, h[:12]), wait=True,
                                 timeout=120),
                   router.submit(key, ops(pkg, h[12:]), timeout=60)]
            svcs["r1"].close(drain=False)
            out += [router.rehome("r1"), router.owner(key),
                    router.result(key, timeout=120),
                    router.submit(key, ops(pkg, h[12:]), seq=2),
                    router.finalize(key, timeout=120),
                    PKGS[pkg].WAL(str(dirs["r1"])).fence(key),
                    router.pins, sorted(router.services)]
        finally:
            for s in router.services.values():
                s.close()
        return out

    _, port = both(scenario)
    assert port[3] == {"r2": [key]} and port[4] == "r2"
    assert port[6]["duplicate"] is True
    assert pin(port[5]) == pin(port[7]) == pin(jsonable(one_shot(h)))
    assert port[8]["epoch"] == 2 and port[8]["owner"] == "r2"


def test_router_graceful_migrate_equals_reference(tmp_path):
    """The graceful path: the source freezes the key, the checkpoint pair
    and segments land on the destination, which thaws, and the source is
    fenced — then the key migrates back and the returning owner serves.
    Every answer equals the reference's."""
    h = register_history(seed=5, corrupt=False)
    names = ["ra", "rb"]
    key = _key_owned_by(names, "ra", "gkey")

    def scenario(pkg):
        dirs = {n: tmp_path / pkg / n for n in names}
        svcs = {n: service(pkg, d) for n, d in dirs.items()}
        router = PKGS[pkg].ring.Router(svcs, {n: str(d)
                                              for n, d in dirs.items()})
        try:
            out = [router.submit(key, ops(pkg, h[:12]), wait=True,
                                 timeout=120),
                   router.migrate_key(key, "rb"),
                   router.migrate_key(key, "rb"),
                   sorted(os.listdir(dirs["rb"] / "checkpoints")),
                   svcs["rb"].result(key, timeout=120),
                   svcs["ra"].submit(key, ops(pkg, h[12:]), seq=2,
                                     timeout=10),
                   router.submit(key, ops(pkg, h[12:]), wait=True,
                                 timeout=120),
                   router.migrate_key(key, "ra"),
                   svcs["rb"].submit(key, ops(pkg, h[12:]), seq=3,
                                     timeout=10),
                   router.finalize(key, timeout=120),
                   PKGS[pkg].WAL(str(dirs["rb"])).fence(key),
                   PKGS[pkg].WAL(str(dirs["ra"])).fence(key),
                   router.pins]
        finally:
            for s in svcs.values():
                s.close()
        return out

    _, port = both(scenario)
    assert port[1]["from"] == "ra" and port[1]["to"] == "rb"
    assert port[1]["segments"] >= 1 and port[1]["checkpoint"] is True
    assert port[2] == {"noop": True, "node": "rb"}
    assert port[5]["fenced"] is True and port[8]["fenced"] is True
    assert pin(port[9]) == pin(jsonable(one_shot(h)))
    assert port[11] is None and port[12] == {key: "ra"}


def test_transfer_key_carries_a_reference_replicas_files(tmp_path):
    """A reference replica's checkpoint side (``.json``, ``.npz`` and the
    ``.programs.json`` the port never writes) travels unchanged, and the
    returned dict equals the reference's on the same source."""
    h = register_history(corrupt=False)
    src = tmp_path / "src"
    svc = service("ref", src, evict_idle_secs=3600)
    try:
        svc.submit("tk", ops("ref", h[:12]), wait=True, timeout=120)
        assert svc.freeze_key("tk")
    finally:
        svc.close()
    cps = src / "checkpoints"
    stem = next(n[:-len(".json")] for n in os.listdir(cps)
                if n.endswith(".json"))
    (cps / (stem + ".programs.json")).write_text('{"programs": []}\n')
    port = service("port", tmp_path / "port")
    try:
        got = ring.transfer_key(str(src), str(tmp_path / "port"), "tk")
        want = ref_ring.transfer_key(str(src), str(tmp_path / "ref"), "tk")
        assert got == want == {"segments": 1, "checkpoint": True,
                               "manifest": True}
        for d in ("port", "ref"):
            for name in os.listdir(cps):
                assert (tmp_path / d / "checkpoints" / name).read_bytes() \
                    == (cps / name).read_bytes()
        assert port.adopt_keys() == ["tk"]
        assert pin(port.result("tk", timeout=120)) \
            == pin(jsonable(one_shot(h[:12])))
    finally:
        port.close()


# ------------------------------------------------ cross-process kill


_CHILD = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from jepsen_tpu_torch.models import CASRegister
from jepsen_tpu_torch.obs.httpd import OpsServer
from jepsen_tpu_torch.serve import CheckerService, SegmentReplicator
from jepsen_tpu_torch.serve.fleet import constant_dst
from jepsen_tpu_torch.serve.ingress import DeltaIngress
from jepsen_tpu_torch.serve.wal import DeltaWAL
wal, repl = sys.argv[1], sys.argv[2]
svc = CheckerService(
    CASRegister(), wal_dir=wal, capacity=128, dedupe="hash", device="cpu",
    evict_idle_secs=0.2,
    replicator=(SegmentReplicator(DeltaWAL(wal), constant_dst(repl),
                                  mode="sync") if repl else None))
ops = OpsServer(health_fn=svc.health, status_fn=svc.status,
                adopt_fn=svc.adopt_keys).start()
ing = DeltaIngress(svc, port=0).start()
print(json.dumps({"ingress": ing.port, "ops": ops.port}), flush=True)
while True:
    time.sleep(1)
"""


def _child(script, wal, repl=""):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("JEPSEN_TPU_TORCH_SERVE_REPL", None)
    proc = subprocess.Popen([sys.executable, str(script), str(wal), repl],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, env=env, cwd=ROOT)
    line = proc.stdout.readline().decode()
    assert line, "the replica child printed no ports"
    return proc, json.loads(line)


def _post_lines(port, reqs, timeout=120):
    body = "".join(json.dumps(r) + "\n" for r in reqs).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/deltas",
                                 data=body)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return [json.loads(ln) for ln in resp.read().decode().splitlines()]


def _wait(cond, what, secs=60):
    deadline = time.time() + secs
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _reference_rehome(tmp_path, keys, deltas, disk):
    """The reference in process on the same deltas: two services with
    the same WALs' roles, A closed without drain after delta 2 (its disk
    deleted when `disk` is "lost", A then sync-shipping to B's mirror),
    `Router.rehome`, then (each step awaited, so the worker's batches
    are the same in both runs) the verdict of delta 2, delta 3 and
    finalize at the owner."""
    dirs = {n: tmp_path / "ref" / n for n in ("A", "B")}
    repl = None
    if disk == "lost":
        repl = PKGS["ref"].fleet.SegmentReplicator(
            PKGS["ref"].WAL(str(dirs["A"])), PKGS["ref"].fleet.constant_dst(
                str(dirs["B"] / ring.REPL_SUBDIR)), mode="sync")
    svcs = {"A": service("ref", dirs["A"], evict_idle_secs=0.2,
                         replicator=repl),
            "B": service("ref", dirs["B"], evict_idle_secs=0.2)}
    router = ref_ring.Router(svcs, {n: str(d) for n, d in dirs.items()})
    try:
        for k in keys:
            router.submit(k, ops("ref", deltas[k][0]), wait=True,
                          timeout=120)
        _wait(lambda: not svcs["A"].stats()["keys_live"], "eviction")
        for k in keys:
            router.submit(k, ops("ref", deltas[k][1]), timeout=60)
        svcs["A"].close(drain=False)
        if disk == "lost":
            shutil.rmtree(dirs["A"])
        plan = router.rehome("A")
        finals = {}
        for k in keys:
            router.result(k, timeout=120)
            router.submit(k, ops("ref", deltas[k][2]), wait=True,
                          timeout=120)
            finals[k] = router.finalize(k, timeout=120)
        return plan, jsonable(finals)
    finally:
        for s in router.services.values():
            s.close()


@pytest.mark.parametrize("disk", ["kept", "lost"])
def test_kill9_replica_rehomed_over_http_adopt(tmp_path, disk):
    """Two replica processes; A is SIGKILLed after acking delta 2 (its
    idle keys frozen by eviction first), with its WAL dir kept or
    deleted. The supervisor polls both ops endpoints over HTTP, declares
    A dead after two misses and re-homes its keys onto B through
    ``POST /adopt`` — from A's dir, or from the mirror A sync-shipped
    into B's ``repl/``. A re-sent delta 2 answers duplicate; delta 3 and
    finalize go to the supervisor's owner. Each key's final answer
    equals the reference's in-process Router.rehome on the same deltas,
    and its verdict the one-shot check."""
    h1 = register_history(seed=2)
    h2 = register_history(seed=4, corrupt=False)
    names = ["A", "B"]
    keys = [_key_owned_by(names, "A", "k9"), _key_owned_by(names, "B",
                                                            "k9")]
    deltas = {k: [h[:8], h[8:14], h[14:]] for k, h in zip(keys, (h1, h2))}
    ref_plan, ref_finals = _reference_rehome(tmp_path, keys, deltas, disk)
    script = tmp_path / "replica.py"
    script.write_text(_CHILD)
    dirs = {n: tmp_path / "port" / n for n in names}
    mirror = str(dirs["B"] / ring.REPL_SUBDIR) if disk == "lost" else ""
    procs = {}
    sup = None
    try:
        procs["A"], pa = _child(script, dirs["A"], mirror)
        procs["B"], pb = _child(script, dirs["B"])
        ingress = {"A": pa["ingress"], "B": pb["ingress"]}
        owner = ring.HashRing(names).owner
        for k in keys:
            r = _post_lines(ingress[owner(k)],
                            [{"key": k, "ops": deltas[k][0], "wait": True,
                              "timeout": 120}])[0]
            assert "valid?" in r, r
        _wait(lambda: any(n.endswith(".json") for n in os.listdir(
            dirs["A"] / "checkpoints"))
            if (dirs["A"] / "checkpoints").is_dir() else False,
            "A's eviction")
        for k in keys:
            r = _post_lines(ingress[owner(k)],
                            [{"key": k, "ops": deltas[k][1]}])[0]
            assert r.get("accepted") and "replicated" not in r, r
        procs["A"].send_signal(signal.SIGKILL)
        procs["A"].wait(timeout=30)
        if disk == "lost":
            shutil.rmtree(dirs["A"])
        sup = FleetSupervisor(
            {"A": f"127.0.0.1:{pa['ops']}", "B": f"127.0.0.1:{pb['ops']}"},
            {n: str(d) for n, d in dirs.items()},
            services={"B": HttpReplica(f"127.0.0.1:{pb['ops']}")},
            interval=0.1, threshold=2, fetch_timeout=2.0).start()
        _wait(lambda: sup.status()["replicas"]["A"]["rehomed"], "rehome")
        st = sup.status()
        assert st["replicas"]["A"]["dead"] is True
        assert st["replicas"]["A"]["breaker"]["state"] in ("open",
                                                           "half-open")
        assert st["replicas"]["B"]["dead"] is False
        assert st["pins"] == {str(keys[0]): "B"}
        assert {n: sorted(ks) for n, ks in ref_plan.items()} \
            == {"B": [keys[0]]}
        dup = _post_lines(ingress["B"], [{"key": keys[0], "seq": 2,
                                          "ops": deltas[keys[0]][1]}])
        assert dup == [{"duplicate": True, "seq": 2, "key": keys[0]}]
        finals = {}
        for k in keys:
            port = ingress[sup.owner(k)]
            finals[k] = _post_lines(port, [
                {"op": "result", "key": k, "timeout": 120},
                {"key": k, "ops": deltas[k][2], "wait": True,
                 "timeout": 120},
                {"op": "finalize", "key": k, "timeout": 120}])[-1]
    finally:
        if sup is not None:
            sup.stop()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for k, h in zip(keys, (h1, h2)):
        got = {f: v for f, v in finals[k].items() if f != "closure"}
        assert got == ref_finals[k]
        assert pin(got) == pin(jsonable(one_shot(h)))
        assert got["seq"] == 3
