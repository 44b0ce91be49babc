"""The port's MeshPlan (jepsen_tpu_torch.parallel.meshplan) against the
reference's (jepsen_tpu.parallel.meshplan): the topology decision, the
re-shard ladder's rungs flat and at 2x2 (four spawned gloo ranks against
the reference's MeshPlan over four devices), `key_home` and
`key_partition` over 2,000 seeded keys of every EDN type, `host_slices`
on one host, the strict gating of `distributed_init` (one case per case
of the reference's tests/test_meshplan.py), and a two-process localhost
gloo handshake through JEPSEN_TPU_TORCH_DIST*, the counterpart of the
reference's test_distributed_two_process_localhost_smoke.
"""

import json
import os
import pathlib
import random
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch_gloo
from jepsen_tpu_torch import edn, envflags
from jepsen_tpu_torch.parallel import meshplan
from jepsen_tpu_torch.parallel.meshplan import MeshPlan
from torch_jax_cache import release_compiled_programs  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _describe(plan) -> tuple:
    return (plan.n_dev, plan.hierarchical, plan.n_slice, plan.n_chip)


def _rank(rank: int) -> dict:
    """One rank of four: the decisions and ladders on a flat 4, a 2x2, a
    1x4 and (gather) 2x2 mesh, and the host view."""
    flat = torch_gloo.mesh((4,))
    sq = torch_gloo.mesh((2, 2))
    row = torch_gloo.mesh((1, 4), names=("a", "b"))
    p = MeshPlan.from_mesh(flat)
    p2 = MeshPlan.from_mesh(sq)
    out = {
        "decisions": [_describe(MeshPlan.from_mesh(m, exchange=x))
                      for m, x in ((flat, "route"), (sq, "route"),
                                   (sq, "gather"), (row, "route"))],
        "ladders": {f"flat-{s}": [_describe(r) for r in p.ladder(s)]
                    for s in (1, 2, 4)},
        "idx": (p2.my_idx, p2.slice_idx, p2.chip_idx),
        "hosts": p.host_slices(),
        "local": p.local_devices(),
        "n_processes": p.n_processes,
        "partition": p.key_partition([f"k{i}" for i in range(40)]),
    }
    out["ladders"].update({f"2x2-{s}": [_describe(r) for r in p2.ladder(s)]
                           for s in (1, 2)})
    return out


_RESULTS: dict = {}


def _results() -> list:
    if not _RESULTS:
        _RESULTS["ranks"] = torch_gloo.shared(
            "meshplan", lambda: torch_gloo.Group(4, _rank).results())
    return _RESULTS["ranks"]


def _ref_describe(plan) -> tuple:
    return (plan.n_dev, plan.hierarchical, plan.n_slice, plan.n_chip)


def test_topology_decision_matches_reference():
    import jax
    from jax.sharding import Mesh
    from jepsen_tpu.parallel.meshplan import MeshPlan as RefPlan
    devs = np.array(jax.devices()[:4])
    want = [_ref_describe(RefPlan.from_mesh(Mesh(d, names), exchange=x))
            for d, names, x in (
                (devs, ("frontier",), "route"),
                (devs.reshape(2, 2), ("a", "b"), "route"),
                (devs.reshape(2, 2), ("a", "b"), "gather"),
                (devs.reshape(1, 4), ("a", "b"), "route"))]
    ranks = _results()
    assert all(r["decisions"] == want for r in ranks)
    assert want[1] == (4, True, 2, 2) and not want[3][1]
    # the row-major device index and its place on the 2x2
    assert [r["idx"] for r in ranks] == [(0, 0, 0), (1, 0, 1), (2, 1, 0),
                                         (3, 1, 1)]


def test_ladder_rungs_flat_and_hierarchical():
    import jax
    from jepsen_tpu.parallel.meshplan import MeshPlan as RefPlan
    devs = np.array(jax.devices()[:4])
    flat, hier = RefPlan(devs), RefPlan(devs.reshape(2, 2), True)
    want = {f"flat-{s}": [_ref_describe(r) for r in flat.ladder(s)]
            for s in (1, 2, 4)}
    want.update({f"2x2-{s}": [_ref_describe(r) for r in hier.ladder(s)]
                 for s in (1, 2)})
    ranks = _results()
    assert all(r["ladders"] == want for r in ranks)
    assert [r[0] for r in want["flat-1"]] == [1, 2, 4]
    assert [(r[0], r[1]) for r in want["2x2-1"]] == [(1, False), (2, False),
                                                     (4, True)]


def test_host_slices_single_host():
    ranks = _results()
    for r in ranks:
        assert r["hosts"] == {0: [0, 1, 2, 3]}
        assert r["local"] == [0, 1, 2, 3]
        assert r["n_processes"] == 1
        # one host: every key in part 0, on every rank alike
        assert r["partition"] == {0: [f"k{i}" for i in range(40)]}


def _edn_text(rng: random.Random, depth: int = 0) -> str:
    """A random EDN form of any type: nil, booleans, integers, floats,
    strings, keywords (namespaced too), symbols, tagged values, vectors,
    lists, sets and maps."""
    kinds = ["nil", "bool", "int", "float", "str", "kw", "sym", "tag"]
    if depth < 2:
        kinds += ["vec", "list", "set", "map"]
    k = rng.choice(kinds)
    if k == "nil":
        return "nil"
    if k == "bool":
        return rng.choice(["true", "false"])
    if k == "int":
        return str(rng.randint(-10 ** 6, 10 ** 6))
    if k == "float":
        return repr(round(rng.uniform(-1e3, 1e3), 3))
    if k == "str":
        return json.dumps("".join(rng.choice("abcxyz _-1") for _ in
                                  range(rng.randint(0, 6))))
    if k == "kw":
        ns = rng.choice(["", "jepsen/", "a.b/"])
        return ":" + ns + rng.choice(["k", "key", "x1", "foo-bar"])
    if k == "sym":
        return rng.choice(["sym", "a/b", "foo?"])
    if k == "tag":
        return "#inst " + json.dumps(f"2026-0{rng.randint(1, 9)}-01")
    n = rng.randint(0, 3)
    items = [_edn_text(rng, depth + 1) for _ in range(n)]
    if k == "vec":
        return "[" + " ".join(items) + "]"
    if k == "list":
        return "(" + " ".join(items) + ")"
    if k == "set":
        return "#{" + " ".join(dict.fromkeys(items)) + "}"
    keys = list(dict.fromkeys(rng.choice(["1", ":a", '"s"', ":b/c", "nil"])
                              for _ in range(n)))
    return "{" + " ".join(f"{a} {_edn_text(rng, depth + 1)}"
                          for a in keys) + "}"


def test_key_home_matches_reference_for_every_edn_type():
    from jepsen_tpu import edn as ref_edn
    from jepsen_tpu.parallel.meshplan import MeshPlan as RefPlan
    rng = random.Random(20261018)
    texts = [_edn_text(rng) for _ in range(2000)]
    keys = [edn.loads(t) for t in texts]
    ref_keys = [ref_edn.loads(t) for t in texts]
    assert len({type(k).__name__ for k in keys}) >= 9
    for n in (1, 2, 3, 4, 7, 8):
        assert [MeshPlan.key_home(k, n) for k in keys] \
            == [RefPlan.key_home(k, n) for k in ref_keys]


def test_key_partition_matches_reference():
    import jax
    from jepsen_tpu.parallel.meshplan import MeshPlan as RefPlan
    keys = [f"k{i}" for i in range(40)] + [7, ("a", 1), None, 2.5]
    want = RefPlan(np.array(jax.devices()[:1])).key_partition(keys,
                                                              n_parts=4)
    got = MeshPlan.from_mesh(meshplan.local_mesh("cpu")).key_partition(
        keys, n_parts=4)
    assert got == want
    assert sorted((k for ks in got.values() for k in ks), key=repr) \
        == sorted(keys, key=repr)


DIST = ("JEPSEN_TPU_TORCH_DIST", "JEPSEN_TPU_TORCH_DIST_COORD",
        "JEPSEN_TPU_TORCH_DIST_NPROC", "JEPSEN_TPU_TORCH_DIST_PROC")


def test_distributed_init_gating(monkeypatch):
    for k in DIST:
        monkeypatch.delenv(k, raising=False)
    # off: a no-op that touches nothing
    assert meshplan.distributed_init() is False
    # armed but half-configured: raise at the read site
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DIST", "1")
    with pytest.raises(envflags.EnvFlagError, match="DIST_COORD"):
        meshplan.distributed_init()
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DIST_COORD", "nocolon")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DIST_NPROC", "2")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DIST_PROC", "0")
    with pytest.raises(envflags.EnvFlagError, match="host:port"):
        meshplan.distributed_init()
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DIST_COORD", "127.0.0.1:0")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DIST_PROC", "2")
    with pytest.raises(envflags.EnvFlagError, match="out of range"):
        meshplan.distributed_init()
    # a bad flag value fails loudly, like every other knob
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DIST", "yes")
    with pytest.raises(envflags.EnvFlagError):
        meshplan.distributed_init()


_CHILD = r"""
import json, torch
torch.set_num_threads(1)
from jepsen_tpu_torch.parallel import meshplan
assert meshplan.distributed_init("cpu") is True
assert meshplan.distributed_init("cpu") is True   # idempotent
plan = meshplan.MeshPlan.auto("cpu")
parts = plan.key_partition([f"k{i}" for i in range(16)], n_parts=2)
print(json.dumps({
    "rank": torch.distributed.get_rank(),
    "world": torch.distributed.get_world_size(),
    "n_dev": plan.n_dev, "my_idx": plan.my_idx,
    "hosts": {str(k): v for k, v in plan.host_slices().items()},
    "partition": {str(k): v for k, v in parts.items()},
}))
torch.distributed.destroy_process_group()
"""


def test_distributed_two_process_localhost_handshake():
    """Two processes complete the gated handshake over a localhost TCP
    rendezvous, see one plan of two ranks on one host, and compute the
    same key partition with no coordination round (the reference's
    partition, part for part)."""
    import jax
    from jepsen_tpu.parallel.meshplan import MeshPlan as RefPlan
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               JEPSEN_TPU_TORCH_DIST="1",
               JEPSEN_TPU_TORCH_DIST_COORD=f"127.0.0.1:{port}",
               JEPSEN_TPU_TORCH_DIST_NPROC="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(env, JEPSEN_TPU_TORCH_DIST_PROC=str(p))) for p in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, (out, err)
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert sorted(o["rank"] for o in outs) == [0, 1]
    want = RefPlan(np.array(jax.devices()[:1])).key_partition(
        [f"k{i}" for i in range(16)], n_parts=2)
    for o in outs:
        assert o["world"] == 2 and o["n_dev"] == 2
        assert o["my_idx"] == o["rank"]
        assert o["hosts"] == {"0": [0, 1]}
        assert o["partition"] == {str(k): v for k, v in want.items()}
