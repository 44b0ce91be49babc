"""The mesh paths on the card, at one NCCL rank (`meshplan.local_mesh()`),
against the same calls on the CPU's plain versions.

On the card (`cuda`): the mesh-sharded key batch (`check_batch(mesh=)`:
batched K1 on a dense bucket, batched K2/K4 on a sparse one), the
stealing rounds (`check_batch(steal=True, mesh=)`) and the resumable
sharded arm (K3 in every restore and iteration) equal, key for key and
checkpoint for checkpoint, the plain versions on the CPU. The CPU side
of the sharded arm runs in a child process: one process holds one
process group, and the card's is NCCL. On the CPU every test skips.

This file imports no JAX, so the card's run needs none.
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.parallel import closure_kernels as ck
from jepsen_tpu_torch.parallel import elastic, encode, engine, meshplan
from jepsen_tpu_torch.parallel import sharded
from jepsen_tpu_torch.parallel import sparse_kernels as sk

ROOT = pathlib.Path(__file__).resolve().parents[1]
PIN = ("valid?", "op", "fail-event", "max-frontier", "capacity",
       "configs-stepped", "dedupe", "escalated")
RES_KW = {"capacity": 128, "max_capacity": 1 << 16, "checkpoint_every": 16,
          "dedupe": "hash"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return meshplan.local_mesh()


def _pin(rs) -> list:
    return [{k: r.get(k) for k in PIN} for r in rs]


def _registers():
    return models.CASRegister(), [histories.rand_register_history(
        n_ops=60, n_processes=5, crash_p=0.05, fail_p=0.05, seed=s)
        for s in range(7)]


def _queues():
    hs = [histories.rand_queue_history(n_ops=60, n_processes=6,
                                       crash_p=0.02, seed=s)
          for s in range(5)]
    return models.UnorderedQueue(), hs


@pytest.mark.cuda
def test_mesh_batch_on_the_card_equals_the_cpu():
    """A dense bucket through batched K1 and a sparse one through batched
    K2/K4 (with stats: equal blocks, K2's stats instantiation), at one
    NCCL rank, equal the CPU's plain batch."""
    mesh = _mesh()
    model, hs = _registers()
    want = engine.check_batch(model, hs, device="cpu")
    ck.reset_launches()
    got = engine.check_batch(model, hs, mesh=mesh)
    assert _pin(got) == _pin(want) and ck.batch_launches > 0
    model, hs = _queues()
    want = engine.check_batch(model, hs, device="cpu", capacity=64,
                              search_stats=True)
    sk.reset_launches()
    got = engine.check_batch(model, hs, mesh=mesh, capacity=64,
                             search_stats=True)
    assert _pin(got) == _pin(want)
    assert [g["stats"] for g in got] == [w["stats"] for w in want]
    assert sk.launches["frontier_closure_batch_stats"] \
        + sk.launches["tiled_insert_batch"] > 0


@pytest.mark.cuda
def test_stealing_rounds_on_the_card_equal_the_cpu():
    mesh = _mesh()
    model, hs = elastic.forced_skew_histories(n_heavy=2, n_light=6)
    kw = {"capacity": elastic.SKEW_CAPACITY, "max_capacity": 1 << 16}
    want_st, got_st = {}, {}
    want = engine.check_batch(model, hs, device="cpu", steal=True,
                              steal_stats=want_st, **kw)
    got = engine.check_batch(model, hs, mesh=mesh, steal=True,
                             steal_stats=got_st, **kw)
    assert _pin(got) == _pin(want)
    assert got_st["buckets"] == want_st["buckets"]


_CHILD = r"""
import hashlib, json, sys, numpy as np, torch
torch.set_num_threads(1)
from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.parallel import encode, meshplan, sharded
kw = json.loads(sys.argv[1])
h = histories.adversarial_register_history(n_ops=60, k_crashed=6, seed=7)
e = encode.encode(models.CASRegister(), h)
cps = []
r = sharded.check_encoded_sharded_resumable(
    e, meshplan.local_mesh("cpu"), checkpoint_cb=cps.append, **kw)
def digest(cp):
    d = hashlib.sha256()
    for a in (cp.st, cp.ml, cp.mh, cp.live):
        a = np.ascontiguousarray(a)
        d.update(str(a.dtype).encode()); d.update(a.tobytes())
    return [cp.event_index, cp.capacity, cp.ok, cp.fail_r, cp.maxf,
            cp.steps_n, cp.stepped, d.hexdigest()[:16]]
print(json.dumps({"result": {k: r.get(k) for k in (
    "valid?", "max-frontier", "capacity", "configs-stepped")},
    "cps": [digest(c) for c in cps]}))
"""


def _digest(cp) -> list:
    d = hashlib.sha256()
    for a in (cp.st, cp.ml, cp.mh, cp.live):
        a = np.ascontiguousarray(a)
        d.update(str(a.dtype).encode())
        d.update(a.tobytes())
    return [cp.event_index, cp.capacity, cp.ok, cp.fail_r, cp.maxf,
            cp.steps_n, cp.stepped, d.hexdigest()[:16]]


@pytest.mark.cuda
def test_sharded_resumable_on_the_card_equals_the_cpu():
    mesh = _mesh()
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(RES_KW)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    e = encode.encode(models.CASRegister(),
                      histories.adversarial_register_history(
                          n_ops=60, k_crashed=6, seed=7))
    cps = []
    sk.reset_launches()
    r = sharded.check_encoded_sharded_resumable(
        e, mesh, checkpoint_cb=cps.append, **RES_KW)
    assert sk.launches["hash_insert"] > 0 and r["closure"] == "cuda"
    assert {k: r.get(k) for k in want["result"]} == want["result"]
    assert [_digest(c) for c in cps] == want["cps"]
