"""The port's jepsen.independent (jepsen_tpu_torch.independent) against
the reference's (jepsen_tpu.independent): the keyed-history helpers, and
the lifted linearizability checker — the port's "torch" arm on the CPU
(every key in one batched scan) against the reference's "jax" arm (its
device batch on the CPU), and the "wgl" arms — on the reference tests'
keyed history and a larger one. `valid?`, `failures` and every per-key
field but `analyzer` and `closure` must match. Also the device contract:
an EncodeError takes the per-key path with the reference's
"not-encodable" record, and any other device error surfaces."""

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import independent as ref_independent
from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import linearizable as ref_linearizable
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu_torch import independent, models
from jepsen_tpu_torch.checker.core import Checker
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import closure_kernels as ck
from jepsen_tpu_torch.parallel import engine


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _op(process, typ, f, value):
    return {"process": process, "type": typ, "f": f, "value": value}


def _keyed(per_key: dict, kv):
    """One history of the per-key op lists, keys interleaved op by op,
    each key's processes its own, values wrapped with `kv`."""
    lists = [[dict(o, process=o["process"] + 100 * i, value=kv(k,
                                                              o["value"]))
              for o in ops] for i, (k, ops) in enumerate(per_key.items())]
    out = []
    for j in range(max(map(len, lists))):
        out += [ops[j] for ops in lists if j < len(ops)]
    return out


def _small():
    """The reference tests' keyed history: x linearizable, y not (a read
    of 5, never written)."""
    return {"x": [_op(0, "invoke", "write", 1), _op(0, "ok", "write", 1),
                  _op(0, "invoke", "read", None), _op(0, "ok", "read", 1)],
            "y": [_op(1, "invoke", "write", 2), _op(1, "ok", "write", 2),
                  _op(1, "invoke", "read", None), _op(1, "ok", "read", 5)]}


def _large():
    """12 keys of the bench's multi-key shape at 60 ops (4 processes), a
    third of them corrupted."""
    out = {}
    for k in range(12):
        h = ref_histories.rand_register_history(
            n_ops=60, n_processes=4, n_values=5, crash_p=0.01, fail_p=0.05,
            busy=0.8, seed=900 + k)
        if k % 3 == 1:
            h = ref_histories.corrupt_history(h, seed=k)
        out[f"k{k}"] = [{f: o.get(f) for f in ("process", "type", "f",
                                               "value")} for o in h]
    return out


def _both(per_key):
    ref = RefHistory.wrap(_keyed(per_key, ref_independent.KV)).index()
    port = History.wrap(_keyed(per_key, independent.KV)).index()
    return ref, port


def _strip(r):
    return {k: v for k, v in r.items() if k not in ("analyzer", "closure")}


def _assert_same(got, want):
    assert got["valid?"] == want["valid?"]
    assert got["failures"] == want["failures"]
    assert list(got["results"]) == list(want["results"])
    for k in want["results"]:
        assert _strip(got["results"][k]) == _strip(want["results"][k]), k


# ------------------------------------------------------------ the helpers

def test_ktuple_and_keys():
    t = independent.ktuple("x", 5)
    assert t.key == "x" and t.value == 5 and tuple(t) == ("x", 5)
    assert independent.is_tuple(t) and not independent.is_tuple(("x", 5))
    _, h = _both(_small())
    h.insert(0, {"process": "nemesis", "type": "info", "f": "kill",
                 "value": None})
    h.insert(4, {"process": "nemesis", "type": "info", "f": "start",
                 "value": None})
    assert independent.history_keys(h) == ["x", "y"]
    subs = independent.split_history(h)
    assert list(subs) == ["x", "y"]
    for k in subs:
        assert list(subs[k]) == list(independent.subhistory(k, h))
    assert [o["f"] for o in subs["x"]] == ["kill", "write", "write",
                                           "start", "read", "read"]
    assert subs["y"][-1]["value"] == 5            # unwrapped
    assert subs["y"][0]["f"] == "kill"            # the un-keyed prefix


def test_kv_history_reinterprets_vectors():
    h = History.wrap([_op(0, "invoke", "w", [3, 9]), _op(0, "ok", "w", [3, 9]),
                      _op("nemesis", "info", "partition", ["n1", "n2"])])
    h2 = independent.kv_history(h)
    assert independent.history_keys(h2) == [3]
    assert h2[2]["value"] == ["n1", "n2"]


# ------------------------------------------------- the lifted checker

@pytest.mark.parametrize("shape", ["small", "large"])
def test_torch_arm_matches_the_reference_device_batch(shape):
    per_key = _small() if shape == "small" else _large()
    ref_h, port_h = _both(per_key)
    want = ref_independent.checker(ref_linearizable(
        ref_models.CASRegister(), algorithm="jax")).check({}, ref_h)
    ck.reset_launches()
    got = independent.checker(linearizable(
        models.CASRegister(), algorithm="torch", device="cpu")).check(
            {}, port_h)
    _assert_same(got, want)
    assert want["valid?"] is False and got["failures"]
    for r in got["results"].values():
        assert r["analyzer"] == "torch" and r["closure"] == "torch"
        assert r["engine"] == "bitdense"   # the batch, not single checks
    assert "device-fallback" not in got
    assert ck.batch_launches == 0          # the plain closure on the CPU


@pytest.mark.parametrize("shape", ["small", "large"])
def test_wgl_arm_matches_the_reference_host_path(shape):
    per_key = _small() if shape == "small" else _large()
    ref_h, port_h = _both(per_key)
    want = ref_independent.checker(ref_linearizable(
        ref_models.CASRegister(), algorithm="wgl")).check({}, ref_h)
    got = independent.checker(linearizable(
        models.CASRegister(), algorithm="wgl")).check({}, port_h)
    _assert_same(got, want)
    assert "device-fallback" not in got
    assert all(r["analyzer"] == "wgl" for r in got["results"].values())


def test_model_from_the_test_map_and_batch_device_off():
    _, h = _both(_small())
    r = independent.checker(linearizable(device="cpu")).check(
        {"model": models.CASRegister()}, h)
    assert r["failures"] == ["y"]
    assert r["results"]["x"]["engine"] == "bitdense"
    one_by_one = independent.checker(
        linearizable(models.CASRegister(), device="cpu"),
        batch_device=False).check({}, h)
    assert one_by_one["failures"] == ["y"]
    assert "slots" in one_by_one["results"]["x"]   # single-key checks


def test_not_encodable_takes_the_per_key_path_with_the_record():
    """A set key with 40 distinct elements cannot be packed: both
    packages say so in a "not-encodable" record and check each key on
    its own, the encodable ones still on the device."""
    big = []
    for v in range(40):
        big += [_op(0, "invoke", "add", v), _op(0, "ok", "add", v)]
    small = [_op(1, "invoke", "add", 1), _op(1, "ok", "add", 1),
             _op(1, "invoke", "read", None), _op(1, "ok", "read", [1])]
    ref_h, port_h = _both({"big": big, "small": small})
    want = ref_independent.checker(ref_linearizable(
        ref_models.GSet(), algorithm="jax")).check({}, ref_h)
    got = independent.checker(linearizable(
        models.GSet(), algorithm="torch", device="cpu")).check({}, port_h)
    _assert_same(got, want)
    assert got["resilience"]["class"] == "not-encodable"
    assert {k: v for k, v in got["resilience"].items() if k != "backend"} \
        == {k: v for k, v in want["resilience"].items() if k != "backend"}
    assert got["resilience"]["backend"] == "cpu"
    assert got["device-fallback"] == want["device-fallback"]
    assert got["results"]["big"]["valid?"] is True
    assert "fallback" in got["results"]["big"]     # the host WGL search


def test_a_device_error_surfaces(monkeypatch):
    """The reference falls back to the host on any batch error; the port
    does not hide the device: the error reaches the caller."""
    _, h = _both(_small())

    def boom(*a, **kw):
        raise RuntimeError("closure kernel batched launch failed")

    monkeypatch.setattr(ck, "closure_scan_batch", boom)
    c = independent.checker(linearizable(models.CASRegister(),
                                         device="cpu"))
    with pytest.raises(RuntimeError, match="batched launch failed"):
        c.check({}, h)
    monkeypatch.setattr(engine, "check_batch", boom)
    with pytest.raises(RuntimeError, match="batched launch failed"):
        c.check({}, h)


def test_without_a_card_the_torch_arm_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, h = _both(_small())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        independent.checker(linearizable(models.CASRegister())).check({}, h)


def test_lifts_any_checker():
    seen = []

    class Count(Checker):
        def check(self, test, history, opts=None):
            seen.append(opts.get("history-key"))
            return {"valid?": True, "n": len(history)}

    _, h = _both(_small())
    r = independent.checker(Count()).check({}, h)
    assert r == {"valid?": True, "failures": [],
                 "results": {"x": {"valid?": True, "n": 4},
                             "y": {"valid?": True, "n": 4}}}
    assert seen == ["x", "y"]
