"""The port's competition race (`checker/competition.py`, the checker's
`algorithm="competition"`): the first decisive verdict wins and the
losers are cooperatively cancelled, the device arm too; the result
equals the reference's result of the arm that won in the port (minus
timing fields and the race's own tags); a crashed host arm loses, a
device arm that raises makes the race raise, a race whose arms all
stall ends "unknown" at its timeout, a wedged device arm cannot hang
the race, the host arms run in forked children that the race's cancel
ends, and the arms are the reference's: torch + packed + wgl for a
packable model (on the card only when it answers; a probe that answers
that there is none raises), linear + wgl for any other. On the CPU the
torch arm is the plain PyTorch engine (device="cpu")."""

import json
import multiprocessing
import os
import pathlib
import threading
import time

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import linear as ref_linear
from jepsen_tpu.checker import linear_packed as ref_packed
from jepsen_tpu.checker import wgl as ref_wgl
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.checker.linearizable import _truncate as ref_truncate
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu_torch import histories, independent, models
from jepsen_tpu_torch.checker import competition, linear_packed, wgl
from jepsen_tpu_torch.checker import linearizable as lz
from jepsen_tpu_torch.checker.linearizable import Linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import Model, inconsistent
from jepsen_tpu_torch.parallel import engine
from torch_jax_cache import release_compiled_programs  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden"
MANIFEST = [e for e in json.loads((GOLDEN / "manifest.json").read_text())
            if e["ops"] <= 500]
MODEL_NAMES = {"cas-register": "CASRegister", "fifo-queue": "FIFOQueue",
               "unordered-queue": "UnorderedQueue", "set": "GSet",
               "mutex": "Mutex"}
# fields that are the race's or the arm's own, not the verdict's
RACE_FIELDS = ("analyzer", "competition", "closure")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strip(r):
    return {k: v for k, v in r.items() if k not in RACE_FIELDS}


def _ref_arm(name, model, h):
    """The reference's result of one arm alone (the torch arm's is the
    reference engine's, hash dedupe as the port's)."""
    if name == "torch":
        return ref_engine.analysis(model, h, dedupe="hash")
    return {"packed": ref_packed, "linear": ref_linear,
            "wgl": ref_wgl}[name].analysis(model, h)


def _golden(entry):
    text = (GOLDEN / entry["file"]).read_text()
    name = MODEL_NAMES[entry["model"]]
    return (getattr(ref_models, name)(), RefHistory.from_edn(text).index(),
            getattr(models, name)(), History.from_edn(text).index())


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_race_equals_the_winning_arms_reference(entry):
    rm, rh, pm, ph = _golden(entry)
    got = competition.analysis(pm, ph, device_kw={"device": "cpu"})
    winner = got["competition"]["winner"]
    assert got["analyzer"] == winner
    assert got["competition"]["arms"] == ["torch", "packed", "wgl"]
    assert got["valid?"] is entry["valid"]
    assert _strip(got) == _strip(_ref_arm(winner, rm, rh))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_checker_race_on_random_histories(seed):
    kw = {"n_ops": 100, "n_processes": 5, "crash_p": 0.02, "fail_p": 0.05,
          "seed": seed}
    rh = ref_histories.corrupt_history(
        ref_histories.rand_register_history(**kw), seed=seed)
    ph = histories.corrupt_history(histories.rand_register_history(**kw),
                                   seed=seed)
    got = Linearizable(models.CASRegister(), "competition",
                       device="cpu").check({}, ph)
    winner = got["competition"]["winner"]
    assert got["analyzer"] == winner
    if winner in ("packed", "linear"):
        # the checker's WGL re-search and truncation, as the reference's
        want = RefLinearizable(ref_models.CASRegister(), winner).check(
            {}, rh)
    else:
        want = ref_truncate(_ref_arm(winner, ref_models.CASRegister(), rh))
    assert _strip(got) == _strip(want)


def _host_fault(*a, **k):
    raise RuntimeError("host fault")


def test_crashed_arm_loses(monkeypatch):
    """A host arm that raises loses; the others decide."""
    monkeypatch.setattr(linear_packed, "analysis", _host_fault)
    h = histories.rand_register_history(n_ops=40, n_processes=4, seed=11)
    r = competition.analysis(models.CASRegister(), h,
                             device_kw={"device": "cpu"})
    assert r["valid?"] is True
    assert r["analyzer"] in ("torch", "wgl")


def test_all_arms_crashed_or_indecisive_is_unknown(monkeypatch):
    monkeypatch.setattr(engine, "analysis",
                        lambda *a, **k: {"valid?": "unknown",
                                         "error": "frontier overflow"})
    monkeypatch.setattr(linear_packed, "analysis", _host_fault)
    monkeypatch.setattr(wgl, "analysis",
                        lambda *a, **k: {"valid?": "unknown",
                                         "timeout": True})
    h = histories.rand_register_history(n_ops=20, seed=1)
    r = competition.analysis(models.CASRegister(), h)
    assert r["valid?"] == "unknown"
    assert r["analyzer"] == "competition"
    assert r["competition"]["winner"] is None
    res = r["competition"]["results"]
    assert "host fault" in res["packed"]["error"]
    assert res["torch"]["error"] == "frontier overflow"


@pytest.mark.parametrize("via", ["race", "checker"])
def test_a_failing_device_arm_raises(monkeypatch, via):
    """A device arm that raises (a kernel that does not build or launch)
    is not a lost arm: the race stops the host arms and raises its
    error, though a host arm would have decided."""
    def fault(*a, **k):
        raise RuntimeError("K2 did not launch")

    def slow(model, history, cancel=None, **kw):
        cancel.wait(60)
        return {"valid?": True}

    monkeypatch.setattr(engine, "analysis", fault)
    monkeypatch.setattr(linear_packed, "analysis", slow)
    monkeypatch.setattr(wgl, "analysis", slow)
    monkeypatch.setattr(competition, "HOST_CANCEL_GRACE_SECS", 0.5)
    h = histories.rand_register_history(n_ops=20, seed=1)
    with pytest.raises(RuntimeError, match="K2 did not launch"):
        if via == "race":
            competition.analysis(models.CASRegister(), h)
        else:
            Linearizable(models.CASRegister(), "competition",
                         device="cpu").check({}, h)
    t0 = time.monotonic()
    while multiprocessing.active_children() and time.monotonic() - t0 < 30:
        time.sleep(0.05)
    assert not multiprocessing.active_children()


def test_a_losing_device_arm_stops(monkeypatch):
    """The winner's verdict reaches the device arm through
    `engine.analysis`'s cancel; the race returns once it has stopped."""
    polls = []

    def device(model, history, cancel=None, **kw):
        while not cancel.is_set():
            polls.append(1)
            time.sleep(0.01)
        return {"valid?": "unknown", "error": "cancelled"}

    monkeypatch.setattr(engine, "analysis", device)
    monkeypatch.setattr(wgl, "analysis", lambda *a, **k: {"valid?": True})
    h = histories.rand_register_history(n_ops=20, seed=1)
    r = competition.analysis(models.CASRegister(), h,
                             arms=("torch", "wgl"))
    assert r["analyzer"] == "wgl" and r["valid?"] is True
    assert not [t for t in threading.enumerate()
                if t.name == "competition-torch"]


class _SetAfter:
    """A cancel that is set from its n-th poll on; counts its polls."""

    def __init__(self, n):
        self.n, self.polls = n, 0

    def is_set(self):
        self.polls += 1
        return self.polls > self.n


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_engine_analysis_stops_at_its_cancel(kind):
    """The device engine polls `cancel` once an event: set before the
    scan it stops at once, set on the 5th poll it stops there, with
    valid? "unknown" and error "cancelled"; unset it decides."""
    if kind == "dense":
        model = models.CASRegister()
        h = histories.rand_register_history(n_ops=60, n_processes=4,
                                            seed=3)
    else:
        model = models.FIFOQueue()
        h = histories.rand_fifo_history(60, n_processes=4, seed=3)
    for n in (0, 5):
        c = _SetAfter(n)
        r = engine.analysis(model, h, device="cpu", cancel=c)
        assert r == {"valid?": "unknown", "error": "cancelled"}
        assert c.polls == n + 1
    c = _SetAfter(10 ** 9)
    r = engine.analysis(model, h, device="cpu", cancel=c)
    assert r["valid?"] in (True, False) and c.polls > 5
    assert r["engine" if kind == "dense" else "dedupe"] == (
        "bitdense" if kind == "dense" else "hash")


def test_race_timeout_gives_unknown(monkeypatch):
    stop = threading.Event()

    def stall(*a, **k):
        stop.wait(300)
        return {"valid?": "unknown"}

    def stall_host(model, history, cancel=None, **kw):
        cancel.wait(300)
        return {"valid?": "unknown", "error": "cancelled"}

    monkeypatch.setattr(engine, "analysis", stall)
    for mod in (linear_packed, wgl):
        monkeypatch.setattr(mod, "analysis", stall_host)
    t0 = time.monotonic()
    r = Linearizable(models.CASRegister(), "competition", device="cpu") \
        .check({"competition-timeout": 1.0},
               histories.rand_register_history(n_ops=20, seed=1))
    elapsed = time.monotonic() - t0
    stop.set()
    assert r["valid?"] == "unknown"
    assert "in time" in r["error"]
    assert elapsed < 30, elapsed


def test_losers_are_cancelled(monkeypatch):
    """The winner's verdict sets the race's cancel: a host arm's child
    that polls it returns at once (cooperative cancel), one that does not
    is terminated HOST_CANCEL_GRACE_SECS later."""
    monkeypatch.setattr(engine, "analysis",
                        lambda *a, **k: {"valid?": True})

    def polls(model, history, cancel=None, **kw):
        cancel.wait(60)
        return {"valid?": "unknown", "error": "cancelled"}

    def ignores(model, history, cancel=None, **kw):
        time.sleep(60)
        return {"valid?": True}

    monkeypatch.setattr(linear_packed, "analysis", polls)
    monkeypatch.setattr(wgl, "analysis", ignores)
    monkeypatch.setattr(competition, "HOST_CANCEL_GRACE_SECS", 0.5)
    h = histories.rand_register_history(n_ops=20, seed=1)
    r = competition.analysis(models.CASRegister(), h)
    assert r["analyzer"] == "torch" and r["valid?"] is True
    t0 = time.monotonic()
    while multiprocessing.active_children() and time.monotonic() - t0 < 30:
        time.sleep(0.05)
    assert time.monotonic() - t0 < 15
    assert not multiprocessing.active_children()


def test_a_host_arm_that_dies_loses(monkeypatch):
    """A host arm's child that exits without answering is a crashed arm;
    the others decide."""
    monkeypatch.setattr(linear_packed, "analysis",
                        lambda *a, **k: os._exit(3))
    h = histories.rand_register_history(n_ops=40, n_processes=4, seed=11)
    r = competition.analysis(models.CASRegister(), h,
                             device_kw={"device": "cpu"})
    assert r["valid?"] is True and r["analyzer"] in ("torch", "wgl")


def test_wedged_device_arm_is_bounded_and_suspected(monkeypatch):
    """A device arm that never returns: the host arms decide; with them
    indecisive the wait is bounded by DEVICE_ARM_GRACE_SECS, and the
    orphaned arm makes later races skip the device until it reports."""
    monkeypatch.setattr(competition, "DEVICE_ARM_GRACE_SECS", 1.0)
    monkeypatch.setattr(competition, "DEVICE_CANCEL_GRACE_SECS", 0.2)
    monkeypatch.setattr(competition, "DEVICE_WEDGE_SUSPECT_SECS", 0.0)
    wedge = threading.Event()

    def wedged(*a, **k):
        wedge.wait(300)
        return {"valid?": "unknown"}

    monkeypatch.setattr(engine, "analysis", wedged)
    h = histories.rand_register_history(n_ops=30, n_processes=4, seed=11)
    r = competition.analysis(models.CASRegister(), h)
    assert r["valid?"] is True and r["analyzer"] in ("packed", "wgl")
    assert [t for t in threading.enumerate()
            if t.name == "competition-torch"]
    monkeypatch.setattr(linear_packed, "analysis",
                        lambda *a, **k: {"valid?": "unknown"})
    monkeypatch.setattr(wgl, "analysis",
                        lambda *a, **k: {"valid?": "unknown"})
    t0 = time.monotonic()
    r = competition.analysis(models.CASRegister(), h)
    assert time.monotonic() - t0 < 30
    assert "'torch'" in r["error"] and "still running" in r["error"]
    time.sleep(0.05)
    assert competition.device_engine_suspect()
    monkeypatch.setattr(lz, "_engine_probe_result", True)
    arms = Linearizable(models.CASRegister(), "competition")._race(
        models.CASRegister(), h, {})["competition"]["arms"]
    assert arms == ["packed", "wgl"]
    wedge.set()
    for t in threading.enumerate():
        if t.name == "competition-torch":
            t.join(30)
    assert not competition.device_engine_suspect()


class Opaque(Model):
    """A register the packer does not know."""

    def __init__(self, v=None):
        self.v = v

    def step(self, op):
        if op.f == "write":
            return Opaque(op.value)
        if op.f == "read" and op.value is not None and op.value != self.v:
            return inconsistent(f"read {op.value} != {self.v}")
        return self

    def __eq__(self, o):
        return isinstance(o, Opaque) and self.v == o.v

    def __hash__(self):
        return hash(("Opaque", self.v))


def _h(*ops):
    return History.wrap(list(ops)).index()


def invoke_op(p, f, v):
    return {"process": p, "type": "invoke", "f": f, "value": v}


def ok_op(p, f, v):
    return {"process": p, "type": "ok", "f": f, "value": v}


@pytest.mark.parametrize("device", ["cpu", None])
def test_arms_of_a_packable_model(monkeypatch, device):
    """On the CPU, and on a card that answers, the device arm races; a
    probe that answers that there is no card raises, as the port's
    other entry points do."""
    h = histories.rand_register_history(n_ops=30, n_processes=4, seed=5)
    checker = Linearizable(models.CASRegister(), "competition",
                           device=device)
    if device is None and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            checker.check({}, h)
        return
    r = checker.check({}, h)
    assert r["competition"]["arms"] == ["torch", "packed", "wgl"]
    assert r["valid?"] is True


def test_an_unanswered_probe_races_host_arms(monkeypatch):
    """While the probe has not answered (a wedged runtime), the race
    hedges with the host arms alone."""
    monkeypatch.setattr(lz, "_engine_available", lambda: None)
    h = histories.rand_register_history(n_ops=30, n_processes=4, seed=5)
    r = Linearizable(models.CASRegister(), "competition").check({}, h)
    assert r["competition"]["arms"] == ["packed", "wgl"]
    assert r["valid?"] is True


def test_arms_of_an_unpackable_model():
    r = Linearizable(Opaque(), "competition").check({}, _h(
        invoke_op(0, "write", 2), ok_op(0, "write", 2),
        invoke_op(1, "read", None), ok_op(1, "read", 3)))
    assert r["competition"]["arms"] == ["linear", "wgl"]
    assert r["valid?"] is False and r["analyzer"] in ("linear", "wgl")
    assert r["final-paths"]


def test_engine_probe_is_bounded(monkeypatch):
    monkeypatch.setattr(lz, "_engine_probe_result", None)
    monkeypatch.setattr(lz, "_engine_probe", {})
    wedge = threading.Event()

    def hanging():
        wedge.wait(300)
        return True

    monkeypatch.setattr(torch.cuda, "is_available", hanging)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    t0 = time.monotonic()
    assert lz._engine_available(timeout=1.0) is None
    assert lz._engine_available(timeout=300.0) is None
    assert time.monotonic() - t0 < 30
    wedge.set()
    lz._engine_probe["thread"].join(30)
    assert lz._engine_available(timeout=1.0) is True


def test_independent_batches_a_competition_checker():
    h = History.wrap([
        {"process": 0, "type": "invoke", "f": "write",
         "value": independent.KV("x", 1)},
        {"process": 0, "type": "ok", "f": "write",
         "value": independent.KV("x", 1)},
        {"process": 1, "type": "invoke", "f": "read",
         "value": independent.KV("y", None)},
        {"process": 1, "type": "ok", "f": "read",
         "value": independent.KV("y", 5)}]).index()
    r = independent.checker(Linearizable(models.CASRegister(),
                                         "competition", device="cpu")) \
        .check({}, h)
    assert r["valid?"] is False and r["failures"] == ["y"]
    assert {k: v["analyzer"] for k, v in r["results"].items()} == \
        {"x": "torch", "y": "torch"}
