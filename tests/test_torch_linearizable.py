"""The port's checker end to end on the CPU (plain closures) against the
reference's `algorithm="jax"` checker: the golden corpus (the queue and
set files through the sparse engine, against the reference's hash
dedupe), long invalid histories whose counterexamples are seeded from
the device's configurations (the > 500-call window branch, on the dense
and on the sparse engine), the routes (EncodeError -> host WGL, too wide
for the dense engine -> the sparse engine), the device contract (no card
and no device="cpu" -> RuntimeError) and the checker combinators. Every
field but `analyzer`/`closure` must match."""

import json
import pathlib

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import core as ref_core
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.parallel import bitdense as ref_bd
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.checker import core
from jepsen_tpu_torch.checker.linearizable import Linearizable
from jepsen_tpu_torch.history import History
from torch_jax_cache import release_compiled_programs  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden"
MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())
MODEL_NAMES = {"cas-register": "CASRegister", "fifo-queue": "FIFOQueue",
               "unordered-queue": "UnorderedQueue", "set": "GSet",
               "mutex": "Mutex"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _strip(r):
    return {k: v for k, v in r.items() if k not in ("analyzer", "closure")}


def _golden(entry):
    text = (GOLDEN / entry["file"]).read_text()
    name = MODEL_NAMES[entry["model"]]
    return (getattr(ref_models, name)(), RefHistory.from_edn(text).index(),
            getattr(models, name)(), History.from_edn(text).index())


def _fits_dense(model, h) -> bool:
    e = ref_enc.encode(model, h)
    return ref_bd.fits_bitdense(e.n_states, e.n_slots)


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_golden_corpus_matches_reference(entry, monkeypatch):
    """Every golden history gives the reference's whole result. The queue
    and set files pack to more than 128 model states, so both packages
    send them to the sparse engine; the port's default dedupe is "hash",
    so the reference runs with its hash dedupe too."""
    rm, rh, pm, ph = _golden(entry)
    if not _fits_dense(rm, rh):
        monkeypatch.setenv("JEPSEN_TPU_DEDUPE", "hash")
    want = RefLinearizable(rm, "jax").check({}, rh)
    assert want["valid?"] is entry["valid"]
    got = Linearizable(pm, "torch", device="cpu").check({}, ph)
    assert got["analyzer"] == "torch" and got["closure"] == "torch"
    assert _strip(got) == _strip(want)


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_golden_corpus_wgl_arm_matches_reference(entry):
    rm, rh, pm, ph = _golden(entry)
    want = RefLinearizable(rm, "wgl").check({}, rh)
    got = Linearizable(pm, "wgl").check({}, ph)
    assert got == want


def test_long_invalid_history_window_counterexample():
    """Over 500 calls the counterexample is searched in a window before
    the failure from the first 8 live configurations of the device's
    reachable set: same window, seeds, paths and configs as the
    reference, whose seeds come from its sparse re-scan."""
    kw = {"n_ops": 600, "k_crashed": 6}
    rh = ref_histories.with_impossible_read(
        ref_histories.adversarial_register_history(**kw))
    ph = histories.with_impossible_read(
        histories.adversarial_register_history(**kw))
    want = RefLinearizable(ref_models.CASRegister(None), "jax").check({}, rh)
    got = Linearizable(models.CASRegister(None), "torch",
                       device="cpu").check({}, ph)
    assert got["valid?"] is False and want["valid?"] is False
    assert got["final-paths-window"] == want["final-paths-window"]
    assert got["final-paths"] == want["final-paths"]
    assert got["configs"] == want["configs"]
    assert _strip(got) == _strip(want)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_register_histories_match_reference(seed):
    rh = ref_histories.rand_register_history(n_ops=150, seed=seed)
    ph = histories.rand_register_history(n_ops=150, seed=seed)
    for a, b in ((rh, ph), (ref_histories.corrupt_history(rh, seed=seed),
                            histories.corrupt_history(ph, seed=seed))):
        want = RefLinearizable(ref_models.CASRegister(None), "jax") \
            .check({}, a)
        got = Linearizable(models.CASRegister(None), device="cpu") \
            .check({}, b)
        assert _strip(got) == _strip(want)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = histories.rand_register_history(n_ops=20, seed=1)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        Linearizable(models.CASRegister(None)).check({}, h)


def test_long_invalid_sparse_history_window_counterexample(monkeypatch):
    """An invalid unordered-queue history of 550 calls: the sparse engine
    finds the failure, and the counterexample is searched in a window
    before it from the first 8 rows of the sparse sort re-scan — the
    reference's window, seeds, paths and configs."""
    monkeypatch.setenv("JEPSEN_TPU_DEDUPE", "hash")
    kw = {"n_ops": 550, "n_processes": 8, "crash_p": 0.005, "seed": 1}
    rh = ref_histories.corrupt_history(
        ref_histories.rand_queue_history(**kw), seed=1)
    ph = histories.corrupt_history(histories.rand_queue_history(**kw),
                                   seed=1)
    want = RefLinearizable(ref_models.UnorderedQueue(), "jax").check({}, rh)
    got = Linearizable(models.UnorderedQueue(), "torch",
                       device="cpu").check({}, ph)
    assert got["valid?"] is False and want["valid?"] is False
    assert not _fits_dense(ref_models.UnorderedQueue(), rh)
    assert got["final-paths-window"] == want["final-paths-window"]
    assert got["final-paths"] == want["final-paths"]
    assert got["configs"] == want["configs"]
    assert _strip(got) == _strip(want)


def test_too_wide_for_the_dense_engine_raises_not_implemented():
    """26 open-call slots are past the dense engine's 24: the history
    runs on the sparse engine, which — as the reference's does — runs
    out of frontier capacity and says "unknown"."""
    kw = {"n_ops": 60, "k_crashed": 25}
    want = ref_engine.analysis(
        ref_models.CASRegister(None),
        ref_histories.adversarial_register_history(**kw),
        max_capacity=1024, dedupe="hash")
    got = Linearizable(models.CASRegister(None), device="cpu",
                       max_capacity=1024).check(
        {}, histories.adversarial_register_history(**kw))
    assert want["valid?"] == "unknown"
    assert got["closure"] == "torch"
    assert _strip(got) == want


def test_unencodable_history_falls_back_to_host_wgl():
    kw = {"n_ops": 80, "k_crashed": 70}
    want = RefLinearizable(ref_models.CASRegister(None), "jax").check(
        {}, ref_histories.adversarial_register_history(**kw))
    got = Linearizable(models.CASRegister(None), device="cpu").check(
        {}, histories.adversarial_register_history(**kw))
    assert "fallback" in got
    assert _strip(got) == _strip(want)


def test_checker_guards():
    h = histories.rand_register_history(n_ops=10, seed=1)
    with pytest.raises(ValueError, match="requires a model"):
        Linearizable(None, device="cpu").check({}, h)
    with pytest.raises(ValueError, match="unknown linearizability"):
        Linearizable(models.CASRegister(None), "jax").check({}, h)
    with pytest.raises(ValueError, match="recognizable"):
        Linearizable(models.CASRegister(None), device="cpu").check(
            {}, [{"process": 0, ":type": "invoke"}])
    # the model may come from the test map
    r = Linearizable(device="cpu").check(
        {"model": models.CASRegister(None)}, h)
    assert r["valid?"] is True


def test_truncates_counterexamples_to_ten():
    from jepsen_tpu_torch.checker.linearizable import _truncate
    r = _truncate({"final-paths": list(range(30)), "configs": [1] * 12})
    assert r["final-paths"] == list(range(10)) and len(r["configs"]) == 10


@pytest.mark.parametrize("vs", [[], [True], [True, "unknown"], [False, True],
                                ["unknown", False, True], [None]])
def test_merge_valid_matches_reference(vs):
    assert core.merge_valid(vs) == ref_core.merge_valid(vs)
    for v in vs:
        assert core.valid_priority(v) == ref_core.valid_priority(v)


def test_compose_and_check_safe():
    class Boom(core.Checker):
        def check(self, test, history, opts=None):
            raise RuntimeError("boom")

    h = histories.rand_register_history(n_ops=20, seed=2)
    out = core.compose({
        "lin": Linearizable(models.CASRegister(None), device="cpu"),
        "boom": Boom()}).check({}, h, {})
    assert out["lin"]["valid?"] is True
    assert out["boom"]["valid?"] == "unknown"
    assert "boom" in out["boom"]["error"]
    assert out["valid?"] == "unknown"
