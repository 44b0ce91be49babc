"""The port's host frontier checkers, `linear` (knossos's JIT
linearization over Model objects) and `packed` (the same search over the
device encoding's ints), against the reference's on the CPU: through the
checker on the 13 golden histories and on seeded random register,
queue and set histories and their corrupted twins — the verdict, `op`,
`configs`, `final-paths` from the state-bounded WGL re-search,
`oracle-disagreement`, and every search counter — and directly
(`linear.analysis`, `linear_packed.analysis`) with their config budget,
cancel and EncodeError behaviour."""

import json
import pathlib
import threading

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import linear as ref_linear
from jepsen_tpu.checker import linear_packed as ref_packed
from jepsen_tpu.checker.linearizable import Linearizable as RefLinearizable
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.parallel.encode import EncodeError as RefEncodeError
from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.checker import linear, linear_packed
from jepsen_tpu_torch.checker.linearizable import Linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel.encode import EncodeError
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


def _golden(entry):
    text = (GOLDEN / entry["file"]).read_text()
    name = MODEL_NAMES[entry["model"]]
    return (getattr(ref_models, name)(), RefHistory.from_edn(text).index(),
            getattr(models, name)(), History.from_edn(text).index())


@pytest.mark.parametrize("algo", ["linear", "packed"])
@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_golden_corpus_matches_reference(entry, algo):
    rm, rh, pm, ph = _golden(entry)
    want = RefLinearizable(rm, algo).check({}, rh)
    got = Linearizable(pm, algo).check({}, ph)
    assert got == want
    assert got["valid?"] is entry["valid"]
    if got["valid?"] is False and len(ph) <= 1000:
        assert got["final-paths"], "the WGL re-search attaches paths"


RANDOM = {
    "register": ("rand_register_history", "CASRegister",
                 {"n_ops": 120, "n_processes": 5, "crash_p": 0.03,
                  "fail_p": 0.05}),
    "register-wide": ("rand_register_history", "CASRegister",
                      {"n_ops": 300, "n_processes": 8, "crash_p": 0.01}),
    "uqueue": ("rand_queue_history", "UnorderedQueue",
               {"n_ops": 80, "n_processes": 6, "crash_p": 0.02}),
    "fifo": ("rand_fifo_history", "FIFOQueue",
             {"n_ops": 80, "n_processes": 5, "crash_p": 0.02}),
    "gset": ("rand_gset_history", "GSet",
             {"n_ops": 60, "n_processes": 6, "n_elements": 8,
              "crash_p": 0.02}),
}


def _random(name, seed, corrupt):
    gen, model, kw = RANDOM[name]
    rh = getattr(ref_histories, gen)(seed=seed, **kw)
    ph = getattr(histories, gen)(seed=seed, **kw)
    if corrupt:
        rh = ref_histories.corrupt_history(rh, seed=seed)
        ph = histories.corrupt_history(ph, seed=seed)
    return (getattr(ref_models, model)(), rh, getattr(models, model)(), ph)


@pytest.mark.parametrize("algo", ["linear", "packed"])
@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_histories_match_reference(name, seed, corrupt, algo):
    rm, rh, pm, ph = _random(name, seed, corrupt)
    want = RefLinearizable(rm, algo).check({}, rh)
    got = Linearizable(pm, algo).check({}, ph)
    assert got == want


@pytest.mark.parametrize("name", ["register", "uqueue", "gset"])
def test_module_analyses_match_reference(name):
    """The search counters (explored, max-frontier) and, on failure, the
    op the frontier localizes, before any re-search."""
    rm, rh, pm, ph = _random(name, 3, True)
    assert linear.analysis(pm, ph) == ref_linear.analysis(rm, rh)
    assert linear_packed.analysis(pm, ph) == ref_packed.analysis(rm, rh)


def test_config_budget_and_cancel_match_reference():
    rm, rh, pm, ph = _random("register-wide", 1, False)
    assert linear.analysis(pm, ph, max_configs=3) == \
        ref_linear.analysis(rm, rh, max_configs=3)
    assert linear_packed.analysis(pm, ph, max_configs=3) == \
        ref_packed.analysis(rm, rh, max_configs=3)
    stop = threading.Event()
    stop.set()
    for mod, ref in ((linear, ref_linear), (linear_packed, ref_packed)):
        got = mod.analysis(pm, ph, cancel=stop)
        assert got == ref.analysis(rm, rh, cancel=stop)
        assert got["error"] == "cancelled" and "timeout" not in got


def test_packed_falls_back_to_wgl_when_the_history_does_not_encode():
    kw = {"n_ops": 80, "k_crashed": 70}
    rh = ref_histories.adversarial_register_history(**kw)
    ph = histories.adversarial_register_history(**kw)
    with pytest.raises(EncodeError):
        linear_packed.analysis(models.CASRegister(None), ph)
    with pytest.raises(RefEncodeError):
        ref_packed.analysis(ref_models.CASRegister(None), rh)
    want = RefLinearizable(ref_models.CASRegister(None), "packed").check(
        {}, rh)
    got = Linearizable(models.CASRegister(None), "packed").check({}, ph)
    assert got["analyzer"] == "wgl" and "fallback" in got
    assert got == want


def test_oracle_disagreement_is_flagged(monkeypatch):
    """An engine that says invalid where the WGL oracle finds a
    linearization: the result keeps the verdict and says so."""
    rm, rh, pm, ph = _random("register", 1, False)
    bogus = {"valid?": False, "final-paths": [], "configs": []}
    for mod in (linear, ref_linear):
        monkeypatch.setattr(mod, "analysis", lambda *a, **k: dict(bogus))
    want = RefLinearizable(rm, "linear").check({}, rh)
    got = Linearizable(pm, "linear").check({}, ph)
    assert got["oracle-disagreement"] is True
    assert got == want
