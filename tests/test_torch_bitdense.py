"""The port's bitdense engine (jepsen_tpu_torch.parallel.bitdense, on
the CPU with the plain closure) against the reference's
(jepsen_tpu.parallel.bitdense) on the identical encoded input, carried
across with `encoded_from_arrays`: every result field but `closure`
must match, for clean and corrupted histories of every model family.
Also the static tables, and the live-configuration readout that seeds
long-history counterexamples against the reference's sparse re-scan
(its row order decides which 8 seeds are searched)."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.parallel import bitdense as ref_bd
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu_torch.parallel import bitdense as bd
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import engine
from torch_jax_cache import release_compiled_programs  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden"

CASES = {
    # name: (generator, kwargs, model)
    "register": ("rand_register_history", {"n_ops": 120},
                 ref_models.CASRegister),
    "register-crashy": ("rand_register_history",
                        {"n_ops": 150, "crash_p": 0.12},
                        ref_models.CASRegister),
    # queue and set states are packed lanes, so S grows as 2^bits: these
    # sizes keep S <= 128, inside the dense engine
    "gset": ("rand_gset_history", {"n_ops": 80, "n_elements": 6},
             ref_models.GSet),
    "uqueue": ("rand_queue_history",
               {"n_ops": 20, "n_values": 2, "deq_p": 0.45},
               ref_models.UnorderedQueue),
    "fifo": ("rand_fifo_history", {"n_ops": 16, "n_values": 2, "deq_p": 0.6},
             ref_models.FIFOQueue),
    "adversarial": ("adversarial_register_history",
                    {"n_ops": 160, "k_crashed": 7}, ref_models.CASRegister),
}


def _to_port(e):
    arrays = {k: getattr(e, k) for k in enc.ARRAY_FIELDS}
    calls = [dataclasses.asdict(c) for c in e.calls]
    meta = {k: getattr(e, k) for k in ("state0", "step_name", "n_calls",
                                       "n_slots", "state_lo", "n_states",
                                       "model_pruned")}
    meta["intern"] = list(e.intern._values)
    return enc.encoded_from_arrays(arrays, calls, meta)


def _history(name, corrupt: bool, seed: int = 3):
    gen, kw, model = CASES[name]
    h = getattr(ref_histories, gen)(seed=seed, **kw)
    if corrupt:
        h = ref_histories.corrupt_history(h, seed=seed)
    return model(), h


def _assert_same(ref, got):
    assert got["closure"] == "torch"
    want = {k: v for k, v in ref.items() if k != "closure"}
    have = {k: v for k, v in got.items() if k != "closure"}
    assert have == want


@pytest.fixture(autouse=True)
def _one_torch_thread():
    # the plain path is many small ops: on a shared CPU, intra-op threads
    # cost far more than they save
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("corrupt", [False, True], ids=["clean", "corrupt"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_check_matches_reference(name, corrupt, seed):
    model, h = _history(name, corrupt, seed)
    e = ref_enc.encode(model, h)
    assert bd.fits_bitdense(e.n_states, e.n_slots)
    _assert_same(ref_bd.check_encoded_bitdense(e),
                 bd.check_encoded_bitdense(_to_port(e), device="cpu"))


@pytest.mark.parametrize("f", ["mutex-valid.edn", "mutex-invalid.edn",
                               "register-invalid.edn",
                               "register-1k-crashheavy-invalid.edn"])
def test_check_matches_reference_on_golden(f):
    model = {"mutex": ref_models.Mutex,
             "register": ref_models.CASRegister}[f.split("-")[0]]()
    h = RefHistory.from_edn((GOLDEN / f).read_text()).index()
    e = ref_enc.encode(model, h)
    _assert_same(ref_bd.check_encoded_bitdense(e),
                 bd.check_encoded_bitdense(_to_port(e), device="cpu"))


def test_empty_history_is_valid():
    e = ref_enc.encode(ref_models.CASRegister(None), RefHistory())
    assert bd.check_encoded_bitdense(_to_port(e), device="cpu") \
        == ref_bd.check_encoded_bitdense(e)


@pytest.mark.parametrize("n_states,n_slots", [
    (1, 1), (18, 13), (22, 17), (128, 12), (129, 5), (2, 24), (2, 25),
    (64, 20), (40, 16), (128, 18)])
def test_fits_bitdense_matches_reference(n_states, n_slots):
    assert bd.fits_bitdense(n_states, n_slots) \
        == ref_bd.fits_bitdense(n_states, n_slots)


@pytest.mark.parametrize("C", [1, 5, 6, 13])
def test_plan_tables_match_reference(C):
    W, plan = bd._plan(C)
    W_ref, plan_ref = ref_bd._plan(C)
    assert W == W_ref
    for a, b in zip(plan, plan_ref):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    for j in range(5):
        assert bd._intra_clear(j) == int(ref_bd._intra_clear(j))


@pytest.mark.parametrize("start_ev", [1, 40, 200])
def test_frontier_rows_match_reference_sparse_rescan(start_ev):
    """The reference reads the live configurations from its sparse
    engine, sorted by (state, mask_lo, mask_hi) after its sort dedupe;
    the port reads them from B. Same set, same order."""
    h = ref_histories.adversarial_register_history(n_ops=300, k_crashed=6)
    e = ref_enc.encode(ref_models.CASRegister(None), h)
    want = ref_engine._frontier_at(e, start_ev)
    got = engine._frontier_at(_to_port(e), start_ev, device="cpu")
    assert len(want) > 8
    assert got == want


def test_frontier_rows_match_on_a_crashy_random_history():
    model, h = _history("register-crashy", False, seed=8)
    e = ref_enc.encode(model, h)
    for start_ev in (e.n_returns // 3, e.n_returns - 1):
        assert engine._frontier_at(_to_port(e), start_ev, device="cpu") \
            == ref_engine._frontier_at(e, start_ev)


def test_check_needs_a_device_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, h = _history("register", False)
    e = _to_port(ref_enc.encode(model, h))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bd.check_encoded_bitdense(e)
