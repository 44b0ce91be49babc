"""The port's host encoder (jepsen_tpu_torch.parallel.encode) against the
reference's (jepsen_tpu.parallel.encode): array for array and scalar
for scalar, on the golden corpus and on seeded generator histories, and
the `encoded_from_arrays` round trip the engine tests feed both engines
through. The port's history generators must also give the reference's
histories for the same seed."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu_torch import histories, models
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import encode as enc
from torch_jax_cache import release_compiled_programs  # noqa: F401

GOLDEN = pathlib.Path(__file__).parent / "data" / "golden"
MANIFEST = json.loads((GOLDEN / "manifest.json").read_text())
MODEL_NAMES = {"cas-register": "CASRegister", "fifo-queue": "FIFOQueue",
               "unordered-queue": "UnorderedQueue", "set": "GSet",
               "mutex": "Mutex"}

GENERATED = {
    # name: (generator, kwargs, model class name)
    "register": ("rand_register_history", {"n_ops": 120}, "CASRegister"),
    "register-crashy": ("rand_register_history",
                        {"n_ops": 120, "crash_p": 0.15}, "CASRegister"),
    "gset": ("rand_gset_history", {"n_ops": 100}, "GSet"),
    "uqueue": ("rand_queue_history", {"n_ops": 100}, "UnorderedQueue"),
    "fifo": ("rand_fifo_history", {"n_ops": 100}, "FIFOQueue"),
    "adversarial": ("adversarial_register_history",
                    {"n_ops": 200, "k_crashed": 6}, "CASRegister"),
}


def _golden(entry):
    text = (GOLDEN / entry["file"]).read_text()
    name = MODEL_NAMES[entry["model"]]
    return (getattr(ref_models, name)(), RefHistory.from_edn(text).index(),
            getattr(models, name)(), History.from_edn(text).index())


def _generated(name, seed):
    gen, kw, model = GENERATED[name]
    return (getattr(ref_models, model)(),
            getattr(ref_histories, gen)(seed=seed, **kw),
            getattr(models, model)(),
            getattr(histories, gen)(seed=seed, **kw))


def _call_tuple(c):
    return tuple(getattr(c, f) for f in enc.CALL_FIELDS)


def _assert_same_encoding(a, b):
    for k in enc.ARRAY_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert (x == y).all(), k
    for k in ("state0", "step_name", "n_calls", "n_slots", "state_lo",
              "n_states", "model_pruned", "n_returns"):
        assert getattr(a, k) == getattr(b, k), k
    assert [_call_tuple(c) for c in a.calls] \
        == [_call_tuple(c) for c in b.calls]
    assert a.intern._values == b.intern._values


@pytest.mark.parametrize("entry", MANIFEST, ids=[e["file"] for e in MANIFEST])
def test_encode_matches_reference_on_golden_corpus(entry):
    rm, rh, pm, ph = _golden(entry)
    _assert_same_encoding(enc.encode(pm, ph), ref_enc.encode(rm, rh))


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", sorted(GENERATED))
def test_encode_matches_reference_on_generated(name, seed):
    rm, rh, pm, ph = _generated(name, seed)
    assert [dict(o) for o in ph] == [dict(o) for o in rh], "generator"
    _assert_same_encoding(enc.encode(pm, ph), ref_enc.encode(rm, rh))


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_history_generators_keep_their_seeds(name):
    _, rh, _, ph = _generated(name, 45100)
    assert [dict(o) for o in ph] == [dict(o) for o in rh]
    for fn in ("with_impossible_read", "corrupt_history"):
        a = getattr(ref_histories, fn)(rh)
        b = getattr(histories, fn)(ph)
        assert [dict(o) for o in b] == [dict(o) for o in a], fn


def test_prepare_finish_compose_to_encode():
    _, _, pm, ph = _generated("register-crashy", 3)
    a = enc.finish_encode(enc.prepare_encode(pm, ph))
    _assert_same_encoding(a, enc.encode(pm, ph, use_bulk=False))


def _to_plain(e):
    arrays = {k: getattr(e, k) for k in enc.ARRAY_FIELDS}
    calls = [dataclasses.asdict(c) for c in e.calls]
    meta = {k: getattr(e, k) for k in ("state0", "step_name", "n_calls",
                                       "n_slots", "state_lo", "n_states",
                                       "model_pruned")}
    meta["intern"] = list(e.intern._values)
    return arrays, calls, meta


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_encoded_from_arrays_round_trip(name):
    rm, rh, pm, ph = _generated(name, 5)
    ref = ref_enc.encode(rm, rh)
    got = enc.encoded_from_arrays(*_to_plain(ref))
    _assert_same_encoding(got, ref)
    assert got.spec is None
    # and the port's own encoding survives the same trip
    own = enc.encode(pm, ph)
    _assert_same_encoding(enc.encoded_from_arrays(*_to_plain(own)), own)


def test_fail_op_fields_match_reference():
    rm, rh, pm, ph = _generated("register", 4)
    ref, own = ref_enc.encode(rm, rh), enc.encode(pm, ph)
    for r in (0, ref.n_returns // 2, ref.n_returns - 1):
        assert enc.fail_op_fields(own, r) == ref_enc.fail_op_fields(ref, r)


def test_too_wide_window_raises_encode_error_in_both():
    kw = {"n_ops": 80, "k_crashed": 70}
    rh = ref_histories.adversarial_register_history(**kw)
    ph = histories.adversarial_register_history(**kw)
    with pytest.raises(ref_enc.EncodeError) as a:
        ref_enc.encode(ref_models.CASRegister(None), rh)
    with pytest.raises(enc.EncodeError) as b:
        enc.encode(models.CASRegister(None), ph)
    assert str(a.value) == str(b.value)
