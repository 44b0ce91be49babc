"""Packed configuration rows (config_pack) in the port's single-key sparse
engine, against the reference's (jepsen_tpu.parallel.engine with
config_pack=True) on the same encoded input.

A packed row is the word (state - state_lo) | mask << state_bits in one
int32 lane up to 32 bits and two up to 64 (`sparse._PackedRep`). Pinned
here: the layout arithmetic at the lane boundaries (32 | 33 and 64 | 65
bits), `pack_spec_for`'s union of a batch's state domains, every method
of the rep against the reference's on seeded rows whose lanes reach past
2^31 (the state, both hashes, the mask test, the candidates, the event
bit, the initial rows and the sort dedupe's order), the
JEPSEN_TPU_TORCH_CONFIG_PACK flag and the "config-pack" tag (with the
"unpacked" path of a word past 64 bits), and whole checks of the four
families of the reference's tests/test_config_pack.py, clean and
corrupted, and mutex, at one lane and two, on the fused route (K2's
plain version), the tiled one (K4's) and the sort closure: every result
field equals the reference's packed result, `capacity` and
`config-pack` included.
"""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import models as ref_models
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu_torch.parallel import sparse
from test_torch_sparse import CASES, _mutex_history, _to_port
from torch_jax_cache import release_compiled_programs  # noqa: F401

KEYS = ("valid?", "fail-event", "op", "max-frontier", "capacity",
        "configs-stepped", "explored", "dedupe", "config-pack")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pin(r):
    return {k: r.get(k) for k in KEYS}


# --------------------------------------------------------- layout math

@pytest.mark.parametrize("S,C,want", [
    (2, 31, (1, 1)),            # 32-bit word: one lane
    (2, 32, (1, 2)),            # 33 bits: the lane boundary crossed
    (1 << 16, 16, (16, 1)),     # 32 bits of state and mask
    (1 << 16, 17, (16, 2)),
    (1 << 32, 32, (32, 2)),     # 64 bits exactly: still packs
    (1 << 32, 33, None),        # 65 bits: the triple
    (1 << 33, 16, None),        # a state field past one lane
    (2, 64, None),              # the mask alone fills the word
    (0, 8, None),               # no state space
])
def test_pack_layout_at_the_lane_boundaries(S, C, want):
    lay = sparse.pack_layout(S, -1, C)
    assert lay == ref_engine.pack_layout(S, -1, C)
    if want is None:
        assert lay is None
    else:
        assert lay == (want[0], -1)
        assert sparse.pack_lanes(lay, C) == want[1] == \
            ref_engine.pack_lanes(lay, C)
    assert sparse.pack_lanes((), C) == 3


@dataclass
class _FakeEnc:
    n_states: int
    state_lo: int
    slot_f: np.ndarray


def test_pack_spec_for_unions_the_batch():
    f = np.zeros((4, 10), np.int32)
    a = _FakeEnc(16, -1, f)
    b = _FakeEnc(100, 50, f)
    wide = _FakeEnc(1 << 31, 0, np.zeros((4, 40), np.int32))
    for encs, C in (([a, b], 10), ([a, b], None), ([a], 10),
                    ([a, wide], 40), ([a, wide], None), ([], 10),
                    (a, None), ([_FakeEnc(0, 0, f)], 10)):
        assert sparse.pack_spec_for(encs, C) == \
            ref_engine.pack_spec_for(encs, C)
    s_bits, lo = sparse.pack_spec_for([a, b], 10)
    assert lo == -1 and (1 << s_bits) >= 151     # covers [-1, 150)
    # the layout is taken at the C asked for, not each key's own
    assert sparse.pack_spec_for([a], 40) == (4, -1)
    assert sparse.pack_spec_for([a], 61) == ()


# ------------------------------------------------------ the packed rep

LAYOUTS = [(4, -1, 20), (12, 5, 20), (1, 0, 31), (20, 0, 14), (27, 0, 6),
           (32, -(1 << 31), 30), (8, 3, 56)]


def _seeded_words(s_bits, C, n, rng):
    """n packed words (uint64) with random fields and masks, some equal,
    some with fields at the top and the bottom of their range."""
    field = rng.integers(0, 1 << s_bits, size=n, dtype=np.uint64)
    field[:8] = (1 << s_bits) - 1
    field[8:16] = 0
    mask = rng.integers(0, 1 << 62, size=n, dtype=np.uint64) \
        & np.uint64((1 << C) - 1)
    words = field | (mask << np.uint64(s_bits))
    words[-20:] = words[:20]
    return words


def _lanes(words, L):
    lo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (words >> np.uint64(32)).astype(np.uint32)
    return [lo, hi][:L]


def _port(lanes):
    return tuple(torch.from_numpy(x.view(np.int32).copy()) for x in lanes)


def _eq(port, ref):
    a = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    if a.dtype == np.int64 or b.dtype == np.int64:
        return np.array_equal(a.astype(np.int64) & 0xFFFFFFFF,
                              b.astype(np.int64) & 0xFFFFFFFF)
    if a.dtype == bool or b.dtype == bool:
        return np.array_equal(a, b)
    return np.array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("s_bits,state_lo,C", LAYOUTS)
def test_packed_rep_matches_the_reference(s_bits, state_lo, C):
    rng = np.random.default_rng(s_bits * 100 + C)
    rep = sparse._rep((s_bits, state_lo), C)
    ref = ref_engine._rep((s_bits, state_lo), C)
    assert rep.lanes == ref.lanes == (1 if s_bits + C <= 32 else 2)
    assert rep.pack == ref.pack
    n = 300
    lanes = _lanes(_seeded_words(s_bits, C, n, rng), rep.lanes)
    rows, rows_j = _port(lanes), tuple(jnp.asarray(x) for x in lanes)
    if s_bits + C >= 32:     # words whose lanes reach 2^31
        assert any((x.view(np.int32) < 0).any() for x in lanes)
    assert _eq(rep.state(rows), ref.state(rows_j))
    assert _eq(rep.table_hash(rows), ref.table_hash(rows_j))
    assert _eq(rep.owner_hash(rows), ref.owner_hash(rows_j))
    assert _eq(rep.mask_test(rows), ref.mask_test(rows_j))
    # candidates from stepped states in the field's range and far outside
    # it (a dead candidate's garbage state must stay out of the mask)
    lo_, hi_ = state_lo, state_lo + (1 << s_bits)
    st = rng.integers(max(lo_, -(1 << 31)), min(hi_, 1 << 31),
                      size=(n, C)).astype(np.int32)
    st[::7] = rng.integers(-(1 << 31), 1 << 31, size=st[::7].shape)
    got = rep.candidates(rows, torch.from_numpy(st))
    want = ref.candidates(rows_j, jnp.asarray(st))
    assert len(got) == len(want) == rep.lanes
    assert all(_eq(g, w) for g, w in zip(got, want))
    # the returning slot's bit, set and cleared, on either side of bit 32
    where = rng.random(n) < 0.5
    bits_t = rep.event_bits_t(torch.arange(C))
    for s in range(C):
        bits = rep.event_bits(s)
        rbits = ref.event_bits(jnp.uint32(s))
        assert [b for b in bits] == [int(np.asarray(b).view(np.int32))
                                     for b in rbits]
        assert [int(b[s]) for b in bits_t] == list(bits)
        assert _eq(rep.has_event_bit(rows, bits),
                   ref.has_event_bit(rows_j, rbits))
        got = rep.clear_event_bit(rows, bits, torch.from_numpy(where))
        want = ref.clear_event_bit(rows_j, rbits, jnp.asarray(where))
        assert all(_eq(g, w) for g, w in zip(got, want))
    # the initial rows, the state at the top of the field and at its foot
    for state0 in (state_lo, state_lo + (1 << s_bits) - 1):
        if not -(1 << 31) <= state0 < (1 << 31):
            continue
        for a, b in ((rep.initial_at0(state0, 16),
                      ref.initial_at0(jnp.int32(state0), 16)),
                     (rep.initial_full(state0, 16),
                      ref.initial_full(jnp.int32(state0), 16))):
            assert all(_eq(g, w) for g, w in zip(a, b))
            assert _eq(rep.state(a), ref.state(b))
    # the sort dedupe: the reference's lexsort order of the lanes, row
    # for row (the low lane is the major key, unsigned)
    live = rng.random(n) < 0.8
    got = sparse._dedupe_compact(rows, torch.from_numpy(live), 256, rep)
    want = ref_engine._dedupe_compact(rows_j, jnp.asarray(live), 256, ref)
    assert all(_eq(g, w) for g, w in zip(got[0], want[0]))
    assert _eq(got[1], want[1]) and int(got[2]) == int(want[2])
    assert bool(got[3]) == bool(want[3])


def test_packed_rep_refuses_a_word_past_64_bits():
    with pytest.raises(ValueError, match="64 bits"):
        sparse._rep((33, 0), 8)
    with pytest.raises(ValueError, match="64 bits"):
        sparse._rep((8, 0), 57)


# ------------------------------------------------------ flag and tags

def test_config_pack_flag(monkeypatch):
    monkeypatch.delenv("JEPSEN_TPU_TORCH_CONFIG_PACK", raising=False)
    assert sparse._resolve_config_pack() is False
    for raw, want in (("1", True), ("0", False), ("", False)):
        monkeypatch.setenv("JEPSEN_TPU_TORCH_CONFIG_PACK", raw)
        assert sparse._resolve_config_pack() is want
        # an explicit argument wins over the flag
        assert sparse._resolve_config_pack(not want) is (not want)
    for raw in ("yes", "true", "2"):
        monkeypatch.setenv("JEPSEN_TPU_TORCH_CONFIG_PACK", raw)
        with pytest.raises(ValueError, match="CONFIG_PACK"):
            sparse._resolve_config_pack()
    _, pe = _encoded("register")
    with pytest.raises(ValueError, match="CONFIG_PACK"):
        sparse.check_encoded(pe, device="cpu")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_CONFIG_PACK", "1")
    r = sparse.check_encoded(pe, capacity=64, device="cpu")
    assert r["config-pack"].startswith("packed:")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_CONFIG_PACK", "0")
    assert "config-pack" not in sparse.check_encoded(pe, capacity=64,
                                                     device="cpu")


def test_tags_match_the_reference():
    for pack, req, C in (((4, -1), True, 20), ((20, 0), True, 14),
                         ((), True, 40), ((4, -1), False, 20),
                         ((), False, 3)):
        got = sparse._tag_config_pack({}, pack, req, C)
        assert got == ref_engine._tag_config_pack({}, pack, req, C)
    assert sparse._tag_config_pack({}, (4, -1), True, 20) == {
        "config-pack": "packed:24b/1-lane"}
    assert sparse._tag_config_pack({}, (32, 0), True, 30) == {
        "config-pack": "packed:62b/2-lane"}


def test_a_word_past_64_bits_runs_the_triple(monkeypatch):
    """A history whose word cannot pack runs unpacked under
    config_pack=True, tagged "unpacked", with the reference's result."""
    re_, pe = _encoded("register", corrupt=True)
    monkeypatch.setattr(ref_engine, "pack_layout", lambda *a, **k: None)
    monkeypatch.setattr(sparse, "pack_layout", lambda *a, **k: None)
    want = ref_engine.check_encoded(re_, capacity=64, dedupe="hash",
                                    config_pack=True)
    got = sparse.check_encoded(pe, capacity=64, dedupe="hash",
                               device="cpu", config_pack=True)
    assert want["config-pack"] == got["config-pack"] == "unpacked"
    assert _pin(got) == _pin(want)


# ------------------------------------------------------ whole checks

# two-lane histories: a 30-element set (27 state bits, 6 slots: slot 5's
# bit at 32, the first of lane 1) clean and corrupted, and a corrupted
# FIFO queue of 28 state bits and 9 slots
TWO_LANE = {
    "gset30": (ref_models.GSet, lambda: ref_histories.rand_gset_history(
        n_ops=44, n_processes=6, n_elements=30, crash_p=0.05, seed=45)),
    "fifo43": (ref_models.FIFOQueue, lambda: ref_histories
               .rand_fifo_history(n_ops=30, n_processes=8, n_values=6,
                                  crash_p=0.05, seed=43)),
}


def _encoded(name, corrupt=False):
    Model, gen = {**CASES, **TWO_LANE}[name]
    h = gen()
    if corrupt:
        h = ref_histories.corrupt_history(h, seed=7, n_corruptions=2)
    if name == "mutex":
        h = _mutex_history()
    e = ref_enc.encode(Model(), h)
    return e, _to_port(e)


_REF: dict = {}


def _ref(name, corrupt, dedupe):
    key = (name, corrupt, dedupe)
    if key not in _REF:
        re_, _ = _encoded(name, corrupt)
        _REF[key] = ref_engine.check_encoded(re_, capacity=64,
                                             dedupe=dedupe, config_pack=True)
    return _REF[key]


VARIANTS = [(n, c, L) for n, L in (("register", 1), ("gset", 1),
                                   ("uqueue", 1), ("fifo", 1),
                                   ("mutex", 1), ("gset30", 2))
            for c in (False, True) if not (n == "mutex" and c)] + \
    [("fifo43", True, 2)]
ROUTES = {"fused": ("hash", None, "torch"),
          "tiled": ("hash", 1, "torch-tiled"),
          "sort": ("sort", None, "torch")}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name,corrupt,lanes", VARIANTS,
                         ids=[f"{n}-{'corrupt' if c else 'clean'}"
                              for n, c, _ in VARIANTS])
def test_packed_check_matches_the_reference(name, corrupt, lanes, route):
    dedupe, budget, tag = ROUTES[route]
    want = _ref(name, corrupt, dedupe)
    _, pe = _encoded(name, corrupt)
    got = sparse.check_encoded(pe, capacity=64, dedupe=dedupe,
                               device="cpu", config_pack=True,
                               smem_budget=budget)
    assert got["closure"] == tag
    assert got["config-pack"].endswith(f"/{lanes}-lane")
    assert _pin(got) == _pin(want)


def test_unpacked_check_has_no_tag():
    _, pe = _encoded("uqueue")
    for kw in ({}, {"config_pack": False}):
        assert "config-pack" not in sparse.check_encoded(
            pe, capacity=64, device="cpu", **kw)


def test_one_lane_widens_k2s_gate():
    """At one lane K2 takes capacities the triple sends to K4: the fused
    route there gives the reference's packed result."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    re_, pe = _encoded("register", corrupt=True)
    C = pe.slot_f.shape[1]
    assert not sk.supported(4096, C) and sk.supported(4096, C, lanes=1)
    assert sparse._route(4096, C, "hash", torch.device("cpu"),
                         lanes=1) == "fused"
    want = ref_engine.check_encoded(re_, capacity=4096, dedupe="hash",
                                    config_pack=True)
    got = sparse.check_encoded(pe, capacity=4096, dedupe="hash",
                               device="cpu", config_pack=True)
    assert got["closure"] == "torch" and _pin(got) == _pin(want)
