"""The plain versions of K2, K3 and K4 on packed rows (config_pack: one or
two int32 lanes a row) against the reference's Pallas kernels run in
interpret mode with the same layout (`jepsen_tpu.parallel.sparse_kernels.
frontier_closure_call`, `hash_insert_call`, and `tiled_insert_call` on one
tile and one chunk: the whole table, as K4 runs it), bit for bit: rows
in order, counts, flags, table layout and probe offsets. On the seeded
packed cases of `tests/torch_parity_cases.py` (one lane and two, slot
bits across bit 32, state fields at their top value, words >= 2^31) and
on K2 inputs recorded from the port's own packed scans.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_cases as pc
from jepsen_tpu.parallel import sparse_kernels as ref_sk
from jepsen_tpu_torch.parallel import sparse
from jepsen_tpu_torch.parallel import sparse_kernels as sk
from test_torch_config_pack import _encoded
from torch_jax_cache import release_compiled_programs  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(rows):
    """Port lanes (int32 bit patterns) -> the reference's uint32 lanes."""
    return tuple(jnp.asarray(r.numpy().view(np.uint32)) for r in rows)


def _same(port_lanes, ref_lanes) -> bool:
    return len(port_lanes) == len(ref_lanes) and all(
        np.array_equal(p.numpy().view(np.uint32), np.asarray(r))
        for p, r in zip(port_lanes, ref_lanes))


# -------------------------------------------------------------------- K2

@functools.lru_cache(maxsize=None)
def _ref_closure(step_name, N, C, probe_limit, pack):
    return jax.jit(functools.partial(
        ref_sk.frontier_closure_call, step_name, N=N, C=C,
        probe_limit=probe_limit, pack=pack, interpret=True))


def _assert_k2(step, ev, rows, live, run, pl, pack):
    N, C = live.shape[0], ev["slot_f"].shape[0]
    rows2, meta = sk.frontier_closure(step, ev, rows, live, run, pl, pack)
    want = _ref_closure(step, N, C, pl, pack)(
        {k: jnp.asarray(v.numpy()) for k, v in ev.items()}, _j(rows),
        jnp.asarray(live.numpy()), jnp.asarray(run.numpy()))
    assert meta.tolist() == [int(want[1]), int(bool(want[2])),
                             int(want[3]), int(want[4])]
    assert _same(rows2, want[0])


K2_SEEDED = [c[0] for c in pc.packed_k2_cases() if c[4].shape[0] <= 2048]


@pytest.mark.parametrize("name", K2_SEEDED)
def test_plain_packed_k2_matches_interpret_pallas(name):
    _, step, ev, rows, live, run, pl, pack = \
        {c[0]: c for c in pc.packed_k2_cases()}[name]
    _assert_k2(step, ev, rows, live, run, pl, pack)


def _record(e, N, pack):
    """Every K2 call of the port's packed scan of e at capacity N."""
    calls = []
    real = sk.frontier_closure

    def recording(step, ev, rows, live, run, pl, **kw):
        calls.append((step, dict(ev), tuple(r.clone() for r in rows),
                      live.clone(), run.clone(), pl, kw["pack"]))
        return real(step, ev, rows, live, run, pl, **kw)

    sk.frontier_closure = recording
    try:
        sc = sparse._Scan(e, N, "hash", 32, torch.device("cpu"), pack=pack)
        assert sc.closure == "fused"
        sc.run(e.n_returns)
    finally:
        sk.frontier_closure = real
    return calls


@pytest.mark.parametrize("name,corrupt", [("register", True),
                                          ("fifo", False),
                                          ("gset30", False),
                                          ("fifo43", True)])
def test_plain_packed_k2_matches_interpret_pallas_on_recorded_calls(
        name, corrupt):
    """The widest closures of the port's packed scans, at one lane (the
    register and FIFO families) and two (the 30-element set, whose slot
    5 sits at bit 32, and a corrupted FIFO of 37 bits)."""
    _, e = _encoded(name, corrupt)
    pack = sparse.pack_spec_for(e)
    calls = _record(e, 64, pack)
    assert calls
    wide = sorted(calls, key=lambda c: -int(c[3].sum()))[:2]
    for step, ev, rows, live, run, pl, pk in wide:
        assert len(rows) == sparse.pack_lanes(pack, e.slot_f.shape[1])
        _assert_k2(step, ev, rows, live, run, pl, pk)


# -------------------------------------------------------------------- K3

def _ref_pack(L):
    """The reference layout whose hash a plain insert of L-lane words
    uses (the word's state_bits do not enter it)."""
    return ((1, 0), 31) if L == 1 else ((1, 0), 63)


@pytest.mark.parametrize("name", [c[0] for c in pc.packed_k3_cases()
                                  if c[5][1].shape[0] <= 1024])
def test_plain_packed_k3_matches_interpret_pallas(name):
    _, c_rows, c_live, f_rows, count, table, pl, N = \
        {c[0]: c for c in pc.packed_k3_cases()}[name]
    pack, C = _ref_pack(len(c_rows))
    want = jax.jit(functools.partial(
        ref_sk.hash_insert_call, probe_limit=pl, N=N, C=C, pack=pack,
        interpret=True))(_j(c_rows), jnp.asarray(c_live.numpy()),
                         _j(f_rows), jnp.int32(int(count)),
                         (_j(table[0]), jnp.asarray(table[1].numpy())))
    got = sk.hash_insert(c_rows, c_live, f_rows, count, table, pl, N)
    assert _same(got[0], want[0]) and _same(got[1][0], want[1][0])
    assert np.array_equal(got[1][1].numpy(), np.asarray(want[1][1]))
    assert [int(got[2]), int(got[3]), bool(got[4])] == \
        [int(want[2]), int(want[3]), bool(want[4])]


# -------------------------------------------------------------------- K4

def _ref_tiled(c_rows, c_live, table, pl):
    pack, C = _ref_pack(len(c_rows))
    T, M = table[1].shape[-1], c_live.shape[-1]
    plan = {"tile": T, "chunk": 1 << max(0, (M - 1).bit_length())}
    return jax.jit(functools.partial(
        ref_sk.tiled_insert_call, probe_limit=pl, plan=plan, pack=pack,
        C=C, interpret=True))(_j(c_rows), jnp.asarray(c_live.numpy()),
                              (_j(table[0]), jnp.asarray(table[1].numpy())))


def _assert_k4(got, want):
    (tr, tocc), fresh, off, pend = got
    (wr, wocc), wfresh, woff, wpend = want
    assert _same(tr, wr)
    assert np.array_equal(tocc.numpy(), np.asarray(wocc))
    assert np.array_equal(fresh.numpy(), np.asarray(wfresh))
    assert np.array_equal(off.numpy(), np.asarray(woff))
    assert bool(pend) == bool(wpend)


@pytest.mark.parametrize("name", [c[0] for c in pc.packed_k4_cases()
                                  if c[2].shape[0] <= 4096])
def test_plain_packed_k4_matches_interpret_pallas(name):
    _, c_rows, c_live, table, pl = \
        {c[0]: c for c in pc.packed_k4_cases()}[name]
    _assert_k4(sk.tiled_insert(c_rows, c_live, table, pl),
               _ref_tiled(c_rows, c_live, table, pl))


@pytest.mark.parametrize("name", [c[0] for c in pc.packed_k4_batch_cases()
                                  if "32" in c[0]])
def test_plain_packed_batched_k4_matches_interpret_pallas_key_by_key(name):
    _, c_rows, c_live, table, pl = \
        {c[0]: c for c in pc.packed_k4_batch_cases()}[name]
    (tr, tocc), fresh, off, pend = sk.tiled_insert_batch(c_rows, c_live,
                                                         table, pl)
    for k in range(c_live.shape[0]):
        want = _ref_tiled(tuple(r[k] for r in c_rows), c_live[k],
                          (tuple(r[k] for r in table[0]), table[1][k]), pl)
        _assert_k4(((tuple(r[k] for r in tr), tocc[k]), fresh[k], off[k],
                    pend[k]), want)
