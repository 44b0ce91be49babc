"""K2's search-stats outputs (`sparse_kernels.frontier_closure(...,
stats=True)` and its batched form): the plain version against the
reference's `frontier_closure_call(..., interpret=True, stats=True)` bit
for bit — the closure's rows and meta, the sort-equivalent work `swork`
and the probe-length histogram — on the seeded cases of
`tests/torch_parity_cases.py` (the triple and packed rows of one and two
lanes, probe_limit 2 where the probes overflow, claim races, duplicates
that meet, seeds with holes) and on calls recorded from the port's own
scans. The `cuda` tests hold the kernel's stats instantiation, single
and batched, against the plain version on the card, and its stats-off
outputs against the stats-off launch."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity_cases as pc
from jepsen_tpu.parallel import sparse_kernels as ref_sk
from jepsen_tpu_torch.parallel import search_stats as st
from jepsen_tpu_torch.parallel import sparse
from jepsen_tpu_torch.parallel import sparse_kernels as sk
from test_torch_config_pack import _encoded
from torch_jax_cache import release_compiled_programs  # noqa: F401

CUDA = torch.cuda.is_available()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(rows):
    """Port lanes (int32 bit patterns) -> the reference's uint32 lanes
    (the triple's state lane stays int32)."""
    if len(rows) == 3:
        return (jnp.asarray(rows[0].numpy()),
                *(jnp.asarray(r.numpy().view(np.uint32)) for r in rows[1:]))
    return tuple(jnp.asarray(r.numpy().view(np.uint32)) for r in rows)


@functools.lru_cache(maxsize=None)
def _ref_closure(step_name, N, C, probe_limit, pack):
    return jax.jit(functools.partial(
        ref_sk.frontier_closure_call, step_name, N=N, C=C,
        probe_limit=probe_limit, pack=pack, interpret=True, stats=True))


def _assert_stats_k2(step, ev, rows, live, run, pl, pack=()):
    N, C = live.shape[0], ev["slot_f"].shape[0]
    kw = {"pack": pack} if pack else {}
    rows2, meta, stats = sk.frontier_closure(step, ev, rows, live, run, pl,
                                             stats=True, **kw)
    want = _ref_closure(step, N, C, pl, pack)(
        {k: jnp.asarray(v.numpy()) for k, v in ev.items()}, _j(rows),
        jnp.asarray(live.numpy()), jnp.asarray(run.numpy()))
    assert meta.tolist() == [int(want[1]), int(bool(want[2])),
                             int(want[3]), int(want[4])]
    assert stats.tolist() == [int(want[5])] + np.asarray(want[6]).tolist()
    for got, ref in zip(rows2, want[0]):
        assert np.array_equal(got.numpy().view(np.uint32),
                              np.asarray(ref).view(np.uint32))
    # the stats-off call gives the same closure
    rows_off, meta_off = sk.frontier_closure(step, ev, rows, live, run, pl,
                                             **kw)
    assert meta_off.tolist() == meta.tolist()
    assert all(torch.equal(a, b) for a, b in zip(rows_off, rows2))
    return stats


K2_SEEDED = [c[0] for c in pc.k2_cases() if c[4].shape[0] <= 1024]
K2_PACKED = [c[0] for c in pc.packed_k2_cases() if c[4].shape[0] <= 2048]


@pytest.mark.parametrize("name", K2_SEEDED)
def test_plain_k2_stats_match_interpret_pallas(name):
    _, step, ev, rows, live, run, pl = {c[0]: c for c in pc.k2_cases()}[name]
    stats = _assert_stats_k2(step, ev, rows, live, run, pl)
    assert stats[1:].sum() > 0     # every case probes something


@pytest.mark.parametrize("name", K2_PACKED)
def test_plain_packed_k2_stats_match_interpret_pallas(name):
    _, step, ev, rows, live, run, pl, pack = \
        {c[0]: c for c in pc.packed_k2_cases()}[name]
    _assert_stats_k2(step, ev, rows, live, run, pl, pack)


def test_probe_limit_2_exhaustion_lands_in_the_2_3_bucket():
    """At probe_limit 2 a candidate that exhausts its probes ends at
    offset 2, which is the "2-3" bucket, not "32+"."""
    _, step, ev, rows, live, run, pl = {
        c[0]: c for c in pc.k2_cases()}["register N1024 C64 pl2"]
    stats = _assert_stats_k2(step, ev, rows, live, run, pl)
    hist = dict(zip(st.PROBE_HIST_LABELS, stats[1:].tolist()))
    assert hist["4-7"] == hist["8-15"] == hist["16-31"] == hist["32+"] == 0


def test_skipped_event_gives_zero_stats():
    _, step, ev, rows, live, _, pl = pc.k2_cases()[2]
    rows2, meta, stats = sk.frontier_closure(step, ev, rows, live,
                                             torch.tensor(False), pl,
                                             stats=True)
    assert meta.tolist() == [0] * 4 and stats.tolist() == [0] * 8


@pytest.mark.parametrize("name,corrupt", [("register", True),
                                          ("fifo", False),
                                          ("gset30", False)])
def test_plain_k2_stats_match_on_recorded_calls(name, corrupt):
    """The widest closures of the port's own scans (the triple, and the
    packed word of one lane and two), with the probe limit at 2 and 32."""
    _, e = _encoded(name, corrupt)
    calls = []
    real = sk.frontier_closure

    def recording(step, ev, rows, live, run, pl, **kw):
        calls.append((step, dict(ev), tuple(r.clone() for r in rows),
                      live.clone(), run.clone(), kw.get("pack", ())))
        return real(step, ev, rows, live, run, pl, **kw)

    for pack in ((), sparse.pack_spec_for(e)):
        calls.clear()
        sk.frontier_closure = recording
        try:
            sparse._Scan(e, 64, "hash", 32, torch.device("cpu"),
                         pack=pack).run(e.n_returns)
        finally:
            sk.frontier_closure = real
        for step, ev, rows, live, run, pk in sorted(
                calls, key=lambda c: -int(c[3].sum()))[:2]:
            for pl in (2, 32):
                _assert_stats_k2(step, ev, rows, live, run, pl, pk)


def _batch_inputs(cases):
    """K keys' events (one row each) from single-key cases of one step
    family, N and C: tables [K, 1, C], rows [K, N], live [K, N], run
    [K] (the last key does not run)."""
    xs = {k: torch.stack([c[2][k] for c in cases])[:, None]
          for k in sk.SLOT_TABLES}
    rows = tuple(torch.stack([c[3][j] for c in cases])
                 for j in range(len(cases[0][3])))
    live = torch.stack([c[4] for c in cases])
    run = torch.tensor([True] * (len(cases) - 1) + [False])
    return xs, rows, live, run


def test_plain_batched_k2_stats_are_each_keys():
    cases = [c for c in pc.k2_cases() if c[1] == "uqueue"
             and c[4].shape[0] == 1024]
    xs, rows, live, run = _batch_inputs(cases + cases[:1])
    rows2, meta, stats = sk.frontier_closure_batch("uqueue", xs, 0, rows,
                                                   live, run, 32, stats=True)
    for i in range(live.shape[0]):
        want = sk.frontier_closure(
            "uqueue", {k: xs[k][i, 0] for k in sk.SLOT_TABLES},
            tuple(r[i] for r in rows), live[i], run[i], 32, stats=True)
        assert meta[i].tolist() == want[1].tolist()
        assert stats[i].tolist() == want[2].tolist()
    assert stats[-1].tolist() == [0] * 8


def test_tiled_closure_stats_match_the_fused_ones():
    """The tiled closure's histogram is bucketed from K4's `off` output:
    the same stats as the fused closure's on the same event."""
    _, step, ev, rows, live, run, pl = {
        c[0]: c for c in pc.k2_cases()}["uqueue N1024 C8 wide seed"]
    rep = sparse._rep((), 8)
    _, meta_t, stats_t = sk.tiled_event_closure(
        rep, sparse.STEPS[step], ev, rows, live, run, 1024, 2048, pl,
        stats=True)
    _, meta_f, stats_f = sk.frontier_closure(step, ev, rows, live, run, pl,
                                             stats=True)
    assert meta_t.tolist() == meta_f.tolist()
    assert stats_t.tolist() == stats_f.tolist()


# ------------------------------------------------------------- on the card

def _cuda(x):
    if isinstance(x, dict):
        return {k: v.cuda() for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(v.cuda() for v in x)
    return x.cuda()


@pytest.mark.cuda
@pytest.mark.skipif(not CUDA, reason="needs an NVIDIA GPU: K2's stats "
                                     "instantiation has no CPU mode")
@pytest.mark.parametrize("pl", [2, 32])
def test_cuda_k2_stats_match_plain(pl):
    cases = [(c[1], c[2], c[3], c[4], c[5], ()) for c in pc.k2_cases()]
    cases += [(c[1], c[2], c[3], c[4], c[5], c[7])
              for c in pc.packed_k2_cases()]
    for step, ev, rows, live, run, pack in cases:
        kw = {"pack": pack} if pack else {}
        want = sk.frontier_closure(step, ev, rows, live, run, pl,
                                   stats=True, **kw)
        got = sk.frontier_closure(step, _cuda(ev), _cuda(rows), _cuda(live),
                                  _cuda(run), pl, stats=True, **kw)
        assert got[1].tolist() == want[1].tolist()
        assert got[2].tolist() == want[2].tolist()
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got[0], want[0]))
        off = sk.frontier_closure(step, _cuda(ev), _cuda(rows), _cuda(live),
                                  _cuda(run), pl, **kw)
        assert off[1].tolist() == want[1].tolist()
        assert all(torch.equal(a.cpu(), b) for a, b in zip(off[0], want[0]))


@pytest.mark.cuda
@pytest.mark.skipif(not CUDA, reason="needs an NVIDIA GPU: K2's stats "
                                     "instantiation has no CPU mode")
def test_cuda_batched_k2_stats_match_plain():
    groups = {}
    for c in pc.k2_cases():
        groups.setdefault((c[1], c[4].shape[0], c[2]["slot_f"].shape[0]),
                          []).append(c)
    for (step, _, _), cases in groups.items():
        xs, rows, live, run = _batch_inputs(cases + cases[:1])
        want = sk.frontier_closure_batch(step, xs, 0, rows, live, run, 2,
                                         stats=True)
        got = sk.frontier_closure_batch(step, _cuda(xs), 0, _cuda(rows),
                                        _cuda(live), _cuda(run), 2,
                                        stats=True)
        assert got[1].tolist() == want[1].tolist()
        assert got[2].tolist() == want[2].tolist()
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got[0], want[0]))
