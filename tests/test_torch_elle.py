"""elle's graph machinery in the port against the reference, on the CPU:
the SCC routes (Tarjan under 1,024 nodes, the closure past it — the
port's plain torch run against the reference's JAX program), the cycle
searches, the anomaly classification, the realtime and process graphs,
and the txn streams and history plumbing. Every comparison is exact:
whole ordered lists, and dicts with their insertion orders."""

import json
import random

import pytest
import torch

import torch_elle_cases as ec
from jepsen_tpu import elle as ref_elle
from jepsen_tpu.elle import txn as ref_txn
from jepsen_tpu.generator import fixed_rand
from jepsen_tpu_torch import elle
from jepsen_tpu_torch.elle import txn
from torch_jax_cache import release_compiled_programs  # noqa: F401

TYPE_SETS = [None, {elle.WW}, {elle.WW, elle.WR}, {elle.WW, elle.RT},
             {elle.WW, elle.WR, elle.RW, elle.RT, elle.PROC}]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(build):
    """The same graph built by `build(Graph)` in the port and the
    reference."""
    return build(elle.Graph), build(ref_elle.Graph)


def _dump(g):
    """A graph's adjacency with every insertion order."""
    return [(a, [(b, sorted(ts)) for b, ts in bs.items()])
            for a, bs in g.out.items()]


def _g3cycle(cls):
    g = cls()
    g.add(0, 1, elle.WW)
    g.add(1, 2, elle.WW)
    g.add(2, 0, elle.WW)
    g.add(2, 3, elle.WW)
    return g


def _test_elle_randoms():
    """tests/test_elle.py::TestSCC's five random 30-node graphs."""
    def build(cls, k):
        r = random.Random(7)
        g = None
        for _ in range(k + 1):
            g = cls()
            for _e in range(60):
                g.add(r.randrange(30), r.randrange(30), elle.WW)
        return g
    return [lambda cls, k=k: build(cls, k) for k in range(5)]


GRAPHS = ([("g3cycle", _g3cycle)]
          + [(f"test_elle-random-{k}", b)
             for k, b in enumerate(_test_elle_randoms())]
          + [(f"random-n{n}-s{s}", lambda cls, n=n, s=s, p=p:
              ec.random_graph(n, s, planted=p, graph_cls=cls))
             for n, s, p in ((30, 1, 0), (30, 2, 12), (1100, 3, 400),
                             (2048, 4, 1500))])


@pytest.mark.parametrize("name,build", GRAPHS, ids=[n for n, _ in GRAPHS])
def test_device_sccs_matches_reference(name, build):
    g, rg = _both(build)
    assert _dump(g) == _dump(rg)
    want = ref_elle.device_sccs(rg)
    before = elle.launches["closure"]
    assert elle.device_sccs(g, device="cpu") == want
    assert elle.launches["closure"] == before + 1
    # the same sets as Tarjan, in the device route's order
    assert ec.reference_order(elle.tarjan_sccs(g)) == want


@pytest.mark.parametrize("name,build", GRAPHS, ids=[n for n, _ in GRAPHS])
def test_tarjan_matches_reference(name, build):
    g, rg = _both(build)
    assert elle.tarjan_sccs(g) == ref_elle.tarjan_sccs(rg)


@pytest.mark.parametrize("n", [1023, 1024])
def test_sccs_routes_at_the_references_threshold(n):
    g, rg = _both(lambda cls: ec.random_graph(n, 11, planted=300,
                                              graph_cls=cls))
    before = elle.launches["closure"]
    got = elle.sccs(g, device="cpu")
    assert got == ref_elle.sccs(rg)
    assert elle.launches["closure"] == before + (n >= 1024)
    if n < 1024:
        assert got == elle.tarjan_sccs(g)
    else:
        assert got == ec.reference_order(elle.tarjan_sccs(g))


def test_device_route_needs_the_card_or_the_cpu():
    g = ec.random_graph(1024, 5)
    if torch.cuda.is_available():
        pytest.skip("the card is here: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elle.sccs(g)
    # under the threshold nothing touches the device
    assert elle.sccs(ec.random_graph(100, 5)) == elle.tarjan_sccs(
        ec.random_graph(100, 5))


def test_empty_and_acyclic_graphs():
    assert elle.device_sccs(elle.Graph(), device="cpu") == []
    g = elle.Graph()
    for i in range(50):
        g.add(i, i + 1, elle.WW)
    assert elle.device_sccs(g, device="cpu") == []
    assert elle.closure_steps(1) == elle.closure_steps(2) == 1
    assert elle.closure_steps(1024) == 10 and elle.closure_steps(1025) == 11


@pytest.mark.parametrize("name,build", GRAPHS[:4] + GRAPHS[-3:-1],
                         ids=[n for n, _ in GRAPHS[:4] + GRAPHS[-3:-1]])
def test_cycle_searches_match_reference(name, build):
    g, rg = _both(build)
    for comp in elle.tarjan_sccs(g)[:8]:
        for types in TYPE_SETS:
            assert elle.find_cycle(g, comp, types) \
                == ref_elle.find_cycle(rg, comp, types)
        for one, rest in ((elle.RW, {elle.WW, elle.WR}),
                          (elle.WW, {elle.WW}), (elle.WR, {elle.WW})):
            assert elle.find_cycle_with_one(g, comp, one, rest) \
                == ref_elle.find_cycle_with_one(rg, comp, one, rest)


def _typed_graph(cls, n, seed):
    """A graph whose edges carry random types, so every cycle spec has
    something to find."""
    rng = random.Random(seed)
    g = cls()
    types = [elle.WW, elle.WR, elle.RW, elle.RT, elle.PROC]
    for _ in range(int(1.3 * n)):
        g.add(rng.randrange(n), rng.randrange(n), rng.choice(types))
    return g


@pytest.mark.parametrize("n,seed", [(12, 3), (12, 6), (40, 2), (200, 3),
                                    (1030, 4)])
def test_cycle_anomalies_match_reference(n, seed):
    g, rg = _both(lambda cls: _typed_graph(cls, n, seed))
    by_id = {i: {"f": "txn", "value": [i], "_id": i} for i in range(n)}
    got = elle.cycle_anomalies(g, by_id=by_id, device="cpu")
    want = ref_elle.cycle_anomalies(rg, by_id=by_id)
    assert got == want and list(got) == list(want)
    assert json.dumps(got) == json.dumps(want)


def test_generic_check_matches_reference():
    def analyzer(mod):
        def run(history):
            g = mod.Graph()
            g.add(0, 1, elle.WW)
            g.add(1, 0, elle.WW)
            return g, None, {0: {}, 1: {}}
        return run
    assert elle.check(analyzer(elle), []) \
        == ref_elle.check(analyzer(ref_elle), [])


SIMS = [("append", None, 300, 1, ()), ("append", None, 300, 2, ec.FAULTS),
        ("append", {"key-count": 10, "max-txn-length": 4}, 400, 3,
         ec.FAULTS),
        ("wr", None, 300, 4, ()),
        ("wr", None, 300, 5, ec.WR_FAULTS)]


@pytest.mark.parametrize("kind,opts,n,seed,faults", SIMS)
def test_history_plumbing_and_graphs_match_reference(kind, opts, n, seed,
                                                     faults):
    h = ec.simulate(n, kind, opts, seed=seed, faults=faults)
    wf = "append" if kind == "append" else "w"
    oks = txn.ok_txns(h)
    assert oks == ref_txn.ok_txns(h)
    assert [list(o) for o in oks] == [list(o) for o in ref_txn.ok_txns(h)]
    assert txn.failed_writes(h, wf) == ref_txn.failed_writes(h, wf)
    assert txn.intermediate_writes(oks, wf) \
        == ref_txn.intermediate_writes(oks, wf)
    assert _dump(elle.realtime_graph(oks)) \
        == _dump(ref_elle.realtime_graph(oks))
    assert _dump(elle.process_graph(oks)) \
        == _dump(ref_elle.process_graph(oks))
    assert len(oks) == n


@pytest.mark.parametrize("seed", [3, 45100, 2026])
@pytest.mark.parametrize("write_f", ["append", "w"])
@pytest.mark.parametrize("opts", [None, {"key-count": 3, "min-txn-length": 1,
                                         "max-txn-length": 4,
                                         "max-writes-per-key": 4}])
def test_txn_streams_match_reference_under_fixed_rand(seed, write_f, opts):
    port = {"append": txn.append_txns, "w": txn.wr_txns}[write_f]
    ref = {"append": ref_txn.append_txns, "w": ref_txn.wr_txns}[write_f]
    stream = port(opts, random.Random(seed))
    got = [next(stream) for _ in range(300)]
    with fixed_rand(seed):
        rs = ref(opts)
        want = [next(rs) for _ in range(300)]
    assert got == want
    gen = txn.txn_generator(opts, write_f, random.Random(seed))
    with fixed_rand(seed):
        rgen = ref_txn.txn_generator(opts, write_f)
        assert [gen() for _ in range(50)] == [rgen() for _ in range(50)]
