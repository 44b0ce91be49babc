"""elle's list-append and rw-register checkers in the port against the
reference, on the CPU: every hand-written history of tests/test_elle.py
and seeded simulated histories (tests/torch_elle_cases.py) of 200-1,500
committed transactions, valid and with each planted anomaly, under the
anomaly sets, additional graphs and rw-register version-order options.
Past 1,023 transactions the SCCs take the device route: the port's
plain torch closure against the reference's JAX program. The whole
result dicts must be equal, `cycle` and `steps` included, with the same
insertion orders. Also the workload wrappers (workloads/cycle.py)."""

import json
import random

import pytest
import torch

import torch_elle_cases as ec
from jepsen_tpu import elle as ref_elle
from jepsen_tpu.elle import list_append as ref_la
from jepsen_tpu.elle import rw_register as ref_wr
from jepsen_tpu.generator import fixed_rand
from jepsen_tpu.workloads import cycle as ref_cycle
from jepsen_tpu_torch import elle
from jepsen_tpu_torch.checker.core import FnChecker
from jepsen_tpu_torch.elle import list_append, rw_register
from jepsen_tpu_torch.workloads import cycle
from torch_jax_cache import release_compiled_programs  # noqa: F401


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def H(ops):
    return [dict(o, index=i) for i, o in enumerate(ops)]


def txn_pair(process, mops_invoke, mops_ok, final="ok"):
    return [
        {"type": "invoke", "process": process, "f": "txn",
         "value": mops_invoke},
        {"type": final, "process": process, "f": "txn", "value": mops_ok},
    ]


# tests/test_elle.py's hand-written histories
_G0 = [*txn_pair(0, [["append", "x", 1], ["append", "y", 2]],
                 [["append", "x", 1], ["append", "y", 2]]),
       *txn_pair(1, [["append", "y", 1], ["append", "x", 2]],
                 [["append", "y", 1], ["append", "x", 2]]),
       *txn_pair(2, [["r", "x", None], ["r", "y", None]],
                 [["r", "x", [1, 2]], ["r", "y", [1, 2]]])]
APPEND_HISTORIES = {
    "valid": [*txn_pair(0, [["append", "x", 1], ["r", "x", None]],
                        [["append", "x", 1], ["r", "x", [1]]]),
              *txn_pair(1, [["append", "x", 2], ["r", "x", None]],
                        [["append", "x", 2], ["r", "x", [1, 2]]])],
    "g0": _G0,
    "g1a": [*txn_pair(0, [["append", "x", 1]], [["append", "x", 1]],
                      final="fail"),
            *txn_pair(1, [["r", "x", None]], [["r", "x", [1]]])],
    "g1b": [*txn_pair(0, [["append", "x", 1], ["append", "x", 2]],
                      [["append", "x", 1], ["append", "x", 2]]),
            *txn_pair(1, [["r", "x", None]], [["r", "x", [1]]])],
    "g-single": [*txn_pair(0, [["r", "x", None], ["append", "y", 1]],
                           [["r", "x", []], ["append", "y", 1]]),
                 *txn_pair(1, [["append", "x", 1], ["r", "y", None]],
                           [["append", "x", 1], ["r", "y", []]]),
                 *txn_pair(2, [["r", "x", None], ["r", "y", None]],
                           [["r", "x", [1]], ["r", "y", [1]]])],
    "internal": [*txn_pair(0, [["append", "x", 1], ["r", "x", None]],
                           [["append", "x", 1], ["r", "x", [5, 9]]])],
    "incompatible-order": [*txn_pair(0, [["r", "x", None]],
                                     [["r", "x", [1, 2]]]),
                           *txn_pair(1, [["r", "x", None]],
                                     [["r", "x", [2, 1]]])],
    "protocol": [*txn_pair(0, [["append", "x", 1]], [["append", "x", 1]]),
                 *txn_pair(1, [["r", "x", None]], [["r", "x", [1]]])],
}
WR_HISTORIES = {
    "valid": [*txn_pair(0, [["w", "x", 1]], [["w", "x", 1]]),
              *txn_pair(1, [["r", "x", None]], [["r", "x", 1]])],
    "g1a": [*txn_pair(0, [["w", "x", 1]], [["w", "x", 1]], final="fail"),
            *txn_pair(1, [["r", "x", None]], [["r", "x", 1]])],
    "g1b": [*txn_pair(0, [["w", "x", 1], ["w", "x", 2]],
                      [["w", "x", 1], ["w", "x", 2]]),
            *txn_pair(1, [["r", "x", None]], [["r", "x", 1]])],
    "internal": [*txn_pair(0, [["w", "x", 1], ["r", "x", None]],
                           [["w", "x", 1], ["r", "x", 2]])],
    "g1c-wfr": [*txn_pair(0, [["w", "x", 1], ["r", "y", None]],
                          [["w", "x", 1], ["r", "y", 1]]),
                *txn_pair(1, [["w", "y", 1], ["r", "x", None]],
                          [["w", "y", 1], ["r", "x", 1]])],
    "linearizable-keys": [*txn_pair(0, [["w", "x", 1]], [["w", "x", 1]]),
                          *txn_pair(1, [["w", "x", 2]], [["w", "x", 2]]),
                          *txn_pair(2, [["r", "x", None]],
                                    [["r", "x", 1]])],
    "protocol": [*txn_pair(0, [["w", "x", 1]], [["w", "x", 1]])],
}
APPEND_OPTS = [None, {"anomalies": ["G0"]}, {"anomalies": ["G1"]},
               {"anomalies": ["G2"]}, {"anomalies": [":G-single", "G1c"]},
               {"additional-graphs": ["realtime", "process"]}]
WR_OPTS = [None, {"anomalies": ["G1"]},
           {"linearizable-keys": True, "additional-graphs": ["realtime"]},
           {"wfr-keys": True, "sequential-keys": True},
           {"linearizable-keys": True, "wfr-keys": True,
            "additional-graphs": ["realtime", "process"],
            "anomalies": ["G2"]}]


def _same(got, want):
    assert got == want
    assert json.dumps(got) == json.dumps(want)   # insertion orders too


@pytest.mark.parametrize("opts", APPEND_OPTS, ids=str)
@pytest.mark.parametrize("name", sorted(APPEND_HISTORIES))
def test_list_append_hand_written_match_reference(name, opts):
    h = H(APPEND_HISTORIES[name])
    _same(list_append.check(opts, h), ref_la.check(opts, h))


@pytest.mark.parametrize("opts", WR_OPTS, ids=str)
@pytest.mark.parametrize("name", sorted(WR_HISTORIES))
def test_rw_register_hand_written_match_reference(name, opts):
    h = H(WR_HISTORIES[name])
    _same(rw_register.check(opts, h), ref_wr.check(opts, h))


RT, WR_RT, WR_FAULTS = ec.RT, ec.WR_RT, ec.WR_FAULTS
WIDE = {"key-count": 10, "max-txn-length": 4}
# (kind, txn-stream opts, committed txns, seed, faults, checker opts)
SIMULATED = (
    [("append", None, 200, 10, (), o) for o in (None, RT)]
    + [("append", None, 200, 11 + i, (f,), RT)
       for i, f in enumerate(ec.FAULTS)]
    + [("append", WIDE, 600, 20, ec.FAULTS, o)
       for o in (RT, {"anomalies": ["G1"]}, {**RT, "anomalies": ["G0"]})]
    + [("append", None, 1200, 21, ec.FAULTS, o)
       for o in (RT, {"additional-graphs": ["realtime", "process"]})]
    + [("append", WIDE, 1500, 22, (), RT)]
    + [("wr", None, 200, 30, (), o) for o in (None, WR_RT)]
    + [("wr", None, 200, 31 + i, (f,), WR_RT)
       for i, f in enumerate(WR_FAULTS)]
    + [("wr", None, 600, 40, WR_FAULTS, o)
       for o in ({**WR_RT, "anomalies": ["G2"]},
                 {"sequential-keys": True, "wfr-keys": True},
                 {"linearizable-keys": True})]
    + [("wr", None, 1200, 41, WR_FAULTS, WR_RT),
       ("wr", None, 1500, 42, (), WR_RT)])


@pytest.mark.parametrize(
    "kind,topts,n,seed,faults,opts", SIMULATED,
    ids=[f"{k}-{n}-s{s}-{'+'.join(f) or 'valid'}-{o}"
         for k, _t, n, s, f, o in SIMULATED])
def test_simulated_histories_match_reference(kind, topts, n, seed, faults,
                                             opts):
    h = ec.simulate(n, kind, topts, seed=seed, faults=faults)
    before = elle.launches["closure"]
    if kind == "append":
        got, want = (list_append.check(opts, h, device="cpu"),
                     ref_la.check(opts, h))
    else:
        got, want = (rw_register.check(opts, h, device="cpu"),
                     ref_wr.check(opts, h))
    _same(got, want)
    assert elle.launches["closure"] == before + (n >= 1024)
    if not faults:
        assert got["valid?"] is True   # the simulator is strict serializable
    else:
        assert got["valid?"] is False


def test_planted_faults_show_as_themselves():
    """Each planted fault is detected as its own anomaly type (with the
    realtime graph, so the stale read closes its cycle)."""
    for f in ec.FAULTS:
        h = ec.simulate(300, "append", None, seed=50, faults=(f,))
        r = list_append.check(RT, h, device="cpu")
        assert f in r["anomaly-types"], (f, r["anomaly-types"])
    for f in WR_FAULTS:
        h = ec.simulate(300, "wr", None, seed=51, faults=(f,))
        r = rw_register.check(WR_RT, h, device="cpu")
        assert f in r["anomaly-types"], (f, r["anomaly-types"])


def test_workload_checkers_match_reference():
    ha = H(APPEND_HISTORIES["protocol"])
    hw = H(WR_HISTORIES["protocol"])
    _same(cycle.append()["checker"].check({}, ha),
          ref_cycle.append()["checker"].check({}, ha))
    _same(cycle.wr()["checker"].check({}, hw),
          ref_cycle.wr()["checker"].check({}, hw))
    h = ec.simulate(1100, "append", None, seed=60, faults=ec.FAULTS)
    _same(cycle.AppendChecker(RT, device="cpu").check({}, h),
          ref_cycle.AppendChecker(RT).check({}, h))
    h = ec.simulate(1100, "wr", None, seed=61, faults=WR_FAULTS)
    _same(cycle.WrChecker(WR_RT, device="cpu").check({}, h),
          ref_cycle.WrChecker(WR_RT).check({}, h))
    assert cycle.AppendChecker().checker_name == "append"
    assert cycle.WrChecker().checker_name == "wr"
    assert cycle.AppendChecker().opts == ref_cycle.AppendChecker().opts


def test_generic_cycle_checker_matches_reference():
    def analyzer(mod):
        def run(history):
            g = mod.Graph()
            g.add(0, 1, elle.WW)
            g.add(1, 0, elle.WW)
            return g, None, {0: {}, 1: {}}
        return run
    c = cycle.checker(analyzer(elle))
    assert isinstance(c, FnChecker) and c.checker_name == "cycle"
    _same(c.check({}, H([])),
          ref_cycle.checker(analyzer(ref_elle)).check({}, H([])))


@pytest.mark.parametrize("seed", [1, 7, 45100])
@pytest.mark.parametrize("which", ["append", "wr"])
def test_workload_generators_match_reference(which, seed):
    opts = {"key-count": 2}
    port = getattr(cycle, which)(opts, random.Random(seed))["generator"]
    got = [port() for _ in range(100)]
    with fixed_rand(seed):
        ref = getattr(ref_cycle, which)(opts)["generator"]
        want = [ref() for _ in range(100)]
    assert got == want
