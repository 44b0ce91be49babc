"""elle's SCC closure on the card against the same on the CPU.

On the card (`cuda`): ``elle.device_sccs`` — the bf16 squarings with an
fp32 product, ``torch.mm`` on the card — gives exactly the SCCs, in
exactly the order, of its plain fp32 run on the CPU, on seeded random
graphs of 1,024 to 4,096 nodes with a planted SCC; and the list-append
and rw-register checkers give the CPU's whole result on simulated
histories past the device route's threshold.

This file imports no JAX, so the card's run needs none.
"""

import pytest
import torch

import torch_elle_cases as ec
from jepsen_tpu_torch import elle
from jepsen_tpu_torch.workloads import cycle


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the closure's card route runs "
                    "only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,planted", [(1024, 300), (2048, 1000),
                                       (3000, 0), (4096, 2500)])
def test_device_sccs_on_the_card_equals_the_cpu(n, planted):
    dev = _cuda()
    g = ec.random_graph(n, 100 + n, planted=planted)
    want = elle.device_sccs(g, device="cpu")
    before = elle.launches["closure"]
    assert elle.device_sccs(g, device=dev) == want
    assert elle.device_sccs(g) == want          # None: the card
    assert elle.launches["closure"] == before + 2
    assert want == ec.reference_order(elle.tarjan_sccs(g))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["append", "wr"])
def test_checkers_on_the_card_equal_the_cpu(kind):
    dev = _cuda()
    if kind == "append":
        faults, opts, make = ec.FAULTS, ec.RT, cycle.AppendChecker
    else:
        faults, opts, make = ec.WR_FAULTS, ec.WR_RT, cycle.WrChecker
    for fs in ((), faults):
        h = ec.simulate(1500, kind, None, seed=7, faults=fs)
        assert make(opts, device=dev).check({}, h) \
            == make(opts, device="cpu").check({}, h)
