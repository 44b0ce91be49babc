"""Cycle-detection workload wrappers (reference:
jepsen/src/jepsen/tests/cycle.clj, tests/cycle/append.clj,
tests/cycle/wr.clj).

`checker(analyzer)` lifts a graph analyzer into a Checker
(cycle.clj:9-16); `append` / `wr` bundle the elle list-append and
rw-register checkers with matching txn generators into partial tests
(append.clj:30-58).

A port of `jepsen_tpu.workloads.cycle`. The checkers take ``device``
for the SCC closure (None: the card); the generators take an explicit
``random.Random``. The reference's ``AtomDB``, ``AtomClient`` and
``noop_test`` need its client and test runner and are not ported.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, Optional

from jepsen_tpu_torch import elle
from jepsen_tpu_torch.checker.core import Checker, FnChecker
from jepsen_tpu_torch.elle import list_append, rw_register


def checker(analyzer: Callable, device=None) -> Checker:
    """A Checker from a history -> (graph, explainer, by_id) analyzer
    (cycle.clj:9-16)."""
    return FnChecker(
        lambda test, history, opts: elle.check(analyzer, history, device),
        name="cycle")


class AppendChecker(Checker):
    """Full list-append checker (append.clj:11-22); default anomalies
    [G1 G2]."""

    def __init__(self, opts: Optional[Dict] = None, device=None):
        self.opts = {"anomalies": ["G1", "G2"], **(opts or {})}
        self.device = device

    def check(self, test, history, opts=None):
        return list_append.check(self.opts, history, self.device)

    @property
    def checker_name(self):
        return "append"


class WrChecker(Checker):
    """Full rw-register checker (wr.clj:14-54)."""

    def __init__(self, opts: Optional[Dict] = None, device=None):
        self.opts = opts or {}
        self.device = device

    def check(self, test, history, opts=None):
        return rw_register.check(self.opts, history, self.device)

    @property
    def checker_name(self):
        return "wr"


def append(opts: Optional[Dict] = None,
           rand: Optional[random.Random] = None, device=None) -> Dict:
    """Partial test {generator, checker} for list-append histories
    (append.clj:30-58)."""
    return {"generator": list_append.gen(opts, rand),
            "checker": AppendChecker(opts, device)}


def wr(opts: Optional[Dict] = None,
       rand: Optional[random.Random] = None, device=None) -> Dict:
    """Partial test {generator, checker} for rw-register histories."""
    return {"generator": rw_register.gen(opts, rand),
            "checker": WrChecker(opts, device)}
