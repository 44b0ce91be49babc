"""Checker protocol and combinators (reference: jepsen/src/jepsen/checker.clj:26-113).

A checker consumes a test map, an indexed history, and an opts dict, and
produces a results dict whose `"valid?"` key is True, False, or
`"unknown"`.

Validity lattice (checker.clj merge-valid): False > "unknown" > True —
any invalid makes the composition invalid; any unknown (absent invalid)
makes it unknown.

A port of the part of `jepsen_tpu.checker.core` the linearizability
and cycle checkers need. `Compose` runs its checkers one after another, where the
reference runs them in a thread pool: the results are the same, and the
port's device checks do not contend for the card.
"""

from __future__ import annotations

import traceback
from typing import Any, Dict, Optional

UNKNOWN = "unknown"


def valid_priority(v) -> int:
    if v is False:
        return 0
    if v == UNKNOWN:
        return 1
    return 2


def merge_valid(vs) -> Any:
    """Worst-of validity (checker.clj:31-45)."""
    out = True
    for v in vs:
        if valid_priority(v) < valid_priority(out):
            out = v
    return out


class Checker:
    """Protocol: (check test history opts) -> results dict
    (checker.clj:49-64)."""

    def check(self, test, history, opts: Optional[dict] = None) -> Dict[str, Any]:
        raise NotImplementedError

    # name used by compose results and stores
    @property
    def checker_name(self) -> str:
        return type(self).__name__.lower()


class FnChecker(Checker):
    """A checker from a plain ``fn(test, history, opts)``."""

    def __init__(self, fn, name="fn"):
        self._fn = fn
        self._name = name

    def check(self, test, history, opts=None):
        return self._fn(test, history, opts or {})

    @property
    def checker_name(self):
        return self._name


def check_safe(checker: Checker, test, history, opts=None) -> Dict[str, Any]:
    """Run a checker, converting exceptions into
    {"valid?": "unknown", "error": <trace>} (checker.clj:66-75) so one
    broken checker never loses a test's results."""
    try:
        return checker.check(test, history, opts or {})
    except Exception:  # noqa: BLE001
        return {"valid?": UNKNOWN, "error": traceback.format_exc()}


class Compose(Checker):
    """Map of name -> checker, all run; results nested under each name
    plus merged validity."""

    def __init__(self, checkers: Dict[str, Checker]):
        self.checkers = dict(checkers)

    def check(self, test, history, opts=None):
        out = {n: check_safe(c, test, history, opts)
               for n, c in self.checkers.items()}
        out["valid?"] = merge_valid(r.get("valid?", UNKNOWN)
                                    for r in list(out.values()))
        return out


def compose(checkers: Dict[str, Checker]) -> Compose:
    return Compose(checkers)
