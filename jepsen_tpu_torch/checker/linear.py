"""Host-side just-in-time linearization checker (knossos.linear equivalent).

Lowe/Horn-style JIT linearization (the algorithm behind
`knossos.linear/analysis`, dispatched at reference
jepsen/src/jepsen/checker.clj:194-200): a *configuration* is
(model state, set of open calls already linearized). The history is
processed event by event; at each **return** event the frontier is
closed under "linearize any open, unlinearized call", then filtered to
configurations where the returning call has linearized. The history is
linearizable iff the frontier is non-empty after the last return —
crashed (:info) calls never return, so they stay optional
(SURVEY.md §7.3 hard part #2).

Completeness: any linearization can be reshuffled so every linearization
point sits immediately before the next return event, so closing only at
returns loses nothing.

This formulation is the *spec* for the device engine
(`jepsen_tpu_torch.parallel.engine`): same frontier, same closure, same
filter — there the config packs into (state, slot-mask) rows and the
closure runs on the card. A copy of `jepsen_tpu.checker.linear`, on the
port's models, history and `checker.wgl._StepOp`; the competition race
(`checker.competition`) runs it as a host arm for models that do not
pack.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from jepsen_tpu_torch import models as model_ns
from jepsen_tpu_torch.checker.wgl import _StepOp
from jepsen_tpu_torch.history import Call, calls as history_calls


def _events(cs: List[Call]) -> List[Tuple[int, int, int]]:
    """(history_position, kind, call_id); kind 0=invoke, 1=return.
    Crashed calls emit no return."""
    ev = []
    for c in cs:
        ev.append((c.invoke_index, 0, c.index))
        if not c.crashed:
            ev.append((c.complete_index, 1, c.index))
    ev.sort()
    return ev


def check_calls(model, cs: List[Call], n_history: int,
                max_configs: int = 2_000_000,
                deadline: Optional[float] = None,
                cancel=None) -> dict:
    """With `deadline` (a time.monotonic() instant), the search returns
    {"valid?": "unknown", "timeout": True, "events-done": k, ...} when
    the budget runs out — cooperative, checked once per return event,
    so benchmark timeouts measure real search progress. `cancel` (a
    threading.Event) is polled at the same points: a competition race
    sets it when another arm already produced a decisive verdict."""
    import time as _time
    if not cs:
        return {"valid?": True, "configs": [], "final-paths": []}
    step_ops = [_StepOp(c) for c in cs]
    open_calls: set = set()
    configs = {(model, frozenset())}
    explored = 0
    max_frontier = 1
    events_done = 0

    for pos, kind, cid in _events(cs):
        if deadline is not None and _time.monotonic() > deadline:
            return {"valid?": "unknown", "timeout": True,
                    "events-done": events_done, "explored": explored,
                    "max-frontier": max_frontier}
        if cancel is not None and cancel.is_set():
            return {"valid?": "unknown", "error": "cancelled",
                    "events-done": events_done, "explored": explored,
                    "max-frontier": max_frontier}
        if kind == 0:
            open_calls.add(cid)
            continue
        events_done += 1
        # return event: closure, then require cid linearized
        frontier = set(configs)
        while frontier:
            new = set()
            for s, lin in frontier:
                for oc in open_calls:
                    if oc in lin:
                        continue
                    s2 = s.step(step_ops[oc])
                    explored += 1
                    if model_ns.is_inconsistent(s2):
                        continue
                    cfg = (s2, lin | {oc})
                    if cfg not in configs and cfg not in new:
                        new.add(cfg)
            configs |= new
            frontier = new
            if len(configs) > max_configs:
                # events_done was bumped when THIS event started; only
                # completed events count (matches the timeout path and
                # linear_packed)
                return {"valid?": "unknown",
                        "error": f"config budget exceeded ({max_configs})",
                        "events-done": events_done - 1,
                        "explored": explored,
                        "max-frontier": max(max_frontier, len(configs))}
        max_frontier = max(max_frontier, len(configs))
        configs = {(s, lin - {cid}) for s, lin in configs if cid in lin}
        open_calls.discard(cid)
        if not configs:
            c = cs[cid]
            return {
                "valid?": False,
                "op": {"process": c.process, "f": c.f,
                       "value": c.result if c.f in ("read", "dequeue")
                       else c.value,
                       "index": c.invoke_index},
                "explored": explored,
                "max-frontier": max_frontier,
                "final-paths": [],
                "configs": [],
            }

    return {"valid?": True, "explored": explored,
            "max-frontier": max_frontier, "configs": [], "final-paths": []}


def analysis(model, history, max_configs: int = 2_000_000,
             deadline: Optional[float] = None, cancel=None) -> dict:
    """knossos.linear/analysis equivalent."""
    from jepsen_tpu_torch.history import History, prune_wildcard_calls
    h = history if isinstance(history, History) else History.wrap(history)
    cs = prune_wildcard_calls(history_calls(h))
    return check_calls(model, cs, len(h), max_configs=max_configs,
                       deadline=deadline, cancel=cancel)
