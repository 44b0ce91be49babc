"""Host-side Wing–Gong–Lowe linearizability checker — the CPU oracle.

Re-implements the capability of `knossos.wgl/analysis` (reference call
surface: jepsen/src/jepsen/checker.clj:17-23,194-213): depth-first search
over linearization orders with Lowe's visited-(state, linearized-bitset)
cache, operating on the Call records produced by
`jepsen_tpu_torch.history.calls`.

Crash semantics (SURVEY.md §7.3 hard part #2): a crashed (:info) call has
no return event — it stays concurrent with everything after it and may be
linearized at any point *or never*. The search succeeds when every
*completed* call is linearized; crashed calls are optional.

This is deliberately simple, allocation-light Python: it is the
counterexample re-search of the device engine
(`jepsen_tpu_torch.parallel.engine`) and the fallback for histories the
encoder cannot pack. A copy of `jepsen_tpu.checker.wgl`.

Result shape mirrors knossos: {"valid?", "op" (first stuck op),
"final-paths" (counter-example traces of {"op", "model"}), "configs"}.
"""

from __future__ import annotations

import time as _time
from typing import Any, List, Optional

from jepsen_tpu_torch import models as model_ns
from jepsen_tpu_torch.history import Call, calls as history_calls


class _EventList:
    """Doubly-linked list of call/return events over array storage.

    Node ids: 2*i = call event of call i, 2*i+1 = return event. Crashed
    calls have no return node. Lift/unlift are O(1), as WGL requires.
    """

    def __init__(self, cs: List[Call], n_history: int):
        events = []  # (position, node_id)
        for c in cs:
            events.append((c.invoke_index, 2 * c.index))
            if not c.crashed:
                events.append((c.complete_index, 2 * c.index + 1))
        events.sort()
        n_nodes = 2 * len(cs)
        self.next = [-1] * (n_nodes + 1)  # +1: virtual head at index n_nodes
        self.prev = [-1] * (n_nodes + 1)
        self.HEAD = n_nodes
        prev = self.HEAD
        for _, nid in events:
            self.next[prev] = nid
            self.prev[nid] = prev
            prev = nid
        self.next[prev] = -1

    def head(self) -> int:
        return self.next[self.HEAD]

    def lift(self, call_id: int, crashed: bool):
        """Remove call (and return, unless crashed) events of call_id."""
        for nid in ((2 * call_id,) if crashed else (2 * call_id, 2 * call_id + 1)):
            p, n = self.prev[nid], self.next[nid]
            self.next[p] = n
            if n != -1:
                self.prev[n] = p

    def unlift(self, call_id: int, crashed: bool):
        """Reinsert events (exact inverse of lift, relies on prev/next of
        the removed nodes being preserved)."""
        for nid in ((2 * call_id + 1, 2 * call_id) if not crashed
                    else (2 * call_id,)):
            p, n = self.prev[nid], self.next[nid]
            self.next[p] = nid
            if n != -1:
                self.prev[n] = nid


def _candidates(ev: _EventList, start_after: Optional[int] = None):
    """Call ids linearizable next: call events before the first return
    event in the remaining list. If start_after is a call id, resume
    enumeration after its call node (for backtracking)."""
    nid = ev.next[2 * start_after] if start_after is not None else ev.head()
    while nid != -1:
        if nid % 2 == 1:  # return event — nothing beyond is linearizable
            return
        yield nid // 2
        nid = ev.next[nid]


class _StepOp:
    """Adapter giving Call records the .f/.value interface models expect,
    with observing ops (reads, dequeues) carrying their completion value
    (knossos complete merges ok values into the invocation)."""

    __slots__ = ("f", "value")

    def __init__(self, c: Call):
        self.f = c.f
        if c.f in ("read", "dequeue"):
            self.value = c.result if not c.crashed else None
        else:
            self.value = c.value


def check_calls(model, cs: List[Call], n_history: int,
                max_states: int = 50_000_000,
                deadline: Optional[float] = None,
                cancel=None) -> dict:
    """Run WGL over prepared calls. Returns a knossos-shaped result.
    With `deadline` (a time.monotonic() instant) the search returns
    `{"valid?": "unknown", "timeout": True}` when it runs past it —
    the same cooperative contract as checker.linear — checked every
    4096 explored states so the overshoot is bounded. `cancel` (a
    threading.Event) is polled at the same stride: a competition race
    sets it when another arm has already produced a decisive verdict
    (knossos competition/analysis future-cancel parity)."""
    m = len(cs)
    if m == 0:
        return {"valid?": True, "configs": [], "final-paths": []}

    ev = _EventList(cs, n_history)
    step_ops = [_StepOp(c) for c in cs]
    crashed = [c.crashed for c in cs]
    completed_mask = 0
    for c in cs:
        if not c.crashed:
            completed_mask |= 1 << c.index

    visited = set()
    stack: list = []  # (call_id, prev_state)
    state = model
    linearized = 0
    explored = 0

    # best (deepest) failure info for counter-example reporting
    best_depth = -1
    best_path: list = []
    best_stuck: Optional[Call] = None

    cand_iter = _candidates(ev)

    while True:
        # success: every *completed* call linearized; crashed calls are
        # optional (checked at loop top so all-crashed histories pass
        # without forcing any crashed op to linearize)
        if (linearized & completed_mask) == completed_mask:
            return {"valid?": True,
                    "explored": explored,
                    "linearization": [cs[i].index for i, _ in stack],
                    "configs": [], "final-paths": []}
        # pick next candidate
        cid = None
        for cid in cand_iter:
            break
        else:
            cid = None
        if cid is not None:
            c = cs[cid]
            s2 = state.step(step_ops[cid])
            explored += 1
            if explored > max_states:
                return {"valid?": "unknown",
                        "error": f"state budget exceeded ({max_states})",
                        "explored": explored}
            if (explored & 0xFFF) == 0:
                if deadline is not None and _time.monotonic() > deadline:
                    return {"valid?": "unknown", "error": "deadline",
                            "timeout": True, "explored": explored}
                if cancel is not None and cancel.is_set():
                    return {"valid?": "unknown", "error": "cancelled",
                            "explored": explored}
            key = (s2, linearized | (1 << cid))
            if not model_ns.is_inconsistent(s2) and key not in visited:
                visited.add(key)
                stack.append((cid, state))
                ev.lift(cid, crashed[cid])
                linearized |= 1 << cid
                state = s2
                cand_iter = _candidates(ev)
            else:
                cand_iter = _resume(ev, cid)
        else:
            # exhausted candidates at this node: record, backtrack
            if len(stack) > best_depth:
                best_depth = len(stack)
                best_path = [(cs[i], st) for i, st in stack] + [(None, state)]
                head = ev.head()
                best_stuck = cs[head // 2] if head != -1 else None
            if not stack:
                return _invalid_result(model, best_path, best_stuck, explored,
                                       state, linearized, cs)
            cid_prev, state = stack.pop()
            ev.unlift(cid_prev, crashed[cid_prev])
            linearized &= ~(1 << cid_prev)
            cand_iter = _resume(ev, cid_prev)


def _resume(ev: _EventList, after_call_id: int):
    return _candidates(ev, start_after=after_call_id)


def _invalid_result(model, best_path, best_stuck, explored, state, linearized,
                    cs) -> dict:
    path = []
    stuck_state = model
    for c, st in best_path:
        if c is None:
            stuck_state = st  # sentinel carries the state at the dead end
            continue
        path.append({"op": {"process": c.process, "f": c.f,
                            "value": c.value, "index": c.invoke_index},
                     "model": str(st)})
    stuck_op = None
    if best_stuck is not None:
        # report the observed value for reads/dequeues (the completion
        # is what the search couldn't explain), invocation args otherwise
        v = (best_stuck.result
             if best_stuck.f in ("read", "dequeue") and not best_stuck.crashed
             else best_stuck.value)
        stuck_op = {"process": best_stuck.process, "f": best_stuck.f,
                    "value": v, "index": best_stuck.invoke_index}
    return {
        "valid?": False,
        "op": stuck_op,
        "explored": explored,
        "final-paths": [path[:64]] if path else [],
        "configs": [{"model": str(stuck_state)}],
    }


def analysis(model, history, max_states: int = 50_000_000,
             deadline: Optional[float] = None, cancel=None) -> dict:
    """knossos.wgl/analysis equivalent: (model, history) -> result.

    History may be a `History` or plain list of op dicts; invocations are
    paired/completed internally. `deadline` is a time.monotonic()
    instant for the cooperative timeout; `cancel` a threading.Event
    polled at the same stride (see check_calls).
    """
    from jepsen_tpu_torch.history import History, prune_wildcard_calls
    h = history if isinstance(history, History) else History.wrap(history)
    cs = prune_wildcard_calls(history_calls(h))
    return check_calls(model, cs, len(h), max_states=max_states,
                       deadline=deadline, cancel=cancel)
