"""Synthetic history generators — test + benchmark corpora.

The reference benchmarks knossos on register histories ("knossos
benchmark corpus: etcd/cockroach register histories", BASELINE.json
configs; knossos.history generators). We generate equivalent corpora in
process: concurrent cas-register histories that are *valid by
construction* (every effect applied at a legal linearization point), with
optional crashes and failures, plus adversarial corruption for invalid
cases. Deterministic under a seed. A copy of `jepsen_tpu.histories`: the same
seed gives the same history.
"""

from __future__ import annotations

import random
from typing import Optional

from jepsen_tpu_torch.history import History, Op


def _simulate(
    n_ops: int,
    n_processes: int,
    busy: float,
    crash_p: float,
    seed: int,
    choose_op,      # (rng) -> (f, invoke_value)
    complete_op,    # (rng, f, v) -> (type, completion_value); applies effect
    crash_op,       # (rng, f, v) -> None; maybe-applies effect (both legal)
) -> History:
    """The shared concurrent-simulation driver behind every generator:
    a true model state evolves; each op's effect is applied at its
    completion instant (a legal linearization point inside its
    [invoke, complete] window), so histories are valid by construction.
    Crashed (:info) ops are applied-or-not by `crash_op` and their
    process id is retired for a fresh one; `busy` biases toward opening
    new calls before completing pending ones (higher -> more
    concurrency -> wider search windows).

    **The n_ops contract** (pinned by tests/test_generator.py):
    ``n_ops`` counts INVOCATIONS — operation attempts — exactly like
    the reference's generators count :invoke entries. Every invocation
    also emits exactly one completion row (``ok``/``fail``/``info``),
    so ``len(history) == 2 * n_ops``, with the two rows of one call
    interleaved arbitrarily far apart. Do NOT slice a generated
    history by ``n_ops`` expecting "the whole thing" — that truncates
    mid-stream, leaves calls dangling open, and reads like a phantom
    parity bug when two differently-sliced views are compared. Slice
    by ``len(ops)`` (or not at all); a prefix slice is still a VALID
    history (open calls are legal), just not the full one."""
    rng = random.Random(seed)
    h = History()
    pending: dict = {}      # process -> (f, invoke value)
    free = list(range(n_processes))
    next_process = n_processes
    started = 0
    t = 0

    def emit(typ, process, f, val, **kw):
        nonlocal t
        t += rng.randint(1, 1000)
        h.append(Op(type=typ, process=process, f=f, value=val, time=t, **kw))

    while started < n_ops or pending:
        can_start = started < n_ops and free
        if can_start and (not pending or rng.random() < busy):
            p = free.pop(rng.randrange(len(free)))
            f, v = choose_op(rng)
            emit("invoke", p, f, v)
            pending[p] = (f, v)
            started += 1
        else:
            p = rng.choice(list(pending))
            f, v = pending.pop(p)
            if rng.random() < crash_p:
                crash_op(rng, f, v)
                emit("info", p, f, v, error="indeterminate")
                free.append(next_process)
                next_process += 1
            else:
                typ, out = complete_op(rng, f, v)
                emit(typ, p, f, out)
                free.append(p)
    return h.index()


def rand_register_history(
    n_ops: int = 100,
    n_processes: int = 5,
    n_values: int = 5,
    cas: bool = True,
    crash_p: float = 0.05,
    fail_p: float = 0.05,
    busy: float = 0.5,
    seed: int = 45100,
) -> History:
    """A random, linearizable-by-construction cas-register history
    (see `_simulate` for the driver semantics — NOTE ``n_ops`` counts
    invocations, so the history has ``2 * n_ops`` rows). Failed ops
    never apply. Default seed 45100 is the reference's test seed
    (jepsen/src/jepsen/generator/test.clj:30-47).
    """
    state = {"value": None}

    def choose(rng):
        r = rng.random()
        if cas and r < 0.3:
            return "cas", [rng.randrange(n_values), rng.randrange(n_values)]
        if r < 0.6:
            return "write", rng.randrange(n_values)
        return "read", None

    def complete(rng, f, v):
        if f != "read" and rng.random() < fail_p:
            return "fail", v
        value = state["value"]
        if f == "read":
            return "ok", value
        new_value, ok = _apply(value, f, v)
        state["value"] = new_value
        return ("ok", v) if ok else ("fail", v)

    def crash(rng, f, v):
        if rng.random() < 0.5:
            state["value"] = _apply(state["value"], f, v)[0]

    return _simulate(n_ops, n_processes, busy, crash_p, seed,
                     choose, complete, crash)


def _apply(value, f, v):
    if f == "write":
        return v, True
    if f == "cas":
        old, new = v
        if value == old:
            return new, True
        return value, False
    return value, True


def rand_gset_history(
    n_ops: int = 100,
    n_processes: int = 5,
    n_elements: int = 8,
    read_p: float = 0.4,
    crash_p: float = 0.05,
    busy: float = 0.5,
    seed: int = 45100,
) -> History:
    """A random, linearizable-by-construction grow-only-set history:
    adds of distinct elements and full-set reads (see `_simulate` —
    ``n_ops`` counts invocations; the history has ``2 * n_ops``
    rows)."""
    true_set: set = set()
    counter = iter(range(n_elements))

    def choose(rng):
        if rng.random() >= read_p:
            v = next(counter, None)
            if v is not None:
                return "add", v
        return "read", None

    def complete(rng, f, v):
        if f == "add":
            true_set.add(v)
            return "ok", v
        return "ok", sorted(true_set)

    def crash(rng, f, v):
        if f == "add" and rng.random() < 0.5:
            true_set.add(v)

    return _simulate(n_ops, n_processes, busy, crash_p, seed,
                     choose, complete, crash)


def rand_queue_history(
    n_ops: int = 100,
    n_processes: int = 5,
    n_values: int = 3,
    deq_p: float = 0.45,
    crash_p: float = 0.05,
    busy: float = 0.5,
    seed: int = 45100,
) -> History:
    """A random, linearizable-by-construction unordered-queue history:
    enqueues of a small value domain and dequeues returning any pending
    element (see `_simulate` — ``n_ops`` counts invocations; the
    history has ``2 * n_ops`` rows). Dequeues finding the queue empty
    complete as :fail (dropped by the checkers, like a client-side
    retryable empty-queue error)."""
    from collections import Counter
    q: Counter = Counter()

    def pop_random(rng):
        x = rng.choice(list(q.elements()))
        q[x] -= 1
        return x

    def choose(rng):
        if rng.random() < deq_p:
            return "dequeue", None
        return "enqueue", rng.randrange(n_values)

    def complete(rng, f, v):
        if f == "enqueue":
            q[v] += 1
            return "ok", v
        if sum(q.values()) == 0:
            return "fail", None
        return "ok", pop_random(rng)

    def crash(rng, f, v):
        # crashed: enqueues maybe applied; dequeues maybe popped
        if f == "enqueue" and rng.random() < 0.5:
            q[v] += 1
        elif (f == "dequeue" and sum(q.values()) > 0
              and rng.random() < 0.5):
            pop_random(rng)

    return _simulate(n_ops, n_processes, busy, crash_p, seed,
                     choose, complete, crash)


def rand_fifo_history(
    n_ops: int = 100,
    n_processes: int = 5,
    n_values: int = 3,
    deq_p: float = 0.45,
    crash_p: float = 0.05,
    busy: float = 0.5,
    seed: int = 45100,
) -> History:
    """A random, linearizable-by-construction strict-FIFO history (see
    `_simulate` — ``n_ops`` counts invocations; the history has
    ``2 * n_ops`` rows): dequeues return the true head; empty-queue dequeues
    complete as :fail (dropped by the checkers). Dequeue-biased once
    the queue runs deep, so the packed device tier's depth bound stays
    inside its 31-bit budget."""
    from collections import deque
    q: deque = deque()

    def choose(rng):
        if len(q) >= 3 or rng.random() < deq_p:
            return "dequeue", None
        return "enqueue", rng.randrange(n_values)

    def complete(rng, f, v):
        if f == "enqueue":
            q.append(v)
            return "ok", v
        if not q:
            return "fail", None
        return "ok", q.popleft()

    def crash(rng, f, v):
        if f == "enqueue" and rng.random() < 0.5:
            q.append(v)
        elif f == "dequeue" and q and rng.random() < 0.5:
            q.popleft()

    return _simulate(n_ops, n_processes, busy, crash_p, seed,
                     choose, complete, crash)


def adversarial_register_history(
    n_ops: int = 1000,
    k_crashed: int = 12,
    n_values: int = 5,
    seed: int = 45100,
) -> History:
    """The knossos-killer shape: k concurrent crashed writes of distinct
    values opened at the start and never completed, followed by a
    sequential write/read tail. Every crashed write stays open forever
    (knossos completes :info ops at history end — SURVEY.md §2.10), so
    the search must carry ~2^k linearized-subset configurations through
    EVERY later event: the host's per-config frontier walk grinds at
    ~2^k work per return, while the bit-packed device engine's cost is
    independent of the live frontier (the whole mask space is a static
    [S, 2^C/32] tensor). Valid by construction: reads return the last
    completed write (crashed writes "not yet" linearized — always
    legal). Host cost scales 2^k; device cost does not."""
    rng = random.Random(seed)
    h = History()
    t = 0

    def emit(typ, process, f, val, **kw):
        nonlocal t
        t += 1
        h.append(Op(type=typ, process=process, f=f, value=val, time=t, **kw))

    for i in range(k_crashed):
        emit("invoke", 500 + i, "write", 1000 + i)
    state = None
    for j in range(max(0, n_ops - k_crashed)):
        if j % 2 == 0:
            v = rng.randrange(n_values)
            emit("invoke", 0, "write", v)
            emit("ok", 0, "write", v)
            state = v
        else:
            emit("invoke", 0, "read", None)
            emit("ok", 0, "read", state)
    return h.index()


def with_impossible_read(h: History, value=999,
                         process: int = 90) -> History:
    """Append a read observing `value` — pick one no write/enqueue ever
    produced and the result is invalid with the failure at the very
    end. The canonical invalid suffix for engine differential tests."""
    ops = [dict(o) for o in h]
    n = len(ops)
    t = (ops[-1]["time"] + 1) if ops else 0
    ops += [{"index": n, "time": t, "process": process,
             "type": "invoke", "f": "read", "value": None},
            {"index": n + 1, "time": t + 1, "process": process,
             "type": "ok", "f": "read", "value": value}]
    return History.wrap(ops).index()


def corrupt_history(h: History, seed: int = 0,
                    n_corruptions: int = 1) -> History:
    """Flip ok completion values to likely-inconsistent ones —
    adversarial invalid(ish) histories; pair with a checker oracle,
    don't assume. Reads claim unobservable values (scalar bump, or a
    never-added element for collection-valued reads); dequeues claim a
    never-enqueued value, so queue families get invalid coverage too."""
    rng = random.Random(seed)
    out = History.wrap(Op(dict(o)) for o in h)
    targets = [i for i, o in enumerate(out)
               if o.get("type") == "ok" and o.get("f") in ("read", "dequeue")
               and o.get("value") is not None]
    for i in rng.sample(targets, min(n_corruptions, len(targets))):
        v = out[i]["value"]
        if isinstance(v, list):
            # set-style read (gset observes a collection): claim an
            # element that was never added
            out[i]["value"] = v + [1000 + i]
        elif isinstance(v, (set, frozenset)):
            out[i]["value"] = set(v) | {1000 + i}
        else:
            out[i]["value"] = (v or 0) + 1000
    return out.index()
