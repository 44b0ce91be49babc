"""Transaction micro-op helpers and generators (elle's txn model, surfaced
through jepsen.tests.cycle.append/wr gen wrappers — tests/cycle/append.clj:
24-27, tests/cycle/wr.clj:9-12).

A port of `jepsen_tpu.elle.txn`. The reference draws from its generator
module's global RNG; here the streams take an explicit
``random.Random``, and seeded with s they yield the reference's stream
under ``generator.fixed_rand(s)``, txn for txn.

A transaction is a list of micro-ops ("mops"): [f, k, v] with
f in {"r", "w", "append"}. Invocations carry nil read values; completions
fill them in:

    invoke  {"f": "txn", "value": [["r", 3, None], ["append", 3, 2]]}
    ok      {"f": "txn", "value": [["r", 3, [1]],  ["append", 3, 2]]}
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional

DEFAULTS = {
    "key-count": 2,
    "min-txn-length": 1,
    "max-txn-length": 2,
    "max-writes-per-key": 32,
}


def _txn_stream(opts: Optional[Dict], write_f: str,
                rand: Optional[random.Random] = None) -> Iterator[list]:
    """Infinite stream of txn mop-lists. Keys come from a sliding active
    pool of `key-count` keys; a key retires once it has taken
    max-writes-per-key writes (elle wr-txns semantics). `rand` None
    draws from a fresh unseeded ``random.Random``."""
    if rand is None:
        rand = random.Random()
    o = {**DEFAULTS, **(opts or {})}
    key_count = o["key-count"]
    lo, hi = o["min-txn-length"], o["max-txn-length"]
    max_writes = o["max-writes-per-key"]
    active: List[int] = list(range(key_count))
    next_key = key_count
    writes: Dict[int, int] = {}

    while True:
        length = rand.randint(lo, hi)
        txn = []
        for _ in range(length):
            k = active[rand.randrange(len(active))]
            if rand.random() < 0.5:
                txn.append(["r", k, None])
            else:
                v = writes.get(k, 0) + 1
                if v > max_writes:
                    i = active.index(k)
                    active[i] = next_key
                    k = next_key
                    next_key += 1
                    v = 1
                writes[k] = v
                txn.append([write_f, k, v])
        yield txn


def txn_generator(opts: Optional[Dict], write_f: str,
                  rand: Optional[random.Random] = None):
    """A jepsen generator of {"f": "txn"} invocations: a plain
    ``next_op`` callable, as the reference's."""
    stream = _txn_stream(opts, write_f, rand)

    def next_op(_test=None, _ctx=None):
        return {"f": "txn", "value": next(stream)}

    return next_op


def wr_txns(opts: Optional[Dict] = None,
            rand: Optional[random.Random] = None) -> Iterator[list]:
    return _txn_stream(opts, "w", rand)


def append_txns(opts: Optional[Dict] = None,
                rand: Optional[random.Random] = None) -> Iterator[list]:
    return _txn_stream(opts, "append", rand)


# ------------------------------------------------------- history plumbing


def ok_txns(history) -> List[dict]:
    """Completed ok txn ops annotated with _id / _invoke_index /
    _complete_index; _id indexes into the returned list."""
    open_by_process: Dict = {}
    out: List[dict] = []
    for i, o in enumerate(history):
        if o.get("f") != "txn":
            continue
        p = o.get("process")
        t = o.get("type")
        if t == "invoke":
            open_by_process[p] = i
        elif t == "ok":
            inv = open_by_process.pop(p, i)
            rec = dict(o)
            rec["_invoke_index"] = inv
            rec["_complete_index"] = i
            rec["_id"] = len(out)
            out.append(rec)
        else:
            open_by_process.pop(p, None)
    return out


def failed_writes(history, write_f: str) -> Dict[int, set]:
    """key -> set of values written by :fail txns (known not committed) —
    the G1a source set."""
    out: Dict[int, set] = {}
    invokes: Dict = {}
    for o in history:
        if o.get("f") != "txn":
            continue
        t = o.get("type")
        p = o.get("process")
        if t == "invoke":
            invokes[p] = o
        elif t == "fail":
            inv = invokes.pop(p, None)
            if inv is None:
                continue
            for mop in inv.get("value") or []:
                f, k, v = mop
                if f == write_f:
                    out.setdefault(k, set()).add(v)
        elif t == "ok":
            invokes.pop(p, None)
    return out


def intermediate_writes(oks: List[dict], write_f: str) -> Dict[int, Dict]:
    """key -> value -> txn, for every write that is NOT the txn's final
    write of that key — the G1b source set."""
    out: Dict[int, Dict] = {}
    for o in oks:
        last: Dict[int, int] = {}
        mops = o.get("value") or []
        for i, (f, k, v) in enumerate(mops):
            if f == write_f:
                last[k] = i
        for i, (f, k, v) in enumerate(mops):
            if f == write_f and last[k] != i:
                out.setdefault(k, {})[v] = o
    return out
