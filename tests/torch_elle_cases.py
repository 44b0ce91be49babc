"""Seeded inputs for elle's checkers and SCC closure: simulated
transactional histories and random dependency graphs.

Import-safe and free of JAX: the CPU tests feed the same inputs to the
reference and the port, and chip_smoke.py loads this file by its path
for the card's phase.

``simulate`` runs `n_procs` processes against an in-memory store.
Each process invokes its next transaction (drawn from the port's
``elle.txn`` stream under a seeded ``random.Random``) after a short
pause; the transaction takes effect atomically at a random instant
between its invocation and its completion. Reads see the store at that
instant, so a history without faults is strict serializable. ``faults``
names the anomalies to plant, each once, on keys of its own (fresh keys
from FAULT_KEY_BASE on, with values 1 and 2) so that each shows as
itself:

  G1a                 a transaction that fails appends/writes a value,
                      and the next reader of that key sees it
  G1b                 a transaction writes a key twice, and the next
                      reader sees the first of the two writes
  G2                  a lost update: two overlapping transactions each
                      read the key and write it, the second reading the
                      state from before the first's write
  incompatible-order  (list-append only) two appends, one reader that
                      sees [1, 2] and one that sees [2, 1]
  G-single            a stale read: one transaction writes 1, one
                      invoked after it completed writes 2, and one
                      invoked after that completed still reads 1 — the
                      staleness is bounded by one write
"""

from __future__ import annotations

import heapq
import random
from typing import Dict, List, Optional, Sequence

from jepsen_tpu_torch.elle import Graph, WW
from jepsen_tpu_torch.elle import txn as txn_mod

FAULTS = ("G1a", "G1b", "G2", "incompatible-order", "G-single")
FAULT_KEY_BASE = 1_000_000
# where in the history (a fraction of its transactions) each fault starts
_AT = {"G1a": 0.15, "G1b": 0.3, "G2": 0.45, "incompatible-order": 0.6,
       "G-single": 0.75}


def _schedule(n: int, n_procs: int, rng: random.Random) -> List[dict]:
    """n transactions' process, invoke, effect and complete times: each
    process invokes its next one after a pause of up to 1 after its
    last completion, and takes 0.5-5 to complete."""
    free = [(rng.random(), p) for p in range(n_procs)]
    heapq.heapify(free)
    out = []
    for _ in range(n):
        t, p = heapq.heappop(free)
        inv = t + rng.random()
        dur = 0.5 + 4.5 * rng.random()
        out.append({"process": p, "inv": inv,
                    "eff": inv + dur * rng.random(), "comp": inv + dur})
        heapq.heappush(free, (inv + dur, p))
    return out


def _next_after(txs, i: int, pred) -> int:
    """The first transaction after i in effect order that `pred` takes."""
    for j in sorted(range(len(txs)), key=lambda j: txs[j]["eff"]):
        if txs[j]["eff"] > txs[i]["eff"] and pred(j):
            return j
    raise ValueError("simulate: no transaction to plant the fault on")


def _plant(txs, faults, kind: str, wf: str) -> None:
    """Rewrites the chosen transactions' mops for each fault and marks
    the reads the store must not answer honestly (``"forced"``)."""
    used = set()
    n = len(txs)

    def free(j):
        return j not in used

    def first_free(frac):
        j = int(frac * n)
        while j in used:
            j += 1
        return j

    def take(j, mops, **kw):
        used.add(j)
        txs[j]["mops"] = mops
        txs[j].update(kw)
        return j

    for f in faults:
        if f == "incompatible-order" and kind != "append":
            raise ValueError("incompatible-order is a list-append fault")
        k = FAULT_KEY_BASE + FAULTS.index(f)
        i = first_free(_AT[f])
        if f == "G1a":
            a = take(i, [[wf, k, 1]], aborted=True)
            take(_next_after(txs, a, free), [["r", k, None]],
                 forced={k: [1] if kind == "append" else 1})
        elif f == "G1b":
            w = take(i, [[wf, k, 1], [wf, k, 2]])
            take(_next_after(txs, w, free), [["r", k, None]],
                 forced={k: [1] if kind == "append" else 1})
        elif f == "G2":
            a = take(i, [["r", k, None], [wf, k, 1]])
            b = _next_after(txs, a, lambda j: free(j)
                            and txs[j]["inv"] < txs[a]["comp"])
            take(b, [["r", k, None], [wf, k, 2]],
                 forced={k: [] if kind == "append" else None})
        elif f == "incompatible-order":
            w1 = take(i, [[wf, k, 1]])
            w2 = take(_next_after(txs, w1, free), [[wf, k, 2]])
            r1 = take(_next_after(txs, w2, free), [["r", k, None]])
            take(_next_after(txs, r1, free), [["r", k, None]],
                 forced={k: [2, 1]})
        elif f == "G-single":
            w1 = take(i, [[wf, k, 1]])
            w2 = take(_next_after(txs, w1, lambda j: free(j)
                                  and txs[j]["inv"] > txs[w1]["comp"]),
                      [[wf, k, 2]])
            take(_next_after(txs, w2, lambda j: free(j)
                             and txs[j]["inv"] > txs[w2]["comp"]),
                 [["r", k, None]],
                 forced={k: [1] if kind == "append" else 1})
        else:
            raise ValueError(f"unknown fault {f!r}")


def simulate(n_txns: int, kind: str = "append", opts: Optional[Dict] = None,
             n_procs: int = 10, seed: int = 0,
             faults: Sequence[str] = ()) -> List[dict]:
    """A history of `n_txns` committed transactions (plus one that fails
    where G1a is planted): op dicts with type, process, f "txn", value
    and index, in time order. `kind` "append" (list-append) or "wr"
    (rw-register); `opts` the txn stream's (key-count, min/max-txn-
    length, max-writes-per-key)."""
    wf = {"append": "append", "wr": "w"}[kind]
    rng = random.Random(seed)
    stream = txn_mod._txn_stream(opts, wf, random.Random(seed + 1))
    n = n_txns + ("G1a" in faults)
    txs = _schedule(n, n_procs, rng)
    for t in txs:
        t["mops"] = next(stream)
    _plant(txs, faults, kind, wf)

    store: Dict = {}
    for t in sorted(txs, key=lambda t: t["eff"]):
        if t.get("aborted"):
            t["done"] = [list(m) for m in t["mops"]]
            continue
        forced = t.get("forced", {})
        done = []
        for f, k, v in t["mops"]:
            if f == "r":
                if k in forced:
                    v = forced[k]
                elif kind == "append":
                    v = list(store.get(k, []))
                else:
                    v = store.get(k)
            elif kind == "append":
                store.setdefault(k, []).append(v)
            else:
                store[k] = v
            done.append([f, k, v])
        t["done"] = done

    events = []
    for t in txs:
        events.append((t["inv"], 0, t))
        events.append((t["comp"], 1, t))
    events.sort(key=lambda e: (e[0], e[1]))
    history = []
    for at, is_comp, t in events:
        if is_comp:
            typ = "fail" if t.get("aborted") else "ok"
            value = t["done"]
        else:
            typ = "invoke"
            value = [[f, k, None if f == "r" else v]
                     for f, k, v in t["mops"]]
        history.append({"type": typ, "process": t["process"], "f": "txn",
                        "value": value, "index": len(history)})
    return history


def random_graph(n: int, seed: int, planted: int = 0,
                 edges_per_node: float = 2.0, graph_cls=Graph):
    """A graph on n nodes with ids 0..n-1, added in a seeded shuffled
    order (so the graph's insertion order is not the sorted one), with
    about `edges_per_node` * n random edges and, when `planted` > 0, one
    cycle through `planted` random nodes (an SCC of at least that
    many). `graph_cls` is the Graph class to build (the reference's has
    the same methods), so that both get the same calls in order."""
    rng = random.Random(seed)
    ids = list(range(n))
    rng.shuffle(ids)
    g = graph_cls()
    for v in ids:
        g.add_node(v)
    for _ in range(int(edges_per_node * n)):
        g.add(ids[rng.randrange(n)], ids[rng.randrange(n)], WW)
    if planted:
        ring = rng.sample(ids, planted)
        for a, b in zip(ring, ring[1:] + ring[:1]):
            g.add(a, b, WW)
    return g


def reference_order(sccs: List[List[int]]) -> List[List[int]]:
    """SCCs put in the device route's order: members sorted, components
    by their smallest member — what ``device_sccs`` must give for the
    sets ``tarjan_sccs`` finds (node ids are their own sort keys)."""
    return sorted(sorted(c) for c in sccs)


# ------------------------------------------- chip_smoke.py's elle phase

#: committed transactions of each smoke history: a short Jepsen elle run
SMOKE_TXNS = 10_000
RT = {"additional-graphs": ["realtime"]}
WR_RT = {**RT, "linearizable-keys": True, "wfr-keys": True}
WR_FAULTS = tuple(f for f in FAULTS if f != "incompatible-order")
#: name -> (kind, txn-stream opts, seed, checker opts, the twin's faults):
#: elle's defaults (txn.py's DEFAULTS: 2 keys, 1-2 mops, 32 writes a
#: key), 10 keys with 1-4 mops, and rw-register at the defaults
SMOKE_HISTORIES = {
    "append-defaults": ("append", None, 1601, RT, FAULTS),
    "append-k10-m4": ("append", {"key-count": 10, "min-txn-length": 1,
                                 "max-txn-length": 4}, 1602, RT, FAULTS),
    "wr-defaults": ("wr", None, 1603, WR_RT, WR_FAULTS),
}


def smoke_history(name: str, twin: bool) -> List[dict]:
    """The smoke's history `name` (SMOKE_HISTORIES), valid or its invalid
    twin, of SMOKE_TXNS committed transactions."""
    kind, topts, seed, _opts, faults = SMOKE_HISTORIES[name]
    return simulate(SMOKE_TXNS, kind, topts, seed=seed,
                    faults=faults if twin else ())


def result_digest(r: dict) -> dict:
    """What the smoke holds a checker's result to: valid?, the anomaly
    types, and the sha256 of the canonical JSON of the anomalies."""
    import hashlib
    import json
    doc = json.dumps(r["anomalies"], sort_keys=True, separators=(",", ":"))
    return {"valid?": r["valid?"], "anomaly-types": r["anomaly-types"],
            "anomalies": hashlib.sha256(doc.encode()).hexdigest()}
