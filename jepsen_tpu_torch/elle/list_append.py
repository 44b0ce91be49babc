"""List-append transactional checker (elle.list-append capability;
call surface jepsen/src/jepsen/tests/cycle/append.clj:11-27).

Transactions append unique values to per-key lists and read whole lists.
Because reads expose the full list, the version order per key is directly
observable: every read is a prefix of the key's final append order, so
incompatible reads are themselves an anomaly ("incompatible-order"), and
ww/wr/rw edges fall out of the longest observed order.

Checked anomalies: internal, G1a (aborted read), G1b (intermediate read),
dirty-update, incompatible-order, and the cycle family G0/G1c/G-single/G2
(classification machinery in jepsen_tpu_torch.elle).

A port of `jepsen_tpu.elle.list_append`; ``check`` takes ``device`` for
the SCC closure (None: the card).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Set, Tuple

from jepsen_tpu_torch import elle
from jepsen_tpu_torch.elle import Graph, RW, WR, WW, txn as txn_mod

DEFAULT_ANOMALIES = ["G1", "G2"]

#: anomaly aliases -> concrete anomalies (wr.clj:47-48: G2 implies
#: G-single and G1c; G1 implies G1a, G1b, G1c; G1c implies G0)
_EXPANSION = {
    "G1": {"G1a", "G1b", "G1c", "G0"},
    "G1c": {"G1c", "G0"},
    "G2": {"G2", "G-single", "G1c", "G0"},
    "G-single": {"G-single", "G1c", "G0"},
}


def expand_anomalies(names) -> Set[str]:
    out: Set[str] = set()
    for n in names:
        n = str(n).lstrip(":")
        out |= _EXPANSION.get(n, {n})
    return out | {"internal", "incompatible-order", "dirty-update"}


# ----------------------------------------------------------- single-txn


def internal_cases(oks: List[dict]) -> List[dict]:
    """Reads inconsistent with the txn's own prior reads/appends
    (elle `internal`). Expected list state per key is tracked through the
    txn; a read must equal expectation when known, or end with the txn's
    own prior appends when the prefix is unknown."""
    bad = []
    for o in oks:
        # key -> (known_prefix_or_None, [own appends since])
        state: Dict = {}
        for f, k, v in o.get("value") or []:
            if f == "append":
                known, own = state.get(k, (None, []))
                state[k] = (known, own + [v])
            else:  # read
                got = list(v) if v is not None else []
                if k in state:
                    known, own = state[k]
                    if known is not None:
                        expected = known + own
                        if got != expected:
                            bad.append({"op": dict(o), "mop": [f, k, v],
                                        "expected": expected})
                            continue
                    elif own and got[-len(own):] != own:
                        bad.append({"op": dict(o), "mop": [f, k, v],
                                    "expected": ["...", *own]})
                        continue
                state[k] = (got, [])
    return bad


# -------------------------------------------------------- version orders


class IncompatibleOrder(Exception):
    def __init__(self, key, readings):
        super().__init__(f"incompatible reads of key {key}")
        self.case = {"key": key, "values": readings}


def _key_orders(oks: List[dict]) -> Tuple[Dict, List[dict]]:
    """key -> append order [v1 v2 ...], from reads (longest read wins;
    all reads must be prefixes of it) extended with appends whose position
    is known: the longest-read order, then any appends by the reading txns
    immediately after their observed prefix. Returns (orders, error-cases)."""
    longest: Dict = {}
    reads_by_key: Dict[int, List[list]] = {}
    for o in oks:
        for f, k, v in o.get("value") or []:
            if f == "r" and v is not None:
                got = list(v)
                reads_by_key.setdefault(k, []).append(got)
                if len(got) > len(longest.get(k, [])):
                    longest[k] = got
    errors = []
    orders: Dict = {}
    for k, lead in longest.items():
        ok = True
        for r in reads_by_key[k]:
            if lead[:len(r)] != r:
                errors.append({"key": k, "values": [lead, r]})
                ok = False
                break
        if ok:
            orders[k] = lead
    return orders, errors


# ------------------------------------------------------- graph building


def graph(oks: List[dict]) -> Tuple[Graph, Dict, Dict, List[dict]]:
    """Build the ww/wr/rw dependency graph. Returns
    (graph, appender-map key->v->txn-id, orders, incompatible-order cases)."""
    g = Graph()
    for o in oks:
        g.add_node(o["_id"])
    appender: Dict[int, Dict] = {}
    for o in oks:
        for f, k, v in o.get("value") or []:
            if f == "append":
                appender.setdefault(k, {})[v] = o["_id"]
    orders, incompat = _key_orders(oks)

    for k, order in orders.items():
        writer = appender.get(k, {})
        # ww: consecutive appends in the version order
        for v1, v2 in zip(order, order[1:]):
            a, b = writer.get(v1), writer.get(v2)
            if a is not None and b is not None:
                g.add(a, b, WW)
    # wr + rw per read. The observed list is a prefix of the key's final
    # append order, so every committed append NOT in the observed list
    # happened after the read: reader --rw--> its appender. This covers
    # appends whose exact position is unknown (e.g. two txns that both
    # read [] and appended — mutual rw, no later read needed).
    for o in oks:
        for f, k, rv in o.get("value") or []:
            if f != "r" or rv is None:
                continue
            got = list(rv)
            if got:
                w = appender.get(k, {}).get(got[-1])
                if w is not None and w != o["_id"]:
                    g.add(w, o["_id"], WR)
            got_set = set(got)
            for v, w2 in appender.get(k, {}).items():
                if v not in got_set and w2 != o["_id"]:
                    g.add(o["_id"], w2, RW)
    return g, appender, orders, incompat


# ---------------------------------------------------------------- check


def check(opts: Optional[Dict], history, device=None) -> Dict:
    """elle.list-append/check equivalent. opts: anomalies (default
    [G1 G2]), additional-graphs ("realtime"/"process")."""
    o = opts or {}
    wanted = expand_anomalies(o.get("anomalies", DEFAULT_ANOMALIES))
    oks = txn_mod.ok_txns(history)
    by_id = {t["_id"]: t for t in oks}
    anomalies: Dict[str, list] = {}

    if "internal" in wanted:
        cases = internal_cases(oks)
        if cases:
            anomalies["internal"] = cases

    failed = txn_mod.failed_writes(history, "append")
    inter = txn_mod.intermediate_writes(oks, "append")
    for t in oks:
        for f, k, v in t.get("value") or []:
            if f != "r" or v is None:
                continue
            for x in v:
                if "G1a" in wanted and x in failed.get(k, ()):
                    anomalies.setdefault("G1a", []).append(
                        {"op": dict(t), "mop": [f, k, list(v)], "value": x})
                src = inter.get(k, {}).get(x)
                # an intermediate read shows a txn's non-final append of k
                # as the *last* element — the final append is missing
                if ("G1b" in wanted and src is not None
                        and src["_id"] != t["_id"] and list(v)[-1] == x):
                    anomalies.setdefault("G1b", []).append(
                        {"op": dict(t), "mop": [f, k, list(v)], "value": x})

    g, _appender, _orders, incompat = graph(oks)
    if incompat:
        anomalies["incompatible-order"] = incompat

    extra = o.get("additional-graphs") or []
    if "realtime" in extra:
        g.merge(elle.realtime_graph(oks))
    if "process" in extra:
        g.merge(elle.process_graph(oks))

    cyc = elle.cycle_anomalies(g, by_id=by_id, device=device)
    for name, cases in cyc.items():
        if name in wanted:
            anomalies[name] = cases

    return {
        "valid?": not anomalies,
        "anomaly-types": sorted(anomalies),
        "anomalies": anomalies,
    }


def gen(opts: Optional[Dict] = None,
        rand: Optional[random.Random] = None):
    """Generator of append/read txns (tests/cycle/append.clj:24-27)."""
    return txn_mod.txn_generator(opts, "append", rand)
