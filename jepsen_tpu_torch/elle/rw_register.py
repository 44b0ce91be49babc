"""Write/read register transactional checker (elle.rw-register capability;
call surface jepsen/src/jepsen/tests/cycle/wr.clj:9-54, anomaly taxonomy
documented there).

Writes are unique per key, so write-read dependencies are exact: reading
value v identifies the (unique) transaction that wrote it. Version orders
— needed for ww and rw edges — are only partially observable and are
inferred per the reference's option set (wr.clj:17-29):

  sequential-keys    each process's txn order gives per-key write order
  linearizable-keys  realtime order of non-overlapping writing txns
  wfr-keys           writes follow reads within a transaction

Default anomalies: [G2 G1a G1b internal] (wr.clj:49-50), which — via the
implication lattice — catches everything.

A port of `jepsen_tpu.elle.rw_register`; ``check`` takes ``device`` for
the SCC closure (None: the card).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from jepsen_tpu_torch import elle
from jepsen_tpu_torch.elle import Graph, RW, WR, WW, txn as txn_mod
from jepsen_tpu_torch.elle.list_append import expand_anomalies

DEFAULT_ANOMALIES = ["G2", "G1a", "G1b", "internal"]


def internal_cases(oks: List[dict]) -> List[dict]:
    """A txn's read disagrees with its own prior write or read of the key
    (wr.clj:44-45)."""
    bad = []
    for o in oks:
        state: Dict = {}
        for f, k, v in o.get("value") or []:
            if f == "w":
                state[k] = v
            else:
                if k in state and state[k] != v:
                    bad.append({"op": dict(o), "mop": [f, k, v],
                                "expected": state[k]})
                state[k] = v
    return bad


def _version_graph(oks: List[dict], opts: Dict) -> Dict[int, Graph]:
    """key -> directed graph over written values (+ None as the initial
    version), one edge per inferred version-order constraint."""
    vgs: Dict[int, Graph] = {}

    def vg(k) -> Graph:
        if k not in vgs:
            vgs[k] = Graph()
        return vgs[k]

    # within-txn write order: w k=v1 ... w k=v2 means v1 precedes v2
    for o in oks:
        last: Dict = {}
        for f, k, v in o.get("value") or []:
            if f == "w":
                if k in last:
                    vg(k).add(last[k], v, "v")
                last[k] = v

    if opts.get("wfr-keys"):
        for o in oks:
            reads: Dict = {}
            for f, k, v in o.get("value") or []:
                if f == "r":
                    reads.setdefault(k, v)
                elif f == "w" and k in reads and reads[k] != v:
                    vg(k).add(reads[k], v, "v")

    if opts.get("sequential-keys"):
        by_proc: Dict = {}
        for o in sorted(oks, key=lambda o: o["_invoke_index"]):
            by_proc.setdefault(o.get("process"), []).append(o)
        for chain in by_proc.values():
            last: Dict = {}
            for o in chain:
                for f, k, v in o.get("value") or []:
                    if f != "w":
                        continue
                    if k in last and last[k] != v:
                        vg(k).add(last[k], v, "v")
                    last[k] = v

    if opts.get("linearizable-keys"):
        writes: Dict[int, List[Tuple[int, int, object]]] = {}
        for o in oks:
            for f, k, v in o.get("value") or []:
                if f == "w":
                    writes.setdefault(k, []).append(
                        (o["_invoke_index"], o["_complete_index"], v))
        for k, ws in writes.items():
            for inv1, comp1, v1 in ws:
                for inv2, _comp2, v2 in ws:
                    if comp1 < inv2 and v1 != v2:
                        vg(k).add(v1, v2, "v")
    return vgs


def graph(oks: List[dict], opts: Optional[Dict] = None) -> Tuple[Graph, Dict]:
    """Dependency graph over txns: exact wr edges plus ww/rw edges from
    the inferred per-key version graphs. Returns (graph, writer-map)."""
    o = opts or {}
    g = Graph()
    writer: Dict[int, Dict] = {}
    for t in oks:
        g.add_node(t["_id"])
        for f, k, v in t.get("value") or []:
            if f == "w":
                writer.setdefault(k, {})[v] = t["_id"]

    # wr: reading v depends on its unique writer
    for t in oks:
        for f, k, v in t.get("value") or []:
            if f == "r" and v is not None:
                w = writer.get(k, {}).get(v)
                if w is not None and w != t["_id"]:
                    g.add(w, t["_id"], WR)

    # readers index, built once: (k, v) -> [txn ids that read k=v]
    readers: Dict[tuple, List[int]] = {}
    for t in oks:
        for f, k, v in t.get("value") or []:
            if f == "r":
                readers.setdefault((k, v), []).append(t["_id"])

    vgs = _version_graph(oks, o)
    for k, vg in vgs.items():
        wk = writer.get(k, {})
        for v1, succs in vg.out.items():
            a = wk.get(v1)
            for v2 in succs:
                b = wk.get(v2)
                if a is not None and b is not None:
                    g.add(a, b, WW)
                if b is None:
                    continue
                # rw: anyone who read v1 is overwritten by v2's writer
                for rid in readers.get((k, v1), ()):
                    if rid != b:
                        g.add(rid, b, RW)
    return g, writer


def check(opts: Optional[Dict], history, device=None) -> Dict:
    """elle.rw-register/check equivalent (wr.clj:14-54)."""
    o = opts or {}
    wanted = expand_anomalies(o.get("anomalies", DEFAULT_ANOMALIES))
    oks = txn_mod.ok_txns(history)
    by_id = {t["_id"]: t for t in oks}
    anomalies: Dict[str, list] = {}

    if "internal" in wanted:
        cases = internal_cases(oks)
        if cases:
            anomalies["internal"] = cases

    failed = txn_mod.failed_writes(history, "w")
    inter = txn_mod.intermediate_writes(oks, "w")
    for t in oks:
        for f, k, v in t.get("value") or []:
            if f != "r" or v is None:
                continue
            if "G1a" in wanted and v in failed.get(k, ()):
                anomalies.setdefault("G1a", []).append(
                    {"op": dict(t), "mop": [f, k, v]})
            src = inter.get(k, {}).get(v)
            if "G1b" in wanted and src is not None and src["_id"] != t["_id"]:
                anomalies.setdefault("G1b", []).append(
                    {"op": dict(t), "mop": [f, k, v]})

    g, _writer = graph(oks, o)
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
    """Generator of write/read txns (wr.clj:9-12)."""
    return txn_mod.txn_generator(opts, "w", rand)
