"""Transactional-anomaly cycle checker — the elle 0.1.2 capability
(reference call surface: jepsen/src/jepsen/tests/cycle.clj,
tests/cycle/append.clj, tests/cycle/wr.clj; anomaly taxonomy documented
at tests/cycle/wr.clj:31-45).

Transactions become nodes in a dependency graph with typed edges:

  ww  write-write   T1's write of version v precedes T2's write of v'
  wr  write-read    T2 read the version T1 wrote
  rw  anti-dep      T1 read a version that T2 overwrote
  rt  realtime      T1 completed before T2 was invoked
  p   process       T1 preceded T2 on the same process

Anomalies are cycles in restricted subgraphs (Adya's taxonomy):

  G0        cycle of only ww edges
  G1c       cycle of ww+wr edges (at least one wr)
  G-single  cycle with exactly one rw edge
  G2        cycle with one or more rw edges

A port of `jepsen_tpu.elle`. Strongly connected components are found
two ways, at the reference's threshold: an iterative Tarjan on the host
for graphs under 1,024 nodes, and on the device past it — boolean
transitive closure by repeated squaring of the adjacency matrix
(``torch.mm`` on bf16 operands with an fp32 result on the card, fp32 on
the CPU; SCC = R & R.T). The host parts are copies: the cycle a BFS
finds, and so the ``cycle`` and ``steps`` of every anomaly, depend on
the graph's dict insertion order, which they keep.

Entry points that can reach the device route (``sccs``,
``cycle_anomalies``, ``check``) take ``device``: None means the card
(RuntimeError without one), ``"cpu"`` the plain run on the CPU. A graph
under the threshold never touches the device.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

# Edge types, in explanation-priority order.
WW, WR, RW, RT, PROC = "ww", "wr", "rw", "rt", "process"

# The reference's threshold (jepsen_tpu/elle/__init__.py:39): a graph of
# at least this many nodes takes the device route.
_DEVICE_SCC_MIN_NODES = 1024

#: closures run by ``scc_labels`` (the device route), on the card or,
#: where the caller asked for it, the CPU
launches = {"closure": 0}


class Graph:
    """Directed multigraph over txn ids with typed edges."""

    def __init__(self):
        # a -> b -> set of edge types
        self.out: Dict[int, Dict[int, Set[str]]] = {}

    def add(self, a: int, b: int, typ: str) -> None:
        if a == b:
            return
        self.out.setdefault(a, {}).setdefault(b, set()).add(typ)
        self.out.setdefault(b, {})

    def add_node(self, a: int) -> None:
        self.out.setdefault(a, {})

    def nodes(self) -> List[int]:
        return list(self.out)

    def edge_types(self, a: int, b: int) -> Set[str]:
        return self.out.get(a, {}).get(b, set())

    def merge(self, other: "Graph") -> "Graph":
        for a, bs in other.out.items():
            self.add_node(a)
            for b, ts in bs.items():
                for t in ts:
                    self.add(a, b, t)
        return self

    def restrict(self, types: Set[str], nodes: Optional[Set[int]] = None) -> "Graph":
        g = Graph()
        for a, bs in self.out.items():
            if nodes is not None and a not in nodes:
                continue
            g.add_node(a)
            for b, ts in bs.items():
                if nodes is not None and b not in nodes:
                    continue
                keep = ts & types
                for t in keep:
                    g.add(a, b, t)
        return g

    def __len__(self):
        return len(self.out)


# ------------------------------------------------------------------- SCC


def tarjan_sccs(g: Graph) -> List[List[int]]:
    """Iterative Tarjan; returns SCCs with >1 node (self-loops excluded
    by construction — Graph.add drops a==b)."""
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on_stack: Set[int] = set()
    stack: List[int] = []
    sccs: List[List[int]] = []
    counter = [0]

    for root in g.nodes():
        if root in index:
            continue
        work: List[Tuple[int, int]] = [(root, 0)]
        while work:
            v, pi = work.pop()
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack.add(v)
            recurse = False
            succs = list(g.out.get(v, {}))
            for i in range(pi, len(succs)):
                w = succs[i]
                if w not in index:
                    work.append((v, i + 1))
                    work.append((w, 0))
                    recurse = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(comp)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return sccs


def closure_steps(n: int) -> int:
    """The squarings that close an n-node graph: ceil(log2 n), at least
    one (paths of up to 2^steps >= n edges)."""
    return max(1, math.ceil(math.log2(max(2, n))))


def scc_labels(src, dst, n: int, device) -> "torch.Tensor":
    """label[i] = the smallest j in i's strongly connected component, for
    the graph on nodes 0..n-1 with edges src[e] -> dst[e] (int64 tensors
    on ``device``). R := A | I, squared ``closure_steps(n)`` times — on
    the card a bf16 product with an fp32 result, on the CPU an fp32 one
    (exact for 0/1 entries), clamped to 1 after each squaring — then
    S = R & R.T, whose row i is i's component; R's diagonal makes the
    first set column of row i the label. At most R and one product are
    n x n at once (6 n^2 bytes on the card, 8 n^2 on the CPU); S goes in
    blocks of rows."""
    import torch
    cuda = device.type == "cuda"
    dt = torch.bfloat16 if cuda else torch.float32
    r = torch.eye(n, dtype=dt, device=device)
    r.index_put_((src, dst), torch.ones((), dtype=dt, device=device))
    for _ in range(closure_steps(n)):
        if cuda:
            rr = torch.mm(r, r, out_dtype=torch.float32)
        else:
            rr = torch.mm(r, r)
        del r
        r = rr.clamp_(max=1.0).to(dt)
        del rr
    launches["closure"] += 1
    labels = torch.empty(n, dtype=torch.int64, device=device)
    blk = max(1, min(n, (1 << 26) // n))
    for i in range(0, n, blk):
        s = (r[i:i + blk] > 0) & (r[:, i:i + blk].T > 0)
        labels[i:i + blk] = s.to(torch.uint8).argmax(dim=1)
    return labels


def edge_index(g: Graph) -> Tuple[List[int], List[int], List[int]]:
    """(ids, src, dst): the graph's nodes in sorted order, and each edge
    as positions in it, in the graph's insertion order."""
    ids = sorted(g.nodes())
    pos = {v: i for i, v in enumerate(ids)}
    src = [pos[u] for u, bs in g.out.items() for _ in bs]
    dst = [pos[v] for bs in g.out.values() for v in bs]
    return ids, src, dst


def device_sccs(g: Graph, device=None) -> List[List[int]]:
    """SCCs by transitive closure on the device (``scc_labels``), in the
    reference's order: components by their smallest node in sorted
    order, members sorted, singletons dropped. The adjacency is built on
    the device from the edges' index tensors. ``device`` None means the
    card; there is no fallback to Tarjan."""
    import torch

    from jepsen_tpu_torch.parallel.bitdense import resolve_device
    ids, src, dst = edge_index(g)
    n = len(ids)
    if n == 0:
        return []
    dev = resolve_device(device)
    labels = scc_labels(torch.tensor(src, dtype=torch.int64, device=dev),
                        torch.tensor(dst, dtype=torch.int64, device=dev),
                        n, dev)
    comps: Dict[int, List[int]] = {}
    for i, lab in enumerate(labels.tolist()):
        comps.setdefault(lab, []).append(ids[i])
    return [comps[lab] for lab in sorted(comps) if len(comps[lab]) > 1]


def sccs(g: Graph, device=None) -> List[List[int]]:
    if len(g) >= _DEVICE_SCC_MIN_NODES:
        return device_sccs(g, device)
    return tarjan_sccs(g)


# --------------------------------------------------------------- cycles


def _bfs_path(g: Graph, src: int, dst: int,
              types: Optional[Set[str]] = None) -> Optional[List[int]]:
    """Shortest path src..dst (inclusive) using only edges of `types`
    (None = any). src == dst finds the shortest cycle through src."""
    parent: Dict[int, int] = {}
    q = deque([src])
    seen = {src} if src != dst else set()
    while q:
        v = q.popleft()
        for w, ts in g.out.get(v, {}).items():
            if types is not None and not (ts & types):
                continue
            if w == dst:
                path = [w, v]
                while path[-1] != src:
                    path.append(parent[path[-1]])
                path.reverse()
                return path
            if w not in seen:
                seen.add(w)
                parent[w] = v
                q.append(w)
    return None


def find_cycle(g: Graph, scc: Sequence[int],
               types: Optional[Set[str]] = None) -> Optional[List[int]]:
    """A cycle [v0, v1, ..., v0] inside scc using only `types` edges."""
    members = set(scc)
    sub = g.restrict(types if types is not None else {WW, WR, RW, RT, PROC},
                     members)
    for v in scc:
        p = _bfs_path(sub, v, v)
        if p:
            return p
    return None


def find_cycle_with_one(g: Graph, scc: Sequence[int], one: str,
                        rest: Set[str]) -> Optional[List[int]]:
    """A cycle containing exactly one edge of type `one`, all others drawn
    from `rest` — the G-single search (one rw edge, back via ww/wr)."""
    members = set(scc)
    sub_rest = g.restrict(rest, members)
    for a in scc:
        for b, ts in g.out.get(a, {}).items():
            if b not in members or one not in ts:
                continue
            back = _bfs_path(sub_rest, b, a)
            if back is not None:
                return [a] + back
    return None


# ---------------------------------------------------------- explanation


def explain_cycle(cycle: List[int], g: Graph,
                  explainer: Callable[[int, int, Set[str]], str]) -> List[str]:
    out = []
    for a, b in zip(cycle, cycle[1:]):
        out.append(explainer(a, b, g.edge_types(a, b)))
    return out


def _default_explainer(by_id: Dict[int, dict]) -> Callable:
    def show(i: int) -> dict:
        return {k: v for k, v in by_id.get(i, {}).items()
                if not str(k).startswith("_")}

    def explain(a: int, b: int, types: Set[str]) -> str:
        t = next((x for x in (WW, WR, RW, RT, PROC) if x in types), "?")
        return f"T{a} {show(a)} --[{t}]--> T{b} {show(b)}"
    return explain


# --------------------------------------------------------------- check


#: anomaly -> (edge types allowed, required type, "exactly-one" type)
_CYCLE_SPECS = [
    ("G0", {WW, RT, PROC}, None, None),
    ("G1c", {WW, WR, RT, PROC}, WR, None),
    ("G-single", {WW, WR, RT, PROC}, None, RW),
    ("G2", {WW, WR, RW, RT, PROC}, RW, None),
]


def cycle_anomalies(g: Graph, explainer: Optional[Callable] = None,
                    by_id: Optional[Dict[int, dict]] = None,
                    device=None) -> Dict[str, list]:
    """Classify every SCC into the most severe anomaly classes it exhibits.
    Returns anomaly-name -> list of {"cycle": [...ids...], "steps": [...]}."""
    if explainer is None:
        explainer = _default_explainer(by_id or {})
    found: Dict[str, list] = {}
    for comp in sccs(g, device):
        for name, types, required, exactly_one in _CYCLE_SPECS:
            if exactly_one is not None:
                cyc = find_cycle_with_one(g, comp, exactly_one,
                                          types - {exactly_one})
            else:
                cyc = find_cycle(g, comp, types)
                if cyc is not None and required is not None:
                    if not any(required in g.edge_types(a, b)
                               for a, b in zip(cyc, cyc[1:])):
                        cyc = None
            if cyc is not None:
                found.setdefault(name, []).append({
                    "cycle": cyc,
                    "steps": explain_cycle(cyc, g, explainer),
                })
                break  # most severe classification for this SCC wins
    return found


def check(analyzer: Callable, history, device=None) -> Dict:
    """elle.core/check equivalent (tests/cycle.clj:9-16): `analyzer` maps a
    history to (graph, explainer, by_id); cycles become anomalies."""
    g, explainer, by_id = analyzer(history)
    anomalies = cycle_anomalies(g, explainer, by_id, device)
    return {
        "valid?": not anomalies,
        "anomaly-types": sorted(anomalies),
        "anomalies": anomalies,
    }


# ------------------------------------------------- generic graph builders


def realtime_graph(oks: List[dict]) -> Graph:
    """rt edges: T1's completion precedes T2's invocation. Uses the
    reduced form: edge only from each txn to the txns invoked after it and
    before any later completion (transitively implied edges dropped)."""
    import bisect

    g = Graph()
    for t in oks:
        g.add_node(t["_id"])
    # oks carry "_invoke_index"/"_complete_index"/"_id" annotations.
    starts = sorted(oks, key=lambda o: o["_invoke_index"])
    invs = [t["_invoke_index"] for t in starts]
    # suffix_min[i] = min complete index among starts[i:]
    suffix_min = [0] * (len(starts) + 1)
    suffix_min[len(starts)] = float("inf")
    for i in range(len(starts) - 1, -1, -1):
        suffix_min[i] = min(starts[i]["_complete_index"], suffix_min[i + 1])
    for t1 in oks:
        i = bisect.bisect_right(invs, t1["_complete_index"])
        if i >= len(starts):
            continue
        horizon = suffix_min[i]
        for j in range(i, len(starts)):
            if invs[j] > horizon:
                break
            g.add(t1["_id"], starts[j]["_id"], RT)
    return g


def process_graph(oks: List[dict]) -> Graph:
    g = Graph()
    by_proc: Dict = {}
    for o in sorted(oks, key=lambda o: o["_invoke_index"]):
        by_proc.setdefault(o.get("process"), []).append(o)
    for chain in by_proc.values():
        for t1, t2 in zip(chain, chain[1:]):
            g.add(t1["_id"], t2["_id"], PROC)
    return g
