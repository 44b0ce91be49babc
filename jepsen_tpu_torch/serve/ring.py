"""Replica scale-out for the streaming checker: a consistent-hash ring
over serve replicas, and key migration built from the service's own
primitives — ``CheckpointStore`` freeze/thaw as the frontier handoff
and WAL **segment transfer** as the durable-op handoff.

A port of `jepsen_tpu.serve.ring`. The
fleet is shared-nothing: each replica is one ``CheckerService`` (own
WAL dir, own card, own ops endpoint), and :class:`HashRing` assigns
every key an owner by hashing its EDN text onto a vnode ring — the
reference's ``sha1(edn.dumps(key))``, so both packages route a key to
the same replica. Adding or removing a replica moves only the keys in
the changed arcs.

Migration is recovery, deliberately. A key is re-homed by copying its
WAL segments (``DeltaWAL.segments``) and its frozen checkpoint pair
into the new owner's WAL dir, then calling
:meth:`CheckerService.adopt_keys` — the same deterministic replay a
restart runs, so a migrated key's verdict equals an unmigrated one-shot
check. Two flavours share the code path:

* **crash re-home** (:func:`rehome_dead_replica`): the dead replica
  flushes nothing — survivors take whatever its WAL fsynced (exactly
  the acknowledged deltas) plus any checkpoint eviction froze;
* **graceful drain** (:meth:`Router.migrate_key`): the source freezes
  the key's live frontier first, so the new owner thaws instead of
  re-scanning.

Both FENCE the old owner (``DeltaWAL.write_fence`` before the transfer,
the epoch bumped by ``adopt_keys``), so a paused-not-dead replica that
resurfaces is refused instead of becoming a second writer, and both PIN
the moved keys to their adopter in the routing layer. When the dead
node's disk is gone, ``rehome_dead_replica`` reads the survivors'
``repl/`` segment mirrors instead (``serve.fleet.SegmentReplicator``).

Import-safe: no torch — routing and file transfer run from a
coordinator that never touches a device.
"""

from __future__ import annotations

import bisect
import hashlib
import logging
import os
import shutil
from typing import Dict, List, Optional

from jepsen_tpu_torch import edn, obs
from jepsen_tpu_torch.serve.wal import DeltaWAL, WALError, _safe_name

_log = logging.getLogger(__name__)

DEFAULT_VNODES = 64

#: where replicated WAL segments land under a successor's WAL dir
#: (``serve.fleet.SegmentReplicator``) — the rehome source when the
#: dead replica's own disk is gone
REPL_SUBDIR = "repl"


def _point(s: str) -> int:
    return int.from_bytes(hashlib.sha1(s.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hashing over replica names: each node owns ``vnodes``
    points on a 64-bit ring; a key belongs to the first point clockwise
    of its own hash. Deterministic across processes (sha1 of strings),
    so a router, a survivor and a test compute the same owner."""

    def __init__(self, nodes: Optional[List[str]] = None,
                 vnodes: int = DEFAULT_VNODES):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._points: List[int] = []
        self._owners: Dict[int, str] = {}
        self._nodes: set = set()
        for n in nodes or ():
            self.add(n)

    @property
    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self.vnodes):
            p = _point(f"{node}#{i}")
            if p in self._owners:
                # a 64-bit collision between two nodes' vnodes: the
                # earlier owner keeps the arc
                continue
            bisect.insort(self._points, p)
            self._owners[p] = node

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._points = [p for p in self._points if self._owners[p] != node]
        self._owners = {p: o for p, o in self._owners.items() if o != node}

    def owner(self, key) -> str:
        """The replica that owns ``key`` (hashed by its EDN text, the
        identity the WAL files use)."""
        if not self._points:
            raise ValueError("ring has no nodes")
        p = _point(edn.dumps(key))
        i = bisect.bisect_right(self._points, p)
        if i == len(self._points):
            i = 0
        return self._owners[self._points[i]]

    def successor(self, key) -> Optional[str]:
        """The first DISTINCT node clockwise after the key's owner — the
        WAL-segment replication target. None on a ring of fewer than two
        nodes."""
        if len(self._nodes) < 2:
            return None
        p = _point(edn.dumps(key))
        i = bisect.bisect_right(self._points, p)
        owner = None
        for k in range(len(self._points)):
            node = self._owners[self._points[(i + k) % len(self._points)]]
            if owner is None:
                owner = node
            elif node != owner:
                return node
        return None

    def assignments(self, keys) -> Dict[str, list]:
        """node -> [key, ...] for a key set (the rebalance plan)."""
        out: Dict[str, list] = {}
        for k in keys:
            out.setdefault(self.owner(k), []).append(k)
        return out


# ------------------------------------------------------ file handoff


def transfer_key(src_wal_dir: str, dst_wal_dir: str, key) -> dict:
    """Copy one key's durable state — its WAL segments and its frozen
    checkpoint files — from a (dead or draining) replica's WAL dir into
    the new owner's, under the names ``adopt_keys``'s recovery scan
    reads. The source is never mutated. The checkpoint side is the
    reference's three files (``.json``, ``.npz``, ``.programs.json``):
    the port writes no ``.programs.json``, but one a reference replica
    wrote travels unchanged. Returns ``{"segments": n, "checkpoint":
    bool, "manifest": bool}``. The copied segments carry the delta ids
    the old owner stamped, so the adopter's thaw and apply spans re-tag
    the same ids: a migrated delta's chain reads across replicas."""
    os.makedirs(dst_wal_dir, exist_ok=True)
    with obs.span("serve.ring.transfer", key=str(key)):
        segs = DeltaWAL(src_wal_dir).segments(key)
        for path in segs:
            shutil.copy2(path, os.path.join(dst_wal_dir,
                                            os.path.basename(path)))
        stem = _safe_name(key)
        has_cp = False
        has_manifest = False
        src_cps = os.path.join(src_wal_dir, "checkpoints")
        for ext in (".json", ".npz", ".programs.json"):
            p = os.path.join(src_cps, stem + ext)
            if os.path.exists(p):
                dst_cps = os.path.join(dst_wal_dir, "checkpoints")
                os.makedirs(dst_cps, exist_ok=True)
                shutil.copy2(p, os.path.join(dst_cps, stem + ext))
                if ext == ".programs.json":
                    has_manifest = True
                else:
                    has_cp = True
    obs.counter("serve.ring.keys_transferred").inc()
    return {"segments": len(segs), "checkpoint": has_cp,
            "manifest": has_manifest}


def _key_sources(dead_wal_dir: str,
                 wal_dirs: Dict[str, str]) -> Dict[object, str]:
    """key -> the dir to transfer it from: the dead replica's own WAL
    dir when it is still readable (it holds everything acknowledged);
    otherwise every survivor's ``repl/`` mirror, preferring the copy
    with the most bytes when a key is in several."""
    out: Dict[object, str] = {}
    if os.path.isdir(dead_wal_dir):
        try:
            for key in DeltaWAL(dead_wal_dir).keys():
                out[key] = dead_wal_dir
        except (OSError, WALError) as err:
            _log.warning("rehome: dead WAL dir %s unreadable (%r) — "
                         "falling back to replicated segments",
                         dead_wal_dir, err)
            out.clear()
    if out:
        return out
    # the mirrors hold EVERY replica's shipped keys: a key a survivor
    # holds in its OWN WAL dir is live there and must not be "rehomed"
    # (the transfer would overwrite live segments with a possibly
    # lagging mirror copy)
    held_live: set = set()
    for d in wal_dirs.values():
        if os.path.isdir(d):
            try:
                held_live.update(DeltaWAL(d).keys())
            except (OSError, WALError):
                pass   # an unreadable survivor claims nothing
    best_bytes: Dict[object, int] = {}
    for d in wal_dirs.values():
        rd = os.path.join(d, REPL_SUBDIR)
        if not os.path.isdir(rd):
            continue
        rwal = DeltaWAL(rd)
        for key in rwal.keys():
            if key in held_live:
                continue
            n = rwal.size_bytes(key)
            if key not in out or n > best_bytes[key]:
                out[key] = rd
                best_bytes[key] = n
    if out:
        obs.counter("serve.ring.rehomes_from_replica").inc()
    return out


def rehome_dead_replica(dead_wal_dir: str, ring: HashRing, dead_node: str,
                        wal_dirs: Dict[str, str],
                        services: Optional[Dict[str, object]] = None) \
        -> Dict[str, list]:
    """Re-home every key a dead replica's WAL holds onto the survivors:
    drop the node from the ring, FENCE each key in the dead replica's
    WAL dir, transfer each key's segments and checkpoint to its new
    owner's WAL dir, and (with the survivor services in hand)
    ``adopt_keys`` so they go live now. Returns the new node -> [key,
    ...] assignment.

    The WAL holds everything the dead replica acknowledged
    (WAL-before-ack), so the survivors' replay reaches exactly the
    acknowledged stream; re-submitted in-flight deltas dedupe by seq.
    With the dead node's disk gone, the survivors' ``repl/`` mirrors
    are the source: with ``sync`` replication still exactly the
    acknowledged stream, with ``async`` trailing by the replication lag.

    The fence comes FIRST: it lands in the dead dir before any segment
    is copied, so a paused replica that wakes mid-rehome re-checks the
    fence after its fsync and refuses — it never acknowledges a delta
    the transfer missed."""
    ring.remove(dead_node)
    sources = _key_sources(dead_wal_dir, wal_dirs)
    plan = ring.assignments(sources)
    # fence only where a stale writer could still live: a missing dead
    # dir (the disk went with the node) has nobody left to fence
    can_fence = os.path.isdir(dead_wal_dir)
    for node, node_keys in plan.items():
        dst = wal_dirs[node]
        for key in node_keys:
            src = sources[key]
            if can_fence:
                try:
                    new_epoch = DeltaWAL(src).epoch(key) + 1
                    DeltaWAL(dead_wal_dir).write_fence(key, new_epoch,
                                                       owner=node)
                except OSError as err:
                    _log.warning("rehome: could not fence key %r in %s "
                                 "(%r)", key, dead_wal_dir, err)
            transfer_key(src, dst, key)
        _log.info("rehome: %d key(s) from dead %r -> %r", len(node_keys),
                  dead_node, node)
    if services:
        for node in plan:
            svc = services.get(node)
            if svc is not None:
                svc.adopt_keys()
    obs.counter("serve.ring.rehomes").inc()
    return plan


# ------------------------------------------------------------ router


class Router:
    """A thin fleet front for in-process replica sets: submit, result
    and finalize forward to the owning replica, ``rehome`` replays a
    crash, ``migrate_key`` is the graceful freeze-first move. A network
    deployment routes in the client with the same :class:`HashRing`."""

    def __init__(self, services: Dict[str, object],
                 wal_dirs: Dict[str, str]):
        if set(services) != set(wal_dirs):
            raise ValueError("services and wal_dirs must name the same "
                             "replicas")
        self.services = dict(services)
        self.wal_dirs = dict(wal_dirs)
        self.ring = HashRing(sorted(services))
        # key -> node overrides: a rehomed or migrated key stays with its
        # adopter even if the arcs later say otherwise (a rejoining node
        # gets NEW keys, never the ones it lost)
        self.pins: Dict[object, str] = {}

    def owner(self, key) -> str:
        pinned = self.pins.get(key)
        if pinned is not None and pinned in self.services:
            return pinned
        return self.ring.owner(key)

    def submit(self, key, ops, **kw):
        return self.services[self.owner(key)].submit(key, ops, **kw)

    def result(self, key, **kw):
        return self.services[self.owner(key)].result(key, **kw)

    def finalize(self, key, **kw):
        return self.services[self.owner(key)].finalize(key, **kw)

    def rehome(self, dead_node: str) -> Dict[str, list]:
        """Crash path: the node is gone (already killed or closed);
        survivors adopt its WAL, and the adopted keys PIN to their
        adopter."""
        dead_dir = self.wal_dirs.pop(dead_node)
        self.services.pop(dead_node, None)
        plan = rehome_dead_replica(dead_dir, self.ring, dead_node,
                                   self.wal_dirs, self.services)
        for node, node_keys in plan.items():
            for key in node_keys:
                self.pins[key] = node
        return plan

    def migrate_key(self, key, dst_node: str) -> dict:
        """Graceful path: drain the key's current owner, freeze its live
        frontier, transfer, adopt on the destination, fence and pin. The
        ring does not change: this is an operator move."""
        src_node = self.owner(key)
        if src_node == dst_node:
            return {"noop": True, "node": src_node}
        src = self.services[src_node]
        src.drain(timeout=60)
        src.freeze_key(key)
        r = transfer_key(self.wal_dirs[src_node], self.wal_dirs[dst_node],
                         key)
        self.services[dst_node].adopt_keys()
        src.fence_key_ownership(key, owner=dst_node)
        self.pins[key] = dst_node
        r["from"], r["to"] = src_node, dst_node
        return r
