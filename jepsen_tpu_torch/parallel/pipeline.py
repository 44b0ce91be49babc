"""Pipelined multi-key checking: the host's encode of the next chunk of
keys overlaps the device's scan of the last one.

A port of `jepsen_tpu.parallel.pipeline`. The serial `check_batch`
encodes every key before its first launch, so the card waits through
the whole encode (on the dense batch the encode is most of the wall).
Here:

  1. **Bucket first.** Stage 1 of the encode (`encode.prepare_encode`:
     the calls packed and their slots assigned) runs for every key; its
     slot and state counts are what the serial path buckets on, so the
     buckets (`engine.bucket_key`) are the serial path's.
  2. **Stream the buckets, a bounded number of chunks in flight.** A
     dense bucket is cut into near-equal chunks; a chunk's stage-2
     encode (`encode.finish_encode`) runs, then the chunk is padded to
     the whole bucket's (S, C, R) and issued
     (`bitdense.dispatch_batch_bitdense`: K1's persistent batched scan,
     which returns before the card has run it), so the next chunk
     encodes while the card scans this one. At most `depth` chunks are
     in flight; the oldest is read (`finalize()`) first. A sparse
     bucket runs whole through `engine._check_batch_sparse`, whose
     capacity retry reads the device as it goes.
  3. **Encode cache.** Encodings are kept in a content-keyed LRU
     (`EncodeCache`), so that checking a stored history again, or a
     checker's second pass, pays no encode. The key is a digest of
     (model, op stream): a history mutated in place gets a new key.
     `store_dir` keeps the entries on disk (pickle: load only a
     directory this package wrote).

Results equal the serial `check_batch`'s, key for key and in order.

Decision: no host thread pool. The encode is Python under the GIL,
and the overlap that matters is the host's encode against the card's
scan, which the asynchronous launch gives on one thread; the smoke
(`chip_smoke.py`, phase "pipeline") times the 84 keys' encode on one
thread and on eight. With `mesh` (a DeviceMesh) every chunk's keys are
sharded over its ranks (`bitdense.dispatch_batch_bitdense(mesh=)`),
dense chunks aligned to the rank count as the reference's are, and
every rank of the mesh calls the executor; with `steal` a dense
bucket's chunks are the rounds of a `elastic.KeyScheduler` that
observes each drained chunk, and a sparse bucket runs through
`elastic.check_batch_stealing`.

Telemetry, the reference's: the `pipeline.run` root span with the
`torch.profiler` capture (`obs.maybe_torch_profile`) around the whole
run; a `pipeline.prepare` and a `pipeline.encode` timer a key, a
`pipeline.dispatch` and a `pipeline.finalize` span a dense chunk and a
`pipeline.sparse` span a sparse bucket, each a child of `pipeline.run`
(the reference's pool threads take its context through `ctx_runner`;
here they run on the submitting thread, outside every chunk's span); a
`device.search` span a chunk on its bucket's `bucket-{tier}` device
track, the chunk's issue-to-read window on the host's clock; the
`pipeline.keys`, `pipeline.chunks` and `pipeline.cache.*` counters, the
`pipeline.inflight` gauge with its counter-track samples, and the
`pipeline.{encode,transfer,device_wait}_secs` histograms, one
observation a bucket.

Not ported: the supervisor's degradation of a failed chunk to the host
(a device fault raises), the decision ledger, and the
JEPSEN_TPU_ENCODE_CACHE size flag (`EncodeCache(max_entries=...)`
sizes a cache, 0 turns it off).
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from time import perf_counter
from typing import Optional

import torch

from jepsen_tpu_torch import models as model_ns
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.parallel import bitdense, engine
from jepsen_tpu_torch.parallel import encode as enc_mod
from jepsen_tpu_torch.parallel import search_stats as st
from jepsen_tpu_torch.parallel import sparse
from jepsen_tpu_torch.parallel.encode import EncodedHistory

_log = logging.getLogger(__name__)

DEFAULT_CACHE_ENTRIES = 256
DEFAULT_CACHE_BYTES = 512 << 20   # the entries' array bytes in memory
DEFAULT_CHUNK_KEYS = 32


# ------------------------------------------------------------ cache key

def encode_cache_key(model, history, pad_slots: Optional[int] = None) -> str:
    """The encode cache's key: a digest of (model, op stream,
    pad_slots) — the model's class and repr, and every op's (process,
    type, f, value) in order (invocations pair with completions by
    position, so the order is content). A history mutated in place gets
    a new key, so a stale hit cannot happen. Op values must have a
    content repr (numbers, strings, lists, tuples, sets, maps), as the
    encoder's intern table already needs."""
    h = hashlib.sha256()
    h.update(repr((type(model).__module__, type(model).__qualname__,
                   model, pad_slots)).encode())
    for o in history:
        h.update(repr((o.get("process"), o.get("type"), o.get("f"),
                       o.get("value"))).encode())
    return h.hexdigest()[:32]


# ---------------------------------------------------------- EncodeCache

_PERSIST_FIELDS = ("slot_f", "slot_a0", "slot_a1", "slot_wild",
                   "slot_occ", "ev_slot", "ret_call", "state0",
                   "step_name", "n_calls", "n_slots", "calls", "intern",
                   "state_lo", "n_states", "model_pruned")
_PERSIST_VERSION = 2


class EncodeCache:
    """A digest-keyed LRU of EncodedHistory, optionally kept on disk.

    Thread-safe. `max_entries` bounds the entries in memory (0 turns the
    cache off) and `max_bytes` their summed array bytes; whichever
    passes its bound first evicts the oldest entry (the newest always
    stays). With `store_dir`, entries are also written there as pickle
    files and read back by a later process; the directory grows until
    its owner prunes it. An entry's prepared spec (history-dependent
    closures of the set and queue models) is not pickled: a load
    rebuilds it from the model and the stored calls, which is faithful
    only where the stored calls are the ones `prepare` saw — so an
    entry whose model-specific prune dropped calls after `prepare`
    (`EncodedHistory.model_pruned`) stays in memory only, and a load
    whose rebuilt spec disagrees with the stored state0 or state count
    is a miss."""

    def __init__(self, max_entries: int = DEFAULT_CACHE_ENTRIES,
                 store_dir: Optional[str] = None,
                 max_bytes: int = DEFAULT_CACHE_BYTES):
        if max_entries < 0:
            raise ValueError(f"max_entries={max_entries} must be >= 0")
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.store_dir = store_dir
        if store_dir is not None:
            os.makedirs(store_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.disk_hits = 0
        self.misses = 0
        self.encodes = 0

    def counters(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "disk_hits": self.disk_hits,
                    "misses": self.misses, "encodes": self.encodes,
                    "entries": len(self._entries), "bytes": self._bytes}

    def note_encode(self):
        """An encode was paid (the miss path)."""
        with self._lock:
            self.encodes += 1

    def get(self, key: str, model=None) -> Optional[EncodedHistory]:
        if self.max_entries == 0:
            with self._lock:
                self.misses += 1
            return None
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                return e
        e = self._load(key, model)
        if e is not None:
            with self._lock:
                self.disk_hits += 1
            self.put(key, e, persist=False)
            return e
        with self._lock:
            self.misses += 1
        return None

    @staticmethod
    def _entry_bytes(e: EncodedHistory) -> int:
        return sum(getattr(e, f).nbytes for f in
                   ("slot_f", "slot_a0", "slot_a1", "slot_wild",
                    "slot_occ", "ev_slot", "ret_call"))

    def put(self, key: str, e: EncodedHistory, persist: bool = True):
        if self.max_entries == 0:
            return
        nb = self._entry_bytes(e)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= self._entry_bytes(old)
            self._entries[key] = e
            self._bytes += nb
            while len(self._entries) > 1 and (
                    len(self._entries) > self.max_entries
                    or self._bytes > self.max_bytes):
                _, ev = self._entries.popitem(last=False)
                self._bytes -= self._entry_bytes(ev)
        if persist and self.store_dir is not None:
            self._save(key, e)

    def _path(self, key: str) -> str:
        return os.path.join(self.store_dir, f"enc_{key}.pkl")

    def _save(self, key: str, e: EncodedHistory):
        if e.model_pruned and e.spec is not None \
                and getattr(e.spec, "prepare", None) is not None:
            return    # a reload could not rebuild this entry's spec
        payload = {"version": _PERSIST_VERSION,
                   "fields": {f: getattr(e, f) for f in _PERSIST_FIELDS}}
        path = self._path(key)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(payload, f)
            os.replace(tmp, path)
        except Exception as err:  # noqa: BLE001 - the disk copy is an
            # optimisation; a value that does not pickle must not fail
            # the check, but it must not pass silently either
            _log.warning("encode cache: could not persist entry %s (%r); "
                         "the in-memory cache has it", key, err)

    def _load(self, key: str, model) -> Optional[EncodedHistory]:
        if self.store_dir is None:
            return None
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                payload = pickle.load(f)
            if payload.get("version") != _PERSIST_VERSION:
                return None
            e = EncodedHistory(spec=None, **payload["fields"])
        except Exception as err:  # noqa: BLE001 - a corrupt entry is a
            # miss, said out loud
            _log.warning("encode cache: unreadable entry %s (%r); a miss",
                         key, err)
            return None
        if model is not None:
            # rebuild the prepared spec from the model and the stored
            # calls; a spec that disagrees with the entry is a miss
            try:
                spec = model_ns.pack_spec(model, e.intern)
                if spec is not None and spec.prepare is not None:
                    spec.prepare(e.calls, e.intern)
                if spec is not None:
                    n = (spec.n_states(e.intern) if spec.n_states
                         else len(e.intern) + 1)
                    if spec.state0 != e.state0 or n != e.n_states:
                        return None
                e.spec = spec
            except Exception:  # noqa: BLE001 - the entry is not this
                # model's: a miss
                return None
        return e


_default_cache = None
_default_cache_lock = threading.Lock()


def default_cache() -> EncodeCache:
    """The process's encode cache, for callers that pass none."""
    global _default_cache
    if _default_cache is None:
        with _default_cache_lock:
            if _default_cache is None:
                _default_cache = EncodeCache()
    return _default_cache


def encode_cached(model, history, cache: Optional[EncodeCache] = None,
                  pad_slots: Optional[int] = None) -> EncodedHistory:
    """`encode` through the cache (None: the process's), for a single
    key: `engine.analysis(encode_cache=...)`."""
    if cache is None:
        cache = default_cache()
    if cache.max_entries == 0:
        # a cache that is off costs nothing: no digest, no lock
        return enc_mod.encode(model, history, pad_slots=pad_slots)
    key = encode_cache_key(model, history, pad_slots)
    e = cache.get(key, model)
    if e is None:
        e = enc_mod.encode(model, history, pad_slots=pad_slots)
        cache.note_encode()
        cache.put(key, e)
    return e


# ------------------------------------------------------- the two stages

@dataclass
class _KeyInfo:
    """A key after stage 1: a cache hit (enc) or a prepared encode
    (prep) waiting for its fill."""

    ckey: Optional[str]
    enc: Optional[EncodedHistory]
    prep: object
    secs: float

    @property
    def n_slots(self) -> int:
        return (self.enc or self.prep).n_slots

    @property
    def n_states(self) -> int:
        return (self.enc or self.prep).n_states

    @property
    def n_returns(self) -> int:
        return (self.enc or self.prep).n_returns


def _lookup_or_prepare(model, h, cache: Optional[EncodeCache],
                       key: Optional[int] = None) -> _KeyInfo:
    # a timer, not a span: the recorded span is the key's prepare secs
    e = prep = ckey = None
    with obs.timer("pipeline.prepare", key=key) as sp:
        if cache is not None:
            ckey = encode_cache_key(model, h)
            e = cache.get(ckey, model)
        if e is not None:
            sp.set(hit=True)
        else:
            prep = enc_mod.prepare_encode(model, h)
    return _KeyInfo(ckey, e, prep, sp.wall)


def _fill(info: _KeyInfo, cache: Optional[EncodeCache],
          key: Optional[int] = None) -> EncodedHistory:
    """The key's encode: its cache hit, or stage 2 of its prepared one
    (then kept in the cache)."""
    if info.enc is None:
        with obs.timer("pipeline.encode", key=key) as sp:
            info.enc = enc_mod.finish_encode(info.prep)
        info.prep = None
        info.secs += sp.wall
        if cache is not None:
            cache.note_encode()
            cache.put(info.ckey, info.enc)
    return info.enc


def _chunks(idxs: list, chunk_keys: int, align: int = 1) -> list:
    """A bucket cut into near-equal chunks of at most ~chunk_keys keys
    (84 keys at 32 give three of 28, not 32, 32 and 20). With a mesh
    (`align` its ranks) every chunk but the last remainder is a multiple
    of `align`, as the reference's are, so that every rank gets its
    share of each."""
    n = len(idxs)
    if align > 1:
        ck = max(align, (max(1, chunk_keys) // align) * align)
        out = [idxs[p:p + ck] for p in range(0, n - n % ck, ck)]
        rem = idxs[n - n % ck:]
        r_aligned = len(rem) - len(rem) % align
        if r_aligned:
            out.append(rem[:r_aligned])
        if len(rem) % align:
            out.append(rem[r_aligned:])
        return out
    k = max(1, -(-n // max(1, chunk_keys)))
    base, rem = divmod(n, k)
    out = []
    pos = 0
    for j in range(k):
        size = base + (1 if j < rem else 0)
        out.append(idxs[pos:pos + size])
        pos += size
    return out


def _bucket_chunks(idxs: list, chunk_keys: int, align: int, sched):
    """(chunk, placement) pairs of a dense bucket: its aligned chunks
    (placement None), or, with a scheduler, its rounds — drawn lazily,
    so that a round reflects every rebalance since the last."""
    if sched is None:
        for chunk in _chunks(idxs, chunk_keys, align):
            yield chunk, None
        return
    while True:
        placement = sched.next_round()
        if placement is None:
            return
        yield [i for i, _d in placement], placement


# ------------------------------------------------------------ executor

def check_batch_pipelined(model, histories, capacity: int = 512,
                          max_capacity: int = 1 << 18, mesh=None,
                          bucket: Optional[str] = None, cache=None,
                          chunk_keys: int = DEFAULT_CHUNK_KEYS,
                          depth: int = 2, stats: Optional[dict] = None,
                          dedupe: Optional[str] = None,
                          search_stats: Optional[bool] = None,
                          config_pack: Optional[bool] = None,
                          steal: Optional[bool] = None,
                          reshard: Optional[bool] = None,
                          steal_stats: Optional[dict] = None,
                          device=None) -> list:
    """`engine.check_batch` with the encode and the device's scan
    overlapped (the module's docstring): the same arguments and the same
    results, and

    cache       the EncodeCache to read and fill (None: the process's;
                False: none for this call)
    chunk_keys  the keys of a dense chunk, about
    depth       the chunks in flight before the oldest is read (>= 1)
    stats       a dict to fill: "n_keys", "bucket", "dedupe",
                "prepare_secs" (stage 1 of every key), "e2e_secs", a
                "buckets" list — each bucket's "tier", "engine"
                ("bitdense" or "sparse"), "keys", "chunks",
                "encode_secs" (its keys' two stages), "issue_secs" (pad,
                copy to the device and issue), "device_wait_secs" (the
                host waiting in `finalize()`), "device_secs" (the card's
                time from each chunk's first launch to its last, by CUDA
                events; None off the card) or, sparse, "search_secs" —
                and the cache's counters of this call under "cache"

    mesh        a torch.distributed DeviceMesh: the keys are sharded
                over its ranks, each of which calls the executor with
                the same arguments (`device` is then the mesh's)
    steal       the work-stealing scheduler (None: the strict
                JEPSEN_TPU_TORCH_STEAL flag): a dense bucket's chunks
                are its rounds, a sparse bucket runs through
                `elastic.check_batch_stealing`
    reshard     the sharded escalation rung recruits ranks first (None:
                JEPSEN_TPU_TORCH_RESHARD)
    steal_stats a dict for the schedulers' accounting ({"buckets":
                [...]}); without stealing it raises ValueError

    `device` None means the card (RuntimeError without one)."""
    engine._check_mesh(mesh)
    steal = engine._resolve_steal(steal)
    if steal_stats is not None and not steal:
        raise ValueError(
            "check_batch: steal_stats is an elastic-executor argument — "
            "pass steal=True (or set JEPSEN_TPU_TORCH_STEAL=1) to use it")
    if depth < 1:
        raise ValueError(f"depth={depth} must be >= 1")
    bucket = engine._resolve_bucket(bucket)
    dedupe = sparse._resolve_dedupe(dedupe)
    search_stats = st._resolve_search_stats(search_stats)
    config_pack = sparse._resolve_config_pack(config_pack)
    if stats is None:
        stats = {}
    K = len(histories)
    stats.update({"n_keys": K, "bucket": bucket, "dedupe": dedupe,
                  "buckets": []})
    if K == 0:
        return []
    dev = engine.batch_device(device, mesh)
    if cache is None:
        cache = default_cache()
    elif cache is False:
        cache = None
    if cache is not None and cache.max_entries == 0:
        cache = None      # off: not even the digest
    c0 = cache.counters() if cache is not None else None
    with obs.span("pipeline.run", keys=K, bucket=bucket, dedupe=dedupe), \
            obs.maybe_torch_profile():
        out = _stream(model, histories, capacity, max_capacity, bucket,
                      cache, chunk_keys, depth, stats, dedupe,
                      search_stats, config_pack, dev, mesh, steal,
                      reshard, steal_stats)
    if c0 is not None:
        c1 = cache.counters()
        stats["cache"] = {k: c1[k] - c0[k] for k in
                          ("hits", "disk_hits", "misses", "encodes")}
        stats["cache"]["entries"] = c1["entries"]
        # the same deltas feed the registry
        reg = obs.registry()
        for k in ("hits", "disk_hits", "misses", "encodes"):
            if stats["cache"][k]:
                reg.counter(f"pipeline.cache.{k}").inc(stats["cache"][k])
    return out


def _stream(model, histories, capacity, max_capacity, bucket, cache,
            chunk_keys, depth, stats, dedupe, search_stats, config_pack,
            dev, mesh=None, steal: bool = False, reshard=None,
            steal_stats: Optional[dict] = None) -> list:
    """The executor's body (`check_batch_pipelined`), under the
    pipeline.run span."""
    from jepsen_tpu_torch.parallel import elastic
    align = 1 if mesh is None else mesh.size()
    scheds: list = []    # (bstat, KeyScheduler) of the stealing buckets
    K = len(histories)
    reg = obs.registry()
    reg.counter("pipeline.keys").inc(K)
    inflight = reg.gauge("pipeline.inflight")

    def _depth(n: int):
        """The gauge and its counter-track sample from one level read
        (the sample is a no-op with tracing off)."""
        inflight.set(n)
        obs.counter_sample("pipeline.inflight", n)

    timed = dev.type == "cuda"
    t_wall = perf_counter()
    out: list = [None] * K
    infos = [_lookup_or_prepare(model, h, cache, key=i)
             for i, h in enumerate(histories)]
    stats["prepare_secs"] = round(perf_counter() - t_wall, 6)
    buckets: dict = {}
    for i, info in enumerate(infos):
        buckets.setdefault(engine.bucket_key(info.n_slots, bucket),
                           []).append(i)
    pending: deque = deque()
    bstats: list = []
    transfer: dict = {}   # a bucket's pad-and-copy secs, for its histogram

    def drain_one():
        (chunk, pb, bstat, chunk_no, t_issue, ev0, ev1, sched,
         placement) = pending.popleft()
        t0 = perf_counter()
        with obs.span("pipeline.finalize", tier=bstat["tier"],
                      chunk=chunk_no, keys=len(chunk)):
            rs = pb.finalize()
        _depth(len(pending))
        t_done = perf_counter()
        bstat["device_wait_secs"] += t_done - t0
        tr = obs.tracer()
        if tr is not None:
            # the chunk's in-flight window, issue to read, on its
            # bucket's device track: host clock reads, no device sync
            tr.add_span("device.search", t_issue, t_done,
                        track=f"bucket-{bstat['tier']}", chunk=chunk_no,
                        keys=len(chunk), engine=bstat["engine"])
        transfer[bstat["tier"]] += pb.transfer_secs
        if timed:
            bstat["device_secs"] += ev0.elapsed_time(ev1) / 1e3
        for i, r in zip(chunk, rs):
            out[i] = r
        if sched is not None:
            # the stealer's observation point: the drained chunk's costs
            # rebalance what is still queued (chunks in flight keep
            # their placement)
            sched.observe(
                {i: elastic.key_cost(r, capacity) for i, r in zip(chunk, rs)},
                placement,
                lf={i: (r.get("stats") or {}).get("load-factor-peak")
                    for i, r in zip(chunk, rs)})

    for tier in sorted(buckets):
        idxs = buckets[tier]
        S_max = max(infos[i].n_states for i in idxs)
        C_max = max(infos[i].n_slots for i in idxs)
        R_max = max(infos[i].n_returns for i in idxs)
        bstat = {"tier": tier, "keys": len(idxs), "chunks": 0}
        bstats.append(bstat)
        transfer[tier] = 0.0
        if bitdense.fits_bitdense(S_max, C_max):
            bstat.update(engine="bitdense", issue_secs=0.0,
                         device_wait_secs=0.0,
                         device_secs=0.0 if timed else None)
            sched = None
            if steal:
                sched = elastic.KeyScheduler(
                    idxs, n_dev=align,
                    round_keys=max(1, max(1, chunk_keys) // align))
                bstat["steal"] = True
                scheds.append((bstat, sched))
            for chunk, placement in _bucket_chunks(idxs, chunk_keys, align,
                                                   sched):
                # the encodes run outside the chunk's span: their
                # parent is pipeline.run, as on the reference's pool
                sub = [_fill(infos[i], cache, key=i) for i in chunk]
                t0 = perf_counter()
                ev0 = ev1 = None
                if timed:
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record()
                # every chunk padded to the bucket's (S, C, R): its
                # results are the whole bucket's
                with obs.span("pipeline.dispatch", tier=tier,
                              chunk=bstat["chunks"], keys=len(chunk)):
                    pb = bitdense.dispatch_batch_bitdense(
                        sub, device=dev, search_stats=search_stats,
                        min_states=S_max, min_slots=max(5, C_max),
                        min_returns=R_max, mesh=mesh,
                        ranks=(None if placement is None
                               else [d for _i, d in placement]))
                if timed:
                    ev1.record()
                bstat["issue_secs"] += perf_counter() - t0
                pending.append((chunk, pb, bstat, bstat["chunks"], t0,
                                ev0, ev1, sched, placement))
                bstat["chunks"] += 1
                reg.counter("pipeline.chunks").inc()
                _depth(len(pending))
                while len(pending) >= depth:
                    drain_one()
        else:
            # the capacity retry reads the device as it goes: the
            # bucket runs whole, while earlier chunks are still in flight
            bstat.update(engine="sparse", chunks=1)
            if not steal:
                reg.counter("pipeline.chunks").inc()
            sub = [_fill(infos[i], cache, key=i) for i in idxs]
            t0 = perf_counter()
            if steal:
                # the stealer's rounds own the sparse bucket's ladder
                bstat["steal"] = True
                est: dict = {}
                with obs.span("pipeline.sparse", tier=tier,
                              keys=len(idxs)):
                    rs = elastic.check_batch_stealing(
                        model, sub, capacity=capacity,
                        max_capacity=max_capacity, mesh=mesh,
                        bucket=bucket, dedupe=dedupe,
                        search_stats=search_stats,
                        config_pack=config_pack, reshard=reshard,
                        stats=est, device=dev)
                bstat["chunks"] = sum(b.get("rounds", 0)
                                      for b in est["buckets"])
                reg.counter("pipeline.chunks").inc(max(1, bstat["chunks"]))
                if steal_stats is not None:
                    steal_stats.setdefault("buckets", []).extend(
                        est["buckets"])
            else:
                with obs.span("pipeline.sparse", tier=tier,
                              keys=len(idxs)):
                    rs = engine._check_batch_sparse(
                        sub, capacity, max_capacity, dedupe=dedupe,
                        device=dev, config_pack=config_pack,
                        search_stats=search_stats, mesh=mesh,
                        reshard=reshard)
            bstat["search_secs"] = round(perf_counter() - t0, 6)
            for i, r in zip(idxs, rs):
                out[i] = r
    while pending:
        drain_one()
    if steal_stats is not None:
        for bstat, sched in scheds:
            steal_stats.setdefault("buckets", []).append(
                {"tier": bstat["tier"], "engine": "bitdense",
                 "keys": bstat["keys"], **sched.stats()})
    for bstat in bstats:
        bstat["encode_secs"] = round(sum(
            infos[i].secs for i in buckets[bstat["tier"]]), 6)
        for k in ("issue_secs", "device_wait_secs", "device_secs"):
            if bstat.get(k) is not None:
                bstat[k] = round(bstat[k], 6)
        # the bucket's split into the registry's histograms
        reg.histogram("pipeline.encode_secs").observe(bstat["encode_secs"])
        reg.histogram("pipeline.transfer_secs").observe(
            round(transfer[bstat["tier"]], 6))
        reg.histogram("pipeline.device_wait_secs").observe(
            bstat.get("device_wait_secs", 0.0))
    stats["buckets"] = bstats
    stats["e2e_secs"] = round(perf_counter() - t_wall, 6)
    return out
