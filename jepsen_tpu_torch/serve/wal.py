"""Per-key delta write-ahead log for the streaming checker service.

A port of `jepsen_tpu.serve.wal`, byte for byte on disk: a WAL
directory or a checkpoint pair written by either package replays in the
other, and counted under the reference's names (``serve.wal_torn``,
``serve.wal_rotations``, ``serve.fences_written``). Left out: the
checkpoint store's compiled-program manifest (the port has no
compiled-program cache).

The robustness contract (docs/streaming.md): a delta the service has
ADMITTED is durable before the producer sees ``{"accepted": ...}`` —
a kill-and-restart replays the WAL through the deterministic encode +
scan and lands bit-identical verdicts. Format: append-only JSONL
**segments** per key under the WAL root,

    <stem>.wal          segment 0 (always first)
    <stem>.wal.1        segment 1 (after the first rotation)
    <stem>.wal.N        ...

    {"key": "<edn>", "segment": N, "tenant": "..."?,
     "epoch": E}                                       header, first
                                                       line of EVERY
                                                       segment
    {"seq": 1, "ops": ["<edn op>", ...]}               one per delta

Ops are EDN-serialized individually (``history.op_to_edn_str`` — the
store's exact round-trip format), so replay reconstructs the op
stream byte-for-byte. Sequence numbers are the idempotence key:
``replay`` drops duplicate/stale seqs, so re-submitting a delta after
a crash (the client can't know whether the pre-crash submit landed)
is a no-op, never a double-apply.

Segmentation exists for two consumers (neither changes replay
semantics): per-tenant WAL-bytes quotas meter ``size_bytes`` (the sum
over segments), and replica handoff (``serve.ring.transfer_key``, and the
replication of ``serve.fleet.SegmentReplicator``) ships a key as a list
of sealed files instead of one unbounded one. ``rotate`` seals the active
segment; ``JEPSEN_TPU_TORCH_SERVE_WAL_SEGMENT_BYTES`` (0 = off, the
default) rotates automatically past a size. Each segment repeats the
header so a transferred file set is self-describing.

Ownership epochs + fences (docs/streaming.md "Fleet self-healing"):
every segment header carries the key's ownership **epoch** — bumped by
:meth:`CheckerService.adopt_keys` when a survivor takes the key over,
so the WAL itself records who owned which stretch of the stream. A
**fence marker** (``<stem>.fence``, written atomically by a rehome /
``CheckerService.fence_key_ownership`` BEFORE the segments are
transferred) tells a stale replica that
resurfaces — the SIGSTOP/paused-not-dead case — that its epoch is
over: the service refuses its producers with a structured answer
instead of becoming a second writer. An unreadable fence file fails
SAFE (treated as fenced): for a split-brain guard, refusing work
beats serving it on corrupt evidence.

Crash tolerance: every append is flushed + fsynced before returning;
a torn final line (the process died mid-write — that delta was never
acknowledged) is detected on replay, logged, and ignored. Because a
torn line was the tail of its file when written, the tolerance is per
SEGMENT: one torn
trailing line in any segment is an unacknowledged kill (possibly
followed by a post-restart rotation), while an undecodable line
before a segment's tail means real corruption and raises
:class:`WALError` rather than silently replaying a hole in an
acknowledged stream.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

from jepsen_tpu_torch import edn, envflags, obs
from jepsen_tpu_torch.history import _hashable, op_from_edn, op_to_edn_str

_log = logging.getLogger(__name__)

_SEG_RE = re.compile(r"\.wal(?:\.(\d+))?$")


class WALError(RuntimeError):
    """An acknowledged region of a WAL file cannot be replayed."""


def _safe_name(key) -> str:
    """Filesystem-safe, collision-free file stem for an arbitrary EDN
    key: readable prefix + content digest (the digest is the identity;
    the prefix is for humans)."""
    s = edn.dumps(key)
    digest = hashlib.sha1(s.encode()).hexdigest()[:10]
    prefix = "".join(ch if ch.isalnum() or ch in "-_" else "-"
                     for ch in s)[:40]
    return f"{prefix or 'key'}_{digest}"


def _resolve_segment_bytes(v: Optional[int]) -> int:
    if v is not None:
        return int(v)
    return envflags.env_int("JEPSEN_TPU_TORCH_SERVE_WAL_SEGMENT_BYTES",
                            default=0, min_value=0,
                            what="WAL segment size (bytes)") or 0


class DeltaWAL:
    """Append-only per-key delta log under ``root`` (module docstring).
    Thread-safe; the service appends from producer threads and replays
    from the worker. ``segment_bytes`` (or the env flag) > 0 rotates
    the active segment automatically once it grows past that size."""

    def __init__(self, root: str, segment_bytes: Optional[int] = None):
        self.root = root
        self.segment_bytes = _resolve_segment_bytes(segment_bytes)
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()          # handle/lock creation
        self._files: Dict[str, object] = {}    # stem -> open handle
        self._seg: Dict[str, int] = {}         # stem -> active index
        self._epochs: Dict[str, int] = {}      # stem -> epoch to stamp
        # on newly-opened segment headers (set_epoch; default: inherit
        # from the newest existing segment, else 1)
        # per-stem write locks: independent keys fsync CONCURRENTLY —
        # one global lock here would re-serialize exactly what the
        # service's seq-ordered handoff exists to avoid
        self._stem_locks: Dict[str, threading.Lock] = {}

    # -- segment naming

    def _seg_path(self, stem: str, i: int) -> str:
        base = os.path.join(self.root, stem + ".wal")
        return base if i == 0 else f"{base}.{i}"

    def _segment_indices(self, stem: str) -> List[int]:
        """Existing segment indices for a stem, ascending."""
        out = []
        prefix = stem + ".wal"
        for name in os.listdir(self.root):
            if not name.startswith(prefix):
                continue
            rest = name[len(stem):]
            m = _SEG_RE.fullmatch(rest)
            if m:
                out.append(int(m.group(1)) if m.group(1) else 0)
        return sorted(out)

    def segments(self, key) -> List[str]:
        """The key's segment paths in replay order — the unit replica
        handoff copies."""
        stem = _safe_name(key)
        return [self._seg_path(stem, i)
                for i in self._segment_indices(stem)]

    # -- write path

    @staticmethod
    def _repair_tail(path: str) -> None:
        """Truncate a torn (newline-less) trailing line before the
        first append of this process. The partial line is an
        UNACKNOWLEDGED mid-write kill — replay already ignores it, but
        appending after it would concatenate the next record onto the
        partial bytes, turning an acknowledged delta into an
        unparseable line on the following restart."""
        try:
            with open(path, "rb+") as fh:
                fh.seek(0, os.SEEK_END)
                if fh.tell() == 0:
                    return
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) == b"\n":
                    return
                fh.seek(0)
                data = fh.read()
                cut = data.rfind(b"\n")
                fh.truncate(cut + 1 if cut >= 0 else 0)
            obs.counter("serve.wal_torn").inc()
            _log.warning("WAL %s: truncated a torn trailing line "
                         "before appending (the delta was never "
                         "acknowledged)", path)
        except OSError as err:
            _log.warning("WAL %s: could not repair tail (%r)", path,
                         err)

    def _open_active(self, stem: str, key, tenant: Optional[str]):
        """The active (highest-index) segment's handle, opened —
        with tail repair — on first touch; callers hold the stem
        lock."""
        with self._lock:
            fh = self._files.get(stem)
        if fh is not None:
            return fh
        idx = self._seg.get(stem)
        if idx is None:
            existing = self._segment_indices(stem)
            idx = existing[-1] if existing else 0
        path = self._seg_path(stem, idx)
        fresh = not os.path.exists(path)
        if not fresh:
            self._repair_tail(path)
        fh = open(path, "a")
        if fresh:
            with self._lock:
                ep = self._epochs.get(stem)
            if ep is None:
                # inherit from the newest lower segment so a rotation
                # never silently resets an ownership epoch
                ep = self._header_epoch(stem, below=idx)
            head = {"key": edn.dumps(key), "segment": idx, "epoch": ep}
            if tenant is not None:
                head["tenant"] = tenant
            fh.write(json.dumps(head) + "\n")
        with self._lock:
            self._files[stem] = fh
            self._seg[stem] = idx
        return fh

    def append(self, key, seq: int, ops,
               tenant: Optional[str] = None,
               delta_id: Optional[str] = None) -> int:
        """Durably append one delta; returns the bytes written (the
        per-tenant WAL-quota meter). ``tenant`` stamps the segment
        header so recovery re-homes the key to its owner.

        ``delta_id`` (when the service has delta tracing armed) rides
        the record as ``"id"`` so the delta's trace identity survives
        recovery, replica handoff, and adoption — the id travels with
        the transferred segment files. None keeps the record bytes
        identical to the pre-tracing format (the default-off parity
        contract); ``replay`` ignores the field either way."""
        stem = _safe_name(key)
        rec = {"seq": int(seq),
               "ops": [op_to_edn_str(o) for o in ops]}
        if delta_id is not None:
            rec["id"] = str(delta_id)
        line = json.dumps(rec)
        with self._lock:
            slock = self._stem_locks.setdefault(stem, threading.Lock())
        with slock:
            fh = self._open_active(stem, key, tenant)
            fh.write(line + "\n")
            fh.flush()
            os.fsync(fh.fileno())
            n = len(line) + 1
            if self.segment_bytes and fh.tell() >= self.segment_bytes:
                self._rotate_locked(stem)
            return n

    def _rotate_locked(self, stem: str) -> None:
        """Seal the active segment (callers hold the stem lock); the
        next append opens ``<stem>.wal.<n+1>`` with a fresh header."""
        with self._lock:
            fh = self._files.pop(stem, None)
            idx = self._seg.get(stem)
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass
        if idx is None:
            existing = self._segment_indices(stem)
            if not existing:
                return   # nothing written yet: rotating would orphan
                # segment 0 (keys() reads its header) — a no-op is the
                # only sound answer
            idx = existing[-1]
        with self._lock:
            self._seg[stem] = idx + 1
        obs.counter("serve.wal_rotations").inc()

    def rotate(self, key) -> None:
        """Seal the key's active segment now (replica handoff wants
        sealed files; quota tests want deterministic boundaries)."""
        stem = _safe_name(key)
        with self._lock:
            slock = self._stem_locks.setdefault(stem, threading.Lock())
        with slock:
            self._rotate_locked(stem)

    def touch(self, key, tenant: Optional[str] = None) -> None:
        """Open the key's active segment NOW, writing its header if
        the file is fresh — adoption calls set_epoch + rotate + touch
        so the bumped ownership epoch is durable immediately, not at
        the next append (a fence computed from this dir's headers
        must already out-rank the previous owner)."""
        stem = _safe_name(key)
        with self._lock:
            slock = self._stem_locks.setdefault(stem, threading.Lock())
        with slock:
            fh = self._open_active(stem, key, tenant)
            fh.flush()
            os.fsync(fh.fileno())

    def close(self) -> None:
        with self._lock:
            for fh in self._files.values():
                try:
                    fh.close()
                except OSError:
                    pass
            self._files.clear()
            self._seg.clear()
            self._stem_locks.clear()
            self._epochs.clear()

    # -- replay path

    def keys(self) -> list:
        """Every key with a WAL file (decoded from the segment-0
        headers; rotation never drops segment 0, so one row per key)."""
        out = []
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".wal"):
                continue
            path = os.path.join(self.root, name)
            try:
                with open(path) as fh:
                    head = fh.readline()
                # EDN round-trips sequences as lists; the service keys
                # a dict on these, so canonicalize to the hashable
                # form (nested tuples) — same identity either way,
                # because _safe_name hashes the EDN text
                out.append(_hashable(edn.loads(json.loads(head)["key"])))
            except Exception as err:  # noqa: BLE001 — a header we
                # cannot read means the whole file is suspect; this is
                # acknowledged data, so it must be loud, not skipped
                raise WALError(
                    f"unreadable WAL header in {path}: {err!r}") from err
        return out

    def header(self, key) -> Optional[dict]:
        """The key's segment-0 header record ({"key", "segment",
        "tenant"?}), or None when the key has no WAL — how recovery
        learns which tenant owns a replayed key."""
        segs = self.segments(key)
        if not segs:
            return None
        try:
            with open(segs[0]) as fh:
                return json.loads(fh.readline())
        except Exception as err:  # noqa: BLE001 — same posture as keys()
            raise WALError(
                f"unreadable WAL header in {segs[0]}: {err!r}") from err

    # -- ownership epoch + fence

    def _header_epoch(self, stem: str, below: Optional[int] = None) \
            -> int:
        """The newest existing segment header's epoch (optionally only
        segments with index < ``below``), default 1 — pre-epoch WAL
        files read as epoch 1, so old fleets replay unchanged."""
        indices = [i for i in self._segment_indices(stem)
                   if below is None or i < below]
        for i in reversed(indices):
            path = self._seg_path(stem, i)
            try:
                with open(path) as fh:
                    return int(json.loads(fh.readline()).get(
                        "epoch", 1))
            except Exception as err:  # noqa: BLE001 — same posture as
                # keys(): an unreadable header is acknowledged data
                raise WALError(
                    f"unreadable WAL header in {path}: {err!r}") \
                    from err
        return 1

    def epoch(self, key) -> int:
        """The key's current ownership epoch: the pending stamp when
        one was set this process, else the newest segment header's,
        else 1 (no WAL yet)."""
        stem = _safe_name(key)
        with self._lock:
            e = self._epochs.get(stem)
        if e is not None:
            return e
        return self._header_epoch(stem)

    def header_epoch(self, key) -> int:
        """The newest segment HEADER's epoch, ignoring any pending
        in-process stamp — the adoption base: a key transferred back
        into this dir carries its truth in the transferred headers,
        and a stamp left by an earlier ownership generation of this
        process must not shadow it."""
        return self._header_epoch(_safe_name(key))

    def set_epoch(self, key, epoch: int) -> None:
        """Stamp ``epoch`` on every segment header this process opens
        for the key from now on (``adopt_keys`` bumps + rotates, so
        the bump lands in the next segment's header durably)."""
        with self._lock:
            self._epochs[_safe_name(key)] = int(epoch)

    def _fence_path(self, stem: str) -> str:
        return os.path.join(self.root, stem + ".fence")

    def write_fence(self, key, epoch: int,
                    owner: Optional[str] = None) -> dict:
        """Atomically drop the key's fence marker: any service over
        this WAL root whose key epoch is below ``epoch`` must refuse
        producers (it is no longer the owner). Written BEFORE segment
        transfer by the rehome path, so a stale writer that re-checks
        the fence after its fsync can never hand out an ack the new
        owner will not replay."""
        doc = {"key": edn.dumps(key), "epoch": int(epoch)}
        if owner is not None:
            doc["owner"] = owner
        path = self._fence_path(_safe_name(key))
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(json.dumps(doc) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        obs.counter("serve.fences_written").inc()
        return doc

    def fence(self, key) -> Optional[dict]:
        """The key's fence marker, or None. An unreadable fence fails
        SAFE — it reads as a fence at an unbeatable epoch, because a
        split-brain guard must refuse on corrupt evidence, never
        write through it."""
        path = self._fence_path(_safe_name(key))
        try:
            with open(path) as fh:
                doc = json.loads(fh.read())
            doc["epoch"] = int(doc["epoch"])
            return doc
        except FileNotFoundError:
            return None
        except Exception as err:  # noqa: BLE001 — corrupt marker
            _log.warning("WAL fence %s unreadable (%r) — treating the "
                         "key as fenced (fail-safe)", path, err)
            return {"epoch": 1 << 62, "error": f"unreadable fence: "
                                               f"{err!r}"}

    def clear_fence(self, key) -> None:
        """Drop a stale fence marker (adoption clears one an earlier
        ownership generation left behind, once its own epoch
        out-ranks it)."""
        try:
            os.remove(self._fence_path(_safe_name(key)))
        except OSError:
            pass

    def replay(self, key) -> List[Tuple[int, list]]:
        """The key's admitted deltas as ``[(seq, [Op, ...]), ...]`` in
        ascending seq order, across every segment, duplicates dropped.
        Tolerates one torn TRAILING line per segment (an
        unacknowledged mid-write kill — it was the tail of its file
        when written, segment boundary or not)."""
        return self.replay_with_ids(key)[0]

    def replay_with_ids(self, key):
        """One-scan ``(replay(key), seq -> delta_id)`` — the
        recovery/adoption/re-thaw path needs both, and with delta
        tracing armed must not pay the segment read + json decode
        twice per key. Same torn-tail/corruption posture as
        ``replay``; ids synthesized like ``delta_ids`` for records
        written without one."""
        out: List[Tuple[int, list]] = []
        seen = set()
        ids: Dict[int, str] = {}
        digest = self._id_digest(key)
        for path in self.segments(key):
            with open(path) as fh:
                lines = fh.read().splitlines()
            for i, line in enumerate(lines[1:], start=2):
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    seq = int(rec["seq"])
                    ops = [op_from_edn(edn.loads(s)) for s in rec["ops"]]
                except Exception as err:  # noqa: BLE001 — decode failure
                    if i == len(lines):
                        obs.counter("serve.wal_torn").inc()
                        _log.warning(
                            "WAL %s: torn trailing line ignored (the "
                            "delta was never acknowledged): %r", path,
                            err)
                        break
                    raise WALError(
                        f"corrupt WAL line {i} in {path} (not the "
                        f"tail — acknowledged data): {err!r}") from err
                if seq in seen:
                    continue
                seen.add(seq)
                out.append((seq, ops))
                ids[seq] = self._record_id(digest, rec, seq)
        out.sort(key=lambda t: t[0])
        return out, ids

    @staticmethod
    def _id_digest(key) -> str:
        return _safe_name(key).rsplit("_", 1)[-1]

    @staticmethod
    def _record_id(digest: str, rec: dict, seq: int) -> str:
        """One record's trace id: the stamped ``"id"``, or the
        SYNTHESIZED stable stand-in (``wal-<stem digest>-<seq>``) for
        records written before delta tracing existed (or unarmed) —
        deterministic per (key, seq), so the same synthetic id
        reappears on every replay/adoption of the same record. ONE
        definition, shared by the strict (``replay_with_ids``) and
        lenient (``delta_ids``) scans: the two paths must never mint
        different ids for the same bytes."""
        return str(rec.get("id") or f"wal-{digest}-{seq}")

    def delta_ids(self, key) -> Dict[int, str]:
        """seq -> trace ``delta_id`` for every replayable delta of the
        key (ids per ``_record_id`` — stamped or synthesized). Decode
        failures are skipped (the torn-tail / corruption posture
        belongs to ``replay``; this is a telemetry read and must
        never out-strict it)."""
        digest = self._id_digest(key)
        out: Dict[int, str] = {}
        for path in self.segments(key):
            try:
                with open(path) as fh:
                    lines = fh.read().splitlines()
            except OSError:
                continue
            for line in lines[1:]:
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                    seq = int(rec["seq"])
                except Exception:  # noqa: BLE001 — torn tail etc.
                    continue
                if seq not in out:
                    out[seq] = self._record_id(digest, rec, seq)
        return out

    def last_seq(self, key) -> int:
        deltas = self.replay(key)
        return deltas[-1][0] if deltas else 0

    def size_bytes(self, key) -> int:
        """The key's WAL size summed across segments (0 when none) —
        the /status durability column and the tenant WAL-quota meter."""
        total = 0
        for path in self.segments(key):
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        return total


# -------------------------------------------------- checkpoint store


class CheckpointStore:
    """The eviction side-car: a frozen session's FrontierCheckpoint
    (.npz, via ``FrontierCheckpoint.save``) plus a small JSON meta
    record (applied seq, op count, digest) under ``root``. Thaw reads
    both; a missing/mismatched pair degrades to a from-scratch rescan
    of the WAL replay — slower, never wrong."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _paths(self, key) -> Tuple[str, str]:
        stem = os.path.join(self.root, _safe_name(key))
        return stem + ".npz", stem + ".json"

    def save(self, key, meta: dict) -> None:
        _npz, jpath = self._paths(key)
        tmp = jpath + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(meta, fh)
        os.replace(tmp, jpath)

    def checkpoint_path(self, key) -> str:
        return self._paths(key)[0]

    def load(self, key) -> Tuple[Optional[object], Optional[dict]]:
        """(FrontierCheckpoint | None, meta | None)."""
        npz, jpath = self._paths(key)
        if not os.path.exists(jpath):
            return None, None
        try:
            with open(jpath) as fh:
                meta = json.load(fh)
        except Exception as err:  # noqa: BLE001 — a checkpoint is an
            # optimization; unreadable meta degrades to WAL replay
            _log.warning("checkpoint meta %s unreadable (%r) — "
                         "thaw will rescan from the WAL", jpath, err)
            return None, None
        cp = None
        if meta.get("checkpoint") and os.path.exists(npz):
            try:
                from jepsen_tpu_torch.parallel import engine
                cp = engine.FrontierCheckpoint.load(npz)
            except Exception as err:  # noqa: BLE001 — same posture
                _log.warning("checkpoint %s unreadable (%r) — thaw "
                             "will rescan from the WAL", npz, err)
                cp = None
        return cp, meta

    def drop(self, key) -> None:
        for p in self._paths(key):
            try:
                os.remove(p)
            except OSError:
                pass
