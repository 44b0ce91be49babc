"""Search telemetry: the per-event stats block of the engines.

A port of the search-stats vocabulary and accumulator of
`jepsen_tpu.parallel.engine` (`_resolve_search_stats`,
`PROBE_HIST_EDGES`, `_probe_hist`, `SearchStats`; the reference's
`_finish_search_stats` is `block_of` and `finish_stats_block`), shared
by the dense and the sparse engines.

With `search_stats` on (the argument, else the flag
JEPSEN_TPU_TORCH_SEARCH_STATS) a check's result gains a "stats" block
built from per-event trajectories the scan writes on the device: the
frontier width after the filter (-1 on an event that did not run), the
closure's peak, iterations and configurations stepped, the work a sort
closure would have done (`swork`) and the histogram of the visited-set
probes' final offsets. With it off nothing changes and the result has no
"stats" key.

The resumable check and the streaming sessions feed an accumulator
chunk by chunk; a session splices each check's leg into its lifetime
stats (`SearchStats.splice`). Every engine's block — dense, sparse,
sharded, resumable and stream — goes through the reference's sinks
(`finish_stats_block`): the obs registry under ``engine.search.*``
(`_publish_search_stats`), the Perfetto counter tracks when tracing is
on (`_emit_stats_tracks`, at most STATS_TRACK_MAX_SAMPLES a search) and
the run directory's search-stats record (`obs.record_search_stats`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from jepsen_tpu_torch import obs

# Probe-length histogram buckets (final linear-probe offset per attempted
# insert): upper-exclusive split at these edges, plus an overflow bucket.
PROBE_HIST_EDGES = (1, 2, 4, 8, 16, 32)
PROBE_HIST_LABELS = ("0", "1", "2-3", "4-7", "8-15", "16-31", "32+")
N_PROBE_BUCKETS = len(PROBE_HIST_LABELS)

# metric-name-safe spellings of PROBE_HIST_LABELS (dots and dashes would
# be mangled by Prometheus name sanitization)
PROBE_METRIC_LABELS = ("0", "1", "le3", "le7", "le15", "le31", "over")

# Counter-track samples a search emits at most (a stride over its events)
STATS_TRACK_MAX_SAMPLES = 512

# Per-key trajectories stop growing past this many events; the block then
# says "truncated": True.
SEARCH_STATS_MAX_EVENTS = 32768

# the columns of a scan's per-event trajectory tensor [R, 5]
TRAJ_FIELDS = ("width", "peak", "iters", "stepped", "swork")


def _resolve_search_stats(search_stats=None) -> bool:
    """Whether the stats block is asked for: an explicit argument wins,
    else JEPSEN_TPU_TORCH_SEARCH_STATS, a strict tri-state: unset (or
    empty) is off, "1" on, "0" off, anything else raises ValueError."""
    if search_stats is not None:
        return bool(search_stats)
    raw = os.environ.get("JEPSEN_TPU_TORCH_SEARCH_STATS", "").strip()
    if raw in ("", "0", "1"):
        return raw == "1"
    raise ValueError(f"JEPSEN_TPU_TORCH_SEARCH_STATS={raw!r}: must be '1' "
                     f"(on) or '0' (off); unset it for the default (off)")


def _next_pow2(n: int) -> int:
    return 1 << max(1, (int(n) - 1).bit_length())


# PROBE_HIST_EDGES and the bucket numbers as tensors, per (device, dtype)
_CONST: dict = {}


def _probe_hist(off, attempted):
    """[..., N_PROBE_BUCKETS] int64 histogram of the final probe offsets
    `off` [..., M] of the attempted candidates (`attempted` bool [..., M]):
    each offset's bucket is the count of PROBE_HIST_EDGES at or below it.
    Four kernels and no host read, whatever the leading dims (one
    histogram per leading index): a bucket index, then a one-hot compare
    summed over M (a scatter-add into the few bins would serialize its
    atomics on the card: almost every candidate of a tiled insert is not
    live)."""
    key = (off.device, off.dtype)
    const = _CONST.get(key)
    if const is None:
        const = _CONST[key] = (
            torch.tensor(PROBE_HIST_EDGES, dtype=off.dtype,
                         device=off.device),
            torch.arange(N_PROBE_BUCKETS, device=off.device))
    edges, buckets = const
    idx = torch.where(attempted, torch.bucketize(off, edges, right=True),
                      N_PROBE_BUCKETS)
    return (idx.unsqueeze(-1) == buckets).sum(-2)


def new_trajectories(R: int, device, lead=()):
    """The preallocated per-event trajectories of a scan of R events
    (`lead` = (K,) for a batch): int32 [*lead, R, 5] (TRAJ_FIELDS, width
    -1: not run) and int32 [*lead, R, N_PROBE_BUCKETS]."""
    traj = torch.zeros((*lead, R, len(TRAJ_FIELDS)), dtype=torch.int32,
                       device=device)
    traj[..., 0] = -1
    phist = torch.zeros((*lead, R, N_PROBE_BUCKETS), dtype=torch.int32,
                        device=device)
    return traj, phist


def trajectories_np(traj, phist) -> dict:
    """One scan's trajectories as the reference's per-event stats dict of
    numpy arrays, read from the device once."""
    t = traj.cpu().numpy()
    out = {k: t[..., i] for i, k in enumerate(TRAJ_FIELDS)}
    out["phist"] = phist.cpu().numpy()
    return out


class SearchStats:
    """Host-side accumulator over a scan's per-event stats arrays, one
    per searched key. Rows with width < 0 (pads, post-failure) are
    dropped here; trajectories cap at SEARCH_STATS_MAX_EVENTS."""

    def __init__(self, dedupe: str):
        self.dedupe = dedupe
        self.width: list = []
        self.peak: list = []
        self.iters: list = []
        self.stepped: list = []
        self.swork: list = []     # per-event sort-equivalent work
        self.phist: list = []     # per-event [N_PROBE_BUCKETS] rows
        self.capacity = 0
        self.escalations = 0
        self.truncated = False

    def splice(self, resume_ev: int, leg: "SearchStats") -> None:
        """Replace events [resume_ev, ...) with a re-scanned leg's: a
        streaming session's delta re-opens the tail at its stable
        boundary and scans again from `resume_ev`, so the stale tail's
        rows give way to the leg's instead of being appended to. Events
        below `resume_ev` are the same under extension (the settled
        rows), so the spliced lifetime stats are a one-shot check's of
        the current prefix."""
        for attr in ("width", "peak", "iters", "stepped", "swork",
                     "phist"):
            rows = getattr(self, attr)
            del rows[resume_ev:]
            keep = SEARCH_STATS_MAX_EVENTS - len(rows)
            rows.extend(getattr(leg, attr)[:max(0, keep)])
        if leg.truncated or len(self.width) >= SEARCH_STATS_MAX_EVENTS:
            self.truncated = True
        self.capacity = max(self.capacity, leg.capacity)
        self.escalations += leg.escalations

    def add_chunk(self, ys, N: int) -> None:
        """One chunk's stats dict (np arrays, [R] / [R, B])."""
        room = SEARCH_STATS_MAX_EVENTS - len(self.width)
        w = np.asarray(ys["width"]).reshape(-1)
        real = w >= 0
        if int(real.sum()) > max(0, room):
            # freeze at the cap: aggregates and lists both describe the
            # first MAX events
            self.truncated = True
            keep = np.flatnonzero(real)[:max(0, room)]
            real = np.zeros_like(real)
            real[keep] = True
        self.width.extend(int(x) for x in w[real])
        for attr in ("peak", "iters", "stepped", "swork"):
            getattr(self, attr).extend(
                int(x) for x in np.asarray(ys[attr]).reshape(-1)[real])
        self.phist.extend(
            [int(v) for v in row] for row in
            np.asarray(ys["phist"]).reshape(-1, N_PROBE_BUCKETS)[real])
        self.capacity = max(self.capacity, int(N))

    def block(self) -> dict:
        """The result's "stats" block, the reference's schema."""
        peak = max(self.peak, default=0)
        stepped = sum(self.stepped)
        swork = sum(self.swork)
        phist = np.asarray(self.phist, np.int64).reshape(
            -1, N_PROBE_BUCKETS).sum(axis=0)
        out = {
            "events": len(self.width),
            "frontier-width": list(self.width),
            "closure-iters": list(self.iters),
            "configs-stepped-per-event": list(self.stepped),
            "closure-peak": list(self.peak),
            "frontier-peak": peak,
            "capacity": self.capacity,
            "capacity-tier": self.escalations,
            "peak-occupancy": (round(peak / self.capacity, 6)
                               if self.capacity else None),
            "dedupe": self.dedupe,
            "delta-split-ratio": (round(stepped / swork, 6)
                                  if swork else None),
            "table-capacity": None,
            "load-factor-peak": None,
            "load-factor-final": None,
            "probe-hist": None,
            "probes": None,
        }
        if self.truncated:
            out["truncated"] = True
        if self.dedupe == "hash" and self.capacity:
            # under hash the closure peak is the visited table's occupancy
            T = _next_pow2(2 * self.capacity)
            out["table-capacity"] = T
            out["load-factor-peak"] = round(peak / T, 6)
            out["load-factor-final"] = (round(self.peak[-1] / T, 6)
                                        if self.peak else None)
            out["probe-hist"] = {lab: int(n) for lab, n in
                                 zip(PROBE_HIST_LABELS, phist)}
            out["probes"] = int(phist.sum())
        return out


def _publish_search_stats(block: dict,
                          prefix: str = "engine.search") -> None:
    """Thread one search's stats block into the obs registry under
    ``engine.search.*`` — the names /metrics serves as
    ``jepsen_engine_search_*``."""
    reg = obs.registry()
    reg.counter(f"{prefix}.events").inc(block["events"])
    reg.gauge(f"{prefix}.frontier_peak").set(block["frontier-peak"])
    if block.get("peak-occupancy") is not None:
        reg.gauge(f"{prefix}.peak_occupancy").set(
            block["peak-occupancy"])
    if block.get("delta-split-ratio") is not None:
        reg.gauge(f"{prefix}.delta_split_ratio").set(
            block["delta-split-ratio"])
    if block.get("load-factor-peak") is not None:
        reg.gauge(f"{prefix}.load_factor_peak").set(
            block["load-factor-peak"])
    if block.get("capacity-tier"):
        reg.counter(f"{prefix}.escalations").inc(block["capacity-tier"])
    if block.get("pad-waste") is not None:
        reg.gauge(f"{prefix}.pad_waste").set(block["pad-waste"])
    hist = block.get("probe-hist")
    if hist:
        for raw, lab in zip(PROBE_HIST_LABELS, PROBE_METRIC_LABELS):
            if hist.get(raw):
                reg.counter(f"{prefix}.probe_len.{lab}").inc(hist[raw])


def _emit_stats_tracks(block: dict, t0: float, t1: float) -> None:
    """The search's per-event trajectories as Perfetto counter tracks:
    event index mapped linearly onto the search's wall window (the
    device scan yields no per-event host timestamps — the x axis is
    the event axis rendered in time units, aligned with the search
    span), at most STATS_TRACK_MAX_SAMPLES samples a track. No-op when
    tracing is off."""
    if not obs.enabled():
        return
    widths = block["frontier-width"]
    R = len(widths)
    if not R or t1 <= t0:
        return
    stride = max(1, -(-R // STATS_TRACK_MAX_SAMPLES))
    dt = (t1 - t0) / R
    T = block.get("table-capacity")
    for i in range(0, R, stride):
        t = t0 + (i + 1) * dt
        obs.counter_sample("engine.search.frontier_width", widths[i],
                           t=t)
        if T:
            obs.counter_sample(
                "engine.search.load_factor",
                round(block["closure-peak"][i] / T, 4), t=t)


def finish_stats_block(block: dict, t0: float, t1: float,
                       key=None) -> dict:
    """Fan a ready stats block into the always-on sinks (obs registry,
    run-dir search-stats record) plus the counter tracks when tracing
    is on — shared by the dense, sparse and sharded engines, so every
    path feeds the same sinks. `t0`/`t1` are the search's host window
    (perf_counter reads the engine makes anyway); `key` tags the
    record (a batch's key index)."""
    _publish_search_stats(block)
    _emit_stats_tracks(block, t0, t1)
    record_stats_block(block, key)
    return block


def record_stats_block(block: dict, key=None) -> None:
    """The run directory's search-stats record of `block`, tagged with
    `key` when there is one."""
    rec = dict(block)
    if key is not None:
        rec["key"] = key
    obs.record_search_stats(rec)


def block_of(acc: SearchStats, engine: str = "sparse",
             extra: Optional[dict] = None) -> dict:
    """The stats block of `acc`, "engine" set and `extra`'s fields
    added, not yet through the sinks (`finish_stats_block`; a mesh
    batch's rank builds its keys' blocks, and every rank sinks every
    key's after the gather)."""
    block = acc.block()
    if extra:
        block.update(extra)
    block["engine"] = engine
    return block
