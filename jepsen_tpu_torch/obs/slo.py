"""SLO burn-rate tracking over the serve ack histogram
(``JEPSEN_TPU_TORCH_SLO_ACK_SECS``).

A port of `jepsen_tpu.obs.slo`. The ``serve.ack_secs`` histogram
measures every producer ack; this module derives the two-window burn
rates from its deltas:

    burn = (fraction of acks slower than the target in the window)
           / (1 - objective)

with the objective fixed at 99% (budget 1%): burn 1.0 is "consuming the
budget exactly on schedule", 10 is "10x too fast". The fast window
(5 min) catches incidents, the slow one (1 h) filters blips.

Sampling rides ``CheckerService.refresh_gauges()``, which the ops
endpoint calls before every render, so the gauges
``serve.slo.ack_burn_rate[window=fast|slow]`` are fresh on /metrics with
no thread of their own. ``JEPSEN_TPU_TORCH_SLO_BURN_MAX`` (default 0 =
never) degrades /healthz readiness when the FAST window burns past it.

Off by default: with ``JEPSEN_TPU_TORCH_SLO_ACK_SECS`` unset no gauge is
minted and no check is added — /metrics and /healthz stay as without
the tracker.

Import-safe: no torch.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from typing import List, Optional, Tuple

from jepsen_tpu_torch import envflags
from jepsen_tpu_torch.obs import metrics as _metrics
from jepsen_tpu_torch.obs.tracer import counter_sample

#: the objective: 99% of acks under the target
OBJECTIVE = 0.99

FAST_WINDOW_SECS = 300.0
SLOW_WINDOW_SECS = 3600.0


def resolve_target_secs(v: Optional[float] = None) -> Optional[float]:
    """The ack-latency SLO target (seconds). Unset/0 -> None: tracking
    off, nothing minted."""
    if v is None:
        v = envflags.env_float("JEPSEN_TPU_TORCH_SLO_ACK_SECS",
                               default=None, min_value=0.0,
                               what="ack SLO target (seconds)")
    if not v:
        return None
    return float(v)


def resolve_burn_max(v: Optional[float] = None) -> float:
    """The fast-window burn rate past which /healthz degrades
    (``JEPSEN_TPU_TORCH_SLO_BURN_MAX``); 0 (the default) = never
    degrade, gauges only."""
    if v is not None:
        return float(v)
    return envflags.env_float("JEPSEN_TPU_TORCH_SLO_BURN_MAX",
                              default=0.0, min_value=0.0,
                              what="burn-rate degrade threshold")


def _good_count(snap: dict, target: float) -> int:
    """Observations at or under the target, from the cumulative bucket
    ladder: the largest ``le <= target`` answers (an off-ladder target
    rounds DOWN, counting borderline acks as bad)."""
    i = bisect_right(_metrics.BUCKET_LADDER, target)
    if i == 0:
        return 0
    buckets = snap.get("buckets") or []
    want = _metrics.BUCKET_LADDER[i - 1]
    for le, cum in buckets:
        if le == want:
            return int(cum)
    return 0


class BurnRateTracker:
    """Two-window burn rates from timestamped histogram snapshots.
    ``sample()`` is cheap (one snapshot and a ring append) and safe to
    call from every /metrics render; the windows and the clock are
    injectable."""

    def __init__(self, hist_name: str = "serve.ack_secs",
                 target_secs: Optional[float] = None,
                 burn_max: Optional[float] = None,
                 fast_window: float = FAST_WINDOW_SECS,
                 slow_window: float = SLOW_WINDOW_SECS,
                 clock=time.monotonic):
        self.hist_name = hist_name
        self.target = resolve_target_secs(target_secs)
        self.burn_max = resolve_burn_max(burn_max)
        self.fast_window = fast_window
        self.slow_window = slow_window
        self._clock = clock
        self._lock = threading.Lock()
        #: (t, total_count, bad_count) samples, oldest first
        self._ring: List[Tuple[float, int, int]] = []
        self._last: Optional[dict] = None

    @property
    def armed(self) -> bool:
        return self.target is not None

    def _window_burn(self, window: float, now: float) -> float:
        """Burn over [now - window, now]: bad/total of the window's own
        observations over the budget. No traffic in the window (or no
        second sample yet) -> 0.0: an idle service burns nothing."""
        base = None
        for t, count, bad in self._ring:
            if t >= now - window:
                base = (count, bad)
                break
        if base is None or not self._ring:
            return 0.0
        count, bad = self._ring[-1][1], self._ring[-1][2]
        d_count = count - base[0]
        d_bad = bad - base[1]
        if d_count <= 0:
            return 0.0
        return round((d_bad / d_count) / (1.0 - OBJECTIVE), 4)

    def sample(self, now: Optional[float] = None) -> Optional[dict]:
        """Take one snapshot, update the ring, set the gauges and the
        trace's counter tracks -> ``{"fast": b, "slow": b}`` (None when
        not armed)."""
        if not self.armed:
            return None
        if now is None:
            now = self._clock()
        snap = _metrics.histogram(self.hist_name).snapshot()
        count = int(snap.get("count") or 0)
        bad = count - _good_count(snap, self.target)
        with self._lock:
            self._ring.append((now, count, bad))
            # keep one sample older than the slow window as the
            # baseline; drop the rest
            cut = now - self.slow_window
            while len(self._ring) > 2 and self._ring[1][0] < cut:
                self._ring.pop(0)
            fast = self._window_burn(self.fast_window, now)
            slow = self._window_burn(self.slow_window, now)
            self._last = {"fast": fast, "slow": slow}
        _metrics.gauge(_metrics.labeled(
            "serve.slo.ack_burn_rate", window="fast")).set(fast)
        _metrics.gauge(_metrics.labeled(
            "serve.slo.ack_burn_rate", window="slow")).set(slow)
        counter_sample("serve.slo.ack_burn_rate/fast", fast)
        counter_sample("serve.slo.ack_burn_rate/slow", slow)
        return self._last

    def check(self) -> dict:
        """The /healthz check: not ok when the FAST window burns past
        ``burn_max`` (and a threshold is configured)."""
        with self._lock:
            last = dict(self._last or {"fast": 0.0, "slow": 0.0})
        ok = not (self.burn_max
                  and (last.get("fast") or 0.0) > self.burn_max)
        return {"ok": ok, "burn_fast": last.get("fast"),
                "burn_slow": last.get("slow"),
                "burn_max": self.burn_max,
                "target_secs": self.target}
