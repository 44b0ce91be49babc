"""Elastic multi-key scheduling: skew-driven key work-stealing over the
batched engines (JEPSEN_TPU_TORCH_STEAL).

A port of `jepsen_tpu.parallel.elastic`. The static executors fix each
key's rank up front — a mesh-sharded batch gives every rank a contiguous
block of the bucket — so one hot key's deep closure or capacity ladder
drags every light key sharing its launch, while the ranks holding only
light keys idle. The stealing executor dispatches each slot-window
bucket in ROUNDS instead:

  * `KeyScheduler` keeps one pending-key queue per rank, seeded with the
    contiguous blocks of the static placement (steal off = the static
    placement, round by round);
  * every round takes `round_keys` keys per rank: each rank scans the
    keys placed on it, and the round's results are all-gathered;
  * after a round the scheduler reads each key's observed cost
    (`key_cost`: the search-stats block when armed, else the
    configs-stepped counter and the capacity tier the key needed),
    updates a per-origin-cohort EWMA and rebalances the pending queues,
    heaviest first and round-major, so that a hot cohort's backlog
    drains across every rank instead of straggling one lane a round.

Every rank's scheduler observes the same gathered costs, and the
scheduler is deterministic given its inputs, so every rank rebalances
to the same queues and joins the same collectives. Keys are independent
(jepsen.independent): migration is re-bucketing, and the results equal
the static path's in every pinned field (`STEAL_PIN`).

Left out of the port: the reference's `_degrade_round` (a dead round's
keys go to the host WGL checker) and the supervised dispatch's retry —
a device error in a round raises on its rank, as on every path of the
port — and the planner hook (`planner.ewma_update` is inlined as
`_ewma`; the strategy planner is a later item of the port) and the
decision ledger.

Telemetry, the reference's sites: the `elastic.check_batch` span around
the buckets and an `elastic.round` span around each round, the
`elastic.ewma_cost[cohort=...]` labeled gauges, and `elastic.keys_stolen`
as a counter and as counter-track samples.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional

from jepsen_tpu_torch import envflags
from jepsen_tpu_torch import obs
from jepsen_tpu_torch.parallel import bitdense, engine, sparse
from jepsen_tpu_torch.parallel import search_stats as st

DEFAULT_ROUND_KEYS = 1   # keys per rank per round: small rounds give the
# scheduler more observation points; JEPSEN_TPU_TORCH_STEAL_ROUND widens
# them when launch overhead dominates


def _resolve_round_keys(round_keys: int = 0) -> int:
    if round_keys and round_keys > 0:
        return int(round_keys)
    return envflags.env_int("JEPSEN_TPU_TORCH_STEAL_ROUND",
                            default=DEFAULT_ROUND_KEYS, min_value=1,
                            what="keys per rank per round")


def _ewma(prev: Optional[float], obs: float, alpha: float) -> float:
    """The reference planner's smoothing (`planner.ewma_update`): the
    first observation seeds the average."""
    if prev is None:
        return float(obs)
    return alpha * float(obs) + (1.0 - alpha) * float(prev)


def key_cost(r: dict, base_capacity: int) -> Optional[float]:
    """A key's observed search cost from its result — the scheduler's
    skew signal. In order of preference: the stats block (closure
    iterations times the capacity their work scales with, times the
    ladder's re-runs), else configs-stepped plus the capacity tiers the
    key forced; None when the result carries no signal (a dense key
    without search stats), so that the scheduler leaves its cohort's
    prediction alone."""
    if not isinstance(r, dict):
        return None
    cap = r.get("capacity") or 0
    tiers = 0
    if cap and base_capacity:
        tiers = max(0, int(round(math.log2(
            max(1.0, cap / max(1, base_capacity))))))
    block = r.get("stats") or {}
    iters = block.get("closure-iters")
    if iters:
        return float((1 + tiers) * max(1, cap) * (sum(iters) + len(iters)))
    stepped = r.get("configs-stepped")
    if stepped is not None:
        return float((1 + tiers) * max(1, cap) + stepped)
    if block.get("events"):
        return float((1 + tiers) * max(1, cap) + block["events"])
    return None


class KeyScheduler:
    """Per-rank pending-key queues with skew-driven rebalancing (the
    module's docstring). `idxs` seed the queues in contiguous blocks —
    the static placement — so `steal=False` is the static baseline with
    the same round structure."""

    def __init__(self, idxs, n_dev: int, round_keys: int = 1,
                 steal: bool = True, ewma: float = 0.5):
        self.n_dev = max(1, int(n_dev))
        self.round_keys = max(1, int(round_keys))
        self.steal = bool(steal)
        self.ewma = float(ewma)
        idxs = list(idxs)
        Q = -(-len(idxs) // self.n_dev) if idxs else 0
        self.queues = [deque(idxs[d * Q:(d + 1) * Q])
                       for d in range(self.n_dev)]
        # origin cohort: the rank the static placement pinned the key
        # to; predictions attach to the cohort, not to where a steal ran
        self.cohort = {i: d for d, q in enumerate(self.queues) for i in q}
        self.pred = [None] * self.n_dev      # per-cohort cost EWMA
        self.observed = [0.0] * self.n_dev   # per RUN rank
        self.lf_peak = [None] * self.n_dev   # per RUN rank table load
        self.steals = 0
        self.rounds = 0
        self.observed_keys = 0
        self._last = None   # the in-flight round's [(idx, rank)]

    def pending(self) -> int:
        return sum(len(q) for q in self.queues)

    def next_round(self) -> Optional[list]:
        """The next round's placement, [(key index, rank)] rank-major;
        None once drained."""
        placement = []
        for d, q in enumerate(self.queues):
            for _ in range(self.round_keys):
                if q:
                    placement.append((q.popleft(), d))
        if not placement:
            return None
        self.rounds += 1
        self._last = placement
        return placement

    def observe(self, costs: dict, placement=None, lf=None) -> None:
        """Feed a finished round's costs ({idx: cost or None}), update
        the cohort EWMAs and rebalance the pending queues (not with
        steal=False). `placement` defaults to the last round issued;
        `lf` carries per-key visited-table load-factor peaks for the
        per-rank accounting."""
        if placement is None:
            placement = self._last
            self._last = None
        for i, d in placement or []:
            c = costs.get(i)
            if c is not None:
                self.observed[d] += c
                self.observed_keys += 1
                coh = self.cohort.get(i, d)
                self.pred[coh] = _ewma(self.pred[coh], c, self.ewma)
                # the cost signal per cohort, on /metrics
                obs.gauge(obs.labeled("elastic.ewma_cost",
                                      cohort=str(coh))
                          ).set(self.pred[coh])
            v = None if lf is None else lf.get(i)
            if v is not None:
                cur = self.lf_peak[d]
                self.lf_peak[d] = v if cur is None else max(cur, v)
        if self.steal:
            self.rebalance()

    def rebalance(self) -> None:
        """Deal the pending keys out again by predicted cost, heaviest
        first and round-major, so that similar keys share a round across
        every rank. Deterministic: the sort is stable over the queues'
        order."""
        pending = [i for q in self.queues for i in q]
        if len(pending) <= 1:
            return
        known = [p for p in self.pred if p is not None]
        if not known:
            return   # nothing observed yet: the static placement stays
        fallback = sum(known) / len(known)

        def pred_of(i):
            p = self.pred[self.cohort.get(i, 0)]
            return fallback if p is None else p

        old_dev = {i: d for d, q in enumerate(self.queues) for i in q}
        order = sorted(pending, key=pred_of, reverse=True)
        new_queues = [deque() for _ in range(self.n_dev)]
        rk = self.round_keys
        moved = 0
        for j, i in enumerate(order):
            d = (j // rk) % self.n_dev
            new_queues[d].append(i)
            if old_dev[i] != d:
                moved += 1
        self.queues = new_queues
        if moved:
            self.steals += moved
            obs.counter("elastic.keys_stolen").inc(moved)
            # counter track (no-op with tracing off): the steal
            # trajectory lines up with the elastic.round spans
            obs.counter_sample("elastic.keys_stolen", self.steals)

    def stats(self) -> dict:
        """The scheduler's accounting: per-rank observed cost and busy
        fraction (relative to the hottest rank), rounds, keys stolen,
        load-factor peaks and the cohort predictions."""
        peak = max(self.observed) if self.observed else 0.0
        busy = [round(c / peak, 4) if peak else None
                for c in self.observed]
        mean = (sum(self.observed) / len(self.observed)
                if self.observed else 0.0)
        known_lf = [v for v in self.lf_peak if v is not None]
        lf_mean = sum(known_lf) / len(known_lf) if known_lf else 0.0
        return {"rounds": self.rounds, "steals": self.steals,
                "observed_keys": self.observed_keys,
                "per_device_cost": [round(c, 3) for c in self.observed],
                "per_device_busy": busy,
                "busy_frac": round(mean / peak, 4) if peak else None,
                "per_device_load_factor_peak": [
                    None if v is None else round(v, 6)
                    for v in self.lf_peak],
                "load_factor_spread": (round(max(known_lf) / lf_mean, 4)
                                       if lf_mean else None),
                "cohort_pred": [None if p is None else round(p, 3)
                                for p in self.pred]}


# ----------------------------------------------------------- executor

def check_batch_stealing(model, pre, capacity: int = 512,
                         max_capacity: int = 1 << 18, mesh=None,
                         bucket: Optional[str] = None,
                         dedupe: Optional[str] = None,
                         search_stats: Optional[bool] = None,
                         config_pack: Optional[bool] = None,
                         reshard: Optional[bool] = None,
                         steal: bool = True, round_keys: int = 0,
                         stats: Optional[dict] = None,
                         device=None) -> list:
    """`engine.check_batch_encoded` with each bucket run in rounds under a
    `KeyScheduler` (the module's docstring): one rank without `mesh` (on
    `device`, None the card), else the mesh's ranks, every one of which
    calls it with the same arguments. `steal=False` keeps the static
    placement with the same rounds — the A/B's baseline. `stats`, a
    dict, receives {"n_keys", "bucket", "dedupe", "steal", "round_keys",
    "buckets": [{"tier", "engine", "keys", ...the scheduler's
    accounting}]}. Results keep `pre`'s order and equal the static
    executor's in every pinned field."""
    bucket = engine._resolve_bucket(bucket)
    dedupe = sparse._resolve_dedupe(dedupe)
    ss = st._resolve_search_stats(search_stats)
    pack_req = sparse._resolve_config_pack(config_pack)
    round_keys = _resolve_round_keys(round_keys)
    engine._check_mesh(mesh)
    if stats is None:
        stats = {}
    stats.update({"n_keys": len(pre), "bucket": bucket, "dedupe": dedupe,
                  "steal": bool(steal), "round_keys": round_keys,
                  "buckets": []})
    if not pre:
        return []
    dev = engine.batch_device(device, mesh)
    n_dev = 1 if mesh is None else mesh.size()
    out: list = [None] * len(pre)
    buckets: dict = {}
    for i, e in enumerate(pre):
        buckets.setdefault(engine.bucket_key(e.n_slots, bucket),
                           []).append(i)
    with obs.span("elastic.check_batch", keys=len(pre),
                  devices=n_dev, steal=bool(steal)):
        for tier in sorted(buckets):
            idxs = buckets[tier]
            sub = [pre[i] for i in idxs]
            S_max = max(bitdense.n_states(e) for e in sub)
            C_max = max(e.n_slots for e in sub)
            is_dense = bitdense.fits_bitdense(S_max, C_max)
            sched = KeyScheduler(idxs, n_dev, round_keys, steal=steal)
            bstat = {"tier": tier, "keys": len(idxs),
                     "engine": "bitdense" if is_dense else "sparse"}
            stats["buckets"].append(bstat)
            if is_dense:
                _rounds_bitdense(pre, sched, out, mesh, dev, sub, ss,
                                 capacity)
            else:
                _rounds_sparse(pre, sched, out, mesh, dev, capacity,
                               max_capacity, dedupe, ss, pack_req,
                               reshard, sub)
            bstat.update(sched.stats())
    return out


def _observe(sched: KeyScheduler, placement, rnd, rs, out,
             capacity: int) -> None:
    costs, lf = {}, {}
    for i, r in zip(rnd, rs):
        out[i] = r
        costs[i] = key_cost(r, capacity)
        lf[i] = (r.get("stats") or {}).get("load-factor-peak")
    sched.observe(costs, placement, lf=lf)


def _rounds_bitdense(pre, sched: KeyScheduler, out, mesh, dev, sub,
                     ss: bool, capacity: int) -> None:
    """A dense bucket's rounds, each padded to the bucket's (S, C, R),
    each rank scanning the round's keys placed on it. The dense engine
    has no free cost counter: its signal is the stats block, so without
    search stats the scheduler observes nothing and the static
    placement stays."""
    S_max = max(bitdense.n_states(e) for e in sub)
    C_max = max(e.n_slots for e in sub)
    R_max = max(e.n_returns for e in sub)
    while True:
        placement = sched.next_round()
        if placement is None:
            break
        rnd = [i for i, _d in placement]
        with obs.span("elastic.round", engine="bitdense",
                      keys=len(rnd), round=sched.rounds):
            rs = bitdense.dispatch_batch_bitdense(
                [pre[i] for i in rnd], device=dev, search_stats=ss,
                min_states=S_max, min_slots=max(5, C_max),
                min_returns=R_max, mesh=mesh,
                ranks=[d for _i, d in placement]).finalize()
        _observe(sched, placement, rnd, rs, out, capacity)


def _rounds_sparse(pre, sched: KeyScheduler, out, mesh, dev,
                   capacity: int, max_capacity: int, dedupe: str, ss: bool,
                   pack_req: bool, reshard, sub) -> None:
    """A sparse bucket's rounds, each through the per-key capacity
    ladder (`engine._check_batch_sparse`) with the bucket's padded dims
    and packed layout fixed for every round and tier, so that every
    key reports the layout and pad extras the whole bucket would; a
    round's first tier runs each key on the rank it was placed on."""
    C_pad = max(e.slot_f.shape[1] for e in sub)
    R_pad = max(e.n_returns for e in sub)
    pack = sparse.pack_spec_for(sub, C_pad) if pack_req else ()
    while True:
        placement = sched.next_round()
        if placement is None:
            break
        rnd = [i for i, _d in placement]
        with obs.span("elastic.round", engine="sparse",
                      keys=len(rnd), round=sched.rounds):
            rs = engine._check_batch_sparse(
                [pre[i] for i in rnd], capacity, max_capacity,
                dedupe=dedupe, device=dev, config_pack=pack_req,
                search_stats=ss, mesh=mesh, reshard=reshard,
                pad=(C_pad, R_pad), pack=pack,
                ranks=[d for _i, d in placement])
        _observe(sched, placement, rnd, rs, out, capacity)


# --------------------------------------------- the recorded A/B shape

# The reference's pinned seeds for the forced-skew shape: heavy seeds are
# crash-riddled unordered-queue histories that climb the capacity ladder
# with deep closures, light seeds stay at the base tier; all land in one
# slot-window bucket on the sparse engine.
_SKEW_HEAVY_SEEDS = (1, 7, 11, 14, 18, 27, 47, 53)
_SKEW_LIGHT_SEEDS = (101, 102, 103, 104, 105, 106, 108, 111, 113, 116,
                     117, 118, 119, 120, 121, 122, 123, 129, 131, 132,
                     134, 135, 137, 138, 139, 142, 144, 147, 150, 151,
                     156, 157, 158, 159, 160, 161, 162, 163, 165, 168)
SKEW_CAPACITY = 32   # the ladder's base tier for the pinned shape


def forced_skew_histories(n_heavy: int = 8, n_light: int = 40,
                          n_ops: int = 32):
    """(model, histories) of the forced-skew shape, heavy keys first:
    arrival order is the static placement, so the contiguous queues pin
    every heavy key onto the first ranks."""
    from jepsen_tpu_torch.histories import rand_queue_history
    from jepsen_tpu_torch.models import UnorderedQueue
    if n_heavy > len(_SKEW_HEAVY_SEEDS) \
            or n_light > len(_SKEW_LIGHT_SEEDS):
        raise ValueError("forced_skew_histories: not enough pinned seeds "
                         "for the requested shape")
    hs = [rand_queue_history(n_ops=n_ops, n_processes=6, n_values=3,
                             crash_p=0.22, seed=s)
          for s in _SKEW_HEAVY_SEEDS[:n_heavy]]
    hs += [rand_queue_history(n_ops=n_ops, n_processes=6, n_values=3,
                              crash_p=0.0, seed=s)
           for s in _SKEW_LIGHT_SEEDS[:n_light]]
    return UnorderedQueue(), hs


STEAL_PIN = ("valid?", "op", "fail-event", "max-frontier", "capacity",
             "configs-stepped", "dedupe")


def steal_ab(model, pre, mesh=None, capacity: int = SKEW_CAPACITY,
             max_capacity: int = 1 << 16, warm: bool = True,
             **kw) -> dict:
    """The steal A/B: the same round executor with the rebalancing off
    (static placement), then on, the verdicts held equal (a speedup that
    changed an answer would be a bug). Returns both arms' seconds, their
    ratio, the scheduler's accounting of each arm and the parity flag.
    No wall-clock claim rests on it without paired runs on the card."""
    from time import perf_counter

    def arm(steal):
        acc: dict = {}
        t0 = perf_counter()
        rs = check_batch_stealing(model, pre, capacity=capacity,
                                  max_capacity=max_capacity, mesh=mesh,
                                  steal=steal, stats=acc, **kw)
        return perf_counter() - t0, rs, acc

    if warm:
        arm(True)
    t_s, rs_s, st_s = arm(False)
    t_e, rs_e, st_e = arm(True)

    def pin(r):
        return {k: r.get(k) for k in STEAL_PIN}

    parity = [pin(a) for a in rs_s] == [pin(b) for b in rs_e]
    if not parity:
        raise AssertionError("steal A/B verdict mismatch — scheduling "
                             "must never change results")
    return {"static_secs": round(t_s, 3), "steal_secs": round(t_e, 3),
            "steal_speedup": round(t_s / max(t_e, 1e-9), 3),
            "verdicts_identical": parity,
            "static": st_s["buckets"], "steal": st_e["buckets"]}
