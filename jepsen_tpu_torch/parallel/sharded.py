"""Frontier-sharded linearizability search over a torch.distributed mesh.

A port of `jepsen_tpu.parallel.sharded`: one history's search frontier
spread over the ranks of a mesh (`parallel.meshplan`), the search the
host knossos checker lacks.

  * Every configuration is owned by the rank `owner_hash(row) % n_dev`,
    so the union of the ranks' frontiers is the exact global set. Each
    rank holds at most Nd = ceil(N / n_dev) rows of the global capacity N.
  * The closure expands each rank's rows locally; the candidates travel
    to their owners by one all-to-all of equal buckets of B rows
    (`exchange="route"`, B twice the uniform share, a fuller bucket
    being an overflow) or by an all-gather of every candidate
    (`exchange="gather"`, the A/B path).
  * On a hierarchical plan (a 2-D mesh, slice x chip) the route runs in
    two stages: first to the owner's chip column over the chip axis's
    groups, then across slices over the slice axis's, the owner hashed
    again after the first stage; each row crosses the slice boundary
    once, in one bucket per destination slice.
  * Each rank deduplicates what it owns: by a sort of its rows and the
    received candidates (dedupe="sort"), or by its own open-addressed
    visited set, expanding only the rows found by the last iteration
    (dedupe="hash", the default). The visited-set transaction of every
    closure iteration is kernel K3 on a card (`sparse_kernels.
    hash_insert`).
  * The filter clears the returning call's slot bit, which changes a
    row's owner: the survivors are routed to their new owners once per
    event.

Every value a loop decides on — fresh rows, overflow, an empty
frontier, the frontier's size — is all-reduced over the mesh before it
is read, so every rank leaves every loop on the same iteration and
returns the same result. The host walks the events, as in the sparse
engine: it reads the device once per closure iteration and once per
event, right after the all-reduce.

The routed exchange expands only the rows a loop steps (the delta, or
the live prefix) instead of all Nd: the dead rows would sort past every
bucket, so the buckets, and everything after them, are the reference's.

With `config_pack` a row is the packed word of `sparse._PackedRep` (one
or two int32 lanes): the owner hash, the visited sets (K3 takes one- and
two-lane rows) and the exchange buffers carry its lanes.

Beyond the one-shot check: `search_stats` (the reference's sharded
block: mesh-reduced trajectories and per-rank variants; the probe
histogram is the plain insert's on the CPU and zeros where K3 ran, as
the reference's fused kernel gives), the resumable arm
(`check_encoded_sharded_resumable`: chunks of events, a global
`FrontierCheckpoint` after each, resumable on any rank count) and the
elastic ladder (`check_encoded_sharded_elastic`, or `reshard=`): an
overflow first recruits the next rung of `MeshPlan.ladder`; ranks
outside the current rung wait and receive its carry by a broadcast.

A device error raises on the rank it happens on (which breaks the
collective): no chunk is retried and nothing falls back to the host.

Telemetry, the reference's sites: the `sharded.search` span with one
`sharded.tier` span a capacity tier (and the `sharded N{N} D{n}`
profiler annotation around K3's launches), the `sharded.elastic` span
around the elastic ladder, and the `engine.reshard_escalations`,
`capacity_escalations`, `configs_stepped` and `host_fallbacks`
counters; the stats block goes through the search-stats sinks. Every
rank records its own spans and counts.
"""

from __future__ import annotations

import logging
from time import perf_counter

import numpy as np
import torch
import torch.distributed as dist

from jepsen_tpu_torch import obs
from jepsen_tpu_torch.checker import wgl
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import encode as enc_mod
from jepsen_tpu_torch.parallel import engine
from jepsen_tpu_torch.parallel import search_stats as st
from jepsen_tpu_torch.parallel import sparse as sp
from jepsen_tpu_torch.parallel import sparse_kernels as sk
from jepsen_tpu_torch.parallel.encode import EncodedHistory, fail_op_fields
from jepsen_tpu_torch.parallel.meshplan import MeshPlan
from jepsen_tpu_torch.parallel.steps import STEPS

_log = logging.getLogger(__name__)

_I32 = torch.int32
_I64 = torch.int64


def _owner(rows, n_dev: int, rep):
    """Each row's owner rank, owner_hash % n_dev. On one rank every row's
    owner is 0, and the hash is not computed."""
    if n_dev == 1:
        return torch.zeros(rows[0].shape[0], dtype=_I64,
                           device=rows[0].device)
    return rep.owner_hash(rows) % n_dev


def _owned_dedupe_compact(rows, live, Nd: int, n_dev: int, my_idx: int,
                          rep):
    """Keep the rows this rank owns, deduplicate them by sort and compact
    them into a fresh [Nd] frontier -> (rows, live, count, overflow)."""
    owner = _owner(rows, n_dev, rep)
    return sp._dedupe_compact(rows, live & (owner == my_idx), Nd, rep)


def _lanes(buf, n: int, width: int, L: int):
    """Rows of L lanes and live flags of a received [n, L + 1, width]
    buffer."""
    v = buf.view(n, L + 1, width)
    return (tuple(v[:, k].reshape(-1) for k in range(L)),
            v[:, L].reshape(-1) != 0)


def _route_stage(rows, live, dest, n_dest: int, B: int, group):
    """One segmented all-to-all: deliver each live row to rank `dest`.
    Rows are ordered by destination with a stable sort (the dead ones
    last), each destination's bucket is cut to B rows, and bucket d goes
    to rank d. Returns the received rows [n_dest*B], their live flags and
    this rank's overflow flag (a bucket past B). Rows of L lanes and
    their flags travel as int32, in one [n_dest, L + 1, B] buffer."""
    L = live.shape[0]
    dev = live.device
    key = torch.where(live, dest.to(_I64), n_dest)
    key_s, order = torch.sort(key, stable=True)
    rows_s = sp._rows_take(rows, order)
    starts = torch.searchsorted(key_s, torch.arange(n_dest, device=dev))
    rank = torch.arange(L, device=dev) - starts[key_s.clamp(0, n_dest - 1)]
    routed = key_s < n_dest
    in_bucket = routed & (rank < B)
    ovf = (routed & (rank >= B)).any()
    # lane k of row (d, rank) at d*W + k*B + rank, W = (L + 1) B; the
    # rest drop into the one slot past the buffer
    n_lanes = len(rows) + 1
    size = n_dest * n_lanes * B
    at = key_s * (n_lanes * B) + rank
    send = torch.zeros(size + 1, dtype=_I32, device=dev)
    for k, lane in enumerate((*rows_s, in_bucket.to(_I32))):
        send[torch.where(in_bucket, at + k * B, size)] = lane
    recv = torch.empty(size, dtype=_I32, device=dev)
    dist.all_to_all_single(recv, send[:size], group=group)
    c_rows, c_live = _lanes(recv, n_dest, B, len(rows))
    return c_rows, c_live, ovf


def _route_to_owners(rows, live, n_dev: int, B: int, rep, group):
    """Flat owner routing over the 1-D mesh: dest = owner hash % n_dev."""
    return _route_stage(rows, live, _owner(rows, n_dev, rep), n_dev, B,
                        group)


def _route2(rows, live, plan: MeshPlan, B1: int, B2: int, rep):
    """The hierarchical route: stage 1 to the owner's chip column over
    this rank's chip group, stage 2 across slices over its slice group,
    the owner hashed again on what stage 1 delivered."""
    D, n_chip = plan.n_dev, plan.n_chip
    owner = rep.owner_hash(rows) % D
    rows, live, o1 = _route_stage(rows, live, owner % n_chip, n_chip, B1,
                                  plan.chip_group)
    owner = rep.owner_hash(rows) % D
    rows, live, o2 = _route_stage(rows, live, owner // n_chip,
                                  plan.n_slice, B2, plan.slice_group)
    return rows, live, o1 | o2


def _gather(rows, live, n_dev: int, group):
    """The A/B exchange: every rank receives every rank's rows, in rank
    order [n_dev * L]. Never overflows."""
    n = live.shape[0]
    send = torch.stack([*rows, live.to(_I32)])
    recv = torch.empty(n_dev * send.numel(), dtype=_I32, device=live.device)
    dist.all_gather_into_tensor(recv, send.reshape(-1), group=group)
    c_rows, c_live = _lanes(recv, n_dev, n, len(rows))
    return c_rows, c_live, torch.zeros((), dtype=torch.bool,
                                       device=live.device)


def _flat_routes(Nd: int, C: int, n_dev: int):
    """(B_cand, B_front): the owner-bucket widths of the candidate and
    the frontier routes, twice the uniform share, at least 64."""
    return max(64, -(-2 * Nd * C // n_dev)), max(64, -(-2 * Nd // n_dev))


def _hier_routes(Nd: int, C: int, n_slice: int, n_chip: int):
    """((B1c, B2c), (B1f, B2f)): the hierarchical route's bucket widths of
    the candidates and the frontier, twice the uniform share at each
    stage; stage 2's input is stage 1's receive buffer (n_chip * B1)."""
    B1c = max(64, -(-2 * Nd * C // n_chip))
    B2c = max(64, -(-2 * n_chip * B1c // n_slice))
    B1f = max(64, -(-2 * Nd // n_chip))
    B2f = max(64, -(-2 * n_chip * B1f // n_slice))
    return (B1c, B2c), (B1f, B2f)


class _ShardedScan:
    """One rank's scan of one history at per-rank capacity Nd. The
    frontier stays on the device; the scalars the loops decide on come
    back all-reduced and live on the host: ok, fail_r, max-frontier,
    configs-stepped and the overflow flag.
    `start()` seeds the initial configuration; `restore(cp)` starts from
    a checkpoint's rows instead. With `stats` each event appends its
    stats to `traj` (this rank's width and peak, the global iterations,
    stepped and swork) and the probe histogram to `phist`."""

    def __init__(self, e: EncodedHistory, Nd: int, plan: MeshPlan,
                 exchange: str, dedupe: str, probe_limit: int, xs: dict,
                 pack=(), stats: bool = False):
        C = e.slot_f.shape[1]
        dev = plan.device
        self.e, self.Nd, self.C = e, Nd, C
        self.Td = sp._next_pow2(2 * Nd)
        self.plan, self.exchange, self.dedupe = plan, exchange, dedupe
        self.probe_limit = probe_limit
        self.device = dev
        self.rep = sp._rep(pack, C, dev)
        self.step = STEPS[e.step_name]
        self.xs = xs
        if plan.hierarchical:
            self.B_cand, self.B_front = _hier_routes(Nd, C, plan.n_slice,
                                                     plan.n_chip)
        else:
            self.B_cand, self.B_front = _flat_routes(Nd, C, plan.n_dev)
        self.row = torch.arange(Nd, device=dev)
        self.stats = stats
        self.traj: list = []
        self.phist = torch.zeros(st.N_PROBE_BUCKETS, dtype=_I64, device=dev)
        self.ok, self.overflow = True, False
        self.fail_r, self.maxf, self.stepped = -1, 1, 0

    # ------------------------------------------------------ collectives

    def _reduce(self, vals, *local):
        """All-reduce (sum) the int64 values `vals` over the mesh and read
        them on the host, with this rank's `local` device scalars."""
        g = torch.stack([v.to(_I64) for v in vals])
        dist.all_reduce(g, group=self.plan.group)
        if local:
            g = torch.cat([g, torch.stack([v.to(_I64) for v in local])])
        return g.tolist()

    def _exchange(self, rows, live, B):
        plan = self.plan
        if self.exchange == "gather":
            return _gather(rows, live, plan.n_dev, plan.group)
        if plan.hierarchical:
            return _route2(rows, live, plan, B[0], B[1], self.rep)
        return _route_to_owners(rows, live, plan.n_dev, B, self.rep,
                                plan.group)

    def _owned(self, rows, live):
        return _owned_dedupe_compact(rows, live, self.Nd, self.plan.n_dev,
                                     self.plan.my_idx, self.rep)

    def _insert(self, c_rows, c_live, f_rows, count, table):
        """One visited-set transaction: K3 (or its plain version on the
        CPU); with stats on the CPU the plain insert, whose probe
        histogram adds to `phist` (K3's offsets never leave the
        kernel)."""
        if self.stats and self.device.type == "cpu":
            out = sp._hash_insert_append(c_rows, c_live, f_rows, count,
                                         table, self.probe_limit, self.Nd,
                                         sp._RowLayout(), stats=True)
            self.phist += out[5]
            return out[:5]
        return sk.hash_insert(c_rows, c_live, f_rows, count, table,
                              self.probe_limit, self.Nd)

    # ---------------------------------------------------------- closure

    def _candidates(self, ev, rows, lo: int, hi: int):
        """The candidates of rows [lo, hi) (index n*C + j) and their legal
        flags. The routed exchange steps only those rows; the gather
        exchange steps all Nd, since every rank must send as many."""
        if self.exchange == "route":
            rows = tuple(r[lo:hi] for r in rows)
            among = None
        else:
            among = (self.row >= lo) & (self.row < hi)
        cand_st, cand_ok = self.step(self.rep.state(rows)[:, None],
                                     ev["slot_f"], ev["slot_a0"],
                                     ev["slot_a1"], ev["slot_wild"])
        legal = ev["slot_occ"][None, :] & ~self.rep.mask_test(rows) & cand_ok
        if among is not None:
            legal = legal & among[:, None]
        return self.rep.candidates(rows, cand_st), legal.reshape(-1)

    def _sort_closure(self, ev, rows, live, count: int):
        """-> (rows2, live2, count2, ovf, stepped, iters, swork) with the
        sort dedupe; the frontier is always compacted, so live is the
        prefix [0, count)."""
        changed, ovf, stepped, iters = True, False, 0, 0
        while changed and not ovf:
            cands, legal = self._candidates(ev, rows, 0, count)
            c_rows, c_live, route_ovf = self._exchange(cands, legal,
                                                       self.B_cand)
            old = live.sum()
            rows, live, cnt, d_ovf = self._owned(
                sp._rows_concat(rows, c_rows), torch.cat([live, c_live]))
            old_n, new_n, g_ovf, count = self._reduce(
                (old, cnt, d_ovf | route_ovf), cnt)
            changed, ovf = new_n > old_n, g_ovf > 0
            stepped += old_n
            iters += 1
        return rows, live, count, ovf, stepped, iters, stepped

    def _hash_closure(self, ev, rows, live):
        """-> (rows2, live2, count2, ovf, stepped, iters, swork) with the
        delta-frontier closure over this rank's visited set: seed it with
        the frontier (compacting it), then expand only the rows the last
        iteration appended, until no rank finds a fresh row. swork is the
        global frontier summed over the iterations (what a sort closure
        would have stepped)."""
        Nd, rep = self.Nd, self.rep
        zero = torch.zeros((), dtype=_I32, device=self.device)
        rows, table, count_t, _, p0 = self._insert(
            rows, live, rep.zeros(Nd), zero, sp._empty_table(self.Td, rep))
        g_p0, g_count, count = self._reduce((p0, count_t), count_t)
        n_old, ovf, stepped, changed = 0, g_p0 > 0, 0, True
        iters = swork = 0
        while changed and not ovf:
            cands, legal = self._candidates(ev, rows, n_old, count)
            c_rows, c_live, route_ovf = self._exchange(cands, legal,
                                                       self.B_cand)
            # the gather exchange hands every rank every candidate: each
            # inserts only what it owns, so the tables stay a partition
            # (the routed exchange delivered only owned rows)
            if self.exchange == "gather":
                owner = _owner(c_rows, self.plan.n_dev, rep)
                c_live = c_live & (owner == self.plan.my_idx)
            delta = torch.full((), count - n_old, dtype=_I64,
                               device=self.device)
            rows, table, count_t, n_fresh, ins_ovf = self._insert(
                c_rows, c_live, rows, count_t, table)
            g_new, g_ovf, g_delta, g_count2, count2 = self._reduce(
                (n_fresh, ins_ovf | route_ovf, delta, count_t), count_t)
            swork += g_count
            n_old, count, g_count = count, count2, g_count2
            changed, ovf = g_new > 0, g_ovf > 0
            stepped += g_delta
            iters += 1
        return rows, self.row < count, count, ovf, stepped, iters, swork

    # ------------------------------------------------------------- scan

    def start(self):
        """The initial carry: the initial configuration on its owner
        rank."""
        e, plan, rep = self.e, self.plan, self.rep
        self.rows = rep.initial_at0(e.state0, self.Nd)
        owner0 = _owner(tuple(r[:1] for r in self.rows), plan.n_dev, rep)
        self.live = (self.row < 1) & (owner0 == plan.my_idx)
        self.count = int(self.live.sum())
        return self

    def restore(self, cp) -> bool:
        """Start from checkpoint `cp` (global capacity n_dev * Nd): place
        the rows of this rank's shard, then route every live row to its
        owner on this plan, with buckets for the worst skew (a shard may
        all belong to one rank): Nd rows, and n_chip * Nd at a
        hierarchical plan's second stage. -> whether that overflowed,
        over the mesh."""
        plan, Nd = self.plan, self.Nd
        sl = slice(plan.my_idx * Nd, (plan.my_idx + 1) * Nd)
        rows = sp._rows_from_canonical(self.rep.pack, self.C, cp.st[sl],
                                       cp.ml[sl], cp.mh[sl], self.device)
        live = torch.from_numpy(np.asarray(cp.live[sl], bool).copy()).to(
            self.device)
        if plan.hierarchical:
            r_rows, r_live, rt_ovf = _route2(rows, live, plan, Nd,
                                             plan.n_chip * Nd, self.rep)
        else:
            r_rows, r_live, rt_ovf = _route_to_owners(
                rows, live, plan.n_dev, Nd, self.rep, plan.group)
        self.rows, self.live, cnt, d_ovf = self._owned(r_rows, r_live)
        g_ovf, self.count = self._reduce((rt_ovf | d_ovf,), cnt)
        self.ok, self.fail_r = bool(cp.ok), int(cp.fail_r)
        self.maxf, self.stepped = int(cp.maxf), int(cp.stepped)
        self.overflow = g_ovf > 0
        return self.overflow

    def run_range(self, lo: int, hi: int):
        """Scan return events [lo, hi): each event's closure, its filter
        and the survivors' re-route. Stops at the first event that
        fails or overflows (every rank reads the same all-reduced
        flags); a checkpoint after it is at `hi` either way, as the
        reference's scan counts every event of the chunk."""
        e, rep = self.e, self.rep
        rows, live, count = self.rows, self.live, self.count
        for r in range(lo, hi):
            if not self.ok:
                break
            ev = {k: v[r] for k, v in self.xs.items()}
            if self.dedupe == "sort":
                rows2, live2, count, ovf, d, iters, swork = \
                    self._sort_closure(ev, rows, live, count)
            else:
                rows2, live2, count, ovf, d, iters, swork = \
                    self._hash_closure(ev, rows, live)
            self.stepped += d
            bits = rep.event_bits(int(e.ev_slot[r]))
            live3 = live2 & rep.has_event_bit(rows2, bits)
            rows3 = rep.clear_event_bit(rows2, bits, live3)
            n_live, n_front = live3.sum(), live2.sum()
            # clearing the slot bit moved every survivor's owner: route
            # each to its new owner before the next closure
            hi_r = count if self.exchange == "route" else self.Nd
            r_rows, r_live, rt_ovf = self._exchange(
                tuple(x[:hi_r] for x in rows3), live3[:hi_r], self.B_front)
            rows, live, cnt, r_ovf = self._owned(r_rows, r_live)
            g_live, g_front, g_ovf, count, l_front = self._reduce(
                (n_live, n_front, r_ovf | rt_ovf), cnt, n_front)
            ovf = ovf or g_ovf > 0
            failed_here = g_live == 0
            if failed_here and self.fail_r < 0:
                self.fail_r = r
            self.ok = not failed_here and not ovf
            self.maxf = max(self.maxf, g_front)
            self.overflow = self.overflow or ovf
            if self.stats:
                # this rank's width after the re-route, and its peak
                self.traj.append((count, l_front, iters, d, swork))
        self.rows, self.live, self.count = rows, live, count
        return self

    def result(self):
        """-> (valid, fail_r, overflow, max-frontier, configs-stepped)."""
        (g_live,) = self._reduce((self.live.sum(),))
        valid = self.ok and g_live > 0 and not self.overflow
        return valid, self.fail_r, self.overflow, self.maxf, self.stepped

    def gather(self):
        """The global frontier on the host, every rank's shard in rank
        order (the reference's sharded carry read whole): the canonical
        (st, ml, mh) and live arrays of n_dev * Nd rows."""
        L = len(self.rows)
        send = torch.stack([*self.rows, self.live.to(_I32)])
        recv = torch.empty(self.plan.n_dev * send.numel(), dtype=_I32,
                           device=self.device)
        dist.all_gather_into_tensor(recv, send.reshape(-1),
                                    group=self.plan.group)
        lanes, live = _lanes(recv, self.plan.n_dev, self.Nd, L)
        st_, ml, mh = sp.carry_fields_np(lanes, self.rep.pack, self.C)
        return st_, ml, mh, live.cpu().numpy()

    def stats_traj(self) -> dict:
        """Every rank's per-event stats of the events this scan ran:
        {"width", "peak"} [n_dev, R'] (each rank's own), {"iters",
        "stepped", "swork"} [R'] (global) and "hist" [7], the probe
        histogram summed over the ranks and events."""
        mine = ([t[0] for t in self.traj], [t[1] for t in self.traj])
        every = [None] * self.plan.n_dev
        dist.all_gather_object(every, mine, group=self.plan.group)
        hist = self.phist.clone()
        dist.all_reduce(hist, group=self.plan.group)
        return {"width": np.asarray([w for w, _ in every], np.int64),
                "peak": np.asarray([p for _, p in every], np.int64),
                "iters": [t[2] for t in self.traj],
                "stepped": [t[3] for t in self.traj],
                "swork": [t[4] for t in self.traj],
                "hist": hist.cpu().numpy()}


def _sharded_stats_block(ys: dict, N: int, Nd: int, n_dev: int,
                         dedupe: str, n_esc: int) -> dict:
    """The sharded search-stats block (the reference's
    `_sharded_stats_block`): mesh-reduced trajectories (the global width
    and peak of each event, summed over the ranks) plus the per-rank
    variants a skew question needs."""
    width, peak = ys["width"], ys["peak"]
    R = width.shape[1] if width.ndim == 2 else 0
    g_width = width.sum(axis=0) if R else np.zeros(0, np.int64)
    g_peak = peak.sum(axis=0) if R else np.zeros(0, np.int64)
    frontier_peak = int(g_peak.max()) if R else 0
    stepped_total = int(sum(ys["stepped"]))
    swork_total = int(sum(ys["swork"]))
    block = {
        "engine": "sharded",
        "events": R,
        "frontier-width": [int(x) for x in g_width],
        "closure-iters": [int(x) for x in ys["iters"]],
        "configs-stepped-per-event": [int(x) for x in ys["stepped"]],
        "closure-peak": [int(x) for x in g_peak],
        "frontier-peak": frontier_peak,
        "capacity": N,
        "capacity-tier": n_esc,
        "peak-occupancy": round(frontier_peak / N, 6) if N else None,
        "dedupe": dedupe,
        "devices": n_dev,
        "delta-split-ratio": (round(stepped_total / swork_total, 6)
                              if swork_total else None),
        "table-capacity": None,
        "load-factor-peak": None,
        "load-factor-final": None,
        "probe-hist": None,
        "probes": None,
        "per-device": {
            "width-peak": [int(width[d].max()) if R else 0
                           for d in range(n_dev)],
        },
    }
    if dedupe == "hash":
        Td = sp._next_pow2(2 * Nd)
        dev_peak = [int(peak[d].max()) if R else 0 for d in range(n_dev)]
        block["table-capacity"] = Td * n_dev   # the union of the tables
        block["per-device"]["table-capacity"] = Td
        block["per-device"]["load-factor-peak"] = [
            round(p / Td, 6) for p in dev_peak]
        block["load-factor-peak"] = (round(max(dev_peak) / Td, 6)
                                     if dev_peak else None)
        if R:
            block["load-factor-final"] = round(int(peak[:, -1].max()) / Td,
                                               6)
        hist = np.asarray(ys["hist"], np.int64)
        block["probe-hist"] = {lab: int(n) for lab, n in
                               zip(st.PROBE_HIST_LABELS, hist)}
        block["probes"] = int(hist.sum())
    return block


def check_encoded_sharded(e: EncodedHistory, mesh, capacity: int = 8192,
                          max_capacity: int = 1 << 22,
                          exchange: str = "route", dedupe=None,
                          probe_limit: int = 0, search_stats=None,
                          config_pack=None, reshard=None) -> dict:
    """Check one encoded history with its frontier sharded over `mesh`, a
    `torch.distributed` DeviceMesh (`meshplan.local_mesh()` for this
    process alone), with the result schema of the reference's
    `check_encoded_sharded`. Every rank of the mesh calls it with the
    same arguments and gets the same result.

    A 2-D mesh with both dims > 1 under exchange="route" runs the
    hierarchical exchange and the result carries "mesh"; any other mesh
    is flattened. `capacity` is the global frontier capacity, at least
    64 per rank; it doubles on overflow (a frontier, a bucket or — under
    hash dedupe — a probe run past its bound) up to `max_capacity`,
    past which the verdict is "unknown". `dedupe` is "hash" (default;
    JEPSEN_TPU_TORCH_DEDUPE) or "sort"; under "hash" each iteration's
    visited-set transaction is K3 on a card ("closure": "cuda"), the
    plain PyTorch insert on the CPU ("torch"). `probe_limit` bounds the
    hash probes (0: JEPSEN_TPU_TORCH_PROBE_LIMIT, default 32).
    `config_pack` (None: JEPSEN_TPU_TORCH_CONFIG_PACK, default off)
    carries the rows as the packed word of `sparse.pack_spec_for(e)` and
    tags the result's "config-pack". `search_stats` (None:
    JEPSEN_TPU_TORCH_SEARCH_STATS) adds the sharded "stats" block.
    `reshard` (None: JEPSEN_TPU_TORCH_RESHARD) hands a routed check over
    more than one rank to the elastic ladder
    (`check_encoded_sharded_elastic`)."""
    if e.n_returns == 0:
        return {"valid?": True, "max-frontier": 0, "capacity": 0}
    plan = MeshPlan.from_mesh(mesh, exchange)
    if engine._resolve_reshard(reshard) and exchange == "route" \
            and plan.n_dev > 1:
        return check_encoded_sharded_elastic(
            e, mesh, capacity=capacity, max_capacity=max_capacity,
            dedupe=dedupe, probe_limit=probe_limit,
            search_stats=search_stats, config_pack=config_pack)
    dedupe = sp._resolve_dedupe(dedupe)
    probe_limit = sp._resolve_probe_limit(probe_limit)
    ss = st._resolve_search_stats(search_stats)
    pack_req = sp._resolve_config_pack(config_pack)
    pack = sp.pack_spec_for(e) if pack_req else ()
    n_dev = plan.n_dev
    xs = sp._xs(e, plan.device)
    tag = sp._closure_tag(dedupe, plan.device)
    N = max(64 * n_dev, capacity)
    n_esc = 0
    t0 = perf_counter()
    with obs.span("sharded.search", devices=n_dev, dedupe=dedupe,
                  returns=e.n_returns) as span:
        while True:
            Nd = -(-N // n_dev)
            # one span a capacity tier: the ladder renders as widening
            # steps in the trace
            with obs.span("sharded.tier", capacity=N, per_device=Nd), \
                    obs.device_annotation(f"sharded N{N} D{n_dev}"):
                scan = _ShardedScan(e, Nd, plan, exchange, dedupe,
                                    probe_limit, xs, pack, stats=ss).start()
                valid, fail_r, overflow, maxf, stepped = scan.run_range(
                    0, e.n_returns).result()
            if not overflow:
                break
            if N * 2 > max_capacity:
                return {"valid?": "unknown",
                        "error": f"frontier overflow at capacity {N}",
                        "capacity": N, "dedupe": dedupe, "closure": tag}
            N *= 2
            n_esc += 1
            obs.counter("engine.capacity_escalations").inc()
        span.set(capacity=N)
        if tag.startswith("cuda"):
            # only when a kernel ran: the plain run's trace schema is
            # the reference's with its kernel off
            span.set(closure=tag)
    obs.counter("engine.configs_stepped").inc(int(stepped))
    out = {"valid?": valid, "max-frontier": maxf, "capacity": N,
           "devices": n_dev, "dedupe": dedupe, "configs-stepped": stepped,
           "closure": tag}
    if ss:
        out["stats"] = st.finish_stats_block(
            _sharded_stats_block(scan.stats_traj(), N, Nd, n_dev, dedupe,
                                 n_esc), t0, perf_counter())
    sp._tag_config_pack(out, pack, pack_req, e.slot_f.shape[1])
    if plan.hierarchical:
        out["mesh"] = f"{plan.n_slice}x{plan.n_chip} (hierarchical exchange)"
    if not valid:
        out.update(fail_op_fields(e, fail_r))
    return out


# ------------------------------------------------ resumable and elastic

def _fresh_checkpoint(e: EncodedHistory, N: int, digest: str):
    """The reference's sharded starting checkpoint: capacity N, the
    initial state in every row, row 0 live."""
    return engine.FrontierCheckpoint(
        0, N, e.step_name, digest, np.full(N, e.state0, np.int32),
        np.zeros(N, np.uint32), np.zeros(N, np.uint32), np.arange(N) < 1,
        True, -1, 1, 0)


def _run_chunk(e: EncodedHistory, plan: MeshPlan, cp, lo: int, hi: int,
               dedupe: str, probe_limit: int, xs: dict, pack):
    """Return events [lo, hi) from checkpoint `cp` on the ranks of `plan`
    (global capacity cp.capacity, a multiple of the ranks) -> (the
    checkpoint after them, or None, and whether the chunk — its restore
    route included — overflowed). Every rank of `plan` calls it."""
    Nd = cp.capacity // plan.n_dev
    scan = _ShardedScan(e, Nd, plan, "route", dedupe, probe_limit, xs, pack)
    if scan.restore(cp):
        return None, True
    scan.run_range(lo, hi)
    if scan.overflow:
        return None, True
    st_, ml, mh, live = scan.gather()
    return engine.FrontierCheckpoint(
        hi, cp.capacity, e.step_name, cp.history_digest, st_, ml, mh, live,
        scan.ok, scan.fail_r, scan.maxf, cp.steps_n, scan.stepped), False


def _final(e: EncodedHistory, cp, n_dev: int, dedupe: str, tag: str,
           pack, pack_req: bool) -> dict:
    out = {"valid?": cp.ok and bool(cp.live.any()),
           "max-frontier": cp.maxf, "capacity": cp.capacity,
           "devices": n_dev, "dedupe": dedupe,
           "configs-stepped": cp.stepped, "closure": tag}
    sp._tag_config_pack(out, pack, pack_req, e.slot_f.shape[1])
    if not out["valid?"]:
        out.update(fail_op_fields(e, cp.fail_r))
    return out


def check_encoded_sharded_resumable(e: EncodedHistory, mesh,
                                    capacity: int = 8192,
                                    max_capacity: int = 1 << 22,
                                    checkpoint_every: int = 256,
                                    checkpoint_cb=None, resume=None,
                                    dedupe=None, probe_limit: int = 0,
                                    config_pack=None) -> dict:
    """`check_encoded_sharded` in chunks of `checkpoint_every` return
    events, with a checkpoint after each (the reference's
    `check_encoded_sharded_resumable`): the global frontier is gathered
    to the host as an `engine.FrontierCheckpoint` and handed to
    `checkpoint_cb`. It is topology-independent — `capacity` is global,
    the rows unsharded — and a resume routes every row to its owner on
    the current mesh, so a search checkpointed on D ranks resumes on any
    other count. An overflow inside a chunk (the restore's route too)
    runs the chunk again at twice the capacity; past `max_capacity` the
    verdict is "unknown" with the checkpoint before the chunk under
    "checkpoint". A 2-D mesh is flattened (with a warning): this arm
    runs the flat exchange. The .npz of a checkpoint is the reference's.

    A device fault is not retried and not resumed on the host: the
    error raised inside a chunk gets `.checkpoint`, the checkpoint before
    the chunk, and surfaces to the caller."""
    if e.n_returns == 0:
        return {"valid?": True, "max-frontier": 0, "capacity": 0}
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every={checkpoint_every} must be "
                         f">= 1")
    plan = MeshPlan.from_mesh(mesh, "route")
    if plan.hierarchical:
        _log.warning(
            "resumable sharded check flattens the 2-D mesh to the flat "
            "1-D exchange — the hierarchical multi-slice routing of "
            "check_encoded_sharded is not used on this path")
        plan = MeshPlan(plan.ranks.reshape(-1), plan.device_type)
    n_dev = plan.n_dev
    dedupe = sp._resolve_dedupe(dedupe)
    probe_limit = sp._resolve_probe_limit(probe_limit)
    pack_req = sp._resolve_config_pack(config_pack)
    pack = sp.pack_spec_for(e) if pack_req else ()
    digest = engine.history_digest(e)
    if resume is not None:
        engine.check_resume(e, resume, digest)
        cp = resume
    else:
        cp = _fresh_checkpoint(e, max(64 * n_dev, capacity), digest)
    xs = sp._xs(e, plan.device)
    tag = sp._closure_tag(dedupe, plan.device)
    R = e.n_returns
    while cp.event_index < R and cp.ok:
        # the global capacity must divide the ranks: a checkpoint from
        # another topology grows to the next multiple
        N = -(-cp.capacity // n_dev) * n_dev
        if N != cp.capacity:
            cp = cp.grown(N)
        lo, hi = cp.event_index, min(R, cp.event_index + checkpoint_every)
        try:
            cp2, overflow = _run_chunk(e, plan, cp, lo, hi, dedupe,
                                       probe_limit, xs, pack)
        except Exception as err:
            err.checkpoint = cp
            raise
        if overflow:
            if N * 2 > max_capacity:
                return {"valid?": "unknown",
                        "error": f"frontier overflow at capacity {N}",
                        "capacity": N, "devices": n_dev, "dedupe": dedupe,
                        "closure": tag, "checkpoint": cp}
            cp = cp.grown(N * 2)       # N more dead rows
            continue                   # the same chunk again
        cp = cp2
        if checkpoint_cb is not None:
            checkpoint_cb(cp)
    return _final(e, cp, n_dev, dedupe, tag, pack, pack_req)


def check_encoded_sharded_elastic(e: EncodedHistory, mesh,
                                  capacity: int = 8192,
                                  max_capacity: int = 1 << 22,
                                  start_devices: int = 0,
                                  checkpoint_every: int = 256,
                                  dedupe=None, probe_limit: int = 0,
                                  search_stats=None,
                                  config_pack=None) -> dict:
    """The sharded search with the elastic capacity ladder (the
    reference's `check_encoded_sharded_elastic`, JEPSEN_TPU_TORCH_RESHARD):
    it starts on the first `start_devices` ranks (0: two, or one on a
    one-rank mesh) and each overflow first recruits the next rung of
    `MeshPlan.ladder` — wider 1-D within the first slice, then whole
    slices through the hierarchical exchange — holding the per-rank
    capacity flat; only on the full mesh does the capacity double, up
    to `max_capacity` ("unknown" past it, with "checkpoint").

    It runs in chunks of `checkpoint_every` events, as the resumable
    arm: a recruited rung runs the overflowing chunk again from the
    checkpoint before it, whose restore route spreads the rows over the
    wider rung. Ranks outside the current rung do not compute: after
    each chunk the rung's first rank broadcasts its checkpoint and
    overflow flag over the whole mesh, so every rank returns the same
    result: the verdict fields of `check_encoded_sharded` plus
    "reshard" ({"start-devices", "events": [{"event", "devices": [from,
    to], "capacity"}, ...]}). `search_stats` is accepted and ignored, as
    in the reference."""
    if e.n_returns == 0:
        return {"valid?": True, "max-frontier": 0, "capacity": 0}
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every={checkpoint_every} must be "
                         f">= 1")
    del search_stats   # no stats on the chunked arms
    dedupe = sp._resolve_dedupe(dedupe)
    probe_limit = sp._resolve_probe_limit(probe_limit)
    pack_req = sp._resolve_config_pack(config_pack)
    pack = sp.pack_spec_for(e) if pack_req else ()
    plan_full = MeshPlan.from_mesh(mesh, "route")
    if start_devices <= 0:
        start_devices = min(2, plan_full.n_dev)
    rungs = plan_full.ladder(start_devices)
    rung = 0
    n_dev = rungs[0].n_dev
    # per-rank capacity held flat across the recruiting rungs: the
    # global capacity of a rung is Nd0 times its ranks
    Nd0 = -(-max(64, capacity) // n_dev)
    N = Nd0 * n_dev
    digest = engine.history_digest(e)
    cp = _fresh_checkpoint(e, N, digest)
    xs = sp._xs(e, plan_full.device)
    tag = sp._closure_tag(dedupe, plan_full.device)
    events: list = []
    R = e.n_returns
    reshard = {"start-devices": start_devices, "events": events}
    with obs.span("sharded.elastic", devices=plan_full.n_dev,
                  dedupe=dedupe, returns=R) as span:
        while cp.event_index < R and cp.ok:
            plan = rungs[rung]
            n_dev = plan.n_dev
            lo = cp.event_index
            hi = min(R, lo + checkpoint_every)
            got = None
            if plan.member:
                try:
                    got = _run_chunk(e, plan, cp, lo, hi, dedupe,
                                     probe_limit, xs, pack)
                except Exception as err:
                    err.checkpoint = cp
                    raise
            if n_dev < plan_full.n_dev:
                # the ranks outside the rung wait for its result
                box = [got]
                dist.broadcast_object_list(
                    box, src=int(plan.ranks.flat[0]),
                    group=plan_full.group)
                got = box[0]
            cp2, overflow = got
            if overflow:
                if rung + 1 < len(rungs):
                    rung += 1
                    new_n = rungs[rung].n_dev
                    N = Nd0 * new_n
                    events.append({"event": cp.event_index,
                                   "devices": [n_dev, new_n],
                                   "capacity": N})
                    obs.counter("engine.reshard_escalations").inc()
                    if N > cp.capacity:
                        cp = cp.grown(N)
                    continue
                # the whole mesh is recruited: the table doubles
                if N * 2 > max_capacity:
                    return {"valid?": "unknown",
                            "error": f"frontier overflow at capacity {N}",
                            "capacity": N, "devices": n_dev,
                            "dedupe": dedupe, "closure": tag,
                            "checkpoint": cp, "reshard": reshard}
                Nd0 *= 2
                N *= 2
                obs.counter("engine.capacity_escalations").inc()
                cp = cp.grown(N)
                continue
            cp = cp2
        span.set(capacity=N, devices=n_dev)
    obs.counter("engine.configs_stepped").inc(int(cp.stepped))
    out = _final(e, cp, n_dev, dedupe, tag, pack, pack_req)
    out["reshard"] = reshard
    return out


def analysis(model, history, mesh, capacity: int = 8192,
             max_capacity: int = 1 << 22, exchange: str = "route",
             dedupe=None, search_stats=None, config_pack=None) -> dict:
    """knossos-style (model, history) -> result with the frontier sharded
    over `mesh`. A history the encoder cannot pack goes to the host WGL
    search with a `fallback` note; an invalid one gets its
    counterexample paths from `engine.apply_final_paths` on this rank's
    device (the sharded union is the single-device frontier). A device
    or collective fault surfaces to the caller."""
    h = history if isinstance(history, History) else History.wrap(history)
    try:
        e = enc_mod.encode(model, h)
    except enc_mod.EncodeError as err:
        obs.counter("engine.host_fallbacks").inc()
        _log.warning(
            "history not device-checkable (%s) — using the host WGL "
            "engine; expect it to be orders of magnitude slower", err)
        r = wgl.analysis(model, h)
        r["fallback"] = str(err)
        return r
    r = check_encoded_sharded(e, mesh, capacity=capacity,
                              max_capacity=max_capacity, exchange=exchange,
                              dedupe=dedupe, search_stats=search_stats,
                              config_pack=config_pack)
    if r["valid?"] is False:
        engine.apply_final_paths(r, model, e,
                                 device=MeshPlan.from_mesh(mesh).device)
    return r
