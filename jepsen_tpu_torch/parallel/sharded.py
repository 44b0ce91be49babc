"""Frontier-sharded linearizability search over a torch.distributed mesh.

A port of the flat 1-D part of `jepsen_tpu.parallel.sharded`: one
history's search frontier spread over the ranks of a mesh
(`parallel.meshplan`), the search the host knossos checker lacks.

  * Every configuration is owned by the rank `owner_hash(row) % n_dev`,
    so the union of the ranks' frontiers is the exact global set. Each
    rank holds at most Nd = ceil(N / n_dev) rows of the global capacity N.
  * The closure expands each rank's rows locally; the candidates travel
    to their owners by one all-to-all of equal buckets of B rows
    (`exchange="route"`, B twice the uniform share, a fuller bucket
    being an overflow) or by an all-gather of every candidate
    (`exchange="gather"`, the A/B path).
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
two-lane rows) and the exchange buffers carry its lanes, so a packed
row crosses the wire as 4 or 8 bytes and its live flag.

Not ported yet: the hierarchical 2-D exchange, the elastic re-shard
ladder, the resumable arm and the search-stats block.
"""

from __future__ import annotations

import logging

import torch
import torch.distributed as dist

from jepsen_tpu_torch.checker import wgl
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import encode as enc_mod
from jepsen_tpu_torch.parallel import engine
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


class _ShardedScan:
    """One rank's scan of one history at per-rank capacity Nd. The
    frontier stays on the device; the scalars the loops decide on come
    back all-reduced and live on the host."""

    def __init__(self, e: EncodedHistory, Nd: int, plan: MeshPlan,
                 exchange: str, dedupe: str, probe_limit: int, xs: dict,
                 pack=()):
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
        self.B_cand, self.B_front = _flat_routes(Nd, C, plan.n_dev)
        self.row = torch.arange(Nd, device=dev)

    # ------------------------------------------------------ collectives

    def _reduce(self, vals, *local):
        """All-reduce (sum) the int64 values `vals` over the mesh and read
        them on the host, with this rank's `local` device scalars."""
        g = torch.stack([v.to(_I64) for v in vals])
        dist.all_reduce(g, group=self.plan.group)
        if local:
            g = torch.cat([g, torch.stack([v.to(_I64) for v in local])])
        return g.tolist()

    def _exchange(self, rows, live, B: int):
        n_dev, group = self.plan.n_dev, self.plan.group
        if self.exchange == "gather":
            return _gather(rows, live, n_dev, group)
        return _route_to_owners(rows, live, n_dev, B, self.rep, group)

    def _owned(self, rows, live):
        return _owned_dedupe_compact(rows, live, self.Nd, self.plan.n_dev,
                                     self.plan.my_idx, self.rep)

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
        """-> (rows2, live2, count2, ovf, stepped) with the sort dedupe;
        the frontier is always compacted, so live is the prefix
        [0, count)."""
        changed, ovf, stepped = True, False, 0
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
        return rows, live, count, ovf, stepped

    def _hash_closure(self, ev, rows, live):
        """-> (rows2, live2, count2, ovf, stepped) with the delta-frontier
        closure over this rank's visited set: seed it with the frontier
        (compacting it), then expand only the rows the last iteration
        appended, until no rank finds a fresh row."""
        Nd, rep = self.Nd, self.rep
        zero = torch.zeros((), dtype=_I32, device=self.device)
        rows, table, count_t, _, p0 = sk.hash_insert(
            rows, live, rep.zeros(Nd), zero, sp._empty_table(self.Td, rep),
            self.probe_limit, Nd)
        g_p0, count = self._reduce((p0,), count_t)
        n_old, ovf, stepped, changed = 0, g_p0 > 0, 0, True
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
            rows, table, count_t, n_fresh, ins_ovf = sk.hash_insert(
                c_rows, c_live, rows, count_t, table, self.probe_limit, Nd)
            g_new, g_ovf, g_delta, count2 = self._reduce(
                (n_fresh, ins_ovf | route_ovf, delta), count_t)
            n_old, count = count, count2
            changed, ovf = g_new > 0, g_ovf > 0
            stepped += g_delta
        return rows, self.row < count, count, ovf, stepped

    # ------------------------------------------------------------- scan

    def run(self):
        """-> (valid, fail_r, overflow, max-frontier, configs-stepped)."""
        e, plan, rep, Nd = self.e, self.plan, self.rep, self.Nd
        rows = rep.initial_at0(e.state0, Nd)
        # the initial configuration lives on its owner rank
        owner0 = _owner(tuple(r[:1] for r in rows), plan.n_dev, rep)
        live = (self.row < 1) & (owner0 == plan.my_idx)
        count = int(live.sum())
        ok, overflow = True, False
        fail_r, maxf, stepped = -1, 1, 0
        for r in range(e.n_returns):
            if not ok:
                break   # every rank read the same all-reduced `ok`
            ev = {k: v[r] for k, v in self.xs.items()}
            if self.dedupe == "sort":
                rows2, live2, count, ovf, d = self._sort_closure(
                    ev, rows, live, count)
            else:
                rows2, live2, count, ovf, d = self._hash_closure(
                    ev, rows, live)
            stepped += d
            bits = rep.event_bits(int(e.ev_slot[r]))
            live3 = live2 & rep.has_event_bit(rows2, bits)
            rows3 = rep.clear_event_bit(rows2, bits, live3)
            n_live, n_front = live3.sum(), live2.sum()
            # clearing the slot bit moved every survivor's owner: route
            # each to its new owner before the next closure
            hi = count if self.exchange == "route" else Nd
            r_rows, r_live, rt_ovf = self._exchange(
                tuple(x[:hi] for x in rows3), live3[:hi], self.B_front)
            rows, live, cnt, r_ovf = self._owned(r_rows, r_live)
            g_live, g_front, g_ovf, count = self._reduce(
                (n_live, n_front, r_ovf | rt_ovf), cnt)
            ovf = ovf or g_ovf > 0
            failed_here = g_live == 0
            if failed_here and fail_r < 0:
                fail_r = r
            ok = not failed_here and not ovf
            maxf = max(maxf, g_front)
            overflow = overflow or ovf
        (g_live,) = self._reduce((live.sum(),))
        return ok and g_live > 0 and not overflow, fail_r, overflow, maxf, \
            stepped


def _flags_unported(**flags) -> None:
    for name, value in flags.items():
        if value:
            raise NotImplementedError(f"{name}=True: a later slice of the "
                                      f"port")


def check_encoded_sharded(e: EncodedHistory, mesh, capacity: int = 8192,
                          max_capacity: int = 1 << 22,
                          exchange: str = "route", dedupe=None,
                          probe_limit: int = 0, search_stats=None,
                          config_pack=None, reshard=None) -> dict:
    """Check one encoded history with its frontier sharded over `mesh`, a
    1-D `torch.distributed` DeviceMesh (`meshplan.local_mesh()` for this
    process alone), with the result schema of the reference's
    `check_encoded_sharded`. Every rank of the mesh calls it with the
    same arguments and gets the same result.

    `capacity` is the global frontier capacity, at least 64 per rank; it
    doubles on overflow (a frontier, a bucket or — under hash dedupe —
    a probe run past its bound) up to `max_capacity`, past which the
    verdict is "unknown". `dedupe` is "hash" (default;
    JEPSEN_TPU_TORCH_DEDUPE) or "sort"; under "hash" each iteration's
    visited-set transaction is K3 on a card ("closure": "cuda"), the
    plain PyTorch insert on the CPU ("torch"). `probe_limit` bounds the
    hash probes (0: JEPSEN_TPU_TORCH_PROBE_LIMIT, default 32).
    `config_pack` (None: JEPSEN_TPU_TORCH_CONFIG_PACK, default off)
    carries the rows as the packed word of `sparse.pack_spec_for(e)` and
    tags the result's "config-pack". `search_stats` and `reshard` are
    not ported yet."""
    _flags_unported(search_stats=search_stats, reshard=reshard)
    if e.n_returns == 0:
        return {"valid?": True, "max-frontier": 0, "capacity": 0}
    plan = MeshPlan.from_mesh(mesh, exchange)
    dedupe = sp._resolve_dedupe(dedupe)
    probe_limit = sp._resolve_probe_limit(probe_limit)
    pack_req = sp._resolve_config_pack(config_pack)
    pack = sp.pack_spec_for(e) if pack_req else ()
    n_dev = plan.n_dev
    xs = sp._xs(e, plan.device)
    tag = sp._closure_tag(dedupe, plan.device)
    N = max(64 * n_dev, capacity)
    while True:
        Nd = -(-N // n_dev)
        valid, fail_r, overflow, maxf, stepped = _ShardedScan(
            e, Nd, plan, exchange, dedupe, probe_limit, xs, pack).run()
        if not overflow:
            break
        if N * 2 > max_capacity:
            return {"valid?": "unknown",
                    "error": f"frontier overflow at capacity {N}",
                    "capacity": N, "dedupe": dedupe, "closure": tag}
        N *= 2
    out = {"valid?": valid, "max-frontier": maxf, "capacity": N,
           "devices": n_dev, "dedupe": dedupe, "configs-stepped": stepped,
           "closure": tag}
    sp._tag_config_pack(out, pack, pack_req, e.slot_f.shape[1])
    if not valid:
        out.update(fail_op_fields(e, fail_r))
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
