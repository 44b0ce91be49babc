"""Side-by-side timing of the kernels of jepsen_tpu_torch (K1 to K4) on
one NVIDIA GPU, for comparing two trees of the port (say a commit and
its parent) on the same inputs in one run.

    python3 kernel_ab.py [--tree DIR] record [--out FILE]
                                      [--kernels k1,k2,k3,k4,k2b,k4b,k1b]
    python3 kernel_ab.py [--tree DIR] time [--inputs FILE]
    python3 kernel_ab.py [--tree DIR] walls [--sparse-batch | --dense-batch]

`--tree DIR` imports `jepsen_tpu_torch` from DIR (a checkout, or a
`git archive` of another commit unpacked into a directory that
.gitignore lists) instead of this one; its kernels build into DIR's own
build directory.

  record  runs the checks whose kernel inputs the timings use and saves
          those inputs with torch.save (default build/kernel_ab_inputs.pt):
          K1 at S=18 C=13 (every 50th closure of the 10k-op adversarial
          register history, 200 in all) and at S=22 C=17 (every 5th of the
          1k-op history with 16 crashed writes); K2 on every 10th event of
          the 400-op unordered-queue history (40 at most, N=1,024, C=8);
          K3 at T=262,144 (the last expansion inserts of a 300-op
          adversarial register history, the 10k-op one's shape, sharded
          at capacity 2^17 on a one-rank mesh as the bench's sharded
          section starts) and at T=1,024 (a 60-op register history's);
          K4 on every 97th expansion insert of the 1000-op FIFO history's
          capacity-32,768 tier (T=65,536, M=393,216; 6 at most), as
          chip_smoke.py records them; batched K2 (k2b) on the 28-key
          sparse batch of chip_smoke.py, triple, packed and with stats,
          by shape (60 rows a shape at most), and batched K4 (k4b) on
          its every 97th expansion insert a shape (4 at most), triple
          and packed; the batched dense scan (k1b) on every chunk of
          event rows of chip_smoke.py's 84-key and 92-key batches, as
          `bitdense._BatchScan.run` builds it: the chunk's selects, the
          carry (B, ok, fail_r) at its start, its rows' returning slots
          and run flags, and r0;
  time    loads them and times each kernel through its wrapper
          (`closure_kernels.closure_fixpoint`, `sparse_kernels.
          frontier_closure`, `hash_insert`, `tiled_insert`) with CUDA
          events, the mean per launch. K1 also gets the host's cost of a
          launch (run=False: the kernel returns at once) and, in a tree
          with `closure_plans`, both in every layout the shape can take.
          K2 gets its breakdown: the launch with run=False (the kernel
          writes an empty result and returns), and the tree's own
          kernels/frontier_closure.cu rebuilt with its closure loop cut
          to 0 passes (table init, seed and output) and to 1 pass. K4
          runs on the plan its tree's engine takes, where the tree's
          wrapper takes one (`whole_plan`, else `tiled_plan`), and gets
          the host's cost of a launch; it updates the table in place in
          trees that do, so every timed launch gets its own copy of the
          recorded table, made before the clock starts. K2 is also
          rebuilt without its one-warp path for passes of at most 32
          candidates, where the tree has one, and timed whole
          (`variant_ms`; the timing alone, results unchecked;
          chip_smoke.py, which shares these timers, times only the cuts
          it prints), and, in a tree whose K2 has search-stats outputs,
          timed with them on (`stats_ms`), and at K = 1 on a cluster of
          8 where the tree's K2 takes one (`cluster8_ms`). Batched K2:
          per launch the keys running, their passes and live rows, the
          slowest key's pass widths (plain closure), the launch with no
          key and with only the slowest key running, cut to 0 and 1
          passes, split from 512 and 32 candidates (`variant_ms`), and
          at every cluster size (`cluster_ms`). Batched K4: each key's
          live candidates and rounds (the reference's loop, counted),
          its host cost and its kernels under torch.profiler. The batched
          dense scan (k1b), per chunk: in a tree with the per-row batched
          K1 (`closure_fixpoint_batch`), its rows as the scan issues them
          (a launch and the torch ops of the filter and carry a row),
          device ms and host issue us a row, their kernels under
          torch.profiler, and the launch taken apart on the rows' own
          inputs (no key running, the sweeps cut to 0, in every layout
          the shape can take, the plain closure's expansions a running
          key); in a tree with the persistent scan (`closure_scan_batch`)
          its one launch a chunk, in every layout `closure_plans_batch`
          gives, at every cluster size whose blocks hold their shares
          (`cluster_ms`) and with no key running; in both a digest of the carry
          at the chunk's end, equal across trees. Prints one JSON line;
  walls   the dense 10k-op check through the checker: cold, then the
          median of three warm runs; with --sparse-batch the 28-key
          sparse batch, triple and packed, cold and three warm runs;
          with --dense-batch the 84-key and 92-key dense batches of
          chip_smoke.py, cold and three warm runs each, and one more warm
          run of the 84 keys under torch.profiler: device time by kernel,
          and the host's seconds in the encode, pad_batch, the scan's
          set-up, its issue and the finalize; one JSON line.

The sharded 10k-op check's walls and busy share come from
`python3 -m jepsen_tpu_torch.profile_check --sharded`, run in each tree.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import subprocess
import sys
import time

DEFAULT_INPUTS = "build/kernel_ab_inputs.pt"
K1_PAIRS = 200
K3_KEEP = 3
K2B_KEEP = 60   # batched K2 calls kept per shape
K4B_KEEP = 4    # batched K4 calls kept per shape
K1B_EXP_STRIDE = 10   # rows between the expansion counts of batched K1


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _record_k1(torch, ck, h, stride: int):
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.models import CASRegister
    real, pairs, calls = ck.closure_fixpoint, [], [0]

    def recording(sel, B, C, **kw):
        if calls[0] % stride == 0 and len(pairs) < K1_PAIRS:
            pairs.append((sel.clone(), B.clone(), C))
        calls[0] += 1
        return real(sel, B, C, **kw)

    ck.closure_fixpoint = recording
    try:
        Linearizable(CASRegister(None), "torch",
                     device=torch.device("cuda")).check({}, h)
    finally:
        ck.closure_fixpoint = real
    return pairs


def _record_k3(torch, sk, e, capacity: int, T_want: int):
    """The last K3_KEEP of every 7th expansion insert (more candidates
    than frontier rows) at table size T_want: the frontier at its
    largest."""
    from jepsen_tpu_torch.parallel import meshplan, sharded
    real, kept, seen = sk.hash_insert, [], [0]

    def recording(c_rows, c_live, f_rows, count, table, pl, N):
        if table[1].shape[0] == T_want and c_live.shape[0] > N:
            seen[0] += 1
            if seen[0] % 7 == 0:
                del kept[:max(0, len(kept) - K3_KEEP + 1)]
                kept.append((tuple(r.clone() for r in c_rows),
                             c_live.clone(),
                             tuple(r.clone() for r in f_rows),
                             count.clone(),
                             (tuple(r.clone() for r in table[0]),
                              table[1].clone()), pl, N))
        return real(c_rows, c_live, f_rows, count, table, pl, N)

    mesh = meshplan.local_mesh()
    sk.hash_insert = recording
    try:
        sharded.check_encoded_sharded(e, mesh, capacity=capacity,
                                      max_capacity=capacity, dedupe="hash")
    finally:
        sk.hash_insert = real
    if not kept:
        raise SystemExit(f"kernel_ab: no K3 expansion insert at T={T_want}")
    return kept


def _record_k2(torch, sk, h, stride: int, keep: int):
    """Every `stride`-th K2 call of the check of `h` (an unordered-queue
    history), `keep` at most, as the scan hands them to the wrapper."""
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.models import UnorderedQueue
    real, kept, seen = sk.frontier_closure, [], [0]

    def recording(step_name, ev, rows, live, run, pl):
        seen[0] += 1
        if seen[0] % stride == 0 and len(kept) < keep:
            kept.append((step_name, {k: v.clone() for k, v in ev.items()},
                         tuple(r.clone() for r in rows), live.clone(),
                         run.clone(), pl))
        return real(step_name, ev, rows, live, run, pl)

    sk.frontier_closure = recording
    try:
        Linearizable(UnorderedQueue(), "torch",
                     device=torch.device("cuda")).check({}, h)
    finally:
        sk.frontier_closure = real
    return kept


def _record_k4(torch, sk, h, T_want: int, stride: int, keep: int):
    """Every `stride`-th K4 expansion insert (M != T/2: not an event's
    seed) on a table of T_want slots in the check of `h` (a FIFO
    history), `keep` at most."""
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.models import FIFOQueue
    real, kept, seen = sk.tiled_insert, [], [0]

    def recording(c_rows, c_live, table, pl, *plan):
        if table[1].shape[0] == T_want and c_live.shape[0] != T_want // 2:
            seen[0] += 1
            if seen[0] % stride == 0 and len(kept) < keep:
                kept.append((tuple(r.clone() for r in c_rows),
                             c_live.clone(),
                             (tuple(r.clone() for r in table[0]),
                              table[1].clone()), pl))
        return real(c_rows, c_live, table, pl, *plan)

    sk.tiled_insert = recording
    try:
        Linearizable(FIFOQueue(), "torch",
                     device=torch.device("cuda")).check({}, h)
    finally:
        sk.tiled_insert = real
    if not kept:
        raise SystemExit(f"kernel_ab: no K4 expansion insert at T={T_want}")
    return kept


def _sparse_batch_keys():
    """The 28 keys of chip_smoke.py's sparse per-key batch
    (sparse-batch-28: 24 of the bench's multi-key layout on
    UnorderedQueue and 4 corrupted twins)."""
    import chip_smoke
    return chip_smoke._sparse_batch_keys()


def _check_sparse_batch(torch, pack: bool, stats: bool):
    from jepsen_tpu_torch.models import UnorderedQueue
    from jepsen_tpu_torch.parallel import engine
    return engine.check_batch(UnorderedQueue(), _sparse_batch_keys(),
                              device=torch.device("cuda"),
                              config_pack=pack, search_stats=stats)


def _record_k2_batch(torch, sk, pack: bool, stats: bool) -> dict:
    """Batched K2's calls in the sparse-batch-28 check through
    `engine.check_batch` (rows packed with `pack`, search stats on with
    `stats`), by shape "K{K}N{N}L{lanes}[S]": every row of a tier, at
    most K2B_KEEP of them at an even stride. Each call keeps the batch's
    slot tables (the same tensors every row) and its keyword arguments."""
    real, kept = sk.frontier_closure_batch, {}

    def recording(step_name, xs, r, rows, live, run, pl, **kw):
        shape = f"K{live.shape[0]}N{live.shape[1]}L{len(rows)}" + \
            ("S" if kw.get("stats") else "")
        kept.setdefault(shape, []).append(
            (step_name, {k: xs[k] for k in sk.SLOT_TABLES}, r,
             tuple(x.clone() for x in rows), live.clone(), run.clone(), pl,
             dict(kw)))
        return real(step_name, xs, r, rows, live, run, pl, **kw)

    sk.frontier_closure_batch = recording
    try:
        _check_sparse_batch(torch, pack, stats)
    finally:
        sk.frontier_closure_batch = real
    return {s: v[::max(1, len(v) // K2B_KEEP)][:K2B_KEEP]
            for s, v in kept.items()}


def _record_k4_batch(torch, sk, pack: bool) -> dict:
    """Batched K4's expansion inserts (M = N*C candidates a key, not an
    event's seed) in the sparse-batch-28 check, by shape
    "K{K}T{T}M{M}L{lanes}": every 97th of a shape, K4B_KEEP at most."""
    real, kept, seen = sk.tiled_insert_batch, {}, {}

    def recording(c_rows, c_live, table, pl):
        T = table[1].shape[1]
        if c_live.shape[1] != T // 2:
            shape = f"K{c_live.shape[0]}T{T}M{c_live.shape[1]}" \
                f"L{len(c_rows)}"
            seen[shape] = seen.get(shape, 0) + 1
            got = kept.setdefault(shape, [])
            if seen[shape] % 97 == 0 and len(got) < K4B_KEEP:
                got.append((tuple(r.clone() for r in c_rows),
                            c_live.clone(),
                            (tuple(r.clone() for r in table[0]),
                             table[1].clone()), pl))
        return real(c_rows, c_live, table, pl)

    sk.tiled_insert_batch = recording
    try:
        _check_sparse_batch(torch, pack, False)
    finally:
        sk.tiled_insert_batch = real
    return {s: v for s, v in kept.items() if v}


def _dense_batches():
    """chip_smoke.py's dense per-key batches: {"84": the bench's 84 keys,
    "92": those and its eight wider keys}."""
    import chip_smoke
    multikey, extra = chip_smoke._batch_keys()
    return {"84": multikey, "92": multikey + extra}


def _record_k1_batch(torch) -> dict:
    """Every chunk of event rows of the batched dense scans of the 84-key
    and 92-key checks through `engine.check_batch`, as
    `bitdense._BatchScan.run` builds it (the tree's own scan, recorded as
    it calls `_compute_sel`): the chunk's selects sel [E, K, C, S, S], the
    carry at its start (B [K, S, W], ok [K], fail_r [K]), its rows'
    returning slots slot [E, K] (int32) and run flags real [E, K], r0, C,
    by name "{keys} K{K}S{S}C{C} r{r0}"."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.parallel import bitdense, engine
    real_run, real_sel = bitdense._BatchScan.run, bitdense._compute_sel
    cur = {"scan": None, "r0": 0, "keys": ""}
    kept = {}

    def run(self):
        cur["scan"], cur["r0"] = self, 0
        try:
            return real_run(self)
        finally:
            cur["scan"] = None

    def sel(step, x, *a):
        out = real_sel(step, x, *a)
        sc = cur["scan"]
        if sc is not None:
            r0, E = cur["r0"], out.shape[0]
            cur["r0"] += E
            K, S, _ = sc.B.shape
            kept[f"{cur['keys']} K{K}S{S}C{sc.C} r{r0}"] = {
                "sel": out.clone(), "B": sc.B.clone(), "ok": sc.ok.clone(),
                "fail_r": sc.fail_r.clone(),
                "slot": sc.slot[r0:r0 + E].to(torch.int32).clone(),
                "real": sc.real[r0:r0 + E].clone(), "r0": r0, "C": sc.C}
        return out

    bitdense._BatchScan.run, bitdense._compute_sel = run, sel
    try:
        for keys, hs in _dense_batches().items():
            cur["keys"] = keys
            engine.check_batch(CASRegister(), hs, device=torch.device("cuda"))
    finally:
        bitdense._BatchScan.run, bitdense._compute_sel = real_run, real_sel
    return kept


def _carry(c: dict) -> tuple:
    """A fresh copy of chunk c's carry (B, ok, fail_r)."""
    return c["B"].clone(), c["ok"].clone(), c["fail_r"].clone()


def _digest(torch, B, ok, fail_r) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in (B, ok.to(torch.int32), fail_r):
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _k1b_rows(torch, ck, bitdense, c: dict):
    """The per-row batched scan of a tree with `closure_fixpoint_batch`,
    as its `_BatchScan.run` issues it for chunk c: f(B, ok, fail_r) ->
    the carry after the chunk, and the per-row launch inputs (sel, B,
    run) it made."""
    C, r0 = c["C"], c["r0"]
    tables = bitdense._Tables(C, c["B"].device)
    sel, slot, real = c["sel"], c["slot"].long(), c["real"]

    def rows(B, ok, fail_r, keep=None):
        K = B.shape[0]
        for i in range(sel.shape[0]):
            run = ok & real[i]
            if keep is not None:
                keep.append((sel[i], B.clone(), run.clone()))
            B2 = ck.closure_fixpoint_batch(sel[i], B, C, run=run, out=B)
            B3 = tables.filter_keys(slot[i], B2)
            failed = run & ~B3.flatten(1).any(1)
            fail_r = torch.where(failed, r0 + i, fail_r)
            B = torch.where(run.view(K, 1, 1), B3, B2)
            ok = ok & ~failed
        return B, ok, fail_r
    return rows


def _device_kernels(torch, fn, n: int = 1) -> dict:
    """Device microseconds and calls of each CUDA kernel that n calls of
    fn() launch, read raw from torch.profiler's trace (as
    profile_check.py does), and the host seconds of the calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            k = out.setdefault(ev.name()[:60], {"us": 0.0, "calls": 0})
            k["us"] += ev.duration_ns() / 1e3 / n
            k["calls"] += 1
    for k in out.values():
        k["calls"] //= n
    return {"kernels": out, "host_s": host_s / n,
            "device_us": sum(k["us"] for k in out.values())}


def _time_k1_rows(torch, ck, bitdense, c: dict) -> dict:
    """The parent's batched scan over chunk c: the rows as its scan issues
    them (device ms and host issue us a row, kernels under the profiler),
    and its per-row launch taken apart on the rows' own inputs."""
    dev = c["B"].device
    E, C = c["sel"].shape[0], c["C"]
    K, S, _ = c["B"].shape
    rows = _k1b_rows(torch, ck, bitdense, c)
    kept: list = []
    res = {"digest": _digest(torch, *rows(*_carry(c), keep=kept))}
    carries = [_carry(c) for _ in range(3)]
    torch.cuda.synchronize()
    res["rows_ms"] = _time_once_each(torch, rows, [_carry(c)], carries) / E
    t_host = []
    for _ in range(3):
        B, ok, fail_r = _carry(c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows(B, ok, fail_r)
        t_host.append((time.perf_counter() - t0) * 1e6 / E)
        torch.cuda.synchronize()
    res["host_issue_us_per_row"] = t_host
    pool = [_carry(c) for _ in range(2)]     # copies made off the trace
    prof = _device_kernels(torch, lambda: rows(*pool.pop()))
    res["profile_per_row"] = {
        n: {"us": v["us"] / E, "calls": v["calls"] / E}
        for n, v in prof["kernels"].items()}
    k1_us = sum(v["us"] for n, v in prof["kernels"].items()
                if "closure" in n)
    res["k1_us_per_row"] = k1_us / E
    res["ops_us_per_row"] = (prof["device_us"] - k1_us) / E
    res["kernels_per_row"] = sum(v["calls"] for v in
                                 prof["kernels"].values()) / E

    def launch(sel, B, run, out):
        ck.closure_fixpoint_batch(sel, B, C, run=run, out=out)
    args = [(s, B, run, torch.empty_like(B)) for s, B, run in kept]
    res["launch_ms"] = _time_launches(torch, launch, args, reps=3)
    off = [(s, B, torch.zeros_like(run), o) for s, B, run, o in args]
    res["cut_ms"] = {"no_key_running": _time_launches(torch, launch, off,
                                                      reps=3)}
    full = ck._lib
    try:
        for n, lib in _closure_variants(ck, K1_CUTS).items():
            ck._lib = lib
            res["cut_ms"][n] = _time_launches(torch, launch, args, reps=3)
    finally:
        ck._lib = full
    res["layout_ms"] = {}
    for name, plan in ck.closure_plans(S, C, *ck.card_limits(dev)).items():
        def forced(sel, B, run, out, plan=plan):
            ck._launch_batch(sel, B, out, C, run=run, plan=plan)
        res["layout_ms"][f"{name}{plan['cluster']}"] = _time_launches(
            torch, forced, args, reps=3)
    res["gate"] = ck.device_plan(S, C, dev)["layout"]
    exps, running = [], []
    for s, B, run in kept[::K1B_EXP_STRIDE]:
        running.append(int(run.sum()))
        for k in torch.nonzero(run).flatten().tolist():
            exps.append(ck.closure_reference_expansions(s[k], B[k], C)[1])
    res["running_keys_per_row"] = sum(int(r.sum()) for _, _, r in kept) / E
    res["expansions_per_key"] = {
        "rows": len(running), "min": min(exps, default=0),
        "mean": sum(exps) / max(1, len(exps)), "max": max(exps, default=0)}
    return res


def _time_k1_scan(torch, ck, c: dict) -> dict:
    """The persistent batched scan over chunk c: its one launch, in every
    layout `closure_plans_batch` gives and with no key running."""
    dev = c["B"].device
    E, C = c["sel"].shape[0], c["C"]
    K, S, _ = c["B"].shape

    def scan(B, ok, fail_r, plan=None):
        if plan is None:
            ck.closure_scan_batch(c["sel"], B, ok, fail_r, c["slot"],
                                  c["real"], c["r0"], C)
        else:
            ck._launch_scan(c["sel"], B, ok, fail_r, c["slot"], c["real"],
                            c["r0"], C, plan=plan)
    B, ok, fail_r = _carry(c)
    scan(B, ok, fail_r)
    res = {"digest": _digest(torch, B, ok, fail_r), "rows": E}
    carries = [_carry(c) for _ in range(5)]
    res["ms"] = _time_once_each(torch, scan, [_carry(c)], carries)
    res["ms_per_row"] = res["ms"] / E
    off = [(B, torch.zeros_like(ok), f) for B, ok, f in
           (_carry(c) for _ in range(5))]
    res["cut_ms"] = {"no_key_running": _time_once_each(
        torch, scan, [_carry(c)], off)}
    plans = ck.closure_plans_batch(K, S, C, *ck.card_limits(dev),
                                   ck.sm_count(dev))
    res["plan"] = ck.device_plan_batch(K, S, C, dev)
    res["layout_ms"] = {}
    gate = res["plan"]
    for t in (256, 512):      # the gate's layout on fewer threads
        if t < gate["threads"]:
            plans[f"{gate['layout']} t{t}"] = dict(gate, threads=t)
    for name, plan in plans.items():
        res["layout_ms"][f"{name}{plan['cluster']}"] = _time_once_each(
            torch, functools.partial(scan, plan=plan), [_carry(c)],
            [_carry(c) for _ in range(5)])
    # every cluster size whose blocks hold their shares of B twice over
    optin, max_cluster = ck.card_limits(dev)
    W = c["B"].shape[2]
    res["cluster_ms"] = {}
    for k in (1, 2, 4, 8, 16):
        if k <= min(max_cluster, W // ck.MIN_BLOCK_WORDS) and \
                ck.k1_block_bytes(S, C, W // k, 2) <= optin:
            res["cluster_ms"][k] = _time_once_each(
                torch, functools.partial(
                    scan, plan=ck._scan_split_plan(S, C, k)),
                [_carry(c)], [_carry(c) for _ in range(5)])
    full = ck._lib
    try:
        for n, lib in _closure_variants(ck, K1_SCAN_GROUPS).items():
            ck._lib = lib
            res["layout_ms"][n] = _time_once_each(
                torch, scan, [_carry(c)], [_carry(c) for _ in range(5)])
    finally:
        ck._lib = full
    # where a key's walk goes, from the clock64() variant
    names = ("repack", "pairs", "sweeps", "filter", "rows_run", "total",
             "sweeps_n")
    full = ck._lib
    try:
        for lib in _closure_variants(ck, K1_SCAN_PHASES).values():
            ck._lib = lib
            B, ok, fail_r = _carry(c)
            traj = torch.zeros((K, c["r0"] + E, 2), dtype=torch.int32,
                               device=dev)
            ck.closure_scan_batch(c["sel"], B, ok, fail_r, c["slot"],
                                  c["real"], c["r0"], C, traj=traj)
            torch.cuda.synchronize()
            v = traj[:, c["r0"]:c["r0"] + 4].reshape(K, 8).cpu()
            v = v[v[:, 4] > 0]                     # keys that ran a row
            res["phases_cycles"] = {
                "slowest_key": dict(zip(names, v[int(v[:, 5].argmax())]
                                        .tolist())),
                "mean": dict(zip(names, v.double().mean(0).tolist())),
                "keys": int(v.shape[0])}
    finally:
        ck._lib = full
    return res


def _time_k1_batch(torch, ck, c: dict) -> dict:
    from jepsen_tpu_torch.parallel import bitdense
    K, S, W = c["B"].shape
    res = {"K": K, "S": S, "C": c["C"], "W": W, "rows": c["sel"].shape[0],
           "r0": c["r0"], "keys_ok_at_start": int(c["ok"].sum())}
    if hasattr(ck, "closure_fixpoint_batch"):
        res["per_row"] = _time_k1_rows(torch, ck, bitdense, c)
    if hasattr(ck, "closure_scan_batch"):
        res["scan"] = _time_k1_scan(torch, ck, c)
    return res


def cmd_record(args, torch) -> dict:
    from jepsen_tpu_torch import histories, models
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import encode
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    adv = histories.adversarial_register_history
    want = set(args.kernels.split(","))
    out: dict = {"k1": {}, "k2": {}, "k3": {}, "k4": {}}
    if "k1" in want:
        out["k1"]["S18C13"] = _record_k1(
            torch, ck, adv(n_ops=10000, k_crashed=12), 50)
        out["k1"]["S22C17"] = _record_k1(
            torch, ck, adv(n_ops=1000, k_crashed=16), 5)
    if "k2" in want:
        out["k2"]["N1024C8"] = _record_k2(
            torch, sk, histories.rand_queue_history(
                400, n_processes=8, crash_p=0.005, seed=1), 10, 40)
    if "k4" in want:
        out["k4"]["T65536"] = _record_k4(
            torch, sk, histories.rand_fifo_history(
                1000, n_processes=8, crash_p=0.005, seed=1), 1 << 16, 97, 6)
    if "k2b" in want:
        out["k2b"] = {**_record_k2_batch(torch, sk, False, False),
                      **_record_k2_batch(torch, sk, True, False),
                      **_record_k2_batch(torch, sk, False, True)}
    if "k4b" in want:
        out["k4b"] = {**_record_k4_batch(torch, sk, False),
                      **_record_k4_batch(torch, sk, True)}
    if "k1b" in want:
        out["k1b"] = _record_k1_batch(torch)
    if "k3" in want:
        out["k3"]["T262144"] = _record_k3(
            torch, sk, encode.encode(models.CASRegister(None),
                                     adv(n_ops=300, k_crashed=12)),
            1 << 17, 1 << 18)
        small = histories.rand_register_history(
            n_ops=60, n_processes=5, crash_p=0.06, fail_p=0.06, seed=77)
        out["k3"]["T1024"] = _record_k3(
            torch, sk, encode.encode(models.CASRegister(), small), 512,
            1024)
    torch.distributed.is_initialized() and \
        torch.distributed.destroy_process_group()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(out, args.out)
    return {"recorded": {k: {s: len(v) for s, v in d.items()}
                         for k, d in out.items()}, "out": args.out}


def _time_launches(torch, fn, inputs: list, reps: int) -> float:
    """Mean device ms per call over `inputs`: the stream first sleeps so
    the host has queued every launch before the first runs, and the
    events time the kernels, not the host's launch rate."""
    for a in inputs[:10]:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        for a in inputs:
            fn(*a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(inputs))


def _host_us(torch, fn, inputs: list, n: int = 2000) -> float:
    """Host microseconds per call of fn over `inputs`, n calls ending in
    one synchronize: the host's launch cost, where the kernel is short."""
    for a in inputs[:10]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


# Variants of a tree's own kernel sources, rebuilt for the timings:
# name -> (a pattern the source holds once, its replacement). A variant
# the tree's source does not hold, or that would change nothing, is
# skipped. K2's closure loop cut short (always timed):
K2_CUTS = {
    "passes_le_0": (r"while \(changed && !ovf\) \{",
                    "while (changed && !ovf && iters < 0) {"),
    "passes_le_1": (r"while \(changed && !ovf\) \{",
                    "while (changed && !ovf && iters < 1) {"),
}
# each kernel without its one-warp path (kernel_ab.py time)
K2_WARP_AB = {"no_warp_pass": (r"if \(M <= 32\) \{", "if (false) {")}
# batched K2 splitting smaller passes over its cluster (a tree that has
# split passes; kernel_ab.py time)
K2_SPLIT_AB = {
    f"split_min_{n}": (r"constexpr int kSplitMin = 2048;",
                       f"constexpr int kSplitMin = {n};")
    for n in (512, 32)}
# K1's sweeps cut to none: the launch loads B, builds its source masks and
# pair list and writes B back (the sweep loop of the tree's closure.cu,
# single-key and batched)
K1_CUTS = {"sweeps_le_0": (r"for \(int sweep = 0;; \+\+sweep\) \{",
                           "for (int sweep = 0; sweep < 0; ++sweep) {")}




def _after(anchor: str, code: str) -> tuple:
    """A substitution that adds `code` after the source text `anchor`."""
    import re
    return (re.escape(anchor), (anchor + code).replace("\\", "\\\\"))


# The persistent batched scan with clock64() counters: for each key the
# cycles of its rows' repack, pair list, sweeps and filter (with the
# cluster's count), the rows it ran, all its cycles and its sweeps,
# written over its first 4 stats rows (traj[key, r0:r0+4]) at the end
# (kernel_ab.py time; a timing tool, its results unchecked)
K1_SCAN_PHASES = {"phases": [
    _after("#include \"sparse_common.cuh\"\n",
           "__device__ int jt_sweeps[1 << 16];\n"),
    _after("  for (int sweep = 0;; ++sweep) {\n",
           "    if (threadIdx.x == 0) ++jt_sweeps[blockIdx.x];\n"),
    (r"    int fr = fail_r\[key\];\n    for \(int x = tid; x < nb;",
     "    int fr = fail_r[key];\n"
     "    long long prp = 0, ppr = 0, psw = 0, pfi = 0;\n"
     "    const long long t_start = clock64();\n"
     "    const int sw0 = jt_sweeps[blockIdx.x];\n    int nrun = 0;\n"
     "    for (int x = tid; x < nb;"),
    (r"      repack_sel\(sel_k \+ i \* row, src, S, C\);\n",
     "      const long long c1 = clock64();\n      ++nrun;\n"
     "      repack_sel(sel_k + i * row, src, S, C);\n"),
    (r"      const int n_items = build_pairs\(",
     "      const long long c2 = clock64();\n      prp += c2 - c1;\n"
     "      const int n_items = build_pairs("),
    (r"      if \(Wb >= 2 \* kScanGroup\) \{",
     "      const long long c3 = clock64();\n      ppr += c3 - c2;\n"
     "      if (Wb >= 2 * kScanGroup) {"),
    (r"      const int acc = filter_split<kCluster>\(",
     "      const long long c4 = clock64();\n      psw += c4 - c3;\n"
     "      const int acc = filter_split<kCluster>("),
    (r"      if \(tr != nullptr && r == 0 && tid == 0\) \{\n        tr\[2 \* i\] = n_left;",
     "      pfi += clock64() - c4;\n"
     "      if (tr != nullptr && r == 0 && tid == 0) {\n        tr[2 * i] = n_left;"),
    (r"    for \(int x = tid; x < nb; x \+= nt\) \{\n      g\[",
     "    __syncthreads();\n"
     "    if (tr != nullptr && r == 0 && tid == 0 && E >= 4) {\n"
     "      const long long v[8] = {prp, ppr, psw, pfi, nrun,\n"
     "                              clock64() - t_start,\n"
     "                              jt_sweeps[blockIdx.x] - sw0, 0};\n"
     "      for (int q = 0; q < 8; ++q) tr[q] = (int)v[q];\n"
     "      i = E;\n"
     "    }\n"
     "    for (int x = tid; x < nb; x += nt) {\n      g["),
]}


# the batched scan's sweeps taking 1 (one item a thread at a time, as the
# single-key sweep) or 4 items of a pair at a time
K1_SCAN_GROUPS = {f"group_{n}": (r"constexpr int kScanGroup = 2;",
                                 f"constexpr int kScanGroup = {n};")
                  for n in (1, 4)}


_VARIANTS: dict = {}


def _variant_libs(sk, kernel: str, variants: dict) -> dict:
    """The tree's own source of `kernel` rebuilt as each variant it
    holds (one nvcc each, all at once, once a run), loaded and set up on
    the current device like the wrapper's own library."""
    memo = (kernel, tuple(sorted(variants)))
    if memo not in _VARIANTS:
        _VARIANTS[memo] = _build_variants(kernel, variants,
                                          sk._lib(kernel))
    return _VARIANTS[memo]


def _closure_variants(ck, variants: dict) -> dict:
    """_variant_libs for K1's closure.cu (`ck._lib` is its library)."""
    memo = ("closure", tuple(sorted(variants)))
    if memo not in _VARIANTS:
        _VARIANTS[memo] = _build_variants("closure", variants,
                                          ck._kernel_lib())
    return _VARIANTS[memo]


def _build_variants(kernel: str, variants: dict, full) -> dict:
    import ctypes
    import re
    from jepsen_tpu_torch import kernels
    src = (kernels.KERNEL_DIR / kernels.SOURCES[kernel]).read_text()
    out_dir = kernels.BUILD_DIR / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, subs in variants.items():
        # one (pattern, replacement) or a list of them, each pattern
        # found once in the source
        var = src
        for pat, new in [subs] if isinstance(subs, tuple) else subs:
            if len(re.findall(pat, var)) != 1:
                var = src
                break
            var = re.sub(pat, new, var)
        if var == src:
            continue
        cu = out_dir / f"{kernel}_{n}.cu"
        cu.write_text(var)
        so = out_dir / f"lib{kernel}_{n}.so"
        procs[n] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
             str(kernels.KERNEL_DIR), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for n, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"kernel_ab: nvcc failed on {kernel}'s {n}:\n"
                             f"{log}")
        lib = ctypes.CDLL(str(so))
        # every C function the wrapper has set up (ctypes keeps each one
        # it was asked for as an attribute of the library)
        for f, ref in vars(full).items():
            if f.startswith("jt_"):
                getattr(lib, f).argtypes = ref.argtypes
                getattr(lib, f).restype = ref.restype
        if getattr(lib, f"jt_{kernel}_init")() <= 0:
            raise SystemExit(f"kernel_ab: {kernel}'s {n} did not set up on "
                             f"the card")
        libs[n] = lib
    return libs


def _time_k2(torch, sk, inputs: list, warp_ab: bool = False) -> dict:
    """K2 per launch, whole and cut short: run=False (an empty result
    written, nothing else), the closure loop cut to 0 passes (table
    init, the seed pass and the output) and to 1 pass; with `warp_ab`,
    whole without the one-warp path too (`variant_ms`)."""
    dev = torch.device("cuda")
    off = torch.zeros((), dtype=torch.bool, device=dev)
    res = {"ms": _time_launches(torch, sk.frontier_closure, inputs,
                                reps=10),
           "inputs": len(inputs),
           "N": inputs[0][3].shape[0], "C": inputs[0][1]["slot_f"].shape[0],
           "host_us": _host_us(torch, sk.frontier_closure, inputs)}
    skipped = [a[:4] + (off,) + a[5:] for a in inputs]
    res["cut_ms"] = {"run_false": _time_launches(
        torch, sk.frontier_closure, skipped, reps=10)}
    res["variant_ms"] = {}
    full = sk._libs["frontier_closure"]
    try:
        variants = {**K2_CUTS, **(K2_WARP_AB if warp_ab else {})}
        for n, lib in _variant_libs(sk, "frontier_closure",
                                    variants).items():
            sk._libs["frontier_closure"] = lib
            res["cut_ms" if n.startswith("passes") else "variant_ms"][n] = \
                _time_launches(torch, sk.frontier_closure, inputs, reps=10)
    finally:
        sk._libs["frontier_closure"] = full
    if "stats" in inspect.signature(sk.frontier_closure).parameters:
        res["stats_ms"] = _time_launches(
            torch, functools.partial(sk.frontier_closure, stats=True),
            inputs, reps=10)
    if _has_clusters(sk):
        # the one key on a cluster of 8 (the wrapper keeps one block)
        def eight(step_name, ev, rows, live, run, pl):
            return sk._frontier_closure_launch(step_name, ev, 0, 1, rows,
                                               live, run, pl, cluster=8)
        res["cluster8_ms"] = _time_launches(torch, eight, inputs, reps=10)
    metas = [sk.frontier_closure(*a)[1].tolist() for a in inputs]
    res["mean_iters"] = sum(m[2] for m in metas) / len(metas)
    res["mean_rows_out"] = sum(m[0] for m in metas) / len(metas)
    return res


def _fresh_tables(torch, inputs: list, reps: int) -> list:
    """`reps` passes over `inputs`, each with its own copy of the
    recorded table (K4 consumes its table in the trees that update it
    in place)."""
    return [a[:2] + ((tuple(r.clone() for r in a[2][0]),
                      a[2][1].clone()),) + a[3:]
            for _ in range(reps) for a in inputs]


def _time_once_each(torch, fn, warm: list, args: list) -> float:
    """Mean device ms per call of fn over `args`, each used once, after
    a warm-up on `warm` (the same as _time_launches otherwise)."""
    for a in warm:
        fn(*a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for a in args:
        fn(*a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args)


def _k4_call(sk, inputs: list):
    """K4's wrapper as f(c_rows, c_live, table, pl): in a tree whose
    `tiled_insert` takes a plan, with the plan its engine's route takes
    at the inputs' capacity (`whole_plan`, else `tiled_plan`)."""
    import inspect
    if len(inspect.signature(sk.tiled_insert).parameters) == 4:
        return sk.tiled_insert
    T, M = inputs[0][2][1].shape[0], inputs[0][1].shape[0]
    N = T // 2
    plan = sk.whole_plan(N) if hasattr(sk, "whole_plan") \
        else sk.tiled_plan(N, M // N)
    return lambda c_rows, c_live, table, pl: sk.tiled_insert(
        c_rows, c_live, table, pl, plan)


def _time_k4(torch, sk, inputs: list) -> dict:
    """K4 per launch on fresh copies of the recorded tables, and the
    host's cost of a launch through the wrapper."""
    fn = _k4_call(sk, inputs)
    return {"ms": _time_once_each(torch, fn,
                                  _fresh_tables(torch, inputs, 1),
                                  _fresh_tables(torch, inputs, 3)),
            "inputs": len(inputs), "M": inputs[0][1].shape[0],
            "T": inputs[0][2][1].shape[0],
            "live": [int(a[1].sum()) for a in inputs],
            "host_us": _host_us(torch, fn, _fresh_tables(torch, inputs, 1),
                                n=500)}


def _has_clusters(sk) -> bool:
    """Whether the tree's K2 takes a cluster size (a later tree than the
    one-block batched K2)."""
    return "cluster" in inspect.signature(
        sk._frontier_closure_launch).parameters


def _k2b_call(sk):
    def fn(step_name, xs, r, rows, live, run, pl, kw):
        return sk.frontier_closure_batch(step_name, xs, r, rows, live, run,
                                         pl, **kw)
    return fn


def _k2_pass_widths(torch, a) -> list:
    """The candidates (the pass's delta rows times C, as the kernel
    builds them) and the live ones of every pass of each running key of
    batched K2 call `a`, from the plain closure: [[(M, live), ...] a
    running key]."""
    from jepsen_tpu_torch.parallel import sparse as sp
    step_name, xs, r, rows, live, run, pl, kw = a
    C, N = xs["slot_f"].shape[2], live.shape[1]
    rep = sp._rep(kw.get("pack", ()), C, live.device)
    out = []
    for k in torch.nonzero(run).flatten().tolist():
        passes = []

        def insert(c_rows, c_live, f_rows, count, table):
            passes.append((int(count), int(c_live.sum())))
            return sp._hash_insert_append(c_rows, c_live, f_rows, count,
                                          table, pl, N, rep)
        sp._hash_event_closure(
            rep, sp.STEPS[step_name], {n: xs[n][k, r] for n in xs},
            tuple(x[k] for x in rows), live[k], run[k], N,
            sp._next_pow2(2 * N), pl, insert=insert)
        # the seed (count 0) is not a pass; a pass steps the rows the
        # one before it appended
        out.append([((c - b) * C, n) for (b, _), (c, n)
                    in zip(passes, passes[1:])])
    return out


def _time_k2_batch(torch, sk, inputs: list) -> dict:
    """Batched K2 per launch on the recorded rows of one shape, and where
    its time goes: the launch with no key running (an empty result
    written), with only each row's slowest key running (the most passes),
    the closure loop cut to 0 and 1 passes; per launch the keys running,
    their passes (meta's iters) and live input rows; the widths of the
    slowest key's passes on a few rows, from the plain closure."""
    fn = _k2b_call(sk)
    a0 = inputs[0]
    res = {"ms": _time_launches(torch, fn, inputs, reps=5),
           "inputs": len(inputs), "K": a0[4].shape[0], "N": a0[4].shape[1],
           "C": a0[1]["slot_f"].shape[2], "lanes": len(a0[3]),
           "stats": bool(a0[7].get("stats")), "variant_ms": {}}
    metas = [fn(*a)[1].cpu() for a in inputs]
    running = [a[5].cpu() for a in inputs]
    iters = [m[:, 2][rn].tolist() for m, rn in zip(metas, running)]
    res["running_keys"] = [int(rn.sum()) for rn in running]
    res["iters_max"] = [max(i, default=0) for i in iters]
    res["iters_mean"] = sum(sum(i) for i in iters) / max(
        1, sum(len(i) for i in iters))
    res["live_rows"] = [int((a[4] & a[5][:, None]).sum()) for a in inputs]
    none = [a[:5] + (torch.zeros_like(a[5]),) + a[6:] for a in inputs]
    res["cut_ms"] = {"run_none": _time_launches(torch, fn, none, reps=5)}
    slowest = []
    for a, m in zip(inputs, metas):
        one = torch.zeros_like(a[5])
        one[int(torch.argmax(torch.where(a[5].cpu(), m[:, 2], -1)))] = True
        slowest.append(a[:5] + (one & a[5],) + a[6:])
    res["cut_ms"]["slowest_key_only"] = _time_launches(torch, fn, slowest,
                                                      reps=5)
    full = sk._libs["frontier_closure"]
    try:
        for n, lib in _variant_libs(sk, "frontier_closure",
                                    {**K2_CUTS, **K2_SPLIT_AB}).items():
            sk._libs["frontier_closure"] = lib
            res["cut_ms" if n.startswith("passes") else "variant_ms"][n] = \
                _time_launches(torch, fn, inputs, reps=5)
    finally:
        sk._libs["frontier_closure"] = full
    if _has_clusters(sk):
        # every cluster size forced (1: the parent's block a key)
        res["cluster"] = sk.k2_cluster(a0[4].device, res["K"], res["N"],
                                       res["C"], res["lanes"], res["stats"])
        res["cluster_ms"] = {}
        for c in (1, 2, 4, 8):
            def forced(step_name, xs, r, rows, live, run, pl, kw, c=c):
                return sk._frontier_closure_launch(
                    step_name, xs, r, xs["slot_f"].shape[1], rows, live, run,
                    pl, kw.get("pack", ()), bool(kw.get("stats")), cluster=c)
            res["cluster_ms"][c] = _time_launches(torch, forced, inputs,
                                                  reps=5)
    order = sorted(range(len(inputs)), key=lambda i: -res["iters_max"][i])
    res["slowest_key_passes"] = {}
    for i in order[:3]:
        widths = _k2_pass_widths(torch, slowest[i])
        res["slowest_key_passes"][inputs[i][2]] = widths[0] if widths \
            else []
    return res


def _k4_rounds(torch, a) -> list:
    """The probe rounds of each key's transaction in batched K4 call `a`
    (the plain transaction's loop, counted)."""
    from jepsen_tpu_torch.parallel import sparse as sp
    c_rows, c_live, table, pl = a
    rep = sp._RowLayout()
    out = []
    for k in range(c_live.shape[0]):
        rows = tuple(x[k] for x in c_rows)
        h0 = rep.table_hash(rows)
        T = table[1].shape[1]
        t_rows = tuple(x[k].clone() for x in table[0])
        t_occ = table[1][k].clone()
        M = c_live.shape[1]
        idx = torch.arange(M, device=c_live.device)
        pending = c_live[k].clone()
        off = torch.zeros(M, dtype=torch.int32, device=c_live.device)
        rounds = 0
        while bool((pending & (off < pl)).any()):
            rounds += 1
            act = pending & (off < pl)
            slot = (h0 + off) & (T - 1)
            occ = t_occ[slot]
            same = occ & sp._rows_eq(sp._rows_take(t_rows, slot), rows)
            try_claim = act & ~occ
            claim = torch.full((T + 1,), M, dtype=torch.int64,
                               device=c_live.device)
            claim.scatter_reduce_(0, torch.where(try_claim, slot, T), idx,
                                  "amin")
            won = try_claim & (claim[slot] == idx)
            for r, c in zip(t_rows, rows):
                r[slot[won]] = c[won]
            t_occ[slot[won]] = True
            pending = pending & ~(act & same) & ~won
            off = off + (act & occ & ~same).to(torch.int32)
        out.append(rounds)
    return out


def _kernel_profile(torch, fn, inputs: list) -> dict:
    """Device microseconds a call of each CUDA kernel the calls of fn over
    `inputs` launch, from torch.profiler (its CUPTI trace); {} where the
    trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    for a in inputs[:2]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for a in inputs:
            fn(*a)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if dev_us and not e.key.startswith(("aten::", "cuda")):
            out[e.key[:80]] = {"us_per_call": dev_us / max(1, e.count),
                               "count": e.count}
    return out


def _time_k4_batch(torch, sk, inputs: list) -> dict:
    """Batched K4 per launch on fresh copies of the recorded tables, the
    host's cost of a launch, each key's live candidates and probe rounds,
    and the device time of each kernel a launch runs (torch.profiler)."""
    fn = sk.tiled_insert_batch
    a0 = inputs[0]
    res = {"ms": _time_once_each(torch, fn, _fresh_tables(torch, inputs, 1),
                                 _fresh_tables(torch, inputs, 3)),
           "inputs": len(inputs), "K": a0[1].shape[0],
           "M": a0[1].shape[1], "T": a0[2][1].shape[1],
           "lanes": len(a0[0]),
           "live_per_key": [a[1].sum(1).tolist() for a in inputs],
           "rounds_per_key": [_k4_rounds(torch, a) for a in inputs],
           "host_us": _host_us(torch, fn, _fresh_tables(torch, inputs, 1),
                               n=200)}
    try:
        res["profile"] = _kernel_profile(torch, fn,
                                         _fresh_tables(torch, inputs, 2))
    except Exception as e:    # the trace is a diagnosis, not a result
        res["profile"] = {"error": repr(e)[:200]}
    return res


def cmd_time(args, torch) -> dict:
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    rec = torch.load(args.inputs)
    dev = torch.device("cuda")
    off = torch.zeros((), dtype=torch.bool, device=dev)
    out: dict = {}
    for shape, pairs in rec.get("k1", {}).items():
        C = pairs[0][2]
        S = pairs[0][1].shape[0]

        def k1(sel, B, o, C=C):
            ck.closure_fixpoint(sel, B, C, out=o)

        def k1_skip(sel, B, o, C=C):
            ck.closure_fixpoint(sel, o, C, out=o, run=off)

        args_ = [(sel, B, torch.empty_like(B)) for sel, B, _ in pairs]
        res = {"ms": _time_launches(torch, k1, args_, reps=3),
               "layout": ck.kernel_layout(S, C), "inputs": len(pairs),
               # the kernel with run=False returns at once: the host's
               # cost of one launch through the wrapper
               "host_us_skipped": _host_us(torch, k1_skip, args_)}
        # trees with more than one layout: each the shape can take, forced
        plans = getattr(ck, "closure_plans", None)
        if plans is not None:
            res["layouts"] = {}
            for name, plan in plans(S, C, *ck.card_limits(dev)).items():
                def forced(sel, B, o, plan=plan, C=C):
                    ck._launch(sel, B, o, C, plan=plan)

                def forced_skip(sel, B, o, plan=plan, C=C):
                    ck._launch(sel, o, o, C, run=off, plan=plan)
                res["layouts"][name] = {
                    "ms": _time_launches(torch, forced, args_, reps=3),
                    "host_us_skipped": _host_us(torch, forced_skip, args_)}
        out[f"K1 {shape}"] = res
    for shape, inputs in rec.get("k2", {}).items():
        out[f"K2 {shape}"] = _time_k2(torch, sk, inputs, warp_ab=True)
    for shape, inputs in rec.get("k4", {}).items():
        out[f"K4 {shape}"] = _time_k4(torch, sk, inputs)
    for shape, inputs in rec.get("k2b", {}).items():
        out[f"K2 batch {shape}"] = _time_k2_batch(torch, sk, inputs)
    for shape, inputs in rec.get("k4b", {}).items():
        out[f"K4 batch {shape}"] = _time_k4_batch(torch, sk, inputs)
    for name, chunk in rec.get("k1b", {}).items():
        out[f"K1 batch {name}"] = _time_k1_batch(torch, ck, chunk)
    for shape, inputs in rec.get("k3", {}).items():
        T = inputs[0][4][1].shape[0]
        out[f"K3 {shape}"] = {
            "ms": _time_launches(torch, sk.hash_insert, inputs,
                                 reps=10 if T <= 8192 else 3),
            "layout": sk.k3_layout(T // 2, torch.device("cuda")),
            "inputs": len(inputs),
            "live": [int(a[1].sum()) for a in inputs]}
    return out


def _sparse_batch_walls(torch) -> dict:
    """The sparse-batch-28 check through `engine.check_batch`, triple and
    packed: cold, then three warm runs each (seconds, the card
    synchronised)."""
    out = {}
    for name, pack in (("triple", False), ("packed", True)):
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = _check_sparse_batch(torch, pack, False)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"sparse_batch_28_{name}"] = {
            "cold_s": walls[0], "warm_s": walls[1:],
            "valid": [r["valid?"] for r in rs],
            "capacity": [r["capacity"] for r in rs]}
    return out


def _dense_batch_walls(torch) -> dict:
    """The 84-key and 92-key dense batches through `engine.check_batch`:
    cold, then three warm runs each (seconds, the card synchronised); and
    one more warm run of the 84 keys traced, its device time by kernel
    (torch.profiler) and its host seconds by step: the encode, pad_batch,
    the scan's set-up (`_BatchScan.__init__`), its issue (`run`) and the
    finalize (the one device read and the results)."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.parallel import bitdense, engine
    dev = torch.device("cuda")
    out = {}
    for name, hs in _dense_batches().items():
        walls = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs = engine.check_batch(CASRegister(), hs, device=dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[f"dense_batch_{name}"] = {
            "cold_s": walls[0], "warm_s": walls[1:],
            "invalid": [i for i, r in enumerate(rs) if not r["valid?"]]}
    hs = _dense_batches()["84"]
    steps: dict = {}
    patched = [(engine.enc_mod, "encode"), (bitdense, "pad_batch"),
               (bitdense._BatchScan, "__init__"), (bitdense._BatchScan, "run"),
               (bitdense.PendingBitdenseBatch, "finalize")]
    saved = [(o, n, getattr(o, n)) for o, n in patched]

    def timed(name, fn):
        def f(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                steps[name] = steps.get(name, 0.0) + time.perf_counter() - t0
        return f
    for o, n, fn in saved:
        setattr(o, n, timed(n.strip("_"), fn))
    try:
        prof = _device_kernels(torch, lambda: engine.check_batch(
            CASRegister(), hs, device=dev))
    finally:
        for o, n, fn in saved:
            setattr(o, n, fn)
    # the device's busy share of the unprofiled warm wall (the profiler
    # slows the host, not the kernels)
    warm = sorted(out["dense_batch_84"]["warm_s"])[1]
    out["dense_batch_84_traced"] = {
        "traced_wall_s": prof["host_s"],
        "host_steps_s": {k: v / 2 for k, v in steps.items()},
        "device_busy_s": prof["device_us"] / 1e6,
        "device_busy_share": prof["device_us"] / 1e6 / warm,
        "kernels": dict(sorted(prof["kernels"].items(),
                               key=lambda kv: -kv[1]["us"])[:12])}
    return out


def cmd_walls(args, torch) -> dict:
    if args.sparse_batch:
        return _sparse_batch_walls(torch)
    if args.dense_batch:
        return _dense_batch_walls(torch)
    from jepsen_tpu_torch import histories
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.models import CASRegister
    h = histories.adversarial_register_history(n_ops=10000, k_crashed=12)
    checker = Linearizable(CASRegister(None), "torch",
                           device=torch.device("cuda"))
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = checker.check({}, h)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if r["valid?"] is not True:
        raise SystemExit(f"kernel_ab: the 10k-op check said {r}")
    return {"dense_10k_cold_s": walls[0],
            "dense_10k_warm_s": sorted(walls[1:])[1],
            "dense_10k_warm_walls_s": walls[1:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("record")
    r.add_argument("--out", default=DEFAULT_INPUTS)
    r.add_argument("--kernels", default="k1,k2,k3,k4,k2b,k4b,k1b")
    t = sub.add_parser("time")
    t.add_argument("--inputs", default=DEFAULT_INPUTS)
    w = sub.add_parser("walls")
    w.add_argument("--sparse-batch", action="store_true",
                   help="the 28-key sparse batch (triple and packed) in "
                        "place of the dense 10k-op check")
    w.add_argument("--dense-batch", action="store_true",
                   help="the 84-key and 92-key dense batches in place of "
                        "the dense 10k-op check")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import jepsen_tpu_torch
    res = {"record": cmd_record, "time": cmd_time,
           "walls": cmd_walls}[args.cmd](args, torch)
    print(json.dumps({"cmd": args.cmd,
                      "tree": os.path.dirname(os.path.dirname(
                          os.path.abspath(jepsen_tpu_torch.__file__))),
                      **res, "card": _card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
