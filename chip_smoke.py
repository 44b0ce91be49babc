"""Smoke run of jepsen_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port — never the JAX package — through the entry point a user
calls, `checker.linearizable.Linearizable(model, "torch")`, on the card,
down both of its engines:

  1. build: compiles every CUDA kernel of the paths from the repository's
     sources (into build/torch_kernels/), one nvcc each, all at once, and
     prints the build seconds and each kernel's registers;
  2. K1 (the dense engine's closure, kernels/closure.cu):
     * parity against its plain PyTorch version, bit for bit, at the main
       path's shape (S=18, C=13), a wide shape (S=22, C=17) and one with
       more than 32 states (S=40, C=12), in every layout the kernel can
       run each in: the gate's (a thread-block cluster at all three)
       through the wrapper, and one block ("shared", where B fits it)
       and B in device memory ("global") forced;
     * main path: the 10k-op adversarial cas-register history (valid),
       its twin with an impossible read (invalid; the counterexample
       re-scans the device to a window before the failure) and a 1k-op
       history with 16 crashed writes. Shorter twins of the three
       (2k ops, 600 ops with 6 crashed writes, the same 1k) are held
       against the check with the plain closure, field for field apart
       from `closure`. Small seeded histories are held against the host
       WGL search;
     * timing, per launch with CUDA events, on closure inputs recorded
       from the main path's own scans, in the gate's layout and in each
       other layout the shape can take;
  3. the per-key batch (jepsen.independent's shape) on the dense engine,
     whose scan is one launch of K1's persistent batched scan per chunk
     of event rows for every key of a bucket (kernels/closure.cu: each
     key walks the chunk's rows with its reachable set in shared memory,
     closing, filtering and testing for failure row after row):
     * main path: the bench's 84 keys (`sec_multikey`: 120 ops, 14
       processes) through `engine.check_batch`, cold and warm (median of
       3), beside the same keys checked one by one through
       `check_encoded_bitdense`; the 84 keys with two 1000-op keys with
       16 crashed writes (one with an impossible read: a bucket of its
       own, S=22/23, C=17) and six corrupted keys, through
       `engine.check_batch` and through `independent.checker(
       linearizable(CASRegister()))`. Every key's result equals the
       reference's (REF_BATCH, recorded on the CPU) and the port's own
       single-key dense check; the batch launches the scan once per
       chunk of event rows of each bucket, exactly (one for the 84 keys);
     * parity of the batched scan against its plain version (run on the
       card), bit for bit, in every layout each bucket's shape can take
       (one block a key, a cluster a key — at S=23 C=17 one of 16 blocks,
       whose filter pairs straddle its blocks — and device memory), on
       every chunk of the 92-key batch — among them keys past their last
       event (pad rows) and keys that fail inside the chunk — and with
       stats on (each row's width);
     * timing per launch on the 84-key batch's chunk (K84, S6, C15, 99
       rows) in every layout, beside the plain scan and the bound, held
       against the plain scan bit for bit: its kernels-line entry;
  4. K2 and K4 (the sparse engine's hash closure, kernels/
     frontier_closure.cu, and its tiled visited-set insert, kernels/
     tiled_insert.cu):
     * parity against their plain versions, bit for bit: K2 on closure
       inputs recorded from the main path's scans (a golden FIFO history,
       a 400-op unordered queue, the 1000-op FIFO's K2 tiers), once
       with probe_limit=2, where the probes overflow, and on the seeded
       cases of `tests/torch_parity_cases.py` (C = 33 and 64, N = 2,048,
       passes of at most 32, more than 32 and more than 1,024
       candidates, a frontier overflow past N, probe_limit 2); K4 on a
       random insert, on inserts recorded from the 1000-op FIFO and on
       the seeded cases (many and few live candidates racing, equal rows
       near and far apart, probe_limit 1 and 2, a few live candidates
       among 50,000 on a half-full table, and more live candidates than
       its grid has threads). K4 updates the table in place, so it gets
       a copy;
     * main path: the six golden queue and set histories, 400-op
       unordered-queue and set histories (the K2 route), a 1000-op FIFO
       history (the K4 route, at capacity 32,768) and its invalid twin,
       whose counterexample re-scans the sparse sort path. Each result
       equals the reference's, recorded on the CPU (below), and the
       same check with dedupe="sort" on the card; a small one equals the
       check with the plain closure;
     * timing of K2 and K4 per launch, beside their plain versions, the
       sort closure, and their bound; K2 also cut short (run=False, its
       closure loop cut to 0 and 1 passes: kernel_ab.py's breakdown),
       each K4 launch on its own copy of the recorded table.
  5. the sparse per-key batch (Jepsen's per-key queue workload), whose
     closure is K2 batched over keys (one launch an event row for every
     key of a tier within K2's gate) and the tiled closure around K4
     batched over keys (one launch a closure iteration for every key
     past it):
     * main path: 24 keys of the bench's multi-key layout on the
       unordered-queue model (120 ops, 14 processes, seeds 2024 + k; cut
       from 84) and corrupted twins of four, through `engine.check_batch`
       at the reference's defaults (capacity 512, ceiling 2^18), three
       times (cold, then warm), beside the same keys one by one through
       `sparse.check_encoded(capacity=512)`; again with max_capacity
       4,096, where keys escalate to the single-key engine ("escalated":
       "single") or end "unknown"; four cheap keys with dedupe="sort";
       and the 28 keys as one keyed history through
       `independent.checker(linearizable(UnorderedQueue()))`. Every
       result equals the reference's (REF_SPARSE_BATCH, recorded on the
       CPU); each tier within K2's gate launches batched K2 once an event
       row, and the main run launches both batched kernels and no
       single-key one; each tier's launches print;
     * parity of batched K2 against its plain version, bit for bit, on
       the first tier's first row, a middle one, the first where a key is
       past its last event and the last; of batched K4 on one iteration
       of the tier at capacity 16,384 (12 keys);
     * timing per launch of both, beside their plain versions and
       bounds;
  6. K3 (the sharded engine's visited-set transaction, kernels/
     hash_insert.cu), on a one-rank NCCL mesh (`meshplan.local_mesh()`):
     * main path, small shapes: 60-op register histories and their
       corrupted twins, a wide frontier that climbs capacity tiers, and
       two golden queue histories through `check_encoded_sharded`, each
       equal field for field to the reference's results recorded on the
       CPU at one device (below);
     * main path, full width: the bench's sharded shape at a quarter of
       its depth, `adversarial_register_history(2500, 12)` through
       `sharded.analysis` at capacity 2^17 (K3's table in device
       memory, its insert a cooperative grid), once, and the
       impossible-read twin of `adversarial_register_history(2500, 12)`
       (the same width: 12 crashed writes, K3's grid) through
       `check_encoded_sharded`, each with the dense engine's verdict, op
       and fail-event on the card;
     * parity against its plain version, bit for bit, on inputs recorded
       from those checks at both table layouts, through the wrapper and
       through the cooperative grid forced (on the one-block layout's
       tables too), at probe_limit=2 with the probe overflow raised, on
       an append past N, and on more live candidates than the grid has
       threads; a short check through the plain insert on the card
       equals the K3 check;
     * timing per launch at both layouts (and the grid forced at
       T=1,024), beside the plain insert and the bound; the kernels line
       has one K3 entry per insert ("shared": one block; "grid"), with
       K3's launches in that layout (the wrapper counts them per layout).
  7. packed rows (config_pack: a configuration as the word (state -
     state_lo) | mask << state_bits in one or two int32 lanes), through K2,
     K3 and K4 and their batched forms at one lane and two:
     * main path, with config_pack=True: the ten sparse histories above and
       a two-lane one (a 200-op set of 20 elements, 14 processes: a 34-bit
       word) through the checker, each equal field for field to
       REF_PACKED; the 28 queue keys through `engine.check_batch` and
       `independent.checker(linearizable(..., config_pack=True))`, equal to
       REF_SPARSE_BATCH_PACKED; the ten small sharded checks, a 44-op set
       of 30 elements (33 bits) and the two-lane set at capacity 16,384
       (K3's grid), equal to REF_SHARDED_PACKED (all recorded from the
       reference on the CPU with config_pack=True and dedupe "hash"). The
       1000-op FIFO and the 28-key batch are also timed warm, packed
       against unpacked (walls: findings, not claims);
     * parity of every packed kernel against its plain version, bit for
       bit, at one lane and two, on the seeded packed cases of
       `tests/torch_parity_cases.py` and on inputs kept from the packed
       main path (K2 also at probe_limit 2; K3 through the wrapper, the
       grid forced and one block forced where the table fits);
     * timing per launch with CUDA events on the kept inputs, beside the
       plain version and the bound (bytes at 4L a row of L lanes); one
       kernels-line entry per packed kernel, lane count and shape, with
       its launches on the packed main path.
  8. search stats (search_stats=True: the reference's per-event "stats"
     block), K2's stats instantiation, the competition race and the host
     checkers:
     * main path, each history once: the dense 10k-op check
       (`closure-iters` all -1 where K1 ran), the six golden queue/set
       histories and the 1000-op FIFO (K2's stats instantiation, then K4),
       the two-lane set with config_pack, the 84-key dense batch and the
       28-key sparse batch (with the pad extras) through `independent`,
       the 92-key dense batch (the 84 and eight wider keys) through
       `engine.check_batch`, and one key escalated from the 28; every
       block equal to the reference's (REF_STATS, recorded on the CPU by
       tests/torch_record_stats_refs.py), `closure-iters` too but in the
       dense engine's blocks;
     * parity of K2's stats instantiation, single and batched, at one,
       two and three lanes, against its plain version bit for bit (rows,
       meta, swork and the probe-length histogram) on the seeded cases at
       probe_limit 2 and 32 and on inputs kept from that path;
     * timing per launch, stats on against stats off on the same inputs;
     * the race: `Linearizable(model, "competition")` on the 10k-op
       history, its twin and two golden invalid histories ("torch" among
       the arms, the reference's verdicts, winner and wall printed), then
       `"packed"` and `"linear"` on the golden invalid histories (the
       reference's final-paths from the WGL re-search, REF_CHECKERS) with
       linear.svg written into a temporary store. The race returns only
       once its device arm has stopped (the race's cancel), and no
       device arm may run on after it.
  9. resumable checks, streaming sessions and the pipelined batch, over
     the kernels above started from resumed carries:
     * "resumable": `engine.check_encoded_resumable` on the 1000-op FIFO
       (K2, then K4) with a checkpoint every 256 events saved to .npz, a
       resume from the second file, both equal to the one-shot check;
       the 400-op unordered queue from capacity 64 (the capacity doubles
       inside chunks) with every checkpoint equal, array for array, to
       the reference's (REF_CHECKPOINTS, tests/torch_record_checkpoint_
       refs.py), again after a resume;
     * "stream": `extend.HistorySession` fed deltas of 50 ops of the
       unordered queue and the corrupted FIFO, each check equal to the
       one-shot check of its prefix, the FIFO's early counterexample
       final, and a freeze/thaw mid-stream that resumes without a
       launch;
     * "stream batch": 14 sparse-batch keys (12 and the twins of keys 0
       and 6) in four deltas through
       `extend.advance_sessions` (batched K2 and K4 from each key's
       carry, launches printed), each key equal to a solo session's
       check and to REF_SPARSE_BATCH's verdicts;
     * "pipeline": the 92-key batch through `engine.check_batch(
       pipeline=True)` equal to REF_BATCH (K1's persistent batched scan
       issued a chunk at a time), a second call all cache hits and no
       encode; the 84 keys' pipelined and serial walls with the
       encode / issue / device split, and their encode on one thread
       and on eight.
 10. "serve", the streaming checker service (`jepsen_tpu_torch.serve`)
     over the sessions of item 9, no kernel of its own:
     * the entry point, `python -m jepsen_tpu_torch.serve --model
       cas-register --wal-dir D --host 127.0.0.1 --ingress-port 0`, as a
       child process with two tenants: keys 0-38 of multikey-84 and the
       six corrupted keys (45 keys, half to each tenant) POSTed to
       /v1/deltas in four deltas a key with bearer tokens, the child
       SIGKILLed after every key's second delta and restarted on the
       same WAL (the restart replays it); a re-sent delta 2 answers
       duplicate, an unauthenticated POST 401, then deltas 3-4 and
       POST /v1/finalize for each key, and {"op": "stop"} on stdin ends
       the child with exit 0. Each key's verdict and failing op equal
       REF_BATCH's, and its contract fields the card's one-shot
       `sparse.check_encoded` (run in a thread here while the child
       works);
     * in process, `CheckerService(UnorderedQueue(), capacity=512)`
       through `run_stdio`: 14 keys of sparse-batch-28 in four deltas a
       key, every key evicted to the checkpoint store and thawed
       between deltas 2 and 3; each key equal to REF_SPARSE_BATCH's
       verdict and failing op and to a solo session fed the same
       deltas; the worker's batched and single K2 and K4 launches,
       zeroed just before and read just after.
 11. "fleet", the serve fleet (`serve.ring`, `serve.fleet`, the ops
     endpoint `obs.httpd`) over the service of item 10, no kernel of its
     own:
     * two replicas of the entry point as child processes with
       `--ops-port 0 --ingress-port 0`, A with
       JEPSEN_TPU_TORCH_SERVE_REPL=sync and `--repl-dir` B's WAL's repl/
       mirror: 18 register keys (multikey-84's keys 42, 45, ..., 75 and
       the six corrupted keys) routed by `HashRing(["A", "B"])` in four
       deltas; after delta 2 A is SIGKILLed and its WAL dir deleted, and
       `FleetSupervisor` over both ops endpoints (the real HTTP fetch,
       interval 0.2 s, threshold 2) declares A dead and re-homes its keys
       onto B from the mirror through B's POST /adopt, within a bounded
       wait; A's re-sent delta 2 answers duplicate on B, deltas 3-4 go to
       the supervisor's owner and every key is finalized: each equal to
       REF_BATCH's verdict and failing op. Prints the seconds from the
       kill to "dead", the rehome's, adoption to the last verdict, the
       keys moved and the bytes in B's mirror;
     * `serve.ring.Router` in process over two
       `CheckerService(UnorderedQueue(), capacity=512)` on the card, six
       keys of `_stream_batch_keys()` in four deltas: after delta 2 one
       replica is closed and `Router.rehome`d, and a joining replica,
       its worker started only once their delta 3 is queued, takes two
       keys at capacity 16,384 through `Router.migrate_key`, so they
       resume in one batched leg on K4's route; each key equal to
       REF_SPARSE_BATCH's verdict and failing op and to a solo session
       fed the same deltas; K2 and K4 (single and batched) launched,
       zeroed just before and read just after, and batched K4 in the
       joining replica's first batch.
 12. the mesh paths at one NCCL rank (`meshplan.local_mesh()`: NCCL
     cannot put two ranks on one card), over K1, K2, K3 and K4, no
     kernel of their own; every reference value from
     tests/torch_record_sharded_refs.py:
     * "sharded resumable": `check_encoded_sharded_resumable` of the
       full-width pair's encoded valid history (not encoded again), a
       checkpoint every 256 events, each equal to the reference's
       (REF_SHARDED_RESUMABLE), the result equal to the pair's one-shot
       check of this run, and a resume from the middle checkpoint via
       .npz to the same result; K3's grid launched;
     * "sharded stats": `check_encoded_sharded(search_stats=True)` of
       `adversarial_register_history(600, 12)`: the block equal to the
       reference's (REF_SHARDED_STATS) but for the probe histogram, all
       zeros where K3 ran (the reference's fused kernel's);
     * "elastic": `check_encoded_sharded_elastic` of the 400-op queue
       from capacity 64: one rung, then the table doubles; the verdict
       fields and "reshard" equal REF_ELASTIC;
     * "mesh batch": `check_batch(mesh=)` of multikey-84 (batched K1) and
       of the 28 sparse keys (batched K2 and K4), equal to REF_BATCH and
       REF_SPARSE_BATCH;
     * "steal": `check_batch(steal=True, mesh=)` of
       `elastic.forced_skew_histories()` equal to the static batch of the
       same keys and to REF_STEAL, the scheduler's accounting too; both
       walls printed.
 13. "elle": the transactional cycle checkers with their SCC closure on
     the card (`elle.device_sccs` -> `elle.scc_labels`: R := A | I
     squared ceil(log2 n) times by `torch.mm` on bf16 operands with an
     fp32 product, a plain product and no kernel of the kernels line):
     * `device_sccs` on seeded random graphs (tests/torch_elle_cases.py)
       at n = 1,024, 4,096 and 16,384 (about 2n edges and one planted
       SCC), each equal to the port's `tarjan_sccs` in the device route's
       order (components by smallest node, members sorted);
     * the closure timed with CUDA events at n = 1,024, 4,096, 10,000
       and 16,384, beside its bound (2 n^3 steps at the bf16 peak) and
       its peak device memory;
     * `workloads.cycle.AppendChecker` (elle's defaults, and 10 keys of
       1-4 mops) and `WrChecker` (linearizable-keys, wfr-keys) with the
       realtime graph on simulated histories of 10,000 committed
       transactions by 10 processes, each valid and an invalid twin with
       a lost update, an aborted read, an intermediate read, a non-prefix
       read (list-append) and a bounded stale read: each result's
       valid?, anomaly types and the sha256 of its anomalies' canonical
       JSON equal to the reference's (REF_ELLE, from
       tests/torch_record_elle_refs.py), each check down the device
       route once; the seconds of each, split into history-to-graph,
       the closure and the cycle search;
 14. "probe": `probe.probe_json(timeout=60, retries=1)` healthy on the
     cuda platform with the card's device count, the circuit breaker's
     default probe True, and a `probe.ProbeWatch` of interval 1 s ok
     after its first tick with its gauges at 1 and about 0 (stopped
     before a second child starts).
 15. "telemetry": the telemetry core over the card's paths — a dense
     single check (K1), pipelined batches of three sparse queue keys of
     the sparse batch's layout (batched K2, and batched K4 at the 4,096
     tier) and of register keys (batched K1), through
     `engine.check_batch(pipeline=True)`, and a one-rank sharded check
     (K3's grid: `adversarial_register_history(40, 12)` at capacity
     2^17):
     * tracing off against JEPSEN_TPU_TORCH_TRACE on at the main path's
       sizes (the 10k-op adversarial history, the queue keys with
       multikey-84), warm: the results equal field for field; the
       Chrome trace holds the reference's span tree (engine.encode and
       bitdense.check; pipeline.run over its prepare, encode, dispatch,
       finalize and sparse spans, engine.sparse_batch under
       pipeline.sparse; sharded.search over sharded.tier) and a
       `bucket-{tier}` device track a dense bucket;
     * smaller inputs (a 300-op dense check, eight register keys, the
       same sharded check) off, then all three traced inside one
       `torch.profiler` capture (JEPSEN_TPU_TORCH_PROFILE on; the checks'
       own capture sites join it): the results equal the untraced ones,
       and every port kernel of the capture (K1, batched K1, K2, K4, K3)
       is tied by its correlation id to the `bitdense single …`,
       `bitdense K…`, `sparse K…` or `sharded N…` annotation around its
       launch, K1 and K2 one kernel a launch;
     * each run launches its path's kernels (counts zeroed just before);
     * prints each warm wall off and traced, the profiled inputs' off
       and in-capture walls, the capture's own cost, the span count, the
       trace's bytes, and the disabled span's CPU cost a call on the
       card's host.
  Launch counts are zeroed just before each main-path check and read just
  after; each check must have launched the kernel of its route.

Prints the timings, each phase's seconds, a {"kernels": [...]} line and
the card's name and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises, so the exit code is not 0 and that line is not
printed. Without a CUDA device it exits with code 1 before doing anything.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261017
MAIN_SHAPE = (18, 13)   # (S, C) of adversarial_register_history(10000, 12)
WIDE_SHAPE = (22, 17)   # (S, C) of adversarial_register_history(1000, 16)
S_WIDE_SHAPE = (40, 12)  # more than 32 states: two source words a mask
TIMED_PAIRS = 200       # closure inputs recorded per shape for timing
PLAIN_TIMED_PAIRS = 20

# H100 SXM rates (NVIDIA's data sheet, at the 700 W limit): HBM3 bytes/s,
# and int32 operations/s on the CUDA cores — 64 INT32 lanes per SM, 132
# SMs, 1.98 GHz boost (half the lane rate behind the sheet's 67 TFLOP/s
# float32, which counts an FMA as two operations).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _rand_case(rng, S: int, C: int, kind: str, dev):
    """Random closure inputs: "sparse" selects each (j, s, t) with
    probability 0.08 from 3 seed configurations; "register" gives most
    (j, s) one target t, as a register's step does, from a B with 30% of
    its words random."""
    W = max(1, (1 << C) // 32)
    if kind == "sparse":
        sel = np.where(rng.random((C, S, S)) < 0.08, -1, 0).astype(np.int32)
        B = np.zeros((S, W), np.uint32)
        for _ in range(3):
            s, m = rng.integers(S), rng.integers(1 << C)
            B[s, m // 32] |= np.uint32(1) << np.uint32(m % 32)
    else:
        sel = np.zeros((C, S, S), np.int32)
        t = rng.integers(S, size=(C, S))
        live = rng.random((C, S)) < 0.7
        jj, ss = np.nonzero(live)
        sel[jj, ss, t[jj, ss]] = -1
        B = rng.integers(0, 1 << 32, size=(S, W), dtype=np.uint64) \
            .astype(np.uint32)
        B[rng.random((S, W)) >= 0.3] = 0
    return (torch.from_numpy(sel).to(dev),
            torch.from_numpy(B.view(np.int32)).to(dev))


def phase_build() -> float:
    from jepsen_tpu_torch import kernels
    secs = kernels.build_all()
    print(f"build: {', '.join(kernels.SOURCES.values())} in {secs:.3f} s")
    for name in kernels.SOURCES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"build: {name}: {line.strip()}")
    return secs


def phase_parity(dev) -> dict:
    """K1 against the plain closure, in every layout the kernel can run
    each shape in (`closure_plans`: the gate's choice through the
    wrapper, the others forced): at the main path's two shapes and at a
    shape with two source words (S > 32). Returns per (S, C) the largest
    |difference| over every word compared (0: bit-identical)."""
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    rng = np.random.default_rng(SEED)
    limits = ck.card_limits(dev)
    worst = {}
    for S, C in (MAIN_SHAPE, WIDE_SHAPE, S_WIDE_SHAPE):
        layout = ck.kernel_layout(S, C)
        plans = ck.closure_plans(S, C, *limits)
        _require(plans[layout] == ck.device_plan(S, C, dev),
                 f"K1 plans at S={S} C={C}")
        worst[(S, C)] = 0
        for kind in ("sparse", "register"):
            for _ in range(3):
                sel, B = _rand_case(rng, S, C, kind, dev)
                want = ck.closure_fixpoint_reference(sel, B, C)
                got = ck.closure_fixpoint(sel, B, C)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                worst[(S, C)] = max(worst[(S, C)], err)
                _require(torch.equal(got, want),
                         f"K1 differs from the plain closure at S={S} "
                         f"C={C} ({kind}, {layout} layout)")
                for name, plan in plans.items():
                    out = torch.empty_like(B)
                    ck._launch(sel, B, out, C, plan=plan)
                    inplace = B.clone()
                    ck._launch(sel, inplace, inplace, C, plan=plan,
                               run=torch.ones((), dtype=torch.bool,
                                              device=dev))
                    skipped = B.clone()
                    ck._launch(sel, skipped, skipped, C, plan=plan,
                               run=torch.zeros((), dtype=torch.bool,
                                               device=dev))
                    torch.cuda.synchronize()
                    err = int((out.long() - want.long()).abs().max())
                    worst[(S, C)] = max(worst[(S, C)], err)
                    _require(torch.equal(out, want),
                             f"K1 ({name} layout) differs at S={S} C={C}")
                    _require(torch.equal(inplace, want),
                             f"in-place K1 ({name}) differs at S={S} C={C}")
                    _require(torch.equal(skipped, B),
                             f"K1 ({name}) with run=False changed B at "
                             f"S={S} C={C}")
        ran = ", ".join(f"{n} k={p['cluster']} Wb={p['block_words']}"
                        for n, p in plans.items())
        print(f"parity: K1 == plain closure at S={S} C={C} (gate: "
              f"{layout}; {ran}), 6 random cases each, in place and "
              f"skipped")
    return worst


def _plain_closure(sel, B, C, *, run=None, out=None):
    """closure_fixpoint with the plain version on any device. `run` is
    ignored, as on the CPU: the scan discards the closure of an event
    after a failure."""
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    res = ck.closure_fixpoint_reference(sel, B, C)
    if out is None:
        return res
    return out.copy_(res)


def _check(h, dev, plain: bool):
    """One check through the checker on `dev`; with `plain` the scan's
    closure is the plain version (swapped in at the wrapper's seam)."""
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    real = ck.closure_fixpoint
    if plain:
        ck.closure_fixpoint = _plain_closure
    try:
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        r = Linearizable(CASRegister(None), "torch", device=dev).check({}, h)
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0, ck.launches
    finally:
        ck.closure_fixpoint = real


def phase_main_path(dev) -> dict:
    """The three K1 checks, and shorter twins held against the plain
    closure; returns K1's launches per (S, C) shape of the three."""
    from jepsen_tpu_torch import histories
    adv = histories.adversarial_register_history
    imp = histories.with_impossible_read
    # (name, history, valid?, one of the three, held against plain)
    cases = [
        ("adv-10k-k12 valid", adv(n_ops=10000, k_crashed=12), True, True,
         False),
        ("adv-10k-k12 impossible read", imp(adv(n_ops=10000, k_crashed=12)),
         False, True, False),
        ("adv-1k-k16 valid", adv(n_ops=1000, k_crashed=16), True, True,
         True),
        ("adv-2k-k12 valid", adv(n_ops=2000, k_crashed=12), True, False,
         True),
        ("adv-600-k6 impossible read", imp(adv(n_ops=600, k_crashed=6)),
         False, False, True),
    ]
    by_shape: dict = {}
    for name, h, want, main, plain in cases:
        r, secs, n = _check(h, dev, plain=False)
        shape = (r["states"], r["slots"])
        if main:
            by_shape[shape] = by_shape.get(shape, 0) + n
        print(f"main: {name}: valid?={r['valid?']} closure={r['closure']} "
              f"S={r['states']} C={r['slots']} wall {secs:.3f} s, "
              f"K1 launches {n}")
        _require(n > 0, f"{name}: K1 was never launched")
        _require(r["closure"] == "cuda", f"{name}: closure {r['closure']}")
        _require(r["valid?"] is want, f"{name}: valid? {r['valid?']}")
        if want is False:
            _require(r["op"]["value"] == 999 and r.get("final-paths")
                     and "final-paths-window" in r,
                     f"{name}: counterexample {r.get('op')} "
                     f"{r.get('final-paths-window')}")
        if not plain:
            continue
        p, psecs, pn = _check(h, dev, plain=True)
        print(f"main: {name}: plain closure wall {psecs:.3f} s, "
              f"K1 launches {pn}")
        _require(pn == 0, f"{name}: plain path launched K1")
        _require(_strip(r) == _strip(p),
                 f"{name}: K1 and plain results differ: "
                 f"{sorted(k for k in _strip(r) if r.get(k) != p.get(k))}")
        _require(p["closure"] == "torch", f"{name}: plain closure "
                                          f"reported {p['closure']}")
    # the invalid twin's read of 999 adds a state: it runs at S=19
    _require({MAIN_SHAPE, WIDE_SHAPE} <= set(by_shape),
             f"main path ran at shapes {sorted(by_shape)}")
    return by_shape


def _strip(r: dict) -> dict:
    return {k: v for k, v in r.items() if k != "closure"}


def phase_oracle(dev) -> None:
    """Small seeded histories: the port on the card against the host WGL
    search (the repository's oracle)."""
    from jepsen_tpu_torch import histories
    from jepsen_tpu_torch.checker import wgl
    from jepsen_tpu_torch.models import CASRegister
    n = 0
    for seed in range(4):
        h = histories.rand_register_history(n_ops=300, seed=seed)
        for hh in (h, histories.corrupt_history(h, seed=seed)):
            r, _, launches = _check(hh, dev, plain=False)
            w = wgl.analysis(CASRegister(None), hh)
            _require(r["valid?"] == w["valid?"],
                     f"seed {seed}: port {r['valid?']} wgl {w['valid?']}")
            _require(launches > 0, f"seed {seed}: K1 never launched")
            n += 1
    print(f"oracle: {n} seeded 300-op histories agree with host WGL")


def _record_closure_inputs(h, dev, stride: int):
    """Run the check once with K1 and keep (sel, B) of every
    `stride`-th closure call, as the scan hands them to K1."""
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    real = ck.closure_fixpoint
    pairs = []
    calls = [0]

    def recording(sel, B, C, **kw):
        if calls[0] % stride == 0 and len(pairs) < TIMED_PAIRS:
            pairs.append((sel.clone(), B.clone(), C))
        calls[0] += 1
        return real(sel, B, C, **kw)

    ck.closure_fixpoint = recording
    try:
        _check(h, dev, plain=False)
    finally:
        ck.closure_fixpoint = real
    return pairs


def _time_launches(fn, args: list, reps: int) -> float:
    """Mean device milliseconds per call of fn(*a) over `args`, from CUDA
    events. The stream first sleeps so that the host has queued every
    launch before the first one runs: the events then time the kernels,
    not the host's launch rate."""
    for a in args[:10]:
        fn(*a)                                            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        for a in args:
            fn(*a)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(args))


def phase_timing(dev, shape, h, stride: int) -> dict:
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    S, C = shape
    pairs = _record_closure_inputs(h, dev, stride)
    _require(all(p[0].shape == (C, S, S) for p in pairs),
             f"recorded closure inputs are not at S={S} C={C}")
    W = pairs[0][1].shape[1]

    def kernel(sel, B, out):
        ck.closure_fixpoint(sel, B, C, out=out)

    ms = _time_launches(kernel, [(sel, B, torch.empty_like(B))
                                 for sel, B, _ in pairs], reps=3)
    # every layout the shape can take (the gate's too), forced
    layout_ms = {}
    for name, plan in ck.closure_plans(S, C, *ck.card_limits(dev)).items():
        def forced(sel, B, out, plan=plan):
            ck._launch(sel, B, out, C, plan=plan)
        layout_ms[name] = _time_launches(
            forced, [(sel, B, torch.empty_like(B)) for sel, B, _ in pairs],
            reps=3)
    plain_ms = _time_launches(ck.closure_fixpoint_reference,
                              pairs[:PLAIN_TIMED_PAIRS], reps=1)
    # the least time: each input read once and B' written once; and the
    # operations these very inputs need at least: one pass over sel, then
    # one OR pass, an OR per selected (j, s, t) and target word — all W
    # words for j < 5, the W/2 words with mask bit j set for j >= 5 (the
    # plain closure's expansions, reported beside, are more)
    nbytes = (C * S * S + 2 * S * W) * 4
    words = torch.tensor([W if j < 5 else W // 2 for j in range(C)],
                         dtype=torch.float64)
    ops, exps = [], []
    for sel, B, _ in pairs:
        exps.append(ck.closure_reference_expansions(sel, B, C)[1])
        ops.append(C * S * S + float(((sel != 0).sum((1, 2)).double().cpu()
                                      * words).sum()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = float(np.mean(ops)) / INT32_OPS_PER_S * 1e3
    out = {"S": S, "C": C, "W": W, "layout": ck.kernel_layout(S, C),
           "plan": ck.device_plan(S, C, dev), "layout_ms": layout_ms,
           "pairs": len(pairs), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "mean_expansions": float(np.mean(exps)),
           "mean_ops": float(np.mean(ops)),
           "bytes_ms": t_bytes, "ops_ms": t_ops}
    print("timing: " + json.dumps(out))
    return out


# ------------------------------------------------------- the per-key batch

BATCH_KEYS = 84        # the bench's multi-key shape (bench.py:80-83)
BATCH_OPS = 120
# The reference's per-key results (jepsen_tpu.parallel.engine.
# check_batch_encoded on the CPU, its XLA closure) on the keys of
# _batch_keys(): a digest of every field but `closure`, key by key in
# input order (_batch_digest), and the invalid keys' failing op and event.
REF_BATCH = {
    "multikey-84": {"keys": 84, "digest": "3980498c79987a26", "invalid": {}},
    "multikey-84+8": {
        "keys": 92, "digest": "5671ea508e9716b3",
        "invalid": {
            85: {"fail-event": 984, "op": {"process": 90, "f": "read",
                                           "value": 999, "index": 1984}},
            86: {"fail-event": 51, "op": {"process": 0, "f": "read",
                                          "value": 1003, "index": 151}},
            87: {"fail-event": 14, "op": {"process": 11, "f": "read",
                                          "value": 1001, "index": 45}},
            88: {"fail-event": 11, "op": {"process": 11, "f": "read",
                                          "value": 1000, "index": 33}},
            89: {"fail-event": 41, "op": {"process": 11, "f": "read",
                                          "value": 1002, "index": 117}},
            90: {"fail-event": 25, "op": {"process": 11, "f": "read",
                                          "value": 1001, "index": 89}},
            91: {"fail-event": 77, "op": {"process": 5, "f": "read",
                                          "value": 1002, "index": 191}}}},
}


def _batch_keys():
    """(multikey, extra): the bench's 84 keys (`sec_multikey`: 120 ops,
    14 processes, seeds 2024 + k), and 8 more — two
    `adversarial_register_history(1000, 16)` keys (S=22/23, C=17: a bucket
    of their own, K1 in a cluster of 16), the second with an impossible
    read, and six corrupted 120-op keys."""
    from jepsen_tpu_torch import histories
    multikey = [histories.rand_register_history(
        n_ops=BATCH_OPS, n_processes=14, n_values=5, crash_p=0.005,
        fail_p=0.05, busy=0.8, seed=2024 + k) for k in range(BATCH_KEYS)]
    adv = histories.adversarial_register_history(n_ops=1000, k_crashed=16)
    extra = [adv, histories.with_impossible_read(adv)]
    for k in range(6):
        h = histories.rand_register_history(
            n_ops=BATCH_OPS, n_processes=14, n_values=5, crash_p=0.005,
            fail_p=0.05, busy=0.8, seed=3000 + k)
        extra.append(histories.corrupt_history(h, seed=k))
    return multikey, extra


def _batch_digest(rs: list) -> dict:
    import hashlib
    strip = [{k: v for k, v in r.items() if k != "closure"} for r in rs]
    return {"keys": len(rs),
            "digest": hashlib.sha256(json.dumps(strip, sort_keys=True,
                                                default=repr).encode())
            .hexdigest()[:16],
            "invalid": {i: {"fail-event": r["fail-event"], "op": r["op"]}
                        for i, r in enumerate(rs) if r["valid?"] is False}}


def _bucket_chunks(encs) -> int:
    """The chunks of event rows of every bucket of the batch (sel built
    at most `bitdense.SEL_CHUNK_ELEMS` int32s at once): one batched scan
    launch each."""
    from jepsen_tpu_torch.parallel import bitdense, engine
    from jepsen_tpu_torch.parallel import encode as enc
    buckets: dict = {}
    for e in encs:
        buckets.setdefault(engine.bucket_key(e.n_slots, "tier"), []).append(e)
    n = 0
    for sub in buckets.values():
        _, _, S, C, R = enc.pad_batch(sub, min_slots=5)
        chunk = max(1, bitdense.SEL_CHUNK_ELEMS // (len(sub) * C * S * S))
        n += -(-R // chunk)
    return n


def _batch_check(model, hs, dev):
    """engine.check_batch on the card, the launch counts zeroed just
    before and read just after."""
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import engine
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    rs = engine.check_batch(model, hs, device=dev)
    torch.cuda.synchronize()
    return rs, time.perf_counter() - t0, ck.batch_launches, ck.launches


def _record_batch_inputs(model, encs, dev) -> list:
    """Run the batch once and keep the inputs of every batched scan call
    (one a chunk of event rows) as the scan hands them to the kernel:
    (sel, B, ok, fail_r, slot, real, r0, C), the carry as it was before
    the call."""
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import engine
    real = ck.closure_scan_batch
    kept = []

    def recording(sel, B, ok, fail_r, slot, real_, r0, C, **kw):
        kept.append((sel.clone(), B.clone(), ok.clone(), fail_r.clone(),
                     slot.clone(), real_.clone(), r0, C))
        return real(sel, B, ok, fail_r, slot, real_, r0, C, **kw)

    ck.closure_scan_batch = recording
    try:
        engine.check_batch_encoded(model, encs, device=dev)
        torch.cuda.synchronize()
    finally:
        ck.closure_scan_batch = real
    return kept


def phase_batch_main(dev) -> dict:
    """The per-key batch (jepsen.independent's shape) through
    `engine.check_batch` and the port's `independent` checker: the 84
    keys alone (a cold run, then the warm wall, median of 3), the same
    84 keys one by one through `check_encoded_bitdense`, and the 92-key
    batch; each result equal to the reference's (REF_BATCH) and to the
    port's own single-key dense check of that key; one batched scan
    launch per chunk of event rows of each bucket, exactly."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.parallel import bitdense, closure_kernels as ck
    from jepsen_tpu_torch.parallel import encode as enc
    multikey, extra = _batch_keys()
    model = CASRegister()
    out = {}
    t0 = time.perf_counter()
    encs = [enc.encode(model, h) for h in multikey + extra]
    print(f"batch: encoded {len(encs)} keys in "
          f"{time.perf_counter() - t0:.3f} s")
    singles = []
    for e in encs:
        r = bitdense.check_encoded_bitdense(e, device=dev)
        singles.append({k: r.get(k) for k in ("valid?", "op",
                                              "fail-event")})
    for name, hs in (("multikey-84", multikey),
                     ("multikey-84+8", multikey + extra)):
        chunks = _bucket_chunks(encs[:len(hs)])
        walls = []
        for _ in range(4 if name == "multikey-84" else 1):
            rs, secs, n, n1 = _batch_check(model, hs, dev)
            walls.append(secs)
            _require(n == chunks, f"{name}: {n} batched scan launches, "
                                  f"{chunks} chunks of event rows in its "
                                  f"buckets")
            _require(n1 == 0, f"{name}: {n1} single-key K1 launches")
        got = _batch_digest(rs)
        _require(got == REF_BATCH[name],
                 f"{name}: results differ from the reference's: {got}")
        _require(all(r["closure"] == "cuda" and r["engine"] == "bitdense"
                     for r in rs), f"{name}: closure or engine")
        for i, r in enumerate(rs):
            _require({k: r.get(k) for k in singles[i]} == singles[i],
                     f"{name}: key {i} differs from its single check: "
                     f"{r} {singles[i]}")
        warm = sorted(walls[1:])[len(walls[1:]) // 2] if len(walls) > 1 \
            else None
        out[name] = {"launches": n, "chunks": chunks, "cold_s": walls[0],
                     "warm_s": warm, "warm_runs": walls[1:],
                     "invalid": len(got["invalid"])}
        print(f"main: batch {name}: {len(hs)} keys, {len(got['invalid'])} "
              f"invalid, == REF_BATCH and the single-key checks; batched "
              f"scan launches {n} (= chunks of event rows of its buckets); "
              f"wall cold {walls[0]:.3f} s" + (
                  f", warm median of 3 {warm:.3f} s {walls[1:]}" if warm
                  else ""))
    # the 84 keys one by one, as a caller without the batch would
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        for h in multikey:
            bitdense.check_encoded_bitdense(enc.encode(model, h),
                                            device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["one-by-one"] = {"wall_s": sorted(walls)[1], "runs": walls,
                         "launches": ck.launches}
    print(f"main: the 84 keys one by one (check_encoded_bitdense): wall "
          f"median of 3 {sorted(walls)[1]:.3f} s {walls}, single-key K1 "
          f"launches {ck.launches}")
    # the same 92 keys through the port's jepsen.independent, as one
    # history of keyed ops (key after key: each key's subhistory is its
    # history above)
    ops = []
    for k, h in enumerate(multikey + extra):
        for o in h:
            o = dict(o)
            o["value"] = independent.KV(k, o.get("value"))
            ops.append(o)
    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    r = independent.checker(linearizable(model, device=dev)).check(
        {}, History.wrap(ops).index())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rs = [{k: v for k, v in r["results"][k].items() if k != "analyzer"}
          for k in range(len(encs))]
    _require(_batch_digest(rs) == REF_BATCH["multikey-84+8"],
             "independent: results differ from the reference's")
    _require(ck.batch_launches == _bucket_chunks(encs),
             f"independent: {ck.batch_launches} batched scan launches")
    _require(r["failures"] == sorted(REF_BATCH["multikey-84+8"]["invalid"])
             and r["valid?"] is False, f"independent: {r['failures']}")
    _require("device-fallback" not in r, "independent: device fallback")
    print(f"main: independent.checker(linearizable(CASRegister())) over "
          f"{len(encs)} keys: failures {r['failures']}, == REF_BATCH, "
          f"batched scan launches {ck.batch_launches}, wall {secs:.3f} s")
    out["independent"] = {"wall_s": secs, "launches": ck.batch_launches}
    out["encs"] = encs
    return out


def _plain_scan(sel, B, ok, fail_r, slot, real, r0, C, traj=None):
    """The plain batched scan on the card (the plain torch closure runs
    far faster there than on the host), row by row. Returns the carry
    after the chunk and the keys that ran each row, [E, K] (for the
    bound's operation count)."""
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    carry = [B.clone(), ok.clone(), fail_r.clone()]
    ran = []
    for i in range(sel.shape[0]):
        ran.append(carry[1] & real[i])
        ck.closure_scan_batch_reference(sel[i:i + 1], *carry, slot[i:i + 1],
                                        real[i:i + 1], r0 + i, C, traj)
    return carry, torch.stack(ran)


def _scan_differs(got, want) -> int:
    """The largest |difference| over the carry (0: bit-identical)."""
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def phase_batch_parity(dev, encs) -> dict:
    """The batched scan against its plain version, bit for bit, in every
    layout each bucket's shape can take (`closure_plans_batch`), on every
    chunk of the 92-key batch — among them keys
    past their last event (pad rows) and keys past their failure, which
    must be left as they were — and once more with stats on in the gate's
    layout (each row's width; iterations -1). Returns per (S, C) the
    largest |difference| (0: bit-identical)."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    kept = _record_batch_inputs(CASRegister(), encs, dev)
    _require(len(kept) == _bucket_chunks(encs),
             f"recorded {len(kept)} chunks")
    limits = ck.card_limits(dev)
    worst: dict = {}
    n_pad = n_fail = 0
    for sel, B, ok, fail_r, slot, real, r0, C in kept:
        E, K, _, S, _ = sel.shape
        R = r0 + E
        traj_w = torch.full((K, R, 2), 7, dtype=torch.int32, device=dev)
        want, _ = _plain_scan(sel, B, ok, fail_r, slot, real, r0, C, traj_w)
        n_pad += int((ok & ~real[-1]).sum())
        n_fail += int(((want[2] >= r0) & ~want[1]).sum())
        plans = {"gate": None, **ck.closure_plans_batch(
            K, S, C, *limits, ck.sm_count(dev))}
        err = 0
        for name, plan in plans.items():
            got = [B.clone(), ok.clone(), fail_r.clone()]
            ck._launch_scan(sel, *got, slot, real, r0, C, plan=plan)
            torch.cuda.synchronize()
            e = _scan_differs(got, want)
            _require(e == 0, f"batched scan ({name}) differs at K={K} S={S} "
                             f"C={C}, rows {r0}..{R - 1}")
            err = max(err, e)
        got = [B.clone(), ok.clone(), fail_r.clone()]
        traj = torch.full((K, R, 2), 7, dtype=torch.int32, device=dev)
        ck.closure_scan_batch(sel, *got, slot, real, r0, C, traj=traj)
        torch.cuda.synchronize()
        _require(_scan_differs(got, want) == 0
                 and torch.equal(traj[..., 0], traj_w[..., 0])
                 and bool((traj[:, r0:, 1] == -1).all()),
                 f"batched scan with stats differs at K={K} S={S} C={C}")
        worst[(S, C)] = max(worst.get((S, C), 0), err)
        print(f"parity: batched scan == plain scan at K={K} S={S} C={C}, "
              f"rows {r0}..{R - 1} (layouts {sorted(plans)}; gate "
              f"{ck.device_plan_batch(K, S, C, dev)}), stats widths too")
    _require(n_pad > 0 and n_fail > 0, f"the chunks leave out {n_pad} pad "
                                       f"keys and fail {n_fail} keys")
    print(f"parity: {n_pad} keys end their chunk on pad rows, {n_fail} fail "
          f"inside one: each left as the plain scan leaves it")
    return worst


def phase_batch_timing(dev, encs) -> dict:
    """The batched scan on the 84-key batch's one chunk: per launch (CUDA
    events, each launch on its own copy of the carry) in the gate's
    layout and in every layout the shape can take, beside the plain scan
    (timed on the card, once) and the bound, and held against the plain
    scan bit for bit (keys past their last event left as they were)."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    kept = _record_batch_inputs(CASRegister(), encs, dev)
    _require(len(kept) == 1, f"{len(kept)} chunks for the 84 keys")
    sel, B, ok, fail_r, slot, real, r0, C = kept[0]
    E, K, _, S, _ = sel.shape
    W = B.shape[2]
    _require((S, C, E) == (6, 15, max(e.n_returns for e in encs)),
             f"84-key batch at S={S} C={C}, {E} rows")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, ran = _plain_scan(sel, B, ok, fail_r, slot, real, r0, C)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    pads = int((~real[-1]).sum())
    _require(pads > 0, "no key of the 84 ends on pad rows")

    def fresh(n):
        return [(B.clone(), ok.clone(), fail_r.clone()) for _ in range(n)]

    def timed(plan):
        def launch(b, o, f):
            ck._launch_scan(sel, b, o, f, slot, real, r0, C, plan=plan)
        runs = fresh(5)
        for a in fresh(1):
            launch(*a)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for a in runs:
            launch(*a)
        end.record()
        torch.cuda.synchronize()
        e = max(_scan_differs(list(a), want) for a in runs)
        return start.elapsed_time(end) / len(runs), e

    plans = ck.closure_plans_batch(K, S, C, *ck.card_limits(dev),
                                   ck.sm_count(dev))
    got = [B.clone(), ok.clone(), fail_r.clone()]
    ck.closure_scan_batch(sel, *got, slot, real, r0, C)
    torch.cuda.synchronize()
    err = _scan_differs(got, want)
    ms, e = timed(None)
    err = max(err, e)
    layout_ms = {}
    for name, plan in plans.items():
        layout_ms[name], e = timed(plan)
        err = max(err, e)
    _require(err == 0, f"batched scan differs from the plain scan at K={K} "
                       f"S={S} C={C}")
    print(f"parity: batched scan == plain scan at K={K} S={S} C={C} over "
          f"{E} rows in layouts {sorted(['gate', *plans])}; {pads} keys "
          f"end on pad rows, unchanged")
    # bytes: the chunk's sel, slot and real read once, the carry read and
    # written once; operations, as K1's: per running key and row one pass
    # over its selects and one OR pass, an OR per selected (j, s, t) and
    # target word — the least a closure does; the plain closure's Jacobi
    # passes, and the kernel's sweeps, are more
    nbytes = 4 * E * K * C * S * S + 5 * E * K + 2 * (4 * K * S * W + 5 * K)
    words = torch.tensor([W if j < 5 else W // 2 for j in range(C)],
                         dtype=torch.float64, device=dev)
    per_row = ((sel != 0).sum((3, 4)).double() * words).sum(2)   # [E, K]
    ops = float((ran.double() * (C * S * S + per_row)).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    plan = ck.device_plan_batch(K, S, C, dev)
    out = {"name": f"closure_scan_batch[K{K},S{S},C{C},E{E}]", "K": K,
           "S": S, "C": C, "W": W, "rows": E, "layout": plan["layout"],
           "plan": plan, "layout_ms": layout_ms, "ms": ms,
           "plain_ms": plain_ms, "max_abs_err": err,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_ms": t_bytes, "ops_ms": t_ops, "ops": ops}
    print("timing: " + json.dumps(out))
    return out


# ---------------------------------------------------------- sparse engine

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "golden"
SPARSE_MODELS = {"fifo-queue": "FIFOQueue", "unordered-queue": "UnorderedQueue",
                 "set": "GSet"}

# The reference's results (jepsen_tpu, JEPSEN_TPU_DEDUPE=hash, on the CPU):
# every field but analyzer, and a digest of final-paths and configs
# (_paths_digest). "route" is the closure the port takes on an H100.
REF = {
    "fifo-valid.edn": {"valid?": True, "max-frontier": 253, "capacity": 1024,
                       "configs-stepped": 2089, "explored": 794624},
    "uqueue-valid.edn": {"valid?": True, "max-frontier": 128,
                         "capacity": 1024, "configs-stepped": 1632,
                         "explored": 666624},
    "gset-valid.edn": {"valid?": True, "max-frontier": 16, "capacity": 1024,
                       "configs-stepped": 297, "explored": 393216},
    "fifo-invalid.edn": {
        "valid?": False, "max-frontier": 5, "capacity": 1024,
        "configs-stepped": 10, "explored": 24576, "fail-event": 2,
        "op": {"process": 2, "f": "dequeue", "value": 1000, "index": 7},
        "paths": "727ecef79e85781a"},
    "uqueue-invalid.edn": {
        "valid?": False, "max-frontier": 32, "capacity": 1024,
        "configs-stepped": 92, "explored": 98304, "fail-event": 7,
        "op": {"process": 2, "f": "dequeue", "value": 1000, "index": 16},
        "paths": "b0450bfaf452a0cb"},
    "gset-invalid.edn": {
        "valid?": False, "max-frontier": 16, "capacity": 1024,
        "configs-stepped": 105, "explored": 230400, "fail-event": 20,
        "op": {"process": 0, "f": "read", "value": [0, 1, 2, 3, 4, 5, 1048],
               "index": 47},
        "paths": "f95482334d86b907"},
    "uqueue-400": {"valid?": True, "max-frontier": 256, "capacity": 1024,
                   "configs-stepped": 25467, "explored": 6447104},
    "gset-400": {"valid?": True, "max-frontier": 1024, "capacity": 1024,
                 "configs-stepped": 75264, "explored": 8192000},
    "fifo-1000": {"valid?": True, "max-frontier": 18610, "capacity": 32768,
                  "configs-stepped": 649022, "explored": 872153088,
                  "route": "cuda-tiled"},
    "fifo-1000 corrupted": {
        "valid?": False, "max-frontier": 8520, "capacity": 16384,
        "configs-stepped": 88757, "explored": 185204736, "fail-event": 395,
        "op": {"process": 5, "f": "dequeue", "value": 1001, "index": 887},
        "final-paths-window": [331, 395], "route": "cuda-tiled",
        "paths": "896dc485b8ac46e0"},
}
EMPTY_PATHS = "32728abe5790daac"   # _paths_digest of a valid result
K2_TIMED = 40   # K2 inputs recorded per history
K4_TIMED = 6    # K4 inputs recorded from the 1000-op FIFO


def _paths_digest(r: dict) -> str:
    import hashlib
    doc = {k: r.get(k) for k in ("final-paths", "configs")}
    return hashlib.sha256(json.dumps(doc, sort_keys=True, default=repr)
                          .encode()).hexdigest()[:16]


def _sparse_cases():
    """(name, model, history) of the sparse main path."""
    from jepsen_tpu_torch import histories, models
    from jepsen_tpu_torch.history import History
    out = []
    for ent in json.loads((GOLDEN / "manifest.json").read_text()):
        if ent["model"] in SPARSE_MODELS:
            out.append((ent["file"],
                        getattr(models, SPARSE_MODELS[ent["model"]])(),
                        History.from_edn((GOLDEN / ent["file"]).read_text())
                        .index()))
            _require(REF[ent["file"]]["valid?"] is ent["valid"],
                     f"{ent['file']}: manifest says {ent['valid']}")
    fifo = histories.rand_fifo_history(1000, n_processes=8, crash_p=0.005,
                                       seed=1)
    out += [
        ("uqueue-400", models.UnorderedQueue(), histories.rand_queue_history(
            400, n_processes=8, crash_p=0.005, seed=1)),
        ("gset-400", models.GSet(), histories.rand_gset_history(
            400, n_processes=10, n_elements=16, crash_p=0.005, seed=1)),
        ("fifo-1000", models.FIFOQueue(), fifo),
        ("fifo-1000 corrupted", models.FIFOQueue(),
         histories.corrupt_history(fifo, seed=0)),
    ]
    _require(len(out) == 10, f"{len(out)} sparse cases")
    return out


def _sparse_counts() -> dict:
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    return {"K2": sk.launches["frontier_closure"],
            "K4": sk.launches["tiled_insert"]}


def _sparse_check(model, h, dev, **kw):
    """One check through the checker on `dev`, launch counts zeroed just
    before and read just after."""
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    torch.cuda.synchronize()
    ck.reset_launches()
    sk.reset_launches()
    t0 = time.perf_counter()
    r = Linearizable(model, "torch", device=dev, **kw).check({}, h)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0, dict(_sparse_counts(), K1=ck.launches)


def _record_sparse(cases, dev) -> dict:
    """K2 and K4 inputs as the main path's scans hand them to the
    wrappers: every K2 call of the golden FIFO history, every 10th of the
    400-op unordered queue, the 1000-op FIFO's calls at capacity 2048,
    and every 97th K4 expansion insert of its capacity-32,768 tier."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    real_k2, real_k4 = sk.frontier_closure, sk.tiled_insert
    rec = {"golden fifo": [], "uqueue-400": [], "fifo-1000 N2048": [],
           "k4": []}
    label = [None]
    seen = [0, 0]

    def k2(step_name, ev, rows, live, run, pl):
        keep = {"fifo-valid.edn": ("golden fifo", 1),
                "uqueue-400": ("uqueue-400", 10),
                "fifo-1000": ("fifo-1000 N2048", 3)}.get(label[0])
        if keep and (label[0] != "fifo-1000" or live.shape[0] == 2048):
            seen[0] += 1
            if seen[0] % keep[1] == 0 and len(rec[keep[0]]) < K2_TIMED:
                rec[keep[0]].append((step_name, {k: v.clone() for k, v in
                                                 ev.items()},
                                     tuple(r.clone() for r in rows),
                                     live.clone(), run.clone()))
        return real_k2(step_name, ev, rows, live, run, pl)

    def k4(c_rows, c_live, table, pl):
        # the expansion inserts (M = N*C candidates; the seed insert of
        # each event has M = N = T/2), sampled across the events
        if table[1].shape[0] == 65536 and c_live.shape[0] != 32768:
            seen[1] += 1
            if seen[1] % 97 == 0 and len(rec["k4"]) < K4_TIMED:
                rec["k4"].append((tuple(r.clone() for r in c_rows),
                                  c_live.clone(),
                                  (tuple(r.clone() for r in table[0]),
                                   table[1].clone()), pl))
        return real_k4(c_rows, c_live, table, pl)

    sk.frontier_closure, sk.tiled_insert = k2, k4
    try:
        for name, model, h in cases:
            if name in ("fifo-valid.edn", "uqueue-400", "fifo-1000"):
                label[0], seen[0], seen[1] = name, 0, 0
                _sparse_check(model, h, dev)
    finally:
        sk.frontier_closure, sk.tiled_insert = real_k2, real_k4
    for k, v in rec.items():
        _require(len(v) > 0, f"no {k} inputs recorded")
    return rec


def _max_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def _parity_cases():
    """tests/torch_parity_cases.py, the seeded K2 and K4 parity inputs the
    cuda-marked tests use too, loaded by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_parity_cases", ROOT / "tests" / "torch_parity_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_sparse_parity(dev, rec) -> dict:
    """K2 and K4 against their plain versions on the card, bit for bit.
    Returns the largest |difference| of each (0: bit-identical)."""
    from jepsen_tpu_torch.parallel import sparse, sparse_kernels as sk
    lib2 = sk._lib("frontier_closure")
    for N, C in ((1024, 8), (2048, 12), (2048, 33)):
        _require(lib2.jt_frontier_closure_smem(N, C, 3)
                 == sk.k2_smem_bytes(N, C), f"K2 layout at N={N} C={C}")
    print(f"parity: shared-memory opt-in {sk.smem_budget(dev)} bytes; K2 "
          f"needs {sk.k2_smem_bytes(1024, 8)} at N=1024 C=8 and "
          f"{sk.k2_smem_bytes(2048, 33)} at N=2048 C=33; K4's grid "
          f"{sk.k4_grid(dev)} blocks of 1,024 threads")
    worst = {"K2": 0, "K4": 0}

    def k2_pair(args, pl):
        got = sk.frontier_closure(*args, pl)
        want = sk.frontier_closure_reference(*args, pl)
        torch.cuda.synchronize()
        err = max(_max_err(got[0], want[0]), _max_err([got[1]], [want[1]]))
        worst["K2"] = max(worst["K2"], err)
        return err, want[1].tolist()

    for label in ("golden fifo", "uqueue-400", "fifo-1000 N2048"):
        for args in rec[label]:
            err, meta = k2_pair(args, 32)
            _require(err == 0, f"K2 differs from the plain closure on a "
                               f"{label} event: meta {meta}")
        print(f"parity: K2 == plain closure on {len(rec[label])} {label} "
              f"events (N={rec[label][0][3].shape[0]}, "
              f"C={rec[label][0][1]['slot_f'].shape[0]})")
    fired = None
    for args in rec["fifo-1000 N2048"] + rec["uqueue-400"]:
        err, meta = k2_pair(args, 2)
        _require(err == 0, f"K2 differs at probe_limit=2: meta {meta}")
        if meta[1] == 1:
            fired = meta
            break
    _require(fired is not None, "probe_limit=2 never overflowed")
    print(f"parity: K2 == plain closure at probe_limit=2 with the probe "
          f"overflow raised (meta {fired})")

    def k4_pair(c_rows, c_live, table, pl):
        want = sk.tiled_insert_reference(c_rows, c_live, table, pl)
        copy = (tuple(r.clone() for r in table[0]), table[1].clone())
        got = sk.tiled_insert(c_rows, c_live, copy, pl)
        torch.cuda.synchronize()
        err = max(_max_err(got[0][0], want[0][0]),
                  _max_err([got[0][1], got[1], got[2], got[3]],
                           [want[0][1], want[1], want[2], want[3]]))
        worst["K4"] = max(worst["K4"], err)
        return err, bool(want[3]), int(want[1].sum())

    rng = np.random.default_rng(SEED)
    T, M = 2048, 1536
    for pl in (32, 2):
        base = rng.integers(0, 1 << 32, size=(3, 700), dtype=np.uint64) \
            .astype(np.uint32).view(np.int32)
        pick = rng.integers(0, 700, size=M)
        c_rows = tuple(torch.from_numpy(np.ascontiguousarray(base[k][pick]))
                       .to(dev) for k in range(3))
        c_live = torch.from_numpy(rng.random(M) < 0.8).to(dev)
        table = sparse._empty_table(T, sparse._rep((), 1, dev))
        err, ovf, n = k4_pair(c_rows, c_live, table, pl)
        _require(err == 0, f"K4 differs on the random insert, "
                           f"probe_limit={pl}")
        print(f"parity: K4 == plain insert, T={T} M={M}, "
              f"probe_limit={pl}: {n} fresh, probe overflow {ovf}")
    for args in rec["k4"]:
        err, ovf, n = k4_pair(*args)
        _require(err == 0, "K4 differs on a recorded 1000-op FIFO insert")
    print(f"parity: K4 == plain insert on {len(rec['k4'])} recorded "
          f"1000-op FIFO inserts (T=65536, M={rec['k4'][0][1].shape[0]})")
    # the seeded cases, on the card
    parity_cases = _parity_cases()
    for name, c_rows, c_live, table, pl in parity_cases.k4_cases() + \
            [parity_cases.k4_wide_case()]:
        args = (tuple(r.to(dev) for r in c_rows), c_live.to(dev),
                (tuple(r.to(dev) for r in table[0]), table[1].to(dev)), pl)
        err, ovf, n = k4_pair(*args)
        _require(err == 0, f"K4 differs from the plain insert: {name}")
        print(f"parity: K4 == plain insert ({name}, T="
              f"{table[1].shape[0]}): {n} fresh of {int(c_live.sum())} "
              f"live, probe overflow {ovf}")
    del args
    for name, step_name, ev, rows, live, run, pl in \
            parity_cases.k2_cases():
        err, meta = k2_pair((step_name, {k: v.to(dev) for k, v in
                                         ev.items()},
                             tuple(r.to(dev) for r in rows), live.to(dev),
                             run.to(dev)), pl)
        _require(err == 0, f"K2 differs from the plain closure: {name}, "
                           f"meta {meta}")
        print(f"parity: K2 == plain closure ({name}): meta {meta}")
    return worst


def phase_sparse_main(dev, cases) -> dict:
    """The sparse checks; returns the K2 and K4 launches of the run, and
    each check's wall ("walls") and result ("results")."""
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import sparse
    total = {"K2": 0, "K4": 0, "walls": {}, "results": {}}
    for name, model, h in cases:
        r, secs, n = _sparse_check(model, h, dev)
        total["walls"][name] = secs
        total["results"][name] = r
        want = REF[name]
        route = want.get("route", "cuda")
        kernel = {"cuda": "K2", "cuda-tiled": "K4"}.get(r.get("closure"))
        print(f"main: {name}: valid?={r['valid?']} closure={r.get('closure')}"
              f" capacity={r.get('capacity')} max-frontier="
              f"{r.get('max-frontier')} wall {secs:.3f} s, launches {n}")
        _require(r.get("closure") == route,
                 f"{name}: route {r.get('closure')}, expected {route}")
        _require(kernel is not None and n[kernel] > 0,
                 f"{name}: {kernel} was never launched")
        for k in ("K2", "K4"):
            total[k] += n[k]
        for k, v in want.items():
            if k == "paths":
                _require(_paths_digest(r) == v,
                         f"{name}: final-paths/configs differ from the "
                         f"reference's")
            elif k != "route":
                _require(r.get(k) == v, f"{name}: {k} {r.get(k)} != {v}")
        _require(r["dedupe"] == "hash", f"{name}: dedupe {r['dedupe']}")
        if r["valid?"]:
            _require(_paths_digest(r) == EMPTY_PATHS, f"{name}: paths")
        else:
            _require(bool(r.get("final-paths")), f"{name}: no final-paths")
        t0 = time.perf_counter()
        rs = sparse.check_encoded(enc.encode(model, h), dedupe="sort",
                                  device=dev)
        torch.cuda.synchronize()
        keys = ("valid?", "fail-event", "op", "max-frontier", "capacity")
        _require({k: rs.get(k) for k in keys} == {k: r.get(k) for k in keys},
                 f"{name}: sort and hash dedupe differ: {rs}")
        print(f"main: {name}: dedupe=sort on the card agrees, "
              f"{time.perf_counter() - t0:.3f} s")
    # one small history against the plain closure, field for field
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    name, model, h = cases[[c[0] for c in cases].index("gset-invalid.edn")]
    r, _, _ = _sparse_check(model, h, dev)
    real = sk.frontier_closure
    sk.frontier_closure = sk.frontier_closure_reference
    try:
        p, secs, n = _sparse_check(model, h, dev)
    finally:
        sk.frontier_closure = real
    _require(n["K2"] == 0 and _strip(p) == _strip(r),
             f"{name}: K2 and plain-closure results differ")
    print(f"main: {name}: plain closure on the card agrees field for "
          f"field, {secs:.3f} s")
    return total


def _time_host(fn, args: list) -> float:
    """Mean milliseconds per call of fn(*a) on the host clock, the card
    synchronised (for the plain versions, which wait on the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in args:
        fn(*a)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(args)


def phase_sparse_timing(dev, rec) -> list:
    """K2 on the 400-op unordered queue's events and K4 on the 1000-op
    FIFO's inserts, per launch with CUDA events (kernel_ab.py's timers:
    K2 also cut short, each K4 launch on its own copy of the table),
    beside the plain versions, the sort closure of the same events and
    the bound."""
    import kernel_ab
    from jepsen_tpu_torch.parallel import sparse, sparse_kernels as sk
    out = []
    k2 = [a + (32,) for a in rec["uqueue-400"]]
    step_name, ev, rows, live, _ = rec["uqueue-400"][0]
    N, C = live.shape[0], ev["slot_f"].shape[0]
    t2 = kernel_ab._time_k2(torch, sk, k2)
    plain_ms = _time_host(sk.frontier_closure_reference, k2[:10])
    rep = sparse._rep((), C, dev)
    step = sparse.STEPS[step_name]
    sort_ms = _time_host(
        lambda s, e, r, lv, run, pl: sparse._sort_event_closure(
            rep, step, e, r, lv, run, N), k2[:10])
    # bytes these events need: the slot tables, the live flags and the
    # live rows in; the frontier (all N rows) and meta out. operations:
    # every candidate (stepped rows x C) stepped and tested (~16 int32
    # ops), every appended row hashed, probed and written (~20)
    metas = [sk.frontier_closure_reference(*a)[1].tolist() for a in k2]
    nbytes = float(np.mean([14 * C + N + 12 * int(a[3].sum()) + 1
                            + 12 * N + 16 for a in k2]))
    ops = float(np.mean([m[3] * C * 16 + m[0] * 20 for m in metas]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t = {"name": f"frontier_closure[N{N},C{C}]", "N": N, "C": C,
         "inputs": len(k2), "ms": t2["ms"], "cut_ms": t2["cut_ms"],
         "host_us": t2["host_us"], "plain_ms": plain_ms,
         "sort_closure_ms": sort_ms, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "mean_iters": float(np.mean([m[2] for m in metas])),
         "mean_rows_out": float(np.mean([m[0] for m in metas]))}
    print("timing: " + json.dumps(t))
    out.append(t)

    k4 = rec["k4"]
    c_rows, c_live, table, pl = k4[0]
    M, T = c_live.shape[0], table[1].shape[0]
    t4 = kernel_ab._time_k4(torch, sk, k4)
    plain_ms = _time_host(sk.tiled_insert_reference, k4[:2])
    # bytes these inserts need: every live flag read and every fresh and
    # off written once; the live candidates' rows read, each table slot
    # they probe read (12 bytes of row, 1 of occupancy) and each one they
    # claim written: the table is updated in place. operations: the live
    # test of every candidate, and for the live ones the hash and its
    # slot, and a compare per probe (~24)
    outs = [sk.tiled_insert_reference(*a) for a in k4]
    live = float(np.mean([int(a[1].sum()) for a in k4]))
    probes = float(np.mean([int((o[2][a[1]] + 1).sum())
                            for a, o in zip(k4, outs)]))
    fresh = float(np.mean([int(o[1].sum()) for o in outs]))
    nbytes = M + 5 * M + 12 * live + 13 * probes + 13 * fresh
    ops = M + live * 24 + probes * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t = {"name": f"tiled_insert[T{T},M{M}]", "T": T, "M": M,
         "inputs": len(k4), "mean_live": live,
         "mean_probes": probes, "mean_fresh": fresh, "ms": t4["ms"],
         "host_us": t4["host_us"], "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print("timing: " + json.dumps(t))
    out.append(t)
    return out


# ------------------------------------------------- the sparse per-key batch

# Jepsen's per-key queue workload on the bench's multi-key layout
# (bench.py:80-85: 120 ops, 14 processes, seeds 2024 + k) on the
# unordered-queue model, cut from 84 keys to 24 (the reference's batch
# took 1,877 s on a CPU for these 28, and ~14 minutes for 12 of the 84;
# PERF.md §4), plus corrupted twins of four of them. Every key packs past
# the dense engine.
SPARSE_BATCH_KEYS = 24
SPARSE_TWINS = (0, 6, 12, 18)
SPARSE_SORT_KEYS = (0, 2, 10, 24)   # cheap keys, and key 0's twin
SPARSE_ESC_CEILING = 4096
SPARSE_K4_TIER = 16384   # the capacity whose batched K4 calls are timed
# The reference's results (jepsen_tpu.parallel.engine.check_batch_encoded
# on the CPU, dedupe "hash" unless named) on _sparse_batch_keys(): the
# digest of every field but `closure` (_batch_digest), each key's
# capacity, and the invalid keys' failing op and event.
REF_SPARSE_BATCH = {
    "uqueue-24+4": {
        "keys": 28, "digest": "f445e21ce09b0403",
        "capacity": [1024, 8192, 1024, 16384, 32768, 16384, 16384,
                     2048, 32768, 32768, 1024, 16384, 512, 32768,
                     1024, 8192, 1024, 32768, 16384, 1024, 4096,
                     4096, 16384, 4096, 1024, 16384, 512, 2048],
        "invalid": {
            24: {"fail-event": 117, "op": {"process": 8, "f": "dequeue",
                 "value": 1001, "index": 223}},
            25: {"fail-event": 103, "op": {"process": 13, "f": "dequeue",
                 "value": 1002, "index": 190}},
            26: {"fail-event": 74, "op": {"process": 6, "f": "dequeue",
                 "value": 1001, "index": 150}},
            27: {"fail-event": 32, "op": {"process": 12, "f": "dequeue",
                 "value": 1002, "index": 66}}}},
    "uqueue-24+4 max4096": {
        "keys": 28, "digest": "b6c75c76d66fabc6",
        "capacity": [1024, 8192, 1024, 16384, 16384, 16384, 16384,
                     2048, 16384, 16384, 1024, 16384, 512, 16384,
                     1024, 8192, 1024, 16384, 16384, 1024, 4096,
                     4096, 16384, 4096, 1024, 16384, 512, 2048],
        "invalid": {
            24: {"fail-event": 117, "op": {"process": 8, "f": "dequeue",
                 "value": 1001, "index": 223}},
            25: {"fail-event": 103, "op": {"process": 13, "f": "dequeue",
                 "value": 1002, "index": 190}},
            26: {"fail-event": 74, "op": {"process": 6, "f": "dequeue",
                 "value": 1001, "index": 150}},
            27: {"fail-event": 32, "op": {"process": 12, "f": "dequeue",
                 "value": 1002, "index": 66}}}},
    "uqueue sort": {
        "keys": 4, "digest": "96459eb7c9457e98",
        "capacity": [1024, 1024, 1024, 1024],
        "invalid": {
            3: {"fail-event": 117, "op": {"process": 8, "f": "dequeue",
                 "value": 1001, "index": 223}}}},
}


def _sparse_batch_keys():
    from jepsen_tpu_torch import histories
    keys = [histories.rand_queue_history(120, n_processes=14, crash_p=0.005,
                                         seed=2024 + k)
            for k in range(SPARSE_BATCH_KEYS)]
    return keys + [histories.corrupt_history(keys[k], seed=k)
                   for k in SPARSE_TWINS]


def _sparse_batch_digest(rs: list) -> dict:
    return dict(_batch_digest(rs), capacity=[r["capacity"] for r in rs])


class _Tiers:
    """Each `sparse._BatchScan` of a run: (K, N, C, R, route) and the
    batched K2 and K4 launches it made, read around its `run`."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        from jepsen_tpu_torch.parallel import sparse, sparse_kernels as sk
        real = self.real = sparse._BatchScan.run
        seen = self.seen

        def run(sc):
            n2 = sk.launches["frontier_closure_batch"]
            n4 = sk.launches["tiled_insert_batch"]
            out = real(sc)
            seen.append({"K": sc.K, "N": sc.N, "C": sc.C, "R": sc.R,
                         "lanes": sc.rep.lanes, "route": sc.closure,
                         "K2": sk.launches["frontier_closure_batch"] - n2,
                         "K4": sk.launches["tiled_insert_batch"] - n4})
            return out

        sparse._BatchScan.run = run
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.parallel import sparse
        sparse._BatchScan.run = self.real


def _sparse_batch_check(model, hs, dev, **kw):
    """engine.check_batch on the card, every launch count zeroed just
    before and read just after -> (results, wall s, counts, tiers)."""
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import engine, sparse_kernels as sk
    torch.cuda.synchronize()
    ck.reset_launches()
    sk.reset_launches()
    with _Tiers() as tiers:
        t0 = time.perf_counter()
        rs = engine.check_batch(model, hs, device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return rs, secs, dict(sk.launches, K1=ck.launches,
                          K1_batch=ck.batch_launches), tiers.seen


def phase_sparse_batch_main(dev) -> dict:
    """The sparse per-key batch (Jepsen's per-key queue workload) through
    `engine.check_batch` and `independent.checker(linearizable(
    UnorderedQueue()))`: the 28 keys at the defaults (capacity 512,
    max_capacity 2^18, dedupe "hash": the cheap keys decide inside K2's
    gate, the hot ones climb into batched K4) cold and warm, the same
    keys one by one through `sparse.check_encoded(capacity=512)`, the
    keys again with max_capacity 4,096 (the single-key escalation and
    its "unknown"), and four cheap keys with dedupe "sort". Every result
    equals the reference's (REF_SPARSE_BATCH); each fused tier launches
    batched K2 once an event row, exactly; batched K2 and K4 both run;
    the main run launches no single-key sparse kernel."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import UnorderedQueue
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import sparse
    hs = _sparse_batch_keys()
    model = UnorderedQueue()
    out = {}

    def held(name, rs, tiers, n):
        got = _sparse_batch_digest(rs)
        _require(got == REF_SPARSE_BATCH[name],
                 f"{name}: results differ from the reference's: {got}")
        for t in tiers:
            if t["route"] == "fused":
                _require(t["K2"] == t["R"] and t["K4"] == 0,
                         f"{name}: fused tier {t}: batched K2 once an "
                         f"event row")
            elif t["route"] == "tiled":
                _require(t["K4"] > 0 and t["K2"] == 0,
                         f"{name}: tiled tier {t}")
        print(f"main: sparse batch {name}: {len(rs)} keys, "
              f"{len(got['invalid'])} invalid, == REF_SPARSE_BATCH; "
              f"capacities {got['capacity']}; launches {n}")
        for t in tiers:
            print(f"main: sparse batch {name}: tier {t}")

    walls = []
    for _ in range(3):
        rs, secs, n, tiers = _sparse_batch_check(model, hs, dev)
        walls.append(secs)
    held("uqueue-24+4", rs, tiers, n)
    _require(n["frontier_closure_batch"] > 0 and n["tiled_insert_batch"] > 0,
             f"uqueue-24+4: batched K2 and K4 must both run: {n}")
    _require(n["frontier_closure"] == n["tiled_insert"] == 0,
             f"uqueue-24+4: a single-key sparse kernel ran: {n}")
    _require({r["closure"] for r in rs} <= {"cuda", "cuda-tiled"}
             and "cuda-tiled" in {r["closure"] for r in rs},
             "uqueue-24+4: closure tags")
    out["main"] = {"cold_s": walls[0], "warm_s": sorted(walls[1:])[0],
                   "warm_runs": walls[1:], "launches": n, "tiers": tiers}
    print(f"main: sparse batch uqueue-24+4: wall cold {walls[0]:.3f} s, "
          f"warm {walls[1:]}")
    # the same keys one by one, as a caller without the batch would
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    singles = [sparse.check_encoded(enc.encode(model, h), capacity=512,
                                    device=dev) for h in hs]
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    for i, (r, s) in enumerate(zip(rs, singles)):
        _require({k: s.get(k) for k in ("valid?", "op", "fail-event")}
                 == {k: r.get(k) for k in ("valid?", "op", "fail-event")},
                 f"key {i}: the single-key check disagrees: {s} {r}")
    out["one_by_one_s"] = one
    print(f"main: the same {len(hs)} keys one by one "
          f"(sparse.check_encoded, capacity 512): {one:.3f} s, verdicts "
          f"agree")
    # the escalation: max_capacity 4,096
    rs2, secs, n2, tiers2 = _sparse_batch_check(
        model, hs, dev, max_capacity=SPARSE_ESC_CEILING)
    held("uqueue-24+4 max4096", rs2, tiers2, n2)
    esc = sum(1 for r in rs2 if r.get("escalated") == "single")
    unknown = sum(1 for r in rs2 if r["valid?"] == "unknown")
    _require(esc > 0 and n2["frontier_closure"] + n2["tiled_insert"] > 0,
             "max4096: no key escalated to the single-key engine")
    out["max4096"] = {"wall_s": secs, "escalated": esc, "unknown": unknown,
                      "launches": n2}
    print(f"main: sparse batch max_capacity {SPARSE_ESC_CEILING}: "
          f"{esc} keys escalated (single), {unknown} unknown, wall "
          f"{secs:.3f} s")
    # dedupe "sort" on four cheap keys
    rs3, secs, n3, tiers3 = _sparse_batch_check(
        model, [hs[i] for i in SPARSE_SORT_KEYS], dev, dedupe="sort")
    held("uqueue sort", rs3, tiers3, n3)
    _require(all(r["closure"] == "torch" and r["dedupe"] == "sort"
                 for r in rs3) and n3["frontier_closure_batch"] == 0,
             "sort: closure tags or a kernel launched")
    out["sort_s"] = secs
    # the same 28 keys through the port's jepsen.independent
    ops = []
    for k, h in enumerate(hs):
        for o in h:
            o = dict(o)
            o["value"] = independent.KV(k, o.get("value"))
            ops.append(o)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = independent.checker(linearizable(model, device=dev)).check(
        {}, History.wrap(ops).index())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = [{k: v for k, v in r["results"][k].items() if k != "analyzer"}
           for k in range(len(hs))]
    _require(_sparse_batch_digest(got) == REF_SPARSE_BATCH["uqueue-24+4"],
             "independent: results differ from the reference's")
    _require(r["failures"] == sorted(REF_SPARSE_BATCH["uqueue-24+4"]
                                     ["invalid"])
             and "device-fallback" not in r, f"independent: {r['failures']}")
    out["independent_s"] = secs
    print(f"main: independent.checker(linearizable(UnorderedQueue())) over "
          f"{len(hs)} keys: failures {r['failures']}, == REF_SPARSE_BATCH, "
          f"wall {secs:.3f} s")
    return out


def _record_sparse_batch(dev) -> dict:
    """From one run of the main batch: the batched K2 calls of its largest
    bucket's first tier (every event row, capacity 512), and every 97th
    expansion insert of batched K4 at capacity 16,384 (6 at most, across
    the tier's rows), as the batch hands them over."""
    from jepsen_tpu_torch.models import UnorderedQueue
    from jepsen_tpu_torch.parallel import encode as enc, engine
    pc = _parity_cases()
    encs = [enc.encode(UnorderedQueue(), h) for h in _sparse_batch_keys()]
    T = 2 * SPARSE_K4_TIER
    seen = [0]

    def wide(a):
        # an expansion insert (M = N*C candidates a key; the seed has N)
        if a[2][1].shape[1] != T or a[1].shape[1] <= T // 2:
            return False
        seen[0] += 1
        return seen[0] % 97 == 0 and seen[0] <= 6 * 97

    k4 = []
    k2 = pc.record_calls(
        "frontier_closure_batch",
        lambda: k4.extend(pc.record_calls(
            "tiled_insert_batch",
            lambda: engine.check_batch_encoded(None, encs, device=dev),
            keep=wide)),
        keep=lambda a: a[4].shape[1] == 512)
    _require(len(k2) > 0 and len(k4) > 0, "no batched inputs recorded")
    K = max(a[4].shape[0] for a in k2)
    k2 = [a for a in k2 if a[4].shape[0] == K]
    tier = engine.bucket_key(k2[0][1]["slot_f"].shape[2], "tier")
    return {"k2": k2, "k4": k4,
            "encs": [e for e in encs
                     if engine.bucket_key(e.n_slots, "tier") == tier]}


def phase_sparse_batch_parity(dev, rec) -> dict:
    """Batched K2 against its plain version, bit for bit, on the first
    tier's first row, a middle one, the first where a key is past its
    last event and the last; batched K4 on one iteration at capacity
    16,384, on its own copy of the table. Returns the largest |difference|
    of each (0: bit-identical)."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    by_row = {a[2]: a for a in rec["k2"]}
    R = max(e.n_returns for e in rec["encs"])
    first_pad = min(e.n_returns for e in rec["encs"])
    worst = {"K2": 0, "K4": 0}
    for r in sorted({0, R // 2, first_pad, R - 1}):
        _require(r in by_row, f"no batched K2 call recorded at row {r}")
        args = by_row[r]
        want = sk.frontier_closure_batch_reference(*args)
        got = sk.frontier_closure_batch(*args)
        torch.cuda.synchronize()
        err = max(_max_err(got[0], want[0]), _max_err([got[1]], [want[1]]))
        worst["K2"] = max(worst["K2"], err)
        idle = int((~args[5]).sum())
        _require(err == 0, f"batched K2 differs from its plain version at "
                           f"row {r}")
        print(f"parity: batched K2 == plain closure at K={args[4].shape[0]}"
              f" N={args[4].shape[1]} C={args[1]['slot_f'].shape[2]}, row "
              f"{r} of {R}, {idle} keys not running")
    _require(idle > 0, "the last row leaves no key out")
    c_rows, c_live, table, pl = rec["k4"][len(rec["k4"]) // 2]
    want = sk.tiled_insert_batch_reference(c_rows, c_live, table, pl)
    copy = (tuple(x.clone() for x in table[0]), table[1].clone())
    got = sk.tiled_insert_batch(c_rows, c_live, copy, pl)
    torch.cuda.synchronize()
    err = max(_max_err(got[0][0], want[0][0]),
              _max_err([got[0][1], got[1], got[2], got[3]],
                       [want[0][1], want[1], want[2], want[3]]))
    worst["K4"] = err
    _require(err == 0, "batched K4 differs from its plain version")
    print(f"parity: batched K4 == plain insert at K={c_live.shape[0]} "
          f"M={c_live.shape[1]} T={table[1].shape[1]}: "
          f"{int(want[1].sum())} fresh of {int(c_live.sum())} live, probe "
          f"overflow {want[3].tolist()}")
    return worst


def phase_sparse_batch_timing(dev, rec) -> list:
    """Batched K2 on every row of the first tier and batched K4 on the
    recorded inserts (each launch on its own copy of the table), per
    launch with CUDA events, beside their plain versions and bounds."""
    import kernel_ab
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    out = []
    k2 = rec["k2"]
    step_name, xs, _, rows, live, run, pl = k2[0]
    K, N = live.shape
    C = xs["slot_f"].shape[2]
    ms = _time_launches(sk.frontier_closure_batch, k2, reps=3)
    picks = k2[::max(1, len(k2) // 3)][:3]
    plain_ms = _time_host(sk.frontier_closure_batch_reference, picks)
    # bytes: per running key its row's slot tables, its live flags and
    # live rows in, its frontier and meta out; operations: every
    # candidate stepped and tested (~16 int32 ops), every appended row
    # hashed, probed and written (~20)
    # (the kernel's meta: bit-identical to the plain version's, above)
    metas = [sk.frontier_closure_batch(*a)[1].cpu() for a in k2]
    nbytes = float(np.mean([
        int(a[5].sum()) * (14 * C + N + 12 * N + 17) + 12 * int(
            (a[4] & a[5][:, None]).sum()) for a in k2]))
    ops = float(np.mean([int((m[:, 3] * C * 16 + m[:, 0] * 20).sum())
                         for m in metas]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t = {"name": f"frontier_closure_batch[K{K},N{N},C{C}]", "K": K, "N": N,
         "C": C, "cluster": sk.k2_cluster(dev, K, N, C, 3, False),
         "rows": len(k2), "ms": ms, "plain_ms": plain_ms,
         "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "bytes_ms": t_bytes, "ops_ms": t_ops,
         "mean_running": float(np.mean([int(a[5].sum()) for a in k2]))}
    print("timing: " + json.dumps(t))
    out.append(t)

    k4 = rec["k4"]
    c_rows, c_live, table, pl = k4[0]
    (K, M), T = c_live.shape, table[1].shape[1]

    def fresh(reps):
        return [a[:2] + ((tuple(x.clone() for x in a[2][0]),
                          a[2][1].clone()),) + a[3:]
                for _ in range(reps) for a in k4]

    ms = kernel_ab._time_once_each(torch, sk.tiled_insert_batch, fresh(1),
                                   fresh(3))
    plain_ms = _time_host(sk.tiled_insert_batch_reference, k4[:1])
    # (the kernel's outputs: bit-identical to the plain version's, above)
    outs = [sk.tiled_insert_batch(*a) for a in fresh(1)]
    live = float(np.mean([int(a[1].sum()) for a in k4]))
    probes = float(np.mean([int((o[2][a[1]] + 1).sum())
                            for a, o in zip(k4, outs)]))
    n_fresh = float(np.mean([int(o[1].sum()) for o in outs]))
    nbytes = K * M + 5 * K * M + 12 * live + 13 * probes + 13 * n_fresh
    ops = K * M + live * 24 + probes * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t = {"name": f"tiled_insert_batch[K{K},T{T},M{M}]", "K": K, "T": T,
         "M": M, "grid": sk.k4_grid(dev), "inputs": len(k4),
         "mean_live": live,
         "mean_probes": probes, "mean_fresh": n_fresh, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print("timing: " + json.dumps(t))
    out.append(t)
    return out


# ---------------------------------------------------------- sharded engine

SHARDED_KEYS = ("valid?", "op", "fail-event", "max-frontier", "capacity",
                "devices", "configs-stepped")
# The reference's results (jepsen_tpu.parallel.sharded.check_encoded_sharded
# with dedupe="hash" on a one-device CPU mesh), the fields of SHARDED_KEYS.
REF_SHARDED = {
    "register-60 seed 77": {"valid?": True, "max-frontier": 256,
                            "capacity": 512, "devices": 1,
                            "configs-stepped": 2644},
    "register-60 seed 77 corrupted": {
        "valid?": False, "op": {"process": 0, "f": "read", "value": 1000,
                                "index": 61},
        "fail-event": 23, "max-frontier": 144, "capacity": 512,
        "devices": 1, "configs-stepped": 932},
    "register-60 seed 78": {"valid?": True, "max-frontier": 36,
                            "capacity": 512, "devices": 1,
                            "configs-stepped": 446},
    "register-60 seed 78 corrupted": {
        "valid?": False, "op": {"process": 5, "f": "read", "value": 1000,
                                "index": 60},
        "fail-event": 24, "max-frontier": 36, "capacity": 512, "devices": 1,
        "configs-stepped": 273},
    "register-60 seed 79": {"valid?": True, "max-frontier": 56,
                            "capacity": 512, "devices": 1,
                            "configs-stepped": 612},
    "register-60 seed 79 corrupted": {
        "valid?": False, "op": {"process": 2, "f": "read", "value": 1000,
                                "index": 18},
        "fail-event": 8, "max-frontier": 20, "capacity": 512, "devices": 1,
        "configs-stepped": 112},
    "wide-10 valid": {"valid?": True, "max-frontier": 7937, "capacity": 8192,
                      "devices": 1, "configs-stepped": 7937},
    "wide-10 invalid": {
        "valid?": False, "op": {"process": 0, "f": "read", "value": 99,
                                "index": 20},
        "fail-event": 0, "max-frontier": 5121, "capacity": 8192,
        "devices": 1, "configs-stepped": 5121},
    "uqueue-valid.edn": {"valid?": True, "max-frontier": 128,
                         "capacity": 1024, "devices": 1,
                         "configs-stepped": 1632},
    "fifo-invalid.edn": {
        "valid?": False, "op": {"process": 2, "f": "dequeue", "value": 1000,
                                "index": 7},
        "fail-event": 2, "max-frontier": 5, "capacity": 1024, "devices": 1,
        "configs-stepped": 10},
}
# the bench's sharded shape (bench.py:617-694) at a quarter of its depth:
# the full width (12 crashed writes, K3's grid) over 2,500 ops, as its
# twin; the 10k-op check took up to 245 s of a smoke that passed 1,000 s
# on a slow host, and the 5,000-op one 92.1 s of an 854.5 s smoke once
# the service phase came (about 1,270 s at the hosts' 1.49x spread)
FULL_OPS = 2500
FULL_CAPACITY = 1 << 17
# the impossible-read twin's depth: the full width at a quarter of the
# bench's ops (a 10k-op twin took up to ~190 s of the smoke on a slow host)
TWIN_OPS = 2500
K3_KEEP = 6             # K3 inputs recorded per table size


def _wide_history(n_crashed: int, read_value: int):
    """n_crashed concurrent crashed writes, then one ok read: the closure
    at the read explores every subset of the writes."""
    from jepsen_tpu_torch.history import History
    ops = [{"type": "invoke", "process": v, "f": "write", "value": v}
           for v in range(1, n_crashed + 1)]
    ops += [{"type": "info", "process": v, "f": "write", "value": v}
            for v in range(1, n_crashed + 1)]
    ops += [{"type": "invoke", "process": 0, "f": "read", "value": None},
            {"type": "ok", "process": 0, "f": "read", "value": read_value}]
    return History.wrap(ops).index()


def _sharded_small_cases():
    """(name, encoded history, capacity) of the small sharded checks."""
    from jepsen_tpu_torch import histories, models
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.parallel import encode as enc
    reg = models.CASRegister()
    out = []
    for seed in (77, 78, 79):
        h = histories.rand_register_history(
            n_ops=60, n_processes=5, crash_p=0.06, fail_p=0.06, seed=seed)
        out.append((f"register-60 seed {seed}", enc.encode(reg, h), 512))
        out.append((f"register-60 seed {seed} corrupted",
                    enc.encode(reg, histories.corrupt_history(h, seed=seed)),
                    512))
    out.append(("wide-10 valid", enc.encode(reg, _wide_history(10, 3)), 512))
    out.append(("wide-10 invalid", enc.encode(reg, _wide_history(10, 99)),
                512))
    for f, model in (("uqueue-valid.edn", models.UnorderedQueue()),
                     ("fifo-invalid.edn", models.FIFOQueue())):
        h = History.from_edn((GOLDEN / f).read_text()).index()
        out.append((f, enc.encode(model, h), 1024))
    return out


class _K3Recorder:
    """Wraps sk.hash_insert and keeps copies of the inputs of every
    `stride`-th call of table size T, up to K3_KEEP per T."""

    def __init__(self, stride: int):
        self.stride, self.seen, self.kept = stride, {}, {}

    def __enter__(self):
        from jepsen_tpu_torch.parallel import sparse_kernels as sk
        self.real = real = sk.hash_insert

        def recording(c_rows, c_live, f_rows, count, table, pl, N):
            T = table[1].shape[0]
            n = self.seen[T] = self.seen.get(T, 0) + 1
            if n % self.stride == 0 and len(self.kept.get(T, ())) < K3_KEEP:
                self.kept.setdefault(T, []).append((tuple(r.clone() for r in c_rows), c_live.clone(),
                             tuple(r.clone() for r in f_rows), count.clone(),
                             (tuple(r.clone() for r in table[0]),
                              table[1].clone()), pl, N))
            return real(c_rows, c_live, f_rows, count, table, pl, N)
        sk.hash_insert = recording
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.parallel import sparse_kernels as sk
        sk.hash_insert = self.real


def _sharded_check(e, mesh, **kw):
    """check_encoded_sharded on the card, K3's count zeroed just before
    and read just after."""
    from jepsen_tpu_torch.parallel import sharded
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    r = sharded.check_encoded_sharded(e, mesh, **kw)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0, sk.launches["hash_insert"]


def phase_sharded_small(dev, mesh) -> dict:
    """The small sharded checks against the reference's results; returns
    K3's launches of these checks per table layout (each check's counts
    zeroed just before it and read just after) and the inputs recorded
    per table size."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    out = {"shared": 0, "device": 0}
    with _K3Recorder(stride=7) as rec:
        for name, e, cap in _sharded_small_cases():
            r, secs, n = _sharded_check(e, mesh, capacity=cap,
                                        dedupe="hash")
            want = REF_SHARDED[name]
            print(f"sharded: {name}: valid?={r['valid?']} capacity="
                  f"{r['capacity']} max-frontier={r.get('max-frontier')} "
                  f"configs-stepped={r.get('configs-stepped')} wall "
                  f"{secs:.3f} s, K3 launches {n}")
            _require(r["closure"] == "cuda" and n > 0,
                     f"{name}: closure {r['closure']}, K3 launches {n}")
            _require({k: r.get(k) for k in SHARDED_KEYS}
                     == {k: want.get(k) for k in SHARDED_KEYS},
                     f"{name}: {r} != reference {want}")
            for layout, k in sk.hash_insert_launches.items():
                out[layout] += k
    out["recorded"] = rec.kept
    return out


def phase_sharded_full(dev, mesh) -> dict:
    """The bench's shape at full width: the valid history through
    `sharded.analysis` once (counted, recording K3 inputs) and the
    impossible-read twin of a TWIN_OPS-op history of the same width
    through check_encoded_sharded; each against the dense engine on the
    card. (One run of the valid history: a warm
    re-run took a third of this phase, up to ~185 s on a slow host.)"""
    from jepsen_tpu_torch import histories, models
    from jepsen_tpu_torch.parallel import bitdense, sharded
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    model = models.CASRegister(None)
    h = histories.adversarial_register_history(n_ops=FULL_OPS, k_crashed=12)
    kw = {"capacity": FULL_CAPACITY, "max_capacity": 1 << 20,
          "dedupe": "hash"}
    _require(sk.k3_layout(FULL_CAPACITY, dev) == "device",
             "the full-width tier does not take the device layout")
    out = {}
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    # a prime stride: a check makes about four inserts per event (the seed
    # and the expansions), and every kind is recorded
    with _K3Recorder(stride=997) as rec:
        r = sharded.analysis(model, h, mesh, **kw)
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    out["by_layout"] = dict(sk.hash_insert_launches)
    print(f"sharded: adv-{FULL_OPS}-k12: valid?={r['valid?']} capacity="
          f"{r['capacity']} max-frontier={r['max-frontier']} "
          f"configs-stepped={r['configs-stepped']} wall {out['wall']:.3f} "
          f"s, K3 launches {sk.launches['hash_insert']}")
    out["recorded"] = rec.kept
    out["valid"] = r
    # kept for the resumable phase, which checks the same history
    out["enc"] = enc.encode(model, h)
    dense = bitdense.check_encoded_bitdense(out["enc"], device=dev)
    keys = ("valid?", "op", "fail-event")
    _require(r["closure"] == "cuda" and r["valid?"] is True,
             f"full width: {r}")
    _require({k: r.get(k) for k in keys} == {k: dense.get(k) for k in keys},
             f"full width: sharded {r} != dense {dense}")
    e_bad = enc.encode(model, histories.with_impossible_read(
        histories.adversarial_register_history(n_ops=TWIN_OPS,
                                               k_crashed=12)))
    rb, secs, n = _sharded_check(e_bad, mesh, **kw)
    dense_b = bitdense.check_encoded_bitdense(e_bad, device=dev)
    print(f"sharded: adv-{TWIN_OPS}-k12 impossible read: valid?="
          f"{rb['valid?']} fail-event={rb.get('fail-event')} op="
          f"{rb.get('op')} max-frontier={rb.get('max-frontier')} wall "
          f"{secs:.3f} s, K3 launches {n}")
    _require(rb["valid?"] is False and n > 0, f"impossible read: {rb}")
    _require({k: rb.get(k) for k in keys}
             == {k: dense_b.get(k) for k in keys},
             f"impossible read: sharded {rb} != dense {dense_b}")
    out["twin"], out["twin_launches"] = secs, n
    return out


def _max_err_k3(got, want) -> int:
    g = [*got[0], *got[1][0], got[1][1], got[2].reshape(1),
         got[3].reshape(1), got[4].reshape(1)]
    w = [*want[0], *want[1][0], want[1][1], want[2].reshape(1),
         want[3].reshape(1), want[4].reshape(1)]
    return _max_err(g, w)


K3_NAMES = {"shared": "shared", "device": "grid"}   # layout -> its insert


def _k3_forced(layout: str):
    """K3 on CUDA tensors with its insert in `layout` ("shared": one
    block; "device": the cooperative grid), whatever the gate says."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk

    def run(c_rows, c_live, f_rows, count, table, pl, N):
        return sk._hash_insert_launch(c_rows, c_live, f_rows, count, table,
                                      pl, N, layout)
    return run


def phase_k3_parity(dev, mesh, recorded: dict) -> int:
    """K3 against the plain insert on the card, bit for bit: on every
    recorded input through the wrapper (both layouts) and through the
    cooperative grid forced (on the shared layout's tables too), at
    probe_limit=2 in both with the probe overflow raised, on an input
    whose append passes N, and on more live candidates than the grid
    has threads; a short check through the plain insert equals the K3
    check. Returns the largest |difference| (0: bit-identical)."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    lib = sk._lib("hash_insert")
    for T in (1024, 8192):
        _require(lib.jt_hash_insert_smem(T, 0, 3) == sk.k3_smem_bytes(T // 2),
                 f"K3 layout at T={T}")
    grid = _k3_forced("device")
    worst = 0
    for T, inputs in sorted(recorded.items()):
        layout = sk.k3_layout(T // 2, dev)
        for args in inputs:
            want = sk.hash_insert_reference(*args)
            for fn, name in ((sk.hash_insert, layout), (grid, "grid")):
                err = _max_err_k3(fn(*args), want)
                torch.cuda.synchronize()
                worst = max(worst, err)
                _require(err == 0, f"K3 ({name}) differs from the plain "
                                   f"insert at T={T}")
        print(f"parity: K3 == plain insert on {len(inputs)} recorded inputs "
              f"at T={T} ({layout} layout, and the grid forced; "
              f"M={inputs[0][1].shape[0]}, live "
              f"{[int(a[1].sum()) for a in inputs]})")
    _require({sk.k3_layout(T // 2, dev) for T in recorded}
             == {"shared", "device"}, "K3 parity missed a layout")
    fired = {}
    for T, inputs in sorted(recorded.items()):
        layout = sk.k3_layout(T // 2, dev)
        for args in inputs:
            a = args[:5] + (2,) + args[6:]
            want = sk.hash_insert_reference(*a)
            for fn, name in ((sk.hash_insert, "wrapper"), (grid, "grid")):
                err = _max_err_k3(fn(*a), want)
                worst = max(worst, err)
                _require(err == 0, f"K3 ({name}) differs at probe_limit=2, "
                                   f"T={T} ({layout} layout)")
                if bool(want[4]) and int(want[2]) < a[6]:
                    fired.setdefault(name, (T, int(want[3])))
    _require(set(fired) == {"wrapper", "grid"},
             f"probe_limit=2 overflowed only in {sorted(fired)}")
    print(f"parity: K3 == plain insert at probe_limit=2 on every recorded "
          f"input, the probe overflow raised (first at (T, fresh): "
          f"{fired})")
    # an append past N: the largest recorded insert, its frontier all
    # but a few rows full
    T, inputs = max(recorded.items())
    args = max(inputs, key=lambda a: int(a[1].sum()))
    fresh = int(sk.hash_insert_reference(*args)[3])
    N = args[6]
    a = args[:3] + (torch.full_like(args[3], N - fresh // 2),) + args[4:]
    want = sk.hash_insert_reference(*a)
    _require(bool(want[4]) and int(want[2]) == N,
             f"the append past N did not overflow: {want[2:]}")
    err = _max_err_k3(sk.hash_insert(*a), want)
    worst = max(worst, err)
    _require(err == 0, f"K3 differs on the append past N at T={T}")
    print(f"parity: K3 == plain insert on an append past N (T={T}, "
          f"count {N - fresh // 2} + {fresh} fresh > N={N}, overflow "
          f"raised)")
    # the grid past its threads: more live candidates than the grid has
    # threads, so their probe state lives in the scratch, not in
    # registers (random rows, many repeated, a table of 2^19 slots)
    threads = sk.k3_grid(dev) * 1024
    g = torch.Generator(device=dev).manual_seed(SEED)
    M = threads * 3 // 2
    pick = torch.randint(0, M // 4, (M,), device=dev, generator=g)
    pool = [torch.randint(-2**31, 2**31 - 1, (M // 4,), device=dev,
                          dtype=torch.int32, generator=g) for _ in range(3)]
    T, N = 1 << 19, 1 << 18
    a = (tuple(r[pick] for r in pool),
         torch.rand(M, device=dev, generator=g) < 0.8,
         tuple(torch.zeros(N, dtype=torch.int32, device=dev)
               for _ in range(3)),
         torch.tensor(5, dtype=torch.int32, device=dev),
         (tuple(torch.zeros(T, dtype=torch.int32, device=dev)
                for _ in range(3)),
          torch.zeros(T, dtype=torch.bool, device=dev)), 32, N)
    live = int(a[1].sum())
    _require(live > threads and sk.k3_layout(T // 2, dev) == "device",
             f"the scratch-path input has {live} live for {threads} threads")
    want = sk.hash_insert_reference(*a)
    err = _max_err_k3(sk.hash_insert(*a), want)
    worst = max(worst, err)
    _require(err == 0, "K3's grid differs past its threads")
    print(f"parity: K3 == plain insert with {live} live candidates past "
          f"the grid's {threads} threads ({int(want[3])} fresh)")
    # the plain insert through a whole check on the card
    name, e, cap = _sharded_small_cases()[1]
    r, _, n = _sharded_check(e, mesh, capacity=cap, dedupe="hash")
    real = sk.hash_insert
    sk.hash_insert = sk.hash_insert_reference
    try:
        p, secs, pn = _sharded_check(e, mesh, capacity=cap, dedupe="hash")
    finally:
        sk.hash_insert = real
    _require(pn == 0 and n > 0 and _strip(p) == _strip(r),
             f"{name}: K3 and plain-insert results differ: {r} {p}")
    print(f"parity: {name}: the plain insert on the card agrees field for "
          f"field, {secs:.3f} s")
    return worst


def phase_k3_timing(dev, recorded: dict) -> list:
    """K3 per launch with CUDA events at both layouts, beside the plain
    insert on the card and the bound; at T=1,024 also the cooperative
    grid forced onto the shared layout's table (the measurement that
    keeps the one-block insert there)."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    out = []
    for T, inputs in sorted(recorded.items()):
        if T not in (1024, 1 << 18):
            continue
        # the expansion inserts (M = n_dev * B_cand candidates; a seed
        # insert has M = N)
        inputs = [a for a in inputs if a[1].shape[0] > a[2][0].shape[0]]
        _require(len(inputs) > 0, f"no expansion insert recorded at T={T}")
        M, N = inputs[0][1].shape[0], inputs[0][2][0].shape[0]
        layout = sk.k3_layout(T // 2, dev)
        ms = _time_launches(sk.hash_insert, inputs, reps=3)
        grid_ms = _time_launches(_k3_forced("device"), inputs, reps=3) \
            if layout == "shared" else ms
        plain_ms = _time_host(sk.hash_insert_reference, inputs[:2])
        # bytes these inserts need: every live flag, the live candidates'
        # rows, the table (rows and occupancy) in and out, the fresh rows
        # appended after `count`, the count and meta; operations: the live
        # test of every candidate, and for the live ones the hash, probes
        # and claim (~24)
        live = float(np.mean([int(a[1].sum()) for a in inputs]))
        fresh = float(np.mean([int(sk.hash_insert(*a)[2]) - int(a[3])
                               for a in inputs]))
        nbytes = M + 12 * live + 2 * 13 * T + 12 * fresh + 16
        ops = M + 24 * live
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        t = {"T": T, "M": M, "N": N, "layout": layout,
             "insert": K3_NAMES[layout], "grid_blocks": sk.k3_grid(dev),
             "inputs": len(inputs), "mean_live": live, "mean_fresh": fresh,
             "ms": ms, "grid_ms": grid_ms, "plain_ms": plain_ms,
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        print("timing: " + json.dumps(t))
        out.append(t)
    _require(len(out) == 2, f"K3 timed at {[t['T'] for t in out]}")
    return out


# ------------------------------------------------ packed rows (config_pack)

# The reference's results with config_pack=True (jepsen_tpu, dedupe
# "hash", on the CPU; tests/torch_record_packed_refs.py records these
# three tables): every field but analyzer and closure, and the digest of
# final-paths and configs (_paths_digest; EMPTY_PATHS for the valid
# ones). The two-lane history is a 20-element set with 14
# processes: 2^20 states and 14 slots, a 34-bit word.
REF_PACKED = {
    "fifo-valid.edn": {"valid?": True, "max-frontier": 253, "capacity": 1024,
        "dedupe": "hash", "configs-stepped": 2089, "explored": 794624,
        "config-pack": "packed:24b/1-lane"},
    "uqueue-valid.edn": {"valid?": True, "max-frontier": 128, "capacity": 1024,
        "dedupe": "hash", "configs-stepped": 1632, "explored": 666624,
        "config-pack": "packed:18b/1-lane"},
    "gset-valid.edn": {"valid?": True, "max-frontier": 16, "capacity": 1024,
        "dedupe": "hash", "configs-stepped": 297, "explored": 393216,
        "config-pack": "packed:12b/1-lane"},
    "fifo-invalid.edn": {"valid?": False, "max-frontier": 5, "capacity": 1024,
        "dedupe": "hash", "configs-stepped": 10, "explored": 24576,
        "config-pack": "packed:19b/1-lane", "op": {"process": 2, "f":
        "dequeue", "value": 1000, "index": 7}, "fail-event": 2, "paths":
        "727ecef79e85781a"},
    "uqueue-invalid.edn": {"valid?": False, "max-frontier": 32, "capacity":
        1024, "dedupe": "hash", "configs-stepped": 92, "explored": 98304,
        "config-pack": "packed:16b/1-lane", "op": {"process": 2, "f":
        "dequeue", "value": 1000, "index": 16}, "fail-event": 7, "paths":
        "b0450bfaf452a0cb"},
    "gset-invalid.edn": {"valid?": False, "max-frontier": 16, "capacity": 1024,
        "dedupe": "hash", "configs-stepped": 105, "explored": 230400,
        "config-pack": "packed:13b/1-lane", "op": {"process": 0, "f": "read",
        "value": [0, 1, 2, 3, 4, 5, 1048], "index": 47}, "fail-event": 20,
        "paths": "f95482334d86b907"},
    "uqueue-400": {"valid?": True, "max-frontier": 256, "capacity": 1024,
        "dedupe": "hash", "configs-stepped": 25467, "explored": 6447104,
        "config-pack": "packed:28b/1-lane"},
    "gset-400": {"valid?": True, "max-frontier": 1024, "capacity": 1024,
        "dedupe": "hash", "configs-stepped": 75264, "explored": 8192000,
        "config-pack": "packed:26b/1-lane"},
    "gset-200 two-lane": {"valid?": True, "max-frontier": 16384, "capacity":
        16384, "dedupe": "hash", "configs-stepped": 354355, "explored":
        91291648, "config-pack": "packed:34b/2-lane"},
    "fifo-1000": {"valid?": True, "max-frontier": 18610, "capacity": 32768,
        "dedupe": "hash", "configs-stepped": 649022, "explored": 872153088,
        "config-pack": "packed:30b/1-lane"},
    "fifo-1000 corrupted": {"valid?": False, "max-frontier": 8520, "capacity":
        16384, "dedupe": "hash", "configs-stepped": 88757, "explored":
        185204736, "config-pack": "packed:39b/2-lane", "op": {"process": 5,
        "f": "dequeue", "value": 1001, "index": 887}, "fail-event": 395,
        "final-paths-window": [331, 395], "paths": "896dc485b8ac46e0"},
}
PACKED_TWO_LANE = "gset-200 two-lane"
# The reference's batch of the 28 queue keys (_sparse_batch_keys()) with
# config_pack=True: the digest of every field but closure, each key's
# capacity, the invalid keys' failing op and event.
REF_SPARSE_BATCH_PACKED = {
    "uqueue-24+4": {
        "keys": 28, "digest": "3197f9ce2f5df2af",
        "capacity": [1024, 16384, 1024, 16384, 32768, 8192, 32768, 2048, 65536,
                     32768, 1024, 32768, 512, 16384, 1024, 8192, 1024, 32768,
                     16384, 1024, 4096, 8192, 16384, 4096, 1024, 32768, 512,
                     2048],
        "invalid": {
            24: {"fail-event": 117, "op": {"process": 8, "f": "dequeue",
                "value": 1001, "index": 223}},
            25: {"fail-event": 103, "op": {"process": 13, "f": "dequeue",
                "value": 1002, "index": 190}},
            26: {"fail-event": 74, "op": {"process": 6, "f": "dequeue",
                "value": 1001, "index": 150}},
            27: {"fail-event": 32, "op": {"process": 12, "f": "dequeue",
                "value": 1002, "index": 66}}}}}
# The reference's check_encoded_sharded(..., config_pack=True) on a
# one-device CPU mesh: the ten small cases (_sharded_small_cases()), a
# 44-op set of 30 elements (a 33-bit word) and the two-lane 200-op set at
# capacity 16,384 (K3's table in device memory), the fields of
# SHARDED_KEYS and "config-pack".
REF_SHARDED_PACKED = {
    "register-60 seed 77": {"valid?": True, "max-frontier": 256, "capacity":
        512, "devices": 1, "configs-stepped": 2644, "config-pack":
        "packed:10b/1-lane"},
    "register-60 seed 77 corrupted": {"valid?": False, "op": {"process": 0,
        "f": "read", "value": 1000, "index": 61}, "fail-event": 23,
        "max-frontier": 144, "capacity": 512, "devices": 1, "configs-stepped":
        932, "config-pack": "packed:10b/1-lane"},
    "register-60 seed 78": {"valid?": True, "max-frontier": 36, "capacity":
        512, "devices": 1, "configs-stepped": 446, "config-pack":
        "packed:8b/1-lane"},
    "register-60 seed 78 corrupted": {"valid?": False, "op": {"process": 5,
        "f": "read", "value": 1000, "index": 60}, "fail-event": 24,
        "max-frontier": 36, "capacity": 512, "devices": 1, "configs-stepped":
        273, "config-pack": "packed:8b/1-lane"},
    "register-60 seed 79": {"valid?": True, "max-frontier": 56, "capacity":
        512, "devices": 1, "configs-stepped": 612, "config-pack":
        "packed:8b/1-lane"},
    "register-60 seed 79 corrupted": {"valid?": False, "op": {"process": 2,
        "f": "read", "value": 1000, "index": 18}, "fail-event": 8,
        "max-frontier": 20, "capacity": 512, "devices": 1, "configs-stepped":
        112, "config-pack": "packed:8b/1-lane"},
    "wide-10 valid": {"valid?": True, "max-frontier": 7937, "capacity": 8192,
        "devices": 1, "configs-stepped": 7937, "config-pack":
        "packed:15b/1-lane"},
    "wide-10 invalid": {"valid?": False, "op": {"process": 0, "f": "read",
        "value": 99, "index": 20}, "fail-event": 0, "max-frontier": 5121,
        "capacity": 8192, "devices": 1, "configs-stepped": 5121, "config-pack":
        "packed:15b/1-lane"},
    "uqueue-valid.edn": {"valid?": True, "max-frontier": 128, "capacity": 1024,
        "devices": 1, "configs-stepped": 1632, "config-pack":
        "packed:18b/1-lane"},
    "fifo-invalid.edn": {"valid?": False, "op": {"process": 2, "f": "dequeue",
        "value": 1000, "index": 7}, "fail-event": 2, "max-frontier": 5,
        "capacity": 1024, "devices": 1, "configs-stepped": 10, "config-pack":
        "packed:19b/1-lane"},
    "gset-44 two-lane": {"valid?": True, "max-frontier": 36, "capacity": 512,
        "devices": 1, "configs-stepped": 307, "config-pack":
        "packed:33b/2-lane"},
    "gset-200 two-lane": {"valid?": True, "max-frontier": 16384, "capacity":
        16384, "devices": 1, "configs-stepped": 354355, "config-pack":
        "packed:34b/2-lane"},
}
PACKED_SHARDED_KEYS = SHARDED_KEYS + ("config-pack",)
PACKED_KEEP = 12      # kernel inputs kept per (wrapper, lanes, shapes)


def _packed_cases(cases):
    """The sparse main path's ten cases and the two-lane set."""
    from jepsen_tpu_torch import histories, models
    return cases + [(PACKED_TWO_LANE, models.GSet(),
                     histories.rand_gset_history(
                         200, n_processes=14, n_elements=20, crash_p=0.005,
                         seed=1))]


def _packed_sharded_cases():
    from jepsen_tpu_torch import histories, models
    from jepsen_tpu_torch.parallel import encode as enc
    gset = models.GSet()
    return _sharded_small_cases() + [
        ("gset-44 two-lane", enc.encode(gset, histories.rand_gset_history(
            n_ops=44, n_processes=6, n_elements=30, crash_p=0.05, seed=45)),
         512),
        (PACKED_TWO_LANE, enc.encode(gset, histories.rand_gset_history(
            200, n_processes=14, n_elements=20, crash_p=0.005, seed=1)),
         16384)]


# wrapper -> the argument that holds its rows
_ROWS_AT = {"frontier_closure": 2, "frontier_closure_batch": 3,
            "hash_insert": 0, "tiled_insert": 0, "tiled_insert_batch": 0}


def _shapes(x) -> tuple:
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    if isinstance(x, dict):
        return tuple(_shapes(v) for v in x.values())
    if isinstance(x, tuple):
        return tuple(_shapes(v) for v in x)
    return ()


class _KeepPacked:
    """Wraps the sparse kernels' wrappers and keeps copies of the inputs
    of their calls on packed rows (one or two lanes) that `keep(name,
    args)` accepts, every `stride`-th of them up to PACKED_KEEP per
    (wrapper, lanes, argument shapes), in kept[(wrapper, lanes)][shapes].
    The wrappers still run and count as ever."""

    def __init__(self, keep, stride: int = 1):
        self.keep, self.stride = keep, stride
        self.kept, self.seen = {}, {}

    def __enter__(self):
        from jepsen_tpu_torch.parallel import sparse_kernels as sk
        self.real = {n: getattr(sk, n) for n in _ROWS_AT}
        pc = _parity_cases()

        def wrap(name, real):
            def recording(*args, **kw):
                L = len(args[_ROWS_AT[name]])
                if L < 3 and self.keep(name, args):
                    sig = _shapes(args)
                    key = (name, L, sig)
                    n = self.seen[key] = self.seen.get(key, 0) + 1
                    kept = self.kept.setdefault((name, L), {}) \
                        .setdefault(sig, [])
                    if n % self.stride == 0 and len(kept) < PACKED_KEEP:
                        kept.append(pc._clone(args + tuple(kw.values())))
                return real(*args, **kw)
            return recording

        for n, real in self.real.items():
            setattr(sk, n, wrap(n, real))
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.parallel import sparse_kernels as sk
        for n, real in self.real.items():
            setattr(sk, n, real)


def _lanes_of(r: dict) -> int:
    return int(r["config-pack"].split("/")[1].split("-")[0]) \
        if r.get("config-pack", "unpacked") != "unpacked" else 3


def phase_packed_main(dev, cases, mesh, swalls, sbatch) -> dict:
    """The packed main path (config_pack=True): the eleven single-key
    histories through `Linearizable`, each equal field for field to
    REF_PACKED; the 28-key batch through `engine.check_batch` and
    `independent.checker(linearizable(..., config_pack=True))`, equal to
    REF_SPARSE_BATCH_PACKED; the twelve sharded checks, equal to
    REF_SHARDED_PACKED. Launch counts are zeroed just before each check
    and read just after; they are summed by kernel and lane count. Also
    the walls of the 1000-op FIFO and of the 28-key batch, packed against
    unpacked, warm, in this run (findings, not claims): one more packed
    run of each, beside the unpacked warm runs of the sparse phases
    (`swalls`, `sbatch`). Keeps kernel inputs of packed rows for the
    parity and timing phases."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import UnorderedQueue
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    launches: dict = {}
    out = {"launches": launches, "walls": {}}

    def count(kernel, L, n):
        launches[(kernel, L)] = launches.get((kernel, L), 0) + n

    def keep(name, args):
        # K2 at its widest tiers (N = 4,096 at one lane, 2,048 at two);
        # K4's expansion inserts (M = N * C, not the seed's N) of the
        # FIFO's top tiers; every batched and sharded call
        if name == "frontier_closure":
            return args[3].shape[0] == (4096 if len(args[2]) == 1 else 2048)
        if name == "tiled_insert":
            T = args[2][1].shape[0]
            return T in (65536, 32768) and args[1].shape[0] != T // 2
        return True

    rec = _KeepPacked(keep, stride=7)
    with rec:
        for name, model, h in _packed_cases(cases):
            r, secs, n = _sparse_check(model, h, dev, config_pack=True)
            want = REF_PACKED[name]
            L = _lanes_of(r)
            got = {k: v for k, v in r.items() if k not in (
                "analyzer", "closure", "final-paths", "configs")}
            _require(got == {k: v for k, v in want.items() if k != "paths"},
                     f"packed {name}: {got} != reference {want}")
            _require(_paths_digest(r) == want.get("paths", EMPTY_PATHS),
                     f"packed {name}: final-paths/configs differ")
            kernel = {"cuda": "K2", "cuda-tiled": "K4"}[r["closure"]]
            _require(n[kernel] > 0, f"packed {name}: {kernel} never ran")
            count("K2", L, n["K2"])
            count("K4", L, n["K4"])
            print(f"packed main: {name}: {r['config-pack']} valid?="
                  f"{r['valid?']} closure={r['closure']} capacity="
                  f"{r['capacity']} == REF_PACKED, wall {secs:.3f} s, "
                  f"launches {n}")
    # the 1000-op FIFO warm: the run above was its first packed one; the
    # sparse main path's was its second unpacked one
    name, model, h = cases[[c[0] for c in cases].index("fifo-1000")]
    _, secs, _ = _sparse_check(model, h, dev, config_pack=True)
    out["walls"]["fifo-1000 packed"] = secs
    out["walls"]["fifo-1000 unpacked"] = swalls["fifo-1000"]
    print(f"packed main: fifo-1000 warm walls: {json.dumps(out['walls'])}")

    # the 28-key batch
    hs = _sparse_batch_keys()
    model = UnorderedQueue()
    with _KeepPacked(lambda name, args: name.endswith("_batch"),
                     stride=5) as brec:
        rs, secs, n, tiers = _sparse_batch_check(model, hs, dev,
                                                 config_pack=True)
    got = _sparse_batch_digest(rs)
    _require(got == REF_SPARSE_BATCH_PACKED["uqueue-24+4"],
             f"packed batch: results differ from the reference's: {got}")
    _require(n["frontier_closure_batch"] > 0 and n["tiled_insert_batch"] > 0
             and n["frontier_closure"] == n["tiled_insert"] == 0,
             f"packed batch: launches {n}")
    lanes = {t["lanes"] for t in tiers}
    for t in tiers:
        count("K2 batch", t["lanes"], t["K2"])
        count("K4 batch", t["lanes"], t["K4"])
        print(f"packed main: batch tier {t}")
    print(f"packed main: batch of {len(rs)} keys: {rs[0]['config-pack']}, "
          f"tiers at {sorted(lanes)} lanes, == REF_SPARSE_BATCH_PACKED, "
          f"cold {secs:.3f} s, launches {n}")
    _, warm, _, _ = _sparse_batch_check(model, hs, dev, config_pack=True)
    out["walls"]["batch-28 packed"] = warm
    out["walls"]["batch-28 unpacked"] = sbatch["main"]["warm_runs"]
    print(f"packed main: batch-28 warm walls: packed {warm:.3f} s, unpacked "
          f"{sbatch['main']['warm_runs']} s (the sparse batch phase's)")
    ops = []
    for k, h in enumerate(hs):
        for o in h:
            o = dict(o)
            o["value"] = independent.KV(k, o.get("value"))
            ops.append(o)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = independent.checker(linearizable(model, device=dev,
                                         config_pack=True)).check(
        {}, History.wrap(ops).index())
    torch.cuda.synchronize()
    got = [{k: v for k, v in r["results"][k].items() if k != "analyzer"}
           for k in range(len(hs))]
    _require(_sparse_batch_digest(got) ==
             REF_SPARSE_BATCH_PACKED["uqueue-24+4"],
             "packed independent: results differ from the reference's")
    print(f"packed main: independent.checker(linearizable(UnorderedQueue(), "
          f"config_pack=True)): failures {r['failures']}, == "
          f"REF_SPARSE_BATCH_PACKED, wall {time.perf_counter() - t0:.3f} s")

    # the sharded checks
    with _KeepPacked(lambda name, args: name == "hash_insert",
                     stride=3) as srec:
        for name, e, cap in _packed_sharded_cases():
            r, secs, n = _sharded_check(e, mesh, capacity=cap,
                                        dedupe="hash", config_pack=True)
            want = REF_SHARDED_PACKED[name]
            _require({k: r.get(k) for k in PACKED_SHARDED_KEYS}
                     == {k: want.get(k) for k in PACKED_SHARDED_KEYS},
                     f"packed sharded {name}: {r} != reference {want}")
            _require(r["closure"] == "cuda" and n > 0,
                     f"packed sharded {name}: K3 launches {n}")
            L = _lanes_of(r)
            for layout, k in sk.hash_insert_launches.items():
                count(f"K3 {layout}", L, k)
            print(f"packed main: sharded {name}: {r['config-pack']} "
                  f"capacity={r['capacity']} == REF_SHARDED_PACKED, wall "
                  f"{secs:.3f} s, K3 launches {dict(sk.hash_insert_launches)}")
    out["recorded"] = {**rec.kept, **brec.kept, **srec.kept}
    print("packed main: kept inputs (wrapper, lanes: shapes, inputs): "
          + json.dumps({f"{k[0]} L{k[1]}": [len(groups), sum(
              len(v) for v in groups.values())]
              for k, groups in out["recorded"].items()}))
    print(f"packed main: launches by (kernel, lanes): "
          f"{ {f'{k} L{L}': v for (k, L), v in sorted(launches.items())} }")
    return out


def _flat(x) -> list:
    """A kernel's output, nested tuples of tensors, as a flat list (each
    scalar as one element)."""
    if isinstance(x, torch.Tensor):
        return [x.reshape(-1)]
    return [t for v in x for t in _flat(v)]


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    return x


def _all_kept(rec, name) -> list:
    """Every input kept of wrapper `name`, at one lane and two."""
    return [a for L in (1, 2) for group in rec.get((name, L), {}).values()
            for a in group]


def _most_kept(rec, name, L) -> list:
    """The inputs kept of wrapper `name` at L lanes in the shape kept most
    often (the larger shape on a tie), or []."""
    groups = rec.get((name, L), {})
    if not groups:
        return []
    return max(groups.items(), key=lambda kv: (len(kv[1]), kv[0]))[1]


def _k2_batch_seeded(pc, dev):
    """Batched K2's seeded packed inputs: three keys on two event rows
    (the case's, and its slots reversed) of each seeded K2 case at N <=
    2,048: the case, the case with run False, and its frontier less the
    first live row (as tests/test_torch_config_pack_kernels.py builds
    them)."""
    out = []
    for name, step, ev, rows, live, run, pl, pack in pc.packed_k2_cases():
        if live.shape[0] > 2048:
            continue
        rev = {k: v.flip(0) for k, v in ev.items()}
        xs = {k: torch.stack([ev[k], rev[k]])[None].expand(3, 2, -1)
              .contiguous() for k in ev}
        live2 = live.clone()
        live2[int(live.nonzero()[0])] = False
        for r in (0, 1):
            out.append((name, _to((step, xs, r, tuple(
                torch.stack([x, x, x]) for x in rows),
                torch.stack([live, live, live2]),
                torch.tensor([True, False, True]), pl, pack), dev)))
    return out


def phase_packed_parity(dev, rec) -> dict:
    """Every packed kernel against its plain version on the card, bit for
    bit, at one lane and two: the seeded packed cases of
    tests/torch_parity_cases.py and the inputs kept from the packed main
    path (K2 also at probe_limit 2); K3 through the wrapper, with the
    grid forced, and with one block forced where the table fits it; K4
    on its own copy of each table. Returns the largest |difference| of
    each (kernel, lanes) (0: bit-identical)."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    pc = _parity_cases()
    lib2, lib3 = sk._lib("frontier_closure"), sk._lib("hash_insert")
    for L in (1, 2, 3):
        for N, C in ((1024, 8), (2048, 14), (4096, 12)):
            _require(lib2.jt_frontier_closure_smem(N, C, L)
                     == sk.k2_smem_bytes(N, C, L), f"K2 at N={N} C={C} L={L}")
        _require(lib3.jt_hash_insert_smem(16384, 0, L)
                 == sk.k3_smem_bytes(8192, L), f"K3 at L={L}")
    worst: dict = {}

    def held(key, got, want, what):
        torch.cuda.synchronize()
        got, want = _flat(got), _flat(want)
        _require(len(got) == len(want), f"{key}: outputs {len(got)} != "
                                        f"{len(want)}")
        err = _max_err(got, want)
        worst[key] = max(worst.get(key, 0), err)
        _require(err == 0, f"{key[0]} differs from its plain version at "
                           f"{key[1]} lanes: {what}")

    def copy_table(args, at):
        t = args[at]
        return args[:at] + ((tuple(x.clone() for x in t[0]),
                             t[1].clone()),) + args[at + 1:]

    # K2
    seeded = [(c[0], _to(c[1:], dev)) for c in pc.packed_k2_cases()]
    kept = [(f"kept N{a[3].shape[0]}", a)
            for a in _all_kept(rec, "frontier_closure")]
    fired = False
    for what, a in seeded + kept:
        held(("K2", len(a[2])), sk.frontier_closure(*a),
             sk.frontier_closure_reference(*a), what)
    for what, a in kept[::4]:
        a2 = a[:5] + (2,) + a[6:]
        want = sk.frontier_closure_reference(*a2)
        held(("K2", len(a[2])), sk.frontier_closure(*a2), want,
             f"{what} probe_limit 2")
        fired = fired or int(want[1][1]) == 1
    _require({k[1] for k in worst if k[0] == "K2"} == {1, 2},
             "K2 parity missed a lane count")
    print(f"parity: packed K2 == plain closure on {len(seeded)} seeded and "
          f"{len(kept)} kept inputs (N "
          f"{sorted({a[3].shape[0] for _, a in seeded + kept})}), and at "
          f"probe_limit 2 (overflow raised: {fired})")
    # batched K2
    seeded = _k2_batch_seeded(pc, dev)
    kept = [("kept", a) for a in _all_kept(rec, "frontier_closure_batch")]
    for what, a in seeded + kept:
        held(("K2 batch", len(a[3])), sk.frontier_closure_batch(*a),
             sk.frontier_closure_batch_reference(*a), what)
    print(f"parity: packed batched K2 == plain closure on {len(seeded)} "
          f"seeded and {len(kept)} kept inputs (K, N: "
          f"{sorted({tuple(a[4].shape) for _, a in seeded + kept})})")
    # K3: through the wrapper, the grid forced, and one block forced
    grid, one = _k3_forced("device"), _k3_forced("shared")
    seeded = [(c[0], _to(c[1:], dev)) for c in pc.packed_k3_cases()]
    kept = [("kept", a) for a in _all_kept(rec, "hash_insert")]
    layouts = set()
    for what, a in seeded + kept:
        L, T = len(a[0]), a[4][1].shape[0]
        want = sk.hash_insert_reference(*a)
        fits = sk.k3_layout(T // 2, dev, L) == "shared"
        layouts.add((L, "device"))
        if fits:
            layouts.add((L, "shared"))
        for fn in (sk.hash_insert, grid) + ((one,) if fits else ()):
            held(("K3", L), fn(*a), want, f"{what} T={T}")
    _require(layouts == {(1, "device"), (1, "shared"), (2, "device"),
                         (2, "shared")}, f"K3 parity covered {layouts}")
    print(f"parity: packed K3 == plain insert on {len(seeded)} seeded and "
          f"{len(kept)} kept inputs, in both layouts at one lane and two "
          f"(T {sorted({a[4][1].shape[0] for _, a in seeded + kept})})")
    # K4 and batched K4, each launch on its own copy of the table
    for name, seeded_k4, key in (
            ("tiled_insert", pc.packed_k4_cases(), "K4"),
            ("tiled_insert_batch", pc.packed_k4_batch_cases(), "K4 batch")):
        fn = getattr(sk, name)
        ref = getattr(sk, name + "_reference")
        inputs = [(c[0], _to(c[1:], dev)) for c in seeded_k4] + \
            [("kept", a) for a in _all_kept(rec, name)]
        for what, a in inputs:
            held((key, len(a[0])), fn(*copy_table(a, 2)), ref(*a), what)
        print(f"parity: packed {key} == plain insert on {len(inputs)} "
              f"inputs (T {sorted({a[2][1].shape[-1] for _, a in inputs})},"
              f" lanes {sorted({len(a[0]) for _, a in inputs})})")
    return worst


def phase_packed_timing(dev, rec, launches) -> list:
    """Each packed kernel per launch with CUDA events on the inputs kept
    from the packed main path, beside its plain version on the card and
    its bound, with bytes at 4L a row of L lanes; one kernels-line entry
    each, with its launches on the packed main path."""
    import kernel_ab
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    src = "jepsen_tpu_torch/kernels/"
    ref = "jepsen_tpu/parallel/sparse_kernels.py:"
    out = []

    def entry(name, key, L, source, line, ms, plain_ms, t_bytes, t_ops,
              **extra):
        n = launches.get((key, L), 0)
        _require(n > 0, f"packed {key} at {L} lanes never ran on the main "
                        f"path")
        t = {"name": name, "route": "cuda", "source": src + source,
             "replaces": ref + str(line), "launches": n, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None, "lanes": L, **extra}
        print("timing: " + json.dumps(t))
        out.append(t)

    def per_s(nbytes, ops):
        return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3

    for L in (1, 2):
        k2 = _most_kept(rec, "frontier_closure", L)
        _require(len(k2) > 0, f"no packed K2 input kept at {L} lanes")
        N, C = k2[0][3].shape[0], k2[0][1]["slot_f"].shape[0]
        ms = _time_launches(sk.frontier_closure, k2, reps=3)
        plain_ms = _time_host(sk.frontier_closure_reference, k2[:2])
        metas = [sk.frontier_closure(*a)[1].tolist() for a in k2]
        # bytes: the slot tables, the live flags and live rows in, the
        # frontier and meta out; operations: every candidate stepped and
        # tested (~16 int32 ops), every appended row hashed, probed and
        # written (~20)
        nbytes = float(np.mean([14 * C + N + 4 * L * int(a[3].sum()) + 1
                                + 4 * L * N + 16 for a in k2]))
        ops = float(np.mean([m[3] * C * 16 + m[0] * 20 for m in metas]))
        entry(f"frontier_closure[packed L{L},N{N},C{C}]", "K2", L,
              "frontier_closure.cu", 205, ms, plain_ms, *per_s(nbytes, ops),
              inputs=len(k2))
    for L in (1, 2):
        k2 = _most_kept(rec, "frontier_closure_batch", L)
        if not k2:
            continue
        step, xs, _, rows, live, run = k2[0][:6]
        (K, N), C = live.shape, xs["slot_f"].shape[2]
        ms = _time_launches(sk.frontier_closure_batch, k2, reps=3)
        plain_ms = _time_host(sk.frontier_closure_batch_reference, k2[:1])
        metas = [sk.frontier_closure_batch(*a)[1].cpu() for a in k2]
        nbytes = float(np.mean([
            int(a[5].sum()) * (14 * C + N + 4 * L * N + 17) + 4 * L * int(
                (a[4] & a[5][:, None]).sum()) for a in k2]))
        ops = float(np.mean([int((m[:, 3] * C * 16 + m[:, 0] * 20).sum())
                             for m in metas]))
        entry(f"frontier_closure_batch[packed L{L},K{K},N{N},C{C}]",
              "K2 batch", L, "frontier_closure.cu", 205, ms, plain_ms,
              *per_s(nbytes, ops), inputs=len(k2),
              cluster=sk.k2_cluster(dev, K, N, C, L, False))
    for name, key in (("tiled_insert", "K4"),
                      ("tiled_insert_batch", "K4 batch")):
        fn, ref_fn = getattr(sk, name), getattr(sk, name + "_reference")
        for L in (1, 2):
            k4 = _most_kept(rec, name, L)
            if not k4 and key == "K4 batch":
                continue
            _require(len(k4) > 0, f"no packed {key} input kept at {L} lanes")
            k4 = k4[:6]
            c_live, T = k4[0][1], k4[0][2][1].shape[-1]
            KM = c_live.numel()

            def fresh(reps, k4=k4):
                return [a[:2] + ((tuple(x.clone() for x in a[2][0]),
                                  a[2][1].clone()),) + a[3:]
                        for _ in range(reps) for a in k4]

            ms = kernel_ab._time_once_each(torch, fn, fresh(1), fresh(2))
            plain_ms = _time_host(ref_fn, k4[:1])
            outs = [fn(*a) for a in fresh(1)]
            live = float(np.mean([int(a[1].sum()) for a in k4]))
            probes = float(np.mean([int((o[2][a[1]] + 1).sum())
                                    for a, o in zip(k4, outs)]))
            n_fresh = float(np.mean([int(o[1].sum()) for o in outs]))
            # bytes: every live flag read and fresh and off written; the
            # live rows read, each probed slot read (4L bytes of row, 1 of
            # occupancy) and each claimed one written; operations: the
            # live test of every candidate, the hash and a compare a probe
            nbytes = 6 * KM + 4 * L * live + (4 * L + 1) * (probes + n_fresh)
            ops = KM + live * 24 + probes * 4
            shape = f"K{c_live.shape[0]}," if c_live.dim() == 2 else ""
            entry(f"{name}[packed L{L},{shape}T{T},M{c_live.shape[-1]}]",
                  key, L, "tiled_insert.cu", 345, ms, plain_ms,
                  *per_s(nbytes, ops), inputs=len(k4), mean_live=live,
                  grid=sk.k4_grid(dev))
    k3 = {}
    for a in _all_kept(rec, "hash_insert"):
        L, T = len(a[0]), a[4][1].shape[0]
        if a[1].shape[0] > a[2][0].shape[0]:     # an expansion insert
            k3.setdefault((L, sk.k3_layout(T // 2, dev, L)), {}) \
                .setdefault(T, []).append(a)
    for (L, layout), by_T in sorted(k3.items()):
        T = max(by_T)
        inputs = by_T[T]
        M, N = inputs[0][1].shape[0], inputs[0][2][0].shape[0]
        ms = _time_launches(sk.hash_insert, inputs, reps=3)
        grid_ms = _time_launches(_k3_forced("device"), inputs, reps=3) \
            if layout == "shared" else ms
        plain_ms = _time_host(sk.hash_insert_reference, inputs[:2])
        live = float(np.mean([int(a[1].sum()) for a in inputs]))
        n_fresh = float(np.mean([int(sk.hash_insert(*a)[2]) - int(a[3])
                                 for a in inputs]))
        # bytes: every live flag, the live rows, the table in and out,
        # the fresh rows appended, the count and meta
        nbytes = M + 4 * L * live + 2 * (4 * L + 1) * T + 4 * L * n_fresh \
            + 16
        ops = M + 24 * live
        entry(f"hash_insert[packed L{L},{K3_NAMES[layout]},T{T},M{M}]",
              f"K3 {layout}", L, "hash_insert.cu", 282, ms, plain_ms,
              *per_s(nbytes, ops), inputs=len(inputs), layout=layout,
              grid_ms=grid_ms)
    return out


# ------------------------------------------------------------ search stats

# The reference's search-stats blocks (jepsen_tpu on the CPU,
# search_stats=True, dedupe "hash"; tests/torch_record_stats_refs.py):
# per check the digest of its block without "closure-iters", the digest
# of the sparse blocks' "closure-iters" (`_stats_digest`: None for a
# dense block, whose card path reports -1 where the reference's CPU
# closure counts its double expansions), its events and frontier peak;
# a batch's digests go over its keys' blocks in input order.
REF_STATS = {
    "adv-10k-k12": {
        "digest": "cbf621e3ae62f679", "events": 9988,
        "frontier-peak": 28672, "iters": "74234e98afe7498f"},
    "fifo-valid.edn": {
        "digest": "1f6a1682af4b3364", "events": 40,
        "frontier-peak": 253, "iters": "e9a0f7ed7396941b"},
    "uqueue-valid.edn": {
        "digest": "7475a118e52811ad", "events": 45,
        "frontier-peak": 128, "iters": "762371bee5036bfd"},
    "gset-valid.edn": {
        "digest": "341897ff0bf6f572", "events": 46,
        "frontier-peak": 16, "iters": "3402fc95c0e474b3"},
    "fifo-invalid.edn": {
        "digest": "ffabeaf519a18627", "events": 3,
        "frontier-peak": 5, "iters": "b3d4dc5729168c11"},
    "uqueue-invalid.edn": {
        "digest": "5cad4f4d75d4e2ee", "events": 8,
        "frontier-peak": 32, "iters": "94b1bdfb096426ef"},
    "gset-invalid.edn": {
        "digest": "eb9df739ef448e8d", "events": 21,
        "frontier-peak": 16, "iters": "0a46525c692182e0"},
    "fifo-1000": {
        "digest": "703a5c63cbfeca49", "events": 863,
        "frontier-peak": 18610, "iters": "a48851c022f2aaa7"},
    "gset-200 two-lane": {
        "digest": "b8d219018041cc4c", "events": 199,
        "frontier-peak": 16384, "iters": "c2f365d02ea24913"},
    "multikey-84": {
        "digest": "f8b4aa0ddb818af0", "events": 7433,
        "frontier-peak": 49344, "iters": "d1709bfb49d99900"},
    "multikey-84+8": {
        "digest": "16067828a47496dd", "events": 9627,
        "frontier-peak": 589824, "iters": "393c2bf7de5f1ad8"},
    "uqueue-24+4": {
        "digest": "29f7d65588a95d6e", "events": 3124,
        "frontier-peak": 32768, "iters": "20f0e6f96a2ee2d7"},
    "uqueue key 1 max4096": {
        "digest": "eabd83632a5f543a", "events": 116,
        "frontier-peak": 8192, "iters": "6fe4db5d29f862c6"},
}
# The race's histories and the verdicts the reference gives them (the
# impossible-read twin and the golden files are invalid: REF_BATCH,
# REF and the manifest agree).
REF_RACE = {"adv-10k-k12": True, "adv-10k-k12 impossible read": False,
            "register-invalid.edn": False, "fifo-invalid.edn": False}
# The reference's `linear` and `packed` checkers on the golden invalid
# histories: the analyzer and the digest of op, final-paths, configs and
# oracle-disagreement after the WGL re-search.
REF_CHECKERS = {
    "register-invalid.edn linear": {"analyzer": "linear",
        "digest": "567f912963988bd3"},
    "register-invalid.edn packed": {"analyzer": "packed",
        "digest": "567f912963988bd3"},
    "mutex-invalid.edn linear": {"analyzer": "linear",
        "digest": "4409437945dd6236"},
    "mutex-invalid.edn packed": {"analyzer": "packed",
        "digest": "4409437945dd6236"},
    "fifo-invalid.edn linear": {"analyzer": "linear",
        "digest": "e854c0dce32f98df"},
    "fifo-invalid.edn packed": {"analyzer": "packed",
        "digest": "e854c0dce32f98df"},
    "uqueue-invalid.edn linear": {"analyzer": "linear",
        "digest": "eea994812acde080"},
    "uqueue-invalid.edn packed": {"analyzer": "packed",
        "digest": "eea994812acde080"},
    "gset-invalid.edn linear": {"analyzer": "linear",
        "digest": "09a02baa4d4a0e41"},
    "gset-invalid.edn packed": {"analyzer": "packed",
        "digest": "09a02baa4d4a0e41"},
}
STATS_KEEP = 6    # K2 stats inputs kept per (wrapper, lanes, keys)


def _digest(doc) -> str:
    import hashlib
    return hashlib.sha256(json.dumps(doc, sort_keys=True, default=repr)
                          .encode()).hexdigest()[:16]


def _stats_digest(blocks) -> dict:
    """tests/torch_record_stats_refs.py's `stats_digest` of one block or
    a batch's list of blocks: "closure-iters" apart, and None for a dense
    block's (the card's K1 path reports -1 where the reference's CPU
    closure counts)."""
    one = isinstance(blocks, dict)
    bs = [blocks] if one else blocks
    rest = [{k: v for k, v in b.items() if k != "closure-iters"}
            for b in bs]
    iters = [None if b["engine"] == "bitdense" else b["closure-iters"]
             for b in bs]
    return {"digest": _digest(rest[0] if one else rest),
            "iters": _digest(iters[0] if one else iters),
            "events": sum(b["events"] for b in bs),
            "frontier-peak": max(b["frontier-peak"] for b in bs)}


def _want_stats(name) -> dict:
    return dict(REF_STATS[name])


class _KeepStats:
    """Keeps copies of the inputs of K2's stats calls (single and
    batched), every `stride`-th up to STATS_KEEP per (wrapper, lanes,
    keys), in kept[(wrapper, lanes, keys)]. The wrappers run and count as
    ever."""

    NAMES = ("frontier_closure", "frontier_closure_batch")

    def __init__(self, stride: int = 5):
        self.stride = stride
        self.kept, self.seen = {}, {}

    def __enter__(self):
        from jepsen_tpu_torch.parallel import sparse_kernels as sk
        self.real = {n: getattr(sk, n) for n in self.NAMES}
        pc = _parity_cases()

        def wrap(name, real):
            def recording(*args, **kw):
                if kw.get("stats"):
                    live = args[_ROWS_AT[name] + 1]
                    key = (name, len(args[_ROWS_AT[name]]),
                           live.numel() // live.shape[-1])
                    n = self.seen[key] = self.seen.get(key, 0) + 1
                    kept = self.kept.setdefault(key, [])
                    if n % self.stride == 0 and len(kept) < STATS_KEEP:
                        kept.append((pc._clone(args),
                                     {k: v for k, v in kw.items()
                                      if k != "stats"}))
                return real(*args, **kw)
            return recording

        for n, real in self.real.items():
            setattr(sk, n, wrap(n, real))
        return self

    def __exit__(self, *exc):
        from jepsen_tpu_torch.parallel import sparse_kernels as sk
        for n, real in self.real.items():
            setattr(sk, n, real)


def _keyed_history(hs):
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.history import History
    ops = []
    for k, h in enumerate(hs):
        for o in h:
            o = dict(o)
            o["value"] = independent.KV(k, o.get("value"))
            ops.append(o)
    return History.wrap(ops).index()


def phase_stats_main(dev, cases) -> dict:
    """The search-stats main path (search_stats=True), each history once:
    through the checker, the dense 10k-op check (K1: `closure-iters` all
    -1), the six golden queue/set histories and the 1000-op FIFO (K2's
    stats instantiation, then K4's tiers) and the two-lane set with
    config_pack; through `independent`, the 84-key dense batch and the
    28-key sparse batch; through `engine.check_batch`, the 92-key dense
    batch (the 84 and eight wider keys) and one key of the 28 escalated at
    max_capacity 4,096. Every block equals the reference's (REF_STATS)
    field for field, `closure-iters` too but in the dense engine's
    blocks. Launch counts are zeroed just before each check and read
    just after; each sparse check launches K2's stats instantiation and
    never its stats-off one. Keeps K2's stats inputs for the parity and
    timing phases."""
    from jepsen_tpu_torch import histories, independent, models
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import engine, sparse_kernels as sk
    keep = _KeepStats()
    totals = {"K1": 0, "K1 batch": 0, "K2 stats": 0, "K2 batch stats": 0}

    def run(name, fn):
        torch.cuda.synchronize()
        ck.reset_launches()
        sk.reset_launches()
        t0 = time.perf_counter()
        with keep:
            out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = dict(sk.launches, K1=ck.launches, K1_batch=ck.batch_launches)
        _require(n["frontier_closure"] == n["frontier_closure_batch"] == 0,
                 f"stats {name}: K2's stats-off instantiation launched")
        for k, key in (("K1", "K1"), ("K1 batch", "K1_batch"),
                       ("K2 stats", "frontier_closure_stats"),
                       ("K2 batch stats", "frontier_closure_batch_stats")):
            totals[k] += n[key]
        return out, secs, n

    def held(name, blocks, secs, n):
        got = _stats_digest(blocks)
        _require(got == _want_stats(name),
                 f"stats {name}: {got} != the reference's "
                 f"{_want_stats(name)}")
        print(f"stats: {name}: == REF_STATS ({got['events']} events, peak "
              f"{got['frontier-peak']}), wall {secs:.3f} s, launches "
              + json.dumps({k: v for k, v in n.items() if v}))

    reg = models.CASRegister(None)
    name = "adv-10k-k12"
    adv = histories.adversarial_register_history(n_ops=10000, k_crashed=12)
    r, secs, n = run(name, lambda: Linearizable(
        reg, "torch", device=dev, search_stats=True).check({}, adv))
    b = r["stats"]
    _require(b["engine"] == "bitdense" and n["K1"] == b["events"]
             and set(b["closure-iters"]) == {-1},
             f"stats {name}: K1 did not run every closure "
             f"({set(b['closure-iters'])}, {n['K1']} launches)")
    held(name, b, secs, n)
    sparse_cases = [c for c in cases if c[0] in REF_STATS] + [
        (PACKED_TWO_LANE, models.GSet(), histories.rand_gset_history(
            200, n_processes=14, n_elements=20, crash_p=0.005, seed=1))]
    for name, model, h in sparse_cases:
        kw = {"config_pack": True} if name == PACKED_TWO_LANE else {}
        r, secs, n = run(name, lambda model=model, h=h, kw=kw: Linearizable(
            model, "torch", device=dev, search_stats=True, **kw).check(
            {}, h))
        _require(n["frontier_closure_stats"] > 0,
                 f"stats {name}: K2's stats instantiation never ran")
        held(name, r["stats"], secs, n)

    dense, extra = _batch_keys()
    queue = models.UnorderedQueue()
    hs = _sparse_batch_keys()
    for name, model, hs_ in (("multikey-84", reg, dense),
                             ("uqueue-24+4", queue, hs)):
        r, secs, n = run(name, lambda m=model, h=hs_:
                         independent.checker(Linearizable(
                             m, device=dev, search_stats=True)).check(
                             {}, _keyed_history(h)))
        bs = [r["results"][k]["stats"] for k in range(len(hs_))]
        _require(n["K1_batch"] > 0 if model is reg else
                 n["frontier_closure_batch_stats"] > 0
                 and n["tiled_insert_batch"] > 0,
                 f"stats {name}: the batch's kernels never ran")
        _require(all("pad-waste" in b for b in bs),
                 f"stats {name}: no pad extras")
        held(name, bs, secs, n)
    name = "multikey-84+8"
    rs, secs, n = run(name, lambda: engine.check_batch(
        reg, dense + extra, device=dev, search_stats=True))
    _require(n["K1_batch"] > 0, f"stats {name}: no batched K1 launch")
    held(name, [r["stats"] for r in rs], secs, n)
    name = "uqueue key 1 max4096"
    rs, secs, n = run(name, lambda: engine.check_batch(
        queue, [hs[1]], max_capacity=SPARSE_ESC_CEILING, device=dev,
        search_stats=True))
    _require(rs[0].get("escalated") == "single",
             f"stats {name}: not escalated ({rs[0].get('escalated')})")
    held(name, rs[0]["stats"], secs, n)
    print("stats: launches over the stats main path " + json.dumps(totals))
    return {"launches": totals, "kept": keep.kept}


def _k2_stats_seeded(pc, dev):
    """K2's seeded inputs at one, two and three lanes: [(name, args,
    kw)] for the single-key wrapper, and batched inputs of three keys
    (the case, the case with run False, and its frontier less its first
    live row) on two event rows (the case's, and its slots reversed)."""
    single, batch = [], []
    cases = [c + ((),) for c in pc.k2_cases()] + pc.packed_k2_cases()
    for name, step, ev, rows, live, run, pl, pack in cases:
        kw = {"pack": pack} if pack else {}
        single.append((name, _to((step, ev, rows, live, run, pl), dev), kw))
        if live.shape[0] > 2048:
            continue
        rev = {k: v.flip(0) for k, v in ev.items()}
        xs = {k: torch.stack([ev[k], rev[k]])[None].expand(3, 2, -1)
              .contiguous() for k in ev}
        live2 = live.clone()
        live2[int(live.nonzero()[0])] = False
        for r in (0, 1):
            batch.append((name, _to((step, xs, r, tuple(
                torch.stack([x, x, x]) for x in rows),
                torch.stack([live, live, live2]),
                torch.tensor([True, False, True]), pl), dev), kw))
    return single, batch


def phase_stats_parity(dev, kept) -> dict:
    """K2's stats instantiation, single and batched, at one, two and three
    lanes, against its plain version bit for bit (rows, meta and the
    stats outputs): on the seeded cases at probe_limit 2 and 32, and on
    the inputs kept from the stats main path. Its rows and meta also
    equal the stats-off launch's on the same inputs. Returns the largest
    |difference| per wrapper (0: bit-identical)."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    pc = _parity_cases()
    seeded, seeded_b = _k2_stats_seeded(pc, dev)
    worst = {"K2": 0, "K2 batch": 0}
    lanes = {"K2": set(), "K2 batch": set()}

    def hold(key, fn, plain, args, kw, what):
        got = fn(*args, stats=True, **kw)
        off = fn(*args, **kw)
        want = plain(*_to(args, "cpu"), stats=True, **kw)
        torch.cuda.synchronize()
        for g, w in zip(_flat(got), _flat(want)):
            err = int((g.cpu().long() - w.long()).abs().max()) \
                if g.numel() else 0
            worst[key] = max(worst[key], err)
        _require(all(torch.equal(g.cpu(), w)
                     for g, w in zip(_flat(got), _flat(want))),
                 f"K2 stats ({key}) differs from its plain version on "
                 f"{what}")
        _require(all(torch.equal(g, o) for g, o in zip(_flat(got[:2]),
                                                        _flat(off))),
                 f"K2 stats ({key}): rows or meta differ from the "
                 f"stats-off launch on {what}")
        lanes[key].add(len(args[_ROWS_AT[fn.__name__]]))

    n = 0
    for pl in (2, 32):
        for name, args, kw in seeded:
            hold("K2", sk.frontier_closure,
                 sk.frontier_closure_reference, args[:5] + (pl,), kw,
                 f"{name} pl{pl}")
            n += 1
        for name, args, kw in seeded_b:
            hold("K2 batch", sk.frontier_closure_batch,
                 sk.frontier_closure_batch_reference, args[:6] + (pl,), kw,
                 f"{name} (batched) pl{pl}")
            n += 1
    for (name, L, _), calls in kept.items():
        key = "K2" if name == "frontier_closure" else "K2 batch"
        fn = getattr(sk, name)
        plain = getattr(sk, name + "_reference")
        for args, kw in calls:
            hold(key, fn, plain, _to(args, dev), kw, f"kept {name} L{L}")
            n += 1
    _require(lanes["K2"] == lanes["K2 batch"] == {1, 2, 3},
             f"K2 stats parity lanes {lanes}")
    print(f"parity: K2 stats == plain, bit for bit, single and batched at "
          f"lanes 1-3, on {n} inputs (seeded at probe_limit 2 and 32, and "
          f"kept from the stats main path); rows and meta == stats off")
    return worst


def phase_stats_timing(dev, kept, launches) -> list:
    """K2 per launch with CUDA events, stats on against stats off on the
    same inputs (kept from the stats main path at three lanes: the
    single-key K2 inputs, and the batched ones of the 28-key batch's
    widest bucket), beside the plain version and the bound; one
    kernels-line entry each."""
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    out = []
    for name, key, line in (("frontier_closure", "K2 stats", 205),
                            ("frontier_closure_batch", "K2 batch stats",
                             205)):
        L = 3
        groups = [k for k in kept if k[:2] == (name, L)]
        _require(groups, f"no {name} stats inputs kept at {L} lanes")
        calls = [(_to(a, dev), kw) for a, kw in kept[max(groups)]]
        fn = getattr(sk, name)
        plain = getattr(sk, name + "_reference")
        args = [a for a, _ in calls]
        on_ms = _time_launches(lambda *a: fn(*a, stats=True), args, reps=10)
        off_ms = _time_launches(fn, args, reps=10)
        plain_ms = _time_host(lambda *a: plain(*_to(a, "cpu"), stats=True),
                              args[:4])
        # bytes: as K2's entry (slot tables, live flags and live rows in,
        # the frontier and meta out) plus 32 bytes of stats a key;
        # operations: K2's, plus a bucket and a count per attempted
        # candidate (~8)
        outs = [plain(*_to(a, "cpu"), stats=True) for a in args]
        live = args[0][_ROWS_AT[name] + 1]
        N = live.shape[-1]
        K = live.numel() // N
        C = args[0][1]["slot_f"].shape[-1]
        nbytes = float(np.mean([
            K * (14 * C + 12 * N + 16 + 32) + N * K
            + 12 * int(a[_ROWS_AT[name] + 1].sum()) for a in args]))
        ops = float(np.mean([
            int((o[1][..., 3] * C * 16 + o[1][..., 0] * 20).sum())
            + 8 * int(o[2][..., 1:].sum()) for o in outs]))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT32_OPS_PER_S * 1e3
        t = {"name": f"{name}[stats,K{K},N{N},C{C},L{L}]", "route": "cuda",
             "source": "jepsen_tpu_torch/kernels/frontier_closure.cu",
             "replaces": f"jepsen_tpu/parallel/sparse_kernels.py:{line}",
             "launches": launches[key], "ms": on_ms, "stats_off_ms": off_ms,
             "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "library_ms": None, "inputs": len(args), "key": key,
             "cluster": sk.k2_cluster(dev, K, N, C, L, True)}
        print("timing: " + json.dumps(t))
        out.append(t)
    return out


def phase_race(dev) -> dict:
    """The competition race on the card, through `Linearizable(model,
    "competition")`: the 10k-op history, its impossible-read twin and
    two golden invalid histories. "torch" must be among the arms and
    every verdict the reference's (REF_RACE); the winner and each check's
    wall print. Then `Linearizable(model, "packed")` and `"linear"` on
    the golden invalid histories, each result's op, final-paths and
    configs (from the WGL re-search) equal to the reference's
    (REF_CHECKERS), and linear.svg written into a temporary store. The
    race must return only once its device arm has stopped."""
    import tempfile
    import threading
    from jepsen_tpu_torch import histories, models
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.history import History
    reg = models.CASRegister(None)
    adv = histories.adversarial_register_history(n_ops=10000, k_crashed=12)
    golden = {e["file"]: (getattr(models, SPARSE_MODELS.get(
        e["model"], {"cas-register": "CASRegister",
                     "mutex": "Mutex"}.get(e["model"])))(),
        History.from_edn((GOLDEN / e["file"]).read_text()).index())
        for e in json.loads((GOLDEN / "manifest.json").read_text())
        if not e["valid"] and e["ops"] <= 500}
    races = [("adv-10k-k12", reg, adv),
             ("adv-10k-k12 impossible read", reg,
              histories.with_impossible_read(adv))]
    races += [(f, *golden[f]) for f in ("register-invalid.edn",
                                        "fifo-invalid.edn")]
    out = {}
    for name, model, h in races:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = Linearizable(model, "competition", device=dev).check({}, h)
        secs = time.perf_counter() - t0
        comp = r["competition"]
        _require("torch" in comp["arms"], f"race {name}: arms {comp}")
        _require(r["valid?"] is REF_RACE[name],
                 f"race {name}: {r['valid?']} != {REF_RACE[name]}")
        # the race returns once its device arm has stopped
        _require(not [t for t in threading.enumerate()
                      if t.name == "competition-torch"],
                 f"race {name}: the device arm runs on after the race")
        print(f"race: {name}: valid? {r['valid?']}, arms {comp['arms']}, "
              f"winner {comp['winner']}, wall {secs:.3f} s")
        out[name] = {"winner": comp["winner"], "wall_s": secs}

    class Store:
        def __init__(self, root):
            self.root = pathlib.Path(root)

        def path(self, *parts):
            return str(self.root.joinpath(*map(str, parts)))

        def write_file(self, parts, text):
            pathlib.Path(self.path(*parts)).write_text(text)

    n = 0
    with tempfile.TemporaryDirectory() as tmp:
        for f, (model, h) in golden.items():
            for algo in ("linear", "packed"):
                svg = pathlib.Path(tmp) / "linear.svg"
                svg.unlink(missing_ok=True)
                r = Linearizable(model, algo, device=dev).check(
                    {"store": Store(tmp)}, h)
                d = _digest({k: r.get(k) for k in (
                    "op", "final-paths", "configs", "oracle-disagreement")})
                _require(r["valid?"] is False and r["final-paths"]
                         and {"analyzer": r["analyzer"], "digest": d}
                         == REF_CHECKERS[f"{f} {algo}"],
                         f"{algo} on {f}: differs from the reference's")
                _require(svg.read_text().startswith("<svg"),
                         f"{algo} on {f}: no linear.svg")
                n += 1
    print(f"checkers: linear and packed on {len(golden)} golden invalid "
          f"histories ({n} checks): == REF_CHECKERS, final-paths from the "
          f"re-search, linear.svg written into the store")
    return out


# ------------------------------------------------- resumable and streaming

# The reference's checkpoints of the 400-op unordered queue's resumable
# check from capacity 64, one every 32 events (jepsen_tpu on the CPU,
# dedupe "hash"; tests/torch_record_checkpoint_refs.py): per checkpoint
# (event index, capacity, ok, fail_r, maxf, steps_n, stepped, the digest
# of its arrays: _cp_digest), and the result.
REF_CHECKPOINTS = {
    "result": {"valid?": True, "max-frontier": 256, "capacity": 256, "configs-stepped": 25467, "fail-event": None},
    "checkpoints": [
        [32, 128, True, -1, 124, 70, 671, "04d96ae68e48d3c3"],
        [64, 256, True, -1, 256, 135, 3471, "dc9952cc549daa2a"],
        [96, 256, True, -1, 256, 197, 4877, "2a9bd52a11b7b3ab"],
        [128, 256, True, -1, 256, 260, 5195, "23ddc0467168dfc2"],
        [160, 256, True, -1, 256, 327, 7061, "382b68b282772ecf"],
        [192, 256, True, -1, 256, 388, 8269, "22a665236ce3bd69"],
        [224, 256, True, -1, 256, 456, 8815, "ba20afca986daaf5"],
        [256, 256, True, -1, 256, 522, 14191, "c6865e121a0627e2"],
        [288, 256, True, -1, 256, 584, 16727, "7fcb7b2667c9ae1e"],
        [320, 256, True, -1, 256, 647, 19175, "0f2c5cdc5445cce3"],
        [352, 256, True, -1, 256, 710, 22743, "603b35f69b8456fc"],
        [384, 256, True, -1, 256, 776, 25335, "4fcb74e627c375fa"],
        [392, 256, True, -1, 256, 787, 25467, "7be218960ef05db4"]],
}
CP_OPS, CP_CAPACITY, CP_EVERY = 400, 64, 32
RESUME_EVERY = 256         # the 1000-op FIFO's checkpoint interval
STREAM_DELTA = 50          # ops a delta
STREAM_BATCH_DELTAS = 4
STREAM_QUEUE_KEYS = 12          # the streaming phases' keys: the first of
STREAM_QUEUE_TWINS = (0, 6)     # sparse-batch-28, and these keys' twins


def _cp_digest(cp) -> str:
    """tests/torch_record_checkpoint_refs.py's digest of a checkpoint's
    arrays (dtype and bytes of st, ml, mh, live)."""
    import hashlib
    h = hashlib.sha256()
    for a in (cp.st, cp.ml, cp.mh, cp.live):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _cp_row(cp) -> list:
    return [cp.event_index, cp.capacity, cp.ok, cp.fail_r, cp.maxf,
            cp.steps_n, cp.stepped, _cp_digest(cp)]


def _sparse_counts_all() -> dict:
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    return dict(sk.launches)


ONE_SHOT_KEYS = ("valid?", "fail-event", "op", "max-frontier", "capacity",
                 "configs-stepped")
# what a streamed check shares with the one-shot check of its prefix: not
# the capacity, which a session keeps at the largest any earlier prefix
# needed (a queue's packing, so its table's probes, change with the
# history)
STREAM_KEYS = ("valid?", "fail-event", "op", "max-frontier",
               "configs-stepped")


def phase_resumable(dev, sparse_results) -> dict:
    """The resumable check (`engine.check_encoded_resumable`) on the card:
    the 1000-op FIFO (K2, then K4 past K2's gate from capacity 4,096)
    from capacity 1,024 with a checkpoint every 256 events, each saved
    to .npz, and a resume from the second file; both equal to the card's
    one-shot check of the sparse main path. Then the 400-op unordered
    queue from capacity 64, a checkpoint every 32 events (the capacity
    doubles inside chunks, each chunk re-run from the checkpoint before
    it): every checkpoint equal, array for array (a digest), to the
    reference's (REF_CHECKPOINTS), and again from a resume of its middle
    checkpoint — K2's claim order through a resume."""
    import tempfile
    from jepsen_tpu_torch.models import FIFOQueue, UnorderedQueue
    from jepsen_tpu_torch import histories
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import engine
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    out = {}
    fifo = histories.rand_fifo_history(1000, n_processes=8, crash_p=0.005,
                                       seed=1)
    e = enc.encode(FIFOQueue(), fifo)
    one = sparse_results["fifo-1000"]
    with tempfile.TemporaryDirectory() as tmp:
        paths = []

        def save(cp):
            paths.append(cp.save(f"{tmp}/fifo-1000-{len(paths)}"))

        torch.cuda.synchronize()
        sk.reset_launches()
        t0 = time.perf_counter()
        r = engine.check_encoded_resumable(e, checkpoint_every=RESUME_EVERY,
                                           checkpoint_cb=save, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = _sparse_counts_all()
        _require(n["frontier_closure"] > 0 and n["tiled_insert"] > 0,
                 f"fifo-1000 resumable: K2 and K4 must both run: {n}")
        _require(len(paths) >= 3, f"fifo-1000: {len(paths)} checkpoints")
        cp = engine.FrontierCheckpoint.load(paths[1])
        sk.reset_launches()
        t0 = time.perf_counter()
        r2 = engine.check_encoded_resumable(e,
                                            checkpoint_every=RESUME_EVERY,
                                            resume=cp, device=dev)
        torch.cuda.synchronize()
        secs2 = time.perf_counter() - t0
        n2 = _sparse_counts_all()
    for name, got in (("fifo-1000 resumable", r),
                      ("fifo-1000 resumed", r2)):
        _require({k: got.get(k) for k in ONE_SHOT_KEYS}
                 == {k: one.get(k) for k in ONE_SHOT_KEYS},
                 f"{name}: differs from the one-shot check: {got}")
    _require(n2["tiled_insert"] > 0, f"fifo-1000 resumed: K4 {n2}")
    out["fifo-1000"] = {"wall_s": secs, "resumed_wall_s": secs2,
                        "checkpoints": len(paths), "resumed_from":
                        cp.event_index, "launches": n,
                        "resumed_launches": n2}
    print(f"resumable: fifo-1000: {len(paths)} checkpoints (.npz), "
          f"capacity {r['capacity']}, == the one-shot check; wall "
          f"{secs:.3f} s, launches K2 {n['frontier_closure']} K4 "
          f"{n['tiled_insert']}; resumed from event {cp.event_index}: "
          f"{secs2:.3f} s, K2 {n2['frontier_closure']} K4 "
          f"{n2['tiled_insert']}")
    uq = histories.rand_queue_history(CP_OPS, n_processes=8,
                                      crash_p=0.005, seed=1)
    e = enc.encode(UnorderedQueue(), uq)
    cps = []
    sk.reset_launches()
    t0 = time.perf_counter()
    r = engine.check_encoded_resumable(e, capacity=CP_CAPACITY,
                                       checkpoint_every=CP_EVERY,
                                       checkpoint_cb=cps.append,
                                       dedupe="hash", device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = _sparse_counts_all()
    want = REF_CHECKPOINTS
    rows = [_cp_row(cp) for cp in cps]
    _require(rows == want["checkpoints"],
             f"uqueue-400 checkpoints differ from the reference's: "
             f"{[i for i, (a, b) in enumerate(zip(rows, want['checkpoints'])) if a != b]}")
    _require({k: r.get(k) for k in want["result"]} == want["result"],
             f"uqueue-400 resumable: {r}")
    _require(n["frontier_closure"] > 0, f"uqueue-400: K2 {n}")
    mid = len(cps) // 2
    again = []
    engine.check_encoded_resumable(e, resume=cps[mid],
                                   checkpoint_every=CP_EVERY,
                                   checkpoint_cb=again.append,
                                   dedupe="hash", device=dev)
    _require([_cp_row(cp) for cp in again] == want["checkpoints"][mid + 1:],
             "uqueue-400: the checkpoints after a resume differ")
    caps = sorted({cp.capacity for cp in cps})
    out["uqueue-400"] = {"wall_s": secs, "checkpoints": len(cps),
                         "capacities": caps, "launches": n}
    print(f"resumable: uqueue-400 from capacity {CP_CAPACITY}: {len(cps)} "
          f"checkpoints == REF_CHECKPOINTS array for array (capacities "
          f"{caps}), and after a resume from event "
          f"{cps[mid].event_index}; wall {secs:.3f} s, K2 launches "
          f"{n['frontier_closure']}")
    return out


def _one_shot(model, ops, dev, **kw):
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import sparse
    return sparse.check_encoded(enc.encode(model, History.wrap(ops)),
                                device=dev, **kw)


def phase_stream(dev) -> dict:
    """Streaming sessions (`extend.HistorySession`) on the card, fed in
    deltas of 50 op records: the 400-op unordered queue, checked after
    every delta, and the corrupted 1000-op FIFO, checked after every
    eighth delta and the last (a queue's packing grows with its
    enqueues, so a delta settles no event and each check scans its
    prefix again: the FIFO's checks are the phase's cost). Every check
    up to the first invalid one equals the card's one-shot check of the
    same prefix (STREAM_KEYS); every later one keeps that counterexample
    (prefix closure: it is final). Mid-stream the queue's session is frozen to
    .npz and thawed into a fresh session, whose check resumes from the
    frozen event and launches nothing."""
    import tempfile
    from jepsen_tpu_torch import histories
    from jepsen_tpu_torch.models import FIFOQueue, UnorderedQueue
    from jepsen_tpu_torch.parallel import engine, extend
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    out = {}
    uq = [dict(o) for o in histories.rand_queue_history(
        CP_OPS, n_processes=8, crash_p=0.005, seed=1)]
    fifo = [dict(o) for o in histories.corrupt_history(
        histories.rand_fifo_history(1000, n_processes=8, crash_p=0.005,
                                    seed=1), seed=0)]
    for name, model, ops in (("uqueue-400", UnorderedQueue(), uq),
                             ("fifo-1000 corrupted", FIFOQueue(), fifo)):
        s = extend.HistorySession(model, device=dev, key=name)
        n_deltas = -(-len(ops) // STREAM_DELTA)
        checked = [d for d in range(n_deltas)
                   if name == "uqueue-400" or d % 8 == 7
                   or d == n_deltas - 1]
        t_session = t_one = 0.0
        first_invalid = None
        sk.reset_launches()
        for d in range(n_deltas):
            s.extend(ops[d * STREAM_DELTA:(d + 1) * STREAM_DELTA])
            if d not in checked:
                continue
            t0 = time.perf_counter()
            r = s.check()
            torch.cuda.synchronize()
            t_session += time.perf_counter() - t0
            if first_invalid is not None:
                _require({k: r.get(k) for k in STREAM_KEYS}
                         == first_invalid[1],
                         f"{name}: delta {d}: the counterexample did not "
                         f"stay final: {r}")
                continue
            t0 = time.perf_counter()
            one = _one_shot(model, ops[:(d + 1) * STREAM_DELTA], dev)
            torch.cuda.synchronize()
            t_one += time.perf_counter() - t0
            _require({k: r.get(k) for k in STREAM_KEYS}
                     == {k: one.get(k) for k in STREAM_KEYS},
                     f"{name}: delta {d}: the session differs from the "
                     f"one-shot check: {r} {one}")
            if r["valid?"] is False:
                first_invalid = (d, {k: r.get(k) for k in STREAM_KEYS})
            if name == "uqueue-400" and d == n_deltas // 2:
                with tempfile.TemporaryDirectory() as tmp:
                    meta = s.freeze(f"{tmp}/{name}")
                    cp = engine.FrontierCheckpoint.load(meta["checkpoint"])
                thawed = extend.HistorySession(model, device=dev)
                thawed.thaw(ops[:(d + 1) * STREAM_DELTA], cp)
                n0 = dict(sk.launches)
                rt = thawed.check()
                _require(thawed.resume_event == meta["event_index"] > 0
                         and sk.launches == n0
                         and {k: rt.get(k) for k in STREAM_KEYS}
                         == {k: r.get(k) for k in STREAM_KEYS},
                         f"{name}: the thawed session rescanned or differs")
                print(f"stream: {name}: frozen at delta {d} (event "
                      f"{meta['event_index']}), thawed: resumes there, "
                      f"no launch, == the session")
        n = _sparse_counts_all()
        final = s.finalize()
        _require(final.get("valid?") is (name == "uqueue-400"),
                 f"{name}: final verdict {final.get('valid?')}")
        if name != "uqueue-400":
            _require(first_invalid is not None
                     and first_invalid[0] < n_deltas - 1
                     and bool(final.get("final-paths")),
                     f"{name}: no early counterexample: {first_invalid}")
        out[name] = {"checks": len(checked), "session_s": t_session,
                     "one_shot_s": t_one, "launches": n,
                     "first_invalid_delta": first_invalid and
                     first_invalid[0]}
        print(f"stream: {name}: {n_deltas} deltas of {STREAM_DELTA} ops, "
              f"{len(checked)} checks == the one-shot prefixes; session "
              f"{t_session:.3f} s, one-shot {t_one:.3f} s; launches K2 "
              f"{n['frontier_closure']} K4 {n['tiled_insert']}"
              + (f"; invalid from delta {first_invalid[0]} on (event "
                 f"{first_invalid[1]['fail-event']})" if first_invalid
                 else ""))
    return out


def _stream_batch_keys() -> tuple:
    """(histories, their REF_SPARSE_BATCH indices): the first
    STREAM_QUEUE_KEYS keys of sparse-batch-28 and the corrupted twins of
    STREAM_QUEUE_TWINS — the streaming phases' cut of the 28 (the 28 took
    45.4 s of the stream batch phase, whose smoke passed 850 s)."""
    qs = _sparse_batch_keys()
    index = list(range(STREAM_QUEUE_KEYS)) \
        + [SPARSE_BATCH_KEYS + SPARSE_TWINS.index(k)
           for k in STREAM_QUEUE_TWINS]
    return [[dict(o) for o in qs[j]] for j in index], index


def phase_stream_batch(dev) -> dict:
    """14 sparse-batch keys (`_stream_batch_keys`: 12 keys and two
    corrupted twins) as streaming sessions fed in four deltas through
    `extend.advance_sessions` on the card:
    batched K2 and batched K4 from each key's resumed carry, their
    launches counted; after the last delta every key equal to a solo
    session's `check()` fed the same deltas (STREAM_KEYS: the batched
    sessions checked each delta, so a key may keep a larger capacity),
    and its verdict and failing op to the reference's batch
    (REF_SPARSE_BATCH)."""
    from jepsen_tpu_torch.models import UnorderedQueue
    from jepsen_tpu_torch.parallel import extend
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    hs, ref_index = _stream_batch_keys()
    model = UnorderedQueue()
    batched = [extend.HistorySession(model, capacity=512, device=dev,
                                     key=k) for k in range(len(hs))]
    solo = [extend.HistorySession(model, capacity=512, device=dev)
            for _ in hs]
    walls = []
    sk.reset_launches()
    with _Tiers() as tiers:
        for d in range(STREAM_BATCH_DELTAS):
            for s, so, o in zip(batched, solo, hs):
                lo = len(o) * d // STREAM_BATCH_DELTAS
                hi = len(o) * (d + 1) // STREAM_BATCH_DELTAS
                s.extend(o[lo:hi])
                so.extend(o[lo:hi])
            t0 = time.perf_counter()
            rs = extend.advance_sessions(batched)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    n = _sparse_counts_all()
    _require(n["frontier_closure_batch"] > 0 and n["tiled_insert_batch"] > 0,
             f"stream batch: batched K2 and K4 must both run: {n}")
    t0 = time.perf_counter()
    ones = [s.check() for s in solo]
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    for k, (r, o) in enumerate(zip(rs, ones)):
        _require({f: r.get(f) for f in STREAM_KEYS}
                 == {f: o.get(f) for f in STREAM_KEYS},
                 f"stream batch: key {k} differs from its solo check: "
                 f"{r} {o}")
    ref = REF_SPARSE_BATCH["uqueue-24+4"]["invalid"]
    _require([ref_index[k] for k, r in enumerate(rs) if r["valid?"] is False]
             == [j for j in ref_index if j in ref]
             and all({"fail-event": r["fail-event"], "op": r["op"]}
                     == ref[j] for r, j in zip(rs, ref_index) if j in ref),
             "stream batch: verdicts differ from REF_SPARSE_BATCH")
    legs = [t for t in tiers.seen]
    print(f"stream batch: {len(hs)} keys in {STREAM_BATCH_DELTAS} deltas "
          f"through advance_sessions: walls {[round(w, 3) for w in walls]}"
          f" s; == each key's solo check ({solo_s:.3f} s) and "
          f"REF_SPARSE_BATCH's verdicts; batched legs {len(legs)}, "
          f"launches batched K2 {n['frontier_closure_batch']} batched K4 "
          f"{n['tiled_insert_batch']}, solo fallbacks K2 "
          f"{n['frontier_closure']} K4 {n['tiled_insert']}")
    for t in legs:
        print(f"stream batch: leg {t}")
    return {"walls": walls, "solo_s": solo_s, "launches": n,
            "legs": len(legs)}


def _encode_walls(model, hs) -> dict:
    """The keys' encode on one thread, and on a pool of eight (the
    pipeline's decision against a thread pool)."""
    from concurrent.futures import ThreadPoolExecutor
    from jepsen_tpu_torch.parallel import encode as enc
    out = {"one_thread_s": [], "eight_threads_s": []}
    for _ in range(3):
        t0 = time.perf_counter()
        for h in hs:
            enc.finish_encode(enc.prepare_encode(model, h))
        out["one_thread_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda h: enc.finish_encode(
                enc.prepare_encode(model, h)), hs))
        out["eight_threads_s"].append(time.perf_counter() - t0)
    return out


def phase_pipeline(dev) -> dict:
    """The pipelined batch executor on the card: multikey-84+8 through
    `engine.check_batch(pipeline=True)` with a fresh encode cache, key
    for key REF_BATCH's, K1's persistent batched scan issued a chunk at a
    time; a second call hits the cache for every key with no encode.
    multikey-84 through the pipeline (no cache) and serially, three warm
    walls each, and the pipeline's encode / issue / device split; the 84
    keys' encode on one thread and on eight."""
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import engine, pipeline
    multikey, extra = _batch_keys()
    model = CASRegister()
    out = {}
    cache = pipeline.EncodeCache()
    for run in ("cold", "cached"):
        stats = {}
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        rs = engine.check_batch(model, multikey + extra, device=dev,
                                pipeline=True, cache=cache,
                                pipeline_stats=stats)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _require(_batch_digest(rs) == REF_BATCH["multikey-84+8"],
                 f"pipeline {run}: results differ from the reference's")
        _require(ck.batch_launches > 0 and ck.launches == 0,
                 f"pipeline {run}: K1 launches {ck.batch_launches} batched, "
                 f"{ck.launches} single")
        if run == "cached":
            _require(stats["cache"]["hits"] == len(rs)
                     and stats["cache"]["encodes"] == 0,
                     f"pipeline: the second call re-encoded: "
                     f"{stats['cache']}")
        out[run] = {"wall_s": secs, "stats": stats,
                    "launches": ck.batch_launches}
        print(f"pipeline: multikey-84+8 {run}: == REF_BATCH, wall "
              f"{secs:.3f} s, batched scan launches {ck.batch_launches}; "
              f"stats {json.dumps(stats)}")
    walls = {"pipeline": [], "serial": []}
    for _ in range(4):
        for arm in ("pipeline", "serial"):
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kw = ({"pipeline": True, "cache": False, "pipeline_stats": stats}
                  if arm == "pipeline" else {"pipeline": False})
            engine.check_batch(model, multikey, device=dev, **kw)
            torch.cuda.synchronize()
            walls[arm].append(time.perf_counter() - t0)
            if arm == "pipeline":
                split = stats
    out["multikey-84"] = {"cold_s": {a: w[0] for a, w in walls.items()},
                          "warm_s": {a: w[1:] for a, w in walls.items()},
                          "split": split}
    print(f"pipeline: multikey-84 warm walls (s) pipeline "
          f"{walls['pipeline'][1:]}, serial {walls['serial'][1:]}; the "
          f"last pipeline run's split {json.dumps(split)}")
    enc_walls = _encode_walls(model, multikey)
    out["encode"] = enc_walls
    print(f"pipeline: the 84 keys' encode, one thread "
          f"{enc_walls['one_thread_s']} s, eight threads "
          f"{enc_walls['eight_threads_s']} s")
    return out


# ------------------------------------------------- the streaming service

SERVE_TENANTS = {"tok-a": "smoke-a", "tok-b": "smoke-b"}
SERVE_DELTAS = 4
SERVE_EVICT_SECS = 0.5
SERVE_CMD = [sys.executable, "-m", "jepsen_tpu_torch.serve"]
# the register keys of the serve phase: multikey-84's keys 0-38 and the six
# corrupted keys (cut from 90 keys to make room for the fleet phase)
SERVE_VALID_KEYS = 39
# the capacity the register keys' frontiers (~12,000-13,250
# configurations) settle at on the sparse engine: the one-shot checks
# start there, sparing the ladder (the contract fields do not depend on
# the capacity; a key that needs more still climbs)
SERVE_ONE_SHOT_CAPACITY = 16384


def _serve_start(wal: str, args=(), env=None) -> tuple:
    """Start `python -m jepsen_tpu_torch.serve --model cas-register` on
    `wal` with its HTTP ingress on an OS-assigned port, plus `args`, in
    the environment `env` adds -> (process, the ports read so far, a
    queue of ("ingress" | "ops", port) as the stderr lines give them,
    stderr lines): `_serve_ports` waits for them. Each port comes from a
    stderr line `delta ingress: http://HOST:PORT` or `ops endpoint:
    http://HOST:PORT` (the regex takes the digits after the host's
    colon, since the line goes on after the port)."""
    import os
    import queue
    import re
    import threading
    proc = subprocess.Popen(
        SERVE_CMD + ["--model", "cas-register", "--wal-dir", wal, "--host",
                     "127.0.0.1", "--ingress-port", "0", *args],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
        env=dict(os.environ, **(env or {})))
    ports: queue.Queue = queue.Queue()
    err: list = []

    def pump():
        for line in proc.stderr:
            err.append(line)
            m = re.search(r"^(delta ingress|ops endpoint): "
                          r"http://[^:]+:(\d+)", line)
            if m:
                ports.put(("ops" if m.group(1) == "ops endpoint"
                           else "ingress", int(m.group(2))))
        ports.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return proc, {}, ports, err


def _serve_ports(child: tuple, names=("ingress",)) -> dict:
    """Wait for the started child's `names` ports -> {"ingress": port,
    "ops": port} (the ones asked for); a child that prints none fails
    the phase."""
    import queue
    proc, got, ports, err = child
    while not all(n in got for n in names):
        try:
            item = ports.get(timeout=600)
        except queue.Empty:
            item = None
        if item is None:
            proc.kill()
            proc.wait()
            _require(False, f"serve: the child printed no "
                            f"{'/'.join(names)} port: "
                            f"{''.join(err)[-4000:]}")
        got[item[0]] = item[1]
    return got


def _serve_child(wal: str) -> tuple:
    """The serve phase's child on `wal` with two tenants -> (process,
    ingress port)."""
    spec = ",".join(f"{name}:token={tok}"
                    for tok, name in SERVE_TENANTS.items())
    child = _serve_start(wal, env={"JEPSEN_TPU_TORCH_TENANTS": spec})
    return child[0], _serve_ports(child)["ingress"]


def _serve_http(port: int, path: str, body=None, token=None):
    """One request to the child's ingress -> (status, body text)."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else body.encode(),
        headers={"Authorization": f"Bearer {token}"} if token else {})
    try:
        with urllib.request.urlopen(req, timeout=900) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def _serve_post_lines(port: int, by_token: dict) -> list:
    """POST /v1/deltas, one streamed-JSONL body per tenant token ->
    every answer line, in order."""
    out = []
    for token, lines in by_token.items():
        code, text = _serve_http(
            port, "/v1/deltas",
            "".join(json.dumps(line) + "\n" for line in lines), token)
        _require(code == 200, f"serve: POST /v1/deltas answered {code}: "
                              f"{text[:2000]}")
        out += [json.loads(ln) for ln in text.splitlines()]
    return out


def _serve_register(dev) -> dict:
    """The entry point as a child process: keys 0-38 of multikey-84 and
    the six corrupted keys of multikey-84+8 (45 keys, 240 op records each,
    half to each tenant) in four deltas a key over HTTP, the child SIGKILLed after every key's
    second delta and restarted on the same WAL; a duplicate, a 401, the
    last two deltas, POST /v1/finalize for every key, and stop on stdin.
    Each key's verdict and failing op equal REF_BATCH's, and every
    contract field the card's one-shot `sparse.check_encoded`'s. The
    one-shot checks run in a thread of this process while the child
    works: both are host-bound, and the card is idle most of the time."""
    import signal
    import tempfile
    import threading
    from jepsen_tpu_torch.history import History
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import sparse
    multikey, extra = _batch_keys()
    hs = [[dict(o) for o in h]
          for h in multikey[:SERVE_VALID_KEYS] + extra[2:]]
    ref_index = list(range(SERVE_VALID_KEYS)) \
        + list(range(BATCH_KEYS + 2, BATCH_KEYS + 8))
    keys = [f"reg-{i}" for i in range(len(hs))]
    tokens = list(SERVE_TENANTS)
    token_of = {k: tokens[i % 2] for i, k in enumerate(keys)}

    def delta(i: int, d: int) -> dict:
        h = hs[i]
        lo = len(h) * d // SERVE_DELTAS
        hi = len(h) * (d + 1) // SERVE_DELTAS
        return {"key": keys[i], "ops": h[lo:hi], "seq": d + 1,
                "timeout": 600}

    def by_token(make) -> dict:
        out = {t: [] for t in tokens}
        for i, k in enumerate(keys):
            out[token_of[k]] += make(i)
        return out

    split = {"admission_s": 0.0}
    model = CASRegister()
    ones: list = []

    def one_shots():
        t0 = time.perf_counter()
        for h in hs:
            ones.append(sparse.check_encoded(
                enc.encode(model, History.wrap(h)),
                capacity=SERVE_ONE_SHOT_CAPACITY, device=dev))
        torch.cuda.synchronize()
        split["one_shot_s"] = time.perf_counter() - t0

    checker = threading.Thread(target=one_shots, daemon=True)
    checker.start()
    children = []
    with tempfile.TemporaryDirectory() as tmp:
        wal = f"{tmp}/wal"
        try:
            t0 = time.perf_counter()
            proc, port = _serve_child(wal)
            children.append(proc)
            split["first_start_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            acks = _serve_post_lines(port, by_token(
                lambda i: [delta(i, 0), delta(i, 1)]))
            split["admission_s"] += time.perf_counter() - t0
            _require(len(acks) == 2 * len(keys)
                     and all(a.get("accepted") for a in acks),
                     f"serve: deltas 1-2 not all accepted: "
                     f"{[a for a in acks if not a.get('accepted')][:3]}")
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            t0 = time.perf_counter()
            proc, port = _serve_child(wal)
            children.append(proc)
            split["restart_s"] = time.perf_counter() - t0
            replayed = _serve_post_lines(port, by_token(
                lambda i: [{"op": "result", "key": keys[i],
                            "timeout": 600}]))
            split["replay_s"] = time.perf_counter() - t0
            _require(all(r.get("seq") == 2 and "valid?" in r
                         for r in replayed),
                     f"serve: the restart did not replay two deltas a "
                     f"key: {replayed[:3]}")
            dup = _serve_post_lines(port, {token_of[keys[3]]:
                                           [delta(3, 1)]})
            _require(dup == [{"duplicate": True, "seq": 2,
                              "key": keys[3]}],
                     f"serve: a re-sent delta 2 answered {dup}")
            code, text = _serve_http(port, "/v1/deltas",
                                     json.dumps(delta(5, 2)) + "\n")
            _require(code == 401 and "unauthorized" in text,
                     f"serve: an unauthenticated POST answered {code} "
                     f"{text}")
            t0 = time.perf_counter()
            acks = _serve_post_lines(port, by_token(
                lambda i: [delta(i, 2), delta(i, 3)]))
            split["admission_s"] += time.perf_counter() - t0
            _require(len(acks) == 2 * len(keys)
                     and all(a.get("accepted") for a in acks),
                     "serve: deltas 3-4 not all accepted")
            t0 = time.perf_counter()
            finals = []
            for k in keys:
                code, text = _serve_http(
                    port, "/v1/finalize",
                    json.dumps({"key": k, "timeout": 600}), token_of[k])
                _require(code == 200, f"serve: finalize {k}: {code}")
                finals.append(json.loads(text))
            split["worker_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out, _ = proc.communicate('{"op": "stop"}\n', timeout=600)
            split["stop_s"] = time.perf_counter() - t0
            _require(proc.returncode == 0
                     and out.splitlines()[-1:] == ['{"stopped": true}'],
                     f"serve: stop ended the child with "
                     f"{proc.returncode}: {out[-2000:]}")
        finally:
            for p in children:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    t0 = time.perf_counter()
    checker.join()
    split["one_shot_wait_s"] = time.perf_counter() - t0
    _require(len(ones) == len(hs), "serve: the one-shot checks failed")
    ref = REF_BATCH["multikey-84+8"]["invalid"]
    for i, (r, one) in enumerate(zip(finals, ones)):
        j = ref_index[i]
        want = ({"valid?": False, **ref[j]} if j in ref
                else {"valid?": True})
        _require(r.get("seq") == SERVE_DELTAS
                 and {f: r.get(f) for f in want} == want,
                 f"serve: {keys[i]} differs from REF_BATCH[{j}]: {r}")
        _require({f: r.get(f) for f in STREAM_KEYS}
                 == json.loads(json.dumps({f: one.get(f)
                                           for f in STREAM_KEYS})),
                 f"serve: {keys[i]} differs from the one-shot check: "
                 f"{r} {one}")
    n_invalid = sum(1 for r in finals if r["valid?"] is False)
    print(f"serve: the entry point, {len(keys)} register keys of two "
          f"tenants in {SERVE_DELTAS} deltas over HTTP, SIGKILLed and "
          f"restarted after delta 2: == REF_BATCH's verdicts and failing "
          f"ops ({n_invalid} invalid) and the one-shot checks' "
          f"{STREAM_KEYS}; duplicate, 401 and stop answered; split (s) "
          f"{json.dumps(split)}")
    return split


def _serve_queue(dev) -> dict:
    """The service in process on the card through `run_stdio`: the first
    12 keys of sparse-batch-28 and the corrupted twins of keys 0 and 6
    in four deltas a key, every key evicted to the checkpoint store and
    thawed between deltas 2 and 3, then finalized. Each key equal to
    REF_SPARSE_BATCH's verdict and failing op and to a solo session fed
    the same deltas; the batched and single K2 and K4 launches of the
    service's worker, counted from just before the first line to just
    after the stop."""
    import io
    import tempfile
    from jepsen_tpu_torch.models import UnorderedQueue
    from jepsen_tpu_torch.parallel import extend
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    from jepsen_tpu_torch.serve import CheckerService
    from jepsen_tpu_torch.serve.stdio import run_stdio
    hs, ref_index = _stream_batch_keys()
    keys = [f"q-{j}" for j in ref_index]

    def delta(i: int, d: int) -> list:
        h = hs[i]
        return h[len(h) * d // SERVE_DELTAS:
                 len(h) * (d + 1) // SERVE_DELTAS]

    split = {}
    with tempfile.TemporaryDirectory() as tmp:
        svc = CheckerService(UnorderedQueue(), wal_dir=f"{tmp}/wal",
                             capacity=512, evict_idle_secs=SERVE_EVICT_SECS,
                             device=dev)
        evicted = {}

        def lines():
            t0 = time.perf_counter()
            for d in (0, 1):
                for i, k in enumerate(keys):
                    yield json.dumps({"key": k, "ops": delta(i, d),
                                      "seq": d + 1})
            yield json.dumps({"op": "drain", "timeout": 900})
            split["deltas_1_2_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            while svc.stats()["keys_live"] and \
                    time.perf_counter() - t0 < 120:
                time.sleep(0.05)
            evicted.update((k, row["state"]) for k, row in
                           svc.status()["keys"].items())
            split["evict_wait_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for d in (2, 3):
                for i, k in enumerate(keys):
                    yield json.dumps({"key": k, "ops": delta(i, d),
                                      "seq": d + 1})
            for k in keys:
                yield json.dumps({"op": "finalize", "key": k,
                                  "timeout": 900})
            split["deltas_3_4_s"] = time.perf_counter() - t0
            yield json.dumps({"op": "stop"})

        out = io.StringIO()
        torch.cuda.synchronize()
        sk.reset_launches()
        t0 = time.perf_counter()
        rc = run_stdio(svc, lines(), out)
        torch.cuda.synchronize()
        split["service_s"] = time.perf_counter() - t0
        n = _sparse_counts_all()
    answers = [json.loads(ln) for ln in out.getvalue().splitlines()]
    _require(rc == 0 and answers[-1] == {"stopped": True},
             f"serve queue: run_stdio {rc}, {answers[-1:]}")
    _require(set(evicted.values()) == {"evicted"},
             f"serve queue: not every key was evicted: {evicted}")
    acks = [a for a in answers if "accepted" in a]
    _require(len(acks) == SERVE_DELTAS * len(keys)
             and all(a["accepted"] for a in acks),
             "serve queue: not every delta was accepted")
    finals = answers[-1 - len(keys):-1]
    _require([r.get("key") for r in finals] == keys
             and all(r.get("seq") == SERVE_DELTAS for r in finals),
             f"serve queue: finalize answers {finals[:2]}")
    _require(n["frontier_closure_batch"] > 0
             and n["tiled_insert_batch"] + n["tiled_insert"] > 0,
             f"serve queue: the worker must launch batched K2 and K4: {n}")
    t0 = time.perf_counter()
    solo = [extend.HistorySession(UnorderedQueue(), capacity=512,
                                  device=dev) for _ in keys]
    for d in range(SERVE_DELTAS):
        for i, s in enumerate(solo):
            s.extend(delta(i, d))
    ones = [s.check() for s in solo]
    torch.cuda.synchronize()
    split["solo_s"] = time.perf_counter() - t0
    ref = REF_SPARSE_BATCH["uqueue-24+4"]["invalid"]
    for i, (r, o) in enumerate(zip(finals, ones)):
        j = ref_index[i]
        want = ({"valid?": False, **ref[j]} if j in ref
                else {"valid?": True})
        _require({f: r.get(f) for f in want} == want,
                 f"serve queue: {keys[i]} differs from "
                 f"REF_SPARSE_BATCH[{j}]: {r}")
        _require({f: r.get(f) for f in STREAM_KEYS}
                 == json.loads(json.dumps({f: o.get(f)
                                           for f in STREAM_KEYS})),
                 f"serve queue: {keys[i]} differs from its solo session: "
                 f"{r} {o}")
    print(f"serve: in process, {len(keys)} unordered-queue keys in "
          f"{SERVE_DELTAS} deltas through run_stdio, every key evicted and "
          f"thawed after delta 2: == REF_SPARSE_BATCH's verdicts and "
          f"failing ops and solo sessions; launches batched K2 "
          f"{n['frontier_closure_batch']} batched K4 "
          f"{n['tiled_insert_batch']}, single K2 {n['frontier_closure']} "
          f"K4 {n['tiled_insert']}; split (s) {json.dumps(split)}")
    return {"split": split, "launches": n}


def phase_serve(dev) -> dict:
    """The streaming checker service (`jepsen_tpu_torch.serve`) on the
    card: the entry point as a child process over HTTP with a kill and
    a WAL replay (cas-register), then the service in process over stdio
    with eviction and thaw (unordered queue)."""
    t0 = time.perf_counter()
    reg = _serve_register(dev)
    queue = _serve_queue(dev)
    print(f"serve: the phase {time.perf_counter() - t0:.1f} s; admission "
          f"{reg['admission_s']:.3f} s, the restart's replay "
          f"{reg['replay_s']:.3f} s, the worker (finalize) "
          f"{reg['worker_s']:.3f} s; the queue keys' service "
          f"{queue['split']['service_s']:.3f} s")
    return {"register": reg, "queue": queue}


# ------------------------------------------------------------ the fleet

# multikey-84's keys the serve phase no longer uses (42, 45, ..., 75) and
# the six corrupted keys of multikey-84+8
FLEET_VALID_KEYS = tuple(range(42, 76, 3))
FLEET_INTERVAL = 0.2       # the supervisor's heartbeat seconds
FLEET_THRESHOLD = 2        # consecutive misses before "dead"
FLEET_WAIT_SECS = 300      # the bound on the supervisor's detect + rehome
# the in-process half's keys: their positions in _stream_batch_keys() (keys
# 0, 4, 7 and 11 of sparse-batch-28, the corrupted twins of keys 0 and 6)
FLEET_QUEUE_KEYS = (0, 4, 7, 11, 12, 13)
# the keys migrated to the joining replica: both climb to capacity 16,384
# (K4's route) within deltas 1-2 and stay there through delta 3, so their
# delta 3 groups into one batched leg of K4 there
FLEET_MIGRATED = (4, 11)


def _fleet_processes(dev) -> dict:
    """Two replicas of the entry point on the card, A sync-shipping its WAL
    segments to B's repl/ mirror: 18 register keys routed by
    `HashRing(["A", "B"])` in four deltas; after delta 2, A is SIGKILLed
    and its WAL dir deleted; `FleetSupervisor` over both ops endpoints
    (the real HTTP fetch) declares A dead and re-homes its keys onto B
    from the mirror through B's `POST /adopt`. A's delta 2 re-sent to B
    answers duplicate; deltas 3-4 go to the supervisor's owner and each
    key is finalized there. Each key's verdict and failing op equal
    REF_BATCH's."""
    import os
    import shutil
    import signal
    import tempfile
    from jepsen_tpu_torch.serve.fleet import FleetSupervisor, HttpReplica
    from jepsen_tpu_torch.serve.ring import REPL_SUBDIR, HashRing
    multikey, extra = _batch_keys()
    hs = [[dict(o) for o in h]
          for h in [multikey[k] for k in FLEET_VALID_KEYS] + extra[2:]]
    ref_index = list(FLEET_VALID_KEYS) \
        + list(range(BATCH_KEYS + 2, BATCH_KEYS + 8))
    keys = [f"fleet-{j}" for j in ref_index]
    owner = HashRing(["A", "B"]).owner
    owned = {n: [i for i, k in enumerate(keys) if owner(k) == n]
             for n in ("A", "B")}
    _require(all(owned.values()), f"fleet: a replica owns no key: {owned}")

    def delta(i: int, d: int, **kw) -> dict:
        h = hs[i]
        return {"key": keys[i], "seq": d + 1, "timeout": 600,
                "ops": h[len(h) * d // SERVE_DELTAS:
                         len(h) * (d + 1) // SERVE_DELTAS], **kw}

    split = {}
    children = []
    sup = None
    with tempfile.TemporaryDirectory() as tmp:
        wals = {n: f"{tmp}/{n}/wal" for n in ("A", "B")}
        mirror = os.path.join(wals["B"], REPL_SUBDIR)
        try:
            t0 = time.perf_counter()
            started = {
                "B": _serve_start(wals["B"], ["--ops-port", "0"]),
                "A": _serve_start(wals["A"], ["--ops-port", "0",
                                              "--repl-dir", mirror],
                                  env={"JEPSEN_TPU_TORCH_SERVE_REPL":
                                       "sync"})}
            children += [c[0] for c in started.values()]
            ports = {n: _serve_ports(c, ("ingress", "ops"))
                     for n, c in started.items()}
            split["start_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            for n, idx in owned.items():
                acks = _serve_post_lines(ports[n]["ingress"], {None: [
                    delta(i, d) for i in idx for d in (0, 1)]})
                _require(len(acks) == 2 * len(idx)
                         and all(a.get("accepted") and "replicated" not in a
                                 for a in acks),
                         f"fleet: {n}'s deltas 1-2 not all accepted with "
                         f"their sync promise met: {acks[:3]}")
            split["admission_s"] = time.perf_counter() - t0
            proc_a = started["A"][0]
            proc_a.send_signal(signal.SIGKILL)
            proc_a.wait()
            t_kill = time.perf_counter()
            shutil.rmtree(wals["A"])
            addr = {n: f"127.0.0.1:{p['ops']}" for n, p in ports.items()}
            sup = FleetSupervisor(addr, wals,
                                  services={"B": HttpReplica(addr["B"])},
                                  interval=FLEET_INTERVAL,
                                  threshold=FLEET_THRESHOLD).start()
            t_dead = None
            while True:
                st = sup.status()["replicas"]["A"]
                if st["dead"] and t_dead is None:
                    t_dead = time.perf_counter()
                if st["rehomed"]:
                    break
                _require(time.perf_counter() - t_kill < FLEET_WAIT_SECS,
                         f"fleet: A not dead and rehomed "
                         f"{FLEET_WAIT_SECS} s after the kill: "
                         f"{sup.status()}")
                time.sleep(0.02)
            t_rehomed = time.perf_counter()
            split["kill_to_dead_s"] = t_dead - t_kill
            split["rehome_s"] = t_rehomed - t_dead
            pins = sup.status()["pins"]
            _require(pins == {keys[i]: "B" for i in owned["A"]},
                     f"fleet: the supervisor's pins {pins} are not A's "
                     f"keys on B")
            dup = _serve_post_lines(ports["B"]["ingress"], {None: [
                delta(i, 1) for i in owned["A"]]})
            _require(dup == [{"duplicate": True, "seq": 2, "key": keys[i]}
                             for i in owned["A"]],
                     f"fleet: A's re-sent delta 2 answered {dup[:3]}")
            t0 = time.perf_counter()
            routes = {k: sup.owner(k) for k in keys}
            _require(set(routes.values()) == {"B"},
                     f"fleet: the supervisor routes {routes}")
            acks = _serve_post_lines(ports["B"]["ingress"], {None: [
                delta(i, d) for i in range(len(keys)) for d in (2, 3)]})
            _require(len(acks) == 2 * len(keys)
                     and all(a.get("accepted") for a in acks),
                     f"fleet: deltas 3-4 not all accepted: {acks[:3]}")
            finals = dict(enumerate(_serve_post_lines(
                ports["B"]["ingress"], {None: [
                    {"op": "finalize", "key": k, "timeout": 600}
                    for k in keys]})))
            split["adoption_to_last_verdict_s"] = \
                time.perf_counter() - t_rehomed
            split["deltas_3_4_finalize_s"] = time.perf_counter() - t0
            split["keys_moved"] = len(pins)
            split["mirror_bytes"] = sum(
                os.path.getsize(os.path.join(mirror, f))
                for f in os.listdir(mirror))
            sup.stop()
            sup = None
            proc_b = started["B"][0]
            out, _ = proc_b.communicate('{"op": "stop"}\n', timeout=600)
            _require(proc_b.returncode == 0
                     and out.splitlines()[-1:] == ['{"stopped": true}'],
                     f"fleet: stop ended B with {proc_b.returncode}")
        finally:
            if sup is not None:
                sup.stop()
            for p in children:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    ref = REF_BATCH["multikey-84+8"]["invalid"]
    for i, r in finals.items():
        j = ref_index[i]
        want = ({"valid?": False, **ref[j]} if j in ref
                else {"valid?": True})
        _require(r.get("seq") == SERVE_DELTAS
                 and {f: r.get(f) for f in want} == want,
                 f"fleet: {keys[i]} differs from REF_BATCH[{j}]: {r}")
    n_invalid = sum(1 for r in finals.values() if r["valid?"] is False)
    print(f"fleet: two replicas of the entry point, {len(keys)} register "
          f"keys in {SERVE_DELTAS} deltas, A ({len(owned['A'])} keys) "
          f"SIGKILLed after delta 2 with its WAL dir deleted, re-homed by "
          f"the supervisor over HTTP from B's sync mirror: == REF_BATCH's "
          f"verdicts and failing ops ({n_invalid} invalid), A's delta 2 "
          f"answered duplicate on B; split (s) {json.dumps(split)}")
    return split


def _fleet_router(dev) -> dict:
    """`serve.ring.Router` in process over two `CheckerService(
    UnorderedQueue(), capacity=512)` on the card, six queue keys of
    `_stream_batch_keys()` in four deltas: after delta 2 the owner of the
    first key is closed without drain and `Router.rehome`d; a third replica
    joins with its worker stopped and takes the FLEET_MIGRATED keys through
    `Router.migrate_key`, their delta 3 is queued there, and its worker
    then starts on both at once: the adopted keys resume from their frozen
    frontiers at capacity 16,384, in one batched leg of K4. Each key
    equals REF_SPARSE_BATCH's verdict and failing op and a solo session
    fed the same deltas; the K2 and K4 launches (single and batched),
    counted from just before the first delta to just after the last
    finalize, each at least once, and batched K4 in the joining replica's
    first batch."""
    import tempfile
    from jepsen_tpu_torch.models import UnorderedQueue
    from jepsen_tpu_torch.parallel import extend
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    from jepsen_tpu_torch.serve import CheckerService
    from jepsen_tpu_torch.serve.ring import Router
    hs, index = _stream_batch_keys()
    hs = [hs[p] for p in FLEET_QUEUE_KEYS]
    ref_index = [index[p] for p in FLEET_QUEUE_KEYS]
    keys = [f"q-{j}" for j in ref_index]
    migrated = {f"q-{index[p]}" for p in FLEET_MIGRATED}

    def delta(i: int, d: int) -> list:
        h = hs[i]
        return h[len(h) * d // SERVE_DELTAS:
                 len(h) * (d + 1) // SERVE_DELTAS]

    def replica(wal, start_worker=True):
        return CheckerService(UnorderedQueue(), wal_dir=wal, capacity=512,
                              device=dev, start_worker=start_worker)

    def send(d: int, which) -> None:
        for i, k in enumerate(keys):
            if k in which:
                _require(router.submit(k, delta(i, d), seq=d + 1,
                                       timeout=900).get("accepted"),
                         f"fleet router: {k} delta {d + 1}")

    def wait(which) -> None:
        for k in which:
            _require("valid?" in router.result(k, timeout=900),
                     f"fleet router: {k} gave no verdict")

    split = {}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {n: f"{tmp}/{n}" for n in ("A", "B")}
        router = Router({n: replica(d) for n, d in dirs.items()}, dirs)
        try:
            torch.cuda.synchronize()
            sk.reset_launches()
            t0 = time.perf_counter()
            for d in (0, 1):
                send(d, keys)
            wait(keys)
            split["deltas_1_2_s"] = time.perf_counter() - t0
            dead = router.owner(keys[0])
            router.services[dead].close(drain=False)
            t0 = time.perf_counter()
            plan = router.rehome(dead)
            wait(keys)
            split["rehome_s"] = time.perf_counter() - t0
            moved = [k for k in keys if k in migrated]
            stay = [k for k in keys if k not in migrated]
            dirs["C"] = f"{tmp}/C"
            router.services["C"] = replica(dirs["C"], start_worker=False)
            router.wal_dirs["C"] = dirs["C"]
            t0 = time.perf_counter()
            for k in moved:
                mig = router.migrate_key(k, "C")
                _require(mig["to"] == "C" and mig["checkpoint"],
                         f"fleet router: migrate_key {mig}")
            split["migrate_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            send(2, keys)
            wait(stay)
            torch.cuda.synchronize()
            n4 = sk.launches["tiled_insert_batch"]
            router.services["C"].start_worker()
            wait(moved)
            torch.cuda.synchronize()
            c_k4 = sk.launches["tiled_insert_batch"] - n4
            send(3, keys)
            finals = [router.finalize(k, timeout=900) for k in keys]
            torch.cuda.synchronize()
            split["deltas_3_4_finalize_s"] = time.perf_counter() - t0
            n = _sparse_counts_all()
        finally:
            for svc in router.services.values():
                svc.close()
    _require(all(n[f] > 0 for f in ("frontier_closure",
                                    "frontier_closure_batch",
                                    "tiled_insert", "tiled_insert_batch")),
             f"fleet router: the replicas must launch K2 and K4, single "
             f"and batched: {n}")
    _require(c_k4 > 0, f"fleet router: the migrated keys' delta 3 on the "
             f"joining replica launched no batched K4 ({c_k4})")
    t0 = time.perf_counter()
    solo = [extend.HistorySession(UnorderedQueue(), capacity=512,
                                  device=dev) for _ in keys]
    for d in range(SERVE_DELTAS):
        for i, s_ in enumerate(solo):
            s_.extend(delta(i, d))
    ones = [s_.check() for s_ in solo]
    torch.cuda.synchronize()
    split["solo_s"] = time.perf_counter() - t0
    ref = REF_SPARSE_BATCH["uqueue-24+4"]["invalid"]
    for i, (r, o) in enumerate(zip(finals, ones)):
        j = ref_index[i]
        want = ({"valid?": False, **ref[j]} if j in ref
                else {"valid?": True})
        _require(r.get("seq") == SERVE_DELTAS
                 and {f: r.get(f) for f in want} == want,
                 f"fleet router: {keys[i]} differs from "
                 f"REF_SPARSE_BATCH[{j}]: {r}")
        _require({f: r.get(f) for f in STREAM_KEYS}
                 == json.loads(json.dumps({f: o.get(f)
                                           for f in STREAM_KEYS})),
                 f"fleet router: {keys[i]} differs from its solo session: "
                 f"{r} {o}")
    print(f"fleet: Router in process, {len(keys)} unordered-queue keys in "
          f"{SERVE_DELTAS} deltas, {dead} closed after delta 2 and its "
          f"{sum(len(v) for v in plan.values())} keys re-homed, {moved} "
          f"migrated to a joining replica: == REF_SPARSE_BATCH's verdicts "
          f"and failing ops and solo sessions; launches batched K2 "
          f"{n['frontier_closure_batch']} batched K4 "
          f"{n['tiled_insert_batch']} ({c_k4} in the joining replica's "
          f"first batch), single K2 {n['frontier_closure']} "
          f"K4 {n['tiled_insert']}; split (s) {json.dumps(split)}")
    return {"split": split, "launches": n, "joining_batched_k4": c_k4}


def phase_fleet(dev) -> dict:
    """The serve fleet on the card: two replicas of the entry point with a
    kill, a lost disk and the supervisor's rehome over HTTP (registers),
    then the ring's Router in process with a crash rehome and a graceful
    migration (unordered queue)."""
    t0 = time.perf_counter()
    procs = _fleet_processes(dev)
    router = _fleet_router(dev)
    print(f"fleet: the phase {time.perf_counter() - t0:.1f} s; kill to "
          f"dead {procs['kill_to_dead_s']:.3f} s, the rehome "
          f"{procs['rehome_s']:.3f} s, adoption to the last verdict "
          f"{procs['adoption_to_last_verdict_s']:.3f} s, keys moved "
          f"{procs['keys_moved']}, B's mirror {procs['mirror_bytes']} "
          f"bytes; the Router's keys "
          f"{router['split']['deltas_3_4_finalize_s']:.3f} s after the "
          f"rehome")
    return {"processes": procs, "router": router}


# ------------------------------------------------- the mesh paths

# The reference's results on a one-device CPU mesh, recorded by
# tests/torch_record_sharded_refs.py (one section each).
# resumable: check_encoded_sharded_resumable of the full-width pair's
# valid history (capacity FULL_CAPACITY, dedupe "hash", a checkpoint every
# MESH_RESUME_EVERY events): the result and every checkpoint's row
REF_SHARDED_RESUMABLE = {
    "result": {"valid?": True, "op": None, "fail-event": None,
               "max-frontier": 57344, "capacity": 131072, "devices": 1,
               "configs-stepped": 142667777},
    "checkpoints": [
        [256, 131072, True, -1, 57344, 0, 14675969, "83ab8cb96e7f4cda"],
        [512, 131072, True, -1, 57344, 0, 29356033, "8e32943378e3e8b7"],
        [768, 131072, True, -1, 57344, 0, 44036097, "8cad094c392fde95"],
        [1024, 131072, True, -1, 57344, 0, 58716161, "83ab8cb96e7f4cda"],
        [1280, 131072, True, -1, 57344, 0, 73396225, "83ab8cb96e7f4cda"],
        [1536, 131072, True, -1, 57344, 0, 88076289, "83ab8cb96e7f4cda"],
        [1792, 131072, True, -1, 57344, 0, 102756353, "8cad094c392fde95"],
        [2048, 131072, True, -1, 57344, 0, 117436417, "7827e454e3cf612a"],
        [2304, 131072, True, -1, 57344, 0, 132116481, "7827e454e3cf612a"],
        [2488, 131072, True, -1, 57344, 0, 142667777, "8cad094c392fde95"]]}
MESH_RESUME_EVERY = 256
# stats: check_encoded_sharded(search_stats=True) of
# adversarial_register_history(600, 12) from capacity 8,192: the result,
# and the digest of the block but for the probe histogram's fields
# (_stats_block_digest) with some of its fields to read
REF_SHARDED_STATS = {
    "result": {"valid?": True, "op": None, "fail-event": None,
               "max-frontier": 57344, "capacity": 131072, "devices": 1,
               "configs-stepped": 33714177},
    "digest": "ca10dd77d5f23c73", "events": 588, "frontier-peak": 57344,
    "capacity-tier": 4}
MESH_STATS_OPS, MESH_STATS_CAPACITY = 600, 8192
# elastic: check_encoded_sharded_elastic of the 400-op unordered queue of
# REF_CHECKPOINTS from capacity 64, a checkpoint every 32 events
REF_ELASTIC = {
    "result": {"valid?": True, "op": None, "fail-event": None,
               "max-frontier": 256, "capacity": 256, "devices": 1,
               "configs-stepped": 25467},
    "reshard": {"start-devices": 1, "events": []}}
# steal: check_batch(steal=True) of elastic.forced_skew_histories() (8
# heavy, 40 light keys) at capacity SKEW_CAPACITY, max 2^16, dedupe
# "hash": the digest of every key's STEAL_PIN fields (_steal_digest) and
# the scheduler's accounting
REF_STEAL = {
    "digest": "98e8182b374cd274",
    "buckets": [{"tier": 8, "engine": "sparse", "keys": 48, "rounds": 48,
                 "steals": 0, "observed_keys": 48,
                 "per_device_cost": [35299.0], "per_device_busy": [1.0],
                 "busy_frac": 1.0, "per_device_load_factor_peak": [None],
                 "load_factor_spread": None, "cohort_pred": [478.614]}]}
MESH_KEYS = ("valid?", "op", "fail-event", "max-frontier", "capacity",
             "devices", "configs-stepped")
# the stats block's fields the probe histogram makes: zeros where K3 ran
PHIST_FIELDS = ("probe-hist", "probes")


def _stats_block_digest(block: dict) -> str:
    """The digest of a sharded stats block without the probe histogram's
    fields, as tests/torch_record_sharded_refs.py computes it."""
    import hashlib
    rest = {k: v for k, v in block.items() if k not in PHIST_FIELDS}
    return hashlib.sha256(json.dumps(rest, sort_keys=True).encode()) \
        .hexdigest()[:16]


def _steal_digest(rs: list) -> str:
    import hashlib
    from jepsen_tpu_torch.parallel import elastic
    pins = [{k: r.get(k) for k in elastic.STEAL_PIN} for r in rs]
    return hashlib.sha256(json.dumps(pins, sort_keys=True, default=repr)
                          .encode()).hexdigest()[:16]


def _pin_mesh(r: dict) -> dict:
    return {k: r.get(k) for k in MESH_KEYS}


def phase_sharded_resumable(dev, mesh, full) -> dict:
    """The resumable sharded arm at full width, on the pair's encoded valid
    history: a checkpoint every MESH_RESUME_EVERY events, each equal to
    the reference's (REF_SHARDED_RESUMABLE), the result equal to the
    pair's one-shot check of this run; then a resume from the middle
    checkpoint, saved to .npz and loaded, to the same result. K3's grid
    runs."""
    import tempfile
    from jepsen_tpu_torch.parallel import engine, sharded
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    e, one = full["enc"], full["valid"]
    kw = {"capacity": FULL_CAPACITY, "max_capacity": 1 << 20,
          "checkpoint_every": MESH_RESUME_EVERY, "dedupe": "hash"}
    cps = []
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    r = sharded.check_encoded_sharded_resumable(e, mesh,
                                                checkpoint_cb=cps.append,
                                                **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grid = sk.hash_insert_launches["device"]
    keys = ("valid?", "max-frontier", "capacity", "configs-stepped")
    print(f"mesh: sharded resumable adv-{FULL_OPS}-k12: "
          f"{ {k: r.get(k) for k in keys} }, {len(cps)} checkpoints, wall "
          f"{wall:.3f} s (one-shot {full['wall']:.3f} s), K3 launches "
          f"{sk.launches['hash_insert']} (grid {grid})")
    _require({k: r.get(k) for k in keys} == {k: one.get(k) for k in keys},
             f"resumable {r} != the one-shot {one}")
    _require(r["closure"] == "cuda" and grid > 0,
             f"resumable: closure {r['closure']}, K3 grid launches {grid}")
    rows = [_cp_row(c) for c in cps]
    _require(rows == REF_SHARDED_RESUMABLE["checkpoints"],
             f"resumable checkpoints != the reference's: {rows}")
    _require(_pin_mesh(r) == REF_SHARDED_RESUMABLE["result"],
             f"resumable {r} != the reference's")
    mid = cps[len(cps) // 2]
    with tempfile.TemporaryDirectory() as d:
        path = mid.save(os.path.join(d, "mid"))
        cp = engine.FrontierCheckpoint.load(path)
    t0 = time.perf_counter()
    r2 = sharded.check_encoded_sharded_resumable(e, mesh, resume=cp, **kw)
    torch.cuda.synchronize()
    resumed = time.perf_counter() - t0
    print(f"mesh: sharded resumable: resumed from event {cp.event_index} "
          f"(.npz) in {resumed:.3f} s: "
          f"{ {k: r2.get(k) for k in keys} }")
    _require({k: r2.get(k) for k in keys} == {k: r.get(k) for k in keys},
             f"resume from the middle checkpoint: {r2} != {r}")
    return {"wall": wall, "resumed": resumed, "grid": grid,
            "launches": sk.launches["hash_insert"]}


def phase_sharded_stats(dev, mesh) -> dict:
    """check_encoded_sharded(search_stats=True) of a smaller history of
    the pair's shape: the block equals the reference's
    (REF_SHARDED_STATS) but for the probe histogram, which is all zeros
    where K3 ran ("closure": "cuda"), as the reference's fused kernel
    gives it."""
    from jepsen_tpu_torch import histories, models
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import sharded
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    e = enc.encode(models.CASRegister(None),
                   histories.adversarial_register_history(
                       n_ops=MESH_STATS_OPS, k_crashed=12))
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    r = sharded.check_encoded_sharded(e, mesh, capacity=MESH_STATS_CAPACITY,
                                      max_capacity=1 << 20, dedupe="hash",
                                      search_stats=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    block = r["stats"]
    print(f"mesh: sharded stats adv-{MESH_STATS_OPS}-k12: "
          f"{_pin_mesh(r)}, events {block['events']}, frontier-peak "
          f"{block['frontier-peak']}, capacity-tier {block['capacity-tier']}"
          f", probes {block['probes']}, wall {wall:.3f} s, K3 launches "
          f"{sk.launches['hash_insert']}")
    _require(_pin_mesh(r) == REF_SHARDED_STATS["result"],
             f"sharded stats: {r} != the reference's")
    _require(_stats_block_digest(block) == REF_SHARDED_STATS["digest"]
             and all(block[k] == REF_SHARDED_STATS[k] for k in (
                 "events", "frontier-peak", "capacity-tier")),
             "sharded stats: the block differs from the reference's")
    _require(r["closure"] == "cuda" and block["probes"] == 0
             and set(block["probe-hist"].values()) == {0},
             f"sharded stats: K3's histogram must be zeros: {block}")
    return {"wall": wall, "launches": sk.launches["hash_insert"]}


def phase_elastic(dev, mesh) -> dict:
    """check_encoded_sharded_elastic of the 400-op queue at one rank: one
    rung, then the table doubles; the verdict fields and the "reshard"
    block equal the reference's (REF_ELASTIC)."""
    from jepsen_tpu_torch import histories, models
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import sharded
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    e = enc.encode(models.UnorderedQueue(), histories.rand_queue_history(
        CP_OPS, n_processes=8, crash_p=0.005, seed=1))
    torch.cuda.synchronize()
    sk.reset_launches()
    t0 = time.perf_counter()
    r = sharded.check_encoded_sharded_elastic(e, mesh, capacity=CP_CAPACITY,
                                              checkpoint_every=CP_EVERY,
                                              dedupe="hash")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"mesh: elastic uqueue-{CP_OPS}: {_pin_mesh(r)}, reshard "
          f"{r['reshard']}, wall {wall:.3f} s, K3 launches "
          f"{sk.launches['hash_insert']}")
    _require({"result": _pin_mesh(r), "reshard": r["reshard"]}
             == REF_ELASTIC, f"elastic: {r} != the reference's")
    _require(r["closure"] == "cuda" and sk.launches["hash_insert"] > 0,
             f"elastic: {r['closure']}")
    return {"wall": wall, "launches": sk.launches["hash_insert"]}


def phase_mesh_batch(dev, mesh) -> dict:
    """check_batch(mesh=local_mesh()) on the 84 keys and on the 28-key
    sparse batch: every key equals REF_BATCH / REF_SPARSE_BATCH, through
    batched K1, batched K2 and batched K4 (each count zeroed just before
    the run and read just after)."""
    from jepsen_tpu_torch.models import CASRegister, UnorderedQueue
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import engine
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    out = {}
    for name, model, hs, ref, digest in (
            ("multikey-84", CASRegister(), _batch_keys()[0],
             REF_BATCH["multikey-84"], _batch_digest),
            ("uqueue-24+4", UnorderedQueue(), _sparse_batch_keys(),
             REF_SPARSE_BATCH["uqueue-24+4"], _sparse_batch_digest)):
        torch.cuda.synchronize()
        ck.reset_launches()
        sk.reset_launches()
        t0 = time.perf_counter()
        rs = engine.check_batch(model, hs, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {"K1_batch": ck.batch_launches,
             "K2_batch": sk.launches["frontier_closure_batch"],
             "K4_batch": sk.launches["tiled_insert_batch"]}
        print(f"mesh: batch {name} at one rank: {len(rs)} keys, wall "
              f"{wall:.3f} s, launches {n}")
        _require(digest(rs) == ref, f"mesh batch {name} != the reference's")
        out[name] = {"wall": wall, **n}
    _require(out["multikey-84"]["K1_batch"] > 0, "mesh batch: no batched K1")
    _require(out["uqueue-24+4"]["K2_batch"] > 0
             and out["uqueue-24+4"]["K4_batch"] > 0,
             "mesh batch: batched K2 and K4 must both run")
    return out


def phase_steal(dev, mesh) -> dict:
    """check_batch(steal=True, mesh=local_mesh()) on the forced-skew keys:
    every key equals the static check_batch of the same keys and the
    reference's (REF_STEAL's digest), and the scheduler's accounting the
    reference's at one device. Both walls print: a finding, not a
    claim."""
    from jepsen_tpu_torch.parallel import elastic, engine
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    model, hs = elastic.forced_skew_histories()
    kw = {"capacity": elastic.SKEW_CAPACITY, "max_capacity": 1 << 16,
          "dedupe": "hash", "mesh": mesh}
    walls = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    static = engine.check_batch(model, hs, **kw)
    torch.cuda.synchronize()
    walls["static"] = time.perf_counter() - t0
    st = {}
    sk.reset_launches()
    t0 = time.perf_counter()
    rs = engine.check_batch(model, hs, steal=True, steal_stats=st, **kw)
    torch.cuda.synchronize()
    walls["steal"] = time.perf_counter() - t0
    n = {"K2_batch": sk.launches["frontier_closure_batch"],
         "K4_batch": sk.launches["tiled_insert_batch"]}
    print(f"mesh: steal forced-skew 8+40 at one rank: walls (s) static "
          f"{walls['static']:.3f}, steal {walls['steal']:.3f}; scheduler "
          f"{st['buckets']}; launches {n}")
    _require(_steal_digest(rs) == _steal_digest(static) == REF_STEAL["digest"],
             "steal: results differ from the static batch's or the "
             "reference's")
    keys = REF_STEAL["buckets"][0].keys()
    _require([{k: b.get(k) for k in keys} for b in st["buckets"]]
             == REF_STEAL["buckets"], f"steal: scheduler {st['buckets']}")
    return {"walls": walls, **n}


# elle: the SCC closure of the transactional cycle checkers on the card
# (jepsen_tpu_torch/elle/__init__.py: scc_labels; the reference's
# device_sccs, jepsen_tpu/elle/__init__.py:146-209) — a plain bf16
# product outside any Pallas kernel, so torch.mm (cuBLAS), not a kernel of
# the kernels line
ELLE_GRAPHS = ((1024, 700), (4096, 2000), (16384, 3000))  # (n, planted SCC)
ELLE_TIMED = (1024, 4096, 10000, 16384)
ELLE_REPS = 3
# H100 SXM dense bf16 tensor-core rate (NVIDIA's data sheet, 700 W)
BF16_FLOPS_PER_S = 989e12
# the reference's results on the smoke's histories
# (tests/torch_record_elle_refs.py, JAX on the CPU)
REF_ELLE = {
    "append-defaults": {
        "valid?": True,
        "anomaly-types": [],
        "anomalies": "44136fa355b3678a1146ad16f7e8649e"
                     "94fb4fc21fe77e8310c060f61caaff8a"},
    "append-defaults twin": {
        "valid?": False,
        "anomaly-types": ["G-single", "G1a", "G1b",
                          "G2", "incompatible-order"],
        "anomalies": "31cb13119081ff2941c10b871d3242b8"
                     "0d28d59806500abab0af59422efb7e23"},
    "append-k10-m4": {
        "valid?": True,
        "anomaly-types": [],
        "anomalies": "44136fa355b3678a1146ad16f7e8649e"
                     "94fb4fc21fe77e8310c060f61caaff8a"},
    "append-k10-m4 twin": {
        "valid?": False,
        "anomaly-types": ["G-single", "G1a", "G1b",
                          "G2", "incompatible-order"],
        "anomalies": "accd3967b7e9a0e306a6354435e18075"
                     "6efddc5a32adcaa860cf3018069f74a5"},
    "wr-defaults": {
        "valid?": True,
        "anomaly-types": [],
        "anomalies": "44136fa355b3678a1146ad16f7e8649e"
                     "94fb4fc21fe77e8310c060f61caaff8a"},
    "wr-defaults twin": {
        "valid?": False,
        "anomaly-types": ["G-single", "G1a", "G1b", "G2"],
        "anomalies": "00683622ddf5027eccdfa35b064b9257"
                     "5bc2e847f9ca4c7f37a65d2e3ab4ab79"},
}


def _elle_cases():
    """tests/torch_elle_cases.py, the simulated histories and random
    graphs the CPU and cuda-marked tests use too, loaded by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_elle_cases", ROOT / "tests" / "torch_elle_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _ElleSplit:
    """Times a check's parts while it runs: ``elle.sccs`` (the device
    closure, its host index build and its label read-back) and
    ``elle.cycle_anomalies`` around it (the rest of which is the cycle
    search); the rest of the check is history-to-graph."""

    def __init__(self, elle):
        self.elle = elle
        self.secs = {"sccs": 0.0, "anomalies": 0.0}

    def _timed(self, key, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.secs[key] += time.perf_counter() - t0
        return run

    def __enter__(self):
        self.saved = (self.elle.sccs, self.elle.cycle_anomalies)
        self.elle.sccs = self._timed("sccs", self.saved[0])
        self.elle.cycle_anomalies = self._timed("anomalies", self.saved[1])
        return self

    def __exit__(self, *exc):
        self.elle.sccs, self.elle.cycle_anomalies = self.saved


def phase_elle(dev) -> dict:
    """elle on the card at full width: device_sccs on seeded random graphs
    held to the port's Tarjan in the device route's order; the closure
    timed at four sizes beside its bound; and the list-append and
    rw-register checkers on the 10,000-transaction histories, each valid
    and its invalid twin, held to the reference's recorded results, each
    going down the device route once."""
    from jepsen_tpu_torch import elle
    from jepsen_tpu_torch.workloads import cycle
    ec = _elle_cases()
    for n, planted in ELLE_GRAPHS:
        g = ec.random_graph(n, SEED + n, planted=planted)
        elle.launches["closure"] = 0
        t0 = time.perf_counter()
        got = elle.device_sccs(g, dev)
        secs = time.perf_counter() - t0
        _require(elle.launches["closure"] == 1,
                 f"elle n={n}: the device route did not run")
        want = ec.reference_order(elle.tarjan_sccs(g))
        _require(got == want, f"elle n={n}: the card's SCCs differ from "
                              f"Tarjan's in the device route's order")
        print(f"elle: random graph n={n} edges="
              f"{sum(len(b) for b in g.out.values())} sccs={len(got)} "
              f"largest={max(map(len, got))}: equal to Tarjan's, "
              f"{secs:.3f} s")
    timed = []
    for n in ELLE_TIMED:
        _ids, src, dst = elle.edge_index(
            ec.random_graph(n, SEED + 7 * n, planted=n // 4))
        src, dst = (torch.tensor(x, dtype=torch.int64, device=dev)
                    for x in (src, dst))
        elle.scc_labels(src, dst, n, dev)       # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = []
        for _ in range(ELLE_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            elle.scc_labels(src, dst, n, dev)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        steps = elle.closure_steps(n)
        flops_ms = 2.0 * n ** 3 * steps / BF16_FLOPS_PER_S * 1e3
        bytes_ms = (16 * src.numel() + 8 * n) / HBM_BYTES_PER_S * 1e3
        timed.append({
            "n": n, "steps": steps, "ms": sorted(ms)[len(ms) // 2],
            "bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "peak_bytes": torch.cuda.max_memory_allocated() - base})
    print(f"elle closure (median of {ELLE_REPS}, CUDA events): "
          f"{json.dumps(timed)}")
    split = {}
    for name, (kind, _t, _s, opts, _f) in ec.SMOKE_HISTORIES.items():
        make = cycle.AppendChecker if kind == "append" else cycle.WrChecker
        for twin in (False, True):
            key = f"{name}{' twin' if twin else ''}"
            h = ec.smoke_history(name, twin)
            elle.launches["closure"] = 0
            with _ElleSplit(elle) as sp:
                t0 = time.perf_counter()
                r = make(opts, device=dev).check({}, h)
                total = time.perf_counter() - t0
            _require(elle.launches["closure"] == 1,
                     f"elle {key}: the device route did not run")
            got = ec.result_digest(r)
            _require(got == REF_ELLE[key],
                     f"elle {key}: {got} != the reference's "
                     f"{REF_ELLE[key]}")
            split[key] = {
                "total": round(total, 4),
                "graph": round(total - sp.secs["anomalies"], 4),
                "closure": round(sp.secs["sccs"], 4),
                "cycle_search": round(sp.secs["anomalies"]
                                      - sp.secs["sccs"], 4),
                "anomaly-types": r["anomaly-types"]}
    print(f"elle split (s): {json.dumps(split)}")
    return {"timed": timed, "split": split}


def phase_probe(dev) -> dict:
    """The device probe on the card: probe_json healthy on cuda with the
    card's device count, the breaker's default probe True, and a
    ProbeWatch of interval 1 s ok after its first tick with its gauges
    at 1 and about 0."""
    from jepsen_tpu_torch import obs, probe
    from jepsen_tpu_torch.resilience import breaker
    doc = probe.probe_json(timeout=60, retries=1, out=sys.stdout)
    _require(doc["verdict"] == "healthy" and doc["exit"] == 0
             and doc["platforms"] == ["cuda"]
             and doc["n_devices"] == torch.cuda.device_count(),
             f"probe: {doc}")
    t0 = time.perf_counter()
    healthy = breaker.CircuitBreaker("chip-smoke").probe()
    t_breaker = time.perf_counter() - t0
    _require(healthy is True, "probe: the breaker's default probe failed")
    w = probe.ProbeWatch(1.0, timeout=60).start()
    t0 = time.perf_counter()
    while w.ticks == 0 and time.perf_counter() - t0 < 90:
        time.sleep(0.02)
    # stop inside the watch's 1 s wait, before a second probe child starts
    w.stop()
    st = w.status()
    gauges = (obs.gauge("probe.chip_healthy").value,
              obs.gauge("probe.last_ok_age_secs").value)
    _require(not w._thread.is_alive(), "probe: the watch did not stop")
    _require(st["ok"] and st["verdict"] == "healthy" and st["ticks"] == 1,
             f"probe: watch {st}")
    _require(gauges[0] == 1 and gauges[1] < 1.0, f"probe: gauges {gauges}")
    print(f"probe: json {doc['elapsed_secs']} s, breaker probe "
          f"{t_breaker:.3f} s, watch first tick "
          f"{time.perf_counter() - t0:.3f} s, status {json.dumps(st)}, "
          f"gauges {gauges}")
    return {"doc": doc, "watch": st}


# ------------------------------------------------------------ telemetry

# the profiled inputs: a capture's processing and write at exit grow
# with the events it holds (25.3 s for ~965,000: a 300-op dense check, the
# pipelined pair and a 120-op sharded check, ~150 torch ops a K3 launch),
# so one capture holds three small checks, the sharded one at the grid's
# capacity from its start; tracing alone runs at the main path's sizes
TEL_DENSE_OPS = 300
TEL_SPARSE_KEYS = (12, 20, 24)   # capacities 512, 4,096, 1,024 (K2, K4)
TEL_DENSE_KEYS = 8
TEL_SHARDED_OPS, TEL_SHARDED_CAPACITY = 40, 1 << 17


def _tel_launches() -> dict:
    """Launch counts of the port's kernels by the label the telemetry
    phase checks them under."""
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    return {"K1": ck.launches, "K1 batched": ck.batch_launches,
            "K2": sk.launches["frontier_closure"]
            + sk.launches["frontier_closure_batch"],
            "K3": sk.launches["hash_insert"],
            "K4": sk.launches["tiled_insert"]
            + sk.launches["tiled_insert_batch"]}


def _tel_zero() -> None:
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    ck.reset_launches()
    sk.reset_launches()


def _tel_timed(fn):
    """fn() -> (result, wall s), the card drained on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def _tel_tree(tr) -> set:
    by_id = {s.sid: s for s in tr.spans()}
    return {(s.name, by_id[s.parent].name if s.parent in by_id else None)
            for s in tr.spans()}


def phase_telemetry(dev, mesh) -> dict:
    """The telemetry core on the card (the module's docstring, item 15)."""
    import shutil
    import tempfile
    from jepsen_tpu_torch import histories, models, obs
    from jepsen_tpu_torch.obs import capture
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import engine, sharded
    for flag in ("JEPSEN_TPU_TORCH_TRACE", "JEPSEN_TPU_TORCH_PROFILE"):
        os.environ.pop(flag, None)
    obs.reset()
    reg, uq = models.CASRegister(), models.UnorderedQueue()
    h_main = histories.adversarial_register_history(n_ops=10000,
                                                    k_crashed=12)
    h_small = histories.adversarial_register_history(n_ops=TEL_DENSE_OPS,
                                                     k_crashed=12)
    queues = _sparse_batch_keys()
    q_keys = [queues[k] for k in TEL_SPARSE_KEYS]
    multikey = _batch_keys()[0]
    e_sh = enc.encode(reg, histories.adversarial_register_history(
        n_ops=TEL_SHARDED_OPS, k_crashed=12))

    def pipelined(r_keys):
        return [engine.check_batch(uq, q_keys, device=dev, pipeline=True,
                                   cache=False),
                engine.check_batch(reg, r_keys, device=dev, pipeline=True,
                                   cache=False)]

    def shard():
        return sharded.check_encoded_sharded(
            e_sh, mesh, capacity=TEL_SHARDED_CAPACITY, dedupe="hash")

    # name: (the check at the main path's size, the profiled one, the
    # span tree's (name, parent) pairs, {kernel: its annotation's prefix})
    paths = {
        "dense": (lambda: engine.analysis(reg, h_main, device=dev),
                  lambda: engine.analysis(reg, h_small, device=dev),
                  {("engine.encode", None), ("bitdense.check", None)},
                  {"K1": "bitdense single S"}),
        "pipeline": (lambda: pipelined(multikey),
                     lambda: pipelined(multikey[:TEL_DENSE_KEYS]), {
            ("pipeline.run", None), ("pipeline.prepare", "pipeline.run"),
            ("pipeline.encode", "pipeline.run"),
            ("pipeline.sparse", "pipeline.run"),
            ("engine.sparse_batch", "pipeline.sparse"),
            ("pipeline.dispatch", "pipeline.run"),
            ("pipeline.finalize", "pipeline.run"),
            ("bitdense.pad_place", "pipeline.dispatch"),
            ("bitdense.finalize", "pipeline.finalize"),
            ("device.search", None)},
            {"K1 batched": "bitdense K", "K2": "sparse K",
             "K4": "sparse K"}),
        # the sharded check at its main path's size takes ~20 s a run
        "sharded": (shard, shard, {("sharded.search", None),
                                   ("sharded.tier", "sharded.search")},
                    {"K3": "sharded N"}),
    }

    def launched(what: str, want) -> dict:
        n = _tel_launches()
        for k in want:
            _require(n[k] > 0, f"telemetry {what}: {k} never launched ({n})")
        return n

    out, main_off = {}, {}
    tmp = tempfile.mkdtemp(prefix="jt-telemetry-")
    try:
        # tracing off against on, at the main path's sizes (warm: the
        # main path ran these checks before)
        for name, (main, _small, tree, want_k) in paths.items():
            walls, results = {}, {}
            for mode in ("off", "traced"):
                tr = obs.configure(True) if mode == "traced" else None
                _tel_zero()
                try:
                    results[mode], walls[mode] = _tel_timed(main)
                finally:
                    obs.reset()
                launched(f"{name} {mode}", want_k)
            _require(results["traced"] == results["off"],
                     f"telemetry {name}: tracing changed a result")
            got = _tel_tree(tr)
            _require(tree <= got, f"telemetry {name}: span tree lacks "
                                  f"{sorted(tree - got)}")
            path = os.path.join(tmp, f"{name}.trace.json")
            obs.write_chrome_trace(path, tr)
            events = json.load(open(path))
            tracks = sorted(e["args"]["name"] for e in events
                            if e["ph"] == "M" and e["name"] == "thread_name"
                            and e["pid"] == 2)
            if name == "pipeline":
                _require(tracks and all(t.startswith("bucket-")
                                        for t in tracks),
                         f"telemetry: device tracks {tracks}")
            main_off[name] = results["off"]
            out[name] = {"walls": walls, "spans": len(tr.spans()),
                         "trace_bytes": os.path.getsize(path),
                         "tracks": tracks}
            print(f"telemetry: {name}: warm walls (s) off "
                  f"{walls['off']:.4f}, traced {walls['traced']:.4f}; "
                  f"{len(tr.spans())} spans, trace "
                  f"{os.path.getsize(path)} bytes, device tracks {tracks}")
        # the profiled inputs off (warm, and the results to hold), then all
        # three traced inside one capture: the checks' own sites
        # (engine.check_batch, pipeline.run) join it
        want_off = {}
        for name, (main, small, _tree, _k) in paths.items():
            if small is main:       # its off run above
                want_off[name] = main_off[name]
                out[name]["small_off"] = out[name]["walls"]["off"]
            else:
                want_off[name], out[name]["small_off"] = _tel_timed(small)
        prof = os.path.join(tmp, "capture")
        os.environ["JEPSEN_TPU_TORCH_PROFILE"] = prof
        obs.configure(True)
        _tel_zero()
        got, in_cap = {}, {}
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with obs.maybe_torch_profile():
                for name, (_main, small, _tree, _k) in paths.items():
                    got[name], in_cap[name] = _tel_timed(small)
            cap_wall = time.perf_counter() - t0
        finally:
            os.environ.pop("JEPSEN_TPU_TORCH_PROFILE", None)
            obs.reset()
        want_k = {k: v for _m, _s, _t, ks in paths.values()
                  for k, v in ks.items()}
        launches = launched("profiled", want_k)
        for name in paths:
            _require(got[name] == want_off[name],
                     f"telemetry {name}: the profiler changed a result")
            out[name]["profiled"] = in_cap[name]
        t0 = time.perf_counter()
        docs = capture.load_captures(prof)
        _require(len(docs) == 1, f"telemetry: {len(docs)} captures, not 1")
        cap_bytes = sum(os.path.getsize(os.path.join(prof, f))
                        for f in os.listdir(prof))
        n_events = len(docs[0]["traceEvents"])
        recs = capture.kernel_annotations(docs[0])
        by_k: dict = {}
        for rec in recs:
            k = rec["kernel"]
            if k == "K1" and (rec["annotation"] or "").startswith(
                    "bitdense K"):
                k = "K1 batched"
            by_k.setdefault(k, []).append(rec)
        for k, prefix in want_k.items():
            got_k = by_k.get(k, [])
            bad = [r for r in got_k if r["annotation"] is None
                   or not r["annotation"].startswith(prefix)]
            _require(got_k and not bad,
                     f"telemetry: {len(bad)} of {len(got_k)} {k} kernels "
                     f"not under '{prefix}…': {bad[:3]}")
            # K1 and K2 are one kernel a launch; K3 and K4 a prep, a
            # compact and the insert
            _require(len(got_k) == launches[k] if k in ("K1", "K1 batched",
                                                       "K2")
                     else len(got_k) >= launches[k],
                     f"telemetry: {len(got_k)} {k} kernels in the capture "
                     f"for {launches[k]} launches")
        _require(set(by_k) <= set(want_k),
                 f"telemetry: unexpected kernels {sorted(by_k)}")
        t_read = time.perf_counter() - t0
        corr = {k: len(v) for k, v in by_k.items()}
        notes = sorted({r["annotation"] for r in recs})
        out["capture"] = {"wall": cap_wall, "kernels": corr,
                          "launches": launches, "bytes": cap_bytes,
                          "events": n_events, "read_s": t_read}
        for name in paths:
            print(f"telemetry: {name}: profiled input warm walls (s) off "
                  f"{out[name]['small_off']:.4f}, traced+profiled "
                  f"{in_cap[name]:.4f}")
        print(f"telemetry: the one capture: {cap_wall:.4f} s, the checks "
              f"{sum(in_cap.values()):.4f} s of it, the capture's start, "
              f"processing and write {cap_wall - sum(in_cap.values()):.4f}"
              f" s; {n_events} events, {cap_bytes} bytes, read and "
              f"matched in {t_read:.2f} s; capture kernels by annotation "
              f"{corr} (launches {launches}) under {notes[:8]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.pop("JEPSEN_TPU_TORCH_PROFILE", None)
        obs.reset()
    # the disabled span's CPU cost a call, on this host
    n = 200_000
    c0 = time.process_time()
    for _ in range(n):
        with obs.span("hot"):
            pass
    per_call = (time.process_time() - c0) / n
    _require(per_call < 2e-6, f"telemetry: disabled span {per_call} s")
    out["disabled_span_s"] = per_call
    print(f"telemetry: the disabled span: {per_call * 1e9:.1f} ns of CPU "
          f"a call (singleton {obs.span('a') is obs.span('b')})")
    return out


def _phase(name: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke runs "
              "only on a GPU", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import histories
    dev = torch.device("cuda")
    card = _card()
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    _phase("build", phase_build)
    worst = _phase("K1 parity", phase_parity, dev)
    launches = _phase("K1 main path", phase_main_path, dev)
    _phase("K1 oracle", phase_oracle, dev)
    timed = [
        _phase("K1 timing S18", phase_timing, dev, MAIN_SHAPE,
               histories.adversarial_register_history(n_ops=10000,
                                                      k_crashed=12), 50),
        _phase("K1 timing S22", phase_timing, dev, WIDE_SHAPE,
               histories.adversarial_register_history(n_ops=1000,
                                                      k_crashed=16), 5)]
    batch = _phase("batch main path", phase_batch_main, dev)
    _phase("batched scan parity", phase_batch_parity, dev, batch["encs"])
    btimed = _phase("batched scan timing", phase_batch_timing, dev,
                    batch["encs"][:BATCH_KEYS])
    cases = _sparse_cases()
    rec = _phase("sparse record", _record_sparse, cases, dev)
    sworst = _phase("K2/K4 parity", phase_sparse_parity, dev, rec)
    slaunches = _phase("sparse main path", phase_sparse_main, dev, cases)
    stimed = _phase("K2/K4 timing", phase_sparse_timing, dev, rec)
    del rec
    sbatch = _phase("sparse batch main path", phase_sparse_batch_main, dev)
    srec = _phase("sparse batch record", _record_sparse_batch, dev)
    sbworst = _phase("batched K2/K4 parity", phase_sparse_batch_parity, dev,
                     srec)
    sbtimed = _phase("batched K2/K4 timing", phase_sparse_batch_timing, dev,
                     srec)
    del srec
    from jepsen_tpu_torch.parallel import meshplan
    mesh = meshplan.local_mesh()
    small = _phase("sharded small", phase_sharded_small, dev, mesh)
    full = _phase("sharded full width", phase_sharded_full, dev, mesh)
    k3_inputs = {**small["recorded"], **full["recorded"]}
    k3_worst = _phase("K3 parity", phase_k3_parity, dev, mesh, k3_inputs)
    k3_timed = _phase("K3 timing", phase_k3_timing, dev, k3_inputs)
    del k3_inputs
    packed = _phase("packed main path", phase_packed_main, dev, cases, mesh,
                    slaunches["walls"], sbatch)
    p_worst = _phase("packed parity", phase_packed_parity, dev,
                     packed["recorded"])
    p_timed = _phase("packed timing", phase_packed_timing, dev,
                     packed["recorded"], packed["launches"])
    del packed["recorded"]
    # K1: one entry per timed shape, with the launches of the main-path
    # check at that shape (the invalid twin's, at S=19, print above);
    # K2 and K4: the launches of the whole sparse main path
    kernels = [{
        "name": f"closure_fixpoint[S{t['S']},C{t['C']}]", "route": "cuda",
        "source": "jepsen_tpu_torch/kernels/closure.cu",
        "replaces": "jepsen_tpu/parallel/pallas_kernels.py:65",
        "launches": launches[(t["S"], t["C"])],
        "max_abs_err": worst[(t["S"], t["C"])],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "layout": t["layout"]} for t in timed]
    # the batched scan: timed and held against its plain version on the
    # 84-key batch's chunk, with the launches of the 84-key check (one per
    # chunk of event rows)
    kernels.append({
        "name": btimed["name"], "route": "cuda",
        "source": "jepsen_tpu_torch/kernels/closure.cu",
        "replaces": "jepsen_tpu/parallel/bitdense.py:368",
        "launches": batch["multikey-84"]["launches"],
        "max_abs_err": btimed["max_abs_err"], "ms": btimed["ms"],
        "plain_ms": btimed["plain_ms"], "bound_ms": btimed["bound_ms"],
        "bound_by": btimed["bound_by"], "library_ms": None,
        "layout": btimed["layout"]})
    for t, key, src, line in (
            (stimed[0], "K2", "frontier_closure.cu", 205),
            (stimed[1], "K4", "tiled_insert.cu", 345)):
        kernels.append({
            "name": t["name"], "route": "cuda",
            "source": f"jepsen_tpu_torch/kernels/{src}",
            "replaces": f"jepsen_tpu/parallel/sparse_kernels.py:{line}",
            "launches": slaunches[key], "max_abs_err": sworst[key],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            **({"cut_ms": t["cut_ms"]} if key == "K2" else {})})
    # K2 and K4 batched over keys: timed and held against their plain
    # versions on the sparse batch's own calls, with the launches of the
    # main batch's run
    for t, key, src, line in (
            (sbtimed[0], "K2", "frontier_closure.cu", 205),
            (sbtimed[1], "K4", "tiled_insert.cu", 345)):
        kernels.append({
            "name": t["name"], "route": "cuda",
            "source": f"jepsen_tpu_torch/kernels/{src}",
            "replaces": f"jepsen_tpu/parallel/sparse_kernels.py:{line}",
            "launches": sbatch["main"]["launches"][
                "frontier_closure_batch" if key == "K2"
                else "tiled_insert_batch"],
            "max_abs_err": sbworst[key], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    # K3: one entry per table layout (insert "shared": one block; "grid":
    # the cooperative grid over the table in device memory), timed at
    # the shape it names; its launches in that layout over the small
    # checks and the full-width check
    for t in k3_timed:
        layout = t["layout"]
        n = small[layout] + full["by_layout"][layout]
        _require(n > 0, f"K3's {layout} layout never launched")
        kernels.append({
            "name": f"hash_insert[{t['insert']},T{t['T']},M{t['M']}]",
            "route": "cuda",
            "source": "jepsen_tpu_torch/kernels/hash_insert.cu",
            "replaces": "jepsen_tpu/parallel/sparse_kernels.py:282",
            "launches": n, "max_abs_err": k3_worst,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "layout": t["insert"]})
    # the packed kernels: one entry per kernel, lane count and shape, its
    # launches those of the packed main path (config_pack=True)
    for t in p_timed:
        key = t["name"].split("[")[0]
        kernel = {"frontier_closure": "K2", "frontier_closure_batch":
                  "K2 batch", "hash_insert": "K3", "tiled_insert": "K4",
                  "tiled_insert_batch": "K4 batch"}[key]
        kernels.append({**t, "max_abs_err": p_worst[(kernel, t["lanes"])]})
    print(f"packed walls (warm, s): {json.dumps(packed['walls'])}")
    stats = _phase("stats main path", phase_stats_main, dev, cases)
    st_worst = _phase("K2 stats parity", phase_stats_parity, dev,
                      stats["kept"])
    st_timed = _phase("K2 stats timing", phase_stats_timing, dev,
                      stats["kept"], stats["launches"])
    del stats["kept"]
    _phase("race and host checkers", phase_race, dev)
    t_new = time.perf_counter()
    _phase("resumable", phase_resumable, dev, slaunches["results"])
    _phase("stream", phase_stream, dev)
    _phase("stream batch", phase_stream_batch, dev)
    _phase("pipeline", phase_pipeline, dev)
    print(f"the four resumable/streaming/pipeline phases: "
          f"{time.perf_counter() - t_new:.1f} s")
    _phase("serve", phase_serve, dev)
    _phase("fleet", phase_fleet, dev)
    # the mesh paths at one NCCL rank (the card's mesh), each count zeroed
    # just before its run and read just after
    t_mesh = time.perf_counter()
    _phase("sharded resumable", phase_sharded_resumable, dev, mesh, full)
    del full["enc"]
    _phase("sharded stats", phase_sharded_stats, dev, mesh)
    _phase("elastic", phase_elastic, dev, mesh)
    _phase("mesh batch", phase_mesh_batch, dev, mesh)
    _phase("steal", phase_steal, dev, mesh)
    print(f"the five mesh phases: {time.perf_counter() - t_mesh:.1f} s")
    _phase("elle", phase_elle, dev)
    _phase("probe", phase_probe, dev)
    _phase("telemetry", phase_telemetry, dev, mesh)
    # K2's stats instantiation, single and batched: timed on inputs kept
    # from the stats main path, with the launches of that path
    for t in st_timed:
        kernels.append({**{k: v for k, v in t.items() if k != "key"},
                        "max_abs_err": st_worst[
                            "K2" if t["key"] == "K2 stats" else "K2 batch"]})
    torch.distributed.destroy_process_group()
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
