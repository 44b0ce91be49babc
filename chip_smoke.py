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
       path's shape (S=18, C=13: B in shared memory) and a wide shape
       (S=22, C=17: B in device memory);
     * main path: the 10k-op adversarial cas-register history (valid),
       its twin with an impossible read (invalid; the counterexample
       re-scans the device to a window before the failure) and a 1k-op
       history with 16 crashed writes. Shorter twins of the three
       (2k ops, 600 ops with 6 crashed writes, the same 1k) are held
       against the check with the plain closure, field for field apart
       from `closure`. Small seeded histories are held against the host
       WGL search;
     * timing, per launch with CUDA events, on closure inputs recorded
       from the main path's own scans;
  3. K2 and K4 (the sparse engine's hash closure, kernels/
     frontier_closure.cu, and its tiled visited-set insert, kernels/
     tiled_insert.cu):
     * parity against their plain versions, bit for bit: K2 on closure
       inputs recorded from the main path's scans (a golden FIFO history,
       a 400-op unordered queue, the 1000-op FIFO's K2 tiers) and once
       with probe_limit=2, where the probes overflow; K4 on a random
       insert over 4 tiles x 3 chunks and on inserts recorded from the
       1000-op FIFO;
     * main path: the six golden queue and set histories, 400-op
       unordered-queue and set histories (the K2 route), a 1000-op FIFO
       history (the K4 route, at capacity 32,768) and its invalid twin,
       whose counterexample re-scans the sparse sort path. Each result
       equals the reference's, recorded on the CPU (below), and the
       same check with dedupe="sort" on the card; a small one equals the
       check with the plain closure;
     * timing of K2 and K4 per launch, beside their plain versions, the
       sort closure, and their bound.
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
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261017
MAIN_SHAPE = (18, 13)   # (S, C) of adversarial_register_history(10000, 12)
WIDE_SHAPE = (22, 17)   # (S, C) of adversarial_register_history(1000, 16)
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
    """K1 against the plain closure; returns per (S, C) the largest
    |difference| over every word compared (0: bit-identical)."""
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    rng = np.random.default_rng(SEED)
    worst = {}
    for S, C in (MAIN_SHAPE, WIDE_SHAPE):
        layout = ck.kernel_layout(S, C)
        worst[(S, C)] = 0
        for kind in ("sparse", "register"):
            for _ in range(3):
                sel, B = _rand_case(rng, S, C, kind, dev)
                want = ck.closure_fixpoint_reference(sel, B, C)
                got = ck.closure_fixpoint(sel, B, C)
                inplace = B.clone()
                ck.closure_fixpoint(sel, inplace, C, out=inplace,
                                    run=torch.ones((), dtype=torch.bool,
                                                   device=dev))
                skipped = B.clone()
                ck.closure_fixpoint(sel, skipped, C, out=skipped,
                                    run=torch.zeros((), dtype=torch.bool,
                                                    device=dev))
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                worst[(S, C)] = max(worst[(S, C)], err)
                _require(torch.equal(got, want),
                         f"K1 differs from the plain closure at S={S} "
                         f"C={C} ({kind}, {layout} layout)")
                _require(torch.equal(inplace, want),
                         f"in-place K1 differs at S={S} C={C}")
                _require(torch.equal(skipped, B),
                         f"K1 with run=False changed B at S={S} C={C}")
        print(f"parity: K1 == plain closure at S={S} C={C} "
              f"({layout} layout), 6 random cases, in place and skipped")
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
    plain_ms = _time_launches(ck.closure_fixpoint_reference,
                              pairs[:PLAIN_TIMED_PAIRS], reps=1)
    # the least time: each input read once and B' written once; and the
    # operations these very inputs need: one pass over sel, then per
    # expansion (as many as the plain closure ran) one OR per selected
    # (j, s, t) and target word — all W words for j < 5, the W/2 words
    # with mask bit j set for j >= 5
    nbytes = (C * S * S + 2 * S * W) * 4
    words = torch.tensor([W if j < 5 else W // 2 for j in range(C)],
                         dtype=torch.float64)
    ops, exps = [], []
    for sel, B, _ in pairs:
        n_exp = ck.closure_reference_expansions(sel, B, C)[1]
        per_exp = float(((sel != 0).sum((1, 2)).double().cpu()
                         * words).sum())
        ops.append(C * S * S + n_exp * per_exp)
        exps.append(n_exp)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = float(np.mean(ops)) / INT32_OPS_PER_S * 1e3
    out = {"S": S, "C": C, "W": W, "layout": ck.kernel_layout(S, C),
           "pairs": len(pairs), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "mean_expansions": float(np.mean(exps)),
           "mean_ops": float(np.mean(ops)),
           "bytes_ms": t_bytes, "ops_ms": t_ops}
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

    def k4(c_rows, c_live, table, pl, plan):
        # the expansion inserts (M = N*C candidates; the seed insert of
        # each event has M = N = T/2), sampled across the events
        if table[1].shape[0] == 65536 and c_live.shape[0] != 32768:
            seen[1] += 1
            if seen[1] % 97 == 0 and len(rec["k4"]) < K4_TIMED:
                rec["k4"].append((tuple(r.clone() for r in c_rows),
                                  c_live.clone(),
                                  (tuple(r.clone() for r in table[0]),
                                   table[1].clone()), pl, dict(plan)))
        return real_k4(c_rows, c_live, table, pl, plan)

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


def phase_sparse_parity(dev, rec) -> dict:
    """K2 and K4 against their plain versions on the card, bit for bit.
    Returns the largest |difference| of each (0: bit-identical)."""
    from jepsen_tpu_torch.parallel import sparse, sparse_kernels as sk
    lib2, lib4 = sk._lib("frontier_closure"), sk._lib("tiled_insert")
    for N, C in ((1024, 8), (2048, 12), (2048, 33)):
        _require(lib2.jt_frontier_closure_smem(N, C)
                 == sk.k2_smem_bytes(N, C), f"K2 layout at N={N} C={C}")
    _require(lib4.jt_tiled_insert_smem(8192, 8192)
             == sk.k4_smem_bytes(8192, 8192), "K4 layout")
    print(f"parity: shared-memory opt-in {sk.smem_budget(dev)} bytes; K2 "
          f"needs {sk.k2_smem_bytes(1024, 8)} at N=1024 C=8 and "
          f"{sk.k2_smem_bytes(2048, 33)} at N=2048 C=33; K4's plan "
          f"{sk.tiled_plan(32768, 12)} needs "
          f"{sk.k4_smem_bytes(8192, 8192)}")
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

    def k4_pair(c_rows, c_live, table, pl, plan):
        got = sk.tiled_insert(c_rows, c_live, table, pl, plan)
        want = sk.tiled_insert_reference(c_rows, c_live, table, pl, plan)
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
        err, ovf, n = k4_pair(c_rows, c_live, table, pl,
                              {"tile": 512, "chunk": 512})
        _require(err == 0, f"K4 differs on the random insert, "
                           f"probe_limit={pl}")
        print(f"parity: K4 == plain insert, 4 tiles x 3 chunks, "
              f"probe_limit={pl}: {n} fresh, probe overflow {ovf}")
    for args in rec["k4"]:
        err, ovf, n = k4_pair(*args)
        _require(err == 0, "K4 differs on a recorded 1000-op FIFO insert")
    plan = rec["k4"][0][4]
    print(f"parity: K4 == plain insert on {len(rec['k4'])} recorded "
          f"1000-op FIFO inserts (T=65536, plan {plan}: "
          f"{65536 // plan['tile']} tiles, M={rec['k4'][0][1].shape[0]})")
    return worst


def phase_sparse_main(dev, cases) -> dict:
    """The sparse checks; returns the K2 and K4 launches of the run."""
    from jepsen_tpu_torch.parallel import encode as enc
    from jepsen_tpu_torch.parallel import sparse
    total = {"K2": 0, "K4": 0}
    for name, model, h in cases:
        r, secs, n = _sparse_check(model, h, dev)
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
    FIFO's inserts, per launch with CUDA events, beside the plain
    versions, the sort closure of the same events and the bound."""
    from jepsen_tpu_torch.parallel import sparse, sparse_kernels as sk
    out = []
    k2 = [a + (32,) for a in rec["uqueue-400"]]
    step_name, ev, rows, live, _ = rec["uqueue-400"][0]
    N, C = live.shape[0], ev["slot_f"].shape[0]
    ms = _time_launches(sk.frontier_closure, k2, reps=3)
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
         "inputs": len(k2), "ms": ms, "plain_ms": plain_ms,
         "sort_closure_ms": sort_ms, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "mean_iters": float(np.mean([m[2] for m in metas])),
         "mean_rows_out": float(np.mean([m[0] for m in metas]))}
    print("timing: " + json.dumps(t))
    out.append(t)

    k4 = rec["k4"]
    c_rows, c_live, table, pl, plan = k4[0]
    M, T = c_live.shape[0], table[1].shape[0]
    ms = _time_launches(sk.tiled_insert, k4, reps=3)
    plain_ms = _time_host(sk.tiled_insert_reference, k4[:2])
    # bytes these inserts need: every live flag, the live candidates'
    # rows and the table read once; the table, fresh and off written
    # once. operations: the live test of every candidate, and for the
    # live ones the hash, the home tile and start, a probe and a claim
    # (~24)
    live = float(np.mean([int(a[1].sum()) for a in k4]))
    nbytes = M + 12 * live + 13 * T + 13 * T + 5 * M
    ops = M + live * 24
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t = {"name": f"tiled_insert[T{T},M{M}]", "T": T, "M": M,
         "plan": plan, "inputs": len(k4), "mean_live": live, "ms": ms,
         "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print("timing: " + json.dumps(t))
    out.append(t)
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
    cases = _sparse_cases()
    rec = _phase("sparse record", _record_sparse, cases, dev)
    sworst = _phase("K2/K4 parity", phase_sparse_parity, dev, rec)
    slaunches = _phase("sparse main path", phase_sparse_main, dev, cases)
    stimed = _phase("K2/K4 timing", phase_sparse_timing, dev, rec)
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
            "library_ms": None})
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
