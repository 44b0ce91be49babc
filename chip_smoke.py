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
  3. K2 and K4 (the sparse engine's hash closure, kernels/
     frontier_closure.cu, and its tiled visited-set insert, kernels/
     tiled_insert.cu):
     * parity against their plain versions, bit for bit: K2 on closure
       inputs recorded from the main path's scans (a golden FIFO history,
       a 400-op unordered queue, the 1000-op FIFO's K2 tiers), once
       with probe_limit=2, where the probes overflow, and on the seeded
       cases of `tests/torch_parity_cases.py` (C = 33 and 64, N = 2,048,
       passes of at most 32, more than 32 and more than 1,024
       candidates, a frontier overflow past N, probe_limit 2); K4 on a
       random insert over 4 tiles x 3 chunks, on inserts recorded from
       the 1000-op FIFO and on the seeded cases (a tile with no live
       candidate, all in one tile, equal rows across a chunk boundary,
       probe_limit 1 and 2, M not a multiple of the chunk, a few live
       candidates over many chunks), and its bin and insert launched
       apart. K4 updates the table in place, so it gets a copy;
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
       K4's bin and insert also apart, each launch on its own copy of
       the recorded table.
  4. K3 (the sharded engine's visited-set transaction, kernels/
     hash_insert.cu), on a one-rank NCCL mesh (`meshplan.local_mesh()`):
     * main path, small shapes: 60-op register histories and their
       corrupted twins, a wide frontier that climbs capacity tiers, and
       two golden queue histories through `check_encoded_sharded`, each
       equal field for field to the reference's results recorded on the
       CPU at one device (below);
     * main path, full width: the bench's sharded shape,
       `adversarial_register_history(10000, 12)` through
       `sharded.analysis` at capacity 2^17 (K3's table in device
       memory, its insert a cooperative grid), cold and warm, and its
       impossible-read twin through `check_encoded_sharded`, each with
       the dense engine's verdict, op and fail-event on the card;
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
           "plan": ck.device_plan(S, C, dev), "layout_ms": layout_ms,
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
    lib2, lib4 = sk._lib("frontier_closure"), sk._lib("tiled_insert")
    for N, C in ((1024, 8), (2048, 12), (2048, 33)):
        _require(lib2.jt_frontier_closure_smem(N, C)
                 == sk.k2_smem_bytes(N, C), f"K2 layout at N={N} C={C}")
    # K4's shared memory has no term in M: the default top tier (N = 2^20,
    # T = 2^21, 256 tiles of 8,192) fits at every C
    for TS, bits, CH in ((8192, 3, 8192), (512, 3, 512), (512, 0, 128),
                         (8192, 8, 8192), (2048, 0, 16384)):
        _require(lib4.jt_tiled_insert_smem(TS, bits, CH)
                 == sk.k4_smem_bytes(TS, CH, 1 << bits),
                 f"K4 layout at TS={TS} tiles=2^{bits} CH={CH}")
        _require(sk.k4_smem_bytes(TS, CH, 1 << bits) <= sk.smem_budget(dev),
                 f"K4 at TS={TS} tiles=2^{bits} CH={CH} past the opt-in")
    print(f"parity: shared-memory opt-in {sk.smem_budget(dev)} bytes; K2 "
          f"needs {sk.k2_smem_bytes(1024, 8)} at N=1024 C=8 and "
          f"{sk.k2_smem_bytes(2048, 33)} at N=2048 C=33; K4's plan "
          f"{sk.tiled_plan(32768, 12)} needs "
          f"{sk.k4_smem_bytes(8192, 8192, 8)} on 8 tiles and "
          f"{sk.k4_smem_bytes(8192, 8192, 256)} on 256, at any M")
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
        want = sk.tiled_insert_reference(c_rows, c_live, table, pl, plan)
        copy = (tuple(r.clone() for r in table[0]), table[1].clone())
        got = sk.tiled_insert(c_rows, c_live, copy, pl, plan)
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
    # the seeded cases, on the card, and K4's two launches apart
    parity_cases = _parity_cases()
    for name, c_rows, c_live, table, pl, plan in parity_cases.k4_cases():
        args = (tuple(r.to(dev) for r in c_rows), c_live.to(dev),
                (tuple(r.to(dev) for r in table[0]), table[1].to(dev)),
                pl, plan)
        err, ovf, n = k4_pair(*args)
        _require(err == 0, f"K4 differs from the plain insert: {name}")
        want = sk.tiled_insert_reference(*args)
        work = sk._tiled_insert_launch(*args, stages=1)[-1]
        got = sk._tiled_insert_launch(*args, stages=2, work=work)
        torch.cuda.synchronize()
        err = max(_max_err(got[0][0], want[0][0]),
                  _max_err([got[0][1], got[1], got[2], got[3]],
                           [want[0][1], want[1], want[2], want[3]]))
        worst["K4"] = max(worst["K4"], err)
        _require(err == 0, f"K4's bin and insert apart differ: {name}")
        print(f"parity: K4 == plain insert ({name}): {n} fresh, probe "
              f"overflow {ovf}; bin and insert apart agree")
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
    FIFO's inserts, per launch with CUDA events (kernel_ab.py's timers:
    K2 also cut short, K4's bin and insert also apart, each K4 launch on
    its own copy of the table), beside the plain versions, the sort
    closure of the same events and the bound."""
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
    c_rows, c_live, table, pl, plan = k4[0]
    M, T = c_live.shape[0], table[1].shape[0]
    t4 = kernel_ab._time_k4(torch, sk, k4)
    plain_ms = _time_host(sk.tiled_insert_reference, k4[:2])
    # bytes these inserts need: every live flag read and every fresh and
    # off written once; the live candidates' rows read, each table slot
    # they probe read (12 bytes of row, 1 of occupancy) and each one they
    # claim written: the table is updated in place. operations: the live
    # test of every candidate, and for the live ones the hash, the home
    # tile and start, and a compare per probe (~24)
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
         "plan": plan, "inputs": len(k4), "mean_live": live,
         "mean_probes": probes, "mean_fresh": fresh, "ms": t4["ms"],
         "bin_ms": t4.get("bin_ms"), "insert_ms": t4.get("insert_ms"),
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
FULL_OPS = 10000        # the bench's sharded shape (bench.py:617-694)
FULL_CAPACITY = 1 << 17
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
    `sharded.analysis` cold (recording K3 inputs) and warm (counted),
    its impossible-read twin through check_encoded_sharded; each against
    the dense engine on the card."""
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
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        sk.reset_launches()
        t0 = time.perf_counter()
        if label == "cold":
            # a prime stride: a check makes about four inserts per event
            # (the seed and the expansions), and every kind is recorded
            with _K3Recorder(stride=997) as rec:
                r = sharded.analysis(model, h, mesh, **kw)
        else:
            r = sharded.analysis(model, h, mesh, **kw)
        torch.cuda.synchronize()
        out[label] = time.perf_counter() - t0
        out[f"{label}_launches"] = sk.launches["hash_insert"]
        out[f"{label}_by_layout"] = dict(sk.hash_insert_launches)
        print(f"sharded: adv-{FULL_OPS}-k12 ({label}): valid?="
              f"{r['valid?']} capacity={r['capacity']} max-frontier="
              f"{r['max-frontier']} configs-stepped={r['configs-stepped']} "
              f"wall {out[label]:.3f} s, K3 launches "
              f"{out[f'{label}_launches']}")
    out["recorded"] = rec.kept
    out["valid"] = r
    dense = bitdense.check_encoded_bitdense(enc.encode(model, h), device=dev)
    keys = ("valid?", "op", "fail-event")
    _require(r["closure"] == "cuda" and r["valid?"] is True,
             f"full width: {r}")
    _require({k: r.get(k) for k in keys} == {k: dense.get(k) for k in keys},
             f"full width: sharded {r} != dense {dense}")
    e_bad = enc.encode(model, histories.with_impossible_read(h))
    rb, secs, n = _sharded_check(e_bad, mesh, **kw)
    dense_b = bitdense.check_encoded_bitdense(e_bad, device=dev)
    print(f"sharded: adv-{FULL_OPS}-k12 impossible read: valid?="
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
        _require(lib.jt_hash_insert_smem(T, 0) == sk.k3_smem_bytes(T // 2),
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
    from jepsen_tpu_torch.parallel import meshplan
    mesh = meshplan.local_mesh()
    small = _phase("sharded small", phase_sharded_small, dev, mesh)
    full = _phase("sharded full width", phase_sharded_full, dev, mesh)
    k3_inputs = {**small["recorded"], **full["recorded"]}
    k3_worst = _phase("K3 parity", phase_k3_parity, dev, mesh, k3_inputs)
    k3_timed = _phase("K3 timing", phase_k3_timing, dev, k3_inputs)
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
            "library_ms": None,
            **({"cut_ms": t["cut_ms"]} if key == "K2" else
               {"bin_ms": t["bin_ms"], "insert_ms": t["insert_ms"]})})
    # K3: one entry per table layout (insert "shared": one block; "grid":
    # the cooperative grid over the table in device memory), timed at
    # the shape it names; its launches in that layout over the small
    # checks and the warm full-width check
    for t in k3_timed:
        layout = t["layout"]
        n = small[layout] + full["warm_by_layout"][layout]
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
