"""Smoke run of jepsen_tpu_torch on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port — never the JAX package — through the entry point a user
calls, `checker.linearizable.Linearizable(CASRegister(None), "torch")`,
on the card:

  1. build: compiles every CUDA kernel of the path from the repository's
     sources (into build/torch_kernels/) and prints the build seconds;
  2. parity: K1 (the closure fixpoint, kernels/closure.cu) against its
     plain PyTorch version on the same random inputs, bit for bit, at the
     main path's shape (S=18, C=13: B in shared memory) and at a wide
     shape (S=22, C=17: B in device memory);
  3. main path: the 10k-op adversarial cas-register history (valid), its
     twin with an impossible read (invalid; its counterexample re-scans
     the device to a window before the failure) and a 1k-op history with
     16 crashed writes (the wide shape). Launch counts are zeroed just
     before each check and read just after; each result must equal the
     same check with the plain closure on the same card, field for field
     apart from `closure`, and the verdicts must be the ones the
     histories were built to have. Small seeded histories are also held
     against the host WGL search;
  4. timing: K1 and its plain version per launch, with CUDA events, on
     closure inputs recorded from the main path's own scan, beside the
     least time the card could take for the same work.

Prints the timings, a {"kernels": [...]} line and the card's name and
power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase raises, so the exit code is not 0 and that line is not
printed. Without a CUDA device it exits with code 1 before doing anything.
"""

from __future__ import annotations

import json
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
            if "registers" in line or "spill" in line:
                print(f"build: {line.strip()}")
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
    """The three checks; returns K1's launches per (S, C) shape."""
    from jepsen_tpu_torch import histories
    cases = [
        ("adv-10k-k12 valid",
         histories.adversarial_register_history(n_ops=10000, k_crashed=12),
         True),
        ("adv-10k-k12 impossible read",
         histories.with_impossible_read(
             histories.adversarial_register_history(n_ops=10000,
                                                    k_crashed=12)),
         False),
        ("adv-1k-k16 valid",
         histories.adversarial_register_history(n_ops=1000, k_crashed=16),
         True),
    ]
    by_shape: dict = {}
    for name, h, want in cases:
        r, secs, n = _check(h, dev, plain=False)
        shape = (r["states"], r["slots"])
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
        p, psecs, pn = _check(h, dev, plain=True)
        print(f"main: {name}: plain closure wall {psecs:.3f} s, "
              f"K1 launches {pn}")
        _require(pn == 0, f"{name}: plain path launched K1")
        a = {k: v for k, v in r.items() if k != "closure"}
        b = {k: v for k, v in p.items() if k != "closure"}
        _require(a == b, f"{name}: K1 and plain results differ: "
                         f"{sorted(k for k in a if a.get(k) != b.get(k))}")
        _require(p["closure"] == "torch", f"{name}: plain closure "
                                          f"reported {p['closure']}")
    # the invalid twin's read of 999 adds a state: it runs at S=19
    _require({MAIN_SHAPE, WIDE_SHAPE} <= set(by_shape),
             f"main path ran at shapes {sorted(by_shape)}")
    return by_shape


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke runs "
              "only on a GPU", file=sys.stderr)
        return 1
    from jepsen_tpu_torch import histories
    dev = torch.device("cuda")
    card = _card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    phase_build()
    worst = phase_parity(dev)
    launches = phase_main_path(dev)
    phase_oracle(dev)
    timed = [
        phase_timing(dev, MAIN_SHAPE, histories.adversarial_register_history(
            n_ops=10000, k_crashed=12), stride=50),
        phase_timing(dev, WIDE_SHAPE, histories.adversarial_register_history(
            n_ops=1000, k_crashed=16), stride=5)]
    # one entry per timed shape, with the launches of the main-path
    # check at that shape (the invalid twin's, at S=19, print above)
    print(json.dumps({"kernels": [{
        "name": f"closure_fixpoint[S{t['S']},C{t['C']}]", "route": "cuda",
        "source": "jepsen_tpu_torch/kernels/closure.cu",
        "replaces": "jepsen_tpu/parallel/pallas_kernels.py:65",
        "launches": launches[(t["S"], t["C"])], "max_abs_err": worst[(t["S"], t["C"])],
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "layout": t["layout"]} for t in timed]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
