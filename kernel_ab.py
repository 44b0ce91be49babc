"""Side-by-side timing of the kernels of jepsen_tpu_torch (K1 to K4) on
one NVIDIA GPU, for comparing two trees of the port (say a commit and
its parent) on the same inputs in one run.

    python3 kernel_ab.py [--tree DIR] record [--out FILE] [--kernels k1,k2,k3,k4]
    python3 kernel_ab.py [--tree DIR] time [--inputs FILE]
    python3 kernel_ab.py [--tree DIR] walls

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
          chip_smoke.py records them;
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
          gets, in a tree whose wrapper splits it, its bin and insert
          launches timed apart. K4 updates the table in place in trees
          that do, so every timed launch gets its own copy of the
          recorded table, made before the clock starts. Each kernel
          is also rebuilt without its one-warp path for small work
          (K2's passes of at most 32 candidates, K4's tiles of at most
          32), where the tree has one, and timed whole (`variant_ms`;
          the timing alone, results unchecked; chip_smoke.py, which
          shares these timers, times only the cuts it prints). Prints
          one JSON line;
  walls   the dense 10k-op check through the checker: cold, then the
          median of three warm runs; one JSON line.

The sharded 10k-op check's walls and busy share come from
`python3 -m jepsen_tpu_torch.profile_check --sharded`, run in each tree.
Every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

DEFAULT_INPUTS = "build/kernel_ab_inputs.pt"
K1_PAIRS = 200
K3_KEEP = 3


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

    def recording(c_rows, c_live, table, pl, plan):
        if table[1].shape[0] == T_want and c_live.shape[0] != T_want // 2:
            seen[0] += 1
            if seen[0] % stride == 0 and len(kept) < keep:
                kept.append((tuple(r.clone() for r in c_rows),
                             c_live.clone(),
                             (tuple(r.clone() for r in table[0]),
                              table[1].clone()), pl, dict(plan)))
        return real(c_rows, c_live, table, pl, plan)

    sk.tiled_insert = recording
    try:
        Linearizable(FIFOQueue(), "torch",
                     device=torch.device("cuda")).check({}, h)
    finally:
        sk.tiled_insert = real
    if not kept:
        raise SystemExit(f"kernel_ab: no K4 expansion insert at T={T_want}")
    return kept


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
K4_WARP_AB = {"no_warp_insert": (r"if \(n_t <= 32\) \{", "if (false) {")}
_C_FUNCS = ("launch", "init", "smem", "scratch")


def _variant_libs(sk, kernel: str, variants: dict) -> dict:
    """The tree's own source of `kernel` rebuilt as each variant it
    holds (one nvcc each, all at once), loaded and set up on the current
    device like the wrapper's own library."""
    import ctypes
    import re
    from jepsen_tpu_torch import kernels
    src = (kernels.KERNEL_DIR / kernels.SOURCES[kernel]).read_text()
    out_dir = kernels.BUILD_DIR / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, (pat, new) in variants.items():
        if len(re.findall(pat, src)) != 1:
            continue
        var = re.sub(pat, new, src)
        if var == src:
            continue
        cu = out_dir / f"{kernel}_{n}.cu"
        cu.write_text(var)
        so = out_dir / f"lib{kernel}_{n}.so"
        procs[n] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I",
             str(kernels.KERNEL_DIR), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    full = sk._lib(kernel)
    libs = {}
    for n, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"kernel_ab: nvcc failed on {kernel}'s {n}:\n"
                             f"{log}")
        lib = ctypes.CDLL(str(so))
        for f in _C_FUNCS:
            try:
                ref = getattr(full, f"jt_{kernel}_{f}")
            except AttributeError:
                continue
            getattr(lib, f"jt_{kernel}_{f}").argtypes = ref.argtypes
            getattr(lib, f"jt_{kernel}_{f}").restype = ref.restype
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


def _time_k4(torch, sk, inputs: list, warp_ab: bool = False) -> dict:
    """K4 per launch on fresh copies of the recorded tables; in a tree
    whose wrapper has `_tiled_insert_launch` (bin and insert as two
    launches), each launch alone too; with `warp_ab`, whole without the
    one-warp path too (`variant_ms`)."""
    reps = 3
    res = {"ms": _time_once_each(torch, sk.tiled_insert,
                                 _fresh_tables(torch, inputs, 1),
                                 _fresh_tables(torch, inputs, reps)),
           "inputs": len(inputs), "M": inputs[0][1].shape[0],
           "T": inputs[0][2][1].shape[0], "plan": inputs[0][4],
           "live": [int(a[1].sum()) for a in inputs]}
    launch = getattr(sk, "_tiled_insert_launch", None)
    if launch is not None:
        def bin_(c_rows, c_live, table, pl, plan):
            launch(c_rows, c_live, table, pl, plan, stages=1)

        works = [launch(*a, stages=1)[-1] for a in inputs]

        def insert(c_rows, c_live, table, pl, plan, work):
            launch(c_rows, c_live, table, pl, plan, stages=2, work=work)

        res["bin_ms"] = _time_launches(torch, bin_, inputs, reps=reps)
        res["variant_ms"] = {}
        full = sk._libs["tiled_insert"]
        try:
            for n, lib in _variant_libs(
                    sk, "tiled_insert",
                    K4_WARP_AB if warp_ab else {}).items():
                sk._libs["tiled_insert"] = lib
                res["variant_ms"][n] = _time_once_each(
                    torch, sk.tiled_insert, _fresh_tables(torch, inputs, 1),
                    _fresh_tables(torch, inputs, reps))
        finally:
            sk._libs["tiled_insert"] = full
        res["insert_ms"] = _time_once_each(
            torch, insert,
            [a + (w,) for a, w in zip(_fresh_tables(torch, inputs, 1),
                                      works)],
            [a + (works[i % len(inputs)],) for i, a in
             enumerate(_fresh_tables(torch, inputs, reps))])
    return res


def cmd_time(args, torch) -> dict:
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import sparse_kernels as sk
    rec = torch.load(args.inputs)
    dev = torch.device("cuda")
    off = torch.zeros((), dtype=torch.bool, device=dev)
    out: dict = {}
    for shape, pairs in rec["k1"].items():
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
        out[f"K4 {shape}"] = _time_k4(torch, sk, inputs, warp_ab=True)
    for shape, inputs in rec["k3"].items():
        T = inputs[0][4][1].shape[0]
        out[f"K3 {shape}"] = {
            "ms": _time_launches(torch, sk.hash_insert, inputs,
                                 reps=10 if T <= 8192 else 3),
            "layout": sk.k3_layout(T // 2, torch.device("cuda")),
            "inputs": len(inputs),
            "live": [int(a[1].sum()) for a in inputs]}
    return out


def cmd_walls(args, torch) -> dict:
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
    r.add_argument("--kernels", default="k1,k2,k3,k4")
    t = sub.add_parser("time")
    t.add_argument("--inputs", default=DEFAULT_INPUTS)
    sub.add_parser("walls")
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
