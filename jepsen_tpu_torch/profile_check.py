"""Where the time of one check goes, on the card.

    python3 -m jepsen_tpu_torch.profile_check [--family register]
        [--ops 10000] [--crashed 12] [--sharded]

Checks one history with the port once to warm up, times the host encode
alone, the whole check three times without the profiler (median:
`wall_s`) and once under `torch.profiler`, tracing the device only
(`profiled_wall_s`), and prints one JSON line with those, the device
time summed by kernel name (top 10), the number of device kernels the
profiled check ran, the launches of the port's own kernels, and the
device's busy share of the unprofiled wall. The profiler slows the host
(its overhead is `profiled_wall_s - wall_s`) but not the kernels, so the
busy share is taken against the wall a user sees. The device events are
read raw from the trace, not through the profiler's Python event tree:
for a full-length sharded check (millions of kernels) that tree outgrew
96 GiB of host memory. Needs a CUDA device.

Families: "register" is `adversarial_register_history(ops, crashed)`
(the dense engine); "uqueue", "gset" and "fifo" are the sparse engine's
`rand_queue_history(ops, n_processes=8)`,
`rand_gset_history(ops, n_processes=10, n_elements=16)` and
`rand_fifo_history(ops, n_processes=8)`, each with crash_p=0.005 and
seed=1.

`--sharded` checks the history with the frontier-sharded engine instead
(`sharded.analysis` on the one-rank mesh `meshplan.local_mesh()`, hash
dedupe, from global capacity 2^17, the bench's starting tier) and adds
the device time of kernel K3 and of the collectives (NCCL) to the line,
each as a share of the busy time.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

# the sharded check's starting global capacity: the bench's (bench.py:648)
SHARDED_CAPACITY = 1 << 17


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="register",
                    choices=("register", "uqueue", "gset", "fifo"))
    ap.add_argument("--ops", type=int, default=10000)
    ap.add_argument("--crashed", type=int, default=12)
    ap.add_argument("--sharded", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_check: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from jepsen_tpu_torch import histories, models
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.parallel import closure_kernels as ck
    from jepsen_tpu_torch.parallel import encode
    from jepsen_tpu_torch.parallel import sparse_kernels as sk

    kw = {"crash_p": 0.005, "seed": 1}
    model, h = {
        "register": lambda: (models.CASRegister(None),
                             histories.adversarial_register_history(
                                 n_ops=args.ops, k_crashed=args.crashed)),
        "uqueue": lambda: (models.UnorderedQueue(),
                           histories.rand_queue_history(
                               args.ops, n_processes=8, **kw)),
        "gset": lambda: (models.GSet(), histories.rand_gset_history(
            args.ops, n_processes=10, n_elements=16, **kw)),
        "fifo": lambda: (models.FIFOQueue(), histories.rand_fifo_history(
            args.ops, n_processes=8, **kw)),
    }[args.family]()
    if args.sharded:
        from jepsen_tpu_torch.parallel import meshplan, sharded
        mesh = meshplan.local_mesh()

        def check():
            return sharded.analysis(model, h, mesh,
                                    capacity=SHARDED_CAPACITY,
                                    max_capacity=1 << 20, dedupe="hash")
    else:
        checker = Linearizable(model, "torch")

        def check():
            return checker.check({}, h)
    check()                                               # warm-up
    t0 = time.perf_counter()
    e = encode.encode(model, h)
    encode_s = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    torch.cuda.synchronize()
    ck.reset_launches()
    sk.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = check()
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    launches = {"K1": ck.launches, **sk.launches}
    by_kernel: dict = {}
    n_kernels = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_kernel[ev.name()] = by_kernel.get(ev.name(), 0.0) \
                + ev.duration_ns() / 1e9
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    extra = {}
    if args.sharded:
        k3 = sum(t for n, t in by_kernel.items() if "k3_" in n)
        coll = sum(t for n, t in by_kernel.items() if "nccl" in n.lower())
        extra = {"sharded": True, "capacity_start": SHARDED_CAPACITY,
                 "max_frontier": r.get("max-frontier"),
                 "configs_stepped": r.get("configs-stepped"),
                 "k3_device_s": k3, "k3_share_of_busy": k3 / busy,
                 "collectives_device_s": coll,
                 "collectives_share_of_busy": coll / busy}
    print(json.dumps({
        "history": {"family": args.family, "ops": args.ops,
                    "crashed": args.crashed, "returns": e.n_returns,
                    "slots": e.slot_f.shape[1]},
        "valid": r["valid?"], "closure": r.get("closure"),
        "capacity": r.get("capacity"), "explored": r.get("explored"),
        "launches": launches, "device_kernels": n_kernels,
        "wall_s": wall, "walls_s": walls,
        "profiled_wall_s": profiled_wall, "encode_s": encode_s,
        "device_busy_s": busy, "device_busy_share": busy / wall,
        "device_s_by_kernel": dict(top), **extra,
        "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
