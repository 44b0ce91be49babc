"""Where the time of one check goes, on the card.

    python3 -m jepsen_tpu_torch.profile_check [--family register]
        [--ops 10000] [--crashed 12]

Checks one history with the port once to warm up, times the host encode
alone, the whole check three times without the profiler (median:
`wall_s`) and once under `torch.profiler` (`profiled_wall_s`), and
prints one JSON line with those, the device time summed by kernel name
(top 10), the number of device kernels the profiled check ran, the
launches of the port's own kernels, and the device's busy share of the
unprofiled wall. The profiler slows the host (its overhead is
`profiled_wall_s - wall_s`) but not the kernels, so the busy share is
taken against the wall a user sees. Needs a CUDA device.

Families: "register" is `adversarial_register_history(ops, crashed)`
(the dense engine); "uqueue", "gset" and "fifo" are the sparse engine's
`rand_queue_history(ops, n_processes=8)`,
`rand_gset_history(ops, n_processes=10, n_elements=16)` and
`rand_fifo_history(ops, n_processes=8)`, each with crash_p=0.005 and
seed=1.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="register",
                    choices=("register", "uqueue", "gset", "fifo"))
    ap.add_argument("--ops", type=int, default=10000)
    ap.add_argument("--crashed", type=int, default=12)
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
    checker = Linearizable(model, "torch")
    checker.check({}, h)                                  # warm-up
    t0 = time.perf_counter()
    e = encode.encode(model, h)
    encode_s = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checker.check({}, h)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    torch.cuda.synchronize()
    ck.reset_launches()
    sk.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = checker.check({}, h)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    launches = {"K1": ck.launches, **sk.launches}
    by_kernel: dict = {}
    n_kernels = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n_kernels += 1
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us() / 1e6
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
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
        "device_s_by_kernel": dict(top),
        "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
