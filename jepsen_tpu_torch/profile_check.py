"""Where the time of one check goes, on the card.

    python3 -m jepsen_tpu_torch.profile_check [--ops 10000] [--crashed 12]

Checks `adversarial_register_history(ops, crashed)` with the port once to
warm up, times the host encode alone, the whole check three times
without the profiler (median: `wall_s`) and once under `torch.profiler`
(`profiled_wall_s`), and prints one JSON line with those, the device
time summed by kernel name (top 10), and the device's busy share of the
unprofiled wall. The profiler slows the host (its overhead is
`profiled_wall_s - wall_s`) but not the kernels, so the busy share is
taken against the wall a user sees. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", type=int, default=10000)
    ap.add_argument("--crashed", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_check: needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from jepsen_tpu_torch import histories
    from jepsen_tpu_torch.checker.linearizable import Linearizable
    from jepsen_tpu_torch.models import CASRegister
    from jepsen_tpu_torch.parallel import encode

    h = histories.adversarial_register_history(n_ops=args.ops,
                                               k_crashed=args.crashed)
    checker = Linearizable(CASRegister(None), "torch")
    checker.check({}, h)                                  # warm-up
    t0 = time.perf_counter()
    encode.encode(CASRegister(None), h)
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = checker.check({}, h)
        torch.cuda.synchronize()
        profiled_wall = time.perf_counter() - t0
    by_kernel: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us() / 1e6
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({
        "history": {"ops": args.ops, "crashed": args.crashed},
        "valid": r["valid?"], "wall_s": wall, "walls_s": walls,
        "profiled_wall_s": profiled_wall, "encode_s": encode_s,
        "device_busy_s": busy, "device_busy_share": busy / wall,
        "device_s_by_kernel": dict(top),
        "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
