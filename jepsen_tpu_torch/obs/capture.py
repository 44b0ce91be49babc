"""Reading a ``torch.profiler`` capture of the port (the profiler
bridge's output, ``JEPSEN_TPU_TORCH_PROFILE``).

``tensorboard_trace_handler`` writes one Chrome-trace JSON file a
capture (``<host>_<pid>.<ms>.pt.trace.json``) into the profile dir; it
opens in Perfetto or TensorBoard as it is. :func:`kernel_annotations`
ties each of the port's kernels in it to the ``device_annotation``
(``record_function``) it was launched under: the kernel event's
``correlation`` id names the CUDA API call that launched it on
the host, and that call lies inside the annotation on its thread. The
match goes by correlation id, not by the launch call's name: K1 and K2
launch as clusters (``cudaLaunchKernelExC``), K3 and K4 cooperatively
(``cudaLaunchCooperativeKernel``).

Import-safe: the standard library only.
"""

from __future__ import annotations

import glob
import json
import os
from typing import List, Optional

#: (kernel, symbol fragment) of the port's kernels, K2 before K1 (K2's
#: symbol holds K1's fragment)
PORT_KERNELS = (("K2", "frontier_closure_kernel"), ("K1", "closure_"),
                ("K3", "k3_"), ("K4", "k4_"))

_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def port_kernel(name: str) -> Optional[str]:
    """"K1".."K4" for a device kernel's name, or None (not the port's)."""
    for k, frag in PORT_KERNELS:
        if frag in name:
            return k
    return None


def load_captures(profile_dir: str) -> List[dict]:
    """Every capture (trace document) in `profile_dir`, oldest first: a
    run writes one a profiled check."""
    paths = sorted(glob.glob(os.path.join(profile_dir, "*.json")),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no torch.profiler capture in "
                                f"{profile_dir!r}")
    out = []
    for path in paths:
        with open(path) as fh:
            out.append(json.load(fh))
    return out


def kernel_annotations(doc: dict) -> List[dict]:
    """One record a port kernel of the capture, in launch order:
    {"kernel": "K1".."K4", "name", "correlation", "annotation": the
    innermost user annotation around its launch call on the launching
    thread, or None}."""
    events = doc.get("traceEvents", [])
    launch = {}
    notes: dict = {}
    for e in events:
        cat = e.get("cat")
        if cat in _LAUNCH_CATS and "correlation" in (e.get("args") or {}):
            launch[e["args"]["correlation"]] = e
        elif cat == "user_annotation":
            notes.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        k = port_kernel(e.get("name", ""))
        if k is None:
            continue
        corr = (e.get("args") or {}).get("correlation")
        rt = launch.get(corr)
        ann = None
        if rt is not None:
            t = rt["ts"]
            around = [a for a in notes.get((rt.get("pid"), rt.get("tid")),
                                           ())
                      if a["ts"] <= t <= a["ts"] + a.get("dur", 0)]
            if around:
                ann = max(around, key=lambda a: a["ts"])["name"]
        out.append({"kernel": k, "name": e.get("name"),
                    "correlation": corr, "ts": e.get("ts"),
                    "annotation": ann})
    out.sort(key=lambda r: r["ts"] or 0)
    return out
