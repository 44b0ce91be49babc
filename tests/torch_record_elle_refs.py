"""Record the reference's results that chip_smoke.py holds the port's
elle phase to (REF_ELLE): `jepsen_tpu.workloads.cycle.AppendChecker` and
`WrChecker` on the smoke's simulated histories of 10,000 committed
transactions (tests/torch_elle_cases.py: SMOKE_HISTORIES, each valid and
its invalid twin), each result as `torch_elle_cases.result_digest`
gives it. Every graph has 10,000 nodes, so the reference's SCCs take
its device route (JAX on the CPU here).

    JAX_PLATFORMS=cpu python tests/torch_record_elle_refs.py

Prints one JSON line, then the seconds the reference took after a `#`.
Not a test: pytest does not collect it.
"""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import torch_elle_cases as ec
    from jepsen_tpu.workloads import cycle
    t0 = time.perf_counter()
    out = {}
    for name, (kind, _t, _s, opts, _f) in ec.SMOKE_HISTORIES.items():
        make = cycle.AppendChecker if kind == "append" else cycle.WrChecker
        for twin in (False, True):
            r = make(opts).check({}, ec.smoke_history(name, twin))
            out[f"{name}{' twin' if twin else ''}"] = ec.result_digest(r)
    print(json.dumps(out))
    print(f"# {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
