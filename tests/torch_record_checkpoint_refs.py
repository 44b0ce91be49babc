"""Record the reference's checkpoints that chip_smoke.py holds the port's
to (REF_CHECKPOINTS): `jepsen_tpu.parallel.engine.check_encoded_resumable`
on the CPU (dedupe "hash") over the 400-op unordered queue
(`rand_queue_history(400, n_processes=8, crash_p=0.005, seed=1)`) from
capacity 64, a checkpoint every 32 events, so that the capacity doubles
inside chunks.

    JAX_PLATFORMS=cpu python tests/torch_record_checkpoint_refs.py

Prints one JSON line: the result's fields and, per checkpoint, (event
index, capacity, ok, fail_r, maxf, steps_n, stepped, digest of the rows'
arrays: `cp_digest`), with the seconds the reference took after a `#`.
Not a test: pytest does not collect it.
"""

import hashlib
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

OPS, CAPACITY, EVERY = 400, 64, 32


def cp_digest(cp) -> str:
    """The digest of a checkpoint's arrays (st, ml, mh, live: dtype and
    bytes), as chip_smoke.py computes it."""
    h = hashlib.sha256()
    for a in (cp.st, cp.ml, cp.mh, cp.live):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from jepsen_tpu import histories, models
    from jepsen_tpu.parallel import encode, engine
    h = histories.rand_queue_history(OPS, n_processes=8, crash_p=0.005,
                                     seed=1)
    e = encode.encode(models.UnorderedQueue(), h)
    cps = []
    t0 = time.perf_counter()
    r = engine.check_encoded_resumable(e, capacity=CAPACITY,
                                       checkpoint_every=EVERY,
                                       checkpoint_cb=cps.append,
                                       dedupe="hash")
    secs = time.perf_counter() - t0
    doc = {"result": {k: r.get(k) for k in (
               "valid?", "max-frontier", "capacity", "configs-stepped",
               "fail-event")},
           "checkpoints": [[cp.event_index, cp.capacity, cp.ok, cp.fail_r,
                            cp.maxf, cp.steps_n, cp.stepped, cp_digest(cp)]
                           for cp in cps]}
    print(json.dumps(doc), f"# {secs:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
