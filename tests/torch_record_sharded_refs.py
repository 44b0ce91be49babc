"""Record the reference's results that chip_smoke.py holds the port's mesh
phases to (REF_SHARDED_RESUMABLE, REF_SHARDED_STATS, REF_ELASTIC,
REF_STEAL), each on a one-device CPU mesh of `jepsen_tpu`:

  resumable  `sharded.check_encoded_sharded_resumable` of the k12
             adversarial register history at 2,500 ops (capacity 2^17,
             dedupe "hash", a checkpoint every 256 events): the result's
             fields and every checkpoint's (event index, capacity, ok,
             fail_r, maxf, steps_n, stepped, digest of the rows' arrays)
  stats      `sharded.check_encoded_sharded(search_stats=True)` of the
             600-op k12 history (capacity 8192): the result, the digest
             of the "stats" block without the probe histogram's fields,
             and some of the block's fields
  elastic    `sharded.check_encoded_sharded_elastic` of the 400-op
             unordered queue (seed 1) from capacity 64, a checkpoint
             every 32 events: the verdict fields and the "reshard" block
  steal      `engine.check_batch(steal=True)` of
             `elastic.forced_skew_histories()` (8 heavy, 40 light keys)
             at the A/B's capacity (`elastic.SKEW_CAPACITY`, max 2^16):
             the digest of every key's pinned fields (`STEAL_PIN`, as
             chip_smoke.py's _steal_digest) and the scheduler's stats

    JAX_PLATFORMS=cpu python tests/torch_record_sharded_refs.py SECTION

Prints one JSON line, then the seconds the reference took after a `#`.
The reference took (its four sections at once on a shared 8-core CPU,
one JAX CPU device each): resumable 8,052.3 s, stats 2,296.7 s,
elastic 12.1 s, steal 9.0 s. Not a test: pytest does not collect it.
"""

import hashlib
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

RESUMABLE_OPS, RESUMABLE_CAPACITY, RESUMABLE_EVERY = 2500, 1 << 17, 256
STATS_OPS, STATS_CAPACITY = 600, 8192
ELASTIC_OPS, ELASTIC_CAPACITY, ELASTIC_EVERY = 400, 64, 32
STEAL_MAX_CAPACITY = 1 << 16
RESULT_KEYS = ("valid?", "op", "fail-event", "max-frontier", "capacity",
               "devices", "configs-stepped")
SCHED_KEYS = ("rounds", "steals", "observed_keys", "per_device_cost",
              "per_device_busy", "busy_frac",
              "per_device_load_factor_peak", "load_factor_spread",
              "cohort_pred")


def cp_digest(cp) -> str:
    """The digest of a checkpoint's arrays (st, ml, mh, live: dtype and
    bytes), as chip_smoke.py computes it."""
    h = hashlib.sha256()
    for a in (cp.st, cp.ml, cp.mh, cp.live):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), ("frontier",))


def _pin(r: dict) -> dict:
    return {k: r.get(k) for k in RESULT_KEYS}


def resumable() -> dict:
    from jepsen_tpu import histories, models
    from jepsen_tpu.parallel import encode, sharded
    h = histories.adversarial_register_history(n_ops=RESUMABLE_OPS,
                                               k_crashed=12)
    e = encode.encode(models.CASRegister(None), h)
    cps = []
    r = sharded.check_encoded_sharded_resumable(
        e, _mesh(), capacity=RESUMABLE_CAPACITY, max_capacity=1 << 20,
        checkpoint_every=RESUMABLE_EVERY, checkpoint_cb=cps.append,
        dedupe="hash")
    return {"result": _pin(r),
            "checkpoints": [[cp.event_index, cp.capacity, cp.ok, cp.fail_r,
                             cp.maxf, cp.steps_n, cp.stepped, cp_digest(cp)]
                            for cp in cps]}


def stats() -> dict:
    from jepsen_tpu import histories, models
    from jepsen_tpu.parallel import encode, sharded
    h = histories.adversarial_register_history(n_ops=STATS_OPS,
                                               k_crashed=12)
    e = encode.encode(models.CASRegister(None), h)
    r = sharded.check_encoded_sharded(e, _mesh(), capacity=STATS_CAPACITY,
                                      max_capacity=1 << 20, dedupe="hash",
                                      search_stats=True)
    block = r["stats"]
    rest = {k: v for k, v in block.items()
            if k not in ("probe-hist", "probes")}
    return {"result": _pin(r),
            "digest": hashlib.sha256(json.dumps(rest, sort_keys=True)
                                     .encode()).hexdigest()[:16],
            **{k: block[k] for k in ("events", "frontier-peak",
                                     "capacity-tier", "probes")}}


def elastic() -> dict:
    from jepsen_tpu import histories, models
    from jepsen_tpu.parallel import encode, sharded
    h = histories.rand_queue_history(ELASTIC_OPS, n_processes=8,
                                     crash_p=0.005, seed=1)
    e = encode.encode(models.UnorderedQueue(), h)
    r = sharded.check_encoded_sharded_elastic(
        e, _mesh(), capacity=ELASTIC_CAPACITY,
        checkpoint_every=ELASTIC_EVERY, dedupe="hash")
    return {"result": _pin(r), "reshard": r["reshard"]}


def steal() -> dict:
    from jepsen_tpu.parallel import elastic as el
    from jepsen_tpu.parallel import engine
    model, hs = el.forced_skew_histories()
    st: dict = {}
    rs = engine.check_batch(model, hs, capacity=el.SKEW_CAPACITY,
                            max_capacity=STEAL_MAX_CAPACITY, mesh=_mesh(),
                            dedupe="hash", steal=True, steal_stats=st)
    pins = [{k: r.get(k) for k in el.STEAL_PIN} for r in rs]
    return {"digest": hashlib.sha256(json.dumps(
                pins, sort_keys=True, default=repr).encode()).hexdigest()[:16],
            "buckets": [{k: b.get(k) for k in ("tier", "engine", "keys")
                         + SCHED_KEYS} for b in st["buckets"]]}


SECTIONS = {"resumable": resumable, "stats": stats, "elastic": elastic,
            "steal": steal}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    if len(sys.argv) != 2 or sys.argv[1] not in SECTIONS:
        print(f"usage: {sys.argv[0]} {'|'.join(SECTIONS)}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    doc = SECTIONS[sys.argv[1]]()
    print(json.dumps(doc), f"# {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
