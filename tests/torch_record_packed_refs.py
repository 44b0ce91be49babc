"""Record the reference's packed results that chip_smoke.py holds the port
to: REF_PACKED (single-key), REF_SPARSE_BATCH_PACKED (the 28-key batch)
and REF_SHARDED_PACKED (the sharded checks at one device), each from
`jepsen_tpu` on the CPU with config_pack=True and dedupe "hash".

    JAX_PLATFORMS=cpu python tests/torch_record_packed_refs.py single
    JAX_PLATFORMS=cpu python tests/torch_record_packed_refs.py batch
    JAX_PLATFORMS=cpu python tests/torch_record_packed_refs.py sharded

Prints one JSON line per check (the batch: its digest line, then every
key's result), with the seconds the reference took after a `#`. Not a
test: pytest does not collect it. The batch takes the longest (2,668 s
on a shared 8-core CPU).
"""

import hashlib
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "data" / "golden"
SPARSE_MODELS = {"fifo-queue": "FIFOQueue",
                 "unordered-queue": "UnorderedQueue", "set": "GSet"}
SHARDED_KEYS = ("valid?", "op", "fail-event", "max-frontier", "capacity",
                "devices", "configs-stepped", "config-pack")


def _digest(doc) -> str:
    return hashlib.sha256(json.dumps(doc, sort_keys=True, default=repr)
                          .encode()).hexdigest()[:16]


def single(histories, models, History, engine):
    """chip_smoke.py's _packed_cases(): every field but analyzer and
    closure, and the digest of final-paths and configs of the invalid."""
    cases = []
    for ent in json.loads((GOLDEN / "manifest.json").read_text()):
        if ent["model"] in SPARSE_MODELS:
            cases.append((ent["file"],
                          getattr(models, SPARSE_MODELS[ent["model"]])(),
                          History.from_edn((GOLDEN / ent["file"])
                                           .read_text()).index()))
    fifo = histories.rand_fifo_history(1000, n_processes=8, crash_p=0.005,
                                       seed=1)
    cases += [
        ("uqueue-400", models.UnorderedQueue(), histories.rand_queue_history(
            400, n_processes=8, crash_p=0.005, seed=1)),
        ("gset-400", models.GSet(), histories.rand_gset_history(
            400, n_processes=10, n_elements=16, crash_p=0.005, seed=1)),
        ("fifo-1000", models.FIFOQueue(), fifo),
        ("fifo-1000 corrupted", models.FIFOQueue(),
         histories.corrupt_history(fifo, seed=0)),
        ("gset-200 two-lane", models.GSet(), histories.rand_gset_history(
            200, n_processes=14, n_elements=20, crash_p=0.005, seed=1)),
    ]
    for name, model, h in cases:
        t0 = time.time()
        r = engine.analysis(model, h, config_pack=True, dedupe="hash")
        for k in ("final-paths", "configs"):
            if isinstance(r.get(k), list):
                r[k] = r[k][:10]      # the checker's truncation
        d = {k: v for k, v in r.items() if k not in (
            "final-paths", "configs", "analyzer", "closure")}
        if r["valid?"] is False:
            d["paths"] = _digest({k: r.get(k)
                                  for k in ("final-paths", "configs")})
        print(json.dumps({name: d}), f"# {time.time() - t0:.1f} s",
              flush=True)


def batch(histories, models, engine, enc):
    """chip_smoke.py's _sparse_batch_keys() through check_batch_encoded:
    the digest of every field but closure, capacities, invalid keys."""
    keys = [histories.rand_queue_history(120, n_processes=14,
                                         crash_p=0.005, seed=2024 + k)
            for k in range(24)]
    hs = keys + [histories.corrupt_history(keys[k], seed=k)
                 for k in (0, 6, 12, 18)]
    model = models.UnorderedQueue()
    t0 = time.time()
    rs = engine.check_batch_encoded(model, [enc.encode(model, h)
                                            for h in hs],
                                    config_pack=True, dedupe="hash")
    strip = [{k: v for k, v in r.items() if k != "closure"} for r in rs]
    print(json.dumps({
        "keys": len(rs), "digest": _digest(strip),
        "invalid": {i: {"fail-event": r["fail-event"], "op": r["op"]}
                    for i, r in enumerate(rs) if r["valid?"] is False},
        "capacity": [r["capacity"] for r in rs]}),
        f"# {time.time() - t0:.1f} s", flush=True)
    print(json.dumps(rs, default=repr), flush=True)


def sharded(histories, models, History, enc):
    """chip_smoke.py's _packed_sharded_cases() at one CPU device."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from jepsen_tpu.parallel import sharded as ref_sharded
    mesh = Mesh(np.array(jax.devices()[:1]), ("frontier",))
    reg = models.CASRegister()

    def wide(n, v):
        ops = [{"type": "invoke", "process": i, "f": "write", "value": i}
               for i in range(1, n + 1)]
        ops += [{"type": "info", "process": i, "f": "write", "value": i}
                for i in range(1, n + 1)]
        ops += [{"type": "invoke", "process": 0, "f": "read",
                 "value": None},
                {"type": "ok", "process": 0, "f": "read", "value": v}]
        return History.wrap(ops).index()

    cases = []
    for seed in (77, 78, 79):
        h = histories.rand_register_history(
            n_ops=60, n_processes=5, crash_p=0.06, fail_p=0.06, seed=seed)
        cases.append((f"register-60 seed {seed}", enc.encode(reg, h), 512))
        cases.append((f"register-60 seed {seed} corrupted",
                      enc.encode(reg, histories.corrupt_history(h,
                                                                seed=seed)),
                      512))
    cases.append(("wide-10 valid", enc.encode(reg, wide(10, 3)), 512))
    cases.append(("wide-10 invalid", enc.encode(reg, wide(10, 99)), 512))
    for f, model in (("uqueue-valid.edn", models.UnorderedQueue()),
                     ("fifo-invalid.edn", models.FIFOQueue())):
        h = History.from_edn((GOLDEN / f).read_text()).index()
        cases.append((f, enc.encode(model, h), 1024))
    gset = models.GSet()
    cases.append(("gset-44 two-lane", enc.encode(
        gset, histories.rand_gset_history(n_ops=44, n_processes=6,
                                          n_elements=30, crash_p=0.05,
                                          seed=45)), 512))
    cases.append(("gset-200 two-lane", enc.encode(
        gset, histories.rand_gset_history(200, n_processes=14,
                                          n_elements=20, crash_p=0.005,
                                          seed=1)), 16384))
    for name, e, cap in cases:
        t0 = time.time()
        r = ref_sharded.check_encoded_sharded(e, mesh, capacity=cap,
                                              dedupe="hash",
                                              config_pack=True)
        print(json.dumps({name: {k: r[k] for k in SHARDED_KEYS if k in r}}),
              f"# {time.time() - t0:.1f} s", flush=True)


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    from jepsen_tpu import histories, models
    from jepsen_tpu.history import History
    from jepsen_tpu.parallel import encode as enc
    from jepsen_tpu.parallel import engine
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "single":
        single(histories, models, History, engine)
    elif what == "batch":
        batch(histories, models, engine, enc)
    elif what == "sharded":
        sharded(histories, models, History, enc)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
