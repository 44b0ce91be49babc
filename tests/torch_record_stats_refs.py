"""Record the reference's search-stats blocks and checker results that
chip_smoke.py holds the port to (REF_STATS, REF_CHECKERS), each from
`jepsen_tpu` on the CPU with search_stats=True (dedupe "hash" on the
sparse engine).

    JAX_PLATFORMS=cpu python tests/torch_record_stats_refs.py single
    JAX_PLATFORMS=cpu python tests/torch_record_stats_refs.py dense-batch
    JAX_PLATFORMS=cpu python tests/torch_record_stats_refs.py sparse-batch
    JAX_PLATFORMS=cpu python tests/torch_record_stats_refs.py escalated
    JAX_PLATFORMS=cpu python tests/torch_record_stats_refs.py checkers

Prints one JSON line per check, with the seconds the reference took
after a `#`: the digest of the stats block without "closure-iters"
(`stats_digest`), the digest of the sparse blocks' "closure-iters"
(None in place of a dense block's: the dense engine's card path reports
-1 there, the reference's CPU path its counted double expansions), and
a few of the block's numbers to read. A batch gives one digest over its
keys' blocks, in input order.
`checkers` prints the `linear` and `packed` checkers' results on the
golden invalid histories (digest of op, final-paths, configs and
oracle-disagreement). Not a test: pytest does not collect it.
The sparse batch takes the longest (2,628 s on a shared 8-core CPU).
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
ALL_MODELS = dict(SPARSE_MODELS, **{"cas-register": "CASRegister",
                                     "mutex": "Mutex"})


def _digest(doc) -> str:
    return hashlib.sha256(json.dumps(doc, sort_keys=True, default=repr)
                          .encode()).hexdigest()[:16]


def stats_digest(blocks) -> dict:
    """The digests chip_smoke.py compares: one block, or a batch's list
    of blocks."""
    one = isinstance(blocks, dict)
    bs = [blocks] if one else blocks
    rest = [{k: v for k, v in b.items() if k != "closure-iters"}
            for b in bs]
    iters = [None if b["engine"] == "bitdense" else b["closure-iters"]
             for b in bs]
    return {"digest": _digest(rest[0] if one else rest),
            "iters": _digest(iters[0] if one else iters),
            "events": sum(b["events"] for b in bs),
            "frontier-peak": max(b["frontier-peak"] for b in bs)}


def _golden(models, History, which):
    out = []
    for ent in json.loads((GOLDEN / "manifest.json").read_text()):
        if ent["model"] in which and ent["ops"] <= 500:
            out.append((ent["file"],
                        getattr(models, which[ent["model"]])(),
                        History.from_edn((GOLDEN / ent["file"])
                                         .read_text()).index()))
    return out


def single(histories, models, History, engine):
    """The dense 10k-op history, the six golden queue/set histories,
    fifo-1000 and the two-lane gset-200 (config_pack=True)."""
    cases = [("adv-10k-k12", models.CASRegister(),
              histories.adversarial_register_history(n_ops=10000,
                                                     k_crashed=12), {})]
    cases += [(f, m, h, {}) for f, m, h in
              _golden(models, History, SPARSE_MODELS)]
    cases += [
        ("fifo-1000", models.FIFOQueue(), histories.rand_fifo_history(
            1000, n_processes=8, crash_p=0.005, seed=1), {}),
        ("gset-200 two-lane", models.GSet(), histories.rand_gset_history(
            200, n_processes=14, n_elements=20, crash_p=0.005, seed=1),
         {"config_pack": True}),
    ]
    for name, model, h, kw in cases:
        t0 = time.time()
        r = engine.analysis(model, h, dedupe="hash", search_stats=True,
                            **kw)
        b = r["stats"]
        print(json.dumps({name: dict(stats_digest(b), valid=r["valid?"],
                                     tier=b.get("capacity-tier"))}),
              f"# {time.time() - t0:.1f} s", flush=True)


def dense_batch(histories, models, engine, enc):
    """chip_smoke.py's _batch_keys(): the 84 keys, then the 92."""
    multikey = [histories.rand_register_history(
        n_ops=120, n_processes=14, n_values=5, crash_p=0.005, fail_p=0.05,
        busy=0.8, seed=2024 + k) for k in range(84)]
    adv = histories.adversarial_register_history(n_ops=1000, k_crashed=16)
    extra = [adv, histories.with_impossible_read(adv)]
    for k in range(6):
        h = histories.rand_register_history(
            n_ops=120, n_processes=14, n_values=5, crash_p=0.005,
            fail_p=0.05, busy=0.8, seed=3000 + k)
        extra.append(histories.corrupt_history(h, seed=k))
    model = models.CASRegister()
    for name, hs in (("multikey-84", multikey),
                     ("multikey-84+8", multikey + extra)):
        t0 = time.time()
        rs = engine.check_batch_encoded(
            model, [enc.encode(model, h) for h in hs], search_stats=True)
        print(json.dumps({name: stats_digest([r["stats"] for r in rs])}),
              f"# {time.time() - t0:.1f} s", flush=True)


def _queue_keys(histories):
    keys = [histories.rand_queue_history(120, n_processes=14,
                                         crash_p=0.005, seed=2024 + k)
            for k in range(24)]
    return keys + [histories.corrupt_history(keys[k], seed=k)
                   for k in (0, 6, 12, 18)]


def sparse_batch(histories, models, engine, enc):
    """chip_smoke.py's _sparse_batch_keys() at the batch's defaults."""
    model = models.UnorderedQueue()
    t0 = time.time()
    rs = engine.check_batch_encoded(
        model, [enc.encode(model, h) for h in _queue_keys(histories)],
        dedupe="hash", search_stats=True)
    print(json.dumps({"uqueue-24+4": dict(
        stats_digest([r["stats"] for r in rs]),
        tier=[r["stats"]["capacity-tier"] for r in rs])}),
        f"# {time.time() - t0:.1f} s", flush=True)


def escalated(histories, models, engine, enc):
    """Key 1 of the queue keys alone at max_capacity 4,096: it escalates
    to the single-key engine, which decides at 8,192."""
    model = models.UnorderedQueue()
    t0 = time.time()
    r, = engine.check_batch_encoded(
        model, [enc.encode(model, _queue_keys(histories)[1])],
        max_capacity=4096, dedupe="hash", search_stats=True)
    print(json.dumps({"uqueue key 1 max4096": dict(
        stats_digest(r["stats"]), escalated=r.get("escalated"),
        capacity=r["capacity"], tier=r["stats"].get("capacity-tier"))}),
        f"# {time.time() - t0:.1f} s", flush=True)


def checkers(histories, models, History):
    """`linear` and `packed` on the golden invalid histories of at most
    500 ops: the analyzer, and the digest of op, final-paths, configs and
    oracle-disagreement after the re-search."""
    from jepsen_tpu.checker.linearizable import Linearizable
    for f, model, h in _golden(models, History, ALL_MODELS):
        for algo in ("linear", "packed"):
            t0 = time.time()
            r = Linearizable(model, algo).check({}, h)
            if r["valid?"] is not False:
                continue
            print(json.dumps({f"{f} {algo}": {
                "analyzer": r["analyzer"],
                "digest": _digest({k: r.get(k) for k in (
                    "op", "final-paths", "configs",
                    "oracle-disagreement")})}}),
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
    elif what == "dense-batch":
        dense_batch(histories, models, engine, enc)
    elif what == "sparse-batch":
        sparse_batch(histories, models, engine, enc)
    elif what == "escalated":
        escalated(histories, models, engine, enc)
    elif what == "checkers":
        checkers(histories, models, History)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
