"""Per-key independence: lift a single-key checker over the keys of a
multi-key history (reference: jepsen/src/jepsen/independent.clj).

A port, trimmed, of the analysis half of `jepsen_tpu.independent`. Ops
carry `KV(k, v)` tuple values; `split_history` buckets them per key,
un-keyed ops going to every key; `checker` lifts a checker over every
key: valid iff valid for all keys, results under {"results": {k: ...},
"failures": [...]}.

When the lifted checker is the port's `Linearizable` with algorithm
"torch" or "competition" and the model is packable, every key is
checked in one call of
`engine.check_batch`: one batched device scan per slot-window bucket —
the dense engine's where the bucket fits it, else the sparse batch with
its per-key capacity retry and single-key escalation (Jepsen's per-key
queue and set workloads) — each sub-result tagged "analyzer": "torch",
with its own "stats" block when the checker asks for search stats.
Otherwise ("wgl", "linear", "packed", an
unpackable model) each key runs the checker on its own, on the host. A
batch that cannot be encoded (EncodeError) goes to the per-key path
with the reference's structured "device-fallback" / "resilience" record
of class "not-encodable"; any other device error surfaces to the
caller, as the port's single-history checker does.

With `pipeline=True` (or JEPSEN_TPU_TORCH_PIPELINE=1) that batch runs
through the pipelined executor (`parallel.pipeline`). A
`torch.distributed` DeviceMesh under the test map's "mesh" shards the
batch's key axis over its ranks (every rank runs the checker on the
same history) and gives an overflowing key the sharded escalation
rung; `steal` and `reshard` (None: their flags) pass through to
`engine.check_batch`. Not ported: the generator half (tuple_gen,
sequential_generator, ConcurrentGenerator), the circuit breaker and
supervisor, and per-key result persistence to a store.

Telemetry, the reference's: the `independent.keys` counter, the
`independent.check` span with an `independent.device_batch` span around
the batch or an `independent.key` span a key on the per-key path, and
the `independent.device_fallbacks` counter with its class-labeled twin
(`independent.device_fallbacks.not-encodable`).
"""

from __future__ import annotations

import logging

from jepsen_tpu_torch import obs

from jepsen_tpu_torch.checker.core import Checker, check_safe, merge_valid
from jepsen_tpu_torch.history import History, Op

log = logging.getLogger(__name__)

DIR = "independent"  # results subdirectory (independent.clj:17-19)


class KV(tuple):
    """A [k v] tuple value (independent.clj:21-29). Subclasses tuple so it
    serializes like a 2-vector, as the reference's history.edn does."""

    __slots__ = ()

    def __new__(cls, k, v):
        return super().__new__(cls, (k, v))

    @property
    def key(self):
        return self[0]

    @property
    def value(self):
        return self[1]


def ktuple(k, v) -> KV:
    return KV(k, v)


def is_tuple(v) -> bool:
    return isinstance(v, KV)


def kv_history(history) -> History:
    """Reinterpret 2-element list/tuple op values as KV tuples — for
    histories loaded from EDN/JSONL, where [k v] values are plain
    vectors. Only client ops (integer process) are rewrapped."""
    out = History()
    for o in history:
        v = o.get("value")
        if (isinstance(o.get("process"), int)
                and not isinstance(v, KV)
                and isinstance(v, (list, tuple)) and len(v) == 2):
            o = Op(o)
            o["value"] = KV(v[0], v[1])
        out.append(o)
    return out


def history_keys(history) -> list:
    """The KV keys of a history, in first-seen order
    (independent.clj:238-248)."""
    seen = set()
    out = []
    for o in history:
        v = o.get("value")
        if isinstance(v, KV) and v.key not in seen:
            seen.add(v.key)
            out.append(v.key)
    return out


def split_history(history) -> dict:
    """One pass over the history, bucketing ops per key with their
    tuples unwrapped (un-keyed ops go to every bucket, late keys start
    from the un-keyed prefix). Returns {k: History} in first-seen
    order."""
    subs: dict = {}
    unkeyed: list = []
    for o in history:
        v = o.get("value")
        if not isinstance(v, KV):
            unkeyed.append(o)
            for h in subs.values():
                h.append(o)
        else:
            h = subs.get(v.key)
            if h is None:
                h = subs[v.key] = History(unkeyed)
            o2 = Op(o)
            o2["value"] = v.value
            h.append(o2)
    return subs


def subhistory(k, history) -> History:
    """All ops without a differing key, tuples unwrapped
    (independent.clj:250-261)."""
    out = History()
    for o in history:
        v = o.get("value")
        if not isinstance(v, KV):
            out.append(o)
        elif v.key == k:
            o2 = Op(o)
            o2["value"] = v.value
            out.append(o2)
    return out


class IndependentChecker(Checker):
    """Lifts a checker over per-key subhistories: valid iff valid for
    all keys (independent.clj:263-314). With the port's device
    `Linearizable` the keys are checked as one batch on its device;
    `batch_device=False` checks them one by one. `pipeline` (None: the
    JEPSEN_TPU_TORCH_PIPELINE flag) runs that batch through the
    pipelined executor (`engine.check_batch(pipeline=...)`): the same
    results, the encode overlapping the card's scan."""

    def __init__(self, checker: Checker, batch_device: bool = True,
                 pipeline=None, steal=None, reshard=None):
        self.checker = checker
        self.batch_device = batch_device
        self.pipeline = pipeline
        self.steal = steal
        self.reshard = reshard

    def check(self, test, history, opts=None):
        opts = opts or {}
        # a history reloaded from EDN/JSONL carries [k v] values as plain
        # lists; without any KV every key would vanish
        if not any(isinstance(o.get("value"), KV) for o in history):
            history = kv_history(history)
        subs = split_history(history)
        ks = list(subs)
        obs.counter("independent.keys").inc(len(ks))
        with obs.span("independent.check", keys=len(ks)):
            results, fallback = self._batched_device_results(test, subs)
            if results is None:
                results = {}
                for k in ks:
                    with obs.span("independent.key", key=str(k)):
                        results[k] = check_safe(
                            self.checker, test, subs[k],
                            {**opts,
                             "subdirectory":
                                 list(opts.get("subdirectory", []))
                                 + [DIR, k],
                             "history-key": k})
        # only proven-invalid keys; "unknown" is not a failure
        # (independent.clj:305-311)
        failures = [k for k, r in results.items() if r.get("valid?") is False]
        out = {
            "valid?": merge_valid(r.get("valid?") for r in results.values()),
            "results": results,
            "failures": failures,
        }
        if fallback is not None:
            out["device-fallback"] = fallback["reason"]
            out["resilience"] = fallback
        return out

    def _batched_device_results(self, test, subs):
        """(results, fallback): results None means the per-key path runs.
        The batch is `engine.check_batch` at its defaults (capacity 512,
        max_capacity 2^18, the port's dedupe flag), dense and sparse
        buckets alike, with the checker's `config_pack` and
        `search_stats`; a "competition" checker batches too, as the
        reference's does (its device arm is the batch).
        fallback None means the batch did not apply (not the port's device
        checker, no model, an unpackable model); else the structured
        record of why a batch that applied did not run."""
        from jepsen_tpu_torch import models as model_ns
        from jepsen_tpu_torch.checker.linearizable import Linearizable
        from jepsen_tpu_torch.history import Intern
        from jepsen_tpu_torch.parallel import engine
        from jepsen_tpu_torch.parallel.encode import EncodeError
        c = self.checker
        if not (self.batch_device and isinstance(c, Linearizable)
                and (c.algorithm or "torch") in ("torch", "competition")
                and subs):
            return None, None
        model = c.model or (test or {}).get("model")
        if model is None:
            return None, None
        try:
            packable = model_ns.pack_spec(model, Intern()) is not None
        except Exception:  # noqa: BLE001 - a failing probe means "no"
            packable = False
        if not packable:
            return None, None
        ks = list(subs)
        # a mesh on the test map shards the key axis over its ranks
        mesh = (test or {}).get("mesh")
        try:
            with obs.span("independent.device_batch", keys=len(ks)):
                rs = engine.check_batch(
                    model, [subs[k] for k in ks],
                    device=None if mesh is not None else c.device,
                    pipeline=self.pipeline, config_pack=c.config_pack,
                    search_stats=c.search_stats, mesh=mesh,
                    steal=self.steal, reshard=self.reshard)
        except EncodeError as err:
            # not device-encodable (a set past its lane budget, a crash
            # pile-up past 64 slots): the host path is right, but slower
            backend = "cpu" if c.device == "cpu" else "cuda"
            return None, self._fallback(
                "not-encodable", f"not device-encodable: {err}", backend)
        return {k: {**r, "analyzer": "torch"} for k, r in zip(ks, rs)}, None

    @staticmethod
    def _fallback(cls: str, reason: str, backend: str) -> dict:
        obs.counter("independent.device_fallbacks").inc()
        obs.counter(f"independent.device_fallbacks.{cls}").inc()
        log.warning("device batch check skipped (%s) — using the per-key "
                    "checker", reason)
        return {"class": cls, "reason": reason, "backend": backend,
                "no-redispatch": False}


def checker(c: Checker, batch_device: bool = True, pipeline=None,
            steal=None, reshard=None) -> IndependentChecker:
    return IndependentChecker(c, batch_device, pipeline, steal=steal,
                              reshard=reshard)
