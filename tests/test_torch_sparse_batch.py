"""The port's sparse per-key batch (jepsen_tpu_torch: `sparse._BatchScan`,
`sparse.check_batch_sparse`, `engine._check_batch_sparse`,
`engine._escalate_overflow`, and the batched closures around K2 and K4),
on the CPU with the plain closures, against the reference's
(`jepsen_tpu.parallel.engine.check_batch_encoded` / `_check_batch_sparse`,
its XLA closure) on the identical encoded input, carried across with
`encoded_from_arrays`. Every field but `closure` must match, key for key
and in input order, under dedupe "hash" and "sort": the capacity retry,
the single-key escalation and its "unknown", the tiled route, mixed
dense and sparse buckets, re-padding to the pending keys, failed and
short keys, and `independent` over keyed queue histories. The batched
closures key by key, and the batched kernels on the card, are in
test_torch_sparse_batch_kernels.py."""

import dataclasses

import pytest
import torch

from jepsen_tpu import histories as ref_histories
from jepsen_tpu import independent as ref_independent
from jepsen_tpu import models as ref_models
from jepsen_tpu.checker import linearizable as ref_linearizable
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.parallel import encode as ref_enc
from jepsen_tpu.parallel import engine as ref_engine
from jepsen_tpu_torch import independent, models
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.parallel import encode as enc
from jepsen_tpu_torch.parallel import engine, sparse
from torch_jax_cache import release_compiled_programs  # noqa: F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(e):
    arrays = {k: getattr(e, k) for k in enc.ARRAY_FIELDS}
    calls = [dataclasses.asdict(c) for c in e.calls]
    meta = {k: getattr(e, k) for k in ("state0", "step_name", "n_calls",
                                       "n_slots", "state_lo", "n_states",
                                       "model_pruned")}
    meta["intern"] = list(e.intern._values)
    return enc.encoded_from_arrays(arrays, calls, meta)


def _strip(rs):
    """Every field but `closure` (the reference tags a dense key's batch
    "xla-while", the port "torch" or "cuda")."""
    return [{k: v for k, v in r.items() if k != "closure"} for r in rs]


def _both(ref_model, hs, **kw):
    """check_batch_encoded of both packages on the same encodings ->
    (port results, reference results, port encodings)."""
    pre = [ref_enc.encode(ref_model, h) for h in hs]
    want = ref_engine.check_batch_encoded(ref_model, pre, **kw)
    ppre = [_to_port(e) for e in pre]
    got = engine.check_batch_encoded(None, ppre, device=CPU, **kw)
    return got, want, ppre


@pytest.fixture
def tiers(monkeypatch):
    """(K, N, C, R, closure) of every `_BatchScan` the test builds."""
    seen = []
    real = sparse._BatchScan.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        seen.append((self.K, self.N, self.C, self.R, self.closure))

    monkeypatch.setattr(sparse._BatchScan, "__init__", init)
    return seen


def _fifo_escalation_keys():
    """The reference's escalation shapes (tests/test_engine.py's batch
    escalation case)."""
    return [ref_histories.rand_fifo_history(n_ops=40, n_processes=6,
                                            n_values=3, crash_p=0.15,
                                            seed=s) for s in (5, 1, 3, 4)]


# ------------------------------------- capacity retry and escalation

@pytest.mark.parametrize("dedupe", ["hash", "sort"])
def test_capacity_retry_and_escalation_match_the_reference(dedupe, tiers):
    """Capacity 64, ceiling 128: one key decides at 128, one escalates
    to the single-key engine and decides at 512, two exhaust it."""
    got, want, _ = _both(ref_models.FIFOQueue(), _fifo_escalation_keys(),
                         capacity=64, max_capacity=128, dedupe=dedupe)
    assert _strip(got) == _strip(want)
    assert [r["capacity"] for r in want] == [128, 512, 512, 512]
    assert want[1]["escalated"] == "single"
    err = ("frontier overflow: batch capacity 128, escalation tiers "
           "exhausted (frontier overflow at capacity 512)")
    assert [r.get("error") for r in want[2:]] == [err, err]
    assert all(r["closure"] == "torch" for r in got)
    # two buckets (C 6 and 8: tier 8; C 11 and 12: tier 16), each run at
    # capacity 64 and again at 128 for its keys that overflowed
    assert [(k, n) for k, n, *_ in tiers] == [(2, 64), (2, 128), (2, 64),
                                              (2, 128)]


def _queue_keys(n_keys=5, n_ops=30, corrupt=(2,)):
    hs = [ref_histories.rand_queue_history(n_ops=n_ops, n_processes=5,
                                           n_values=3, crash_p=0.08, seed=s)
          for s in range(n_keys)]
    for i in corrupt:
        hs[i] = ref_histories.corrupt_history(hs[i], seed=1)
    return hs


def test_tiled_route_equals_the_fused_route_and_the_reference(tiers):
    """A budget too small for K2's layout at capacity 512 sends every
    key's closure through the batched tiled insert (the whole table)."""
    pre = [ref_enc.encode(ref_models.UnorderedQueue(), h)
           for h in _queue_keys()]
    want = ref_engine._check_batch_sparse(ref_models.UnorderedQueue(), pre,
                                          512, 1 << 18, dedupe="hash")
    ppre = [_to_port(e) for e in pre]
    tiled = engine._check_batch_sparse(ppre, 512, 1 << 18,
                                       dedupe="hash", device=CPU,
                                       smem_budget=16384)
    fused = engine._check_batch_sparse(ppre, 512, 1 << 18,
                                       dedupe="hash", device=CPU)
    assert [t[-1] for t in tiers] == ["tiled", "fused"]
    assert _strip(tiled) == _strip(fused) == want
    assert {r["closure"] for r in tiled} == {"torch-tiled"}
    assert {r["closure"] for r in fused} == {"torch"}
    assert any(r["valid?"] is False for r in want)


def test_tiled_route_escalates_like_the_reference(tiers):
    """The tiled batch at capacity 512 with a ceiling of 512, and the
    escalation's single-key checks (capacity 1,024 to 2,048) through the
    tiled route too."""
    pre = [ref_enc.encode(ref_models.FIFOQueue(), h)
           for h in _fifo_escalation_keys()]
    got = engine._check_batch_sparse([_to_port(e) for e in pre], 512,
                                     512, dedupe="hash", device=CPU,
                                     smem_budget=16384)
    want = ref_engine._check_batch_sparse(ref_models.FIFOQueue(), pre, 512,
                                          512, dedupe="hash")
    assert [t[-1] for t in tiers] == ["tiled"]
    assert _strip(got) == want
    assert {r["closure"] for r in got} == {"torch-tiled"}
    assert any(r.get("escalated") == "single" for r in want)


def test_tiled_batch_probe_overflow_is_the_references(tiers):
    """At probe_limit 3 the table's layout decides where keys overflow:
    the tiled batch (the whole table, one chunk: the reference's
    transaction) gives the reference's capacities, 512 to 4,096."""
    pre = [ref_enc.encode(ref_models.UnorderedQueue(), ref_histories
                          .rand_queue_history(n_ops=40, n_processes=6,
                                              n_values=3, crash_p=0.1,
                                              seed=s)) for s in range(6)]
    got = sparse.check_batch_sparse(
        [_to_port(e) for e in pre], 256, 1 << 12, dedupe="hash",
        device=CPU, smem_budget=16384, probe_limit=3,
        escalate=lambda e, n: None)
    want = ref_engine._check_batch_sparse(None, pre, 256, 1 << 12,
                                          dedupe="hash", probe_limit=3)
    assert {t[-1] for t in tiers} == {"tiled"}
    assert _strip(got) == want
    assert len({r["capacity"] for r in want}) >= 3


def _uq(n_processes, n_ops, n_values, seed, crash_p=0.1):
    return ref_histories.rand_queue_history(
        n_ops=n_ops, n_processes=n_processes, n_values=n_values,
        crash_p=crash_p, seed=seed)


@pytest.mark.parametrize("dedupe", ["hash", "sort"])
def test_dense_and_sparse_buckets_in_input_order(dedupe, tiers):
    """One model, two buckets: the tier-4 keys fit the dense engine, the
    tier-8 keys do not; results come back in input order."""
    hs = [_uq(4, 30, 3, 0), _uq(2, 10, 2, 0), _uq(6, 40, 3, 1),
          _uq(3, 12, 2, 0), _uq(8, 40, 3, 0)]
    got, want, ppre = _both(ref_models.UnorderedQueue(), hs,
                            dedupe=dedupe)
    assert _strip(got) == _strip(want)
    engines = [r.get("engine", "sparse") for r in got]
    assert engines == ["sparse", "bitdense", "sparse", "bitdense",
                       "sparse"]
    assert [(k, c) for k, _, c, _, _ in tiers] == [(3, 8)]


def _fails_first(h):
    """`h` after a first op that can never linearize: a dequeue of a value
    nobody enqueues, on a process of its own (fails at return event 0)."""
    bad = [{"process": 99, "type": "invoke", "f": "dequeue", "value": None},
           {"process": 99, "type": "ok", "f": "dequeue", "value": 99}]
    return RefHistory.wrap(bad + [dict(o) for o in h]).index()


def _fifo(n_processes, seed, n_ops=40, crash_p=0.05):
    return ref_histories.rand_fifo_history(
        n_ops=n_ops, n_processes=n_processes, n_values=3, crash_p=crash_p,
        seed=seed)


@pytest.mark.parametrize("dedupe", ["hash", "sort"])
def test_repadding_to_the_pending_keys(dedupe, tiers):
    """A wide key (C = 12) fails at its first event and so decides at the
    first tier; the two narrower keys overflow capacity 64 and run again
    padded to their own C and R (7 and their longest), as the reference
    re-pads (`pad_batch` over the pending keys only). The candidate
    index n*C + j places rows in the table, so C matters."""
    hs = [_fails_first(_fifo(12, 1, n_ops=30, crash_p=0.3)),
          _fifo(5, 0), _fifo(4, 2)]
    pre = [ref_enc.encode(ref_models.FIFOQueue(), h) for h in hs]
    ppre = [_to_port(e) for e in pre]
    got = engine._check_batch_sparse(ppre, 64, 1 << 12,
                                     dedupe=dedupe, device=CPU)
    want = ref_engine._check_batch_sparse(None, pre, 64, 1 << 12,
                                          dedupe=dedupe)
    assert _strip(got) == want
    C = [e.slot_f.shape[1] for e in ppre]
    R = [e.n_returns for e in ppre]
    assert C[0] > max(C[1:]) and R[0] < max(R)
    assert want[0]["capacity"] == 64 and want[0]["fail-event"] == 0
    assert [r["capacity"] for r in want[1:]] == [128, 128]
    assert tiers == [(3, 64, max(C), max(R), tiers[0][4]),
                     (2, 128, max(C[1:]), max(R[1:]), tiers[1][4])]


@pytest.mark.parametrize("dedupe", ["hash", "sort"])
def test_failed_keys_and_keys_shorter_than_the_batch(dedupe, tiers):
    """Keys that fail (their fail-event and op), and keys with fewer
    events than the batch's R: pad events do not run and leave each
    key's max-frontier, configs-stepped and capacity as the reference's
    batch gives them."""
    hs = [_fifo(5, 3), ref_histories.corrupt_history(_fifo(5, 0), seed=2),
          _fifo(3, 0, n_ops=12), _fails_first(_fifo(3, 1)),
          ref_histories.corrupt_history(_fifo(3, 2), seed=5)]
    pre = [ref_enc.encode(ref_models.FIFOQueue(), h) for h in hs]
    ppre = [_to_port(e) for e in pre]
    got = engine._check_batch_sparse(ppre, 64, 1 << 12,
                                     dedupe=dedupe, device=CPU)
    want = ref_engine._check_batch_sparse(None, pre, 64, 1 << 12,
                                          dedupe=dedupe)
    assert _strip(got) == want
    R = max(e.n_returns for e in ppre)
    assert tiers[0][:4] == (len(hs), 64,
                            max(e.slot_f.shape[1] for e in ppre), R)
    assert min(e.n_returns for e in ppre) < R // 2
    bad = [i for i, r in enumerate(want) if r["valid?"] is False]
    assert len(bad) >= 2 and all("op" in want[i] and "fail-event" in want[i]
                                 for i in bad)


# ---------------------------------------- entry points, flags, the card

def _keyed(per_key: dict, kv):
    out = []
    lists = [[dict(o, process=o["process"] + 100 * i,
                   value=kv(k, o.get("value"))) for o in h]
             for i, (k, h) in enumerate(per_key.items())]
    for j in range(max(map(len, lists))):
        out += [ops[j] for ops in lists if j < len(ops)]
    return out


@pytest.mark.parametrize("model", ["FIFOQueue", "UnorderedQueue"])
def test_independent_over_keyed_queue_histories(model, monkeypatch):
    """`independent.checker(linearizable(model))` over a keyed history
    whose keys need the sparse batch (S > 128), one of them invalid,
    against the reference's independent ("jax" arm, under dedupe "hash",
    the port's default)."""
    monkeypatch.setenv("JEPSEN_TPU_DEDUPE", "hash")
    monkeypatch.delenv("JEPSEN_TPU_TORCH_DEDUPE", raising=False)
    gen = (ref_histories.rand_fifo_history if model == "FIFOQueue"
           else ref_histories.rand_queue_history)
    per_key = {}
    for k in range(5):
        h = gen(n_ops=30, n_processes=5, n_values=3, crash_p=0.08, seed=k)
        if k == 3:
            h = ref_histories.corrupt_history(h, seed=1)
        per_key[f"q{k}"] = [{f: o.get(f) for f in ("process", "type", "f",
                                                   "value")} for o in h]
    ref_h = RefHistory.wrap(_keyed(per_key, ref_independent.KV)).index()
    port_h = History.wrap(_keyed(per_key, independent.KV)).index()
    want = ref_independent.checker(ref_linearizable(
        getattr(ref_models, model)(), algorithm="jax")).check({}, ref_h)
    got = independent.checker(linearizable(
        getattr(models, model)(), algorithm="torch", device=CPU)).check(
            {}, port_h)
    assert got["valid?"] == want["valid?"] is False
    assert got["failures"] == want["failures"] == ["q3"]
    assert list(got["results"]) == list(want["results"])
    for k, w in want["results"].items():
        g = got["results"][k]
        assert g["analyzer"] == "torch" and w["analyzer"] == "jax"
        assert {f: v for f, v in g.items() if f not in ("analyzer",
                                                        "closure")} \
            == {f: v for f, v in w.items() if f not in ("analyzer",
                                                        "closure")}
    assert {r["capacity"] for r in got["results"].values()} != {None}
    assert "device-fallback" not in got


def test_unknown_dedupe_raises_before_anything_runs(monkeypatch):
    """As the reference: an unknown dedupe raises ValueError on an empty
    batch too, from the argument or from the flag."""
    m = models.FIFOQueue()
    for call in (engine.check_batch, engine.check_batch_encoded):
        with pytest.raises(ValueError, match="dedupe"):
            call(m, [], dedupe="bogus")
    monkeypatch.setenv("JEPSEN_TPU_TORCH_DEDUPE", "bogus")
    with pytest.raises(ValueError, match="dedupe"):
        engine.check_batch(m, [])
    with pytest.raises(ValueError, match="dedupe"):
        ref_engine.check_batch(ref_models.FIFOQueue(), [], dedupe="bogus")


def test_sparse_batch_needs_a_device_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    encs = [_to_port(ref_enc.encode(ref_models.FIFOQueue(), h))
            for h in _fifo_escalation_keys()]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparse.check_batch_sparse(encs, escalate=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.check_batch_encoded(None, encs)
