"""The port's telemetry core (jepsen_tpu_torch.obs) against the
reference's (jepsen_tpu.obs).

* The tracer's contracts, as the reference's tests state them: off,
  ``span()`` is the process-wide no-op singleton, under 2 us of CPU a
  call with nothing retained; spans nest through the contextvar and
  ``ctx_runner``; ``timer`` measures with tracing off; the flags parse
  through the port's validated accessors.
* The registry: histogram snapshots, deltas and ``hist_quantile``
  equal to the reference's on the same observations; ``labeled`` and
  ``split_labels``; ``/metrics`` text with histograms equal to the
  reference's renderer.
* The exporters: the Chrome trace and JSONL shapes equal to the
  reference's for the same spans, ``export_run``'s per-run deltas and
  numbered flag exports, the search-stats and slow-delta collectors, the
  flight recorder's dump.
* The ``torch.profiler`` bridge on the CPU: one capture directory, the
  annotation in it.
* Engine counters and nesting in the port's pipelined batch, and results
  bit-identical with tracing on and off for every packable family.
"""

import json
import os
import sys
import threading
import tracemalloc
from time import process_time

import pytest
import torch

from jepsen_tpu import obs as ref_obs
from jepsen_tpu.obs import httpd as ref_httpd
from jepsen_tpu_torch import envflags, histories, obs
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import (CASRegister, FIFOQueue, GSet, Mutex,
                                     UnorderedQueue)
from jepsen_tpu_torch.obs import httpd
from torch_jax_cache import release_compiled_programs  # noqa: F401

CPU = "cpu"
FLAGS = ("JEPSEN_TPU_TORCH_TRACE", "JEPSEN_TPU_TORCH_PROFILE",
         "JEPSEN_TPU_TORCH_FLIGHT_RECORDER", "JEPSEN_TPU_TORCH_SEARCH_STATS")


def _export_mod():
    return sys.modules["jepsen_tpu_torch.obs.export"]


@pytest.fixture(autouse=True)
def _clean_obs(monkeypatch):
    """Every test starts from the flags' state (all unset) and leaves no
    tracer, no collected records and no export baseline behind."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for f in FLAGS:
        monkeypatch.delenv(f, raising=False)
    obs.reset()
    obs.drain_search_stats()
    obs.drain_slow_deltas()
    obs.flight_reset()
    _export_mod()._last_reg_snapshot = {}
    yield
    obs.reset()
    obs.drain_search_stats()
    obs.drain_slow_deltas()
    obs.flight_reset()
    _export_mod()._last_reg_snapshot = {}
    torch.set_num_threads(n)


def _h(*ops):
    return History.wrap(ops).index()


def invoke_op(p, f, v):
    return {"process": p, "type": "invoke", "f": f, "value": v}


def ok_op(p, f, v):
    return {"process": p, "type": "ok", "f": f, "value": v}


def _families():
    """(model, histories) per packable family, clean and corrupted keys
    (the reference's test_obs set)."""
    reg = [histories.rand_register_history(n_ops=30, n_processes=4,
                                           crash_p=0.05, fail_p=0.05, seed=s)
           for s in range(4)]
    reg[2] = histories.corrupt_history(reg[2], seed=3, n_corruptions=2)
    gset = [histories.rand_gset_history(n_ops=24, n_processes=4,
                                        n_elements=5, crash_p=0.06,
                                        seed=s + 70) for s in range(3)]
    uq = [histories.rand_queue_history(n_ops=24, n_processes=4, n_values=3,
                                       crash_p=0.06, seed=s + 80)
          for s in range(3)]
    fifo = [histories.rand_fifo_history(n_ops=24, n_processes=4, n_values=3,
                                        crash_p=0.15, seed=s + 90)
            for s in range(3)]
    mutex = [_h(invoke_op(0, "acquire", None), ok_op(0, "acquire", None),
                invoke_op(1, "acquire", None), ok_op(1, "acquire", None))]
    return [(CASRegister(), reg), (GSet(), gset), (UnorderedQueue(), uq),
            (FIFOQueue(), fifo), (Mutex(), mutex)]


# ------------------------------------------------- disabled = no-op


def test_disabled_span_is_singleton_noop():
    assert not obs.enabled() and obs.tracer() is None
    s1 = obs.span("a")
    s2 = obs.span("b", key=1)
    assert s1 is s2, "a disabled span() must be the no-op singleton"
    with s1 as s:
        s.set(anything=True)
    assert s1.wall == 0.0 and s1.cpu == 0.0
    obs.counter_sample("x", 1)                 # a no-op too
    assert obs.tracer() is None


def test_disabled_span_cpu_budget_and_zero_allocations():
    """Off, span() costs under 2 us of CPU a call and retains nothing
    inside the tracer module (process_time: insensitive to load)."""
    N = 200_000
    for _ in range(1000):
        obs.span("warm")
    c0 = process_time()
    for _ in range(N):
        with obs.span("hot"):
            pass
    cpu = process_time() - c0
    assert cpu / N < 2e-6, f"{cpu / N * 1e9:.0f} ns a disabled span"

    trmod = sys.modules["jepsen_tpu_torch.obs.tracer"]
    tracemalloc.start()
    before = tracemalloc.take_snapshot()
    for _ in range(50_000):
        with obs.span("hot"):
            pass
    after = tracemalloc.take_snapshot()
    tracemalloc.stop()
    flt = (tracemalloc.Filter(True, trmod.__file__),)
    growth = sum(st.size_diff for st in
                 after.filter_traces(flt).compare_to(
                     before.filter_traces(flt), "filename"))
    assert growth <= 0, f"obs retained {growth} bytes over 50k no-ops"


def test_timer_measures_even_when_disabled():
    with obs.timer("t", shape="x") as tm:
        sum(range(50_000))
    assert tm.wall > 0
    assert obs.tracer() is None


# ------------------------------------------------- span mechanics


def test_span_nesting_and_timer_identity():
    tr = obs.configure(True)
    with obs.span("outer", a=1) as o:
        with obs.span("inner") as i:
            assert obs.current_span() is i
    assert i.parent == o.sid and o.parent is None
    assert obs.current_span() is None
    with obs.timer("measured") as tm:
        pass
    assert tm in tr.spans()
    rec = [s for s in tr.spans() if s.name == "measured"][0]
    assert rec.t0 == tm.t0 and rec.t1 == tm.t1


def test_ctx_runner_propagates_across_threads():
    obs.configure(True)
    out = []
    with obs.span("root") as root:
        wrap = obs.ctx_runner()

        def work(k):
            with obs.span("child", key=k) as c:
                out.append(c)

        ts = [threading.Thread(target=wrap(work), args=(k,))
              for k in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    assert len(out) == 4
    assert all(c.parent == root.sid for c in out)
    obs.reset()
    fn = object()
    assert obs.ctx_runner()(fn) is fn        # off: the identity wrap


def test_flag_gating_and_env_path_accessor(monkeypatch):
    assert set(envflags.TELEMETRY_FLAGS) == {
        "JEPSEN_TPU_TORCH_TRACE", "JEPSEN_TPU_TORCH_PROFILE",
        "JEPSEN_TPU_TORCH_FLIGHT_RECORDER"}
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TRACE", "0")
    obs.reset()
    assert not obs.enabled()
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TRACE", "1")
    obs.reset()
    assert obs.enabled() and obs.tracer().path == ""
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TRACE", "/tmp/t.json")
    obs.reset()
    assert obs.tracer().path == "/tmp/t.json"
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TRACE", "  ")
    obs.reset()
    with pytest.raises(envflags.EnvFlagError, match="TRACE"):
        obs.enabled()
    monkeypatch.delenv("JEPSEN_TPU_TORCH_TRACE")
    assert obs.torch_profile_dir() is None
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROFILE", "1")
    assert obs.torch_profile_dir() == "store/torch_profile"
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROFILE", "/tmp/prof")
    assert obs.torch_profile_dir() == "/tmp/prof"
    # the reference's flag does not reach the port, nor the port's it
    monkeypatch.delenv("JEPSEN_TPU_TORCH_PROFILE")
    monkeypatch.setenv("JEPSEN_TPU_TRACE", "1")
    obs.reset()
    assert not obs.enabled()


def test_flight_recorder_flag(monkeypatch):
    """1: the default ring of 256 spans, N >= 2 that many, alone a
    flight-only recorder that enabled() and export_run do not see."""
    monkeypatch.setenv("JEPSEN_TPU_TORCH_FLIGHT_RECORDER", "1")
    obs.reset()
    tr = obs.tracer()
    assert tr is not None and tr.flight_only and tr._ring.maxlen == 256
    assert not obs.enabled() and obs.flight_active()
    monkeypatch.setenv("JEPSEN_TPU_TORCH_FLIGHT_RECORDER", "7")
    obs.reset()
    assert obs.tracer()._ring.maxlen == 7
    monkeypatch.setenv("JEPSEN_TPU_TORCH_TRACE", "1")
    obs.reset()
    assert obs.enabled() and obs.flight_active()
    for bad in ("-1", "x"):
        monkeypatch.setenv("JEPSEN_TPU_TORCH_FLIGHT_RECORDER", bad)
        obs.reset()
        with pytest.raises(envflags.EnvFlagError, match="FLIGHT"):
            obs.tracer()


# ------------------------------------------------- metrics registry


def test_registry_counter_gauge_histogram_and_delta():
    reg = obs.Registry()
    reg.counter("a.b").inc()
    reg.counter("a.b").inc(4)
    g = reg.gauge("depth")
    g.set(3)
    g.set(1)
    reg.histogram("secs").observe(0.5)
    reg.histogram("secs").observe(1.5)
    snap = reg.snapshot()
    assert snap["a.b"]["value"] == 5
    assert snap["depth"] == {"type": "gauge", "value": 1, "max": 3,
                             "nops": 2}
    assert snap["secs"]["count"] == 2 and snap["secs"]["mean"] == 1.0
    reg.counter("a.b").inc(2)
    d = reg.delta(snap)
    assert d["a.b"]["value"] == 2 and "depth" not in d
    with pytest.raises(TypeError):
        reg.gauge("a.b")
    with pytest.raises(TypeError):
        reg.histogram("depth")


def test_delta_windows_gauges_and_histograms():
    reg = obs.Registry()
    g = reg.gauge("depth")
    g.inc(5), g.dec(5)
    reg.histogram("secs").observe(2.0)
    before = reg.snapshot()
    d0 = reg.delta({})
    assert d0["depth"] == {"type": "gauge", "value": 0, "max": 5,
                           "nops": 2}
    assert d0["secs"]["min"] == d0["secs"]["max"] == 2.0
    g.inc(1), g.dec(1)
    reg.histogram("secs").observe(1.0)
    d = reg.delta(before)
    assert d["depth"] == {"type": "gauge", "value": 0, "max": None,
                          "nops": 2}
    secs = dict(d["secs"])
    buckets = dict(secs.pop("buckets"))
    assert buckets[1.0] == 1 and buckets[0.25] == 0 and buckets[60.0] == 1
    assert secs == {"type": "histogram", "count": 1, "total": 1.0,
                    "min": None, "max": None, "mean": 1.0}
    g.inc(9), g.dec(9)
    assert reg.delta(before)["depth"]["max"] == 9
    assert reg.delta(reg.snapshot()) == {}


# one window's observations (seconds), then another's: ladder edges,
# values between and past them, zero and repeats
OBSERVATIONS = {
    "edges": ([0.0001, 0.00025, 0.001, 0.0025, 0.01, 0.025, 0.1, 0.25, 1.0,
               2.5, 10.0, 60.0], [0.00025, 60.0]),
    "between": ([0.00005, 0.0003, 0.002, 0.2, 3.0, 9.99], [0.5, 0.5, 7.0]),
    "past-the-ladder": ([61.0, 120.5, 0.0], [1e3, 0.00001]),
    "seeded": (list(__import__("numpy").random.default_rng(17)
                    .lognormal(-4, 3, 300).round(9)),
               list(__import__("numpy").random.default_rng(18)
                    .lognormal(-2, 2, 120).round(9))),
}
QUANTILES = (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0)


@pytest.mark.parametrize("case", sorted(OBSERVATIONS))
def test_histogram_snapshot_delta_quantile_equal_reference(case):
    first, second = OBSERVATIONS[case]
    port, ref = obs.Registry(), ref_obs.Registry()
    for reg in (port, ref):
        for v in first:
            reg.histogram("serve.ack_secs").observe(float(v))
        reg.counter("serve.deltas").inc(len(first))
    p0, r0 = port.snapshot(), ref.snapshot()
    assert p0 == r0
    for reg in (port, ref):
        for v in second:
            reg.histogram("serve.ack_secs").observe(float(v))
            reg.histogram(obs.labeled("serve.ack_secs", tenant="a")) \
                .observe(float(v))
    assert port.snapshot() == ref.snapshot()
    pd, rd = port.delta(p0), ref.delta(r0)
    assert pd == rd
    for snap in (p0["serve.ack_secs"], pd["serve.ack_secs"], {}):
        for q in QUANTILES:
            assert obs.hist_quantile(snap, q) == \
                ref_obs.hist_quantile(snap, q), (q, snap)
    assert obs.BUCKET_LADDER == ref_obs.BUCKET_LADDER


@pytest.mark.parametrize("name,labels", [
    ("serve.ack_secs", {}), ("serve.ack_secs", {"tenant": "alice"}),
    ("elastic.ewma_cost", {"cohort": "3"}),
    ("x", {"b": "2", "a": "1", "c": "v:1.2-x"})])
def test_labeled_and_split_labels_equal_reference(name, labels):
    lab = obs.labeled(name, **labels)
    assert lab == ref_obs.labeled(name, **labels)
    assert obs.split_labels(lab) == ref_obs.split_labels(lab) \
        == (name, labels)
    for odd in ("a]", "a[b]", "a[=]", "plain"):
        assert obs.split_labels(odd) == ref_obs.split_labels(odd)


def test_render_prometheus_histograms_equal_reference():
    """/metrics with histograms (plain and labeled), counters and gauges
    is the reference's text, byte for byte."""
    port, ref = obs.Registry(), ref_obs.Registry()
    for reg, lab in ((port, obs.labeled), (ref, ref_obs.labeled)):
        for v in (0.0002, 0.3, 0.3, 70.0):
            reg.histogram("pipeline.encode_secs").observe(v)
            reg.histogram(lab("serve.ack_secs", tenant="bob")).observe(v)
        reg.histogram(lab("serve.ack_secs", tenant='q"x')).observe(1.5)
        reg.counter("pipeline.keys").inc(3)
        reg.gauge(lab("elastic.ewma_cost", cohort="0")).set(2.5)
    text = httpd.render_prometheus(port.snapshot())
    assert text == ref_httpd.render_prometheus(ref.snapshot())
    assert 'jepsen_pipeline_encode_secs_bucket{le="+Inf"} 4' in text
    assert 'jepsen_serve_ack_secs_bucket{tenant="bob",le="0.25"} 1' in text
    assert "jepsen_pipeline_encode_secs_count 4" in text
    assert "# TYPE jepsen_pipeline_encode_secs histogram" in text
    assert "jepsen_pipeline_encode_secs_max 70.0" in text


# ------------------------------------------------- exporters


def _spans_both():
    """The same synthetic spans in each package's tracer."""
    out = []
    for pkg in (obs, ref_obs):
        tr = pkg.configure(True)
        with pkg.span("pipeline.run", keys=2, bucket="tier"):
            with pkg.span("pipeline.dispatch", tier=8, chunk=0, keys=2):
                pass
            pkg.counter_sample("pipeline.inflight", 1)
        tr.add_span("device.search", tr.epoch + 0.5, tr.epoch + 0.75,
                    track="bucket-8", chunk=0, keys=2, engine="bitdense")
        out.append(tr)
        pkg.reset()
    return out


def _shape(events):
    """A Chrome-trace array without its clock and thread values."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur")}
        if e.get("pid") == 1 and "tid" in e and e.get("ph") != "C":
            e["tid"] = "host-thread"
        args = dict(e.get("args") or {})
        args.pop("cpu_secs", None)
        if e.get("name") == "trace_epoch":
            args = {}
        if e.get("name") == "thread_name" and e.get("pid") == 1:
            args = {"name": "host-thread-name"}
        e["args"] = args
        out.append(e)
    return out


def test_chrome_trace_and_jsonl_shapes_equal_reference():
    port_tr, ref_tr = _spans_both()
    pe, re_ = obs.chrome_trace(port_tr), ref_obs.chrome_trace(ref_tr)
    assert _shape(pe) == _shape(re_)
    assert {e["ph"] for e in pe} == {"X", "M", "C"}
    dev = [e for e in pe if e.get("name") == "device.search"][0]
    assert dev["pid"] == 2 and dev["ts"] == 500000.0 and dev["dur"] == 250000.0
    epoch = [e for e in pe if e.get("name") == "trace_epoch"][0]
    assert epoch["args"]["unix"] == round(port_tr.epoch_unix, 6)

    def line_shape(ln):
        return {k: v for k, v in ln.items()
                if k not in ("t0", "wall", "cpu", "tid", "thread")}

    pl = obs.jsonl_events(port_tr, snap={})
    rl = ref_obs.jsonl_events(ref_tr, snap={})
    assert [line_shape(x) for x in pl] == [line_shape(x) for x in rl]
    assert obs.chrome_trace(None) == [] == obs.jsonl_events(None, snap={})


def test_summary_equals_reference():
    port, ref = obs.Registry(), ref_obs.Registry()
    for reg in (port, ref):
        reg.counter("engine.configs_stepped").inc(12)
        reg.gauge("pipeline.inflight").set(2)
        reg.histogram("pipeline.encode_secs").observe(0.5)
    assert obs.summary(None, port) == ref_obs.summary(None, ref)
    port_tr, _ = _spans_both()
    text = obs.summary(port_tr, snap={})
    assert text.splitlines()[0].split() == ["span", "count", "total_s",
                                            "mean_ms", "cpu_s"]
    assert "pipeline.dispatch" in text and "device.search" in text


def test_export_run_noop_when_disabled(tmp_path):
    assert obs.export_run(str(tmp_path)) is None
    assert not os.path.exists(tmp_path / "telemetry.jsonl")
    # the search-stats records are their own opt-in: they land alone
    obs.record_search_stats({"events": 1, "key": 0})
    arts = obs.export_run(str(tmp_path))
    assert set(arts) == {"search_stats"}
    assert [json.loads(ln) for ln in open(arts["search_stats"])] == \
        [{"events": 1, "key": 0}]


def test_export_run_is_per_run_with_numbered_flag_exports(tmp_path):
    tr = obs.configure(True, path=str(tmp_path / "flag_trace.json"))
    g = obs.gauge("pipeline.test_inflight")
    with obs.span("run.one"):
        pass
    obs.counter("engine.test_counter").inc(5)
    g.inc(5), g.dec(5)
    obs.histogram("engine.test_secs").observe(2.0)
    a1 = obs.export_run(str(tmp_path / "r1"))
    with obs.span("run.two"):
        pass
    obs.counter("engine.test_counter").inc(2)
    g.inc(1), g.dec(1)
    obs.histogram("engine.test_secs").observe(1.0)
    a2 = obs.export_run(str(tmp_path / "r2"))
    assert set(a1) == {"jsonl", "trace", "summary", "flag_trace"}
    assert a1["flag_trace"] == str(tmp_path / "flag_trace.json")
    assert a2["flag_trace"] == str(tmp_path / "flag_trace.2.json")
    assert json.load(open(a1["flag_trace"]))
    assert json.load(open(a2["trace"]))

    def load(d):
        return [json.loads(ln) for ln in
                open(os.path.join(str(tmp_path), d, "telemetry.jsonl"))]

    assert {ln["name"] for ln in load("r1") if ln["type"] == "span"} \
        == {"run.one"}
    assert {ln["name"] for ln in load("r2") if ln["type"] == "span"} \
        == {"run.two"}

    def metric(d, name):
        m = [ln for ln in load(d) if ln["type"] == "metric"
             and ln["name"] == name]
        return m[0] if m else None

    assert metric("r2", "engine.test_counter")["value"] == 2
    assert metric("r1", "pipeline.test_inflight")["max"] == 5
    assert metric("r2", "pipeline.test_inflight")["max"] is None
    h2 = metric("r2", "engine.test_secs")
    assert h2["count"] == 1 and h2["total"] == 1.0
    assert h2["metric_type"] == "histogram"
    assert "run.two" in open(a2["summary"]).read()
    assert tr.spans() == []


def test_search_stats_collector_keeps_the_newest(monkeypatch):
    """Past the bound the oldest record goes, counted, as the
    reference's collector does."""
    exp = _export_mod()
    monkeypatch.setattr(exp, "SEARCH_STATS_MAX_RECORDS", 3)
    before = obs.registry().snapshot()
    for k in range(5):
        obs.record_search_stats({"key": k})
    assert [r["key"] for r in obs.search_stats_records()] == [2, 3, 4]
    assert obs.registry().delta(before)["obs.search_stats_dropped"] \
        == {"type": "counter", "value": 2}
    assert [r["key"] for r in obs.drain_search_stats()] == [2, 3, 4]
    assert obs.search_stats_records() == []


def test_slow_delta_ring_scopes_and_worst():
    assert obs.record_slow_delta({"total_secs": 2.0}, scope="a") is True
    assert obs.record_slow_delta({"total_secs": 1.0}, scope="a") is False
    assert obs.record_slow_delta({"total_secs": 1.5}, scope="b") is True
    assert [r["total_secs"] for r in obs.slow_delta_records("a")] \
        == [2.0, 1.0]
    assert len(obs.slow_delta_records()) == 3
    assert len(obs.drain_slow_deltas()) == 3
    assert obs.record_slow_delta({"total_secs": 0.5}, scope="a") is True


def test_flight_dump(tmp_path):
    assert obs.flight_dump("nothing-armed") is None
    obs.configure(True, ring=3, flight_only=True)
    assert not obs.enabled() and obs.flight_active()
    for k in range(5):
        with obs.span("serve.delta", k=k):
            pass
    obs.counter("serve.sheds").inc()
    obs.set_flight_dir(str(tmp_path))
    path = obs.flight_dump("shed storm!", context={"key": ("k", 1)})
    assert path == str(tmp_path / "flight_shed-storm-_1.trace.json")
    doc = json.load(open(path))
    names = [e["args"]["k"] for e in doc["traceEvents"]
             if e.get("ph") == "X"]
    assert names == [2, 3, 4]
    assert doc["flight"]["reason"] == "shed storm!"
    assert doc["flight"]["metrics_delta"]["serve.sheds"]["value"] == 1
    assert doc["flight"]["trigger"] == {"key": ["k", 1]}
    assert obs.export_run(str(tmp_path / "run")) is None


# ------------------------------------------------- torch.profiler bridge


def test_profiler_bridge_off_is_a_noop():
    assert obs.torch_profile_dir() is None
    with obs.maybe_torch_profile() as p, obs.device_annotation("x") as a:
        assert p._inner is None and a._inner is None


def test_profiler_bridge_captures_the_annotation(tmp_path, monkeypatch):
    """With JEPSEN_TPU_TORCH_PROFILE=<dir> a check-sized block runs under
    one torch.profiler capture, written to <dir>, holding the launch
    annotation (on the CPU: the CPU activity)."""
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROFILE", str(tmp_path))
    with obs.maybe_torch_profile():
        with obs.device_annotation("bitdense single S6 C5"):
            torch.ones(64).cumsum(0)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1, files
    doc = json.load(open(tmp_path / files[0]))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "bitdense single S6 C5" in names


def test_profiler_bridge_joins_an_open_capture(tmp_path, monkeypatch):
    """A check's capture site inside a capture already open (a caller's
    around several checks) opens no second profiler: one capture holds
    both annotations."""
    monkeypatch.setenv("JEPSEN_TPU_TORCH_PROFILE", str(tmp_path))
    with obs.maybe_torch_profile() as outer:
        with obs.maybe_torch_profile() as inner:
            with obs.device_annotation("sparse K2 N512 C8"):
                torch.ones(64).cumsum(0)
        with obs.device_annotation("sharded N64 D1"):
            torch.ones(64).cumsum(0)
    assert outer._inner is not inner._inner
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1, files
    names = {e.get("name") for e in
             json.load(open(tmp_path / files[0]))["traceEvents"]}
    assert {"sparse K2 N512 C8", "sharded N64 D1"} <= names


def test_capture_correlates_kernels_by_correlation_id():
    """A kernel is tied to the annotation around its launch call on the
    launching thread through the correlation id, whatever the launch
    call's name (cluster and cooperative launches)."""
    from jepsen_tpu_torch.obs import capture

    ev = [{"cat": "user_annotation", "name": "bitdense K4 S6 C5",
           "pid": 1, "tid": 7, "ts": 100, "dur": 50},
          {"cat": "user_annotation", "name": "sharded N64 D1",
           "pid": 1, "tid": 7, "ts": 200, "dur": 50},
          {"cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
           "pid": 1, "tid": 7, "ts": 110, "args": {"correlation": 5}},
          {"cat": "cuda_runtime", "name": "cudaLaunchCooperativeKernel",
           "pid": 1, "tid": 7, "ts": 210, "args": {"correlation": 6}},
          {"cat": "cuda_driver", "name": "cuLaunchKernel",
           "pid": 1, "tid": 7, "ts": 300, "args": {"correlation": 7}},
          {"cat": "kernel", "name": "void k3_grid_insert<1>(Args)",
           "ts": 230, "args": {"correlation": 6}},
          {"cat": "kernel", "name": "void closure_scan_split<2>(int*)",
           "ts": 120, "args": {"correlation": 5}},
          {"cat": "kernel", "name": "frontier_closure_kernel<true>",
           "ts": 320, "args": {"correlation": 7}},
          {"cat": "kernel", "name": "void at::native::fill_kernel",
           "ts": 130, "args": {"correlation": 8}}]
    got = capture.kernel_annotations({"traceEvents": ev})
    assert [(r["kernel"], r["annotation"]) for r in got] == [
        ("K1", "bitdense K4 S6 C5"), ("K3", "sharded N64 D1"),
        ("K2", None)]
    assert capture.port_kernel("k4_prep") == "K4"


# ------------------------------------------------- engines


def test_engine_false_invalid_counter(monkeypatch):
    from jepsen_tpu_torch.checker import wgl
    from jepsen_tpu_torch.parallel import encode as enc_mod, engine

    e = enc_mod.encode(CASRegister(),
                       _h(invoke_op(0, "write", 1), ok_op(0, "write", 1),
                          invoke_op(1, "read", None), ok_op(1, "read", 1)))
    monkeypatch.setattr(wgl, "check_calls",
                        lambda *a, **k: {"valid?": True})
    before = obs.registry().snapshot()
    r = engine._disagreement_recheck(CASRegister(), e, "test note")
    assert r["valid?"] is True
    assert obs.registry().delta(before)["engine.false_invalid"]["value"] == 1


def test_engine_capacity_escalation_counter():
    from jepsen_tpu_torch.parallel import encode as enc_mod, sparse

    e = enc_mod.encode(CASRegister(), histories.adversarial_register_history(
        n_ops=120, k_crashed=8, seed=7))
    before = obs.registry().snapshot()
    r = sparse.check_encoded(e, capacity=64, max_capacity=1 << 16,
                             device=CPU, dedupe="hash")
    assert r["valid?"] is True and r["capacity"] > 64
    d = obs.registry().delta(before)
    assert d["engine.capacity_escalations"]["value"] >= 1
    assert d["engine.configs_stepped"]["value"] == r["configs-stepped"]


def test_span_nesting_in_the_pipelined_batch():
    """The port runs the pipeline's encodes on its own thread: every
    prepare and encode span still hangs off pipeline.run, every chunk
    has its dispatch, finalize and device.search spans."""
    from jepsen_tpu_torch.parallel import pipeline as pipe

    tr = obs.configure(True)
    hs = [histories.rand_register_history(n_ops=30, n_processes=4,
                                          crash_p=0.04, seed=900 + s)
          for s in range(6)]
    before = obs.registry().snapshot()
    stats: dict = {}
    pipe.check_batch_pipelined(CASRegister(), hs, cache=False, chunk_keys=2,
                               depth=2, device=CPU, stats=stats)
    tiers = {f"bucket-{b['tier']}" for b in stats["buckets"]}
    spans = {s.sid: s for s in tr.spans()}
    by_name: dict = {}
    for s in spans.values():
        by_name.setdefault(s.name, []).append(s)
    root = by_name["pipeline.run"][0]
    assert len(by_name["pipeline.run"]) == 1
    assert len(by_name["pipeline.prepare"]) == len(hs)
    assert len(by_name["pipeline.encode"]) == len(hs)
    for s in by_name["pipeline.prepare"] + by_name["pipeline.encode"] \
            + by_name["pipeline.dispatch"] + by_name["pipeline.finalize"]:
        assert spans[s.parent] is root, (s.name, s.args)
    n_chunks = len(by_name["pipeline.dispatch"])
    assert n_chunks == sum(b["chunks"] for b in stats["buckets"]) >= 3
    assert len(by_name["pipeline.finalize"]) == n_chunks
    assert len(by_name["device.search"]) == n_chunks
    assert all(s.track in tiers and s.parent is None
               for s in by_name["device.search"])
    for s in by_name["bitdense.pad_place"]:
        assert spans[s.parent].name == "pipeline.dispatch"
    for s in by_name["bitdense.finalize"]:
        assert spans[s.parent].name == "pipeline.finalize"
    d = obs.registry().delta(before)
    assert d["pipeline.keys"]["value"] == len(hs)
    assert d["pipeline.chunks"]["value"] == n_chunks
    assert d["bitdense.dispatches"]["value"] == n_chunks
    assert d["pipeline.inflight"]["nops"] == 2 * n_chunks
    assert d["pipeline.encode_secs"]["count"] == len(stats["buckets"])
    events = obs.chrome_trace(tr)
    tracks = {e["args"]["name"] for e in events
              if e["ph"] == "M" and e["name"] == "thread_name"
              and e["pid"] == 2}
    assert tracks == tiers
    assert any(e["ph"] == "C" and e["name"] == "pipeline.inflight"
               for e in events)


@pytest.mark.parametrize("model,hs", _families(),
                         ids=lambda v: type(v).__name__
                         if not isinstance(v, list) else "")
def test_results_bit_identical_tracing_on_vs_off(model, hs):
    """Serial and pipelined check_batch results are the same dicts with
    tracing off, on, and off again, for every packable family."""
    from jepsen_tpu_torch.parallel import engine

    kw = dict(capacity=64, max_capacity=4096, device=CPU)
    assert not obs.enabled()
    rs_off = engine.check_batch(model, hs, **kw)
    rs_off_p = engine.check_batch(model, hs, pipeline=True, cache=False,
                                  **kw)
    obs.configure(True)
    rs_on = engine.check_batch(model, hs, **kw)
    rs_on_p = engine.check_batch(model, hs, pipeline=True, cache=False,
                                 **kw)
    obs.reset()
    assert rs_on == rs_off
    assert rs_on_p == rs_off_p == rs_off
