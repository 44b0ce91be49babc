"""The port's telemetry: span tracing, metrics and their exporters.

A copy of `jepsen_tpu.obs`, under the reference's names:

  tracer    ``span("name", key=...)`` context managers — nested,
            contextvar-propagated (``ctx_runner`` carries the context
            into a worker), wall + process CPU time, gated by
            ``JEPSEN_TPU_TORCH_TRACE`` and a no-op singleton when off;
            ``timer`` always measures. The ``torch.profiler`` bridge
            (``JEPSEN_TPU_TORCH_PROFILE``: ``maybe_torch_profile``,
            ``device_annotation``) names the card's kernel launches so
            they line up with the host spans.
  metrics   counters / gauges / histograms under stable dotted names
            (``engine.configs_stepped``, ``pipeline.cache.hits``, ...),
            always on.
  export    Chrome trace-event JSON (Perfetto: one track per host
            thread, one per device bucket), JSONL, the end-of-run
            summary, the search-stats collector, the slow-delta ring and
            the flight recorder's dump (``JEPSEN_TPU_TORCH_FLIGHT_RECORDER``).
  httpd     the ops endpoint (import ``jepsen_tpu_torch.obs.httpd``
            explicitly): ``/metrics`` Prometheus text, ``/healthz``,
            ``/status`` and ``POST /adopt``.

Not here yet: the SLO tracker and the decision ledger.

Import-safe: no torch at import time, no device work — the probe's
parent and the ops surface must answer while a card is wedged.
"""

from jepsen_tpu_torch.obs.export import (  # noqa: F401
    chrome_trace, drain_search_stats, drain_slow_deltas, export_run,
    flight_dump, flight_reset, jsonl_events, record_search_stats,
    record_slow_delta, search_stats_records, set_flight_dir,
    slow_delta_records, summary, write_chrome_trace, write_jsonl,
    write_search_stats, write_slow_deltas,
)
from jepsen_tpu_torch.obs.metrics import (  # noqa: F401
    BUCKET_LADDER, Counter, Gauge, Histogram, Registry, counter, gauge,
    hist_quantile, histogram, labeled, registry, split_labels,
)
from jepsen_tpu_torch.obs.tracer import (  # noqa: F401
    Span, Tracer, configure, counter_sample, ctx_runner, current_span,
    device_annotation, enabled, flight_active, maybe_torch_profile,
    reset, span, timer, torch_profile_dir, tracer,
)
