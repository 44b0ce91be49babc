"""The port's telemetry: the counter and gauge registry
(``obs.metrics``) and the ops endpoint over it (``obs.httpd``: import
it explicitly).

A trimmed copy of `jepsen_tpu.obs`: the fleet's counters and gauges
and the HTTP surface a supervisor polls. Spans, the tracer, flight
dumps, histograms, the SLO tracker and the decision ledger are not
ported. Import-safe: no torch, no device work — the ops surface must
answer while a replica's device is wedged.
"""

from jepsen_tpu_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Registry, counter, gauge, registry,
)
