"""The port's resilience layer: the circuit breakers and their registry
(``resilience.breaker``; the fleet supervisor runs one per replica, and
/healthz reads the registry). A trimmed copy of `jepsen_tpu.resilience`:
its fault injector, dispatch supervisor and host recovery are not
ported (a device fault surfaces to the caller). Import-safe: no torch at
module scope."""

from jepsen_tpu_torch.resilience.breaker import CircuitBreaker  # noqa: F401
