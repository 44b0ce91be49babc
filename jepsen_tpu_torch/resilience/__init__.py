"""The port's resilience layer: the circuit breaker the fleet
supervisor runs per replica (``resilience.breaker``). A trimmed copy of
`jepsen_tpu.resilience`: its fault injector, dispatch supervisor,
breaker registry and host recovery are not ported (a device fault
surfaces to the caller). Import-safe: no torch at module scope."""

from jepsen_tpu_torch.resilience.breaker import CircuitBreaker  # noqa: F401
