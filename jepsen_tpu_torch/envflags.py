"""Validated accessors for the port's ``JEPSEN_TPU_TORCH_*`` flags.

A trimmed copy of `jepsen_tpu.envflags`: the accessors the service
reads its flags with. A malformed value fails loudly at the read site,
naming the flag, instead of silently reverting a default. Names must
carry the ``JEPSEN_TPU_TORCH_`` prefix, so the port's flags stay apart
from the reference's ``JEPSEN_TPU_*`` ones.

The serve layer's flags (its queue bounds, WAL, tenants, ingress and
ops ports, WAL replication), the mesh executors' (STEAL, STEAL_ROUND,
RESHARD, and DIST with its three companions) and the device-health
ones (PROBE_INTERVAL, BREAKER_THRESHOLD, BREAKER_BACKOFF) and the
telemetry ones (TRACE, PROFILE, FLIGHT_RECORDER) go through these
accessors. The flags the
port read before this module existed (dedupe, probe limit, bucket,
config pack, search stats, pipeline) keep their own readers.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

PREFIX = "JEPSEN_TPU_TORCH_"

# The mesh executors' flags, each read strictly where it is used:
# STEAL and RESHARD (`env_bool`, engine._resolve_steal/_resolve_reshard),
# STEAL_ROUND (`env_int` >= 1, elastic._resolve_round_keys), DIST
# (`env_bool`) and its three required companions DIST_COORD (host:port),
# DIST_NPROC (>= 1) and DIST_PROC (in [0, NPROC)), meshplan.
# distributed_init.
MESH_FLAGS = tuple(PREFIX + n for n in (
    "STEAL", "STEAL_ROUND", "RESHARD", "DIST", "DIST_COORD", "DIST_NPROC",
    "DIST_PROC"))

# The device-health flags: PROBE_INTERVAL (`env_float` seconds >= 0,
# 0/unset = no watch; probe.start_watch_from_env), BREAKER_THRESHOLD
# (`env_int` >= 1, default 3) and BREAKER_BACKOFF (`env_float` seconds
# >= 0, default 1.0), the breaker's defaults (resilience.breaker).
HEALTH_FLAGS = tuple(PREFIX + n for n in (
    "PROBE_INTERVAL", "BREAKER_THRESHOLD", "BREAKER_BACKOFF"))

# The telemetry flags (obs.tracer): TRACE (`env_path`: unset/0 off, 1
# on, <path> on and the Chrome trace written there at export), PROFILE
# (`env_path`: the torch.profiler capture directory, 1 =
# store/torch_profile) and FLIGHT_RECORDER (`env_int` >= 0: 1 = a ring
# of the last 256 closed spans, N >= 2 that many).
TELEMETRY_FLAGS = tuple(PREFIX + n for n in (
    "TRACE", "PROFILE", "FLIGHT_RECORDER"))


class EnvFlagError(ValueError):
    """A JEPSEN_TPU_TORCH_* variable is set to a value outside its
    contract."""


def env_raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The raw string value of a prefixed flag (no validation beyond
    the namespace check). Prefer the typed accessors below."""
    if not name.startswith(PREFIX):
        raise EnvFlagError(
            f"{name!r} is not a {PREFIX}* flag: the accessor only serves "
            f"the jepsen_tpu_torch namespace")
    return os.environ.get(name, default)


def env_bool(name: str, default: Optional[bool] = None) -> Optional[bool]:
    """A strict tri-state boolean flag: unset -> ``default``, ``"1"`` ->
    True, ``"0"`` -> False; any other value raises
    :class:`EnvFlagError` instead of silently counting as off."""
    raw = env_raw(name)
    if raw is None:
        return default
    if raw == "1":
        return True
    if raw == "0":
        return False
    raise EnvFlagError(
        f"{name}={raw!r}: must be '1' (on) or '0' (off); unset the "
        f"variable to get the default")


def env_choice(name: str, choices: Sequence[str],
               default: Optional[str] = None,
               what: str = "value") -> Optional[str]:
    """A flag restricted to an explicit set of strings. Unset ->
    ``default``; anything outside ``choices`` raises
    :class:`EnvFlagError` naming ``what``."""
    raw = env_raw(name)
    if raw is None:
        return default
    if raw in choices:
        return raw
    raise EnvFlagError(
        f"{name}={raw!r}: unknown {what} (expected one of "
        f"{tuple(choices)})")


def env_int(name: str, default: Optional[int] = None,
            min_value: Optional[int] = None,
            what: str = "value") -> Optional[int]:
    """An integer flag. Unset -> ``default``; a non-integer value or
    one below ``min_value`` raises :class:`EnvFlagError`."""
    raw = env_raw(name)
    if raw is None:
        return default
    try:
        v = int(raw)
    except ValueError:
        raise EnvFlagError(
            f"{name}={raw!r}: must be an integer {what}; unset the "
            f"variable to get the default")
    if min_value is not None and v < min_value:
        raise EnvFlagError(
            f"{name}={raw!r}: {what} must be >= {min_value}")
    return v


def env_float(name: str, default: Optional[float] = None,
              min_value: Optional[float] = None,
              what: str = "value") -> Optional[float]:
    """A float flag (seconds-style knobs). Unset -> ``default``; a
    non-numeric, non-finite, or below-``min_value`` value raises
    :class:`EnvFlagError`."""
    raw = env_raw(name)
    if raw is None:
        return default
    try:
        v = float(raw)
    except ValueError:
        raise EnvFlagError(
            f"{name}={raw!r}: must be a number {what}; unset the "
            f"variable to get the default")
    if not math.isfinite(v):
        raise EnvFlagError(f"{name}={raw!r}: {what} must be finite")
    if min_value is not None and v < min_value:
        raise EnvFlagError(
            f"{name}={raw!r}: {what} must be >= {min_value}")
    return v


def env_path(name: str, what: str = "path") -> Optional[str]:
    """A tri-state destination flag: unset or ``"0"`` -> None (feature
    off), ``"1"`` -> ``""`` (on, the caller picks the destination),
    anything else -> that path. Whitespace-only values raise."""
    raw = env_raw(name)
    if raw is None or raw == "0":
        return None
    if raw == "1":
        return ""
    if not raw.strip():
        raise EnvFlagError(
            f"{name}={raw!r}: must be '0' (off), '1' (on, default "
            f"destination), or a {what}")
    return raw
