"""Tenant model for the multi-tenant streaming checker service.

A port of `jepsen_tpu.serve.tenancy`: the same grammar, quotas and
errors, read from the port's ``JEPSEN_TPU_TORCH_*`` flags. Without
tenants the service has one implicit producer population: any client
can fill the queue, the WAL, and the device, so one greedy producer is
a denial of service against every other. This module is the isolation
boundary the multi-tenant service admits through:

* a **tenant** is a named principal with an auth token, a scheduling
  weight, and three quotas — pending ops, keys, WAL bytes — all
  declared in one validated ``JEPSEN_TPU_TORCH_TENANTS`` spec (or passed
  programmatically);
* **admission** is weighted-fair: each tenant's pending-ops bound
  defaults to its weight share of the shed high-water, so a tenant
  flooding past its share is shed *immediately* with a structured
  ``{shed, reason, tenant}`` while every other tenant's deltas keep
  admitting and acking inside their SLO (the fairness pin in
  tests/test_torch_serve.py);
* **service order** is deficit round-robin (``serve.service``): per
  worker cycle every backlogged tenant banks ``weight x quantum`` ops
  of deficit and the batch takes whole deltas against it, so the
  device serves tenants proportionally to weight, not arrival order.

Spec grammar (comma-separated tenants, colon-separated fields)::

    JEPSEN_TPU_TORCH_TENANTS = <name>[:token=T][:weight=W][:ops=N]
                               [:keys=N][:wal=BYTES][,<tenant>...]

    name    [A-Za-z0-9_-]+ — the /status row key
    token   the ingress bearer token (required when the HTTP ingress
            authenticates; distinct per tenant)
    weight  integer >= 1 (default 1) — DRR share and the divisor for
            the derived pending-ops bound
    ops     pending-ops quota (default 0 = derive from weight share)
    keys    max concurrently admitted keys (default from
            JEPSEN_TPU_TORCH_TENANT_KEYS; 0 = unlimited)
    wal     WAL-bytes quota across the tenant's keys (default from
            JEPSEN_TPU_TORCH_TENANT_WAL_BYTES; 0 = unlimited)

Validation is strict: an unknown
field, a duplicate name or token, or a malformed number raises
:class:`TenantSpecError` (an ``envflags.EnvFlagError``) at the first
read — a typo'd tenant plan must never silently run un-isolated.

With no tenants configured the service runs single-tenant: one
implicit :data:`DEFAULT_TENANT` with unlimited quotas, no auth, FIFO
take order.

The module itself imports no torch and no engine (the ingress
authenticates against it while the device runtime may be wedged).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional

from jepsen_tpu_torch import envflags

#: the implicit single-tenant name when no tenant table is configured
DEFAULT_TENANT = "default"

_NAME_RE = re.compile(r"^[A-Za-z0-9_-]+$")

_FIELDS = ("token", "weight", "ops", "keys", "wal")


class TenantSpecError(envflags.EnvFlagError):
    """A JEPSEN_TPU_TORCH_TENANTS spec outside the grammar above."""


@dataclass(frozen=True)
class Tenant:
    """One tenant's declared identity, weight, and quotas (0 for a
    quota means "unlimited" / "derive" per the module docstring)."""

    name: str
    token: Optional[str] = None
    weight: int = 1
    max_pending_ops: int = 0
    max_keys: int = 0
    max_wal_bytes: int = 0


def _default_quota(flag: str, what: str) -> int:
    return envflags.env_int(flag, default=0, min_value=0, what=what) or 0


def _parse_int(part: str, field: str, val: str,
               min_value: int = 0) -> int:
    try:
        v = int(val)
    except ValueError:
        raise TenantSpecError(
            f"JEPSEN_TPU_TORCH_TENANTS tenant {part!r}: field {field}={val!r} "
            f"must be an integer")
    if v < min_value:
        raise TenantSpecError(
            f"JEPSEN_TPU_TORCH_TENANTS tenant {part!r}: field {field}={val!r} "
            f"must be >= {min_value}")
    return v


def parse_tenants(raw: str) -> List[Tenant]:
    """Parse a JEPSEN_TPU_TORCH_TENANTS value into tenants, strictly
    (module docstring grammar). Duplicate names or tokens raise — two
    tenants sharing a token would collapse the isolation boundary the
    table exists to draw."""
    default_keys = _default_quota("JEPSEN_TPU_TORCH_TENANT_KEYS",
                                  "default per-tenant key quota")
    default_wal = _default_quota("JEPSEN_TPU_TORCH_TENANT_WAL_BYTES",
                                 "default per-tenant WAL-bytes quota")
    default_ops = _default_quota("JEPSEN_TPU_TORCH_TENANT_OPS",
                                 "default per-tenant pending-ops quota")
    tenants: List[Tenant] = []
    names, tokens = set(), set()
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        name = fields[0].strip()
        if not _NAME_RE.match(name):
            raise TenantSpecError(
                f"JEPSEN_TPU_TORCH_TENANTS tenant {part!r}: name {name!r} "
                f"must match [A-Za-z0-9_-]+ (it becomes a metric "
                f"label and a /status row)")
        if name in names:
            raise TenantSpecError(
                f"JEPSEN_TPU_TORCH_TENANTS: duplicate tenant name {name!r}")
        names.add(name)
        kw = {"token": None, "weight": 1, "ops": default_ops,
              "keys": default_keys, "wal": default_wal}
        for f in fields[1:]:
            key, eq, val = f.partition("=")
            key = key.strip()
            if not eq or key not in _FIELDS:
                raise TenantSpecError(
                    f"JEPSEN_TPU_TORCH_TENANTS tenant {part!r}: unknown "
                    f"field {f!r} (expected one of "
                    f"{[k + '=' for k in _FIELDS]})")
            if key == "token":
                if not val:
                    raise TenantSpecError(
                        f"JEPSEN_TPU_TORCH_TENANTS tenant {part!r}: empty "
                        f"token")
                kw["token"] = val
            elif key == "weight":
                kw["weight"] = _parse_int(part, key, val, min_value=1)
            else:
                kw[key] = _parse_int(part, key, val, min_value=0)
        if kw["token"] is not None:
            if kw["token"] in tokens:
                raise TenantSpecError(
                    f"JEPSEN_TPU_TORCH_TENANTS: tenant {name!r} reuses "
                    f"another tenant's token — tokens must be "
                    f"distinct (they ARE the isolation boundary)")
            tokens.add(kw["token"])
        tenants.append(Tenant(name=name, token=kw["token"],
                              weight=kw["weight"],
                              max_pending_ops=kw["ops"],
                              max_keys=kw["keys"],
                              max_wal_bytes=kw["wal"]))
    return tenants


class TenantTable:
    """Immutable name -> :class:`Tenant` and token -> tenant lookups
    (shared by the service's admission layer and the HTTP ingress's
    auth check, so both answer identically)."""

    def __init__(self, tenants: List[Tenant]):
        if not tenants:
            raise TenantSpecError("a TenantTable needs >= 1 tenant")
        self._by_name: Dict[str, Tenant] = {}
        self._by_token: Dict[str, Tenant] = {}
        for t in tenants:
            if t.name in self._by_name:
                raise TenantSpecError(
                    f"duplicate tenant name {t.name!r}")
            self._by_name[t.name] = t
            if t.token is not None:
                if t.token in self._by_token:
                    raise TenantSpecError(
                        f"tenant {t.name!r} reuses another tenant's "
                        f"token")
                self._by_token[t.token] = t
        self.total_weight = sum(t.weight for t in tenants)

    def __len__(self) -> int:
        return len(self._by_name)

    def names(self) -> List[str]:
        return sorted(self._by_name)

    def get(self, name: str) -> Optional[Tenant]:
        return self._by_name.get(name)

    def by_token(self, token: str) -> Optional[Tenant]:
        return self._by_token.get(token)

    def pending_bound(self, name: str, budget: int) -> int:
        """The tenant's effective pending-ops bound: its explicit
        ``ops`` quota, else its weight share of ``budget`` (the shed
        high-water when shedding is on, else the global bound). The
        derived shares sum to <= budget, so no single tenant — nor all
        tenants flooding at once — can push the service past the
        global shed line: a quiet tenant's deltas are admitted by
        construction, not by luck."""
        t = self._by_name[name]
        if t.max_pending_ops:
            return t.max_pending_ops
        return max(1, (budget * t.weight) // max(1, self.total_weight))


def resolve_tenants() -> Optional[TenantTable]:
    """The process tenant table from ``JEPSEN_TPU_TORCH_TENANTS``, or
    None when unset/empty (single-tenant mode)."""
    raw = envflags.env_raw("JEPSEN_TPU_TORCH_TENANTS")
    if raw is None or not raw.strip():
        return None
    tenants = parse_tenants(raw)
    return TenantTable(tenants) if tenants else None


def resolve_quantum() -> int:
    """``JEPSEN_TPU_TORCH_TENANT_QUANTUM``: ops of deficit one weight
    unit banks per worker cycle (default 512, min 1)."""
    return envflags.env_int("JEPSEN_TPU_TORCH_TENANT_QUANTUM", default=512,
                            min_value=1, what="DRR quantum (ops)")
