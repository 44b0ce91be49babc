"""The streaming checker service over the port's sessions: a
long-lived, crash-safe front over the incremental extension engine
(``jepsen_tpu_torch.parallel.extend``) — per-key history deltas in,
online verdicts out, with backpressure, load shedding, idle-frontier
eviction, WAL replay, tenant-isolated weighted-fair admission
(``serve.tenancy``), the JSONL stdio transport (``serve.stdio``) and an
asyncio HTTP delta ingress (``serve.ingress``). A port of
`jepsen_tpu.serve`; ``python -m jepsen_tpu_torch.serve`` runs it on the
card. Not ported yet: the reference's replica ring and fleet layer
(``serve.ring``, ``serve.fleet``) and its observability surface."""

from jepsen_tpu_torch.serve.service import (  # noqa: F401
    CheckerService, default_wal_dir,
)
from jepsen_tpu_torch.serve.tenancy import (  # noqa: F401
    DEFAULT_TENANT, Tenant, TenantSpecError, TenantTable,
    parse_tenants, resolve_tenants,
)
from jepsen_tpu_torch.serve.wal import (  # noqa: F401
    CheckpointStore, DeltaWAL, WALError,
)
