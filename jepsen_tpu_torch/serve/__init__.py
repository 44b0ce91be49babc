"""The streaming checker service over the port's sessions: a
long-lived, crash-safe front over the incremental extension engine
(``jepsen_tpu_torch.parallel.extend``) — per-key history deltas in,
online verdicts out, with backpressure, load shedding, idle-frontier
eviction, WAL replay, tenant-isolated weighted-fair admission
(``serve.tenancy``), the JSONL stdio transport (``serve.stdio``), an
asyncio HTTP delta ingress (``serve.ingress``), consistent-hash replica
scale-out with freeze/thaw and WAL-segment key migration
(``serve.ring``), and the self-healing fleet layer — failure detection,
automatic re-homing, epoch-fenced ownership and WAL segment replication
(``serve.fleet``). A port of `jepsen_tpu.serve`; ``python -m
jepsen_tpu_torch.serve`` runs it on the card, with its ops endpoint
(``obs.httpd``) on ``--ops-port``. Not ported yet: the reference's
tracing, SLO and ledger surface."""

from jepsen_tpu_torch.serve.fleet import (  # noqa: F401
    FleetSupervisor, HttpReplica, SegmentReplicator,
)
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
