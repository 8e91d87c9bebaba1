"""Query lifecycle subsystem of the port: admission control, deadlines
and cancellation, tenants, in-flight visibility and warmup.

- ``sched.context`` — QueryContext (id, deadline, cancel flag, stage
  timings) and its thread-local propagation into layers that do not
  take a ctx argument (the device dispatch in parallel.mesh, the slab
  packing in parallel.residency).
- ``sched.admission`` — the weighted (read/write/admin) bounded queue
  in front of the executor with a second, per-tenant stride level;
  overflow surfaces as HTTP 429.
- ``sched.tenants`` — the tenant (= index) as a scheduling and
  accounting principal: weights, concurrency caps, queue quotas,
  cost ceilings with a decaying penalty box.
- ``sched.registry`` — in-flight query visibility (/debug/queries),
  cancellation, and the slow-query log.
- ``sched.warmup`` — build and load the kernels and launch each kernel
  entry once at server open.

Copies of the JAX package's ``sched/`` modules (one node: no cluster
broadcast of a cancel or a kill).
"""

from .admission import (AdmissionController, AdmissionFullError,  # noqa: F401
                        Slot)
from .context import (DEADLINE_HEADER, LANE_ADMIN, LANE_READ,  # noqa: F401
                      LANE_WRITE, LANES, QUERY_ID_HEADER, TENANT_HEADER,
                      QueryContext, check_current, current, use)
from .registry import QueryRegistry  # noqa: F401
from .tenants import (DEFAULT_TENANT, KILL_POLICY,  # noqa: F401
                      KILLED_BY_HEADER, TenantPolicy, TenantRegistry)
