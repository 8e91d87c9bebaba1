"""Multi-tenant QoS: the tenant as a first-class scheduling and
accounting principal.

A copy of the JAX package's ``sched/tenants.py``. A **tenant is an
index** unless the request names one in ``X-Pilosa-Tenant``. This
module turns that name into policy:

- **Weighted lanes** (sched.admission): within each read/write/admin
  lane, tenants schedule by stride over their configured weight.
  Per-tenant concurrency caps bound how many slots one tenant may hold;
  per-tenant queue quotas bound its waiters, and overflow 429s (with a
  per-tenant-lane Retry-After) only the offending tenant.
- **Slow-query kill policy** (``TenantRegistry.install`` →
  ``ctx.cost_policy``): per-tenant ceilings over the LIVE cost ledger
  (container-op units, device bytes, wall ms — obs.accounting) are
  checked at every cooperative checkpoint (``ctx.check()``). A breach
  cancels the query with ``killed_by`` set, so every layer raises
  QueryKilledError (HTTP 402 + ``X-Pilosa-Killed-By: cost-policy``).
- **Penalty box**: each kill adds 1 to a decaying score (half-life
  ``penalty_half_life_s``); the tenant's effective stride weight is
  demoted by ``2^-score`` and recovers automatically as the score
  decays.
- **Chargeback**: per-tenant roll-ups of the cost ledger and latency
  histograms (``pilosa_tenant_*``, bounded label set) and
  ``GET /debug/tenants``.

``kill_broadcast`` stays None on one node (the JAX server fans a kill
out to its peers there).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional

from ..errors import QueryKilledError
from ..obs import metrics as obs_metrics
from ..utils.config import DEFAULT_TENANT  # noqa: F401  (re-export)

KILLED_BY_HEADER = "X-Pilosa-Killed-By"
KILL_POLICY = "cost-policy"

# Built-in default policy: weight 1, no caps, no ceilings — exactly
# the pre-tenant behavior for every tenant until an operator says
# otherwise.
_DEFAULTS = {"weight": 1.0, "concurrency": 0, "queue_depth": 0,
             "max_container_ops": 0, "max_device_bytes": 0,
             "max_wall_s": 0.0, "cache_share": 1.0}

DEFAULT_PENALTY_HALF_LIFE_S = 30.0
# Scores below this read as "out of the box" (full weight restored,
# state dropped): 2^-0.05 demotes weight by ~3%, i.e. noise.
_PENALTY_FLOOR = 0.05

# TOML-form key aliases, so a registry built straight from a raw
# table (tests, embedders) means the same thing as one built from
# parse_tenant_table output. Unknown keys raise — a silently-ignored
# quota is an isolation hole, not a default.
_KEY_ALIASES = {"queue-depth": "queue_depth",
                "max-container-ops": "max_container_ops",
                "max-device-bytes": "max_device_bytes",
                "max-wall": "max_wall_s",
                "cache-share": "cache_share"}


class TenantPolicy:
    """One tenant's immutable QoS knobs (see _DEFAULTS for units:
    0 = unlimited everywhere; cache_share is the fraction of each
    result-cache budget this tenant may occupy)."""

    __slots__ = ("name", "weight", "concurrency", "queue_depth",
                 "max_container_ops", "max_device_bytes", "max_wall_s",
                 "cache_share")

    def __init__(self, name: str, entry: Optional[dict] = None,
                 base: Optional["TenantPolicy"] = None):
        self.name = name
        src = dict(_DEFAULTS)
        if base is not None:
            for k in _DEFAULTS:
                src[k] = getattr(base, k)
        for k, v in (entry or {}).items():
            k = _KEY_ALIASES.get(k, k)
            if k not in _DEFAULTS:
                raise ValueError(
                    f"tenant {name}: unknown policy key {k!r}")
            if k == "max_wall_s" and isinstance(v, str):
                from ..utils.config import parse_duration
                v = parse_duration(v)
            src[k] = v
        for k in _DEFAULTS:
            setattr(self, k, src[k])

    def has_ceilings(self) -> bool:
        return bool(self.max_container_ops or self.max_device_bytes
                    or self.max_wall_s)

    def to_json(self) -> dict:
        return {k: getattr(self, k) for k in _DEFAULTS}


class _TenantState:
    __slots__ = ("score", "stamp", "kills", "sheds")

    def __init__(self):
        self.score = 0.0
        self.stamp = time.monotonic()
        self.kills = 0
        self.sheds = 0


class TenantRegistry:
    """Tenant → policy resolution + penalty box + kill policy.

    ``table`` is utils.config.parse_tenant_table output ({name:
    normalized entry}); named tenants inherit unset knobs from the
    ``default`` entry, unknown tenants ride the default policy
    wholesale — but every tenant schedules as its OWN stride
    principal (two quiet tenants on the default policy still get
    separate queue positions and separate chargeback rows).

    ``kill_broadcast`` (set by the server once its broadcaster is up)
    fans a cost-policy kill cluster-wide via CancelQueryMessage.
    """

    def __init__(self, table: Optional[dict] = None,
                 penalty_half_life_s: float = DEFAULT_PENALTY_HALF_LIFE_S,
                 node: str = ""):
        table = dict(table or {})
        self._default = TenantPolicy(DEFAULT_TENANT,
                                     table.pop(DEFAULT_TENANT, None))
        self._policies = {name: TenantPolicy(name, entry,
                                             base=self._default)
                          for name, entry in table.items()}
        self.penalty_half_life_s = max(0.001, penalty_half_life_s)
        self.node = node
        self.kill_broadcast: Optional[Callable[[str], None]] = None
        self._mu = threading.Lock()
        self._state: dict[str, _TenantState] = {}

    # -- resolution ----------------------------------------------------------

    def resolve(self, tenant: str) -> str:
        return tenant or DEFAULT_TENANT

    def policy(self, tenant: str) -> TenantPolicy:
        return self._policies.get(self.resolve(tenant), self._default)

    def known(self) -> list[str]:
        return sorted([DEFAULT_TENANT, *self._policies])

    # -- penalty box ---------------------------------------------------------

    def _decayed_locked(self, st: _TenantState,
                        now: float) -> float:
        dt = now - st.stamp
        if dt > 0 and st.score:
            st.score *= math.pow(0.5, dt / self.penalty_half_life_s)
            st.stamp = now
            if st.score < _PENALTY_FLOOR:
                st.score = 0.0
        return st.score

    def penalty_score(self, tenant: str) -> float:
        tenant = self.resolve(tenant)
        now = time.monotonic()
        with self._mu:
            st = self._state.get(tenant)
            return self._decayed_locked(st, now) if st else 0.0

    def effective_weight(self, tenant: str) -> float:
        """The stride weight admission schedules this tenant at: the
        configured weight demoted by the decaying penalty score —
        2^-score, so one kill halves it and recovery is automatic."""
        base = self.policy(tenant).weight
        score = self.penalty_score(tenant)
        return base * math.pow(0.5, score) if score else base

    def note_kill(self, tenant: str) -> None:
        tenant = self.resolve(tenant)
        now = time.monotonic()
        with self._mu:
            st = self._state.setdefault(tenant, _TenantState())
            self._decayed_locked(st, now)
            st.score += 1.0
            st.kills += 1
            score = st.score
        obs_metrics.TENANT_KILLS.labels(tenant).inc()
        obs_metrics.TENANT_PENALTY.labels(tenant).set(round(score, 4))

    def note_shed(self, tenant: str, lane: str) -> None:
        tenant = self.resolve(tenant)
        with self._mu:
            self._state.setdefault(tenant, _TenantState()).sheds += 1
        obs_metrics.TENANT_SHED.labels(tenant, lane).inc()

    # -- slow-query kill policy ----------------------------------------------

    def install(self, ctx) -> None:
        """Bind this registry's cost policy to a QueryContext: resolve
        the tenant and, when its policy has ceilings, attach the
        stage-boundary checker. Cheap for the common (no-ceiling)
        tenant: nothing is attached and ctx.check() stays two
        attribute reads."""
        ctx.tenant = self.resolve(getattr(ctx, "tenant", ""))
        if self.policy(ctx.tenant).has_ceilings():
            ctx.cost_policy = self._check_cost

    def _breach(self, ctx) -> str:
        """The ceiling this query is past, or ''. Wall is checked
        against elapsed (distinct from the client deadline: the
        POLICY's bound, not the caller's patience); the ledger
        ceilings read the live per-node QueryCost."""
        pol = self.policy(getattr(ctx, "tenant", ""))
        if pol.max_wall_s and ctx.elapsed() > pol.max_wall_s:
            return (f"wall {ctx.elapsed() * 1e3:.0f}ms >"
                    f" {pol.max_wall_s * 1e3:.0f}ms")
        cost = getattr(ctx, "cost", None)
        if cost is None:
            return ""
        if pol.max_container_ops:
            ops = sum(cost.container_ops.values())
            if ops > pol.max_container_ops:
                return (f"container ops {ops} >"
                        f" {pol.max_container_ops}")
        if (pol.max_device_bytes
                and cost.device_bytes > pol.max_device_bytes):
            return (f"device bytes {cost.device_bytes} >"
                    f" {pol.max_device_bytes}")
        return ""

    def _check_cost(self, ctx) -> None:
        detail = self._breach(ctx)
        if not detail:
            return
        tenant = getattr(ctx, "tenant", "") or DEFAULT_TENANT
        # Kill: mark BEFORE cancel so every other thread's check()
        # already raises the killed (not plain-cancelled) form.
        ctx.killed_by = KILL_POLICY
        ctx.cancel(reason=f"{KILL_POLICY}: tenant {tenant} {detail}")
        self.note_kill(tenant)
        # Cluster-wide: the same CancelQueryMessage an operator
        # DELETE rides — peers cancel the legs registered under this
        # id. Best-effort (a dead broadcaster must not mask the
        # kill); fired from whichever node detects the breach first,
        # coordinator or forwarded leg.
        fan = self.kill_broadcast
        if fan is not None:
            try:
                fan(ctx.id)
            except Exception:  # noqa: BLE001 - best-effort fan-out
                pass
        raise QueryKilledError(
            f"query {ctx.id} killed by {KILL_POLICY}:"
            f" tenant {tenant} {detail}")

    # -- exposition ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Per-tenant policy + penalty state for /debug/tenants.
        Covers every CONFIGURED tenant plus any tenant with live
        penalty state (an unknown tenant that got itself killed must
        not vanish from the report)."""
        now = time.monotonic()
        with self._mu:
            names = set(self._policies) | set(self._state) \
                | {DEFAULT_TENANT}
            out = {}
            for name in sorted(names):
                pol = self._policies.get(name, self._default)
                st = self._state.get(name)
                score = self._decayed_locked(st, now) if st else 0.0
                out[name] = {
                    "policy": pol.to_json(),
                    "effectiveWeight": round(
                        pol.weight * math.pow(0.5, score)
                        if score else pol.weight, 4),
                    "penaltyScore": round(score, 4),
                    "inPenaltyBox": score > 0.0,
                    "killed": st.kills if st else 0,
                    "shed": st.sheds if st else 0,
                }
        return out
