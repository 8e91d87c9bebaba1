"""Fault-tolerance layer: peer health, circuit breakers, failpoints.

Copy of the JAX package's ``fault/__init__.py``. The executor re-maps a
failed node's slices onto surviving replicas (executor._map_reduce);
this package remembers a failure between queries, so only the first
query after a peer dies pays its RPC timeout:

- ``fault.health``   — per-peer EWMA of RPC outcomes and latency, fed
  by every cluster/client call (and, with gossip, by its liveness
  transitions).
- ``fault.breaker``  — closed/open/half-open circuit breakers per peer
  with exponential backoff and full jitter on half-open probes.
- ``fault.failpoints`` — named deterministic fault-injection sites
  (``rpc.send``, ``rpc.recv``); zero-cost when disarmed.

``FaultManager`` is one node's composition, shared by the executor, the
client and the syncer. State is per node (two in-process servers each
keep their own view of a peer); failpoints are process-global.
"""

from __future__ import annotations

from typing import Optional

from .breaker import (STATE_CLOSED, STATE_HALF_OPEN,  # noqa: F401
                      STATE_OPEN, BreakerBoard)
from .health import PeerHealth


class FaultManager:
    """One node's fault-tolerance state: health scores + breakers.

    ``record_rpc`` is the single feed for RPC outcomes (called by
    cluster.client._do for every attempt); ``note_gossip`` folds the
    membership layer's liveness transitions in, so a gossip-declared
    death opens the breaker *before* any query pays a timeout at all.
    """

    def __init__(self, breaker_threshold: int = 3,
                 backoff_base_s: float = 0.5,
                 backoff_cap_s: float = 30.0,
                 hedge_s: float = 0.0,
                 node: str = "", rng=None):
        self.node = node
        self.health = PeerHealth(node=node)
        self.breakers = BreakerBoard(threshold=breaker_threshold,
                                     backoff_base_s=backoff_base_s,
                                     backoff_cap_s=backoff_cap_s,
                                     node=node, rng=rng)
        # Hedged-read floor (seconds); 0 disables hedging. The actual
        # per-peer trigger is max(floor, the peer's p95-ish latency
        # estimate), so a configured 30 ms floor hedges a peer whose
        # EWMA tail says 200 ms at 200 ms, not 30.
        self.hedge_s = hedge_s

    # -- feeds ---------------------------------------------------------------

    def record_rpc(self, host: str, ok: bool,
                   latency_s: Optional[float] = None) -> None:
        if not host or host == self.node:
            return
        self.health.record(host, ok, latency_s)
        if ok:
            self.breakers.record_success(host)
        else:
            self.breakers.record_failure(host)

    def note_gossip(self, host: str, state: str) -> None:
        """Fold a membership transition in: ``dead`` opens the breaker
        immediately (no query ever pays the first timeout when gossip
        already knows), ``alive`` re-arms an immediate half-open probe
        so recovery isn't held hostage to the backoff schedule."""
        if not host or host == self.node:
            return
        self.health.note_gossip(host, state)
        if state == "dead":
            self.breakers.force_open(host, reason="gossip dead")
        elif state == "alive":
            self.breakers.note_probe_ready(host)

    # -- consults ------------------------------------------------------------

    def allow(self, host: str) -> bool:
        """May a request go to ``host`` right now? (Closed breaker, or
        a granted half-open probe.) The local node is always allowed.
        SIDE-EFFECTFUL: a lapsed open window transitions to half-open
        and this caller takes the single probe slot — only the layer
        that actually SENDS (cluster.client._do) may call this; pure
        filters must use would_allow()."""
        if not host or host == self.node:
            return True
        return self.breakers.allow(host)

    def would_allow(self, host: str) -> bool:
        """allow() without side effects — for peer filters (the
        anti-entropy syncer) whose own client will gate again when it
        actually sends."""
        if not host or host == self.node:
            return True
        return self.breakers.would_allow(host)

    def order_nodes(self, nodes: list, local: str = "") -> list:
        """Replica owners ordered for placement: breaker-allowed nodes
        first (stable within each class, so equal-health clusters keep
        the jump-hash primary order and its locality), the allowed
        class additionally ranked by quantized health score. Open
        circuits sink to the end but are NOT dropped — when every
        replica of a slice is dark the query still attempts one (the
        attempt doubles as an extra probe)."""
        if len(nodes) < 2:
            return nodes
        local = local or self.node

        def key(n):
            if n.host == local:
                return (0, 0.0)
            if not self.breakers.would_allow(n.host):
                return (2, 0.0)
            if self.breakers.state(n.host) != STATE_CLOSED:
                # Probe-ready (open window lapsed / half-open): rank
                # at the top of the remote class so the slices whose
                # natural order starts with this peer route it the
                # probe. Its health score is STALE by construction —
                # an open circuit gets no samples — and ranking by it
                # would exile a recovered peer forever.
                return (1, -1.0)
            # Quantized so EWMA noise can't shuffle stable placement.
            return (1, -round(self.health.score(n.host), 1))

        return sorted(nodes, key=key)

    def probe_targets(self) -> list[str]:
        """Peers whose breaker wants a half-open probe NOW (open
        window lapsed, no probe in flight). The server's background
        probe loop sends each a cheap /version request — recovery must
        not depend on query traffic happening to rank the returned
        peer first (in many topologies it never does)."""
        return [host for host, st in self.breakers.snapshot().items()
                if st["state"] != STATE_CLOSED
                and self.breakers.would_allow(host)]

    def hedge_delay_s(self, host: str) -> Optional[float]:
        """Seconds to wait on ``host`` before firing a hedge leg, or
        None when hedging is off."""
        if self.hedge_s <= 0 or host == self.node:
            return None
        return max(self.hedge_s, self.health.latency_tail(host))

    # -- exposition ----------------------------------------------------------

    def snapshot(self) -> dict:
        """The /status ``fault`` block: per-peer health + breaker
        state, plus the armed failpoints."""
        from . import failpoints as fp
        out = {
            "peers": self.health.snapshot(),
            "breakers": self.breakers.snapshot(),
            "hedgeS": self.hedge_s,
        }
        if fp.ACTIVE is not None:
            out["failpoints"] = fp.ACTIVE.snapshot()
        return out
