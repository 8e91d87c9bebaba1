"""Per-peer health: EWMA of RPC outcomes and latency + liveness.

Copy of the JAX package's ``fault/health.py``. Every cluster/client.py
attempt feeds ``record`` (ok/failed + wall latency); a membership layer
feeds ``note_gossip`` on state transitions. The blended **score** in
[0, 1] is what the executor's replica ordering consumes
(fault.FaultManager.order_nodes), and every update mirrors into the
``pilosa_cluster_peer_health`` gauge.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ..obs import metrics as obs_metrics

# Smoothing factor per sample: ~10 samples to move 90% of the way.
ALPHA = 0.2
# Latency deviation multiplier for the hedging tail estimate
# (mean + K·mean-abs-deviation ≈ p95 for well-behaved latencies).
_TAIL_K = 3.0


class _Peer:
    __slots__ = ("ok", "lat", "dev", "gossip", "samples", "last_ts",
                 "fails", "oks")

    def __init__(self):
        self.ok = 1.0        # EWMA of outcome (1 success / 0 failure)
        self.lat = 0.0       # EWMA of latency seconds
        self.dev = 0.0       # EWMA of |latency - lat|
        self.gossip = "alive"
        self.samples = 0
        self.last_ts = 0.0
        self.fails = 0       # lifetime counters, for the snapshot
        self.oks = 0


class PeerHealth:
    def __init__(self, node: str = "", alpha: float = ALPHA):
        self.node = node
        self.alpha = alpha
        self._mu = threading.Lock()
        self._peers: dict[str, _Peer] = {}

    def _peer(self, host: str) -> _Peer:
        p = self._peers.get(host)
        if p is None:
            p = self._peers[host] = _Peer()
        return p

    # -- feeds ---------------------------------------------------------------

    def record(self, host: str, ok: bool,
               latency_s: Optional[float] = None) -> None:
        a = self.alpha
        with self._mu:
            p = self._peer(host)
            p.ok += a * ((1.0 if ok else 0.0) - p.ok)
            if ok:
                p.oks += 1
            else:
                p.fails += 1
            if latency_s is not None and ok:
                if p.samples == 0 or p.lat == 0.0:
                    p.lat = latency_s
                else:
                    p.dev += a * (abs(latency_s - p.lat) - p.dev)
                    p.lat += a * (latency_s - p.lat)
            p.samples += 1
            p.last_ts = time.time()
            score = self._score_locked(p)
        obs_metrics.PEER_HEALTH.labels(host).set(round(score, 4))

    def note_gossip(self, host: str, state: str) -> None:
        with self._mu:
            p = self._peer(host)
            p.gossip = state
            if state == "alive" and p.ok < 1.0:
                # A refuted suspicion / rejoin fully forgives the
                # outcome EWMA: the old score describes the old
                # incarnation, and a decayed score would starve the
                # returned peer of the traffic it needs to re-prove
                # itself (the breaker still guards the first probe).
                p.ok = 1.0
            score = self._score_locked(p)
        obs_metrics.PEER_HEALTH.labels(host).set(round(score, 4))

    # -- consults ------------------------------------------------------------

    @staticmethod
    def _score_locked(p: _Peer) -> float:
        if p.gossip == "dead":
            return 0.0
        s = p.ok
        if p.gossip == "suspect":
            s *= 0.5
        return max(0.0, min(1.0, s))

    def score(self, host: str) -> float:
        """Blended health in [0, 1]; unknown peers score 1.0 (innocent
        until an RPC or a rumor says otherwise)."""
        with self._mu:
            p = self._peers.get(host)
            return 1.0 if p is None else self._score_locked(p)

    def latency(self, host: str) -> float:
        with self._mu:
            p = self._peers.get(host)
            return 0.0 if p is None else p.lat

    def latency_tail(self, host: str) -> float:
        """A p95-ish latency estimate (EWMA mean + K·deviation) — the
        hedged-read trigger for this peer; 0.0 when unobserved."""
        with self._mu:
            p = self._peers.get(host)
            if p is None or p.lat == 0.0:
                return 0.0
            return p.lat + _TAIL_K * p.dev

    def snapshot(self) -> dict:
        with self._mu:
            items = list(self._peers.items())
        out = {}
        for host, p in items:
            out[host] = {
                "score": round(self._score_locked(p), 4),
                "okEwma": round(p.ok, 4),
                "latencyMs": round(p.lat * 1e3, 3),
                "latencyTailMs": round(
                    (p.lat + _TAIL_K * p.dev) * 1e3, 3),
                "gossip": p.gossip,
                "samples": p.samples,
                "failures": p.fails,
                "successes": p.oks,
            }
        return out
