"""Readiness behind ``GET /health``.

The ``HealthChecker`` of the JAX package's ``obs/slo.py``: a READINESS
probe, distinct from liveness (``/version`` answers as long as the
process serves), with the same six checks, JSON keys and ``ok`` flags —
holder open, gossip converged (with a gossip membership; a static or
HTTP cluster has no failure detector and says so), admission not
saturated, data directory writable, no quarantined fragment without a
replica to fail over to, and writes accepted (not latched write-unready
after ENOSPC). Load balancers route on it. The SLO burn-rate trackers of
that module wait for the observability slice.
"""

from __future__ import annotations

import os
import threading
import time


class HealthChecker:
    """Readiness checks behind ``GET /health`` — every check is cheap
    (the disk probe is throttled) so a load balancer can poll at 1 Hz
    without showing up in the profiles."""

    DISK_PROBE_INTERVAL_S = 5.0

    def __init__(self, holder=None, cluster=None, admission=None,
                 host: str = ""):
        self.holder = holder
        self.cluster = cluster
        self.admission = admission
        self.host = host
        self._disk_mu = threading.Lock()
        self._disk_last = 0.0
        self._disk_ok = True
        self._disk_err = ""

    def check(self) -> tuple[bool, dict]:
        """(ready, checks) — ready only when every check passes."""
        checks: dict[str, dict] = {}

        holder = self.holder
        if holder is None:
            checks["holder"] = {"ok": False, "detail": "no holder"}
        else:
            # Holder.open() creates the data dir and sets .path; a
            # closed/never-opened holder has no usable directory.
            path = getattr(holder, "path", "") or ""
            ok = bool(path) and os.path.isdir(path)
            checks["holder"] = {"ok": ok,
                                "detail": path or "not open"}

        if (self.cluster is not None and len(self.cluster.nodes) > 1
                and getattr(self.cluster, "node_set", None)
                is not None):
            try:
                states = self.cluster.node_states()
            except Exception as e:  # noqa: BLE001 - membership mid-close
                states = {}
                checks["gossip"] = {"ok": False, "detail": str(e)[:120]}
            if "gossip" not in checks:
                down = sorted(h for h, s in states.items() if s != "UP")
                checks["gossip"] = {
                    "ok": not down,
                    "detail": (f"down: {','.join(down)}" if down
                               else f"{len(states)} nodes UP")}
        elif self.cluster is not None and len(self.cluster.nodes) > 1:
            # Static/HTTP membership has no failure detector —
            # node_states() would report every peer DOWN and a load
            # balancer routing on /health would drain a healthy
            # cluster. Convergence simply isn't observable here.
            checks["gossip"] = {
                "ok": True,
                "detail": "static membership (no failure detector)"}
        else:
            checks["gossip"] = {"ok": True, "detail": "single node"}

        if self.admission is not None:
            snap = self.admission.snapshot()
            queued = sum((snap.get("queued") or {}).values())
            depth = snap.get("queueDepth", 0) or 1
            # Saturated = the queue is full (the next arrival would be
            # rejected); a busy-but-absorbing queue stays ready.
            ok = queued < depth
            checks["admission"] = {
                "ok": ok,
                "detail": f"queued={queued}/{depth}"
                          f" inFlight={snap.get('inFlight', 0)}"}
        else:
            checks["admission"] = {"ok": True, "detail": "unlimited"}

        checks["disk"] = self._check_disk()

        # Storage integrity (storage.integrity): quarantined fragments
        # are a degraded-but-serving condition when replicas exist
        # (reads fail over while the repairer re-streams); with no
        # peers to fail over to, the touched slices genuinely cannot
        # answer, so readiness reflects it.
        q = (getattr(self.holder, "quarantine", None)
             if self.holder is not None else None)
        if q is not None:
            n = len(q)
            # Failover needs a REPLICA of the quarantined data, not
            # just another node: replica_n=1 means no copy exists
            # anywhere else regardless of cluster size.
            replicated = (self.cluster is not None
                          and len(self.cluster.nodes) > 1
                          and getattr(self.cluster, "replica_n", 1)
                          > 1)
            checks["storage"] = {
                "ok": n == 0 or replicated,
                "detail": ("clean" if n == 0 else
                           f"{n} fragments quarantined"
                           + ("" if replicated
                              else " (no replica to fail over to)"))}

        # Disk-full degradation (fault.diskfull): while ENOSPC holds
        # the node write-unready, /health SAYS so — but the node is
        # not "down": reads keep serving, so the block carries its
        # own key instead of failing the disk probe (which may well
        # still succeed for tiny probe files on a nearly-full disk).
        from ..fault import diskfull as _diskfull
        wr = _diskfull.write_ready()
        checks["writeReady"] = {
            "ok": wr,
            "detail": ("writes accepted" if wr else
                       "write-unready after ENOSPC (writes answer"
                       " 507, reads serving)")}

        ready = all(c["ok"] for c in checks.values())
        return ready, checks

    def _check_disk(self) -> dict:
        path = getattr(self.holder, "path", "") or "" \
            if self.holder is not None else ""
        if not path:
            return {"ok": False, "detail": "no data dir"}
        now = time.monotonic()
        with self._disk_mu:
            if now - self._disk_last < self.DISK_PROBE_INTERVAL_S:
                return {"ok": self._disk_ok,
                        "detail": self._disk_err or path}
            self._disk_last = now
        probe = os.path.join(path, ".health-probe")
        try:
            with open(probe, "w") as f:
                f.write(str(time.time()))
            os.remove(probe)
            ok, err = True, ""
        except OSError as e:
            ok, err = False, str(e)[:120]
        with self._disk_mu:
            self._disk_ok, self._disk_err = ok, err
        return {"ok": ok, "detail": err or path}
