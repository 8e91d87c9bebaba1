"""QueryRegistry: in-flight query visibility + cancellation + slow log.

A copy of the JAX package's ``sched/registry.py``. Every query
registers here for its lifetime, so

- ``GET /debug/queries`` can list what is actually running on this
  node (id, PQL, elapsed, remaining budget, state),
- ``DELETE /debug/queries/{id}`` can cancel it by flipping the
  context's cancel flag (every executor layer checks it
  cooperatively), and
- queries slower than the configured threshold land in a bounded
  slow-query log (PQL + per-stage timings), mirrored into the stats
  pipeline (``slowQueries`` counter + ``slowQueryNs`` timing).

The registry keeps a list per id (a client may reuse an id): cancel by
id then cancels every context in the group.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from ..utils.stats import NOP
from .context import QueryContext


class QueryRegistry:
    def __init__(self, slow_threshold_s: Optional[float] = None,
                 stats=NOP, logger=None, max_slow: int = 64):
        from ..utils import logger as logger_mod
        self.slow_threshold_s = slow_threshold_s or None
        self.stats = stats
        self.logger = logger or logger_mod.NOP
        self._mu = threading.Lock()
        self._active: dict[str, list[QueryContext]] = {}
        self._slow: deque[dict] = deque(maxlen=max_slow)

    # -- lifecycle -----------------------------------------------------------

    def register(self, ctx: QueryContext) -> QueryContext:
        with self._mu:
            self._active.setdefault(ctx.id, []).append(ctx)
        return ctx

    def finish(self, ctx: QueryContext,
               error: Optional[BaseException] = None) -> None:
        with self._mu:
            group = self._active.get(ctx.id)
            if group is not None:
                try:
                    group.remove(ctx)
                except ValueError:
                    pass
                if not group:
                    del self._active[ctx.id]
        if ctx.state not in ("cancelled", "expired"):
            ctx.state = "error" if error is not None else "done"
        elapsed = ctx.elapsed()
        if (self.slow_threshold_s is not None
                and elapsed >= self.slow_threshold_s):
            self._record_slow(ctx, elapsed, error)

    def track(self, ctx: QueryContext):
        """register() as a context manager; finish() records whatever
        exception ends the block."""
        registry = self

        class _Track:
            def __enter__(self):
                registry.register(ctx)
                ctx.state = "running"
                return ctx

            def __exit__(self, exc_type, exc, tb):
                registry.finish(ctx, error=exc)
                return False

        return _Track()

    # -- slow-query log ------------------------------------------------------

    def _record_slow(self, ctx: QueryContext, elapsed: float,
                     error) -> None:
        entry = ctx.to_json()
        entry["elapsedS"] = round(elapsed, 4)
        if error is not None:
            entry["error"] = str(error)[:200]
        # Cross-link to the tail sampler (obs.sampler): when the
        # query's trace was kept, this slow entry points straight at
        # the persisted trace — /debug/traces/{id} (ring) or
        # /debug/traces?source=disk (after a restart).
        entry["traceKept"] = bool(getattr(ctx, "trace_kept", False))
        reason = getattr(ctx, "keep_reason", "")
        if reason:
            entry["traceKeepReason"] = reason
        with self._mu:
            self._slow.append(entry)
        self.stats.count("slowQueries", 1)
        self.stats.timing("slowQueryNs", elapsed * 1e9)
        stages = ", ".join(f"{k}={v:.3f}s"
                           for k, v in entry["stages"].items())
        self.logger.printf(
            "slow query %s (%.3fs%s): index=%s lane=%s pql=%.200s",
            ctx.id, elapsed, f"; {stages}" if stages else "",
            ctx.index, ctx.lane, ctx.pql)

    def slow_queries(self) -> list[dict]:
        with self._mu:
            return list(self._slow)

    # -- visibility + cancellation -------------------------------------------

    def active(self) -> list[dict]:
        return [c.to_json() for c in self.active_contexts()]

    def active_contexts(self) -> list[QueryContext]:
        """The live QueryContext objects, oldest first — the watchdog
        (stuck-leg detection, force-keeping in-flight traces) needs
        the contexts themselves, not their JSON."""
        with self._mu:
            ctxs = [c for group in self._active.values() for c in group]
        ctxs.sort(key=lambda c: c.started)
        return ctxs

    def __len__(self) -> int:
        with self._mu:
            return sum(len(g) for g in self._active.values())

    def get(self, qid: str) -> Optional[QueryContext]:
        with self._mu:
            group = self._active.get(qid)
            return group[0] if group else None

    def cancel_local(self, qid: str,
                     reason: str = "cancelled via API") -> int:
        """Cancel every in-flight context registered under ``qid`` on
        THIS node; returns how many were cancelled."""
        with self._mu:
            group = list(self._active.get(qid, ()))
        for ctx in group:
            ctx.cancel(reason)
        if group:
            self.stats.count("queriesCancelled", len(group))
        return len(group)
