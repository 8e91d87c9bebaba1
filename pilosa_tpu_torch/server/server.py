"""Server: one node of the port — holder, executor on the card, HTTP.

Trimmed copy of the JAX package's ``server/server.py`` (reference
server.go:89-180) for a one-node server: ``open()`` opens the holder
under ``data_dir``, builds the ``Executor`` on ``device`` (the card
unless the caller passes ``"cpu"``), the ``Handler`` and the
``HTTPServer``, and serves on a thread; a bind to port 0 rewrites
``host`` with the port the system chose. ``wal_fsync`` is every
fragment's WAL fsync policy (storage.wal: "none", the default as in the
JAX package, "group" or "always"). ``close()`` closes in the JAX
package's order: stop serving, commit barrier, then the holder, whose
fragments snapshot their op-logs and close their WALs. The HTTP front's
pipelined batch lane (``_query_batcher``) runs consecutive plain-PQL
query POSTs of one index as one ``Executor.execute_partial`` call (a
write that adds a slice ends the call) and, when they wrote, one commit
barrier before their acks.

The query lifecycle (the JAX server's sched and obs wiring): every query
goes through the weighted admission queue (``query_config``:
concurrency and queue depth; overflow answers 429 with Retry-After),
under its tenant's policy (``tenants_config``), registered in the query
registry behind ``/debug/queries`` (cancel by id, the slow-query log),
with a cost ledger (unless ``handler.accounting`` is off) and, when
asked or ``trace_config.enabled``, a trace kept in the tracer's ring.
A pipelined batch run holds ONE admission slot and ONE context; when
admission is full the lane declines and the requests go one by one
through the handler, which answers the 429s. ``open()`` starts the
warmup (sched.warmup: build, load and launch every kernel entry once)
on a daemon thread; ``cal_dir`` is where the executor persists the cost
model's calibration (none: not persisted); ``executor_options`` are
further Executor arguments. Cluster membership, gossip, anti-entropy,
the background loops (cache flush, scrub, tiering, backup) and the
other observability subsystems wait for the slices that port them.
"""

from __future__ import annotations

import errno
import json
import threading

from typing import Optional

from .. import SLICE_WIDTH
from ..device import resolve_device
from ..errors import (PilosaError, QueryCancelledError,
                      QueryDeadlineError)
from ..executor import _WRITE_CALLS, ExecOptions, Executor
from ..models.holder import Holder
from ..models.view import VIEW_INVERSE
from ..obs import accounting as obs_accounting
from ..obs import metrics as obs_metrics
from ..obs.metrics import RegistryStatsClient, default_registry
from ..obs.trace import Tracer
from ..pql import parser as pql
from ..pql.ast import Query
from ..sched import (LANE_READ, LANE_WRITE, AdmissionController,
                     AdmissionFullError, QueryContext, QueryRegistry,
                     TenantRegistry)
from ..sched.warmup import Warmup
from ..storage import wal as storage_wal
from ..utils import logger as logger_mod
from ..utils.config import QueryConfig, TenantsConfig, TraceConfig
from ..utils.stats import ExpvarStatsClient, MultiStatsClient
from . import codec
from .handler import Handler
from .httpd import HTTPServer

DEFAULT_PORT = 10101


class Server:
    def __init__(self, data_dir: str, host: str = "localhost:10101",
                 device=None, logger=logger_mod.NOP,
                 wal_fsync: str = storage_wal.FSYNC_NONE,
                 query_config: Optional[QueryConfig] = None,
                 trace_config: Optional[TraceConfig] = None,
                 tenants_config: Optional[TenantsConfig] = None,
                 cal_dir: Optional[str] = None, warmup: bool = True,
                 executor_options: Optional[dict] = None):
        self.data_dir = data_dir
        self.host = host
        self.device = device
        self.wal_fsync = wal_fsync
        self.logger = logger
        self.cal_dir = cal_dir
        # Extra Executor keyword arguments (e.g. mesh_min_slices=1 and
        # costmodel.pinned(0.0) to pin every device leg).
        self.executor_options = dict(executor_options or {})
        self.holder = None
        self.executor = None
        self.handler = None
        self._httpd = None
        self._thread = None
        # Observability: the expvar collector behind /debug/vars, its
        # call sites fed into the /metrics registry too.
        self.trace_config = trace_config or TraceConfig()
        self.stats = MultiStatsClient(
            [ExpvarStatsClient(), RegistryStatsClient(default_registry())])
        self.tracer = Tracer(enabled=self.trace_config.enabled,
                             max_traces=self.trace_config.max_traces,
                             max_spans=self.trace_config.max_spans)
        # Query lifecycle: the weighted admission queue with the tenant
        # (= index) as its second stride level, and the in-flight
        # registry behind /debug/queries.
        self.query_config = query_config or QueryConfig()
        self.tenants_config = tenants_config or TenantsConfig()
        self.tenants = TenantRegistry(self.tenants_config.table, node=host)
        self.admission = AdmissionController(
            concurrency=self.query_config.concurrency,
            queue_depth=self.query_config.queue_depth,
            tenants=self.tenants)
        self.query_registry = QueryRegistry(
            slow_threshold_s=self.query_config.slow_threshold or None,
            stats=self.stats, logger=logger)
        self.warmup_enabled = warmup
        self.warmup: Optional[Warmup] = None

    # -- lifecycle (server.go:89-180) ----------------------------------------

    def open(self) -> None:
        bind_host, sep, port_s = self.host.rpartition(":")
        if not sep:  # bare hostname, no port
            bind_host, port_s = self.host, ""
        bind_host = bind_host or "localhost"
        try:
            port = int(port_s) if port_s else DEFAULT_PORT
        except ValueError:
            raise PilosaError(f"invalid host: {self.host!r}"
                              " (expected host:port)")
        # The device first: without a card (and no "cpu" asked for) the
        # server does not start, before it touches the data directory.
        device = resolve_device(self.device)
        self.holder = Holder(self.data_dir, wal_fsync=self.wal_fsync)
        try:
            self.holder.open()
            self.executor = Executor(self.holder, device=device,
                                     cal_dir=self.cal_dir,
                                     **self.executor_options)
            if self.warmup_enabled:
                self.warmup = Warmup(self.executor, logger=self.logger)
            self.handler = Handler(
                self.holder, self.executor, host=self.host,
                logger=self.logger, admission=self.admission,
                registry=self.query_registry, warmup=self.warmup,
                default_timeout_s=self.query_config.default_timeout,
                tracer=self.tracer, stats=self.stats,
                tenants=self.tenants)
            self._httpd = HTTPServer(self.handler, bind_host, port,
                                     logger=self.logger,
                                     query_batcher=self._query_batcher)
        except BaseException:
            self.holder.close()  # a port in use, an unreadable index
            self.holder = None
            raise
        # Re-resolve the port for ":0" binds (server.go:98-106).
        actual_port = self._httpd.server_address[1]
        if actual_port != port:
            self.host = f"{bind_host}:{actual_port}"
            self.handler.host = self.host
        if self.warmup is not None:
            self.warmup.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="httpd")
        self._thread.start()
        self.logger.printf("listening as http://%s on %s", self.host,
                           device)

    def close(self) -> None:
        if self.warmup is not None:
            self.warmup.stop()
            self.warmup.wait(60)
        if self._httpd is not None:
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None
        if self.holder is not None:
            storage_wal.barrier_all()
            self.holder.close()
            self.holder = None

    # -- the pipelined query batch lane (the JAX server's _query_batcher) ----

    def _query_batcher(self, index: str, bodies: list[str]):
        """Run pipelined plain-PQL query bodies as few executor calls as
        sequential dispatch allows; None sends them one by one through
        the handler. Every request answers as it would alone. A run of
        requests is ONE ``execute_partial`` call, which takes the slice
        lists once, before its first write: so a run ends after a
        request whose write can add a slice past those lists (the next
        run reads them anew), where the JAX server's one run would
        answer the later reads without the new slice (ROADMAP fault
        3.6 of the reference). Partial failure is the JAX package's:
        ``execute_partial`` says how far a run's combined calls got —
        each request it fully covered gets its results, the request
        holding the failing call gets the error response, and the
        requests after it in the run run one by one (none of their
        calls ran). No applied mutation runs twice (a SetBit run again
        would answer false to the client that set the bit). Requests
        that wrote take one commit barrier before any ack goes out.

        Lifecycle: the whole pipelined group occupies ONE admission slot
        (its lane classified over all calls, its tenant the index) and
        registers ONE QueryContext (the default timeout, a cost ledger)
        that every run executes under; with admission full the lane
        declines (None) and per-request dispatch answers the 429s. A
        request whose call hits the deadline or a cancel answers 504 or
        409; the requests before it keep their answers."""
        if self.executor is None:
            return None
        try:
            queries = [pql.parse(b) for b in bodies]
        except PilosaError:
            return None
        calls = [c for q in queries for c in q.calls]
        if not calls or all(c.name == "SetRowAttrs" for c in calls):
            return None  # the bulk attribute path applies out of order
        lane = (LANE_WRITE if any(c.name in _WRITE_CALLS for c in calls)
                else LANE_READ)
        try:
            slot = self.admission.acquire(lane, tenant=index)
        except AdmissionFullError:
            return None  # per-request dispatch answers the 429s
        ctx = QueryContext(pql=f"<pipelined batch: {len(calls)} calls>",
                           index=index, lane=lane,
                           timeout_s=self.query_config.default_timeout
                           or None, node=self.host, tenant=index)
        if self.handler.accounting:
            obs_accounting.attach(ctx, node=self.host)
        self.tenants.install(ctx)
        out: list = []
        failed = True
        try:
            with self.query_registry.track(ctx):
                out = self._run_group(index, queries, calls,
                                      ExecOptions(ctx=ctx))
            failed = any(isinstance(p, tuple) for p in out)
        finally:
            slot.release()
            # The batch lane bypasses the handler's query path, so it
            # records its own latency sample.
            labels = ("batch", lane, "500" if failed else "200")
            obs_metrics.QUERY_SECONDS.labels(*labels).observe(
                ctx.elapsed())
            obs_metrics.QUERIES_TOTAL.labels(*labels).inc()
        return out

    def _run_group(self, index: str, queries: list[Query], calls: list,
                   opt: ExecOptions) -> list:
        """The payloads of a pipelined group: runs split where a write
        can add a slice, then one commit barrier when any request
        wrote."""
        idx = self.holder.index(index)
        out: list = []
        start = 0
        while start < len(queries):
            end = start + 1
            if idx is not None:
                max_slice = idx.max_slice()
                max_inverse = idx.max_inverse_slice()
                while (end < len(queries) and not _grows_slices(
                        idx, queries[end - 1].calls, max_slice,
                        max_inverse)):
                    end += 1
            else:
                end = len(queries)  # every call fails: no index
            out += self._run_payloads(index, queries[start:end], opt)
            start = end
        if any(c.name in _WRITE_CALLS for c in calls):
            try:
                storage_wal.barrier_all()
            except storage_wal.WalError as e:
                # No ack goes out for a write that is not durable.
                status = (507 if getattr(e.__cause__, "errno", None)
                          == errno.ENOSPC else 500)
                return [_error_payload(e, status) for _ in queries]
        return out

    def _run_payloads(self, index: str, queries: list[Query],
                      opt: Optional[ExecOptions] = None) -> list:
        """The responses of one run of requests: one ``execute_partial``
        call over their calls, mapped back onto the requests."""
        calls = [c for q in queries for c in q.calls]
        if all(c.name == "SetRowAttrs" for c in calls):
            # The bulk attribute path applies out of order: one by one.
            return [self._single_query_payload(index, q) for q in queries]
        results, err = self.executor.execute_partial(index, Query(calls),
                                                     opt=opt)
        out = []
        pos = 0
        failed = False
        for q in queries:
            n = len(q.calls)
            if err is None or (not failed and len(results) >= pos + n):
                out.append(_ok_payload(results[pos:pos + n]))
            elif not failed:
                # This request holds the failing call: the error
                # response sequential dispatch gives.
                out.append(_error_payload(err, _error_status(err)))
                failed = True
            else:
                # None of these calls ran: run the request on its own.
                out.append(self._single_query_payload(index, q))
            pos += n
        return out

    def _single_query_payload(self, index: str, q: Query):
        try:
            rs = self.executor.execute(index, q)
            if q.write_calls():
                storage_wal.barrier_all()  # commit before the ack
        except PilosaError as e:
            return _error_payload(e, 400)
        except Exception as e:  # noqa: BLE001 - surfaced as a 500
            return _error_payload(e, 500)
        return _ok_payload(rs)


def _grows_slices(idx, calls: list, max_slice: int,
                  max_inverse: int) -> bool:
    """Can a write of ``calls`` add a slice past the index's slice lists
    (``max_slice`` for the column slices, ``max_inverse`` for the
    inverse view's)? A call that cannot be read here answers True: it
    only ends a batched run early."""
    for c in calls:
        if c.name not in ("SetBit", "ClearBit", "SetFieldValue"):
            continue
        frame = idx.frame(c.args.get("frame") or "")
        if frame is None:
            continue  # the call fails without writing
        try:
            col, has_col = c.uint_arg(idx.column_label)
            row, has_row = c.uint_arg(frame.row_label)
        except ValueError:
            return True
        if has_col and col // SLICE_WIDTH > max_slice:
            return True
        inverse = (c.args.get("view") == VIEW_INVERSE
                   or (frame.inverse_enabled and not c.args.get("view")))
        if (c.name != "SetFieldValue" and inverse and has_row
                and row // SLICE_WIDTH > max_inverse):
            return True
    return False


def _ok_payload(results: list) -> bytes:
    """A 200 batch-lane entry; the common one-boolean answers of a
    pipelined write stream skip the JSON encoder."""
    if len(results) == 1 and results[0] is True:
        return b'{"results": [true]}\n'
    if len(results) == 1 and results[0] is False:
        return b'{"results": [false]}\n'
    return (json.dumps(codec.query_response_json(results, [])) + "\n"
            ).encode()


def _error_status(err: Exception) -> int:
    """The status sequential dispatch answers for ``err``."""
    if isinstance(err, QueryDeadlineError):
        return 504
    if isinstance(err, QueryCancelledError):
        return 409
    if isinstance(err, PilosaError):
        return 400
    return 500


def _error_payload(err: Exception, status: int) -> tuple[int, bytes]:
    """A non-200 batch-lane entry: the HTTP front frames a plain bytes
    entry as a 200, so an error carries its status."""
    return status, (json.dumps({"error": str(err)}) + "\n").encode()
