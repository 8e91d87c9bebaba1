"""HTTP API of one node as a WSGI application.

Trimmed copy of the JAX package's ``server/handler.py`` (reference
handler.go, route table at handler.go:82-120): the routes a one-node
server serves, with the same status codes, error texts and JSON and
protobuf bodies. Content negotiation between JSON and
``application/x-protobuf`` mirrors handler.go:811-893; strict
unknown-key validation of index/frame options mirrors
handler.go:299-351,577-610. Status mapping: ``HTTPError`` gives its
status, ``PilosaError`` 400, any other exception 500.

A query keeps parse → execute → commit barrier → encode: a query holding
a write call, every ``/import`` and every field import answers 200 only
once ``storage.wal.barrier_all()`` has put its WAL records in the OS
(the JAX package's ack contract). A failed barrier answers 507 with
``Retry-After`` when the disk is full, 500 otherwise; while the node is
write-unready after ENOSPC (fault.diskfull) every write answers 507
with ``Retry-After`` before it executes, and reads keep serving.
``?plan=1`` on the query route plans the query without executing it
(EXPLAIN). A read over a slice that no trustworthy copy can serve (the
local one quarantined, no replica left) answers 503.

The query lifecycle is the JAX handler's (handler.py:1628-1860, one
node): each query gets its lane (read or write), a QueryContext with its
id (``X-Pilosa-Query-Id`` when the client names it), its deadline
(``X-Pilosa-Deadline`` seconds, else ``?timeout=``, else the server's
default) and its tenant (``X-Pilosa-Tenant``, else the index); a cost
ledger (``X-Pilosa-Stats`` on every answer, the cost tree and the plan
under ``?profile=1``); the tenant's kill policy; a trace when the
tracer is on or ``?trace=1`` asks, and with the tail sampler wired
(obs.sampler, the server default) a span buffer on every query and the
keep decision at its end; registration for ``/debug/queries``; and an
admission slot — 429 with ``Retry-After`` under overload. A deadline
answers 504, a cancel 409, a cost-policy kill 402, with the JAX texts.
The import and schema routes take a write or admin slot. Routes:
``/metrics``, ``/debug/vars``, ``/debug/queries``,
``/debug/queries/slow``, ``DELETE /debug/queries/{qid}``,
``/debug/traces`` (``?source=disk`` pages the sampler's disk ring),
``/debug/traces/summary``, ``/debug/traces/{qid}`` (a miss in the ring
falls back to the disk ring), ``/debug/tenants``, ``/debug/plans``,
``/debug/integrity`` (quarantined fragments, footer coverage, scrub and
repair state) and ``POST /debug/integrity/scrub`` (``?sync=1`` runs a
pass inline).

The cluster's routes (handler.py:374, :414-428 of the JAX package):
``/hosts`` and ``/status`` list the cluster's nodes (``/status`` each
node's state and the slices it owns); a protobuf query's ``Remote`` and
``Slices`` fields make it a coordinator's leg — no admission slot, this
node's slices only — whose answer carries the generation tokens of the
served slices (``X-Pilosa-Generations``) and, as asked, the spans and
the cost tree for the coordinator to stitch; ``/import`` and
``/export`` answer 412 for a slice this node does not own; index and
frame creation and deletion broadcast their message to the peers;
``/fragment/nodes``, ``/fragment/blocks``, ``/fragment/block/data`` and
``POST /fragment/import`` serve anti-entropy, ``GET``/``POST
/fragment/data`` a fragment's tar stream (the reads answer 409 for a
quarantined fragment, whose copy must not feed a peer); ``/generations`` the
cluster result cache's probe; ``POST /messages`` takes a peer's
broadcast; ``/debug/topology`` shows the placement and
``/debug/failpoints`` arms the fault sites. ``GET /health`` is the
readiness probe (obs.slo.HealthChecker: 200 or 503 with the JAX
checks), and ``POST /index/{index}/frame/{frame}/restore?host=`` pulls
every slice of a frame that this node owns, each view, from a remote
host's ``/fragment/data`` (handler.go:1180-1266).

A coordinator's query with ``?partial=1`` skips the slices no reachable
replica owns and answers 200 with ``X-Pilosa-Partial`` listing them
(sorted; a forwarded leg answers strictly). ``/status`` carries the
``build`` block and the runtime collector's ``runtime`` block.
``GET /metrics/cluster`` federates every node's ``/metrics`` (counters
and histograms summed, gauges labeled by ``node``) and ``GET
/debug/cluster`` every node's debug block with a version-skew verdict
(``?local=1``: this node's block); an unreachable peer fails either with
503 unless ``?partial=1``, which answers the rest and names the missing
nodes in ``X-Pilosa-Partial-Nodes`` (obs.federate).

The operator surface (the JAX handler's, handler.py:337-411): ``/`` and
``/assets/{file}`` serve the web console (server.webui); the seven
``/debug/pprof*`` routes the host profiler (utils.profiling, and the
continuous profiler's folded stacks at ``/debug/pprof/flame``);
``/debug/blackbox`` and ``POST /debug/blackbox/dump`` the flight
recorder with the watchdog's trip record; ``/debug/metrics/history``
(``?scope=cluster`` through obs.federate) the on-disk metric history;
``/debug/sentinel`` the regression sentinel; ``/debug/capture`` and
``/debug/capture/records`` (``?since=``, ``?scope=cluster``) workload
capture. Every successful coordinator query answers with
``X-Pilosa-Result-Digest`` and, with capture on, appends one record
(imports append one per ack). ``/import`` passes the process-wide apply
gate (``pilosa_import_pipeline_depth``).

Elastic resize (the JAX handler's, handler.py:2440-2500):
``GET /cluster/resize`` shows the epoch, the installed in-flight state
and this node's coordinator op; ``POST /cluster/resize`` starts one with
this node as coordinator (``{"hosts": [...]}``, ``{"add": h}`` or
``{"remove": h}``; 202) or aborts it (``{"abort": true}``; 409 when
none is in flight), and answers 503 on a node without a coordinator. A
``ResizeMessage`` arrives through ``POST /messages``; ``/debug/topology``
shows the in-flight resize and each index's moving slices; ``POST
/fragment/import`` accepts a slice this node owns in either epoch of an
in-flight resize or, after a finalize, for the grace window.

Tiered storage (the JAX handler's, handler.py:1491-1506): ``GET
/debug/tier`` shows the tier manager's state (``{"enabled": false}``
without one), ``?pass=1`` runs one pass inline and ``?entries=1`` lists
the ledger (``&tier=cold`` filters it). The archive backup and pod
routes wait for the slices that port them.
"""

from __future__ import annotations

import contextlib
import datetime as dt
import io
import json
import math
import os
import re
import threading
import time
from typing import Callable, Optional
from urllib.parse import parse_qs

import numpy as np

from .. import SLICE_WIDTH, __version__
from ..errors import (FrameExistsError, IndexExistsError, PilosaError,
                      QueryCancelledError, QueryDeadlineError,
                      QueryKilledError, SliceUnavailableError,
                      validate_label)
from ..cluster import generations as gens_mod
from ..cluster.broadcast import (NOP_BROADCASTER, CancelQueryMessage,
                                 unmarshal_message)
from ..executor import _WRITE_CALLS, ExecOptions
from ..fault import diskfull as fault_diskfull
from ..fault import failpoints as fault_failpoints
from ..models.frame import Field, FrameOptions
from ..models.index import IndexOptions
from ..obs import accounting as obs_accounting
from ..obs import capture as obs_capture
from ..obs import federate as obs_federate
from ..obs import metrics as obs_metrics
from ..obs import profile as obs_profile
from ..obs import runtime as obs_runtime
from ..obs import trace as obs_trace
from ..parallel import residency
from ..pql import parser as pql
from ..proto import internal as pb
from ..proto import rawimport
from ..sched import context as sched_context
from ..sched import (KILL_POLICY, KILLED_BY_HEADER, LANE_ADMIN, LANE_READ,
                     LANE_WRITE, AdmissionFullError, QueryContext,
                     QueryRegistry)
from ..storage import wal as storage_wal
from ..storage.attrs import diff_blocks
from ..storage.bitmap import Bitmap
from ..utils import logger as logger_mod
from ..utils import profiling
from ..utils import timequantum as tq
from ..utils.config import parse_duration
from ..utils.streams import CappedReader
from . import codec, webui

_PROTOBUF = "application/x-protobuf"

# JSON keys accepted in POST /index and POST /frame options
# (handler.go:299-351 validates against the Go struct tags).
_VALID_INDEX_OPTIONS = {"columnLabel", "timeQuantum"}
_VALID_FRAME_OPTIONS = {"rowLabel", "inverseEnabled", "cacheType",
                        "cacheSize", "timeQuantum", "fields"}



class HTTPError(Exception):
    def __init__(self, status: int, message: str, headers=None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = list(headers or ())


class Request:
    """Decoded WSGI request."""

    def __init__(self, environ: dict, vars: dict[str, str]):
        self.environ = environ
        self.vars = vars
        self.query = {k: v[0] for k, v in
                      parse_qs(environ.get("QUERY_STRING", "")).items()}

    @property
    def content_type(self) -> str:
        return self.environ.get("CONTENT_TYPE", "")

    @property
    def accept(self) -> str:
        return self.environ.get("HTTP_ACCEPT", "")

    def body(self) -> bytes:
        # Missing/invalid Content-Length reads as empty — an unbounded
        # read() on the live socket would block the worker thread.
        try:
            length = int(self.environ.get("CONTENT_LENGTH") or 0)
        except ValueError:
            length = 0
        stream = self.environ.get("wsgi.input")
        if stream is None or length <= 0:
            return b""
        return CappedReader(stream, length).read()

    def json(self) -> dict:
        raw = self.body()
        if not raw:
            return {}
        try:
            return json.loads(raw)
        except ValueError as e:
            raise HTTPError(400, f"invalid JSON: {e}")

    def uint_param(self, name: str) -> int:
        v = self.query.get(name)
        if v is None or not v.isdigit():
            raise HTTPError(400, f"{name} required")
        return int(v)


class Response:
    def __init__(self, status: int = 200, body=b"",
                 content_type: str = "application/json",
                 headers: tuple = ()):
        # body: bytes, or an iterator of byte chunks (the CSV export).
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = list(headers)

    @staticmethod
    def json(obj, status: int = 200, headers=()) -> "Response":
        return Response(status, (json.dumps(obj) + "\n").encode(),
                        headers=headers)

    @staticmethod
    def proto(msg, status: int = 200, headers=()) -> "Response":
        return Response(status, msg.SerializeToString(), _PROTOBUF,
                        headers=headers)


def _export_csv_chunks(positions: np.ndarray, slice: int,
                       chunk: int = 1 << 16):
    """Chunked CSV body of one fragment, ``row,column`` per bit in
    position order (the reference streams via csv.Writer over
    ForEachBit, handler.go:985-1025). ``positions`` is a point-in-time
    copy, so writes during the transfer cannot tear a row."""
    base = slice * SLICE_WIDTH
    w = np.uint64(SLICE_WIDTH)
    for i in range(0, len(positions), chunk):
        vals = positions[i:i + chunk]
        rows = (vals // w).tolist()
        cols = (vals % w).tolist()
        yield "".join(f"{r},{base + c}\r\n"
                      for r, c in zip(rows, cols)).encode()


_STATUS_TEXT = {200: "OK", 400: "Bad Request",
                402: "Payment Required",  # cost-policy kill
                404: "Not Found",
                405: "Method Not Allowed", 406: "Not Acceptable",
                409: "Conflict", 415: "Unsupported Media Type",
                429: "Too Many Requests",
                500: "Internal Server Error",
                503: "Service Unavailable",
                504: "Gateway Timeout",
                507: "Insufficient Storage"}


# Import apply lanes (the JAX handler's gate): how many /import handlers
# may be in their apply stage at once, process-wide. The apply is mostly
# GIL-holding Python and numpy, so unbounded concurrent applies convoy
# on the GIL; decode, wire and WAL of other blocks overlap an apply, and
# the gate never blocks them. ``pilosa_import_pipeline_depth`` counts
# handlers in the stage (applying and gate-queued).
_APPLY_LANES = max(1, int(os.environ.get(
    "PILOSA_TPU_IMPORT_APPLY_LANES", "1") or 1))
_APPLY_GATE = threading.BoundedSemaphore(_APPLY_LANES)


class Handler:
    """Router + handlers over one holder and its executor (any object
    with ``execute(index, query, slices)``). ``host`` is the node's
    ``host:port`` as ``/hosts`` and ``/status`` report it; empty for a
    handler served in-process."""

    def __init__(self, holder, executor, host: str = "",
                 logger=logger_mod.NOP, admission=None, registry=None,
                 warmup=None, default_timeout_s: float = 0.0,
                 tracer=None, stats=None, accounting: bool = True,
                 tenants=None, cluster=None, broadcaster=None,
                 status_handler=None, sampler=None, scrubber=None,
                 repairer=None, client_factory=None, runtime=None,
                 federator=None, profiler=None, blackbox=None,
                 watchdog=None, history=None, sentinel=None,
                 tenant_slo=None, capture=None, tier=None):
        self.logger = logger
        self.holder = holder
        self.executor = executor
        self.host = host
        # The cluster's placement (None: a bare one-node handler), the
        # schema broadcaster, and the server that applies received
        # broadcasts and reports the cluster's status.
        self.cluster = cluster
        self.broadcaster = broadcaster or NOP_BROADCASTER
        self.status_handler = status_handler
        self.version = __version__
        # Query lifecycle (sched): admission=None means no admission
        # control (bare handlers); the registry always exists so
        # /debug/queries works on any handler.
        self.admission = admission
        self.tenants = tenants
        self.registry = registry if registry is not None \
            else QueryRegistry(logger=self.logger)
        self.warmup = warmup
        self.default_timeout_s = default_timeout_s or 0.0
        # Observability (obs): a tracer (off by default — ?trace=1
        # still traces one request), the stats client behind
        # /debug/vars, and the per-handler accounting gate.
        self.tracer = tracer if tracer is not None \
            else obs_trace.Tracer(enabled=False)
        self.stats = stats
        self.accounting = accounting
        # Tail sampling (obs.sampler): when wired, EVERY query buffers
        # spans and the keep decision runs at query end; kept traces
        # persist to its disk ring.
        self.sampler = sampler
        # Storage integrity (storage.scrub / server.repair) behind
        # /debug/integrity; None (bare handlers) serves the holder's
        # quarantine registry alone.
        self.scrubber = scrubber
        self.repairer = repairer
        # host -> cluster.client.Client, for the restore route's pulls.
        self.client_factory = client_factory
        # The runtime collector behind /status's runtime block, and the
        # federator behind /metrics/cluster and /debug/cluster (a bare
        # handler keeps a peerless one).
        self.runtime = runtime
        self.federator = federator or obs_federate.Federator(host)
        # The operator surface: the continuous profiler behind
        # /debug/pprof/flame (the module default is not started, so a
        # bare handler serves an empty ring), the flight recorder and
        # the stall watchdog behind /debug/blackbox*, the metric history
        # and the regression sentinel behind /debug/metrics/history and
        # /debug/sentinel, the per-tenant SLO burn behind /debug/tenants,
        # and workload capture behind /debug/capture* (None: a disabled
        # status, nothing captured).
        self.profiler = profiler if profiler is not None \
            else obs_profile.get_profiler()
        self.blackbox = blackbox
        self.watchdog = watchdog
        self.history = history
        self.sentinel = sentinel
        self.tenant_slo = tenant_slo
        self.capture = capture
        # Tiered storage (tier) behind /debug/tier; None (tiering off,
        # bare handlers) serves a disabled stub.
        self.tier = tier
        # Readiness checks behind GET /health, built at the first probe.
        self._health = None
        # (method, regex, handler, admission lane)
        self._routes: list[tuple] = []
        self._add_routes()

    # -- routing -------------------------------------------------------------

    def _route(self, method: str, pattern: str, fn: Callable,
               lane: Optional[str] = None) -> None:
        # {name} segments become named groups matching one path segment.
        # ``lane`` routes the whole handler through that admission lane
        # (the query handler manages its own, deadline-aware slot).
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self._routes.append((method, re.compile(f"^{regex}$"), fn, lane))

    def _add_routes(self) -> None:
        # Route table (reference handler.go:82-120), one-node routes.
        r = self._route
        r("GET", "/", self._handle_webui)
        r("GET", "/assets/{file}", self._handle_asset)
        r("GET", "/index", self._handle_get_schema)
        r("GET", "/index/{index}", self._handle_get_index)
        r("POST", "/index/{index}", self._handle_post_index,
          lane=LANE_ADMIN)
        r("DELETE", "/index/{index}", self._handle_delete_index,
          lane=LANE_ADMIN)
        r("POST", "/index/{index}/attr/diff", self._handle_index_attr_diff)
        r("POST", "/index/{index}/frame/{frame}", self._handle_post_frame,
          lane=LANE_ADMIN)
        r("DELETE", "/index/{index}/frame/{frame}",
          self._handle_delete_frame, lane=LANE_ADMIN)
        r("POST", "/index/{index}/query", self._handle_post_query)
        r("POST", "/index/{index}/frame/{frame}/restore",
          self._handle_post_frame_restore, lane=LANE_ADMIN)
        r("POST", "/index/{index}/frame/{frame}/attr/diff",
          self._handle_frame_attr_diff)
        r("PATCH", "/index/{index}/frame/{frame}/time-quantum",
          self._handle_patch_frame_time_quantum, lane=LANE_ADMIN)
        r("GET", "/index/{index}/frame/{frame}/views",
          self._handle_get_frame_views)
        r("GET", "/index/{index}/frame/{frame}/fields",
          self._handle_get_frame_fields)
        r("POST", "/index/{index}/frame/{frame}/field/{field}",
          self._handle_post_frame_field, lane=LANE_ADMIN)
        r("POST", "/index/{index}/frame/{frame}/field/{field}/import",
          self._handle_post_field_import, lane=LANE_WRITE)
        r("PATCH", "/index/{index}/time-quantum",
          self._handle_patch_index_time_quantum, lane=LANE_ADMIN)
        r("GET", "/cluster/resize", self._handle_get_cluster_resize)
        r("POST", "/cluster/resize", self._handle_post_cluster_resize,
          lane=LANE_ADMIN)
        r("GET", "/debug/topology", self._handle_debug_topology)
        r("GET", "/debug/failpoints", self._handle_debug_failpoints)
        r("POST", "/debug/failpoints", self._handle_post_failpoints)
        r("GET", "/debug/integrity", self._handle_debug_integrity)
        r("POST", "/debug/integrity/scrub",
          self._handle_post_integrity_scrub)
        r("GET", "/debug/tier", self._handle_debug_tier)
        r("GET", "/debug/tenants", self._handle_debug_tenants)
        r("GET", "/debug/queries", self._handle_debug_queries)
        r("GET", "/debug/queries/slow", self._handle_debug_slow_queries)
        r("DELETE", "/debug/queries/{qid}", self._handle_delete_query)
        r("GET", "/debug/traces", self._handle_debug_traces)
        # /summary must register BEFORE the {qid} wildcard or the
        # wildcard swallows it.
        r("GET", "/debug/traces/summary",
          self._handle_debug_traces_summary)
        r("GET", "/debug/traces/{qid}", self._handle_debug_trace)
        r("GET", "/debug/blackbox", self._handle_debug_blackbox)
        r("POST", "/debug/blackbox/dump",
          self._handle_post_blackbox_dump)
        r("GET", "/debug/capture", self._handle_debug_capture)
        r("GET", "/debug/capture/records",
          self._handle_debug_capture_records)
        r("GET", "/debug/metrics/history", self._handle_metrics_history)
        r("GET", "/debug/sentinel", self._handle_debug_sentinel)
        r("GET", "/debug/pprof", self._handle_pprof_index)
        r("GET", "/debug/pprof/", self._handle_pprof_index)
        r("GET", "/debug/pprof/profile", self._handle_pprof_profile)
        r("GET", "/debug/pprof/threads", self._handle_pprof_threads)
        r("GET", "/debug/pprof/heap", self._handle_pprof_heap)
        r("POST", "/debug/pprof/heap", self._handle_pprof_heap_post)
        r("GET", "/debug/pprof/flame", self._handle_pprof_flame)
        r("GET", "/debug/vars", self._handle_expvar)
        r("GET", "/debug/plans", self._handle_debug_plans)
        r("GET", "/metrics", self._handle_metrics)
        r("GET", "/metrics/cluster", self._handle_metrics_cluster)
        r("GET", "/debug/cluster", self._handle_debug_cluster)
        r("GET", "/health", self._handle_health)
        r("GET", "/export", self._handle_get_export)
        r("GET", "/fragment/block/data", self._handle_fragment_block_data)
        r("GET", "/fragment/blocks", self._handle_fragment_blocks)
        r("GET", "/fragment/data", self._handle_get_fragment_data)
        r("POST", "/fragment/data", self._handle_post_fragment_data,
          lane=LANE_WRITE)
        r("POST", "/fragment/import", self._handle_post_fragment_import,
          lane=LANE_WRITE)
        r("GET", "/fragment/nodes", self._handle_fragment_nodes)
        r("GET", "/generations", self._handle_get_generations)
        r("POST", "/import", self._handle_post_import, lane=LANE_WRITE)
        r("GET", "/hosts", self._handle_get_hosts)
        r("GET", "/schema", self._handle_get_schema)
        r("GET", "/slices/max", self._handle_slice_max)
        r("GET", "/status", self._handle_get_status)
        r("GET", "/version", self._handle_get_version)
        r("POST", "/messages", self._handle_post_message)

    def __call__(self, environ, start_response):
        method = environ.get("REQUEST_METHOD", "GET")
        path = environ.get("PATH_INFO", "/")
        # HEAD serves through GET handlers with the body dropped —
        # net/http gives the reference this for free.
        head = method == "HEAD"
        if head:
            method = "GET"
        matched_path = False
        for m, regex, fn, lane in self._routes:
            match = regex.match(path)
            if match is None:
                continue
            matched_path = True
            if m != method:
                continue
            try:
                if lane is None:
                    resp = fn(Request(environ, match.groupdict()))
                else:
                    # Tenant principal for the import and schema lanes:
                    # header > {index} path segment > default, resolved
                    # before the slot is taken.
                    vars_ = match.groupdict()
                    tenant = (environ.get("HTTP_X_PILOSA_TENANT", "")
                              or vars_.get("index", ""))
                    with self._admitted(lane, tenant=tenant):
                        resp = fn(Request(environ, vars_))
            except HTTPError as e:
                resp = Response(e.status, (e.message + "\n").encode(),
                                "text/plain; charset=utf-8",
                                headers=e.headers)
            except PilosaError as e:
                resp = Response(400, (str(e) + "\n").encode(),
                                "text/plain; charset=utf-8")
            except Exception as e:  # noqa: BLE001 - surface as 500
                self.logger.printf("http error: %s %s: %s", method, path, e)
                resp = Response(500, (str(e) + "\n").encode(),
                                "text/plain; charset=utf-8")
            break
        else:
            status = 405 if matched_path else 404
            resp = Response(status,
                            (_STATUS_TEXT[status] + "\n").encode(),
                            "text/plain; charset=utf-8")
        status_line = (
            f"{resp.status} {_STATUS_TEXT.get(resp.status, 'Unknown')}")
        if isinstance(resp.body, bytes):
            start_response(status_line,
                           [("Content-Type", resp.content_type),
                            ("Content-Length", str(len(resp.body)))]
                           + resp.headers)
            return [] if head else [resp.body]
        # Streamed body (CSV export): never buffered whole.
        start_response(status_line, [("Content-Type", resp.content_type)]
                       + resp.headers)
        return resp.body

    # -- meta ----------------------------------------------------------------

    def _handle_webui(self, req: Request) -> Response:
        # The embedded console (reference webui/, handler.go:132-145).
        return Response(200, webui.page_bytes(), "text/html; charset=utf-8")

    def _handle_asset(self, req: Request) -> Response:
        # Its static assets (reference handler.go:84 /assets/{file}).
        got = webui.asset(req.vars["file"])
        if got is None:
            raise HTTPError(404, "asset not found")
        body, ctype = got
        return Response(200, body, ctype)

    def _handle_get_version(self, req: Request) -> Response:
        return Response.json({"version": self.version})

    def _handle_get_hosts(self, req: Request) -> Response:
        if self.cluster is None:
            return Response.json([{"host": self.host, "internalHost": ""}]
                                 if self.host else [])
        return Response.json([{"host": n.host,
                               "internalHost": n.internal_host}
                              for n in self.cluster.nodes])

    def _handle_get_status(self, req: Request) -> Response:
        """Every node of the cluster with its state and, per index, the
        max slice, the slices it owns and the frames — the JAX server's
        JSON shape (server.go:306-351); protobuf ``ClusterStatus`` when
        asked."""
        if self.status_handler is not None:
            cs = self.status_handler.cluster_status()
        else:
            cs = pb.ClusterStatus(Nodes=[_local_status(
                self.holder, self.host, None)])
        if _PROTOBUF in req.accept:
            return Response.proto(cs)
        out = {"status": {"nodes": [
            {"host": ns.Host, "state": ns.State,
             "indexes": [{"name": ix.Name, "maxSlice": ix.MaxSlice,
                          "slices": np.asarray(ix.Slices).tolist(),
                          "frames": [{"name": f.Name} for f in ix.Frames]}
                         for ix in ns.Indexes]}
            for ns in cs.Nodes]}}
        fault = getattr(self.status_handler, "fault", None)
        if (fault is not None and self.cluster is not None
                and len(self.cluster.nodes) > 1):
            # Peer health and breakers, the JAX server's fault block.
            out["fault"] = fault.snapshot()
        # Build identity, and the runtime collector's sample (holder,
        # residency and container sizes), the JAX server's blocks.
        out["build"] = obs_runtime.build_info()
        if self.warmup is not None:
            # Cold-start warmup state (sched.warmup), the JAX block.
            out["warmup"] = self.warmup.to_json()
        if self.runtime is not None:
            out["runtime"] = self.runtime.snapshot()
        if self.watchdog is not None:
            out["watchdog"] = self.watchdog.snapshot()
        return Response.json(out)

    def _handle_get_schema(self, req: Request) -> Response:
        return Response.json({"indexes": self.holder.schema()})

    def _handle_slice_max(self, req: Request) -> Response:
        inverse = req.query.get("inverse") == "true"
        ms = (self.holder.max_inverse_slices() if inverse
              else self.holder.max_slices())
        if _PROTOBUF in req.accept:
            return Response.proto(pb.MaxSlicesResponse(MaxSlices=ms))
        return Response.json({"maxSlices": ms})

    # -- index CRUD ----------------------------------------------------------

    def _handle_get_index(self, req: Request) -> Response:
        idx = self.holder.index(req.vars["index"])
        if idx is None:
            raise HTTPError(404, "index not found")
        return Response.json({"index": {"name": idx.name}})

    @staticmethod
    def _validate_options(body: dict, valid: set[str]) -> dict:
        # handler.go:299-351: any unknown key is an error.
        for k in body:
            if k != "options":
                raise HTTPError(400, f"Unknown key: {k}")
        options = body.get("options", {})
        if not isinstance(options, dict):
            raise HTTPError(400, "options is not map")
        for k in options:
            if k not in valid:
                raise HTTPError(400, f"Unknown key: {k}:{options[k]}")
        return options

    def _handle_post_index(self, req: Request) -> Response:
        name = req.vars["index"]
        opts = self._validate_options(req.json(), _VALID_INDEX_OPTIONS)
        options = IndexOptions(
            column_label=opts.get("columnLabel", "columnID"),
            time_quantum=tq.parse_time_quantum(opts.get("timeQuantum", "")))
        validate_label(options.column_label)
        try:
            self.holder.create_index(name, options)
        except IndexExistsError as e:
            raise HTTPError(409, str(e))
        self.broadcaster.send_sync(pb.CreateIndexMessage(
            Index=name, Meta=options.encode()))
        return Response.json({})

    def _handle_delete_index(self, req: Request) -> Response:
        name = req.vars["index"]
        self.holder.delete_index(name)
        self.broadcaster.send_sync(pb.DeleteIndexMessage(Index=name))
        return Response.json({})

    def _handle_patch_index_time_quantum(self, req: Request) -> Response:
        q = tq.parse_time_quantum(req.json().get("timeQuantum", ""))
        idx = self.holder.index(req.vars["index"])
        if idx is None:
            raise HTTPError(404, "index not found")
        idx.set_time_quantum(q)
        return Response.json({})

    # -- frame CRUD ----------------------------------------------------------

    def _handle_post_frame(self, req: Request) -> Response:
        index_name, frame_name = req.vars["index"], req.vars["frame"]
        opts = self._validate_options(req.json(), _VALID_FRAME_OPTIONS)
        idx = self.holder.index(index_name)
        if idx is None:
            raise HTTPError(404, "index not found")
        options = FrameOptions(
            row_label=opts.get("rowLabel", "rowID"),
            inverse_enabled=bool(opts.get("inverseEnabled", False)),
            cache_type=opts.get("cacheType", "lru"),
            cache_size=int(opts.get("cacheSize", 50000)),
            time_quantum=tq.parse_time_quantum(opts.get("timeQuantum", "")),
            fields=self._parse_fields_option(opts.get("fields")))
        try:
            idx.create_frame(frame_name, options)
        except FrameExistsError as e:
            raise HTTPError(409, str(e))
        self.broadcaster.send_sync(pb.CreateFrameMessage(
            Index=index_name, Frame=frame_name, Meta=options.encode()))
        return Response.json({})

    def _handle_delete_frame(self, req: Request) -> Response:
        index_name, frame_name = req.vars["index"], req.vars["frame"]
        idx = self.holder.index(index_name)
        if idx is None:
            return Response.json({})
        idx.delete_frame(frame_name)
        self.broadcaster.send_sync(pb.DeleteFrameMessage(
            Index=index_name, Frame=frame_name))
        return Response.json({})

    def _handle_patch_frame_time_quantum(self, req: Request) -> Response:
        q = tq.parse_time_quantum(req.json().get("timeQuantum", ""))
        frame = self.holder.frame(req.vars["index"], req.vars["frame"])
        if frame is None:
            raise HTTPError(404, "frame not found")
        frame.set_time_quantum(q)
        return Response.json({})

    def _handle_get_frame_views(self, req: Request) -> Response:
        frame = self.holder.frame(req.vars["index"], req.vars["frame"])
        if frame is None:
            raise HTTPError(404, "frame not found")
        return Response.json({"views": sorted(frame.views)})

    @staticmethod
    def _parse_fields_option(raw):
        if raw is None:
            return None
        if not isinstance(raw, list):
            raise HTTPError(400, "fields is not a list")
        out = []
        for o in raw:
            if not isinstance(o, dict) or "name" not in o:
                raise HTTPError(400, f"invalid field: {o!r}")
            for k in o:
                if k not in ("name", "min", "max"):
                    raise HTTPError(400, f"Unknown key: {k}:{o[k]}")
            try:
                out.append(Field(name=o["name"],
                                 min=int(o.get("min", 0)),
                                 max=int(o.get("max", 0))))
            except (TypeError, ValueError) as e:
                raise HTTPError(400, str(e))
        return out

    # -- BSI integer fields --------------------------------------------------

    def _handle_get_frame_fields(self, req: Request) -> Response:
        frame = self.holder.frame(req.vars["index"], req.vars["frame"])
        if frame is None:
            raise HTTPError(404, "frame not found")
        return Response.json(
            {"fields": [f.to_json() for f in frame.fields()]})

    def _handle_post_frame_field(self, req: Request) -> Response:
        """Create one BSI field on an existing frame (body: ``{"min": N,
        "max": M}``); the frame's meta is broadcast again so peers
        register the field too."""
        index_name, frame_name = req.vars["index"], req.vars["frame"]
        frame = self.holder.frame(index_name, frame_name)
        if frame is None:
            raise HTTPError(404, "frame not found")
        body = req.json()
        for k in body:
            if k not in ("min", "max"):
                raise HTTPError(400, f"Unknown key: {k}:{body[k]}")
        try:
            field = Field(name=req.vars["field"],
                          min=int(body.get("min", 0)),
                          max=int(body.get("max", 0)))
        except (TypeError, ValueError) as e:
            raise HTTPError(400, str(e))
        frame.create_field(field)
        self.broadcaster.send_sync(pb.CreateFrameMessage(
            Index=index_name, Frame=frame_name,
            Meta=frame.options.encode()))
        return Response.json({})

    def _handle_post_field_import(self, req: Request) -> Response:
        """Bulk field-value import: a protobuf ``ImportValueRequest``
        (answered in protobuf) or the JSON form ``{"columns": [...],
        "values": [...]}``, acked after the commit barrier."""
        index_name, frame_name = req.vars["index"], req.vars["frame"]
        field_name = req.vars["field"]
        if req.content_type == _PROTOBUF:
            ireq = pb.ImportValueRequest.FromString(req.body())
            if (ireq.Index, ireq.Frame, ireq.Field) != (
                    index_name, frame_name, field_name):
                raise HTTPError(400, "import target mismatch")
            cols = np.asarray(ireq.ColumnIDs, dtype=np.uint64)
            vals = np.asarray(ireq.Values, dtype=np.int64)
            self._check_owner(index_name, ireq.Slice)
        else:
            body = req.json()
            cols = np.asarray(body.get("columns", []), dtype=np.uint64)
            vals = np.asarray(body.get("values", []), dtype=np.int64)
            # Every touched slice must be this node's (412 otherwise,
            # nothing applied).
            for slice in np.unique(cols // np.uint64(SLICE_WIDTH)).tolist():
                self._check_owner(index_name, slice)
        if len(cols) != len(vals):
            raise HTTPError(400, "import array length mismatch")
        frame = self.holder.frame(index_name, frame_name)
        if frame is None:
            raise HTTPError(404, "frame not found")
        if frame.field(field_name) is None:
            raise HTTPError(404, "field not found")
        frame.import_field_values(field_name, cols, vals)
        storage_wal.barrier_all()  # commit before the 200
        obs_metrics.IMPORT_BITS.labels("field_values").inc(len(cols))
        if req.content_type == _PROTOBUF:
            return Response.proto(pb.ImportResponse())
        return Response.json({})

    # -- query lifecycle (sched) ---------------------------------------------

    def _query_timeout_s(self, req: Request) -> Optional[float]:
        """Deadline budget for this request: ``X-Pilosa-Deadline``
        (remaining seconds) wins over ``?timeout=`` (Go-style duration,
        the client-facing form), which wins over the configured
        default. None = unbounded."""
        hdr = req.environ.get("HTTP_X_PILOSA_DEADLINE", "")
        if hdr:
            try:
                return max(float(hdr), 0.001)
            except ValueError:
                raise HTTPError(400, f"invalid X-Pilosa-Deadline: {hdr}")
        arg = req.query.get("timeout")
        if arg:
            try:
                return max(parse_duration(arg), 0.001)
            except ValueError:
                raise HTTPError(400, f"invalid timeout: {arg}")
        return self.default_timeout_s or None

    def _admit(self, lane: str, ctx=None, tenant: str = ""):
        """Acquire an execution slot (None admission = unlimited, for
        bare handlers). AdmissionFullError maps to 429 with the
        controller's Retry-After estimate; a deadline that expires while
        queued maps like any other expiry (504) — the query never held
        a slot. A write while the node is write-unready answers 507
        first (``_check_writable``)."""
        self._check_writable(lane)
        if self.admission is None:
            return None
        try:
            return self.admission.acquire(lane, ctx,
                                          tenant=tenant or None)
        except AdmissionFullError as e:
            if self.stats is not None:
                self.stats.count("queriesRejected", 1)
            obs_metrics.ADMISSION_REJECTED.labels(lane).inc()
            if e.tenant:
                # Tenant-scoped shed: only the offending tenant 429s.
                if self.tenants is not None:
                    self.tenants.note_shed(e.tenant, lane)
                else:
                    obs_metrics.TENANT_SHED.labels(e.tenant, lane).inc()
            raise HTTPError(
                429, f"too many requests: {e}",
                headers=[("Retry-After", str(int(e.retry_after_s)))])

    def _check_writable(self, lane: str) -> None:
        """Disk-full graceful degradation (fault.diskfull): while the
        node is write-unready after ENOSPC, writes answer 507 +
        Retry-After INSTEAD of being admitted into a doomed WAL append —
        reads and admin keep serving. The throttled probe inside
        write_ready() is also the auto-recovery path."""
        if lane != LANE_WRITE:
            return
        if fault_diskfull.write_ready():
            return
        st = fault_diskfull.default()
        raise HTTPError(
            507, "insufficient storage: node is write-unready after"
                 " ENOSPC (reads still serving; retry after space"
                 " frees)",
            headers=[("Retry-After", str(st.retry_after_s()))])

    @contextlib.contextmanager
    def _admitted(self, lane: str, tenant: str = ""):
        """Slot-scoped admission for the non-query lanes (imports ride
        ``write``, schema mutations ``admin``)."""
        slot = self._admit(lane, tenant=tenant)
        try:
            yield
        finally:
            if slot is not None:
                slot.release()

    # -- query (handler.go:811-893) ------------------------------------------

    def _handle_post_query(self, req: Request) -> Response:
        index_name = req.vars["index"]
        proto_out = _PROTOBUF in req.accept

        def error_resp(status, msg, headers=()):
            if proto_out:
                return Response.proto(pb.QueryResponse(Err=msg), status,
                                      headers=headers)
            return Response.json({"error": msg}, status, headers=headers)

        remote = False
        if req.content_type == _PROTOBUF:
            preq = pb.QueryRequest.FromString(req.body())
            query_str = preq.Query
            slices = np.asarray(preq.Slices).tolist()
            column_attrs = preq.ColumnAttrs
            remote = preq.Remote
        else:
            query_str = req.body().decode()
            try:
                slices = [int(s)
                          for s in req.query.get("slices", "").split(",")
                          if s != ""]
            except ValueError:
                return error_resp(400, "invalid slice argument")
            column_attrs = req.query.get("columnAttrs") == "true"
        parse_wall = time.time()
        parse_t0 = time.perf_counter()
        try:
            query = pql.parse(query_str)
        except PilosaError as e:
            return error_resp(400, str(e))
        parse_s = time.perf_counter() - parse_t0
        if req.query.get("plan") == "1" and not remote:
            # EXPLAIN-only: the plan tree (estimates and decisions), no
            # execution.
            try:
                tree = self.executor.explain(index_name, query,
                                             slices or None)
            except PilosaError as e:
                return error_resp(400, str(e))
            return Response.json({"results": [], "plan": tree})

        # Lifecycle: classify the lane, build the QueryContext, attach
        # the ledger, the kill policy and the trace, register, admit.
        lane = (LANE_WRITE
                if any(c.name in _WRITE_CALLS for c in query.calls)
                else LANE_READ)
        tenant = req.environ.get("HTTP_X_PILOSA_TENANT", "") or index_name
        ctx = QueryContext(
            pql=query_str, index=index_name, lane=lane,
            timeout_s=self._query_timeout_s(req),
            id=req.environ.get("HTTP_X_PILOSA_QUERY_ID", "") or None,
            remote=remote, node=self.host, tenant=tenant)
        ctx.stages["parse"] = parse_s
        # ?profile=1 asks for EXPLAIN ANALYZE: exact per-node actual
        # cardinalities on top of the always-on wall times.
        ctx.profile = req.query.get("profile") == "1"
        if self.accounting:
            obs_accounting.attach(ctx, node=self.host)
        if self.tenants is not None:
            self.tenants.install(ctx)
        trace = None
        # A coordinator asks its leg to trace itself (X-Pilosa-Trace);
        # the leg's spans ride back on the answer for stitching. With
        # tail sampling wired, EVERY query buffers spans and the keep
        # decision runs at query end instead.
        trace_requested = (
            self.tracer.enabled or req.query.get("trace") == "1"
            or (remote and req.environ.get(
                "HTTP_X_PILOSA_TRACE", "") == "1"))
        if trace_requested or self.sampler is not None:
            trace = self.tracer.start(ctx, node=self.host)
            trace.add_span("parse", parse_wall, parse_s)
        # Query latency label set: one call name when the query is
        # homogeneous, "multi" otherwise (bounded cardinality).
        call_names = {c.name for c in query.calls}
        call_label = call_names.pop() if len(call_names) == 1 else "multi"

        def _resp_headers() -> list:
            # The id rides every response; the ledger's compact roll-up
            # too (X-Pilosa-Stats). A coordinator's leg also carries its
            # served slices' generation tokens, its spans when traced
            # and its full cost tree (X-Pilosa-Cost), error answers too.
            hs = [("X-Pilosa-Query-Id", ctx.id)]
            if remote:
                gh = self._generations_header(index_name, slices)
                if gh is not None:
                    hs.append(gh)
                if trace is not None:
                    hs.append((obs_trace.SPANS_HEADER, trace.spans_json()))
            if ctx.cost is not None:
                hs.append((obs_accounting.STATS_HEADER,
                           json.dumps(ctx.cost.summary(),
                                      separators=(",", ":"))))
                if remote:
                    hs.append((obs_accounting.COST_HEADER,
                               ctx.cost.wire_json(dict(ctx.stages))))
            if ctx.result_digest:
                # The canonical result digest (obs.capture), set at query
                # end on success only.
                hs.append((obs_capture.DIGEST_HEADER, ctx.result_digest))
            return hs

        # Register BEFORE admission so a queued query is visible at
        # /debug/queries and cancellable while it waits.
        slot = None
        err: Optional[BaseException] = None
        results = None
        # Degraded reads (?partial=1): slices with no reachable replica
        # are skipped and reported in X-Pilosa-Partial instead of
        # failing the whole query. Coordinator-only: a forwarded leg
        # answers strictly so its coordinator decides the degradation.
        exec_opt = ExecOptions(
            remote=remote, ctx=ctx,
            partial=req.query.get("partial") == "1" and not remote,
            missing_slices=[])
        self.registry.register(ctx)
        try:
            # A coordinator's leg was admitted once, at its coordinator:
            # admitting it again could deadlock a saturated cluster.
            if not remote:
                with ctx.stage("admission"):
                    slot = self._admit(lane, ctx)
            ctx.state = "running"
            with ctx.stage("execute"):
                results = self.executor.execute(
                    index_name, query, slices or None, exec_opt)
            if lane == LANE_WRITE:
                # Commit barrier before the ack: every mutation this
                # query applied has its WAL record in the OS (fsynced
                # per the fsync policy) when the response goes out. Bound
                # as the thread's query, so a wal.append failpoint hit
                # in THIS barrier flags its context for the sampler.
                with ctx.stage("commit"), sched_context.use(ctx):
                    storage_wal.barrier_all()
        except HTTPError as e:  # 429 / 507 from _admit
            err = e
            raise
        except QueryDeadlineError as e:
            err = e
            return error_resp(504, str(e), headers=_resp_headers())
        except QueryKilledError as e:
            # Cost-policy kill: a DISTINCT status so clients tell a
            # budget kill from an operator cancel.
            err = e
            hs = _resp_headers()
            hs.append((KILLED_BY_HEADER, KILL_POLICY))
            return error_resp(402, str(e), headers=hs)
        except QueryCancelledError as e:
            err = e
            return error_resp(409, str(e), headers=_resp_headers())
        except storage_wal.WalError as e:
            # A barrier that failed on a full disk (fault.diskfull has
            # already flipped the node write-unready at the WAL site) is
            # retryable: 507 + Retry-After. Any other WAL failure stays
            # a 500.
            err = e
            if not fault_diskfull.write_ready(probe=False):
                hs = _resp_headers()
                hs.append(("Retry-After", str(
                    fault_diskfull.default().retry_after_s())))
                return error_resp(
                    507, f"insufficient storage: write not durable ({e})",
                    headers=hs)
            self.logger.printf("query commit barrier failed: %s", e)
            return error_resp(500, str(e), headers=_resp_headers())
        except SliceUnavailableError as e:
            # No reachable (or trustworthy — storage quarantine) copy of
            # a touched slice anywhere: a retryable 503, not a 400.
            err = e
            return error_resp(503, f"slice unavailable: {e}",
                              headers=_resp_headers())
        except PilosaError as e:
            err = e
            return error_resp(400, str(e), headers=_resp_headers())
        except Exception as e:  # noqa: BLE001 - surfaced in response
            err = e
            self.logger.printf("query error: index=%s query=%.120s: %s",
                               index_name, query_str, e)
            return error_resp(500, str(e), headers=_resp_headers())
        finally:
            if slot is not None:
                slot.release()
            self._finish_query(ctx, err, trace, call_label, query_str,
                               req.query.get("trace") == "1",
                               trace_requested and remote,
                               partial=bool(exec_opt.missing_slices),
                               results=results, req=req)

        # Optional column-attribute join (handler.go:208-227).
        attr_sets = []
        if column_attrs:
            idx = self.holder.index(index_name)
            arrs = [r.bits() for r in results if isinstance(r, Bitmap)]
            ids = (np.unique(np.concatenate(arrs)).tolist()
                   if arrs else [])
            for id in ids:
                attrs = idx.column_attr_store.attrs(id)
                if attrs:
                    attr_sets.append((id, attrs))
        headers = _resp_headers()
        if exec_opt.missing_slices:
            # The degraded-result contract: the client SEES which slices
            # are missing from these results.
            headers.append(("X-Pilosa-Partial", ",".join(
                str(s) for s in sorted(exec_opt.missing_slices))))
            obs_metrics.PARTIAL_RESULTS.inc()
        with ctx.stage("encode"):
            if proto_out:
                return Response.proto(
                    codec.encode_query_response(results, attr_sets),
                    headers=headers)
            payload = codec.query_response_json(results, attr_sets)
            if ctx.profile and ctx.cost is not None:
                # The per-stage cost tree rides inline with the results.
                payload["profile"] = ctx.cost.to_tree(dict(ctx.stages))
            if ctx.profile and ctx.plan is not None:
                # The chosen plan with per-node est-vs-actual rows.
                payload["plan"] = ctx.plan.to_tree()
            return Response.json(payload, headers=headers)

    @staticmethod
    def _status_of(err: Optional[BaseException]) -> int:
        if isinstance(err, HTTPError):
            return err.status
        if isinstance(err, QueryDeadlineError):
            return 504
        if isinstance(err, QueryKilledError):
            return 402
        if isinstance(err, QueryCancelledError):
            return 409
        if (isinstance(err, storage_wal.WalError)
                and not fault_diskfull.write_ready(probe=False)):
            return 507
        if isinstance(err, SliceUnavailableError):
            return 503
        if isinstance(err, PilosaError):
            return 400
        if err is not None:
            return 500
        return 200

    def _finish_query(self, ctx, err, trace, call_label: str,
                      query_str: str, trace_asked: bool,
                      remote_asked: bool = False,
                      partial: bool = False, results=None,
                      req: Optional[Request] = None) -> None:
        """Query end: the keep decision (the tail sampler's, or an
        explicit ask: the tracer on, ``?trace=1``, a coordinator-asked
        leg when no sampler runs here), feed the plan store, the result
        digest and the capture record, finish the registry entry, and
        record the latency, outcome and chargeback metrics — for every
        outcome, 429/504/409 included."""
        status = self._status_of(err)
        if trace is not None:
            if ctx.cost is not None:
                # Cost roll-up as span args.
                trace.add_span("query_cost", ctx.started_wall, 0.0,
                               tags=ctx.cost.summary())
            if ctx.plan is not None and (ctx.plan.sample
                                         or ctx.plan.analyze):
                tags = {"fingerprint": ctx.plan.fingerprint}
                tags.update(ctx.plan.decision_summary())
                trace.add_span("query_plan", ctx.started_wall, 0.0,
                               tags=tags)
            reason = None
            if self.sampler is not None:
                reason = self.sampler.decide(ctx, err=err, status=status,
                                             partial=partial)
            # Explicit keeps: the tracer on and ?trace=1 always; a
            # coordinator-asked leg only when no sampler runs here —
            # with tail sampling on, every leg carries the header, and
            # the peer's own tail decision keeps the interesting legs.
            if reason is None and (
                    self.tracer.enabled or trace_asked
                    or (remote_asked and self.sampler is None)):
                reason = "requested"
            if trace.keep_reason:
                reason = trace.keep_reason  # already kept mid-flight
            elif reason is not None:
                # keep() claims atomically: a racing force-keep wins and
                # its reason is reported instead.
                if self.tracer.keep(trace, reason=reason):
                    if self.sampler is not None:
                        self.sampler.persist(trace, reason, ctx=ctx)
                else:
                    reason = trace.keep_reason or reason
            ctx.trace_kept = reason is not None
            ctx.keep_reason = reason or ""
        if ctx.plan is not None and (ctx.plan.sample or ctx.plan.analyze):
            # Per-fingerprint aggregation behind /debug/plans: fresh
            # plans and a 1-in-16 slice of memo hits record.
            est = actual = None
            for root in ctx.plan.roots:
                if (root.est_rows is not None
                        and root.actual_rows is not None):
                    est, actual = root.est_rows, root.actual_rows
                    break
            self.executor.plan_store.record(
                ctx.plan.fingerprint, ctx.plan.to_tree, ctx.elapsed(),
                pql=query_str, est_rows=est, actual_rows=actual)
        # The canonical result digest (obs.capture): the value of
        # X-Pilosa-Result-Digest and the shadow diff's comparison key.
        # Coordinator only (a leg's partial results are not an answer)
        # and success only.
        if err is None and not ctx.remote and results is not None:
            try:
                ctx.result_digest = obs_capture.result_digest(
                    [codec.result_to_json(r) for r in results])
            except Exception:  # noqa: BLE001 - observability only
                pass
        # Workload capture: the replayable record, appended before the
        # registry's finish so the slow-log entry links the capture id.
        cap = self.capture
        if (cap is not None and cap.enabled and not ctx.remote
                and cap.should_capture(ctx.lane)):
            opts = {}
            query = req.query if req is not None else {}
            if query.get("timeout"):
                opts["timeout"] = query["timeout"]
            if query.get("partial") == "1":
                opts["partial"] = True
            ctx.capture_id = cap.add(
                "query", query_str, ctx.index, ctx.tenant, ctx.lane,
                ctx.id, status, ctx.elapsed(), digest=ctx.result_digest,
                plan=(ctx.plan.fingerprint if ctx.plan is not None
                      else ""),
                opts=opts or None, wall=ctx.started_wall,
                mono=ctx.started)
        self.registry.finish(ctx, error=err)
        labels = (call_label, ctx.lane, str(status))
        # The latency observation carries the query id as an
        # OpenMetrics exemplar.
        obs_metrics.QUERY_SECONDS.labels(*labels).observe(
            ctx.elapsed(), exemplar={"trace_id": ctx.id})
        obs_metrics.QUERIES_TOTAL.labels(*labels).inc()
        tlabel = ctx.tenant or "default"
        obs_metrics.TENANT_QUERY_SECONDS.labels(tlabel).observe(
            ctx.elapsed())
        obs_metrics.TENANT_QUERIES.labels(tlabel, str(status)).inc()
        cost = ctx.cost
        if cost is not None:
            for resource, amount in (
                    ("container_ops", sum(cost.container_ops.values())),
                    ("words_scanned", cost.words_scanned),
                    ("bits_written", cost.bits_written),
                    ("device_bytes", cost.device_bytes),
                    ("queue_wait_ms",
                     int(ctx.stages.get("admission", 0.0) * 1e3)),
                    ("wall_us", int(ctx.elapsed() * 1e6))):
                if amount:
                    obs_metrics.TENANT_COST_UNITS.labels(
                        tlabel, resource).inc(amount)

    # -- profiling (reference handler.go:30,99 mounts net/http/pprof) --------

    def _handle_pprof_index(self, req: Request) -> Response:
        return Response(
            200, b"profile: sampled CPU profile (?seconds=N, default 5)\n"
                 b"threads: stack dump of all live threads\n"
                 b"flame: continuous-profiler folded stacks"
                 b" (?query=<id> filters to one query;"
                 b" speedscope/flamegraph.pl-loadable)\n"
                 b"heap: tracemalloc allocation sites (?n=N, default"
                 b" 30); GET is read-only, POST ?op=start|stop"
                 b" arms/disarms\n",
            "text/plain; charset=utf-8")

    def _handle_pprof_heap(self, req: Request) -> Response:
        """Read-only heap report; arming and disarming tracemalloc
        mutate interpreter-wide state, so they live on POST."""
        try:
            top_n = int(req.query.get("n", "30"))
        except ValueError:
            raise HTTPError(400, "invalid n")
        return Response(200, profiling.heap_report(
            max(1, min(top_n, 500))).encode(), "text/plain; charset=utf-8")

    def _handle_pprof_heap_post(self, req: Request) -> Response:
        """Arm or disarm tracemalloc: POST ?op=start | ?op=stop."""
        op = req.query.get("op", "start")
        if op == "start":
            body = profiling.heap_start()
        elif op == "stop":
            body = profiling.heap_stop()
        else:
            raise HTTPError(400, f"invalid op: {op} (start|stop)")
        return Response(200, body.encode(), "text/plain; charset=utf-8")

    def _handle_pprof_flame(self, req: Request) -> Response:
        """Continuous-profiler export: collapsed stacks over the bounded
        sample ring; ``?query=<id>`` keeps the samples tagged with that
        query, ``?since=<dur>`` the recent ones."""
        since_s = 0.0
        if req.query.get("since"):
            try:
                since_s = parse_duration(req.query["since"])
            except ValueError:
                raise HTTPError(400, "invalid since")
        body = self.profiler.flame(query=req.query.get("query", ""),
                                   since_s=since_s)
        return Response(200, body.encode(), "text/plain; charset=utf-8")

    def _handle_pprof_profile(self, req: Request) -> Response:
        try:
            seconds = float(req.query.get("seconds", "5"))
        except ValueError:
            raise HTTPError(400, "invalid seconds")
        if not math.isfinite(seconds):
            raise HTTPError(400, "invalid seconds")
        seconds = min(max(seconds, 0.1), 120.0)
        return Response(200, profiling.sample_profile(seconds).encode(),
                        "text/plain; charset=utf-8")

    def _handle_pprof_threads(self, req: Request) -> Response:
        return Response(200, profiling.thread_dump().encode(),
                        "text/plain; charset=utf-8")

    # -- the flight recorder, history, sentinel and capture ------------------

    def _handle_debug_blackbox(self, req: Request) -> Response:
        """Flight-recorder state: ring and dump stats, the most recent
        snapshots (``?limit=N``, default 8) and the watchdog's trip
        record."""
        try:
            limit = max(0, int(req.query.get("limit", "8")))
        except ValueError:
            raise HTTPError(400, "invalid limit")
        out: dict = {"enabled": self.blackbox is not None}
        if self.blackbox is not None:
            out.update(self.blackbox.stats())
            snaps = []
            if limit:
                for rec in self.blackbox.ring.scan():
                    snaps.append(rec)
                    if len(snaps) >= limit:
                        break
            out["recent"] = snaps
        if self.watchdog is not None:
            out["watchdog"] = self.watchdog.snapshot()
        return Response.json(out)

    def _handle_post_blackbox_dump(self, req: Request) -> Response:
        """Force a full flight-recorder dump (cause ``api``)."""
        if self.blackbox is None:
            raise HTTPError(404, "no blackbox recorder")
        path = self.blackbox.dump("api")
        if path is None:
            raise HTTPError(500, "blackbox dump failed")
        return Response.json({"dumped": path})

    def _handle_metrics_history(self, req: Request) -> Response:
        """The on-disk metric history as JSON series: ``?family=``
        selects a family (and its derived ``:p50``/``:p99``/``:rate``
        forms), ``?label=k=v[,k=v]`` filters, ``?window=``/``?step=``
        pick the trailing window and resolution hint; ``?scope=cluster``
        asks every node and attributes each series to its node."""
        family = req.query.get("family", "")
        window_s, step_s = 3600.0, 0.0
        try:
            if req.query.get("window"):
                window_s = parse_duration(req.query["window"])
            if req.query.get("step"):
                step_s = parse_duration(req.query["step"])
        except ValueError:
            raise HTTPError(400, "invalid window/step")
        label_filter: dict = {}
        for pair in (req.query.get("label") or "").split(","):
            if not pair:
                continue
            k, sep, v = pair.partition("=")
            if not sep:
                raise HTTPError(400, f"invalid label filter: {pair!r}")
            label_filter[k] = v

        def local() -> dict:
            if self.history is None:
                return {"family": family, "series": [],
                        "enabled": False}
            return self.history.series(
                family, label_filter or None, window_s, step_s)

        if req.query.get("scope") != "cluster":
            out = local()
            out.setdefault("enabled", self.history is not None)
            return Response.json(out)
        fed = self.federator

        def fetch(host: str) -> dict:
            return fed.client_for(host).metrics_history(
                family=family, label=req.query.get("label", ""),
                window=req.query.get("window", ""),
                step=req.query.get("step", ""), host=host,
                deadline_s=fed.peer_timeout_s)

        results, missing = fed.fan_out(fetch, local)
        headers: list = []
        self._partial_or_503(req, missing, headers)
        series = []
        for host in sorted(results):
            for s in results[host].get("series") or []:
                series.append({**s, "node": host})
        return Response.json(
            {"family": family, "scope": "cluster",
             "windowS": window_s, "missing": missing,
             "series": series},
            headers=headers)

    def _handle_debug_sentinel(self, req: Request) -> Response:
        """The regression sentinel's recent findings, active conditions
        and rule thresholds."""
        out: dict = {"enabled": self.sentinel is not None}
        if self.sentinel is not None:
            out.update(self.sentinel.snapshot())
        return Response.json(out)

    def _handle_debug_capture(self, req: Request) -> Response:
        """Workload-capture status: mode, sampling, redaction, cursor
        and the ring's byte accounting (disabled without a store)."""
        cap = self.capture
        if cap is None:
            return Response.json({"enabled": False, "mode": "off"})
        out = cap.status()
        out["enabled"] = cap.enabled
        return Response.json(out)

    def _handle_debug_capture_records(self, req: Request) -> Response:
        """Paged capture export: ``?since=<seq>`` (exclusive cursor) and
        ``?limit=`` page the local ring oldest-first, ``next`` is the
        next page's cursor; ``?scope=cluster`` merges every node's
        stream by arrival wall-clock (obs.capture.merge_streams)."""
        try:
            since = int(req.query.get("since", "0"))
            limit = int(req.query.get("limit", "500"))
        except ValueError:
            raise HTTPError(400, "invalid since/limit")

        def local() -> dict:
            cap = self.capture
            recs = cap.export(since=since, limit=limit) \
                if cap is not None else []
            return {"node": self.host, "records": recs,
                    "next": recs[-1]["seq"] if recs else since}

        if req.query.get("scope") != "cluster":
            return Response.json(local())
        fed = self.federator

        def fetch(host: str) -> dict:
            return fed.client_for(host).capture_records(
                since=since, limit=limit, host=host,
                deadline_s=fed.peer_timeout_s)

        results, missing = fed.fan_out(fetch, local)
        headers: list = []
        self._partial_or_503(req, missing, headers)
        merged = obs_capture.merge_streams(
            [r.get("records") or [] for r in results.values()])
        return Response.json(
            {"scope": "cluster", "records": merged,
             "nodes": sorted(results), "missing": missing},
            headers=headers)

    # -- lifecycle and observability routes -----------------------------------

    def _handle_debug_queries(self, req: Request) -> Response:
        out = {"queries": self.registry.active(),
               "slow": self.registry.slow_queries()}
        if self.admission is not None:
            out["admission"] = self.admission.snapshot()
        return Response.json(out)

    def _handle_debug_slow_queries(self, req: Request) -> Response:
        return Response.json({"slow": self.registry.slow_queries()})

    def _handle_delete_query(self, req: Request) -> Response:
        """Cancel every in-flight query registered under the id on this
        node (every executor layer checks the flag cooperatively)."""
        qid = req.vars["qid"]
        n = self.registry.cancel_local(qid)
        if req.query.get("local") != "true":
            # Cluster-wide: peers cancel the legs registered under the
            # same id (``?local=true`` keeps it to this node).
            self.broadcaster.send_async(CancelQueryMessage(qid))
        return Response.json({"id": qid, "cancelled": n})

    def _handle_debug_tenants(self, req: Request) -> Response:
        """The multi-tenant operator view: per tenant — policy and
        effective weight, penalty-box state, in-flight / queued / served
        / shed / killed. The ``writeReady`` block (fault.diskfull) rides
        along, since a write-unready node sheds every tenant's
        writes."""
        rows: dict[str, dict] = {}

        def row(name: str) -> dict:
            return rows.setdefault(name, {})

        if self.tenants is not None:
            for name, snap in self.tenants.snapshot().items():
                row(name).update(snap)
        if self.admission is not None:
            adm = self.admission.snapshot()
            for name, snap in (adm.get("tenants") or {}).items():
                row(name).update(snap)
        if self.tenants is not None:
            for name, r in rows.items():
                if "policy" not in r:
                    score = self.tenants.penalty_score(name)
                    r["policy"] = self.tenants.policy(name).to_json()
                    r["effectiveWeight"] = round(
                        self.tenants.effective_weight(name), 4)
                    r["penaltyScore"] = round(score, 4)
                    r["inPenaltyBox"] = score > 0.0
                    r.setdefault("killed", 0)
                    r.setdefault("shed", 0)
        usage_fn = getattr(self.executor, "tenant_cache_usage", None)
        if callable(usage_fn):
            for name, snap in usage_fn().items():
                row(name)["cache"] = snap
        if self.tenant_slo is not None:
            for name, snap in self.tenant_slo.last().items():
                row(name)["slo"] = snap
        return Response.json({
            "tenants": rows,
            "writeReady": fault_diskfull.default().snapshot(),
        })

    def _handle_debug_traces(self, req: Request) -> Response:
        """The in-memory ring by default; ``?source=disk`` lists the
        PERSISTED kept traces (the tail sampler's segment ring, which
        survives restarts), ``?reason=<keep-reason>`` filters either
        source, ``?limit=N&offset=M`` page through the listing (newest
        first, default limit 100)."""
        from ..obs import sampler as obs_sampler
        reason = req.query.get("reason", "")
        try:
            limit = max(1, int(req.query.get("limit", "100")))
            offset = max(0, int(req.query.get("offset", "0")))
        except ValueError:
            raise HTTPError(400, "invalid limit/offset")
        if req.query.get("source") == "disk":
            disk = self.sampler.disk if self.sampler is not None \
                else None
            traces: list[dict] = []
            matched = 0
            if disk is not None:
                for record in disk.scan():
                    if reason and record.get("reason") != reason:
                        continue
                    matched += 1
                    if matched <= offset:
                        continue
                    if len(traces) < limit:
                        # Keep counting past the page: ``total`` tells
                        # the pager whether another page exists.
                        traces.append(obs_sampler.record_summary(record))
            out = {"enabled": self.tracer.enabled, "source": "disk",
                   "traces": traces, "offset": offset, "limit": limit,
                   "total": matched}
            if disk is not None:
                out["disk"] = disk.stats()
            return Response.json(out)
        traces = self.tracer.traces()
        if reason:
            traces = [t for t in traces if t.get("reason") == reason]
        return Response.json({"enabled": self.tracer.enabled,
                              "tail": self.sampler is not None,
                              "offset": offset, "limit": limit,
                              "total": len(traces),
                              "traces": traces[offset:offset + limit]})

    def _handle_debug_traces_summary(self, req: Request) -> Response:
        """Keep-reason roll-up over both stores: kept traces per reason
        in the in-memory ring and in the on-disk segment ring."""
        ring: dict[str, int] = {}
        for t in self.tracer.traces():
            r = t.get("reason") or "unkept"
            ring[r] = ring.get(r, 0) + 1
        disk_counts: dict[str, int] = {}
        out: dict = {"ring": ring, "disk": disk_counts}
        disk = self.sampler.disk if self.sampler is not None else None
        if disk is not None:
            for record in disk.scan():
                r = str(record.get("reason") or "unknown")
                disk_counts[r] = disk_counts.get(r, 0) + 1
            out["diskStats"] = disk.stats()
        return Response.json(out)

    def _handle_debug_trace(self, req: Request) -> Response:
        """One trace as Chrome trace-event JSON (open in perfetto);
        ``?format=spans`` returns the raw span list instead. A miss in
        the in-memory ring falls back to the tail sampler's disk ring
        (``?source=disk`` goes straight there), so a persisted trace
        stays addressable after a restart."""
        trace = None
        if req.query.get("source") != "disk":
            trace = self.tracer.get(req.vars["qid"])
        if trace is None and self.sampler is not None \
                and self.sampler.disk is not None:
            from ..obs import sampler as obs_sampler
            qid = req.vars["qid"]
            for record in self.sampler.disk.scan():
                if record.get("id") == qid:
                    trace = obs_sampler.record_to_trace(record)
                    break
        if trace is None:
            raise HTTPError(404, "trace not found")
        if req.query.get("format") == "spans":
            return Response.json(
                {"id": trace.id, "reason": trace.keep_reason,
                 "spans": [s.to_json() for s in trace.spans()]})
        return Response.json(trace.to_chrome())

    def _handle_expvar(self, req: Request) -> Response:
        """expvar counters plus the device-path state: the residency
        cache and the cost model (vetoes, constants, drift)."""
        snap = dict(self.stats.snapshot()
                    if hasattr(self.stats, "snapshot") else {})
        snap["deviceBlockCache"] = residency.device_cache().snapshot()
        # The disk-full latch (fault.diskfull), also under
        # /debug/tenants: whether writes are admitted, since when and at
        # which site they stopped, and the recoveries.
        snap["writeReady"] = fault_diskfull.default().snapshot()
        vetoes = getattr(self.executor, "cost_vetoes", None)
        if vetoes is not None:
            snap["costModelVetoes"] = vetoes
            snap["coldAdmits"] = self.executor.cold_admits
        model = getattr(self.executor, "cost_model", None)
        if model is not None:
            snap["costModel"] = {"syncS": model.cal.sync_s,
                                 "hostBps": model.cal.host_bps,
                                 "margin": model.margin,
                                 "drift": model.drift_snapshot()}
        return Response.json(snap)

    def _handle_debug_plans(self, req: Request) -> Response:
        """The bounded per-fingerprint plan store (plan.store), hottest
        first (``?limit=N``), with the planner's own state."""
        try:
            limit = max(1, int(req.query.get("limit", "64")))
        except ValueError:
            raise HTTPError(400, "invalid limit")
        out: dict = {"enabled": bool(getattr(self.executor,
                                             "planner_enabled", False))}
        store = getattr(self.executor, "plan_store", None)
        if store is not None:
            out.update(store.snapshot(limit=limit))
        planner = getattr(self.executor, "planner", None)
        if planner is not None:
            out["planner"] = planner.snapshot()
        return Response.json(out)

    def _handle_metrics(self, req: Request) -> Response:
        """Prometheus text exposition of the process registry (0.0.4,
        or OpenMetrics with exemplars when the scraper asks). The cheap
        gauges and the roaring op counters refresh at scrape time."""
        if "application/openmetrics-text" in req.accept:
            self._refresh_scrape_gauges()
            body = obs_metrics.default_registry().render(
                openmetrics=True).encode()
            return Response(
                200, body,
                "application/openmetrics-text; version=1.0.0;"
                " charset=utf-8")
        return Response(200, self._local_metrics_text().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")

    def _local_metrics_text(self) -> str:
        """The local 0.0.4 exposition exactly as /metrics serves it —
        also the body the /metrics/cluster local leg merges."""
        self._refresh_scrape_gauges()
        return obs_metrics.default_registry().render()

    # -- fleet observability (obs.federate) ----------------------------------

    def _partial_or_503(self, req: Request, missing: list[str],
                        headers: list) -> None:
        """The federation partial contract: unreachable peers fail the
        request unless ``?partial=1``, in which case the merged answer
        is served and the missing nodes ride
        ``X-Pilosa-Partial-Nodes``."""
        if not missing:
            return
        if req.query.get("partial") != "1":
            raise HTTPError(
                503, "federation incomplete; unreachable nodes: "
                     + ",".join(missing)
                     + " (retry with ?partial=1 for a marked partial"
                       " rollup)")
        headers.append(("X-Pilosa-Partial-Nodes", ",".join(missing)))

    def _handle_metrics_cluster(self, req: Request) -> Response:
        """Cluster-wide Prometheus exposition: ONE bounded parallel
        scrape of every peer's /metrics (pooled clients — an open
        breaker fails a dead peer's leg fast), merged at query time:
        counters sum, histograms merge, gauges stay per-node labeled
        ``{node}``."""
        fed = self.federator

        def fetch(host: str) -> dict:
            client = fed.client_for(host)
            return obs_federate.parse_exposition(
                client.metrics_text(host=host,
                                    deadline_s=fed.peer_timeout_s))

        results, missing = fed.fan_out(
            fetch,
            lambda: obs_federate.parse_exposition(
                self._local_metrics_text()))
        headers: list = []
        self._partial_or_503(req, missing, headers)
        body = obs_federate.render_merged(
            obs_federate.merge_node_families(results)).encode()
        headers.append(("X-Pilosa-Federated-Nodes", str(len(results))))
        return Response(200, body,
                        "text/plain; version=0.0.4; charset=utf-8",
                        headers=headers)

    def _handle_debug_cluster(self, req: Request) -> Response:
        """The fleet rollup: every node's local debug block (build
        info, placement epoch, breaker states, WAL flusher health,
        resize phase), plus a version-skew verdict. ``?local=1`` answers
        just this node's block (the leg the coordinator fans out)."""
        state_fn = getattr(self.status_handler, "local_debug_state",
                           None)

        def local() -> dict:
            if state_fn is not None:
                return state_fn()
            return {"host": self.host, "build": obs_runtime.build_info()}

        if req.query.get("local") == "1":
            return Response.json(local())
        fed = self.federator

        def fetch(host: str) -> dict:
            client = fed.client_for(host)
            return client.debug_cluster_local(
                host=host, deadline_s=fed.peer_timeout_s)

        results, missing = fed.fan_out(fetch, local)
        headers: list = []
        self._partial_or_503(req, missing, headers)
        versions: dict[str, str] = {}
        for host, block in results.items():
            versions[host] = str(
                (block.get("build") or {}).get("version", ""))
        # Gossip-learned builds cover nodes a scrape can't reach (the
        # rolling-restart window where skew matters most).
        local_block = results.get(self.host) or {}
        for host, build in (local_block.get("gossipBuilds")
                            or {}).items():
            versions.setdefault(host, str(build.get("version", "")))
        distinct = {v for v in versions.values() if v}
        return Response.json(
            {"coordinator": self.host,
             "nodes": results,
             "missing": missing,
             "versions": versions,
             "versionSkew": len(distinct) > 1},
            headers=headers)

    def _refresh_scrape_gauges(self) -> None:
        if self.admission is not None:
            adm = self.admission.snapshot()
            obs_metrics.ADMISSION_IN_FLIGHT.set(adm.get("inFlight", 0))
            # Zero every lane first: a drained lane drops out of the
            # snapshot and must not report its last depth forever.
            for lane in (LANE_READ, LANE_WRITE, LANE_ADMIN):
                obs_metrics.ADMISSION_QUEUE_DEPTH.labels(lane).set(
                    (adm.get("queued") or {}).get(lane, 0))
            now = self.admission.tenant_in_flight()
            for labels, _child in \
                    obs_metrics.TENANT_INFLIGHT._label_dicts():
                t = labels.get("tenant", "")
                if t and t not in now:
                    obs_metrics.TENANT_INFLIGHT.labels(t).set(0)
            for tenant, n in now.items():
                obs_metrics.TENANT_INFLIGHT.labels(tenant).set(n)
        usage_fn = getattr(self.executor, "tenant_cache_usage", None)
        if callable(usage_fn):
            usage = usage_fn()
            for labels, _child in \
                    obs_metrics.TENANT_CACHE_BYTES._label_dicts():
                t = labels.get("tenant", "")
                if t and t not in usage:
                    obs_metrics.TENANT_CACHE_BYTES.labels(t).set(0)
            for tenant, ent in usage.items():
                obs_metrics.TENANT_CACHE_BYTES.labels(tenant).set(
                    ent.get("bytes", 0))
        obs_runtime.roaring_ops_sample()
        obs_runtime.residency_sample()

    # -- attr diff (anti-entropy) --------------------------------------------

    def _attr_diff(self, store, req: Request) -> Response:
        body = req.json()
        blocks = codec.blocks_from_json(body.get("blocks", []))
        attrs = {}
        for block_id in diff_blocks(store.blocks(), blocks):
            for id, m in store.block_data(block_id).items():
                attrs[str(id)] = m
        return Response.json({"attrs": attrs})

    def _handle_index_attr_diff(self, req: Request) -> Response:
        idx = self.holder.index(req.vars["index"])
        if idx is None:
            raise HTTPError(404, "index not found")
        return self._attr_diff(idx.column_attr_store, req)

    def _handle_frame_attr_diff(self, req: Request) -> Response:
        frame = self.holder.frame(req.vars["index"], req.vars["frame"])
        if frame is None:
            raise HTTPError(404, "frame not found")
        return self._attr_diff(frame.row_attr_store, req)

    # -- import / export (handler.go:896-1025) -------------------------------

    def _handle_post_import(self, req: Request) -> Response:
        # Protobuf at reference parity, plus the raw-array form the JAX
        # package's own client negotiates (proto/rawimport.py).
        if req.content_type not in (_PROTOBUF, rawimport.CONTENT_TYPE):
            raise HTTPError(415, "Unsupported media type")
        # Strict 406 before body parsing; the raw form also accepts its
        # own type as Accept. The answer is protobuf either way.
        if req.accept != _PROTOBUF and not (
                req.content_type == rawimport.CONTENT_TYPE
                and req.accept == rawimport.CONTENT_TYPE):
            raise HTTPError(406, "Not acceptable")
        positions = None
        body = req.body()
        decode_t0 = time.perf_counter()
        if req.content_type == rawimport.CONTENT_TYPE:
            try:
                (index_name, frame_name, slice, rows, cols,
                 ts_ns, positions) = rawimport.decode(body)
            except ValueError as e:
                raise HTTPError(400, str(e))
        else:
            ireq = pb.ImportRequest.FromString(body)
            index_name, frame_name, slice = \
                ireq.Index, ireq.Frame, ireq.Slice
            rows, cols = ireq.RowIDs, ireq.ColumnIDs
            ts_ns = ireq.Timestamps if len(ireq.Timestamps) else None
        decode_s = time.perf_counter() - decode_t0
        obs_metrics.IMPORT_STAGE_SECONDS.labels("decode").observe(decode_s)
        if positions is not None:
            # The positions form: sorted-unique is the client's
            # contract, held with one vectorised pass.
            if len(positions) > 1 and not bool(
                    np.all(positions[:-1] < positions[1:])):
                raise HTTPError(
                    400, "raw-import positions not sorted-unique")
        elif len(rows) != len(cols) or (
                ts_ns is not None and len(ts_ns) != len(rows)):
            raise HTTPError(400, "import array length mismatch")
        self._check_owner(index_name, slice)
        idx = self.holder.index(index_name)
        if idx is None:
            raise HTTPError(404, "index not found")
        frame = idx.frame(frame_name)
        if frame is None:
            raise HTTPError(404, "frame not found")
        timestamps = None
        if ts_ns is not None and ts_ns.any():
            # Nanoseconds since the epoch → naive UTC; 0 is no timestamp.
            timestamps = [
                dt.datetime.fromtimestamp(ts / 1e9, dt.timezone.utc)
                .replace(tzinfo=None) if ts else None
                for ts in np.asarray(ts_ns).tolist()]
        if positions is not None and frame.inverse_enabled:
            # The positions form is the standard view's lane; the
            # inverse transpose needs (row, column) pairs.
            w = np.uint64(SLICE_WIDTH)
            rows = positions // w
            cols = np.uint64(slice) * w + positions % w
            positions = None
        n_bits = len(positions) if positions is not None else len(rows)
        apply_t0 = time.perf_counter()
        # Pipeline depth: /import handlers in their apply stage (> 1:
        # a later block's decode overlapped this apply).
        obs_metrics.IMPORT_PIPELINE_DEPTH.inc()
        try:
            with _APPLY_GATE:
                if positions is not None:
                    # A writable copy: the decoded array is a view of
                    # the request body.
                    frame.import_slice_positions(slice,
                                                 np.array(positions))
                else:
                    frame.import_bits(rows, cols, timestamps)
        finally:
            obs_metrics.IMPORT_PIPELINE_DEPTH.inc(-1)
        apply_s = time.perf_counter() - apply_t0
        obs_metrics.IMPORT_STAGE_SECONDS.labels("apply").observe(apply_s)
        # Commit barrier before the 200: the import lanes barrier their
        # own fragment's WAL; this covers every fragment the request
        # touched (time views and the inverse transpose included),
        # coalesced with concurrent imports' barriers.
        storage_wal.barrier_all()
        obs_metrics.IMPORT_BITS.labels("bits").inc(n_bits)
        # Workload capture: an import ack is a state mutation a replay
        # must know of, so it records in every mode but off.
        cap = self.capture
        if cap is not None and cap.enabled \
                and cap.should_capture(LANE_WRITE):
            tenant = (req.environ.get("HTTP_X_PILOSA_TENANT", "")
                      or index_name)
            cap.add("import", "", index_name, tenant, LANE_WRITE, "",
                    200, decode_s + apply_s, bits=n_bits,
                    slice=int(slice), frame=frame_name)
        # The decode and apply times and the wire and bit volumes ride
        # the answer; so do the written slice's fresh generation tokens,
        # which invalidate an importing coordinator's cached results on
        # the ack itself.
        hs = [(obs_accounting.STATS_HEADER, json.dumps(
            {"decodeMs": round(decode_s * 1e3, 3),
             "applyMs": round(apply_s * 1e3, 3),
             "wireBytes": len(body), "bits": n_bits},
            separators=(",", ":")))]
        gh = self._generations_header(index_name, [slice])
        if gh is not None:
            hs.append(gh)
        return Response.proto(pb.ImportResponse(), headers=hs)

    # -- cluster: ownership, fragment sync, generations, messages ------------

    def _check_owner(self, index: str, slice: int) -> None:
        """412 when this node holds no replica of ``slice`` (a client
        importing or exporting must go to the slice's owners)."""
        if self.cluster is not None and not self.cluster.owns_fragment(
                self.host, index, slice):
            raise HTTPError(412, f"host does not own slice"
                                 f" {self.host}-{index} slice:{slice}")

    def _generations_header(self, index_name: str,
                            slices) -> Optional[tuple]:
        """(header, payload) with this node's tokens for ``slices``
        (every owned slice when none is named), or None when there is
        nothing to report."""
        if self.holder.index(index_name) is None:
            return None
        if not slices:
            slices = self._owned_slices(index_name)
        if not slices:
            return None
        tokens = gens_mod.local_tokens(self.holder, index_name, slices)
        return (gens_mod.GENERATIONS_HEADER,
                gens_mod.encode_wire(index_name, tokens))

    def _owned_slices(self, index_name: str) -> list[int]:
        idx = self.holder.index(index_name)
        if idx is None:
            return []
        max_slice = idx.max_slice()
        if self.cluster is None:
            return list(range(max_slice + 1))
        return self.cluster.owns_slices(index_name, max_slice, self.host)

    def _fragment_from_query(self, req: Request):
        return self.holder.fragment(req.query.get("index", ""),
                                    req.query.get("frame", ""),
                                    req.query.get("view", ""),
                                    req.uint_param("slice"))

    def _handle_fragment_nodes(self, req: Request) -> Response:
        slice = req.uint_param("slice")
        index = req.query.get("index", "")
        if self.cluster is None:
            return Response.json([{"host": self.host, "internalHost": ""}])
        return Response.json([{"host": n.host,
                               "internalHost": n.internal_host}
                              for n in self.cluster.fragment_nodes(
                                  index, slice)])

    @staticmethod
    def _refuse_quarantined(frag) -> None:
        """Storage integrity: a quarantined fragment's copy (corrupt, or
        the fresh near-empty replacement awaiting repair) must not feed
        a peer's anti-entropy vote or repair — 409 so remote consumers
        skip this node and sweep again after repair. The local repairer
        bypasses HTTP (server.repair's in-process target)."""
        if frag is not None and getattr(frag, "quarantined", False):
            raise HTTPError(409, "fragment quarantined: "
                                 + frag.quarantine_reason)

    def _handle_fragment_blocks(self, req: Request) -> Response:
        frag = self._fragment_from_query(req)
        if frag is None:
            raise HTTPError(404, "fragment not found")
        self._refuse_quarantined(frag)
        return Response.json({"blocks": codec.blocks_to_json(frag.blocks())})

    def _handle_fragment_block_data(self, req: Request) -> Response:
        breq = pb.BlockDataRequest.FromString(req.body())
        frag = self.holder.fragment(breq.Index, breq.Frame, breq.View,
                                    breq.Slice)
        if frag is None:
            raise HTTPError(404, "fragment not found")
        self._refuse_quarantined(frag)
        ps = frag.block_data(breq.Block)
        return Response.proto(pb.BlockDataResponse(
            RowIDs=ps.row_ids, ColumnIDs=ps.column_ids))

    def _handle_get_fragment_data(self, req: Request) -> Response:
        """The fragment as the reference's tar stream (data + cache),
        spooled to disk past 8 MiB and streamed back."""
        import tempfile
        frag = self._fragment_from_query(req)
        if frag is None:
            raise HTTPError(404, "fragment not found")
        self._refuse_quarantined(frag)
        spool = tempfile.SpooledTemporaryFile(max_size=8 << 20)
        frag.write_to(spool)
        spool.seek(0)

        def chunks():
            with spool:
                while True:
                    b = spool.read(1 << 20)
                    if not b:
                        return
                    yield b
        return Response(200, chunks(), "application/octet-stream")

    def _handle_post_fragment_data(self, req: Request) -> Response:
        """Replace one fragment from a tar stream of ``GET
        /fragment/data``; the body is read whole before the swap."""
        slice = req.uint_param("slice")
        frame = self.holder.frame(req.query.get("index", ""),
                                  req.query.get("frame", ""))
        if frame is None:
            raise HTTPError(404, "frame not found")
        frag = frame.create_view_if_not_exists(
            req.query.get("view", "")).create_fragment_if_not_exists(slice)
        frag.read_from(io.BytesIO(req.body()))
        return Response.json({})

    def _handle_post_fragment_import(self, req: Request) -> Response:
        """Additive import of slice-local positions (LE u64,
        row*SLICE_WIDTH + col%SLICE_WIDTH) into one exact (frame, view)
        fragment: idempotent, so a torn push re-pushes safely."""
        index_name = req.query.get("index", "")
        frame_name = req.query.get("frame", "")
        view = req.query.get("view", "")
        slice = req.uint_param("slice")
        if not index_name or not frame_name or not view:
            raise HTTPError(400, "index, frame, and view required")
        self._check_owner(index_name, slice)
        frame = self.holder.frame(index_name, frame_name)
        if frame is None:
            raise HTTPError(404, "frame not found")
        body = req.body()
        if len(body) % 8:
            raise HTTPError(400, "positions body not 8-byte aligned")
        positions = np.frombuffer(body, dtype="<u8")
        frag = frame.create_view_if_not_exists(
            view).create_fragment_if_not_exists(slice)
        if len(positions):
            # A writable sorted copy of the request buffer's view.
            frag.import_positions(np.sort(positions).astype(np.uint64))
        storage_wal.barrier_all()
        obs_metrics.IMPORT_BITS.labels("resizeStream").inc(len(positions))
        gh = self._generations_header(index_name, [slice])
        return Response.json({"accepted": int(len(positions))},
                             headers=[gh] if gh is not None else [])

    def _handle_get_generations(self, req: Request) -> Response:
        """The cluster result cache's validation probe: this node's
        (uid, generation) tokens for the named slices (default: every
        slice it owns). No query runs, so a probe costs a round trip."""
        index_name = req.query.get("index", "")
        if not index_name:
            raise HTTPError(400, "index required")
        if self.holder.index(index_name) is None:
            raise HTTPError(404, "index not found")
        try:
            slices = [int(s) for s in req.query.get("slices", "").split(",")
                      if s != ""]
        except ValueError:
            raise HTTPError(400, "invalid slices argument")
        if not slices:
            slices = self._owned_slices(index_name)
        tokens = gens_mod.local_tokens(self.holder, index_name, slices)
        return Response.json({
            "index": index_name, "host": self.host,
            "tokens": {str(s): {k: [v[0], v[1]] for k, v in m.items()}
                       for s, m in tokens.items()}})

    def _handle_post_message(self, req: Request) -> Response:
        if self.status_handler is None:
            raise HTTPError(404, "no broadcast handler")
        try:
            msg = unmarshal_message(req.body())
        except (ValueError, IndexError, pb.DecodeError) as e:
            raise HTTPError(400, f"invalid message: {e}")
        self.status_handler.receive_message(msg)
        return Response.json({})

    # -- elastic resize (cluster.resize; docs/CLUSTER_RESIZE.md) -------------

    def _resize_server(self):
        """The Server behind the resize control surface; bare test
        handlers (no status_handler / no start_resize) answer 503."""
        s = self.status_handler
        if s is None or not hasattr(s, "start_resize"):
            raise HTTPError(503, "no resize coordinator on this node")
        return s

    def _handle_get_cluster_resize(self, req: Request) -> Response:
        out: dict = {"epoch": self.cluster.epoch
                     if self.cluster is not None else 0}
        rs = self.cluster.resize if self.cluster is not None else None
        out["installed"] = rs.to_wire() if rs is not None else None
        s = self.status_handler
        op = getattr(s, "resize_op", None)
        out["op"] = op.status() if op is not None else None
        return Response.json(out)

    def _handle_post_cluster_resize(self, req: Request) -> Response:
        """Start (or abort) an online resize with THIS node as
        coordinator. Body: {"hosts": [target membership]} |
        {"add": "h:p"} | {"remove": "h:p"} | {"abort": true}."""
        server = self._resize_server()
        body = req.json()
        if body.get("abort"):
            status = server.abort_resize()
            if status is None:
                raise HTTPError(409, "no resize in flight")
            return Response.json({"op": status})
        current = [n.host for n in self.cluster.nodes]
        if body.get("hosts"):
            target = [str(h) for h in body["hosts"]]
        elif body.get("add"):
            h = str(body["add"])
            if h in current:
                raise HTTPError(400, f"{h} already a member")
            target = current + [h]
        elif body.get("remove"):
            h = str(body["remove"])
            if h not in current:
                raise HTTPError(400, f"{h} not a member")
            if len(current) == 1:
                raise HTTPError(400, "cannot remove the last node")
            target = [x for x in current if x != h]
        else:
            raise HTTPError(400, "hosts, add, remove, or abort"
                                 " required")
        try:
            coord = server.start_resize(target)
        except PilosaError as e:
            raise HTTPError(409, str(e))
        return Response.json({"op": coord.status()}, status=202)

    def _handle_debug_topology(self, req: Request) -> Response:
        """Placement: the epoch, the members, each index's owners a
        slice and the in-flight resize with its moving slices."""
        cl = self.cluster
        if cl is None:
            return Response.json({"epoch": 0, "nodes": [], "indexes": {},
                                  "resize": None})
        rs = cl.resize
        indexes = {}
        for name in sorted(self.holder.indexes):
            idx = self.holder.indexes[name]
            hi = max(idx.max_slice(), idx.max_inverse_slice())
            owners = {}
            moving = []
            for s in range(hi + 1):
                owners[str(s)] = [n.host for n in cl.fragment_nodes(name, s)]
                if cl.moving_slice(name, s) is not None:
                    moving.append(s)
            entry: dict = {"maxSlice": idx.max_slice(), "owners": owners}
            if moving:
                entry["movingSlices"] = moving
            indexes[name] = entry
        return Response.json({
            "epoch": cl.epoch, "partitionN": cl.partition_n,
            "replicaN": cl.replica_n,
            "nodes": [n.host for n in cl.nodes],
            "resize": rs.to_wire() if rs is not None else None,
            "indexes": indexes})

    def _handle_debug_tier(self, req: Request) -> Response:
        """Tiered-storage state (tier): per-tier fragment and byte
        counts, resident bytes against the budget and watermarks,
        per-tenant residency, transition totals, blocked cold fetches
        and the blob store summary. ``?entries=1`` appends the
        per-fragment ledger (``&tier=cold`` filters it); ``?pass=1``
        runs one manager pass inline and includes its summary."""
        if self.tier is None:
            return Response.json({"enabled": False})
        out = self.tier.state()
        if req.query.get("pass") == "1":
            out["pass"] = self.tier.pass_once()
        if req.query.get("entries") == "1":
            out["entries"] = self.tier.entries(
                req.query.get("tier", ""))[:1024]
        return Response.json(out)

    def _handle_debug_integrity(self, req: Request) -> Response:
        """Storage-integrity state: quarantined fragments (what, why,
        since when), scrub pass progress and totals, repair totals, and
        the footer coverage summary (how many open fragments carry
        checksums — vintage files read fine but scrub blind)."""
        covered = vintage = 0
        for frag in self.holder.iter_fragments():
            storage = getattr(frag, "storage", None)
            if storage is not None and getattr(storage, "footer",
                                               None) is not None:
                covered += 1
            else:
                vintage += 1
        registry = getattr(self.holder, "quarantine", None)
        out: dict = {
            "quarantined": registry.entries() if registry is not None
            else [],
            "coverage": {"footered": covered, "vintage": vintage}}
        if self.scrubber is not None:
            out["scrub"] = self.scrubber.state()
        if self.repairer is not None:
            out["repair"] = self.repairer.state()
        return Response.json(out)

    def _handle_post_integrity_scrub(self, req: Request) -> Response:
        """Trigger an immediate scrub pass. ``?sync=1`` runs the pass
        inline and returns its summary; the default just wakes the
        background thread."""
        if self.scrubber is None:
            raise HTTPError(503, "no scrubber on this node")
        if req.query.get("sync") == "1":
            return Response.json(self.scrubber.pass_once())
        self.scrubber.trigger()
        return Response.json({"triggered": True})

    def _handle_debug_failpoints(self, req: Request) -> Response:
        """The armed failpoints and the seed that replays them."""
        return Response.json(fault_failpoints.default().snapshot())

    def _handle_post_failpoints(self, req: Request) -> Response:
        """Arm or disarm failpoints: ``{"site": "rpc.send", "spec":
        "error(0.5)"}`` or ``{"failpoints": {"rpc.send": "error"}}``;
        spec "off" disarms. An unknown site or a malformed spec is 400
        with nothing armed."""
        body = req.json()
        updates: dict = {}
        if "failpoints" in body:
            if not isinstance(body["failpoints"], dict):
                raise HTTPError(400, "failpoints is not a map")
            updates.update(body["failpoints"])
        if "site" in body:
            updates[body["site"]] = body.get("spec", "off")
        if not updates:
            raise HTTPError(400, "no failpoints given")
        for site, spec in updates.items():
            if site not in fault_failpoints.SITES:
                raise HTTPError(400, f"unknown failpoint site: {site}")
            try:
                fault_failpoints.parse_spec(site, str(spec))
            except ValueError as e:
                raise HTTPError(400, str(e))
        reg = fault_failpoints.default()
        for site, spec in updates.items():
            reg.arm(site, str(spec))
            self.logger.printf("failpoint %s: %s (seed %d)", site,
                               spec or "off", reg.seed)
        return Response.json(reg.snapshot())

    def _handle_health(self, req: Request) -> Response:
        """READINESS (not liveness): 200 only when this node can serve —
        holder open, gossip converged, admission not saturated, data
        directory writable, no unreplicated quarantine, writes
        accepted. ``/version`` stays the liveness probe."""
        from ..obs.slo import HealthChecker
        if self._health is None:
            self._health = HealthChecker(holder=self.holder,
                                         cluster=self.cluster,
                                         admission=self.admission,
                                         host=self.host)
        ready, checks = self._health.check()
        return Response.json(
            {"status": "ok" if ready else "unhealthy", "checks": checks},
            status=200 if ready else 503)

    def _handle_post_frame_restore(self, req: Request) -> Response:
        """Pull every owned slice of a frame, each view, from a remote
        cluster host (handler.go:1180-1266)."""
        index_name, frame_name = req.vars["index"], req.vars["frame"]
        host = req.query.get("host")
        if not host:
            raise HTTPError(400, "host required")
        if self.client_factory is None:
            raise HTTPError(500, "no client factory configured")
        client = self.client_factory(host)
        max_slices = client.max_slices()
        frame = self.holder.frame(index_name, frame_name)
        if frame is None:
            raise HTTPError(404, "frame not found")
        views = client.frame_views(index_name, frame_name)
        for slice in range(max_slices.get(index_name, 0) + 1):
            if self.cluster is not None and not self.cluster.owns_fragment(
                    self.host, index_name, slice):
                continue
            for view_name in views:
                view = frame.create_view_if_not_exists(view_name)
                frag = view.create_fragment_if_not_exists(slice)
                rd = client.backup_slice(index_name, frame_name, view_name,
                                         slice)
                if rd is None:
                    continue
                try:
                    frag.read_from(rd)
                finally:
                    rd.close()
        return Response.json({})

    def _handle_get_export(self, req: Request) -> Response:
        if req.accept != "text/csv":
            raise HTTPError(406, "Not acceptable")
        slice = req.uint_param("slice")
        self._check_owner(req.query.get("index", ""), slice)
        frag = self.holder.fragment(req.query.get("index", ""),
                                    req.query.get("frame", ""),
                                    req.query.get("view", ""), slice)
        if frag is None:
            return Response(200, b"", "text/csv")
        return Response(200, _export_csv_chunks(frag.positions(), slice),
                        "text/csv")


def _local_status(holder, host: str, cluster) -> pb.NodeStatus:
    """One node's NodeStatus (server.go:306-323): each index with its
    meta, max slice, frames and the slices this node owns as primary
    (all of them without a cluster)."""
    indexes = []
    for name in sorted(holder.indexes):
        idx = holder.indexes[name]
        max_slice = idx.max_slice()
        owned = (list(range(max_slice + 1)) if cluster is None
                 else cluster.owns_slices(name, max_slice, host))
        indexes.append(pb.Index(
            Name=name, Meta=idx.options.encode(), MaxSlice=max_slice,
            Frames=[pb.Frame(Name=fn, Meta=idx.frames[fn].options.encode())
                    for fn in sorted(idx.frames)],
            Slices=owned))
    return pb.NodeStatus(Host=host, State="UP", Indexes=indexes)
