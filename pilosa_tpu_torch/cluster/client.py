"""Node-to-node and external HTTP client: protobuf-over-HTTP data plane.

Copy of the JAX package's ``cluster/client.py`` (reference client.go):
the remote query legs (executor.go:1001-1083), the schema and
max-slice reads, slice-grouped bulk imports to every owner
(client.go:304-389, the raw-array lanes first), the CSV export with
owner failover, anti-entropy block sync (client.go:798-886), attribute
diffs (client.go:889-974), broadcast envelopes and query cancel, and
the frame-view tar backup and restore over the ``/fragment/data`` stream
(client.go:463-695): ``backup_slice``, ``restore_slice``, ``backup_to``,
``restore_from`` and ``restore_frame``.

Every request goes through ``_do``: a keep-alive connection pool per
host, one transparent retry for idempotent requests on a stale pooled
socket, the circuit breaker consulted before the wire (an open circuit
fails fast with CircuitOpenError) and every attempt's outcome fed to the
node's FaultManager. The socket timeout is the JAX package's 30 s,
clamped to a query's remaining budget, so a dead peer costs one timeout
and the breaker opens after the threshold. The generation, cost and
trace headers the JAX server and client exchange ride the query legs.

The fleet-observability helpers wait for the slice that ports their
modules.
"""

from __future__ import annotations

import http.client
import json
import random
import threading
import time
from typing import Optional

import numpy as np

from .. import SLICE_WIDTH
from ..utils.arrays import group_by_key
from ..errors import (FragmentNotFoundError, PilosaError,
                      QueryDeadlineError)
from ..fault import failpoints as _fp
from ..obs.accounting import COST_HEADER
from ..obs.trace import SPANS_HEADER, TRACE_HEADER
from ..pql import parser as pql
from ..proto import internal as pb
from ..sched import context as sched_context
from . import generations as gens_mod
from .topology import Node

_PROTOBUF = "application/x-protobuf"


class ClientError(PilosaError):
    pass


class CircuitOpenError(ClientError):
    """Failed fast: the target peer's circuit breaker is open (fault
    subsystem). Subclasses ClientError so every failover loop treats
    it exactly like the timeout it replaces — minus the wait."""


def _host_of(node) -> str:
    return node.host if isinstance(node, Node) else str(node)


class _StreamReader:
    """File-like over an HTTPResponse + its dedicated connection."""

    def __init__(self, resp, conn):
        self.resp = resp
        self.conn = conn
        self.status = resp.status

    def read(self, size: int = -1) -> bytes:
        return self.resp.read(size)

    def close(self) -> None:
        try:
            self.resp.close()
        finally:
            self.conn.close()


class Bit:
    """One (row, column, timestamp) triple for import
    (client.go:977-1005)."""

    __slots__ = ("row_id", "column_id", "timestamp")

    def __init__(self, row_id: int, column_id: int, timestamp: int = 0):
        self.row_id = row_id
        self.column_id = column_id
        self.timestamp = timestamp  # ns since epoch, 0 = none


class Client:
    """HTTP client against one host (plus owner discovery for imports).

    Connections are pooled per host with keep-alive: write-heavy flows
    (imports, `bench -op set-bit`, anti-entropy block sync) issue many
    small requests, and a fresh TCP connect per request dominates their
    latency. The pool is thread-safe (executor fan-out shares one
    Client across worker threads); a request that fails on a pooled
    connection retries once on a fresh one, since the server may have
    closed an idle socket.
    """

    def __init__(self, host: str, timeout: float = 30.0, fault=None,
                 gens=None):
        if not host:
            raise ClientError("host required")
        self.host = host
        self.timeout = timeout
        # Coordinator-side generation map (cluster.generations): when
        # set, every query/import response's piggybacked
        # X-Pilosa-Generations header lands here — unless the caller
        # passes gens_out to take custody (hedged reads must merge
        # the WINNING leg's tokens only). None (external clients,
        # CLI) skips the parse entirely.
        self.gens = gens
        # Fault-tolerance hook (fault.FaultManager): when set, every
        # request consults the target's circuit breaker (open = fail
        # fast with CircuitOpenError instead of paying the socket
        # timeout) and every attempt's outcome + latency feeds the
        # per-peer health EWMA. None (bare clients, tests, CLI) keeps
        # the plain transport behavior.
        self.fault = fault
        self._pool: dict[str, list[http.client.HTTPConnection]] = {}
        self._pool_mu = threading.Lock()
        # Hosts that 415'd the raw-array import format (reference-
        # shaped servers): remembered so every later slice goes
        # straight to protobuf.
        self._no_raw_import: set[str] = set()
        self._no_posn_import: set[str] = set()

    # -- low-level -----------------------------------------------------------

    _POOL_PER_HOST = 8

    def _conn_get(self, host: str) -> Optional[http.client.HTTPConnection]:
        with self._pool_mu:
            conns = self._pool.get(host)
            return conns.pop() if conns else None

    def _conn_put(self, host: str, conn: http.client.HTTPConnection) -> None:
        with self._pool_mu:
            conns = self._pool.setdefault(host, [])
            if len(conns) < self._POOL_PER_HOST:
                conns.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._pool_mu:
            for conns in self._pool.values():
                for c in conns:
                    c.close()
            self._pool.clear()

    _IDEMPOTENT = frozenset({"GET", "HEAD", "PUT", "DELETE"})

    def _do(self, method: str, path: str, body: Optional[bytes] = None,
            headers: Optional[dict] = None, host: Optional[str] = None,
            idempotent: Optional[bool] = None,
            deadline_s: Optional[float] = None,
            headers_out: Optional[list] = None) -> tuple[int, bytes]:
        """``idempotent`` overrides the per-method default for POST
        endpoints that are safe to replay (queries, attr diffs, create-
        if-not-exists) — those keep the transparent stale-keep-alive
        retry; everything else (e.g. /import op-log appends) does not.

        ``deadline_s`` is the query's remaining budget (sched
        subsystem): every attempt's socket timeout is clamped to what
        is left, and NO attempt — in particular no retry — starts once
        the budget is exhausted (an attempt whose timeout exceeded the
        remaining budget would overrun the caller's deadline). Budget
        exhaustion surfaces as QueryDeadlineError, distinct from
        ClientError so failover loops don't retry a dead query on a
        replica."""
        target = host or self.host
        if idempotent is None:
            idempotent = method in self._IDEMPOTENT
        # Circuit breaker (fault subsystem): an open circuit fails
        # fast — the whole point is to NOT pay the dead peer's socket
        # timeout again. allow() grants the half-open probe when the
        # backoff window has lapsed.
        if self.fault is not None and not self.fault.allow(target):
            ctx = sched_context.current()
            if ctx is not None:
                # Tail-sampling cross-link: this query touched an open
                # breaker — whatever happens next (failover, partial,
                # error), its trace is worth keeping (obs.sampler).
                ctx.note_flag("breaker")
            raise CircuitOpenError(
                f"{method} http://{target}{path}: circuit open")
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        # File-like bodies (streaming restore) must rewind between
        # attempts — http.client reads them destructively.
        body_start = body.tell() if hasattr(body, "seek") else None
        last_err = None
        for attempt in range(2):
            timeout = self.timeout
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise QueryDeadlineError(
                        f"{method} http://{target}{path}: deadline"
                        f" exceeded"
                        + (f" (after {last_err})" if last_err else ""))
                timeout = min(timeout, remaining)
            if body_start is not None:
                body.seek(body_start)
            conn = None if attempt else self._conn_get(target)
            fresh = conn is None
            if conn is None:
                try:
                    conn = http.client.HTTPConnection(
                        target, timeout=timeout)
                except Exception as e:  # bad host string
                    raise ClientError(f"{method} http://{target}{path}: {e}")
            else:
                # Pooled sockets carry whatever timeout their LAST use
                # armed (possibly a tiny clamped budget); re-arm every
                # attempt — both to clamp to this request's budget and
                # to restore the default for deadline-free requests.
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
            sent = False
            t0 = time.perf_counter()
            try:
                if _fp.ACTIVE is not None:
                    _fp.ACTIVE.hit("rpc.send", host=target)
                conn.request(method, path, body=body, headers=headers or {})
                sent = True
                resp = conn.getresponse()
                data = resp.read()
                if _fp.ACTIVE is not None:
                    _fp.ACTIVE.hit("rpc.recv", host=target)
                if headers_out is not None:
                    headers_out.extend(resp.getheaders())
                if resp.will_close:
                    conn.close()
                else:
                    self._conn_put(target, conn)
                if self.fault is not None:
                    # Any completed HTTP exchange means the peer is
                    # alive, whatever the status code says.
                    self.fault.record_rpc(target, True,
                                          time.perf_counter() - t0)
                return resp.status, data
            except (http.client.HTTPException, OSError) as e:
                conn.close()
                last_err = e
                deadline_hit = (deadline is not None
                                and time.monotonic() >= deadline)
                if self.fault is not None and not (
                        deadline_hit and isinstance(e, TimeoutError)):
                    # A timeout that merely exhausted the CALLER'S
                    # clamped budget says more about the budget than
                    # the peer — a healthy 80 ms peer serving 50 ms
                    # deadlines must not trip its breaker. Refused/
                    # reset/torn responses are real peer failures
                    # whatever the budget; the breaker-probe loop
                    # classifies its own timeouts explicitly.
                    self.fault.record_rpc(target, False)
                if deadline_hit:
                    # The attempt consumed the rest of the budget (e.g.
                    # a stalled peer ate the clamped socket timeout):
                    # this is a deadline expiry, not a node failure.
                    raise QueryDeadlineError(
                        f"{method} http://{target}{path}: deadline"
                        f" exceeded (after {e})")
                if fresh:  # a fresh connection failing is a real error
                    break
                if sent and not idempotent:
                    # The request reached the wire on a pooled socket and
                    # only the response failed — the server may already
                    # have processed it. Re-POSTing would re-execute a
                    # non-idempotent write (e.g. /import op-log appends),
                    # so surface the error instead (urllib3 safe-retry
                    # policy).
                    break
            except BaseException:
                # Anything else that escapes mid-request — a deadline
                # raised from a hook, KeyboardInterrupt, an unexpected
                # protocol error — leaves the socket in an unknown
                # state: DROP it. A broken connection must never
                # return to the pool where _conn_get would hand it to
                # the next request (pool-poisoning).
                conn.close()
                raise
        # Unreachable host → ClientError so failover loops can catch
        # and try the next owner.
        raise ClientError(f"{method} http://{target}{path}: {last_err}")

    def _do_stream(self, path: str, host: Optional[str] = None,
                   headers: Optional[dict] = None) -> "_StreamReader":
        """GET on a dedicated (unpooled) connection, returning the
        response as a file-like the caller reads in chunks and closes —
        the streaming leg of backup (client.go:552-580 attaches the
        response body as an io.ReadCloser)."""
        target = host or self.host
        try:
            conn = http.client.HTTPConnection(target, timeout=self.timeout)
            conn.request("GET", path, headers=headers or {})
            resp = conn.getresponse()
        except (http.client.HTTPException, OSError) as e:
            raise ClientError(f"GET http://{target}{path}: {e}")
        return _StreamReader(resp, conn)

    def _ok(self, status: int, body: bytes, what: str) -> bytes:
        if status != 200:
            raise ClientError(
                f"{what}: invalid status: code={status},"
                f" err={body.decode(errors='replace').strip()}")
        return body

    # Import-lane 429 handling: base/cap of the capped exponential
    # backoff (full jitter), and the total-wait ceiling when no query
    # deadline bounds the retry loop.
    _RETRY_429_BASE = 0.25
    _RETRY_429_CAP = 8.0

    def _do_429(self, method: str, path: str, body, headers: dict,
                host: Optional[str]) -> tuple[int, bytes]:
        """_do for import legs, honoring admission control's 429 +
        Retry-After — and the disk-full degradation's 507 + Retry-After
        (PR-14 write-unready: the peer is SHEDDING WRITES while it
        reclaims space, exactly as transient as an admission shed; a
        mid-import ENOSPC on one peer used to fail the whole import
        instead of waiting it out) — with capped exponential backoff +
        full jitter instead of surfacing the first rejection. The loop
        is bounded by the calling query's remaining deadline budget
        when one is bound to this thread (sched.context), and by
        ``self.timeout`` of total sleep otherwise — an overloaded
        server sheds load; the client must neither hammer it nor wait
        forever."""
        ctx = sched_context.current()
        budget = ctx.remaining() if ctx is not None else None
        if budget is None:
            budget = self.timeout
        deadline = time.monotonic() + max(budget, 0.0)
        backoff = self._RETRY_429_BASE
        while True:
            headers_out: list = []
            status, raw = self._do(method, path, body, headers,
                                   host=host, headers_out=headers_out)
            if status not in (429, 507):
                if self.gens is not None:
                    # Import acks piggyback the touched fragments'
                    # generation tokens (same contract as query legs)
                    # — one parse site covers every import form.
                    for hk, hv in headers_out:
                        if (hk.lower()
                                == gens_mod.GENERATIONS_HEADER.lower()):
                            self.gens.apply_wire(host or self.host, hv)
                return status, raw
            retry_after = 0.0
            for hk, hv in headers_out:
                if hk.lower() == "retry-after":
                    try:
                        retry_after = float(hv)
                    except ValueError:
                        pass
            # Full jitter over the exponential window, floored at the
            # server's own hold estimate.
            wait = max(retry_after, random.uniform(0.0, backoff))
            backoff = min(backoff * 2.0, self._RETRY_429_CAP)
            remaining = deadline - time.monotonic()
            if wait >= remaining:
                # Out of budget: surface the rejection (the caller's
                # _ok turns it into the usual ClientError).
                return status, raw
            if ctx is not None:
                ctx.check()
            time.sleep(wait)

    # -- queries (client.go:216-269) -----------------------------------------

    # Marker the executor checks before passing lifecycle kwargs —
    # scripted test fakes without the kwargs keep the plain call shape.
    deadline_aware = True
    # Same idea for the generation-token kwarg (gens_out).
    generation_aware = True

    def execute_query(self, node, index: str, query: str,
                      slices: Optional[list[int]] = None,
                      remote: bool = True,
                      column_attrs: bool = False,
                      pod_local: bool = False,
                      deadline_s: Optional[float] = None,
                      query_id: Optional[str] = None,
                      gens_out: Optional[list] = None) -> list:
        """``deadline_s``/``query_id`` propagate the coordinator's
        REMAINING budget and query identity to the peer (sched wire
        contract: X-Pilosa-Deadline / X-Pilosa-Query-Id), and clamp
        this leg's socket timeouts + retry budget to the deadline.

        ``gens_out`` (a list) takes custody of the response's
        generation tokens as ``(peer, payload)`` pairs INSTEAD of
        applying them to ``self.gens`` — the hedged-read path applies
        only the winning leg's tokens, so a stale loser can never
        poison the coordinator generation map."""
        from ..server import codec
        body = codec.encode_query_request(query, slices,
                                          column_attrs=column_attrs,
                                          remote=remote)
        path = f"/index/{index}/query"
        if pod_local:  # a pod-internal leg (parallel.pod)
            path += "?podLocal=true"
        headers = {"Content-Type": _PROTOBUF, "Accept": _PROTOBUF}
        if deadline_s is not None:
            headers["X-Pilosa-Deadline"] = f"{deadline_s:.6f}"
        if query_id:
            headers["X-Pilosa-Query-Id"] = query_id
        # Distributed tracing + cost accounting: when the calling
        # thread carries a lifecycle-bound query (the executor binds it
        # via sched_context.use), ask the peer to trace its leg and
        # stitch the spans AND the cost ledger it piggybacks on the
        # response headers back into the originating trace/cost tree.
        ctx = sched_context.current()
        trace = getattr(ctx, "trace", None) if ctx is not None else None
        cost = getattr(ctx, "cost", None) if ctx is not None else None
        # Tenant principal (sched.tenants, the X-Pilosa-Deadline
        # pattern): the remote leg schedules its device work, accounts
        # its costs, and enforces cost ceilings under the SAME tenant
        # as the coordinator — forwarded legs bypass admission, but
        # never the accounting.
        tenant = getattr(ctx, "tenant", "") if ctx is not None else ""
        if tenant:
            headers[sched_context.TENANT_HEADER] = tenant
        headers_out: Optional[list] = None
        if trace is not None:
            headers[TRACE_HEADER] = "1"
        if (trace is not None or cost is not None
                or self.gens is not None or gens_out is not None):
            headers_out = []
        target = _host_of(node) if node is not None else self.host
        status, raw = self._do(
            "POST", path, body, headers,
            host=_host_of(node) if node is not None else None,
            idempotent=True,  # PQL writes set absolute state — replayable
            deadline_s=deadline_s, headers_out=headers_out)
        if cost is not None:
            cost.note_rpc(target, len(body), len(raw))
        if headers_out:
            for hk, hv in headers_out:
                lk = hk.lower()
                if trace is not None and lk == SPANS_HEADER.lower():
                    trace.add_remote_json(hv)
                elif cost is not None and lk == COST_HEADER.lower():
                    cost.add_remote_json(hv)
                elif lk == gens_mod.GENERATIONS_HEADER.lower():
                    if gens_out is not None:
                        gens_out.append((target, hv))
                    elif self.gens is not None:
                        self.gens.apply_wire(target, hv)
        self._ok(status, raw, "execute query")
        resp = pb.QueryResponse.FromString(raw)
        if resp.Err:
            raise ClientError(resp.Err)
        call_names = [c.name for c in pql.parse(query).calls]
        return codec.decode_query_results(resp, call_names)

    def cancel_query(self, query_id: str,
                     host: Optional[str] = None) -> dict:
        """DELETE /debug/queries/{id}: cancel a query on this node;
        the node re-broadcasts the cancel cluster-wide."""
        status, raw = self._do("DELETE",
                               f"/debug/queries/{query_id}", host=host)
        return json.loads(self._ok(status, raw, "cancel query"))

    def queries(self, host: Optional[str] = None) -> dict:
        """GET /debug/queries: this node's in-flight queries + slow
        log (sched.registry)."""
        status, raw = self._do("GET", "/debug/queries", host=host)
        return json.loads(self._ok(status, raw, "debug queries"))

    def generations(self, index: str,
                    slices: Optional[list[int]] = None,
                    host: Optional[str] = None,
                    deadline_s: Optional[float] = None) -> dict:
        """GET /generations: a peer's current per-fragment generation
        tokens for the given slices — the cheap validation round-trip
        the coordinator result cache pays instead of a full fan-out
        re-execution. The probe's answer also refreshes ``self.gens``
        (it is the freshest possible knowledge of that peer)."""
        path = f"/generations?index={index}"
        if slices:
            path += "&slices=" + ",".join(str(s) for s in slices)
        status, raw = self._do("GET", path, host=host,
                               deadline_s=deadline_s)
        data = json.loads(self._ok(status, raw, "generations"))
        tokens = gens_mod.decode_tokens(data.get("tokens") or {})
        if self.gens is not None and tokens:
            self.gens.apply(host or self.host, index, tokens)
        return tokens

    # -- fleet observability (obs.federate) ----------------------------------

    def metrics_text(self, host: Optional[str] = None,
                     deadline_s: Optional[float] = None) -> str:
        """GET /metrics: one peer's Prometheus exposition — the
        federation scrape leg (/metrics/cluster). ``deadline_s`` is
        the per-peer scrape budget; the breaker consult in _do makes a
        dead peer fail this fast instead of paying the timeout."""
        status, raw = self._do("GET", "/metrics", host=host,
                               deadline_s=deadline_s)
        return self._ok(status, raw, "metrics scrape").decode()

    def debug_cluster_local(self, host: Optional[str] = None,
                            deadline_s: Optional[float] = None) -> dict:
        """GET /debug/cluster?local=1: one peer's local debug block
        (build, epoch, breakers, WAL health, resize phase) — the
        /debug/cluster fan-out leg."""
        status, raw = self._do("GET", "/debug/cluster?local=1",
                               host=host, deadline_s=deadline_s)
        return json.loads(self._ok(status, raw, "debug cluster"))

    def metrics_history(self, family: str = "", label: str = "",
                        window: str = "", step: str = "",
                        host: Optional[str] = None,
                        deadline_s: Optional[float] = None) -> dict:
        """GET /debug/metrics/history: one peer's metric-history
        series — the scope=cluster federation leg."""
        from urllib.parse import urlencode
        params = {k: v for k, v in (("family", family),
                                    ("label", label),
                                    ("window", window),
                                    ("step", step)) if v}
        path = "/debug/metrics/history"
        if params:
            path += "?" + urlencode(params)
        status, raw = self._do("GET", path, host=host,
                               deadline_s=deadline_s)
        return json.loads(self._ok(status, raw, "metrics history"))

    def capture_records(self, since: int = 0, limit: int = 500,
                        host: Optional[str] = None,
                        deadline_s: Optional[float] = None) -> dict:
        """GET /debug/capture/records: one peer's local capture page
        (obs.capture) — the scope=cluster federation leg, and the
        replay's export transport."""
        from urllib.parse import urlencode
        path = ("/debug/capture/records?"
                + urlencode({"since": since, "limit": limit}))
        status, raw = self._do("GET", path, host=host,
                               deadline_s=deadline_s)
        return json.loads(self._ok(status, raw, "capture records"))

    # -- schema / slices (client.go:63-136) ----------------------------------

    def schema(self) -> list[dict]:
        status, raw = self._do("GET", "/schema")
        return json.loads(self._ok(status, raw, "schema"))["indexes"]

    def max_slices(self, inverse: bool = False) -> dict[str, int]:
        path = "/slices/max" + ("?inverse=true" if inverse else "")
        status, raw = self._do("GET", path)
        return json.loads(self._ok(status, raw, "max slices"))["maxSlices"]

    def frame_views(self, index: str, frame: str) -> list[str]:
        status, raw = self._do("GET",
                               f"/index/{index}/frame/{frame}/views")
        return json.loads(self._ok(status, raw, "frame views"))\
            .get("views", [])

    def create_index(self, index: str, options: Optional[dict] = None
                     ) -> None:
        body = json.dumps({"options": options or {}}).encode()
        status, raw = self._do("POST", f"/index/{index}", body,
                               idempotent=True)
        if status not in (200, 409):
            self._ok(status, raw, "create index")

    def create_frame(self, index: str, frame: str,
                     options: Optional[dict] = None) -> None:
        body = json.dumps({"options": options or {}}).encode()
        status, raw = self._do("POST", f"/index/{index}/frame/{frame}",
                               body, idempotent=True)
        if status not in (200, 409):
            self._ok(status, raw, "create frame")

    # -- import (client.go:304-389) ------------------------------------------

    def fragment_nodes(self, index: str, slice: int) -> list[dict]:
        status, raw = self._do(
            "GET", f"/fragment/nodes?index={index}&slice={slice}")
        return json.loads(self._ok(status, raw, "fragment nodes"))

    def import_bits(self, index: str, frame: str, bits: list[Bit]) -> None:
        """Group by slice, then POST each group to EVERY owner node."""
        self.import_arrays(
            index, frame,
            np.fromiter((b.row_id for b in bits), dtype=np.uint64,
                        count=len(bits)),
            np.fromiter((b.column_id for b in bits), dtype=np.uint64,
                        count=len(bits)),
            np.fromiter((b.timestamp for b in bits), dtype=np.int64,
                        count=len(bits)))

    def _import_slice(self, index: str, frame: str, slice: int,
                      rows: np.ndarray, cols: np.ndarray,
                      ts: np.ndarray) -> None:
        # Raw-array wire format first (proto/rawimport.py — protobuf's
        # per-u64 varint decode was the measured wire bound), falling
        # back to protobuf per host on 415 so reference-shaped servers
        # keep working. All-zero timestamps stay off the wire in both
        # forms (the server treats absent as None).
        from ..proto import rawimport
        from ..utils.arrays import sort_dedupe
        from .. import SLICE_WIDTH
        raw_body = posn_body = pb_body = None
        # Timestamp-free blocks ride the presorted positions form
        # (rawimport v2): half the wire bytes, and the sort happens
        # HERE — np.sort releases the GIL, so encoding slice N+1
        # overlaps the server applying slice N on the concurrent
        # per-slice legs.
        use_posn = not ts.any() and (
            not len(rows) or int(rows.max()) < (1 << 43))
        nodes = self.fragment_nodes(index, slice)
        if not nodes:
            raise ClientError(f"no owner for slice {slice}")
        for node in nodes:
            host = node["host"]
            if host not in self._no_raw_import:
                posn = use_posn and host not in self._no_posn_import
                if posn:
                    if posn_body is None:
                        W = np.uint64(SLICE_WIDTH)
                        posn_body = rawimport.encode_positions(
                            index, frame, slice,
                            sort_dedupe(rows * W + cols % W))
                    body = posn_body
                elif raw_body is None:
                    raw_body = body = rawimport.encode(
                        index, frame, slice, rows, cols,
                        ts if ts.any() else None)
                else:
                    body = raw_body
                status, raw = self._do_429(
                    "POST", "/import", body,
                    {"Content-Type": rawimport.CONTENT_TYPE,
                     "Accept": _PROTOBUF}, host)
                if posn and status == 400 and b"version" in raw:
                    # Pre-v2 raw server: drop to the v1 pair form for
                    # this host (same negotiation idiom as the 415
                    # protobuf fallback below).
                    self._no_posn_import.add(host)
                    if raw_body is None:
                        raw_body = rawimport.encode(
                            index, frame, slice, rows, cols,
                            ts if ts.any() else None)
                    status, raw = self._do_429(
                        "POST", "/import", raw_body,
                        {"Content-Type": rawimport.CONTENT_TYPE,
                         "Accept": _PROTOBUF}, host)
                if status != 415:
                    self._ok(status, raw, f"import slice {slice}")
                    resp = pb.ImportResponse.FromString(raw)
                    if resp.Err:
                        raise ClientError(resp.Err)
                    continue
                self._no_raw_import.add(host)
            if pb_body is None:
                pb_body = pb.ImportRequest(
                    Index=index, Frame=frame, Slice=slice,
                    RowIDs=rows.tolist(), ColumnIDs=cols.tolist(),
                    Timestamps=ts.tolist() if ts.any() else []
                ).SerializeToString()
            status, raw = self._do_429(
                "POST", "/import", pb_body,
                {"Content-Type": _PROTOBUF, "Accept": _PROTOBUF},
                host)
            self._ok(status, raw, f"import slice {slice}")
            resp = pb.ImportResponse.FromString(raw)
            if resp.Err:
                raise ClientError(resp.Err)

    def _import_slice_positions(self, index: str, frame: str,
                                slice: int,
                                positions: np.ndarray) -> None:
        """POST one slice's PRESORTED slice-local positions to every
        owner (rawimport v2). Fallbacks mirror _import_slice's
        per-host negotiation: a pre-v2 raw server (400 "version")
        gets the v1 pair form, a reference-shaped server (415) gets
        protobuf — both reconstructed from the positions with three
        vector ops."""
        from ..proto import rawimport
        from .. import SLICE_WIDTH
        W = np.uint64(SLICE_WIDTH)
        body = rawimport.encode_positions(index, frame, slice,
                                          positions)
        rows = cols = pb_body = raw_body = None
        nodes = self.fragment_nodes(index, slice)
        if not nodes:
            raise ClientError(f"no owner for slice {slice}")

        def pairs():
            nonlocal rows, cols
            if rows is None:
                rows = positions // W
                cols = np.uint64(slice) * W + (positions % W)
            return rows, cols

        for node in nodes:
            host = node["host"]
            if host not in self._no_raw_import:
                if host not in self._no_posn_import:
                    status, raw = self._do_429(
                        "POST", "/import", body,
                        {"Content-Type": rawimport.CONTENT_TYPE,
                         "Accept": _PROTOBUF}, host)
                    if not (status == 400 and b"version" in raw):
                        if status != 415:
                            self._ok(status, raw,
                                     f"import slice {slice}")
                            resp = pb.ImportResponse.FromString(raw)
                            if resp.Err:
                                raise ClientError(resp.Err)
                            continue
                        self._no_raw_import.add(host)
                    else:
                        self._no_posn_import.add(host)
                if host not in self._no_raw_import:
                    if raw_body is None:
                        r, c = pairs()
                        raw_body = rawimport.encode(
                            index, frame, slice, r, c, None)
                    status, raw = self._do_429(
                        "POST", "/import", raw_body,
                        {"Content-Type": rawimport.CONTENT_TYPE,
                         "Accept": _PROTOBUF}, host)
                    if status != 415:
                        self._ok(status, raw, f"import slice {slice}")
                        resp = pb.ImportResponse.FromString(raw)
                        if resp.Err:
                            raise ClientError(resp.Err)
                        continue
                    self._no_raw_import.add(host)
            if pb_body is None:
                r, c = pairs()
                pb_body = pb.ImportRequest(
                    Index=index, Frame=frame, Slice=slice,
                    RowIDs=r.tolist(), ColumnIDs=c.tolist(),
                    Timestamps=[]).SerializeToString()
            status, raw = self._do_429(
                "POST", "/import", pb_body,
                {"Content-Type": _PROTOBUF, "Accept": _PROTOBUF},
                host)
            self._ok(status, raw, f"import slice {slice}")
            resp = pb.ImportResponse.FromString(raw)
            if resp.Err:
                raise ClientError(resp.Err)

    def import_arrays(self, index: str, frame: str, row_ids, column_ids,
                      timestamps=None) -> None:
        """Array-native import: group by slice with one stable argsort
        (the vector form of Bits.GroupBySlice, client.go:1027-1040) and
        POST each slice's block to every owner."""
        rows = np.asarray(row_ids, dtype=np.uint64)
        cols = np.asarray(column_ids, dtype=np.uint64)
        ts = (np.zeros(len(rows), dtype=np.int64) if timestamps is None
              else np.asarray(timestamps, dtype=np.int64))
        if not len(rows):
            return
        from ..utils.arrays import sort_dedupe
        W = np.uint64(SLICE_WIDTH)
        slices_a = cols // W
        if (not ts.any() and int(rows.max()) < (1 << 24)
                and int(slices_a.max()) < (1 << 20)):
            # Timestamp-free fast lane (the bulk-load shape): pack
            # (slice, position) into one u64 — the same idiom as
            # frame.put_arrays — so ONE sort_dedupe (np.sort releases
            # the GIL) orders and dedupes every slice's span at once,
            # and each span ships PRESORTED as a rawimport-v2
            # positions body: no per-slice re-sort here, none on the
            # server (add_many's is-sorted check passes), half the
            # wire bytes of the (rows, cols) pair form.
            packed = sort_dedupe((slices_a << np.uint64(44))
                                 | (rows * W + cols % W))
            sl = packed >> np.uint64(44)
            b = np.flatnonzero(sl[1:] != sl[:-1]) + 1
            mask = np.uint64((1 << 44) - 1)
            jobs = [(self._import_slice_positions,
                     (index, frame, int(sl[s]), packed[s:e] & mask))
                    for s, e in zip(
                        np.concatenate(([0], b)).tolist(),
                        np.concatenate((b, [len(sl)])).tolist())]
            if len(jobs) == 1:
                fn, args = jobs[0]
                fn(*args)
            else:
                self._import_by_host(index, jobs)
            return
        groups = list(group_by_key(slices_a, rows, cols, ts))
        if len(groups) == 1:
            slice, rs, cs, tss = groups[0]
            self._import_slice(index, frame, slice, rs, cs, tss)
            return
        # Per-slice blocks go to different owners: POST them
        # concurrently (client.go imports slices on goroutines), so one
        # slice's server-side apply overlaps the next one's encode and
        # transfer. First failure wins; the reference surfaces one
        # error the same way.
        self._parallel_slices(
            [(self._import_slice, (index, frame, slice, rs, cs, tss))
             for slice, rs, cs, tss in groups])

    def _import_by_host(self, index: str, jobs: list[tuple]) -> None:
        """Host-aware scheduling for per-slice import legs: slices
        whose primary owner is the SAME node post sequentially —
        concurrent same-host posts convoy on the GIL (client encode
        and the server's decode/apply share cores; measured 23%
        slower at 4-way fan-out than queued posts) — while distinct
        nodes still fan out in parallel, where the concurrency is
        real. Grouping is by first owner only (a scheduling choice;
        each leg still posts to every owner itself)."""
        groups: dict[str, list] = {}
        for fn, args in jobs:
            nodes = self.fragment_nodes(index, args[2])
            key = nodes[0]["host"] if nodes else ""
            groups.setdefault(key, []).append((fn, args))
        if len(groups) == 1:
            for fn, args in jobs:
                fn(*args)
            return

        def run_group(group: list) -> None:
            for fn, args in group:
                fn(*args)

        self._parallel_slices(
            [(run_group, (g,)) for g in groups.values()])

    def _parallel_slices(self, jobs: list[tuple]) -> None:
        """Run per-slice import legs concurrently; on the first error,
        cancel legs that have not started so a failed import bounds its
        partial writes to the in-flight slices (ADVICE r5 #2) — the
        import API stays at-least-once either way."""
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=min(4, len(jobs))) as tp:
            futs = [tp.submit(fn, *args) for fn, args in jobs]
            try:
                for f in futs:
                    f.result()
            except BaseException:
                tp.shutdown(wait=False, cancel_futures=True)
                raise

    # -- BSI field values ----------------------------------------------------

    def create_field(self, index: str, frame: str, field: str,
                     min: int = 0, max: int = 0) -> None:
        body = json.dumps({"min": min, "max": max}).encode()
        status, raw = self._do(
            "POST", f"/index/{index}/frame/{frame}/field/{field}", body,
            idempotent=True)
        if status not in (200, 409):
            self._ok(status, raw, "create field")

    def field_import_slice(self, index: str, frame: str, field: str,
                           slice: int, cols: np.ndarray,
                           vals: np.ndarray) -> None:
        """POST one slice's ImportValueRequest to EVERY owner node."""
        body = pb.ImportValueRequest(
            Index=index, Frame=frame, Field=field, Slice=slice,
            ColumnIDs=cols.tolist(),
            Values=vals.tolist()).SerializeToString()
        nodes = self.fragment_nodes(index, slice)
        if not nodes:
            raise ClientError(f"no owner for slice {slice}")
        for node in nodes:
            status, raw = self._do_429(
                "POST", f"/index/{index}/frame/{frame}/field/{field}"
                        f"/import", body,
                {"Content-Type": _PROTOBUF, "Accept": _PROTOBUF},
                node["host"])
            self._ok(status, raw, f"import field slice {slice}")
            resp = pb.ImportResponse.FromString(raw)
            if resp.Err:
                raise ClientError(resp.Err)

    def import_field_values(self, index: str, frame: str, field: str,
                            column_ids, values) -> None:
        """Bulk integer-field import: group (column, value) pairs by
        slice and fan each group out to its owner nodes — the
        ImportValue analogue of import_arrays."""
        cols = np.asarray(column_ids, dtype=np.uint64)
        vals = np.asarray(values, dtype=np.int64)
        if len(cols) != len(vals):
            raise ClientError("column/value length mismatch")
        if not len(cols):
            return
        groups = list(group_by_key(cols // np.uint64(SLICE_WIDTH),
                                   cols, vals))
        if len(groups) == 1:
            slice, cs, vs = groups[0]
            self.field_import_slice(index, frame, field, slice, cs, vs)
            return
        self._parallel_slices(
            [(self.field_import_slice, (index, frame, field, slice,
                                        cs, vs))
             for slice, cs, vs in groups])

    # -- export (client.go:392-460) ------------------------------------------

    # Spool cap: slices smaller than this stay in memory; larger ones
    # roll to a temp file, so a 128 MB+ slice never sits in RAM whole.
    _SPOOL_MAX = 1 << 24

    def export_csv_to(self, w, index: str, frame: str, view: str,
                      slice: int) -> None:
        """Stream one slice's CSV into text writer ``w``, trying each
        owner until one succeeds (client.go:392-460 streams through
        io.Copy; whole-slice CSV is too big to buffer). The download
        spools through a bounded temp file so an owner dying mid-body
        fails over without having written partial rows to ``w``."""
        import shutil
        import tempfile
        nodes = self.fragment_nodes(index, slice)
        random.shuffle(nodes)
        last_err = None
        for node in nodes:
            try:
                rd = self._do_stream(
                    f"/export?index={index}&frame={frame}&view={view}"
                    f"&slice={slice}", host=node["host"],
                    headers={"Accept": "text/csv"})
            except ClientError as e:
                last_err = e
                continue
            try:
                if rd.status != 200:
                    last_err = ClientError(f"export: status={rd.status}")
                    continue
                with tempfile.SpooledTemporaryFile(
                        max_size=self._SPOOL_MAX) as spool:
                    try:
                        shutil.copyfileobj(rd, spool, 1 << 20)
                    except (http.client.HTTPException, OSError) as e:
                        last_err = ClientError(
                            f"export from {node['host']}: {e}")
                        continue
                    spool.seek(0)
                    while True:
                        chunk = spool.read(1 << 20)
                        if not chunk:
                            return
                        w.write(chunk.decode())
            finally:
                rd.close()
        raise last_err or ClientError("no nodes")

    def export_csv(self, index: str, frame: str, view: str, slice: int
                   ) -> str:
        """Buffered convenience form of export_csv_to."""
        import io as _io
        buf = _io.StringIO()
        self.export_csv_to(buf, index, frame, view, slice)
        return buf.getvalue()

    # -- backup / restore (client.go:463-695) --------------------------------

    def backup_slice(self, index: str, frame: str, view: str, slice: int,
                     snapshot: bool = False):
        """One slice's fragment tar as a seekable bounded spool (the
        caller closes it); None if the slice doesn't exist yet
        (client.go:541-580). The body downloads inside the per-owner
        loop so a node dying mid-transfer fails over to a replica.
        ``snapshot=True`` asks the owner to fold its WAL into a fresh
        footered snapshot first (the backup coordinator's barrier)."""
        import shutil
        import tempfile
        nodes = self.fragment_nodes(index, slice)
        random.shuffle(nodes)
        snap = "&snapshot=1" if snapshot else ""
        last_err: Optional[Exception] = None
        for node in nodes:
            try:
                rd = self._do_stream(
                    f"/fragment/data?index={index}&frame={frame}"
                    f"&view={view}&slice={slice}{snap}",
                    host=node["host"])
            except ClientError as e:
                last_err = e
                continue
            try:
                if rd.status == 404:
                    return None
                if rd.status != 200:
                    last_err = ClientError(
                        f"backup slice: status={rd.status}")
                    continue
                spool = tempfile.SpooledTemporaryFile(
                    max_size=self._SPOOL_MAX)
                try:
                    shutil.copyfileobj(rd, spool, 1 << 20)
                except (http.client.HTTPException, OSError) as e:
                    spool.close()
                    last_err = ClientError(
                        f"backup slice from {node['host']}: {e}")
                    continue
                spool.seek(0)
                return spool
            finally:
                rd.close()
        if last_err:
            raise last_err
        return None

    def restore_slice(self, index: str, frame: str, view: str, slice: int,
                      data) -> None:
        """POST one slice tar (bytes or a sized file-like) to this host."""
        headers = {"Content-Type": "application/octet-stream"}
        if not isinstance(data, bytes):
            # An explicit length keeps http.client from chunking, which
            # the WSGI server does not decode.
            pos = data.tell()
            data.seek(0, 2)
            headers["Content-Length"] = str(data.tell() - pos)
            data.seek(pos)
        status, raw = self._do(
            "POST", f"/fragment/data?index={index}&frame={frame}"
                    f"&view={view}&slice={slice}", data, headers)
        self._ok(status, raw, "restore slice")

    def backup_to(self, w, index: str, frame: str, view: str) -> None:
        """Stream every slice of (index, frame, view) into a tar whose
        entries are named by slice id (client.go:463-529). Slices spool
        through bounded temp files (tar headers need the size upfront);
        peak memory stays at the spool cap, not the slice size."""
        import tarfile
        tw = tarfile.open(fileobj=w, mode="w|")
        max_slice = self.max_slices().get(index, 0)
        for slice in range(max_slice + 1):
            spool = self.backup_slice(index, frame, view, slice)
            if spool is None:
                continue
            with spool:
                spool.seek(0, 2)
                size = spool.tell()
                spool.seek(0)
                info = tarfile.TarInfo(str(slice))
                info.size = size
                info.mode = 0o666
                tw.addfile(info, spool)
        tw.close()

    def restore_from(self, r, index: str, frame: str, view: str) -> None:
        """Restore a backup_to tar: push each slice entry to every owner
        (client.go:583-674). Entries spool through a bounded temp file
        (each goes to multiple owners, so the source must be re-readable)
        and POST as streaming bodies."""
        import shutil
        import tarfile
        import tempfile
        tr = tarfile.open(fileobj=r, mode="r|")
        for info in tr:
            if not info.name.isdigit():
                raise ClientError(f"invalid backup entry: {info.name}")
            slice = int(info.name)
            src = tr.extractfile(info)
            with tempfile.SpooledTemporaryFile(
                    max_size=self._SPOOL_MAX) as spool:
                shutil.copyfileobj(src, spool, 1 << 20)
                for node in self.fragment_nodes(index, slice):
                    spool.seek(0)
                    status, raw = self._do(
                        "POST", f"/fragment/data?index={index}"
                                f"&frame={frame}&view={view}"
                                f"&slice={slice}", spool,
                        {"Content-Type": "application/octet-stream",
                         "Content-Length": str(info.size)},
                        host=node["host"])
                    self._ok(status, raw, f"restore slice {slice}")

    def restore_frame(self, host: str, index: str, frame: str) -> None:
        """Ask this node to pull a frame from a remote cluster host
        (client.go:677-695 → POST /index/{i}/frame/{f}/restore)."""
        status, raw = self._do(
            "POST", f"/index/{index}/frame/{frame}/restore?host={host}",
            b"")
        self._ok(status, raw, "restore frame")

    # -- anti-entropy (client.go:798-974) ------------------------------------

    def fragment_blocks(self, index: str, frame: str, view: str,
                        slice: int, host: Optional[str] = None
                        ) -> list[tuple[int, bytes]]:
        from ..server import codec
        status, raw = self._do(
            "GET", f"/fragment/blocks?index={index}&frame={frame}"
                   f"&view={view}&slice={slice}", host=host)
        if status == 404:
            raise FragmentNotFoundError()
        return codec.blocks_from_json(
            json.loads(self._ok(status, raw, "fragment blocks"))
            .get("blocks") or [])

    def block_data(self, index: str, frame: str, view: str, slice: int,
                   block: int, host: Optional[str] = None
                   ) -> tuple[np.ndarray, np.ndarray]:
        req = pb.BlockDataRequest(Index=index, Frame=frame, View=view,
                                  Slice=slice, Block=block)
        status, raw = self._do(
            "GET", "/fragment/block/data", req.SerializeToString(),
            {"Content-Type": _PROTOBUF, "Accept": _PROTOBUF}, host=host)
        self._ok(status, raw, "block data")
        resp = pb.BlockDataResponse.FromString(raw)
        return (np.array(resp.RowIDs, dtype=np.uint64),
                np.array(resp.ColumnIDs, dtype=np.uint64))

    def fragment_import(self, index: str, frame: str, view: str,
                        slice: int, positions: np.ndarray,
                        host: Optional[str] = None) -> None:
        """Additive per-fragment import of slice-local bit positions
        (row*SLICE_WIDTH + col%SLICE_WIDTH) — the resize streamer's
        push lane (POST /fragment/import): unlike the /fragment/data
        restore it never replaces content (concurrent double-writes
        land between a diff read and this push), and unlike /import it
        applies to the EXACT (frame, view) fragment so time and
        inverse views migrate byte-faithfully. Idempotent (re-adding
        set bits is a no-op), so torn streams re-push safely."""
        body = np.asarray(positions, dtype="<u8").tobytes()
        status, raw = self._do(
            "POST", f"/fragment/import?index={index}&frame={frame}"
                    f"&view={view}&slice={slice}", body,
            {"Content-Type": "application/octet-stream"}, host=host,
            idempotent=True)
        if status == 404:
            raise FragmentNotFoundError()
        self._ok(status, raw, "fragment import")

    def post_message(self, data: bytes,
                     host: Optional[str] = None,
                     deadline_s: Optional[float] = None) -> None:
        """POST one marshaled broadcast envelope to a node's
        /messages — the resize coordinator's DIRECT, acked control
        sends (a 200 is the node's ack; any failure raises)."""
        status, raw = self._do(
            "POST", "/messages", data,
            {"Content-Type": "application/x-protobuf"}, host=host,
            idempotent=True, deadline_s=deadline_s)
        self._ok(status, raw, "post message")

    def column_attr_diff(self, index: str, blocks: list[tuple[int, bytes]],
                         host: Optional[str] = None) -> dict[int, dict]:
        return self._attr_diff(f"/index/{index}/attr/diff", blocks, host)

    def row_attr_diff(self, index: str, frame: str,
                      blocks: list[tuple[int, bytes]],
                      host: Optional[str] = None) -> dict[int, dict]:
        return self._attr_diff(f"/index/{index}/frame/{frame}/attr/diff",
                               blocks, host)

    def _attr_diff(self, path: str, blocks, host) -> dict[int, dict]:
        from ..server import codec
        body = json.dumps({"blocks": codec.blocks_to_json(blocks)}).encode()
        status, raw = self._do("POST", path, body, host=host,
                               idempotent=True)  # pure read
        if status == 404:
            raise FragmentNotFoundError()
        attrs = json.loads(self._ok(status, raw, "attr diff"))["attrs"]
        return {int(k): v for k, v in attrs.items()}
