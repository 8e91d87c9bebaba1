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
barrier before their acks. Admission,
tenants, the query registry and the metrics around that lane in the
JAX package wait for the operator slice. Cluster
membership, gossip, anti-entropy, the background loops (cache flush,
scrub, tiering, backup) and the observability subsystems wait for the
slices that port them.
"""

from __future__ import annotations

import errno
import json
import threading

from .. import SLICE_WIDTH
from ..device import resolve_device
from ..errors import PilosaError
from ..executor import _WRITE_CALLS, Executor
from ..models.holder import Holder
from ..models.view import VIEW_INVERSE
from ..pql import parser as pql
from ..pql.ast import Query
from ..storage import wal as storage_wal
from ..utils import logger as logger_mod
from . import codec
from .handler import Handler
from .httpd import HTTPServer

DEFAULT_PORT = 10101


class Server:
    def __init__(self, data_dir: str, host: str = "localhost:10101",
                 device=None, logger=logger_mod.NOP,
                 wal_fsync: str = storage_wal.FSYNC_NONE):
        self.data_dir = data_dir
        self.host = host
        self.device = device
        self.wal_fsync = wal_fsync
        self.logger = logger
        self.holder = None
        self.executor = None
        self.handler = None
        self._httpd = None
        self._thread = None

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
            self.executor = Executor(self.holder, device=device)
            self.handler = Handler(self.holder, self.executor,
                                   host=self.host, logger=self.logger)
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
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="httpd")
        self._thread.start()
        self.logger.printf("listening as http://%s on %s", self.host,
                           device)

    def close(self) -> None:
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
        that wrote take one commit barrier before any ack goes out."""
        if self.executor is None:
            return None
        try:
            queries = [pql.parse(b) for b in bodies]
        except PilosaError:
            return None
        calls = [c for q in queries for c in q.calls]
        if not calls or all(c.name == "SetRowAttrs" for c in calls):
            return None  # the bulk attribute path applies out of order
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
            out += self._run_payloads(index, queries[start:end])
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

    def _run_payloads(self, index: str, queries: list[Query]) -> list:
        """The responses of one run of requests: one ``execute_partial``
        call over their calls, mapped back onto the requests."""
        calls = [c for q in queries for c in q.calls]
        if all(c.name == "SetRowAttrs" for c in calls):
            # The bulk attribute path applies out of order: one by one.
            return [self._single_query_payload(index, q) for q in queries]
        results, err = self.executor.execute_partial(index, Query(calls))
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
                out.append(_error_payload(
                    err, 400 if isinstance(err, PilosaError) else 500))
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


def _error_payload(err: Exception, status: int) -> tuple[int, bytes]:
    """A non-200 batch-lane entry: the HTTP front frames a plain bytes
    entry as a 200, so an error carries its status."""
    return status, (json.dumps({"error": str(err)}) + "\n").encode()
