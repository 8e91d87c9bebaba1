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
``Retry-After`` when the disk is full, 500 otherwise. ``?plan=1`` on
the query route plans the query without executing it (EXPLAIN).
Admission, tenants, tracing, cost accounting, plan and workload capture
wait for the slices that port those subsystems, as do the
``/debug/*``, ``/metrics``, cluster, backup, fragment-sync, pod and
web-console routes.
"""

from __future__ import annotations

import datetime as dt
import errno
import json
import re
from typing import Callable
from urllib.parse import parse_qs

import numpy as np

from .. import SLICE_WIDTH, __version__
from ..errors import (FrameExistsError, IndexExistsError, PilosaError,
                      validate_label)
from ..models.frame import Field, FrameOptions
from ..models.index import IndexOptions
from ..pql import parser as pql
from ..proto import internal as pb
from ..proto import rawimport
from ..storage import wal as storage_wal
from ..storage.attrs import diff_blocks
from ..storage.bitmap import Bitmap
from ..utils import logger as logger_mod
from ..utils import timequantum as tq
from ..utils.streams import CappedReader
from . import codec

_PROTOBUF = "application/x-protobuf"

# JSON keys accepted in POST /index and POST /frame options
# (handler.go:299-351 validates against the Go struct tags).
_VALID_INDEX_OPTIONS = {"columnLabel", "timeQuantum"}
_VALID_FRAME_OPTIONS = {"rowLabel", "inverseEnabled", "cacheType",
                        "cacheSize", "timeQuantum", "fields"}

# Node state in /status (the one node of this server is always up).
NODE_STATE_UP = "UP"


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


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
    def json(obj, status: int = 200) -> "Response":
        return Response(status, (json.dumps(obj) + "\n").encode())

    @staticmethod
    def proto(msg, status: int = 200) -> "Response":
        return Response(status, msg.SerializeToString(), _PROTOBUF)


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


_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 406: "Not Acceptable",
                409: "Conflict", 415: "Unsupported Media Type",
                500: "Internal Server Error",
                507: "Insufficient Storage"}

# Retry-After of a 507 (the JAX package's fault.diskfull RETRY_AFTER_S).
RETRY_AFTER_S = 2


class Handler:
    """Router + handlers over one holder and its executor (any object
    with ``execute(index, query, slices)``). ``host`` is the node's
    ``host:port`` as ``/hosts`` and ``/status`` report it; empty for a
    handler served in-process."""

    def __init__(self, holder, executor, host: str = "",
                 logger=logger_mod.NOP):
        self.logger = logger
        self.holder = holder
        self.executor = executor
        self.host = host
        self.version = __version__
        # (method, regex, handler)
        self._routes: list[tuple] = []
        self._add_routes()

    # -- routing -------------------------------------------------------------

    def _route(self, method: str, pattern: str, fn: Callable) -> None:
        # {name} segments become named groups matching one path segment.
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self._routes.append((method, re.compile(f"^{regex}$"), fn))

    def _add_routes(self) -> None:
        # Route table (reference handler.go:82-120), one-node routes.
        r = self._route
        r("GET", "/index", self._handle_get_schema)
        r("GET", "/index/{index}", self._handle_get_index)
        r("POST", "/index/{index}", self._handle_post_index)
        r("DELETE", "/index/{index}", self._handle_delete_index)
        r("POST", "/index/{index}/attr/diff", self._handle_index_attr_diff)
        r("POST", "/index/{index}/frame/{frame}", self._handle_post_frame)
        r("DELETE", "/index/{index}/frame/{frame}",
          self._handle_delete_frame)
        r("POST", "/index/{index}/query", self._handle_post_query)
        r("POST", "/index/{index}/frame/{frame}/attr/diff",
          self._handle_frame_attr_diff)
        r("PATCH", "/index/{index}/frame/{frame}/time-quantum",
          self._handle_patch_frame_time_quantum)
        r("GET", "/index/{index}/frame/{frame}/views",
          self._handle_get_frame_views)
        r("GET", "/index/{index}/frame/{frame}/fields",
          self._handle_get_frame_fields)
        r("POST", "/index/{index}/frame/{frame}/field/{field}",
          self._handle_post_frame_field)
        r("POST", "/index/{index}/frame/{frame}/field/{field}/import",
          self._handle_post_field_import)
        r("PATCH", "/index/{index}/time-quantum",
          self._handle_patch_index_time_quantum)
        r("GET", "/export", self._handle_get_export)
        r("POST", "/import", self._handle_post_import)
        r("GET", "/hosts", self._handle_get_hosts)
        r("GET", "/schema", self._handle_get_schema)
        r("GET", "/slices/max", self._handle_slice_max)
        r("GET", "/status", self._handle_get_status)
        r("GET", "/version", self._handle_get_version)

    def __call__(self, environ, start_response):
        method = environ.get("REQUEST_METHOD", "GET")
        path = environ.get("PATH_INFO", "/")
        # HEAD serves through GET handlers with the body dropped —
        # net/http gives the reference this for free.
        head = method == "HEAD"
        if head:
            method = "GET"
        matched_path = False
        for m, regex, fn in self._routes:
            match = regex.match(path)
            if match is None:
                continue
            matched_path = True
            if m != method:
                continue
            try:
                resp = fn(Request(environ, match.groupdict()))
            except HTTPError as e:
                resp = Response(e.status, (e.message + "\n").encode(),
                                "text/plain; charset=utf-8")
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
        start_response(status_line, [("Content-Type", resp.content_type)])
        return resp.body

    # -- meta ----------------------------------------------------------------

    def _handle_get_version(self, req: Request) -> Response:
        return Response.json({"version": self.version})

    def _handle_get_hosts(self, req: Request) -> Response:
        return Response.json([{"host": self.host, "internalHost": ""}]
                             if self.host else [])

    def _handle_get_status(self, req: Request) -> Response:
        """The one node, UP, with each index's max slice, the slices it
        owns (all of them) and its frames — the JAX server's JSON shape
        (server.go:306-351)."""
        indexes = []
        for name in sorted(self.holder.indexes):
            idx = self.holder.indexes[name]
            max_slice = idx.max_slice()
            indexes.append({"name": name, "maxSlice": max_slice,
                            "slices": list(range(max_slice + 1)),
                            "frames": [{"name": fn}
                                       for fn in sorted(idx.frames)]})
        return Response.json({"status": {"nodes": [
            {"host": self.host, "state": NODE_STATE_UP,
             "indexes": indexes}]}})

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
        return Response.json({})

    def _handle_delete_index(self, req: Request) -> Response:
        self.holder.delete_index(req.vars["index"])
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
        return Response.json({})

    def _handle_delete_frame(self, req: Request) -> Response:
        idx = self.holder.index(req.vars["index"])
        if idx is not None:
            idx.delete_frame(req.vars["frame"])
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
        "max": M}``)."""
        frame = self.holder.frame(req.vars["index"], req.vars["frame"])
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
        else:
            body = req.json()
            cols = np.asarray(body.get("columns", []), dtype=np.uint64)
            vals = np.asarray(body.get("values", []), dtype=np.int64)
        if len(cols) != len(vals):
            raise HTTPError(400, "import array length mismatch")
        frame = self.holder.frame(index_name, frame_name)
        if frame is None:
            raise HTTPError(404, "frame not found")
        if frame.field(field_name) is None:
            raise HTTPError(404, "field not found")
        frame.import_field_values(field_name, cols, vals)
        storage_wal.barrier_all()  # commit before the 200
        if req.content_type == _PROTOBUF:
            return Response.proto(pb.ImportResponse())
        return Response.json({})

    # -- query (handler.go:811-893) ------------------------------------------

    def _handle_post_query(self, req: Request) -> Response:
        index_name = req.vars["index"]
        proto_out = _PROTOBUF in req.accept

        def error_resp(status, msg, headers=()):
            if proto_out:
                resp = Response.proto(pb.QueryResponse(Err=msg), status)
            else:
                resp = Response.json({"error": msg}, status)
            resp.headers.extend(headers)
            return resp

        if req.content_type == _PROTOBUF:
            preq = pb.QueryRequest.FromString(req.body())
            query_str = preq.Query
            slices = np.asarray(preq.Slices).tolist()
            column_attrs = preq.ColumnAttrs
        else:
            query_str = req.body().decode()
            try:
                slices = [int(s)
                          for s in req.query.get("slices", "").split(",")
                          if s != ""]
            except ValueError:
                return error_resp(400, "invalid slice argument")
            column_attrs = req.query.get("columnAttrs") == "true"
        try:
            query = pql.parse(query_str)
        except PilosaError as e:
            return error_resp(400, str(e))
        if req.query.get("plan") == "1":
            # EXPLAIN-only: the plan tree (estimates and decisions), no
            # execution.
            try:
                tree = self.executor.explain(index_name, query,
                                             slices or None)
            except PilosaError as e:
                return error_resp(400, str(e))
            return Response.json({"results": [], "plan": tree})
        try:
            results = self.executor.execute(index_name, query,
                                            slices or None)
            if query.write_calls():
                # Commit barrier before the ack: every mutation this
                # query applied has its WAL record in the OS (fsynced
                # per the fsync policy) when the response goes out.
                storage_wal.barrier_all()
        except storage_wal.WalError as e:
            # A barrier that failed on a full disk is retryable: 507 +
            # Retry-After. Any other WAL failure stays a 500.
            if getattr(e.__cause__, "errno", None) == errno.ENOSPC:
                return error_resp(
                    507, f"insufficient storage: write not durable ({e})",
                    headers=[("Retry-After", str(RETRY_AFTER_S))])
            self.logger.printf("query commit barrier failed: %s", e)
            return error_resp(500, str(e))
        except PilosaError as e:
            return error_resp(400, str(e))
        except Exception as e:  # noqa: BLE001 - surfaced in response
            self.logger.printf("query error: index=%s query=%.120s: %s",
                               index_name, query_str, e)
            return error_resp(500, str(e))

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
        if proto_out:
            return Response.proto(
                codec.encode_query_response(results, attr_sets))
        return Response.json(codec.query_response_json(results, attr_sets))

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
        if req.content_type == rawimport.CONTENT_TYPE:
            try:
                (index_name, frame_name, slice, rows, cols,
                 ts_ns, positions) = rawimport.decode(req.body())
            except ValueError as e:
                raise HTTPError(400, str(e))
        else:
            ireq = pb.ImportRequest.FromString(req.body())
            index_name, frame_name, slice = \
                ireq.Index, ireq.Frame, ireq.Slice
            rows, cols = ireq.RowIDs, ireq.ColumnIDs
            ts_ns = ireq.Timestamps if len(ireq.Timestamps) else None
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
        if positions is not None:
            # A writable copy: the decoded array is a view of the
            # request body.
            frame.import_slice_positions(slice, np.array(positions))
        else:
            frame.import_bits(rows, cols, timestamps)
        # Commit barrier before the 200: the import lanes barrier their
        # own fragment's WAL; this covers every fragment the request
        # touched (time views and the inverse transpose included),
        # coalesced with concurrent imports' barriers.
        storage_wal.barrier_all()
        return Response.proto(pb.ImportResponse())

    def _handle_get_export(self, req: Request) -> Response:
        if req.accept != "text/csv":
            raise HTTPError(406, "Not acceptable")
        slice = req.uint_param("slice")
        frag = self.holder.fragment(req.query.get("index", ""),
                                    req.query.get("frame", ""),
                                    req.query.get("view", ""), slice)
        if frag is None:
            return Response(200, b"", "text/csv")
        return Response(200, _export_csv_chunks(frag.positions(), slice),
                        "text/csv")
