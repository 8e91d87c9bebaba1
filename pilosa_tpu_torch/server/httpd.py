"""Minimal threaded HTTP/1.1 server for the WSGI handler.

A copy of the JAX package's ``server/httpd.py``.

The reference serves each connection on a goroutine with net/http
(server.go:146): keep-alive connections, concurrent accept, little
per-request overhead. The stdlib wsgiref server speaks HTTP/1.0 (a
fresh TCP connection and a fresh thread per request), so this one
replaces it.

Design:
- thread per CONNECTION (goroutine analogue), keep-alive by default,
  one tight request parser (find header end, split request line, scan
  the few headers the app reads).
- PIPELINING: every complete request already buffered is parsed before
  responding, and the responses go out in order.
- QUERY BATCH LANE: consecutive pipelined ``POST /index/{i}/query``
  requests (plain-PQL JSON, same index, no query string) go to the
  server's ``query_batcher`` as ONE executor call — a 1,000-request
  SetBit burst becomes a few batched mutations and one commit barrier.
  A write that adds a slice ends the executor call, so a later read in
  the burst sees that slice, as it would sent alone.
  Each request keeps its own response; when the batcher declines
  (None) the requests go one by one, so error semantics stay those of
  sequential dispatch.
"""

from __future__ import annotations

import io
import re
import socket
import sys
import threading

from ..utils import logger as logger_mod

# Largest single request (header + body) accepted; matches the import
# path's 10M-bit buffers with headroom.
_MAX_REQUEST = 1 << 28

_QUERY_PATH_RE = re.compile(r"^/index/([^/]+)/query$")

_STATUS_REASON = {200: "OK", 400: "Bad Request", 402: "Payment Required",
                  404: "Not Found",
                  405: "Method Not Allowed", 409: "Conflict",
                  429: "Too Many Requests",
                  500: "Internal Server Error",
                  501: "Not Implemented", 503: "Service Unavailable",
                  504: "Gateway Timeout", 507: "Insufficient Storage"}


class _Request:
    __slots__ = ("method", "path", "qs", "headers", "body", "close")

    def __init__(self, method, path, qs, headers, body, close):
        self.method = method
        self.path = path
        self.qs = qs
        self.headers = headers  # dict, lower-cased keys
        self.body = body
        self.close = close


class HTTPServer:
    """Threaded HTTP/1.1 front door over a WSGI app."""

    def __init__(self, app, host: str, port: int,
                 logger=logger_mod.NOP, query_batcher=None):
        self.app = app
        self.logger = logger
        # query_batcher(index, [pql bodies]) -> list of payloads | None
        self.query_batcher = query_batcher
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(512)
        self.server_address = self._sock.getsockname()
        self._closing = threading.Event()
        self._conns: set[socket.socket] = set()
        self._conns_mu = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def serve_forever(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Accepted sockets do NOT inherit SO_REUSEADDR on Linux;
            # without it, a lingering keep-alive connection in FIN_WAIT
            # blocks rebinding the port on restart (the reference's
            # net/http restarts fine for the same reason: Go sets
            # REUSEADDR on every socket).
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            with self._conns_mu:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="httpd-conn").start()

    def shutdown(self) -> None:
        self._closing.set()
        try:
            # A thread blocked in accept() pins the listening socket
            # past close() (close only drops the fd table entry);
            # shutdown() wakes the accept so the socket actually dies
            # and the port frees for restart.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def server_close(self) -> None:
        self.shutdown()
        with self._conns_mu:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    # -- connection loop -----------------------------------------------------

    # Idle keep-alive connections release their thread + fd after this
    # long (the thread-per-connection model would otherwise pin one of
    # each per idle client forever; Go's net/http has the same knob in
    # IdleTimeout).
    IDLE_TIMEOUT_S = 120.0

    def _serve_conn(self, conn: socket.socket) -> None:
        conn.settimeout(self.IDLE_TIMEOUT_S)
        buf = bytearray()
        need = 0
        try:
            while not self._closing.is_set():
                if need and len(buf) < need:
                    # A partial request with known total size: keep
                    # receiving without re-parsing (re-scanning the
                    # buffer per 64 KB recv made multi-MB bodies
                    # quadratic in header finds).
                    try:
                        data = conn.recv(1 << 20)
                    except TimeoutError:
                        return
                    if not data:
                        return
                    buf += data
                    if len(buf) > _MAX_REQUEST:
                        conn.sendall(self._plain_response(
                            400, "request too large", close=True))
                        return
                    continue
                reqs, bad, need = self._drain_requests(buf)
                if bad:
                    # Serve the valid requests already parsed FIRST —
                    # the client must not read the 400 as the response
                    # to an earlier (valid, possibly mutating) request.
                    if reqs:
                        items, _ = self._process(reqs)
                        for item in items:
                            if isinstance(item, bytes):
                                conn.sendall(item)
                            else:
                                for chunk in item:
                                    if chunk:
                                        conn.sendall(chunk)
                    conn.sendall(self._plain_response(
                        400, "malformed request", close=True))
                    return
                if reqs:
                    items, close = self._process(reqs)
                    for item in items:
                        if isinstance(item, bytes):
                            conn.sendall(item)
                        else:  # streamed body: send chunk by chunk
                            for chunk in item:
                                if chunk:
                                    conn.sendall(chunk)
                    if close:
                        return
                    continue
                try:
                    data = conn.recv(1 << 16)
                except TimeoutError:
                    return  # idle past IDLE_TIMEOUT_S
                if not data:
                    return
                buf += data
                if len(buf) > _MAX_REQUEST:
                    conn.sendall(self._plain_response(
                        400, "request too large", close=True))
                    return
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_mu:
                self._conns.discard(conn)

    def _drain_requests(self, buf: bytearray):
        """Parse every complete request in ``buf`` (consuming them).
        Returns (requests, malformed, need): ``need`` is the total
        buffered size required to complete the trailing PARTIAL request
        (0 when unknown), so the receive loop can fill large bodies
        without re-parsing per recv."""
        reqs: list[_Request] = []
        while True:
            end = buf.find(b"\r\n\r\n")
            if end < 0:
                return reqs, False, 0
            head = bytes(buf[:end]).decode("latin-1")
            lines = head.split("\r\n")
            parts = lines[0].split(" ")
            if len(parts) != 3 or not parts[2].startswith("HTTP/1"):
                return reqs, True, 0
            method, target, proto = parts
            headers = {}
            for ln in lines[1:]:
                k, sep, v = ln.partition(":")
                if sep:
                    headers[k.lower()] = v.strip()
            if "chunked" in headers.get("transfer-encoding", ""):
                return reqs, True, 0  # like wsgiref: no chunked uploads
            try:
                length = int(headers.get("content-length") or 0)
            except ValueError:
                return reqs, True, 0
            total = end + 4 + length
            if length > _MAX_REQUEST:
                return reqs, False, 0  # rejected by the size guard
            if total > len(buf):
                return reqs, False, total  # body not fully buffered
            body = bytes(buf[end + 4:total])
            del buf[:total]
            path, _, qs = target.partition("?")
            close = (headers.get("connection", "").lower() == "close"
                     or proto == "HTTP/1.0")
            reqs.append(_Request(method, path, qs, headers, body, close))
            if close:
                return reqs, False, 0

    # -- request processing --------------------------------------------------

    def _process(self, reqs: list[_Request]) -> tuple[list, bool]:
        """Response items (bytes, or a generator for streamed bodies)
        for a pipelined group, in request order, batching query POST
        runs."""
        out: list = []
        close = False
        i = 0
        n = len(reqs)
        while i < n:
            run_index = self._batchable_index(reqs[i])
            if run_index is not None:
                j = i + 1
                while (j < n
                       and self._batchable_index(reqs[j]) == run_index):
                    j += 1
                if j - i >= 2 and self.query_batcher is not None:
                    bodies = [reqs[k].body.decode("latin-1")
                              for k in range(i, j)]
                    batched = self.query_batcher(run_index, bodies)
                    if batched is not None:
                        out.append(b"".join(
                            self._json_response(payload,
                                                reqs[i + k].close)
                            for k, payload in enumerate(batched)))
                        close = reqs[j - 1].close
                        i = j
                        continue
            resp, close = self._dispatch_wsgi(reqs[i])
            out.append(resp)
            i += 1
            if close:
                break
        return out, close

    def _batchable_index(self, req: _Request):
        """The index name when this request can join a query batch run,
        else None (protobuf bodies or answers, a query string —
        slices, columnAttrs, plan — and a closing request go one by
        one)."""
        if req.method != "POST" or req.qs or req.close:
            return None
        m = _QUERY_PATH_RE.match(req.path)
        if m is None:
            return None
        if "protobuf" in req.headers.get("content-type", ""):
            return None
        if "protobuf" in req.headers.get("accept", ""):
            return None
        return m.group(1)

    def _dispatch_wsgi(self, req: _Request):
        environ = {
            "REQUEST_METHOD": req.method,
            "PATH_INFO": req.path,
            "QUERY_STRING": req.qs,
            "SERVER_PROTOCOL": "HTTP/1.1",
            "SERVER_NAME": self.server_address[0],
            "SERVER_PORT": str(self.server_address[1]),
            "CONTENT_TYPE": req.headers.get("content-type", ""),
            "CONTENT_LENGTH": str(len(req.body)),
            "wsgi.version": (1, 0),
            "wsgi.url_scheme": "http",
            "wsgi.input": io.BytesIO(req.body),
            "wsgi.errors": sys.stderr,
            "wsgi.multithread": True,
            "wsgi.multiprocess": False,
            "wsgi.run_once": False,
        }
        for k, v in req.headers.items():
            environ["HTTP_" + k.upper().replace("-", "_")] = v
        captured: dict = {}

        def start_response(status, headers, exc_info=None):
            captured["status"] = status
            captured["headers"] = headers

        body_iter = self.app(environ, start_response)
        status = captured.get("status", "500 Internal Server Error")
        headers = captured.get("headers", [])
        has_length = any(k.lower() == "content-length"
                         for k, _ in headers)
        head = [f"HTTP/1.1 {status}"]
        head.extend(f"{k}: {v}" for k, v in headers)
        if has_length:
            conn_hdr = "close" if req.close else "keep-alive"
            head.append(f"Connection: {conn_hdr}")
            head.append("")
            head.append("")
            parts = [("\r\n".join(head)).encode("latin-1")]
            parts.extend(body_iter)
            return b"".join(parts), req.close
        # Streamed response with unknown length: close-delimited (the
        # CSV export / tar download path — can be 100 MB+, never
        # buffered whole). Returned as a generator; the connection loop
        # sends chunk by chunk then closes.
        head.append("Connection: close")
        head.append("")
        head.append("")

        def stream():
            yield ("\r\n".join(head)).encode("latin-1")
            yield from body_iter
        return stream(), True

    # -- response builders ---------------------------------------------------

    @staticmethod
    def _json_response(payload, close: bool) -> bytes:
        """Frame one batch-lane payload: plain bytes are a 200; a
        (status, bytes) tuple carries an error status."""
        status = 200
        if isinstance(payload, tuple):
            status, payload = payload
        conn_hdr = "close" if close else "keep-alive"
        reason = _STATUS_REASON.get(status, "Unknown")
        return (f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: {conn_hdr}\r\n\r\n"
                ).encode("latin-1") + payload

    @staticmethod
    def _plain_response(status: int, msg: str, close: bool) -> bytes:
        body = (msg + "\n").encode()
        conn_hdr = "close" if close else "keep-alive"
        return (f"HTTP/1.1 {status} {_STATUS_REASON.get(status, '?')}\r\n"
                f"Content-Type: text/plain; charset=utf-8\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: {conn_hdr}\r\n\r\n").encode("latin-1") + body
