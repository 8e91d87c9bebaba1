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
fragments snapshot their op-logs and close their WALs. Cluster
membership, gossip, anti-entropy, the background loops (cache flush,
scrub, tiering, backup) and the observability subsystems wait for the
slices that port them.
"""

from __future__ import annotations

import threading

from ..device import resolve_device
from ..errors import PilosaError
from ..executor import Executor
from ..models.holder import Holder
from ..storage import wal as storage_wal
from ..utils import logger as logger_mod
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
                                     logger=self.logger)
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
