"""StatsD/DataDog stats backend.

Reference: datadog/datadog.go — a StatsClient speaking the dogstatsd wire
protocol over UDP (datadog.go:38-115). The datadog-go dependency is a thin
formatter around a UDP socket, so this module emits the protocol directly:

    metric.name:value|TYPE|@rate|#tag1:v1,tag2

Types: ``c`` count, ``g`` gauge, ``h`` histogram, ``s`` set, ``ms`` timing
(timings arrive in nanoseconds per the StatsClient contract and are sent
as milliseconds, matching datadog.go:105-113). ``with_tags`` children
accumulate tags hierarchically exactly like the reference's WithTags
(datadog.go:63-75). Sends are fire-and-forget UDP: a missing agent
costs nothing and drops silently, so the hot path never blocks.

Copy of the JAX package's ``utils/statsd.py``.
"""

from __future__ import annotations

import copy
import socket
from typing import Optional

from .stats import StatsClient

DEFAULT_ADDR = "127.0.0.1:8125"   # dogstatsd agent default (datadog.go:30)


class StatsDStatsClient(StatsClient):
    """dogstatsd-protocol emitter (datadog/datadog.go:38-115)."""

    def __init__(self, addr: str = DEFAULT_ADDR, prefix: str = "pilosa.",
                 tags: Optional[list[str]] = None, _sock=None):
        host, _, port = addr.rpartition(":")
        self._dest = (host or "127.0.0.1", int(port))
        self.prefix = prefix
        self.tags = list(tags or [])
        self._sock = _sock or socket.socket(socket.AF_INET,
                                            socket.SOCK_DGRAM)

    def with_tags(self, *tags: str) -> "StatsDStatsClient":
        child = copy.copy(self)   # children share the socket and dest
        child.tags = sorted(set(self.tags) | set(tags))
        return child

    # -- emitters -----------------------------------------------------------

    def count(self, name: str, value: int = 1) -> None:
        self._send(name, f"{value}|c")

    def gauge(self, name: str, value: float) -> None:
        self._send(name, f"{_num(value)}|g")

    def histogram(self, name: str, value: float) -> None:
        self._send(name, f"{_num(value)}|h")

    def set(self, name: str, value: str) -> None:
        self._send(name, f"{value}|s")

    def timing(self, name: str, value_ns: float) -> None:
        # StatsClient carries nanoseconds; dogstatsd timers take ms
        # (datadog.go:105-113 converts with time.Duration.Seconds()*1000).
        self._send(name, f"{_num(value_ns / 1e6)}|ms")

    def _send(self, name: str, payload: str) -> None:
        msg = f"{self.prefix}{name}:{payload}"
        if self.tags:
            msg += "|#" + ",".join(self.tags)
        try:
            self._sock.sendto(msg.encode(), self._dest)
        except OSError:
            pass   # agent down: drop, never block the caller

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _num(v: float) -> str:
    """Render floats compactly: integral values without the trailing .0."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))
