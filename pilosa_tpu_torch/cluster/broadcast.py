"""Broadcast: cluster membership + schema-mutation messaging.

Copy of the JAX package's ``cluster/broadcast.py`` (reference
broadcast.go + httpbroadcast/messenger.go). The control plane carries
the reference's five message kinds (create-slice/index/frame,
delete-index/frame) plus the query-cancel and resize control messages
as a 1-byte type tag + body envelope (broadcast.go:109-166), byte for
byte the JAX package's, so a JAX node and a port node read each other's
messages.
Backends: ``static`` (fixed node list, no messaging) and ``http``
(direct POST of the envelope to each peer's ``/messages``). The data
plane (queries, imports, block sync) never rides this channel — it is
protobuf-over-HTTP via cluster.client.
"""

from __future__ import annotations

import threading
import urllib.request
from typing import Optional

from ..proto import internal as pb
from .topology import Node

MESSAGE_TYPE_CREATE_SLICE = 1
MESSAGE_TYPE_CREATE_INDEX = 2
MESSAGE_TYPE_DELETE_INDEX = 3
MESSAGE_TYPE_CREATE_FRAME = 4
MESSAGE_TYPE_DELETE_FRAME = 5
MESSAGE_TYPE_CANCEL_QUERY = 6
MESSAGE_TYPE_RESIZE = 7


class CancelQueryMessage:
    """Cluster-wide query cancellation (sched subsystem): the envelope
    body is the raw query id, so this rides the same 1-byte-tag wire
    format as the protobuf control messages without a schema change —
    it duck-types the SerializeToString/FromString pair
    marshal/unmarshal use."""

    __slots__ = ("id",)

    def __init__(self, id: str = ""):
        self.id = id

    def SerializeToString(self) -> bytes:  # noqa: N802 - protobuf parity
        return self.id.encode()

    @classmethod
    def FromString(cls, raw: bytes) -> "CancelQueryMessage":  # noqa: N802
        return cls(raw.decode())

    def __repr__(self) -> str:
        return f"CancelQueryMessage(id={self.id!r})"


class ResizeMessage:
    """Elastic-resize control message (cluster.resize;
    docs/CLUSTER_RESIZE.md): one wire form for every phase of the
    protocol — ``prepare`` installs the in-flight state (union writes,
    read fencing), ``flip`` switches placement epoch-atomically,
    ``finalize`` drops the union, ``abort`` backs out to the old
    epoch. The body is compact JSON riding the same 1-byte-tag
    envelope as the protobuf control messages (the CancelQueryMessage
    duck-typing pattern), so it travels over every broadcaster backend
    (static direct-POST, http, gossip) unchanged. The coordinator
    sends phases as DIRECT per-node POSTs of this envelope to
    ``/messages`` (each node's 200 is its ack) and re-broadcasts them
    async over gossip for stragglers."""

    __slots__ = ("id", "phase", "epoch", "old_hosts", "new_hosts",
                 "coordinator")

    def __init__(self, id: str = "", phase: str = "", epoch: int = 0,
                 old_hosts=None, new_hosts=None, coordinator: str = ""):
        self.id = id
        self.phase = phase            # prepare | flip | finalize | abort
        self.epoch = epoch            # the epoch the resize starts FROM
        self.old_hosts = list(old_hosts or [])
        self.new_hosts = list(new_hosts or [])
        self.coordinator = coordinator

    def SerializeToString(self) -> bytes:  # noqa: N802 - protobuf parity
        import json
        return json.dumps(
            {"id": self.id, "phase": self.phase, "epoch": self.epoch,
             "old": self.old_hosts, "new": self.new_hosts,
             "coordinator": self.coordinator},
            separators=(",", ":")).encode()

    @classmethod
    def FromString(cls, raw: bytes) -> "ResizeMessage":  # noqa: N802
        import json
        d = json.loads(raw.decode())
        return cls(id=str(d.get("id", "")),
                   phase=str(d.get("phase", "")),
                   epoch=int(d.get("epoch", 0)),
                   old_hosts=d.get("old") or [],
                   new_hosts=d.get("new") or [],
                   coordinator=str(d.get("coordinator", "")))

    def __repr__(self) -> str:
        return (f"ResizeMessage(id={self.id!r}, phase={self.phase!r},"
                f" epoch={self.epoch}, old={self.old_hosts},"
                f" new={self.new_hosts})")


_TYPE_BY_CLASS = {
    pb.CreateSliceMessage: MESSAGE_TYPE_CREATE_SLICE,
    pb.CreateIndexMessage: MESSAGE_TYPE_CREATE_INDEX,
    pb.DeleteIndexMessage: MESSAGE_TYPE_DELETE_INDEX,
    pb.CreateFrameMessage: MESSAGE_TYPE_CREATE_FRAME,
    pb.DeleteFrameMessage: MESSAGE_TYPE_DELETE_FRAME,
    CancelQueryMessage: MESSAGE_TYPE_CANCEL_QUERY,
    ResizeMessage: MESSAGE_TYPE_RESIZE,
}
_CLASS_BY_TYPE = {v: k for k, v in _TYPE_BY_CLASS.items()}


def marshal_message(m) -> bytes:
    """1-byte type tag + protobuf body (broadcast.go:118-139)."""
    typ = _TYPE_BY_CLASS.get(type(m))
    if typ is None:
        raise ValueError(f"message type not implemented: {type(m)}")
    return bytes([typ]) + m.SerializeToString()


def unmarshal_message(buf: bytes):
    cls = _CLASS_BY_TYPE.get(buf[0])
    if cls is None:
        raise ValueError(f"invalid message type: {buf[0]}")
    return cls.FromString(buf[1:])


class NopBroadcaster:
    """Default no-op broadcaster (broadcast.go:60-74)."""

    def send_sync(self, m) -> None:
        pass

    send_async = send_sync


NOP_BROADCASTER = NopBroadcaster()


class StaticNodeSet:
    """Fixed-membership NodeSet for single node / tests
    (broadcast.go:35-58)."""

    def __init__(self, nodes: Optional[list[Node]] = None):
        self._nodes = list(nodes or [])

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def nodes(self) -> list[Node]:
        return list(self._nodes)

    def join(self, nodes: list[Node]) -> None:
        self._nodes = list(nodes)


class HTTPBroadcaster:
    """POST the type-tagged envelope to every peer's internal host
    (httpbroadcast/messenger.go:43-121)."""

    def __init__(self, server, timeout: float = 5.0):
        # ``server`` supplies local host + cluster (server.py); matching
        # the reference, sends exclude the local node.
        self.server = server
        self.timeout = timeout

    def _peers(self) -> list[Node]:
        return [n for n in self.server.cluster.nodes
                if n.host != self.server.host]

    def send_sync(self, m) -> None:
        data = marshal_message(m)
        errs = []
        threads = []

        def post(node):
            try:
                host = node.internal_host or node.host
                req = urllib.request.Request(
                    f"http://{host}/messages", data=data, method="POST",
                    headers={"Content-Type": "application/x-protobuf"})
                urllib.request.urlopen(req, timeout=self.timeout).read()
            except Exception as e:  # noqa: BLE001 - collected below
                errs.append(e)

        for node in self._peers():
            t = threading.Thread(target=post, args=(node,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errs:
            raise errs[0]

    def send_async(self, m) -> None:
        # Best-effort fire-and-forget on a thread.
        threading.Thread(target=lambda: self._send_quiet(m),
                         daemon=True).start()

    def _send_quiet(self, m) -> None:
        try:
            self.send_sync(m)
        except Exception:  # noqa: BLE001 - async sends are best-effort
            pass
