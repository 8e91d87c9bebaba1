"""Gossip membership backend: SWIM-lite memberlist equivalent.

Copy of the JAX package's ``cluster/gossip.py`` (reference
gossip/gossip.go), wire-compatible with it, so port nodes and JAX nodes
form one gossip cluster. ``GossipNodeSet`` is at once a NodeSet,
Broadcaster, BroadcastReceiver and memberlist.Delegate
(gossip.go:31-45): sync sends go direct-TCP to every member
(gossip.go:124-149), async sends ride a retransmit-limited gossip queue
(gossip.go:152-164), and full-state push/pull anti-entropy exchanges a
protobuf ``NodeStatus`` carrying schema + owned slices (gossip.go:193-222,
status built at server.go:306-323), encoded by ``proto.internal`` to the
JAX package's bytes.

hashicorp/memberlist is Go-only, so this module implements the same
behavior directly on sockets — a deliberately small SWIM variant:

- **UDP** carries probes (ping/ack), piggybacked membership updates
  (alive/dead rumors with incarnation numbers), and piggybacked broadcast
  envelopes with a retransmit budget of ``retransmit_mult*ceil(log2(n+1))``
  (memberlist's TransmitLimitedQueue policy).
- **TCP** carries sync broadcasts (one frame per connection) and the
  push/pull full state used for join and periodic anti-entropy. Every
  frame is a 4-byte big-endian length and a JSON body.
- Failure detection (full SWIM, memberlist semantics gossip.go:48-54):
  a member that misses ``suspect_after`` consecutive direct probes is
  probed INDIRECTLY through ``indirect_probes`` random relays (ping-req);
  only if no relay can reach it either is it marked *suspect* — a state
  gossiped like dead but reversible: the suspect hears the rumor and
  refutes with a higher incarnation within ``suspect_timeout``, or the
  window expires and the member is declared dead. An asymmetric or lossy
  direct path therefore cannot kill a node other peers still reach.
- Optional shared-key auth: with ``secret_key`` set, every UDP datagram
  and TCP frame carries an HMAC-SHA256 tag (with ``replay_window``, over
  a timestamp too); unauthenticated or tampered frames are dropped before
  parsing.

The push/pull piggybacks, both sent and applied as the JAX gossip
does: ``resize_state`` (the handler's ``resize_wire_state``: the
placement epoch and the in-flight and last settled resize, so a node
that missed a resize control send converges) and ``build_state`` (the
handler's ``build_wire_state``, each node's build identity).

Membership is a host-side concern; the device holds only bitmap data.
"""

from __future__ import annotations

import base64
import hmac as hmac_mod
import hashlib
import json
import math
import random
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..fault import failpoints as _fp
from ..proto import internal as pb
from ..utils import logger as logger_mod
from .broadcast import marshal_message, unmarshal_message
from .topology import Node

DEFAULT_GOSSIP_PORT = 14000      # reference internal/gossip port default

STATE_ALIVE = "alive"
STATE_SUSPECT = "suspect"
STATE_DEAD = "dead"

# Merge precedence at equal incarnation (memberlist: dead beats suspect
# beats alive; an alive claim only un-suspects with a HIGHER incarnation).
_STATE_RANK = {STATE_ALIVE: 0, STATE_SUSPECT: 1, STATE_DEAD: 2}

_HMAC_TAG = b"PGS1"     # sealed-frame magic
_HMAC_TS_TAG = b"PGS2"  # sealed frame with replay-bound timestamp
_HMAC_LEN = 32


@dataclass
class Member:
    name: str                    # cluster identity: the node's HTTP host
    addr: str                    # gossip "host:port"
    incarnation: int = 0
    state: str = STATE_ALIVE
    fails: int = field(default=0, compare=False)
    suspect_at: float = field(default=0.0, compare=False)

    def to_wire(self) -> dict:
        return {"name": self.name, "addr": self.addr,
                "inc": self.incarnation, "state": self.state}

    @classmethod
    def from_wire(cls, d: dict) -> "Member":
        return cls(d["name"], d["addr"], int(d["inc"]), d["state"])


def _split_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "localhost", int(port)


def _recv_frame(sock: socket.socket) -> bytes:
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("short frame header")
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(min(65536, n - len(buf)))
        if not chunk:
            raise ConnectionError("short frame body")
        buf += chunk
    return buf


def _send_frame(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack(">I", len(data)) + data)


class GossipNodeSet:
    """NodeSet + Broadcaster + BroadcastReceiver over SWIM-lite gossip.

    Mirrors gossip.go:31-243. ``host`` is the node's HTTP host (its
    cluster identity, like memberlist's node Name); ``gossip_host`` is the
    UDP/TCP bind for the membership protocol; ``seeds`` are peers'
    gossip addresses contacted on open (gossip.go:63-86 join).
    """

    def __init__(self, host: str, gossip_host: str = "",
                 seeds: Optional[list[str]] = None,
                 probe_interval: float = 1.0, probe_timeout: float = 0.5,
                 push_pull_interval: float = 15.0, suspect_after: int = 3,
                 retransmit_mult: int = 3, indirect_probes: int = 3,
                 suspect_timeout: Optional[float] = None,
                 secret_key: Optional[bytes] = None,
                 replay_window: Optional[float] = None,
                 logger=logger_mod.NOP):
        self.host = host
        self.logger = logger
        self.gossip_host = gossip_host or f"localhost:{DEFAULT_GOSSIP_PORT}"
        self.seeds = list(seeds or [])
        self.probe_interval = probe_interval
        self.probe_timeout = probe_timeout
        self.push_pull_interval = push_pull_interval
        self.suspect_after = suspect_after
        self.retransmit_mult = retransmit_mult
        self.indirect_probes = indirect_probes
        # Refutation window before a suspect is declared dead. None =
        # auto-scale with cluster size, memberlist's SuspicionMult
        # policy: bigger clusters need more protocol periods for the
        # rumor to reach the suspect and the refutation to travel back
        # (a fixed 4-period window makes refutation a no-op under loss
        # in clusters of more than 4 nodes).
        self.suspect_timeout = suspect_timeout
        if isinstance(secret_key, str):
            secret_key = secret_key.encode()
        # NOTE (replay): the HMAC tag authenticates frame CONTENTS only.
        # Without ``replay_window``, a captured frame (an old suspect
        # rumor, a stale push/pull) can be replayed verbatim by an
        # on-path attacker; incarnation rules bound the resulting churn
        # but do not eliminate it. Set ``replay_window`` (seconds) to
        # bind a timestamp under the MAC and reject frames older than
        # the window — requires member clocks within the window of each
        # other, which is why it is opt-in.
        self.secret_key = secret_key
        self.replay_window = replay_window
        # Test hook: loss_filter(dest_addr, pkt) -> True drops the
        # datagram (deterministic loss/asymmetry injection; UDP loss on
        # send is indistinguishable from loss on the wire).
        self.loss_filter = None
        # Fault-subsystem hook: on_state_change(member_name, state)
        # fires on every membership transition (joined/alive/suspect/
        # dead) so the server can fold gossip liveness into per-peer
        # health and open a dead peer's circuit breaker BEFORE any
        # query pays a timeout against it. Exceptions are swallowed —
        # an observer must never break the membership protocol.
        self.on_state_change = None

        self._handler = None          # server: BroadcastHandler+StatusHandler
        self._mu = threading.Lock()
        self._members: dict[str, Member] = {}   # keyed by name
        # Gossip queue entries: [msg-id, b64-envelope, remaining-transmits].
        self._queue: list[list] = []
        self._seen: dict[str, None] = {}  # bounded FIFO of delivered ids
        self._bcast_n = 0
        self._seq = 0
        self._acks: dict[int, threading.Event] = {}
        # ping-req relays in flight: our relay seq -> (origin addr, origin seq)
        self._relays: dict[int, tuple[str, int]] = {}
        self._udp: Optional[socket.socket] = None
        self._tcp: Optional[socket.socket] = None
        # Stall-watchdog signal (obs.watchdog "gossip_silence"): when
        # the membership layer last RECEIVED anything (UDP absorb or a
        # TCP push/pull). 0.0 until open(); single-member clusters
        # report no age (silence is not observable — nothing should be
        # talking).
        self._last_recv = 0.0
        self._send_pool = None          # lazy bounded sync-send pool
        self._send_pool_mu = threading.Lock()
        self._closing = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- BroadcastReceiver (broadcast.go:100-107) ----------------------------

    def start(self, handler) -> None:
        """Attach the server (BroadcastHandler + StatusHandler)."""
        self._handler = handler

    # -- NodeSet (broadcast.go:26-33) ----------------------------------------

    def open(self) -> None:
        bind_host, port = _split_addr(self.gossip_host)
        if port == 0:
            # ":0" support — pick a port the kernel grants in BOTH spaces
            # (a free UDP port may be TCP-taken; retry on EADDRINUSE).
            for _ in range(16):
                udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                udp.bind((bind_host, 0))
                actual = udp.getsockname()[1]
                tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                try:
                    tcp.bind((bind_host, actual))
                except OSError:
                    udp.close()
                    tcp.close()
                    continue
                self._udp, self._tcp, port = udp, tcp, actual
                break
            else:
                raise OSError("no port bindable for both UDP and TCP")
        else:
            self._udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._udp.bind((bind_host, port))
            self._tcp = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._tcp.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._tcp.bind((bind_host, port))
        self._tcp.listen(16)
        # Advertise a peer-reachable address: a wildcard bind is useless
        # to remote nodes, so fall back to this host's primary IP.
        adv_host = bind_host
        if adv_host in ("", "0.0.0.0", "::"):
            adv_host = _primary_ip()
        self.gossip_host = f"{adv_host}:{port}"
        self.logger.printf("gossip: listening on %s (node %s)",
                           self.gossip_host, self.host)
        with self._mu:
            self._members[self.host] = Member(self.host, self.gossip_host)

        for name, target in (("udp", self._udp_loop),
                             ("tcp", self._tcp_loop),
                             ("probe", self._probe_loop),
                             ("pushpull", self._push_pull_loop)):
            t = threading.Thread(target=target, name=f"gossip-{name}",
                                 daemon=True)
            t.start()
            self._threads.append(t)

        for seed in self.seeds:
            if seed and seed != self.gossip_host:
                try:
                    self._push_pull(seed)
                except OSError:
                    pass  # seed down; periodic push/pull will retry

    def close(self) -> None:
        self._closing.set()
        with self._send_pool_mu:
            pool, self._send_pool = self._send_pool, None
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        for s in (self._udp, self._tcp):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    def nodes(self) -> list[Node]:
        # Suspect members are still cluster members (memberlist keeps
        # them in the node list until the refutation window confirms
        # death) — dropping them early would reshard slices on a blip.
        with self._mu:
            return [Node(m.name) for m in
                    sorted(self._members.values(), key=lambda m: m.name)
                    if m.state != STATE_DEAD]

    def join(self, nodes) -> None:  # parity with StaticNodeSet
        for n in nodes:
            addr = getattr(n, "internal_host", "") or ""
            if addr:
                try:
                    self._push_pull(addr)
                except OSError:
                    pass

    # -- Broadcaster (gossip.go:124-164) -------------------------------------

    # Concurrent sync-broadcast legs (the reference's errgroup fan-out,
    # gossip.go:124-149, is similarly unbounded, but a thread per peer
    # per message does not survive n=50 clusters under write load).
    _SEND_SYNC_WORKERS = 16

    def send_sync(self, m) -> None:
        """Direct TCP frame to every alive member (gossip.go:124-149),
        fanned out over a bounded worker pool."""
        import concurrent.futures as futures
        from concurrent.futures import ThreadPoolExecutor
        data = marshal_message(m)
        peers = self._alive_peers()
        if not peers:
            return
        errs: list[Exception] = []

        def send(addr: str) -> None:
            try:
                self._tcp_request(addr, {"t": "bcast",
                                         "data": _b64(data)})
            except Exception as e:  # noqa: BLE001 - collected below
                errs.append(e)

        with self._send_pool_mu:
            if self._closing.is_set():
                return  # close() owns the pool; don't resurrect it
            pool = self._send_pool
            if pool is None:
                pool = self._send_pool = ThreadPoolExecutor(
                    max_workers=self._SEND_SYNC_WORKERS,
                    thread_name_prefix="gossip-send")
        try:
            list(pool.map(send, [mem.addr for mem in peers]))
        except futures.CancelledError:
            return  # close() cancelled the fan-out mid-flight
        except RuntimeError:
            # close() shut the pool down between our _send_pool_mu check
            # and pool.map scheduling ("cannot schedule new futures after
            # shutdown"); during shutdown this is benign, same as a cancel.
            if self._closing.is_set():
                return
            raise
        if errs:
            raise errs[0]

    def send_async(self, m) -> None:
        """Queue for piggybacked gossip (TransmitLimitedQueue,
        gossip.go:152-164)."""
        data = marshal_message(m)
        with self._mu:
            self._bcast_n += 1
            msg_id = f"{self.host}#{self._bcast_n}"
            n = max(1, len(self._members))
            budget = self.retransmit_mult * max(
                1, math.ceil(math.log2(n + 1)))
            self._queue.append([msg_id, _b64(data), budget])
            self._mark_seen(msg_id)  # don't deliver our own rumor locally

    # -- membership internals ------------------------------------------------

    def _alive_peers(self) -> list[Member]:
        """Broadcast/gossip fan-out targets: every non-dead peer
        (suspects still receive traffic — they are probably alive)."""
        with self._mu:
            return [m for m in self._members.values()
                    if m.state != STATE_DEAD and m.name != self.host]

    def _merge_member(self, w: Member) -> None:
        """SWIM merge rule: higher incarnation wins; on a tie, dead beats
        alive. A dead rumor about *ourselves* is refuted by re-announcing
        alive with a bumped incarnation."""
        deliver_update = False
        log_line = None
        with self._mu:
            cur = self._members.get(w.name)
            if w.name == self.host:
                # Refute ANY non-alive rumor about ourselves (suspect or
                # dead) with a bumped incarnation — the SWIM refutation
                # that closes a suspect's window (gossip.go:48-54).
                me = self._members[self.host]
                if (w.state in (STATE_DEAD, STATE_SUSPECT)
                        and w.incarnation >= me.incarnation):
                    me.incarnation = w.incarnation + 1
                    deliver_update = True
                    log_line = (f"gossip: refuting {w.state} rumor about"
                                f" self (inc={me.incarnation})")
            elif cur is None:
                self._members[w.name] = m = Member(w.name, w.addr,
                                                   w.incarnation, w.state)
                if m.state == STATE_SUSPECT:
                    m.suspect_at = time.monotonic()
                deliver_update = True
                log_line = (f"gossip: member joined: {w.name} ({w.addr})"
                            f" state={w.state}")
            elif (w.incarnation > cur.incarnation
                  or (w.incarnation == cur.incarnation
                      and _STATE_RANK[w.state]
                      > _STATE_RANK[cur.state])):
                # dead > suspect > alive at equal incarnation; an alive
                # claim needs a HIGHER incarnation to clear suspicion.
                if cur.state != w.state:
                    log_line = (f"gossip: member {w.name} {cur.state}"
                                f" -> {w.state} (inc={w.incarnation})")
                if w.state == STATE_SUSPECT and cur.state != STATE_SUSPECT:
                    cur.suspect_at = time.monotonic()
                cur.incarnation = w.incarnation
                cur.state = w.state
                cur.addr = w.addr
                cur.fails = 0
                deliver_update = True
        if log_line:
            self.logger.printf("%s", log_line)
        if deliver_update:
            if w.name != self.host:
                self._notify_state(w.name)
            self._gossip_update(self._member_snapshot(w.name))

    def _notify_state(self, name: str) -> None:
        cb = self.on_state_change
        if cb is None:
            return
        with self._mu:
            m = self._members.get(name)
            state = m.state if m is not None else STATE_DEAD
        try:
            cb(name, state)
        except Exception:  # noqa: BLE001 - observers must not break SWIM
            pass

    def _member_snapshot(self, name: str) -> Member:
        with self._mu:
            m = self._members[name]
            return Member(m.name, m.addr, m.incarnation, m.state)

    def _gossip_update(self, m: Member) -> None:
        """Spread a membership rumor to a few random peers immediately.

        One-shot sends can die out under loss, but state rumors are NOT
        fire-and-forget overall: every probe/ack/push-pull piggybacks
        the full membership table (_packet), and every state-CHANGING
        merge re-triggers this spread — memberlist's retransmit-queue
        effect without a second queue. A non-alive rumor is ALSO sent
        straight to its subject, so the suspect learns of its suspicion
        in one hop and can refute within the window."""
        pkt = self._packet("update", updates=[m.to_wire()])
        peers = self._alive_peers()
        for peer in random.sample(peers, min(3, len(peers))):
            self._udp_send(peer.addr, pkt)
        if m.state != STATE_ALIVE and m.name != self.host:
            self._udp_send(m.addr, pkt)

    # -- frame auth ----------------------------------------------------------

    def _seal(self, payload: bytes) -> bytes:
        """Tag a frame with HMAC-SHA256 when a secret key is set. With
        ``replay_window`` enabled, an 8-byte wall-clock timestamp is
        bound under the MAC so stale captures can be rejected (see the
        replay NOTE in __init__)."""
        if self.secret_key is None:
            return payload
        if self.replay_window is not None:
            ts = struct.pack(">d", time.time())
            body = ts + payload
            mac = hmac_mod.new(self.secret_key, body,
                               hashlib.sha256).digest()
            return _HMAC_TS_TAG + mac + body
        mac = hmac_mod.new(self.secret_key, payload,
                           hashlib.sha256).digest()
        return _HMAC_TAG + mac + payload

    def _open_sealed(self, data: bytes) -> Optional[bytes]:
        """Verify + strip the HMAC tag; None = drop the frame. With a
        key configured, untagged or bad-MAC frames never reach the
        parser: a spoofed datagram cannot poison the view."""
        if self.secret_key is None:
            return data
        if self.replay_window is not None:
            if (len(data) < len(_HMAC_TS_TAG) + _HMAC_LEN + 8
                    or not data.startswith(_HMAC_TS_TAG)):
                return None
            mac = data[len(_HMAC_TS_TAG):len(_HMAC_TS_TAG) + _HMAC_LEN]
            body = data[len(_HMAC_TS_TAG) + _HMAC_LEN:]
            want = hmac_mod.new(self.secret_key, body,
                                hashlib.sha256).digest()
            if not hmac_mod.compare_digest(mac, want):
                return None
            (ts,) = struct.unpack(">d", body[:8])
            if abs(time.time() - ts) > self.replay_window:
                return None  # stale capture (or clocks beyond window)
            return body[8:]
        if (len(data) < len(_HMAC_TAG) + _HMAC_LEN
                or not data.startswith(_HMAC_TAG)):
            return None
        mac = data[len(_HMAC_TAG):len(_HMAC_TAG) + _HMAC_LEN]
        payload = data[len(_HMAC_TAG) + _HMAC_LEN:]
        want = hmac_mod.new(self.secret_key, payload,
                            hashlib.sha256).digest()
        if not hmac_mod.compare_digest(mac, want):
            return None
        return payload

    # -- packet plumbing -----------------------------------------------------

    def _mark_seen(self, msg_id: str) -> None:
        """Bounded FIFO dedup of delivered gossip message ids (must hold
        self._mu)."""
        self._seen[msg_id] = None
        while len(self._seen) > 4096:
            self._seen.pop(next(iter(self._seen)))

    def _packet(self, typ: str, **kw) -> dict:
        """Every UDP packet piggybacks membership + queued broadcasts."""
        with self._mu:
            updates = [m.to_wire() for m in self._members.values()]
            bcasts = []
            for entry in self._queue:
                bcasts.append({"id": entry[0], "data": entry[1]})
                entry[2] -= 1
            self._queue = [e for e in self._queue if e[2] > 0]
        return {"t": typ, "from": self.host,
                "updates": updates, "bcasts": bcasts, **kw}

    def _udp_send(self, addr: str, pkt: dict) -> None:
        if self.loss_filter is not None and self.loss_filter(addr, pkt):
            return  # injected datagram loss (tests)
        try:
            self._udp.sendto(self._seal(json.dumps(pkt).encode()),
                             _split_addr(addr))
        except OSError:
            pass

    def _udp_loop(self) -> None:
        while not self._closing.is_set():
            try:
                buf, src = self._udp.recvfrom(65536)
            except OSError:
                return
            try:
                buf = self._open_sealed(buf)
                if buf is None:
                    continue  # unauthenticated/tampered: drop pre-parse
                pkt = json.loads(buf.decode())
                self._absorb(pkt)
                typ = pkt.get("t")
                if typ == "ping":
                    self._udp_send("%s:%d" % src,
                                   self._packet("ack", seq=pkt.get("seq", 0)))
                elif typ == "pingreq":
                    # Relay an indirect probe: ping the target with our
                    # own seq; the eventual ack maps back to the origin.
                    target = pkt.get("target", "")
                    origin = pkt.get("origin") or "%s:%d" % src
                    with self._mu:
                        self._seq += 1
                        relay_seq = self._seq
                        self._relays[relay_seq] = (origin,
                                                   int(pkt.get("seq", 0)))
                        while len(self._relays) > 1024:
                            self._relays.pop(next(iter(self._relays)))
                    self._udp_send(target,
                                   self._packet("ping", seq=relay_seq))
                elif typ == "ack":
                    seq = pkt.get("seq", -1)
                    ev = self._acks.get(seq)
                    if ev is not None:
                        ev.set()
                    relay = self._relays.pop(seq, None)
                    if relay is not None:  # forward to the ping-req origin
                        self._udp_send(relay[0],
                                       self._packet("ack", seq=relay[1]))
            except Exception:  # noqa: BLE001 - a bad packet must not kill IO
                continue

    def last_activity_age(self) -> Optional[float]:
        """Seconds since the last received membership traffic, or
        None when silence is not meaningful (not open yet, or no
        known peers to hear from)."""
        if self._last_recv == 0.0:
            return None
        with self._mu:
            peers = sum(1 for m in self._members.values()
                        if m.name != self.host)
        if peers == 0:
            return None
        return time.monotonic() - self._last_recv

    def _absorb(self, pkt: dict) -> None:
        self._last_recv = time.monotonic()
        for w in pkt.get("updates", []):
            try:
                self._merge_member(Member.from_wire(w))
            except (KeyError, ValueError):
                continue
        for b in pkt.get("bcasts", []):
            try:
                msg_id, data = b["id"], base64.b64decode(b["data"])
            except (KeyError, TypeError, ValueError):
                continue
            self._deliver_gossip(msg_id, data)

    def _deliver_gossip(self, msg_id: str, data: bytes) -> None:
        """Deliver a gossiped envelope once per message id, then keep the
        rumor spreading with a fresh retransmit budget."""
        with self._mu:
            if msg_id in self._seen:
                return
            self._mark_seen(msg_id)
            n = max(1, len(self._members))
            budget = self.retransmit_mult * max(
                1, math.ceil(math.log2(n + 1)))
            self._queue.append([msg_id, _b64(data), budget])
        self._handle_envelope(data)

    def _handle_envelope(self, data: bytes) -> None:
        if _fp.ACTIVE is not None:
            try:
                _fp.ACTIVE.hit("gossip.deliver")
            except _fp.FailpointError:
                return  # injected drop: the envelope is lost in transit
        if self._handler is not None:
            try:
                self._handler.receive_message(unmarshal_message(data))
            except Exception:  # noqa: BLE001 - bad envelope must not kill IO
                pass

    # -- TCP: sync bcast + push/pull (gossip.go:124-149,193-222) -------------

    def _tcp_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._tcp.accept()
            except OSError:
                return
            threading.Thread(target=self._tcp_serve, args=(conn,),
                             daemon=True).start()

    def _tcp_serve(self, conn: socket.socket) -> None:
        try:
            with conn:
                conn.settimeout(10.0)
                raw = self._open_sealed(_recv_frame(conn))
                if raw is None:
                    return  # unauthenticated frame: drop
                req = json.loads(raw.decode())
                if req.get("t") == "bcast":
                    # Sync sends are point-to-point: deliver directly,
                    # no gossip relay and no dedup (gossip.go:124-149).
                    self._handle_envelope(base64.b64decode(req["data"]))
                    _send_frame(conn, self._seal(b'{"t":"ok"}'))
                elif req.get("t") == "pushpull":
                    self._absorb_state(req)
                    _send_frame(conn, self._seal(
                        json.dumps(self._local_state()).encode()))
        except (OSError, ValueError, ConnectionError, KeyError):
            pass

    def _tcp_request(self, addr: str, req: dict,
                     timeout: float = 10.0) -> dict:
        with socket.create_connection(_split_addr(addr),
                                      timeout=timeout) as conn:
            _send_frame(conn, self._seal(json.dumps(req).encode()))
            raw = self._open_sealed(_recv_frame(conn))
            if raw is None:
                raise ConnectionError("unauthenticated gossip response")
            return json.loads(raw.decode())

    def _local_state(self) -> dict:
        """Full state for push/pull: membership + the protobuf
        ``NodeStatus`` (schema metas + owned slices) exactly as the
        reference's memberlist delegate marshals it (gossip.go:193-205
        LocalState; internal/private.proto:74-90). The protobuf rides
        base64 inside the JSON frame."""
        with self._mu:
            members = [m.to_wire() for m in self._members.values()]
        status_b64 = None
        if self._handler is not None and hasattr(self._handler,
                                                 "local_status"):
            try:
                status = self._handler.local_status()  # pb.NodeStatus
                status_b64 = _b64(status.SerializeToString())
            except Exception as e:  # noqa: BLE001 - status is best-effort
                self.logger.printf("gossip: error getting local state:"
                                   " %s", e)
        out = {"t": "pushpull", "members": members,
               "status_pb": status_b64}
        # Elastic-resize convergence (cluster.resize): the placement
        # epoch + in-flight/last-settled resize ride the push/pull, so
        # a node that missed the coordinator's control sends
        # (partitioned, restarted) converges within one exchange.
        if self._handler is not None and hasattr(
                self._handler, "resize_wire_state"):
            try:
                out["resize_state"] = self._handler.resize_wire_state()
            except Exception:  # noqa: BLE001 - piggyback best-effort
                pass
        # Build identity (obs.runtime.build_info): rides every
        # push/pull so version skew across a mixed-version fleet is
        # visible from any member during a rolling restart
        # (/debug/cluster's gossipBuilds block).
        if self._handler is not None and hasattr(
                self._handler, "build_wire_state"):
            try:
                out["build_state"] = self._handler.build_wire_state()
            except Exception:  # noqa: BLE001 - piggyback best-effort
                pass
        return out

    def _absorb_state(self, state: dict) -> None:
        """MergeRemoteState (gossip.go:208-222)."""
        self._last_recv = time.monotonic()
        for w in state.get("members", []):
            try:
                self._merge_member(Member.from_wire(w))
            except (KeyError, ValueError):
                continue
        rz = state.get("resize_state")
        if rz and self._handler is not None and hasattr(
                self._handler, "apply_resize_wire_state"):
            try:
                self._handler.apply_resize_wire_state(rz)
            except Exception as e:  # noqa: BLE001 - merge best-effort
                self.logger.printf("gossip: resize merge error: %s", e)
        bd = state.get("build_state")
        if bd and self._handler is not None and hasattr(
                self._handler, "apply_build_wire_state"):
            try:
                self._handler.apply_build_wire_state(bd)
            except Exception:  # noqa: BLE001 - piggyback best-effort
                pass
        status_b64 = state.get("status_pb")
        if status_b64 and self._handler is not None and hasattr(
                self._handler, "handle_remote_status"):
            try:
                ns = pb.NodeStatus.FromString(
                    base64.b64decode(status_b64))
                self._handler.handle_remote_status(ns)
            except Exception as e:  # noqa: BLE001 - merge is best-effort
                self.logger.printf("gossip: merge state error: %s", e)

    def _push_pull(self, addr: str) -> None:
        resp = self._tcp_request(addr, self._local_state())
        self._absorb_state(resp)

    def _push_pull_loop(self) -> None:
        while not self._closing.wait(self.push_pull_interval):
            peers = self._alive_peers()
            if not peers:
                continue
            try:
                self._push_pull(random.choice(peers).addr)
            except OSError:
                pass

    # -- failure detection (SWIM probe) --------------------------------------

    def _probe_loop(self) -> None:
        while not self._closing.wait(self.probe_interval):
            self._expire_suspects()
            peers = self._probe_targets()
            if not peers:
                continue
            self._probe(random.choice(peers))

    def _probe_targets(self) -> list[Member]:
        with self._mu:
            return [m for m in self._members.values()
                    if m.state in (STATE_ALIVE, STATE_SUSPECT)
                    and m.name != self.host]

    def _ping(self, addr: str) -> bool:
        """One direct ping/ack round trip."""
        with self._mu:
            self._seq += 1
            seq = self._seq
            ev = self._acks[seq] = threading.Event()
        self._udp_send(addr, self._packet("ping", seq=seq))
        ok = ev.wait(self.probe_timeout)
        self._acks.pop(seq, None)
        return ok

    def _ping_indirect(self, peer: Member) -> bool:
        """SWIM ping-req: ask k random other peers to probe ``peer``
        and relay the ack — a lossy/asymmetric direct path must not
        condemn a node the rest of the cluster reaches fine
        (memberlist's IndirectChecks, gossip.go:48-54)."""
        relays = [m for m in self._probe_targets()
                  if m.name != peer.name and m.state == STATE_ALIVE]
        if not relays or self.indirect_probes <= 0:
            return False
        relays = random.sample(relays,
                               min(self.indirect_probes, len(relays)))
        with self._mu:
            self._seq += 1
            seq = self._seq
            ev = self._acks[seq] = threading.Event()
        pkt = self._packet("pingreq", seq=seq, target=peer.addr,
                           origin=self.gossip_host)
        for r in relays:
            self._udp_send(r.addr, pkt)
        # Relays each pay one probe_timeout; allow one extra hop's worth.
        ok = ev.wait(2.0 * self.probe_timeout)
        self._acks.pop(seq, None)
        return ok

    def _probe(self, peer: Member) -> None:
        ok = self._ping(peer.addr)
        if not ok:
            ok = self._ping_indirect(peer)
        suspect = None
        with self._mu:
            cur = self._members.get(peer.name)
            if cur is None or cur.state == STATE_DEAD:
                return
            if ok:
                cur.fails = 0
                return
            cur.fails += 1
            if (cur.state == STATE_ALIVE
                    and cur.fails >= self.suspect_after):
                cur.state = STATE_SUSPECT
                cur.suspect_at = time.monotonic()
                suspect = Member(cur.name, cur.addr, cur.incarnation,
                                 STATE_SUSPECT)
        if suspect is not None:
            self.logger.printf(
                "gossip: node %s missed %d direct+indirect probes,"
                " marking suspect", suspect.name, self.suspect_after)
            self._notify_state(suspect.name)
            self._gossip_update(suspect)

    def _suspect_window(self, n_members: int) -> float:
        """Seconds a suspect has to refute. Explicit override wins;
        otherwise memberlist's SuspicionMult shape — protocol periods
        scaled by log(cluster size), so the rumor can reach the suspect
        and the refutation can travel back even with loss."""
        if self.suspect_timeout is not None:
            return self.suspect_timeout
        return 4.0 * self.probe_interval * max(
            1.0, math.log2(n_members + 1))

    def _expire_suspects(self) -> None:
        """Suspects whose refutation window lapsed are declared dead."""
        now = time.monotonic()
        dead = []
        with self._mu:
            window = self._suspect_window(len(self._members))
            for m in self._members.values():
                if (m.state == STATE_SUSPECT
                        and now - m.suspect_at > window):
                    m.state = STATE_DEAD
                    dead.append(Member(m.name, m.addr, m.incarnation,
                                       STATE_DEAD))
        for d in dead:
            self.logger.printf(
                "gossip: suspect %s not refuted in %.1fs, declaring"
                " dead", d.name, window)
            self._notify_state(d.name)
            self._gossip_update(d)


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode()


def _primary_ip() -> str:
    """Best-effort primary interface IP for advertising a wildcard bind.
    The connect() on a UDP socket sends no packets; it only resolves the
    route."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
    except OSError:
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"
