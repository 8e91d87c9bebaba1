"""Cluster topology: nodes, partitioning, and fragment placement.

Copy of the JAX package's ``cluster/topology.py`` (reference
cluster.go). A slice maps to one of PARTITION_N partitions via FNV-1a of
(index name, big-endian slice id) (cluster.go:198-207); a partition maps
to its primary owner via jump consistent hash, and to REPLICA_N
consecutive ring successors (cluster.go:220-240). The placement is pure
and deterministic — every node computes the same owner set with no
coordination — and bit for bit the JAX package's, so a port node and a
JAX node agree on every slice's owners.

Elastic resize (docs/CLUSTER_RESIZE.md): placement is versioned by an
integer **epoch**; an in-flight resize installs a ``ResizeState`` that
makes ownership math epoch-aware in three regimes:

- ``migrating`` (pre-flip): the CURRENT (old) placement is the read
  authority; writes fan to the union of old and new owners of every
  moving partition, so the target copies stay write-synchronized while
  the streamer backfills their base data.
- ``draining`` (post-flip): ``nodes``/``epoch`` have switched to the
  target membership in one atomic step; reads route by the new
  placement (old owners stay read-valid — everyone still union-writes
  until finalize); writes keep fanning to the union so a node that has
  not yet processed the flip cannot strand a write.
- finalized: resize state clears; for a short grace window the
  previous epoch's owners keep ACCEPTING writes (never serving reads)
  so straggler coordinators' union-writes don't bounce.

The movement set is computable from the jump-hash delta alone
(``movement()``): growing n→n+1 relocates ~1/(n+1) of partitions and
never moves one between two surviving old owners.
"""

from __future__ import annotations

import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

DEFAULT_PARTITION_N = 16
DEFAULT_REPLICA_N = 1

NODE_STATE_UP = "UP"
NODE_STATE_DOWN = "DOWN"

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_U64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_64(data: bytes) -> int:
    h = _FNV_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV_PRIME) & _U64
    return h


def jump_hash(key: int, n: int) -> int:
    """Jump consistent hash: key → bucket in [0, n)
    (cluster.go:266-277, Lamping & Veach)."""
    b, j = -1, 0
    key &= _U64
    while j < n:
        b = j
        key = (key * 2862933555777941757 + 1) & _U64
        j = int(float(b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b


@dataclass
class Node:
    """One cluster member (cluster.go:39-56)."""
    host: str
    internal_host: str = ""
    state: str = NODE_STATE_UP
    # Last pb.NodeStatus received from this node (schema + owned slices),
    # set by the status merge like the reference's Node.SetStatus
    # (cluster.go:58-76).
    status: Optional[object] = field(default=None, compare=False,
                                     repr=False)

    def set_state(self, s: str) -> None:
        self.state = s

    def set_status(self, ns) -> None:
        self.status = ns


def filter_host(nodes: list[Node], host: str) -> list[Node]:
    return [n for n in nodes if n.host != host]


def hosts_of(nodes: list[Node]) -> list[str]:
    return [n.host for n in nodes]


# -- elastic resize: movement-set math + in-flight state ----------------------

RESIZE_MIGRATING = "migrating"   # pre-flip: old placement authoritative
RESIZE_DRAINING = "draining"     # post-flip: new placement authoritative


def owner_hosts(hosts: list[str], partition_id: int, replica_n: int,
                hasher=None) -> tuple[str, ...]:
    """The owner host tuple for one partition over an explicit host
    list — the pure function both epochs' placement reduces to, so the
    movement set is computable without a Cluster instance."""
    if not hosts:
        return ()
    replica_n = min(replica_n, len(hosts)) or 1
    h = (hasher or jump_hash)(partition_id, len(hosts))
    return tuple(hosts[(h + k) % len(hosts)] for k in range(replica_n))


def movement(old_hosts: list[str], new_hosts: list[str],
             partition_n: int, replica_n: int,
             hasher=None) -> dict[int, tuple[tuple, tuple]]:
    """``{partition: (old_owner_hosts, new_owner_hosts)}`` for every
    partition whose owner SET changes between the two memberships —
    the minimal movement set the jump-hash delta gives us. Growing
    n→n+1 (host appended) relocates ~1/(n+1) of partitions, and a
    moved partition's PRIMARY either stays put or becomes the added
    host — jump hash never reassigns a primary between surviving
    buckets (Lamping & Veach). With replica_n>1 the successor ring can
    additionally shift a replica, which the owner-SET comparison here
    deliberately catches: those copies need streaming too."""
    out: dict[int, tuple[tuple, tuple]] = {}
    for p in range(partition_n):
        old = owner_hosts(old_hosts, p, replica_n, hasher)
        new = owner_hosts(new_hosts, p, replica_n, hasher)
        if set(old) != set(new):
            out[p] = (old, new)
    return out


class ResizeState:
    """One in-flight resize as every node tracks it. Built by
    ``Cluster.install_resize`` (the prepare broadcast) and mutated only
    under the cluster lock; readers see a consistent snapshot because
    the phase moves monotonically migrating → draining and the node
    lists are immutable once built."""

    __slots__ = ("id", "phase", "epoch_from", "old_hosts", "new_hosts",
                 "target_nodes", "old_nodes", "moving", "_extra",
                 "started_mono")

    def __init__(self, resize_id: str, epoch_from: int,
                 old_hosts: list[str], new_hosts: list[str],
                 target_nodes: list[Node], old_nodes: list[Node],
                 moving: dict[int, tuple[tuple, tuple]]):
        self.id = resize_id
        self.phase = RESIZE_MIGRATING
        self.epoch_from = epoch_from
        self.old_hosts = list(old_hosts)
        self.new_hosts = list(new_hosts)
        self.target_nodes = target_nodes
        self.old_nodes = old_nodes
        # partition -> (old owner hosts, new owner hosts), owner SET
        # changed. The whole double-write/double-read machinery keys
        # off membership here; non-moving partitions have identical
        # owners in both epochs, so mixed-epoch routing is
        # unobservable for them by construction.
        self.moving = moving
        # partition -> the OTHER side's extra Node objects (identity-
        # stable, so placement consumers that compare by ``is`` keep
        # working): during migrating the targets not already owners,
        # during draining the old owners not in the new set.
        self._extra: dict[int, list[Node]] = {}
        self.started_mono = time.monotonic()
        self._rebuild_extra()

    def _node_for(self, host: str) -> Node:
        for n in self.target_nodes:
            if n.host == host:
                return n
        for n in self.old_nodes:
            if n.host == host:
                return n
        return Node(host)

    def _rebuild_extra(self) -> None:
        extra: dict[int, list[Node]] = {}
        for p, (old, new) in self.moving.items():
            if self.phase == RESIZE_MIGRATING:
                want = [h for h in new if h not in old]
            else:
                want = [h for h in old if h not in new]
            extra[p] = [self._node_for(h) for h in want]
        self._extra = extra

    def extra_nodes(self, partition_id: int) -> list[Node]:
        return self._extra.get(partition_id, ())

    def to_wire(self) -> dict:
        return {"id": self.id, "phase": self.phase,
                "epochFrom": self.epoch_from,
                "old": list(self.old_hosts),
                "new": list(self.new_hosts)}


@dataclass
class Cluster:
    """Node list + placement math (cluster.go:120-264), versioned by a
    placement epoch for elastic resize (docs/CLUSTER_RESIZE.md)."""
    nodes: list[Node] = field(default_factory=list)
    partition_n: int = DEFAULT_PARTITION_N
    replica_n: int = DEFAULT_REPLICA_N
    node_set: Optional[object] = None  # membership backend (broadcast.py)
    hasher: object = None              # override for tests
    # Placement epoch: bumped atomically by flip_epoch so every
    # ownership consumer switches math in one step. ``resize`` is the
    # in-flight ResizeState or None (the hot-path check is one attr
    # read). ``_prev`` keeps the previous epoch's owners write-
    # accepting for a grace window after finalize.
    epoch: int = 0
    resize: Optional[ResizeState] = field(default=None, compare=False)
    _prev: Optional[tuple] = field(default=None, compare=False,
                                   repr=False)
    _mu: threading.Lock = field(default_factory=threading.Lock,
                                compare=False, repr=False)

    def node_by_host(self, host: str) -> Optional[Node]:
        for n in self.nodes:
            if n.host == host:
                return n
        return None

    def _hash(self, key: int, n: int) -> int:
        if self.hasher is not None:
            return self.hasher(key, n)
        return jump_hash(key, n)

    def partition(self, index: str, slice: int) -> int:
        """Slice → partition by FNV-1a(index ∥ BE64(slice)) mod partition_n
        (cluster.go:198-207)."""
        h = fnv1a_64(index.encode() + struct.pack(">Q", slice))
        return h % self.partition_n

    def partition_nodes(self, partition_id: int) -> list[Node]:
        """Primary owner by jump hash + replica_n ring successors
        (cluster.go:220-240) — the CURRENT epoch's authoritative
        placement (old pre-flip, new post-flip)."""
        if not self.nodes:
            return []
        replica_n = min(self.replica_n, len(self.nodes)) or 1
        i = self._hash(partition_id, len(self.nodes))
        return [self.nodes[(i + k) % len(self.nodes)]
                for k in range(replica_n)]

    def fragment_nodes(self, index: str, slice: int) -> list[Node]:
        """WRITE/general placement: the current epoch's owners, plus —
        during a resize — the other epoch's owners of a moving
        partition, so every write double-lands on old and new copies
        from prepare until finalize."""
        p = self.partition(index, slice)
        owners = self.partition_nodes(p)
        rs = self.resize
        if rs is not None:
            extra = rs.extra_nodes(p)
            if extra:
                owners = owners + [n for n in extra
                                   if all(o.host != n.host
                                          for o in owners)]
        return owners

    def read_nodes(self, index: str, slice: int) -> list[Node]:
        """READ authority: who may SERVE this slice without risk of an
        incomplete copy. No resize → the current owners. Migrating →
        the old (current) owners only — a stream target's copy is
        incomplete until the flip. Draining → new owners plus old
        owners (both copies receive every write until finalize).
        Post-finalize grace never extends read authority — the old
        copy goes stale the moment finalized writers stop
        double-writing."""
        p = self.partition(index, slice)
        owners = self.partition_nodes(p)
        rs = self.resize
        if rs is None or rs.phase != RESIZE_DRAINING:
            return owners
        extra = rs.extra_nodes(p)
        if extra:
            owners = owners + [n for n in extra
                               if all(o.host != n.host for o in owners)]
        return owners

    def read_allowed(self, host: str, index: str, slice: int) -> bool:
        return any(n.host == host
                   for n in self.read_nodes(index, slice))

    def moving_slice(self, index: str, slice: int):
        """``(phase, old_owner_hosts, new_owner_hosts)`` when the slice
        sits in a moving partition of an in-flight resize, else None.
        One attr read on the no-resize hot path."""
        rs = self.resize
        if rs is None:
            return None
        mv = rs.moving.get(self.partition(index, slice))
        if mv is None:
            return None
        return rs.phase, mv[0], mv[1]

    def owns_fragment(self, host: str, index: str, slice: int) -> bool:
        """Write-accepting ownership: the resize union, plus (post-
        finalize) the previous epoch's owners inside the grace window —
        a straggler coordinator's union-write must not bounce off the
        old owner with a 412. Read-path gates use read_allowed, never
        this."""
        if any(n.host == host
               for n in self.fragment_nodes(index, slice)):
            return True
        prev = self._prev
        if prev is not None:
            deadline, old_hosts, _epoch = prev
            if time.monotonic() < deadline:
                p = self.partition(index, slice)
                return host in owner_hosts(old_hosts, p, self.replica_n,
                                           self.hasher)
            # Expired: clear under the lock, and only the tuple we
            # read — an unsynchronized None could clobber a grace
            # window a concurrent finalize just installed.
            with self._mu:
                if self._prev is prev:
                    self._prev = None
        return False

    # -- resize lifecycle (driven by ResizeMessage broadcasts) ---------------

    def install_resize(self, resize_id: str,
                       new_hosts: list[str]) -> ResizeState:
        """The prepare step: atomically install the in-flight state.
        Idempotent for the same id; a different in-flight id raises
        (one resize at a time, cluster-wide)."""
        with self._mu:
            rs = self.resize
            if rs is not None:
                if rs.id == resize_id:
                    return rs
                raise ValueError(
                    f"resize {rs.id} already in flight (phase"
                    f" {rs.phase}); cannot install {resize_id}")
            old_hosts = [n.host for n in self.nodes]
            by_host = {n.host: n for n in self.nodes}
            target_nodes = [by_host.get(h) or Node(h)
                            for h in new_hosts]
            rs = ResizeState(
                resize_id, self.epoch, old_hosts, new_hosts,
                target_nodes, list(self.nodes),
                movement(old_hosts, new_hosts, self.partition_n,
                         self.replica_n, self.hasher))
            self.resize = rs
            return rs

    def flip_epoch(self, resize_id: str) -> bool:
        """The epoch-atomic switch: nodes/epoch move to the target
        membership and the resize enters draining, all under one lock
        — every subsequent placement consult on this node uses the new
        math. Returns True when this call performed the flip (False =
        already flipped). Raises if no matching resize is installed
        (the caller installs from the flip message first — it carries
        everything needed)."""
        with self._mu:
            rs = self.resize
            if rs is None or rs.id != resize_id:
                raise ValueError(f"no resize {resize_id} installed")
            if rs.phase == RESIZE_DRAINING:
                return False
            self.nodes = list(rs.target_nodes)
            self.epoch = rs.epoch_from + 1
            rs.phase = RESIZE_DRAINING
            rs._rebuild_extra()
            return True

    def finalize_resize(self, resize_id: str,
                        grace_s: float = 30.0) -> bool:
        """Drop the union: single-path writes resume; old owners keep
        write-accepting (never read-serving) for ``grace_s``."""
        with self._mu:
            rs = self.resize
            if rs is None or rs.id != resize_id:
                return False
            if rs.phase != RESIZE_DRAINING:
                # Finalize without flip = protocol violation upstream.
                raise ValueError(
                    f"resize {resize_id} not flipped (phase {rs.phase})")
            self.resize = None
            self._prev = (time.monotonic() + grace_s,
                          list(rs.old_hosts), rs.epoch_from)
            return True

    def abort_resize(self, resize_id: str) -> bool:
        """Back out to the old epoch. Pre-flip this only clears state;
        post-flip (a node that flipped before the coordinator decided
        to abort) it reverts nodes/epoch — safe because every node
        union-writes until finalize, so the old copies never missed a
        write."""
        with self._mu:
            rs = self.resize
            if rs is None or rs.id != resize_id:
                return False
            if rs.phase == RESIZE_DRAINING:
                self.nodes = list(rs.old_nodes)
                self.epoch = rs.epoch_from
            self.resize = None
            return True

    def owns_slices(self, index: str, max_slice: int, host: str
                    ) -> list[int]:
        """Slices whose PRIMARY owner is host (cluster.go:243-254)."""
        if not self.nodes:
            return []
        out = []
        for s in range(max_slice + 1):
            p = self.partition(index, s)
            if self.nodes[self._hash(p, len(self.nodes))].host == host:
                out.append(s)
        return out

    def node_set_hosts(self) -> list[str]:
        if self.node_set is None:
            return []
        return [n.host for n in self.node_set.nodes()]

    def node_states(self) -> dict[str, str]:
        """UP/DOWN per node, by NodeSet membership (cluster.go:157-169)."""
        h = {n.host: NODE_STATE_DOWN for n in self.nodes}
        for host in self.node_set_hosts():
            if host in h:
                h[host] = NODE_STATE_UP
        return h


def new_cluster(hosts: list[str], replica_n: int = DEFAULT_REPLICA_N
                ) -> Cluster:
    return Cluster(nodes=[Node(h) for h in hosts], replica_n=replica_n)
