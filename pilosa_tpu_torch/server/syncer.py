"""Anti-entropy: checksum-driven repair of attributes and fragments.

Copy of the JAX package's ``server/syncer.py`` (reference
holder.go:364-562 HolderSyncer + fragment.go:1301-1481 FragmentSyncer).
Walks the whole schema; for each index/frame it pulls
attribute diffs from peers by 100-id block checksums; for each owned
(view, slice) it compares 100-row SHA1 block checksums across replicas,
pulls differing blocks, runs the majority-consensus MergeBlock
(fragment.merge_block), applies local diffs, and pushes each peer's
diffs back as SetBit/ClearBit PQL. Peers behind an open circuit are
skipped for the pass, and a quarantined local fragment does not vote
(storage.integrity: the repairer owns it until it clears).

``FragmentStreamer`` is the JAX package's directed block-diff stream,
source to target through the additive ``/fragment/import`` lane: the
resize coordinator (cluster.resize) moves slices with it, paced and
with a per-block progress callback and the ``resize.stream`` failpoint,
and the repairer (server.repair) re-streams a quarantined fragment with
it. Anti-entropy leaves a moving slice to the streamer.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from .. import SLICE_WIDTH
from ..cluster.client import Client, ClientError
from ..errors import FragmentNotFoundError, FrameNotFoundError
from ..fault import failpoints as _fp
from ..models.view import VIEW_STANDARD
from ..storage.fragment import PairSet
from ..utils import logger as logger_mod


class HolderSyncer:
    def __init__(self, holder, host: str, cluster,
                 closing: Optional[threading.Event] = None,
                 client_factory=Client, logger=logger_mod.NOP,
                 fault=None):
        self.holder = holder
        self.host = host
        self.cluster = cluster
        self.closing = closing or threading.Event()
        self.client_factory = client_factory
        self.logger = logger
        # fault.FaultManager: peers whose circuit breaker is open are
        # skipped for the whole pass (they get repaired when they
        # return) instead of blocking anti-entropy on dead-peer
        # timeouts — the 60-minute soak's sweep must survive a down
        # replica.
        self.fault = fault

    def is_closing(self) -> bool:
        return self.closing.is_set()

    def _peers(self):
        # would_allow, not allow: this is a pure filter — consuming
        # the half-open probe slot here would starve the client's own
        # gate of it when the sync RPC actually goes out.
        return [n for n in self.cluster.nodes
                if n.host != self.host
                and (self.fault is None
                     or self.fault.would_allow(n.host))]

    # -- whole-holder walk (holder.go:385-436) -------------------------------

    def sync_holder(self) -> None:
        # Only STANDARD views are consensus-merged: the push-back repair
        # is SetBit/ClearBit PQL, which writes through the frame and so
        # regenerates inverse/time views consistently. Merging raw block
        # data into a transposed or time-scoped fragment would corrupt it
        # (the reference pulls only ViewStandard data for the same
        # reason, fragment.go:1425).
        for di in self.holder.schema():
            if self.is_closing():
                return
            self.sync_index(di["name"])
            for fi in di["frames"]:
                if self.is_closing():
                    return
                self.sync_frame(di["name"], fi["name"])
                if not any(v["name"] == VIEW_STANDARD
                           for v in fi["views"]):
                    continue
                max_slice = self.holder.index(di["name"]).max_slice()
                for slice in range(max_slice + 1):
                    # READ authority, not the write-accept union: an
                    # old owner inside the post-resize grace window
                    # still owns_fragment a moved slice, but its
                    # frozen copy must never VOTE in the consensus
                    # merge — majority with a stale voter can push
                    # ClearBits of acked writes or resurrect cleared
                    # bits (the class of the executor's cache
                    # gates).
                    if not self.cluster.read_allowed(
                            self.host, di["name"], slice):
                        continue
                    # Elastic resize: a moving slice's target copy is
                    # legitimately incomplete mid-migration — feeding
                    # it into the majority-consensus merge could push
                    # CLEARS of not-yet-streamed bits back to the
                    # source. The resize streamer owns these fragments
                    # until the flip settles; anti-entropy resumes on
                    # the next sweep after finalize.
                    if self.cluster.moving_slice(di["name"],
                                                 slice) is not None:
                        continue
                    if self.is_closing():
                        return
                    self.sync_fragment(di["name"], fi["name"],
                                       VIEW_STANDARD, slice)

    # -- attribute sync (holder.go:439-528) ----------------------------------

    def _sync_attr_store(self, store, fetch_diff) -> None:
        # Blocks are recomputed after every merge so the next peer diffs
        # against current state (holder.go:466-478).
        blocks = store.blocks()
        for node in self._peers():
            client = self.client_factory(node.host)
            try:
                m = fetch_diff(client, blocks)
            except (FrameNotFoundError, FragmentNotFoundError):
                continue  # not created remotely yet
            except ClientError as e:
                # A dead/unreachable peer must not abort the whole
                # sweep — the remaining peers still get their repair.
                # The failed RPC already fed the breaker (when the
                # client is fault-aware), so the NEXT store skips the
                # peer without paying this timeout again.
                self.logger.printf("sync: skipping peer %s: %s",
                                   node.host, e)
                continue
            if not m:
                continue
            store.set_bulk_attrs(m)
            blocks = store.blocks()

    def sync_index(self, index: str) -> None:
        idx = self.holder.index(index)
        if idx is None:
            return
        self._sync_attr_store(
            idx.column_attr_store,
            lambda c, blocks: c.column_attr_diff(index, blocks))

    def sync_frame(self, index: str, frame: str) -> None:
        f = self.holder.frame(index, frame)
        if f is None:
            return
        self._sync_attr_store(
            f.row_attr_store,
            lambda c, blocks: c.row_attr_diff(index, frame, blocks))

    # -- fragment sync (holder.go:531-562) -----------------------------------

    def sync_fragment(self, index: str, frame: str, view: str,
                      slice: int) -> None:
        f = self.holder.frame(index, frame)
        if f is None:
            raise FrameNotFoundError(frame)
        v = f.create_view_if_not_exists(view)
        frag = v.create_fragment_if_not_exists(slice)
        if frag.quarantined:
            # Storage integrity: a quarantined local copy must not
            # VOTE in the consensus merge — majority with a corrupt
            # (or freshly-reset, near-empty) voter could push
            # ClearBits of acked writes to healthy replicas. The
            # repairer owns this fragment; anti-entropy resumes on
            # the sweep after it clears.
            return
        FragmentSyncer(frag, self.host, self.cluster, self.closing,
                       self.client_factory, logger=self.logger,
                       fault=self.fault).sync_fragment()


class FragmentSyncer:
    def __init__(self, fragment, host: str, cluster,
                 closing: Optional[threading.Event] = None,
                 client_factory=Client, logger=logger_mod.NOP,
                 fault=None):
        self.fragment = fragment
        self.host = host
        self.cluster = cluster
        self.closing = closing or threading.Event()
        self.client_factory = client_factory
        self.logger = logger
        self.fault = fault

    def is_closing(self) -> bool:
        return self.closing.is_set()

    def _replica_peers(self, nodes):
        """The replica owners this pass will actually talk to: open
        circuits are skipped — a dead replica is repaired by the sweep
        AFTER it returns; blocking this sweep on its timeouts starves
        every healthy fragment behind it in the schema walk."""
        out = []
        for node in nodes:
            if node.host != self.host and self.fault is not None \
                    and not self.fault.would_allow(node.host):
                self.logger.printf(
                    "sync: skipping open-circuit peer %s for"
                    " %s/%s/%d", node.host, self.fragment.index,
                    self.fragment.frame, self.fragment.slice)
                continue
            out.append(node)
        return out

    def sync_fragment(self) -> None:
        """Compare per-block checksums across the replica set; merge any
        differing block (fragment.go:1322-1399)."""
        f = self.fragment
        if getattr(f, "quarantined", False):
            return  # must not vote (see HolderSyncer.sync_fragment)
        nodes = self._replica_peers(
            self.cluster.fragment_nodes(f.index, f.slice))
        if len(nodes) <= 1:
            return

        block_sets: list[list[tuple[int, bytes]]] = []
        sync_nodes: list = []
        for node in nodes:
            if node.host == self.host:
                block_sets.append(f.blocks())
                sync_nodes.append(node)
                continue
            client = self.client_factory(node.host)
            try:
                blocks = client.fragment_blocks(f.index, f.frame, f.view,
                                                f.slice, host=node.host)
            except FragmentNotFoundError:
                blocks = []
            except ClientError as e:
                # Unreachable mid-pass: drop the peer from THIS
                # fragment's consensus (its RPC failure fed the
                # breaker; later fragments skip it up front).
                self.logger.printf("sync: skipping peer %s: %s",
                                   node.host, e)
                continue
            block_sets.append(blocks)
            sync_nodes.append(node)
            if self.is_closing():
                return
        if len(sync_nodes) <= 1:
            return
        self._sync_nodes = sync_nodes

        # Zip the sorted block lists; sync any id whose checksums differ
        # or that is missing somewhere.
        idxs = [0] * len(block_sets)
        while True:
            block_id = None
            for bs, i in zip(block_sets, idxs):
                if i < len(bs) and (block_id is None or bs[i][0] < block_id):
                    block_id = bs[i][0]
            if block_id is None:
                break
            checksums = []
            for k, (bs, i) in enumerate(zip(block_sets, idxs)):
                if i < len(bs) and bs[i][0] == block_id:
                    checksums.append(bs[i][1])
                    idxs[k] += 1
                else:
                    checksums.append(None)
            if all(c == checksums[0] for c in checksums):
                continue
            self.sync_block(block_id)

    def sync_block(self, block_id: int) -> None:
        """Pull the block from every peer, merge by majority consensus,
        push per-peer diffs back as PQL (fragment.go:1403-1481)."""
        f = self.fragment
        nodes = getattr(self, "_sync_nodes", None)
        if nodes is None:
            nodes = self._replica_peers(
                self.cluster.fragment_nodes(f.index, f.slice))
        pair_sets: list[PairSet] = []
        clients: list = []
        for node in nodes:
            if node.host == self.host:
                continue
            if self.is_closing():
                return
            client = self.client_factory(node.host)
            # Only the standard view blocks are consensus-merged.
            try:
                rows, cols = client.block_data(f.index, f.frame,
                                               VIEW_STANDARD, f.slice,
                                               block_id, host=node.host)
            except ClientError as e:
                self.logger.printf("sync: skipping peer %s: %s",
                                   node.host, e)
                continue
            clients.append(client)
            pair_sets.append(PairSet(rows, cols))

        if self.is_closing():
            return
        sets, clears = f.merge_block(block_id, pair_sets)
        self.logger.printf(
            "sync block %s/%s/%s/%d block=%d: pushing sets=%d clears=%d",
            f.index, f.frame, f.view, f.slice, block_id,
            sum(len(s.column_ids) for s in sets),
            sum(len(c.column_ids) for c in clears))

        base = f.slice * SLICE_WIDTH
        for client, set_ps, clear_ps in zip(clients, sets, clears):
            if not len(set_ps.column_ids) and not len(clear_ps.column_ids):
                continue
            lines = []
            for r, c in zip(set_ps.row_ids, set_ps.column_ids):
                lines.append(f'SetBit(frame="{f.frame}", rowID={int(r)},'
                             f' columnID={base + int(c)})')
            for r, c in zip(clear_ps.row_ids, clear_ps.column_ids):
                lines.append(f'ClearBit(frame="{f.frame}", rowID={int(r)},'
                             f' columnID={base + int(c)})')
            if self.is_closing():
                return
            try:
                client.execute_query(None, f.index, "\n".join(lines),
                                     remote=False)
            except ClientError as e:
                # The peer died between pull and push-back: its repair
                # waits for the next sweep; local + other peers' merges
                # already landed.
                self.logger.printf("sync: push-back to %s failed: %s",
                                   client.host, e)


class _PrefixPush:
    """Torn-stream adapter for the ``resize.stream`` failpoint: torn
    mode hands this "writer" a byte PREFIX of the block's encoded u64
    positions; we push the whole positions that fit in it, so a torn
    injection leaves a genuine partial block on the target — exactly
    the state a crashed stream leaves — which the idempotent re-diff
    must then converge."""

    def __init__(self, push_fn, positions: np.ndarray):
        self.push_fn = push_fn
        self.positions = positions

    def write(self, data: bytes) -> None:
        n = len(data) // 8
        if n > 0:
            self.push_fn(self.positions[:n])


class FragmentStreamer:
    """Directed fragment migration for elastic resize
    (docs/CLUSTER_RESIZE.md): reuses the FragmentSyncer block-diff
    protocol (per-block SHA1 checksums via GET /fragment/blocks,
    changed-block pulls via the block-data wire), but instead of the
    consensus merge it pushes SETS-ONLY source→target through the
    additive ``POST /fragment/import`` lane:

    - sets-only because during migration every ClearBit double-writes
      to both copies (a bit absent on the source is already absent on
      the target), while a bit present on the target but not yet on
      the source can only be an in-flight double-write racing the diff
      read — clearing it would drop an acked write;
    - additive import (never the replace-style /fragment/data restore)
      because concurrent double-writes land between the diff read and
      the push, and a whole-fragment replace would clobber them;
    - per-block pushes bound memory, give the ``resize.stream``
      failpoint its injection granularity (error / delay / torn /
      partition-by-target-host), and let the pacing hook breathe
      between blocks.

    The push is idempotent (re-adding set bits is a no-op), so a torn
    or crashed stream recovers by simply re-running the diff.
    """

    def __init__(self, client_factory=Client, logger=logger_mod.NOP,
                 fault=None, pace_s: float = 0.0, on_block=None):
        self.client_factory = client_factory
        self.logger = logger
        # fault.FaultManager: the stream defers to the breaker state —
        # a target (or source) behind an open circuit pauses the
        # migration instead of hammering a struggling peer (the PR-5
        # health/breaker machinery paces the stream).
        self.fault = fault
        self.pace_s = pace_s
        # on_block(bits, nbytes): per-BLOCK progress callback — the
        # resize coordinator feeds its status/watchdog heartbeat from
        # it, so a long fragment's progress is visible while it
        # streams, not only after.
        self.on_block = on_block
        self.bits_pushed = 0
        self.bytes_pushed = 0

    def wait_allowed(self, host: str, closing=None,
                     timeout_s: float = 30.0) -> bool:
        """Block until the peer's circuit allows traffic (half-open
        probe windows count), up to ``timeout_s``."""
        if self.fault is None:
            return True
        deadline = None
        import time as _time
        while not self.fault.would_allow(host):
            if deadline is None:
                deadline = _time.monotonic() + timeout_s
            elif _time.monotonic() > deadline:
                return False
            if closing is not None and closing.is_set():
                return False
            _time.sleep(0.1)
        return True

    def stream_fragment(self, index: str, frame: str, view: str,
                        slice: int, source_host: str,
                        target_host: str) -> tuple[int, int]:
        """One fragment source→target; returns (bits, bytes) pushed.
        Zero bits pushed on a re-run is the convergence signal the
        coordinator's diff-until-clean loop keys on."""
        src = self.client_factory(source_host)
        tgt = self.client_factory(target_host)
        try:
            src_blocks = src.fragment_blocks(index, frame, view, slice,
                                             host=source_host)
        except FragmentNotFoundError:
            return (0, 0)  # nothing at the source: nothing to move
        try:
            tgt_blocks = dict(tgt.fragment_blocks(index, frame, view,
                                                  slice,
                                                  host=target_host))
        except FragmentNotFoundError:
            tgt_blocks = {}
        bits = nbytes = 0
        for block_id, checksum in src_blocks:
            if tgt_blocks.get(block_id) == checksum:
                continue
            rows, cols = src.block_data(index, frame, view, slice,
                                        block_id, host=source_host)
            if not len(rows):
                continue
            positions = np.unique(
                np.asarray(rows, dtype=np.uint64)
                * np.uint64(SLICE_WIDTH)
                + np.asarray(cols, dtype=np.uint64)
                % np.uint64(SLICE_WIDTH))

            def push(p, _tgt=tgt, _host=target_host):
                _tgt.fragment_import(index, frame, view, slice, p,
                                     host=_host)

            if _fp.ACTIVE is not None:
                # Torn mode pushes a PREFIX of this block, then raises
                # — the mid-stream crash shape.
                _fp.ACTIVE.hit("resize.stream", host=target_host,
                               writer=_PrefixPush(push, positions),
                               data=positions.tobytes())
            push(positions)
            block_bits = len(positions)
            block_bytes = block_bits * 8
            bits += block_bits
            nbytes += block_bytes
            self.bits_pushed += block_bits
            self.bytes_pushed += block_bytes
            from ..obs import metrics as obs_metrics
            obs_metrics.RESIZE_STREAM_BYTES.inc(block_bytes)
            if self.on_block is not None:
                self.on_block(block_bits, block_bytes)
            if self.pace_s:
                import time as _time
                _time.sleep(self.pace_s)
        return (bits, nbytes)
