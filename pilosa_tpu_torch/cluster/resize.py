"""Elastic cluster resize: the coordinator that takes a cluster from N
to N±1 nodes online, with zero wrong answers under live load
(docs/CLUSTER_RESIZE.md).

Copy of the JAX package's ``cluster/resize.py``: the same phases, the
same journal file (``<data>/resize.json``, readable by either package)
and the same ``ResizeMessage`` wire, so a port coordinator drives JAX
nodes and a JAX coordinator drives port nodes.

One difference is kept on purpose: the JAX coordinator's ``abort``
publishes the ``aborted`` phase before its abort broadcast has reached
the nodes, so a client that sees ``aborted`` on ``GET /cluster/resize``
can still find a node holding the installed resize (ROADMAP fault
3.15). Here the journal records the abort first (crash safety is the
same), the broadcast goes out, and only then does ``aborted`` become
visible: a client that sees it finds every reachable node back on the
old epoch, as the documented state machine says. And a stream pass
moves ``STREAM_WORKERS`` (index, slice) groups at once where the JAX
coordinator moves one at a time; a pass is the same set of idempotent
block diffs either way.

Protocol (every control step is a ``ResizeMessage`` POSTed directly to
each node's ``/messages`` — the 200 is that node's ack — and
re-broadcast async over gossip for stragglers):

1. **prepare** (all-ack required): every node (old ∪ new membership)
   installs the in-flight ``ResizeState``. From this moment writes to
   moving partitions fan to the union of old and new owners, reads of
   moving slices stay fenced to the old owners (the target copies are
   incomplete), and coordinators double-read moving slices.
2. **stream**: the coordinator walks the moving fragment set and
   pushes each one source→target with the FragmentSyncer block-diff
   protocol (server.syncer.FragmentStreamer — sets-only, additive,
   idempotent), paced by the PR-5 health EWMA/circuit breakers, until
   a whole pass moves zero bits (every pre-prepare bit is streamed;
   everything since double-writes).
3. **flip** (all-ack required): every node switches ``cluster.nodes``
   and bumps the placement epoch in ONE atomic step (topology
   ``flip_epoch``) and enters *draining* — reads route by the new
   placement, writes KEEP fanning to the union so a node that has not
   yet processed the flip cannot strand a write on the old copy only.
4. **drain-diff**: one more block-diff pass while everyone
   union-writes — closes the window where a write placed before its
   node processed *prepare* applied after its block had been streamed.
5. **finalize** (acked, stragglers converge via gossip + the
   write-accept grace window): the union drops; single-path writes
   resume; done.

Abort at any point before finalize completes broadcasts ``abort``:
nodes clear the resize state (reverting nodes/epoch if they had
flipped — safe, because every node union-writes until finalize, so the
old copies never missed a write). The coordinator journals every phase
transition to ``<data>/resize.json`` (atomic rename), so a coordinator
crash recovers deterministically: pre-flip resizes abort back to the
old epoch, post-flip resizes roll forward.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..errors import PilosaError
from ..obs import metrics as obs_metrics
from ..utils import logger as logger_mod
from .broadcast import ResizeMessage, marshal_message
from .topology import movement

# Coordinator phases (journal + /cluster/resize + the
# pilosa_cluster_resize_state gauge). Node-side ResizeState phases
# (migrating/draining) are a projection of these.
PHASE_IDLE = "idle"
PHASE_PREPARING = "preparing"
PHASE_STREAMING = "streaming"
PHASE_FLIPPING = "flipping"
PHASE_DRAINING = "draining"
PHASE_FINALIZING = "finalizing"
PHASE_DONE = "done"
PHASE_ABORTED = "aborted"

PHASES = (PHASE_IDLE, PHASE_PREPARING, PHASE_STREAMING, "migrating",
          PHASE_FLIPPING, PHASE_DRAINING, PHASE_FINALIZING, PHASE_DONE,
          PHASE_ABORTED)

JOURNAL_FILE = "resize.json"

# How many clean-pass attempts the streamer makes before giving up on
# convergence (each pass is a full block-diff; a pass that moves zero
# bits proves the pre-flip copies converged).
MAX_STREAM_PASSES = 6
# Control-send retry budget (per phase, per node) before the
# coordinator declares the phase unreachable.
ACK_RETRIES = 10
ACK_RETRY_SLEEP_S = 0.5
# (index, slice) groups a stream pass moves at once (the JAX
# coordinator moves one at a time).
STREAM_WORKERS = 6


def set_state_gauge(phase: str) -> None:
    """One-hot the resize-state gauge across the known phase labels."""
    for p in PHASES:
        obs_metrics.RESIZE_STATE.labels(p).set(
            1.0 if p == phase else 0.0)


class ResizeError(PilosaError):
    pass


class ResizeJournal:
    """Crash-safe record of the coordinator's progress: one JSON file
    under the data dir, rewritten atomically (tmp + rename) on every
    phase transition and streamed-fragment batch. ``Server.open``
    replays it — an in-flight pre-flip resize aborts back to the old
    epoch, a post-flip one rolls forward."""

    VERSION = 1

    def __init__(self, path: str):
        self.path = path
        self.state: dict = {}
        # write() is reachable from the coordinator run thread AND the
        # HTTP abort thread concurrently — serialize both the state
        # mutation and the tmp+rename (an interleaved pair could land
        # a truncated file that load() rejects, silently abandoning an
        # in-flight resize at the next open).
        self._mu = threading.Lock()

    @classmethod
    def for_data_dir(cls, data_dir: str) -> "ResizeJournal":
        return cls(os.path.join(data_dir, JOURNAL_FILE))

    def load(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                loaded = json.load(f)
        except (OSError, ValueError):
            return None
        if loaded.get("version") != self.VERSION:
            return None
        with self._mu:
            self.state = loaded
        return self.state

    def write(self, **updates) -> None:
        with self._mu:
            self.state.update(updates)
            self.state["version"] = self.VERSION
            self.state["updatedAt"] = time.time()
            snapshot = dict(self.state)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(snapshot, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)

    def in_flight(self) -> bool:
        phase = self.state.get("phase")
        if phase in (None, PHASE_DONE):
            return False
        if phase == PHASE_ABORTED:
            # An abort whose broadcast never reached every node leaves
            # peers holding the installed state (union writes, fenced
            # reads) — recovery must re-send it.
            return not self.state.get("abortAcked", True)
        return True


class ResizeCoordinator:
    """Drives one resize end-to-end against a live Server. One at a
    time per cluster (the prepare install enforces it cluster-wide:
    a second id raises on every node)."""

    def __init__(self, server, target_hosts: list[str],
                 resize_id: Optional[str] = None,
                 journal: Optional[ResizeJournal] = None,
                 pace_s: Optional[float] = None,
                 grace_s: Optional[float] = None,
                 logger=None):
        self.server = server
        self.cluster = server.cluster
        self.target_hosts = list(target_hosts)
        self.id = resize_id or uuid.uuid4().hex[:12]
        self.journal = journal or ResizeJournal.for_data_dir(
            server.holder.path)
        self.pace_s = (pace_s if pace_s is not None
                       else getattr(server, "resize_pace_s", 0.0))
        self.grace_s = (grace_s if grace_s is not None
                        else getattr(server, "resize_grace_s", 30.0))
        self.logger = logger or getattr(server, "logger",
                                        logger_mod.NOP)
        self.old_hosts = [n.host for n in self.cluster.nodes]
        self.phase = PHASE_IDLE
        self.error: Optional[str] = None
        self.moving: dict = {}
        self.slices_moved = 0
        self._moved_groups: set = set()
        self.bits_streamed = 0
        self.bytes_streamed = 0
        self.stream_passes = 0
        self.started_at = 0.0
        self.finished_at = 0.0
        # Watchdog progress signal (obs.watchdog "resize_stall"): any
        # forward step — an ack, a streamed block, a phase move —
        # touches this.
        self.last_progress = time.monotonic()
        self._mu = threading.Lock()
        self._cancel = threading.Event()
        # Set by the first abort() (the operator's or the run loop's):
        # the other must not abort on top of it.
        self._aborting = False

    # -- plumbing -------------------------------------------------------------

    def cancel(self) -> None:
        """Cooperative stop (server close / operator abort): the run
        loop notices between control sends and streamed blocks, then
        aborts back to the old epoch."""
        self._cancel.set()

    def touch(self) -> None:
        self.last_progress = time.monotonic()

    def _on_stream_block(self, bits: int, nbytes: int) -> None:
        """Per-block streamer callback: live progress for status,
        bench, and the watchdog heartbeat."""
        with self._mu:
            self.bytes_streamed += nbytes
        self.touch()

    def _check_cancel(self) -> None:
        if self._cancel.is_set():
            raise ResizeError(f"resize {self.id}: cancelled")

    def _set_phase(self, phase: str, **journal_updates) -> None:
        # Terminal phases stamp the finish time BEFORE the phase
        # becomes visible: a status poll must never observe
        # phase=done with finishedAt still unset (a duration computed
        # from the status would go negative), and
        # recovery paths reach DONE without passing through run().
        if phase in (PHASE_DONE, PHASE_ABORTED) and not self.finished_at:
            self.finished_at = time.time()
        with self._mu:
            self.phase = phase
        set_state_gauge(phase)
        self.touch()
        self.journal.write(phase=phase, **journal_updates)
        self.logger.printf("resize %s: phase %s", self.id, phase)

    def _union_hosts(self) -> list[str]:
        seen = []
        for h in self.old_hosts + self.target_hosts:
            if h not in seen:
                seen.append(h)
        return seen

    def _message(self, phase: str) -> ResizeMessage:
        return ResizeMessage(id=self.id, phase=phase,
                             epoch=self.journal.state.get(
                                 "epochFrom", self.cluster.epoch),
                             old_hosts=self.old_hosts,
                             new_hosts=self.target_hosts,
                             coordinator=self.server.host)

    def _send_phase(self, msg: ResizeMessage, hosts: list[str],
                    require_all: bool,
                    retries: int = ACK_RETRIES) -> list[str]:
        """Deliver ``msg`` to every host (self applied in-process),
        retrying failures with backoff. Returns the hosts that never
        acked; raises ResizeError when ``require_all`` and any
        remain. The message is also re-broadcast async (gossip /
        whatever backend) so a temporarily partitioned node converges
        later."""
        data = marshal_message(msg)
        pending = list(hosts)
        for attempt in range(retries):
            if msg.phase != "abort":
                self._check_cancel()
            still = []
            for host in pending:
                try:
                    if host == self.server.host:
                        self.server.receive_message(msg)
                    else:
                        self.server.client_for(host).post_message(
                            data, host=host, deadline_s=10.0)
                    self.touch()
                except Exception as e:  # noqa: BLE001 - retried below
                    self.logger.printf(
                        "resize %s: %s to %s failed (attempt %d): %s",
                        self.id, msg.phase, host, attempt + 1, e)
                    still.append(host)
            pending = still
            if not pending:
                break
            time.sleep(ACK_RETRY_SLEEP_S * min(4, attempt + 1))
        try:
            self.server.broadcaster.send_async(msg)
        except Exception:  # noqa: BLE001 - async catch-up best-effort
            pass
        if pending and require_all:
            raise ResizeError(
                f"resize {self.id}: phase {msg.phase} unacked by"
                f" {pending}")
        return pending

    # -- movement enumeration -------------------------------------------------

    def _moving_slice_groups(self) -> list[tuple]:
        """Every (index, slice, source_hosts, target_hosts) in the
        movement set, from the coordinator's schema knowledge (max
        slices include remote announcements)."""
        holder = self.server.holder
        out = []
        for name in sorted(holder.indexes):
            idx = holder.indexes[name]
            hi = max(idx.max_slice(), idx.max_inverse_slice())
            for slice in range(hi + 1):
                p = self.cluster.partition(name, slice)
                mv = self.moving.get(p)
                if mv is None:
                    continue
                old, new = mv
                targets = [h for h in new if h not in old]
                if targets:
                    out.append((name, slice, list(old), targets))
        return out

    def _stream_pass(self, streamer) -> int:
        """One full block-diff pass over the moving fragment set;
        returns bits moved (0 = converged). Fragments enumerate from
        the SOURCE's view of the schema (its frames' views), so time
        and inverse views migrate too.

        The (index, slice) groups stream on ``STREAM_WORKERS`` threads
        (the JAX coordinator streams them one after another): a group's
        stream is an idempotent block diff whose time is the source's
        and the target's host work, so groups of different nodes
        overlap. A pass still ends only when every group has streamed;
        the first group's error fails the pass once the others have
        stopped."""
        view_memo: dict = {}
        groups = []
        for index, slice, sources, targets in self._moving_slice_groups():
            src_host = self._pick_source(sources)
            if src_host is None:
                raise ResizeError(
                    f"resize {self.id}: no reachable source among"
                    f" {sources} for {index}/{slice}")
            idx = self.server.holder.index(index)
            frames = sorted(idx.frames) if idx is not None else []
            fviews = []
            for frame in frames:
                views = view_memo.get((src_host, index, frame))
                if views is None:
                    try:
                        views = self._source_views(src_host, index,
                                                   frame)
                    except Exception:  # noqa: BLE001 - fall back local
                        frame_obj = idx.frames.get(frame)
                        views = (sorted(frame_obj.views)
                                 if frame_obj is not None else [])
                    view_memo[(src_host, index, frame)] = views
                fviews += [(frame, view) for view in views]
            groups.append((index, slice, src_host, targets, fviews))
        stop = threading.Event()

        def stream_group(group) -> int:
            index, slice, src_host, targets, fviews = group
            if stop.is_set():
                return 0
            self._check_cancel()
            group_bits = 0
            for frame, view in fviews:
                for target in targets:
                    if not streamer.wait_allowed(
                            target, closing=self.server._closing):
                        raise ResizeError(
                            f"resize {self.id}: target {target}"
                            f" circuit stayed open")
                    # Byte/progress accounting rides the per-block
                    # on_block callback (the streamer invokes
                    # _on_stream_block), so status + the watchdog
                    # heartbeat advance WHILE a fragment streams.
                    bits, _nbytes = streamer.stream_fragment(
                        index, frame, view, slice, src_host, target)
                    group_bits += bits
                    self.touch()
            with self._mu:
                if (group_bits
                        and (index, slice) not in self._moved_groups):
                    # Once per (index, slice) across ALL passes: later
                    # catch-up passes re-moving a few live-write bits
                    # must not re-count the group.
                    self._moved_groups.add((index, slice))
                    self.slices_moved += 1
                    obs_metrics.RESIZE_SLICES_MOVED.inc()
            return group_bits

        moved_bits = 0
        first_error: Optional[BaseException] = None
        with ThreadPoolExecutor(max_workers=STREAM_WORKERS) as pool:
            for fut in [pool.submit(stream_group, g) for g in groups]:
                try:
                    moved_bits += fut.result()
                except Exception as e:  # noqa: BLE001 - raised below
                    stop.set()
                    if first_error is None:
                        first_error = e
        if first_error is not None:
            raise first_error
        with self._mu:
            self.bits_streamed += moved_bits
        return moved_bits

    def _source_views(self, src_host: str, index: str,
                      frame: str) -> list[str]:
        client = self.server.client_for(src_host)
        views = client.frame_views(index, frame)
        return [v if isinstance(v, str) else v.get("name", "")
                for v in (views or [])]

    def _sync_slice_knowledge(self) -> None:
        """Announce every index's max (and max inverse) slice to the
        whole union membership as CreateSliceMessage envelopes — the
        same wire the ordinary slice-creation broadcast rides — so
        every node enumerates the full slice range from the first
        post-flip query. Best-effort per host: a miss falls back to
        the gossip status merge."""
        from ..proto import internal as pb
        holder = self.server.holder
        for name in sorted(holder.indexes):
            idx = holder.indexes[name]
            for is_inv, mx in ((False, idx.max_slice()),
                               (True, idx.max_inverse_slice())):
                if mx <= 0:
                    continue
                msg = pb.CreateSliceMessage(Index=name, Slice=mx,
                                            IsInverse=is_inv)
                data = marshal_message(msg)
                for host in self._union_hosts():
                    try:
                        if host == self.server.host:
                            self.server.receive_message(msg)
                        else:
                            self.server.client_for(host).post_message(
                                data, host=host, deadline_s=10.0)
                    except Exception as e:  # noqa: BLE001 - advisory
                        self.logger.printf(
                            "resize %s: slice-knowledge sync to %s"
                            " failed: %s", self.id, host, e)

    def _pick_source(self, sources: list[str]) -> Optional[str]:
        fault = self.server.fault
        ordered = list(sources)
        if fault is not None:
            ordered = sorted(
                ordered, key=lambda h: 0 if fault.would_allow(h) else 1)
        for h in ordered:
            if fault is None or fault.would_allow(h):
                return h
        return ordered[0] if ordered else None

    # -- the protocol ---------------------------------------------------------

    def run(self) -> dict:
        """Drive the resize to done (or abort on failure). Returns the
        status dict; raises nothing — errors land in ``self.error``
        with the journal at ``aborted`` and the cluster back on the
        old epoch."""
        self.started_at = time.time()
        try:
            self._run_inner()
        except Exception as e:  # noqa: BLE001 - abort owns cleanup
            self.error = str(e)
            self.logger.printf("resize %s: failed: %s — aborting",
                               self.id, e)
            if not self._aborting:
                # An operator abort() (which sets _cancel and
                # broadcasts) surfaces here as the cancel error — the
                # protocol must not re-abort on top of it.
                try:
                    self.abort(reason=str(e))
                except Exception as e2:  # noqa: BLE001 - keep first
                    self.logger.printf("resize %s: abort itself"
                                       " failed: %s", self.id, e2)
        self.finished_at = self.finished_at or time.time()
        return self.status()

    def _run_inner(self) -> None:
        if set(self.target_hosts) == set(self.old_hosts):
            raise ResizeError("target membership equals current")
        if not self.target_hosts:
            raise ResizeError("target membership empty")
        self.moving = movement(self.old_hosts, self.target_hosts,
                               self.cluster.partition_n,
                               self.cluster.replica_n,
                               self.cluster.hasher)
        self.journal.write(
            id=self.id, phase=PHASE_IDLE,
            epochFrom=self.cluster.epoch,
            old=self.old_hosts, new=self.target_hosts,
            coordinator=self.server.host, startedAt=self.started_at,
            movingPartitions=sorted(self.moving))
        if not self.moving:
            # Same owner sets everywhere (e.g. pure reorder): flip
            # membership without any streaming.
            self.logger.printf("resize %s: empty movement set",
                               self.id)
        # 1. prepare — all-ack before any byte moves (a node that has
        # not installed the union could write old-only past a block
        # the streamer already read). Slice knowledge syncs alongside:
        # a freshly joined target otherwise only learns remote max
        # slices on the ~15 s gossip push/pull cadence, and a
        # coordinator that under-counts an index's slices right after
        # the flip would silently answer over a subset.
        self._set_phase(PHASE_PREPARING)
        self._send_phase(self._message("prepare"), self._union_hosts(),
                         require_all=True)
        self._sync_slice_knowledge()
        # 2. stream until a pass is clean.
        self._set_phase(PHASE_STREAMING)
        from ..server.syncer import FragmentStreamer
        streamer = FragmentStreamer(
            client_factory=self.server._client_factory,
            logger=self.logger, fault=self.server.fault,
            pace_s=self.pace_s, on_block=self._on_stream_block)
        for pass_n in range(1, MAX_STREAM_PASSES + 1):
            self.stream_passes = pass_n
            moved = self._stream_pass(streamer)
            self.journal.write(streamPasses=pass_n,
                               bitsStreamed=self.bits_streamed,
                               bytesStreamed=self.bytes_streamed)
            if moved == 0 and pass_n > 1:
                break
            if moved == 0 and not self.moving:
                break
        else:
            raise ResizeError(
                f"stream did not converge in {MAX_STREAM_PASSES}"
                f" passes (live write rate too high?)")
        # 3. flip — the commit point. All-ack: after ANY node flips,
        # we roll FORWARD (retry until all ack); if the retries
        # exhaust, the abort below reverts flipped nodes (safe:
        # everyone still union-writes).
        self._set_phase(PHASE_FLIPPING)
        self._send_phase(self._message("flip"), self._union_hosts(),
                         require_all=True, retries=ACK_RETRIES * 2)
        # 4. drain-diff: one more pass with every node on the new
        # epoch and still union-writing — catches any write that was
        # placed before its node processed prepare but applied after
        # its block streamed.
        self._set_phase(PHASE_DRAINING)
        self._stream_pass(streamer)
        # 5. finalize — drop the union. Stragglers converge via the
        # async re-broadcast + gossip piggyback + the old owners'
        # write-accept grace window, so this phase tolerates unacked
        # nodes.
        self._set_phase(PHASE_FINALIZING)
        pending = self._send_phase(self._message("finalize"),
                                   self._union_hosts(),
                                   require_all=False)
        if pending:
            self.logger.printf(
                "resize %s: finalize unacked by %s (gossip catch-up"
                " + %.0fs write grace cover them)", self.id, pending,
                self.grace_s)
        self._set_phase(PHASE_DONE, finishedAt=time.time(),
                        slicesMoved=self.slices_moved)
        set_state_gauge(PHASE_IDLE)

    def abort(self, reason: str = "") -> None:
        """Back the whole cluster out to the old epoch. No data loss
        by construction: old owners never dropped anything, and every
        write since prepare double-landed on them. The journal only
        records the abort as fully acked once every node confirmed —
        otherwise recovery re-sends it, so no peer stays stuck
        holding the installed state.

        Callable from any thread (the operator API aborts a LIVE
        coordinator): the cancel flag stops the run loop at its next
        check, so it cannot re-install state and complete a resize
        the operator was told is aborted."""
        self._cancel.set()
        self._aborting = True
        # The journal records the abort BEFORE the broadcast (a crash
        # in between re-sends it at recovery); the visible phase moves
        # only AFTER it, so ``aborted`` is never observable while a
        # reachable node still holds the installed state.
        self.journal.write(phase=PHASE_ABORTED, abortReason=reason,
                           abortAcked=False)
        pending = self._send_phase(self._message("abort"),
                                   self._union_hosts(),
                                   require_all=False)
        self._set_phase(PHASE_ABORTED, abortAcked=not pending,
                        abortPending=pending)
        set_state_gauge(PHASE_IDLE)

    def status(self) -> dict:
        with self._mu:
            phase = self.phase
        return {"id": self.id, "phase": phase,
                "error": self.error,
                "old": self.old_hosts, "new": self.target_hosts,
                "movingPartitions": sorted(self.moving),
                "slicesMoved": self.slices_moved,
                "bitsStreamed": self.bits_streamed,
                "bytesStreamed": self.bytes_streamed,
                "streamPasses": self.stream_passes,
                "startedAt": self.started_at,
                "finishedAt": self.finished_at or None,
                "progressAgeS": round(
                    time.monotonic() - self.last_progress, 3)}


def recover(server, logger=None) -> Optional[dict]:
    """Replay the resize journal at server open: an in-flight PRE-FLIP
    resize aborts back to the old epoch (the safe default — nothing
    moved authoritatively yet); a post-flip one rolls FORWARD (some
    nodes may already be serving the new epoch, and the old copies
    stop being written the moment anyone finalizes). Returns the final
    status dict, or None when the journal shows nothing in flight."""
    logger = logger or getattr(server, "logger", logger_mod.NOP)
    journal = ResizeJournal.for_data_dir(server.holder.path)
    state = journal.load()
    if not state or not journal.in_flight():
        return None
    phase = state.get("phase")
    resize_id = state.get("id", "")
    targets = state.get("new") or []
    olds = state.get("old") or []
    logger.printf("resize recovery: journal shows %s in phase %s",
                  resize_id, phase)
    coord = ResizeCoordinator(server, targets, resize_id=resize_id,
                              journal=journal, logger=logger)
    coord.old_hosts = olds
    coord.moving = movement(olds, targets, server.cluster.partition_n,
                            server.cluster.replica_n,
                            server.cluster.hasher)
    # Register as THE live op: the roll-forward must be visible to
    # GET /cluster/resize, drive the resize_stall watchdog, and own
    # the abort API — an unregistered recovery could otherwise race a
    # second operator-spawned coordinator over the same journal.
    server.resize_op = coord
    if phase in (PHASE_IDLE, PHASE_PREPARING, PHASE_STREAMING,
                 PHASE_ABORTED):
        coord.abort(reason=f"coordinator restarted in phase {phase}")
        return coord.status()
    # Post-flip: roll forward — re-send flip (idempotent; nodes that
    # lost state install from the message), drain-diff, finalize.
    try:
        coord._set_phase(PHASE_FLIPPING)
        coord._send_phase(coord._message("flip"), coord._union_hosts(),
                          require_all=True, retries=ACK_RETRIES * 2)
        from ..server.syncer import FragmentStreamer
        streamer = FragmentStreamer(
            client_factory=server._client_factory, logger=logger,
            fault=server.fault, pace_s=coord.pace_s,
            on_block=coord._on_stream_block)
        coord._set_phase(PHASE_DRAINING)
        coord._stream_pass(streamer)
        coord._set_phase(PHASE_FINALIZING)
        coord._send_phase(coord._message("finalize"),
                          coord._union_hosts(), require_all=False)
        coord._set_phase(PHASE_DONE, finishedAt=time.time())
        set_state_gauge(PHASE_IDLE)
    except Exception as e:  # noqa: BLE001 - surfaced in status
        coord.error = str(e)
        logger.printf("resize recovery: roll-forward failed: %s", e)
    return coord.status()
