"""Pod-internal query broadcast: a pod of processes as ONE cluster node.

The torch form of the JAX package's ``parallel/pod.py``, with its
semantics line for line; the collective underneath is
``parallel.multihost``'s torch.distributed reduce instead of a
``jax.distributed`` SPMD program.

- Only the pod *coordinator* (rank 0) appears in the cluster's host
  list. Clients, and other cluster nodes' remote legs, talk to it.
- Slice ownership inside the pod is round-robin by process:
  ``owner_pid(slice) = slice % n_procs``, stable as the index grows.
- Device-batched Count/TopN: the coordinator posts a *work item*
  (expression tree, leaf descriptors, the global slice list) to every
  worker's ``/pod/exec`` route, then every process packs its owned
  slices, counts them on its own device and enters the same
  all_reduce (multihost.count_exprs / topn_exact).
- Host-path reads (materialization, the TopN candidate phase) and
  writes route within the pod over HTTP as ``podLocal`` query legs to
  the owning process (the executor's ``_pod_host_mapper``).

The work item is the JAX item byte for byte (the same keys in the same
order, expressions as the same JSON arrays), so either package's
coordinator speaks to either package's worker over HTTP. A pod itself is
made of one package's processes: a ``jax.distributed`` job and a
torch.distributed group cannot share a collective. Mixing happens at
the cluster level (a JAX node and a port pod are two nodes of one
cluster).

Failure semantics are a pod's, not the reference's replica retry: a
dispatch that fails after some worker received the item (a partial
delivery, a leg stalled past ``PILOSA_TPU_POD_TIMEOUT``, a failed
collective) poisons the pod — the collective path stays off until the
pod restarts, and the podLocal host fan-out keeps answering. One
difference from the JAX dispatcher: a worker whose connection is
refused counts as undelivered at once, where the JAX one waits for the
delivery timeout (min(pod timeout, 15 s)) on every dispatch to a dead
worker.

Environment contract (in addition to parallel.multihost's):
  PILOSA_TPU_POD_PEERS   comma list of every pod process's HTTP host,
                         in process order (index 0 = coordinator)
  PILOSA_TPU_POD_TIMEOUT seconds to wait for worker legs (default 300)
"""

from __future__ import annotations

import http.client
import json
import os
import threading
from typing import Optional

import numpy as np

from ..errors import PilosaError
from ..models.view import VIEW_STANDARD
from ..ops.packed import WORDS_PER_SLICE
from . import multihost

ENV_PEERS = "PILOSA_TPU_POD_PEERS"


class PodError(PilosaError):
    pass


def _expr_from_json(v):
    """JSON arrays back to the hashable tuple trees the kernels key on."""
    if isinstance(v, list):
        return tuple(_expr_from_json(x) for x in v)
    return v


class Pod:
    """Pod membership + the work-item protocol. One per Server process;
    ``device`` is where this process counts its shard."""

    def __init__(self, holder, peers: list[str], device=None):
        self._init_state(holder, multihost.process_index(),
                         multihost.process_count(), peers)
        self.device = device

    def _init_state(self, holder, pid: int, n_procs: int,
                    peers: list[str]) -> None:
        """All state but the device — shared by __init__ and unit tests
        that build Pods without a process group."""
        self.holder = holder
        self.device = "cpu"
        self.pid = pid
        self.n_procs = n_procs
        if len(peers) != self.n_procs:
            raise PodError(
                f"{ENV_PEERS} lists {len(peers)} hosts for"
                f" {self.n_procs} pod processes")
        self.peers = peers
        self.timeout = float(os.environ.get("PILOSA_TPU_POD_TIMEOUT",
                                            "300"))
        self._run_mu = threading.Lock()       # one collective at a time
        self._dispatch_mu = threading.Lock()  # one item in flight pod-wide
        # Set when a dispatch failed AFTER some worker received the item:
        # that worker may be parked inside the orphaned collective, and a
        # new collective would cross-match with it. Once poisoned, the
        # device path stays off (the podLocal host fan-out remains
        # correct) until the pod is restarted.
        self._poisoned = False
        # Per-kind successful dispatch counts.
        self.dispatch_counts: dict[str, int] = {}
        # Per-peer keep-alive connections for pod-internal requests
        # (serialized per peer; reconnect on any error).
        self._conns: dict[int, http.client.HTTPConnection] = {}
        self._conn_mus = {pid: threading.Lock()
                          for pid in range(self.n_procs)}

    @property
    def is_coordinator(self) -> bool:
        return self.pid == 0

    @property
    def poisoned(self) -> bool:
        return self._poisoned

    # -- slice placement -----------------------------------------------------

    def owner_pid(self, slice: int) -> int:
        return slice % self.n_procs

    def owned(self, slices, pid: Optional[int] = None) -> list[int]:
        pid = self.pid if pid is None else pid
        return sorted(s for s in slices if s % self.n_procs == pid)

    def max_shard_slices(self, slices) -> int:
        """Per-process shard length for an item's slice list: the max
        owned count over processes, so unbalanced lists still give
        every process an equal shard."""
        counts = [0] * self.n_procs
        for s in slices:
            counts[s % self.n_procs] += 1
        return max(counts) if counts else 0

    def _local_slices(self, slices: list[int]) -> list[int]:
        """This process's shard of the item's slice list, padded with -1
        (absent: zero slices, the identity of every reduction) so every
        process feeds an identically shaped shard — deterministic from
        the item alone."""
        per = self.max_shard_slices(slices)
        mine = self.owned(slices)
        return mine + [-1] * (per - len(mine))

    # -- packing (zeros for absent fragments and pad slices) -----------------

    def _pack_leaves(self, index: str, leaves: list[tuple],
                     local_slices: list[int]) -> np.ndarray:
        block = np.zeros(
            (len(leaves), len(local_slices), WORDS_PER_SLICE),
            dtype=np.uint32)
        for li, (frame, view, row_id) in enumerate(leaves):
            for si, s in enumerate(local_slices):
                if s < 0:
                    continue
                frag = self.holder.fragment(index, frame, view, s)
                if frag is not None:
                    frag.pack_row(row_id, out=block[li, si])
        return block

    def _pack_rows(self, index: str, frame: str, row_ids: list[int],
                   local_slices: list[int]) -> np.ndarray:
        rows = np.zeros(
            (len(local_slices), len(row_ids), WORDS_PER_SLICE),
            dtype=np.uint32)
        for si, s in enumerate(local_slices):
            if s < 0:
                continue
            frag = self.holder.fragment(index, frame, VIEW_STANDARD, s)
            if frag is None:
                continue
            cached = len(row_ids) <= frag.device.max_rows
            for ri, rid in enumerate(row_ids):
                frag.pack_row(rid, out=rows[si, ri], cached=cached)
        return rows

    # -- the collective leg (every process runs this) ------------------------

    def run_item(self, item: dict) -> dict:
        """Pack this process's shard and enter the pod-wide collective.

        Called inline by the coordinator and from the ``/pod/exec``
        route by workers. Every process computes the same shard layout
        from the item, so the collectives line up."""
        with self._run_mu:
            kind = item["kind"]
            index = item["index"]
            slices = [int(s) for s in item["slices"]]
            leaves = [tuple(leaf) for leaf in item["leaves"]]
            local = self._local_slices(slices)
            if kind == "count_expr":
                block = self._pack_leaves(index, leaves, local)
                return {"total": multihost.count_expr(
                    self.device, _expr_from_json(item["expr"]), block)}
            if kind == "count_exprs":
                exprs = tuple(_expr_from_json(e) for e in item["exprs"])
                block = self._pack_leaves(index, leaves, local)
                return {"totals": multihost.count_exprs(
                    self.device, exprs, block)}
            if kind == "topn_exact":
                rows = self._pack_rows(index, item["frame"],
                                       item["row_ids"], local)
                lblock = self._pack_leaves(index, leaves, local)
                return {"counts": multihost.topn_exact(
                    self.device, _expr_from_json(item["expr"]), rows,
                    lblock, threshold=int(item.get("threshold", 1)),
                    tanimoto=int(item.get("tanimoto", 0)))}
            raise PodError(f"unknown pod work item kind: {kind}")

    # -- coordinator dispatch ------------------------------------------------

    def _request(self, pid: int, method: str, path: str, body: bytes,
                 content_type: str,
                 sent: Optional[threading.Event] = None) -> bytes:
        """One pod-internal request on the peer's keep-alive connection
        (serialized per peer; reconnect once on a stale socket)."""
        with self._conn_mus[pid]:
            for _attempt in range(2):
                conn = self._conns.pop(pid, None)
                fresh = conn is None
                if conn is None:
                    conn = http.client.HTTPConnection(
                        self.peers[pid], timeout=self.timeout)
                else:
                    # The CURRENT pod timeout applies to a pooled socket
                    # too: one made during a tight phase must not pin
                    # its deadline onto a phase that allows longer legs,
                    # nor the reverse.
                    conn.timeout = self.timeout
                    if conn.sock is not None:
                        conn.sock.settimeout(self.timeout)
                try:
                    # Accept mirrors Content-Type: the /import route
                    # negotiates strictly on both (406/415).
                    conn.request(method, path, body=body,
                                 headers={"Content-Type": content_type,
                                          "Accept": content_type})
                except (http.client.HTTPException, OSError):
                    conn.close()
                    if fresh:
                        raise
                    continue  # stale keep-alive socket: retry fresh
                if sent is not None:
                    sent.set()  # delivered: the worker enters the leg
                try:
                    resp = conn.getresponse()
                    data = resp.read()
                except (http.client.HTTPException, OSError):
                    conn.close()
                    raise
                if resp.will_close:
                    conn.close()
                else:
                    self._conns[pid] = conn
                if resp.status != 200:
                    raise PodError(f"pod process {pid} {method} {path}:"
                                   f" {data.decode(errors='replace')}")
                return data
            raise PodError(f"pod process {pid} {method} {path}:"
                           " no connection")

    def _post_item(self, pid: int, body: bytes, sent: threading.Event,
                   out: list, errs: list, refused: set) -> None:
        try:
            out[pid] = json.loads(self._request(
                pid, "POST", "/pod/exec", body, "application/json",
                sent=sent))
        except Exception as e:  # noqa: BLE001 - collected by dispatcher
            errs.append((pid, e))
            if not sent.is_set():
                # Never delivered (a refused connection): wake the
                # dispatcher now, not at its delivery timeout.
                refused.add(pid)
                sent.set()

    def _dispatch(self, item: dict) -> dict:
        """Post the item to every worker, run our own leg, check that
        every leg agrees (they all hold the same reduced result)."""
        if self._poisoned:
            raise PodError("pod collective path disabled after an earlier"
                           " partial dispatch failure (restart the pod)")
        body = json.dumps(item).encode()
        out: list = [None] * self.n_procs
        errs: list = []
        refused: set = set()
        sent_events = []
        threads = []
        with self._dispatch_mu:
            for pid in range(1, self.n_procs):
                sent = threading.Event()
                t = threading.Thread(
                    target=self._post_item, args=(pid, body, sent, out,
                                                  errs, refused),
                    daemon=True)
                t.start()
                sent_events.append((pid, sent))
                threads.append(t)
            # Enter the collective only once every worker has the item:
            # entering with a worker unreachable would stall the pod
            # until the collective times out.
            delivered = []
            undelivered = []
            for pid, sent in sent_events:
                (delivered if sent.wait(min(self.timeout, 15.0))
                 and pid not in refused else undelivered).append(pid)
            if undelivered:
                if delivered:
                    # Some workers are already entering the orphaned
                    # collective; a new one would cross-match with it.
                    self._poisoned = True
                raise PodError(
                    f"pod processes {undelivered} not reachable for"
                    " work-item broadcast"
                    + (" — pod collective path disabled" if delivered
                       else ""))
            # Our own leg runs BOUNDED by the pod timeout: a worker that
            # dies after receiving the item leaves the collective
            # stalled; the bound turns the stall into a poisoned pod
            # with the host fan-out still serving.
            box: dict = {}

            def run_leg():
                try:
                    box["out"] = self.run_item(item)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    box["err"] = e

            leg = threading.Thread(target=run_leg, daemon=True)
            leg.start()
            leg.join(self.timeout)
            if leg.is_alive():
                self._poisoned = True
                raise PodError(
                    f"pod collective stalled past {self.timeout:.0f}s "
                    "(worker died mid-collective?) — pod collective "
                    "path disabled")
            if "err" in box:
                # The collective itself failed (a worker died after
                # receiving the item): the others may be parked in it;
                # nothing further can safely pair up.
                self._poisoned = True
                raise box["err"]
            mine = box["out"]
            for t in threads:
                t.join()
        if errs:
            pid, e = errs[0]
            raise PodError(f"pod process {pid} failed: {e}") from e
        for pid in range(1, self.n_procs):
            if out[pid] != mine:
                raise PodError(
                    f"pod divergence: process {pid} returned {out[pid]},"
                    f" coordinator computed {mine}")
        kind = item["kind"]
        self.dispatch_counts[kind] = self.dispatch_counts.get(kind, 0) + 1
        return mine

    def count_expr(self, index: str, expr: tuple, leaves: list[tuple],
                   slices: list[int]) -> int:
        if not slices:
            return 0
        return self._dispatch({
            "kind": "count_expr", "index": index, "expr": expr,
            "leaves": [list(leaf) for leaf in leaves],
            "slices": sorted(slices)})["total"]

    def count_exprs(self, index: str, exprs: list[tuple],
                    leaves: list[tuple], slices: list[int]) -> list[int]:
        """K batched Counts in one pod collective (one work item, one
        dispatch): the pod form of the executor's fused count batch."""
        if not slices:
            return [0] * len(exprs)
        return self._dispatch({
            "kind": "count_exprs", "index": index,
            "exprs": list(exprs),
            "leaves": [list(leaf) for leaf in leaves],
            "slices": sorted(slices)})["totals"]

    def topn_exact(self, index: str, frame: str, expr, leaves: list[tuple],
                   row_ids: list[int], slices: list[int],
                   threshold: int = 1, tanimoto: int = 0) -> list[int]:
        if not slices or not row_ids:
            return [0] * len(row_ids)
        return self._dispatch({
            "kind": "topn_exact", "index": index, "frame": frame,
            "expr": expr, "leaves": [list(leaf) for leaf in leaves],
            "row_ids": [int(r) for r in row_ids],
            "threshold": int(threshold), "tanimoto": int(tanimoto),
            "slices": sorted(slices)})["counts"]

    # -- pod-internal forwarding ---------------------------------------------

    def forward_raw(self, pid: int, method: str, path: str, body: bytes,
                    content_type: str) -> bytes:
        """One pod-internal HTTP request (import forwarding, schema
        replication) on the peer's keep-alive connection."""
        return self._request(pid, method, path, body, content_type)

    def close(self) -> None:
        """Close the keep-alive connections to the peers."""
        for pid, mu in self._conn_mus.items():
            with mu:
                conn = self._conns.pop(pid, None)
                if conn is not None:
                    conn.close()


class PodBroadcaster:
    """Wraps the coordinator's cluster broadcaster so schema messages
    also reach every pod worker (their ``/messages`` route): workers are
    not cluster nodes, but must hold the same schema to serve
    pod-internal legs."""

    def __init__(self, base, pod: Pod):
        self.base = base
        self.pod = pod

    def _pod_send(self, m) -> None:
        from ..cluster.broadcast import marshal_message
        body = marshal_message(m)
        errs = []
        threads = []

        def post(pid):
            try:
                self.pod.forward_raw(pid, "POST", "/messages", body,
                                     "application/x-protobuf")
            except Exception as e:  # noqa: BLE001 - collected below
                errs.append(e)

        for pid in range(1, self.pod.n_procs):
            t = threading.Thread(target=post, args=(pid,), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errs:
            raise errs[0]

    def send_sync(self, m) -> None:
        self.base.send_sync(m)
        self._pod_send(m)

    def send_async(self, m) -> None:
        self.base.send_async(m)
        threading.Thread(target=self._quiet_pod_send, args=(m,),
                         daemon=True).start()

    def _quiet_pod_send(self, m) -> None:
        try:
            self._pod_send(m)
        except Exception:  # noqa: BLE001 - async sends are best-effort
            pass


def maybe_pod(holder, device) -> Optional[Pod]:
    """A Pod when the multihost env contract is active with more than
    one process; None in the ordinary single-process server."""
    if not multihost.initialize_from_env(device):
        return None
    if multihost.process_count() <= 1:
        return None
    peers = [p.strip()
             for p in os.environ.get(ENV_PEERS, "").split(",") if p.strip()]
    return Pod(holder, peers, device)
