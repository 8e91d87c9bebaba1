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
fragments snapshot their op-logs and close their WALs. The HTTP front's
pipelined batch lane (``_query_batcher``) runs consecutive plain-PQL
query POSTs of one index as one ``Executor.execute_partial`` call (a
write that adds a slice ends the call) and, when they wrote, one commit
barrier before their acks.

The query lifecycle (the JAX server's sched and obs wiring): every query
goes through the weighted admission queue (``query_config``:
concurrency and queue depth; overflow answers 429 with Retry-After),
under its tenant's policy (``tenants_config``), registered in the query
registry behind ``/debug/queries`` (cancel by id, the slow-query log),
with a cost ledger (unless ``handler.accounting`` is off) and, when
asked or ``trace_config.enabled``, a trace kept in the tracer's ring.
A pipelined batch run holds ONE admission slot and ONE context; when
admission is full the lane declines and the requests go one by one
through the handler, which answers the 429s. ``open()`` starts the
warmup (sched.warmup: build, load and launch every kernel entry once)
on a daemon thread; ``cal_dir`` is where the executor persists the cost
model's calibration (none: not persisted); ``executor_options`` are
further Executor arguments.

The static cluster (the JAX server's wiring, server.go:182-300):
``cluster`` is the placement (``cluster.topology.Cluster``, this node's
``host`` among its nodes; one node when None). The server builds the
node's FaultManager, its generation map, one keep-alive Client a peer
(``client_for``) and the executor's routing transport over them, and the
broadcaster (``cluster_type`` "http": schema messages POSTed to every
peer's ``/messages``; "static": none). It applies the broadcasts it
receives (``receive_message``), announces a fragment past a view's max
slice to its peers (CreateSliceMessage), and runs three loops while the
cluster has peers: the max-slice poll (``polling_interval``), the
half-open breaker probes, and anti-entropy (``anti_entropy_interval``,
server.syncer.HolderSyncer).

Storage integrity and tail sampling (the JAX server's wiring,
server.py:212-218, :409-450): ``scrub_config`` builds the background
scrubber (storage.scrub: a paced re-verification of every open
fragment's file against its checksums, on by default every 10 minutes)
and the repairer (server.repair: woken by each new quarantine, it
re-streams the fragment from a replica), both started at open and
stopped before the holder closes. ``trace_config.tail`` (on by default)
gives every query a span buffer and keeps the interesting ones to a
segment ring under ``<data_dir>/traces`` (obs.sampler, obs.diskring).
While the node is write-unready after ENOSPC (fault.diskfull) the
pipelined lane declines write runs, so each request answers its own
507. Every ``CACHE_FLUSH_INTERVAL`` (60 s, holder.go:31) a loop writes
every fragment's ``.cache`` sidecar, so a SIGKILL loses at most that
much of the ranked caches.

Gossip (the JAX server's wiring, server.py:620-631, :895-898): with
``cluster_type`` "gossip" the cluster's ``node_set`` is a
``cluster.gossip.GossipNodeSet``. It is the broadcaster, and at open the
server attaches itself as its receiver and status handler
(``receive_message``, ``local_status``, ``handle_remote_status``, the
``build_state`` piggyback), then opens the membership. Each membership
transition goes to the fault layer (``note_gossip``): a dead rumor
force-opens the peer's breaker, so its slices fail over to the other
replica before a query pays a refused connection, and ``/status`` and
``/health`` report the membership's states. ``metrics_config`` (the
registry feed and the cost ledger) and ``fault_config`` (the breaker
settings and the configured failpoints) are the ``[metrics]`` and
``[fault]`` sections; ``[fault] hedge`` arms the executor's hedged
reads. With metrics on, the runtime collector (obs.runtime) samples the
holder, residency and thread gauges every ``runtime_interval`` and feeds
``/status``; the federator (obs.federate, bounded by ``[metrics]
federate-timeout`` and ``federate-fanout``) serves ``/metrics/cluster``
and ``/debug/cluster`` from this node's ``local_debug_state`` and its
peers'. Resize, tiering and backup wait for the slices that port them.
"""

from __future__ import annotations

import errno
import json
import os
import threading

from typing import Optional

from .. import SLICE_WIDTH
from ..cluster.broadcast import (NOP_BROADCASTER, CancelQueryMessage,
                                 HTTPBroadcaster)
from ..cluster.client import Client
from ..cluster.generations import GenerationMap
from ..cluster.topology import NODE_STATE_DOWN, NODE_STATE_UP, new_cluster
from ..device import resolve_device
from ..errors import (PilosaError, QueryCancelledError,
                      QueryDeadlineError, SliceUnavailableError)
from ..executor import _WRITE_CALLS, ExecOptions, Executor
from ..fault import FaultManager
from ..fault import failpoints as fault_failpoints
from ..models.frame import FrameOptions
from ..models.holder import Holder
from ..models.index import IndexOptions
from ..models.view import VIEW_INVERSE
from ..obs import accounting as obs_accounting
from ..obs import metrics as obs_metrics
from ..obs.diskring import SegmentRing
from ..obs.federate import Federator
from ..obs.metrics import RegistryStatsClient, default_registry
from ..obs.runtime import RuntimeCollector, build_info
from ..obs.sampler import TailSampler
from ..obs.trace import Tracer
from ..pql import parser as pql
from ..pql.ast import Query
from ..sched import (LANE_READ, LANE_WRITE, AdmissionController,
                     AdmissionFullError, QueryContext, QueryRegistry,
                     TenantRegistry)
from ..sched.warmup import Warmup
from ..storage import wal as storage_wal
from ..storage.scrub import Scrubber
from ..utils import logger as logger_mod
from ..proto import internal as pb
from ..utils.config import (DEFAULT_ANTI_ENTROPY_INTERVAL,
                            DEFAULT_POLLING_INTERVAL, FaultConfig,
                            MetricsConfig, QueryConfig, ScrubConfig,
                            TenantsConfig, TraceConfig)
from ..utils.stats import ExpvarStatsClient, MultiStatsClient
from . import codec
from .handler import Handler, _local_status
from .httpd import HTTPServer
from .repair import Repairer
from .syncer import HolderSyncer

DEFAULT_PORT = 10101
CACHE_FLUSH_INTERVAL = 60.0             # holder.go:31


class Server:
    def __init__(self, data_dir: str, host: str = "localhost:10101",
                 device=None, logger=logger_mod.NOP,
                 wal_fsync: str = storage_wal.FSYNC_NONE,
                 query_config: Optional[QueryConfig] = None,
                 trace_config: Optional[TraceConfig] = None,
                 tenants_config: Optional[TenantsConfig] = None,
                 cal_dir: Optional[str] = None, warmup: bool = True,
                 executor_options: Optional[dict] = None,
                 cluster=None, cluster_type: str = "static",
                 polling_interval: float = DEFAULT_POLLING_INTERVAL,
                 anti_entropy_interval: float
                 = DEFAULT_ANTI_ENTROPY_INTERVAL,
                 scrub_config: Optional[ScrubConfig] = None,
                 metrics_config: Optional[MetricsConfig] = None,
                 fault_config: Optional[FaultConfig] = None):
        self.data_dir = data_dir
        self.host = host
        # Placement: the static cluster, or (None) this node alone,
        # built at open() once the bound port is known.
        self.cluster = cluster
        self.cluster_type = cluster_type
        self.polling_interval = polling_interval
        self.anti_entropy_interval = anti_entropy_interval
        self.broadcaster = NOP_BROADCASTER
        self.fault: Optional[FaultManager] = None
        self.fault_config = fault_config or FaultConfig()
        # Build identities of the peers, from the gossip push/pull.
        self.peer_builds: dict[str, dict] = {}
        self.gens = GenerationMap()
        self._clients: dict[str, Client] = {}
        self._clients_mu = threading.Lock()
        self._closing = threading.Event()
        self._loops: list[threading.Thread] = []
        self.device = device
        self.wal_fsync = wal_fsync
        self.logger = logger
        self.cal_dir = cal_dir
        # Extra Executor keyword arguments (e.g. mesh_min_slices=1 and
        # costmodel.pinned(0.0) to pin every device leg).
        self.executor_options = dict(executor_options or {})
        self.holder = None
        self.executor = None
        self.handler = None
        self._httpd = None
        self._thread = None
        # Observability: the expvar collector behind /debug/vars, its
        # call sites fed into the /metrics registry too.
        self.trace_config = trace_config or TraceConfig()
        self.metrics_config = metrics_config or MetricsConfig()
        self.stats = MultiStatsClient(
            [ExpvarStatsClient()]
            + ([RegistryStatsClient(default_registry())]
               if self.metrics_config.enabled else []))
        self.tracer = Tracer(enabled=self.trace_config.enabled,
                             max_traces=self.trace_config.max_traces,
                             max_spans=self.trace_config.max_spans)
        # Query lifecycle: the weighted admission queue with the tenant
        # (= index) as its second stride level, and the in-flight
        # registry behind /debug/queries.
        self.query_config = query_config or QueryConfig()
        self.tenants_config = tenants_config or TenantsConfig()
        self.tenants = TenantRegistry(self.tenants_config.table, node=host)
        self.admission = AdmissionController(
            concurrency=self.query_config.concurrency,
            queue_depth=self.query_config.queue_depth,
            tenants=self.tenants)
        self.query_registry = QueryRegistry(
            slow_threshold_s=self.query_config.slow_threshold or None,
            stats=self.stats, logger=logger)
        self.warmup_enabled = warmup
        self.warmup: Optional[Warmup] = None
        # Storage integrity (storage.scrub / server.repair) and tail
        # sampling (obs.sampler): built in open(), under the data dir.
        self.scrub_config = scrub_config or ScrubConfig()
        self.scrubber: Optional[Scrubber] = None
        self.repairer: Optional[Repairer] = None
        self.sampler: Optional[TailSampler] = None
        # The runtime collector (obs.runtime) and the federator behind
        # /metrics/cluster and /debug/cluster (obs.federate).
        self.runtime: Optional[RuntimeCollector] = None
        self.federator: Optional[Federator] = None

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
        own_cluster = self.cluster is None
        if own_cluster:
            self.cluster = new_cluster([self.host])
        elif self.cluster.node_by_host(self.host) is None:
            raise PilosaError(f"host {self.host} is not a member of the"
                              " cluster")
        if self.cluster_type == "gossip" and self.cluster.node_set is None:
            raise PilosaError("cluster type gossip needs the cluster's"
                              " gossip node set")
        fc = self.fault_config
        if fc.enabled:
            self.fault = FaultManager(
                breaker_threshold=fc.breaker_threshold,
                backoff_base_s=fc.breaker_backoff,
                backoff_cap_s=fc.breaker_backoff_cap,
                hedge_s=fc.hedge, node=self.host)
        if fc.seed:
            fault_failpoints.seed_default(fc.seed)
        for site, spec in fc.failpoints.items():
            fault_failpoints.arm(site, spec)
            self.logger.printf("failpoint armed: %s = %s (seed %d)", site,
                               spec, fault_failpoints.default().seed)
        self.holder = Holder(self.data_dir, wal_fsync=self.wal_fsync)
        try:
            self.holder.open()
            qc = self.query_config
            self.executor = Executor(
                self.holder, device=device, cal_dir=self.cal_dir,
                host=self.host, cluster=self.cluster,
                client=_RoutingClient(self), fault=self.fault,
                gens=self.gens,
                **{"result_cache_entries": qc.result_cache_entries,
                   "result_cache_bits": qc.result_cache_bits,
                   **self.executor_options})
            self.executor.CLUSTER_CACHE_ENTRIES = qc.cluster_cache_entries
            if self.warmup_enabled:
                self.warmup = Warmup(self.executor, logger=self.logger)
            if self.trace_config.tail:
                self.sampler = TailSampler(
                    disk=SegmentRing(
                        os.path.join(self.holder.path, "traces"),
                        segment_bytes=self.trace_config.disk_segment_bytes,
                        max_segments=self.trace_config.disk_segments),
                    head_n=self.trace_config.head_n,
                    slow_floor_s=self.trace_config.slow_floor,
                    admission=self.admission)
            if self.scrub_config.enabled:
                self.scrubber = Scrubber(
                    self.holder, interval_s=self.scrub_config.interval,
                    pace_s=self.scrub_config.pace, logger=self.logger)
            if self.scrub_config.repair:
                # Wires itself to the registry's on_quarantine hook.
                self.repairer = Repairer(
                    self.holder, self.cluster, self.host,
                    client_factory=self._client_factory, fault=self.fault,
                    rescan_s=self.scrub_config.repair_rescan,
                    logger=self.logger)
            if self.metrics_config.enabled:
                self.runtime = RuntimeCollector(
                    holder=self.holder, executor=self.executor,
                    admission=self.admission,
                    interval_s=self.metrics_config.runtime_interval)
            self.federator = Federator(
                self.host, cluster=self.cluster,
                client_for=self.client_for,
                peer_timeout_s=self.metrics_config.federate_timeout,
                fanout=self.metrics_config.federate_fanout)
            self.handler = Handler(
                self.holder, self.executor, host=self.host,
                logger=self.logger, admission=self.admission,
                registry=self.query_registry, warmup=self.warmup,
                default_timeout_s=self.query_config.default_timeout,
                tracer=self.tracer, stats=self.stats,
                tenants=self.tenants, cluster=self.cluster,
                status_handler=self, sampler=self.sampler,
                scrubber=self.scrubber, repairer=self.repairer,
                accounting=self.metrics_config.accounting,
                client_factory=self._client_factory,
                runtime=self.runtime, federator=self.federator)
            self._httpd = HTTPServer(self.handler, bind_host, port,
                                     logger=self.logger,
                                     query_batcher=self._query_batcher)
        except BaseException:
            self.holder.close()  # a port in use, an unreadable index
            self.holder = None
            raise
        # Re-resolve the port for ":0" binds (server.go:98-106).
        actual_port = self._httpd.server_address[1]
        ns = self.cluster.node_set
        if actual_port != port:
            new_host = f"{bind_host}:{actual_port}"
            for n in self.cluster.nodes:
                if n.host == self.host:
                    n.host = new_host
            # Gossip members are named by their HTTP host.
            if ns is not None and getattr(ns, "host", None) == self.host:
                ns.host = new_host
            self.host = new_host
            self.handler.host = self.host
            self.executor.host = self.host
            self.federator.host = self.host
            if self.fault is not None:
                self.fault.node = self.host
                self.fault.health.node = self.host
                self.fault.breakers.node = self.host
            if self.repairer is not None:
                # Its self-identity picks the in-process stream target.
                self.repairer.host = self.host
        if self.cluster_type == "http":
            self.broadcaster = HTTPBroadcaster(self)
        elif self.cluster_type == "gossip":
            self.broadcaster = ns
        self.handler.broadcaster = self.broadcaster
        self.holder.on_create_slice = self._on_create_slice
        if ns is not None:
            # Receiver first, then membership open: the join's push/pull
            # needs the status handler (server.go:118,123). Liveness
            # feeds the fault layer.
            ns.start(self)
            if hasattr(ns, "on_state_change"):
                ns.on_state_change = self._on_peer_state
            ns.open()
        if self.warmup is not None:
            self.warmup.start()
        if self.runtime is not None:
            self.runtime.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="httpd")
        self._thread.start()
        if self.scrubber is not None:
            self.scrubber.start()
        if self.repairer is not None:
            self.repairer.start()
        t = threading.Thread(target=self._loop,
                             args=(CACHE_FLUSH_INTERVAL,
                                   self.holder.flush_caches,
                                   "holder cache flush"),
                             daemon=True, name="cache flush")
        t.start()
        self._loops.append(t)
        if len(self.cluster.nodes) > 1:
            for fn, interval, name in (
                    (self.poll_max_slices, self.polling_interval,
                     "max slices poll"),
                    (self.probe_open_breakers, self._BREAKER_PROBE_INTERVAL,
                     "breaker probe"),
                    (self.sync_holder, self.anti_entropy_interval,
                     "anti-entropy")):
                if interval <= 0 or (fn == self.probe_open_breakers
                                     and self.fault is None):
                    continue  # 0 turns a loop off, as in the JAX server
                t = threading.Thread(target=self._loop,
                                     args=(interval, fn, name),
                                     daemon=True, name=name)
                t.start()
                self._loops.append(t)
        self.logger.printf("listening as http://%s on %s", self.host,
                           device)

    def close(self) -> None:
        self._closing.set()
        if self.warmup is not None:
            self.warmup.stop()
            self.warmup.wait(60)
        if self._httpd is not None:
            self._httpd.server_close()
            self._thread.join(timeout=10)
            self._httpd = None
        if self.cluster is not None and self.cluster.node_set is not None:
            self.cluster.node_set.close()
        if self.runtime is not None:
            self.runtime.stop()
        for t in self._loops:
            t.join(timeout=10)
        self._loops = []
        # Scrub and repair stop before the holder closes: a mid-pass
        # verify or re-stream must not race the fragments' close.
        if self.repairer is not None:
            self.repairer.stop()
        if self.scrubber is not None:
            self.scrubber.stop()
        if self.sampler is not None and self.sampler.disk is not None:
            self.sampler.disk.close()
        if self.executor is not None:
            self.executor.close()
        with self._clients_mu:
            for c in self._clients.values():
                c.close()
            self._clients.clear()
        if self.holder is not None:
            storage_wal.barrier_all()
            self.holder.close()
            self.holder = None

    # -- cluster (server.go:182-440) -----------------------------------------

    def client_for(self, host: str) -> Client:
        """The shared keep-alive Client of a peer, fault- and
        generation-aware."""
        with self._clients_mu:
            client = self._clients.get(host)
            if client is None:
                client = self._clients[host] = Client(
                    host, fault=self.fault, gens=self.gens)
            return client

    def _client_factory(self, host: str) -> Client:
        return self.client_for(host)

    def _loop(self, interval: float, fn, name: str) -> None:
        while not self._closing.wait(interval):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - a loop outlives errors
                self.logger.printf("%s error: %s", name, e)

    def poll_max_slices(self) -> None:
        """Adopt the peers' larger max slices (server.go:216-252)."""
        for node in self.cluster.nodes:
            if node.host == self.host:
                continue
            client = self.client_for(node.host)
            for inverse in (False, True):
                for name, value in client.max_slices(
                        inverse=inverse).items():
                    idx = self.holder.index(name)
                    if idx is None:
                        continue
                    if inverse:
                        idx.set_remote_max_inverse_slice(value)
                    else:
                        idx.set_remote_max_slice(value)

    # A peer behind an open circuit gets no traffic, so its recovery
    # is probed: one /version request a second to each probe-ready peer.
    _BREAKER_PROBE_INTERVAL = 1.0

    def probe_open_breakers(self) -> None:
        for host in self.fault.probe_targets():
            try:
                self.client_for(host)._do("GET", "/version",
                                          deadline_s=2.0)
            except QueryDeadlineError:
                # The client does not feed budget-clamped timeouts to
                # the breaker; the probe's 2 s is the probe's verdict.
                self.fault.record_rpc(host, False)
            except (PilosaError, OSError):
                pass  # the outcome fed the breaker

    def sync_holder(self) -> None:
        """One anti-entropy sweep (server.go:182-214)."""
        with self.logger.track("holder sync"):
            HolderSyncer(self.holder, self.host, self.cluster,
                         closing=self._closing,
                         client_factory=self._client_factory,
                         fault=self.fault, logger=self.logger).sync_holder()

    def _on_create_slice(self, index: str, slice: int,
                         inverse: bool) -> None:
        """Announce a new max slice to the peers (view.go:236-246)."""
        self.broadcaster.send_async(pb.CreateSliceMessage(
            Index=index, Slice=slice, IsInverse=inverse))

    def receive_message(self, m) -> None:
        """Apply a peer's broadcast (server.go:255-300)."""
        if isinstance(m, pb.CreateSliceMessage):
            idx = self.holder.index(m.Index)
            if idx is None:
                return
            if m.IsInverse:
                idx.set_remote_max_inverse_slice(m.Slice)
            else:
                idx.set_remote_max_slice(m.Slice)
        elif isinstance(m, pb.CreateIndexMessage):
            self.holder.create_index_if_not_exists(
                m.Index, IndexOptions.decode(m.Meta or pb.IndexMeta()))
        elif isinstance(m, pb.DeleteIndexMessage):
            self.holder.delete_index(m.Index)
        elif isinstance(m, pb.CreateFrameMessage):
            idx = self.holder.index(m.Index)
            if idx is not None:
                opts = FrameOptions.decode(m.Meta or pb.FrameMeta())
                frame = idx.create_frame_if_not_exists(m.Frame, opts)
                # A field created on an existing frame broadcasts the
                # whole meta again: register the fields this node lacks.
                for fld in opts.fields or []:
                    if frame.field(fld.name) is None:
                        frame.create_field(fld)
        elif isinstance(m, pb.DeleteFrameMessage):
            idx = self.holder.index(m.Index)
            if idx is not None:
                idx.delete_frame(m.Frame)
        elif isinstance(m, CancelQueryMessage):
            n = self.query_registry.cancel_local(
                m.id, reason="cancelled cluster-wide")
            if n:
                self.logger.printf("cancelled query %s (%d context%s)",
                                   m.id, n, "" if n == 1 else "s")
        else:
            raise PilosaError(f"unexpected message: {m!r}")

    def cluster_status(self) -> pb.ClusterStatus:
        """Every node's NodeStatus (server.go:325-351): this node's
        live. With gossip a peer's is its last status merge and its
        state the membership's; otherwise a peer's is computed from the
        shared schema and placement, DOWN while its circuit is open."""
        if self.cluster.node_set is not None:
            states = self.cluster.node_states()
            nodes = []
            for n in self.cluster.nodes:
                if n.host == self.host:
                    nodes.append(self.local_status())
                    continue
                nodes.append(pb.NodeStatus(
                    Host=n.host, State=states.get(n.host, NODE_STATE_DOWN),
                    Indexes=(list(n.status.Indexes)
                             if n.status is not None else [])))
            return pb.ClusterStatus(Nodes=nodes)
        nodes = []
        for n in self.cluster.nodes:
            ns = _local_status(self.holder, n.host, self.cluster)
            if (n.host != self.host and self.fault is not None
                    and not self.fault.would_allow(n.host)):
                ns.State = NODE_STATE_DOWN
            else:
                ns.State = NODE_STATE_UP
            nodes.append(ns)
        return pb.ClusterStatus(Nodes=nodes)

    # -- gossip: StatusHandler and the membership callback -------------------

    def local_status(self) -> pb.NodeStatus:
        """This node's state as the gossip push/pull carries it: schema
        with metas and the slices this node owns (server.go:306-323)."""
        return _local_status(self.holder, self.host, self.cluster)

    def handle_remote_status(self, status: pb.NodeStatus) -> None:
        """Merge a peer's schema and owned-slice knowledge into ours
        (server.go:353-387 mergeRemoteStatus)."""
        node = self.cluster.node_by_host(status.Host)
        if node is not None:
            node.set_status(status)
        for idx_info in status.Indexes:
            idx = self.holder.create_index_if_not_exists(
                idx_info.Name,
                IndexOptions.decode(idx_info.Meta or pb.IndexMeta()))
            remote_max = max([idx_info.MaxSlice] +
                             [int(s) for s in idx_info.Slices])
            idx.set_remote_max_slice(remote_max)
            for frame_info in idx_info.Frames:
                idx.create_frame_if_not_exists(
                    frame_info.Name,
                    FrameOptions.decode(frame_info.Meta or pb.FrameMeta()))

    # -- fleet observability (obs.federate) ----------------------------------

    def local_debug_state(self) -> dict:
        """This node's block of the ``/debug/cluster`` rollup: build
        identity, placement epoch, admission shape, WAL flusher health,
        quarantine size, breaker states, holder sizes, resize phase and
        the peers' builds learned by gossip. Deliberately light: a
        fleet-wide fan-out must stay cheap on every leg."""
        out: dict = {"host": self.host,
                     "build": build_info(),
                     "epoch": self.cluster.epoch,
                     "admission": self.admission.snapshot(),
                     "wal": storage_wal.flusher_health(),
                     "quarantined": len(self.holder.quarantine)}
        if self.fault is not None:
            out["fault"] = self.fault.snapshot()
        if self.runtime is not None:
            rt = self.runtime.snapshot()
            if rt.get("holder") is not None:
                out["holder"] = rt["holder"]
            if rt.get("deviceBlockCache"):
                out["deviceBlockCache"] = rt["deviceBlockCache"]
        rs = self.cluster.resize
        out["resize"] = {"phase": (rs.phase if rs is not None
                                   else "idle"),
                         "inFlight": rs.to_wire()
                         if rs is not None else None}
        if self.peer_builds:
            out["gossipBuilds"] = dict(self.peer_builds)
        return out

    def build_wire_state(self) -> dict:
        """The push/pull's build piggyback: this node's identity, so a
        mixed fleet's version skew is visible from any member."""
        return {"host": self.host, **build_info()}

    def apply_build_wire_state(self, d: dict) -> None:
        try:
            host = str(d.get("host", ""))
        except (TypeError, ValueError):
            return
        if not host or host == self.host:
            return
        self.peer_builds[host] = {
            k: str(d.get(k, "")) for k in ("version", "python", "jax",
                                           "backend")}

    def _on_peer_state(self, host: str, state: str) -> None:
        """Gossip membership callback → fault layer (the gossip states
        are health's liveness vocabulary)."""
        if self.fault is not None:
            self.fault.note_gossip(host, state)

    # -- the pipelined query batch lane (the JAX server's _query_batcher) ----

    def _query_batcher(self, index: str, bodies: list[str]):
        """Run pipelined plain-PQL query bodies as few executor calls as
        sequential dispatch allows; None sends them one by one through
        the handler. Every request answers as it would alone. A run of
        requests is ONE ``execute_partial`` call, which takes the slice
        lists once, before its first write: so a run ends after a
        request whose write can add a slice past those lists (the next
        run reads them anew), where the JAX server's one run would
        answer the later reads without the new slice (ROADMAP fault
        3.6 of the reference). Partial failure is the JAX package's:
        ``execute_partial`` says how far a run's combined calls got —
        each request it fully covered gets its results, the request
        holding the failing call gets the error response, and the
        requests after it in the run run one by one (none of their
        calls ran). No applied mutation runs twice (a SetBit run again
        would answer false to the client that set the bit). Requests
        that wrote take one commit barrier before any ack goes out.

        Lifecycle: the whole pipelined group occupies ONE admission slot
        (its lane classified over all calls, its tenant the index) and
        registers ONE QueryContext (the default timeout, a cost ledger)
        that every run executes under; with admission full the lane
        declines (None) and per-request dispatch answers the 429s. A
        request whose call hits the deadline or a cancel answers 504 or
        409; the requests before it keep their answers."""
        if self.executor is None:
            return None
        try:
            queries = [pql.parse(b) for b in bodies]
        except PilosaError:
            return None
        calls = [c for q in queries for c in q.calls]
        if not calls or all(c.name == "SetRowAttrs" for c in calls):
            return None  # the bulk attribute path applies out of order
        lane = (LANE_WRITE if any(c.name in _WRITE_CALLS for c in calls)
                else LANE_READ)
        if lane == LANE_WRITE:
            from ..fault import diskfull as fault_diskfull
            if not fault_diskfull.write_ready():
                # Write-unready after ENOSPC: decline the batch so
                # per-request dispatch answers the proper 507s.
                return None
        try:
            slot = self.admission.acquire(lane, tenant=index)
        except AdmissionFullError:
            return None  # per-request dispatch answers the 429s
        ctx = QueryContext(pql=f"<pipelined batch: {len(calls)} calls>",
                           index=index, lane=lane,
                           timeout_s=self.query_config.default_timeout
                           or None, node=self.host, tenant=index)
        if self.handler.accounting:
            obs_accounting.attach(ctx, node=self.host)
        self.tenants.install(ctx)
        out: list = []
        failed = True
        try:
            with self.query_registry.track(ctx):
                out = self._run_group(index, queries, calls,
                                      ExecOptions(ctx=ctx))
            failed = any(isinstance(p, tuple) for p in out)
        finally:
            slot.release()
            # The batch lane bypasses the handler's query path, so it
            # records its own latency sample.
            labels = ("batch", lane, "500" if failed else "200")
            obs_metrics.QUERY_SECONDS.labels(*labels).observe(
                ctx.elapsed())
            obs_metrics.QUERIES_TOTAL.labels(*labels).inc()
        return out

    def _run_group(self, index: str, queries: list[Query], calls: list,
                   opt: ExecOptions) -> list:
        """The payloads of a pipelined group: runs split where a write
        can add a slice, then one commit barrier when any request
        wrote."""
        idx = self.holder.index(index)
        out: list = []
        start = 0
        while start < len(queries):
            end = start + 1
            if idx is not None:
                max_slice = idx.max_slice()
                max_inverse = idx.max_inverse_slice()
                while (end < len(queries) and not _grows_slices(
                        idx, queries[end - 1].calls, max_slice,
                        max_inverse)):
                    end += 1
            else:
                end = len(queries)  # every call fails: no index
            out += self._run_payloads(index, queries[start:end], opt)
            start = end
        if any(c.name in _WRITE_CALLS for c in calls):
            try:
                storage_wal.barrier_all()
            except storage_wal.WalError as e:
                # No ack goes out for a write that is not durable.
                status = (507 if getattr(e.__cause__, "errno", None)
                          == errno.ENOSPC else 500)
                return [_error_payload(e, status) for _ in queries]
        return out

    def _run_payloads(self, index: str, queries: list[Query],
                      opt: Optional[ExecOptions] = None) -> list:
        """The responses of one run of requests: one ``execute_partial``
        call over their calls, mapped back onto the requests."""
        calls = [c for q in queries for c in q.calls]
        if all(c.name == "SetRowAttrs" for c in calls):
            # The bulk attribute path applies out of order: one by one.
            return [self._single_query_payload(index, q) for q in queries]
        results, err = self.executor.execute_partial(index, Query(calls),
                                                     opt=opt)
        out = []
        pos = 0
        failed = False
        for q in queries:
            n = len(q.calls)
            if err is None or (not failed and len(results) >= pos + n):
                out.append(_ok_payload(results[pos:pos + n]))
            elif not failed:
                # This request holds the failing call: the error
                # response sequential dispatch gives.
                out.append(_error_payload(err, _error_status(err)))
                failed = True
            else:
                # None of these calls ran: run the request on its own.
                out.append(self._single_query_payload(index, q))
            pos += n
        return out

    def _single_query_payload(self, index: str, q: Query):
        try:
            rs = self.executor.execute(index, q)
            if q.write_calls():
                storage_wal.barrier_all()  # commit before the ack
        except Exception as e:  # noqa: BLE001 - surfaced in the payload
            return _error_payload(e, _error_status(e))
        return _ok_payload(rs)


class _RoutingClient:
    """The executor's transport: each remote leg goes through the
    target peer's pooled Client (deadline- and generation-aware)."""

    deadline_aware = True
    generation_aware = True

    def __init__(self, server: Server):
        self.server = server

    def execute_query(self, node, index, query, slices, remote,
                      deadline_s=None, query_id=None, gens_out=None):
        return self.server.client_for(node.host).execute_query(
            node, index, query, slices, remote=remote,
            deadline_s=deadline_s, query_id=query_id, gens_out=gens_out)

    def generations(self, index, slices=None, host=None,
                    deadline_s=None):
        """The cluster result cache's validation probe."""
        return self.server.client_for(host).generations(
            index, slices, deadline_s=deadline_s)


def _grows_slices(idx, calls: list, max_slice: int,
                  max_inverse: int) -> bool:
    """Can a write of ``calls`` add a slice past the index's slice lists
    (``max_slice`` for the column slices, ``max_inverse`` for the
    inverse view's)? A call that cannot be read here answers True: it
    only ends a batched run early."""
    for c in calls:
        if c.name not in ("SetBit", "ClearBit", "SetFieldValue"):
            continue
        frame = idx.frame(c.args.get("frame") or "")
        if frame is None:
            continue  # the call fails without writing
        try:
            col, has_col = c.uint_arg(idx.column_label)
            row, has_row = c.uint_arg(frame.row_label)
        except ValueError:
            return True
        if has_col and col // SLICE_WIDTH > max_slice:
            return True
        inverse = (c.args.get("view") == VIEW_INVERSE
                   or (frame.inverse_enabled and not c.args.get("view")))
        if (c.name != "SetFieldValue" and inverse and has_row
                and row // SLICE_WIDTH > max_inverse):
            return True
    return False


def _ok_payload(results: list) -> bytes:
    """A 200 batch-lane entry; the common one-boolean answers of a
    pipelined write stream skip the JSON encoder."""
    if len(results) == 1 and results[0] is True:
        return b'{"results": [true]}\n'
    if len(results) == 1 and results[0] is False:
        return b'{"results": [false]}\n'
    return (json.dumps(codec.query_response_json(results, [])) + "\n"
            ).encode()


def _error_status(err: Exception) -> int:
    """The status sequential dispatch answers for ``err``: a slice no
    trustworthy copy can serve is the handler's 503 here too (the JAX
    server's batch lane answers it 400)."""
    if isinstance(err, QueryDeadlineError):
        return 504
    if isinstance(err, QueryCancelledError):
        return 409
    if isinstance(err, SliceUnavailableError):
        return 503
    if isinstance(err, PilosaError):
        return 400
    return 500


def _error_payload(err: Exception, status: int) -> tuple[int, bytes]:
    """A non-200 batch-lane entry: the HTTP front frames a plain bytes
    entry as a 200, so an error carries its status."""
    msg = (f"slice unavailable: {err}"
           if isinstance(err, SliceUnavailableError) else str(err))
    return status, (json.dumps({"error": msg}) + "\n").encode()
