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
``cluster`` is the placement (``cluster.topology.Cluster``; one node
when None). A node whose ``host`` is not among its nodes is a resize's
join candidate: it owns nothing until a resize adds it. The server builds
the node's FaultManager, its generation map, one keep-alive Client a
peer (``client_for``) and the executor's routing transport over them, and
the broadcaster (``cluster_type`` "http": schema messages POSTed to every
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
peers'.

The operator surface (the JAX server's open, server.py:378-675), each
section a config object: the continuous profiler (``profile_config``,
started at open when ``continuous``), the SLO burn trackers
(``slo_config``; with metrics on), the on-disk metric history under
``<data>/history`` (``history_config``; sampled on the runtime
collector's tick), the flight recorder under ``<data>/blackbox``
(``blackbox_config``; its SIGTERM and thread-excepthook dump triggers
are installed once per process), the stall watchdog
(``watchdog_config``; its resize input is ``_resize_progress``, its tier
input the tier manager's ``stall_age``, its backup input
``_backup_progress``),
the regression sentinel
(``sentinel_config``; a manifest only from ``[sentinel] manifest``),
workload capture under ``<data>/capture`` (``capture_config``) and the
fair dispatch queue below admission (parallel.mesh, installed at open
with the tenants' effective weights).

Tiered storage (the JAX server's wiring, server.py:452-479): with
``tier_config.enabled`` open() builds the TierManager (tier.manager)
over the holder — cold dir ``<data>/_tier`` unless ``[tier] cold-dir``
names one, the blob store from ``[tier] blob``, the tenants' cache
shares, the metric history's touch rates for the prefetcher, admission
as its busy signal — hooks the fragments already open (``sync``), and
starts its loops with the others; close() stops it before the holder
closes. ``/debug/tier`` (server.handler) shows it and ``?pass=1`` runs
one pass.

Elastic resize (the JAX server's wiring, server.py:902-1325;
docs/CLUSTER_RESIZE.md): ``start_resize`` makes this node the
coordinator of an online resize (cluster.resize.ResizeCoordinator on a
thread, ``resize_pace_s`` between streamed blocks), ``abort_resize``
backs one out, and ``_apply_resize_message`` is one node's side of the
protocol (prepare / flip / finalize / abort, every phase idempotent).
The placement epoch and membership persist in ``<data>/epoch.json`` at
every transition and are restored at open; an in-flight journal
(``<data>/resize.json``) is recovered at open on a thread — a pre-flip
resize aborts, a post-flip one rolls forward. After a finalize the old
owners keep accepting writes for ``resize_grace_s``. The gossip
push/pull carries ``resize_wire_state`` so a node that missed a control
send converges.

Disaster recovery (the JAX server's wiring, server.py:230-241,
:480-494, :644-692, :1005-1080): with ``backup_config.archive`` set,
open() opens the archive store (backup.archive.open_archive; ``dir``
roots it at ``<data>/_archive``) and starts this node's continuous WAL
archiver (backup.walarchive: a sink on the group-commit WAL, segments
named by this node's host, renamed with it on a ``:0`` bind) before any
traffic; an in-flight ``<data>/backup.json`` journal resumes on a
thread under the same backup id. ``start_backup`` makes this node the
coordinator of a cluster backup (backup.coordinator on a thread, one
at a time), ``abort_backup`` stops it cooperatively (its journal stays
in flight, so the next open resumes it). close() cancels the backup
and flushes the archiver before the holder closes, so an orderly
shutdown loses no point-in-time coverage.

The pod (the JAX server's wiring, server.py:318-348, :364, :566): with
the ``PILOSA_TPU_DIST_*`` and ``PILOSA_TPU_POD_PEERS`` environment
contract, open() joins the pod's torch.distributed process group before
any device use (parallel.multihost; gloo on the CPU, NCCL on a card
unless ``PILOSA_TPU_DIST_BACKEND=gloo``), and after the holder and the
placement epoch opens the ``Pod`` (parallel.pod.maybe_pod), which goes
to the executor and the handler; on the coordinator a ``PodBroadcaster``
wraps the broadcaster, so schema messages reach the workers. close()
closes the pod's connections and then destroys the process group. The
JAX children had to ``os._exit``, because ``jax.distributed``'s exit
hook hangs on a dead peer; a port process exits normally: the group's
timeout is the pod timeout, and a poisoned pod (a collective perhaps
parked on a dead peer) keeps its group until the process ends.
"""

from __future__ import annotations

import errno
import json
import os
import threading
import time

from typing import Optional

from .. import SLICE_WIDTH
from ..backup import archive as backup_archive
from ..backup import coordinator as backup_coord
from ..backup.walarchive import WalArchiver
from ..cluster import resize as resize_mod
from ..cluster.broadcast import (NOP_BROADCASTER, CancelQueryMessage,
                                 HTTPBroadcaster, ResizeMessage)
from ..cluster.client import Client
from ..cluster.generations import GenerationMap
from ..cluster.topology import (NODE_STATE_DOWN, NODE_STATE_UP, Node,
                                new_cluster)
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
from ..obs import blackbox as obs_blackbox
from ..obs import metrics as obs_metrics
from ..obs.capture import CaptureStore
from ..obs.diskring import SegmentRing
from ..obs.federate import Federator
from ..obs.history import MetricHistory
from ..obs.metrics import RegistryStatsClient, default_registry
from ..obs.profile import ContinuousProfiler
from ..obs.runtime import RuntimeCollector, build_info
from ..obs.sampler import TailSampler
from ..obs.sentinel import Sentinel
from ..obs.slo import SLOTracker, TenantSLOTracker
from ..obs.trace import Tracer
from ..obs.watchdog import Watchdog
from ..parallel import mesh as mesh_mod
from ..parallel import multihost
from ..parallel import pod as pod_mod
from ..pql import parser as pql
from ..pql.ast import Query
from ..sched import (LANE_READ, LANE_WRITE, AdmissionController,
                     AdmissionFullError, QueryContext, QueryRegistry,
                     TenantRegistry)
from ..sched.warmup import Warmup
from ..storage import wal as storage_wal
from ..storage.scrub import Scrubber
from ..tier.manager import TierManager
from ..utils import logger as logger_mod
from ..proto import internal as pb
from ..utils.config import (DEFAULT_ANTI_ENTROPY_INTERVAL,
                            DEFAULT_POLLING_INTERVAL, BackupConfig,
                            BlackboxConfig,
                            CaptureConfig, FaultConfig, HistoryConfig,
                            MetricsConfig, ProfileConfig, QueryConfig,
                            ScrubConfig, SentinelConfig, SLOConfig,
                            TenantsConfig, TierConfig, TraceConfig,
                            WatchdogConfig, parse_resolutions)
from ..utils.profiling import thread_dump
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
                 fault_config: Optional[FaultConfig] = None,
                 profile_config: Optional[ProfileConfig] = None,
                 slo_config: Optional[SLOConfig] = None,
                 blackbox_config: Optional[BlackboxConfig] = None,
                 watchdog_config: Optional[WatchdogConfig] = None,
                 history_config: Optional[HistoryConfig] = None,
                 sentinel_config: Optional[SentinelConfig] = None,
                 capture_config: Optional[CaptureConfig] = None,
                 tier_config: Optional[TierConfig] = None,
                 resize_pace_s: float = 0.0,
                 resize_grace_s: float = 30.0,
                 backup_config: Optional[BackupConfig] = None):
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
        # Background tasks that outlive no request and are not joined at
        # close (the resize coordinator, journal recovery).
        self._threads: list[threading.Thread] = []
        # Elastic resize (cluster.resize; docs/CLUSTER_RESIZE.md):
        # this node's in-flight coordinator op (None unless THIS node
        # is driving a resize), the post-finalize write-accept grace,
        # and the last settled resize for gossip catch-up.
        self.resize_pace_s = resize_pace_s
        self.resize_grace_s = resize_grace_s
        self.resize_op = None
        self._resize_mu = threading.Lock()
        self._last_resize: Optional[dict] = None
        # Disaster recovery (backup): the archive store, this node's
        # continuous WAL-segment archiver, and the backup this node
        # coordinates (None unless THIS node drives one) — built in
        # open() when [backup] names an archive.
        self.backup_config = backup_config or BackupConfig()
        self.backup_store = None
        self.wal_archiver = None
        self.backup_op = None
        self._backup_mu = threading.Lock()
        # parallel.pod.Pod once open() joins a pod (the env contract).
        self.pod = None
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
        # Tiered storage (tier): the working-set manager, built in open()
        # when [tier] enables it.
        self.tier_config = tier_config or TierConfig()
        self.tier: Optional[TierManager] = None
        # The runtime collector (obs.runtime) and the federator behind
        # /metrics/cluster and /debug/cluster (obs.federate).
        self.runtime: Optional[RuntimeCollector] = None
        self.federator: Optional[Federator] = None
        # The operator surface (module docstring): the continuous
        # profiler and the SLO trackers are built here, the disk-backed
        # parts (history, blackbox, capture) and the loops over them
        # (watchdog, sentinel) in open().
        self.profile_config = profile_config or ProfileConfig()
        self.profiler = ContinuousProfiler(
            hz=self.profile_config.hz, ring=self.profile_config.ring)
        self.slo_config = slo_config or SLOConfig()
        self.slo: Optional[SLOTracker] = None
        self.tenant_slo: Optional[TenantSLOTracker] = None
        if self.metrics_config.enabled:
            self.slo = SLOTracker(objective_s=self.slo_config.objective,
                                  target=self.slo_config.target)
            self.tenant_slo = TenantSLOTracker(
                objective_s=self.slo_config.objective,
                target=self.slo_config.target)
        self.blackbox_config = blackbox_config or BlackboxConfig()
        self.watchdog_config = watchdog_config or WatchdogConfig()
        self.history_config = history_config or HistoryConfig()
        self.sentinel_config = sentinel_config or SentinelConfig()
        self.capture_config = capture_config or CaptureConfig()
        self.blackbox: Optional[obs_blackbox.Blackbox] = None
        self.watchdog: Optional[Watchdog] = None
        self.history: Optional[MetricHistory] = None
        self.sentinel: Optional[Sentinel] = None
        self.capture: Optional[CaptureStore] = None

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
        # Pod membership joins before any device use (a no-op unless
        # the PILOSA_TPU_DIST_* env contract is set; parallel.multihost).
        multihost.initialize_from_env(device)
        own_cluster = self.cluster is None
        if own_cluster:
            self.cluster = new_cluster([self.host])
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
            # Placement-epoch durability (cluster.resize): a node that
            # lived through resizes must not boot back at epoch 0 with
            # the configured (stale) membership — restore the last
            # persisted (epoch, hosts) pair before anything consults
            # placement.
            self._load_epoch()
            # The pod-internal query broadcast (parallel.pod): the
            # coordinator posts device-batched Counts and TopNs to every
            # pod process as one collective and replicates schema
            # messages to its workers.
            self.pod = pod_mod.maybe_pod(self.holder, device)
            qc = self.query_config
            self.executor = Executor(
                self.holder, device=device, cal_dir=self.cal_dir,
                host=self.host, cluster=self.cluster,
                client=_RoutingClient(self), fault=self.fault,
                gens=self.gens, pod=self.pod,
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
            hc = self.history_config
            if self.metrics_config.enabled and hc.enabled:
                self.history = MetricHistory(
                    os.path.join(self.holder.path, "history"),
                    resolutions=parse_resolutions(hc.resolutions),
                    max_series=hc.max_series,
                    segment_bytes=hc.segment_bytes,
                    max_segments=hc.segments)
            self._open_tier()
            self._open_backup()
            if self.metrics_config.enabled:
                self.runtime = RuntimeCollector(
                    holder=self.holder, executor=self.executor,
                    admission=self.admission,
                    interval_s=self.metrics_config.runtime_interval,
                    slo=self.slo, tenant_slo=self.tenant_slo,
                    profiler=self.profiler, history=self.history)
            self.federator = Federator(
                self.host, cluster=self.cluster,
                client_for=self.client_for,
                peer_timeout_s=self.metrics_config.federate_timeout,
                fanout=self.metrics_config.federate_fanout)
            self._open_operator_surface()
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
                runtime=self.runtime, federator=self.federator,
                profiler=self.profiler, blackbox=self.blackbox,
                watchdog=self.watchdog, history=self.history,
                sentinel=self.sentinel, tenant_slo=self.tenant_slo,
                capture=self.capture, tier=self.tier, pod=self.pod)
            self._httpd = HTTPServer(self.handler, bind_host, port,
                                     logger=self.logger,
                                     query_batcher=self._query_batcher)
        except BaseException:
            self._close_operator_surface()
            if self.wal_archiver is not None:
                self.wal_archiver.close()
                self.wal_archiver = None
            self.holder.tier = self.tier = None
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
            # Capture records and blackbox snapshots name the serving
            # node; merged multi-node exports disambiguate on it.
            self.capture.node = self.host
            if self.blackbox is not None:
                self.blackbox.node = self.host
            if self.wal_archiver is not None:
                # WAL segments are keyed by the serving identity; the
                # seq counter is lazy, so no segment has been written
                # under the provisional name yet.
                self.wal_archiver.node = self.host
        if self.cluster_type == "http":
            self.broadcaster = HTTPBroadcaster(self)
        elif self.cluster_type == "gossip":
            self.broadcaster = ns
        if self.pod is not None and self.pod.is_coordinator:
            self.broadcaster = pod_mod.PodBroadcaster(self.broadcaster,
                                                      self.pod)
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
        # Resize journal recovery: an in-flight resize whose coordinator
        # (us) crashed either aborts back to the old epoch (pre-flip) or
        # rolls forward (post-flip). Runs on a background thread with
        # the cluster up — peers must be reachable for the control
        # sends, and boot must not block on them.
        _rj = resize_mod.ResizeJournal.for_data_dir(self.holder.path)
        if _rj.load() and _rj.in_flight():
            self._spawn(self._recover_resize, "resize-recover")
        # Backup journal recovery: an in-flight backup whose coordinator
        # (us) was killed resumes under the same id — journaled
        # fragments and pool-resident objects are skipped, so recovery
        # converges instead of re-shipping.
        if self.backup_store is not None:
            _bj = backup_coord.BackupJournal.for_data_dir(self.holder.path)
            if _bj.load() and _bj.in_flight():
                self._spawn(self._recover_backup, "backup-recover")
        if self.warmup is not None:
            self.warmup.start()
        if self.runtime is not None:
            self.runtime.start()
        if self.profile_config.continuous:
            self.profiler.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="httpd")
        self._thread.start()
        if self.scrubber is not None:
            self.scrubber.start()
        if self.repairer is not None:
            self.repairer.start()
        if self.tier is not None:
            self.tier.start()
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
        # Device-queue fairness below admission: dispatch slots stride
        # over the same penalty-boxed tenant weights admission uses.
        mesh_mod.install_fair_dispatch(self.tenants.effective_weight)
        self.logger.printf("listening as http://%s on %s", self.host,
                           device)

    def _open_tier(self) -> None:
        """The tiered-storage working-set manager (tier.manager):
        demotion, eviction and blob loops over the residency ledger,
        honoring the tenants' cache shares, with the prefetcher ranking
        cold fragments by the metric history's touch rates. Its loops
        start at the end of open() with the others."""
        tc = self.tier_config
        if not tc.enabled:
            return
        self.tier = TierManager(
            self.holder, resident_budget=tc.resident_budget,
            high_watermark=tc.high_watermark,
            low_watermark=tc.low_watermark, idle_s=tc.idle,
            blob_idle_s=tc.blob_idle,
            cold_dir=tc.cold_dir or os.path.join(self.holder.path,
                                                 "_tier"),
            blob=tc.blob, interval_s=tc.interval,
            prefetch_interval_s=tc.prefetch_interval, pace_s=tc.pace,
            tenants=self.tenants, history=self.history,
            busy_fn=lambda: self.admission.in_flight() > 0,
            logger=self.logger)
        self.holder.tier = self.tier
        # Fragments already open get their manager hook now; later
        # opens are picked up by the next pass's sync.
        self.tier.sync()

    def _open_backup(self) -> None:
        """The archive store and this node's continuous WAL archiver.
        The archiver's sink hooks the group-commit WAL before any
        traffic arrives, so the point-in-time record starts at boot,
        not at the first backup."""
        if not self.backup_config.archive:
            return
        self.backup_store = backup_archive.open_archive(
            self.backup_config.archive, self.holder.path)
        self.wal_archiver = WalArchiver(
            self.backup_store, self.holder.path, self.host,
            interval_s=self.backup_config.wal_interval,
            logger=self.logger)
        self.wal_archiver.start()

    def _open_operator_surface(self) -> None:
        """The flight recorder, the watchdog, the sentinel and the
        capture store, in the JAX server's order (its history and the
        runtime collector's hooks come before)."""
        bc = self.blackbox_config
        if bc.enabled:
            self.blackbox = obs_blackbox.Blackbox(
                os.path.join(self.holder.path, "blackbox"),
                state_fn=self._blackbox_state, interval_s=bc.interval,
                segment_bytes=bc.segment_bytes, max_segments=bc.segments,
                max_dumps=bc.dumps, node=self.host, logger=self.logger)
            self.blackbox.start()
            obs_blackbox.install_process_hooks()
        wc = self.watchdog_config
        if wc.enabled:
            self.watchdog = Watchdog(
                registry=self.query_registry, admission=self.admission,
                tracer=self.tracer, sampler=self.sampler,
                blackbox=self.blackbox, gossip_age_fn=self._gossip_age,
                resize_progress_fn=self._resize_progress,
                backup_progress_fn=self._backup_progress,
                scrub_progress_fn=(self.scrubber.stall_age
                                   if self.scrubber is not None
                                   else None),
                tier_progress_fn=(self.tier.stall_age
                                  if self.tier is not None else None),
                interval_s=wc.interval, wal_stall_s=wc.wal_stall,
                deadline_grace_s=wc.deadline_grace,
                gossip_silence_s=wc.gossip_silence,
                queue_stall_s=wc.queue_stall,
                resize_stall_s=wc.resize_stall,
                scrub_stall_s=wc.scrub_stall, tier_stall_s=wc.tier_stall,
                backup_stall_s=wc.backup_stall, retrip_s=wc.retrip,
                logger=self.logger)
            self.watchdog.start()
        sc = self.sentinel_config
        if sc.enabled and self.history is not None:
            self.sentinel = Sentinel(
                self.history, registry=self.query_registry,
                tracer=self.tracer, sampler=self.sampler,
                blackbox=self.blackbox, interval_s=sc.interval,
                window_s=sc.window, baseline_s=sc.baseline,
                zscore=sc.zscore, min_points=sc.min_points,
                min_ratio=sc.min_ratio, retrip_s=sc.retrip,
                manifest_path=sc.manifest,
                manifest_tolerance=sc.manifest_tolerance,
                logger=self.logger)
            self.sentinel.start()
        cc = self.capture_config
        self.capture = CaptureStore(
            os.path.join(self.holder.path, "capture"), mode=cc.mode,
            sample_n=cc.sample_n, segment_bytes=cc.segment_bytes,
            max_segments=cc.segments,
            redact_tenants={t.strip() for t in cc.redact.split(",")
                            if t.strip()},
            node=self.host)

    def _close_operator_surface(self) -> None:
        """Stop what _open_operator_surface started and close the
        metric history (idempotent; the runtime collector, which samples
        the history, stops first)."""
        if self.sentinel is not None:
            self.sentinel.stop()
            self.sentinel = None
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        if self.blackbox is not None:
            self.blackbox.stop()
            self.blackbox = None
        if self.capture is not None:
            self.capture.close()
            self.capture = None
        if self.history is not None:
            self.history.close()
            self.history = None

    def _gossip_age(self) -> Optional[float]:
        """Seconds of membership silence for the watchdog, or None
        when not observable (static membership, a single node)."""
        ns = self.cluster.node_set if self.cluster is not None else None
        if ns is None or not hasattr(ns, "last_activity_age"):
            return None
        return ns.last_activity_age()

    def _blackbox_state(self) -> dict:
        """One whole-system snapshot for the flight recorder: queues,
        breakers, generation knowledge, the WAL dirty set and flusher
        heartbeat, the runtime sample, recent slow queries, the
        integrity state, the resize block, the tier state, the backup
        block and a thread dump (the JAX server's blocks)."""
        out: dict = {"host": self.host,
                     "admission": self.admission.snapshot(),
                     "wal": storage_wal.flusher_health()}
        if self.fault is not None:
            out["fault"] = self.fault.snapshot()
        out["generations"] = self.gens.snapshot()
        reg = self.query_registry
        out["queries"] = {"active": reg.active()[:32],
                          "slow": reg.slow_queries()[-8:]}
        if self.runtime is not None:
            out["runtime"] = self.runtime.snapshot()
        if self.executor is not None:
            out["executor"] = {
                "deviceFallbacks": getattr(self.executor,
                                           "device_fallbacks", 0),
                "costModelVetoes": getattr(self.executor,
                                           "cost_vetoes", 0)}
            planner = getattr(self.executor, "planner", None)
            if planner is not None:
                out["planner"] = planner.snapshot()
        if self.watchdog is not None:
            out["watchdog"] = self.watchdog.snapshot()
        # Elastic resize state: phase, movement progress, epoch — the
        # one thing a mid-migration incident retro always asks first.
        rs = self.cluster.resize
        resize_block: dict = {"epoch": self.cluster.epoch,
                              "inFlight": rs.to_wire()
                              if rs is not None else None}
        if self.resize_op is not None:
            resize_block["op"] = self.resize_op.status()
        out["resize"] = resize_block
        integrity: dict = {
            "quarantined": self.holder.quarantine.entries()[:32]}
        if self.scrubber is not None:
            integrity["scrub"] = self.scrubber.state()
        if self.repairer is not None:
            integrity["repair"] = self.repairer.state()
        out["integrity"] = integrity
        # Tiered storage: residency counts, watermarks, blocked cold
        # fetches — where the working set lived when it happened.
        if self.tier is not None:
            out["tier"] = self.tier.state()
        # Disaster recovery: the in-flight backup op and this node's
        # WAL-archiver lag — was a backup running, and how much
        # point-in-time coverage was buffered.
        if self.backup_store is not None:
            backup_block: dict = {"configured": True}
            if self.backup_op is not None:
                backup_block["op"] = self.backup_op.status()
            if self.wal_archiver is not None:
                backup_block["walArchiver"] = self.wal_archiver.state()
            out["backup"] = backup_block
        try:
            out["threads"] = thread_dump()[:20000]
        except Exception:  # noqa: BLE001 - interpreter-internal API
            pass
        return out

    def close(self) -> None:
        self._closing.set()
        if self.resize_op is not None:
            # Cooperative stop; an in-flight journal is recovered (or
            # aborted) on the next open.
            self.resize_op.cancel()
        if self.backup_op is not None:
            # Cooperative stop; the journal stays in flight so the next
            # open resumes the backup under the same id.
            self.backup_op.cancel()
        if self.wal_archiver is not None:
            # Before the holder closes: the final flush ships every
            # buffered batch, so an orderly shutdown loses no
            # point-in-time coverage.
            self.wal_archiver.close()
        mesh_mod.uninstall_fair_dispatch()
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
        # The tier manager before the holder closes: a mid-pass
        # demotion must not race the fragments' close (stop joins it).
        if self.tier is not None:
            self.tier.stop()
        self._close_operator_surface()
        if self.sampler is not None and self.sampler.disk is not None:
            self.sampler.disk.close()
        self.profiler.stop()
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
        if self.pod is not None:
            self.pod.close()
            # Leave the process group — unless a dispatch poisoned the
            # pod: a collective may still be parked on a dead peer (it
            # raises at the group's timeout), and the group then goes
            # with the process.
            if not self.pod.poisoned:
                multihost.shutdown()
            self.pod = None

    # -- cluster (server.go:182-440) -----------------------------------------

    def _spawn(self, fn, name: str) -> None:
        t = threading.Thread(target=fn, name=f"pilosa-{name}", daemon=True)
        t.start()
        self._threads.append(t)

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
        elif isinstance(m, ResizeMessage):
            # Elastic resize control plane (cluster.resize): prepare /
            # flip / finalize / abort, delivered as direct acked POSTs
            # by the coordinator and replayed via gossip for
            # stragglers.
            self._apply_resize_message(m)
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

    # -- elastic resize (cluster.resize; docs/CLUSTER_RESIZE.md) -------------

    def start_resize(self, target_hosts: list[str]):
        """Begin an online resize to ``target_hosts`` with THIS node
        as coordinator; returns the ResizeCoordinator (already running
        on a background thread). One at a time — cluster-wide, the
        prepare install enforces it; locally, this guard does."""
        with self._resize_mu:
            op = self.resize_op
            # A just-constructed coordinator sits in IDLE until its
            # thread reaches the first phase — IDLE with no finish
            # time IS in flight, or two rapid POSTs would both pass
            # the guard and share one journal.
            if op is not None and not (
                    op.phase in (resize_mod.PHASE_DONE,
                                 resize_mod.PHASE_ABORTED)
                    or op.finished_at):
                raise PilosaError(
                    f"resize {op.id} already in flight"
                    f" (phase {op.phase})")
            if self.cluster.resize is not None:
                raise PilosaError(
                    f"resize {self.cluster.resize.id} already"
                    f" installed cluster-wide")
            # Journal recovery may still be rolling a prior resize
            # forward on its background thread (it registers itself
            # as resize_op only once it runs) — an in-flight journal
            # refuses new resizes outright so two coordinators can
            # never interleave writes to it. The one settle-able
            # state: an ABORT whose broadcast never reached a (since
            # dead) peer — re-send it now; if every node acks, the
            # old resize is settled and the new one may start.
            _rj = resize_mod.ResizeJournal.for_data_dir(
                self.holder.path)
            if _rj.load() and _rj.in_flight():
                if _rj.state.get("phase") == resize_mod.PHASE_ABORTED:
                    stale = resize_mod.ResizeCoordinator(
                        self, _rj.state.get("new") or [],
                        resize_id=str(_rj.state.get("id")),
                        journal=_rj, logger=self.logger)
                    stale.old_hosts = _rj.state.get("old") or []
                    stale.abort(reason="settling unacked abort before"
                                       " a new resize")
                    _rj.load()
                if _rj.in_flight():
                    raise PilosaError(
                        f"resize {_rj.state.get('id')} still settling"
                        f" (journal phase {_rj.state.get('phase')})")
            coord = resize_mod.ResizeCoordinator(
                self, target_hosts, pace_s=self.resize_pace_s,
                grace_s=self.resize_grace_s, logger=self.logger)
            self.resize_op = coord
        self._spawn(coord.run, f"resize-{coord.id}")
        return coord

    def abort_resize(self) -> Optional[dict]:
        """Operator abort: back the in-flight resize out to the old
        epoch. Works from the coordinator (aborts its op) or any node
        that merely has the state installed (broadcasts abort on the
        coordinator's behalf)."""
        op = self.resize_op
        if op is not None and op.phase not in (
                resize_mod.PHASE_DONE, resize_mod.PHASE_ABORTED):
            op.abort(reason="operator abort")
            return op.status()
        rs = self.cluster.resize
        if rs is None:
            return None
        coord = resize_mod.ResizeCoordinator(
            self, rs.new_hosts, resize_id=rs.id, logger=self.logger)
        coord.old_hosts = list(rs.old_hosts)
        # Seed the journal with the full membership BEFORE the abort
        # lands in it: if the abort broadcast can't reach every node
        # and this node restarts, recovery must be able to re-send it
        # to the right hosts (an id-less abort record re-sends to
        # nobody yet marks itself acked).
        coord.journal.write(id=rs.id, epochFrom=rs.epoch_from,
                            old=list(rs.old_hosts),
                            new=list(rs.new_hosts),
                            coordinator=self.host)
        coord.abort(reason="operator abort (non-coordinator)")
        return coord.status()

    def _recover_resize(self) -> None:
        try:
            status = resize_mod.recover(self, logger=self.logger)
            if status is not None:
                self.logger.printf("resize recovery finished: %s",
                                   status.get("phase"))
        except Exception as e:  # noqa: BLE001 - recovery best-effort
            self.logger.printf("resize recovery failed: %s", e)

    def _resize_progress(self):
        """Watchdog hook (obs.watchdog cause ``resize_stall``):
        (phase, seconds-without-progress) while this node coordinates
        an active resize, else None."""
        op = self.resize_op
        if op is None:
            return None
        if op.phase in (resize_mod.PHASE_IDLE, resize_mod.PHASE_DONE,
                        resize_mod.PHASE_ABORTED):
            return None
        import time as time_mod
        return op.phase, time_mod.monotonic() - op.last_progress

    # -- cluster backup (backup.coordinator) ---------------------------------

    def start_backup(self, kind: str = "full"):
        """Begin a cluster backup into the configured archive with THIS
        node as coordinator; returns the BackupCoordinator (already
        running on a background thread). One at a time per node — the
        journal is single-writer."""
        if self.backup_store is None:
            raise PilosaError("no backup archive configured"
                              " ([backup] archive)")
        with self._backup_mu:
            op = self.backup_op
            if op is not None and not (
                    op.phase in (backup_coord.PHASE_DONE,
                                 backup_coord.PHASE_FAILED)
                    or op.finished_at):
                raise PilosaError(f"backup {op.id} already in flight"
                                  f" (phase {op.phase})")
            # An in-flight journal belongs to a backup still being
            # recovered (recovery registers itself as backup_op only
            # once it runs): refuse rather than interleave two
            # coordinators into one journal.
            _bj = backup_coord.BackupJournal.for_data_dir(self.holder.path)
            if _bj.load() and _bj.in_flight() and (
                    op is None or _bj.state.get("id") != op.id):
                raise PilosaError(
                    f"backup {_bj.state.get('id')} still recovering"
                    f" (journal phase {_bj.state.get('phase')})")
            coord = backup_coord.BackupCoordinator(
                self, self.backup_store, kind=kind, logger=self.logger)
            self.backup_op = coord
        self._spawn(coord.run, f"backup-{coord.id}")
        return coord

    def abort_backup(self) -> Optional[dict]:
        """Operator abort: cooperatively stop the backup this node
        coordinates. The journal stays in flight, so the next open (or
        a later POST) resumes it instead of discarding the objects
        already pushed."""
        op = self.backup_op
        if op is None or op.phase in (backup_coord.PHASE_DONE,
                                      backup_coord.PHASE_FAILED) \
                or op.finished_at:
            return None
        op.cancel()
        return op.status()

    def _recover_backup(self) -> None:
        try:
            status = backup_coord.recover(self, logger=self.logger)
            if status is not None:
                self.logger.printf("backup recovery finished: %s",
                                   status.get("phase"))
        except Exception as e:  # noqa: BLE001 - recovery best-effort
            self.logger.printf("backup recovery failed: %s", e)

    def _backup_progress(self):
        """Watchdog hook (obs.watchdog cause ``backup_stall``): seconds
        without progress while this node coordinates an active backup,
        else None."""
        op = self.backup_op
        if op is None or op.phase in (backup_coord.PHASE_IDLE,
                                      backup_coord.PHASE_DONE,
                                      backup_coord.PHASE_FAILED):
            return None
        return time.monotonic() - op.last_progress

    def _epoch_path(self) -> str:
        return os.path.join(self.holder.path, "epoch.json")

    def _save_epoch(self) -> None:
        """Persist (epoch, membership) on every epoch transition —
        without it a restarted node resets to epoch 0 with its
        boot-config membership, silently mis-placing every slice and
        refusing every future resize's prepare."""
        try:
            tmp = self._epoch_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"epoch": self.cluster.epoch,
                           "hosts": [n.host
                                     for n in self.cluster.nodes]}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._epoch_path())
        except OSError as e:
            self.logger.printf("epoch persist failed: %s", e)

    def _load_epoch(self) -> None:
        try:
            with open(self._epoch_path()) as f:
                d = json.load(f)
            epoch = int(d.get("epoch", 0))
            hosts = [str(h) for h in (d.get("hosts") or [])]
        except (OSError, ValueError, TypeError):
            return
        if epoch <= self.cluster.epoch or not hosts:
            return
        if self.host.endswith(":0"):
            # A ":0" bind re-resolves its port after this point, so
            # the persisted membership names a port this node no
            # longer answers on and cannot be stitched back — skip
            # adoption (ephemeral-port servers are test harness
            # territory; production binds are stable).
            return
        self.cluster.nodes = [Node(h) for h in hosts]
        self.cluster.epoch = epoch
        self.logger.printf(
            "restored placement epoch %d (%d members) from %s",
            epoch, len(hosts), self._epoch_path())

    def _moved_fn(self, moving: dict):
        """``moved(index, slice) -> bool`` over a captured moving-
        partition map — the executor's eager cache flush on a flip."""
        parts = frozenset(moving)
        partition = self.cluster.partition

        def moved(index: str, slice: int) -> bool:
            return partition(index, slice) in parts
        return moved

    def _apply_resize_message(self, m: ResizeMessage) -> None:
        """One node's side of the resize protocol. Every phase is
        idempotent — the coordinator retries control sends, and the
        gossip catch-up path replays them — and a node that missed
        earlier phases reconstructs them from the message itself (it
        carries the full old/new membership)."""
        cl = self.cluster
        ex = self.executor

        def _install() -> bool:
            if cl.resize is not None:
                if cl.resize.id != m.id:
                    raise PilosaError(
                        f"resize {cl.resize.id} already in flight;"
                        f" refusing {m.id}")
                return True
            last = self._last_resize
            if last is not None and last.get("id") == m.id:
                # This id already settled here (aborted or done): a
                # straggling control send racing the abort broadcast
                # — or a gossip replay — must never re-install it.
                return False
            if cl.epoch > m.epoch:
                # AHEAD of the message: a resize minted against a
                # past epoch (e.g. a coordinator that restarted
                # before converging). A silent 200 would fake the
                # all-ack while this node never installs — refuse
                # loudly; legitimate replays of SETTLED resizes were
                # already absorbed by the _last_resize guard above.
                raise PilosaError(
                    f"resize {m.id} minted at epoch {m.epoch} but"
                    f" this node is at {cl.epoch}")
            if cl.epoch < m.epoch:
                # This node is BEHIND (restarted at epoch 0 / missed
                # flips). A silent 200 here would count as the all-ack
                # the union-write guarantee rests on while the node
                # keeps routing writes old-placement-only — the
                # coordinator must see a FAILURE and retry until the
                # gossip catch-up brings the node forward (or abort).
                raise PilosaError(
                    f"node at placement epoch {cl.epoch}, resize"
                    f" {m.id} expects {m.epoch} — catching up")
            cl.install_resize(m.id, m.new_hosts)
            resize_mod.set_state_gauge("migrating")
            if ex is not None:
                ex.on_resize_change()
            self.logger.printf(
                "resize %s: installed (epoch %d, %s -> %s)", m.id,
                m.epoch, m.old_hosts, m.new_hosts)
            return True

        if m.phase == "prepare":
            _install()
            return
        if m.phase == "flip":
            if cl.epoch == m.epoch + 1:
                return  # already flipped (retry / catch-up replay)
            if not _install():
                return
            rs = cl.resize
            if rs is None or rs.id != m.id:
                return  # aborted concurrently on another thread
            moving = dict(rs.moving)
            try:
                flipped = cl.flip_epoch(m.id)
            except ValueError:
                return  # abort raced the flip: settled-id guard holds
            if flipped:
                self._save_epoch()
                resize_mod.set_state_gauge(resize_mod.PHASE_DRAINING)
                if ex is not None:
                    ex.on_resize_change(self._moved_fn(moving))
                self.logger.printf(
                    "resize %s: FLIPPED to epoch %d (%d moving"
                    " partitions)", m.id, cl.epoch, len(moving))
            return
        if m.phase == "finalize":
            if cl.resize is None and cl.epoch == m.epoch:
                # Missed prepare AND flip (restart/partition): replay
                # both from this message, then finalize below.
                if not _install():
                    return
            rs = cl.resize
            if rs is not None and rs.id == m.id:
                moving = dict(rs.moving)
                from ..cluster.topology import RESIZE_DRAINING
                try:
                    if rs.phase != RESIZE_DRAINING:
                        cl.flip_epoch(m.id)
                        if ex is not None:
                            ex.on_resize_change(self._moved_fn(moving))
                    cl.finalize_resize(m.id,
                                       grace_s=self.resize_grace_s)
                except ValueError:
                    return  # abort raced this application
                self._save_epoch()
                resize_mod.set_state_gauge(resize_mod.PHASE_IDLE)
                if ex is not None:
                    ex.on_resize_change()
                self._last_resize = {
                    "id": m.id, "outcome": "done",
                    "epochFrom": m.epoch, "old": m.old_hosts,
                    "new": m.new_hosts}
                self.logger.printf("resize %s: finalized (epoch %d)",
                                   m.id, cl.epoch)
            return
        if m.phase == "abort":
            # A live coordinator op for this id (an abort initiated
            # through ANOTHER node) must stop driving the protocol —
            # its later phases would otherwise be silently absorbed
            # by every node's settled-id guard and the journal would
            # record 'done' for a resize the cluster aborted.
            op = self.resize_op
            if op is not None and op.id == m.id:
                op.cancel()
            rs = cl.resize
            moving = dict(rs.moving) if rs is not None else {}
            aborted = cl.abort_resize(m.id)
            # Record the settled outcome even when nothing was
            # installed here (a node that missed prepare): a
            # straggling prepare/flip for this id must never install
            # it afterwards.
            self._last_resize = {
                "id": m.id, "outcome": "aborted",
                "epochFrom": m.epoch, "old": m.old_hosts,
                "new": m.new_hosts}
            if aborted:
                self._save_epoch()  # covers a post-flip revert
                resize_mod.set_state_gauge(resize_mod.PHASE_IDLE)
                if ex is not None:
                    ex.on_resize_change(self._moved_fn(moving))
                self.logger.printf("resize %s: aborted (epoch stays"
                                   " %d)", m.id, cl.epoch)
            return
        raise PilosaError(f"unknown resize phase: {m.phase!r}")

    # -- gossip piggyback: epoch/resize convergence --------------------------

    def resize_wire_state(self) -> dict:
        """Rides the gossip push/pull full-state exchange so a node
        that missed resize control sends (partitioned, restarted)
        converges on the cluster's placement epoch within one
        anti-entropy period."""
        out: dict = {"epoch": self.cluster.epoch}
        rs = self.cluster.resize
        if rs is not None:
            out["resize"] = rs.to_wire()
        if self._last_resize is not None:
            out["last"] = dict(self._last_resize)
        return out

    def apply_resize_wire_state(self, d: dict) -> None:
        """Converge toward a peer's epoch/resize knowledge. Only ever
        moves FORWARD (install → flip → finalize, or abort of the
        exact in-flight id) — a peer that is itself behind can never
        drag us back."""
        try:
            peer_epoch = int(d.get("epoch", 0))
        except (TypeError, ValueError):
            return
        cl = self.cluster
        rz = d.get("resize")
        last = d.get("last")

        def msg(phase: str, src: dict) -> ResizeMessage:
            return ResizeMessage(
                id=str(src.get("id", "")), phase=phase,
                epoch=int(src.get("epochFrom", peer_epoch - 1)),
                old_hosts=src.get("old") or [],
                new_hosts=src.get("new") or [])
        try:
            if (cl.resize is not None and rz is None and last
                    and last.get("id") == cl.resize.id):
                # The resize WE still carry has settled at the peer.
                if last.get("outcome") == "aborted":
                    self._apply_resize_message(msg("abort", last))
                elif last.get("outcome") == "done":
                    self._apply_resize_message(msg("finalize", last))
                return
            if rz is not None:
                if (rz.get("phase") == "draining"
                        and peer_epoch == cl.epoch + 1):
                    self._apply_resize_message(msg("flip", rz))
                elif (peer_epoch == cl.epoch and cl.resize is None):
                    self._apply_resize_message(msg("prepare", rz))
                return
            if peer_epoch > cl.epoch and last and int(
                    last.get("epochFrom", -1)) == cl.epoch:
                # Peer finalized a resize we never heard of at all.
                self._apply_resize_message(msg("finalize", last))
        except Exception as e:  # noqa: BLE001 - convergence best-effort
            self.logger.printf("resize gossip catch-up skipped: %s", e)

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
        if self.resize_op is not None:
            out["resize"]["op"] = self.resize_op.status()
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
                      pod_local=False, deadline_s=None, query_id=None,
                      gens_out=None):
        return self.server.client_for(node.host).execute_query(
            node, index, query, slices, remote=remote,
            pod_local=pod_local, deadline_s=deadline_s,
            query_id=query_id, gens_out=gens_out)

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
