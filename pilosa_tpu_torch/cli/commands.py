"""Command logic of the port's CLI.

Copy of the JAX package's ``cli/commands.py`` (reference ctl/), 12 of
its 13 verbs, each with the JAX CLI's output byte for byte:

- ``server``: the TOML config file (``-c``) under the ``PILOSA_*``
  environment under the flags (``load_server_config``), with the JAX
  verb's flags for what this package runs — ``--log-path``,
  ``--tenants``, the ``--query.*`` bounds and caches, the cluster
  (``--cluster.hosts``, ``--cluster.type static|http|gossip``, the
  gossip port, seed and HMAC secret, ``--cluster.poll-interval``,
  ``--cluster.gen-staleness``), ``--anti-entropy.interval``, the
  ``--trace.*`` and ``--metrics.*`` switches, the operator surface's
  switches (blackbox, watchdog, history, sentinel, the continuous
  profiler, SLO), the ``[tier]`` section (the tier manager and its blob
  store) and ``--profile.cpu``/``--profile.cpu-time`` (a sampled host
  CPU profile written to a file) — plus ``--device`` (the
  card unless ``cpu``), ``--cost.dir`` (where the cost model's calibration is
  kept) and ``--fault.hedge`` (the hedged-read floor, which the JAX verb
  takes from ``[fault] hedge`` and ``PILOSA_FAULT_HEDGE`` only). An
  explicit switch-on of a subsystem this package does not run yet (a
  ``[backup] archive``) exits 2 naming its slice. SIGTERM dumps the
  flight recorder (when on), then closes the server as SIGINT does. ``gen-staleness`` is kept
  and has nothing to bound: every hit of the coordinator's cluster
  cache is validated by a probe;
- ``import`` (CSV ``row,col[,timestamp]`` bits, or ``column,value``
  with ``--field``) and ``export`` (CSV of every slice), both through
  the cluster client, to every owner of each slice;
- ``backup -o`` and ``restore -i/-f INPUT``: the frame-view tar of
  every slice of a view (client.backup_to / restore_from). Their
  archive faces (``--mode``, ``--list``, ``--gc``, ``--archive``) exit
  2 naming the backup slice;
- ``sort`` (CSV rows in fragment bit order, ctl/sort.go), ``bench``
  (random SetBits through HTTP, ctl/bench.go) and ``config`` (the
  default configuration as TOML);
- ``check`` (offline consistency check of fragment files, ``.cache``
  sidecars and ``.snapshotting`` leftovers; ``--deep`` is the offline
  storage scrub over data directories and files) and ``inspect`` (a
  fragment file's container and checksum summary). ``check --deep``
  verifies each blob-tier stub's objects against the manifest crcs and
  the reassembled footer digest; ``--archive`` exits 2, waiting for the
  backup slice.

- ``replay`` (obs.replay: re-issue a captured workload, or
  ``--shadow BASELINE CANDIDATE`` to compare result digests) and
  ``top`` (cli.top: the live fleet dashboard).

- ``resize`` (the operator face of the online resize: ``--add``,
  ``--remove`` or ``--hosts`` starts one on ``--host``, which
  coordinates; ``--abort``, ``--status``; ``--wait`` polls until it
  settles and exits 0 on done, 1 on aborted).
"""

from __future__ import annotations

import argparse
import csv
import datetime as dt
import mmap
import os
import random
import signal
import sys
import time
from typing import Optional

import numpy as np

from ..errors import TIME_FORMAT, PilosaError
from ..utils.config import CLUSTER_TYPES, parse_duration

IMPORT_BUFFER_SIZE = 10_000_000  # bits per import batch (ctl/import.go:58)


def load_server_config(args, env=None):
    """Config for the server verb with flags > env > file priority
    (reference cmd/root.go:99-153 viper merge; flags cmd/server.go:88-104):
    ``load`` applies defaults ← file ← env, explicit flags overlay last."""
    from ..utils import config as config_mod
    from ..utils.config import parse_bool, parse_tenants

    cfg = config_mod.load(args.config or "", env=env)
    if args.data_dir:
        cfg.data_dir = args.data_dir
    if args.bind:
        cfg.host = args.bind
    if args.plugins_path:
        cfg.plugins_path = args.plugins_path
    if args.log_path:
        cfg.log_path = args.log_path
    if args.cluster_hosts:
        cfg.cluster.hosts = [h.strip() for h in
                             args.cluster_hosts.split(",") if h.strip()]
    if args.cluster_internal_hosts:
        cfg.cluster.internal_hosts = [
            h.strip() for h in args.cluster_internal_hosts.split(",")
            if h.strip()]
    if args.cluster_replicas is not None:
        cfg.cluster.replica_n = args.cluster_replicas
    if args.cluster_type:
        cfg.cluster.type = args.cluster_type
    if args.cluster_internal_port:
        cfg.cluster.internal_port = args.cluster_internal_port
    if args.cluster_gossip_seed:
        cfg.cluster.gossip_seed = args.cluster_gossip_seed
    if args.cluster_gossip_secret:
        cfg.cluster.gossip_secret = args.cluster_gossip_secret
    if args.cluster_poll_interval is not None:
        cfg.cluster.polling_interval = args.cluster_poll_interval
    if args.anti_entropy_interval is not None:
        cfg.anti_entropy_interval = args.anti_entropy_interval
    for attr in ("concurrency", "queue_depth", "default_timeout",
                 "slow_threshold", "result_cache_entries",
                 "result_cache_bits", "cluster_cache_entries"):
        value = getattr(args, f"query_{attr}")
        if value is not None:
            setattr(cfg.query, attr, value)
    if args.tenants:
        cfg.tenants.table = parse_tenants(args.tenants)
    if args.cluster_gen_staleness is not None:
        cfg.cluster.gen_staleness = args.cluster_gen_staleness
    for section, attr in (("metrics", "enabled"), ("trace", "enabled"),
                          ("trace", "tail"), ("blackbox", "enabled"),
                          ("watchdog", "enabled"), ("metrics", "accounting"),
                          ("history", "enabled"), ("sentinel", "enabled"),
                          ("profile", "continuous")):
        value = getattr(args, f"{section}_{attr}")
        if value is not None:
            setattr(getattr(cfg, section), attr, parse_bool(value))
    if args.metrics_runtime_interval is not None:
        cfg.metrics.runtime_interval = args.metrics_runtime_interval
    if args.fault_hedge is not None:
        cfg.fault.hedge = args.fault_hedge
    if args.trace_max_traces is not None:
        cfg.trace.max_traces = args.trace_max_traces
    if args.sentinel_manifest:
        cfg.sentinel.manifest = args.sentinel_manifest
    if args.profile_hz is not None:
        cfg.profile.hz = args.profile_hz
    if args.slo_objective is not None:
        cfg.slo.objective = args.slo_objective
    if args.slo_target is not None:
        cfg.slo.target = args.slo_target
    return cfg


def cmd_server(args, stdout, stderr) -> int:
    """Serve one node until SIGINT or SIGTERM (reference
    server/server.go). The executor runs on the card unless ``--device
    cpu`` is given; without a card the verb prints the error and exits
    non-zero. Both signals close the server cleanly (barrier, snapshot,
    WAL close); an acked write survives SIGKILL too, through the WAL."""
    from ..cluster.topology import Cluster, Node
    from ..server.server import Server
    from ..utils import config as config_mod
    from ..utils import logger as logger_mod

    cfg = load_server_config(args)
    refused = config_mod.unported_switch_ons(cfg)
    if refused:
        for msg in refused:
            print(f"error: {msg}", file=stderr)
        return 2
    if cfg.log_path:
        logger = logger_mod.Logger.open(os.path.expanduser(cfg.log_path))
    else:
        logger = logger_mod.Logger(stderr)
    cluster = None
    if cfg.cluster.hosts:
        internal = cfg.cluster.internal_hosts or [""] * len(
            cfg.cluster.hosts)
        cluster = Cluster(nodes=[Node(h, internal_host=ih) for h, ih
                                 in zip(cfg.cluster.hosts, internal)],
                          replica_n=cfg.cluster.replica_n)
    if cfg.cluster.type == "gossip":
        from ..cluster.gossip import GossipNodeSet
        bind_host = cfg.host.rpartition(":")[0] or "localhost"
        gossip_set = GossipNodeSet(
            cfg.host, gossip_host=f"{bind_host}:{cfg.cluster.internal_port}",
            seeds=[cfg.cluster.gossip_seed] if cfg.cluster.gossip_seed
            else [],
            secret_key=cfg.cluster.gossip_secret or None, logger=logger)
        if cluster is None:
            cluster = Cluster(nodes=[Node(cfg.host)])
        cluster.node_set = gossip_set
    server = Server(os.path.expanduser(cfg.data_dir), host=cfg.host,
                    device=args.device, logger=logger,
                    query_config=cfg.query, tenants_config=cfg.tenants,
                    cal_dir=(os.path.expanduser(args.cost_dir)
                             if args.cost_dir else None),
                    cluster=cluster, cluster_type=cfg.cluster.type,
                    polling_interval=cfg.cluster.polling_interval,
                    anti_entropy_interval=cfg.anti_entropy_interval,
                    trace_config=cfg.trace, scrub_config=cfg.scrub,
                    metrics_config=cfg.metrics, fault_config=cfg.fault,
                    profile_config=cfg.profile, slo_config=cfg.slo,
                    blackbox_config=cfg.blackbox,
                    watchdog_config=cfg.watchdog,
                    history_config=cfg.history,
                    sentinel_config=cfg.sentinel,
                    capture_config=cfg.capture, tier_config=cfg.tier,
                    resize_pace_s=cfg.cluster.resize_pace,
                    resize_grace_s=cfg.cluster.resize_grace)

    def stop(signum, frame):
        raise KeyboardInterrupt

    # Installed before open: the flight recorder's SIGTERM hook chains
    # to it, so a SIGTERM dumps the recorder and then closes cleanly.
    signal.signal(signal.SIGTERM, stop)
    server.open()
    profiler = None
    if args.profile_cpu:
        from ..utils.profiling import CPUProfiler
        profiler = CPUProfiler(args.profile_cpu,
                               duration=args.profile_cpu_time)
        profiler.start()
    print(f"pilosa-tpu serving at http://{server.host} "
          f"(data: {cfg.data_dir})", file=stdout, flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        print("shutting down", file=stderr)
        if profiler is not None:
            profiler.stop()
        server.close()
        logger.close()
    return 0


def _parse_csv_bits(stream, start_rnum: int = 1):
    """CSV rows → (row, column, timestamp ns) triples, streamed, with the
    reference's per-row errors (ctl/import.go:119-180)."""
    for rnum, record in enumerate(csv.reader(stream), start_rnum):
        if not record or record[0] == "":
            continue
        if len(record) < 2:
            raise PilosaError(
                f"bad column count on row {rnum}: col={len(record)}")
        # Ids are unsigned 64-bit, as ParseUint reads them: a negative
        # or an overflow is the row's error.
        try:
            row_id = int(record[0])
            if not 0 <= row_id < 1 << 64:
                raise ValueError
        except ValueError:
            raise PilosaError(
                f"invalid row id on row {rnum}: {record[0]!r}")
        try:
            col_id = int(record[1])
            if not 0 <= col_id < 1 << 64:
                raise ValueError
        except ValueError:
            raise PilosaError(
                f"invalid column id on row {rnum}: {record[1]!r}")
        ts = 0
        if len(record) > 2 and record[2]:
            try:
                t = dt.datetime.strptime(record[2], TIME_FORMAT)
            except ValueError:
                raise PilosaError(
                    f"invalid timestamp on row {rnum}: {record[2]!r}")
            ts = int(t.replace(tzinfo=dt.timezone.utc).timestamp() * 1e9)
        yield row_id, col_id, ts


def _parse_csv_arrays(stream, chunk_lines: int):
    """CSV → (rows u64, cols u64, timestamps i64 or None) chunks of at
    most ``chunk_lines`` bits: strict ``digits,digits`` blocks through
    the native parser (storage.native.parse_csv_pairs), anything else
    through ``_parse_csv_bits``, which owns the per-row errors. Blocks
    are cut at line boundaries, so memory stays flat on large files."""
    from ..storage import native
    rnum = 1
    pending = ""
    block_chars = max(1 << 20, min(chunk_lines * 16, 64 << 20))
    eof = False
    while True:
        parts = [pending] if pending else []
        size = len(pending)
        has_nl = "\n" in pending
        while not eof and (size < block_chars or not has_nl):
            block = stream.read(block_chars)
            if not block:
                eof = True
            else:
                parts.append(block)
                size += len(block)
                has_nl = has_nl or "\n" in block
        pending = "".join(parts)
        if not pending:
            return
        if eof:
            chunk, pending = pending, ""
        else:
            cut = pending.rfind("\n")
            chunk, pending = pending[:cut + 1], pending[cut + 1:]
        n_chunk_lines = chunk.count("\n") + (not chunk.endswith("\n"))
        parsed = native.parse_csv_pairs(chunk.encode())
        if parsed is not None and len(parsed[0]):
            rows, cols = parsed
            for i in range(0, len(rows), chunk_lines):
                yield rows[i:i + chunk_lines], cols[i:i + chunk_lines], None
        else:
            bits = list(_parse_csv_bits(iter(chunk.splitlines(True)),
                                        start_rnum=rnum))
            for i in range(0, len(bits), chunk_lines):
                group = np.array(bits[i:i + chunk_lines],
                                 dtype=object).reshape(-1, 3)
                yield (group[:, 0].astype(np.uint64),
                       group[:, 1].astype(np.uint64),
                       group[:, 2].astype(np.int64))
        rnum += n_chunk_lines


def _parse_csv_field_values(stream, chunk_lines: int):
    """``column,value`` CSV → (cols u64, vals i64) chunks for the BSI
    field import (values may be negative)."""
    cols: list[int] = []
    vals: list[int] = []
    for rnum, record in enumerate(csv.reader(stream), 1):
        if not record or record[0] == "":
            continue
        if len(record) != 2:
            raise PilosaError(
                f"bad column count on row {rnum}: col={len(record)}")
        try:
            col = int(record[0])
            if not 0 <= col < 1 << 64:
                raise ValueError
        except ValueError:
            raise PilosaError(
                f"invalid column id on row {rnum}: {record[0]!r}")
        try:
            val = int(record[1])
            if not -(1 << 63) <= val < 1 << 63:
                raise ValueError
        except ValueError:
            raise PilosaError(f"invalid value on row {rnum}: {record[1]!r}")
        cols.append(col)
        vals.append(val)
        if len(cols) >= chunk_lines:
            yield (np.array(cols, dtype=np.uint64),
                   np.array(vals, dtype=np.int64))
            cols, vals = [], []
    if cols:
        yield np.array(cols, dtype=np.uint64), np.array(vals, dtype=np.int64)


def cmd_import(args, stdout, stderr) -> int:
    """Bulk-import CSV files ('-' for stdin) through the cluster
    client: each slice's block goes to every owner."""
    from ..cluster.client import Client
    client = Client(args.host)

    def import_stream(stream):
        if args.field:
            for cols, vals in _parse_csv_field_values(stream,
                                                      IMPORT_BUFFER_SIZE):
                print(f"importing {len(cols)} values", file=stderr)
                client.import_field_values(args.index, args.frame,
                                           args.field, cols, vals)
            return
        for rows, cols, ts in _parse_csv_arrays(stream, IMPORT_BUFFER_SIZE):
            print(f"importing {len(rows)} bits", file=stderr)
            client.import_arrays(args.index, args.frame, rows, cols, ts)

    try:
        for path in args.paths:
            print(f"parsing: {path}", file=stderr)
            if path == "-":
                import_stream(sys.stdin)
            else:
                with open(path, newline="") as f:
                    import_stream(f)
    finally:
        client.close()
    return 0


def cmd_export(args, stdout, stderr) -> int:
    """Every slice of a frame's view as CSV, each from one of its
    owners (failing over to the next)."""
    from ..cluster.client import Client
    client = Client(args.host)
    try:
        max_slice = client.max_slices().get(args.index, 0)
        for slice in range(max_slice + 1):
            client.export_csv_to(stdout, args.index, args.frame,
                                 args.view, slice)
    finally:
        client.close()
    return 0


def _archive_face(verb: str, face: str, stderr) -> int:
    print(f"{verb} {face}: cluster backup archives are not available in"
          " this package yet (item 7, the backup slice)", file=stderr)
    return 2


def cmd_backup(args, stdout, stderr) -> int:
    """The frame-view tar dump (-i/-f/-o, ctl/backup.go): every slice of
    the view, each from one of its owners, as one tar entry named by
    the slice id. The archive faces (--mode, --list, --gc) wait for the
    backup slice and exit 2."""
    for face, on in (("--list", args.list), ("--gc", args.gc),
                     ("--mode", args.mode)):
        if on:
            return _archive_face("backup", face, stderr)
    if not (args.index and args.frame and args.output):
        print("backup: either --mode (cluster archive backup),"
              " --archive with --list/--gc, or -i/-f/-o (frame-view"
              " tar)", file=stderr)
        return 1
    from ..cluster.client import Client
    client = Client(args.host)
    try:
        with open(args.output, "wb") as f:
            client.backup_to(f, args.index, args.frame, args.view)
    finally:
        client.close()
    return 0


def cmd_restore(args, stdout, stderr) -> int:
    """The frame-view tar restore (-i/-f INPUT, ctl/restore.go): each
    slice entry of a ``backup -o`` tar to every owner of the slice. The
    archive restore (--archive) waits for the backup slice and exits
    2."""
    if args.archive:
        return _archive_face("restore", "--archive", stderr)
    if not (args.index and args.frame and args.input):
        print("restore: either --archive (archive restore) or"
              " -i/-f INPUT (frame-view tar)", file=stderr)
        return 1
    from ..cluster.client import Client
    client = Client(args.host)
    try:
        with open(args.input, "rb") as f:
            client.restore_from(f, args.index, args.frame, args.view)
    finally:
        client.close()
    return 0


def cmd_sort(args, stdout, stderr) -> int:
    """CSV rows sorted by fragment bit position (ctl/sort.go:49-106). The
    key (slice, row*W + col%W) is lexicographic (slice, row, col%W),
    which lexsort computes without the u64 overflow of row*W."""
    from .. import SLICE_WIDTH
    with open(args.path, newline="") as f:
        chunks = list(_parse_csv_arrays(f, IMPORT_BUFFER_SIZE))
    if not chunks:
        return 0
    rows = np.concatenate([c[0] for c in chunks])
    cols = np.concatenate([c[1] for c in chunks])
    ts = np.concatenate([c[2] if c[2] is not None
                         else np.zeros(len(c[0]), dtype=np.int64)
                         for c in chunks])
    w = np.uint64(SLICE_WIDTH)
    order = np.lexsort((cols % w, rows, cols // w))
    for i in order:
        if ts[i]:
            t = dt.datetime.fromtimestamp(ts[i] / 1e9, dt.timezone.utc)
            stdout.write(f"{rows[i]},{cols[i]},"
                         f"{t.strftime(TIME_FORMAT)}\n")
        else:
            stdout.write(f"{rows[i]},{cols[i]}\n")
    return 0


def cmd_bench(args, stdout, stderr) -> int:
    """Random SetBit throughput through the full HTTP stack
    (ctl/bench.go:53-102): the JAX CLI's seeded rows and columns."""
    from ..cluster.client import Client
    if args.op != "set-bit":
        print(f"unknown bench op: {args.op!r}", file=stderr)
        return 1
    client = Client(args.host)
    max_row_id, max_column_id = 1000, 100000
    rng = random.Random(0)
    try:
        start = time.perf_counter()
        for _ in range(args.n):
            row = rng.randrange(max_row_id)
            col = rng.randrange(max_column_id)
            client.execute_query(
                None, args.index,
                f'SetBit(rowID={row}, frame="{args.frame}",'
                f' columnID={col})', remote=False)
        elapsed = time.perf_counter() - start
    finally:
        client.close()
    print(f"Executed {args.n} operations in {elapsed:.3f}s "
          f"({args.n / elapsed:0.3f} op/sec)", file=stdout)
    return 0


def cmd_replay(args, stdout, stderr) -> int:
    """Re-issue a captured workload: records come from a file
    (--records) or a live cluster-merged export (--from / --host),
    replay preserves arrival gaps scaled by --rate xN, and --shadow
    BASELINE CANDIDATE switches to the digest-comparing differential
    mode (rc 1 on any mismatch)."""
    import json as json_mod

    from ..obs import replay as obs_replay

    if args.records:
        records = obs_replay.load_records(args.records)
    else:
        source = args.from_host or args.host
        records = obs_replay.fetch_records(source, cluster=True)
    if not records:
        print("no capture records to replay", file=stderr)
        return 1
    rate = args.rate.lstrip("xX") or "1"
    try:
        rate = float(rate)
    except ValueError:
        print(f"invalid --rate: {args.rate!r}", file=stderr)
        return 1
    if args.shadow:
        out = obs_replay.shadow(records, args.shadow[0], args.shadow[1],
                                senders=args.senders)
    else:
        out = obs_replay.replay(records, args.host, rate=rate,
                                processes=args.processes,
                                senders=args.senders)
    body = json_mod.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(body + "\n")
    print(body, file=stdout)
    if args.shadow and out["mismatches"]:
        return 1
    return 0


def cmd_config(args, stdout, stderr) -> int:
    from ..utils.config import Config
    stdout.write(Config().to_toml())
    return 0


def _mmap_bitmap(path: str):
    from ..storage import roaring
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    return roaring.Bitmap.unmarshal(mm, mapped=True), mm


def _fragment_files(path: str) -> list[str]:
    """Fragment data files under a data dir (or the path itself when
    it IS a file): numeric names inside a ``fragments`` directory —
    the holder layout <index>/<frame>/views/<view>/fragments/<slice>."""
    if not os.path.isdir(path):
        return [path]
    out = []
    for root, _dirs, files in os.walk(path):
        if os.path.basename(root) != "fragments":
            continue
        for name in sorted(files):
            if name.isdigit():
                out.append(os.path.join(root, name))
    return out


def _blob_stubs(path: str) -> list[str]:
    """``<slice>.blob`` stub files under a data dir — fragments whose
    bytes live in the blob tier (tier)."""
    if not os.path.isdir(path):
        return [path] if path.endswith(".blob") else []
    out = []
    for root, _dirs, files in os.walk(path):
        if os.path.basename(root) != "fragments":
            continue
        for name in sorted(files):
            if name.endswith(".blob") and name[:-5].isdigit():
                out.append(os.path.join(root, name))
    return out


def _blob_store_for(stub_path: str):
    """The blob store a stub's objects live in: the PILOSA_TIER_BLOB /
    PILOSA_TIER_COLD_DIR settings when present (the knobs the server
    reads), else the default layout — a ``_tier/blob`` dir under an
    ancestor of the stub (the data dir). None when none is found."""
    from ..tier import blob as blob_mod
    spec = os.environ.get("PILOSA_TIER_BLOB", "")
    cold = os.environ.get("PILOSA_TIER_COLD_DIR", "")
    if spec.startswith("dir:"):
        return blob_mod.LocalDirBlobStore(spec[len("dir:"):])
    if cold and os.path.isdir(os.path.join(cold, "blob")):
        return blob_mod.LocalDirBlobStore(os.path.join(cold, "blob"))
    probe = os.path.dirname(os.path.abspath(stub_path))
    for _ in range(8):
        root = os.path.join(probe, "_tier", "blob")
        if os.path.isdir(root):
            return blob_mod.LocalDirBlobStore(root)
        parent = os.path.dirname(probe)
        if parent == probe:
            break
        probe = parent
    return None


def _check_deep(args, stdout, stderr) -> int:
    """Offline storage scrub (the CLI face of storage.scrub): verify
    every snapshot footer (per-block crc32 table + whole-body digest)
    and WAL-tail FNV checksums under the given data dirs / files, one
    verdict line per fragment; nonzero exit on ANY corruption.
    ``.corrupt`` aside files (quarantine forensics / pending-repair
    sentinels) are reported too. Blob-tier stubs (``<slice>.blob``) are
    walked as well: each fragment's blob objects verify against the
    manifest crcs and the reassembled footer digest — cold-tier files
    are ordinary footered snapshots and take the normal lane."""
    import json as _json

    from ..storage import scrub as scrub_mod
    from ..tier import blob as blob_mod
    rc = 0
    n = corrupt = vintage = 0
    for path in args.paths:
        files = _fragment_files(path)
        stubs = _blob_stubs(path)
        if not files and not stubs:
            print(f"{path}: no fragment files found", file=stdout)
        for f in files:
            n += 1
            v = scrub_mod.scrub_file(f)
            if v.get("corrupt"):
                corrupt += 1
                rc = 1
                print(f"{f}: CORRUPT: {v.get('error')}", file=stdout)
            else:
                cov = v.get("coverage")
                if cov != "full":
                    vintage += 1
                extra = ""
                if v.get("walTornBytes"):
                    extra = (f", torn tail {v['walTornBytes']}B"
                             " (trimmed on next open)")
                print(f"{f}: ok ({cov} coverage,"
                      f" {v.get('blocks', 0)} blocks,"
                      f" {v.get('walRecords', 0)} wal records{extra})",
                      file=stdout)
            if os.path.exists(f + ".corrupt"):
                print(f"{f}.corrupt: quarantine forensics present"
                      f" (fragment pending repair)", file=stdout)
        for s in stubs:
            n += 1
            try:
                with open(s, "r", encoding="utf-8") as fh:
                    stub = _json.load(fh)
                prefix = stub["prefix"]
            except (OSError, ValueError, KeyError) as e:
                corrupt += 1
                rc = 1
                print(f"{s}: CORRUPT: unreadable blob stub: {e}",
                      file=stdout)
                continue
            store = _blob_store_for(s)
            if store is None:
                # A stub without a reachable store (a moved dir): report
                # it, never guess at a verdict.
                print(f"{s}: blob stub ({stub.get('size', '?')}B at"
                      f" {prefix}; no local blob store found —"
                      f" skipped)", file=stdout)
                continue
            v = blob_mod.verify_fragment(store, prefix)
            if v.get("corrupt"):
                corrupt += 1
                rc = 1
                print(f"{s}: CORRUPT (blob {prefix}):"
                      f" {v.get('error')}", file=stdout)
            else:
                print(f"{s}: ok (blob tier, {v.get('blocks', 0)}"
                      f" blocks at {prefix})", file=stdout)
    print(f"checked {n} fragments: {corrupt} corrupt,"
          f" {vintage} without footers", file=stdout)
    return rc


def cmd_resize(args, stdout, stderr) -> int:
    """Operator face of the online resize (docs/CLUSTER_RESIZE.md):
    POST /cluster/resize on any member to start/abort, GET to watch."""
    import json as json_mod
    import urllib.request

    def get_status():
        with urllib.request.urlopen(
                f"http://{args.host}/cluster/resize", timeout=10) as r:
            return json_mod.loads(r.read())

    def post(body: dict):
        req = urllib.request.Request(
            f"http://{args.host}/cluster/resize",
            data=json_mod.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json_mod.loads(r.read())

    if args.status:
        print(json_mod.dumps(get_status(), indent=1), file=stdout)
        return 0
    if args.abort:
        print(json_mod.dumps(post({"abort": True}), indent=1),
              file=stdout)
        return 0
    body: dict = {}
    if args.hosts:
        body["hosts"] = [h.strip() for h in args.hosts.split(",")
                         if h.strip()]
    elif args.add:
        body["add"] = args.add
    elif args.remove:
        body["remove"] = args.remove
    else:
        print("resize: one of --add/--remove/--hosts/--abort/--status"
              " required", file=stderr)
        return 1
    status = post(body)
    print(json_mod.dumps(status, indent=1), file=stdout)
    if not args.wait:
        return 0
    rid = (status.get("op") or {}).get("id") or status.get("id")
    # Transient poll failures (a node busy streaming, a coordinator
    # restart mid-recovery) keep waiting; only a sustained outage or
    # the overall deadline gives up. An absent op is NOT terminal —
    # journal recovery re-registers it.
    deadline = time.time() + 1800
    misses = 0
    while time.time() < deadline:
        time.sleep(0.5)
        try:
            s = get_status()
        except Exception as e:  # noqa: BLE001 - transient poll error
            misses += 1
            if misses >= 60:
                print(f"resize {rid}: status unreachable: {e}",
                      file=stderr)
                return 1
            continue
        misses = 0
        op = s.get("op") or {}
        phase = op.get("phase", "")
        print(f"resize {rid}: {phase or '(pending)'} "
              f"(slices={op.get('slicesMoved', 0)},"
              f" bytes={op.get('bytesStreamed', 0)})", file=stdout,
              flush=True)
        if phase in ("done", "aborted"):
            return 0 if phase == "done" else 1
    print(f"resize {rid}: wait timed out", file=stderr)
    return 1


def cmd_check(args, stdout, stderr) -> int:
    """Offline consistency check of fragment files (ctl/check.go:46-113):
    ``Bitmap.check()`` validates every container kind, the run
    invariants included. ``--deep`` runs the offline storage scrub
    (footer + WAL checksums) and accepts whole data DIRS; ``--archive``
    (a backup archive) waits for the backup slice and exits 2."""
    from ..proto import internal as pb
    if args.deep:
        if args.archive:
            print("check --deep --archive: backup archives are not"
                  " available in this package yet (the backup slice)",
                  file=stderr)
            return 2
        return _check_deep(args, stdout, stderr)
    if not args.paths:
        print("check: paths required (or --deep --archive)",
              file=stderr)
        return 1
    rc = 0
    for path in args.paths:
        if path.endswith(".cache"):
            try:
                with open(path, "rb") as f:
                    pb.Cache.FromString(f.read())
                print(f"{path}: ok", file=stdout)
            except pb.DecodeError:
                # The protobuf runtime's text, as the JAX CLI prints it.
                print(f"{path}: Error parsing message with type"
                      " 'internal.Cache'", file=stdout)
                rc = 1
            except Exception as e:  # noqa: BLE001 - reported per file
                print(f"{path}: {e}", file=stdout)
                rc = 1
            continue
        if path.endswith(".snapshotting"):
            print(f"{path}: snapshot file found (incomplete snapshot)",
                  file=stdout)
            continue
        try:
            bm, mm = _mmap_bitmap(path)
            bm.check()
            bm.unmap()
            print(f"{path}: ok", file=stdout)
        except Exception as e:  # noqa: BLE001 - reported per file
            print(f"{path}: {e}", file=stdout)
            rc = 1
    return rc


def cmd_inspect(args, stdout, stderr) -> int:
    """Container stats dump (ctl/inspect.go:48-105) with the per-kind
    summary (counts, run intervals, resident bytes) and the checksum
    coverage of the integrity footer."""
    bm, mm = _mmap_bitmap(args.path)
    stats = bm.container_stats()
    print("== Bitmap Info ==", file=stdout)
    print(f"Containers: {len(bm.containers)}", file=stdout)
    print(f"Operations: {bm.op_n}", file=stdout)
    footer = bm.footer
    if footer is not None:
        print(f"Checksums: footer v{footer.version}"
              f" ({footer.block_n} block crc32s,"
              f" {footer.body_len} body bytes covered)", file=stdout)
    else:
        print("Checksums: none (vintage snapshot — scrub blind;"
              " rewritten with a footer on next snapshot)",
              file=stdout)
    print("", file=stdout)
    print("== Container Types ==", file=stdout)
    print(f"{'TYPE':>6} {'COUNT':>8} {'INTERVALS':>10} {'BYTES':>10}",
          file=stdout)
    for kind in ("array", "bitmap", "run"):
        ivals = stats["intervals"].get(kind, 0)
        print(f"{kind:>6} {stats['counts'][kind]:>8}"
              f" {ivals:>10} {stats['bytes'][kind]:>10}", file=stdout)
    print("", file=stdout)
    print("== Containers ==", file=stdout)
    print(f"{'KEY':>12} {'TYPE':>6} {'N':>8} {'RUNS':>6}", file=stdout)
    for key, c in zip(bm.keys, bm.containers):
        n_runs = ((len(c.runs) - 1) >> 1) if c.runs is not None else 0
        print(f"{int(key):>12} {c.kind():>6} {c.n:>8} {n_runs:>6}",
              file=stdout)
    bm.unmap()
    return 0


def build_parser() -> argparse.ArgumentParser:
    from .. import __version__
    p = argparse.ArgumentParser(
        prog="pilosa-tpu-torch",
        description=f"bitmap index on one NVIDIA card"
                    f" (version {__version__})")
    p.add_argument("--version", action="version",
                   version=f"pilosa-tpu-torch {__version__}")
    sub = p.add_subparsers(dest="command", required=True)

    # The server flag surface (reference cmd/server.go:88-104).
    s = sub.add_parser("server", help="run a pilosa-tpu-torch node")
    s.add_argument("-d", "--data-dir", default="")
    s.add_argument("-b", "--bind", default="",
                   help="host:port to listen on (default localhost:10101)")
    s.add_argument("-c", "--config", default="", help="TOML config file")
    s.add_argument("--device", default=None,
                   help="torch device of the executor (default the card,"
                        " cuda:0; 'cpu' runs every kernel's plain version"
                        " on the host)")
    s.add_argument("--cost.dir", dest="cost_dir", default="",
                   metavar="DIR",
                   help="directory that keeps the cost model's"
                        " calibration of this host and card (default:"
                        " measured at first device use, not kept)")
    s.add_argument("--log-path", dest="log_path", default="",
                   help="log file path (default stderr)")
    s.add_argument("--cluster.replicas", dest="cluster_replicas",
                   type=int, default=None, metavar="N",
                   help="number of hosts each piece of data is stored on")
    s.add_argument("--cluster.hosts", dest="cluster_hosts", default="",
                   help="comma-separated list of hosts in cluster")
    s.add_argument("--cluster.internal-hosts",
                   dest="cluster_internal_hosts", default="",
                   help="comma-separated internal-communication hosts")
    s.add_argument("--cluster.type", dest="cluster_type", default="",
                   choices=CLUSTER_TYPES,
                   help="cluster membership backend")
    s.add_argument("--cluster.internal-port", dest="cluster_internal_port",
                   default="", help="internal state-sharing (gossip) port")
    s.add_argument("--cluster.gossip-secret", dest="cluster_gossip_secret",
                   default="", help="shared HMAC key authenticating gossip"
                   " frames (unset = unauthenticated)")
    s.add_argument("--cluster.gossip-seed", dest="cluster_gossip_seed",
                   default="", help="host:port to seed gossip membership")
    s.add_argument("--cluster.poll-interval", dest="cluster_poll_interval",
                   type=parse_duration, default=None, metavar="DUR",
                   help="max-slice polling interval (e.g. 60s)")
    s.add_argument("--query.concurrency", dest="query_concurrency",
                   type=int, default=None, metavar="N",
                   help="max queries executing concurrently"
                        " (admission cap, default 16)")
    s.add_argument("--query.queue-depth", dest="query_queue_depth",
                   type=int, default=None, metavar="N",
                   help="max queries waiting for a slot before the"
                        " server answers 429 (default 64)")
    s.add_argument("--query.default-timeout",
                   dest="query_default_timeout", type=parse_duration,
                   default=None, metavar="DUR",
                   help="deadline applied to queries that carry no"
                        " ?timeout= or X-Pilosa-Deadline (0 = none)")
    s.add_argument("--query.slow-threshold",
                   dest="query_slow_threshold", type=parse_duration,
                   default=None, metavar="DUR",
                   help="log queries slower than this with per-stage"
                        " timings (0 = disabled)")
    s.add_argument("--query.result-cache-entries",
                   dest="query_result_cache_entries", type=int,
                   default=None, metavar="N",
                   help="materialized-result residency cache entry"
                        " bound (0 disables, default 8)")
    s.add_argument("--query.result-cache-bits",
                   dest="query_result_cache_bits", type=int,
                   default=None, metavar="N",
                   help="materialized-result residency cache total"
                        " cached-bit bound (default 33554432)")
    s.add_argument("--query.cluster-cache-entries",
                   dest="query_cluster_cache_entries", type=int,
                   default=None, metavar="N",
                   help="coordinator hot-query result cache entry"
                        " bound (0 disables, default 64)")
    s.add_argument("--tenants", dest="tenants", default="",
                   metavar="SPEC",
                   help="per-tenant QoS table, compact form:"
                        " 'default:weight=4,concurrency=8;"
                        "bulk:weight=1,max-wall=2s' — same keys as"
                        " the [tenants] TOML table (a 'default'"
                        " entry is required)")
    s.add_argument("--cluster.gen-staleness",
                   dest="cluster_gen_staleness", type=parse_duration,
                   default=None, metavar="DUR",
                   help="generation-map staleness bound for"
                        " remote-slice cache keys (default 2s)")
    s.add_argument("--anti-entropy.interval", dest="anti_entropy_interval",
                   type=parse_duration, default=None, metavar="DUR",
                   help="anti-entropy sweep interval (e.g. 10m)")
    s.add_argument("--metrics.enabled", dest="metrics_enabled",
                   default=None, metavar="BOOL",
                   help="serve Prometheus /metrics + feed the registry"
                        " from every stats call site (default true)")
    s.add_argument("--metrics.runtime-interval",
                   dest="metrics_runtime_interval", type=parse_duration,
                   default=None, metavar="DUR",
                   help="runtime collector sampling interval"
                        " (default 10s)")
    s.add_argument("--fault.hedge", dest="fault_hedge",
                   type=parse_duration, default=None, metavar="DUR",
                   help="hedged-read floor: a second replica leg fires"
                        " when the first exceeds max(DUR, the peer's"
                        " latency tail) (default 0, off)")
    s.add_argument("--trace.enabled", dest="trace_enabled",
                   default=None, metavar="BOOL",
                   help="trace every query (default false; any single"
                        " request can opt in with ?trace=1)")
    s.add_argument("--trace.tail", dest="trace_tail",
                   default=None,
                   help="tail-sampled tracing: every query buffers"
                        " spans; slow/errored/faulted ones persist"
                        " (default true)")
    s.add_argument("--blackbox.enabled", dest="blackbox_enabled",
                   default=None,
                   help="blackbox flight recorder (default true)")
    s.add_argument("--history.enabled", dest="history_enabled",
                   default=None,
                   help="on-disk metric history under the data dir"
                        " (default true)")
    s.add_argument("--sentinel.enabled", dest="sentinel_enabled",
                   default=None,
                   help="regression sentinel over the metric history"
                        " (default true)")
    s.add_argument("--sentinel.manifest", dest="sentinel_manifest",
                   default="", metavar="PATH",
                   help="benchmarks/MANIFEST.json whose committed"
                        " envelope live latencies must stay inside")
    s.add_argument("--watchdog.enabled", dest="watchdog_enabled",
                   default=None,
                   help="stall watchdog (default true)")
    s.add_argument("--trace.max-traces", dest="trace_max_traces",
                   type=int, default=None, metavar="N",
                   help="recent traces kept per node for /debug/traces"
                        " (default 64)")
    s.add_argument("--metrics.accounting", dest="metrics_accounting",
                   default=None, metavar="BOOL",
                   help="per-query cost ledgers (?profile=1,"
                        " X-Pilosa-Stats; default true)")
    s.add_argument("--profile.continuous", dest="profile_continuous",
                   default=None, metavar="BOOL",
                   help="always-on low-Hz wall profiler behind"
                        " /debug/pprof/flame (default true)")
    s.add_argument("--profile.hz", dest="profile_hz", type=float,
                   default=None, metavar="HZ",
                   help="continuous-profiler sampling rate"
                        " (default 10)")
    s.add_argument("--slo.objective", dest="slo_objective",
                   type=parse_duration, default=None, metavar="DUR",
                   help="latency objective for burn-rate gauges"
                        " (default 250ms)")
    s.add_argument("--slo.target", dest="slo_target", type=float,
                   default=None, metavar="FRACTION",
                   help="fraction of queries that must meet the"
                        " objective (default 0.99)")
    # Profiling flags (reference cmd/server.go:47-62,99-100).
    s.add_argument("--profile.cpu", dest="profile_cpu", default="",
                   metavar="PATH",
                   help="write a sampled CPU profile to PATH")
    s.add_argument("--plugins.path", dest="plugins_path", default="",
                   help="path to plugin directory (accepted but inert, "
                        "as in the reference at this vintage)")
    s.add_argument("--profile.cpu-time", dest="profile_cpu_time",
                   type=parse_duration, default=30.0, metavar="DUR",
                   help="duration of the CPU profile (default 30s)")
    s.set_defaults(fn=cmd_server)

    def client_cmd(name, help, fn, **extra):
        c = sub.add_parser(name, help=help)
        c.add_argument("--host", default="localhost:10101")
        c.add_argument("-i", "--index", required=extra.get("index", True))
        c.add_argument("-f", "--frame", required=extra.get("frame", True))
        c.set_defaults(fn=fn)
        return c

    c = client_cmd("import", "bulk-import CSV bits", cmd_import)
    c.add_argument("--field", default="",
                   help="import column,value rows into this BSI"
                        " integer field instead of bits")
    c.add_argument("paths", nargs="+", help="CSV files ('-' for stdin)")
    c = client_cmd("export", "export a frame's view as CSV", cmd_export)
    c.add_argument("--view", default="standard")

    c = client_cmd("backup", "cluster backup into the archive, or a"
                             " frame-view tar dump", cmd_backup,
                   index=False, frame=False)
    c.add_argument("--view", default="standard")
    c.add_argument("-o", "--output", default="",
                   help="frame-view tar mode: output file")
    c.add_argument("--mode", default="", choices=["full", "incremental"],
                   help="cluster archive backup (not available in this"
                        " package yet)")
    c.add_argument("--wait", action="store_true",
                   help="with --mode: poll until the backup settles")
    c.add_argument("--archive", default="",
                   help="offline archive spec (dir:/path) for"
                        " --list/--gc")
    c.add_argument("--list", action="store_true",
                   help="list committed backups in --archive")
    c.add_argument("--gc", action="store_true",
                   help="run archive retention GC against --archive")
    c.add_argument("--keep", type=int, default=2, metavar="N",
                   help="GC: full backups to keep (default 2, min 1)")
    c.add_argument("--dry-run", action="store_true",
                   help="GC: print the plan, delete nothing")
    c.add_argument("--sweep-orphans", action="store_true",
                   help="GC: also delete pool objects no committed"
                        " manifest references")

    c = client_cmd("restore", "restore from the backup archive, or a"
                              " frame-view tar", cmd_restore,
                   index=False, frame=False)
    c.add_argument("--view", default="standard")
    c.add_argument("input", nargs="?", default="",
                   help="frame-view tar mode: input file")
    c.add_argument("--archive", default="",
                   help="archive spec (dir:/path): restore the cluster"
                        " at --host from it (not available in this"
                        " package yet)")
    c.add_argument("--id", default="",
                   help="restore this backup id (default: newest"
                        " usable)")
    c.add_argument("--to-timestamp", dest="to_timestamp",
                   type=float, default=None, metavar="EPOCH",
                   help="point-in-time cut: replay archived WAL only"
                        " up to this unix timestamp")
    c.add_argument("--verify", default="",
                   help="after restoring, replay this captured-"
                        "workload records file and compare result"
                        " digests")

    c = sub.add_parser("sort", help="sort CSV by fragment position")
    c.add_argument("path")
    c.set_defaults(fn=cmd_sort)

    c = sub.add_parser("check", help="consistency-check fragment files")
    c.add_argument("paths", nargs="*")
    c.add_argument("--deep", action="store_true",
                   help="offline storage scrub: verify snapshot"
                        " footers (block crc32s + body digest) and"
                        " WAL-tail checksums; accepts data DIRS;"
                        " nonzero exit on corruption")
    c.add_argument("--archive", default="",
                   help="with --deep: walk an offline backup archive"
                        " (not available in this package yet)")
    c.set_defaults(fn=cmd_check)

    c = sub.add_parser("inspect", help="dump container stats of a file")
    c.add_argument("path")
    c.set_defaults(fn=cmd_inspect)

    c = client_cmd("bench", "run benchmarks against a server", cmd_bench)
    c.add_argument("--op", default="", help="benchmark operation"
                                            " (set-bit)")
    c.add_argument("-n", type=int, default=0, help="operation count")

    c = sub.add_parser(
        "top", help="live fleet dashboard over the federation"
                    " endpoints")
    c.add_argument("--host", default="localhost:10101",
                   help="any cluster member (it federates the fleet)")
    c.add_argument("--interval", type=parse_duration, default=2.0,
                   metavar="DUR", help="poll interval (default 2s)")
    c.add_argument("--window", default="10m", metavar="DUR",
                   help="history window for the sparkline"
                        " (default 10m)")
    c.add_argument("--once", action="store_true",
                   help="render one frame and exit (scripts, tests)")
    from .top import cmd_top
    c.set_defaults(fn=cmd_top)

    c = sub.add_parser(
        "resize", help="drive / inspect an elastic cluster resize")
    c.add_argument("--host", default="localhost:10101",
                   help="any current cluster member (it coordinates)")
    c.add_argument("--add", default="",
                   help="host:port joining the cluster")
    c.add_argument("--remove", default="",
                   help="host:port leaving the cluster")
    c.add_argument("--hosts", default="",
                   help="explicit target membership (comma-separated;"
                        " overrides --add/--remove)")
    c.add_argument("--abort", action="store_true",
                   help="abort the in-flight resize")
    c.add_argument("--status", action="store_true",
                   help="print resize status and exit")
    c.add_argument("--wait", action="store_true",
                   help="poll until the resize settles")
    c.set_defaults(fn=cmd_resize)

    c = sub.add_parser(
        "replay", help="re-issue a captured workload against a"
                       " cluster")
    c.add_argument("--host", default="localhost:10101",
                   help="replay target (also the default capture"
                        " export source)")
    c.add_argument("--records", default="",
                   help="records file (JSONL or a saved"
                        " /debug/capture/records response); default:"
                        " export live from --from")
    c.add_argument("--from", dest="from_host", default="",
                   help="export the capture stream from this node"
                        " (cluster-merged) instead of a file;"
                        " defaults to --host")
    c.add_argument("--rate", default="x1", metavar="xN",
                   help="arrival-gap compression (x1 = recorded rate,"
                        " x10 = 10x faster)")
    c.add_argument("--processes", type=int, default=1,
                   help="sender processes (open-loop shards)")
    c.add_argument("--senders", type=int, default=32,
                   help="sender threads per process")
    c.add_argument("--shadow", nargs=2,
                   metavar=("BASELINE", "CANDIDATE"),
                   help="differential replay: writes to both in"
                        " order, reads compared by result digest")
    c.add_argument("--out", default="",
                   help="write the summary JSON here as well")
    c.set_defaults(fn=cmd_replay)

    c = sub.add_parser("config", help="print default configuration")
    c.set_defaults(fn=cmd_config)
    return p


def main(argv: Optional[list[str]] = None, stdout=None, stderr=None) -> int:
    stdout = stdout or sys.stdout
    stderr = stderr or sys.stderr
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args, stdout, stderr)
    except (PilosaError, RuntimeError) as e:
        # RuntimeError: no card, and no other device asked for.
        print(f"error: {e}", file=stderr)
        return 1
