"""Command logic of the port's CLI.

Trimmed copy of the JAX package's ``cli/commands.py`` (reference ctl/):

- ``server`` with ``-d/--data-dir``, ``-b/--bind``, ``--device``, the
  admission bounds (``--query.concurrency``, ``--query.queue-depth``),
  ``--cost.dir`` (where the cost model's calibration is kept), and the
  static cluster: ``--cluster.hosts a,b,c`` (this node's ``--bind``
  among them), ``--cluster.replicas``, ``--cluster.type static|http``
  (``gossip`` is refused until the gossip slice),
  ``--cluster.poll-interval``, ``--anti-entropy.interval`` and
  ``--trace.tail``; the ``PILOSA_TRACE_*`` and ``PILOSA_SCRUB_*``
  environment keys set the tail sampler and the storage scrubber and
  repairer, as in the JAX package;
- ``import`` (CSV ``row,col[,timestamp]`` bits, or ``column,value``
  with ``--field``) and ``export`` (CSV of every slice), both through
  the cluster client, to every owner of each slice;
- ``check`` (offline consistency check of fragment files, ``.cache``
  sidecars and ``.snapshotting`` leftovers; ``--deep`` is the offline
  storage scrub over data directories and files) and ``inspect`` (a
  fragment file's container and checksum summary), whose output is the
  JAX CLI's byte for byte. ``check --deep`` exits 2 on a blob-tier stub
  and on ``--archive``, which wait for the tier and backup slices.

The TOML config file and the other verbs wait for later slices.
"""

from __future__ import annotations

import argparse
import csv
import datetime as dt
import mmap
import os
import signal
import sys
import time
from typing import Optional

import numpy as np

from ..errors import TIME_FORMAT, PilosaError
from ..utils.config import CLUSTER_TYPES, ClusterConfig, parse_duration

IMPORT_BUFFER_SIZE = 10_000_000  # bits per import batch (ctl/import.go:58)


def cmd_server(args, stdout, stderr) -> int:
    """Serve one node until SIGINT or SIGTERM (reference
    server/server.go). The executor runs on the card unless ``--device
    cpu`` is given; without a card the verb prints the error and exits
    non-zero. Both signals close the server cleanly (barrier, snapshot,
    WAL close); an acked write survives SIGKILL too, through the WAL."""
    from ..server.server import Server
    from ..utils import logger as logger_mod
    from ..utils.config import (QueryConfig, ScrubConfig, TraceConfig,
                                apply_env, parse_bool)

    from ..cluster.topology import Cluster, Node

    logger = logger_mod.Logger(stderr)
    query = QueryConfig()
    for attr in ("concurrency", "queue_depth"):
        value = getattr(args, f"query_{attr}")
        if value is not None:
            setattr(query, attr, value)
    cfg = ClusterConfig()
    if args.cluster_hosts:
        cfg.hosts = [h.strip() for h in args.cluster_hosts.split(",")
                     if h.strip()]
    if args.cluster_internal_hosts:
        cfg.internal_hosts = [h.strip() for h in
                              args.cluster_internal_hosts.split(",")
                              if h.strip()]
    if args.cluster_replicas is not None:
        cfg.replica_n = args.cluster_replicas
    if args.cluster_type:
        cfg.type = args.cluster_type
    if args.cluster_poll_interval is not None:
        cfg.polling_interval = args.cluster_poll_interval
    if args.anti_entropy_interval is not None:
        cfg.anti_entropy_interval = args.anti_entropy_interval
    trace, scrub = TraceConfig(), ScrubConfig()
    apply_env(trace, scrub, os.environ)
    if args.trace_tail is not None:
        trace.tail = parse_bool(args.trace_tail)
    if cfg.type == "gossip":
        raise PilosaError("--cluster.type gossip is not available in this"
                          " package yet: use static or http with"
                          " --cluster.hosts")
    cluster = None
    if cfg.hosts:
        internal = cfg.internal_hosts or [""] * len(cfg.hosts)
        cluster = Cluster(nodes=[Node(h, internal_host=ih)
                                 for h, ih in zip(cfg.hosts, internal)],
                          replica_n=cfg.replica_n)
    server = Server(os.path.expanduser(args.data_dir), host=args.bind,
                    device=args.device, logger=logger, query_config=query,
                    cal_dir=(os.path.expanduser(args.cost_dir)
                             if args.cost_dir else None),
                    cluster=cluster, cluster_type=cfg.type,
                    polling_interval=cfg.polling_interval,
                    anti_entropy_interval=cfg.anti_entropy_interval,
                    trace_config=trace, scrub_config=scrub)
    server.open()

    def stop(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, stop)
    print(f"pilosa-tpu serving at http://{server.host} "
          f"(data: {args.data_dir})", file=stdout, flush=True)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        print("shutting down", file=stderr)
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
    bytes live in the JAX package's blob tier."""
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


def _check_deep(args, stdout, stderr) -> int:
    """Offline storage scrub (the CLI face of storage.scrub): verify
    every snapshot footer (per-block crc32 table + whole-body digest)
    and WAL-tail FNV checksums under the given data dirs / files, one
    verdict line per fragment; nonzero exit on ANY corruption.
    ``.corrupt`` aside files (quarantine forensics / pending-repair
    sentinels) are reported too. A blob-tier stub has no local bytes to
    verify: that lane waits for the tier slice, and the verb exits 2."""
    from ..storage import scrub as scrub_mod
    stubs = [s for path in args.paths for s in _blob_stubs(path)]
    if stubs:
        print(f"check --deep: {stubs[0]}: blob-tier fragments are not"
              " available in this package yet (the tier slice)",
              file=stderr)
        return 2
    rc = 0
    n = corrupt = vintage = 0
    for path in args.paths:
        files = _fragment_files(path)
        if not files:
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
    print(f"checked {n} fragments: {corrupt} corrupt,"
          f" {vintage} without footers", file=stdout)
    return rc


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

    s = sub.add_parser("server", help="run a pilosa-tpu-torch node")
    s.add_argument("-d", "--data-dir", default="~/.pilosa")
    s.add_argument("-b", "--bind", default="localhost:10101",
                   help="host:port to listen on (default localhost:10101)")
    s.add_argument("--device", default=None,
                   help="torch device of the executor (default the card,"
                        " cuda:0; 'cpu' runs every kernel's plain version"
                        " on the host)")
    s.add_argument("--query.concurrency", dest="query_concurrency",
                   type=int, default=None, metavar="N",
                   help="max queries executing concurrently"
                        " (admission cap, default 16)")
    s.add_argument("--query.queue-depth", dest="query_queue_depth",
                   type=int, default=None, metavar="N",
                   help="max queries waiting for a slot before the"
                        " server answers 429 (default 64)")
    s.add_argument("--cost.dir", dest="cost_dir", default="",
                   metavar="DIR",
                   help="directory that keeps the cost model's"
                        " calibration of this host and card (default:"
                        " measured at first device use, not kept)")
    s.add_argument("--cluster.hosts", dest="cluster_hosts", default="",
                   metavar="H1,H2,...",
                   help="static cluster membership (this node's --bind"
                        " among them)")
    s.add_argument("--cluster.internal-hosts",
                   dest="cluster_internal_hosts", default="",
                   metavar="H1,H2,...",
                   help="internal host of each --cluster.hosts entry,"
                        " where broadcasts go (default: the host)")
    s.add_argument("--cluster.replicas", dest="cluster_replicas",
                   type=int, default=None, metavar="N",
                   help="replicas of each slice (default 1)")
    s.add_argument("--cluster.type", dest="cluster_type", default="",
                   choices=CLUSTER_TYPES,
                   help="static (no schema broadcasts) or http (POST them"
                        " to every peer); gossip is not available yet")
    s.add_argument("--cluster.poll-interval",
                   dest="cluster_poll_interval", type=parse_duration,
                   default=None, metavar="DUR",
                   help="max-slice poll of the peers (default 60s)")
    s.add_argument("--anti-entropy.interval",
                   dest="anti_entropy_interval", type=parse_duration,
                   default=None, metavar="DUR",
                   help="block sync between replica owners (default 10m)")
    s.add_argument("--trace.tail", dest="trace_tail", default=None,
                   help="tail-sampled tracing: every query buffers"
                        " spans; slow/errored/faulted ones persist"
                        " (default true)")
    s.set_defaults(fn=cmd_server)

    def client_cmd(name, help, fn):
        c = sub.add_parser(name, help=help)
        c.add_argument("--host", default="localhost:10101")
        c.add_argument("-i", "--index", required=True)
        c.add_argument("-f", "--frame", required=True)
        c.set_defaults(fn=fn)
        return c

    c = client_cmd("import", "bulk-import CSV bits", cmd_import)
    c.add_argument("--field", default="",
                   help="import column,value rows into this BSI"
                        " integer field instead of bits")
    c.add_argument("paths", nargs="+", help="CSV files ('-' for stdin)")
    c = client_cmd("export", "export a frame's view as CSV", cmd_export)
    c.add_argument("--view", default="standard")

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
