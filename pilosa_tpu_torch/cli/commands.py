"""Command logic of the port's CLI.

Trimmed copy of the JAX package's ``cli/commands.py`` (reference ctl/):

- ``server`` with ``-d/--data-dir``, ``-b/--bind``, ``--device``, the
  admission bounds (``--query.concurrency``, ``--query.queue-depth``),
  ``--cost.dir`` (where the cost model's calibration is kept), and the
  static cluster: ``--cluster.hosts a,b,c`` (this node's ``--bind``
  among them), ``--cluster.replicas``, ``--cluster.type static|http``
  (``gossip`` is refused until the gossip slice),
  ``--cluster.poll-interval`` and ``--anti-entropy.interval``;
- ``import`` (CSV ``row,col[,timestamp]`` bits, or ``column,value``
  with ``--field``) and ``export`` (CSV of every slice), both through
  the cluster client, to every owner of each slice.

The TOML config file and the other verbs wait for later slices.
"""

from __future__ import annotations

import argparse
import csv
import datetime as dt
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
    from ..utils.config import QueryConfig

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
                    anti_entropy_interval=cfg.anti_entropy_interval)
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
