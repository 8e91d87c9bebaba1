"""Command logic of the port's CLI.

Trimmed copy of the JAX package's ``cli/commands.py`` (reference ctl/):
the ``server`` verb with ``-d/--data-dir``, ``-b/--bind`` and
``--device``. The TOML config file and the other verbs wait for later
slices (``import`` and ``export`` need the cluster client).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time
from typing import Optional

from ..errors import PilosaError


def cmd_server(args, stdout, stderr) -> int:
    """Serve one node until SIGINT or SIGTERM (reference
    server/server.go). The executor runs on the card unless ``--device
    cpu`` is given; without a card the verb prints the error and exits
    non-zero. Both signals close the server cleanly (barrier, snapshot,
    WAL close); an acked write survives SIGKILL too, through the WAL."""
    from ..server.server import Server
    from ..utils import logger as logger_mod

    logger = logger_mod.Logger(stderr)
    server = Server(os.path.expanduser(args.data_dir), host=args.bind,
                    device=args.device, logger=logger)
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
    s.set_defaults(fn=cmd_server)
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
