"""Process-level crash durability of the port: SIGKILL a live server.

The port's counterpart of ``tests/test_crash.py``: a ``pilosa_tpu_torch``
server subprocess (``--device cpu``) takes a write storm — SetBit and
ClearBit queries from several client threads, protobuf ``/import``
batches, and a thread whose imports drive one fragment past
``MAX_OP_N`` so that background snapshots swap its WAL mid-storm — and
is killed with SIGKILL while requests are in flight. Restarted on the
same data directory it must hold every acked SetBit and none of the
acked ClearBits (the last acked op of a bit decides it, unless a later
op on that bit was still in flight), and every bit it holds must have
been attempted. Every wait, request and storm loop has its own time
limit.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from pilosa_tpu_torch.proto import internal as pb

from podenv import free_port, wait_up

SW = 1 << 20
N_SLICES = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(data_dir, port, log):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
         "-d", str(data_dir), "-b", f"127.0.0.1:{port}",
         "--device", "cpu"],
        env=env, stdout=log, stderr=log, cwd=REPO)


def _post(port, path, body, headers=None, timeout=20):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=body, method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _query(port, pql, timeout=20):
    return json.loads(_post(port, "/index/ci/query", pql.encode(),
                            timeout=timeout))["results"]


def _storm(port, halt, seed):
    """Start the storm threads; they run until ``halt`` is set (or a
    minute passes). Returns (threads, point log, import log): the point
    log maps (row, col) to its [op, acked] entries in send order, the
    import log holds [row*SW + col positions, acked] per batch."""
    log: dict = {}
    imports: list = []
    mu = threading.Lock()
    stop = time.monotonic() + 60.0

    def running():
        return not halt.is_set() and time.monotonic() < stop

    def writer(k):
        rng = np.random.default_rng(seed * 100 + k)
        mine = []
        while running():
            if mine and rng.random() < 0.3:
                bit, op = mine[int(rng.integers(len(mine)))], "clear"
            else:
                bit = (10 * k + int(rng.integers(10)),
                       int(rng.integers(N_SLICES * SW)))
                op = "set"
                mine.append(bit)
            call = "SetBit" if op == "set" else "ClearBit"
            entry = [op, False]
            with mu:
                log.setdefault(bit, []).append(entry)
            try:
                _query(port, f'{call}(frame="cf", rowID={bit[0]},'
                             f' columnID={bit[1]})', timeout=10)
            except (OSError, urllib.error.URLError):
                continue  # in flight at the kill, or refused after it
            entry[1] = True

    def importer(k, n_bits, slice_=None):
        rng = np.random.default_rng(seed * 100 + 50 + k)
        while running():
            s = (int(rng.integers(N_SLICES)) if slice_ is None else slice_)
            rows = 100 + 10 * k + rng.integers(10, size=n_bits)
            cols = s * SW + rng.integers(SW, size=n_bits)
            entry = [rows.astype(np.uint64) * np.uint64(N_SLICES * SW)
                     + cols.astype(np.uint64), False]
            with mu:
                imports.append(entry)
            body = pb.ImportRequest(Index="ci", Frame="cf", Slice=s,
                                    RowIDs=rows.tolist(),
                                    ColumnIDs=cols.tolist()
                                    ).SerializeToString()
            try:
                _post(port, "/import", body,
                      {"Content-Type": "application/x-protobuf",
                       "Accept": "application/x-protobuf"}, timeout=20)
            except (OSError, urllib.error.URLError):
                continue
            entry[1] = True

    threads = ([threading.Thread(target=writer, args=(k,))
                for k in range(4)]
               + [threading.Thread(target=importer, args=(0, 2000))]
               # 65,536 bits a batch into slice 0: the WAL-first lane
               # adds 4,096 to its op count each time, past MAX_OP_N
               # (50,000) every 13 batches.
               + [threading.Thread(target=importer, args=(1, 65536, 0))])
    for t in threads:
        t.start()
    return threads, log, imports


def test_sigkill_mid_write_storm_keeps_every_acked_write(tmp_path):
    port = free_port()
    data_dir = tmp_path / "data"
    halt = threading.Event()
    with open(tmp_path / "server.log", "w") as out:
        proc = _spawn(data_dir, port, out)
        try:
            wait_up(f"127.0.0.1:{port}", deadline=90)
            _post(port, "/index/ci", b"{}")
            _post(port, "/index/ci/frame/cf", b"{}")
            threads, log, imports = _storm(port, halt, seed=3)
            time.sleep(8.0)
            # Kill mid-storm, with requests in flight.
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
        finally:
            halt.set()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    for t in threads:
        t.join(timeout=40)
    assert not any(t.is_alive() for t in threads)
    acked = sum(1 for ops in log.values() for _, a in ops if a)
    assert acked > 100, "storm too slow to be meaningful"
    assert sum(a for _, a in imports) >= 2

    # What must be there and what must not: the last op of a bit
    # decides it when that op was acked.
    W = np.uint64(N_SLICES * SW)
    want: dict = {}
    must_not: dict = {}
    attempted: dict = {}
    for (row, col), ops in log.items():
        attempted.setdefault(row, set()).add(col)
        op, was_acked = ops[-1]
        if was_acked:
            (want if op == "set" else must_not).setdefault(
                row, set()).add(col)
    for pos, was_acked in imports:
        for row, col in zip((pos // W).tolist(), (pos % W).tolist()):
            attempted.setdefault(row, set()).add(col)
            if was_acked:
                want.setdefault(row, set()).add(col)
    assert want and must_not

    with open(tmp_path / "server2.log", "w") as out:
        proc = _spawn(data_dir, port, out)
        try:
            wait_up(f"127.0.0.1:{port}", deadline=90)
            for row in sorted(attempted):
                got = set(_query(port, f'Bitmap(frame="cf", rowID={row})',
                                 timeout=60)[0]["bits"])
                missing = want.get(row, set()) - got
                assert not missing, (row, sorted(missing)[:5])
                resurrected = must_not.get(row, set()) & got
                assert not resurrected, (row, sorted(resurrected)[:5])
                assert got <= attempted[row], \
                    (row, sorted(got - attempted[row])[:5])
        finally:
            proc.send_signal(signal.SIGINT)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
