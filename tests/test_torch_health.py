"""``GET /health`` and the 60 s ``.cache`` flush, against the JAX package.

1. One JAX node and one port node over copies of one data directory
   answer ``/health`` with the same status and body (each node's own
   data path read as ``<dir>``) in the same states: clean, a quarantined
   fragment without a replica (503) and with one (200), write-unready
   after ENOSPC (503), and a full admission queue (503).
2. The holder's cache flush loop: a port node and a JAX node, each a
   subprocess with the module's ``CACHE_FLUSH_INTERVAL`` patched to
   0.5 s, take the same imports into a ranked frame; once the loop has
   written the ``.cache`` sidecars, both are killed with SIGKILL. The
   sidecars are the same bytes, and the reopened ranked caches rank the
   same rows.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

from podenv import cpu_env, free_port, wait_up

from pilosa_tpu.fault import diskfull as jdiskfull
from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.server.server import Server as JServer
from pilosa_tpu.utils.config import QueryConfig as JQuery
from pilosa_tpu.utils.config import ScrubConfig as JScrub

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.cluster.client import Client
from pilosa_tpu_torch.cluster.topology import Cluster, Node
from pilosa_tpu_torch.fault import diskfull as tdiskfull
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.server.server import Server as TServer
from pilosa_tpu_torch.utils.config import QueryConfig as TQuery
from pilosa_tpu_torch.utils.config import ScrubConfig as TScrub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _get(host, path):
    try:
        with urllib.request.urlopen(f"http://{host}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(host, path, body=b"{}"):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read()


def _health(srv):
    status, raw = _get(srv.host, "/health")
    return status, raw.decode().replace(srv.holder.path, "<dir>")


STATES = ("clean", "quarantine", "quarantine_replicated", "enospc",
          "admission")


@pytest.mark.parametrize("state", STATES)
def test_health_matches_the_jax_route(tmp_path, monkeypatch, state):
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    seed = TServer(str(tmp_path / "seed"), host="127.0.0.1:0",
                   device="cpu", warmup=False)
    seed.open()
    _post(seed.host, "/index/h")
    _post(seed.host, "/index/h/frame/f")
    _post(seed.host, "/index/h/query",
          b'SetBit(frame="f", rowID=1, columnID=3)')
    seed.close()
    shutil.copytree(tmp_path / "seed", tmp_path / "j")
    shutil.copytree(tmp_path / "seed", tmp_path / "t")
    replicated = state == "quarantine_replicated"
    query = {"concurrency": 1, "queue_depth": 1}
    scrub = {"enabled": False, "repair": False}
    jkw, tkw = {}, {}
    if replicated:
        # A replica-2 placement with a second member that never serves.
        peer = f"127.0.0.1:{free_port()}"
        hosts = [f"127.0.0.1:{free_port()}" for _ in range(2)]
        from pilosa_tpu.cluster.topology import Cluster as JCluster
        from pilosa_tpu.cluster.topology import Node as JNode
        jkw["cluster"] = JCluster(nodes=[JNode(hosts[0]), JNode(peer)],
                                  replica_n=2)
        tkw["cluster"] = Cluster(nodes=[Node(hosts[1]), Node(peer)],
                                 replica_n=2)
        jhost, thost = hosts
    else:
        jhost = thost = "127.0.0.1:0"
    js = JServer(str(tmp_path / "j"), host=jhost, anti_entropy_interval=0,
                 polling_interval=0, query_config=JQuery(**query),
                 scrub_config=JScrub(**scrub), **jkw)
    ts = TServer(str(tmp_path / "t"), host=thost, device="cpu",
                 warmup=False, anti_entropy_interval=0, polling_interval=0,
                 query_config=TQuery(**query),
                 scrub_config=TScrub(**scrub), **tkw)
    js.open()
    ts.open()
    slots, waiters = [], []
    try:
        assert _health(ts) == _health(js)
        if state.startswith("quarantine"):
            for srv in (js, ts):
                srv.holder.quarantine.add(types.SimpleNamespace(
                    index="h", frame="f", view="standard", slice=0,
                    path=os.path.join(srv.holder.path, "h")), "test")
        elif state == "enospc":
            for mod, srv in ((jdiskfull, js), (tdiskfull, ts)):
                mod.default().note_enospc("wal.append")
        elif state == "admission":
            for srv in (js, ts):
                slots.append(srv.admission.acquire("read"))
                t = threading.Thread(
                    target=lambda a=srv.admission: slots.append(
                        a.acquire("read")), daemon=True)
                t.start()
                waiters.append(t)
            deadline = time.monotonic() + 10
            while (time.monotonic() < deadline and not all(
                    sum(s.admission.snapshot()["queued"].values())
                    for s in (js, ts))):
                time.sleep(0.01)
        got, want = _health(ts), _health(js)
        assert got == want
        assert got[0] == (200 if state in ("clean", "quarantine_replicated")
                          else 503)
        body = json.loads(got[1])
        assert set(body["checks"]) == {"holder", "gossip", "admission",
                                       "disk", "storage", "writeReady"}
    finally:
        for mod in (jdiskfull, tdiskfull):
            mod.default().reset()
        # The held slots first, then the ones the waiters got.
        while slots:
            slots.pop().release()
        for t in waiters:
            t.join(10)
            assert not t.is_alive()
        while slots:
            slots.pop().release()
        ts.close()
        js.close()


# -- the holder's .cache flush loop ------------------------------------------

_CHILD = """
import sys
import {pkg}.server.server as server_mod
server_mod.CACHE_FLUSH_INTERVAL = 0.5
from {pkg}.cli.commands import main
sys.exit(main(sys.argv[1:]))
"""


def _spawn(pkg, data_dir, host, log):
    env = cpu_env()
    env["PILOSA_TPU_MESH"] = "0"
    env["PYTHONPATH"] = REPO
    argv = [sys.executable, "-c", _CHILD.format(pkg=pkg), "server",
            "-d", str(data_dir), "-b", host]
    if pkg == "pilosa_tpu_torch":
        argv += ["--device", "cpu"]
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=log,
                            stderr=log)


def _sidecars(data_dir, n_slices):
    frag = os.path.join(data_dir, "c", "r", "views", "standard",
                        "fragments")
    return [os.path.join(frag, f"{s}.cache") for s in range(n_slices)]


def test_cache_flush_survives_sigkill_like_the_jax_holder(tmp_path):
    n_slices = 3
    rng = np.random.default_rng(17)
    rows = (rng.zipf(1.3, size=20000) % 300).astype(np.uint64)
    cols = rng.integers(0, n_slices * SLICE_WIDTH,
                        size=20000).astype(np.uint64)
    dirs, procs = {}, {}
    try:
        for pkg in ("pilosa_tpu", "pilosa_tpu_torch"):
            host = f"127.0.0.1:{free_port()}"
            dirs[pkg] = tmp_path / pkg
            log = open(tmp_path / f"{pkg}.log", "wb")
            procs[pkg] = _spawn(pkg, dirs[pkg], host, log)
            wait_up(host)
            _post(host, "/index/c")
            _post(host, "/index/c/frame/r", json.dumps(
                {"options": {"cacheType": "ranked",
                             "cacheSize": 50}}).encode())
            c = Client(host)
            c.import_arrays("c", "r", rows, cols)
            c.close()
        for pkg, proc in procs.items():
            paths = _sidecars(str(dirs[pkg]), n_slices)
            deadline = time.monotonic() + 30
            while not all(os.path.exists(p) for p in paths):
                assert time.monotonic() < deadline, f"{pkg}: no flush"
                time.sleep(0.1)
            time.sleep(0.6)  # one more flush interval: no torn sidecar
            proc.send_signal(signal.SIGKILL)
            proc.wait(30)
        for jp, tp in zip(_sidecars(str(dirs["pilosa_tpu"]), n_slices),
                          _sidecars(str(dirs["pilosa_tpu_torch"]),
                                    n_slices)):
            with open(jp, "rb") as a, open(tp, "rb") as b:
                assert a.read() == b.read()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranked = []
    for holder_cls, pkg in ((JHolder, "pilosa_tpu"),
                            (THolder, "pilosa_tpu_torch")):
        h = holder_cls(str(dirs[pkg]))
        h.open()
        try:
            ranked.append([list(h.fragment("c", "r", "standard", s)
                                .cache.ids()) for s in range(n_slices)])
        finally:
            h.close()
    assert ranked[0] == ranked[1]
    assert all(0 < len(ids) <= 50 for ids in ranked[1])
