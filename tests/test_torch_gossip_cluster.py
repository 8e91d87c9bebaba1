"""A mixed gossip cluster of one JAX node and two port nodes, on the CPU.

All three serve HTTP in this process with ``cluster.gossip`` membership
(``--cluster.type gossip``'s wiring: the node set is the broadcaster,
the receiver and the status handler's transport), replicas 2, probes
every 0.1 s and a 2 s suspect window:

- membership converges both ways (``/status`` and ``/health`` read
  ``3 nodes UP`` on every node, each kind with the other's build);
- a frame created on either kind appears on the other, over gossip;
- Count and TopN answer identically from every coordinator, and the
  Count as a host reference of the imported bits does;
- ``/health`` bodies agree in keys and ``ok`` flags;
- a closed node of either kind is declared dead by the others: their
  ``/health`` answers 503 naming it, a port survivor's breaker for it is
  open with the gossip reason, and the survivors' answers stay exact.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from podenv import free_port

from pilosa_tpu.cluster.gossip import GossipNodeSet as JGossip
from pilosa_tpu.cluster.topology import Cluster as JCluster
from pilosa_tpu.cluster.topology import Node as JNode
from pilosa_tpu.server.server import Server as JServer

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.cluster.client import Client
from pilosa_tpu_torch.cluster.gossip import GossipNodeSet as TGossip
from pilosa_tpu_torch.cluster.topology import Cluster, Node
from pilosa_tpu_torch.server.server import Server as TServer

N_SLICES = 4
GOSSIP = {"probe_interval": 0.1, "probe_timeout": 0.5,
          "push_pull_interval": 0.3, "suspect_after": 2,
          "suspect_timeout": 2.0}


def _req(host, method, path, body=None, timeout=60):
    r = urllib.request.Request(f"http://{host}{path}", data=body,
                               method=method)
    try:
        with urllib.request.urlopen(r, timeout=timeout) as f:
            return f.status, f.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(pred, deadline_s=20.0, what="", poll_s=0.05):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if pred():
            return
        time.sleep(poll_s)
    raise AssertionError(f"timed out waiting for {what}")


def _health(host):
    status, raw = _req(host, "GET", "/health")
    return status, json.loads(raw)


def _ok_flags(host):
    status, body = _health(host)
    return status, {k: v["ok"] for k, v in body["checks"].items()}


@pytest.fixture
def cluster(tmp_path, monkeypatch):
    """[JAX node, port node, port node], all three open."""
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    hosts = [f"127.0.0.1:{free_port()}" for _ in range(3)]
    jgs = JGossip(hosts[0], gossip_host="127.0.0.1:0", **GOSSIP)
    js = JServer(str(tmp_path / "n0"), host=hosts[0],
                 cluster=JCluster(nodes=[JNode(h) for h in hosts],
                                  replica_n=2, node_set=jgs),
                 broadcaster=jgs, broadcast_receiver=jgs,
                 anti_entropy_interval=0, polling_interval=0)
    js.open()
    servers = [js]
    try:
        for i in (1, 2):
            tgs = TGossip(hosts[i], gossip_host="127.0.0.1:0",
                          seeds=[jgs.gossip_host], **GOSSIP)
            ts = TServer(str(tmp_path / f"n{i}"), host=hosts[i],
                         device="cpu", warmup=False,
                         cluster=Cluster(nodes=[Node(h) for h in hosts],
                                         replica_n=2, node_set=tgs),
                         cluster_type="gossip", polling_interval=0,
                         anti_entropy_interval=0)
            ts.open()
            servers.append(ts)
        yield hosts, servers
    finally:
        for s in servers:
            if not getattr(s, "_test_closed", False):
                s.close()


def _query(host, q):
    return _req(host, "POST", "/index/i/query", q.encode())


READS = ["Count(Bitmap(rowID=1, frame=f))",
         "Count(Intersect(Bitmap(rowID=1, frame=f), Bitmap(rowID=2,"
         " frame=f)))",
         "Count(Union(Bitmap(rowID=3, frame=h), Bitmap(rowID=4, frame=f)))",
         "TopN(frame=f, n=5)",
         "TopN(Bitmap(rowID=3, frame=f), frame=f, n=4)"]


@pytest.mark.parametrize("victim", ["jax", "port"])
def test_mixed_gossip_cluster(cluster, victim):
    hosts, servers = cluster
    js, ps = servers[0], servers[1]
    _wait(lambda: all(_health(h)[0] == 200 for h in hosts), 20,
          "three UP")
    for h in hosts:
        status, body = _health(h)
        assert body["checks"]["gossip"]["detail"] == "3 nodes UP"
        st = json.loads(_req(h, "GET", "/status")[1])["status"]["nodes"]
        assert [n["state"] for n in st] == ["UP"] * 3
    assert _ok_flags(hosts[0]) == _ok_flags(hosts[1]) == _ok_flags(hosts[2])
    _wait(lambda: hosts[1] in js.peer_builds and hosts[0] in ps.peer_builds,
          10, "builds over push/pull")
    assert ps.peer_builds[hosts[0]]["version"] == \
        js.peer_builds[hosts[1]]["version"]
    # Schema over gossip, from either kind.
    assert _req(hosts[0], "POST", "/index/i", b"{}")[0] == 200
    assert _req(hosts[0], "POST", "/index/i/frame/f", b"{}")[0] == 200
    assert _req(hosts[2], "POST", "/index/i/frame/h", b"{}")[0] == 200
    _wait(lambda: all(s.holder.frame("i", fr) is not None
                      for s in servers for fr in ("f", "h")), 10,
          "the schema")
    rng = np.random.default_rng(8)
    rows = rng.integers(0, 12, size=3000).astype(np.uint64)
    cols = rng.integers(0, N_SLICES * SLICE_WIDTH,
                        size=3000).astype(np.uint64)
    for frame, via in (("f", hosts[1]), ("h", hosts[0])):
        c = Client(via)
        c.import_arrays("i", frame, rows, cols)   # to both owners
        c.close()
    _wait(lambda: all(s.holder.index("i").max_slice() == N_SLICES - 1
                      for s in servers), 10, "slice knowledge")
    want = {q: _query(hosts[0], q) for q in READS}
    for q, w in want.items():
        assert w[0] == 200, (q, w)
        for h in hosts[1:]:
            assert _query(h, q) == w, (h, q)
    ref = len(np.unique(cols[rows == 1]))
    assert json.loads(want[READS[0]][1])["results"] == [ref]

    # A node of ``victim``'s kind stops: the others declare it dead.
    k = 0 if victim == "jax" else 2
    dead = hosts[k]
    servers[k].close()
    servers[k]._test_closed = True
    survivors = [h for h in hosts if h != dead]
    # The moment the port survivor's fault layer hears the dead rumor,
    # its breaker is open for the gossip reason (a later half-open
    # probe of the lapsed window would restate the reason).
    port_survivor = servers[1]
    health = port_survivor.fault.health
    _wait(lambda: health.snapshot().get(dead, {}).get("gossip") == "dead",
          20, "the dead rumor", poll_s=0.002)
    brk = port_survivor.fault.breakers.snapshot()[dead]
    assert brk["state"] == "open" and brk["reason"] == "gossip dead"
    _wait(lambda: all(_health(h)[0] == 503 for h in survivors), 20,
          "the death")
    for h in survivors:
        status, body = _health(h)
        assert body["checks"]["gossip"] == {"ok": False,
                                            "detail": f"down: {dead}"}
    assert _ok_flags(survivors[0]) == _ok_flags(survivors[1])
    for q, w in want.items():
        for h in survivors:
            assert _query(h, q) == w, ("after the death", h, q)
