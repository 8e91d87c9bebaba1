"""Fleet observability: the port's ``obs.federate`` and ``obs.runtime``
against the JAX package's.

- ``parse_exposition``, ``merge_node_families`` and ``render_merged`` on
  seeded registries (``_feed`` of ``tests/test_torch_obs.py``): both
  packages parse to the same families and render the merge of the same
  per-node expositions byte for byte.
- ``GET /metrics/cluster`` and ``GET /debug/cluster`` on a three-node
  port cluster and on a mixed gossip cluster of one JAX node and two
  port nodes, from each kind of coordinator: every node federated, one
  epoch, no version skew; with a peer closed, 503 without ``?partial=1``
  and 200 naming the peer in ``X-Pilosa-Partial-Nodes`` with it. The
  in-process nodes of one package share one metric registry, so a
  counter's merged value is the sum of its scrapes.
- The runtime collector's ``holder`` block against the JAX collector's
  over one data directory.
"""

from __future__ import annotations

import json
import shutil
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from podenv import free_port
from test_torch_obs import _feed

import pilosa_tpu.obs.federate as jfed
import pilosa_tpu.obs.metrics as jmetrics
import pilosa_tpu.obs.runtime as jruntime
from pilosa_tpu.cluster.gossip import GossipNodeSet as JGossip
from pilosa_tpu.cluster.topology import Cluster as JCluster
from pilosa_tpu.cluster.topology import Node as JNode
from pilosa_tpu.models.holder import Holder as JHolder
from pilosa_tpu.server.server import Server as JServer

import pilosa_tpu_torch.obs.federate as tfed
import pilosa_tpu_torch.obs.metrics as tmetrics
import pilosa_tpu_torch.obs.runtime as truntime
from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.cluster.gossip import GossipNodeSet as TGossip
from pilosa_tpu_torch.cluster.topology import Cluster, Node
from pilosa_tpu_torch.models.holder import Holder as THolder
from pilosa_tpu_torch.server.server import Server as TServer

GOSSIP = {"probe_interval": 0.1, "probe_timeout": 0.5,
          "push_pull_interval": 0.3, "suspect_after": 2,
          "suspect_timeout": 2.0}
COUNTER = "pilosa_query_requests_total"


# -- the functions ------------------------------------------------------------


def _expositions(seed: int) -> dict:
    """{node: a seeded registry's 0.0.4 text} for three nodes."""
    out = {}
    for i, node in enumerate(("n1:1", "n2:2", "n3:3")):
        text = _feed(tmetrics, 10 * seed + i)
        out[node] = text.split("\n# EOF")[0].rsplit("\n\n", 1)[0] + "\n"
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_parse_merge_render_identical(seed):
    texts = _expositions(seed)
    parsed = {pkg: {n: pkg.parse_exposition(t) for n, t in texts.items()}
              for pkg in (jfed, tfed)}
    assert parsed[jfed] == parsed[tfed]
    merged = {pkg: pkg.merge_node_families(parsed[pkg])
              for pkg in (jfed, tfed)}
    assert merged[jfed] == merged[tfed]
    want = jfed.render_merged(merged[jfed])
    assert tfed.render_merged(merged[tfed]) == want
    # Counters sum over the nodes; gauges keep one sample a node.
    fam = merged[tfed]["pilosa_test_events_total"]
    for (name, labels), v in fam["samples"].items():
        assert v == sum(s[2] for n in parsed[tfed].values()
                        for s in n.get("pilosa_test_events_total",
                                       {"samples": []})["samples"]
                        if (s[0], tuple(sorted(s[1].items())))
                        == (name, labels))
    gauge = merged[tfed]["pilosa_test_depth_items"]["samples"]
    assert sorted(dict(k[1])["node"] for k in gauge) == sorted(texts)


def test_parse_escapes_and_openmetrics_alike():
    text = _feed(tmetrics, 7)  # the 0.0.4 and the OpenMetrics renders
    assert tfed.parse_exposition(text) == jfed.parse_exposition(text)
    fam = tfed.parse_exposition(text)["pilosa_test_depth_items"]
    assert fam["help"] == 'depth \\ with a "quote"'


def test_fan_out_marks_failed_legs():
    def fetch(host):
        if host == "b:2":
            raise OSError("refused")
        return {"host": host}

    got = []
    for pkg, metrics in ((jfed, jmetrics), (tfed, tmetrics)):
        fed = pkg.Federator("a:1", cluster=Cluster(
            nodes=[Node("a:1"), Node("b:2"), Node("c:3")]))
        before = metrics.FEDERATION_SCRAPES.labels("b:2", "error").value
        results, missing = fed.fan_out(fetch, lambda: {"host": "a:1"})
        got.append((results, missing,
                    metrics.FEDERATION_SCRAPES.labels("b:2", "error").value
                    - before))
    assert got[0] == got[1] == ({"a:1": {"host": "a:1"},
                                 "c:3": {"host": "c:3"}}, ["b:2"], 1)


# -- the routes on live clusters ----------------------------------------------


def _req(host, method, path, body=None, timeout=60):
    r = urllib.request.Request(f"http://{host}{path}", data=body,
                               method=method)
    try:
        with urllib.request.urlopen(r, timeout=timeout) as f:
            return f.status, dict(f.headers), f.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _counter_sum(text: str, pkg=tfed) -> float:
    fam = pkg.parse_exposition(text).get(COUNTER)
    return sum(s[2] for s in fam["samples"]) if fam else 0.0


def _own_sum(hosts) -> float:
    return sum(_counter_sum(_req(h, "GET", "/metrics")[2].decode())
               for h in hosts)


def _seed_reads(host):
    _req(host, "POST", "/index/i", b"{}")
    _req(host, "POST", "/index/i/frame/f", b"{}")
    for col in (1, SLICE_WIDTH + 2, 3 * SLICE_WIDTH + 3):
        _req(host, "POST", "/index/i/query",
             f"SetBit(rowID=1, frame=f, columnID={col})".encode())
    assert json.loads(_req(host, "POST", "/index/i/query",
                           b"Count(Bitmap(rowID=1, frame=f))")[2]) == {
        "results": [3]}


def _check_fleet(coord: str, hosts: list[str]) -> None:
    before = _own_sum(hosts)
    st, hs, body = _req(coord, "GET", "/metrics/cluster")
    after = _own_sum(hosts)
    assert st == 200 and hs["X-Pilosa-Federated-Nodes"] == "3"
    merged = _counter_sum(body.decode())
    assert before <= merged <= after
    st, hs, body = _req(coord, "GET", "/debug/cluster")
    assert st == 200 and "X-Pilosa-Partial-Nodes" not in hs
    roll = json.loads(body)
    assert roll["coordinator"] == coord and roll["missing"] == []
    assert sorted(roll["nodes"]) == sorted(hosts)
    assert {b["epoch"] for b in roll["nodes"].values()} == {0}
    assert roll["versionSkew"] is False
    st, _, body = _req(coord, "GET", "/debug/cluster?local=1")
    assert st == 200 and json.loads(body)["host"] == coord


def _check_dead(coord: str, dead: str, live: list[str]) -> None:
    for path in ("/metrics/cluster", "/debug/cluster"):
        st, _, body = _req(coord, "GET", path)
        assert st == 503 and dead.encode() in body, path
        st, hs, body = _req(coord, "GET", path + "?partial=1")
        assert st == 200 and hs["X-Pilosa-Partial-Nodes"] == dead, path
    st, hs, _ = _req(coord, "GET", "/metrics/cluster?partial=1")
    assert hs["X-Pilosa-Federated-Nodes"] == str(len(live))
    roll = json.loads(_req(coord, "GET", "/debug/cluster?partial=1")[2])
    assert sorted(roll["nodes"]) == sorted(live)
    assert roll["missing"] == [dead]


@pytest.fixture
def port_cluster(tmp_path, monkeypatch):
    """Three port nodes in one static cluster, replicas 2."""
    hosts = [f"127.0.0.1:{free_port()}" for _ in range(3)]
    servers = []
    try:
        for i, h in enumerate(hosts):
            s = TServer(str(tmp_path / f"n{i}"), host=h, device="cpu",
                        warmup=False, cluster=Cluster(
                            nodes=[Node(x) for x in hosts], replica_n=2),
                        cluster_type="http", polling_interval=0,
                        anti_entropy_interval=0)
            s.open()
            servers.append(s)
        yield hosts, servers
    finally:
        for s in servers:
            if not getattr(s, "_test_closed", False):
                s.close()


def test_port_cluster_fleet_routes(port_cluster):
    hosts, servers = port_cluster
    _seed_reads(hosts[0])
    for coord in hosts:
        _check_fleet(coord, hosts)
    # A gauge keeps one sample a node.
    body = _req(hosts[1], "GET", "/metrics/cluster")[2].decode()
    inflight = tfed.parse_exposition(body)[
        "pilosa_admission_inflight_queries"]["samples"]
    assert sorted(s[1]["node"] for s in inflight) == sorted(hosts)
    servers[2].close()
    servers[2]._test_closed = True
    _check_dead(hosts[0], hosts[2], hosts[:2])


def _wait(pred, deadline_s=30.0, what=""):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture
def mixed_cluster(tmp_path, monkeypatch):
    """[JAX node, port node, port node] over gossip, replicas 2."""
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


def test_mixed_gossip_cluster_fleet_routes(mixed_cluster):
    hosts, servers = mixed_cluster

    def joined():
        return all(len(json.loads(_req(h, "GET", "/status")[2])
                       ["status"]["nodes"]) == 3 for h in hosts)

    _wait(joined, what="three members everywhere")
    # The gossip push/pull carries each node's build to the others.
    _wait(lambda: all(
        len(json.loads(_req(h, "GET", "/debug/cluster?local=1")[2])
            .get("gossipBuilds") or {}) == 2 for h in hosts[1:]),
        what="gossip builds on the port nodes")
    _seed_reads(hosts[1])
    for coord in hosts:
        _check_fleet(coord, hosts)
    roll = json.loads(_req(hosts[1], "GET", "/debug/cluster")[2])
    assert {b["build"]["jax"] == "unloaded"
            for b in roll["nodes"].values()} == {True, False}
    # A closed port node: both kinds of coordinator answer 503, and
    # 200 naming it under ?partial=1.
    servers[2].close()
    servers[2]._test_closed = True
    for coord in hosts[:2]:
        _check_dead(coord, hosts[2], hosts[:2])


# -- the runtime collector ----------------------------------------------------


def test_runtime_holder_block_matches(tmp_path):
    rng = np.random.default_rng(11)
    seed = THolder(str(tmp_path / "seed"))
    seed.open()
    idx = seed.create_index_if_not_exists("i")
    for frame in ("f", "g"):
        fr = idx.create_frame_if_not_exists(frame)
        for col in rng.choice(4 * SLICE_WIDTH, size=3000, replace=False):
            fr.set_bit("standard", int(rng.integers(0, 20)), int(col))
        # A dense row and a run: every container kind.
        for col in range(70000, 75000):
            fr.set_bit("standard", 99, col)
    seed.close()
    blocks = []
    for name, holder_cls, mod in (("jax", JHolder, jruntime),
                                  ("torch", THolder, truntime)):
        shutil.copytree(tmp_path / "seed", tmp_path / name)
        h = holder_cls(str(tmp_path / name))
        h.open()
        try:
            blocks.append(mod.RuntimeCollector(holder=h)._holder_sizes())
        finally:
            h.close()
    assert blocks[0] == blocks[1]
    assert blocks[1]["fragments"] == 8
    assert tmetrics.HOLDER_FRAGMENTS.value == 8


def test_metrics_settings_reach_the_federator(tmp_path):
    from pilosa_tpu_torch.utils.config import MetricsConfig
    s = TServer(str(tmp_path / "d"), host="127.0.0.1:0", device="cpu",
                warmup=False, metrics_config=MetricsConfig(
                    federate_timeout=0.75, federate_fanout=3))
    s.open()
    try:
        assert (s.federator.peer_timeout_s, s.federator.fanout) == (0.75, 3)
        assert s.federator.host == s.host == s.handler.host
        st, hs, _ = _req(s.host, "GET", "/metrics/cluster")
        assert st == 200 and hs["X-Pilosa-Federated-Nodes"] == "1"
    finally:
        s.close()
