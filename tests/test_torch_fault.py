"""The port's fault layer against the JAX package's: seeded failpoint
specs parse alike (values and errors), a seeded failpoint registry
fires the same hits, seeded breaker boards walk the same state
sequence under one scripted clock, peer health scores the same EWMA,
and the fault manager orders replicas alike."""

import random

import numpy as np
import pytest

from pilosa_tpu.cluster import topology as jtop
from pilosa_tpu.fault import FaultManager as JFaultManager
from pilosa_tpu.fault import breaker as jbreaker
from pilosa_tpu.fault import failpoints as jfp
from pilosa_tpu.fault import health as jhealth

from pilosa_tpu_torch.cluster import topology as ttop
from pilosa_tpu_torch.fault import FaultManager as TFaultManager
from pilosa_tpu_torch.fault import breaker as tbreaker
from pilosa_tpu_torch.fault import failpoints as tfp
from pilosa_tpu_torch.fault import health as thealth

SPECS = ["off", "", "error", "error(0.25)", "enospc", "enospc(0.5)",
         "delay(5ms)", "delay(1ms,0.5)", "torn(7)", "torn(3,0.2)",
         "corrupt", "corrupt(3)", "corrupt(2,0.5)", "partition(hostB)",
         "partition(h:1,0.3)", "error*3", "delay(2ms)*1",
         "partition(x)*2", "bogus", "error(1,2)", "delay()", "torn()",
         "corrupt(0)", "error(1.5)", "partition()", "error*x", "(1)"]


def _parsed(mod, spec):
    try:
        fp = mod.parse_spec("rpc.send", spec)
    except ValueError as e:
        return ("ValueError", str(e))
    if fp is None:
        return None
    return (fp.site, fp.mode, fp.arg, fp.pct, fp.remaining, fp.spec)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_spec_equals_jax(spec):
    assert _parsed(tfp, spec) == _parsed(jfp, spec)


def _hits(mod, seed: int, spec: str, n: int = 300) -> list:
    reg = mod.Failpoints(seed=seed)
    reg.arm("rpc.recv", spec)
    out = []
    hosts = ["hostA:1", "hostB:2"]
    for k in range(n):
        try:
            reg.hit("rpc.recv", host=hosts[k % 2])
            out.append("ok")
        except mod.FailpointError as e:
            out.append(str(e))
    out.append(reg.snapshot()["armed"])
    return out


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("spec", ["error(0.3)", "enospc(0.6)*5",
                                  "partition(hostB,0.5)", "error*4"])
def test_seeded_hit_sequences_equal_jax(seed, spec):
    assert _hits(tfp, seed, spec) == _hits(jfp, seed, spec)


def test_unknown_site_raises():
    reg = tfp.Failpoints(seed=1)
    with pytest.raises(ValueError):
        reg.arm("backup.push", "error")
    assert set(tfp.SITES) <= set(jfp.SITES)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _breaker_walk(mod, seed: int) -> list:
    clock = _Clock()
    board = mod.BreakerBoard(threshold=3, backoff_base_s=0.5,
                             backoff_cap_s=8.0, node="me",
                             rng=random.Random(seed), clock=clock)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(400):
        host = f"p{int(rng.integers(3))}"
        op = int(rng.integers(6))
        if op == 0:
            board.record_failure(host)
        elif op == 1:
            board.record_success(host)
        elif op == 2:
            out.append(("allow", host, board.allow(host)))
        elif op == 3:
            out.append(("would", host, board.would_allow(host)))
        elif op == 4:
            clock.t += float(rng.exponential(1.0))
        else:
            if rng.random() < 0.1:
                board.force_open(host, "forced")
            else:
                board.note_probe_ready(host)
        out.append((host, board.state(host)))
    out.append(board.snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 3, 11, 42])
def test_breaker_state_sequences_equal_jax(seed):
    assert _breaker_walk(tbreaker, seed) == _breaker_walk(jbreaker, seed)


def test_peer_health_equals_jax():
    rng = np.random.default_rng(5)
    t, j = thealth.PeerHealth(node="me"), jhealth.PeerHealth(node="me")
    for _ in range(500):
        host = f"p{int(rng.integers(4))}"
        if rng.random() < 0.1:
            state = ["alive", "suspect", "dead"][int(rng.integers(3))]
            t.note_gossip(host, state)
            j.note_gossip(host, state)
        else:
            ok = bool(rng.random() < 0.7)
            lat = float(rng.exponential(0.01))
            t.record(host, ok, lat)
            j.record(host, ok, lat)
        assert t.score(host) == j.score(host)
        assert t.latency_tail(host) == j.latency_tail(host)
    snap_t, snap_j = t.snapshot(), j.snapshot()
    for h in snap_t:
        snap_t[h].pop("latencyMs"), snap_j[h].pop("latencyMs")
    assert snap_t.keys() == snap_j.keys()


def test_order_nodes_equals_jax():
    hosts = ["a:1", "b:2", "c:3", "d:4"]
    rng = np.random.default_rng(9)
    tm = TFaultManager(node="a:1", rng=random.Random(1))
    jm = JFaultManager(node="a:1", rng=random.Random(1))
    tnodes = [ttop.Node(h) for h in hosts]
    jnodes = [jtop.Node(h) for h in hosts]
    for _ in range(200):
        h = hosts[int(rng.integers(1, 4))]
        ok = bool(rng.random() < 0.6)
        tm.record_rpc(h, ok, 0.001)
        jm.record_rpc(h, ok, 0.001)
        perm = rng.permutation(4).tolist()
        got = [n.host for n in tm.order_nodes([tnodes[i] for i in perm])]
        want = [n.host for n in jm.order_nodes([jnodes[i] for i in perm])]
        assert got == want
        assert tm.probe_targets() == jm.probe_targets()
