"""The port's fair dispatch queue (parallel.mesh.FairDispatchQueue)
against the JAX package's, and its place in every dispatch.

- The same arrivals (tenants, made from a numpy seed) behind one held
  slot, with the same weights, are granted in the same order by both
  queues, and both report the same state.
- The slot is reentrant per thread: a dispatch inside a dispatch holds
  one slot (the JAX wrapper's contract), and a queue of one slot does
  not deadlock on it.
- ``install_fair_dispatch`` honours ``PILOSA_MESH_FAIR=0`` and
  ``PILOSA_MESH_FAIR_SLOTS`` as the JAX package's does.
- The ``mesh.dispatch`` failpoint fires before each launch: an injected
  error stops the dispatch in both packages, and a delay holds it.
- A port server installs the queue at open (``fairDispatch`` in the
  ``/status`` runtime block) and removes it at close.
"""

import threading
import time

import numpy as np
import pytest
import torch

from pilosa_tpu.fault import failpoints as jfp
from pilosa_tpu.parallel import mesh as jmesh

from pilosa_tpu_torch.fault import failpoints as tfp
from pilosa_tpu_torch.parallel import mesh as tmesh
from pilosa_tpu_torch.sched import context as tctx


def _grant_order(mod, arrivals, weights, slots=1):
    """Tenants in the order the queue granted them their slot, with
    every arrival queued behind ``slots`` held slots first."""
    q = mod.FairDispatchQueue(slots, weight_fn=weights.get)
    for _ in range(slots):
        q.acquire("holder")
    order, mu = [], threading.Lock()

    def waiter(tenant):
        q.acquire(tenant)
        with mu:
            order.append(tenant)
        q.release()

    threads = []
    for i, tenant in enumerate(arrivals):
        t = threading.Thread(target=waiter, args=(tenant,))
        t.start()
        threads.append(t)
        # Enqueue one at a time: the arrival order is the test's input.
        deadline = time.monotonic() + 10
        while q.state()["queued"] < i + 1:
            assert time.monotonic() < deadline
            time.sleep(0.001)
    queued = q.state()
    for _ in range(slots):
        q.release()
    for t in threads:
        t.join(10)
    return order, queued, q.state()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_grant_order_for_the_same_arrivals(seed):
    rng = np.random.default_rng(seed)
    tenants = ["wide", "quiet", "mid", "new"]
    weights = {"wide": 1.0, "quiet": 4.0, "mid": 2.0,
               "new": float(rng.choice([0.5, 1.0, 3.0])), "holder": 1.0}
    arrivals = [str(t) for t in rng.choice(
        tenants, size=int(rng.integers(12, 30)), p=[0.55, 0.1, 0.25, 0.1])]
    jorder, jq, jend = _grant_order(jmesh, arrivals, weights)
    torder, tq, tend = _grant_order(tmesh, arrivals, weights)
    assert torder == jorder
    assert sorted(torder) == sorted(arrivals)
    assert tq == jq and tend == jend
    assert tend["inFlight"] == 0 and tend["waits"] == len(arrivals)


def test_contended_shares_follow_the_weights():
    """A wide tenant queues 24 dispatches before a quiet tenant of three
    times its weight queues 24: in the first 16 grants the quiet tenant
    takes about three of four, whatever the arrival order, in both."""
    weights = {"wide": 1.0, "quiet": 3.0, "holder": 1.0}
    arrivals = ["wide"] * 24 + ["quiet"] * 24
    order = _grant_order(tmesh, arrivals, weights)[0]
    assert order == _grant_order(jmesh, arrivals, weights)[0]
    assert order[:16].count("quiet") >= 11


def test_reentrant_per_thread(monkeypatch):
    monkeypatch.delenv("PILOSA_MESH_FAIR", raising=False)
    monkeypatch.setenv("PILOSA_MESH_FAIR_SLOTS", "1")
    leaf = [torch.zeros(2, 4, dtype=torch.int32)]
    try:
        tmesh.install_fair_dispatch()
        jmesh.install_fair_dispatch()

        @jmesh._fair_dispatch
        def inner():
            return jmesh.fair_dispatch_state()["inFlight"]

        @jmesh._fair_dispatch
        def outer():
            return inner()

        with tmesh._dispatch("count", leaf):
            with tmesh._dispatch("count", leaf):
                port_in_flight = tmesh.fair_dispatch_state()["inFlight"]
        assert port_in_flight == outer() == 1
        assert tmesh.fair_dispatch_state() == jmesh.fair_dispatch_state()
        assert tmesh.fair_dispatch_state()["dispatches"] == 1
        # A real entry of the port's mesh takes its slot and gives it back.
        expr = ("and", ("leaf", 0), ("leaf", 1))
        leaves = np.arange(2 * 3 * 32768, dtype=np.uint32).reshape(
            2, 3, 32768)
        want = int(np.unpackbits((leaves[0] & leaves[1]).view(
            np.uint8)).sum())
        assert tmesh.count_expr(torch.device("cpu"), expr, leaves) == want
        st = tmesh.fair_dispatch_state()
        assert st["dispatches"] == 2 and st["inFlight"] == 0
    finally:
        tmesh.uninstall_fair_dispatch()
        jmesh.uninstall_fair_dispatch()


@pytest.mark.parametrize("env,want", [
    ({}, 8), ({"PILOSA_MESH_FAIR_SLOTS": "3"}, 3),
    ({"PILOSA_MESH_FAIR_SLOTS": "x"}, 8), ({"PILOSA_MESH_FAIR": "0"}, None)])
def test_install_honours_the_environment(monkeypatch, env, want):
    monkeypatch.delenv("PILOSA_MESH_FAIR", raising=False)
    monkeypatch.delenv("PILOSA_MESH_FAIR_SLOTS", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        tmesh.install_fair_dispatch()
        jmesh.install_fair_dispatch()
        got = tmesh.fair_dispatch_state()
        assert got == jmesh.fair_dispatch_state()
        assert (got["slots"] if got is not None else None) == want
    finally:
        tmesh.uninstall_fair_dispatch()
        jmesh.uninstall_fair_dispatch()
    assert tmesh.fair_dispatch_state() is None


def test_a_cancelled_waiter_gives_up_its_place():
    """A query cancelled while queued leaves the queue; the slot passes
    to the next waiter."""
    q = tmesh.FairDispatchQueue(1)
    q.acquire("holder")
    ctx = tctx.QueryContext(pql="Count()", index="i")
    err = []

    def waiter():
        with tctx.use(ctx):
            try:
                q.acquire("i")
            except BaseException as e:  # noqa: BLE001 - recorded
                err.append(type(e).__name__)

    t = threading.Thread(target=waiter)
    t.start()
    while q.state()["queued"] < 1:
        time.sleep(0.001)
    ctx.cancel()
    t.join(10)
    assert err == ["QueryCancelledError"]
    assert q.state()["queued"] == 0
    q.release()
    assert q.state()["inFlight"] == 0


@pytest.fixture
def _disarm():
    yield
    tfp.disarm_all()
    jfp.disarm_all()


def test_mesh_dispatch_failpoint(_disarm):
    assert "mesh.dispatch" in tfp.SITES and "mesh.dispatch" in jfp.SITES
    assert tfp.SITES.index("mesh.dispatch") == jfp.SITES.index(
        "mesh.dispatch")
    expr = ("or", ("leaf", 0), ("leaf", 1))
    leaves = np.ones((2, 2, 32768), dtype=np.uint32)
    cpu = torch.device("cpu")
    tfp.arm("mesh.dispatch", "error*1")
    jfp.arm("mesh.dispatch", "error*1")
    with pytest.raises(tfp.FailpointError):
        tmesh.count_expr(cpu, expr, leaves)
    with pytest.raises(jfp.FailpointError):
        jmesh._dispatch_gate()
    # Spent (``*1``): the next dispatch runs.
    assert tmesh.count_expr(cpu, expr, leaves) == 2 * 32768
    assert (tfp.default().snapshot()["armed"]
            == jfp.default().snapshot()["armed"])
    tfp.arm("mesh.dispatch", "delay(150ms)")
    t0 = time.perf_counter()
    tmesh.count_expr(cpu, expr, leaves)
    assert time.perf_counter() - t0 >= 0.15
    assert tfp.default().snapshot()["armed"]["mesh.dispatch"]["hits"] == 1


def test_server_installs_the_queue(tmp_path, monkeypatch):
    import json
    import urllib.request
    from pilosa_tpu_torch.server.server import Server
    monkeypatch.setenv("PILOSA_MESH_FAIR_SLOTS", "2")
    srv = Server(str(tmp_path / "d"), host="127.0.0.1:0", device="cpu",
                 warmup=False)
    srv.open()
    try:
        with urllib.request.urlopen(f"http://{srv.host}/status",
                                    timeout=10) as r:
            fair = json.loads(r.read())["runtime"]["fairDispatch"]
        assert fair == {"slots": 2, "inFlight": 0, "queued": 0,
                        "dispatches": 0, "waits": 0}
    finally:
        srv.close()
    assert tmesh.fair_dispatch_state() is None
