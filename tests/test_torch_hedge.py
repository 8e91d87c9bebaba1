"""Hedged reads: the port's ``[fault] hedge`` against the JAX package's.

The same seeded data goes into a JAX and a port holder, each the
coordinator ``local`` of a three-node cluster (replicas 2) whose peers
``b`` and ``c`` answer through one scripted transport. A peer that is
"held" blocks on a ``threading.Event`` that the test sets only after the
executor has returned (or at the test's end), so which side of a hedge
race wins is decided by the script, not by sleeps. Both executors must
give the same answer, make the same remote calls and count the same
hedge outcomes; the answer must also equal the count of the seeded bits.
"""

import threading
import types

import numpy as np
import pytest

import pilosa_tpu.cli.commands as jax_cli
import pilosa_tpu.cluster.client as jclient
import pilosa_tpu.cluster.generations as jgens
import pilosa_tpu.cluster.topology as jtop
import pilosa_tpu.errors as jerrors
import pilosa_tpu.executor as jexec
import pilosa_tpu.fault as jfault
import pilosa_tpu.models.holder as jholder
import pilosa_tpu.obs.metrics as jmetrics
import pilosa_tpu.sched.context as jctx
import pilosa_tpu.storage.cache as jcache
import pilosa_tpu.utils.config as jcfg

import pilosa_tpu_torch.cli.commands as port_cli
import pilosa_tpu_torch.cluster.client as tclient
import pilosa_tpu_torch.cluster.generations as tgens
import pilosa_tpu_torch.cluster.topology as ttop
import pilosa_tpu_torch.errors as terrors
import pilosa_tpu_torch.executor as texec
import pilosa_tpu_torch.fault as tfault
import pilosa_tpu_torch.models.holder as tholder
import pilosa_tpu_torch.obs.metrics as tmetrics
import pilosa_tpu_torch.sched.context as tctx
import pilosa_tpu_torch.storage.cache as tcache
import pilosa_tpu_torch.utils.config as tcfg

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.server.server import Server

JAX = types.SimpleNamespace(
    name="jax", Holder=jholder.Holder, exec=jexec, top=jtop,
    FaultManager=jfault.FaultManager, ClientError=jclient.ClientError,
    metrics=jmetrics, gens=jgens, Pair=jcache.Pair, ctx=jctx,
    errors=jerrors)
TORCH = types.SimpleNamespace(
    name="torch", Holder=tholder.Holder, exec=texec, top=ttop,
    FaultManager=tfault.FaultManager, ClientError=tclient.ClientError,
    metrics=tmetrics, gens=tgens, Pair=tcache.Pair, ctx=tctx,
    errors=terrors)

N_SLICES = 16
ROWS = range(1, 7)
COUNT = "Count(Bitmap(rowID=1, frame=general))"
# Slices whose owners are [b, c]: b's legs are the only ones a held b
# stalls (the coordinator serves every slice it owns itself).
HOSTS = ["local", "b", "c"]
B_FIRST = [s for s in range(N_SLICES)
           if [n.host for n in ttop.new_cluster(HOSTS, replica_n=2)
               .fragment_nodes("i", s)] == ["b", "c"]]


def _seed_data(seed: int) -> dict:
    """{(row, slice): sorted columns} of the seeded bits."""
    rng = np.random.default_rng(seed)
    out = {}
    for s in range(N_SLICES):
        for row in ROWS:
            k = int(rng.integers(0, 12))
            cols = rng.choice(SLICE_WIDTH, size=k, replace=False)
            out[(row, s)] = sorted(int(c) + s * SLICE_WIDTH for c in cols)
    return out


def _load(h, data: dict) -> None:
    idx = h.create_index_if_not_exists("i")
    for frame in ("general", "f"):
        f = idx.create_frame_if_not_exists(frame)
        for (row, _s), cols in data.items():
            for col in cols:
                f.set_bit("standard", row, col)


class Script:
    """Scripted transport answering every leg from the seeded truth. A
    host in ``held`` waits on its Event before it answers (or raises,
    when in ``then_fail``); a host in ``fail_until`` raises until its
    Event is set. ``on_call(host)`` runs as each call arrives."""

    generation_aware = False

    def __init__(self, pkg, data, held=None, then_fail=(),
                 fail_until=None):
        self.pkg = pkg
        self.data = data
        self.held = dict(held or {})
        self.then_fail = set(then_fail)
        # host -> Event: the host raises until the Event is set.
        self.fail_until = dict(fail_until or {})
        self.calls = []
        self.mu = threading.Lock()
        self.failed = threading.Event()
        self.on_call = None

    def _count(self, row, slices):
        return {r: sum(len(self.data[(r, s)]) for s in slices)
                for r in ([row] if row else ROWS)}

    def execute_query(self, node, index, query, slices, remote, **kw):
        with self.mu:
            self.calls.append((node.host, query,
                               tuple(slices) if slices else None))
        if self.on_call is not None:
            self.on_call(node.host)
        ev = self.held.get(node.host)
        if ev is not None:
            ev.wait(30)
            if node.host in self.then_fail:
                raise self.pkg.ClientError(f"{node.host}: held, then down")
        gate = self.fail_until.get(node.host)
        if gate is not None and not gate.is_set():
            self.failed.set()
            raise self.pkg.ClientError(f"{node.host}: refused")
        if query.startswith("Count("):
            return [self._count(1, slices)[1]]
        if query.startswith("SetBit("):
            return [True]
        assert query.startswith("TopN("), query
        counts = self._count(None, slices)
        if "ids=" in query:
            ids = query.split("ids=[")[1].split("]")[0]
            want = {int(x) for x in ids.split(",") if x}
            counts = {r: n for r, n in counts.items() if r in want}
        return [[self.pkg.Pair(r, n) for r, n in sorted(counts.items())
                 if n]]


class GenScript(Script):
    generation_aware = True


def _executor(pkg, h, client, hedge_s=0.05):
    cluster = pkg.top.new_cluster(HOSTS, replica_n=2)
    fm = pkg.FaultManager(hedge_s=hedge_s, node="local")
    kw = dict(host="local", cluster=cluster, client=client, fault=fm)
    if pkg is JAX:
        return pkg.exec.Executor(h, use_mesh=False, **kw)
    return pkg.exec.Executor(h, device="cpu", **kw)


def _outcomes(pkg) -> dict:
    return {o: pkg.metrics.HEDGED_REQUESTS.labels(o).value
            for o in ("fired", "primary_won", "hedge_won")}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def _both(tmp_path, case, seed=0):
    """Run ``case(pkg, holder, data)`` on both packages; each returns
    (answer, calls); both must agree."""
    data = _seed_data(seed)
    out = []
    for pkg in (JAX, TORCH):
        h = pkg.Holder(str(tmp_path / pkg.name))
        h.open()
        try:
            _load(h, data)
            answer, calls = case(pkg, h, data)
        finally:
            h.close()
        out.append((answer, sorted(calls, key=repr)))
    assert out[0] == out[1]
    return out[0][0], out[0][1], data


def test_b_leads_some_slices():
    assert B_FIRST, "the placement gives b no slice it leads over c"


# -- the delay ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("floor", [0.0, 0.03, 0.2])
def test_hedge_delay_matches(seed, floor):
    rng = np.random.default_rng(seed)
    fms = [pkg.FaultManager(hedge_s=floor, node="local")
           for pkg in (JAX, TORCH)]
    peers = ["b", "c", "d"]
    for _ in range(200):
        host = peers[int(rng.integers(len(peers)))]
        ok = bool(rng.random() < 0.9)
        lat = float(rng.exponential(0.02)) if rng.random() < 0.8 else None
        for fm in fms:
            fm.record_rpc(host, ok, lat)
    for host in peers + ["local", "never-seen"]:
        got = [fm.hedge_delay_s(host) for fm in fms]
        assert got[0] == got[1], host
        if floor == 0 or host == "local":
            assert got[1] is None
        else:
            assert got[1] >= floor
    assert fms[1].snapshot()["hedgeS"] == fms[0].snapshot()["hedgeS"] \
        == floor


# -- the race ----------------------------------------------------------------


@pytest.mark.parametrize("seed", [4, 5])
def test_slow_primary_beaten_by_the_hedge(tmp_path, seed):
    def case(pkg, h, data):
        held = threading.Event()
        client = Script(pkg, data, held={"b": held})
        e = _executor(pkg, h, client)
        before = _outcomes(pkg)
        try:
            res = e.execute("i", COUNT)
        finally:
            held.set()
            e.close()
        return [res, _delta(before, _outcomes(pkg))], client.calls

    (res, outcomes), calls, data = _both(tmp_path, case, seed)
    assert res == [sum(len(data[(1, s)]) for s in range(N_SLICES))]
    assert outcomes == {"fired": 1, "primary_won": 0, "hedge_won": 1}
    assert sorted(c[0] for c in calls) == ["b", "c"]
    assert calls[0][2] == calls[1][2] == tuple(B_FIRST)


def test_fast_primary_wins_without_a_hedge(tmp_path):
    def case(pkg, h, data):
        client = Script(pkg, data)
        e = _executor(pkg, h, client, hedge_s=30.0)
        before = _outcomes(pkg)
        res = e.execute("i", COUNT)
        e.close()
        return [res, _delta(before, _outcomes(pkg))], client.calls

    (res, outcomes), calls, _ = _both(tmp_path, case)
    assert outcomes == {"fired": 0, "primary_won": 0, "hedge_won": 0}
    assert [c[0] for c in calls] == ["b"]


def test_only_the_winners_tokens_reach_the_map(tmp_path):
    """After JAX tests/test_distributed_fastpath.py::TestHedgedGenerations:
    a held primary that straggles in after the hedge won must not land
    its (older) tokens in the coordinator's generation map."""
    def case(pkg, h, data):
        cluster = pkg.top.new_cluster(["slowpeer:1", "fastpeer:2"],
                                      replica_n=2)
        gens = (pkg.gens.GenerationMap(staleness_s=60.0) if pkg is JAX
                else pkg.gens.GenerationMap())
        held = threading.Event()
        slow_done = threading.Event()

        class HedgeClient:
            generation_aware = True

            def execute_query(self, node, index, query, slices, remote,
                              gens_out=None, **kwargs):
                slow = "slow" in node.host
                payload = pkg.gens.encode_wire(
                    index, {0: {"general/standard": (1, 0 if slow else 5)}})
                if slow:
                    held.wait(30)
                if gens_out is not None:
                    gens_out.append((node.host, payload))
                if slow:
                    slow_done.set()
                return [3]

        kw = dict(host="coord", cluster=cluster, client=HedgeClient(),
                  gens=gens)
        e = (pkg.exec.Executor(h, use_mesh=False, **kw) if pkg is JAX
             else pkg.exec.Executor(h, device="cpu", **kw))
        c = pkg.exec.parse_pql(COUNT).calls[0]
        slow_node = cluster.node_by_host("slowpeer:1")

        def add(prev, v):
            return (prev or 0) + v

        if pkg is JAX:
            res = e._exec_remote_hedged(slow_node, "i", c, [0],
                                        pkg.exec.ExecOptions(), map_fn=None,
                                        reduce_fn=add, hedge_s=0.05)
        else:
            res = e._exec_remote_hedged(slow_node, "i", c, [0],
                                        pkg.exec.ExecOptions(), None, add,
                                        0.05)
        def token(peer):
            if pkg is JAX:
                return gens.token(peer, "i", "general", "standard", 0)
            ent = gens._peers.get(peer, {}).get(("i", 0))
            return None if ent is None else ent[0]["general/standard"]

        tok = [token("fastpeer:2"), token("slowpeer:1")]
        held.set()
        assert slow_done.wait(30)
        e.close()
        tok.append(token("slowpeer:1"))
        return [res, tok], []

    (res, tok), _, _ = _both(tmp_path, case)
    assert res == 3
    assert tok == [(1, 5), None, None]


def test_both_sides_fail_then_the_remap(tmp_path):
    """The hedge to c fails while the primary b is held; then b fails
    too: the primary's error surfaces, and the outer re-map serves b's
    slices from c."""
    def case(pkg, h, data):
        b_failed = threading.Event()
        client = Script(pkg, data, fail_until={"c": b_failed})
        # b answers only once c's hedge has failed, and then fails.
        client.held["b"] = client.failed
        client.then_fail.add("b")
        orig = client.execute_query

        def execute_query(node, *a, **kw):
            try:
                return orig(node, *a, **kw)
            finally:
                if node.host == "b":
                    b_failed.set()

        client.execute_query = execute_query
        e = _executor(pkg, h, client)
        before = _outcomes(pkg)
        res = e.execute("i", COUNT, slices=B_FIRST)
        e.close()
        return [res, _delta(before, _outcomes(pkg))], client.calls

    (res, outcomes), calls, data = _both(tmp_path, case)
    assert res == [sum(len(data[(1, s)]) for s in B_FIRST)]
    assert outcomes == {"fired": 1, "primary_won": 0, "hedge_won": 0}
    assert sorted(c[0] for c in calls) == ["b", "c", "c"]


@pytest.mark.parametrize("how", ["deadline", "cancel"])
def test_deadline_and_cancel_during_the_race(tmp_path, how):
    def case(pkg, h, data):
        held = threading.Event()
        client = Script(pkg, data, held={"b": held, "c": held})
        e = _executor(pkg, h, client)
        ctx = pkg.ctx.QueryContext(
            pql=COUNT, index="i",
            timeout_s=2.0 if how == "deadline" else None)
        if how == "cancel":
            # Cancelled once the hedge leg is out: both sides held.
            client.on_call = lambda host: host == "c" and ctx.cancel()
        try:
            e.execute("i", COUNT, slices=B_FIRST,
                      opt=pkg.exec.ExecOptions(ctx=ctx))
            got = "answered"
        except (pkg.errors.QueryDeadlineError,
                pkg.errors.QueryCancelledError) as err:
            got = type(err).__name__
        finally:
            held.set()
            e.close()
        return [got], client.calls

    (got,), calls, _ = _both(tmp_path, case)
    assert got == {"deadline": "QueryDeadlineError",
                   "cancel": "QueryCancelledError"}[how]
    assert sorted(c[0] for c in calls) == ["b", "c"]


def test_topn_pushdown_leg_hedged(tmp_path):
    def case(pkg, h, data):
        held = threading.Event()
        client = GenScript(pkg, data, held={"b": held})
        e = _executor(pkg, h, client)
        before = _outcomes(pkg)
        pushed = pkg.metrics.TOPN_PUSHDOWN.labels("merged").value
        try:
            res = e.execute("i", "TopN(frame=f, n=4)")
        finally:
            held.set()
            e.close()
        merged = pkg.metrics.TOPN_PUSHDOWN.labels("merged").value - pushed
        pairs = [(p.id, p.count) for p in res[0]]
        return [pairs, merged, _delta(before, _outcomes(pkg))], client.calls

    (pairs, merged, outcomes), calls, data = _both(tmp_path, case, seed=6)
    totals = {r: sum(len(data[(r, s)]) for s in range(N_SLICES))
              for r in ROWS}
    want = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))[:4]
    assert pairs == want
    assert merged == 1
    assert outcomes == {"fired": 1, "primary_won": 0, "hedge_won": 1}
    hedged = [c for c in calls if "pushdown=true" in c[1]
              and c[2] == tuple(B_FIRST)]
    assert sorted(c[0] for c in hedged) == ["b", "c"]


def test_writes_never_hedge(tmp_path):
    """A SetBit forwarded to a slow owner waits for it: no second leg,
    whatever the hedge floor."""
    col = B_FIRST[0] * SLICE_WIDTH + 11

    def case(pkg, h, data):
        held = threading.Event()
        client = Script(pkg, data, held={"b": held})
        e = _executor(pkg, h, client)
        before = _outcomes(pkg)
        release = threading.Timer(0.3, held.set)
        release.start()
        try:
            res = e.execute("i", f"SetBit(rowID=1, frame=general,"
                                 f" columnID={col})")
        finally:
            release.cancel()
            held.set()
            e.close()
        return [res, _delta(before, _outcomes(pkg))], client.calls

    (res, outcomes), calls, _ = _both(tmp_path, case)
    assert res == [True]
    assert outcomes == {"fired": 0, "primary_won": 0, "hedge_won": 0}
    assert sorted(c[0] for c in calls) == ["b", "c"]


# -- the setting reaches the server ------------------------------------------


@pytest.mark.parametrize("way", ["toml", "flag", "env"])
def test_hedge_setting_reaches_the_fault_manager(tmp_path, way):
    argv = ["server"]
    env = {}
    if way == "toml":
        path = tmp_path / "pilosa.toml"
        path.write_text('[fault]\nhedge = "50ms"\n')
        argv += ["-c", str(path)]
    elif way == "flag":
        argv += ["--fault.hedge", "50ms"]
    else:
        env["PILOSA_FAULT_HEDGE"] = "50ms"
    cfg = port_cli.load_server_config(
        port_cli.build_parser().parse_args(argv), env=env)
    if way != "flag":
        # The JAX verb reads the hedge from the file and the environment
        # only.
        want = jax_cli.load_server_config(
            jax_cli.build_parser().parse_args(argv), env=env)
        assert want.fault.hedge == cfg.fault.hedge
    assert cfg.to_toml() == tcfg.load("", env={
        "PILOSA_FAULT_HEDGE": "50ms"}).to_toml()
    assert jcfg.load("", env={"PILOSA_FAULT_HEDGE": "50ms"}).fault.hedge \
        == 0.05
    server = Server(str(tmp_path / "data"), host="127.0.0.1:0",
                    device="cpu", warmup=False, fault_config=cfg.fault)
    server.open()
    try:
        assert server.fault.snapshot()["hedgeS"] == 0.05
        assert server.fault.hedge_delay_s("peer:1") == 0.05
        assert server.fault.hedge_delay_s(server.host) is None
    finally:
        server.close()


def test_real_cluster_hedges_through_the_routing_client(tmp_path):
    """Three port servers in this process, each with a hedge floor of
    1 µs: every remote read leg is raced at once through the servers'
    own pooled clients (which take custody of the tokens), and every
    answer stays the seeded count."""
    from podenv import free_port

    from pilosa_tpu_torch.cluster.topology import Cluster, Node
    from pilosa_tpu_torch.utils.config import FaultConfig

    hosts = [f"127.0.0.1:{free_port()}" for _ in range(3)]
    servers = []
    try:
        for i, h in enumerate(hosts):
            s = Server(str(tmp_path / f"n{i}"), host=h, device="cpu",
                       warmup=False, cluster=Cluster(
                           nodes=[Node(x) for x in hosts], replica_n=2),
                       cluster_type="http", polling_interval=0,
                       anti_entropy_interval=0,
                       fault_config=FaultConfig(hedge=1e-6))
            s.open()
            servers.append(s)
        import urllib.request

        def post(path, body):
            req = urllib.request.Request(f"http://{hosts[0]}{path}",
                                         data=body, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200

        post("/index/i", b"{}")
        post("/index/i/frame/general", b"{}")
        data = _seed_data(9)
        cols = [c for s in range(N_SLICES) for c in data[(1, s)]]
        post("/index/i/query", " ".join(
            f"SetBit(rowID=1, frame=general, columnID={c})"
            for c in cols).encode())
        coord = servers[0]
        ex = coord.executor
        want = sum(len(data[(1, s)]) for s in range(N_SLICES))
        # Every Count fans out (no cluster cache), and the write legs'
        # latencies are forgotten: the delay is the 1 µs floor.
        ex.CLUSTER_CACHE_ENTRIES = 0
        coord.fault.health = type(coord.fault.health)(node=coord.host)
        before = _outcomes(TORCH)
        for _ in range(3):
            assert ex.execute("i", COUNT) == [want]
        got = _delta(before, _outcomes(TORCH))
        assert got["fired"] >= 1
        assert got["primary_won"] + got["hedge_won"] == got["fired"]
        assert any(coord.gens.newest("i", s) is not None
                   for s in range(N_SLICES))
    finally:
        for s in servers:
            s.close()
