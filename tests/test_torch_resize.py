"""Elastic cluster resize in the port against the JAX package.

Mirrors ``tests/test_resize.py`` class by class on the same seeded
inputs, and holds every case to the JAX package: the same movement
sets and owner maps, the same message and journal bytes (each read by
the other package), the same double-read answers and counters through
the same scripted transport, and — in process, over real sockets — a
port trio that grows, aborts, recovers and shrinks to the same answers
as a JAX trio on the same data. One mixed case has a port coordinator
grow a ``[port, JAX]`` cluster to ``[port, JAX, port]``.

Failpoints are process-global in each package, so an autouse fixture
disarms both registries around every case (a schedule armed by an
earlier test must never leak into a stream here).
"""

import io
import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import pilosa_tpu.cli.commands as jax_cli
import pilosa_tpu.cluster.broadcast as jbroadcast
import pilosa_tpu.cluster.client as jclient
import pilosa_tpu.cluster.generations as jgens
import pilosa_tpu.cluster.resize as jresize
import pilosa_tpu.cluster.topology as jtop
import pilosa_tpu.errors as jerrors
import pilosa_tpu.executor as jexec
import pilosa_tpu.fault as jfault
import pilosa_tpu.fault.failpoints as jfp
import pilosa_tpu.models.holder as jholder
import pilosa_tpu.obs.metrics as jmetrics
import pilosa_tpu.pql.parser as jparser
from pilosa_tpu.server.server import Server as JaxServer

import pilosa_tpu_torch.cli.commands as port_cli
import pilosa_tpu_torch.cluster.broadcast as tbroadcast
import pilosa_tpu_torch.cluster.client as tclient
import pilosa_tpu_torch.cluster.generations as tgens
import pilosa_tpu_torch.cluster.resize as tresize
import pilosa_tpu_torch.cluster.topology as ttop
import pilosa_tpu_torch.errors as terrors
import pilosa_tpu_torch.executor as texec
import pilosa_tpu_torch.fault as tfault
import pilosa_tpu_torch.fault.failpoints as tfp
import pilosa_tpu_torch.models.holder as tholder
import pilosa_tpu_torch.obs.metrics as tmetrics
import pilosa_tpu_torch.pql.parser as tparser
from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.server.server import Server as PortServer

pytestmark = pytest.mark.resize

JAX = types.SimpleNamespace(
    name="jax", Holder=jholder.Holder, exec=jexec, top=jtop,
    resize=jresize, broadcast=jbroadcast, gens=jgens, fp=jfp,
    metrics=jmetrics, errors=jerrors, ClientError=jclient.ClientError,
    Client=jclient.Client, FaultManager=jfault.FaultManager,
    parse=jparser.parse, Server=JaxServer, cli=jax_cli)
TORCH = types.SimpleNamespace(
    name="torch", Holder=tholder.Holder, exec=texec, top=ttop,
    resize=tresize, broadcast=tbroadcast, gens=tgens, fp=tfp,
    metrics=tmetrics, errors=terrors, ClientError=tclient.ClientError,
    Client=tclient.Client, FaultManager=tfault.FaultManager,
    parse=tparser.parse, Server=PortServer, cli=port_cli)
PKGS = (JAX, TORCH)


@pytest.fixture(autouse=True)
def _disarmed_failpoints():
    """Both packages' failpoint registries are process-global: start
    and end every case with nothing armed."""
    for fp in (jfp, tfp):
        fp.disarm_all()
    yield
    for fp in (jfp, tfp):
        fp.disarm_all()


# ---------------------------------------------------------------------------
# movement-set math and owner maps


TRANSITIONS = {"1to2": (1, 2), "2to3": (2, 3), "3to4": (3, 4),
               "4to3": (4, 3)}


def _hosts(n):
    return [f"node{i}:1" for i in range(n)]


class TestMovementMinimality:
    PARTITION_N = 256

    @pytest.mark.parametrize("replicas", [1, 2, 3])
    @pytest.mark.parametrize("step", sorted(TRANSITIONS))
    @pytest.mark.parametrize("partition_n", [16, 256])
    def test_movement_and_owner_maps_equal_jax(self, step, replicas,
                                               partition_n):
        a, b = TRANSITIONS[step]
        old, new = _hosts(a), _hosts(b)
        got = ttop.movement(old, new, partition_n, replicas)
        want = jtop.movement(old, new, partition_n, replicas)
        assert got == want
        if a < b:
            assert got, "growing must move something"
        for hosts in (old, new):
            tc = ttop.new_cluster(hosts, replica_n=replicas)
            jc = jtop.new_cluster(hosts, replica_n=replicas)
            tc.partition_n = jc.partition_n = partition_n
            for p in range(partition_n):
                assert ([n.host for n in tc.partition_nodes(p)]
                        == [n.host for n in jc.partition_nodes(p)])
                assert (ttop.owner_hosts(hosts, p, replicas,
                                         ttop.jump_hash)
                        == jtop.owner_hosts(hosts, p, replicas,
                                            jtop.jump_hash))

    @pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
    def test_grow_moves_one_over_n_plus_one(self, n):
        old = _hosts(n)
        mv = ttop.movement(old, old + [f"node{n}:1"], self.PARTITION_N, 1)
        frac, want = len(mv) / self.PARTITION_N, 1.0 / (n + 1)
        assert abs(frac - want) < max(0.08, 2.5 * want)
        assert mv == jtop.movement(old, old + [f"node{n}:1"],
                                   self.PARTITION_N, 1)

    @pytest.mark.parametrize("n", [2, 3, 5, 8])
    def test_grow_never_moves_between_survivors(self, n):
        old = _hosts(n)
        added = f"node{n}:1"
        mv = ttop.movement(old, old + [added], self.PARTITION_N, 1)
        assert mv
        for p, (o, nw) in mv.items():
            assert nw == (added,), (p, o, nw)

    def test_shrink_of_last_host_mirrors_grow(self):
        old = _hosts(5)
        grown = old + ["node5:1"]
        mv_grow = ttop.movement(old, grown, self.PARTITION_N, 1)
        mv_shrink = ttop.movement(grown, old, self.PARTITION_N, 1)
        assert set(mv_grow) == set(mv_shrink)
        for p in mv_grow:
            assert mv_grow[p] == (mv_shrink[p][1], mv_shrink[p][0])


# ---------------------------------------------------------------------------
# topology: epoch lifecycle, union placement, read fencing


def _placement(cl, hosts, index="i", n=64):
    """Every placement answer of slices 0..n-1 the resize touches."""
    out = []
    for s in range(n):
        out.append((
            tuple(x.host for x in cl.fragment_nodes(index, s)),
            tuple(x.host for x in cl.read_nodes(index, s)),
            tuple(cl.owns_fragment(h, index, s) for h in hosts),
            tuple(cl.read_allowed(h, index, s) for h in hosts),
            cl.moving_slice(index, s)))
    return out, cl.epoch, [x.host for x in cl.nodes]


def _lifecycle(pkg, old, new, replicas):
    """Placement after install, flip and finalize (grace open), and
    the wire forms, on one package's Cluster."""
    cl = pkg.top.new_cluster(old, replica_n=replicas)
    everyone = sorted(set(old) | set(new))
    seen = [_placement(cl, everyone)]
    rs = cl.install_resize("r1", new)
    seen.append((_placement(cl, everyone), rs.to_wire()))
    assert cl.flip_epoch("r1") is True
    assert cl.flip_epoch("r1") is False
    seen.append((_placement(cl, everyone), cl.resize.to_wire()))
    assert cl.finalize_resize("r1", grace_s=60.0)
    seen.append(_placement(cl, everyone))
    return seen


class TestTopologyResizeLifecycle:
    @pytest.mark.parametrize("replicas", [1, 2, 3])
    @pytest.mark.parametrize("step", sorted(TRANSITIONS))
    def test_lifecycle_equals_jax(self, step, replicas):
        a, b = TRANSITIONS[step]
        old, new = _hosts(a), _hosts(b)
        assert (_lifecycle(TORCH, old, new, replicas)
                == _lifecycle(JAX, old, new, replicas))

    def test_install_flip_finalize(self):
        cl = ttop.new_cluster(["a:1", "b:1"])
        rs = cl.install_resize("r1", ["a:1", "b:1", "c:1"])
        assert cl.epoch == 0 and rs.phase == ttop.RESIZE_MIGRATING
        s = next(s for s in range(64) if cl.moving_slice("i", s))
        _phase, old, new = cl.moving_slice("i", s)
        assert "c:1" in new and "c:1" not in old
        assert "c:1" in [n.host for n in cl.fragment_nodes("i", s)]
        assert "c:1" not in [n.host for n in cl.read_nodes("i", s)]
        assert cl.owns_fragment("c:1", "i", s)
        assert not cl.read_allowed("c:1", "i", s)
        cl.flip_epoch("r1")
        assert cl.epoch == 1 and cl.resize.phase == ttop.RESIZE_DRAINING
        assert "c:1" in [n.host for n in cl.read_nodes("i", s)]
        cl.finalize_resize("r1", grace_s=60.0)
        assert cl.resize is None
        for h in old:
            assert cl.owns_fragment(h, "i", s)
            assert not cl.read_allowed(h, "i", s)

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_second_resize_id_refused(self, pkg):
        cl = pkg.top.new_cluster(["a:1", "b:1"])
        cl.install_resize("r1", ["a:1", "b:1", "c:1"])
        cl.install_resize("r1", ["a:1", "b:1", "c:1"])
        with pytest.raises(ValueError):
            cl.install_resize("r2", ["a:1"])

    def test_abort_pre_flip_and_post_flip(self):
        out = []
        for pkg in PKGS:
            cl = pkg.top.new_cluster(["a:1", "b:1"])
            cl.install_resize("r1", ["a:1", "b:1", "c:1"])
            steps = [cl.abort_resize("r1"), cl.resize, cl.epoch,
                     cl.abort_resize("r1")]
            cl.install_resize("r2", ["a:1", "b:1", "c:1"])
            cl.flip_epoch("r2")
            steps += [cl.epoch, len(cl.nodes), cl.abort_resize("r2"),
                      cl.epoch, [n.host for n in cl.nodes]]
            out.append(steps)
        assert out[0] == out[1] == [True, None, 0, False, 1, 3, True, 0,
                                    ["a:1", "b:1"]]

    def test_grace_expires(self):
        out = []
        for pkg in PKGS:
            cl = pkg.top.new_cluster(["a:1", "b:1"])
            cl.install_resize("r1", ["a:1", "b:1", "c:1"])
            cl.flip_epoch("r1")
            cl.finalize_resize("r1", grace_s=0.0)
            time.sleep(0.01)
            out.append([cl.owns_fragment(h, "i", s)
                        for s in range(64) for h in ("a:1", "b:1")])
        assert out[0] == out[1]

    def test_non_moving_slices_identical_across_epochs(self):
        cl = ttop.new_cluster(["a:1", "b:1"])
        before = {s: tuple(n.host for n in cl.fragment_nodes("i", s))
                  for s in range(64)}
        cl.install_resize("r1", ["a:1", "b:1", "c:1"])
        moving = {s for s in range(64) if cl.moving_slice("i", s)}
        cl.flip_epoch("r1")
        cl.finalize_resize("r1", grace_s=0.0)
        for s in range(64):
            after = tuple(n.host for n in cl.fragment_nodes("i", s))
            assert (before[s] == after) == (s not in moving), s


# ---------------------------------------------------------------------------
# ResizeMessage wire, the journal, the wire state


MESSAGES = [
    dict(id="abc", phase="flip", epoch=3, old_hosts=["a:1"],
         new_hosts=["a:1", "b:1"], coordinator="a:1"),
    dict(id="r-ü", phase="prepare", epoch=0,
         old_hosts=["127.0.0.1:1", "127.0.0.1:2"],
         new_hosts=["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]),
    dict(id="", phase="abort", epoch=7, old_hosts=[], new_hosts=[]),
]


class TestWireAndJournal:
    @pytest.mark.parametrize("case", range(len(MESSAGES)))
    def test_message_bytes_equal_jax_both_ways(self, case):
        kw = MESSAGES[case]
        tb = tbroadcast.marshal_message(tbroadcast.ResizeMessage(**kw))
        jb = jbroadcast.marshal_message(jbroadcast.ResizeMessage(**kw))
        assert tb == jb and tb[0] == tbroadcast.MESSAGE_TYPE_RESIZE == 7
        for raw, pkg in ((jb, TORCH), (tb, JAX)):
            got = pkg.broadcast.unmarshal_message(raw)
            assert isinstance(got, pkg.broadcast.ResizeMessage)
            assert (got.id, got.phase, got.epoch, got.old_hosts,
                    got.new_hosts, got.coordinator) == (
                kw["id"], kw["phase"], kw["epoch"], kw["old_hosts"],
                kw["new_hosts"], kw.get("coordinator", ""))

    @pytest.mark.parametrize("writer,reader", [(JAX, TORCH),
                                               (TORCH, JAX)],
                             ids=["jax-to-port", "port-to-jax"])
    @pytest.mark.parametrize("phase,acked,in_flight", [
        ("streaming", None, True), ("flipping", None, True),
        ("done", None, False), ("aborted", False, True),
        ("aborted", True, False)])
    def test_journal_read_by_the_other_package(self, tmp_path, writer,
                                               reader, phase, acked,
                                               in_flight):
        j = writer.resize.ResizeJournal.for_data_dir(str(tmp_path))
        assert j.load() is None
        upd = dict(id="r1", phase=phase, epochFrom=2, old=["a:1"],
                   new=["a:1", "b:1"], coordinator="a:1",
                   movingPartitions=[1, 5])
        if acked is not None:
            upd["abortAcked"] = acked
        j.write(**upd)
        r = reader.resize.ResizeJournal.for_data_dir(str(tmp_path))
        state = r.load()
        assert state == j.state
        assert r.in_flight() is in_flight is j.in_flight()

    def test_journal_path_and_phases_equal_jax(self, tmp_path):
        assert tresize.JOURNAL_FILE == jresize.JOURNAL_FILE
        assert tresize.PHASES == jresize.PHASES
        assert (tresize.MAX_STREAM_PASSES, tresize.ACK_RETRIES) == (
            jresize.MAX_STREAM_PASSES, jresize.ACK_RETRIES)
        assert (tresize.ResizeJournal.for_data_dir(str(tmp_path)).path
                == jresize.ResizeJournal.for_data_dir(str(tmp_path)).path)

    @pytest.mark.parametrize("pkg", PKGS, ids=lambda p: p.name)
    def test_torn_journal_ignored(self, tmp_path, pkg):
        path = os.path.join(str(tmp_path), pkg.resize.JOURNAL_FILE)
        with open(path, "w") as f:
            f.write('{"version": 1, "phase": "stre')
        j = pkg.resize.ResizeJournal(path)
        assert j.load() is None and not j.in_flight()

    def test_resize_state_wire_equal_jax(self):
        out = []
        for pkg in PKGS:
            cl = pkg.top.new_cluster(["a:1", "b:1"], replica_n=2)
            cl.install_resize("w1", ["a:1", "b:1", "c:1"])
            pre = cl.resize.to_wire()
            cl.flip_epoch("w1")
            out.append((pre, cl.resize.to_wire()))
        assert out[0] == out[1]

    def test_resize_state_gauge_one_hot(self):
        tresize.set_state_gauge("streaming")
        vals = {p: tmetrics.RESIZE_STATE.labels(p).value
                for p in tresize.PHASES}
        assert vals["streaming"] == 1.0 and sum(vals.values()) == 1.0
        tresize.set_state_gauge("idle")


# ---------------------------------------------------------------------------
# executor: read fencing, the double read's three exits, caches


class ScriptedClient:
    generation_aware = True
    deadline_aware = False

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def execute_query(self, node, index, query, slices, remote,
                      gens_out=None, **kwargs):
        self.calls.append((node.host, query, tuple(slices or ())))
        return self.fn(node, index, query, slices, gens_out)


def _executor(pkg, holder, **kw):
    if pkg is JAX:
        return pkg.exec.Executor(holder, use_mesh=False, **kw)
    return pkg.exec.Executor(holder, device="cpu", **kw)


def _seeded_holder(pkg, path, n_slices=4):
    h = pkg.Holder(str(path / pkg.name))
    h.open()
    idx = h.create_index_if_not_exists("i")
    f = idx.create_frame_if_not_exists("f")
    for s in range(n_slices):
        f.set_bit("standard", 1, s * SLICE_WIDTH + 1)
    idx.set_remote_max_slice(n_slices - 1)
    return h


def _peer_moving(cluster, n=4):
    return [s for s in range(n)
            if cluster.moving_slice("i", s) is not None
            and cluster.moving_slice("i", s)[1] == ("peer:1",)]


def _run_both(tmp_path, case, n_slices=4):
    """``case(pkg, holder)`` on a seeded JAX holder and a seeded port
    holder; both must give the same outcome."""
    out = []
    for pkg in PKGS:
        h = _seeded_holder(pkg, tmp_path, n_slices)
        try:
            out.append(case(pkg, h))
        finally:
            h.close()
    assert out[0] == out[1], out
    return out[1]


COUNT = 'Count(Bitmap(rowID=1, frame="f"))'


def _double_reads(pkg):
    return (pkg.metrics.RESIZE_DOUBLE_READS.labels("source").value,
            pkg.metrics.RESIZE_DOUBLE_READS.labels("target").value)


def _delta(before, after):
    return tuple(b - a for a, b in zip(before, after))


class TestExecutorResize:
    def _setup(self, pkg, holder, fn, hosts=("local", "peer:1"),
               replicas=1, **kw):
        cluster = pkg.top.new_cluster(list(hosts), replica_n=replicas)
        client = ScriptedClient(fn)
        e = _executor(pkg, holder, host="local", cluster=cluster,
                      client=client, **kw)
        return e, client, cluster

    def test_remote_leg_fenced_on_migration_target(self, tmp_path):
        def case(pkg, h):
            cluster = pkg.top.new_cluster(["a:1", "b:1"], replica_n=1)
            e = _executor(pkg, h, host="local", cluster=cluster)
            cluster.install_resize("r1", ["a:1", "b:1", "local"])
            moving = [s for s in range(4)
                      if cluster.moving_slice("i", s) is not None]
            assert moving
            with pytest.raises(pkg.errors.SliceUnavailableError):
                e.execute("i", COUNT, slices=moving,
                          opt=pkg.exec.ExecOptions(remote=True))
            cluster.flip_epoch("r1")
            res = e.execute("i", COUNT, slices=moving,
                            opt=pkg.exec.ExecOptions(remote=True))
            return moving, res[0]

        moving, n = _run_both(tmp_path, case)
        assert n == len(moving)

    def test_double_read_source_wins(self, tmp_path):
        def case(pkg, h):
            e, client, cluster = self._setup(
                pkg, h, lambda node, index, q, slices, g: [len(slices)])
            cluster.install_resize("r1", ["local", "peer:1", "new:1"])
            moving = _peer_moving(cluster)
            assert moving
            before = _double_reads(pkg)
            res = e.execute("i", COUNT)
            # The old owner answered the moving slices (the target leg
            # is cancelled or abandoned once it has, so whether it ran
            # is a race in both packages).
            asked = {c[0] for c in client.calls if set(c[2]) & set(moving)}
            return (res[0], moving, "peer:1" in asked,
                    _delta(before, _double_reads(pkg)))

        n, moving, asked_old, delta = _run_both(tmp_path, case)
        assert n == 4 and asked_old and delta == (1, 0)

    def test_double_read_target_wins_only_post_flip_shape(self, tmp_path):
        def case(pkg, h):
            def fn(node, index, query, slices, gens_out):
                if node.host == "peer:1":
                    raise pkg.ClientError("old owner SIGKILLed")
                if gens_out is not None:
                    gens_out.append((node.host, pkg.gens.encode_wire(
                        index, {s: {"f/standard": (9, 5)}
                                for s in slices})))
                return [len(slices) * 10]

            e, client, cluster = self._setup(pkg, h, fn)
            e.gens = (pkg.gens.GenerationMap(staleness_s=60.0)
                      if pkg is JAX else pkg.gens.GenerationMap())
            cluster.install_resize("r1", ["local", "peer:1", "new:1"])
            moving = _peer_moving(cluster)
            assert moving
            before = _double_reads(pkg)
            res = e.execute("i", COUNT, slices=moving)
            return (res[0], _delta(before, _double_reads(pkg)),
                    e.gens.newest("i", moving[0])[:2])

        n, delta, newest = _run_both(tmp_path, case)
        assert delta == (0, 1)
        assert newest == ("new:1", {"f/standard": (9, 5)})

    def test_double_read_stale_target_tokens_lose(self, tmp_path):
        """The losing side's generation tokens are never applied: the
        regressed target loses, the old side's error surfaces, and the
        map keeps what it knew."""
        def case(pkg, h):
            def fn(node, index, query, slices, gens_out):
                if node.host == "peer:1":
                    raise pkg.ClientError("old owner dead")
                if gens_out is not None:
                    gens_out.append((node.host, pkg.gens.encode_wire(
                        index, {s: {"f/standard": (9, 1)}
                                for s in slices})))
                return [999]

            e, client, cluster = self._setup(pkg, h, fn)
            e.gens = (pkg.gens.GenerationMap(staleness_s=60.0)
                      if pkg is JAX else pkg.gens.GenerationMap())
            cluster.install_resize("r1", ["local", "peer:1", "new:1"])
            moving = _peer_moving(cluster)
            e.gens.apply("new:1", "i", {moving[0]: {"f/standard": (9, 4)}})
            before = _double_reads(pkg)
            with pytest.raises(pkg.ClientError) as ei:
                e.execute("i", COUNT, slices=moving)
            return (str(ei.value), _delta(before, _double_reads(pkg)),
                    e.gens.newest("i", moving[0])[:2])

        err, delta, newest = _run_both(tmp_path, case)
        assert "old owner dead" in err and delta == (0, 0)
        assert newest == ("new:1", {"f/standard": (9, 4)})

    def test_double_read_partial_mode_reports_missing(self, tmp_path):
        """Both sides down under ?partial=1: each moving slice goes
        into the missing list once."""
        def case(pkg, h):
            def fn(node, index, query, slices, gens_out):
                raise pkg.ClientError("everyone is dead")

            e, client, cluster = self._setup(pkg, h, fn)
            cluster.install_resize("r1", ["local", "peer:1", "new:1"])
            moving = _peer_moving(cluster)
            opt = pkg.exec.ExecOptions(partial=True)
            res = e.execute("i", COUNT, slices=moving, opt=opt)
            return res[0], list(opt.missing_slices), moving

        n, missing, moving = _run_both(tmp_path, case)
        assert n == 0 and sorted(missing) == sorted(moving)
        assert len(missing) == len(set(missing))

    def test_double_read_partial_whole_query(self, tmp_path):
        """?partial=1 over every slice with every peer down: the local
        slices answer, the rest (moving or not) are reported once."""
        def case(pkg, h):
            def fn(node, index, query, slices, gens_out):
                raise pkg.ClientError("down")

            e, client, cluster = self._setup(pkg, h, fn)
            cluster.install_resize("r1", ["local", "peer:1", "new:1"])
            opt = pkg.exec.ExecOptions(partial=True)
            res = e.execute("i", COUNT, opt=opt)
            return res[0], sorted(opt.missing_slices)

        n, missing = _run_both(tmp_path, case)
        assert len(missing) == len(set(missing))
        assert n + len(missing) == 4

    @pytest.mark.parametrize("old_side", ["fails", "held"])
    def test_double_read_with_hedge_configured(self, tmp_path, old_side):
        """A moving slice's old owner stopped while a hedge is
        configured: the double read does not hedge; its old side fails
        over to the next old owner (``fails``) or waits the stalled one
        out (``held``), and the old side's answer wins. The coordinator
        ``local`` owns nothing, so every leg is remote."""
        hosts = ("a", "b", "c")

        def case(pkg, h):
            release = threading.Event()

            def fn(node, index, query, slices, gens_out):
                if node.host == first_old[0]:
                    if old_side == "fails":
                        raise pkg.ClientError("stopped")
                    release.wait(10)
                return [len(slices)]

            fault = pkg.FaultManager(hedge_s=0.05, node="local")
            e, client, cluster = self._setup(pkg, h, fn, hosts=hosts,
                                             replicas=2, fault=fault)
            cluster.install_resize("r1", ["a", "b", "c", "d"])
            groups = e._resize_moving_groups("i", list(range(16))) or {}
            picked = [(olds, s) for (olds, _new), ss in groups.items()
                      if "local" not in olds for s in ss]
            assert picked, "no remote-only moving slice in this layout"
            first_old = [picked[0][0][0]]
            slices = [picked[0][1]]
            fired0 = pkg.metrics.HEDGED_REQUESTS.labels("fired").value
            before = _double_reads(pkg)
            if old_side == "held":
                threading.Timer(0.3, release.set).start()
            res = e.execute("i", COUNT, slices=slices)
            release.set()
            fired = (pkg.metrics.HEDGED_REQUESTS.labels("fired").value
                     - fired0)
            return res[0], _delta(before, _double_reads(pkg)), fired

        assert _run_both(tmp_path, case, n_slices=16) == (1, (1, 0), 0)

    def test_grace_window_never_keys_on_frozen_local_copy(self, tmp_path):
        """Inside the post-finalize grace an old owner write-accepts a
        moved slice but has no read authority: the cluster cache's
        token snapshot classifies it by read authority in both
        packages. The port's bitmap-result key never keys a slice this
        node does not serve (the JAX key embeds the new owner's
        tokens), so it declines."""
        def case(pkg, h):
            gens = (pkg.gens.GenerationMap(staleness_s=60.0)
                    if pkg is JAX else pkg.gens.GenerationMap())
            cluster = pkg.top.new_cluster(["local", "peer:1"],
                                          replica_n=1)
            e = _executor(pkg, h, host="local", cluster=cluster,
                          client=ScriptedClient(lambda *a: [0]),
                          gens=gens)
            cluster.install_resize("g1", ["local", "peer:1", "new:1"])
            moved = next(
                (s for s in range(64)
                 if cluster.moving_slice("i", s) is not None
                 and cluster.moving_slice("i", s)[1] == ("local",)))
            h.index("i").frame("f").set_bit("standard", 1,
                                            moved * SLICE_WIDTH + 3)
            cluster.flip_epoch("g1")
            cluster.finalize_resize("g1", grace_s=60.0)
            steps = [cluster.owns_fragment("local", "i", moved),
                     cluster.read_allowed("local", "i", moved),
                     e._cluster_cache_snapshot("i", [moved])]
            gens.apply("new:1", "i", {moved: {"f/standard": (9, 4)}})
            snap = e._cluster_cache_snapshot("i", [moved])
            steps.append((sorted(snap["local"]),
                          snap["remote"]["new:1"][moved]))
            gens.apply("peer:1", "i", {moved: {"f/standard": (5, 7)}})
            steps.append(e._cluster_cache_snapshot("i", [moved]))
            call = pkg.parse('Union(Bitmap(rowID=1, frame=f),'
                             ' Bitmap(rowID=2, frame=f))').calls[0]
            key = e._bitmap_result_key("i", call, [moved])
            return steps, key

        out = []
        for pkg in PKGS:
            h = _seeded_holder(pkg, tmp_path)
            try:
                out.append(case(pkg, h))
            finally:
                h.close()
        (jsteps, jkey), (tsteps, tkey) = out
        assert tsteps == jsteps
        assert tsteps[:3] == [True, False, None]
        assert tsteps[3] == ([], {"f/standard": (9, 4)})
        assert jkey is not None and all(p != "" for p, _u, _g in jkey[3])
        assert tkey is None

    def test_epoch_bump_invalidates_result_caches(self, tmp_path):
        q = 'Union(Bitmap(rowID=10, frame=g), Bitmap(rowID=11, frame=g))'

        def case(pkg, h):
            f = h.index("i").create_frame_if_not_exists("g")
            f.set_bit("standard", 10, 3)
            f.set_bit("standard", 11, 3)
            cluster = pkg.top.new_cluster(["local"], replica_n=1)
            cluster.hasher = lambda key, n: 0
            e = _executor(pkg, h, host="local", cluster=cluster)
            first = e.execute("i", q)[0].count()
            key = next(iter(e._bitmap_results))
            cluster.install_resize("r1", ["local", "new:1"])
            e.on_resize_change()
            call = pkg.parse(q).calls[0]
            during = e._bitmap_result_key("i", call, [0])
            cluster.flip_epoch("r1")
            e.on_resize_change(lambda index, s: True)
            flushed = not e._bitmap_results
            cluster.finalize_resize("r1", grace_s=0.0)
            again = e.execute("i", q)[0].count()
            key2 = next(iter(e._bitmap_results))
            return (first, key[-1], during, flushed, again, key2[-1],
                    key2 != key)

        assert _run_both(tmp_path, case) == (1, 0, None, True, 1, 1,
                                             True)

    def test_union_writes_reach_both_epochs_owners(self, tmp_path):
        """While a resize is in flight a SetBit of a moving slice goes
        to the old AND the new owners, in both packages."""
        def case(pkg, h):
            calls = []

            def fn(node, index, query, slices, gens_out):
                calls.append(node.host)
                return [True]

            e, client, cluster = self._setup(pkg, h, fn)
            cluster.install_resize("r1", ["local", "peer:1", "new:1"])
            out = []
            for s in range(8):
                mv = cluster.moving_slice("i", s)
                if mv is None:
                    continue
                calls.clear()
                e.execute("i", f'SetBit(frame="f", rowID=3,'
                               f' columnID={s * SLICE_WIDTH + 7})')
                frag = h.fragment("i", "f", "standard", s)
                local = frag is not None and frag.row(3).count() > 0
                out.append((s, mv[1], mv[2], sorted(calls), local))
            return out

        got = _run_both(tmp_path, case)
        assert got
        for s, old, new, remote, local in got:
            union = set(old) | set(new)
            assert set(remote) | ({"local"} if local else set()) == union


# ---------------------------------------------------------------------------
# in-process coordinator protocol: port trios held to JAX trios


def _post(host, path, body=b"{}"):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST")
    return urllib.request.urlopen(req, timeout=30).read()


def _get(host, path):
    return json.loads(urllib.request.urlopen(
        f"http://{host}{path}", timeout=10).read())


def _query(host, index, body):
    return json.loads(
        _post(host, f"/index/{index}/query", body.encode()))["results"]


def _wait_resize(host, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        op = _get(host, "/cluster/resize")["op"]
        if op and op["phase"] in ("done", "aborted"):
            return op
        time.sleep(0.05)
    raise AssertionError("resize did not settle")


def _seed_trio_data():
    rng = np.random.default_rng(5)
    n_bits = 2000
    rows = rng.integers(0, 8, n_bits).astype(np.uint64)
    cols = rng.choice(6 * SLICE_WIDTH, size=n_bits,
                      replace=False).astype(np.uint64)
    model: dict = {}
    for r, c in zip(rows.tolist(), cols.tolist()):
        model.setdefault(int(r), set()).add(int(c))
    return rows, cols, model


def _make_trio(pkg, root, kinds=None):
    """Three in-process servers: the first two a static cluster, the
    third booted knowing the CURRENT membership (the join candidate),
    with the seeded data imported through the first."""
    servers = []
    for i in range(3):
        spkg = (kinds or (pkg, pkg, pkg))[i]
        kw = dict(host="127.0.0.1:0", anti_entropy_interval=0,
                  polling_interval=0)
        if spkg is TORCH:
            kw.update(device="cpu", warmup=False)
        s = spkg.Server(str(root / f"{spkg.name}{i}"), **kw)
        s.open()
        servers.append(s)
    s1, s2, _s3 = servers
    for s in servers:
        nodecls = (TORCH if isinstance(s, PortServer) else JAX).top.Node
        s.cluster.nodes = [nodecls(s1.host), nodecls(s2.host)]
    for s in servers:
        _post(s.host, "/index/rz")
        _post(s.host, "/index/rz/frame/f")
    rows, cols, model = _seed_trio_data()
    pkg.Client(s1.host).import_arrays("rz", "f", rows, cols)
    for s in servers:
        s.holder.index("rz").set_remote_max_slice(5)
    return servers, model


def _close_all(servers):
    for s in servers:
        try:
            s.close()
        except Exception:  # noqa: BLE001 - teardown best-effort
            pass


@pytest.fixture
def trio(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    servers, model = _make_trio(TORCH, tmp_path)
    yield servers, model
    _close_all(servers)


@pytest.fixture
def jax_trio(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    servers, model = _make_trio(JAX, tmp_path)
    yield servers, model
    _close_all(servers)


READS = [f'Count(Bitmap(frame="f", rowID={r}))' for r in range(8)] + [
    'Count(Intersect(Bitmap(frame="f", rowID=1),'
    ' Bitmap(frame="f", rowID=2)))',
    'TopN(frame="f", n=5)']


def _answers(hosts):
    return {h: [_query(h, "rz", q)[0] for q in READS] for h in hosts}


def _differential(hosts, model, jax_hosts=None):
    """Every host answers the model exactly; with ``jax_hosts`` each
    answer also equals the JAX trio's, TopN order included."""
    got = _answers(hosts)
    for h, answers in got.items():
        for row in range(8):
            assert answers[row] == len(model.get(row, set())), (h, row)
    if jax_hosts:
        want = _answers(jax_hosts)
        ref = next(iter(want.values()))
        for h, answers in list(got.items()) + list(want.items()):
            assert answers == ref, h


def _resize(host, body):
    return _post(host, "/cluster/resize", json.dumps(body).encode())


def _grow(servers):
    s1, s2, s3 = servers
    _resize(s1.host, {"hosts": [s1.host, s2.host, s3.host]})
    return _wait_resize(s1.host)


class TestCoordinatorInProcess:
    def test_grow_under_live_load_zero_wrong_answers(self, trio,
                                                     jax_trio):
        (s1, s2, s3), model = trio
        stop = threading.Event()
        errors: list = []
        written: list = []

        def loadgen():
            i = 0
            while not stop.is_set():
                col = int(6 * SLICE_WIDTH - 1 - i)
                i += 1
                try:
                    _query((s1, s2)[i % 2].host, "rz",
                           f'SetBit(frame="f", rowID=30,'
                           f' columnID={col})')
                    written.append(col)
                    for h in (s1.host, s2.host):
                        got = _query(
                            h, "rz",
                            'Count(Bitmap(frame="f", rowID=2))')[0]
                        if got != len(model[2]):
                            errors.append((h, got, len(model[2])))
                except Exception as e:  # noqa: BLE001 - recorded
                    errors.append(("load", repr(e)))
                time.sleep(0.005)

        t = threading.Thread(target=loadgen)
        t.start()
        try:
            op = _grow((s1, s2, s3))
        finally:
            stop.set()
            t.join(timeout=30)
        assert not t.is_alive()
        assert op["phase"] == "done", op
        assert not errors, errors[:5]
        for s in (s1, s2, s3):
            assert s.cluster.epoch == 1
            assert len(s.cluster.nodes) == 3
            assert s.cluster.resize is None
        (j1, j2, j3), _ = jax_trio
        jop = _grow((j1, j2, j3))
        assert jop["phase"] == "done"
        assert (op["slicesMoved"], op["movingPartitions"]) == (
            jop["slicesMoved"], jop["movingPartitions"])
        _differential((s1.host, s2.host, s3.host), model,
                      (j1.host, j2.host, j3.host))
        counts = {h: _query(h, "rz",
                            'Count(Bitmap(frame="f", rowID=30))')[0]
                  for h in (s1.host, s2.host, s3.host)}
        assert set(counts.values()) == {len(written)}, counts
        assert any(s3.cluster.owns_fragment(s3.host, "rz", s)
                   for s in range(6))
        assert op["slicesMoved"] >= 1 and op["bytesStreamed"] > 0

    @pytest.mark.chaos
    def test_torn_stream_aborts_then_retry_succeeds(self, trio, jax_trio):
        """torn(48): the first pushed block lands as a prefix on the
        target and the stream fails; the resize aborts cluster-wide
        back to epoch 0, the old epoch answers exactly, and a retry
        converges by the idempotent block re-diff.

        The documented state machine (docs/CLUSTER_RESIZE.md) makes
        ``aborted`` mean "back to the old epoch": the port's coordinator
        publishes it only after its abort broadcast, so every node is
        clear the moment the phase reads ``aborted``. The JAX
        coordinator publishes it before the broadcast (ROADMAP fault
        3.15): its nodes are polled until clear."""
        (s1, s2, s3), model = trio
        (j1, j2, j3), _ = jax_trio
        ops = []
        for pkg, servers in ((TORCH, (s1, s2, s3)), (JAX, (j1, j2, j3))):
            pkg.fp.arm("resize.stream", "torn(48)")
            op = _grow(servers)
            pkg.fp.disarm_all()
            assert op["phase"] == "aborted", op
            assert "resize.stream" in (op["error"] or "")
            if pkg is JAX:
                deadline = time.time() + 30
                while (any(s.cluster.resize is not None for s in servers)
                       and time.time() < deadline):
                    time.sleep(0.01)
            for s in servers:
                assert s.cluster.epoch == 0
                assert s.cluster.resize is None
                assert len(s.cluster.nodes) == 2
            ops.append(op)
        assert (ops[0]["error"], ops[0]["slicesMoved"]) == (
            ops[1]["error"], ops[1]["slicesMoved"])
        _differential((s1.host, s2.host), model, (j1.host, j2.host))
        for servers in ((s1, s2, s3), (j1, j2, j3)):
            assert _grow(servers)["phase"] == "done"
        _differential((s1.host, s2.host, s3.host), model,
                      (j1.host, j2.host, j3.host))

    @pytest.mark.chaos
    def test_aborted_is_visible_only_after_the_broadcast(self, trio,
                                                        monkeypatch):
        """Fault 3.15 not copied: with the abort's journal write made
        slow (0.3 s, a slow fsync), the coordinator still reports
        ``aborted`` only once every node has cleared the installed
        resize."""
        (s1, s2, s3), model = trio
        write = tresize.ResizeJournal.write

        def slow_write(self, **updates):
            write(self, **updates)
            if updates.get("phase") == tresize.PHASE_ABORTED:
                time.sleep(0.3)

        monkeypatch.setattr(tresize.ResizeJournal, "write", slow_write)
        tfp.arm("resize.stream", "torn(48)")
        _resize(s1.host, {"hosts": [s1.host, s2.host, s3.host]})
        while True:
            op = _get(s1.host, "/cluster/resize")["op"]
            if op and op["phase"] == "aborted":
                break
            assert not op or op["phase"] != "done", op
            time.sleep(0.005)
        assert [s.cluster.resize for s in (s1, s2, s3)] == [None] * 3
        assert all(s.cluster.epoch == 0 for s in (s1, s2, s3))
        _differential((s1.host, s2.host), model)

    @pytest.mark.chaos
    def test_intermittent_stream_errors_survive(self, trio, jax_trio):
        """error*2: the first attempt aborts on the first injected
        error in both packages; the cluster is consistent either way."""
        (s1, s2, s3), model = trio
        (j1, j2, j3), _ = jax_trio
        phases = []
        for pkg, servers in ((TORCH, (s1, s2, s3)), (JAX, (j1, j2, j3))):
            pkg.fp.arm("resize.stream", "error*2")
            op = _grow(servers)
            pkg.fp.disarm_all()
            phases.append(op["phase"])
            if op["phase"] == "aborted":
                assert all(s.cluster.epoch == 0 for s in servers)
            else:
                assert all(s.cluster.epoch == 1 for s in servers)
        assert phases[0] == phases[1]
        hosts = (s1.host, s2.host) + (
            (s3.host,) if phases[0] == "done" else ())
        jhosts = (j1.host, j2.host) + (
            (j3.host,) if phases[1] == "done" else ())
        _differential(hosts, model, jhosts)

    @pytest.mark.chaos
    def test_operator_abort_mid_stream_stops_the_coordinator(self, trio,
                                                             jax_trio):
        (s1, s2, s3), model = trio
        tfp.arm("resize.stream", "delay(700ms)")
        _resize(s1.host, {"hosts": [s1.host, s2.host, s3.host]})
        deadline = time.time() + 30
        while time.time() < deadline:
            op = _get(s1.host, "/cluster/resize")["op"] or {}
            if op.get("phase") == "streaming":
                break
            assert op.get("phase") not in ("done", "aborted"), op
            time.sleep(0.02)
        body = json.loads(_resize(s1.host, {"abort": True}))
        assert body["op"]["phase"] == "aborted"
        op = _wait_resize(s1.host)
        tfp.disarm_all()
        assert op["phase"] == "aborted", op
        time.sleep(1.0)
        assert _get(s1.host, "/cluster/resize")["op"]["phase"] == "aborted"
        for s in (s1, s2, s3):
            assert s.cluster.epoch == 0
            assert s.cluster.resize is None
        (j1, j2, j3), _ = jax_trio
        _differential((s1.host, s2.host), model, (j1.host, j2.host))
        assert _grow((s1, s2, s3))["phase"] == "done"
        assert _grow((j1, j2, j3))["phase"] == "done"
        _differential((s1.host, s2.host, s3.host), model,
                      (j1.host, j2.host, j3.host))

    @pytest.mark.chaos
    def test_partition_during_epoch_flip(self, trio):
        """The flip-window leg: the coordinator streams, then a one-way
        partition cuts the joiner off the control plane — s1 and s2
        flip, s3 cannot. Reads inside the mixed-epoch window stay exact
        (moved-slice legs to the unflipped target fail its read fence
        and fail over to the old owner), and once the partition heals
        the flip completes cluster-wide."""
        from pilosa_tpu_torch.server.syncer import FragmentStreamer
        (s1, s2, s3), model = trio
        coord = tresize.ResizeCoordinator(s1, [s1.host, s2.host, s3.host])
        coord.moving = ttop.movement(
            coord.old_hosts, coord.target_hosts,
            s1.cluster.partition_n, s1.cluster.replica_n)
        coord.journal.write(id=coord.id, epochFrom=0,
                            old=coord.old_hosts, new=coord.target_hosts,
                            coordinator=s1.host)
        coord._set_phase(tresize.PHASE_PREPARING)
        coord._send_phase(coord._message("prepare"), coord._union_hosts(),
                          require_all=True)
        coord._sync_slice_knowledge()
        streamer = FragmentStreamer(client_factory=s1._client_factory,
                                    on_block=coord._on_stream_block)
        coord._set_phase(tresize.PHASE_STREAMING)
        for _ in range(tresize.MAX_STREAM_PASSES):
            if coord._stream_pass(streamer) == 0:
                break
        tfp.arm("rpc.send", f"partition({s3.host})")
        flip_err: list = []

        def do_flip():
            try:
                coord._set_phase(tresize.PHASE_FLIPPING)
                coord._send_phase(coord._message("flip"),
                                  coord._union_hosts(), require_all=True,
                                  retries=60)
            except Exception as e:  # noqa: BLE001 - recorded
                flip_err.append(e)

        t = threading.Thread(target=do_flip)
        t.start()
        deadline = time.time() + 10
        while time.time() < deadline and not (
                s1.cluster.epoch == 1 and s2.cluster.epoch == 1):
            time.sleep(0.05)
        assert s1.cluster.epoch == 1 and s2.cluster.epoch == 1
        assert s3.cluster.epoch == 0
        for _ in range(3):
            _differential((s1.host, s2.host), model)
        tfp.disarm_all()
        t.join(timeout=60)
        assert not t.is_alive() and not flip_err, flip_err
        assert s3.cluster.epoch == 1
        coord._set_phase(tresize.PHASE_DRAINING)
        coord._stream_pass(streamer)
        coord._set_phase(tresize.PHASE_FINALIZING)
        coord._send_phase(coord._message("finalize"), coord._union_hosts(),
                          require_all=False)
        coord._set_phase(tresize.PHASE_DONE)
        for s in (s1, s2, s3):
            assert s.cluster.resize is None and s.cluster.epoch == 1
        _differential((s1.host, s2.host, s3.host), model)

    def test_shrink_back(self, trio, jax_trio):
        (s1, s2, s3), model = trio
        (j1, j2, j3), _ = jax_trio
        for servers in ((s1, s2, s3), (j1, j2, j3)):
            a, b, c = servers
            assert _grow(servers)["phase"] == "done"
            _resize(b.host, {"remove": c.host})
            op = _wait_resize(b.host)
            assert op["phase"] == "done", op
            for s in (a, b):
                assert s.cluster.epoch == 2 and len(s.cluster.nodes) == 2
        _differential((s1.host, s2.host), model, (j1.host, j2.host))

    def test_one_resize_at_a_time(self, trio):
        (s1, s2, s3), _model = trio
        s1.cluster.install_resize("blocker", [s1.host, s2.host, "x:1"])
        with pytest.raises(urllib.error.HTTPError) as ei:
            _resize(s1.host, {"hosts": [s1.host, s2.host, s3.host]})
        assert ei.value.code == 409
        s1.cluster.abort_resize("blocker")

    @pytest.mark.parametrize("body,code", [
        ({}, 400), ({"add": "SELF"}, 400), ({"remove": "x:9"}, 400),
        ({"abort": True}, 409)])
    def test_post_errors_equal_jax(self, trio, jax_trio, body, code):
        got = []
        for servers in (trio[0], jax_trio[0]):
            b = {k: (servers[0].host if v == "SELF" else v)
                 for k, v in body.items()}
            with pytest.raises(urllib.error.HTTPError) as ei:
                _resize(servers[0].host, b)
            got.append((ei.value.code, ei.value.read().decode().replace(
                servers[0].host, "HOST")))
        assert got[0] == got[1] and got[0][0] == code

    def test_no_coordinator_answers_503(self, tmp_path):
        """A handler without a resize server behind it answers 503 on
        POST, as the JAX handler does."""
        from pilosa_tpu.server.handler import Handler as JHandler
        from pilosa_tpu_torch.server.handler import Handler as THandler
        out = []
        for pkg, cls in ((JAX, JHandler), (TORCH, THandler)):
            h = pkg.Holder(str(tmp_path / pkg.name))
            h.open()
            try:
                app = cls(h, _executor(pkg, h), host="local")
                status = []
                body = b"".join(app(
                    {"REQUEST_METHOD": "POST", "PATH_INFO":
                     "/cluster/resize", "QUERY_STRING": "",
                     "wsgi.input": io.BytesIO(b'{"add": "x:1"}'),
                     "CONTENT_LENGTH": "14"},
                    lambda st, hd: status.append(st)))
                out.append((status[0].split()[0], body))
            finally:
                h.close()
        assert out[0] == out[1] and out[0][0] == "503"

    def test_journal_recovery_pre_flip_aborts(self, trio):
        (s1, s2, s3), model = trio
        msg = tbroadcast.ResizeMessage(
            id="crashed", phase="prepare", epoch=0,
            old_hosts=[s1.host, s2.host],
            new_hosts=[s1.host, s2.host, s3.host])
        for s in (s1, s2, s3):
            s.receive_message(msg)
        assert all(s.cluster.resize is not None for s in (s1, s2, s3))
        j = tresize.ResizeJournal.for_data_dir(s1.holder.path)
        j.write(id="crashed", phase=tresize.PHASE_STREAMING, epochFrom=0,
                old=[s1.host, s2.host], new=[s1.host, s2.host, s3.host],
                coordinator=s1.host)
        status = tresize.recover(s1)
        assert status["phase"] == tresize.PHASE_ABORTED
        for s in (s1, s2, s3):
            assert s.cluster.resize is None and s.cluster.epoch == 0
        _differential((s1.host, s2.host), model)
        j2 = tresize.ResizeJournal.for_data_dir(s1.holder.path)
        j2.load()
        assert not j2.in_flight()

    def test_journal_recovery_post_flip_rolls_forward(self, trio):
        (s1, s2, s3), model = trio
        kw = dict(id="flipped", epoch=0, old_hosts=[s1.host, s2.host],
                  new_hosts=[s1.host, s2.host, s3.host])
        for s in (s1, s2, s3):
            s.receive_message(tbroadcast.ResizeMessage(phase="prepare",
                                                       **kw))
        s2.receive_message(tbroadcast.ResizeMessage(phase="flip", **kw))
        assert s2.cluster.epoch == 1 and s1.cluster.epoch == 0
        # A JAX-written journal: the port coordinator recovers it.
        j = jresize.ResizeJournal.for_data_dir(s1.holder.path)
        j.write(id="flipped", phase=jresize.PHASE_FLIPPING, epochFrom=0,
                old=[s1.host, s2.host], new=[s1.host, s2.host, s3.host],
                coordinator=s1.host)
        status = tresize.recover(s1)
        assert status["phase"] == tresize.PHASE_DONE, status
        for s in (s1, s2, s3):
            assert s.cluster.epoch == 1
            assert len(s.cluster.nodes) == 3
            assert s.cluster.resize is None
        _differential((s1.host, s2.host, s3.host), model)

    def test_recovery_at_open_and_epoch_restored(self, tmp_path,
                                                 monkeypatch):
        """A node that lived through a resize comes back at its epoch
        and membership (``epoch.json``), and a journal left in flight
        pre-flip is aborted by the recovery thread at open."""
        monkeypatch.setenv("PILOSA_TPU_MESH", "0")
        from pilosa_tpu_torch.cluster.client import Client
        ports = []
        import socket
        for _ in range(3):
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                ports.append(sk.getsockname()[1])
        hosts = [f"127.0.0.1:{p}" for p in ports]

        def boot(i, members):
            # Static membership has no slice discovery: each boot is
            # told the index's max slice, as the fixture's nodes are.
            s = PortServer(
                str(tmp_path / f"n{i}"), host=hosts[i], device="cpu",
                warmup=False, anti_entropy_interval=0,
                polling_interval=0,
                cluster=ttop.Cluster(
                    nodes=[ttop.Node(h) for h in members]),
                cluster_type="http")
            s.open()
            idx = s.holder.index("rz")
            if idx is not None:
                idx.set_remote_max_slice(5)
            return s

        servers = [boot(i, hosts[:2]) for i in range(3)]
        try:
            _post(hosts[0], "/index/rz")
            _post(hosts[0], "/index/rz/frame/f")
            _post(hosts[2], "/index/rz")
            _post(hosts[2], "/index/rz/frame/f")
            rows, cols, model = _seed_trio_data()
            Client(hosts[0]).import_arrays("rz", "f", rows, cols)
            for s in servers:
                s.holder.index("rz").set_remote_max_slice(5)
            _resize(hosts[0], {"add": hosts[2]})
            assert _wait_resize(hosts[0])["phase"] == "done"
            servers[2].close()
            servers[2] = boot(2, hosts[:2])  # stale boot membership
            assert servers[2].cluster.epoch == 1
            assert [n.host for n in servers[2].cluster.nodes] == hosts
            _differential(hosts, model)
            # A pre-flip journal on node 0: recovered (aborted) at open.
            j = tresize.ResizeJournal.for_data_dir(
                servers[0].holder.path)
            j.write(id="stale", phase=tresize.PHASE_STREAMING,
                    epochFrom=1, old=hosts, new=hosts[:2],
                    coordinator=hosts[0])
            servers[0].close()
            servers[0] = boot(0, hosts[:2])
            deadline = time.time() + 30
            while time.time() < deadline:
                op = _get(hosts[0], "/cluster/resize")["op"]
                if op and op["phase"] == "aborted":
                    break
                time.sleep(0.05)
            assert op["id"] == "stale" and op["phase"] == "aborted"
            assert all(s.cluster.epoch == 1 for s in servers)
            _differential(hosts, model)
        finally:
            _close_all(servers)

    def test_debug_topology_and_metrics(self, trio, jax_trio):
        (s1, s2, s3), _model = trio
        (j1, j2, j3), _ = jax_trio
        topos = []
        for a, b, c in ((s1, s2, s3), (j1, j2, j3)):
            idle = _get(a.host, "/debug/topology")
            a.cluster.install_resize("t1", [a.host, b.host, c.host])
            busy = _get(a.host, "/debug/topology")
            a.cluster.abort_resize("t1")
            topos.append((idle, busy))
        for (idle, busy), (a, b) in zip(topos, ((s1, s2), (j1, j2))):
            assert idle["epoch"] == 0 and idle["resize"] is None
            assert sorted(idle["nodes"]) == sorted([a.host, b.host])
            assert set(idle["indexes"]["rz"]["owners"]) == {
                str(s) for s in range(6)}
            assert busy["resize"]["id"] == "t1"
            assert busy["resize"]["phase"] == "migrating"
        (ti, tb), (ji, jb) = topos
        assert set(ti) == set(ji) and set(tb) == set(jb)
        assert (tb["indexes"]["rz"]["movingSlices"]
                == jb["indexes"]["rz"]["movingSlices"])
        assert ti["partitionN"] == ji["partitionN"]
        text = urllib.request.urlopen(
            f"http://{s1.host}/metrics", timeout=10).read().decode()
        for fam in ("pilosa_cluster_resize_state",
                    "pilosa_resize_slices_moved_total",
                    "pilosa_resize_stream_bytes_total",
                    "pilosa_cluster_resize_double_reads_total"):
            assert fam in text, fam

    def test_get_cluster_resize_keys_equal_jax(self, trio, jax_trio):
        (s1, s2, s3), _model = trio
        (j1, j2, j3), _ = jax_trio
        assert _get(s1.host, "/cluster/resize") == {
            "epoch": 0, "installed": None, "op": None}
        assert _get(j1.host, "/cluster/resize") == {
            "epoch": 0, "installed": None, "op": None}
        _grow((s1, s2, s3))
        _grow((j1, j2, j3))
        t = _get(s1.host, "/cluster/resize")
        j = _get(j1.host, "/cluster/resize")
        assert set(t) == set(j) and set(t["op"]) == set(j["op"])
        assert (t["epoch"], t["installed"], t["op"]["phase"]) == (
            j["epoch"], j["installed"], j["op"]["phase"]) == (1, None,
                                                              "done")

    def test_watchdog_resize_stall_cause(self, trio):
        from pilosa_tpu_torch.obs.watchdog import Watchdog
        (s1, s2, s3), _model = trio
        assert s1.watchdog.resize_progress_fn == s1._resize_progress
        coord = tresize.ResizeCoordinator(s1, [s1.host, s2.host, s3.host])
        coord.phase = tresize.PHASE_STREAMING
        coord.last_progress = time.monotonic() - 100.0
        s1.resize_op = coord
        wd = Watchdog(resize_progress_fn=s1._resize_progress,
                      resize_stall_s=5.0, wal_stall_s=0,
                      deadline_grace_s=0, gossip_silence_s=0,
                      queue_stall_s=0)
        fired = wd.check()
        assert any(c == "resize_stall" for c, _ in fired), fired
        assert tmetrics.WATCHDOG_TRIPS.labels("resize_stall").value >= 1
        s1.resize_op = None

    def test_blackbox_state_has_resize_block(self, trio, jax_trio):
        (s1, s2, s3), _model = trio
        (j1, j2, j3), _ = jax_trio
        for a, b, c in ((s1, s2, s3), (j1, j2, j3)):
            state = a._blackbox_state()
            assert state["resize"] == {"epoch": 0, "inFlight": None}
            a.cluster.install_resize("bb", [a.host, b.host, c.host])
            state = a._blackbox_state()
            assert state["resize"]["inFlight"]["id"] == "bb"
            a.cluster.abort_resize("bb")
        assert (set(s1.local_debug_state()["resize"])
                == set(j1.local_debug_state()["resize"]))

    def test_anti_entropy_skips_moving_fragments(self, trio):
        from pilosa_tpu_torch.server.syncer import HolderSyncer
        (s1, s2, s3), _model = trio
        s1.cluster.install_resize("ae", [s1.host, s2.host, s3.host])
        synced = []

        class SpyingSyncer(HolderSyncer):
            def sync_fragment(self, index, frame, view, slice):
                synced.append(slice)

        SpyingSyncer(s1.holder, s1.host, s1.cluster,
                     client_factory=s1._client_factory).sync_holder()
        moving = {s for s in range(6)
                  if s1.cluster.moving_slice("rz", s) is not None}
        assert moving and not (set(synced) & moving)
        s1.cluster.abort_resize("ae")

    def test_failpoint_site_armed_over_http(self, trio):
        (s1, _s2, _s3), _model = trio
        _post(s1.host, "/debug/failpoints", json.dumps(
            {"site": "resize.stream", "spec": "torn(8)*1"}).encode())
        snap = _get(s1.host, "/debug/failpoints")
        assert "resize.stream" in snap["sites"]
        assert snap["armed"]["resize.stream"]["spec"] == "torn(8)*1"
        _post(s1.host, "/debug/failpoints", json.dumps(
            {"site": "resize.stream", "spec": "off"}).encode())

    def test_resize_verb_equals_jax(self, trio, jax_trio):
        """``resize --add ... --wait`` through each package's CLI."""
        results = []
        for servers, cli in ((trio[0], port_cli), (jax_trio[0], jax_cli)):
            a, _b, c = servers
            out, err = io.StringIO(), io.StringIO()
            rc = cli.main(["resize", "--host", a.host, "--add", c.host,
                           "--wait"], stdout=out, stderr=err)
            lines = out.getvalue().splitlines()
            results.append((rc, lines[-1].split(":")[1].split()[0],
                            json.loads(out.getvalue()[
                                :out.getvalue().index("\nresize ")])[
                                "op"]["new"] == [x.host for x in servers]))
            st = io.StringIO()
            assert cli.main(["resize", "--host", a.host, "--status"],
                            stdout=st, stderr=err) == 0
            assert json.loads(st.getvalue())["epoch"] == 1
        assert results[0] == results[1] == (0, "done", True)

    def test_resize_verb_usage_error(self):
        out = []
        for cli in (port_cli, jax_cli):
            err = io.StringIO()
            out.append((cli.main(["resize", "--host", "127.0.0.1:1"],
                                 stdout=io.StringIO(), stderr=err),
                        err.getvalue()))
        assert out[0] == out[1] and out[0][0] == 1


def test_route_tables_are_equal(tmp_path):
    """Fault 3.4 is closed: with ``/cluster/resize``, ``/debug/tier``,
    the backup routes and ``/pod/exec`` served, the port's route table
    is the JAX handler's."""
    from pilosa_tpu.server.handler import Handler as JHandler
    from pilosa_tpu_torch.server.handler import Handler as THandler
    tables = []
    for pkg, cls in ((JAX, JHandler), (TORCH, THandler)):
        h = pkg.Holder(str(tmp_path / pkg.name))
        h.open()
        try:
            app = cls(h, _executor(pkg, h), host="local")
            tables.append({(r[0], r[1].pattern) for r in app._routes})
        finally:
            h.close()
    jax_routes, port_routes = tables
    assert jax_routes == port_routes
    assert {("GET", "^/cluster/resize$"), ("POST", "^/cluster/resize$"),
            ("GET", "^/debug/tier$"), ("GET", "^/backup$"),
            ("POST", "^/backup$"), ("GET", "^/debug/backup$"),
            ("POST", "^/pod/exec$")} <= port_routes


# ---------------------------------------------------------------------------
# a mixed cluster: a port coordinator grows [port, JAX] to [port, JAX, port]


def test_port_coordinator_grows_a_mixed_cluster(tmp_path, monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    servers, model = _make_trio(TORCH, tmp_path, kinds=(TORCH, JAX, TORCH))
    try:
        p1, j2, p3 = servers
        # Wire states agree before anything moves.
        assert p1.resize_wire_state() == j2.resize_wire_state() == {
            "epoch": 0}
        op = _grow(servers)
        assert op["phase"] == "done", op
        for s in servers:
            assert s.cluster.epoch == 1
            assert [n.host for n in s.cluster.nodes] == [
                p1.host, j2.host, p3.host]
            assert s.cluster.resize is None
        assert p1.resize_wire_state() == j2.resize_wire_state()
        _differential([s.host for s in servers], model)
        # The JAX node's settled wire state converges a port node that
        # missed the finalize (apply_resize_wire_state both ways).
        ref = j2.resize_wire_state()
        assert ref["last"]["outcome"] == "done"
        p3._last_resize = None
        p3.apply_resize_wire_state(ref)
        assert p3.cluster.epoch == 1
    finally:
        _close_all(servers)


def test_wire_state_converges_both_ways(tmp_path, monkeypatch):
    """The gossip piggyback's dict carries a missed flip from a port
    node to a JAX node, and a missed finalize from a JAX node to a port
    node."""
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    servers, model = _make_trio(TORCH, tmp_path, kinds=(TORCH, JAX, TORCH))
    try:
        p1, j2, p3 = servers
        kw = dict(id="w1", epoch=0, old_hosts=[p1.host, j2.host],
                  new_hosts=[p1.host, j2.host, p3.host])
        for s, pkg in ((p1, TORCH), (j2, JAX), (p3, TORCH)):
            s.receive_message(pkg.broadcast.ResizeMessage(phase="prepare",
                                                          **kw))
        assert p1.resize_wire_state() == j2.resize_wire_state()
        p1.receive_message(tbroadcast.ResizeMessage(phase="flip", **kw))
        assert (p1.cluster.epoch, j2.cluster.epoch) == (1, 0)
        j2.apply_resize_wire_state(p1.resize_wire_state())
        assert j2.cluster.epoch == 1
        assert j2.cluster.resize.phase == "draining"
        p3.receive_message(tbroadcast.ResizeMessage(phase="flip", **kw))
        j2.receive_message(jbroadcast.ResizeMessage(phase="finalize", **kw))
        assert j2.cluster.resize is None
        p3.apply_resize_wire_state(j2.resize_wire_state())
        assert p3.cluster.resize is None and p3.cluster.epoch == 1
        assert p3.resize_wire_state()["last"] == j2.resize_wire_state()[
            "last"]
    finally:
        _close_all(servers)
