"""The port's cluster legs against the JAX executor's, with one
scripted transport.

Each case is the JAX package's (``tests/test_executor.py::
TestDistributed``, ``tests/test_distributed_fastpath.py``): a real local
executor in a two-node cluster whose other node answers through a
scripted fake client, as the reference's executor tests do
(executor_test.go:473-692). The same case runs on the JAX executor and
on the port's (device ``cpu``) over the same seeded data, and both must
give the same answer and make the same remote calls (host, query,
slices, remote flag; sorted, since legs run concurrently): remote Count
and Bitmap merges, the two-phase TopN, SetBit to every owner, the
``remote`` flag stopping a forward, a failed leg re-mapped onto the
replica, attribute broadcasts, the TopN pushdown with its missing-row
refetch, its fallback to the fan-out, a pushdown leg's exact untrimmed
partials, and the coordinator's cluster result cache (hit, validate,
invalidate).
"""

import types

import pytest

import pilosa_tpu.cluster.client as jclient
import pilosa_tpu.cluster.generations as jgens
import pilosa_tpu.cluster.topology as jtop
import pilosa_tpu.executor as jexec
import pilosa_tpu.models.frame as jframe
import pilosa_tpu.models.holder as jholder
import pilosa_tpu.obs.metrics as jmetrics
import pilosa_tpu.storage.bitmap as jbitmap
import pilosa_tpu.storage.cache as jcache

import pilosa_tpu_torch.cluster.client as tclient
import pilosa_tpu_torch.cluster.generations as tgens
import pilosa_tpu_torch.cluster.topology as ttop
import pilosa_tpu_torch.executor as texec
import pilosa_tpu_torch.models.frame as tframe
import pilosa_tpu_torch.models.holder as tholder
import pilosa_tpu_torch.obs.metrics as tmetrics
import pilosa_tpu_torch.storage.bitmap as tbitmap
import pilosa_tpu_torch.storage.cache as tcache

from pilosa_tpu_torch import SLICE_WIDTH

JAX = types.SimpleNamespace(
    name="jax", Holder=jholder.Holder, exec=jexec, top=jtop,
    FrameOptions=jframe.FrameOptions, Bitmap=jbitmap.Bitmap,
    Pair=jcache.Pair, GenerationMap=jgens.GenerationMap,
    ClientError=jclient.ClientError, metrics=jmetrics)
TORCH = types.SimpleNamespace(
    name="torch", Holder=tholder.Holder, exec=texec, top=ttop,
    FrameOptions=tframe.FrameOptions, Bitmap=tbitmap.Bitmap,
    Pair=tcache.Pair, GenerationMap=tgens.GenerationMap,
    ClientError=tclient.ClientError, metrics=tmetrics)


def _executor(pkg, holder, **kw):
    if pkg is JAX:
        return pkg.exec.Executor(holder, use_mesh=False, **kw)
    return pkg.exec.Executor(holder, device="cpu", **kw)


class FakeClient:
    """Scripted remote transport; ``fn(pkg, node, index, query,
    slices)`` answers a leg."""

    def __init__(self, pkg, fn, generation_aware=False):
        self.pkg = pkg
        self.fn = fn
        self.calls = []
        self.generation_aware = generation_aware

    def execute_query(self, node, index, query, slices, remote, **kw):
        self.calls.append((node.host, index, query,
                           tuple(slices) if slices else None, remote))
        return self.fn(self.pkg, node, index, query, slices)


def _norm(r):
    if hasattr(r, "segments"):
        return ("bitmap", r.bits().tolist(), r.attrs)
    if isinstance(r, list) and r and hasattr(r[0], "count"):
        return [(p.id, p.count) for p in r]
    return r


def _both(tmp_path, case):
    """Run ``case(pkg, holder)`` on both packages; returns their
    (answers, calls) pairs."""
    out = []
    for pkg in (JAX, TORCH):
        h = pkg.Holder(str(tmp_path / pkg.name))
        h.open()
        try:
            answer, calls = case(pkg, h)
        finally:
            h.close()
        out.append(([_norm(a) for a in answer], sorted(calls, key=repr)))
    assert out[0] == out[1]
    return out[0]


def must_set(holder, index, frame, row, col, view="standard", opts=None):
    idx = holder.create_index_if_not_exists(index)
    f = idx.create_frame_if_not_exists(frame, opts)
    f.set_bit(view, row, col)


def _two_node(pkg, holder, fn, replica_n=1, **kw):
    cluster = pkg.top.new_cluster(["local", "remotehost"],
                                  replica_n=replica_n)
    client = FakeClient(pkg, fn, kw.pop("generation_aware", False))
    e = _executor(pkg, holder, host="local", cluster=cluster,
                  client=client, **kw)
    return e, client, cluster


def test_remote_count_merges(tmp_path):
    def case(pkg, h):
        must_set(h, "i", "general", 10, 3)
        h.index("i").set_remote_max_slice(2)
        e, client, _ = _two_node(pkg, h, lambda *a: [7])
        return e.execute("i", "Count(Bitmap(rowID=10, frame=general))"), \
            client.calls
    answer, calls = _both(tmp_path, case)
    assert calls and answer[0] in (7, 8)


def test_remote_bitmap_merges(tmp_path):
    def fn(pkg, node, index, query, slices):
        bm = pkg.Bitmap()
        for s in slices:
            bm.set_bit(s * SLICE_WIDTH + 42)
        return [bm]

    def case(pkg, h):
        must_set(h, "i", "general", 10, 3)
        h.index("i").set_remote_max_slice(2)
        h.frame("i", "general").row_attr_store.set_attrs(10, {"x": 1})
        e, client, _ = _two_node(pkg, h, fn)
        return e.execute("i", "Bitmap(rowID=10, frame=general)"), \
            client.calls
    _both(tmp_path, case)


def test_remote_topn_two_phase(tmp_path):
    def fn(pkg, node, index, query, slices):
        if "ids=" in query:
            return [[pkg.Pair(0, 1), pkg.Pair(30, 5)]]
        return [[pkg.Pair(30, 5)]]

    def case(pkg, h):
        idx = h.create_index_if_not_exists("i")
        f = idx.create_frame_if_not_exists(
            "f", pkg.FrameOptions(cache_type="ranked"))
        for col in range(4):
            f.set_bit("standard", 0, col)
        f.view("standard").fragment(0).recalculate_cache()
        idx.set_remote_max_slice(2)
        e, client, _ = _two_node(pkg, h, fn)
        return e.execute("i", "TopN(frame=f, n=2)"), client.calls
    answer, calls = _both(tmp_path, case)
    assert any("ids=" in c[2] for c in calls)


@pytest.mark.parametrize("replica_n", [1, 2])
@pytest.mark.parametrize("col", [3, SLICE_WIDTH + 5, 7 * SLICE_WIDTH + 1])
def test_setbit_forwards_to_owners(tmp_path, replica_n, col):
    def case(pkg, h):
        h.create_index_if_not_exists("i").create_frame_if_not_exists("f")
        e, client, _ = _two_node(pkg, h, lambda *a: [True],
                                 replica_n=replica_n)
        res = e.execute("i", f"SetBit(rowID=1, frame=f, columnID={col})")
        frag = h.fragment("i", "f", "standard", col // SLICE_WIDTH)
        local = frag.row(1).count() if frag is not None else 0
        return res + [local], client.calls
    _both(tmp_path, case)


def test_remote_flag_stops_forwarding(tmp_path):
    def case(pkg, h):
        h.create_index_if_not_exists("i").create_frame_if_not_exists("f")

        def fn(*a):
            raise AssertionError("must not forward when remote=True")
        e, client, _ = _two_node(pkg, h, fn, replica_n=2)
        res = e.execute("i", "SetBit(rowID=1, frame=f, columnID=3)",
                        opt=pkg.exec.ExecOptions(remote=True))
        return res, client.calls
    answer, calls = _both(tmp_path, case)
    assert answer == [True] and calls == []


def test_failed_node_retries_on_replica(tmp_path):
    def fn(pkg, node, index, query, slices):
        raise ConnectionError("node down")

    def case(pkg, h):
        must_set(h, "i", "general", 10, 3)
        must_set(h, "i", "general", 10, SLICE_WIDTH + 3)
        must_set(h, "i", "general", 10, 2 * SLICE_WIDTH + 3)
        e, client, _ = _two_node(pkg, h, fn, replica_n=2)
        # Every slice is owned by both: local first, so nothing goes
        # remote; a write's forward to the dead peer raises.
        return e.execute("i", "Count(Bitmap(rowID=10, frame=general))"), \
            client.calls
    answer, _ = _both(tmp_path, case)
    assert answer == [3]


def test_failed_leg_remaps_onto_local_replica(tmp_path):
    """With three nodes and replicas 2, the slices whose first owner is
    a peer that fails re-map onto the next owner: here the local node
    where it owns them, else the other peer."""
    def fn(pkg, node, index, query, slices):
        if node.host == "deadpeer":
            raise ConnectionError("node down")
        return [100 * len(slices)]

    def case(pkg, h):
        for s in range(8):
            must_set(h, "i", "general", 10, s * SLICE_WIDTH + 3)
        cluster = pkg.top.new_cluster(["local", "deadpeer", "livepeer"],
                                      replica_n=2)
        client = FakeClient(pkg, fn)
        e = _executor(pkg, h, host="local", cluster=cluster, client=client)
        return e.execute("i", "Count(Bitmap(rowID=10, frame=general))"), \
            client.calls
    _both(tmp_path, case)


def test_attr_write_broadcasts(tmp_path):
    def case(pkg, h):
        must_set(h, "i", "f", 10, 1)
        e, client, _ = _two_node(pkg, h, lambda *a: [None])
        e.execute("i", 'SetRowAttrs(rowID=10, frame=f, foo="bar")')
        e.execute("i", 'SetColumnAttrs(id=5, x=1)')
        e.execute("i", 'SetRowAttrs(rowID=1, frame=f, a=1)'
                       ' SetRowAttrs(rowID=2, frame=f, a=2)')
        return [h.frame("i", "f").row_attr_store.attrs(10)], client.calls
    _both(tmp_path, case)


# -- the TopN pushdown (scripted transport) -----------------------------------

def _pushdown_setup(pkg, h, fn):
    idx = h.create_index_if_not_exists("i")
    f = idx.create_frame_if_not_exists("f")
    for col in (1, 2, 3):
        f.set_bit("standard", 1, col)
    f.set_bit("standard", 2, 4)
    idx.set_remote_max_slice(2)
    return _two_node(pkg, h, fn, generation_aware=True)


def test_pushdown_merge_and_missing_row_refetch(tmp_path):
    def fn(pkg, node, index, query, slices):
        if "pushdown=true" in query:
            return [[pkg.Pair(1, 10), pkg.Pair(30, 7)]]
        assert "ids=" in query, f"unexpected leg: {query}"
        return [[pkg.Pair(2, 5)]]

    def case(pkg, h):
        e, client, _ = _pushdown_setup(pkg, h, fn)
        merged = pkg.metrics.TOPN_PUSHDOWN.labels("merged").value
        res = e.execute("i", "TopN(frame=f, n=5)")
        # The second query carries the merged union as hints.
        res2 = e.execute("i", "TopN(frame=f, n=5)")
        assert pkg.metrics.TOPN_PUSHDOWN.labels("merged").value \
            == merged + 2
        return res + res2, client.calls
    answer, calls = _both(tmp_path, case)
    assert any("hints=" in c[2] for c in calls)


def test_pushdown_failure_degrades_to_fanout(tmp_path):
    def fn(pkg, node, index, query, slices):
        if "pushdown=true" in query:
            raise pkg.ClientError("injected")
        return [[pkg.Pair(1, 4)]]

    def case(pkg, h):
        e, client, _ = _pushdown_setup(pkg, h, fn)
        before = pkg.metrics.TOPN_PUSHDOWN.labels("fallback").value
        res = e.execute("i", "TopN(frame=f, n=5)")
        assert pkg.metrics.TOPN_PUSHDOWN.labels("fallback").value \
            == before + 1
        return res, client.calls
    _both(tmp_path, case)


@pytest.mark.parametrize("q", ["TopN(frame=f, n=2, pushdown=true)",
                               "TopN(frame=f, n=2, pushdown=true,"
                               " hints=[4,5])",
                               "TopN(frame=f, n=1, pushdown=true,"
                               " hints=[3])"])
def test_remote_leg_answers_exact_untrimmed_partials(tmp_path, q):
    def case(pkg, h):
        idx = h.create_index_if_not_exists("i")
        f = idx.create_frame_if_not_exists("f")
        for row, n_bits in ((1, 5), (2, 4), (3, 3), (4, 2), (5, 1)):
            for col in range(n_bits):
                f.set_bit("standard", row, col)
        e = _executor(pkg, h, host="local")
        return e.execute("i", q, slices=[0],
                         opt=pkg.exec.ExecOptions(remote=True)), []
    _both(tmp_path, case)


# -- the coordinator's cluster result cache -----------------------------------

class ClusterCacheClient:
    """Responses carry generation tokens (applied to the shared map,
    like the real pooled client), and the /generations probe answers."""

    generation_aware = True

    def __init__(self, gens, tokens):
        self.gens = gens
        self.tokens = tokens
        self.calls = []

    def execute_query(self, node, index, query, slices, remote, **kw):
        self.calls.append(("exec", node.host, query,
                           tuple(slices or ())))
        self.gens.apply(node.host, index,
                        {s: self.tokens[node.host][s] for s in slices})
        return [7]

    def generations(self, index, slices=None, host=None, deadline_s=None):
        self.calls.append(("probe", host, tuple(slices or ())))
        t = {s: dict(self.tokens[host][s]) for s in (slices or [])}
        self.gens.apply(host, index, t)
        return t


def test_cluster_cache_hit_validate_invalidate(tmp_path):
    def case(pkg, h):
        must_set(h, "i", "general", 10, 3)
        h.index("i").set_remote_max_slice(2)
        cluster = pkg.top.new_cluster(["local", "remotehost"], replica_n=1)
        remote = [s for s in range(3)
                  if cluster.fragment_nodes("i", s)[0].host == "remotehost"]
        gens = (pkg.GenerationMap(staleness_s=60.0) if pkg is JAX
                else pkg.GenerationMap())
        tokens = {"remotehost": {s: {"general/standard": (50, 0)}
                                 for s in remote}}
        client = ClusterCacheClient(gens, tokens)
        e = _executor(pkg, h, host="local", cluster=cluster, client=client,
                      gens=gens)
        gens.apply("remotehost", "i",
                   {s: tokens["remotehost"][s] for s in remote})
        q = "Count(Bitmap(rowID=10, frame=general))"
        hits = pkg.metrics.CLUSTER_CACHE_REQUESTS.labels("hit")
        inval = pkg.metrics.CLUSTER_CACHE_REQUESTS.labels("invalidated")
        h0, i0 = hits.value, inval.value
        out = e.execute("i", q)            # computed, cached
        out += e.execute("i", q)           # one probe, no leg
        assert hits.value == h0 + 1
        for s in remote:                   # a remote write
            tokens["remotehost"][s] = {"general/standard": (50, 9)}
        out += e.execute("i", q)           # invalidated, recomputed
        assert inval.value == i0 + 1
        local = [s for s in range(3) if s not in remote]
        h.frame("i", "general").set_bit(
            "standard", 10, local[0] * SLICE_WIDTH + 9)
        out += e.execute("i", q)           # a local write: recomputed
        out += e.execute("i", "SetBit(frame=general, rowID=1,"
                              f" columnID={local[0] * SLICE_WIDTH})",
                         opt=pkg.exec.ExecOptions(remote=True))
        return out, client.calls
    answer, calls = _both(tmp_path, case)
    assert [c[0] for c in calls].count("probe") >= 2


# -- a failed leg of the coordinator's own ------------------------------------

def _own_leg_case(pkg, h, raise_on_device=None):
    """Three nodes, replicas 2: the coordinator ``local`` owns some of
    the eight slices; its peers answer each leg with the exact count of
    the slices they were given (one bit a slice). On the port the
    coordinator's own leg runs the device count, pinned, and
    ``raise_on_device`` (when given) replaces the device count with a
    function that raises."""
    for s in range(8):
        must_set(h, "i", "general", 10, s * SLICE_WIDTH + 3)
    cluster = pkg.top.new_cluster(["local", "peer1", "peer2"], replica_n=2)
    client = FakeClient(pkg, lambda pkg, node, index, query, slices:
                        [len(slices)])
    kw = {}
    if pkg is TORCH:
        from pilosa_tpu_torch.parallel import costmodel
        kw = dict(mesh_min_slices=1, cost_model=costmodel.pinned(0.0))
    e = _executor(pkg, h, host="local", cluster=cluster, client=client,
                  **kw)
    local = [s for s in range(8)
             if cluster.fragment_nodes("i", s)[0].host == "local"]
    return e, client, local


def test_own_device_leg_error_remaps_onto_replicas(tmp_path, monkeypatch):
    """A device error on the coordinator's own leg re-maps that leg's
    slices onto the other replica owners, as the JAX cluster does on any
    leg error, and the failover counter counts them."""
    q = "Count(Bitmap(rowID=10, frame=general))"
    h = JAX.Holder(str(tmp_path / "jax"))
    h.open()
    try:
        e, _client, _local = _own_leg_case(JAX, h)
        want = e.execute("i", q)
    finally:
        h.close()

    def broken(*a, **kw):
        raise RuntimeError("device fault: illegal memory access")

    monkeypatch.setattr(texec.mesh_mod, "count_expr_sharded", broken)
    h = TORCH.Holder(str(tmp_path / "torch"))
    h.open()
    try:
        e, client, local = _own_leg_case(TORCH, h)
        assert local, "the coordinator owns a first replica"
        ctr = tmetrics.FAILOVER_SLICES.labels("local")
        before = ctr.value
        got = e.execute("i", q)
        assert ctr.value - before == len(local)
        served = sorted(s for call in client.calls for s in call[3])
        assert served == list(range(8))
    finally:
        h.close()
    assert got == want == [8]


@pytest.mark.parametrize("err", ["deadline", "cancel"])
def test_own_leg_deadline_and_cancel_still_surface(tmp_path, monkeypatch,
                                                   err):
    """The query's own deadline or cancel on the coordinator's leg is
    never re-mapped: it surfaces, and the handler answers 504 / 409."""
    from pilosa_tpu_torch.errors import (QueryCancelledError,
                                         QueryDeadlineError)
    from pilosa_tpu_torch.server.handler import Handler
    exc = (QueryDeadlineError("query deadline exceeded")
           if err == "deadline" else QueryCancelledError("cancelled"))

    def dying(*a, **kw):
        raise exc

    monkeypatch.setattr(texec.mesh_mod, "count_expr_sharded", dying)
    h = TORCH.Holder(str(tmp_path / "torch"))
    h.open()
    try:
        e, client, local = _own_leg_case(TORCH, h)
        ctr = tmetrics.FAILOVER_SLICES.labels("local")
        before = ctr.value
        with pytest.raises(type(exc)) as ei:
            e.execute("i", "Count(Bitmap(rowID=10, frame=general))")
        assert ctr.value == before
    finally:
        h.close()
    assert Handler._status_of(ei.value) == (504 if err == "deadline"
                                            else 409)


def test_own_device_error_surfaces_without_a_replica(tmp_path,
                                                     monkeypatch):
    """With no other replica to re-map onto (one node), the device error
    surfaces: the leg never falls back to the host."""
    def broken(*a, **kw):
        raise RuntimeError("device fault: illegal memory access")

    monkeypatch.setattr(texec.mesh_mod, "count_expr_sharded", broken)
    from pilosa_tpu_torch.parallel import costmodel
    h = TORCH.Holder(str(tmp_path / "torch"))
    h.open()
    try:
        for s in range(4):
            must_set(h, "i", "general", 10, s * SLICE_WIDTH + 3)
        e = _executor(TORCH, h, mesh_min_slices=1,
                      cost_model=costmodel.pinned(0.0))
        with pytest.raises(RuntimeError, match="device fault"):
            e.execute("i", "Count(Bitmap(rowID=10, frame=general))")
    finally:
        h.close()
