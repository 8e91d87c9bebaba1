"""Anti-entropy in the port against the JAX package: a fragment's
block checksums, block data and majority merge equal the JAX fragment's
on the same seeded bits, and one in-process anti-entropy round makes two
port replicas of a two-node cluster converge (fragments and
attributes)."""

import socket

import numpy as np
import pytest

from pilosa_tpu.storage.fragment import Fragment as JFragment
from pilosa_tpu.storage.fragment import PairSet as JPairSet

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.cluster.topology import Cluster, Node
from pilosa_tpu_torch.server.server import Server
from pilosa_tpu_torch.storage.fragment import Fragment as TFragment
from pilosa_tpu_torch.storage.fragment import PairSet as TPairSet


def _pair(tmp_path, seed, slice=1):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 3000))
    rows = rng.integers(0, 450, size=n).astype(np.uint64)
    cols = (rng.integers(0, SLICE_WIDTH, size=n).astype(np.uint64)
            + np.uint64(slice * SLICE_WIDTH))
    t = TFragment(str(tmp_path / f"t{seed}"), "i", "f", "standard", slice)
    j = JFragment(str(tmp_path / f"j{seed}"), "i", "f", "standard", slice)
    t.open()
    j.open()
    t.import_bits(rows, cols)
    j.import_bits(rows, cols)
    return rng, t, j


@pytest.mark.parametrize("seed", range(6))
def test_blocks_and_block_data_equal_jax(tmp_path, seed):
    rng, t, j = _pair(tmp_path, seed)
    try:
        assert t.blocks() == j.blocks()
        assert t.checksum() == j.checksum()
        for bid in range(6):
            a, b = t.block_data(bid), j.block_data(bid)
            assert a.row_ids.tolist() == b.row_ids.tolist()
            assert a.column_ids.tolist() == b.column_ids.tolist()
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("n_peers", [1, 2, 3])
def test_merge_block_equals_jax(tmp_path, seed, n_peers):
    """Majority merge: the peers' diffs and the local result equal the
    JAX fragment's (with one peer, a union)."""
    rng, t, j = _pair(tmp_path, seed)
    try:
        for bid in range(3):
            peers = []
            for _ in range(n_peers):
                k = int(rng.integers(0, 200))
                rows = rng.integers(bid * 100, bid * 100 + 100,
                                    size=k).astype(np.uint64)
                cols = rng.integers(0, SLICE_WIDTH, size=k).astype(np.uint64)
                peers.append((rows, cols))
            got = t.merge_block(bid, [TPairSet(r, c) for r, c in peers])
            want = j.merge_block(bid, [JPairSet(r, c) for r, c in peers])
            for g_list, w_list in zip(got, want):
                assert [(p.row_ids.tolist(), p.column_ids.tolist())
                        for p in g_list] == \
                    [(p.row_ids.tolist(), p.column_ids.tolist())
                     for p in w_list]
            assert t.blocks() == j.blocks()
    finally:
        t.close()
        j.close()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_fragment_tar_stream_crosses_packages(tmp_path, direction):
    """``write_to``'s tar stream (data + cache) restores a fragment of
    the other package with the same bits and count cache."""
    import io
    rng, t, j = _pair(tmp_path, 9)
    src, dst_mod = (t, JFragment) if direction == "port_to_jax" \
        else (j, TFragment)
    dst = dst_mod(str(tmp_path / "dst"), "i", "f", "standard", 1)
    dst.open()
    try:
        buf = io.BytesIO()
        src.write_to(buf)
        buf.seek(0)
        dst.read_from(buf)
        assert dst.storage.all_positions().tolist() == \
            src.storage.all_positions().tolist()
        assert dst.blocks() == src.blocks()
        assert sorted(dst.cache.ids()) == sorted(src.cache.ids())
    finally:
        for f in (t, j, dst):
            f.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_anti_entropy_round_converges_two_replicas(tmp_path):
    hosts = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    servers = []
    for i, h in enumerate(hosts):
        cl = Cluster(nodes=[Node(x) for x in hosts], replica_n=2)
        srv = Server(str(tmp_path / f"n{i}"), host=h, device="cpu",
                     cluster=cl, warmup=False,
                     polling_interval=3600, anti_entropy_interval=3600)
        srv.open()
        servers.append(srv)
    try:
        rng = np.random.default_rng(4)
        for srv in servers:
            idx = srv.holder.create_index("i")
            idx.create_frame("f")
        # Each replica takes bits the other lacks, and one shared set.
        shared = rng.integers(0, 3 * SLICE_WIDTH, size=500)
        for k, srv in enumerate(servers):
            f = srv.holder.frame("i", "f")
            own = rng.integers(0, 3 * SLICE_WIDTH, size=300)
            cols = np.concatenate((shared, own)).astype(np.uint64)
            rows = rng.integers(0, 250, size=len(cols)).astype(np.uint64)
            rows[:len(shared)] = 7
            f.import_bits(rows, cols)
            f.row_attr_store.set_attrs(k + 1, {"from": k})
            srv.holder.index("i").column_attr_store.set_attrs(
                100 + k, {"c": k})
        # One sweep of node 0 merges the fragments both ways (it pushes
        # node 1's diff back); attributes are pulled, so node 1's own
        # sweep takes node 0's.
        servers[0].sync_holder()
        for s in range(3):
            a = servers[0].holder.fragment("i", "f", "standard", s)
            b = servers[1].holder.fragment("i", "f", "standard", s)
            assert a.blocks() == b.blocks()
            assert a.positions().tolist() == b.positions().tolist()
        servers[1].sync_holder()
        # The tar stream route: node 1's slice 0 into a fresh frame of
        # node 0, over HTTP.
        import urllib.request
        with urllib.request.urlopen(
                f"http://{hosts[1]}/fragment/data?index=i&frame=f"
                f"&view=standard&slice=0") as r:
            tar = r.read()
        servers[0].holder.index("i").create_frame("copy")
        req = urllib.request.Request(
            f"http://{hosts[0]}/fragment/data?index=i&frame=copy"
            f"&view=standard&slice=0", data=tar, method="POST")
        with urllib.request.urlopen(req) as r:
            assert r.status == 200
        assert servers[0].holder.fragment(
            "i", "copy", "standard", 0).positions().tolist() == \
            servers[1].holder.fragment(
                "i", "f", "standard", 0).positions().tolist()
        for srv in servers:
            store = srv.holder.frame("i", "f").row_attr_store
            assert store.attrs(1) == {"from": 0}
            assert store.attrs(2) == {"from": 1}
        assert servers[0].holder.index("i").column_attr_store.attrs(
            101) == {"c": 1}
    finally:
        for srv in servers:
            srv.close()
