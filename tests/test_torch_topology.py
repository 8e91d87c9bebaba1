"""The port's placement against the JAX package's, bit for bit.

``fnv1a_64``, ``jump_hash``, ``owner_hosts``, ``Cluster.partition``,
``Cluster.fragment_nodes`` and ``Cluster.owns_slices`` are held equal
over 1-8 hosts, replicas 1-3, slices 0-2000 and three index names, with
seeded host names and keys: a port node and a JAX node in one cluster
must agree on every slice's owners.
"""

import numpy as np
import pytest

from pilosa_tpu.cluster import topology as jtop

from pilosa_tpu_torch.cluster import topology as ttop

INDEXES = ("i", "c5", "index-with-a-long-name_0")
SLICES = range(2001)


def _hosts(n: int) -> list[str]:
    rng = np.random.default_rng(n)
    return [f"10.0.{int(rng.integers(256))}.{k}:{int(rng.integers(1024, 65536))}"
            for k in range(n)]


def test_fnv1a_64_and_jump_hash():
    rng = np.random.default_rng(7)
    for _ in range(2000):
        data = rng.integers(0, 256, size=int(rng.integers(0, 40)),
                            dtype=np.uint8).tobytes()
        assert ttop.fnv1a_64(data) == jtop.fnv1a_64(data)
        key = int(rng.integers(0, 2**63, dtype=np.uint64)) * 2 + 1
        n = int(rng.integers(1, 300))
        assert ttop.jump_hash(key, n) == jtop.jump_hash(key, n)
    for key in (0, 1, 2**64 - 1, 2**63):
        for n in (1, 2, 3, 16, 1000):
            assert ttop.jump_hash(key, n) == jtop.jump_hash(key, n)


@pytest.mark.parametrize("n_hosts", range(1, 9))
def test_placement_equals_jax(n_hosts):
    hosts = _hosts(n_hosts)
    for replicas in (1, 2, 3):
        tc = ttop.new_cluster(hosts, replica_n=replicas)
        jc = jtop.new_cluster(hosts, replica_n=replicas)
        for p in range(tc.partition_n):
            assert ttop.owner_hosts(hosts, p, replicas) == \
                jtop.owner_hosts(hosts, p, replicas)
        for index in INDEXES:
            for s in SLICES:
                assert tc.partition(index, s) == jc.partition(index, s)
                got = [n.host for n in tc.fragment_nodes(index, s)]
                assert got == [n.host for n in jc.fragment_nodes(index, s)]
                assert got == [n.host for n in tc.read_nodes(index, s)]
            for h in hosts:
                assert tc.owns_slices(index, 2000, h) == \
                    jc.owns_slices(index, 2000, h)
                assert tc.owns_fragment(h, index, 17) == \
                    jc.owns_fragment(h, index, 17)


def test_movement_equals_jax():
    old, new = _hosts(3), _hosts(4)
    for replicas in (1, 2):
        assert ttop.movement(old, new, 16, replicas) == \
            jtop.movement(old, new, 16, replicas)
