"""The port's durability layer against the JAX package's.

Both packages run the same seeded op sequences (numpy ``default_rng``)
on a fragment of their own: per-op SetBit/ClearBit, ``set_bits`` /
``clear_bits``, and both import lanes (the WAL'd batch lane of a small
import into a large fragment, and the WAL-first lane), with async
snapshots forced by a small ``MAX_OP_N`` set on each package's module.
The test then barriers and simulates a crash by copying the data file
without ``close``; each package reopens its copy and the bits, row
counts and LRU count caches must be identical. Also: a truncation at
every byte offset of the last WAL batch trims to the same prefix in
both (never past an acked record), a footered file with a WAL tail
written by either package opens and verifies in the other, and the
subprocess probe of two SetBits, ``barrier_all`` and ``os._exit(0)``
reopens to ``Count == [2]`` in both.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import pilosa_tpu.storage.fragment as jax_fragment
from pilosa_tpu.storage import integrity as jax_integrity
from pilosa_tpu.storage import roaring as jax_roaring
from pilosa_tpu.storage import wal as jax_wal

import pilosa_tpu_torch.storage.fragment as port_fragment
from pilosa_tpu_torch.storage import roaring as port_roaring
from pilosa_tpu_torch.storage import wal as port_wal

SW = 1 << 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": jax_fragment, "port": port_fragment}


def _frag(pkg, path, slice=0, cache_type="lru", cache_size=50000):
    f = PACKAGES[pkg].Fragment(path, "i", "f", "standard", slice,
                               cache_type=cache_type, cache_size=cache_size)
    f.open()
    return f


def _crash_copy(frag, dst):
    """Barrier, wait out any background snapshot, and copy the data
    file (and the count-cache sidecar if one exists) without closing:
    what a SIGKILL after the ack leaves on disk."""
    frag._join_snapshot()
    frag.wal_barrier()
    shutil.copyfile(frag.path, dst)
    if os.path.exists(frag.cache_path):
        shutil.copyfile(frag.cache_path, dst + ".cache")


def _abandon(frag):
    """Drop a fragment without close (the crashed process): its WAL
    writes nothing more and its flock is released."""
    import fcntl
    frag._join_snapshot()
    frag._wal.close()
    fcntl.flock(frag._file.fileno(), fcntl.LOCK_UN)
    frag._file.close()


def _lru_state(frag):
    return list(frag.cache._od.items())


def _state(frag):
    pos = frag.storage.all_positions()
    rows = np.unique(pos // np.uint64(SW))
    counts = [frag.row_count(int(r)) for r in rows.tolist()]
    return pos, rows, counts


@pytest.fixture
def small_op_log(monkeypatch):
    """A small MAX_OP_N (and WAL-first budget) on both modules, the way
    the JAX package's tests force snapshot storms."""
    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "MAX_OP_N", 40)
        monkeypatch.setattr(mod, "_WAL_IMPORT_MAX_BYTES", 13 * 3000)


def _ops(rng, n_steps=60):
    """A seeded op sequence: (kind, payload) tuples."""
    ops = []
    for _ in range(n_steps):
        kind = rng.choice(["set", "clear", "set_bits", "clear_bits",
                           "import_small", "import_big", "import_huge"],
                          p=[0.35, 0.15, 0.15, 0.1, 0.1, 0.1, 0.05])
        if kind in ("set", "clear"):
            ops.append((kind, (int(rng.integers(300)),
                               int(rng.integers(SW)))))
        elif kind in ("set_bits", "clear_bits"):
            k = int(rng.integers(1, 40))
            ops.append((kind, (rng.integers(300, size=k).astype(np.uint64),
                               rng.integers(SW, size=k).astype(np.uint64))))
        else:
            k = {"import_small": 3, "import_big": 800,
                 "import_huge": 5000}[kind]
            rows = rng.integers(300, size=k).astype(np.uint64)
            cols = rng.integers(SW, size=k).astype(np.uint64)
            ops.append((kind, np.unique(rows * np.uint64(SW) + cols)))
    return ops


def _apply(frag, op):
    kind, p = op
    if kind == "set":
        frag.set_bit(*p)
    elif kind == "clear":
        frag.clear_bit(*p)
    elif kind == "set_bits":
        frag.set_bits(*p)
    elif kind == "clear_bits":
        frag.clear_bits(*p)
    else:
        frag.import_positions(p)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_ops_crash_and_reopen_identical(tmp_path, small_op_log, seed):
    ops = _ops(np.random.default_rng(seed))
    frags = {pkg: _frag(pkg, str(tmp_path / f"{pkg}.frag"))
             for pkg in PACKAGES}
    # A large fragment first, so the small imports take the batch lane.
    wide = np.unique(np.arange(0, 300, dtype=np.uint64) * np.uint64(SW)
                     + np.arange(300, dtype=np.uint64) * np.uint64(65536))
    for f in frags.values():
        f.import_positions(wide)
    for op in ops:
        for f in frags.values():
            _apply(f, op)
        assert _lru_state(frags["jax"]) == _lru_state(frags["port"])
    snapshots = {pkg: f._snapshot_n for pkg, f in frags.items()}
    assert snapshots["port"] >= 1, "MAX_OP_N never forced a snapshot"
    live = {pkg: _state(f) for pkg, f in frags.items()}
    for pkg, f in frags.items():
        _crash_copy(f, str(tmp_path / f"{pkg}.copy"))
        _abandon(f)
    for pkg in PACKAGES:
        f = _frag(pkg, str(tmp_path / f"{pkg}.copy"))
        try:
            got = _state(f)
            assert np.array_equal(got[0], live["jax"][0])
            assert np.array_equal(got[1], live["jax"][1])
            assert got[2] == live["jax"][2]
            # The reopened count cache: sidecar ids, then the repair of
            # the rows the WAL replay added.
            if pkg == "port":
                assert _lru_state(f) == reopened_jax
            else:
                reopened_jax = _lru_state(f)
        finally:
            f.close()


@pytest.mark.parametrize("lane", ["batch", "wal_first", "detached"])
def test_lru_caches_follow_every_import_lane(tmp_path, monkeypatch, lane):
    """An evicting LRU count cache holds the same rows, counts and
    recency order in both packages after imports through each lane."""
    for mod in PACKAGES.values():
        monkeypatch.setattr(mod, "_WAL_IMPORT_MAX_BYTES",
                            13 * 50 if lane == "detached" else 32 << 20)
    rng = np.random.default_rng(7)
    frags = {pkg: _frag(pkg, str(tmp_path / pkg), cache_size=60)
             for pkg in PACKAGES}
    # 400 rows, one container each: a fragment large enough that a
    # 10-position import is a small one (10 × 16 < 400 containers).
    base = (np.arange(400, dtype=np.uint64) * np.uint64(SW)
            + rng.integers(SW, size=400).astype(np.uint64))
    for f in frags.values():
        f.import_positions(np.sort(base))
    for step in range(12):
        k = 10 if lane == "batch" else 200
        rows = rng.integers(400, size=k).astype(np.uint64)
        pos = np.unique(rows * np.uint64(SW)
                        + rng.integers(SW, size=k).astype(np.uint64))
        for f in frags.values():
            f.import_positions(pos)
        assert _lru_state(frags["jax"]) == _lru_state(frags["port"]), step
        assert len(frags["port"].cache) == 60  # it evicts
    for f in frags.values():
        f.close()


def test_lru_caches_follow_setbit_runs(tmp_path):
    """Runs of 8 or more SetBit/ClearBit calls in one query take the
    batch lane in both executors: the same answers, and evicting LRU
    count caches in the same state."""
    from pilosa_tpu.executor import Executor as JaxExecutor
    from pilosa_tpu.models.frame import FrameOptions as JaxFrameOptions
    from pilosa_tpu.models.holder import Holder as JaxHolder
    from pilosa_tpu_torch.executor import Executor as PortExecutor
    from pilosa_tpu_torch.models.frame import FrameOptions
    from pilosa_tpu_torch.models.holder import Holder as PortHolder

    jh, th = JaxHolder(str(tmp_path / "j")), PortHolder(str(tmp_path / "t"))
    jh.open()
    th.open()
    jh.create_index("i").create_frame("f", JaxFrameOptions(cache_size=20))
    th.create_index("i").create_frame("f", FrameOptions(cache_size=20))
    jex, tex = JaxExecutor(jh, host="local"), PortExecutor(th, device="cpu")
    rng = np.random.default_rng(5)
    try:
        for step in range(30):
            rows = rng.integers(60, size=12)
            cols = rng.integers(3 * SW, size=12)
            q = " ".join(f'SetBit(frame="f", rowID={int(r)}, '
                         f'columnID={int(c)})' for r, c in zip(rows, cols))
            if step % 3 == 0:
                q += " " + " ".join(
                    f'ClearBit(frame="f", rowID={int(r)}, columnID={int(c)})'
                    for r, c in zip(rows[:9], cols[:9]))
            assert jex.execute("i", q) == tex.execute("i", q)
        for s in range(3):
            jf = jh.fragment("i", "f", "standard", s)
            tf = th.fragment("i", "f", "standard", s)
            assert _lru_state(jf) == _lru_state(tf)
            assert len(tf.cache) == 20
            assert np.array_equal(jf.storage.all_positions(),
                                  tf.storage.all_positions())
    finally:
        jex.close()
        jh.close()
        th.close()


def _write_batch(frag, cols):
    frag.set_bits(np.full(len(cols), 1, dtype=np.uint64),
                  np.asarray(cols, dtype=np.uint64))


def test_truncation_at_every_offset_of_the_last_batch(tmp_path):
    """A crash tears the last WAL batch at an arbitrary byte: both
    packages trim to the same prefix, and every acked record stays."""
    acked = list(range(8))
    batch = [99, 100, 101, 102]
    srcs = {}
    for pkg in PACKAGES:
        f = _frag(pkg, str(tmp_path / f"{pkg}.src"))
        for col in acked:
            f.set_bit(1, col)
        f.wal_barrier()
        acked_size = os.path.getsize(f.path)
        _write_batch(f, batch)
        f.wal_barrier()
        assert os.path.getsize(f.path) == acked_size + 13 * len(batch)
        _crash_copy(f, str(tmp_path / f"{pkg}.full"))
        _abandon(f)
        srcs[pkg] = (str(tmp_path / f"{pkg}.full"), acked_size)
    for k in range(13 * len(batch) + 1):
        got = {}
        for pkg, (full, acked_size) in srcs.items():
            for reader in PACKAGES:
                dst = str(tmp_path / f"{pkg}-{reader}-{k}")
                shutil.copyfile(full, dst)
                os.truncate(dst, acked_size + k)
                f = _frag(reader, dst)
                got[(pkg, reader)] = sorted(f.row(1).bits())
                assert os.path.getsize(dst) == acked_size + 13 * (k // 13)
                f.close()
        want = acked + batch[:k // 13]
        assert all(v == want for v in got.values()), (k, got)


def test_footered_files_with_wal_tail_interchange(tmp_path):
    """A file one package snapshotted (footered) and then extended with
    WAL records opens in the other, verifies, and holds the same bits."""
    rng = np.random.default_rng(11)
    for writer, reader in (("port", "jax"), ("jax", "port")):
        path = str(tmp_path / f"{writer}.frag")
        f = _frag(writer, path)
        rows = rng.integers(50, size=500).astype(np.uint64)
        cols = rng.integers(SW, size=500).astype(np.uint64)
        f.import_positions(np.unique(rows * np.uint64(SW) + cols))
        f.snapshot()
        for i in range(30):
            f.set_bit(int(rng.integers(50)), int(rng.integers(SW)))
        f.clear_bit(int(rows[0]), int(cols[0]))
        want = f.storage.all_positions()
        dst = str(tmp_path / f"{writer}-to-{reader}")
        _crash_copy(f, dst)
        _abandon(f)
        with open(dst, "rb") as fh:
            data = fh.read()
        # Footer and whole-body digest verify with the JAX package's
        # integrity code, and the op-log tail is present.
        bm = jax_roaring.Bitmap.unmarshal(data, verify_body=True)
        assert bm.footer is not None and bm.op_n == 31
        assert port_roaring.Bitmap.unmarshal(
            data, verify_body=True).op_n == 31
        g = _frag(reader, dst)
        try:
            if reader == "jax":
                # The JAX package's lazy per-block check on first read.
                g.row(1)
                assert not g.quarantined
                bad = jax_integrity.verify_blocks(g._mmap, g.storage.footer)
                assert not bad
            assert np.array_equal(g.storage.all_positions(), want)
        finally:
            g.close()


_PROBE = """
import os, sys
sys.path.insert(0, {repo!r})
pkg = sys.argv[1]
if pkg == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    from pilosa_tpu.models.holder import Holder
    from pilosa_tpu.executor import Executor
    from pilosa_tpu.storage import wal
    kw = dict(host="local")
else:
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.storage import wal
    kw = dict(device="cpu")
h = Holder(sys.argv[2])
h.open()
if sys.argv[3] == "write":
    idx = h.create_index("i")
    idx.create_frame("f")
    ex = Executor(h, **kw)
    ex.execute("i", 'SetBit(frame="f", rowID=1, columnID=3)')
    ex.execute("i", 'SetBit(frame="f", rowID=1, columnID=5)')
    wal.barrier_all()
    os._exit(0)
ex = Executor(h, **kw)
print(ex.execute("i", 'Count(Bitmap(frame="f", rowID=1))'))
os._exit(0)
"""


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_acked_writes_survive_process_exit(tmp_path, pkg):
    """Two SetBits, the commit barrier, then the process dies without
    closing anything: the reopen counts both bits."""
    script = _PROBE.format(repo=REPO)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    data = str(tmp_path / "data")
    for step in ("write", "read"):
        out = subprocess.run([sys.executable, "-c", script, pkg, data, step],
                             capture_output=True, text=True, timeout=120,
                             env=env, cwd=REPO)
        assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[2]"


def test_barrier_and_flusher_semantics(tmp_path):
    """The port's WAL keeps the JAX WAL's contract: appends are buffered,
    a barrier writes them, the background flusher drains what nobody
    barriers and then exits, and a failed leader write truncates to the
    durable prefix and raises WalError to its waiters."""
    import threading
    import time
    for mod in (jax_wal, port_wal):
        path = str(tmp_path / f"{mod.__name__}.log")
        with open(path, "a+b", buffering=0) as fh:
            w = mod.GroupCommitWal(fh, fsync_policy="none")
            seq = w.append(b"x" * 13)
            assert w.durable_seq() == 0 and w.pending_bytes() == 13
            w.flush(seq)
            assert w.durable_seq() == 13 and os.path.getsize(path) == 13
            w.append(b"y" * 26)
            deadline = time.monotonic() + 10
            while w.pending_bytes() and time.monotonic() < deadline:
                time.sleep(0.005)
            assert w.pending_bytes() == 0 and os.path.getsize(path) == 39
            w.close()
    # The port's flusher thread ends once nothing is dirty.
    deadline = time.monotonic() + 10
    while port_wal._flusher is not None and time.monotonic() < deadline:
        time.sleep(0.005)
    assert port_wal._flusher is None
    assert not any(t.name == "wal-group-flusher" and t.is_alive()
                   and t is not jax_wal._flusher
                   for t in threading.enumerate())

    class Torn:
        """A file whose write lands half the batch, then fails."""
        def __init__(self, fh):
            self.fh = fh

        def seek(self, *a):
            return self.fh.seek(*a)

        def fileno(self):
            return self.fh.fileno()

        def write(self, data):
            self.fh.write(data[:len(data) // 2])
            raise OSError(28, "No space left on device")

    path = str(tmp_path / "torn.log")
    with open(path, "a+b", buffering=0) as fh:
        fh.write(b"h" * 8)
        w = port_wal.GroupCommitWal(fh)
        w.append(b"a" * 13)
        w.barrier()
        w._file = Torn(fh)
        w.append(b"b" * 26)
        with pytest.raises(port_wal.WalError) as err:
            w.barrier()
        assert err.value.__cause__.errno == 28
        assert os.path.getsize(path) == 8 + 13  # back to the durable prefix
        assert w.pending_bytes() == 26          # kept for the retry
        w._file = fh
        w.barrier()
        assert os.path.getsize(path) == 8 + 39
        w.close()


def test_write_ack_waits_for_the_commit_barrier(tmp_path, monkeypatch):
    """With the background flusher held off, a write query's 200 and an
    /import's 200 still come only after the records reach the file; a
    read query writes nothing. A barrier that fails on a full disk
    answers 507 with Retry-After, any other failure 500."""
    from pilosa_tpu_torch.executor import Executor
    from pilosa_tpu_torch.models.holder import Holder
    from pilosa_tpu_torch.proto import internal as pb
    from pilosa_tpu_torch.server.handler import Handler
    from test_torch_server import call

    import time
    # Hold the background flusher off: wait for the running one to end
    # (it does once nothing is dirty) and start no other.
    deadline = time.monotonic() + 10
    while port_wal._flusher is not None and time.monotonic() < deadline:
        time.sleep(0.005)
    assert port_wal._flusher is None

    def register_quietly(wal):
        with port_wal._dirty_mu:
            port_wal._dirty.add(wal)

    monkeypatch.setattr(port_wal, "_register_dirty", register_quietly)
    h = Holder(str(tmp_path / "d"))
    h.open()
    app = Handler(h, Executor(h, device="cpu"))
    try:
        assert call(app, "POST", "/index/i", b"{}")[0] == 200
        assert call(app, "POST", "/index/i/frame/f", b"{}")[0] == 200
        assert call(app, "POST", "/index/i/query",
                    'SetBit(frame="f", rowID=1, columnID=3)')[0] == 200
        frag = h.fragment("i", "f", "standard", 0)
        size = os.path.getsize(frag.path)
        for q in ('SetBit(frame="f", rowID=1, columnID=4)',
                  'ClearBit(frame="f", rowID=1, columnID=3) '
                  'Count(Bitmap(frame="f", rowID=1))'):
            assert call(app, "POST", "/index/i/query", q)[0] == 200
            assert frag._wal.pending_bytes() == 0
            assert os.path.getsize(frag.path) == size + 13
            size += 13
        body = pb.ImportRequest(Index="i", Frame="f", Slice=0,
                                RowIDs=[2, 2], ColumnIDs=[7, 9]
                                ).SerializeToString()
        assert call(app, "POST", "/import", body,
                    content_type="application/x-protobuf",
                    accept="application/x-protobuf")[0] == 200
        assert frag._wal.pending_bytes() == 0
        assert os.path.getsize(frag.path) == size + 26

        class Full:
            """The data file, refusing writes like a full disk."""
            def __init__(self, fh, code):
                self.fh, self.code = fh, code

            def seek(self, *a):
                return self.fh.seek(*a)

            def fileno(self):
                return self.fh.fileno()

            def write(self, data):
                raise OSError(self.code, os.strerror(self.code))

        real = frag._wal._file
        for code, status in ((28, 507), (5, 500)):
            frag._wal._file = Full(real, code)
            st, _, out = call(app, "POST", "/index/i/query",
                              f'SetBit(frame="f", rowID=1, columnID={code})')
            assert st == status, out
            frag._wal._file = real
            frag.wal_barrier()  # the retry lands the kept batch
        assert frag._wal.pending_bytes() == 0
    finally:
        h.close()
