"""The port's backup package against the JAX package's, unit by unit.

Every case runs the same seeded input through both packages and
requires the same result: the pool objects a fragment file decomposes
into (keys and bytes, the hash-named tail included), the WAL segments
of the same batches, the crash journal in both directions, the
retention plan of one archive, the archiver's flush order, outage
requeue and seq resume, the rejection of corrupt, torn and unfootered
objects, and the ``backup.push`` / ``restore.fetch`` failpoints' hit
sequences and the bytes they leave behind.
"""

from __future__ import annotations

import io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from pilosa_tpu.backup import archive as j_archive
from pilosa_tpu.backup import coordinator as j_coord
from pilosa_tpu.backup import retention as j_retention
from pilosa_tpu.backup import walarchive as j_walarchive
from pilosa_tpu.fault import failpoints as j_fp
from pilosa_tpu.storage import integrity as j_integrity
from pilosa_tpu.storage import roaring as j_roaring
from pilosa_tpu.tier import blob as j_blob

from pilosa_tpu_torch.backup import archive as t_archive
from pilosa_tpu_torch.backup import coordinator as t_coord
from pilosa_tpu_torch.backup import retention as t_retention
from pilosa_tpu_torch.backup import walarchive as t_walarchive
from pilosa_tpu_torch.fault import failpoints as t_fp
from pilosa_tpu_torch.storage import integrity as t_integrity
from pilosa_tpu_torch.storage import roaring as t_roaring
from pilosa_tpu_torch.tier import blob as t_blob

JAX = SimpleNamespace(name="jax", archive=j_archive, coord=j_coord,
                      retention=j_retention, walarchive=j_walarchive,
                      fp=j_fp, integrity=j_integrity, roaring=j_roaring,
                      blob=j_blob)
TORCH = SimpleNamespace(name="torch", archive=t_archive, coord=t_coord,
                        retention=t_retention, walarchive=t_walarchive,
                        fp=t_fp, integrity=t_integrity,
                        roaring=t_roaring, blob=t_blob)
PKGS = (JAX, TORCH)


def _values(seed: int, kind: str) -> np.ndarray:
    """Seeded fragment contents: a few arrays, many containers, runs, a
    bitmap container, or bit positions past 2^31."""
    rng = np.random.default_rng(seed)
    if kind == "small":
        v = rng.choice(1 << 16, size=40, replace=False)
    elif kind == "blocks":
        v = rng.choice(16 << 20, size=6000, replace=False)
    elif kind == "runs":
        starts = rng.choice(1 << 20, size=12, replace=False) * 64
        v = np.concatenate([np.arange(s, s + 500) for s in starts])
    elif kind == "dense":
        v = rng.choice(1 << 16, size=20000, replace=False)
    else:  # high rows
        v = (np.uint64(1) << np.uint64(33)) + rng.choice(
            4 << 20, size=300, replace=False).astype(np.uint64)
    return np.unique(np.asarray(v, dtype=np.uint64))


def _footered(pkg, values, footer: bool = True) -> bytes:
    b = pkg.roaring.Bitmap()
    b.add_many(np.asarray(values, dtype=np.uint64))
    if len(values) and values[0] % 64 == 0:
        b.optimize()  # the run-container case
    buf = io.BytesIO()
    b.write_to(buf, footer=footer)
    return buf.getvalue()


def _pool(store) -> dict:
    return {k: store.get(k) for k in sorted(store.list(""))}


@pytest.fixture
def failpoints():
    """Both packages' default failpoint registries, restored after."""
    saved = [(m, m._default, m.ACTIVE) for m in (j_fp, t_fp)]
    yield
    for m, default, active in saved:
        if m._default is not None:
            m._default.disarm_all()
        m._default, m.ACTIVE = default, active


# -- the object pool -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["small", "blocks", "runs", "dense",
                                  "high"])
@pytest.mark.parametrize("seed", [0, 5])
def test_pool_objects_and_bytes_equal_jax(tmp_path, kind, seed):
    """One fragment file pushed by each package: the same keys (head,
    blocks, the hash-named tail), the same object bytes, manifest and
    body digest; each package fetches the other's pool back to the
    file, and a second push skips every object."""
    body = _footered(TORCH, _values(seed, kind))
    assert body == _footered(JAX, _values(seed, kind))
    prefix = t_archive.fragment_prefix("i", "f", "standard", seed)
    assert prefix == j_archive.fragment_prefix("i", "f", "standard", seed)
    out = {}
    for pkg in PKGS:
        store = pkg.blob.LocalDirBlobStore(str(tmp_path / pkg.name))
        fm, digest, pushed, nbytes = pkg.archive.push_fragment_bytes(
            store, prefix, body)
        assert pushed == 2 + int(fm["blockN"]) and nbytes == len(body)
        assert pkg.archive.push_fragment_bytes(store, prefix,
                                               body)[2:] == (0, 0)
        out[pkg.name] = (store, fm, digest, _pool(store))
    (js, jfm, jd, jpool), (ts, tfm, td, tpool) = out["jax"], out["torch"]
    assert (tfm, td) == (jfm, jd)
    assert tpool == jpool
    assert tfm["tail"].startswith("tail-")
    assert bytes(t_archive.fetch_fragment_bytes(js, prefix, jfm,
                                                jd)) == body
    assert bytes(j_archive.fetch_fragment_bytes(ts, prefix, tfm,
                                                td)) == body


def test_incremental_ships_the_same_changed_blocks(tmp_path):
    vals = set(range(0, 200000, 7))
    prefix = t_archive.fragment_prefix("i", "f", "standard", 0)
    pushed = {}
    for pkg in PKGS:
        store = pkg.blob.LocalDirBlobStore(str(tmp_path / pkg.name))
        full = pkg.archive.push_fragment_bytes(
            store, prefix, _footered(pkg, sorted(vals)))[2]
        delta = pkg.archive.push_fragment_bytes(
            store, prefix, _footered(pkg, sorted(vals | {3})))[2]
        pushed[pkg.name] = (full, delta, _pool(store))
    assert pushed["torch"] == pushed["jax"]
    full, delta, _ = pushed["torch"]
    assert 0 < delta < full


def test_tail_objects_are_content_distinct(tmp_path):
    """Footers end with their own crc32, so crc-named tails would alias
    every fragment's footer to one object (the CRC residue): the tail is
    named by a hash of its bytes."""
    store = t_blob.LocalDirBlobStore(str(tmp_path))
    prefix = t_archive.fragment_prefix("i", "f", "standard", 0)
    fm1, d1, _, _ = t_archive.push_fragment_bytes(
        store, prefix, _footered(TORCH, [1, 2]))
    fm2, d2, _, _ = t_archive.push_fragment_bytes(
        store, prefix, _footered(TORCH, [3, 4]))
    assert fm1["tail"] != fm2["tail"]
    for fm, d in ((fm1, d1), (fm2, d2)):
        t_archive.fetch_fragment_bytes(store, prefix, fm, d)


# -- WAL segments ----------------------------------------------------------------


def _batches(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(1, 6))):
        ops = b"".join(
            t_roaring.Op(int(rng.integers(0, 2)),
                         int(rng.integers(0, 1 << 40))).marshal()
            for _ in range(int(rng.integers(1, 9))))
        out.append({"frag": f"i/f/standard/{int(rng.integers(0, 4))}",
                    "t": 1.7e9 + float(rng.random()) * 100 + i,
                    "ops": ops})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_wal_segments_byte_equal(tmp_path, seed):
    batches = _batches(seed)
    node = "127.0.0.1:10101"
    bodies = [pkg.archive.encode_wal_segment(node, seed, batches)
              for pkg in PKGS]
    assert bodies[0] == bodies[1]
    keys = [pkg.archive.wal_segment_key(node, seed, bodies[0])
            for pkg in PKGS]
    assert keys[0] == keys[1] and ":" not in keys[0].split("/", 1)[1]
    store = t_blob.LocalDirBlobStore(str(tmp_path))
    store.put(keys[0], bodies[0])
    segs = [pkg.archive.read_wal_segment(store, keys[0]) for pkg in PKGS]
    assert segs[0] == segs[1]
    assert [b["ops"] for b in segs[1]["batches"]] == [
        b["ops"] for b in batches]


def test_wal_listing_and_next_seq_equal_jax(tmp_path):
    store = t_blob.LocalDirBlobStore(str(tmp_path))
    for node, seq in (("b", 1), ("a", 2), ("a", 0), ("b", 0)):
        body = t_archive.encode_wal_segment(node, seq, [])
        store.put(t_archive.wal_segment_key(node, seq, body), body)
    store.put("wal/a/garbage", b"nope")
    lists = [pkg.archive.list_wal_segments(store) for pkg in PKGS]
    assert lists[0] == lists[1]
    assert [(n, s) for _, n, s in lists[1]] == [
        ("a", 0), ("a", 2), ("b", 0), ("b", 1)]
    for node in ("a", "b", "c"):
        assert (t_archive.next_wal_seq(store, node)
                == j_archive.next_wal_seq(store, node))
    for key in ("wal/n/short", "data/i/f/s/0/head-0",
                t_archive.wal_segment_key("n:1", 7, b"x")):
        assert t_archive.parse_wal_key(key) == j_archive.parse_wal_key(key)


# -- the crash journal -------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [(TORCH, JAX), (JAX, TORCH)])
def test_journal_round_trip_across_packages(tmp_path, writer, reader):
    w = writer.coord.BackupJournal.for_data_dir(str(tmp_path))
    assert w.load() is None and not w.in_flight()
    w.write(phase=writer.coord.PHASE_SNAPSHOT, id="abc", kind="full",
            walStart={"n1": 3}, fragments={"i/f/standard/0": {"x": 1}})
    r = reader.coord.BackupJournal.for_data_dir(str(tmp_path))
    state = r.load()
    assert state == w.state and r.in_flight()
    r.write(phase=reader.coord.PHASE_DONE)
    assert not writer.coord.BackupJournal.for_data_dir(
        str(tmp_path)).load() is None
    assert not r.in_flight()
    r.clear()
    assert writer.coord.BackupJournal.for_data_dir(
        str(tmp_path)).load() is None


def test_journal_version_mismatch_ignored_alike(tmp_path):
    path = os.path.join(str(tmp_path), t_coord.JOURNAL_FILE)
    assert t_coord.JOURNAL_FILE == j_coord.JOURNAL_FILE
    with open(path, "w") as f:
        json.dump({"version": 99, "phase": "snapshot"}, f)
    assert t_coord.BackupJournal(path).load() is None
    assert j_coord.BackupJournal(path).load() is None
    assert t_coord.PHASES == j_coord.PHASES


# -- retention + GC -------------------------------------------------------------


def _fake_backup(pkg, store, bid, kind, t, parent=None, rows=(1,),
                 wal_start=None, slice=0):
    """A committed manifest whose one fragment lives in the pool."""
    body = _footered(pkg, sorted(rows))
    prefix = pkg.archive.fragment_prefix("i", "f", "standard", slice)
    fm, digest, _, _ = pkg.archive.push_fragment_bytes(store, prefix,
                                                       body)
    manifest = {
        "version": pkg.archive.MANIFEST_VERSION, "id": bid, "kind": kind,
        "parent": parent, "t": t, "coordinator": "n0", "epoch": 0,
        "hosts": ["n0"], "schema": [], "maxSlices": {"i": slice},
        "walStart": dict(wal_start or {}),
        "fragments": [{"index": "i", "frame": "f", "view": "standard",
                       "slice": slice, "prefix": prefix,
                       "bodyDigest": digest, "manifest": fm}]}
    pkg.archive.write_backup_manifest(store, manifest)
    return manifest


def _archive_with_chains(pkg, root) -> object:
    store = pkg.blob.LocalDirBlobStore(root)
    _fake_backup(pkg, store, "f1", "full", 100.0, rows=(1, 2),
                 wal_start={"n": 0, "m": 0})
    _fake_backup(pkg, store, "i1", "incremental", 150.0, parent="f1",
                 rows=(1, 2, 3), wal_start={"n": 2, "m": 0}, slice=1)
    _fake_backup(pkg, store, "f2", "full", 200.0, rows=(4,),
                 wal_start={"n": 5, "m": 1})
    _fake_backup(pkg, store, "i2", "incremental", 250.0, parent="i1",
                 rows=(9,), wal_start={"n": 6, "m": 1}, slice=2)
    _fake_backup(pkg, store, "f3", "full", 300.0, rows=(5,),
                 wal_start={"n": 7, "m": 1})
    for node, n in (("n", 9), ("m", 3)):
        for seq in range(n):
            body = pkg.archive.encode_wal_segment(node, seq, [])
            store.put(pkg.archive.wal_segment_key(node, seq, body), body)
    store.put("data/i/f/standard/0/stray-deadbeef", b"debris")
    return store


@pytest.mark.parametrize("keep", [1, 2, 3, 5])
def test_plan_gc_equal_jax(tmp_path, keep):
    """The same archive (built by either package: the same bytes) gives
    the same plan, and each GC leaves the same objects behind."""
    stores = {pkg.name: _archive_with_chains(pkg, str(tmp_path / pkg.name))
              for pkg in PKGS}
    assert _pool(stores["torch"]) == _pool(stores["jax"])
    plans = [pkg.retention.plan_gc(stores[pkg.name], keep) for pkg in PKGS]
    assert plans[0] == plans[1]
    for sweep in (False, True):
        dry = [pkg.retention.run_gc(stores[pkg.name], keep, dry_run=True,
                                    sweep_orphans=sweep) for pkg in PKGS]
        assert dry[0] == dry[1] and dry[1]["deleted"] == 0
    done = [pkg.retention.run_gc(stores[pkg.name], keep,
                                 sweep_orphans=True) for pkg in PKGS]
    assert done[0] == done[1]
    assert _pool(stores["torch"]) == _pool(stores["jax"])
    newest = t_archive.read_backup(stores["torch"], "f3")
    for _name, verdict in t_archive.verify_backup(stores["torch"],
                                                  newest):
        assert not verdict["corrupt"]


@pytest.mark.parametrize("newest_names_m", [True, False])
def test_gc_keeps_the_wal_a_kept_backup_replays(tmp_path, newest_names_m):
    """A kept full taken before node ``m`` wrote any segment has no
    watermark for ``m``: restore replays ``m``'s segments from 0. The
    JAX plan takes ``m``'s floor from the other kept backups only and
    drops segments that backup replays (ROADMAP fault 3.20): when the
    newest full names ``m`` the JAX GC deletes them, else its own check
    refuses the plan. The port's floor for ``m`` is 0: nothing of it
    drops, and the GC runs."""
    out = {}
    for pkg in PKGS:
        store = pkg.blob.LocalDirBlobStore(str(tmp_path / pkg.name))
        _fake_backup(pkg, store, "f1", "full", 100.0,
                     wal_start={"n": 2} if newest_names_m
                     else {"n": 2, "m": 3})
        _fake_backup(pkg, store, "f2", "full", 200.0, rows=(4,),
                     wal_start={"n": 4, "m": 3} if newest_names_m
                     else {"n": 4})
        for node, n in (("n", 6), ("m", 5)):
            for seq in range(n):
                body = pkg.archive.encode_wal_segment(node, seq, [])
                store.put(pkg.archive.wal_segment_key(node, seq, body),
                          body)
        plan = pkg.retention.plan_gc(store, keep_fulls=2)
        try:
            done = pkg.retention.run_gc(store, keep_fulls=2)["deleted"]
        except pkg.retention.GCError as e:
            done = str(e)
        out[pkg.name] = (sorted(plan["dropWalSegments"]), done)
    jax_drop, jax_done = out["jax"]
    port_drop, port_done = out["torch"]
    assert [k.split("/")[1] for k in port_drop] == ["n", "n"]
    assert port_done == 2
    assert any(k.split("/")[1] == "m" for k in jax_drop)
    if newest_names_m:
        assert jax_done == 2 + 3  # m's segments 0-2 deleted
    else:
        assert "refusing to GC" in jax_done


@pytest.mark.parametrize("what", ["objects", "wal"])
def test_run_gc_refuses_to_break_the_newest_chain_alike(tmp_path,
                                                        monkeypatch, what):
    out = []
    for pkg in PKGS:
        store = pkg.blob.LocalDirBlobStore(str(tmp_path / pkg.name))
        m = _fake_backup(pkg, store, "f1", "full", 100.0,
                         wal_start={"n": 3})
        body = pkg.archive.encode_wal_segment("n", 5, [])
        key = pkg.archive.wal_segment_key("n", 5, body)
        store.put(key, body)
        evil = pkg.retention.plan_gc(store, 1)
        if what == "objects":
            evil["dropObjects"] = sorted(
                pkg.archive.manifest_object_keys(m))
        else:
            evil["dropWalSegments"] = [key]
        monkeypatch.setattr(pkg.retention, "plan_gc",
                            lambda *a, _e=evil, **k: dict(_e))
        with pytest.raises(pkg.retention.GCError) as ei:
            pkg.retention.run_gc(store, 1)
        out.append((str(ei.value), _pool(store)))
    assert out[0] == out[1]


# -- the WAL archiver ---------------------------------------------------------------


class _FlakyStore:
    """Delegating store whose next ``fail`` puts raise OSError."""

    def __init__(self, inner, fail=0):
        self.inner = inner
        self.fail = fail

    def put(self, key, data):
        if self.fail > 0:
            self.fail -= 1
            raise OSError("injected archive outage")
        self.inner.put(key, data)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def _frag_path(root, slice=0):
    return os.path.join(str(root), "i", "f", "views", "standard",
                        "fragments", str(slice))


def _archiver_run(pkg, root, scenario: str) -> list:
    """Drive one archiver through ``scenario``; the segments it left,
    as (node, seq, [(frag, ops)]) with the stamps dropped."""
    store = pkg.blob.LocalDirBlobStore(os.path.join(root, "arch"))
    data = os.path.join(root, "data")
    if scenario == "resume":
        for seq in (0, 1):
            body = pkg.archive.encode_wal_segment("n1", seq, [])
            store.put(pkg.archive.wal_segment_key("n1", seq, body), body)
    flaky = _FlakyStore(store, fail=1 if scenario == "outage" else 0)
    a = pkg.walarchive.WalArchiver(flaky, data, "n1")
    assert a._frag_key(_frag_path(data, 7)) == "i/f/standard/7"
    assert a._frag_key(os.path.join(data, "backup.json")) is None
    a._on_batch(_frag_path(data), b"\x01" * 13)
    a._on_batch(_frag_path(data, 2), b"\x02" * 26)
    a._on_batch(os.path.join(data, "junk"), b"zz")
    events = []
    try:
        events.append(a.flush())
    except OSError as e:
        events.append(str(e))
    a._on_batch(_frag_path(data), b"\x03" * 13)
    events.append(a.flush())
    events.append(a.flush())
    state = a.state()
    events.append({k: state[k] for k in ("nextSeq", "buffered",
                                         "segmentsWritten",
                                         "recordsArchived", "errors")})
    for key, node, seq in pkg.archive.list_wal_segments(store):
        seg = pkg.archive.read_wal_segment(store, key)
        events.append((node, seq, [(b["frag"], b["ops"])
                                   for b in seg["batches"]]))
    return events


@pytest.mark.parametrize("scenario", ["order", "outage", "resume"])
def test_archiver_equal_jax(tmp_path, scenario):
    """Flush order is commit order, a store outage requeues the batches
    at the front in order, and the seq resumes from the store."""
    got = [_archiver_run(pkg, str(tmp_path / pkg.name), scenario)
           for pkg in PKGS]
    assert got[0] == got[1]
    segs = [e for e in got[1] if isinstance(e, tuple)]
    ops = [o for _, _, batches in segs for _, o in batches]
    assert [o[:1] for o in ops] == [b"\x01", b"\x02", b"\x03"]
    if scenario == "resume":
        assert segs[-1][1] >= 2


# -- rejection of corrupt, torn and unfootered objects ---------------------------


def _reject(pkg, root, kind: str) -> tuple:
    store = pkg.blob.LocalDirBlobStore(root)
    body = _footered(pkg, list(range(0, 5000, 3)))
    prefix = pkg.archive.fragment_prefix("i", "f", "standard", 0)
    try:
        if kind == "unfootered":
            pkg.archive.push_fragment_bytes(
                store, prefix, _footered(pkg, [1, 2], footer=False))
            return ("accepted",)
        if kind == "wal_crc":
            seg = pkg.archive.encode_wal_segment(
                "n1", 3, [{"frag": "i/f/standard/0", "t": 1.0,
                           "ops": b"x" * 13}])
            key = pkg.archive.wal_segment_key("n1", 3, seg)
            store.put(key, seg + b" ")
            pkg.archive.read_wal_segment(store, key)
            return ("accepted",)
        fm, digest, _, _ = pkg.archive.push_fragment_bytes(store, prefix,
                                                           body)
        keys = sorted(store.list(prefix + "/"))
        path = store._path(keys[0] if kind != "torn_tail" else keys[-1])
        raw = bytearray(open(path, "rb").read())
        if kind == "corrupt":
            raw[len(raw) // 2] ^= 0xFF
        elif kind.startswith("torn"):
            raw = raw[:max(1, len(raw) // 2)]
        with open(path, "wb") as f:
            f.write(bytes(raw))
        if kind == "digest":
            digest = "0" * 32
        pkg.archive.fetch_fragment_bytes(store, prefix, fm, digest)
        return ("accepted",)
    except pkg.integrity.CorruptionError as e:
        return ("CorruptionError", str(e))


@pytest.mark.parametrize("kind", ["corrupt", "torn", "torn_tail",
                                  "digest", "unfootered", "wal_crc"])
def test_rejections_equal_jax(tmp_path, kind):
    got = [_reject(pkg, str(tmp_path / pkg.name), kind) for pkg in PKGS]
    assert got[0] == got[1]
    assert got[1][0] == "CorruptionError"


# -- the backup.push and restore.fetch failpoints -------------------------------


def _failpoint_run(pkg, root, site: str, spec: str, seed: int) -> list:
    store = pkg.blob.LocalDirBlobStore(root)
    pkg.fp.seed_default(seed)
    keys = [f"data/i/f/standard/0/blk-{i}-{i:08x}" for i in range(12)]
    data = {k: bytes(np.random.default_rng(i).integers(
        0, 256, 64, dtype=np.uint8)) for i, k in enumerate(keys)}
    if site == "restore.fetch":
        for k in keys:
            store.put(k, data[k])
    pkg.fp.arm(site, spec)
    out = []
    for k in keys:
        try:
            if site == "backup.push":
                pkg.archive.put_object(store, k, data[k])
                out.append("ok")
            else:
                out.append(pkg.archive.get_object(store, k) == data[k])
        except OSError as e:
            out.append(type(e).__name__ + ": " + str(e))
    pkg.fp.disarm_all()
    out.append(sum(store.get(k) != data[k] for k in keys))
    out.append(_pool(store))
    return out


@pytest.mark.parametrize("site,spec", [
    ("backup.push", "error(0.4)"), ("backup.push", "torn(9)*2"),
    ("backup.push", "corrupt(3)*3"),
    ("backup.push", "partition(blk-3)"),
    ("restore.fetch", "error(0.5)*4"), ("restore.fetch", "corrupt(2)*2"),
    ("restore.fetch", "partition(blk-1)")])
@pytest.mark.parametrize("seed", [1, 7])
def test_failpoint_hits_equal_jax(tmp_path, failpoints, site, spec, seed):
    """Seeded schedules hit the same objects in both packages and leave
    the same bytes behind: a push fires after the store write (error
    keeps the object, torn replaces it with a prefix, corrupt flips
    stored bits) and a fetch's corrupt flips stored bits before the
    read."""
    got = [_failpoint_run(pkg, str(tmp_path / pkg.name), site, spec, seed)
           for pkg in PKGS]
    assert got[0] == got[1]
    outcomes, changed = got[1][:-2], got[1][-2]
    assert changed or any(x is not True and x != "ok" for x in outcomes)
