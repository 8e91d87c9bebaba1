"""Backup and point-in-time restore end to end on CPU servers, the port
held to the JAX package.

In process, over real sockets, with one shared ``dir:`` archive:

- a two-node cluster backed up while a writer thread keeps writing, an
  incremental on top, every data directory destroyed, then a restore
  into a cluster of another size (three nodes) with the captured reads
  verified (0 mismatches) and a ``--to-timestamp`` restore into one
  node that holds exactly the writes acked before the cut — with the
  port on both sides, a JAX cluster's archive restored into port nodes
  and a port cluster's archive restored into a JAX node, every Count,
  TopN order and bitmap equal to the seeded model;
- a coordinator that stops mid-push resumes the same backup id at the
  next open, reusing what the journal and the pool hold;
- the ``backup --list``, ``--gc`` and ``check --deep --archive`` verbs
  print what the JAX verbs print over the same archive;
- a slice that a resize moves while the WAL archive runs: the JAX
  restore keeps one node's op stream of a fragment (ROADMAP fault
  3.17) and loses the other's writes, the port's replays the union of
  the streams in stamp order and loses none;
- ``Client.queries`` against a JAX node.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
import types
import urllib.request

import numpy as np
import pytest

import pilosa_tpu.backup.archive as j_archive
import pilosa_tpu.backup.coordinator as j_coord
import pilosa_tpu.backup.restore as j_restore
import pilosa_tpu.backup.verify as j_verify
import pilosa_tpu.cli.commands as jax_cli
import pilosa_tpu.cluster.broadcast as j_broadcast
import pilosa_tpu.cluster.client as j_client
import pilosa_tpu.cluster.topology as j_top
import pilosa_tpu.fault.failpoints as j_fp
import pilosa_tpu.obs.replay as j_replay
import pilosa_tpu.utils.config as j_config
from pilosa_tpu.server.server import Server as JaxServer

import pilosa_tpu_torch.backup.archive as t_archive
import pilosa_tpu_torch.backup.coordinator as t_coord
import pilosa_tpu_torch.backup.restore as t_restore
import pilosa_tpu_torch.backup.verify as t_verify
import pilosa_tpu_torch.cli.commands as port_cli
import pilosa_tpu_torch.cluster.client as t_client
import pilosa_tpu_torch.cluster.topology as t_top
import pilosa_tpu_torch.fault.failpoints as t_fp
import pilosa_tpu_torch.obs.replay as t_replay
import pilosa_tpu_torch.utils.config as t_config
from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.server.server import Server as PortServer

JAX = types.SimpleNamespace(
    name="jax", Server=JaxServer, Node=j_top.Node, Client=j_client.Client,
    archive=j_archive, coord=j_coord, restore=j_restore, verify=j_verify,
    replay=j_replay, cli=jax_cli, config=j_config, fp=j_fp)
TORCH = types.SimpleNamespace(
    name="torch", Server=PortServer, Node=t_top.Node, Client=t_client.Client,
    archive=t_archive, coord=t_coord, restore=t_restore, verify=t_verify,
    replay=t_replay, cli=port_cli, config=t_config, fp=t_fp)

INDEX, FRAME = "bk", "f"
N_ROWS = 16


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    for fp in (j_fp, t_fp):
        fp.disarm_all()
    yield
    for fp in (j_fp, t_fp):
        fp.disarm_all()


@pytest.fixture
def servers():
    made: list = []
    yield made
    for s in made:
        try:
            s.close()
        except Exception:  # noqa: BLE001 - closed mid-test already
            pass


def _post(host, path, body=b"{}"):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read() or b"{}")


def _get(host, path):
    with urllib.request.urlopen(f"http://{host}{path}", timeout=30) as r:
        return json.loads(r.read())


def _query(host, q):
    return _post(host, f"/index/{INDEX}/query", q.encode())["results"]


def _server(made, pkg, root, name, archive=None):
    """One node; schema messages go to its cluster's other nodes over
    HTTP (the restore creates the schema through one node)."""
    kw = dict(host="127.0.0.1:0", anti_entropy_interval=0,
              polling_interval=0)
    if archive is not None:
        kw["backup_config"] = pkg.config.BackupConfig(
            archive=f"dir:{archive}", wal_interval=60.0)
    if pkg is TORCH:
        kw.update(device="cpu", warmup=False, cluster_type="http")
    s = pkg.Server(str(root / name), **kw)
    s.open()
    if pkg is JAX:
        s.broadcaster = s.handler.broadcaster = j_broadcast.HTTPBroadcaster(s)
    made.append(s)
    return s


def _cluster(made, pkg, root, prefix, n, archive=None, max_slice=0):
    nodes = [_server(made, pkg, root, f"{prefix}{i}", archive)
             for i in range(n)]
    for s in nodes:
        s.cluster.nodes = [pkg.Node(x.host) for x in nodes]
    _post(nodes[0].host, f"/index/{INDEX}")
    _post(nodes[0].host, f"/index/{INDEX}/frame/{FRAME}")
    for s in nodes:
        if s.holder.index(INDEX) is None:
            _post(s.host, f"/index/{INDEX}")
            _post(s.host, f"/index/{INDEX}/frame/{FRAME}")
    _max_slice(nodes, max_slice)
    return nodes


def _max_slice(nodes, max_slice):
    # Static membership has no slice discovery: tell every node.
    for s in nodes:
        idx = s.holder.index(INDEX)
        if idx is not None:
            idx.set_remote_max_slice(max_slice)


def _wait_backup(host, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        op = _get(host, "/backup")["op"]
        if op and op["phase"] in ("done", "failed"):
            return op
        time.sleep(0.05)
    raise AssertionError("backup did not finish in time")


def _flush(nodes):
    for s in nodes:
        s.wal_archiver.flush()


class Model:
    """row → columns, written through ``set``/``clear`` with the same
    query to the cluster."""

    def __init__(self):
        self.rows: dict = {r: set() for r in range(N_ROWS)}

    def copy(self) -> "Model":
        m = Model()
        m.rows = {r: set(c) for r, c in self.rows.items()}
        return m

    def write(self, host, op, row, col):
        _query(host, f'{op}(frame="{FRAME}", rowID={row},'
                     f' columnID={col})')
        (self.rows[row].add if op == "SetBit" else
         self.rows[row].discard)(col)

    def reads(self) -> list:
        """(pql, the answer this state gives)."""
        counts = {r: len(c) for r, c in self.rows.items()}
        top = sorted(((r, n) for r, n in counts.items() if n),
                     key=lambda p: (-p[1], p[0]))[:5]
        src = self.rows[1]
        ids = [2, 3, 4, 5, 8]
        sourced = sorted(((r, len(self.rows[r] & src)) for r in ids
                          if self.rows[r] & src),
                         key=lambda p: (-p[1], p[0]))
        out = [(f'Count(Bitmap(frame="{FRAME}", rowID={r}))', counts[r])
               for r in range(N_ROWS)]
        out.append((f'TopN(frame="{FRAME}", n=5)',
                    [{"id": r, "count": n} for r, n in top]))
        out.append((f'TopN(Bitmap(frame="{FRAME}", rowID=1),'
                    f' frame="{FRAME}", ids={ids})',
                    [{"id": r, "count": n} for r, n in sourced]))
        out.append((f'Union(Bitmap(frame="{FRAME}", rowID=2),'
                    f' Bitmap(frame="{FRAME}", rowID=3))',
                    {"attrs": {},
                     "bits": sorted(self.rows[2] | self.rows[3])}))
        return out


def _check(host, model, label):
    for q, want in model.reads():
        got = _query(host, q)[0]
        assert got == want, (label, host, q, got, want)


def _seed(pkg, host, model, n_slices=3, seed=7):
    rng = np.random.default_rng(seed)
    n = 1500
    rows = rng.integers(0, N_ROWS, n).astype(np.uint64)
    cols = rng.choice(n_slices * SLICE_WIDTH, size=n,
                      replace=False).astype(np.uint64)
    client = pkg.Client(host)
    client.import_arrays(INDEX, FRAME, rows, cols)
    for r, c in zip(rows.tolist(), cols.tolist()):
        model.rows[int(r)].add(int(c))


@pytest.mark.parametrize("src,dst", [(TORCH, TORCH), (JAX, TORCH),
                                     (TORCH, JAX)],
                         ids=["port-port", "jax-port", "port-jax"])
def test_backup_destroy_restore_other_size_pitr_verified(tmp_path, servers,
                                                         src, dst):
    arch = tmp_path / "archive"
    rng = np.random.default_rng(11)
    model = Model()
    a, b = _cluster(servers, src, tmp_path, "src", 2, archive=arch,
                    max_slice=2)
    _seed(src, a.host, model)

    # A full backup while a writer keeps writing (sets into row 8,
    # clears of row 9's bits), every write acked before the next.
    stop = threading.Event()
    errors: list = []
    row9 = sorted(model.rows[9])

    def writer():
        i = 0
        while not stop.is_set():
            try:
                host = (a, b)[i % 2].host
                if i % 3 == 2 and row9:
                    model.write(host, "ClearBit", 9, row9.pop())
                else:
                    model.write(host, "SetBit", 8,
                                int(rng.integers(3 * SLICE_WIDTH)))
            except Exception as e:  # noqa: BLE001 - recorded
                errors.append(repr(e))
            i += 1
            time.sleep(0.002)

    t = threading.Thread(target=writer)
    t.start()
    try:
        out = _post(a.host, "/backup", b'{"kind": "full"}')
        assert out["op"]["kind"] == "full"
        full = _wait_backup(a.host)
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive() and not errors, errors[:3]
    assert full["phase"] == "done", full
    assert full["fragments"] == 3

    # Known writes before the cut, the cut, and known writes after it.
    for i in range(12):
        model.write((a, b)[i % 2].host, "SetBit", 10 + i % 2,
                    int(rng.integers(3 * SLICE_WIDTH)))
    model.write(a.host, "ClearBit", 1, sorted(model.rows[1])[0])
    _flush((a, b))
    at_cut = model.copy()
    time.sleep(0.05)
    cut = time.time()
    time.sleep(0.05)
    _max_slice((a, b), 3)
    for i in range(8):
        model.write((a, b)[i % 2].host, "SetBit", 12,
                    int(rng.integers(4 * SLICE_WIDTH)))
    model.write(b.host, "ClearBit", 2, sorted(model.rows[2])[-1])
    _flush((a, b))

    # An incremental rides the pool: fewer objects than the full.
    _post(a.host, "/backup", b'{"kind": "incremental"}')
    incr = _wait_backup(a.host)
    assert incr["phase"] == "done", incr
    assert incr["objectsPushed"] < full["objectsPushed"]
    dbg = _get(a.host, "/debug/backup")
    assert [(x["kind"], x["parent"]) for x in dbg["backups"]] == [
        ("full", None), ("incremental", full["id"])]
    # Writes into a slice no backup holds: only the WAL archive has them.
    _max_slice((a, b), 4)
    for i in range(6):
        model.write((a, b)[i % 2].host, "SetBit", 13,
                    4 * SLICE_WIDTH + int(rng.integers(SLICE_WIDTH)))
    _flush((a, b))
    assert sorted(_get(a.host, "/debug/backup")["walSegments"]) == sorted(
        src.archive.sanitize_node(s.host) for s in (a, b))

    # The source's answers, captured as records with their digests.
    _check(a.host, model, "source")
    records = []
    for q, _want in model.reads():
        rec = {"index": INDEX, "pql": q}
        got = src.replay._issue(a.host, rec)
        assert got["status"] == 200 and got["digest"]
        rec.update(status=200, digest=got["digest"])
        records.append(rec)
    records.append({"index": INDEX,
                    "pql": f'SetBit(frame="{FRAME}", rowID=1, columnID=1)'})
    recpath = tmp_path / "records.json"
    recpath.write_text(json.dumps({"records": records}))

    for s in (a, b):
        s.close()
    servers.clear()
    shutil.rmtree(tmp_path / "src0")
    shutil.rmtree(tmp_path / "src1")

    # The latest state into three nodes, verified by the captured reads.
    targets = [_server(servers, dst, tmp_path, f"dst{i}") for i in range(3)]
    for s in targets:
        s.cluster.nodes = [dst.Node(x.host) for x in targets]
    out, err = io.StringIO(), io.StringIO()
    rc = dst.cli.main(["restore", "--host", targets[0].host, "--archive",
                       f"dir:{arch}", "--verify", str(recpath)], out, err)
    assert rc == 0, (out.getvalue(), err.getvalue())
    summary = json.loads(out.getvalue())
    assert summary["id"] == incr["id"]
    assert summary["walOnlyFragments"] == 1
    assert summary["verify"]["compared"] == len(records) - 1
    assert summary["verify"]["mismatches"] == 0
    assert summary["verify"]["skipped"] == 1
    _max_slice(targets, 4)
    for s in targets:
        _check(s.host, model, "latest")

    # The cut into one node: every write acked before it, none after.
    pitr = _server(servers, dst, tmp_path, "pitr")
    store = dst.archive.open_archive(f"dir:{arch}", "")
    summary = dst.restore.run_restore(pitr.host, store, to_timestamp=cut)
    assert summary["id"] == full["id"]
    assert summary["walOnlyFragments"] == 0
    _max_slice([pitr], 4)
    _check(pitr.host, at_cut, "pitr")
    verdict = dst.verify.verify_restore(pitr.host, records)
    assert verdict["mismatches"] >= 1  # the post-cut writes show


def test_coordinator_stopped_mid_push_resumes_the_same_id(tmp_path,
                                                          servers):
    """A backup aborted mid-push leaves its journal in flight; the node
    closed and reopened on its directory resumes the same backup id,
    reusing the journaled fragments, and the pool skips every object the
    first attempt made durable."""
    arch = tmp_path / "archive"
    model = Model()
    (s,) = _cluster(servers, TORCH, tmp_path, "n", 1, archive=arch,
                    max_slice=5)
    _seed(TORCH, s.host, model, n_slices=6)
    s.wal_archiver.flush()
    coord = s.start_backup("full")
    coord.pace_s = 0.3
    deadline = time.monotonic() + 30
    while coord.fragments_done < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    _post(s.host, "/backup", b'{"abort": true}')
    deadline = time.monotonic() + 30
    while coord.phase != t_coord.PHASE_IDLE and not coord.error:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    coord.journal.write(fragments=dict(
        coord.journal.state.get("fragments") or {}))
    journal = t_coord.BackupJournal.for_data_dir(s.holder.path)
    assert journal.load() and journal.in_flight()
    assert t_archive.read_backup(s.backup_store, coord.id) is None
    pushed_before = coord.objects_pushed
    assert 0 < coord.fragments_done < 6
    data_dir = s.holder.path
    s.close()
    servers.clear()

    again = TORCH.Server(data_dir, host="127.0.0.1:0", device="cpu",
                         warmup=False, anti_entropy_interval=0,
                         polling_interval=0,
                         backup_config=t_config.BackupConfig(
                             archive=f"dir:{arch}", wal_interval=60.0))
    again.open()
    servers.append(again)
    again.holder.index(INDEX).set_remote_max_slice(5)
    op = _wait_backup(again.host)
    assert op["id"] == coord.id and op["phase"] == "done", op
    assert op["fragmentsSkipped"] >= 1
    manifest = t_archive.read_backup(again.backup_store, coord.id)
    total = len(t_archive.manifest_object_keys(manifest))
    assert pushed_before + op["objectsPushed"] <= total
    assert op["objectsPushed"] < total
    assert len(manifest["fragments"]) == 6
    for name, verdict in t_archive.verify_backup(again.backup_store,
                                                 manifest):
        assert not verdict["corrupt"], (name, verdict)
    # Both packages read the committed manifest alike.
    assert j_archive.list_backups(again.backup_store) == \
        t_archive.list_backups(again.backup_store)


def test_failed_push_resumes_same_id(tmp_path, servers):
    """``backup.push`` error fires after the store write: the crash
    leaves the first object durable but unjournaled, and ``recover``
    commits the same id without pushing it again."""
    arch = tmp_path / "archive"
    (s,) = _cluster(servers, TORCH, tmp_path, "n", 1, archive=arch,
                    max_slice=1)
    _seed(TORCH, s.host, Model(), n_slices=2)
    s.wal_archiver.flush()
    coord = t_coord.BackupCoordinator(s, s.backup_store, kind="full")
    with t_fp.injected("backup.push", "error*1"):
        with pytest.raises(OSError):
            coord._run()
    journal = t_coord.BackupJournal.for_data_dir(s.holder.path)
    assert journal.load() is not None and journal.in_flight()
    out = t_coord.recover(s)
    assert out["id"] == coord.id and out["phase"] == "done", out
    manifest = t_archive.read_backup(s.backup_store, coord.id)
    assert out["objectsPushed"] < len(
        t_archive.manifest_object_keys(manifest))
    assert t_coord.recover(s) is None  # nothing in flight any more


def _port_archive(tmp_path, servers) -> str:
    """A port node's archive: a full backup, writes, an incremental and
    WAL segments; the node closed."""
    arch = tmp_path / "archive"
    model = Model()
    (s,) = _cluster(servers, TORCH, tmp_path, "n", 1, archive=arch,
                    max_slice=2)
    _seed(TORCH, s.host, model)
    s.start_backup("full")
    assert _wait_backup(s.host)["phase"] == "done"
    for col in range(5):
        model.write(s.host, "SetBit", 14, col * 9973)
    s.wal_archiver.flush()
    s.start_backup("incremental")
    assert _wait_backup(s.host)["phase"] == "done"
    s.close()
    servers.clear()
    return str(arch)


def _both_cli(argv):
    out = []
    for cli in (jax_cli, port_cli):
        so, se = io.StringIO(), io.StringIO()
        rc = cli.main(argv, stdout=so, stderr=se)
        out.append((rc, so.getvalue(), se.getvalue()))
    assert out[0] == out[1], argv
    return out[1]


def _tree(root) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_cli_list_gc_and_check_deep_archive_equal_jax(tmp_path, servers):
    arch = _port_archive(tmp_path, servers)
    spec = f"dir:{arch}"
    rc, out, _ = _both_cli(["backup", "--archive", spec, "--list"])
    assert rc == 0 and out.count("\n") == 2 and "incremental" in out
    rc, out, _ = _both_cli(["check", "--deep", "--archive", spec])
    assert rc == 0 and "0 corrupt" in out
    rc, out, _ = _both_cli(["backup", "--archive", spec, "--gc", "--keep",
                            "1", "--dry-run"])
    assert rc == 0 and json.loads(out)["deleted"] == 0
    # The GC itself, each CLI on its own copy: the same plan, the same
    # archive left.
    copies = []
    for cli in (jax_cli, port_cli):
        copy = tmp_path / f"copy_{cli.__name__.split('.')[0]}"
        shutil.copytree(arch, copy)
        so = io.StringIO()
        assert cli.main(["backup", "--archive", f"dir:{copy}", "--gc",
                         "--keep", "1", "--sweep-orphans"], so,
                        io.StringIO()) == 0
        copies.append((so.getvalue(), _tree(copy)))
    assert copies[0] == copies[1]
    # Rot one pool object: both walks fail alike, naming it.
    key = sorted(k for k in _tree(arch) if k.startswith("data"))[0]
    path = os.path.join(arch, key)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(raw))
    rc, out, _ = _both_cli(["check", "--deep", "--archive", spec])
    assert rc == 1 and "CORRUPT" in out


def _owners(s, slice):
    return [n.host for n in s.cluster.fragment_nodes(INDEX, slice)]


def test_restore_after_a_resize_moved_a_slice(tmp_path, servers):
    """Two port nodes archive their WALs; a full backup, then writes into
    every slice; a resize grows the cluster to three, so some slices
    move to the new node; more writes into every slice. The old owner's
    stream holds the writes before the cutover and the new owner's the
    writes after it. The JAX restore keeps one stream a fragment (the
    one with the most bytes) and loses the other's writes; the port's
    replays every stream's batches in stamp order and holds them all."""
    arch = tmp_path / "archive"
    rng = np.random.default_rng(23)
    model = Model()
    a, b, c = (_server(servers, TORCH, tmp_path, f"n{i}", archive=arch)
               for i in range(3))
    for s in (a, b, c):
        s.cluster.nodes = [TORCH.Node(a.host), TORCH.Node(b.host)]
    for s in (a, b, c):
        if s.holder.index(INDEX) is None:
            _post(s.host, f"/index/{INDEX}")
            _post(s.host, f"/index/{INDEX}/frame/{FRAME}")
    n_slices = 6
    _max_slice((a, b, c), n_slices - 1)
    _seed(TORCH, a.host, model, n_slices=n_slices)
    before = {sl: _owners(a, sl) for sl in range(n_slices)}
    a.start_backup("full")
    assert _wait_backup(a.host)["phase"] == "done"

    def writes(row):
        for sl in range(n_slices):
            for _ in range(3):
                model.write(a.host, "SetBit", row,
                            sl * SLICE_WIDTH + int(rng.integers(SLICE_WIDTH)))
        # One clear a slice of a bit the backup holds.
        for sl in range(n_slices):
            held = sorted(x for x in model.rows[row - 1]
                          if x // SLICE_WIDTH == sl)
            if held:
                model.write(a.host, "ClearBit", row - 1, held[0])

    writes(14)
    _post(a.host, "/cluster/resize",
          json.dumps({"hosts": [a.host, b.host, c.host]}).encode())
    deadline = time.monotonic() + 60
    while True:
        op = _get(a.host, "/cluster/resize")["op"]
        if op and op["phase"] in ("done", "aborted"):
            break
        assert time.monotonic() < deadline
        time.sleep(0.05)
    assert op["phase"] == "done", op
    moved = [sl for sl in range(n_slices) if _owners(a, sl) != before[sl]]
    assert moved, "the grow moved no slice"
    writes(15)
    _flush((a, b, c))
    for s in (a, b, c):
        _check(s.host, model, "source")
    for s in (a, b, c):
        s.close()
    servers.clear()

    answers = {}
    for pkg in (JAX, TORCH):
        t = _server(servers, pkg, tmp_path, f"restored_{pkg.name}")
        store = pkg.archive.open_archive(f"dir:{arch}", "")
        pkg.restore.run_restore(t.host, store)
        _max_slice([t], n_slices - 1)
        answers[pkg.name] = {q: _query(t.host, q)[0]
                             for q, _ in model.reads()}
    want = {q: w for q, w in model.reads()}
    assert answers["torch"] == want
    lost = {q for q in want if answers["jax"][q] != want[q]}
    # ROADMAP fault 3.17: the JAX restore replays only the new owner's
    # stream of a moved slice (the larger: it holds the resize stream's
    # imports), so a ClearBit acked on the old owner before the cutover
    # is lost and the bit comes back from the backup's body.
    row13 = f'Count(Bitmap(frame="{FRAME}", rowID=13))'
    assert row13 in lost, lost
    assert answers["jax"][row13] > want[row13]


def test_client_queries_against_a_jax_node(tmp_path, servers):
    js = JaxServer(str(tmp_path / "jax"), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0)
    js.open()
    servers.append(js)
    _post(js.host, "/index/q")
    _post(js.host, "/index/q/frame/f")
    _post(js.host, "/index/q/query", b'Count(Bitmap(frame="f", rowID=1))')
    got = t_client.Client(js.host).queries()
    want = j_client.Client(js.host).queries()
    assert got == want
    assert {"queries", "slow", "admission"} <= set(got)
    assert got["admission"]["served"]


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "port"])
def test_resumed_backup_keeps_the_first_attempts_wal_watermark(
        tmp_path, servers, pkg):
    """A backup stopped after it journaled slice 0, a write into slice
    0, then the resume under the same id. The resumed manifest's
    ``walStart`` must not pass the segments written since slice 0's
    snapshot: a restore of that backup replays the write. The JAX
    coordinator takes a new watermark at the resume and the write is
    lost (ROADMAP fault 3.18); the port keeps the journaled one."""
    arch = tmp_path / "archive"
    model = Model()
    (s,) = _cluster(servers, pkg, tmp_path, "n", 1, archive=arch,
                    max_slice=3)
    _seed(pkg, s.host, model, n_slices=4)
    s.wal_archiver.flush()
    coord = pkg.coord.BackupCoordinator(s, s.backup_store, kind="full",
                                        pace_s=0.5)
    t = threading.Thread(target=coord.run)
    t.start()
    journal = os.path.join(s.holder.path, pkg.coord.JOURNAL_FILE)
    deadline = time.monotonic() + 30
    while True:
        try:
            with open(journal) as f:
                if json.load(f).get("fragments"):
                    break
        except (OSError, ValueError):
            pass
        assert time.monotonic() < deadline
        time.sleep(0.01)
    coord.cancel()
    t.join(timeout=30)
    assert not t.is_alive()
    model.write(s.host, "SetBit", 15, 12345)  # slice 0, journaled
    s.wal_archiver.flush()
    out = pkg.coord.recover(s)
    assert out["id"] == coord.id and out["phase"] == "done", out
    assert out["fragmentsSkipped"] >= 1
    target = _server(servers, pkg, tmp_path, "restored")
    pkg.restore.run_restore(target.host, s.backup_store,
                            backup_id=coord.id)
    got = _query(target.host, f'Count(Bitmap(frame="{FRAME}", rowID=15))')
    if pkg is JAX:
        assert got == [len(model.rows[15]) - 1]  # the write is lost
    else:
        assert got == [len(model.rows[15])]
        _check(target.host, model, "resumed")


@pytest.mark.parametrize("tier", ["cold", "blob"])
def test_backup_reads_cold_and_blob_fragments_through_the_tier_gate(
        tmp_path, servers, tier):
    """With the tier manager on, every fragment demoted (and pushed to
    the blob store): ``/fragment/data?snapshot=1`` brings each back
    through the tier gate, so the backup commits and a restore answers
    the model."""
    arch = tmp_path / "archive"
    s = TORCH.Server(str(tmp_path / "n0"), host="127.0.0.1:0", device="cpu",
                     warmup=False, anti_entropy_interval=0,
                     polling_interval=0,
                     backup_config=t_config.BackupConfig(
                         archive=f"dir:{arch}", wal_interval=60.0),
                     tier_config=t_config.TierConfig(
                         enabled=True, idle=999.0, blob_idle=999.0,
                         interval=999.0, blob="dir", pace=0.0))
    s.open()
    servers.append(s)
    _post(s.host, f"/index/{INDEX}")
    _post(s.host, f"/index/{INDEX}/frame/{FRAME}")
    model = Model()
    _seed(TORCH, s.host, model, n_slices=3)
    s.tier.sync()
    for sl in range(3):
        frag = s.holder.fragment(INDEX, FRAME, "standard", sl)
        s.tier._demote(frag, "idle")
        if tier == "blob":
            assert s.tier.push_blob(frag)
        assert frag.tier_state == tier
    s.start_backup("full")
    op = _wait_backup(s.host)
    assert op["phase"] == "done" and op["fragments"] == 3, op
    target = _server(servers, TORCH, tmp_path, "restored")
    t_restore.run_restore(target.host, s.backup_store)
    _max_slice([target], 2)
    _check(target.host, model, tier)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "port"])
def test_resumed_backup_keeps_the_first_attempts_max_slices(
        tmp_path, servers, pkg):
    """A two-node cluster whose highest slice node 1 owns; node 0's
    backup stopped after it journaled a fragment, node 0 closed and
    reopened on its directory. Its recovery runs at open, before it has
    learned node 1's max slice: the JAX coordinator backs up the slices
    it knows then and its manifest lacks the highest (ROADMAP fault
    3.19); the port's keeps the first attempt's max slices and holds
    every fragment."""
    Cluster = (j_top if pkg is JAX else t_top).Cluster
    hosts = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    probe = Cluster(nodes=[pkg.Node(h) for h in hosts], replica_n=1)
    owner = [probe.fragment_nodes(INDEX, sl)[0].host for sl in range(40)]
    n_slices = next(n for n in range(2, 40) if owner[n - 1] == hosts[1]
                    and hosts[0] in owner[:n - 1])
    arch = tmp_path / "archive"

    def make(i):
        kw = dict(host=hosts[i], anti_entropy_interval=0,
                  polling_interval=0,
                  cluster=Cluster(nodes=[pkg.Node(h) for h in hosts],
                                  replica_n=1),
                  backup_config=pkg.config.BackupConfig(
                      archive=f"dir:{arch}", wal_interval=60.0))
        if pkg is TORCH:
            kw.update(device="cpu", warmup=False)
        s = pkg.Server(str(tmp_path / f"n{i}"), **kw)
        s.open()
        servers.append(s)
        return s

    s0, s1 = make(0), make(1)
    for s in (s0, s1):
        _post(s.host, f"/index/{INDEX}")
        _post(s.host, f"/index/{INDEX}/frame/{FRAME}")
    _max_slice((s0, s1), n_slices - 1)
    _seed(pkg, s0.host, Model(), n_slices=n_slices)
    s0.wal_archiver.flush()
    coord = s0.start_backup("full")
    coord.pace_s = 0.5
    journal = os.path.join(s0.holder.path, pkg.coord.JOURNAL_FILE)
    deadline = time.monotonic() + 30
    while True:
        try:
            with open(journal) as f:
                if json.load(f).get("fragments"):
                    break
        except (OSError, ValueError):
            pass
        assert time.monotonic() < deadline
        time.sleep(0.01)
    s0.close()
    servers.remove(s0)
    s0 = make(0)
    op = _wait_backup(s0.host)
    assert op["id"] == coord.id and op["phase"] == "done", op
    manifest = pkg.archive.read_backup(s0.backup_store, coord.id)
    slices = sorted(f["slice"] for f in manifest["fragments"])
    if pkg is JAX:
        assert n_slices - 1 not in slices
    else:
        assert slices == list(range(n_slices))


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "port"])
def test_a_rejected_fragment_is_not_rebuilt_from_its_wal(tmp_path, servers,
                                                        pkg):
    """A backup, then writes into slice 0 (archived WAL), then one of
    slice 0's pool objects rotted. The restore fails loudly, naming the
    fragment. The JAX restore still rebuilds slice 0 from its op history
    on an empty base and the node serves that partial state (ROADMAP
    fault 3.21); the port's serves nothing of slice 0."""
    arch = tmp_path / "archive"
    model = Model()
    (s,) = _cluster(servers, TORCH, tmp_path, "n", 1, archive=arch,
                    max_slice=1)
    _seed(TORCH, s.host, model, n_slices=2)
    s.start_backup("full")
    assert _wait_backup(s.host)["phase"] == "done"
    for col in (11, 22, 33):
        model.write(s.host, "SetBit", 15, col)  # slice 0
    s.close()
    servers.clear()
    store = t_archive.open_archive(f"dir:{arch}", "")
    key = sorted(store.list(f"data/{INDEX}/{FRAME}/standard/0/"))[0]
    path = store._path(key)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x40
    with open(path, "wb") as f:
        f.write(bytes(raw))
    target = _server(servers, pkg, tmp_path, "restored")
    with pytest.raises(pkg.restore.RestoreError) as ei:
        pkg.restore.run_restore(target.host,
                                pkg.archive.open_archive(f"dir:{arch}", ""))
    assert f"{INDEX}/{FRAME}/standard/0" in str(ei.value)
    got = _post(target.host, f"/index/{INDEX}/query?slices=0",
                f'Count(Bitmap(frame="{FRAME}", rowID=15))'.encode())
    if pkg is JAX:
        assert got["results"] == [3]  # the three WAL writes alone
    else:
        assert got["results"] == [0]


def test_watchdog_trips_on_a_backup_without_progress(tmp_path, servers):
    """The server feeds the watchdog its backup input: a backup this
    node coordinates that has made no progress for longer than
    ``[watchdog] backup-stall`` trips ``backup_stall``; an idle or
    finished one trips nothing."""
    s = _server(servers, TORCH, tmp_path, "n", archive=tmp_path / "arch")
    assert s._backup_progress() is None
    op = t_coord.BackupCoordinator(s, s.backup_store)
    s.backup_op = op
    op.phase = t_coord.PHASE_SNAPSHOT
    op.last_progress = time.monotonic() - 3600.0
    assert s._backup_progress() > 3599.0
    fired = s.watchdog.check()
    assert [c for c, _ in fired] == ["backup_stall"], fired
    op.phase = t_coord.PHASE_DONE
    assert s._backup_progress() is None
