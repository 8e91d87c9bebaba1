"""The ``import`` and ``export`` verbs of both CLIs, on the CPU.

The JAX CLI (``pilosa_tpu.cli``) drives one ``pilosa_tpu`` node; the
port's CLI (``pilosa_tpu_torch.cli``) drives three port nodes in this
process (``--cluster.type http``, replicas 2), so each slice's block
goes to its two owners and the export reads each slice from one of
them. The same seeded CSV files go to both:

- bits without timestamps (the native parser's lane) and with them
  (the per-row parser, which also fills the time views);
- ``--field`` rows with negative values (the BSI value lane);
- malformed files, each one error on a known row: both CLIs exit 1
  with the same error text.

Then every frame's view is exported through each CLI, and the CSV must
be the same byte for byte. ``sort`` prints the JAX CLI's bytes over
seeded CSVs with and without timestamps; ``bench`` prints the JAX line
format and sets the JAX CLI's bits; ``backup -o`` from the port cluster
and from the JAX node hold equal members (the same slices, positions
and cache ids), and each CLI's ``restore`` of the other's tar gives the
same Counts; the restore route pulls a frame from a JAX host and from a
port host. ``check`` and ``inspect`` match the JAX CLI over a seeded
data-directory tree.
"""

import io
import json
import socket
import urllib.error
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cli import commands as jax_cli
from pilosa_tpu.server.server import Server as JaxServer

from pilosa_tpu_torch import SLICE_WIDTH
from pilosa_tpu_torch.cli import commands as port_cli
from pilosa_tpu_torch.cluster.topology import Cluster, Node
from pilosa_tpu_torch.server.server import Server as PortServer

N_SLICES = 5

SCHEMA = (
    ("/index/i", {}),
    ("/index/i/frame/f", {}),
    ("/index/i/frame/t", {"options": {"timeQuantum": "YMD"}}),
    ("/index/i/frame/v", {"options": {"fields": [
        {"name": "x", "min": -50, "max": 1000}]}}),
    # The malformed files' frames, which the exports do not read.
    ("/index/i/frame/m", {"options": {"timeQuantum": "YMD"}}),
    ("/index/i/frame/n", {"options": {"fields": [
        {"name": "x", "min": -50, "max": 1000}]}}),
)

# (file body, the error the import must end with); each file's good rows
# come first, in the same chunk as the bad one. They go to frames ``m``
# and ``n``.
MALFORMED = (
    ("1,2\n3,4\n5\n", "bad column count on row 3: col=1"),
    ("1,2\n-3,4\n", "invalid row id on row 2: '-3'"),
    ("1,2\n3,abc\n", "invalid column id on row 2: 'abc'"),
    ("1,2\n3,18446744073709551616\n",
     "invalid column id on row 2: '18446744073709551616'"),
    ("1,2,2017-01-05T00:00\n3,4,yesterday\n",
     "invalid timestamp on row 2: 'yesterday'"),
)

FIELD_MALFORMED = (
    ("1,-5\n2,3,4\n", "bad column count on row 2: col=3"),
    ("1,-5\n2,x\n", "invalid value on row 2: 'x'"),
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(host, path, body):
    req = urllib.request.Request(f"http://{host}{path}",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.status == 200


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(the JAX node's host, the port nodes' hosts)."""
    tmp = tmp_path_factory.mktemp("cli_io")
    js = JaxServer(str(tmp / "jax"), host="127.0.0.1:0",
                   anti_entropy_interval=0, polling_interval=0)
    js.open()
    hosts = [f"127.0.0.1:{_free_port()}" for _ in range(3)]
    ps = [PortServer(str(tmp / f"port{i}"), host=h, device="cpu",
                     cluster=Cluster(nodes=[Node(x) for x in hosts],
                                     replica_n=2),
                     cluster_type="http", warmup=False,
                     polling_interval=0, anti_entropy_interval=0)
          for i, h in enumerate(hosts)]
    for s in ps:
        s.open()
    try:
        for path, body in SCHEMA:
            _post(js.host, path, body)
            _post(hosts[0], path, body)
        yield js.host, hosts
    finally:
        for s in ps:
            s.close()
        js.close()


def _run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    rc = cli.main(argv, stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def _csv_files(tmp_path):
    rng = np.random.default_rng(11)
    n = 400
    rows = rng.integers(0, 30, size=n)
    cols = rng.integers(0, N_SLICES * SLICE_WIDTH, size=n)
    bits = "".join(f"{r},{c}\n" for r, c in zip(rows, cols))
    days = rng.integers(1, 28, size=60)
    ts = "".join(f"{r},{c},2017-01-{d:02d}T{int(h):02d}:00\n"
                 for r, c, d, h in zip(rows[:60], cols[:60], days,
                                       rng.integers(0, 24, size=60)))
    fcols = rng.choice(N_SLICES * SLICE_WIDTH, size=120, replace=False)
    fvals = rng.integers(-50, 1001, size=120)
    fields = "".join(f"{c},{v}\n" for c, v in zip(fcols, fvals))
    assert (fvals < 0).any()
    return (_write(tmp_path, "bits.csv", bits),
            _write(tmp_path, "ts.csv", ts),
            _write(tmp_path, "fields.csv", fields))


def test_import_then_export_match_the_jax_cli(servers, tmp_path):
    jax_host, hosts = servers
    bits, ts, fields = _csv_files(tmp_path)
    for cli, host in ((jax_cli, jax_host), (port_cli, hosts[1])):
        for argv in (["import", "--host", host, "-i", "i", "-f", "f", bits],
                     ["import", "--host", host, "-i", "i", "-f", "t", ts],
                     ["import", "--host", host, "-i", "i", "-f", "v",
                      "--field", "x", fields]):
            rc, _, err = _run(cli, argv)
            assert rc == 0, (cli.__name__, argv, err)
    views = (("f", "standard"), ("t", "standard"), ("t", "standard_2017"),
             ("t", "standard_201701"), ("t", "standard_20170105"),
             ("v", "field_x"))
    for frame, view in views:
        want = _run(jax_cli, ["export", "--host", jax_host, "-i", "i",
                              "-f", frame, "--view", view])
        assert want[0] == 0 and want[1], (frame, view, want[2])
        # From every port node as the one the CLI asks.
        for host in hosts:
            got = _run(port_cli, ["export", "--host", host, "-i", "i",
                                  "-f", frame, "--view", view])
            assert got[:2] == want[:2], (frame, view, host)


@pytest.mark.parametrize("body,error", MALFORMED)
def test_malformed_bits_fail_alike(servers, tmp_path, body, error):
    jax_host, hosts = servers
    path = _write(tmp_path, "bad.csv", body)
    for cli, host in ((jax_cli, jax_host), (port_cli, hosts[0])):
        rc, out, err = _run(cli, ["import", "--host", host, "-i", "i",
                                  "-f", "m", path])
        assert rc == 1 and out == ""
        assert err.splitlines()[-1] == f"error: {error}", cli.__name__


@pytest.mark.parametrize("body,error", FIELD_MALFORMED)
def test_malformed_field_values_fail_alike(servers, tmp_path, body, error):
    jax_host, hosts = servers
    path = _write(tmp_path, "bad.csv", body)
    for cli, host in ((jax_cli, jax_host), (port_cli, hosts[2])):
        rc, out, err = _run(cli, ["import", "--host", host, "-i", "i",
                                  "-f", "n", "--field", "x", path])
        assert rc == 1 and out == ""
        assert err.splitlines()[-1] == f"error: {error}", cli.__name__


# -- check and inspect (the offline face of the scrub) ------------------------

def _footered(roar, n, seed, footer=True, runs=False):
    import io as io_mod
    rng = np.random.default_rng(seed)
    b = roar.Bitmap()
    b.add_many(rng.choice(4 * SLICE_WIDTH, size=n, replace=False)
               .astype(np.uint64))
    if runs:
        b.add_many(np.arange(70000, 140000, dtype=np.uint64))
        b.optimize()
    if not footer:
        return b.marshal()
    buf = io_mod.BytesIO()
    b.write_to(buf, footer=True)
    return buf.getvalue()


@pytest.fixture
def check_tree(tmp_path):
    """A data-dir shaped tree: clean, rotten, vintage, run-container and
    op-log files, a torn WAL tail, a ``.corrupt`` aside file, a
    ``.cache`` sidecar (good and garbage) and a ``.snapshotting``
    leftover."""
    from pilosa_tpu_torch.storage import roaring as troar
    d = tmp_path / "data" / "i" / "f" / "views" / "standard" / "fragments"
    d.mkdir(parents=True)
    (d / "0").write_bytes(_footered(troar, 300, 1))
    bad = bytearray(_footered(troar, 300, 2))
    bad[len(bad) // 2] ^= 0x01
    (d / "1").write_bytes(bytes(bad))
    (d / "2").write_bytes(_footered(troar, 300, 3, footer=False))
    ops = _footered(troar, 100, 4) + b"".join(
        troar.Op(troar.OP_ADD, 5 + i).marshal() for i in range(4))
    (d / "3").write_bytes(ops + b"\x00\x01")
    (d / "4").write_bytes(_footered(troar, 50, 5, runs=True))
    (d / "1.corrupt").write_bytes(bytes(bad))
    from pilosa_tpu_torch.proto import internal as pb
    (d / "0.cache").write_bytes(pb.Cache(IDs=[1, 5, 9])
                                .SerializeToString())
    (d / "2.cache").write_bytes(b"\xff\xff\xff")
    (d / "3.snapshotting").write_bytes(b"partial")
    return tmp_path / "data", d


def _both_cli(argv):
    out = []
    for mod in (jax_cli, port_cli):
        so, se = io.StringIO(), io.StringIO()
        try:
            rc = mod.main(argv, stdout=so, stderr=se)
        except Exception as e:  # noqa: BLE001 - compared across CLIs
            rc = (type(e).__name__, str(e))
        out.append((rc, so.getvalue(), se.getvalue()))
    assert out[0] == out[1], argv
    return out[1]


@pytest.mark.parametrize("which", ["dir", "clean", "rotten", "vintage",
                                   "torn", "runs"])
def test_check_deep_matches_jax(check_tree, which):
    data, d = check_tree
    path = {"dir": data, "clean": d / "0", "rotten": d / "1",
            "vintage": d / "2", "torn": d / "3", "runs": d / "4"}[which]
    rc, out, _err = _both_cli(["check", "--deep", str(path)])
    assert rc == (1 if which in ("dir", "rotten") else 0)
    assert out.endswith("without footers\n")


@pytest.mark.parametrize("which", ["0", "1", "2", "4", "0.cache",
                                   "2.cache", "3.snapshotting"])
def test_check_matches_jax(check_tree, which):
    _data, d = check_tree
    _both_cli(["check", str(d / which)])


def test_check_without_paths_matches_jax():
    rc, _out, err = _both_cli(["check"])
    assert rc == 1 and err


@pytest.mark.parametrize("which", ["0", "1", "2", "3", "4"])
def test_inspect_matches_jax(check_tree, which):
    _data, d = check_tree
    _both_cli(["inspect", str(d / which)])


def test_check_deep_unported_faces_exit_2(check_tree, tmp_path):
    """``--archive`` (the backup slice) still exits 2. A blob-tier stub
    takes the blob lane since the tier slice, as in the JAX CLI: one
    without a prefix is an unreadable stub (rc 1, the same lines)."""
    data, d = check_tree
    so, se = io.StringIO(), io.StringIO()
    assert port_cli.main(["check", "--deep", "--archive", "dir:/x",
                          str(data)], stdout=so, stderr=se) == 2
    assert "backup slice" in se.getvalue() and not so.getvalue()
    (d / "7.blob").write_text("{}")
    rc, out, _err = _both_cli(["check", "--deep", str(data)])
    assert rc == 1 and "7.blob: CORRUPT: unreadable blob stub" in out


# -- sort, bench, and the frame-view tar of backup and restore ---------------

def _sort_csv(tmp_path, timestamps: bool, seed: int) -> str:
    rng = np.random.default_rng(seed)
    n = 300
    rows = rng.integers(0, 40, size=n)
    cols = rng.integers(0, N_SLICES * SLICE_WIDTH, size=n)
    lines = []
    for k, (r, c) in enumerate(zip(rows, cols)):
        if timestamps and k % 3:
            lines.append(f"{r},{c},2017-0{1 + k % 9}-1{k % 10}T0{k % 10}:00")
        else:
            lines.append(f"{r},{c}")
    return _write(tmp_path, f"sort{seed}.csv", "\n".join(lines) + "\n")


@pytest.mark.parametrize("timestamps", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_sort_matches_jax(tmp_path, timestamps, seed):
    rc, out, _ = _both_cli(["sort", _sort_csv(tmp_path, timestamps, seed)])
    assert rc == 0 and len(out.splitlines()) == 300


def _counts(host, frame, rows=range(40)):
    body = " ".join(f"Count(Bitmap(rowID={r}, frame={frame}))"
                    for r in rows)
    req = urllib.request.Request(f"http://{host}/index/i/query",
                                 data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["results"]


def test_bench_sets_the_jax_bits(servers):
    import re
    jax_host, hosts = servers
    for host in (jax_host, hosts[0]):
        _post(host, "/index/i/frame/bench", {})
    want = _run(jax_cli, ["bench", "--host", jax_host, "-i", "i",
                          "-f", "bench", "--op", "set-bit", "-n", "60"])
    got = _run(port_cli, ["bench", "--host", hosts[2], "-i", "i",
                          "-f", "bench", "--op", "set-bit", "-n", "60"])
    line = re.compile(r"^Executed 60 operations in \d+\.\d{3}s"
                      r" \(\d+\.\d{3} op/sec\)\n$")
    for rc, out, err in (want, got):
        assert rc == 0 and line.match(out) and not err
    assert _counts(hosts[0], "bench", range(1000)) == _counts(
        jax_host, "bench", range(1000))
    assert _run(port_cli, ["bench", "--host", hosts[0], "-i", "i", "-f",
                           "bench", "--op", "clear"]) == _run(
        jax_cli, ["bench", "--host", jax_host, "-i", "i", "-f", "bench",
                  "--op", "clear"])


def _tar_members(path) -> dict:
    """{slice: (positions, cache ids)} of a ``backup -o`` tar."""
    import tarfile
    from pilosa_tpu_torch.proto import internal as tpb
    from pilosa_tpu_torch.storage import roaring as troar
    out = {}
    with tarfile.open(path) as outer:
        for info in outer.getmembers():
            inner = tarfile.open(fileobj=outer.extractfile(info))
            data = inner.extractfile("data").read()
            cache = inner.extractfile("cache").read()
            bm = troar.Bitmap.unmarshal(data)
            out[info.name] = (bm.all_positions().tolist(),
                              list(tpb.Cache.FromString(cache).IDs))
    return out


def test_backup_and_restore_tar_match_the_jax_cli(servers, tmp_path):
    jax_host, hosts = servers
    rng = np.random.default_rng(21)
    rows = rng.integers(0, 40, size=3000)
    cols = rng.integers(0, N_SLICES * SLICE_WIDTH, size=3000)
    bits = _write(tmp_path, "bk.csv",
                  "".join(f"{r},{c}\n" for r, c in zip(rows, cols)))
    for frame in ("bk", "rs"):
        _post(jax_host, f"/index/i/frame/{frame}", {})
        _post(hosts[0], f"/index/i/frame/{frame}", {})
    for cli, host in ((jax_cli, jax_host), (port_cli, hosts[1])):
        assert _run(cli, ["import", "--host", host, "-i", "i", "-f", "bk",
                          bits])[0] == 0
    tars = {}
    for name, cli, host in (("jax", jax_cli, jax_host),
                            ("port", port_cli, hosts[2])):
        tars[name] = str(tmp_path / f"{name}.tar")
        assert _run(cli, ["backup", "--host", host, "-i", "i", "-f", "bk",
                          "-o", tars[name]]) == (0, "", "")
    members = _tar_members(tars["port"])
    assert members == _tar_members(tars["jax"])
    assert sorted(members) == [str(s) for s in range(N_SLICES)]
    # Each CLI restores the other's tar into an empty frame.
    assert _run(port_cli, ["restore", "--host", hosts[0], "-i", "i", "-f",
                           "rs", tars["jax"]]) == (0, "", "")
    assert _run(jax_cli, ["restore", "--host", jax_host, "-i", "i", "-f",
                          "rs", tars["port"]]) == (0, "", "")
    want = _counts(jax_host, "bk")
    assert sum(want) > 0
    assert _counts(jax_host, "rs") == want
    for host in hosts:
        assert _counts(host, "rs") == want
        assert _counts(host, "bk") == want


def test_backup_restore_usage_and_archive_faces(servers, tmp_path):
    jax_host, hosts = servers
    for verb in ("backup", "restore"):
        got = _run(port_cli, [verb, "--host", hosts[0]])
        assert got == _run(jax_cli, [verb, "--host", jax_host])
        assert got[0] == 1
    for argv in (["backup", "--mode", "full"], ["backup", "--list"],
                 ["backup", "--gc"], ["restore", "--archive", "dir:/x"]):
        rc, out, err = _run(port_cli, argv + ["--host", hosts[0]])
        assert rc == 2 and not out
        assert "(item 7, the backup slice)" in err


def test_restore_route_pulls_from_jax_and_port_hosts(servers, tmp_path):
    """``POST /index/i/frame/{f}/restore?host=`` on every port node pulls
    the slices it owns from a JAX node, and from a port node outside the
    cluster; the cluster then answers the source's Counts."""
    from pilosa_tpu_torch.cluster.client import Client
    jax_host, hosts = servers
    solo = PortServer(str(tmp_path / "solo"), host="127.0.0.1:0",
                      device="cpu", warmup=False)
    solo.open()
    try:
        _post(solo.host, "/index/i", {})
        rng = np.random.default_rng(33)
        for frame, src in (("rj", jax_host), ("rp", solo.host)):
            _post(src, f"/index/i/frame/{frame}", {})
            _post(hosts[0], f"/index/i/frame/{frame}", {})
            c = Client(src)
            c.import_arrays("i", frame,
                            rng.integers(0, 40, size=2000).astype(np.uint64),
                            rng.integers(0, N_SLICES * SLICE_WIDTH,
                                         size=2000).astype(np.uint64))
            c.close()
            for host in hosts:
                c = Client(host)
                c.restore_frame(src, "i", frame)
                c.close()
            want = _counts(src, frame)
            assert sum(want) > 0
            for host in hosts:
                assert _counts(host, frame) == want, (frame, host)
        status, _ = _req_status(hosts[0], "/index/i/frame/rj/restore")
        assert status == 400
    finally:
        solo.close()


def _req_status(host, path):
    req = urllib.request.Request(f"http://{host}{path}", data=b"",
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
