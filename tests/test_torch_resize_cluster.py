"""Elastic resize of a real gossip cluster of port nodes on the CPU.

The counterpart of ``tests/test_resize_cluster.py``: three
``pilosa_tpu_torch`` server processes (``--device cpu``), the third
booted with the CURRENT membership and gossip-joined, grow 2→3 under
concurrent write and differential-checked read load. The reference is a
single-node JAX server process fed the same data and writes: every
answer during the migration, and every node's answer afterwards, must
equal it. The three SIGKILL legs (target, source, coordinator killed
mid-stream) are copied and stay ``slow``, as in the JAX file.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

from podenv import cpu_env, free_port, wait_up  # noqa: E402

from pilosa_tpu_torch import SLICE_WIDTH  # noqa: E402

pytestmark = pytest.mark.resize


def _post(host: str, path: str, body: bytes = b"{}") -> bytes:
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST")
    return urllib.request.urlopen(req, timeout=30).read()


def _query(host: str, index: str, body: str):
    return json.loads(_post(host, f"/index/{index}/query",
                            body.encode()))["results"]


def _get(host: str, path: str):
    return json.loads(urllib.request.urlopen(
        f"http://{host}{path}", timeout=10).read())


def _wait_resize(host: str, timeout: float = 120.0) -> dict:
    deadline = time.time() + timeout
    while time.time() < deadline:
        op = _get(host, "/cluster/resize").get("op")
        if op and op["phase"] in ("done", "aborted"):
            return op
        time.sleep(0.2)
    raise AssertionError("resize did not settle in time")


def _metric(host: str, name: str) -> float:
    with urllib.request.urlopen(f"http://{host}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    return sum(float(line.rsplit(" ", 1)[1])
               for line in text.splitlines()
               if line.startswith(name) and line[len(name):][:1] in "{ ")


class _Fleet:
    """Spawn, kill and restart port node processes (and the JAX
    reference)."""

    def __init__(self, tmp_path):
        self.tmp_path = tmp_path
        self.procs: dict[str, subprocess.Popen] = {}
        self.logs: list = []
        self.ports: dict[str, tuple[int, int]] = {}

    def spawn(self, name, cluster_hosts, seed="", cluster=True,
              package="pilosa_tpu_torch"):
        if name not in self.ports:
            self.ports[name] = (free_port(), free_port())
        port, gport = self.ports[name]
        d = self.tmp_path / name
        d.mkdir(exist_ok=True)
        env = cpu_env()
        env["PILOSA_TPU_MESH"] = "0"
        # Each CPU node's plain versions would otherwise run torch's
        # intra-op threads on every core.
        env["OMP_NUM_THREADS"] = "2"
        log = open(self.tmp_path / f"{name}.log", "a")
        self.logs.append(log)
        argv = [sys.executable, "-m", f"{package}.cli", "server",
                "-d", str(d), "-b", f"127.0.0.1:{port}",
                "--anti-entropy.interval", "300s"]
        if package == "pilosa_tpu_torch":
            argv += ["--device", "cpu"]
        if cluster:
            argv += ["--cluster.type", "gossip",
                     "--cluster.hosts", cluster_hosts,
                     "--cluster.replicas", "1",
                     "--cluster.internal-port", str(gport)]
            if seed:
                argv += ["--cluster.gossip-seed", seed]
        p = subprocess.Popen(argv, env=env, stdout=log, stderr=log,
                             cwd=os.path.dirname(_HERE))
        self.procs[name] = p
        wait_up(f"127.0.0.1:{port}")
        return f"127.0.0.1:{port}"

    def host(self, name):
        return f"127.0.0.1:{self.ports[name][0]}"

    def gossip_addr(self, name):
        return f"127.0.0.1:{self.ports[name][1]}"

    def kill(self, name):
        p = self.procs[name]
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=10)

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for p in self.procs.values():
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
        for log in self.logs:
            log.close()


@pytest.fixture
def fleet(tmp_path):
    f = _Fleet(tmp_path)
    yield f
    f.close()


def _kill_mid_stream(fleet, coord_host, victim, timeout=60.0):
    """SIGKILL ``victim`` once the coordinator has streamed bytes and
    is still streaming."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        op = _get(coord_host, "/cluster/resize").get("op") or {}
        if op.get("phase") == "streaming" and op.get("bytesStreamed",
                                                    0) > 0:
            fleet.kill(victim)
            return op
        if op.get("phase") in ("done", "aborted"):
            raise AssertionError(
                f"resize settled ({op.get('phase')}) before the kill"
                f" window — widen the stream pacing")
        time.sleep(0.05)
    raise AssertionError("stream never started")


def _row_counts(host, index, rows):
    return {r: _query(host, index,
                      f'Count(Bitmap(frame="f", rowID={r}))')[0]
            for r in rows}


def _boot_trio(fleet):
    pa, ga = free_port(), free_port()
    pb, gb = free_port(), free_port()
    pc, gc = free_port(), free_port()
    fleet.ports = {"a": (pa, ga), "b": (pb, gb), "c": (pc, gc)}
    hosts2 = f"127.0.0.1:{pa},127.0.0.1:{pb}"
    host_a = fleet.spawn("a", hosts2)
    host_b = fleet.spawn("b", hosts2, seed=f"127.0.0.1:{ga}")
    # The joiner boots with the CURRENT membership (it owns nothing
    # yet) and gossip-joins (docs/CLUSTER_RESIZE.md).
    host_c = fleet.spawn("c", hosts2, seed=f"127.0.0.1:{ga}")
    return host_a, host_b, host_c


def _import_data(host_a, host_solo, n_slices=4, n_bits=900, seed=23,
                 n_rows=8):
    from pilosa_tpu_torch.cluster.client import Client
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, n_bits).astype(np.uint64)
    cols = rng.choice(n_slices * SLICE_WIDTH, size=n_bits,
                      replace=False).astype(np.uint64)
    Client(host_a).import_arrays("rz", "f", rows, cols)
    if host_solo:
        Client(host_solo).import_arrays("rz", "f", rows, cols)
    model: dict = {}
    for r, c in zip(rows.tolist(), cols.tolist()):
        model.setdefault(int(r), set()).add(int(c))
    return model


def _wait_converged(hosts, model, timeout=30.0):
    row = max(model, key=lambda r: len(model[r]))
    want = len(model[row])
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if all(_query(h, "rz",
                          f'Count(Bitmap(frame="f", rowID={row}))')[0]
                   == want for h in hosts):
                return
        except Exception:  # noqa: BLE001 - still converging
            pass
        time.sleep(0.3)
    raise AssertionError("cluster did not converge on seeded data")


def test_real_2_to_3_resize_under_load(fleet):
    """A live gossip cluster of port nodes grows 2→3 under concurrent
    write and read load; every answer during the migration equals the
    JAX single-node reference's, and afterwards all three nodes agree
    with it exactly."""
    host_a, host_b, host_c = _boot_trio(fleet)
    host_s = fleet.spawn("solo", "", cluster=False, package="pilosa_tpu")
    for h in (host_a, host_s):
        _post(h, "/index/rz", b"{}")
        _post(h, "/index/rz/frame/f", b"{}")
    model = _import_data(host_a, host_s)
    _wait_converged([host_a, host_b], model)

    stop = threading.Event()
    errors: list = []
    writes_done: list = []

    def loadgen():
        i = 0
        while not stop.is_set():
            col = int(4 * SLICE_WIDTH - 1 - i)
            i += 1
            try:
                _query((host_a, host_b)[i % 2], "rz",
                       f'SetBit(frame="f", rowID=50, columnID={col})')
                _query(host_s, "rz",
                       f'SetBit(frame="f", rowID=50, columnID={col})')
                writes_done.append(col)
                for h in (host_a, host_b):
                    got = _query(
                        h, "rz",
                        'Count(Bitmap(frame="f", rowID=4))')[0]
                    if got != len(model[4]):
                        errors.append(("stable-row", h, got,
                                       len(model[4])))
            except Exception as e:  # noqa: BLE001 - recorded
                errors.append(("load", repr(e)))
            time.sleep(0.01)

    t = threading.Thread(target=loadgen)
    t.start()
    try:
        _post(host_a, "/cluster/resize", json.dumps(
            {"hosts": [host_a, host_b, host_c]}).encode())
        op = _wait_resize(host_a)
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert op["phase"] == "done", op
    assert not errors, errors[:5]
    assert writes_done, "load generator made no progress"
    for h in (host_a, host_b, host_c):
        topo = _get(h, "/debug/topology")
        assert topo["epoch"] == 1, (h, topo["epoch"])
        assert sorted(topo["nodes"]) == sorted([host_a, host_b, host_c])
        assert topo["resize"] is None
    want = _row_counts(host_s, "rz", list(range(8)) + [50])
    for h in (host_a, host_b, host_c):
        assert _row_counts(h, "rz", list(range(8)) + [50]) == want, h
    topn = [_query(h, "rz", 'TopN(frame="f", n=5)')[0]
            for h in (host_s, host_a, host_b, host_c)]
    assert all(x == topn[0] for x in topn), topn
    assert op["slicesMoved"] >= 1 and op["bytesStreamed"] > 0
    assert _metric(host_a, "pilosa_resize_slices_moved_total") >= 1
    assert _metric(host_a, "pilosa_resize_stream_bytes_total") > 0
    owners = _get(host_c, "/debug/topology")["indexes"]["rz"]["owners"]
    assert any(host_c in v for v in owners.values()), owners


def _chaos_setup(fleet):
    host_a, host_b, host_c = _boot_trio(fleet)
    _post(host_a, "/index/rz", b"{}")
    _post(host_a, "/index/rz/frame/f", b"{}")
    # Rows spread over many 100-row checksum blocks so the paced
    # stream stays in flight long enough to kill mid-stream.
    model = _import_data(host_a, None, n_bits=2400, n_rows=700)
    _wait_converged([host_a, host_b], model)
    _post(host_a, "/debug/failpoints", json.dumps(
        {"site": "resize.stream", "spec": "delay(300ms)"}).encode())
    _post(host_a, "/cluster/resize", json.dumps(
        {"hosts": [host_a, host_b, host_c]}).encode())
    return host_a, host_b, host_c, model


@pytest.mark.slow
@pytest.mark.chaos
def test_sigkill_target_mid_stream_aborts_cleanly(fleet):
    host_a, host_b, _host_c, model = _chaos_setup(fleet)
    _kill_mid_stream(fleet, host_a, "c")
    op = _wait_resize(host_a, timeout=180.0)
    _post(host_a, "/debug/failpoints", json.dumps(
        {"site": "resize.stream", "spec": "off"}).encode())
    assert op["phase"] == "aborted", op
    for h in (host_a, host_b):
        topo = _get(h, "/debug/topology")
        assert topo["epoch"] == 0 and topo["resize"] is None, (h, topo)
    want = {r: len(model.get(r, set())) for r in range(8)}
    deadline = time.time() + 20
    while time.time() < deadline:
        try:
            if (_row_counts(host_a, "rz", range(8)) == want
                    and _row_counts(host_b, "rz", range(8)) == want):
                break
        except Exception:  # noqa: BLE001 - breakers settling
            pass
        time.sleep(0.5)
    assert _row_counts(host_a, "rz", range(8)) == want
    assert _row_counts(host_b, "rz", range(8)) == want


@pytest.mark.slow
@pytest.mark.chaos
def test_sigkill_source_mid_stream_aborts_cleanly(fleet):
    host_a, host_b, host_c, model = _chaos_setup(fleet)
    _kill_mid_stream(fleet, host_a, "b")
    op = _wait_resize(host_a, timeout=180.0)
    _post(host_a, "/debug/failpoints", json.dumps(
        {"site": "resize.stream", "spec": "off"}).encode())
    assert op["phase"] == "aborted", op
    assert _get(host_a, "/debug/topology")["epoch"] == 0
    fleet.spawn("b", f"{host_a},{fleet.host('b')}",
                seed=fleet.gossip_addr("a"))
    _wait_converged([host_a, fleet.host("b")], model)
    _post(host_a, "/cluster/resize", json.dumps(
        {"hosts": [host_a, host_b, host_c]}).encode())
    op = _wait_resize(host_a, timeout=180.0)
    assert op["phase"] == "done", op
    want = {r: len(model.get(r, set())) for r in range(8)}
    for h in (host_a, host_b, host_c):
        assert _row_counts(h, "rz", range(8)) == want, h


@pytest.mark.slow
@pytest.mark.chaos
def test_sigkill_coordinator_journal_recovery(fleet):
    host_a, host_b, host_c, model = _chaos_setup(fleet)
    _kill_mid_stream(fleet, host_a, "a")
    assert _get(host_b, "/debug/topology")["resize"] is not None
    fleet.spawn("a", f"{fleet.host('a')},{host_b}",
                seed=fleet.gossip_addr("b"))
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            ta = _get(host_a, "/debug/topology")
            tb = _get(host_b, "/debug/topology")
            tc = _get(host_c, "/debug/topology")
            if (ta["resize"] is None and tb["resize"] is None
                    and tc["resize"] is None and ta["epoch"] == 0):
                break
        except Exception:  # noqa: BLE001 - restarting
            pass
        time.sleep(0.5)
    assert _get(host_b, "/debug/topology")["resize"] is None
    _wait_converged([host_a, host_b], model)
    want = {r: len(model.get(r, set())) for r in range(8)}
    assert _row_counts(host_a, "rz", range(8)) == want
    assert _row_counts(host_b, "rz", range(8)) == want
    _post(host_a, "/cluster/resize", json.dumps(
        {"hosts": [host_a, host_b, host_c]}).encode())
    op = _wait_resize(host_a, timeout=180.0)
    assert op["phase"] == "done", op
    for h in (host_a, host_b, host_c):
        assert _row_counts(h, "rz", range(8)) == want, h
