"""Storage integrity on three port node processes (the two legs of
``tests/test_scrub_cluster.py``), on the CPU.

A static cluster of three ``pilosa_tpu_torch`` server processes
(``--device cpu``, replicas 2, ``--cluster.type http``), seeded at the
JAX test's sizes (6 slices, 8 rows), every answer held to the host
model of the bits written:

- restart bit rot: one node is SIGKILLed, 5 seeded bytes are flipped in
  every fragment data file it owns, and it restarts. The open
  quarantines, a background thread's Counts to all three nodes stay
  exact with no failed request, the repairer drains the quarantine from
  the replicas, and a further restart finds nothing quarantined;
- live scrub: a clean synchronous scrub finds nothing; the seeded
  ``storage.read`` ``corrupt(8)*1`` failpoint, armed over
  ``/debug/failpoints``, rots a file under the next scrub, which
  reports it; answers stay exact, the quarantine drains, and a further
  pass is clean. The same for bytes flipped by hand under the running
  node.
"""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from pilosa_tpu_torch import SLICE_WIDTH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SLICES = 6
N_ROWS = 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(host, path, body=b"", timeout=30):
    req = urllib.request.Request(f"http://{host}{path}", data=body,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _get_json(host, path, timeout=10):
    with urllib.request.urlopen(f"http://{host}{path}",
                                timeout=timeout) as r:
        return json.loads(r.read())


def _count(host, row, timeout=30):
    got = json.loads(_post(host, "/index/sc/query",
                           f'Count(Bitmap(frame="f", rowID={row}))'
                           .encode(), timeout=timeout))
    assert "error" not in got, got
    return got["results"][0]


def _metric(host, name):
    total, found = 0.0, False
    with urllib.request.urlopen(f"http://{host}/metrics",
                                timeout=10) as r:
        for line in r.read().decode().splitlines():
            if line.startswith(name) and not line.startswith("#"):
                total += float(line.rsplit(" ", 1)[1])
                found = True
    return total if found else None


def _wait(pred, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            if pred():
                return
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}")


class _Cluster:
    def __init__(self, tmp_path):
        self.tmp_path = tmp_path
        self.hosts = {n: f"127.0.0.1:{_free_port()}" for n in "abc"}
        self.procs: dict = {}
        self.logs = []

    def spawn(self, name):
        d = self.tmp_path / name
        d.mkdir(exist_ok=True)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=REPO, PILOSA_FAULT_SEED="12345",
                   # Fast repair cadence; passive scrub passes stay off
                   # (the test triggers them).
                   PILOSA_SCRUB_INTERVAL="600s", PILOSA_SCRUB_PACE="0s",
                   PILOSA_SCRUB_REPAIR_RESCAN="0.5s")
        log = open(self.tmp_path / f"{name}.log", "ab")
        self.logs.append(log)
        self.procs[name] = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch.cli", "server",
             "--device", "cpu", "-d", str(d), "-b", self.hosts[name],
             "--cluster.hosts", ",".join(self.hosts[n] for n in "abc"),
             "--cluster.replicas", "2", "--cluster.type", "http",
             "--cluster.poll-interval", "1s",
             "--anti-entropy.interval", "300s"],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=log)
        _wait(lambda: _get_json(self.hosts[name], "/version"), 60,
              f"node {name}")
        return self.hosts[name]

    def wait_breakers_closed(self):
        """A peer's max-slice poll against a node still starting opens
        its circuit breaker: wait until the probes have closed every
        breaker between running nodes, so no request fails fast on a
        node that is up."""
        up = {self.hosts[n] for n in self.procs}

        def closed():
            for host in up:
                brk = _get_json(host, "/status").get("fault", {}).get(
                    "breakers", {})
                if any(b["state"] != "closed" for peer, b in brk.items()
                       if peer in up):
                    return False
            return True
        _wait(closed, 60, "the breakers to close")

    def kill(self, name):
        p = self.procs.pop(name)
        p.send_signal(signal.SIGKILL)
        p.wait()

    def fragment_files(self, name):
        out = []
        for root, _dirs, files in os.walk(self.tmp_path / name):
            if os.path.basename(root) == "fragments":
                out += [os.path.join(root, f) for f in files
                        if f.isdigit()]
        return sorted(out)

    def close(self):
        for p in self.procs.values():
            p.send_signal(signal.SIGTERM)
        for p in self.procs.values():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    c = _Cluster(tmp_path_factory.mktemp("integrity"))
    try:
        for n in "abc":
            c.spawn(n)
        c.wait_breakers_closed()
        host_a = c.hosts["a"]
        _post(host_a, "/index/sc", b"{}")
        _post(host_a, "/index/sc/frame/f", b"{}")
        _wait(lambda: all(_get_json(h, "/index/sc")
                          for h in c.hosts.values()), 30, "the schema")
        rng = random.Random(7)
        model = {r: set() for r in range(N_ROWS)}
        lines = []
        for _ in range(4000):
            r = rng.randrange(N_ROWS)
            col = rng.randrange(N_SLICES * SLICE_WIDTH)
            model[r].add(col)
            lines.append(f'SetBit(frame="f", rowID={r}, columnID={col})')
            if len(lines) >= 500:
                _post(host_a, "/index/sc/query", "\n".join(lines).encode())
                lines = []
        _wait_slices(c.hosts.values())
        yield c, model
    finally:
        c.close()


def _wait_slices(hosts):
    _wait(lambda: all(_get_json(h, "/slices/max")["maxSlices"].get("sc")
                      == N_SLICES - 1 for h in hosts), 30,
          "every node's max slice")


def _differential(hosts, model):
    for h in hosts:
        for row in sorted(model):
            got = _count(h, row)
            assert got == len(model[row]), (h, row, got, len(model[row]))


def _flip_bytes(path, n, rng):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        for _ in range(n):
            off = rng.randrange(size)
            f.seek(off)
            b = f.read(1)[0]
            f.seek(off)
            f.write(bytes([b ^ (1 << rng.randrange(8))]))


def _drain(host, timeout=60.0):
    _wait(lambda: not _get_json(host, "/debug/integrity")["quarantined"],
          timeout, f"the quarantine on {host} to drain")


def _under_load(hosts, model, body):
    """Run ``body()`` while a thread sends Counts to every node; every
    answer must be exact and no request may fail."""
    stop = threading.Event()
    violations: list = []
    answered = [0]

    def loadgen():
        rng = random.Random(3)
        while not stop.is_set():
            h = hosts[rng.randrange(len(hosts))]
            row = rng.randrange(N_ROWS)
            try:
                got = _count(h, row)
            except Exception as e:  # noqa: BLE001 - surfaced below
                violations.append((h, row, repr(e)))
                continue
            answered[0] += 1
            if got != len(model[row]):
                violations.append((h, row, got, len(model[row])))

    t = threading.Thread(target=loadgen)
    t.start()
    try:
        body()
    finally:
        stop.set()
        t.join()
    assert not violations, violations[:5]
    assert answered[0] > 0


def test_bit_rot_across_a_restart_quarantines_and_repairs(seeded):
    c, model = seeded
    hosts = list(c.hosts.values())
    _differential(hosts, model)
    c.kill("b")
    rng = random.Random(99)
    files = c.fragment_files("b")
    assert files, "node b owns fragments"
    for f in files:
        _flip_bytes(f, 5, rng)
    host_b = c.spawn("b")
    integ = _get_json(host_b, "/debug/integrity")
    assert integ["quarantined"], integ
    n_quarantined = len(integ["quarantined"])
    assert _metric(host_b, "pilosa_storage_corruption_detected_total") >= 1
    _wait_slices([host_b])

    def settle():
        _differential(hosts, model)
        _drain(host_b)

    _under_load(hosts, model, settle)
    assert _metric(host_b, "pilosa_storage_repairs_total") >= n_quarantined
    _differential(hosts, model)
    # The repaired copy survives another restart with no sentinel left.
    c.kill("b")
    host_b = c.spawn("b")
    assert not _get_json(host_b, "/debug/integrity")["quarantined"]
    _wait_slices([host_b])
    _differential(hosts, model)


def test_live_scrub_detects_and_repairs_without_a_restart(seeded):
    c, model = seeded
    c.wait_breakers_closed()  # after the restarts of the test before
    hosts = list(c.hosts.values())
    host_c = c.hosts["c"]
    assert not _get_json(host_c, "/debug/integrity")["quarantined"]
    summary = json.loads(_post(host_c, "/debug/integrity/scrub?sync=1"))
    assert summary["corrupt"] == 0 and summary["fragments"] >= 1
    _post(host_c, "/debug/failpoints",
          json.dumps({"site": "storage.read",
                      "spec": "corrupt(8)*1"}).encode())

    def scrub_and_drain():
        out = json.loads(_post(host_c, "/debug/integrity/scrub?sync=1"))
        assert out["corrupt"] >= 1, out
        _differential(hosts, model)
        _drain(host_c)

    _under_load(hosts, model, scrub_and_drain)
    assert _metric(host_c, "pilosa_storage_repairs_total") >= 1
    # Bytes flipped by hand under the running node.
    target = max(c.fragment_files("c"), key=os.path.getsize)
    _flip_bytes(target, 16, random.Random(5))
    summary = json.loads(_post(host_c, "/debug/integrity/scrub?sync=1"))
    assert summary["corrupt"] >= 1, summary
    _differential(hosts, model)
    _drain(host_c)
    _differential(hosts, model)
    summary = json.loads(_post(host_c, "/debug/integrity/scrub?sync=1"))
    assert summary["corrupt"] == 0
