"""The port's pod on the CPU: whole processes joined into one
torch.distributed group (gloo), serving PQL as one node.

1. Two port processes (``tests/torch_pod_child.py pod``) run the JAX pod
   test's sequence through the coordinator's HTTP API (Counts as pod
   collectives, one ``count_exprs`` dispatch for a multi-Count body,
   podLocal Bitmaps, every TopN form, inverse views, a split import,
   time views, attributes, a BSI field); every request and answer is
   then replayed against one JAX server, whose answers must be equal.
2. Three processes with ``POD_TEST_POISON``: the same, then a forced
   partial dispatch poisons the pod and the host fan-out answers exactly
   under concurrent load.
3. Three processes, the last SIGKILLed between collectives (the port's
   form of tests/test_pod.py's eight-process case): the next collective
   fails within ``PILOSA_TPU_POD_TIMEOUT`` (10 s) plus 5 s, the pod is
   poisoned, reads that need no dead slice stay exact, and a Count that
   needs one answers 400 within the same bound.
4. A cluster of a JAX plain node and a port pod (the shape of
   tests/test_pod_cluster.py): writes through either node, every read
   from either node equal to one JAX node's over the same writes.

Tolerance: exact — equal integers, equal bit lists, the same TopN order.
Each test bounds its own waits to ``BUDGET_S`` (110 s) and stops its
children in a ``finally``.
"""

import base64
import json
import os
import signal
import sys
import time
import urllib.error
import urllib.request

from podenv import ChildSet, free_port, pod_env

from pilosa_tpu.cluster.broadcast import StaticNodeSet as JStaticNodeSet
from pilosa_tpu.cluster.topology import Cluster as JCluster
from pilosa_tpu.cluster.topology import Node as JNode
from pilosa_tpu.server.server import Server as JaxServer

_HERE = os.path.dirname(os.path.abspath(__file__))
CHILD = os.path.join(_HERE, "torch_pod_child.py")
SLICE_WIDTH = 1 << 20
BUDGET_S = 110.0


def _left(t_end: float) -> float:
    left = t_end - time.monotonic()
    assert left > 0, "the test's time budget ran out"
    return left


def _env(pid: int, port: int, peers: list, extra=None) -> dict:
    env = pod_env(pid, port, peers)
    env["OMP_NUM_THREADS"] = "2"
    env.update(extra or {})
    return env


def _req(host, method, path, body=b"", ctype="application/json"):
    r = urllib.request.Request(f"http://{host}{path}", data=body,
                               method=method,
                               headers={"Content-Type": ctype,
                                        "Accept": ctype})
    try:
        with urllib.request.urlopen(r, timeout=60) as f:
            return f.status, f.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _replay_against_jax(tmp_path, transcript_path) -> int:
    """Every recorded request against one JAX server, in order: equal
    statuses and equal JSON answers. Returns the reads compared."""
    with open(transcript_path) as f:
        steps = json.load(f)
    srv = JaxServer(str(tmp_path / "jax_ref"), host="127.0.0.1:0",
                    anti_entropy_interval=0, polling_interval=0)
    srv.open()
    reads = 0
    try:
        for st in steps:
            status, raw = _req(srv.host, st["method"], st["path"],
                               base64.b64decode(st["body"]), st["ctype"])
            assert status == 200, (st["path"], raw[:300])
            if st["answer"] is not None:
                assert json.loads(raw) == st["answer"], (
                    base64.b64decode(st["body"])[:200], raw[:300],
                    st["answer"])
                reads += 1
    finally:
        srv.close()
    return reads


def _run_pod(tmp_path, n_procs: int, extra=None) -> str:
    t_end = time.monotonic() + BUDGET_S - 20  # the JAX replay after it
    port = free_port()
    peers = [f"localhost:{free_port()}" for _ in range(n_procs)]
    transcript = str(tmp_path / "transcript.json")
    children = ChildSet(tmp_path)
    try:
        for pid in range(n_procs):
            data_dir = tmp_path / f"node{pid}"
            data_dir.mkdir()
            env = _env(pid, port, peers,
                       dict(extra or {}, POD_TRANSCRIPT=transcript))
            children.spawn(f"proc{pid}",
                           [sys.executable, CHILD, "pod", str(pid),
                            str(data_dir)], env, pipe=(pid == 0))
        coord = children.procs["proc0"]
        out, err = coord.communicate(timeout=_left(t_end))
        assert coord.returncode == 0, (
            f"coordinator rc={coord.returncode}\n{out}\n{err[-4000:]}\n"
            f"{children.logs_tail()}")
        assert "POD_TEST_OK" in out, out
    finally:
        children.cleanup()
    return transcript


def test_two_process_port_pod_answers_as_one_jax_node(tmp_path):
    transcript = _run_pod(tmp_path, 2)
    assert _replay_against_jax(tmp_path, transcript) >= 30


def test_three_process_port_pod_poisoned_serves_host_path(tmp_path):
    transcript = _run_pod(tmp_path, 3, {"POD_TEST_POISON": "1"})
    assert _replay_against_jax(tmp_path, transcript) >= 30


def test_three_process_port_pod_worker_sigkill(tmp_path):
    import select
    t_end = time.monotonic() + BUDGET_S - 10
    n_procs = 3
    port = free_port()
    peers = [f"localhost:{free_port()}" for _ in range(n_procs)]
    sentinel = tmp_path / "killed.sentinel"
    transcript = str(tmp_path / "transcript.json")
    children = ChildSet(tmp_path)
    try:
        for pid in range(n_procs):
            data_dir = tmp_path / f"node{pid}"
            data_dir.mkdir()
            env = _env(pid, port, peers, {
                "PILOSA_TPU_POD_TIMEOUT": "10",
                "POD_KILL_SENTINEL": str(sentinel),
                "POD_TRANSCRIPT": transcript})
            children.spawn(f"proc{pid}",
                           [sys.executable, CHILD, "kill", str(pid),
                            str(data_dir)], env, pipe=(pid == 0))
        coord = children.procs["proc0"]
        lines = []
        while select.select([coord.stdout], [], [], _left(t_end))[0]:
            line = coord.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "READY_FOR_KILL" in line:
                break
        assert any("READY_FOR_KILL" in ln for ln in lines), (
            "".join(lines) + children.logs_tail())
        victim = children.procs[f"proc{n_procs - 1}"]
        victim.send_signal(signal.SIGKILL)
        victim.wait()
        sentinel.write_text("killed")
        out, err = coord.communicate(timeout=_left(t_end))
        assert coord.returncode == 0, (
            f"coordinator rc={coord.returncode}\n{''.join(lines)}{out}\n"
            f"{err[-4000:]}\n{children.logs_tail()}")
        assert "POD_KILL_TEST_OK" in out, out
    finally:
        children.cleanup()
    assert _replay_against_jax(tmp_path, transcript) >= 1


def test_cluster_of_jax_node_and_port_pod(tmp_path, monkeypatch):
    t_end = time.monotonic() + BUDGET_S
    monkeypatch.setenv("PILOSA_TPU_MESH", "0")
    port = free_port()
    host_a = f"127.0.0.1:{free_port()}"
    peers = [f"127.0.0.1:{free_port()}", f"127.0.0.1:{free_port()}"]
    children = ChildSet(tmp_path)
    nodes = [JNode(host_a), JNode(peers[0])]
    a = JaxServer(str(tmp_path / "a"), host=host_a,
                  cluster=JCluster(nodes=nodes,
                                   node_set=JStaticNodeSet(nodes)),
                  anti_entropy_interval=0, polling_interval=0.3)
    ref = JaxServer(str(tmp_path / "ref"), host="127.0.0.1:0",
                    anti_entropy_interval=0, polling_interval=0)
    try:
        for pid, role in enumerate(("b0", "b1")):
            data_dir = tmp_path / role
            data_dir.mkdir()
            env = _env(pid, port, peers, {"POD_CLUSTER_A": host_a})
            children.spawn(role, [sys.executable, CHILD, "cluster", role,
                                  str(data_dir)], env)
        a.open()
        ref.open()
        while True:
            try:
                if _req(peers[0], "GET", "/version")[0] == 200:
                    break
            except urllib.error.URLError:
                pass
            assert time.monotonic() < t_end, children.logs_tail()
            time.sleep(0.2)
        for h in (host_a, peers[0], ref.host):
            assert _req(h, "POST", "/index/i", b"{}")[0] == 200
            assert _req(h, "POST", "/index/i/frame/f", b"{}")[0] == 200

        def write(host, pql):
            # A node's poll may have opened its breaker for a peer that
            # was still starting; the half-open probe closes it within
            # its backoff (tests/pod_cluster_child.py's q_retry).
            for h in (host, ref.host):
                while True:
                    st, raw = _req(h, "POST", "/index/i/query",
                                   pql.encode())
                    if (st == 200 or b"circuit open" not in raw
                            or time.monotonic() > t_end):
                        break
                    time.sleep(0.3)
                assert st == 200, (h, pql, raw)

        # Bits over 6 slices through both cluster nodes: placement by
        # jump hash to A or the pod, inside the pod by slice % 2.
        for s in range(6):
            via = (host_a, peers[0])[s % 2]
            for j in range(3):
                write(via, f"SetBit(frame=f, rowID=1,"
                           f" columnID={s * SLICE_WIDTH + j})")
            for j in range(2):
                write(via, f"SetBit(frame=f, rowID=2,"
                           f" columnID={s * SLICE_WIDTH + j})")
        write(host_a, 'SetRowAttrs(frame=f, rowID=2, tag="x")')
        reads = ["Count(Bitmap(frame=f, rowID=1))",
                 "Count(Intersect(Bitmap(frame=f, rowID=1),"
                 " Bitmap(frame=f, rowID=2)))",
                 "Count(Bitmap(frame=f, rowID=1))"
                 " Count(Bitmap(frame=f, rowID=2))",
                 "TopN(frame=f, n=2)",
                 "TopN(Bitmap(frame=f, rowID=1), frame=f, ids=[1, 2])",
                 "TopN(Bitmap(frame=f, rowID=1), frame=f, ids=[1, 2],"
                 " threshold=3)",
                 "Bitmap(frame=f, rowID=2)"]
        for host in (host_a, peers[0]):
            for pql in reads:
                want = _req(ref.host, "POST", "/index/i/query",
                            pql.encode())
                while True:
                    got = _req(host, "POST", "/index/i/query",
                               pql.encode())
                    # A learns the pod's max slice through its 0.3 s poll.
                    if got == want or time.monotonic() > t_end:
                        break
                    time.sleep(0.3)
                assert got[0] == want[0] == 200, (host, pql, got)
                assert json.loads(got[1]) == json.loads(want[1]), (
                    host, pql, got[1][:300], want[1][:300])
    finally:
        children.cleanup()
        a.close()
        ref.close()
