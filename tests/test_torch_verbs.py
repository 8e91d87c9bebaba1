"""The port's ``top`` verb (cli.top), statsd emitter (utils.statsd) and
host profilers (utils.profiling, obs.profile) against the JAX package's.

- ``top``'s ``render`` draws the same frame from the same federation
  answers (an exposition, a cluster roll-up and a history made from a
  numpy seed), with and without a previous poll; ``top --once`` against
  a live port server draws the JAX verb's frame but for the clock.
- The statsd client sends the same packets for the same calls.
- The profilers fold the same stacks, tag samples with the bound
  query's id (``/debug/pprof/flame?query=``) and write the same report
  shape for ``--profile.cpu``.
"""

import io
import sys
import threading
import time

import numpy as np
import pytest

from pilosa_tpu.cli import commands as jax_cli
from pilosa_tpu.cli import top as jtop
from pilosa_tpu.obs import federate as jfed
from pilosa_tpu.obs import profile as jprof
from pilosa_tpu.sched import context as jctx
from pilosa_tpu.utils import profiling as jprofiling
from pilosa_tpu.utils import statsd as jstatsd

from pilosa_tpu_torch.cli import commands as port_cli
from pilosa_tpu_torch.cli import top as ttop
from pilosa_tpu_torch.obs import federate as tfed
from pilosa_tpu_torch.obs import profile as tprof
from pilosa_tpu_torch.sched import context as tctx
from pilosa_tpu_torch.server.server import Server as PortServer
from pilosa_tpu_torch.utils import profiling as tprofiling
from pilosa_tpu_torch.utils import statsd as tstatsd


def _exposition(rng, scale: float) -> str:
    lines = []
    for lane in ("read", "write"):
        n = int(rng.integers(100, 1000) * scale)
        lines.append(f'pilosa_query_requests_total{{call="Count",'
                     f'lane="{lane}",status="200"}} {n}')
        cum = 0
        for le in ("0.001", "0.004", "0.016", "0.064", "+Inf"):
            cum += int(rng.integers(0, n // 4 + 1))
            lines.append(f'pilosa_query_duration_seconds_bucket{{call='
                         f'"Count",lane="{lane}",status="200",le="{le}"}}'
                         f' {cum}')
        lines.append(f'pilosa_query_duration_seconds_sum{{call="Count",'
                     f'lane="{lane}",status="200"}} {cum * 0.003:.4f}')
        lines.append(f'pilosa_query_duration_seconds_count{{call="Count",'
                     f'lane="{lane}",status="200"}} {cum}')
        lines.append(f'pilosa_admission_queue_depth{{lane="{lane}"}}'
                     f' {int(rng.integers(5))}')
    lines.append(f"pilosa_admission_inflight_queries {int(rng.integers(9))}")
    lines.append(f"pilosa_wal_fsync_calls_total {int(1000 * scale)}")
    lines.append(f'pilosa_residency_hbm_bytes{{kind="used"}}'
                 f' {int(rng.integers(1 << 30))}')
    return "\n".join(lines) + "\n"


def _snapshot(mod, fed, rng, at: float, scale: float):
    snap = object.__new__(mod.Snapshot)
    snap.at = at
    snap.families = fed.parse_exposition(_exposition(rng, scale))
    snap.cluster = {
        "nodes": {"127.0.0.1:1": {"build": {"version": "0.1.0"},
                                  "admission": {"inFlight": 2},
                                  "wal": {"dirtyWals": 1},
                                  "resize": {"phase": "idle"}},
                  "127.0.0.1:2": {"build": {"version": "0.1.0"},
                                  "admission": {"inFlight": 0},
                                  "wal": {"dirtyWals": 0},
                                  "resize": {"phase": "idle"}}},
        "missing": ["127.0.0.1:3"] if scale > 1 else [],
        "versionSkew": False}
    snap.history = {"series": [{
        "name": "pilosa_query_duration_seconds:p99",
        "labels": {"lane": "read"},
        "points": [[at - 60 + i, float(v)] for i, v in
                   enumerate(rng.exponential(0.01, size=40))]}]}
    return snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_draws_the_same_frame(seed):
    frames = []
    for mod, fed in ((jtop, jfed), (ttop, tfed)):
        rng = np.random.default_rng(seed)
        prev = _snapshot(mod, fed, rng, 1_700_000_000.0, 1.0)
        cur = _snapshot(mod, fed, rng, 1_700_000_002.0, 1.5)
        frames.append((mod.render(cur, None),
                       mod.render(cur, prev),
                       mod.render(cur, prev, show_nodes=False, paused=True,
                                  width=100)))
    assert frames[1] == frames[0]
    assert "2 nodes" in frames[1][1]


def test_top_once_against_a_port_server(tmp_path):
    srv = PortServer(str(tmp_path / "d"), host="127.0.0.1:0", device="cpu",
                     warmup=False)
    srv.open()
    try:
        got = []
        for cli in (jax_cli, port_cli):
            so, se = io.StringIO(), io.StringIO()
            rc = cli.main(["top", "--host", srv.host, "--once"],
                          stdout=so, stderr=se)
            got.append((rc, so.getvalue().splitlines()))
    finally:
        srv.close()
    (jrc, jlines), (trc, tlines) = got
    assert jrc == trc == 0
    # The first line ends in the wall clock of each poll.
    assert tlines[0].rsplit(" ", 1)[0] == jlines[0].rsplit(" ", 1)[0]
    assert "1 node" in tlines[0]
    assert len(tlines) == len(jlines)
    so, se = io.StringIO(), io.StringIO()
    assert port_cli.main(["top", "--host", "127.0.0.1:1", "--once"],
                         stdout=so, stderr=se) == 1
    assert se.getvalue().startswith("top: cannot reach 127.0.0.1:1")


class _Sock:
    def __init__(self):
        self.sent = []

    def sendto(self, data, dest):
        self.sent.append((data, dest))

    def close(self):
        pass


@pytest.mark.parametrize("seed", [0, 1])
def test_statsd_sends_the_same_packets(seed):
    sent = []
    for mod in (jstatsd, tstatsd):
        rng = np.random.default_rng(seed)
        sock = _Sock()
        c = mod.StatsDStatsClient("10.0.0.1:9125", prefix="p.",
                                  tags=["b:2", "a:1"], _sock=sock)
        child = c.with_tags("index:i", "a:1")
        for _ in range(30):
            which = rng.integers(5)
            v = float(rng.choice([3.0, 2.5, 1e-7, 12345678.0]))
            client = child if rng.integers(2) else c
            if which == 0:
                client.count("setN", int(v))
            elif which == 1:
                client.gauge("fragments", v)
            elif which == 2:
                client.histogram("lat", v)
            elif which == 3:
                client.set("hosts", "h1")
            else:
                client.timing("snapshotDurationNs", v)
        c.close()
        sent.append(sock.sent)
    assert sent[0] == sent[1] and len(sent[1]) == 30
    assert sent[1][0][1] == ("10.0.0.1", 9125)


def _busy(stop: threading.Event) -> None:
    while not stop.is_set():
        sum(range(200))


def test_profilers_fold_and_tag_alike(tmp_path):
    frame = sys._getframe()
    assert tprof._collapse(frame) == jprof._collapse(frame)
    folded = []
    for prof_mod, ctx_mod in ((jprof, jctx), (tprof, tctx)):
        stop = threading.Event()
        ctx = ctx_mod.QueryContext(pql="Count()", index="i", id="qbusy")

        def run():
            with ctx_mod.use(ctx):
                _busy(stop)

        t = threading.Thread(target=run)
        t.start()
        p = prof_mod.ContinuousProfiler(hz=50, ring=256)
        try:
            for _ in range(5):
                p.sample_once()
                time.sleep(0.01)
        finally:
            stop.set()
            t.join()
        flame = p.flame(query="qbusy")
        stacks = [line.rsplit(" ", 1)[0] for line in flame.splitlines()[1:]]
        assert stacks and all("_busy (test_torch_verbs.py" in s
                              for s in stacks)
        folded.append((flame.splitlines()[0].split(" samples")[0],
                       sorted(p.snapshot())))
    assert folded[0] == folded[1]
    # The on-demand samplers: the same report shape, and --profile.cpu
    # writes it to its file.
    for mod in (jprofiling, tprofiling):
        assert mod.sample_profile(0.05).startswith(
            "# cpu profile (wall-clock sampler, idle leaves dropped): ")
        path = tmp_path / f"{mod.__name__}.prof"
        cp = mod.CPUProfiler(str(path), duration=0.05)
        cp.start()
        cp.stop()
        assert path.read_text().startswith("# cpu profile")
    assert tprofiling.heap_report() == jprofiling.heap_report()
    assert ("thread MainThread" in tprofiling.thread_dump())
