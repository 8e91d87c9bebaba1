"""The port's configuration against the JAX package's, on the CPU.

- The ``config`` verb prints the JAX CLI's bytes.
- Seeded TOML files, ``PILOSA_*`` environment maps and ``server`` flags
  load (``load``, then ``load_server_config``: flags over env over file)
  to the same values and the same ``to_toml()`` bytes in both packages,
  and the written TOML loads back to itself.
- Invalid values fail with the same exception and message.
- An explicit switch-on of a subsystem the port does not run yet exits
  2 before the server starts, naming the slice that brings it; the
  subsystems on by default are only noted.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from pilosa_tpu.cli import commands as jax_cli
from pilosa_tpu.utils import config as jcfg

from pilosa_tpu_torch.cli import commands as port_cli
from pilosa_tpu_torch.utils import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DURS = ("250ms", "1s", "0.5s", "90s", "2m", "1h30m", "10m")


def _run(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    rc = cli.main(argv, stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()


def test_config_verb_prints_the_jax_bytes():
    assert _run(port_cli, ["config"]) == _run(jax_cli, ["config"])


def _toml_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, list):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    return f'"{v}"'


def _sections(rng) -> dict:
    """Every key of every section with a seeded valid value."""
    def dur():
        return str(rng.choice(DURS))

    def b():
        return bool(rng.integers(0, 2))

    def n(lo=1, hi=5000):
        return int(rng.integers(lo, hi))

    hosts = [f"10.0.0.{k}:10101" for k in range(n(1, 4))]
    return {
        "": {"data-dir": f"/data/{n()}", "host": f"127.0.0.1:{n()}",
             "log-path": f"/tmp/log{n()}"},
        "cluster": {"replicas": n(1, 4),
                    "type": str(rng.choice(["static", "http", "gossip"])),
                    "hosts": hosts, "internal-hosts": hosts[:1],
                    "polling-interval": dur(), "internal-port": str(n()),
                    "gossip-seed": f"10.0.0.9:{n()}",
                    "gossip-secret": f"s{n()}", "gen-staleness": dur(),
                    "resize-pace": dur(), "resize-grace": dur()},
        "query": {"concurrency": n(), "queue-depth": n(),
                  "default-timeout": dur(), "slow-threshold": dur(),
                  "result-cache-entries": n(), "result-cache-bits": n(),
                  "cluster-cache-entries": n()},
        "tenants.default": {"weight": n(1, 9), "concurrency": n(0, 9),
                            "max-wall": dur(), "cache-share": 0.5},
        "tenants.bulk": {"weight": 1, "queue-depth": n(0, 9),
                         "max-container-ops": n(), "max-device-bytes": n()},
        "metrics": {"enabled": b(), "runtime-interval": dur(),
                    "accounting": b(), "federate-timeout": dur(),
                    "federate-fanout": n(1, 16)},
        "history": {"enabled": b(), "resolutions": "10s:36,1m:72",
                    "segment-bytes": n(), "segments": n(1, 9),
                    "max-series": n()},
        "sentinel": {"enabled": b(), "interval": dur(), "window": dur(),
                     "baseline": dur(), "zscore": 4.5, "min-points": n(1, 9),
                     "min-ratio": 2.0, "retrip": dur(),
                     "manifest": f"/m{n()}.json",
                     "manifest-tolerance": 3.0},
        "trace": {"enabled": b(), "max-traces": n(), "max-spans": n(),
                  "tail": b(), "head-n": n(), "slow-floor": dur(),
                  "disk-segment-bytes": n(), "disk-segments": n(1, 9)},
        "blackbox": {"enabled": b(), "interval": dur(),
                     "segment-bytes": n(), "segments": n(1, 9),
                     "dumps": n(1, 9)},
        "watchdog": {"enabled": b(), "interval": dur(), "wal-stall": dur(),
                     "deadline-grace": dur(), "gossip-silence": dur(),
                     "queue-stall": dur(), "resize-stall": dur(),
                     "scrub-stall": dur(), "tier-stall": dur(),
                     "backup-stall": dur(), "retrip": dur()},
        "scrub": {"enabled": b(), "interval": dur(), "pace": dur(),
                  "repair": b(), "repair-rescan": dur()},
        "tier": {"enabled": b(), "resident-budget": n(),
                 "high-watermark": 0.8, "low-watermark": 0.6,
                 "idle": dur(), "blob-idle": dur(), "cold-dir": "/cold",
                 "blob": "dir", "interval": dur(),
                 "prefetch-interval": dur(), "pace": dur()},
        "capture": {"mode": str(rng.choice(["off", "sampled", "full"])),
                    "sample-n": n(), "segment-bytes": n(),
                    "segments": n(1, 9), "redact": "*"},
        "backup": {"archive": "dir:/arch", "wal-interval": dur(),
                   "keep-fulls": n(1, 5)},
        "profile": {"continuous": b(), "hz": 20.0, "ring": n()},
        "slo": {"objective": dur(), "target": 0.95},
        "fault": {"enabled": b(), "breaker-threshold": n(1, 9),
                  "breaker-backoff": dur(), "breaker-backoff-cap": dur(),
                  "hedge": dur(), "seed": n()},
        "fault.failpoints": {"rpc.send": "error(0.5)",
                             "wal.append": "delay(5ms)"},
        "plugins": {"path": "/plugins"},
        "anti-entropy": {"interval": dur()},
    }


def _seeded_toml(seed: int) -> str:
    """A seeded subset of the sections, each with a seeded subset of its
    keys."""
    rng = np.random.default_rng(seed)
    out = []
    for name, keys in _sections(rng).items():
        if name and name not in ("tenants.default",) and rng.random() < 0.2:
            continue
        picked = [k for k in keys if rng.random() < 0.7 or name in (
            "tenants.default", "fault.failpoints")]
        if name:
            out.append(f"[{name}]")
        out += [f"{k} = {_toml_value(keys[k])}" for k in picked]
        out.append("")
    return "\n".join(out)


ENV = {
    "PILOSA_DATA_DIR": "/env/data", "PILOSA_HOST": "127.0.0.1:7000",
    "PILOSA_CLUSTER_TYPE": "gossip",
    "PILOSA_CLUSTER_HOSTS": "10.1.0.1:1, 10.1.0.2:2",
    "PILOSA_CLUSTER_REPLICAS": "2", "PILOSA_CLUSTER_INTERNAL_PORT": "15000",
    "PILOSA_CLUSTER_GOSSIP_SEED": "10.1.0.1:15000",
    "PILOSA_CLUSTER_GOSSIP_SECRET": "env-secret",
    "PILOSA_CLUSTER_POLL_INTERVAL": "3s", "PILOSA_LOG_PATH": "/env/log",
    "PILOSA_ANTI_ENTROPY_INTERVAL": "5m", "PILOSA_QUERY_CONCURRENCY": "3",
    "PILOSA_QUERY_QUEUE_DEPTH": "7", "PILOSA_QUERY_DEFAULT_TIMEOUT": "2s",
    "PILOSA_QUERY_SLOW_THRESHOLD": "250ms",
    "PILOSA_QUERY_RESULT_CACHE_ENTRIES": "4",
    "PILOSA_QUERY_RESULT_CACHE_BITS": "1024",
    "PILOSA_QUERY_CLUSTER_CACHE_ENTRIES": "0",
    "PILOSA_TENANTS": "default:weight=4,concurrency=8;bulk:max-wall=2s",
    "PILOSA_CLUSTER_GEN_STALENESS": "1.5",
    "PILOSA_METRICS_ENABLED": "false", "PILOSA_METRICS_ACCOUNTING": "0",
    "PILOSA_HISTORY_RESOLUTIONS": "5s:10", "PILOSA_SENTINEL_ZSCORE": "3.5",
    "PILOSA_TRACE_ENABLED": "1", "PILOSA_TRACE_SLOW_FLOOR": "50ms",
    "PILOSA_BLACKBOX_ENABLED": "no", "PILOSA_WATCHDOG_WAL_STALL": "9s",
    "PILOSA_SCRUB_PACE": "0s", "PILOSA_TIER_BLOB": "dir",
    "PILOSA_CAPTURE_MODE": "off", "PILOSA_BACKUP_KEEP_FULLS": "4",
    "PILOSA_PLUGINS_PATH": "/env/plugins", "PILOSA_FAULT_SEED": "9",
    "PILOSA_FAULT_BREAKER_THRESHOLD": "5", "PILOSA_FAULT_RPC_SEND":
    "error(0.1)", "PILOSA_FAULT_GOSSIP_DELIVER": "error*2",
}

# Flags both CLIs' server verbs take.
FLAGS = (
    ["-d", "/flag/data"], ["-b", "127.0.0.1:9100"],
    ["--log-path", "/flag/log"], ["--cluster.replicas", "3"],
    ["--cluster.hosts", "a:1,b:2,c:3"], ["--cluster.type", "http"],
    ["--cluster.internal-port", "16000"],
    ["--cluster.gossip-seed", "a:16000"],
    ["--cluster.gossip-secret", "flag-secret"],
    ["--cluster.poll-interval", "7s"], ["--query.concurrency", "2"],
    ["--query.default-timeout", "1s"], ["--query.slow-threshold", "2s"],
    ["--query.result-cache-entries", "1"],
    ["--query.result-cache-bits", "99"],
    ["--query.cluster-cache-entries", "5"],
    ["--tenants", "default:weight=2"], ["--cluster.gen-staleness", "3s"],
    ["--anti-entropy.interval", "20m"], ["--metrics.enabled", "true"],
    ["--trace.enabled", "off"], ["--trace.tail", "false"],
    ["--trace.max-traces", "11"], ["--metrics.accounting", "true"],
    ["--blackbox.enabled", "false"], ["--watchdog.enabled", "0"],
    ["--history.enabled", "off"], ["--profile.continuous", "no"],
    ["--profile.hz", "2.5"], ["--slo.target", "0.9"],
    ["--slo.objective", "100ms"], ["--plugins.path", "/flag/plugins"],
)


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("seed", range(6))
def test_seeded_files_env_and_flags_load_alike(tmp_path, seed):
    path = tmp_path / "pilosa.toml"
    path.write_text(_seeded_toml(seed))
    rng = np.random.default_rng(100 + seed)
    env = {k: v for k, v in ENV.items() if rng.random() < 0.5}
    argv = ["server", "-c", str(path)]
    for flag in FLAGS:
        if rng.random() < 0.4:
            argv += flag
    for e in ({}, env):
        want = jcfg.load(str(path), env=e)
        got = tcfg.load(str(path), env=e)
        assert _asdict(got) == _asdict(want)
        assert got.to_toml() == want.to_toml()
        want = jax_cli.load_server_config(
            jax_cli.build_parser().parse_args(argv), env=e)
        got = port_cli.load_server_config(
            port_cli.build_parser().parse_args(argv), env=e)
        assert got.to_toml() == want.to_toml()
        # The written file loads back to the same configuration.
        again = tmp_path / "again.toml"
        again.write_text(got.to_toml())
        assert (tcfg.load(str(again), env={}).to_toml()
                == jcfg.load(str(again), env={}).to_toml())


BAD_FILES = (
    "[cluster]\nreplicas = \"x\"\n",
    "[query]\ndefault-timeout = \"soon\"\n",
    "[tenants.bulk]\nweight = 1\n",
    "[tenants.default]\nweight = -1\n",
    "[tenants.default]\nspeed = 3\n",
    "[tenants.default]\ncache-share = 1.5\n",
    "[tenants.default]\nmax-wall = \"-\"\n",
    "[tenants]\ndefault = 3\n",
    "[history]\nresolutions = \"1m:10,10s:5\"\n",
    "[history]\nresolutions = \"10s:0\"\n",
    "[trace]\nmax-traces = \"many\"\n",
    "[fault]\nseed = \"x\"\n",
    "[cluster\nreplicas = 1\n",
)

BAD_ENV = (
    {"PILOSA_CLUSTER_REPLICAS": "two"},
    {"PILOSA_QUERY_SLOW_THRESHOLD": "later"},
    {"PILOSA_TENANTS": "bulk:weight=1"},
    {"PILOSA_TENANTS": "default"},
    {"PILOSA_HISTORY_RESOLUTIONS": "1m:1,1s:1"},
    {"PILOSA_CLUSTER_GEN_STALENESS": "stale"},
)


def _failure(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", range(len(BAD_FILES) + len(BAD_ENV)))
def test_invalid_values_fail_alike(tmp_path, case):
    path = tmp_path / "bad.toml"
    if case < len(BAD_FILES):
        path.write_text(BAD_FILES[case])
        env = {}
    else:
        path.write_text("")
        env = BAD_ENV[case - len(BAD_FILES)]
    want = _failure(lambda: jcfg.load(str(path), env=env))
    assert want is not None
    assert _failure(lambda: tcfg.load(str(path), env=env)) == want


# A backup switch-on exits 2, also beside a tier switch-on (the tier
# slice is ported: only the backup one refuses).
SWITCH_ONS = (
    ("[tier]\nenabled = true\n[backup]\narchive = \"dir:/x\"\n", [], {},
     "item 7, the backup slice"),
    ("[tier]\nblob = \"dir\"\n", [], {"PILOSA_BACKUP_ARCHIVE": "dir:/x"},
     "item 7, the backup slice"),
    ("[backup]\narchive = \"dir:/x\"\n", [], {}, "item 7, the backup slice"),
    ("", [], {"PILOSA_BACKUP_ARCHIVE": "dir:/x"}, "item 7, the backup slice"),
    ("[backup]\narchive = \"dir:/x\"\n", [], {"PILOSA_TIER_BLOB": "dir"},
     "item 7, the backup slice"),
    ("", [], {"PILOSA_TIER_ENABLED": "1", "PILOSA_BACKUP_ARCHIVE": "dir:/x"},
     "item 7, the backup slice"),
)

# Switch-ons of the operator surface, which the port now runs: the
# server starts (it exited 2 before the operator slice).
PORTED_SWITCH_ONS = (
    ("[capture]\nmode = \"full\"\n", []),
    ("", ["--sentinel.manifest", "m.json"]),
    ("[blackbox]\nenabled = true\n[watchdog]\nenabled = true\n"
     "[history]\nenabled = true\n[profile]\ncontinuous = true\n", []),
    ("", ["--profile.cpu", "cpu.prof", "--profile.cpu-time", "200ms"]),
    ("[tier]\nenabled = true\nblob = \"dir\"\n", []),
    ("[tier]\nenabled = true\n", []),
)


@pytest.mark.parametrize("case", range(len(SWITCH_ONS)))
def test_unported_switch_on_exits_2(tmp_path, monkeypatch, case):
    text, flags, env, slice_name = SWITCH_ONS[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    path = tmp_path / "on.toml"
    path.write_text(text)
    data = tmp_path / "data"
    rc, out, err = _run(port_cli, ["server", "-c", str(path), "--device",
                                   "cpu", "-d", str(data), "-b",
                                   "127.0.0.1:0"] + flags)
    assert rc == 2 and not out
    assert f"not available in this package yet ({slice_name})" in err
    assert "[tier]" not in err
    assert not data.exists()  # refused before the node opened anything


def test_default_on_subsystems_are_noted_not_refused():
    """The JAX defaults switch on nothing the port lacks: only backup is
    still unported, and it is off by default."""
    assert [u[0] for u in tcfg.UNPORTED] == ["backup"]
    assert tcfg.unported_switch_ons(tcfg.Config()) == []
    cfg = tcfg.load("", env={"PILOSA_CAPTURE_MODE": "full",
                             "PILOSA_BLACKBOX_ENABLED": "true"})
    assert tcfg.unported_switch_ons(cfg) == []


@pytest.mark.parametrize("case", range(len(PORTED_SWITCH_ONS)))
def test_operator_switch_on_starts(tmp_path, case):
    """Capture's full mode, a sentinel manifest, the default-on
    operator sections, ``--profile.cpu`` and a ``[tier]`` switch-on (with
    and without a blob store) start the ``server`` verb: it serves,
    answers the sections' routes and exits 0 on SIGINT."""
    text, flags = PORTED_SWITCH_ONS[case]
    path = tmp_path / "on.toml"
    path.write_text(text)
    data = tmp_path / "data"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "pilosa_tpu_torch.cli", "server", "-c",
         str(path), "--device", "cpu", "-d", str(data), "-b",
         "127.0.0.1:0"] + flags, cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("pilosa-tpu serving at http://"), (
            line + proc.stderr.read())
        host = line.split("http://", 1)[1].split()[0]
        for route in ("/debug/capture", "/debug/sentinel",
                      "/debug/blackbox", "/debug/metrics/history",
                      "/debug/tier"):
            with urllib.request.urlopen(f"http://{host}{route}",
                                        timeout=10) as r:
                assert r.status == 200
                body = json.loads(r.read())
            assert "enabled" in body
        with urllib.request.urlopen(f"http://{host}/debug/capture",
                                    timeout=10) as r:
            assert json.loads(r.read())["mode"] == (
                "full" if case == 0 else "sampled")
        with urllib.request.urlopen(f"http://{host}/debug/tier?pass=1",
                                    timeout=10) as r:
            tier = json.loads(r.read())
        assert tier["enabled"] is ("[tier]" in text)
        if "[tier]" in text:
            assert tier["store"] == ({"kind": "dir", "objects": 0,
                                      "root": str(data / "_tier" / "blob")}
                                     if "blob" in text else None)
    finally:
        proc.send_signal(signal.SIGINT)
        proc.communicate(timeout=60)
    assert proc.returncode == 0
    if "--profile.cpu" in flags:
        # The sampled host profile, written when its time ran out.
        assert (tmp_path / "cpu.prof").read_text().startswith(
            "# cpu profile (wall-clock sampler")
