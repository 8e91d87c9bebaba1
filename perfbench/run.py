"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration
(``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<mix>.json``). One run:

1. makes the configuration's data from the seed (``datagen``);
2. starts the program's HTTP server (``pilosa_tpu_torch``) in this
   process, on the card, on 127.0.0.1 over a fresh data directory under
   ``TMPDIR``, with its default query, admission and WAL settings (the
   fsync policy from the configuration's guarantees);
3. creates the schema over HTTP and imports each frame through the
   program's bulk path in one call (WAL'd, as any import);
4. starts the mix's clients, separate processes on keep-alive
   connections, makes every leaf row of the mix resident with fused
   bodies of Counts of 32-row Unions (``_make_resident``), waits for the
   server's kernel warmup, then lets the clients send their warm-up
   streams of the cell's own requests (past the configuration's
   ``settle_s`` after the import);
5. opens the window: each client sends its next request when the last
   answer has come, for ``--seconds``; with ``--trace 1`` the requests
   ask for the per-stage profile, ``/metrics`` is scraped on both sides
   of the window and ``torch.profiler`` traces its middle 60 %;
   the notes on standard error say where the requests went and what
   the server's process did with its time (``watch``);
6. reads the device's peak memory, closes the server, checks every
   window answer against the plain reference (``reference``), computes
   the cell's metrics (one reader a metric, ``perfbench/metrics``), and
   prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
   ``checks``, each compared number beside its limit (also the last
   lines on standard error).

It exits non-zero, printing no result, without a card (or fewer than
the cell asks for), or if JAX or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import http.client  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import datagen, scrape, traffic, watch  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "pilosa_tpu")
RESIDENT_GROUP = 32     # leaf rows a residency warm-up Count unions
TRACE_FROM, TRACE_TO = 0.2, 0.8   # the traced share of the window
CLIENT_WAIT_S = 300.0


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    """``read(rec)`` of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    sp = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


class Http:
    """The harness's own requests (schema, residency warm-up, scrapes)."""

    def __init__(self, host: str):
        h, _, p = host.rpartition(":")
        self._c = http.client.HTTPConnection(h, int(p), timeout=600)

    def call(self, method: str, path: str, body: str = "") -> tuple:
        self._c.request(method, path, body.encode())
        r = self._c.getresponse()
        return r.status, r.read().decode("utf-8", "replace")

    def ok(self, method: str, path: str, body: str = "") -> str:
        status, text = self.call(method, path, body)
        if status != 200:
            raise RuntimeError(f"{method} {path}: {status} {text[:300]}")
        return text

    def close(self) -> None:
        self._c.close()


class Clients:
    """The client process (``client.py``) and a thread that reads its
    lines."""

    def __init__(self, args: dict):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "client.py"),
             json.dumps(args)],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=ROOT)
        self.lines: list = []
        self._cv = threading.Condition()
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            with self._cv:
                self.lines.append(line.rstrip("\n"))
                self._cv.notify_all()
        with self._cv:
            self.lines.append(None)
            self._cv.notify_all()

    def send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def wait_for(self, prefix: str, timeout: float = CLIENT_WAIT_S) -> str:
        end = time.monotonic() + timeout
        with self._cv:
            while True:
                for line in self.lines:
                    if line is None:
                        raise RuntimeError("a client ended early")
                    if line.startswith(prefix):
                        return line
                left = end - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"a client sent no {prefix!r}")
                self._cv.wait(left)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._t.join(timeout=10)


def _answers(body: str, tree: tuple):
    """The JSON answer's results, each parsed by its call's module, and
    the per-stage profile; (None, None) for a malformed answer or one
    of the wrong length."""
    try:
        doc = json.loads(body)
        res = doc.get("results")
    except (ValueError, AttributeError):
        return None, None
    if not isinstance(res, list) or len(res) != len(tree):
        return None, None
    return ([traffic.call_kind(c[0]).parse(r) for c, r in zip(tree, res)],
            doc.get("profile"))


def _power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             spec: dict, device: str = "cuda", cfg: dict = None,
             t_start: float = T_START) -> dict:
    """One run of ``cell``; the result line as a dict. ``cfg`` replaces
    the configuration file (the tests run tiny sizes)."""
    import torch
    from pilosa_tpu_torch.server.server import Server
    from perfbench import devtrace

    cfg = cfg or datagen.load(cell["config"])
    mix = traffic.load(cell["traffic"])
    log = sys.stderr
    data = datagen.make(cfg, seed)
    frame_rows = datagen.frame_rows(cfg)
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    srv = None
    clients = None
    try:
        srv = Server(os.path.join(tmp, "data"), host="127.0.0.1:0",
                     device=device,
                     wal_fsync=cfg["guarantees"]["wal_fsync"])
        srv.open()
        t_open = time.monotonic()
        hc = Http(srv.host)
        index = cfg["index"]
        hc.ok("POST", f"/index/{index}", "{}")
        for name, fr in sorted(cfg["frames"].items()):
            hc.ok("POST", f"/index/{index}/frame/{name}",
                  json.dumps({"options": fr.get("options", {})}))
        t_imp = time.monotonic()
        for name, fr in sorted(cfg["frames"].items()):
            datagen.load_frame(srv.holder.index(index).frame(name), fr,
                               data[name])
        t_import_end = time.monotonic()
        print(f"perfbench: imported in {t_import_end - t_imp:.1f} s",
              file=log)
        qs = "?profile=1" if trace else ""
        clients = Clients({
            "host": srv.host, "index": index, "mix": cell["traffic"],
            "frame_rows": frame_rows, "seed": seed,
            "clients": int(mix["clients"]), "query_string": qs})
        _make_resident(hc, index, traffic.leaf_frames(mix), frame_rows)
        end = time.monotonic() + 600
        while time.monotonic() < end:
            w = json.loads(hc.ok("GET", "/status")).get("warmup")
            if w is None or w.get("state") not in ("pending", "running"):
                break
            time.sleep(0.2)
        clients.wait_for("ready")
        warm_end = max(time.monotonic() + float(mix["warm_seconds"]),
                       t_import_end + float(cfg.get("settle_s", 0)))
        clients.send(f"warm {warm_end!r}")
        warmed = clients.wait_for("warmed").split()
        print(f"perfbench: {warmed[1]} warm-up requests, {warmed[2]} failed;"
              f" answers each second {warmed[3]}", file=log)
        if trace:
            devtrace.prime()
        before = scrape.parse(hc.ok("GET", "/metrics")) if trace else None
        t0 = time.monotonic() + 0.05
        t1 = t0 + seconds
        gcc = watch.GcClock()
        gcc.start()
        each_s = watch.EachSecond()
        each_s.start()
        th = [watch.threads_cpu()]
        cpu0 = watch.cpu_s()
        clients.send(f"go {t0!r} {t1!r}")
        summary = None
        if not trace:
            for mark in ((t0 + t1) / 2, t1):
                time.sleep(max(0.0, mark - time.monotonic()))
                th.append(watch.threads_cpu())
        if trace:
            st = devtrace.Stretch()
            time.sleep(max(0.0, t0 + TRACE_FROM * seconds - time.monotonic()))
            st.start()
            time.sleep(max(0.0, min(
                st.t_start + (TRACE_TO - TRACE_FROM) * seconds, t1)
                - time.monotonic()))
            summary = st.stop(os.path.join(tmp, "trace.json"))
        clients.wait_for("done", timeout=seconds + CLIENT_WAIT_S)
        cpu1 = watch.cpu_s()
        if trace:
            th.append(watch.threads_cpu())
        each_s.stop()
        gcc.stop()
        reqs = []
        for line in clients.lines:
            if line and line.startswith("["):
                ci, i, ts, tr, status, st_h, body = json.loads(line)
                reqs.append({"client": ci, "i": i, "t_send": ts,
                             "t_recv": tr, "status": status,
                             "stats": json.loads(st_h) if st_h else None,
                             "body": body})
        after = scrape.parse(hc.ok("GET", "/metrics")) if trace else None
        dv = json.loads(hc.ok("GET", "/debug/vars"))
        print("perfbench: after the window: "
              + json.dumps({k: dv.get(k) for k in (
                  "costModelVetoes", "coldAdmits", "costModel",
                  "deviceBlockCache")}), file=log)
        hc.close()
        on_card = torch.device(device).type == "cuda"
        kind = torch.cuda.get_device_name(0) if on_card else "cpu"
        peak = torch.cuda.max_memory_allocated(0) if on_card else 0
        clients.stop()
        clients = None
        srv.close()
        srv = None
        rec = {"reqs": reqs, "t0": t0, "t1": t1, "setup_s": t0 - t_start,
               "kind": kind, "n_slices": int(cfg["slices"]), "trace": summary,
               "scrape": ({"before": before, "after": after} if trace
                          else None), "cpu": (cpu0, cpu1),
               "watch": {"gc": gcc.snapshot(),
                         "threads": [watch.thread_delta(a, b)
                                     for a, b in zip(th, th[1:])],
                         "usage_5s": each_s.by_bucket(t0, t1, 5.0),
                         "open_s": t0 - t_open}}
        checks = _check(cfg, mix, data, frame_rows, seed, rec, device)
    finally:
        if clients is not None:
            clients.stop()
        if srv is not None:
            srv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    _note(rec, log=sys.stderr)
    metrics = {}
    for m in cell_metrics(spec, cell["name"], trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": peak,
           "power_limit": _power_limit() if kind != "cpu" else "none"}
    out = {"correct": all(c["value"] <= c["limit"]
                          for c in checks.values()) and bool(reqs),
           "attempted": len(reqs),
           "failed": sum(1 for r in reqs if not r["ok"]),
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = summary["breakdown"]
    out["checks"] = checks
    return out


def _note(rec: dict, log) -> None:
    """Where the window's requests went, on standard error: device
    programs a request and the requests that launched none, the mean
    latency of each half of the window, the server process's CPU
    seconds, the answers of each 5 s and each second, the garbage
    collector's pauses and the busiest threads (``watch``)."""
    reqs = rec["reqs"]
    progs = [r["stats"].get("devicePrograms", 0) for r in reqs
             if r.get("stats")]
    mid = (rec["t0"] + rec["t1"]) / 2
    halves = [[r["t_recv"] - r["t_send"] for r in reqs
               if (r["t_send"] < mid) == first] for first in (True, False)]
    ms = [f"{sum(h) / len(h) * 1e3:.1f}" if h else "-" for h in halves]
    print(f"perfbench: {len(reqs)} requests; device programs a request"
          f" {sum(progs) / max(1, len(progs)):.3f}, none in"
          f" {sum(1 for p in progs if not p)}; mean ms by half {ms}",
          file=log)
    cpu0, cpu1 = rec["cpu"]
    per5 = [sum(1 for r in reqs
                if rec["t0"] + k <= r["t_recv"] < rec["t0"] + k + 5)
            for k in range(0, int(rec["t1"] - rec["t0"]), 5)]
    print(f"perfbench: this process's CPU in the window {cpu1 - cpu0:.2f} s"
          f" ({(cpu1 - cpu0) / max(1, len(reqs)) * 1e3:.2f} ms a request);"
          f" answers a 5 s {per5}", file=log)
    w = rec["watch"]
    gc_s, gc_n = w["gc"]
    per1 = [sum(1 for r in reqs
                if rec["t0"] + k <= r["t_recv"] < rec["t0"] + k + 1)
            for k in range(int(rec["t1"] - rec["t0"]))]
    print(f"perfbench: garbage collector s by generation"
          f" {[round(x, 3) for x in gc_s]} in {list(gc_n)} passes;"
          f" busiest threads by part of the window {w['threads']}; the"
          f" server opened {w['open_s']:.1f} s before the window;"
          f" answers each second {per1}; by 5 s"
          f" {json.dumps(w['usage_5s'])}", file=log)


def _make_resident(hc: Http, index: str, frames: list,
                   frame_rows: dict) -> None:
    """Make every row of ``frames`` resident on the card before any of
    the cell's own requests. Rows go in groups of ``RESIDENT_GROUP``,
    two groups' Counts of Unions to a body, each body sent twice: the
    program's fused batch runs a body's cold block at its second
    sighting, and a fused batch feeds nothing to the cost model's drift
    loop, so the cell's own device legs, not these cold ones, set its
    drift median."""
    groups = []
    for frame in frames:
        n = frame_rows[frame]
        for lo in range(0, n, RESIDENT_GROUP):
            groups.append((frame, range(lo, min(lo + RESIDENT_GROUP, n))))
    if len(groups) % 2:
        # A body needs two calls to fuse: halve the last group.
        frame, rows = groups.pop()
        mid = max(1, len(rows) // 2)
        groups += [(frame, rows[:mid]), (frame, rows[mid:] or rows[:mid])]
    for i in range(0, len(groups), 2):
        body = " ".join(
            "Count(Union(" + ", ".join(
                f"Bitmap(rowID={r}, frame={frame})" for r in rows) + "))"
            for frame, rows in groups[i:i + 2])
        for _ in range(2):
            hc.ok("POST", f"/index/{index}/query", body)


def _check(cfg, mix, data, frame_rows, seed, rec, device) -> dict:
    """Every window answer against the reference: answers that differ,
    and requests that got none (a failure, a refusal, a malformed
    body)."""
    from perfbench import reference
    by_client: dict = {}
    for r in rec["reqs"]:
        by_client.setdefault(r["client"], []).append(r)
    ref = reference.Reference(cfg, data, device)
    wrong = missing = 0
    want: dict = {}  # PQL body -> the reference's answers
    for ci, reqs in sorted(by_client.items()):
        reqs.sort(key=lambda r: r["i"])
        stream = traffic.Stream(mix, frame_rows, seed, ci)
        for r, (pql, tree) in zip(reqs, stream.take(len(reqs))):
            got, prof = (_answers(r["body"], tree)
                         if r["status"] == 200 else (None, None))
            r["ok"] = got is not None
            r["profile"] = prof
            r["leaves"] = len(set().union(*map(traffic.leaves, tree)))
            if got is None:
                missing += 1
                continue
            if pql not in want:
                want[pql] = [ref.answer(call) for call in tree]
            if got != want[pql]:
                wrong += 1
    return {"wrong_answers": {"value": wrong, "limit": 0},
            "missing_answers": {"value": missing, "limit": 0}}


def _forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache = os.path.join(HERE, ".cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    spec = load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if a.workload not in cells:
        print(f"perfbench: no cell {a.workload!r}", file=sys.stderr)
        return 2
    cell = cells[a.workload]
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"perfbench: the cell needs {cell['chips']} CUDA device(s);"
              f" found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(cell, a.seed, a.seconds, bool(a.trace), spec)
    bad = _forbidden_modules()
    if bad:
        print(f"perfbench: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
