"""``pilosa-tpu top``: a live terminal dashboard over the fleet
observability plane (docs/OBSERVABILITY.md).

Polls the federation endpoints of any cluster member — the member
does the fan-out, `top` does none of its own:

- ``GET /metrics/cluster?partial=1`` — merged counters/histograms +
  per-node gauges; consecutive scrapes difference into live QPS,
  per-lane p50/p99, WAL fsync rate, compile-cache hit rate;
- ``GET /debug/cluster?partial=1`` — per-node build/breaker/WAL/
  resize/admission columns (missing nodes render as DOWN);
- ``GET /debug/metrics/history?scope=cluster&partial=1`` — the p99
  sparkline over the trailing window, from the on-disk history.

Keybindings (documented in docs/OBSERVABILITY.md): ``q`` quit,
``p`` pause/resume polling, ``n`` toggle the per-node table.
``--once`` renders a single frame and exits (scripts, tests).

Copy of the JAX package's ``cli/top.py``.
"""

from __future__ import annotations

import json
import time
import urllib.request
from typing import Optional

SPARK = "▁▂▃▄▅▆▇█"


def _get(host: str, path: str, timeout: float = 10.0) -> bytes:
    with urllib.request.urlopen(f"http://{host}{path}",
                                timeout=timeout) as r:
        return r.read()


def sparkline(values: list[float], width: int = 40) -> str:
    """Unicode sparkline, newest right, scaled to the window max."""
    if not values:
        return ""
    values = values[-width:]
    hi = max(values)
    if hi <= 0:
        return SPARK[0] * len(values)
    return "".join(SPARK[min(len(SPARK) - 1,
                             int(v / hi * (len(SPARK) - 1) + 0.5))]
                   for v in values)


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0:
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}PB"


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v < 0.001:
        return f"{v * 1e6:.0f}us"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


class Snapshot:
    """One polling pass: the parsed federation responses."""

    def __init__(self, host: str, timeout: float = 10.0,
                 history_window: str = "10m"):
        from ..obs.federate import parse_exposition
        self.at = time.time()
        self.families = parse_exposition(
            _get(host, "/metrics/cluster?partial=1",
                 timeout).decode())
        self.cluster = json.loads(
            _get(host, "/debug/cluster?partial=1", timeout))
        try:
            self.history = json.loads(_get(
                host, "/debug/metrics/history?scope=cluster&partial=1"
                      "&family=pilosa_query_duration_seconds"
                      f"&window={history_window}", timeout))
        except Exception:  # noqa: BLE001 - sparkline is optional garnish
            self.history = {"series": []}

    # -- family accessors -----------------------------------------------------

    def samples(self, family: str) -> list[tuple[str, dict, float]]:
        fam = self.families.get(family)
        return list(fam["samples"]) if fam else []

    def total(self, family: str, **match) -> float:
        out = 0.0
        for name, labels, v in self.samples(family):
            if name.endswith(("_bucket", "_sum")):
                continue
            if name.endswith("_count") and not family.endswith("_count"):
                continue
            if all(labels.get(k) == v2 for k, v2 in match.items()):
                out += v
        return out

    def gauge_sum(self, family: str, **match) -> float:
        return self.total(family, **match)

    def hist_components(self, family: str, **match
                        ) -> tuple[dict, float, float]:
        """(bucket le → cumulative count, sum, count) over every
        sample matching the label filter."""
        buckets: dict[str, float] = {}
        total = count = 0.0
        for name, labels, v in self.samples(family):
            if not all(labels.get(k) == v2 for k, v2 in match.items()):
                continue
            if name.endswith("_bucket"):
                le = labels.get("le", "")
                buckets[le] = buckets.get(le, 0.0) + v
            elif name.endswith("_sum"):
                total += v
            elif name.endswith("_count"):
                count += v
        return buckets, total, count


def _quantile(buckets: dict[str, float], q: float) -> Optional[float]:
    """Upper-bound quantile estimate from cumulative le buckets."""
    rows = []
    for le, c in buckets.items():
        try:
            bound = float("inf") if le == "+Inf" else float(le)
        except ValueError:
            continue
        rows.append((bound, c))
    rows.sort()
    if not rows or rows[-1][1] <= 0:
        return None
    want = rows[-1][1] * q
    for bound, c in rows:
        if c >= want:
            return None if bound == float("inf") else bound
    return None


def _delta_hist(cur, prev, family: str, **match
                ) -> tuple[dict, float, float]:
    """Bucket/sum/count deltas between two snapshots (the live
    window); falls back to cumulative when there is no previous."""
    cb, cs, cc = cur.hist_components(family, **match)
    if prev is None:
        return cb, cs, cc
    pb, ps, pc = prev.hist_components(family, **match)
    db = {le: max(0.0, c - pb.get(le, 0.0)) for le, c in cb.items()}
    return db, max(0.0, cs - ps), max(0.0, cc - pc)


def _rate(cur, prev, family: str, **match) -> Optional[float]:
    if prev is None:
        return None
    dt = cur.at - prev.at
    if dt <= 0:
        return None
    return max(0.0, (cur.total(family, **match)
                     - prev.total(family, **match))) / dt


def _lanes() -> tuple:
    from ..sched import LANES
    return LANES


def render(cur: Snapshot, prev: Optional[Snapshot],
           show_nodes: bool = True, paused: bool = False,
           width: int = 78) -> str:
    """One frame of the dashboard as plain text (ANSI-free: the loop
    adds the clear-screen; tests snapshot this)."""
    lines = []
    nodes = cur.cluster.get("nodes") or {}
    missing = cur.cluster.get("missing") or []
    skew = cur.cluster.get("versionSkew")
    title = (f"pilosa-tpu top — {len(nodes)} node"
             f"{'s' if len(nodes) != 1 else ''}")
    if missing:
        title += f" ({len(missing)} unreachable)"
    if skew:
        title += "  [VERSION SKEW]"
    if paused:
        title += "  [paused]"
    clock = time.strftime("%H:%M:%S", time.localtime(cur.at))
    lines.append(title + " " * max(1, width - len(title) - len(clock))
                 + clock)
    lines.append("-" * width)

    # Cluster roll-up row: QPS, latency, admission, WAL, compile, HBM.
    qps = _rate(cur, prev, "pilosa_query_requests_total")
    fsync = _rate(cur, prev, "pilosa_wal_fsync_calls_total")
    hits = _rate(cur, prev, "pilosa_compile_cache_hits_total")
    misses = _rate(cur, prev, "pilosa_compile_cache_misses_total")
    inflight = cur.gauge_sum("pilosa_admission_inflight_queries")
    queued = cur.gauge_sum("pilosa_admission_queue_depth")
    hbm = cur.gauge_sum("pilosa_residency_hbm_bytes", kind="used")
    b, _s, _c = _delta_hist(cur, prev, "pilosa_query_duration_seconds")
    lines.append(
        f"qps {qps:8.1f}/s" if qps is not None else "qps        -  ",)
    lines[-1] += (f"   p50 {_fmt_s(_quantile(b, 0.5)):>8}"
                  f"   p99 {_fmt_s(_quantile(b, 0.99)):>8}"
                  f"   inflight {inflight:.0f}"
                  f"   queued {queued:.0f}")
    row = (f"wal fsync {fsync:6.1f}/s" if fsync is not None
           else "wal fsync     -  ")
    if hits is not None and misses is not None:
        row += f"   compile hit {hits:5.1f}/s miss {misses:5.1f}/s"
    row += f"   hbm {_fmt_bytes(hbm)}"
    lines.append(row)
    lines.append("")

    # Per-lane table (live window when a previous scrape exists).
    lines.append(f"{'LANE':<8}{'QPS':>10}{'SHED/S':>10}{'P50':>10}"
                 f"{'P99':>10}")
    for lane in _lanes():
        lb, _ls, lc = _delta_hist(cur, prev,
                                  "pilosa_query_duration_seconds",
                                  lane=lane)
        lqps = _rate(cur, prev, "pilosa_query_requests_total",
                     lane=lane)
        shed = _rate(cur, prev, "pilosa_admission_rejections_total",
                     lane=lane)
        lines.append(
            f"{lane:<8}"
            + (f"{lqps:>9.1f}/s" if lqps is not None else f"{'-':>10}")
            + (f"{shed:>9.1f}/s" if shed is not None else f"{'-':>10}")
            + f"{_fmt_s(_quantile(lb, 0.5)):>10}"
            + f"{_fmt_s(_quantile(lb, 0.99)):>10}")
    lines.append("")

    # Planner panel: is the cost-based planner helping — CSE cache hit
    # rate, short-circuits per second, and the estimator's tail error
    # (misestimation ratio p99; ~1.0 means estimates track actuals).
    cse_hit = _rate(cur, prev,
                    "pilosa_planner_subresult_cache_events_total",
                    event="hit")
    cse_miss = _rate(cur, prev,
                     "pilosa_planner_subresult_cache_events_total",
                     event="miss")
    sc = _rate(cur, prev, "pilosa_planner_decisions_total",
               outcome="short_circuit")
    mb, _ms, _mc = _delta_hist(cur, prev,
                               "pilosa_planner_misestimation_ratio")
    mis_p99 = _quantile(mb, 0.99)
    if any(v is not None for v in (cse_hit, cse_miss, sc, mis_p99)):
        row = "planner "
        if cse_hit is not None and cse_miss is not None \
                and cse_hit + cse_miss > 0:
            pct = 100.0 * cse_hit / (cse_hit + cse_miss)
            row += f"  cse hit {pct:5.1f}%"
        else:
            row += "  cse hit     -"
        row += (f"   short-circuit {sc:6.1f}/s" if sc is not None
                else "   short-circuit     -")
        row += (f"   misest p99 {mis_p99:6.2f}x" if mis_p99 is not None
                else "   misest p99     -")
        lines.append(row)
        lines.append("")

    # p99 sparkline from the fleet history (mean across nodes/lanes
    # per tick).
    series = [s for s in (cur.history.get("series") or [])
              if s.get("name", "").endswith(":p99")]
    if series:
        by_ts: dict[float, list[float]] = {}
        for s in series:
            for ts, v in s.get("points") or []:
                by_ts.setdefault(round(ts), []).append(v)
        vals = [sum(vs) / len(vs) for _ts, vs in sorted(by_ts.items())]
        win = cur.history.get("windowS") or 0
        lines.append(f"p99 history ({int(win)}s): "
                     + sparkline(vals, width - 24))
        lines.append("")

    # Per-node table.
    if show_nodes:
        lines.append(f"{'NODE':<24}{'STATE':>6}{'VER':>10}{'BRKR':>6}"
                     f"{'WAL':>6}{'INFL':>6}{'RESIZE':>10}")
        for host in sorted(set(nodes) | set(missing)):
            if host in missing:
                lines.append(f"{host:<24}{'DOWN':>6}{'-':>10}{'-':>6}"
                             f"{'-':>6}{'-':>6}{'-':>10}")
                continue
            block = nodes[host] or {}
            ver = str((block.get("build") or {}).get("version",
                                                     ""))[:9]
            breakers = (block.get("fault") or {}).get("breakers") or {}
            n_open = sum(1 for b in breakers.values()
                         if isinstance(b, dict)
                         and b.get("state") == "open")
            wal = block.get("wal") or {}
            wal_col = ("ok" if not wal.get("oldestDirtyAgeS")
                       or wal["oldestDirtyAgeS"] < 1.0 else
                       f"{wal['oldestDirtyAgeS']:.0f}s")
            infl = (block.get("admission") or {}).get("inFlight", 0)
            resize = (block.get("resize") or {}).get("phase", "idle")
            lines.append(f"{host:<24}{'up':>6}{ver:>10}{n_open:>6}"
                         f"{wal_col:>6}{infl:>6}{resize:>10}")
    return "\n".join(lines) + "\n"


def cmd_top(args, stdout, stderr) -> int:
    """The CLI entry point (registered in commands.py)."""
    host = args.host
    interval = max(0.2, float(getattr(args, "interval", 2.0) or 2.0))
    window = getattr(args, "window", "") or "10m"
    try:
        cur = Snapshot(host, history_window=window)
    except Exception as e:  # noqa: BLE001 - CLI-facing error
        print(f"top: cannot reach {host}: {e}", file=stderr)
        return 1
    if getattr(args, "once", False):
        stdout.write(render(cur, None))
        return 0

    import select
    import sys
    prev: Optional[Snapshot] = None
    show_nodes = True
    paused = False
    poll_keys = True   # latched off at stdin EOF (closed pipe)
    # Raw-ish single-key input when stdin is a tty; plain polling
    # otherwise (pipes, tests).
    tty_fd = None
    old_attrs = None
    try:
        import termios
        import tty as tty_mod
        if sys.stdin.isatty():
            tty_fd = sys.stdin.fileno()
            old_attrs = termios.tcgetattr(tty_fd)
            tty_mod.setcbreak(tty_fd)
    except Exception:  # noqa: BLE001 - keys are a convenience
        tty_fd = None
    try:
        while True:
            stdout.write("\x1b[2J\x1b[H")   # clear + home
            stdout.write(render(cur, prev, show_nodes=show_nodes,
                                paused=paused))
            stdout.write("\n[q]uit  [p]ause  [n]odes\n")
            if hasattr(stdout, "flush"):
                stdout.flush()
            deadline = time.monotonic() + interval
            while True:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                if not poll_keys:
                    # Stdin hit EOF (closed pipe): select() reports
                    # an EOF stream always-readable and read('')
                    # would busy-spin — just sleep out the interval.
                    time.sleep(wait)
                    break
                try:
                    ready, _, _ = select.select([sys.stdin], [], [],
                                                wait)
                except (OSError, ValueError):
                    time.sleep(wait)
                    break
                if not ready:
                    break
                key = sys.stdin.read(1)
                if not key:   # EOF mid-session: stop polling keys
                    poll_keys = False
                    continue
                if key in ("q", "Q"):
                    return 0
                if key in ("p", "P"):
                    paused = not paused
                if key in ("n", "N"):
                    show_nodes = not show_nodes
            if paused:
                continue
            try:
                prev, cur = cur, Snapshot(host, history_window=window)
            except Exception as e:  # noqa: BLE001 - keep the last frame
                print(f"top: poll failed: {e}", file=stderr)
    except KeyboardInterrupt:
        return 0
    finally:
        if tty_fd is not None and old_attrs is not None:
            import termios
            termios.tcsetattr(tty_fd, termios.TCSADRAIN, old_attrs)
