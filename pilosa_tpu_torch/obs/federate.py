"""Cluster-wide metric federation: aggregate at query time, not at
write time.

Copy of the JAX package's ``obs/federate.py``. Each node keeps its own
registry; a fleet question fans out when it is asked:

- ``GET /metrics/cluster`` — the coordinator scrapes every peer's
  ``/metrics`` in bounded parallel over the pooled client
  (breaker-aware: a dead peer's open circuit fails the leg fast
  instead of paying the timeout again; per-peer deadline otherwise),
  parses the 0.0.4 exposition, and merges: **counters sum** across
  nodes, **histograms merge** (bucket/sum/count sums per label set),
  **gauges stay per-node** labeled ``{node="host"}``.
- ``GET /debug/cluster`` — the same fan-out over each node's local
  debug block (build info, epoch, breaker states, WAL flusher health,
  resize phase), with a version-skew verdict.

Partial semantics follow the ``?partial=1`` contract: without it, an
unreachable peer fails the whole request (503); with it, the merge
serves what answered and names the missing nodes in
``X-Pilosa-Partial-Nodes``. The third fan-out,
``/debug/metrics/history?scope=cluster`` (and the capture export's
``?scope=cluster``), goes through the same ``fan_out``.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Optional

from . import metrics as obs_metrics

DEFAULT_PEER_TIMEOUT_S = 2.0
DEFAULT_FANOUT = 8

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\",?)*)\})?"
    r"\s+(NaN|[-+]?(?:[0-9.eE+-]+|Inf))"
    r"(?:\s+[0-9.]+)?$")
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SUFFIX_RE = re.compile(r"_(bucket|sum|count)$")


def unescape_label_value(v: str) -> str:
    """Inverse of the exposition renderer's label-value escaping
    (``\\\\`` → ``\\``, ``\\"`` → ``"``, ``\\n`` → newline)."""
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "n":
                out.append("\n")
            elif nxt in ("\\", '"'):
                out.append(nxt)
            else:  # unknown escape: keep both chars (promtext rule)
                out.append(c)
                out.append(nxt)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def parse_exposition(text: str) -> dict:
    """Prometheus text format 0.0.4 → ``{family: {"type": t, "help":
    h, "samples": [(sample_name, labels_dict, float_value)]}}`` with
    label values UNESCAPED back to their true strings. Unparseable
    lines are skipped (a federating coordinator must tolerate a peer
    one version ahead), unknown families default to untyped."""
    families: dict = {}

    def fam_for(name: str) -> dict:
        base = _SUFFIX_RE.sub("", name)
        fam = families.get(base)
        if fam is None and base != name:
            fam = families.get(name)
            base = name if fam is not None else base
        if fam is None:
            fam = families.setdefault(
                base, {"type": "untyped", "help": "", "samples": []})
        return fam

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            try:
                name, typ = line[len("# TYPE "):].split()
            except ValueError:
                continue
            families.setdefault(
                name, {"type": typ, "help": "", "samples": []})[
                "type"] = typ
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            # Unescape back to the true string — render_merged
            # re-escapes, and a still-escaped stored form would
            # double-escape on every federation hop.
            families.setdefault(
                name, {"type": "untyped", "help": "", "samples": []})[
                "help"] = unescape_label_value(help_text)
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, rawlabels, rawvalue = m.group(1), m.group(2), m.group(3)
        labels = {k: unescape_label_value(v)
                  for k, v in _LABEL_RE.findall(rawlabels or "")}
        try:
            value = float(rawvalue)
        except ValueError:
            continue
        fam_for(name)["samples"].append((name, labels, value))
    return families


# -- merging -------------------------------------------------------------------


def merge_node_families(per_node: dict[str, dict]) -> dict:
    """{node: parse_exposition(...)} → one merged family dict.
    Counters and histogram components sum per identical label set;
    gauges (and untyped) get a ``node`` label per source node."""
    merged: dict = {}
    for node in sorted(per_node):
        for name, fam in per_node[node].items():
            out = merged.setdefault(
                name, {"type": fam["type"], "help": fam.get("help", ""),
                       "samples": {}})
            if fam["type"] != "untyped":
                out["type"] = fam["type"]
            summed = out["type"] in ("counter", "histogram")
            for sample_name, labels, value in fam["samples"]:
                if summed:
                    key = (sample_name,
                           tuple(sorted(labels.items())))
                    cur = out["samples"].get(key)
                    out["samples"][key] = (value if cur is None
                                           else cur + value)
                else:
                    key = (sample_name, tuple(
                        sorted({**labels, "node": node}.items())))
                    out["samples"][key] = value
    return merged


def render_merged(merged: dict) -> str:
    """Merged families back to 0.0.4 exposition text."""
    lines = []
    for name in sorted(merged):
        fam = merged[name]
        if fam.get("help"):
            lines.append(f"# HELP {name} "
                         + obs_metrics.escape_help(fam["help"]))
        lines.append(f"# TYPE {name} {fam['type']}")
        for (sample_name, labels), value in sorted(
                fam["samples"].items(), key=lambda kv: kv[0]):
            if labels:
                lab = ",".join(
                    f'{k}="{obs_metrics.escape_label_value(str(v))}"'
                    for k, v in labels)
                lines.append(f"{sample_name}{{{lab}}}"
                             f" {obs_metrics.format_value(value)}")
            else:
                lines.append(
                    f"{sample_name} {obs_metrics.format_value(value)}")
    return "\n".join(lines) + "\n"


class Federator:
    """The coordinator side: bounded parallel fan-out of one scrape
    function over the peer set, with the local node answered
    in-process (no self-scrape over HTTP)."""

    def __init__(self, host: str, cluster=None,
                 client_for: Optional[Callable] = None,
                 peer_timeout_s: float = DEFAULT_PEER_TIMEOUT_S,
                 fanout: int = DEFAULT_FANOUT):
        self.host = host
        self.cluster = cluster
        self.client_for = client_for
        self.peer_timeout_s = float(peer_timeout_s)
        self.fanout = max(1, int(fanout))

    def peers(self) -> list[str]:
        if self.cluster is None:
            return []
        return [n.host for n in self.cluster.nodes
                if n.host != self.host]

    def fan_out(self, fetch: Callable[[str], object],
                local: Callable[[], object]
                ) -> tuple[dict[str, object], list[str]]:
        """``{host: result}`` for every reachable node (the local
        result computed in-process) plus the list of unreachable
        hosts. Each remote leg is bounded by the per-peer timeout and
        the target's circuit breaker; legs run on a bounded pool so a
        large fleet cannot explode thread count."""
        from concurrent.futures import ThreadPoolExecutor
        peers = self.peers()
        results: dict[str, object] = {}
        missing: list[str] = []
        mu = threading.Lock()

        def leg(host: str) -> None:
            try:
                got = fetch(host)
            except Exception:  # noqa: BLE001 - leg outcome recorded
                obs_metrics.FEDERATION_SCRAPES.labels(
                    host, "error").inc()
                with mu:
                    missing.append(host)
                return
            obs_metrics.FEDERATION_SCRAPES.labels(host, "ok").inc()
            with mu:
                results[host] = got

        if peers:
            with ThreadPoolExecutor(
                    max_workers=min(self.fanout, len(peers))) as tp:
                list(tp.map(leg, peers))
        try:
            results[self.host] = local()
        except Exception:  # noqa: BLE001 - local side best-effort too
            missing.append(self.host)
        return results, sorted(missing)
