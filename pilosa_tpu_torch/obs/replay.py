"""Deterministic workload replay + shadow diff (obs.capture consumers).

The engine behind ``pilosa-tpu replay`` (copy of the JAX package's):
re-issues a captured (or merged multi-node) record stream against any
cluster as a **multi-process open-loop load generator** — each record
fires at its recorded arrival offset (scaled by ``--rate xN``) regardless of
completions, so queueing delay shows up as latency exactly like the
live traffic it was recorded from. Tenant headers, lanes, and the
effective ``?timeout=``/``?partial=`` options replay verbatim;
latency counts from the SCHEDULED send time (open-loop accounting,
the latency_under_load.py discipline).

Records with ``kind == "import"`` mark state mutations whose payload
the capture ring does not hold (only the ack is recorded); replay
counts them as skipped — bulk loads re-drive via the import tool.

Shadow mode replays the same stream against a baseline AND a candidate
endpoint: write queries go to both **in order** first (state must
converge before reads compare), then reads fire at both concurrently
and the canonical result digests (X-Pilosa-Result-Digest, recomputed
from the body when the header is absent) are compared. Mismatches
report the plan fingerprint — the /debug/plans key on both sides —
and full result dumps for the first K.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from . import capture as obs_capture

# Statuses that count as load shedding (not errors): admission 429,
# cost-policy kill 402, write-unready 507.
SHED_STATUSES = (429, 402, 507)

DEFAULT_SENDERS = 32


# -- record sources -----------------------------------------------------------


def load_records(path: str) -> list[dict]:
    """Records from a file: JSONL (one record per line) or a JSON
    document carrying a ``records`` list (the /debug/capture/records
    response shape, saved verbatim)."""
    with open(path) as f:
        text = f.read()
    text = text.strip()
    if not text:
        return []
    try:
        doc = json.loads(text)
    except ValueError:
        # JSONL: one record per line (a ring segment saved verbatim).
        return [json.loads(line) for line in text.splitlines() if line]
    if isinstance(doc, list):
        return doc
    return doc.get("records", [])


def fetch_records(host: str, since: int = 0, limit: int = 10000,
                  cluster: bool = False,
                  timeout: float = 30.0) -> list[dict]:
    """Records exported live from a node's /debug/capture/records
    (``cluster=True`` asks for the merged cluster scope)."""
    params = {"since": since, "limit": limit}
    if cluster:
        params["scope"] = "cluster"
    url = (f"http://{host}/debug/capture/records?"
           + urllib.parse.urlencode(params))
    with urllib.request.urlopen(url, timeout=timeout) as r:
        doc = json.loads(r.read())
    return doc.get("records", [])


def schedule(records: list[dict], rate: float = 1.0) -> list[float]:
    """Send offsets (seconds from replay start) preserving the
    recorded inter-arrival gaps, compressed by ``rate`` (x2 = half
    the gaps)."""
    rate = max(rate, 1e-9)
    return [off / rate
            for off in obs_capture.arrival_offsets(records)]


# -- one request --------------------------------------------------------------


def _issue(host: str, rec: dict, timeout_s: float = 30.0,
           want_results: bool = False) -> dict:
    """Re-issue one captured query record; returns
    ``{"status", "digest", "latS", "results"?}``. Network errors map
    to status 0."""
    params = dict(rec.get("opts") or {})
    if params.get("partial") is True:
        params["partial"] = "1"
    path = f"/index/{rec.get('index', '')}/query"
    if params:
        path += "?" + urllib.parse.urlencode(params)
    headers = {}
    if rec.get("tenant"):
        headers["X-Pilosa-Tenant"] = rec["tenant"]
    req = urllib.request.Request(
        f"http://{host}{path}", data=rec.get("pql", "").encode(),
        method="POST", headers=headers)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            body = r.read()
            digest = r.headers.get(obs_capture.DIGEST_HEADER, "")
            status = r.status
    except urllib.error.HTTPError as e:
        e.read()
        return {"status": e.code, "digest": "",
                "latS": time.perf_counter() - t0}
    except OSError:
        return {"status": 0, "digest": "",
                "latS": time.perf_counter() - t0}
    out = {"status": status, "digest": digest,
           "latS": time.perf_counter() - t0}
    if want_results or not digest:
        try:
            results = json.loads(body).get("results", [])
        except ValueError:
            results = None
        if results is not None:
            if not digest:
                out["digest"] = obs_capture.result_digest(results)
            if want_results:
                out["results"] = results
    return out


# -- the open-loop shard (one process) ----------------------------------------


def _replay_shard(args: tuple) -> list[dict]:
    """Open-loop replay of one shard: (records, offsets, host,
    t0_wall, senders). Runs in a worker process (or inline) and
    returns per-record outcomes ``{"lane", "status", "latS",
    "lateS"}``. Latency counts from the SCHEDULED time."""
    records, offsets, host, t0_wall, senders = args
    outcomes: list[Optional[dict]] = [None] * len(records)
    mu = threading.Lock()
    ticket = {"i": 0}

    def sender():
        while True:
            with mu:
                i = ticket["i"]
                if i >= len(records):
                    return
                ticket["i"] = i + 1
            scheduled = t0_wall + offsets[i]
            delay = scheduled - time.time()
            if delay > 0:
                time.sleep(delay)
            rec = records[i]
            if rec.get("kind") != "query":
                outcomes[i] = {"lane": rec.get("lane", "write"),
                               "status": -1, "latS": 0.0,
                               "lateS": 0.0}
                continue
            res = _issue(host, rec)
            # Open-loop accounting: sender-pool delay is latency.
            late = max(0.0, time.time() - scheduled - res["latS"])
            outcomes[i] = {"lane": rec.get("lane", "read"),
                           "status": res["status"],
                           "latS": res["latS"] + late,
                           "lateS": late}

    threads = [threading.Thread(target=sender)
               for _ in range(max(1, min(senders, len(records))))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [o for o in outcomes if o is not None]


def _percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1,
            max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def _summarize(outcomes: list[dict], offered_qps: float,
               wall_s: float) -> dict:
    """Per-lane p50/p99 + shed rates + achieved-vs-offered QPS over
    the flattened shard outcomes."""
    lanes: dict[str, dict] = {}
    completed = shed = errors = skipped = 0
    for o in outcomes:
        if o["status"] == -1:
            skipped += 1
            continue
        lane = lanes.setdefault(o["lane"],
                                {"lats": [], "shed": 0, "errors": 0})
        if o["status"] == 200:
            completed += 1
            lane["lats"].append(o["latS"])
        elif o["status"] in SHED_STATUSES:
            shed += 1
            lane["shed"] += 1
        else:
            errors += 1
            lane["errors"] += 1
    per_lane = {}
    for lane, st in sorted(lanes.items()):
        lats = sorted(st["lats"])
        n = len(lats) + st["shed"] + st["errors"]
        per_lane[lane] = {
            "sent": n, "completed": len(lats),
            "shed": st["shed"], "errors": st["errors"],
            "shed_rate": round(st["shed"] / n, 4) if n else 0.0,
            "p50_ms": round(_percentile(lats, 50) * 1e3, 3),
            "p99_ms": round(_percentile(lats, 99) * 1e3, 3),
        }
    return {
        "offered": len(outcomes) - skipped,
        "completed": completed, "shed": shed, "errors": errors,
        "skipped_imports": skipped,
        "offered_qps": round(offered_qps, 1),
        "achieved_qps": round(completed / wall_s, 1) if wall_s else 0.0,
        "wall_s": round(wall_s, 3),
        "lanes": per_lane,
    }


def replay(records: list[dict], host: str, rate: float = 1.0,
           processes: int = 1, senders: int = DEFAULT_SENDERS) -> dict:
    """Multi-process open-loop replay of ``records`` against ``host``.
    Shards round-robin across ``processes`` worker processes sharing
    one wall-clock t0 (``processes=1`` runs inline — the test path,
    fork-free). Returns the summary dict (REPLAY.json's ``replay``
    block)."""
    records = [r for r in records if r.get("kind") in
               ("query", "import")]
    if not records:
        return _summarize([], 0.0, 0.0)
    offsets = schedule(records, rate)
    span_s = max(offsets[-1], 1e-6)
    n_q = sum(1 for r in records if r.get("kind") == "query")
    offered_qps = n_q / span_s
    processes = max(1, int(processes))
    shards: list[tuple] = []
    t0_wall = time.time() + 0.25  # let every process reach the gate
    for p in range(processes):
        recs = records[p::processes]
        offs = offsets[p::processes]
        if recs:
            shards.append((recs, offs, host, t0_wall, senders))
    wall_t0 = time.perf_counter()
    if len(shards) == 1:
        results = [_replay_shard(shards[0])]
    else:
        import multiprocessing as mp
        with mp.get_context("fork").Pool(len(shards)) as pool:
            results = pool.map(_replay_shard, shards)
    wall_s = time.perf_counter() - wall_t0
    outcomes = [o for shard in results for o in shard]
    out = _summarize(outcomes, offered_qps, wall_s)
    out["rate"] = rate
    out["processes"] = len(shards)
    return out


# -- shadow diff --------------------------------------------------------------


def shadow(records: list[dict], baseline: str, candidate: str,
           max_dumps: int = 8,
           senders: int = DEFAULT_SENDERS) -> dict:
    """Differential replay: write queries go to BOTH endpoints in
    recorded order (sequentially — state must converge), then each
    read fires at both concurrently and the canonical digests are
    compared. Returns mismatch rate + the first ``max_dumps``
    mismatches with full result dumps and plan fingerprints."""
    writes = [r for r in records if r.get("kind") == "query"
              and r.get("lane") != "read"]
    reads = [r for r in records if r.get("kind") == "query"
             and r.get("lane") == "read"]
    for rec in writes:
        _issue(baseline, rec)
        _issue(candidate, rec)

    compared = [0]
    mismatches: list[dict] = []
    mu = threading.Lock()
    ticket = {"i": 0}

    def check(rec: dict) -> None:
        pair: dict = {}

        def side(name: str, host: str) -> None:
            pair[name] = _issue(host, rec, want_results=True)

        tb = threading.Thread(target=side, args=("baseline", baseline))
        tc = threading.Thread(target=side,
                              args=("candidate", candidate))
        tb.start(); tc.start(); tb.join(); tc.join()
        b, c = pair["baseline"], pair["candidate"]
        if b["status"] != 200 or c["status"] != 200:
            return
        with mu:
            compared[0] += 1
            if b["digest"] != c["digest"]:
                entry = {"seq": rec.get("seq"),
                         "pql": rec.get("pql", ""),
                         "index": rec.get("index", ""),
                         "plan": rec.get("plan", ""),
                         "recordedDigest": rec.get("digest", ""),
                         "baselineDigest": b["digest"],
                         "candidateDigest": c["digest"]}
                if len(mismatches) < max_dumps:
                    entry["baselineResults"] = b.get("results")
                    entry["candidateResults"] = c.get("results")
                mismatches.append(entry)

    def sender():
        while True:
            with mu:
                i = ticket["i"]
                if i >= len(reads):
                    return
                ticket["i"] = i + 1
            check(reads[i])

    threads = [threading.Thread(target=sender)
               for _ in range(max(1, min(senders, len(reads) or 1)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    n = compared[0]
    return {
        "baseline": baseline, "candidate": candidate,
        "writes_replayed": len(writes), "reads_compared": n,
        "mismatches": len(mismatches),
        "mismatch_rate": round(len(mismatches) / n, 4) if n else 0.0,
        "dumps": mismatches[:max_dumps],
    }
