"""The window's arithmetic over every request, with no statistic taken
from medians of chunks.

A request is sent inside the window when its send time lies in
[t0, t1). Every such request counts: the rate is the answered ones
over the time from t0 to the last answer, so a stall inside the window
lowers it, and a latency quantile is taken over all of them, a failed
or refused request counted above every answered one (it misses every
latency limit).
"""

from __future__ import annotations

import math


def quantile(values: list, q: float) -> float:
    """The nearest-rank q-quantile: the ceil(q * n)-th smallest value."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def latencies_ms(reqs: list) -> list:
    """Client latency of every request, in ms; a failed one reads the
    largest answered latency plus the window, above all of them."""
    ok = [(r["t_recv"] - r["t_send"]) * 1e3 for r in reqs if r["ok"]]
    top = max(ok, default=0.0)
    span = (max(r["t_recv"] for r in reqs) - min(r["t_send"] for r in reqs)
            ) * 1e3 if reqs else 0.0
    return ok + [top + span] * sum(1 for r in reqs if not r["ok"])


def rate_per_s(reqs: list, t0: float) -> float:
    """Answered requests over the time from t0 to the last answer."""
    answered = [r for r in reqs if r["ok"]]
    if not answered:
        return 0.0
    return len(answered) / (max(r["t_recv"] for r in reqs) - t0)


def latency_quantile_ms(reqs: list, q: float):
    """The q-quantile of every request's latency (``latencies_ms``), or
    None with no request."""
    lat = latencies_ms(reqs)
    return quantile(lat, q) if lat else None
