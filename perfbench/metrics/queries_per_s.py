"""Answered requests of the window over the time from its start to the
last answer (a multi-call body is one query)."""

from perfbench import stats


def read(rec):
    return stats.rate_per_s(rec["reqs"], rec["t0"]) if rec["reqs"] else None
