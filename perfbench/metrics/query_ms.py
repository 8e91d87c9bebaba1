"""The server's mean query time over the window: the change of
``pilosa_query_duration_seconds`` sum over its count (executor.py's
parse, admission and execution, as the handler times them)."""

from perfbench import scrape


def read(rec):
    s = scrape.delta(rec, "pilosa_query_duration_seconds_sum")
    n = scrape.delta(rec, "pilosa_query_duration_seconds_count")
    return s / n * 1e3 if s is not None and n else None
