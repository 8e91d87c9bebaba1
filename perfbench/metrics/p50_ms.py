"""Median client latency of every request sent in the window."""

from perfbench import stats


def read(rec):
    return stats.latency_quantile_ms(rec["reqs"], 0.50)
