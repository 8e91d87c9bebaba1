"""95th percentile client latency of every request of the traced
window, the tail of ``c4_segments.intersect_batch``: its runs spread too
far for an end-to-end bound (PERF.md, section 2)."""

from perfbench import stats


def read(rec):
    return stats.latency_quantile_ms(rec["reqs"], 0.95)
