"""HTTP front time: the clients' mean latency of the window's answered
requests minus the server's mean query time (``query_ms``): the
request's read and parse by server/httpd.py, the answer's encode and
write, and the loopback."""

from perfbench import scrape


def read(rec):
    ok = [r for r in rec["reqs"] if r["ok"]]
    s = scrape.delta(rec, "pilosa_query_duration_seconds_sum")
    n = scrape.delta(rec, "pilosa_query_duration_seconds_count")
    if not ok or s is None or not n:
        return None
    client = sum(r["t_recv"] - r["t_send"] for r in ok) / len(ok)
    return (client - s / n) * 1e3
