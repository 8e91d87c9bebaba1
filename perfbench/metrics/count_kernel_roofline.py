"""The expression-count kernels' share of their bound (ops/csrc/
expr_count.cu, single and batched entries), against the card's HBM
peak (perfbench/peaks.py).

Numerator: the least time of the bytes the requests need, reckoned by
the benchmark from each request it sent: distinct leaf rows x slices x
131,072 B, each leaf read once whether a single or a batched entry
runs, over the requests answered wholly inside the traced stretch that
launched a device program. Denominator: the summed device time of the
``expr_count_kernel`` operations in the stretch's trace, which holds
every kernel of those requests and perhaps some of their neighbours',
so the share is never counted high."""

from perfbench import peaks

KERNEL = "expr_count_kernel"


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    k_s = sum(v for name, v in tr["device_s"].items() if KERNEL in name)
    inside = [r for r in rec["reqs"]
              if r["ok"] and r.get("stats")
              and r["stats"].get("devicePrograms", 0) > 0
              and r["t_send"] >= tr["t_start"] and r["t_recv"] <= tr["t_stop"]]
    if k_s <= 0 or not inside:
        return None
    need = sum(peaks.count_bytes(r["leaves"], rec["n_slices"])
               for r in inside)
    return 100.0 * need / peaks.HBM_BYTES_PER_S / k_s
