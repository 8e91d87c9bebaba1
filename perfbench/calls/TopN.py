"""``TopN(<filter>, frame=F, n=N)``: the N rows of F with the most
columns in the filter, by reference Pilosa's two phases (the rank walk
of each slice's cache, then the exact counts of the union of the
candidates; ``reference.RankedFrame``). F's ``cacheType`` must be
``ranked``. ``n`` may be a ``choose`` node.

The control stops after the first phase.
"""


def draw(node, d):
    return ("TopN", d.at("a").expr(node["arg"]), node["frame"],
            int(d.at("n").resolve(node["n"])))


def pql(t, pql):
    return f"TopN({pql(t[1])}, frame={t[2]}, n={t[3]})"


def exprs(t):
    return [t[1]]


def parse(result):
    if not isinstance(result, list):
        return result
    return [[p.get("id"), p.get("count")] if isinstance(p, dict) else p
            for p in result]


def answer(ref, t, control=False):
    _, expr, frame, n = t
    return ref.ranked(frame).top(ref.column_mask(expr), n,
                                 phase1_only=control)
