"""Share of the traced stretch in which no device operation ran: one
minus the union of the trace's kernel, copy and set intervals."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
