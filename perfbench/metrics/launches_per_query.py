"""Device programs per request: ``devicePrograms`` of each answer's
X-Pilosa-Stats (parallel/mesh.py's launches), over the window."""


def read(rec):
    st = [r["stats"] for r in rec["reqs"] if r.get("stats")]
    if not st:
        return None
    return sum(s.get("devicePrograms", 0) for s in st) / len(st)
