"""Mean admission wait per request (sched/admission.py): ``queueWaitMs``
of the per-stage profile each traced request asks for (``?profile=1``;
the X-Pilosa-Stats roll-up does not carry the stages)."""


def read(rec):
    waits = [r["profile"]["queueWaitMs"] for r in rec["reqs"]
             if r.get("profile") and "queueWaitMs" in r["profile"]]
    return sum(waits) / len(waits) if waits else None
