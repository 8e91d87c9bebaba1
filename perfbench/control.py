"""The control of a cell's comparison: the reference's control put in
the program's place, judged by the run's own comparison.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3
                                 [--requests N]

For each seed: the cell's data at its own size, and the first requests
of every client's window stream, as many as ``--requests`` in all (a
run's count); each answered by the control (``Reference.answer(...,
control=True)``: Count over every slice but the last, TopN from its
first phase alone) and compared with the reference's answer as a run
compares the program's. Prints one JSON line a seed with the
``wrong_answers`` reading. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import datagen, run, traffic  # noqa: E402


def readings(cell: dict, seed: int, n_requests: int, device: str,
             cfg: dict = None) -> dict:
    from perfbench import reference
    cfg = cfg or datagen.load(cell["config"])
    mix = traffic.load(cell["traffic"])
    data = datagen.make(cfg, seed)
    rows = datagen.frame_rows(cfg)
    ref = reference.Reference(cfg, data, device)
    n_clients = int(mix["clients"])
    wrong = total = 0
    for ci in range(n_clients):
        share = n_requests // n_clients + (ci < n_requests % n_clients)
        for _pql, tree in traffic.Stream(mix, rows, seed, ci).take(share):
            total += 1
            if ([ref.answer(c, control=True) for c in tree]
                    != [ref.answer(c) for c in tree]):
                wrong += 1
    return {"cell": cell["name"], "seed": seed, "requests": total,
            "wrong_answers": wrong, "limit": 0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--requests", type=int, default=400)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cell = {w["name"]: w for w in run.load_spec()["workloads"]}[a.workload]
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.monotonic()
        out = readings(cell, seed, a.requests, a.device)
        out["seconds"] = time.monotonic() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
