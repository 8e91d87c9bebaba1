"""Each cell end to end on the CPU at a tiny size: the program's server
(pilosa_tpu_torch, on the CPU) against the plain reference, and the
same run with the program broken underneath, which must read not
correct."""

import pytest

from perfbench import run
from perfbench.tests.sizes import tiny

SPEC = run.load_spec()
CELLS = {w["name"]: w for w in SPEC["workloads"]}
# Mixes and configurations kept for cells a later change adds (PERF.md,
# Open questions): their reference is held to the program here too.
for _cfg, _mix in (("c4_segments", "wide_count"), ("c4_segments", "dashboard"),
                   ("c4_segments", "intersect_count"),
                   ("c3_topn", "filtered_topn")):
    CELLS.setdefault(f"{_cfg}.{_mix}", {"name": f"{_cfg}.{_mix}",
                                         "config": _cfg, "traffic": _mix,
                                         "chips": 1})
SECONDS = 1.5


def _run(name, seed, trace=False):
    cell = CELLS[name]
    return run.run_cell(cell, seed, SECONDS, trace, SPEC, device="cpu",
                        cfg=tiny(cell["config"]))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_is_correct_on_the_cpu(name):
    out = _run(name, 2**31 + 17)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in run.cell_metrics(SPEC, name, False)
            if "workloads" not in m}
    assert want <= set(out["metrics"])
    assert list(out)[-1] == "checks"


def test_traced_run_reports_the_program_counters():
    out = _run("c4_segments.intersect_batch", 5, trace=True)
    assert out["correct"]
    for name in ("front_ms", "query_ms", "plan_ms", "queue_wait_ms",
                 "launches_per_query", "device_idle_share"):
        assert name in out["metrics"], name
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _alter_first_answer(results):
    r = results[0]
    if isinstance(r, int):
        results[0] = r + 1
    elif isinstance(r, list) and r:
        r[0].count += 1
    return results


def _leave_out_half(results):
    half = len(results) // 2
    return results[:half] + results[:len(results) - half]


@pytest.mark.parametrize("name,fault", [
    ("c4_segments.wide_count", _alter_first_answer),
    ("c3_topn.filtered_topn", _alter_first_answer),
    ("c4_segments.dashboard", _alter_first_answer),
    ("c4_segments.dashboard", _leave_out_half),
    ("c4_segments.intersect_batch", _alter_first_answer),
    ("c4_segments.intersect_batch", _leave_out_half),
], ids=["wide_count-altered", "filtered_topn-altered",
        "dashboard-altered", "dashboard-half-left-out",
        "intersect_batch-altered", "intersect_batch-half-left-out"])
def test_a_broken_program_reads_not_correct(monkeypatch, name, fault):
    from pilosa_tpu_torch.executor import Executor
    orig = Executor.execute

    def broken(self, index, query, *args, **kwargs):
        results = orig(self, index, query, *args, **kwargs)
        if index == tiny(CELLS[name]["config"])["index"] and any(
                getattr(c, "name", "") in ("Count", "TopN")
                for c in getattr(query, "calls", [])):
            return fault(list(results))
        return results

    monkeypatch.setattr(Executor, "execute", broken)
    out = _run(name, 4242)
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0
