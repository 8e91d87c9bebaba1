"""Planner seconds per query of the window: the change of
``pilosa_planner_plan_seconds`` sum over the window's requests."""

from perfbench import scrape


def read(rec):
    s = scrape.delta(rec, "pilosa_planner_plan_seconds_sum")
    n = scrape.delta(rec, "pilosa_planner_plan_seconds_count")
    if s is None or not n or not rec["reqs"]:
        return None
    return s / len(rec["reqs"]) * 1e3
