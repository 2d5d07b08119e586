"""Rows x stable key passes of the port's device sorts (its `sort`
counter: ops/sort.py's lexsort_stable, group_by's first-occurrence
argsort), counted in the profiled part and divided by its answered
queries; the rows by query instance go to the log. Nothing where the
program counted no sort there."""
from portbench.harness import program


def read(t):
    snap = program.snapshot(t)
    if snap is None or not t.profile_queries:
        return None
    sorts = program.counted(snap.spans, "sort")
    if not sorts:
        return None
    t.log("sorted rows x passes per instance by query: "
          + program.per_instance(sorts, t.trace.marks, amount=True))
    return sum(r.amount for r in sorts) / t.profile_queries
