"""Host-clock ms of the plans' `group_by` stages (compute/groupby.py),
synchronized at each stage's start and end, summed over the first traced
part and divided by its answered queries."""


def read(t):
    ms = [m for _, stage, m in t.spans if stage == "group_by"]
    if not ms or not t.span_queries:
        return None
    return sum(ms) / t.span_queries
