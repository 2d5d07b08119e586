"""Host-clock ms of the plans' `hash_join` stages (the joins and the
semi verdict, compute/join.py), synchronized at each stage's start and
end, summed over the first traced part and divided by its answered
queries. Nothing where no plan of the cell joins."""


def read(t):
    ms = [m for _, stage, m in t.spans if stage == "hash_join"]
    if not ms or not t.span_queries:
        return None
    return sum(ms) / t.span_queries
