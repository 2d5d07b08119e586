"""Device->host reads of the port's operators (its `host_read` spans:
the join's size read, the group-by's count and results, a filter's
count, a sort's permutation, a column brought to the host, a reduction's
result), counted in the profiled part and divided by its answered
queries; the reads by site, and by query instance, go to the log.
Nothing where the program recorded no read there."""
from collections import Counter

from portbench.harness import program


def read(t):
    snap = program.snapshot(t)
    if snap is None or not t.profile_queries:
        return None
    reads = [r for r in snap.spans if r.kind == "host_read"]
    if not reads:
        return None
    by_site = Counter(r.name for r in reads)
    t.log("host reads per query by site: " + ", ".join(
        f"{k} {n / t.profile_queries:.3f}" for k, n in by_site.most_common()))
    t.log("host reads per instance by query: "
          + program.per_instance(reads, t.trace.marks, amount=False))
    return len(reads) / t.profile_queries
