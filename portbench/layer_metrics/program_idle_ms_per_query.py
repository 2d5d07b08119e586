"""Device idle ms while the port's own code runs: the gaps between
device activities (DeviceTrace.idle_by_stage's arithmetic) that open
while one of the port's spans is open, summed over the profiled part
and divided by its answered queries. The ten longest idle totals by the
innermost span open go to the log. Nothing where the program recorded
no span, or the trace no device activity."""
from portbench.harness import program


def read(t):
    snap = program.snapshot(t)
    if snap is None or not t.profile_queries or not t.trace.ops:
        return None
    idle = program.idle_by_span(snap.spans, t.trace.ops)
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    t.log("device idle s by the innermost program span: " + ", ".join(
        f"{name} {s:.4f}" for name, s in top))
    return sum(idle.values()) * 1e3 / t.profile_queries
