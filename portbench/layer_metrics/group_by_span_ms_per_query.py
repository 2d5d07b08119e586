"""Stream-elapsed ms of the port's own `group_by` spans
(compute/groupby.py), the outermost of them only, summed over the
profiled part and divided by its answered queries; the phases' ms go to
the log. A span's CUDA events (no synchronize) time the stream from its
first launch to its end, idle gaps included, under the profiler: where
the host paces the group-by (the join and star cells) this reads the
profiled dispatch, not the device's work, and above the stage marks.
Nothing where the program recorded no such span with CUDA events."""
from portbench.harness import program


def read(t):
    snap = program.snapshot(t)
    if snap is None or not t.profile_queries:
        return None
    ms = [r.device_ms for r in program.outermost(snap.spans, ("group_by",))
          if r.device_ms is not None]
    if not ms:
        return None
    program.phases_ms(t, snap.spans, "group_by")
    return sum(ms) / t.profile_queries
