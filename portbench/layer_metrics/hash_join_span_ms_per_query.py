"""Stream-elapsed ms of the port's own `hash_join` and `semi_verdict`
spans (compute/join.py), the outermost of them only, summed over the
profiled part and divided by its answered queries; the phases' ms go to
the log. A span's CUDA events (no synchronize) time the stream from its
first launch to its end, idle gaps included, under the profiler: the
device's work where the joins keep it busy, the profiled dispatch where
the host paces them. Nothing where the program recorded no such span
with CUDA events."""
from portbench.harness import program


def read(t):
    snap = program.snapshot(t)
    if snap is None or not t.profile_queries:
        return None
    ms = [r.device_ms for r in program.outermost(
        snap.spans, ("hash_join", "semi_verdict"))
        if r.device_ms is not None]
    if not ms:
        return None
    program.phases_ms(t, snap.spans, "hash_join")
    return sum(ms) / t.profile_queries
