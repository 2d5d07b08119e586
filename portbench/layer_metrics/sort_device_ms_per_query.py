"""Device ms of the sort kernels (the names torch.profiler gives them:
cub's DeviceRadixSort* and DeviceSegmentedRadixSort*, torch's own sort
kernels; every name with "sort" in it) over the profiled part, divided
by its answered queries."""


def read(t):
    s = sum(d for name, _, d in t.trace.ops if "sort" in name.lower())
    if not s or not t.profile_queries:
        return None
    return s / 1e3 / t.profile_queries
