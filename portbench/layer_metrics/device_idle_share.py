"""The share of the profiled part's wall time in which no operation ran
on the device: 1 - busy / wall, busy the union of every device
activity's interval (kernels, copies, fills), in percent."""


def read(t):
    if t.trace.wall_s <= 0 or not t.trace.ops:
        return None
    return 100.0 * (1.0 - t.trace.busy_s / t.trace.wall_s)
