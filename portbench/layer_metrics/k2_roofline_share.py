"""K2's share of its roofline (csrc/scan.cu), in percent: the least
time of its launches in the profiled part over the device time of its
kernels there (cummax_kernel).

A launch's least bytes are the port's own count (`kernel.K2` in
utils/metrics.py, ops/scan.least_bytes: the hi lane and each lo lane, n
int64 each, read once and written once), over the H100's 3.35e12 B/s
(NVIDIA's data sheet, SXM). Where the program counted another number of
launches than the profiler traced kernels, nothing is reported."""
from portbench.harness import program

HBM_BYTES_PER_S = 3.35e12
KERNEL = "cummax_kernel"


def read(t):
    snap = program.snapshot(t)
    if snap is None:
        return None
    launches = program.counted(snap.spans, "kernel.K2")
    device_us = [d for name, _, d in t.trace.ops if KERNEL in name]
    if not launches or not device_us:
        return None
    if len(launches) != len(device_us):
        t.log(f"k2_roofline_share: {len(launches)} K2 launches counted, "
              f"{len(device_us)} {KERNEL} kernels traced: not reported")
        return None
    least_s = sum(r.amount for r in launches) / HBM_BYTES_PER_S
    return 100.0 * least_s / (sum(device_us) / 1e6)
