"""K1's share of its roofline (csrc/compaction.cu), in percent: the
least time of its calls in the profiled part over the device time of its
two kernels there (count_kernel, scatter_kernel).

K1 writes the whole stable partition, so a call's least time is its
keep flags (1 byte a row) read once and every payload read once and
written once, over the H100's 3.35e12 B/s (NVIDIA's data sheet, SXM).
The shapes come from the harness's capture of K1's call sites; where
it saw another number of calls than the profiler saw scatter_kernel
launches, a call site was missed and nothing is reported."""

HBM_BYTES_PER_S = 3.35e12
KERNELS = ("count_kernel", "scatter_kernel")


def read(t):
    calls = [c for c in t.trace.k1_calls if c[1] > 0]
    launches = sum(1 for name, _, _ in t.trace.ops
                   if name.startswith("scatter_kernel"))
    if not calls or not launches:
        return None
    if len(calls) != launches:
        t.log(f"k1_roofline_share: {len(calls)} K1 calls captured, "
              f"{launches} scatter_kernel launches traced: not reported")
        return None
    least_s = sum(rows + 2 * rows * sum(sizes)
                  for _, rows, sizes in calls) / HBM_BYTES_PER_S
    device_us = sum(d for name, _, d in t.trace.ops
                    if name.startswith(KERNELS))
    return 100.0 * least_s / (device_us / 1e6)
