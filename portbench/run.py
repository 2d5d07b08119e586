"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or `python3 -m portbench.run ...`), from the root of a checkout that
holds BENCHMARK.json, portbench/ and arrow_go_tpu_torch/. The host
allocator is set to keep what it frees (`keep_freed_host_memory`). The cell's
tables are made on the card from the seed and loaded as the port's
resident DeviceBatches; each query of the cell's mix is warmed; one
closed-loop query stream runs for --seconds; every answer is held
against the plain reference. The last line of standard output is the
result: {"correct", "attempted", "failed", "metrics", "device",
["breakdown",] "checks"}; with --trace 0 the cell's end-to-end metrics,
with --trace 1 its per-layer metrics. Without enough CUDA cards it
exits non-zero and prints no result.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# run as a script, the script's folder would shadow modules by its
# files' names: the checkout's root goes there instead
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# kernel caches at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".portbench_cache" / sub)


def keep_freed_host_memory() -> None:
    """Sets the process's host allocator to keep what it frees.

    By default glibc's malloc gives blocks of 128 KiB and more back to
    the kernel (each its own mapping, and the heap's top trimmed), so
    the host copies of every query's results land on fresh pages, and
    how long that takes varies from run to run and within one. As a
    service tunes its allocator, the benchmark has blocks under 32 MiB
    come from the heap and trims the heap's top only past 2 GiB."""
    import ctypes
    import ctypes.util
    name = ctypes.util.find_library("c")
    libc = ctypes.CDLL(name) if name else None
    if libc is None or not hasattr(libc, "mallopt"):
        print("no glibc mallopt: the host allocator as it is",
              file=sys.stderr, flush=True)
        return
    # M_TRIM_THRESHOLD, M_TOP_PAD, M_MMAP_THRESHOLD (malloc.h)
    for param, value in ((-1, (2 << 30) - 1), (-2, 256 << 20),
                         (-3, 32 << 20)):
        if libc.mallopt(param, value) != 1:
            print(f"mallopt({param}, {value}) refused", file=sys.stderr,
                  flush=True)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    keep_freed_host_memory()

    import torch

    import arrow_go_tpu_torch  # noqa: F401  (the program under test)
    from portbench.harness import cell as runner
    from portbench.harness.spec import load_cell
    c = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        runner.log(f"{args.workload} needs {c.chips} CUDA card(s); "
                   f"{n} available: no result")
        return 2
    out = runner.run_cell(c, args.seed % (1 << 63), args.seconds,
                          bool(args.trace))
    if out is None:
        return 3
    runner.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
