"""Chip smoke test of the PyTorch/CUDA port (arrow_go_tpu_torch).

Runs on one NVIDIA card and fails (non-zero exit, no result line)
without one. Phases:

  1. device: the card's name and power limit (nvidia-smi);
  2. build:  the port's CUDA kernels, compiled from csrc/ with nvcc;
  3. K1 (compact_flagged) and K2 (cummax_u64_lanes) against their plain
     PyTorch versions over a sweep of lengths, densities and payload
     types, bit for bit; then each timed at the shape the Q3 pipeline
     gives it, beside its plain version, a one-call PyTorch yardstick
     and its memory-bound least time;
  4. Q3 (filter -> hash join -> group-by -> sort, the pipeline of
     benchmarks/engine_e2e.py) at TPC-H SF10 scale (59,986,052 lineitem
     rows), checked against a numpy oracle, with each kernel's launch
     count over one run of it;
  5. one more Q3 run broken down by stage (host clock), and one under
     torch.profiler: device time by kernel and the device's idle share;
  6. a `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", ...}}.

Usage: python3 chip_smoke.py [--sf 10]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

import arrow_go_tpu_torch as agt
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import cuda_build, dtypes as dt
from arrow_go_tpu_torch.device.block import DeviceBatch, HostBatch
from arrow_go_tpu_torch.ops import compaction, scan

LINEITEM_SF1 = 6_001_215          # TPC-H spec 4.2.5: lineitem rows at SF1
LINEITEM_SF10 = 59_986_052        # ... and at SF10
CUTOFF = 10000
HBM_BYTES_PER_S = 3.35e12         # H100 SXM memory rate (data sheet)


def make_data(n_li: int, n_ord: int):
    """benchmarks/engine_e2e.py:make_data (seed 7)."""
    rng = np.random.default_rng(7)
    li = {
        "l_okey": rng.integers(0, n_ord, n_li).astype(np.int64),
        "l_price": np.round(rng.uniform(1.0, 1000.0, n_li), 2),
        "l_disc": np.round(rng.uniform(0.0, 0.1, n_li), 2),
        "l_sdate": rng.integers(8000, 12000, n_li).astype(np.int32),
    }
    orders = {
        "o_okey": np.arange(n_ord, dtype=np.int64),
        "o_odate": rng.integers(700, 740, n_ord).astype(np.int32),
    }
    return li, orders


def compute_q3(li_db: DeviceBatch, ord_db: DeviceBatch, cutoff: int,
               mark=lambda stage: None) -> HostBatch:
    """The port's Q3 (benchmarks/engine_e2e.py:compute_ours):

        SELECT o_odate, SUM(l_price * (1 - l_disc)), COUNT(*)
        FROM lineitem JOIN orders ON l_okey = o_okey
        WHERE l_sdate > cutoff GROUP BY o_odate ORDER BY 2 DESC

    `mark(stage)` is called as each stage ends (the profile's timer).
    """
    mask = pc.execute_scalar_expression(
        pc.call("greater", [pc.field("l_sdate"), pc.literal(cutoff)]), li_db)
    mark("predicate")
    # l_sdate is consumed by the mask: project it away before the filter
    keep = ["l_okey", "l_price", "l_disc"]
    li_proj = DeviceBatch(
        dt.Schema([li_db.schema.field(li_db.schema.field_index(n))
                   for n in keep]),
        [li_db.column(n) for n in keep], li_db.length)
    li_f = pc.filter(li_proj, mask)
    mark("filter")
    joined = pc.hash_join(li_f, ord_db, left_keys=["l_okey"],
                          right_keys=["o_okey"],
                          output_columns=["l_price", "l_disc", "o_odate"])
    mark("hash_join")
    rev = pc.execute_scalar_expression(pc.call("multiply", [
        pc.field("l_price"),
        pc.call("subtract", [pc.literal(1.0), pc.field("l_disc")])]), joined)
    jb = DeviceBatch(dt.Schema([dt.Field("o_odate", dt.int32),
                                dt.Field("rev", dt.float64)]),
                     [joined.column("o_odate"), rev], joined.length)
    mark("revenue")
    g = pc.group_by(jb, "o_odate", [("rev", "sum"), ("rev", "count")])
    mark("group_by")
    idx = pc.sort_indices(g.column("rev_sum"), order="descending")
    out = HostBatch.from_arrays({nm: pc.take(g.column(nm), idx)
                                 for nm in g.schema.names})
    mark("sort_take")
    return out


def q3_oracle(li, orders, cutoff: int):
    """numpy Q3: (o_odate by descending revenue, counts, revenues)."""
    m = li["l_sdate"] > cutoff
    key = orders["o_odate"][li["l_okey"][m]].astype(np.int64)
    rev = (li["l_price"] * (1.0 - li["l_disc"]))[m]
    base = int(orders["o_odate"].min())
    cnt = np.bincount(key - base)
    tot = np.bincount(key - base, weights=rev)
    present = np.flatnonzero(cnt)
    order = present[np.argsort(-tot[present], kind="stable")]
    return order + base, cnt[order], tot[order]


def check_q3(out: HostBatch, oracle) -> None:
    odate, cnt, tot = oracle
    got = out.to_pydict()
    if out.num_rows != len(odate):
        raise AssertionError(f"Q3: {out.num_rows} groups, oracle "
                             f"{len(odate)}")
    if got["o_odate"] != odate.tolist():
        raise AssertionError("Q3: group order differs from the oracle")
    if got["rev_count"] != cnt.tolist():
        raise AssertionError("Q3: counts differ from the oracle")
    np.testing.assert_allclose(got["rev_sum"], tot, rtol=1e-9)
    rs = np.asarray(got["rev_sum"])
    if not np.all(np.isfinite(rs)) or np.any(np.diff(rs) > 0):
        raise AssertionError("Q3: revenues not finite and descending")


# ---------------------------------------------------------------------------
# kernel checks and timings
# ---------------------------------------------------------------------------

_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(_INT_VIEW[t.element_size()])


def _max_abs_err(got, want) -> float:
    """Max |kernel - plain| over payloads, on their bit patterns as ints;
    raises unless they are bit-identical."""
    err = 0.0
    for g, w in zip(got, want):
        gb, wb = _bits(g), _bits(w)
        if g.numel():
            err = max(err, float((gb.to(torch.float64)
                                  - wb.to(torch.float64)).abs().max()))
        if not torch.equal(gb, wb):
            raise AssertionError(f"kernel differs from plain version "
                                 f"({g.dtype}, n={g.numel()}, err={err})")
    return err


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _payloads(kind: str, n: int, g: torch.Generator, dev):
    def ints(dtype):
        return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g,
                             device=dev, dtype=torch.int64).to(dtype)
    if kind == "bool":
        return (torch.rand(n, generator=g, device=dev) < 0.5,)
    if kind == "int32":
        return (ints(torch.int32),)
    if kind == "int64":
        return (ints(torch.int64) * 3 + 1,)
    if kind == "float16":
        return (torch.randn(n, generator=g, device=dev).to(torch.float16),)
    if kind == "float64":
        return (torch.randn(n, generator=g, device=dev,
                            dtype=torch.float64),)
    return (ints(torch.int64), torch.randn(n, generator=g, device=dev,
                                           dtype=torch.float64),
            ints(torch.int32))


K1_SIZES = (1, 31, 8191, 8192, 65_537, 67_108_864)
K2_SIZES = (1, 31, 8191, 8192, 65_537, 33_554_432, 67_108_864)


def check_k1(dev, sizes=K1_SIZES) -> float:
    g = torch.Generator(device=dev).manual_seed(1)
    err = 0.0
    cases = 0
    for n in sizes:
        for density in (0.0, 0.01, 0.5, 1.0):
            keep = torch.rand(n, generator=g, device=dev) < density
            for kind in ("bool", "int32", "int64", "float16", "float64",
                         "three"):
                pays = _payloads(kind, n, g, dev)
                got = compaction.compact_flagged(keep, pays)
                want = compaction.compact_flagged_plain(keep, pays)
                torch.cuda.synchronize()
                err = max(err, _max_abs_err(got, want))
                cases += 1
    print(f"K1 check: {cases} cases bit-identical to the plain version")
    return err


def _u32(n: int, g: torch.Generator, dev) -> torch.Tensor:
    return torch.randint(0, 2 ** 32, (n,), generator=g, device=dev)


def _join_like_lanes(n: int, total: int, g: torch.Generator, dev,
                     set_share: float, random_hi: bool = False):
    """Lanes as the join's expansion scatters them: owner bases (monotone,
    or random u32 with `random_hi`) at set slots, zero (unset) slots
    elsewhere, nothing past `total`."""
    j = torch.arange(n, device=dev, dtype=torch.int64)
    is_set = (torch.rand(n, generator=g, device=dev) < set_share) & (
        j < total)
    is_set[0] = total > 0
    hi = torch.where(is_set, _u32(n, g, dev) if random_hi else j, 0)
    los = [torch.where(is_set, _u32(n, g, dev), 0) for _ in range(2)]
    return hi, los


def check_k2(dev, sizes=K2_SIZES) -> float:
    g = torch.Generator(device=dev).manual_seed(2)
    err = 0.0
    cases = 0
    for n in sizes:
        for share, random_hi in ((0.001, False), (0.3, False), (1.0, False),
                                 (0.3, True)):
            hi, los = _join_like_lanes(n, n - n // 9, g, dev, share,
                                       random_hi)
            for lanes in (los[:1], los):    # the join state's, expansion's
                got = scan.cummax_u64_lanes(hi, lanes)
                want = scan.cummax_u64_lanes_plain(hi, lanes)
                torch.cuda.synchronize()
                err = max(err, _max_abs_err(got, want))
                cases += 1
    print(f"K2 check: {cases} cases bit-identical to the plain version")
    return err


def time_k1(dev, P: int, n_rows: int) -> dict:
    """K1 at the Q3 filter's shape: keep over P padded rows (about half of
    the n_rows real ones kept), payloads l_okey/l_price/l_disc."""
    g = torch.Generator(device=dev).manual_seed(3)
    keep = (torch.rand(P, generator=g, device=dev) < 0.5) & (
        torch.arange(P, device=dev) < n_rows)
    pays = (torch.randint(0, 2 ** 40, (P,), generator=g, device=dev),
            torch.rand(P, generator=g, device=dev, dtype=torch.float64),
            torch.rand(P, generator=g, device=dev, dtype=torch.float64))
    stacked = torch.stack([pays[0], pays[1].view(torch.int64),
                           pays[2].view(torch.int64)])
    nbytes = keep.numel() + 2 * sum(p.numel() * p.element_size()
                                    for p in pays)
    return {
        "ms": _time_ms(lambda: compaction.compact_flagged(keep, pays), 20),
        "plain_ms": _time_ms(
            lambda: compaction.compact_flagged_plain(keep, pays), 5),
        "library_ms": _time_ms(lambda: stacked[:, keep], 10),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "shape": f"P={P}, payloads int64+float64+float64",
    }


def time_k2(dev, n: int, total: int) -> dict:
    """K2 at the Q3 join expansion's shape: cap slots, hi + 2 lo lanes."""
    g = torch.Generator(device=dev).manual_seed(4)
    hi, los = _join_like_lanes(n, total, g, dev, 1.0)
    packs = torch.stack([(hi << 32) | lo for lo in los])
    nbytes = 2 * 8 * n * (1 + len(los))
    return {
        "ms": _time_ms(lambda: scan.cummax_u64_lanes(hi, los), 20),
        "plain_ms": _time_ms(lambda: scan.cummax_u64_lanes_plain(hi, los),
                             5),
        "library_ms": _time_ms(lambda: torch.cummax(packs, 1), 10),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "shape": f"n={n}, hi + 2 lo lanes",
    }


def profile_q3(li_db, ord_db, oracle) -> dict:
    """Where one Q3 run's time goes: the host-clock time of each stage
    (synchronized at each stage's end), then the device activity (kernels,
    copies, fills) of one unsynchronized run under torch.profiler. Their
    summed time over that run's wall time is the device's busy share (one
    stream, so activities do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    stages = {}
    last = [0.0]

    def mark(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[stage] = (now - last[0]) * 1e3
        last[0] = now

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    check_q3(compute_q3(li_db, ord_db, CUTOFF, mark), oracle)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = compute_q3(li_db, ord_db, CUTOFF)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    check_q3(out, oracle)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                               calls + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"stages_ms": stages, "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "top_device_ms": [[name[:90], ms, calls]
                              for name, (ms, calls) in top]}


def _nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of the Q3 data (default 10)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = _nvidia_smi()
    print(f"card: {card}", flush=True)

    t_build = cuda_build.build(["compaction", "scan"])
    print(f"build: {t_build:.1f} s (nvcc, sm_90a)", flush=True)
    for name in ("compaction", "scan"):
        log = cuda_build.library_path(name).with_name(
            cuda_build.library_path(name).name + ".log")
        for line in log.read_text().splitlines():
            if "registers" in line:
                print(f"ptxas {name}: {line.strip()}")

    k1_err = check_k1(dev)
    k2_err = check_k2(dev)

    n_li = LINEITEM_SF10 if args.sf == 10 else int(round(LINEITEM_SF1
                                                         * args.sf))
    n_ord = n_li // 4
    t0 = time.perf_counter()
    li, orders = make_data(n_li, n_ord)
    li_db = agt.batch_to_device(li, device=dev)
    ord_db = agt.batch_to_device(orders, device=dev)
    oracle = q3_oracle(li, orders, CUTOFF)
    torch.cuda.synchronize()
    print(f"q3 data: {n_li} lineitem rows, {n_ord} orders, padded "
          f"{li_db.padded}/{ord_db.padded}, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the main path: counts from 0, one Q3 run, counts read after it
    compaction.compact_flagged.launches = 0
    scan.cummax_u64_lanes.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = compute_q3(li_db, ord_db, CUTOFF)
    torch.cuda.synchronize()
    launches = {"K1": compaction.compact_flagged.launches,
                "K2": scan.cummax_u64_lanes.launches}
    check_q3(out, oracle)
    if min(launches.values()) < 1:
        raise AssertionError(f"Q3 did not launch every kernel: {launches}")
    times = []
    for _ in range(3):
        t = time.perf_counter()
        out = compute_q3(li_db, ord_db, CUTOFF)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        check_q3(out, oracle)
    med = float(np.median(times))
    peak = torch.cuda.max_memory_allocated()
    n_joined = int(sum(out.column("rev_count").to_pylist()))
    print(json.dumps({"q3": {
        "sf": args.sf, "lineitem_rows": n_li, "orders_rows": n_ord,
        "joined_rows": n_joined, "groups": out.num_rows,
        "ms_runs": [t * 1e3 for t in times], "ms_median": med * 1e3,
        "rows_per_s": n_li / med, "peak_mem_bytes": peak,
        "launches_per_run": launches, "verified": True}}), flush=True)
    print(json.dumps({"q3_profile": profile_q3(li_db, ord_db, oracle)}), flush=True)

    P_li = li_db.padded
    cap = agt.pad_length(n_joined)
    k1 = time_k1(dev, P_li, n_li)
    k2 = time_k2(dev, cap, n_joined)
    for name, t in (("K1", k1), ("K2", k2)):
        print(f"{name} at {t['shape']}: kernel {t['ms']:.3f} ms, plain "
              f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.3f} ms")
    kernels = [
        {"name": "compact_flagged", "route": "cuda",
         "source": "arrow_go_tpu_torch/csrc/compaction.cu",
         "replaces": "arrow_go_tpu/ops/compaction.py:103",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "bytes",
         "library_ms": k1["library_ms"]},
        {"name": "cummax_u64_lanes", "route": "cuda",
         "source": "arrow_go_tpu_torch/csrc/scan.cu",
         "replaces": "arrow_go_tpu/ops/scan.py:38",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": k2["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
