"""Chip smoke test of the PyTorch/CUDA port (arrow_go_tpu_torch).

Runs on one NVIDIA card and fails (non-zero exit, no result line)
without one. Phases:

  1. device: the card's name and power limit (nvidia-smi);
  2. build:  the port's CUDA kernels, compiled from csrc/ with nvcc;
  3. K1 (compact_flagged), K2 (cummax_u64_lanes) and K3 (reduce,
     reduce_with_count) against their plain PyTorch versions over a
     sweep of lengths, densities and types: K1 and K2 bit for bit (K1
     over its whole length, with views at an element offset that are
     not 16-byte aligned and with 16 mixed-width payloads), K3 bit for
     bit for ints, min, max and (exact) products, float sums at rtol
     1e-9 (f64) and 1e-5 (f32), its counts exact, and every K3 result
     identical over two launches and over two launches with another
     between them (K3 again, in phase 6, on the very columns Q6 and the
     summary reduce);
  4. Q3 (filter -> hash join -> group-by -> sort, the pipeline of
     benchmarks/engine_e2e.py) from device-resident batches at TPC-H
     SF10 scale (59,986,052 lineitem rows), checked against a numpy
     oracle, with each kernel's launch count over one run of it; one
     more run broken down by stage (host clock), one under
     torch.profiler (device time by kernel and the device's idle
     share), and one that captures what each K1 call site hands K1,
     timed at each of those shapes;
  5. the same tables (plus l_qty) written to parquet bytes by the
     port's writer, then scanned onto the card (read_batch_device),
     with the host-parse / host-to-device / device-decode split;
  6. from parquet bytes: TPC-H Q6 (predicate -> filter -> expression ->
     SUM/COUNT), the lineitem summary aggregates, and Q3, each checked
     against a numpy oracle, each with its kernels' launch counts;
  7. K2 and K3 timed at the shapes of those paths, beside their plain
     versions, a one-call PyTorch yardstick and their memory-bound
     least time;
  8. a `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", ...}}.

With --timing-only it skips phase 3 and the lines of phase 8: a run
that times every path and kernel shape using only entry points that
earlier trees have too, so that two trees can be run in turns on one
card (copy this script into a tree unpacked with `git archive` and run
it there, then here, here, there).

Usage: python3 chip_smoke.py [--sf 10] [--timing-only]
"""
from __future__ import annotations

import argparse
import io
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

import arrow_go_tpu_torch as agt
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import cuda_build, dtypes as dt
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.device.block import DeviceBatch, HostBatch
from arrow_go_tpu_torch.ops import bitmap, compaction, reductions, scan

LINEITEM_SF1 = 6_001_215          # TPC-H spec 4.2.5: lineitem rows at SF1
LINEITEM_SF10 = 59_986_052        # ... and at SF10
CUTOFF = 10000
HBM_BYTES_PER_S = 3.35e12         # H100 SXM memory rate (data sheet)
# TPC-H Q6 with its validation substitutions (spec 2.4.6): the year
# 1994 as days since 1970-01-01, DISCOUNT 0.06 +- 0.01, QUANTITY 24
Q6_DATE_LO, Q6_DATE_HI = 8766, 9131
Q6_DISC_LO, Q6_DISC_HI = 0.05, 0.07
Q6_QTY = 24
KERNELS = {"K1": compaction.compact_flagged, "K2": scan.cummax_u64_lanes,
           "K3": reductions.reduce}


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


def add_quantity(li) -> None:
    """l_qty: TPC-H L_QUANTITY, uniform in [1, 50] (spec 4.2.3), from a
    generator of its own so the make_data columns stay as they were."""
    n = len(li["l_okey"])
    li["l_qty"] = np.random.default_rng(8).integers(1, 51, n).astype(
        np.int32)


def project(db: DeviceBatch, names) -> DeviceBatch:
    """The named columns of a batch, fields and columns both in `names`
    order."""
    return DeviceBatch(
        dt.Schema([db.schema.field(db.schema.field_index(n)) for n in names]),
        [db.column(n) for n in names], db.length)


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
    li_f = pc.filter(project(li_db, ["l_okey", "l_price", "l_disc"]), mask)
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


def q6_expression():
    """TPC-H Q6's WHERE clause: a conjunction of five comparisons."""
    f, lit, call = pc.field, pc.literal, pc.call
    conds = [call("greater_equal", [f("l_sdate"), lit(Q6_DATE_LO)]),
             call("less", [f("l_sdate"), lit(Q6_DATE_HI)]),
             call("greater_equal", [f("l_disc"), lit(Q6_DISC_LO)]),
             call("less_equal", [f("l_disc"), lit(Q6_DISC_HI)]),
             call("less", [f("l_qty"), lit(Q6_QTY)])]
    pred = conds[0]
    for c in conds[1:]:
        pred = call("and", [pred, c])
    return pred


def q6_revenue(li_db: DeviceBatch):
    """Q6 up to its aggregates: l_price * l_disc over the rows that pass
    the WHERE clause (the column Q6's SUM reduces)."""
    mask = pc.execute_scalar_expression(q6_expression(), li_db)
    li_f = pc.filter(project(li_db, ["l_price", "l_disc"]), mask)
    return pc.execute_scalar_expression(
        pc.call("multiply", [pc.field("l_price"), pc.field("l_disc")]), li_f)


def compute_q6(li_db: DeviceBatch) -> dict:
    """The port's TPC-H Q6:

        SELECT SUM(l_price * l_disc), COUNT(*) FROM lineitem
        WHERE l_sdate >= 8766 AND l_sdate < 9131
          AND l_disc >= 0.05 AND l_disc <= 0.07 AND l_qty < 24
    """
    rev = q6_revenue(li_db)
    return {"revenue": pc.agg_sum(rev),
            "count": pc.agg_count(rev, pc.CountOptions("all"))}


def q6_oracle(li) -> dict:
    m = ((li["l_sdate"] >= Q6_DATE_LO) & (li["l_sdate"] < Q6_DATE_HI)
         & (li["l_disc"] >= Q6_DISC_LO) & (li["l_disc"] <= Q6_DISC_HI)
         & (li["l_qty"] < Q6_QTY))
    return {"revenue": float(np.sum(li["l_price"][m] * li["l_disc"][m])),
            "count": int(m.sum())}


def check_q6(got: dict, want: dict) -> None:
    if got["count"] != want["count"] or want["count"] < 1:
        raise AssertionError(f"Q6: count {got['count']}, oracle "
                             f"{want['count']}")
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-9)


SUMMARY_COLUMNS = ["l_qty", "l_sdate", "l_price"]


def compute_summary(li_db: DeviceBatch) -> dict:
    """SELECT COUNT(*), SUM(l_qty), MIN(l_sdate), MAX(l_sdate),
    AVG(l_price), SUM(l_price) FROM lineitem."""
    qty, sdate, price = (li_db.column(c) for c in SUMMARY_COLUMNS)
    return {"count": pc.agg_count(qty, pc.CountOptions("all")),
            "sum_qty": pc.agg_sum(qty), "min_sdate": pc.agg_min(sdate),
            "max_sdate": pc.agg_max(sdate), "avg_price": pc.agg_mean(price),
            "sum_price": pc.agg_sum(price)}


def summary_reductions(li_db: DeviceBatch) -> list:
    """(column, op) of the K3 launches of compute_summary (AVG(l_price)
    reduces as SUM(l_price) does)."""
    qty, sdate, price = (li_db.column(c) for c in SUMMARY_COLUMNS)
    return [(qty, "sum"), (sdate, "min"), (sdate, "max"), (price, "sum")]


def summary_oracle(li) -> dict:
    return {"count": len(li["l_qty"]),
            "sum_qty": int(li["l_qty"].sum(dtype=np.int64)),
            "min_sdate": int(li["l_sdate"].min()),
            "max_sdate": int(li["l_sdate"].max()),
            "avg_price": float(li["l_price"].mean()),
            "sum_price": float(li["l_price"].sum())}


def check_summary(got: dict, want: dict) -> None:
    for k in ("count", "sum_qty", "min_sdate", "max_sdate"):
        if got[k] != want[k] or type(got[k]) is not int:
            raise AssertionError(f"summary {k}: {got[k]!r}, oracle "
                                 f"{want[k]!r}")
    for k in ("avg_price", "sum_price"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9)


def write_parquet(table: dict) -> bytes:
    """One row group, UNCOMPRESSED, dictionary on (PLAIN past the 1 MiB
    dictionary limit), 8 MiB data pages: the layout of
    benchmarks/engine_e2e.py:write_parquet_ours, without its codec."""
    buf = io.BytesIO()
    tpq.write_table(table, buf, data_page_size=8 << 20)
    return buf.getvalue()


def scan_parquet(blob: bytes, columns=None, device=None,
                 times=None) -> DeviceBatch:
    """Row group 0 of a parquet file onto the device."""
    return tpq.read_batch_device(tpq.ParquetFile(blob), 0, columns=columns,
                                 device=device, times=times)


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


K1_TILE = compaction._TILE
K1_SIZES = (1, 31, K1_TILE - 1, K1_TILE, K1_TILE + 1, 8191, 8192, 65_537,
            67_108_864)
K2_SIZES = (1, 31, 8191, 8192, 65_537, 33_554_432, 67_108_864)
K1_MIXED = (torch.bool, torch.int8, torch.int16, torch.float16, torch.int32,
            torch.float32, torch.int64, torch.float64)


def _mixed_payloads(n: int, g: torch.Generator, dev) -> tuple:
    """16 payloads, two of each of K1_MIXED: 1-, 2-, 4- and 8-byte."""
    out = []
    for dtype in K1_MIXED * 2:
        bits = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                             device=dev)
        if dtype == torch.bool:
            out.append(bits > 0)
        else:
            out.append(bits.to(_INT_VIEW[dtype.itemsize]).view(dtype))
    return tuple(out)


def _k1_case(keep, pays) -> float:
    """K1 against its plain version over the whole length, twice (a
    ticket left set by the first launch would show in the second)."""
    err = 0.0
    for _ in range(2):
        got = compaction.compact_flagged(keep, pays)
        want = compaction.compact_flagged_plain(keep, pays)
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(got, want))
    return err


def check_k1(dev, sizes=K1_SIZES) -> float:
    """K1 bit for bit against its plain version over the whole length:
    sizes around one and two tiles, densities 0 to 1, every element
    size; 16 mixed payloads; keep and payloads as views at an element
    offset (not 16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(1)
    err = 0.0
    cases = 0
    for n in sizes:
        for density in (0.0, 0.01, 0.5, 1.0):
            keep = torch.rand(n, generator=g, device=dev) < density
            for kind in ("bool", "int32", "int64", "float16", "float64",
                         "three"):
                err = max(err, _k1_case(keep, _payloads(kind, n, g, dev)))
                cases += 1
            if n <= 65_537 or density == 0.5:
                err = max(err, _k1_case(keep, _mixed_payloads(n, g, dev)))
                cases += 1
        for off in (1, 3):
            # views at an element offset: keep and every payload start
            # off elements into a larger tensor
            keep = (torch.rand(n + off, generator=g, device=dev) < 0.5)[off:]
            pays = tuple(p[off:] for p in _payloads("three", n + off, g, dev)
                         + _mixed_payloads(n + off, g, dev)[:13])
            assert all(p.data_ptr() % 16 for p in (keep,) + pays[:3])
            err = max(err, _k1_case(keep, pays))
            cases += 1
    print(f"K1 check: {cases} cases bit-identical to the plain version "
          f"over the whole length, each launched twice")
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


def capture_k1(fn):
    """Run fn once with every K1 call site of the engine recording what
    it hands K1. Returns (fn's result, [(site, keep, payloads)]), site
    being the function that asked for the compaction."""
    from arrow_go_tpu_torch.ops import groupagg, selection
    from arrow_go_tpu_torch.parallel import join as pjoin
    calls = []

    def recording(keep, payloads):
        payloads = tuple(payloads)
        caller = sys._getframe(1).f_code.co_name
        if caller == "compact_runs":           # groupagg's thin wrapper
            caller = sys._getframe(2).f_code.co_name
        calls.append((caller, keep, payloads))
        return compaction.compact_flagged(keep, payloads)

    mods = (selection, groupagg, pjoin)
    saved = [m.compact_flagged for m in mods]
    for m in mods:
        m.compact_flagged = recording
    try:
        out = fn()
    finally:
        for m, f in zip(mods, saved):
            m.compact_flagged = f
    return out, calls


def _k1_library(keep, pays):
    """One PyTorch call that computes K1's kept rows: boolean indexing
    of the payloads stacked as rows (one element size) or packed side by
    side as bytes (mixed sizes)."""
    sizes = {p.element_size() for p in pays}
    if len(sizes) == 1:
        stacked = torch.stack([_bits(p) for p in pays])
        return lambda: stacked[:, keep]
    packed = torch.cat([p.view(torch.uint8).view(-1, p.element_size())
                        for p in pays], 1)
    return lambda: packed[keep]


def time_k1(calls) -> list:
    """K1 at each shape the main path hands it (capture_k1), on those
    very inputs: kernel, plain version and library call, and the bound:
    keep read once and every payload read and written once. copy_ms is
    a device copy of every payload (one `copy_` each): the rate a plain
    read and write of the same payload bytes reaches on this card."""
    out = []
    for site, keep, pays in calls:
        P = keep.numel()
        nbytes = P + 2 * sum(p.numel() * p.element_size() for p in pays)
        copies = [torch.empty_like(p) for p in pays]
        out.append({
            "site": site, "P": P, "kept": int(keep.sum()),
            "payloads": "+".join(str(p.dtype).replace("torch.", "")
                                 for p in pays),
            "ms": _time_ms(lambda: compaction.compact_flagged(keep, pays),
                           20),
            "plain_ms": _time_ms(
                lambda: compaction.compact_flagged_plain(keep, pays), 5),
            "library_ms": _time_ms(_k1_library(keep, pays), 10),
            "copy_ms": _time_ms(lambda: [c.copy_(p) for c, p in
                                         zip(copies, pays)], 10),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes,
        })
        del copies
    return out


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


K3_SIZES = (1, 31, 127, 128, 8191, 65_537, 16_777_216, 67_108_864)
K3_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)
K3_RTOL = {torch.float32: 1e-5, torch.float64: 1e-9}


def _k3_inputs(dtype, n: int, P: int, g: torch.Generator, dev):
    """(values for sum/min/max, values for prod) over P rows, junk in
    [n, P). Float values are uniform in [0, 1), so a float sum has no
    cancellation to amplify the order-of-addition error; product values
    are +-1 with a few powers of two, so every product is exact in any
    order and is compared bit for bit."""
    if dtype.is_floating_point:
        v = torch.rand(P, generator=g, device=dev, dtype=dtype)
        junk = torch.tensor([float("nan"), float("inf"), float("-inf"),
                             torch.finfo(dtype).max], dtype=dtype, device=dev)
    else:
        info = torch.iinfo(dtype)
        v = torch.randint(info.min, info.max, (P,), generator=g, device=dev,
                          dtype=torch.int64).to(dtype)
        junk = torch.tensor([info.min, info.max], dtype=dtype, device=dev)
    sign = torch.rand(P, generator=g, device=dev) < 0.5
    prod = torch.where(sign, 1, -1).to(dtype)
    twos = torch.randint(0, max(n, 1), (12,), generator=g, device=dev)
    prod[twos[:6]] = 2
    if dtype.is_floating_point:
        prod[twos[6:]] = 0.5
    tail = torch.randint(0, len(junk), (P - n,), generator=g, device=dev)
    for t in (v, prod):
        t[n:] = junk[tail]
    return v, prod


def _k3_words(density, n: int, P: int, g: torch.Generator, dev):
    """Validity words with the given share of set bits (all bits in
    [n, P) set, so only `i < n` keeps the junk out), or None."""
    if density is None:
        return None
    bits = torch.rand(P, generator=g, device=dev) < density
    bits[n:] = True
    return bitmap.pack_mask(bits)


def _k3_compare(got, again, want, dtype, op, what) -> float:
    """|kernel - plain|; raises unless two launches gave the same bits
    and the kernel agrees with the plain version (bit for bit, or at
    K3_RTOL for float sums)."""
    if not torch.equal(_bits(got.reshape(1)), _bits(again.reshape(1))):
        raise AssertionError(f"K3 {what}: two launches differ")
    g, w = got.item(), want.item()
    if isinstance(g, float) and np.isnan(g) and np.isnan(w):
        return 0.0                   # NaN payloads are not compared
    if dtype.is_floating_point and op == "sum":
        ok = np.isclose(g, w, rtol=K3_RTOL[dtype], atol=0)
    else:
        ok = torch.equal(_bits(got.reshape(1)), _bits(want.reshape(1)))
    if not ok:
        raise AssertionError(f"K3 {what}: {g!r} vs plain {w!r}")
    return abs(g - w)


def _k3_with_count(x, words, n, op, other, dtype, what) -> float:
    """reduce_with_count against reduce_plain + count_valid: the count
    exact, the accumulator as _k3_compare holds it, and the pair the
    same over two launches, and over two more with a launch on `other`
    (another input) between them, so that a ticket left set would show."""
    want, want_count = reductions.reduce_with_count_plain(x, words, n, op)
    runs = [reductions.reduce_with_count(x, words, n, op) for _ in range(2)]
    runs.append(reductions.reduce_with_count(x, words, n, op))
    reductions.reduce_with_count(*other)
    runs.append(reductions.reduce_with_count(x, words, n, op))
    err = 0.0
    for (acc, count), (again, count2) in zip(runs[::2], runs[1::2]):
        if count.item() != want_count.item() or \
                count2.item() != want_count.item():
            raise AssertionError(f"K3 count {what}: {count.item()} / "
                                 f"{count2.item()}, plain "
                                 f"{want_count.item()}")
        err = max(err, _k3_compare(acc, again, want, dtype, op,
                                   f"with count {what}"))
    if not torch.equal(_bits(runs[0][0].reshape(1)),
                       _bits(runs[2][0].reshape(1))):
        raise AssertionError(f"K3 {what}: a launch between two launches "
                             f"changed the result")
    return err


def check_k3(dev, sizes=K3_SIZES) -> float:
    """K3 over the sweep, through reduce and through reduce_with_count
    (whose count must be exact)."""
    g = torch.Generator(device=dev).manual_seed(5)
    other_v = torch.rand(1024, generator=g, device=dev, dtype=torch.float64)
    other = (other_v, _k3_words(0.3, 999, 1024, g, dev), 999, "sum")
    err = 0.0
    cases = 0
    for n in sizes:
        P = agt.pad_length(n)
        for dtype in K3_DTYPES:
            v, prod = _k3_inputs(dtype, n, P, g, dev)
            for density in (None, 0.0, 0.5, 1.0):
                words = _k3_words(density, n, P, g, dev)
                for op in reductions.OPS:
                    x = prod if op == "prod" else v
                    what = f"{dtype} {op} n={n} density={density}"
                    got = reductions.reduce(x, words, n, op)
                    again = reductions.reduce(x, words, n, op)
                    want = reductions.reduce_plain(x, words, n, op)
                    err = max(err, _k3_compare(got, again, want, dtype, op,
                                               what))
                    err = max(err, _k3_with_count(x, words, n, op, other,
                                                  dtype, what))
                    cases += 1
            if not dtype.is_floating_point:
                continue
            # NaN in a counted row propagates; in a null row it does not
            row = n // 2
            v[row] = float("nan")
            prod[row] = float("nan")
            bits = torch.ones(P, dtype=torch.bool, device=dev)
            bits[row] = False
            hidden = bitmap.pack_mask(bits)
            for words, nan in ((None, True), (hidden, False)):
                for op in reductions.OPS:
                    x = prod if op == "prod" else v
                    got = reductions.reduce(x, words, n, op)
                    want = reductions.reduce_plain(x, words, n, op)
                    if bool(torch.isnan(got)) != nan:
                        raise AssertionError(f"K3 NaN {dtype} {op} n={n}: "
                                             f"{got.item()!r}")
                    what = f"NaN {dtype} {op} n={n} nan={nan}"
                    err = max(err, _k3_compare(
                        got, reductions.reduce(x, words, n, op), want,
                        dtype, op, what))
                    err = max(err, _k3_with_count(x, words, n, op, other,
                                                  dtype, what))
                    cases += 1
    torch.cuda.synchronize()
    print(f"K3 check: {cases} cases through reduce and reduce_with_count; "
          f"ints, min, max and products bit-identical to the plain "
          f"version, float sums within rtol, counts exact, results the "
          f"same over repeated and interleaved launches; max |kernel - "
          f"plain| {err!r}")
    return err


def check_k3_at(what: str, reductions_of_path) -> float:
    """K3 against its plain version on the very inputs a path hands it:
    each (column, op) reduced as agg_* reduces it (values, validity
    words, length), compared as check_k3 compares."""
    err = 0.0
    for col, op in reductions_of_path:
        x, w, n = col.values, col.validity, col.length
        err = max(err, _k3_compare(
            reductions.reduce(x, w, n, op), reductions.reduce(x, w, n, op),
            reductions.reduce_plain(x, w, n, op), x.dtype, op,
            f"{what} {x.dtype} {op} n={n} P={x.shape[0]}"))
    shapes = sorted({(c.length, c.padded, str(c.values.dtype))
                     for c, _ in reductions_of_path})
    print(f"K3 at the {what} shapes (n, P, dtype) {shapes}: "
          f"{len(reductions_of_path)} reductions agree with the plain "
          f"version; max |kernel - plain| {err!r}", flush=True)
    return err


def time_k3(dev, P: int, n: int) -> list:
    """K3 at the lineitem summary's shape (P padded rows, n real): an
    f64 sum without validity (SUM(l_price)) and an int32 min with
    validity words at density 0.5. The library call is one torch call
    over the n rows (with a where() against a precomputed mask when
    there is validity); the bound reads the n values (and their words)
    once at the memory rate."""
    g = torch.Generator(device=dev).manual_seed(6)
    f64 = torch.rand(P, generator=g, device=dev, dtype=torch.float64)
    i32 = torch.randint(-2 ** 31, 2 ** 31, (P,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    words = _k3_words(0.5, n, P, g, dev)
    mask = bitmap.expand_words(words, P)[:n]
    imax = torch.iinfo(torch.int32).max
    out = []
    for name, x, w, op, lib in (
            ("f64 sum, no validity", f64, None, "sum",
             lambda: torch.sum(f64[:n])),
            ("int32 min, validity 0.5", i32, words, "min",
             lambda: torch.where(mask, i32[:n], imax).amin())):
        nbytes = n * x.element_size() + (0 if w is None else -(-n // 32) * 4)
        out.append({
            "shape": f"{name}, P={P}, n={n}",
            "ms": _time_ms(lambda: reductions.reduce(x, w, n, op), 50),
            "plain_ms": _time_ms(
                lambda: reductions.reduce_plain(x, w, n, op), 10),
            "library_ms": _time_ms(lib, 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        })
    return out


def profile_device(fn, check, top: int = 12) -> dict:
    """The device activity (kernels, copies, fills) of one unsynchronized
    run of `fn` under torch.profiler. Their summed time over the run's
    wall time is the device's busy share (one stream, so activities do
    not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    check(out)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                               calls + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "top_device_ms": [[name[:90], ms, calls]
                              for name, (ms, calls) in ranked]}


def profile_q3(li_db, ord_db, oracle) -> dict:
    """Where one Q3 run's time goes: the host-clock time of each stage
    (synchronized at each stage's end), then the device activity of one
    more run (profile_device)."""
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
    return {"stages_ms": stages, **profile_device(
        lambda: compute_q3(li_db, ord_db, CUTOFF),
        lambda out: check_q3(out, oracle))}


def _nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def run_path(name: str, fn, needs):
    """Drive one path once with every launch count set to 0 just before
    it and read just after; fails unless each kernel in `needs`
    launched. Returns (result, counts)."""
    for k in KERNELS.values():
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in KERNELS.items()}
    missing = [k for k in needs if counts[k] < 1]
    if missing:
        raise AssertionError(f"{name} did not launch {missing}: {counts}")
    return out, counts


def timed(fn, reps: int = 3):
    """(outputs, host-clock ms of each run), each run ending in a
    device synchronize."""
    outs, runs = [], []
    for _ in range(reps):
        t = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    return outs, runs


def check_scan(dbs: dict, sources: dict) -> None:
    """Every scanned column equals its numpy source over [0, n), at the
    padded length pad_length(n)."""
    for tname, db in dbs.items():
        for name, want in sources[tname].items():
            c = db.column(name)
            n = len(want)
            if db.length != n or c.length != n or \
                    c.padded != agt.pad_length(n) or c.validity is not None:
                raise AssertionError(f"scan {tname}.{name}: length "
                                     f"{c.length}/{n}, padded {c.padded}")
            if not np.array_equal(c.values[:n].cpu().numpy(), want):
                raise AssertionError(f"scan {tname}.{name}: values differ")


def time_scan(blobs: dict, dev, sources: dict) -> dict:
    """Three scans of every column of both files, the first checked
    against the numpy sources: each run's ms, and the median run's
    host-parse / host-to-device / device-decode split."""
    runs = []
    for i in range(3):
        phases = {}
        t = time.perf_counter()
        dbs = {k: scan_parquet(b, device=dev, times=phases)
               for k, b in blobs.items()}
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t) * 1e3, phases))
        if i == 0:
            check_scan(dbs, sources)
        del dbs
    med = sorted(runs, key=lambda r: r[0])[1]
    file_bytes = sum(len(b) for b in blobs.values())
    return {"ms_runs": [r[0] for r in runs], "ms_median": med[0],
            "median_split_ms": {k[:-2] + "_ms": v * 1e3
                                for k, v in med[1].items()},
            "file_bytes": file_bytes,
            "file_gb_per_s": file_bytes / med[0] / 1e6, "verified": True}


def _print_ptxas(names) -> None:
    """Each source's kernels: how many, their registers, and any spill."""
    for name in names:
        lib = cuda_build.library_path(name)
        lines = lib.with_name(lib.name + ".log").read_text().splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "registers" in ln]
        spills = [ln.strip() for ln in lines if any(
            int(b) for b in re.findall(r"(\d+) bytes spill", ln))]
        print(f"ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, spills: {spills or 'none'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of the data (default 10)")
    ap.add_argument("--timing-only", action="store_true",
                    help="skip the kernel sweeps (phase 3) and the final "
                         "kernels and ok lines: a run that times every "
                         "path and kernel shape, for comparing two trees "
                         "in turns on one card")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = _nvidia_smi()
    print(f"card: {card}", flush=True)
    t_start = time.perf_counter()

    sources = ["compaction", "scan", "reduce"]
    t_build = cuda_build.build(sources)
    print(f"build: {t_build:.1f} s (nvcc, sm_90a)", flush=True)
    _print_ptxas(sources)

    if args.timing_only:
        k1_err = k2_err = k3_err = 0.0
    else:
        k1_err = check_k1(dev)
        k2_err = check_k2(dev)
        k3_err = check_k3(dev)

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

    # device-resident Q3: counts from 0, one run, counts read after it
    torch.cuda.reset_peak_memory_stats()
    out, launches = run_path("Q3", lambda: compute_q3(li_db, ord_db, CUTOFF),
                             ("K1", "K2"))
    check_q3(out, oracle)
    outs, runs = timed(lambda: compute_q3(li_db, ord_db, CUTOFF))
    for out in outs:
        check_q3(out, oracle)
    med = float(np.median(runs))
    peak = torch.cuda.max_memory_allocated()
    n_joined = int(sum(out.column("rev_count").to_pylist()))
    print(json.dumps({"q3": {
        "sf": args.sf, "lineitem_rows": n_li, "orders_rows": n_ord,
        "joined_rows": n_joined, "groups": out.num_rows,
        "ms_runs": runs, "ms_median": med, "rows_per_s": n_li / med * 1e3,
        "peak_mem_bytes": peak, "launches_per_run": launches,
        "verified": True}}), flush=True)
    print(json.dumps({"q3_profile": profile_q3(li_db, ord_db, oracle)}),
          flush=True)
    # K1 at each of its Q3 shapes, on the inputs one Q3 run hands it
    out, calls = capture_k1(lambda: compute_q3(li_db, ord_db, CUTOFF))
    check_q3(out, oracle)
    if len(calls) != launches["K1"]:
        raise AssertionError(f"captured {len(calls)} K1 calls of Q3, "
                             f"counted {launches['K1']}")
    k1s = time_k1(calls)
    del calls
    for t in k1s:
        print(f"K1 at {t['site']} (P={t['P']}, {t['payloads']}, "
              f"kept {t['kept']}): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"copy {t['copy_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    print(json.dumps({"k1_shapes": k1s}), flush=True)
    P_li = li_db.padded
    cap = agt.pad_length(n_joined)
    del li_db, ord_db

    # the same tables as parquet bytes, written by the port's writer
    add_quantity(li)
    t0 = time.perf_counter()
    blobs = {"lineitem": write_parquet(li), "orders": write_parquet(orders)}
    write_s = time.perf_counter() - t0
    encodings = {}
    for tname, blob in blobs.items():
        pf = tpq.ParquetFile(blob)
        for c in pf.metadata.row_groups[0].columns:
            encodings[f"{tname}.{c.meta_data.path_in_schema[0]}"] = [
                tpq.format.Encoding(e).name for e in c.meta_data.encodings]
    print(json.dumps({"parquet": {
        "write_s": write_s, "bytes": {k: len(b) for k, b in blobs.items()},
        "encodings": encodings}}), flush=True)

    # scan: both files, every column, three runs with the phase split
    sources = {"lineitem": li, "orders": orders}
    print(json.dumps({"scan": time_scan(blobs, dev, sources)}), flush=True)

    # Q6 from parquet bytes
    q6_cols = ["l_price", "l_disc", "l_sdate", "l_qty"]
    q6_want = q6_oracle(li)

    def q6_from_bytes():
        return compute_q6(scan_parquet(blobs["lineitem"], q6_cols, dev))
    got, q6_launches = run_path("Q6", q6_from_bytes, ("K1", "K3"))
    check_q6(got, q6_want)
    li_q6 = scan_parquet(blobs["lineitem"], q6_cols, dev)
    k3_err = max(k3_err, check_k3_at("Q6", [(q6_revenue(li_q6), "sum")]))
    outs, compute_runs = timed(lambda: compute_q6(li_q6))
    del li_q6
    outs_e2e, e2e_runs = timed(q6_from_bytes)
    for out in outs + outs_e2e:
        check_q6(out, q6_want)
    print(json.dumps({"q6": {
        **got, "oracle": q6_want, "selectivity": got["count"] / n_li,
        "compute_ms_runs": compute_runs,
        "compute_ms_median": float(np.median(compute_runs)),
        "from_bytes_ms_runs": e2e_runs,
        "from_bytes_ms_median": float(np.median(e2e_runs)),
        "launches_per_run": q6_launches, "verified": True}}), flush=True)
    print(json.dumps({"q6_from_bytes_profile": profile_device(
        q6_from_bytes, lambda out: check_q6(out, q6_want), top=8)}),
        flush=True)

    # the lineitem summary aggregates from parquet bytes
    sum_want = summary_oracle(li)
    got, sum_launches = run_path(
        "summary", lambda: compute_summary(scan_parquet(
            blobs["lineitem"], SUMMARY_COLUMNS, dev)), ("K3",))
    check_summary(got, sum_want)
    li_sum = scan_parquet(blobs["lineitem"], SUMMARY_COLUMNS, dev)
    k3_err = max(k3_err, check_k3_at("summary", summary_reductions(li_sum)))
    outs, sum_runs = timed(lambda: compute_summary(li_sum))
    del li_sum
    for out in outs:
        check_summary(out, sum_want)
    print(json.dumps({"summary": {
        **got, "compute_ms_runs": sum_runs,
        "compute_ms_median": float(np.median(sum_runs)),
        "launches_per_run": sum_launches, "verified": True}}), flush=True)

    # Q3 from parquet bytes
    def q3_from_bytes():
        return compute_q3(
            scan_parquet(blobs["lineitem"],
                         ["l_okey", "l_price", "l_disc", "l_sdate"], dev),
            scan_parquet(blobs["orders"], None, dev), CUTOFF)
    out, q3b_launches = run_path("Q3 from bytes", q3_from_bytes,
                                 ("K1", "K2"))
    check_q3(out, oracle)
    outs, runs = timed(q3_from_bytes)
    for out in outs:
        check_q3(out, oracle)
    print(json.dumps({"q3_from_bytes": {
        "ms_runs": runs, "ms_median": float(np.median(runs)),
        "launches_per_run": q3b_launches, "verified": True}}), flush=True)

    k1 = next(t for t in k1s if t["site"] == "filter_with_payload")
    k2 = time_k2(dev, cap, n_joined)
    k3s = time_k3(dev, P_li, n_li)
    for name, t in [("K2", k2)] + [("K3", t) for t in k3s]:
        print(f"{name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms")
    print(json.dumps({"k2_k3_timed": [k2] + k3s}), flush=True)
    if args.timing_only:
        print(f"total: {time.perf_counter() - t_start:.1f} s (timing only)")
        return 0
    k3 = k3s[0]
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
        {"name": "reduce", "route": "cuda",
         "source": "arrow_go_tpu_torch/csrc/reduce.cu",
         "replaces": "arrow_go_tpu/ops/reductions.py:132",
         "launches": q6_launches["K3"], "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes",
         "library_ms": k3["library_ms"]},
    ]
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
