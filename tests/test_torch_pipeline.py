"""The port's device pipeline as a whole, against the JAX package.

Q3 (benchmarks/engine_e2e.py:compute_ours) runs in both packages on the
same make_data inputs; the port's composition is the one chip_smoke.py
drives on the card. Groups and their order must be the same and counts
exact; revenues agree to rtol=1e-9 (engine_e2e.py:185's tolerance).
TPC-H Q6 and Q3 also run from parquet bytes written by the port's
writer: Q6 against the same composition in the JAX package and numpy,
Q3 against the device-resident run.
"""
import collections

import numpy as np

import arrow_go_tpu.compute as jpc
from arrow_go_tpu import dtypes as jdt
from arrow_go_tpu import parquet as jpq
from arrow_go_tpu.compute.functions import agg_sum as jax_agg_sum
from arrow_go_tpu.device.block import DeviceBatch as JaxDeviceBatch
from arrow_go_tpu.parquet.device_read import read_batch_device
from benchmarks.engine_e2e import compute_ours, make_data

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as tdt
from arrow_go_tpu_torch.device.block import DeviceBatch
from chip_smoke import (CUTOFF, Q6_DATE_HI, Q6_DATE_LO, Q6_DISC_HI,
                        Q6_DISC_LO, Q6_QTY, add_quantity, check_q3, check_q6,
                        check_summary, compute_q3, compute_q6,
                        compute_summary, q3_oracle, q6_oracle, scan_parquet,
                        summary_oracle, write_parquet)
from torch_parity import jax_batch, port_batch


def test_q3_matches_jax_and_oracle():
    li, orders = make_data(20_000, 5_000)
    jli, jord = jax_batch(li), jax_batch(orders)
    _, jout = compute_ours(jli, jord, CUTOFF)
    tout = compute_q3(port_batch(jli), port_batch(jord), CUTOFF)
    assert tout.schema.names == jout.schema.names
    assert tout.num_rows == jout.num_rows == 40
    for name in ("o_odate", "rev_count"):
        assert tout.column(name).to_pylist() == jout.column(name).to_pylist()
    np.testing.assert_allclose(tout.column("rev_sum").to_pylist(),
                               jout.column("rev_sum").to_pylist(),
                               rtol=1e-9)
    check_q3(tout, q3_oracle(li, orders, CUTOFF))


def test_device_resident_filter_join_group_by(rng):
    """tests/test_device_pipeline.py's composition, in the port."""
    n = 5000
    left = {"k": rng.integers(0, 50, n), "v": rng.standard_normal(n),
            "d": rng.integers(0, 30, n)}
    right = {"k": np.arange(50), "w": rng.integers(0, 9, 50)}
    ldb, rdb = port_batch(jax_batch(left)), port_batch(jax_batch(right))
    mask = pc.execute_scalar_expression(
        pc.call("greater", [pc.field("d"), pc.literal(10)]), ldb)
    f = pc.filter(ldb, mask)
    assert isinstance(f, DeviceBatch)
    j = pc.hash_join(f, rdb, "k")
    assert isinstance(j, DeviceBatch)
    rev = pc.execute_scalar_expression(
        pc.call("multiply", [pc.field("v"), pc.literal(2.0)]), j)
    jb = DeviceBatch(tdt.Schema([tdt.Field("w", tdt.int64),
                                 tdt.Field("rev", tdt.float64)]),
                     [j.column("w"), rev], j.length)
    g = pc.group_by(jb, "w", [("rev", "sum"), ("rev", "count")])

    w_of = dict(zip(range(50), right["w"]))
    sel = left["d"] > 10
    sums = collections.defaultdict(float)
    cnts = collections.Counter()
    for ki, vi in zip(left["k"][sel], left["v"][sel]):
        sums[int(w_of[ki])] += 2.0 * vi
        cnts[int(w_of[ki])] += 1
    got = dict(zip(g.column("w").to_pylist(),
                   zip(g.column("rev_sum").to_pylist(),
                       g.column("rev_count").to_pylist())))
    assert set(got) == set(sums)
    for wk in sums:
        np.testing.assert_allclose(got[wk][0], sums[wk], rtol=1e-9)
        assert got[wk][1] == cnts[wk]


def _jax_q6(li_db):
    """TPC-H Q6 composed of the JAX package's functions, as compute_q6
    composes the port's."""
    f, lit, call = jpc.field, jpc.literal, jpc.call
    conds = [call("greater_equal", [f("l_sdate"), lit(Q6_DATE_LO)]),
             call("less", [f("l_sdate"), lit(Q6_DATE_HI)]),
             call("greater_equal", [f("l_disc"), lit(Q6_DISC_LO)]),
             call("less_equal", [f("l_disc"), lit(Q6_DISC_HI)]),
             call("less", [f("l_qty"), lit(Q6_QTY)])]
    pred = conds[0]
    for c in conds[1:]:
        pred = call("and", [pred, c])
    mask = jpc.execute_scalar_expression(pred, li_db)
    keep = ["l_price", "l_disc"]
    proj = JaxDeviceBatch(jdt.Schema([li_db.schema.field(
        li_db.schema.field_index(n)) for n in keep]),
        [li_db.column(n) for n in keep], li_db.length)
    li_f = jpc.filter(proj, mask)
    rev = jpc.execute_scalar_expression(
        call("multiply", [f("l_price"), f("l_disc")]), li_f)
    return {"revenue": jax_agg_sum(rev), "count": li_f.length}


def _lineitem_bytes(n: int):
    li, orders = make_data(n, n // 4)
    add_quantity(li)
    return li, orders, write_parquet(li), write_parquet(orders)


def test_q6_from_parquet_bytes_matches_jax_and_oracle():
    li, _, li_blob, _ = _lineitem_bytes(60_000)
    got = compute_q6(scan_parquet(li_blob, device="cpu"))
    want = q6_oracle(li)
    check_q6(got, want)
    jax_got = _jax_q6(read_batch_device(jpq.ParquetFile(li_blob), 0))
    assert got["count"] == jax_got["count"] == want["count"] > 100
    np.testing.assert_allclose(got["revenue"], jax_got["revenue"],
                               rtol=1e-9)


def test_lineitem_summary_from_parquet_bytes():
    li, _, li_blob, _ = _lineitem_bytes(30_000)
    got = compute_summary(scan_parquet(li_blob, device="cpu"))
    check_summary(got, summary_oracle(li))
    jdb = read_batch_device(jpq.ParquetFile(li_blob), 0)
    assert got["sum_qty"] == jax_agg_sum(jdb.column("l_qty"))


def test_q3_from_parquet_bytes_matches_device_resident():
    li, orders, li_blob, ord_blob = _lineitem_bytes(20_000)
    resident = compute_q3(port_batch(jax_batch({
        k: li[k] for k in ("l_okey", "l_price", "l_disc", "l_sdate")})),
        port_batch(jax_batch(orders)), CUTOFF)
    from_bytes = compute_q3(
        scan_parquet(li_blob, ["l_okey", "l_price", "l_disc", "l_sdate"],
                     device="cpu"),
        scan_parquet(ord_blob, device="cpu"), CUTOFF)
    assert from_bytes.to_pydict() == resident.to_pydict()
    check_q3(from_bytes, q3_oracle(li, orders, CUTOFF))
