"""The port's device pipeline as a whole, against the JAX package.

Q3 (benchmarks/engine_e2e.py:compute_ours) runs in both packages on the
same make_data inputs; the port's composition is the one chip_smoke.py
drives on the card. Groups and their order must be the same and counts
exact; revenues agree to rtol=1e-9 (engine_e2e.py:185's tolerance).
TPC-H Q6 and Q3 also run from parquet bytes written by the port's
writer: Q6 against the same composition in the JAX package and numpy,
Q3 against the device-resident run. TPC-H Q1 (string group keys, sums,
means, COUNT(*), ORDER BY the keys) runs device-resident in both
packages and from the port's snappy files, against numpy. TPC-H Q4 (a
semi join), Q12 (an inner join carrying strings, IN, CASE) and Q13 (a
left outer join and two group-bys) run device-resident in both
packages and against numpy, as do the join sweep and the functions
phase of chip_smoke.py at a small size.
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
from chip_smoke import (CUTOFF, Q1_COLUMNS, Q1_SHIPDATE_MAX, Q1_SUMS,
                        Q4_ODATE_HI, Q4_ODATE_LO, Q6_DATE_HI, Q6_DATE_LO,
                        Q6_DISC_HI, Q6_DISC_LO, Q6_QTY, Q12_HIGH,
                        Q12_MODES, Q12_RDATE_HI, Q12_RDATE_LO, SWEEP_HOWS,
                        add_join_columns, add_q1_columns, add_quantity,
                        aggs_oracle, check_aggs, check_functions, check_q1,
                        check_q3, check_q6, check_rows, check_summary,
                        compute_aggs, compute_functions, compute_q1,
                        compute_q3, compute_q4, compute_q6, compute_q12,
                        compute_q13, compute_summary, functions_oracle,
                        product_factors, q1_oracle, q3_oracle, q4_oracle,
                        q6_oracle, q12_oracle, q13_oracle, scan_parquet,
                        summary_oracle, sweep_checksums, sweep_host_batch,
                        sweep_join, sweep_oracle, sweep_sides,
                        write_parquet)
from torch_parity import jax_batch, port_batch

import arrow_go_tpu_torch as agt_torch


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


def _q1_lineitem(n: int):
    li, _ = make_data(n, n // 4)
    add_quantity(li)
    add_q1_columns(li)
    return li


def _jax_q1(li_db):
    """TPC-H Q1 composed of the JAX package's functions, as compute_q1
    composes the port's."""
    f, lit, call = jpc.field, jpc.literal, jpc.call
    mask = jpc.execute_scalar_expression(
        call("less_equal", [f("l_sdate"), lit(Q1_SHIPDATE_MAX)]), li_db)
    keep = Q1_COLUMNS[:-1]
    li_f = jpc.filter(JaxDeviceBatch(jdt.Schema([li_db.schema.field(
        li_db.schema.field_index(c)) for c in keep]),
        [li_db.column(c) for c in keep], li_db.length), mask)
    dp = jpc.execute_scalar_expression(call("multiply", [
        f("l_price"), call("subtract", [lit(1.0), f("l_disc")])]), li_f)
    with_dp = JaxDeviceBatch(jdt.Schema(list(li_f.schema.fields) + [
        jdt.Field("disc_price", jdt.float64)]), li_f.columns + [dp],
        li_f.length)
    charge = jpc.execute_scalar_expression(call("multiply", [
        f("disc_price"), call("add", [lit(1.0), f("l_tax")])]), with_dp)
    gb = JaxDeviceBatch(jdt.Schema(list(with_dp.schema.fields) + [
        jdt.Field("charge", jdt.float64)]), with_dp.columns + [charge],
        with_dp.length)
    g = jpc.group_by(gb, ["l_rflag", "l_lstatus"], Q1_SUMS)
    idx = jpc.sort_indices(g, jpc.SortOptions(
        keys=[jpc.SortKey("l_rflag"), jpc.SortKey("l_lstatus")]))
    return jpc.take(g, idx)


def _same_q1(tout, jout) -> None:
    assert tout.schema.names == jout.schema.names
    for name in tout.schema.names:
        got, want = tout.column(name).to_pylist(), \
            jout.column(name).to_pylist()
        if tout.column(name).type == tdt.float64:
            np.testing.assert_allclose(got, want, rtol=1e-9, err_msg=name)
        else:
            assert got == want, name


def test_q1_matches_jax_and_oracle():
    li = _q1_lineitem(20_000)
    data = {c: li[c] for c in Q1_COLUMNS}
    for c in ("l_rflag", "l_lstatus"):
        codes, values = li[c]
        data[c] = values[codes]         # strings, as the JAX package takes
    jdb = jax_batch(data)
    tout = compute_q1(port_batch(jdb))
    _same_q1(tout, _jax_q1(jdb))
    want = q1_oracle(li)
    check_q1(tout, want)
    assert tout.num_rows == 4
    assert tout.column("l_rflag").to_pylist() == ["A", "N", "N", "R"]
    # the (codes, values) pairs on the port's device as they stand
    check_q1(compute_q1(agt_torch.batch_to_device(
        {c: li[c] for c in Q1_COLUMNS}, device="cpu")), want)


def test_q1_from_snappy_bytes_matches_jax_and_oracle():
    li = _q1_lineitem(30_000)
    blob = write_parquet(li, "snappy")
    got = compute_q1(scan_parquet(blob, Q1_COLUMNS, device="cpu"))
    check_q1(got, q1_oracle(li))
    _same_q1(got, _jax_q1(read_batch_device(jpq.ParquetFile(blob), 0,
                                            columns=Q1_COLUMNS)))


def test_every_other_aggregation_over_scanned_lineitem():
    li = _q1_lineitem(20_000)
    blob = write_parquet(li, "snappy")
    li_s = scan_parquet(blob, ["l_rflag", "l_sdate", "l_price", "l_qty"],
                        device="cpu")
    pfac = product_factors(len(li["l_sdate"]))
    pfac[::997] = 2                      # nonzero products to compare
    col = agt_torch.batch_to_device({"p": pfac}, device="cpu").column(0)
    want = aggs_oracle(li, pfac)
    check_aggs(compute_aggs(li_s, col), want)
    assert sorted(want["l_rflag"]) == ["A", "N", "R"]
    assert max(abs(p) for p in want["l_pfac_product"]) > 2 ** 5


def _join_tables(n: int):
    """make_data at n lineitem rows with the Q4/Q12/Q13 columns, as
    numpy (strings as str arrays) and as both packages' batches."""
    li, orders = make_data(n, n // 4)
    customer = add_join_columns(li, orders)
    np_li = {c: li[c] for c in ("l_okey", "l_sdate", "l_cdate", "l_rdate")}
    np_li["l_smode"] = li["l_smode"][1][li["l_smode"][0]]
    np_ord = {c: orders[c] for c in ("o_okey", "o_odate", "o_custkey")}
    np_ord["o_opri"] = orders["o_opri"][1][orders["o_opri"][0]]
    jli, jord, jcust = jax_batch(np_li), jax_batch(np_ord), jax_batch(
        customer)
    return li, orders, customer, (jli, jord, jcust), (
        port_batch(jli), port_batch(jord), port_batch(jcust))


def _jproject(db, names):
    return JaxDeviceBatch(jdt.Schema([db.schema.field(
        db.schema.field_index(n)) for n in names]),
        [db.column(n) for n in names], db.length)


def _jsorted(g, *keys):
    return jpc.take(g, jpc.sort_indices(g, jpc.SortOptions(
        keys=[jpc.SortKey(k, o) for k, o in keys])))


def _jax_q4(jli, jord):
    """TPC-H Q4 composed of the JAX package's functions."""
    from arrow_go_tpu.compute.join import _key_codes
    from arrow_go_tpu.device.block import DeviceColumn, row_mask
    from arrow_go_tpu.parallel.join import local_join_semi
    f, lit, call = jpc.field, jpc.literal, jpc.call
    om = jpc.execute_scalar_expression(call("and", [
        call("greater_equal", [f("o_odate"), lit(Q4_ODATE_LO)]),
        call("less", [f("o_odate"), lit(Q4_ODATE_HI)])]), jord)
    ord_f = jpc.filter(_jproject(jord, ["o_okey", "o_opri"]), om)
    lm = jpc.execute_scalar_expression(
        call("less", [f("l_cdate"), f("l_rdate")]), jli)
    li_f = jpc.filter(_jproject(jli, ["l_okey"]), lm)
    oc, lc = _key_codes(ord_f, li_f, ["o_okey"], ["l_okey"])
    verdict = local_join_semi(
        oc, row_mask(ord_f.padded, ord_f.length) & (oc >= 0), lc,
        row_mask(li_f.padded, li_f.length) & (lc >= 0), "left semi")
    hits = jpc.filter(ord_f, DeviceColumn(verdict, None, ord_f.length,
                                          jdt.bool_))
    g = jpc.group_by(hits, "o_opri", [("o_okey", "count_all")])
    return _jsorted(g, ("o_opri", "ascending"))


def _jax_q12(jli, jord):
    """TPC-H Q12 composed of the JAX package's functions; its if_else
    takes no two literals, so the CASE's 1 rides a column of ones."""
    from arrow_go_tpu.compute import functions as jf
    from arrow_go_tpu.compute import kernels as jk
    f, lit, call = jpc.field, jpc.literal, jpc.call
    pred = call("is_in", [f("l_smode")], {"value_set": Q12_MODES})
    for c in (call("less", [f("l_cdate"), f("l_rdate")]),
              call("less", [f("l_sdate"), f("l_cdate")]),
              call("greater_equal", [f("l_rdate"), lit(Q12_RDATE_LO)]),
              call("less", [f("l_rdate"), lit(Q12_RDATE_HI)])):
        pred = call("and", [pred, c])
    li_f = jpc.filter(_jproject(jli, ["l_okey", "l_smode"]),
                      jpc.execute_scalar_expression(pred, jli))
    joined = jpc.hash_join(li_f, _jproject(jord, ["o_okey", "o_opri"]),
                           left_keys=["l_okey"], right_keys=["o_okey"],
                           output_columns=["l_smode", "o_opri"])
    high = jpc.execute_scalar_expression(
        call("is_in", [f("o_opri")], {"value_set": Q12_HIGH}), joined)
    ones = jk._broadcast_scalar(1, jdt.int64, joined.padded, joined.length)
    cols = [jf.if_else(c, ones, 0) for c in (high, jk.invert(high))]
    gb = JaxDeviceBatch(jdt.Schema([jdt.Field("l_smode", jdt.string),
                                    jdt.Field("high", jdt.int64),
                                    jdt.Field("low", jdt.int64)]),
                        [joined.column("l_smode")] + cols, joined.length)
    g = jpc.group_by(gb, "l_smode", [("high", "sum"), ("low", "sum")])
    return _jsorted(g, ("l_smode", "ascending"))


def _jax_q13(jcust, jord):
    """TPC-H Q13 composed of the JAX package's functions."""
    import arrow_go_tpu as agt
    from arrow_go_tpu.device.block import batch_to_device
    joined = jpc.hash_join(jcust, _jproject(jord, ["o_okey", "o_custkey"]),
                           left_keys=["c_custkey"], right_keys=["o_custkey"],
                           join_type="left outer",
                           output_columns=["c_custkey", "o_okey"])
    per_cust = jpc.group_by(joined, "c_custkey", [("o_okey", "count")])
    counts = batch_to_device(agt.record_batch({"c_count": agt.from_numpy(
        np.asarray(per_cust.column("o_okey_count").to_pylist()))}))
    g = jpc.group_by(counts, "c_count", [("c_count", "count_all")])
    return _jsorted(g, ("c_count_count_all", "descending"),
                    ("c_count", "descending"))


def _rows(rb) -> dict:
    return {n: rb.column(i).to_pylist()
            for i, n in enumerate(rb.schema.names)}


def test_q4_q12_q13_match_jax_and_oracle():
    li, orders, customer, (jli, jord, jcust), (tli, tord, tcust) = \
        _join_tables(40_000)
    q4 = compute_q4(tli, tord)
    assert q4.to_pydict() == _rows(_jax_q4(jli, jord))
    check_rows("q4", q4, q4_oracle(li, orders))
    q12 = compute_q12(tli, tord)
    assert q12.to_pydict() == _rows(_jax_q12(jli, jord))
    check_rows("q12", q12, q12_oracle(li, orders))
    assert q12.column("l_smode").to_pylist() == ["MAIL", "SHIP"]
    q13 = compute_q13(tcust, tord)
    assert q13.to_pydict() == _rows(_jax_q13(jcust, jord))
    want = q13_oracle(orders, len(customer["c_custkey"]))
    check_rows("q13", q13, want)
    # about a third of the customers have no order: count 0
    assert 0 in want["c_count"]


def test_join_columns_follow_the_spec():
    li, orders = make_data(30_000, 7_500)
    customer = add_join_columns(li, orders)
    assert not np.any(orders["o_custkey"] % 3 == 0)
    assert orders["o_custkey"].min() >= 1
    assert orders["o_custkey"].max() <= len(customer["c_custkey"])
    d = li["l_rdate"] - li["l_sdate"]
    assert d.min() == 1 and d.max() == 30
    d = li["l_cdate"] - li["l_sdate"]
    assert d.min() >= 30 - 121 and d.max() <= 90 - 1


def test_join_sweep_matches_numpy_on_both_routes():
    li, orders = make_data(30_000, 7_500)
    add_join_columns(li, orders)
    sides = sweep_sides(li, orders)
    hosts = tuple(sweep_host_batch(s) for s in sides)
    devs = tuple(agt_torch.compute.join.host_batch_to_device(h, "cpu")
                 for h in hosts)
    for how in SWEEP_HOWS:
        want = sweep_oracle(*sides, how)
        assert want["rows"] > 0
        routes = ("device", "host") if how in SWEEP_HOWS[:4] else ("host",)
        for route in routes:
            assert sweep_checksums(sweep_join(how, route, hosts,
                                              devs)) == want, (how, route)


def test_functions_phase_matches_numpy():
    li = _q1_lineitem(20_000)
    blob = write_parquet(li, "snappy")
    li_s = scan_parquet(blob, ["l_rflag", "l_lstatus", "l_qty", "l_price",
                               "l_okey"], device="cpu")
    pfac = product_factors(len(li["l_okey"]))
    pfac[::997] = 2
    col = agt_torch.batch_to_device({"p": pfac}, device="cpu").column(0)
    want = functions_oracle(li, pfac)
    check_functions(compute_functions(li_s, col), want)
    assert want["product"] > 2 ** 5
