"""The generators against the rules their sources state."""
import numpy as np
import pytest
import torch

from portbench.generators import ssb, tpch
from portbench.harness.tables import date_day


@pytest.fixture(scope="module")
def tp():
    return tpch.generate({"scale_factor": 0.01}, 2 ** 31 + 5, "cpu")


@pytest.fixture(scope="module")
def sb():
    return ssb.generate({"scale_factor": 0.01}, 2 ** 31 + 5, "cpu")


def _np(col):
    return col.values.numpy()


def test_tpch_cardinalities(tp):
    assert len(_np(tp["customer"]["c_custkey"])) == 1500
    assert len(_np(tp["orders"]["o_orderkey"])) == 15000
    n = len(_np(tp["lineitem"]["l_orderkey"]))
    assert 15000 <= n <= 7 * 15000 and abs(n / 15000 - 4) < 0.1


def test_tpch_one_to_seven_lines_an_order(tp):
    okey = _np(tp["orders"]["o_orderkey"])
    lines = np.searchsorted(okey, _np(tp["lineitem"]["l_orderkey"]))
    assert np.all(okey[lines] == _np(tp["lineitem"]["l_orderkey"]))
    cnt = np.bincount(lines, minlength=len(okey))
    assert cnt.min() == 1 and cnt.max() == 7


def test_tpch_sparse_orderkeys(tp):
    okey = _np(tp["orders"]["o_orderkey"])
    assert np.all(np.diff(okey) > 0)
    assert np.all((okey - 1) % 32 < 8)


def test_tpch_custkey_never_a_multiple_of_3(tp):
    ck = _np(tp["orders"]["o_custkey"])
    assert np.all(ck % 3 != 0) and ck.min() >= 1 and ck.max() <= 1500


def test_tpch_dates(tp):
    o, li = tp["orders"], tp["lineitem"]
    odate = _np(o["o_orderdate"])
    assert odate.min() >= date_day("1992-01-01")
    assert odate.max() <= date_day("1998-12-31") - 151
    row = np.searchsorted(_np(o["o_orderkey"]), _np(li["l_orderkey"]))
    ship = _np(li["l_shipdate"]) - odate[row]
    commit = _np(li["l_commitdate"]) - odate[row]
    receipt = _np(li["l_receiptdate"]) - _np(li["l_shipdate"])
    assert ship.min() == 1 and ship.max() == 121
    assert commit.min() == 30 and commit.max() == 90
    assert receipt.min() == 1 and receipt.max() == 30


def test_tpch_flags_follow_currentdate(tp):
    li = tp["lineitem"]
    cur = date_day("1995-06-17")
    rf = np.array(li["l_returnflag"].dictionary)[_np(li["l_returnflag"])]
    ls = np.array(li["l_linestatus"].dictionary)[_np(li["l_linestatus"])]
    received = _np(li["l_receiptdate"]) <= cur
    assert set(rf[received]) == {"R", "A"} and set(rf[~received]) == {"N"}
    assert np.all((ls == "O") == (_np(li["l_shipdate"]) > cur))


def test_tpch_prices(tp):
    li = tp["lineitem"]
    qty = _np(li["l_quantity"])
    assert qty.min() == 1 and qty.max() == 50
    unit = _np(li["l_extendedprice"]) / qty
    assert unit.min() >= 900.0 and unit.max() <= 2099.0 + 1e-9
    assert np.all(np.isin(np.round(_np(li["l_discount"]) * 100), range(11)))
    assert np.all(np.isin(np.round(_np(li["l_tax"]) * 100), range(9)))


def test_tpch_retail_price_formula():
    pk = torch.tensor([1, 10, 199999, 200000])
    want = [(90000 + ((k // 10) % 20001) + 100 * (k % 1000)) for k in
            pk.tolist()]
    assert tpch.retail_price_cents(pk).tolist() == want


def test_same_seed_same_tables_and_another_seed_other_tables():
    a = tpch.generate({"scale_factor": 0.002}, 9, "cpu")
    b = tpch.generate({"scale_factor": 0.002}, 9, "cpu")
    c = tpch.generate({"scale_factor": 0.002}, 10, "cpu")
    for t in a:
        for k in a[t]:
            assert torch.equal(a[t][k].values, b[t][k].values)
    assert not torch.equal(a["lineitem"]["l_shipdate"].values[:100],
                           c["lineitem"]["l_shipdate"].values[:100])


def test_ssb_keys_in_range(sb):
    lo = sb["lineorder"]
    for fk, table, key in (("lo_custkey", "customer", "c_custkey"),
                           ("lo_suppkey", "supplier", "s_suppkey"),
                           ("lo_partkey", "part", "p_partkey"),
                           ("lo_orderdate", "date", "d_datekey")):
        assert np.all(np.isin(_np(lo[fk]), _np(sb[table][key])))
    assert np.all(_np(lo["lo_custkey"]) % 3 != 0)


def test_ssb_sizes(sb):
    assert len(_np(sb["customer"]["c_custkey"])) == 300
    assert len(_np(sb["supplier"]["s_suppkey"])) == 20
    assert len(_np(sb["part"]["p_partkey"])) == 200_000
    assert len(_np(sb["date"]["d_datekey"])) == 2556
    assert ssb.generate.__module__ == "portbench.generators.ssb"


def test_ssb_columns(sb):
    lo = sb["lineorder"]
    qty, disc = _np(lo["lo_quantity"]), _np(lo["lo_discount"])
    ext = _np(lo["lo_extendedprice"]).astype(np.int64)
    assert qty.min() == 1 and qty.max() == 50
    assert disc.min() == 0 and disc.max() == 10
    assert np.all(_np(lo["lo_revenue"]) == ext * (100 - disc) // 100)
    d = sb["date"]
    assert _np(d["d_datekey"])[0] == 19920101
    assert np.array(d["d_yearmonth"].dictionary)[
        _np(d["d_yearmonth"])][-1] == "Dec1998"
    assert _np(d["d_weeknuminyear"]).max() == 53


def test_ssb_places_and_parts(sb):
    c = sb["customer"]
    city = np.array(c["c_city"].dictionary)[_np(c["c_city"])]
    nation = np.array(c["c_nation"].dictionary)[_np(c["c_nation"])]
    assert all(ci[:9] == f"{n[:9]:<9}" for ci, n in zip(city, nation))
    regions = dict(ssb.NATIONS)
    region = np.array(c["c_region"].dictionary)[_np(c["c_region"])]
    assert all(regions[n] == r for n, r in zip(nation, region))
    p = sb["part"]
    brand = np.array(p["p_brand1"].dictionary)[_np(p["p_brand1"])]
    cat = np.array(p["p_category"].dictionary)[_np(p["p_category"])]
    assert all(b.startswith(ca) and 8 <= len(b) <= 9
               for b, ca in zip(brand[:1000], cat[:1000]))
    assert len(set(brand)) == 1000


def test_dictionaries_in_string_order(tp, sb):
    for t in (tp, sb):
        for cols in t.values():
            for col in cols.values():
                if col.dictionary is not None:
                    assert list(col.dictionary) == sorted(col.dictionary)
