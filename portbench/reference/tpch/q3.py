"""Plain TPC-H Q3 (see portbench/queries/tpch/q3.py for the SQL)."""
import numpy as np
import torch

from portbench.reference.common import day, host, isin, row_of


def run(t, p, acc):
    c, o, li = t["customer"], t["orders"], t["lineitem"]
    d = day(p["date"])
    seg_ok = isin(c["c_mktsegment"], [p["segment"]])
    crow, chit = row_of(c["c_custkey"].values, o["o_custkey"].values)
    o_ok = (o["o_orderdate"].values < d) & chit & seg_ok[crow]
    orow, ohit = row_of(o["o_orderkey"].values, li["l_orderkey"].values)
    m = (li["l_shipdate"].values > d) & ohit & o_ok[orow]
    rows = orow[m]
    price = li["l_extendedprice"].values[m].to(acc)
    disc = li["l_discount"].values[m].to(acc)
    rev = torch.zeros(len(o_ok), dtype=acc, device=rows.device).index_add_(
        0, rows, price * (1 - disc))
    hit = torch.zeros(len(o_ok), dtype=torch.bool, device=rows.device)
    hit[rows] = True
    cand = torch.nonzero(hit).flatten()
    # ORDER BY revenue DESC, o_orderdate: sort by the minor key first,
    # then stably by the major one
    odate = o["o_orderdate"].values[cand]
    by_date = torch.argsort(odate, stable=True)
    cand = cand[by_date]
    cand = cand[torch.argsort(-rev[cand], stable=True)][:10]
    return {
        "l_orderkey": host(o["o_orderkey"].values[cand]).astype(np.int64),
        "o_orderdate": host(o["o_orderdate"].values[cand]).astype(np.int64),
        "o_shippriority": host(o["o_shippriority"].values[cand]).astype(
            np.int64),
        "revenue_sum": host(rev[cand]).astype(np.float64),
    }
