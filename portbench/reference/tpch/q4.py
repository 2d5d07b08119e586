"""Plain TPC-H Q4 (see portbench/queries/tpch/q4.py for the SQL)."""
import numpy as np
import torch

from portbench.reference.common import add_months, day, host, row_of


def run(t, p, acc):
    o, li = t["orders"], t["lineitem"]
    od = o["o_orderdate"].values
    o_ok = (od >= day(p["date"])) & (od < add_months(p["date"], 3))
    late = li["l_commitdate"].values < li["l_receiptdate"].values
    orow, ohit = row_of(o["o_orderkey"].values, li["l_orderkey"].values[late])
    exists = torch.zeros(len(od), dtype=torch.bool, device=od.device)
    exists[orow[ohit]] = True
    pri = o["o_orderpriority"]
    cnt = host(torch.bincount(pri.values[o_ok & exists].long(),
                              minlength=len(pri.dictionary)))
    present = sorted((v, k) for k, v in enumerate(pri.dictionary) if cnt[k])
    return {"o_orderpriority": np.array([v for v, _ in present], object),
            "o_orderkey_count_all": np.array([cnt[k] for _, k in present],
                                             np.int64)}
