"""Plain TPC-H Q12 (see portbench/queries/tpch/q12.py for the SQL)."""
import numpy as np
import torch

from portbench.reference.common import add_months, day, host, isin, row_of

HIGH = ["1-URGENT", "2-HIGH"]


def run(t, p, acc):
    o, li = t["orders"], t["lineitem"]
    start = f"{p['year']}-01-01"
    cd, rd = li["l_commitdate"].values, li["l_receiptdate"].values
    mode = li["l_shipmode"]
    m = (isin(mode, p["shipmodes"]) & (cd < rd)
         & (li["l_shipdate"].values < cd) & (rd >= day(start))
         & (rd < add_months(start, 12)))
    orow, ohit = row_of(o["o_orderkey"].values, li["l_orderkey"].values[m])
    high = isin(o["o_orderpriority"], HIGH)[orow] & ohit
    codes = mode.values[m].long()[ohit]
    high = high[ohit]
    n = len(mode.dictionary)
    hi = host(torch.bincount(codes[high], minlength=n))
    lo = host(torch.bincount(codes[~high], minlength=n))
    present = sorted((v, k) for k, v in enumerate(mode.dictionary)
                     if hi[k] + lo[k])
    return {"l_shipmode": np.array([v for v, _ in present], object),
            "high_line_sum": np.array([hi[k] for _, k in present], np.int64),
            "low_line_sum": np.array([lo[k] for _, k in present], np.int64)}
