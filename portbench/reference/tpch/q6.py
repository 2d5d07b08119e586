"""Plain TPC-H Q6 (see portbench/queries/tpch/q6.py for the SQL)."""
import numpy as np

from portbench.reference.common import add_months, day


def run(t, p, acc):
    li = t["lineitem"]
    start = f"{p['year']}-01-01"
    lo, hi = round(p["discount"] - 0.01, 2), round(p["discount"] + 0.01, 2)
    sd, disc = li["l_shipdate"].values, li["l_discount"].values
    m = ((sd >= day(start)) & (sd < add_months(start, 12)) & (disc >= lo)
         & (disc <= hi) & (li["l_quantity"].values < float(p["quantity"])))
    rev = (li["l_extendedprice"].values[m].to(acc) * disc[m].to(acc)).sum()
    return {"revenue": np.array([float(rev)], np.float64)}
