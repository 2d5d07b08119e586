"""Plain SSB flight 1: SUM(lo_extendedprice * lo_discount) over the
lines of the kept dates, discounts and quantities."""
import numpy as np

from portbench.reference.common import star


def revenue(t, date_mask, disc_lo, qty_lo, qty_hi, acc):
    lo = t["lineorder"]
    disc, qty = lo["lo_discount"].values, lo["lo_quantity"].values
    keep, _ = star(lo, [("lo_orderdate", t["date"], "d_datekey", date_mask,
                         [])])
    keep &= (disc >= disc_lo) & (disc <= disc_lo + 2) & (qty >= qty_lo) \
        & (qty <= qty_hi)
    v = (lo["lo_extendedprice"].values[keep].to(acc)
         * disc[keep].to(acc)).sum(dtype=acc)
    return {"revenue": np.array([int(v)], np.int64)}
