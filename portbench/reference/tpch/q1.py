"""Plain TPC-H Q1 (see portbench/queries/tpch/q1.py for the SQL)."""
import numpy as np
import torch

from portbench.reference.common import day, group_sums, host


def run(t, p, acc):
    li = t["lineitem"]
    m = li["l_shipdate"].values <= day("1998-12-01") - p["delta"]
    rf, ls = li["l_returnflag"], li["l_linestatus"]
    nls = len(ls.dictionary)
    n = len(rf.dictionary) * nls
    key = rf.values[m].long() * nls + ls.values[m].long()
    qty, price, disc, tax = (li[c].values[m].to(acc) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (1 - disc)
    charge = disc_price * (1 + tax)
    cnt = torch.bincount(key, minlength=n)
    s_qty, s_price, s_dp, s_ch, s_disc = group_sums(
        key, n, [qty, price, disc_price, charge, disc], acc)
    present = [k for k in host(torch.nonzero(cnt).flatten()).tolist()]
    present.sort(key=lambda k: (rf.dictionary[k // nls],
                                ls.dictionary[k % nls]))
    ks = torch.tensor(present, dtype=torch.long, device=key.device)
    c = cnt[ks]
    f64 = lambda x: host(x[ks]).astype(np.float64)   # noqa: E731
    return {
        "l_returnflag": np.array([rf.dictionary[k // nls] for k in present],
                                 dtype=object),
        "l_linestatus": np.array([ls.dictionary[k % nls] for k in present],
                                 dtype=object),
        "l_quantity_sum": f64(s_qty),
        "l_extendedprice_sum": f64(s_price),
        "disc_price_sum": f64(s_dp),
        "charge_sum": f64(s_ch),
        "l_quantity_mean": host(s_qty[ks] / c).astype(np.float64),
        "l_extendedprice_mean": host(s_price[ks] / c).astype(np.float64),
        "l_discount_mean": host(s_disc[ks] / c).astype(np.float64),
        "l_quantity_count_all": host(c).astype(np.int64),
    }
