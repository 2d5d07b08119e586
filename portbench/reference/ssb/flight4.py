"""Plain SSB flight 4: SUM(lo_revenue - lo_supplycost) by the groups of
each query over the kept customers, suppliers, parts and dates."""
from portbench.reference.common import grouped, sort_rows, star


def profit(t, c_mask, s_mask, p_mask, d_mask, keys, acc):
    """keys: [(table, attribute)], the GROUP BY and ORDER BY columns."""
    lo = t["lineorder"]
    want = {name: [a for tb, a in keys if tb == name]
            for name in ("customer", "supplier", "part", "date")}
    keep, a = star(lo, [
        ("lo_suppkey", t["supplier"], "s_suppkey", s_mask, want["supplier"]),
        ("lo_custkey", t["customer"], "c_custkey", c_mask, want["customer"]),
        ("lo_partkey", t["part"], "p_partkey", p_mask, want["part"]),
        ("lo_orderdate", t["date"], "d_datekey", d_mask, want["date"])])
    v = lo["lo_revenue"].values[keep].to(acc) \
        - lo["lo_supplycost"].values[keep].to(acc)
    g = grouped({attr: a[attr] for _, attr in keys}, v, acc, "profit_sum",
                {attr: t[tb][attr] for tb, attr in keys})
    return sort_rows(g, [attr for _, attr in keys])


def years_1997_1998(t):
    y = t["date"]["d_year"].values
    return (y == 1997) | (y == 1998)
