"""Plain SSB flight 3: SUM(lo_revenue) by (customer place, supplier
place, d_year) over the kept customers, suppliers and dates, ordered by
d_year and then revenue, descending."""
from portbench.reference.common import grouped, sort_rows, star


def revenue_by_places(t, c_mask, s_mask, d_mask, c_attr, s_attr, acc):
    lo, cust, supp = t["lineorder"], t["customer"], t["supplier"]
    keep, a = star(lo, [
        ("lo_suppkey", supp, "s_suppkey", s_mask, [s_attr]),
        ("lo_custkey", cust, "c_custkey", c_mask, [c_attr]),
        ("lo_orderdate", t["date"], "d_datekey", d_mask, ["d_year"])])
    g = grouped({c_attr: a[c_attr], s_attr: a[s_attr], "d_year": a["d_year"]},
                lo["lo_revenue"].values[keep], acc, "lo_revenue_sum",
                {c_attr: cust[c_attr], s_attr: supp[s_attr]})
    return sort_rows(g, ["d_year", ("lo_revenue_sum", "descending")])


def years_1992_1997(t):
    y = t["date"]["d_year"].values
    return (y >= 1992) & (y <= 1997)


def cities(p):
    return [f"{p['nation'][:9]:<9}{d}" for d in p["digits"]]
