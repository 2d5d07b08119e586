"""Plain SSB flight 2: SUM(lo_revenue) by (d_year, p_brand1) over the
kept parts and the suppliers of one region."""
from portbench.reference.common import grouped, isin, sort_rows, star


def revenue_by_brand(t, part_mask, region, acc):
    lo, part, supp = t["lineorder"], t["part"], t["supplier"]
    keep, a = star(lo, [
        ("lo_partkey", part, "p_partkey", part_mask, ["p_brand1"]),
        ("lo_suppkey", supp, "s_suppkey", isin(supp["s_region"], [region]),
         []),
        ("lo_orderdate", t["date"], "d_datekey", None, ["d_year"])])
    g = grouped({"d_year": a["d_year"], "p_brand1": a["p_brand1"]},
                lo["lo_revenue"].values[keep], acc, "lo_revenue_sum",
                {"p_brand1": part["p_brand1"]})
    return sort_rows(g, ["d_year", "p_brand1"])
