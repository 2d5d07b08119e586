"""SSB Q3.3:

    SELECT c_city, s_city, d_year, SUM(lo_revenue) AS revenue
    FROM customer, lineorder, supplier, date
    WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
      AND lo_orderdate = d_datekey
      AND (c_city = ':city1' OR c_city = ':city2')
      AND (s_city = ':city1' OR s_city = ':city2')
      AND d_year >= 1992 AND d_year <= 1997
    GROUP BY c_city, s_city, d_year
    ORDER BY d_year ASC, revenue DESC

(the two cities: the nation's name cut to 9 characters and a digit)
"""
import arrow_go_tpu_torch.compute as pc

from portbench.queries.common import all_of, isin, join, ordered, where


def run(db, p, ctx):
    f, lit, call = pc.field, pc.literal, pc.call
    cities = [f"{p['nation'][:9]:<9}{d}" for d in p["digits"]]
    with ctx.span("filter"):
        cust = where(db["customer"], isin("c_city", cities),
                     ["c_custkey", "c_city"])
        supp = where(db["supplier"], isin("s_city", cities),
                     ["s_suppkey", "s_city"])
        date = where(db["date"], all_of(
            call("greater_equal", [f("d_year"), lit(1992)]),
            call("less_equal", [f("d_year"), lit(1997)])),
            ["d_datekey", "d_year"])
    with ctx.span("hash_join"):
        j = join(db["lineorder"], supp, "lo_suppkey", "s_suppkey",
                 ["lo_custkey", "lo_orderdate", "lo_revenue", "s_city"])
        j = join(j, cust, "lo_custkey", "c_custkey",
                 ["lo_orderdate", "lo_revenue", "s_city", "c_city"])
        j = join(j, date, "lo_orderdate", "d_datekey",
                 ["lo_revenue", "s_city", "c_city", "d_year"])
    with ctx.span("group_by"):
        g = pc.group_by(j, ["c_city", "s_city", "d_year"],
                        [("lo_revenue", "sum")])
    with ctx.span("sort_take"):
        return ordered(g, ["d_year", ("lo_revenue_sum", "descending")],
                       ctx.device)
