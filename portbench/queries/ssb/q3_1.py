"""SSB Q3.1:

    SELECT c_nation, s_nation, d_year, SUM(lo_revenue) AS revenue
    FROM customer, lineorder, supplier, date
    WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
      AND lo_orderdate = d_datekey AND c_region = ':region'
      AND s_region = ':region' AND d_year >= 1992 AND d_year <= 1997
    GROUP BY c_nation, s_nation, d_year
    ORDER BY d_year ASC, revenue DESC
"""
import arrow_go_tpu_torch.compute as pc

from portbench.queries.common import all_of, isin, join, ordered, where


def run(db, p, ctx):
    f, lit, call = pc.field, pc.literal, pc.call
    with ctx.span("filter"):
        cust = where(db["customer"], isin("c_region", [p["region"]]),
                     ["c_custkey", "c_nation"])
        supp = where(db["supplier"], isin("s_region", [p["region"]]),
                     ["s_suppkey", "s_nation"])
        date = where(db["date"], all_of(
            call("greater_equal", [f("d_year"), lit(1992)]),
            call("less_equal", [f("d_year"), lit(1997)])),
            ["d_datekey", "d_year"])
    with ctx.span("hash_join"):
        j = join(db["lineorder"], supp, "lo_suppkey", "s_suppkey",
                 ["lo_custkey", "lo_orderdate", "lo_revenue", "s_nation"])
        j = join(j, cust, "lo_custkey", "c_custkey",
                 ["lo_orderdate", "lo_revenue", "s_nation", "c_nation"])
        j = join(j, date, "lo_orderdate", "d_datekey",
                 ["lo_revenue", "s_nation", "c_nation", "d_year"])
    with ctx.span("group_by"):
        g = pc.group_by(j, ["c_nation", "s_nation", "d_year"],
                        [("lo_revenue", "sum")])
    with ctx.span("sort_take"):
        return ordered(g, ["d_year", ("lo_revenue_sum", "descending")],
                       ctx.device)
