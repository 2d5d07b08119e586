"""SSB Q2.1:

    SELECT SUM(lo_revenue), d_year, p_brand1
    FROM lineorder, date, part, supplier
    WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
      AND lo_suppkey = s_suppkey AND p_category = ':category'
      AND s_region = ':region'
    GROUP BY d_year, p_brand1
    ORDER BY d_year, p_brand1
"""
import arrow_go_tpu_torch.compute as pc

from portbench.queries.common import isin, join, ordered, where


def run(db, p, ctx):
    with ctx.span("filter"):
        part = where(db["part"], isin("p_category", [p["category"]]),
                     ["p_partkey", "p_brand1"])
        supp = where(db["supplier"], isin("s_region", [p["region"]]),
                     ["s_suppkey"])
    with ctx.span("hash_join"):
        j = join(db["lineorder"], part, "lo_partkey", "p_partkey",
                 ["lo_suppkey", "lo_orderdate", "lo_revenue", "p_brand1"])
        j = join(j, supp, "lo_suppkey", "s_suppkey",
                 ["lo_orderdate", "lo_revenue", "p_brand1"])
        j = join(j, db["date"], "lo_orderdate", "d_datekey",
                 ["lo_revenue", "p_brand1", "d_year"])
    with ctx.span("group_by"):
        g = pc.group_by(j, ["d_year", "p_brand1"], [("lo_revenue", "sum")])
    with ctx.span("sort_take"):
        return ordered(g, ["d_year", "p_brand1"], ctx.device)
