"""SSB Q2.2:

    SELECT SUM(lo_revenue), d_year, p_brand1
    FROM lineorder, date, part, supplier
    WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
      AND lo_suppkey = s_suppkey
      AND p_brand1 BETWEEN ':category:brand_lo' AND ':category:brand_lo+7'
      AND s_region = ':region'
    GROUP BY d_year, p_brand1
    ORDER BY d_year, p_brand1

The mix draws brand_lo so that the range holds the 8 two-digit brands
brand_lo..brand_lo+7 and no other, so BETWEEN is the IN of those 8 (the
port has no string comparison with a literal).
"""
import arrow_go_tpu_torch.compute as pc

from portbench.queries.common import isin, join, ordered, where


def run(db, p, ctx):
    brands = [f"{p['category']}{b}" for b in range(p["brand_lo"],
                                                    p["brand_lo"] + 8)]
    with ctx.span("filter"):
        part = where(db["part"], isin("p_brand1", brands),
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
