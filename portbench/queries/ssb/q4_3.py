"""SSB Q4.3:

    SELECT d_year, s_city, p_brand1,
           SUM(lo_revenue - lo_supplycost) AS profit
    FROM date, customer, supplier, part, lineorder
    WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
      AND lo_partkey = p_partkey AND lo_orderdate = d_datekey
      AND c_region = ':region' AND s_nation = ':nation'
      AND (d_year = 1997 OR d_year = 1998)
      AND p_category = ':category'
    GROUP BY d_year, s_city, p_brand1
    ORDER BY d_year, s_city, p_brand1
"""
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt

from portbench.queries.common import (isin, join, ordered, where,
                                      with_columns)


def run(db, p, ctx):
    f, call = pc.field, pc.call
    with ctx.span("filter"):
        cust = where(db["customer"], isin("c_region", [p["region"]]),
                     ["c_custkey"])
        supp = where(db["supplier"], isin("s_nation", [p["nation"]]),
                     ["s_suppkey", "s_city"])
        part = where(db["part"], isin("p_category", [p["category"]]),
                     ["p_partkey", "p_brand1"])
        date = where(db["date"], call("is_in", [f("d_year")],
                                      {"value_set": [1997, 1998]}),
                     ["d_datekey", "d_year"])
    with ctx.span("hash_join"):
        j = join(db["lineorder"], part, "lo_partkey", "p_partkey",
                 ["lo_custkey", "lo_suppkey", "lo_orderdate", "lo_revenue",
                  "lo_supplycost", "p_brand1"])
        j = join(j, supp, "lo_suppkey", "s_suppkey",
                 ["lo_custkey", "lo_orderdate", "lo_revenue",
                  "lo_supplycost", "p_brand1", "s_city"])
        j = join(j, cust, "lo_custkey", "c_custkey",
                 ["lo_orderdate", "lo_revenue", "lo_supplycost", "p_brand1",
                  "s_city"])
        j = join(j, date, "lo_orderdate", "d_datekey",
                 ["lo_revenue", "lo_supplycost", "p_brand1", "s_city",
                  "d_year"])
    with ctx.span("expressions"):
        profit = pc.execute_scalar_expression(call("subtract", [
            f("lo_revenue"), f("lo_supplycost")]), j)
        gb = with_columns(j, ["d_year", "s_city", "p_brand1"],
                          [("profit", dt.int32, profit)])
    with ctx.span("group_by"):
        g = pc.group_by(gb, ["d_year", "s_city", "p_brand1"],
                        [("profit", "sum")])
    with ctx.span("sort_take"):
        return ordered(g, ["d_year", "s_city", "p_brand1"], ctx.device)
