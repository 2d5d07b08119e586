"""SSB Q4.1:

    SELECT d_year, c_nation, SUM(lo_revenue - lo_supplycost) AS profit
    FROM date, customer, supplier, part, lineorder
    WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
      AND lo_partkey = p_partkey AND lo_orderdate = d_datekey
      AND c_region = ':region' AND s_region = ':region'
      AND (p_mfgr = ':mfgr1' OR p_mfgr = ':mfgr2')
    GROUP BY d_year, c_nation
    ORDER BY d_year, c_nation
"""
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt

from portbench.queries.common import (isin, join, ordered, where,
                                      with_columns)


def run(db, p, ctx):
    f, call = pc.field, pc.call
    with ctx.span("filter"):
        cust = where(db["customer"], isin("c_region", [p["region"]]),
                     ["c_custkey", "c_nation"])
        supp = where(db["supplier"], isin("s_region", [p["region"]]),
                     ["s_suppkey"])
        part = where(db["part"], isin("p_mfgr", p["mfgrs"]), ["p_partkey"])
    with ctx.span("hash_join"):
        j = join(db["lineorder"], supp, "lo_suppkey", "s_suppkey",
                 ["lo_custkey", "lo_partkey", "lo_orderdate", "lo_revenue",
                  "lo_supplycost"])
        j = join(j, cust, "lo_custkey", "c_custkey",
                 ["lo_partkey", "lo_orderdate", "lo_revenue",
                  "lo_supplycost", "c_nation"])
        j = join(j, part, "lo_partkey", "p_partkey",
                 ["lo_orderdate", "lo_revenue", "lo_supplycost", "c_nation"])
        j = join(j, db["date"], "lo_orderdate", "d_datekey",
                 ["lo_revenue", "lo_supplycost", "c_nation", "d_year"])
    with ctx.span("expressions"):
        profit = pc.execute_scalar_expression(call("subtract", [
            f("lo_revenue"), f("lo_supplycost")]), j)
        gb = with_columns(j, ["d_year", "c_nation"],
                          [("profit", dt.int32, profit)])
    with ctx.span("group_by"):
        g = pc.group_by(gb, ["d_year", "c_nation"], [("profit", "sum")])
    with ctx.span("sort_take"):
        return ordered(g, ["d_year", "c_nation"], ctx.device)
