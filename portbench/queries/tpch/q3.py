"""TPC-H Q3, the shipping priority query (clause 2.4.3):

    SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue,
           o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = ':segment' AND c_custkey = o_custkey
      AND l_orderkey = o_orderkey AND o_orderdate < date ':date'
      AND l_shipdate > date ':date'
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, o_orderdate
    LIMIT 10
"""
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt

from portbench.queries.common import day, project, with_columns

KEYS = ["l_orderkey", "o_orderdate", "o_shippriority"]


def run(db, p, ctx):
    f, lit, call = pc.field, pc.literal, pc.call
    cust, orders, li = db["customer"], db["orders"], db["lineitem"]
    d = day(p["date"])
    with ctx.span("filter"):
        c_mask = pc.execute_scalar_expression(call(
            "is_in", [f("c_mktsegment")], {"value_set": [p["segment"]]}),
            cust)
        cust_f = pc.filter(project(cust, ["c_custkey"]), c_mask)
        o_mask = pc.execute_scalar_expression(
            call("less", [f("o_orderdate"), lit(d)]), orders)
        ord_f = pc.filter(project(orders, ["o_orderkey", "o_custkey",
                                           "o_orderdate", "o_shippriority"]),
                          o_mask)
        l_mask = pc.execute_scalar_expression(
            call("greater", [f("l_shipdate"), lit(d)]), li)
        li_f = pc.filter(project(li, ["l_orderkey", "l_extendedprice",
                                      "l_discount"]), l_mask)
    with ctx.span("hash_join"):
        oc = pc.hash_join(ord_f, cust_f, left_keys=["o_custkey"],
                          right_keys=["c_custkey"],
                          output_columns=["o_orderkey", "o_orderdate",
                                          "o_shippriority"])
        j = pc.hash_join(li_f, oc, left_keys=["l_orderkey"],
                         right_keys=["o_orderkey"],
                         output_columns=["l_orderkey", "l_extendedprice",
                                         "l_discount", "o_orderdate",
                                         "o_shippriority"])
    with ctx.span("expressions"):
        rev = pc.execute_scalar_expression(call("multiply", [
            f("l_extendedprice"),
            call("subtract", [lit(1.0), f("l_discount")])]), j)
        gb = with_columns(j, KEYS, [("revenue", dt.float64, rev)])
    with ctx.span("group_by"):
        g = pc.group_by(gb, KEYS, [("revenue", "sum")])
    with ctx.span("sort_take"):
        idx = pc.sort_indices(g, pc.SortOptions([
            pc.SortKey("revenue_sum", "descending"),
            pc.SortKey("o_orderdate")]), device=ctx.device)
        return pc.take(g, idx).slice(0, 10)
