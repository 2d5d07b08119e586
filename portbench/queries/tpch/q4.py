"""TPC-H Q4, the order priority checking query (clause 2.4.4):

    SELECT o_orderpriority, COUNT(*) AS order_count
    FROM orders
    WHERE o_orderdate >= date ':date'
      AND o_orderdate < date ':date' + interval '3' month
      AND EXISTS (SELECT * FROM lineitem
                  WHERE l_orderkey = o_orderkey
                    AND l_commitdate < l_receiptdate)
    GROUP BY o_orderpriority
    ORDER BY o_orderpriority

EXISTS is a left semi join; on DeviceBatches the port gives it as the
semi verdict over the orders' rows.
"""
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.compute.join import semi_verdict
from arrow_go_tpu_torch.device import DeviceColumn

from portbench.queries.common import add_months, day, project


def run(db, p, ctx):
    f, lit, call = pc.field, pc.literal, pc.call
    orders, li = db["orders"], db["lineitem"]
    with ctx.span("filter"):
        o_mask = pc.execute_scalar_expression(call("and", [
            call("greater_equal", [f("o_orderdate"), lit(day(p["date"]))]),
            call("less", [f("o_orderdate"), lit(add_months(p["date"], 3))])]),
            orders)
        ord_f = pc.filter(project(orders, ["o_orderkey", "o_orderpriority"]),
                          o_mask)
        l_mask = pc.execute_scalar_expression(
            call("less", [f("l_commitdate"), f("l_receiptdate")]), li)
        li_f = pc.filter(project(li, ["l_orderkey"]), l_mask)
    with ctx.span("hash_join"):
        verdict = semi_verdict(ord_f, li_f, ["o_orderkey"], ["l_orderkey"],
                               "left semi")
    with ctx.span("filter"):
        hits = pc.filter(ord_f, DeviceColumn(verdict, None, ord_f.length,
                                             dt.bool_))
    with ctx.span("group_by"):
        g = pc.group_by(hits, "o_orderpriority", [("o_orderkey", "count_all")])
    with ctx.span("sort_take"):
        idx = pc.sort_indices(g, pc.SortOptions([
            pc.SortKey("o_orderpriority")]), device=ctx.device)
        return pc.take(g, idx)
