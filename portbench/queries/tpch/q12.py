"""TPC-H Q12, the shipping modes and order priority query (clause 2.4.12):

    SELECT l_shipmode,
           SUM(CASE WHEN o_orderpriority = '1-URGENT'
                      OR o_orderpriority = '2-HIGH' THEN 1 ELSE 0 END),
           SUM(CASE WHEN o_orderpriority <> '1-URGENT'
                     AND o_orderpriority <> '2-HIGH' THEN 1 ELSE 0 END)
    FROM orders, lineitem
    WHERE o_orderkey = l_orderkey
      AND l_shipmode IN (':shipmodes[0]', ':shipmodes[1]')
      AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
      AND l_receiptdate >= date ':year-01-01'
      AND l_receiptdate < date ':year-01-01' + interval '1' year
    GROUP BY l_shipmode
    ORDER BY l_shipmode
"""
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt

from portbench.queries.common import add_years, day, project, with_columns

HIGH = ["1-URGENT", "2-HIGH"]


def run(db, p, ctx):
    f, lit, call = pc.field, pc.literal, pc.call
    orders, li = db["orders"], db["lineitem"]
    start = f"{p['year']}-01-01"
    with ctx.span("filter"):
        pred = call("is_in", [f("l_shipmode")],
                    {"value_set": list(p["shipmodes"])})
        for c in (call("less", [f("l_commitdate"), f("l_receiptdate")]),
                  call("less", [f("l_shipdate"), f("l_commitdate")]),
                  call("greater_equal", [f("l_receiptdate"),
                                         lit(day(start))]),
                  call("less", [f("l_receiptdate"),
                                lit(add_years(start, 1))])):
            pred = call("and", [pred, c])
        mask = pc.execute_scalar_expression(pred, li)
        li_f = pc.filter(project(li, ["l_orderkey", "l_shipmode"]), mask)
    with ctx.span("hash_join"):
        j = pc.hash_join(li_f, project(orders, ["o_orderkey",
                                                "o_orderpriority"]),
                         left_keys=["l_orderkey"], right_keys=["o_orderkey"],
                         output_columns=["l_shipmode", "o_orderpriority"])
    with ctx.span("expressions"):
        high = call("is_in", [f("o_orderpriority")], {"value_set": HIGH})
        hi, lo = (pc.execute_scalar_expression(
            call("if_else", [cond, lit(1), lit(0)]), j)
            for cond in (high, call("invert", [high])))
        gb = with_columns(j, ["l_shipmode"], [("high_line", dt.int64, hi),
                                              ("low_line", dt.int64, lo)])
    with ctx.span("group_by"):
        g = pc.group_by(gb, "l_shipmode", [("high_line", "sum"),
                                           ("low_line", "sum")])
    with ctx.span("sort_take"):
        idx = pc.sort_indices(g, pc.SortOptions([pc.SortKey("l_shipmode")]),
                              device=ctx.device)
        return pc.take(g, idx)
