"""TPC-H Q1, the pricing summary report (clause 2.4.1):

    SELECT l_returnflag, l_linestatus, SUM(l_quantity),
           SUM(l_extendedprice), SUM(l_extendedprice * (1 - l_discount)),
           SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
           AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount),
           COUNT(*)
    FROM lineitem
    WHERE l_shipdate <= date '1998-12-01' - interval ':delta' day
    GROUP BY l_returnflag, l_linestatus
    ORDER BY l_returnflag, l_linestatus
"""
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import dtypes as dt

from portbench.queries.common import day, project, with_columns

AGGS = [("l_quantity", "sum"), ("l_extendedprice", "sum"),
        ("disc_price", "sum"), ("charge", "sum"), ("l_quantity", "mean"),
        ("l_extendedprice", "mean"), ("l_discount", "mean"),
        ("l_quantity", "count_all")]
KEYS = ["l_returnflag", "l_linestatus"]


def run(db, p, ctx):
    f, lit, call = pc.field, pc.literal, pc.call
    li = db["lineitem"]
    with ctx.span("filter"):
        mask = pc.execute_scalar_expression(call("less_equal", [
            f("l_shipdate"), lit(day("1998-12-01") - p["delta"])]), li)
        li_f = pc.filter(project(li, KEYS + [
            "l_quantity", "l_extendedprice", "l_discount", "l_tax"]), mask)
    with ctx.span("expressions"):
        disc_price = pc.execute_scalar_expression(call("multiply", [
            f("l_extendedprice"),
            call("subtract", [lit(1.0), f("l_discount")])]), li_f)
        charge = pc.execute_scalar_expression(call("multiply", [
            call("multiply", [f("l_extendedprice"),
                              call("subtract", [lit(1.0), f("l_discount")])]),
            call("add", [lit(1.0), f("l_tax")])]), li_f)
        gb = with_columns(li_f, [fl.name for fl in li_f.schema.fields],
                          [("disc_price", dt.float64, disc_price),
                           ("charge", dt.float64, charge)])
    with ctx.span("group_by"):
        g = pc.group_by(gb, KEYS, AGGS)
    with ctx.span("sort_take"):
        idx = pc.sort_indices(g, pc.SortOptions([pc.SortKey(k) for k in KEYS]),
                              device=ctx.device)
        return pc.take(g, idx)
