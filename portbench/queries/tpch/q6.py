"""TPC-H Q6, the forecasting revenue change query (clause 2.4.6):

    SELECT SUM(l_extendedprice * l_discount) AS revenue
    FROM lineitem
    WHERE l_shipdate >= date ':year-01-01'
      AND l_shipdate < date ':year-01-01' + interval '1' year
      AND l_discount BETWEEN :discount - 0.01 AND :discount + 0.01
      AND l_quantity < :quantity
"""
import arrow_go_tpu_torch.compute as pc

from portbench.queries.common import add_years, day, project


def run(db, p, ctx):
    f, lit, call = pc.field, pc.literal, pc.call
    li = db["lineitem"]
    start = f"{p['year']}-01-01"
    lo, hi = round(p["discount"] - 0.01, 2), round(p["discount"] + 0.01, 2)
    with ctx.span("filter"):
        pred = call("greater_equal", [f("l_shipdate"), lit(day(start))])
        for c in (call("less", [f("l_shipdate"), lit(add_years(start, 1))]),
                  call("greater_equal", [f("l_discount"), lit(lo)]),
                  call("less_equal", [f("l_discount"), lit(hi)]),
                  call("less", [f("l_quantity"),
                                lit(float(p["quantity"]))])):
            pred = call("and", [pred, c])
        mask = pc.execute_scalar_expression(pred, li)
        li_f = pc.filter(project(li, ["l_extendedprice", "l_discount"]), mask)
    with ctx.span("aggregate"):
        rev = pc.execute_scalar_expression(call("multiply", [
            f("l_extendedprice"), f("l_discount")]), li_f)
        return {"revenue": pc.agg_sum(rev)}
