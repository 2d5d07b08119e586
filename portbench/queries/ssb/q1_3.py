"""SSB Q1.3:

    SELECT SUM(lo_extendedprice * lo_discount) AS revenue
    FROM lineorder, date
    WHERE lo_orderdate = d_datekey AND d_weeknuminyear = :week
      AND d_year = :year
      AND lo_discount BETWEEN :discount_lo AND :discount_lo + 2
      AND lo_quantity BETWEEN 26 AND 35
"""
import arrow_go_tpu_torch.compute as pc

from portbench.queries.common import all_of, join, where


def run(db, p, ctx):
    f, lit, call = pc.field, pc.literal, pc.call
    with ctx.span("filter"):
        d = where(db["date"], all_of(
            call("equal", [f("d_weeknuminyear"), lit(p["week"])]),
            call("equal", [f("d_year"), lit(p["year"])])), ["d_datekey"])
        lo = where(db["lineorder"], all_of(
            call("greater_equal", [f("lo_discount"), lit(p["discount_lo"])]),
            call("less_equal", [f("lo_discount"),
                                lit(p["discount_lo"] + 2)]),
            call("greater_equal", [f("lo_quantity"), lit(26)]),
            call("less_equal", [f("lo_quantity"), lit(35)])),
            ["lo_orderdate", "lo_extendedprice", "lo_discount"])
    with ctx.span("hash_join"):
        j = join(lo, d, "lo_orderdate", "d_datekey",
                 ["lo_extendedprice", "lo_discount"])
    with ctx.span("aggregate"):
        rev = pc.execute_scalar_expression(call("multiply", [
            f("lo_extendedprice"), f("lo_discount")]), j)
        return {"revenue": pc.agg_sum(rev)}
