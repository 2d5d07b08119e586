"""Plain SSB Q1.1 (see portbench/queries/ssb/q1_1.py for the SQL)."""
from portbench.reference.ssb.flight1 import revenue


def run(t, p, acc):
    return revenue(t, t["date"]["d_year"].values == p["year"],
                   p["discount_lo"], -2**31, 24, acc)
