"""Plain SSB Q1.2 (see portbench/queries/ssb/q1_2.py for the SQL)."""
from portbench.reference.ssb.flight1 import revenue


def run(t, p, acc):
    yyyymm = int(p["month"][:4]) * 100 + int(p["month"][5:7])
    return revenue(t, t["date"]["d_yearmonthnum"].values == yyyymm,
                   p["discount_lo"], 26, 35, acc)
