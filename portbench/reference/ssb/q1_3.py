"""Plain SSB Q1.3 (see portbench/queries/ssb/q1_3.py for the SQL)."""
from portbench.reference.ssb.flight1 import revenue


def run(t, p, acc):
    d = t["date"]
    return revenue(t, (d["d_weeknuminyear"].values == p["week"])
                   & (d["d_year"].values == p["year"]), p["discount_lo"],
                   26, 35, acc)
