"""Plain SSB Q4.3 (see portbench/queries/ssb/q4_3.py for the SQL)."""
from portbench.reference.common import isin
from portbench.reference.ssb.flight4 import profit, years_1997_1998


def run(t, p, acc):
    return profit(t, isin(t["customer"]["c_region"], [p["region"]]),
                  isin(t["supplier"]["s_nation"], [p["nation"]]),
                  isin(t["part"]["p_category"], [p["category"]]),
                  years_1997_1998(t),
                  [("date", "d_year"), ("supplier", "s_city"),
                   ("part", "p_brand1")], acc)
