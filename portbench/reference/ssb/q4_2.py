"""Plain SSB Q4.2 (see portbench/queries/ssb/q4_2.py for the SQL)."""
from portbench.reference.common import isin
from portbench.reference.ssb.flight4 import profit, years_1997_1998


def run(t, p, acc):
    return profit(t, isin(t["customer"]["c_region"], [p["region"]]),
                  isin(t["supplier"]["s_region"], [p["region"]]),
                  isin(t["part"]["p_mfgr"], p["mfgrs"]), years_1997_1998(t),
                  [("date", "d_year"), ("supplier", "s_nation"),
                   ("part", "p_category")], acc)
