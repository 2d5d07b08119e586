"""Plain SSB Q4.1 (see portbench/queries/ssb/q4_1.py for the SQL)."""
from portbench.reference.common import isin
from portbench.reference.ssb.flight4 import profit


def run(t, p, acc):
    return profit(t, isin(t["customer"]["c_region"], [p["region"]]),
                  isin(t["supplier"]["s_region"], [p["region"]]),
                  isin(t["part"]["p_mfgr"], p["mfgrs"]), None,
                  [("date", "d_year"), ("customer", "c_nation")], acc)
