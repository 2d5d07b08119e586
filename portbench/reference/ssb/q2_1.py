"""Plain SSB Q2.1 (see portbench/queries/ssb/q2_1.py for the SQL)."""
from portbench.reference.common import isin
from portbench.reference.ssb.flight2 import revenue_by_brand


def run(t, p, acc):
    return revenue_by_brand(t, isin(t["part"]["p_category"], [p["category"]]),
                            p["region"], acc)
