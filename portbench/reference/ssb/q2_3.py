"""Plain SSB Q2.3 (see portbench/queries/ssb/q2_3.py for the SQL)."""
from portbench.reference.common import isin
from portbench.reference.ssb.flight2 import revenue_by_brand


def run(t, p, acc):
    return revenue_by_brand(t, isin(t["part"]["p_brand1"],
                                    [f"{p['category']}{p['brand']}"]),
                            p["region"], acc)
