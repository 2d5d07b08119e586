"""Plain SSB Q3.2 (see portbench/queries/ssb/q3_2.py for the SQL)."""
from portbench.reference.common import isin
from portbench.reference.ssb.flight3 import revenue_by_places, years_1992_1997


def run(t, p, acc):
    return revenue_by_places(
        t, isin(t["customer"]["c_nation"], [p["nation"]]),
        isin(t["supplier"]["s_nation"], [p["nation"]]), years_1992_1997(t),
        "c_city", "s_city", acc)
