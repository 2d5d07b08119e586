"""Plain SSB Q3.1 (see portbench/queries/ssb/q3_1.py for the SQL)."""
from portbench.reference.common import isin
from portbench.reference.ssb.flight3 import revenue_by_places, years_1992_1997


def run(t, p, acc):
    return revenue_by_places(
        t, isin(t["customer"]["c_region"], [p["region"]]),
        isin(t["supplier"]["s_region"], [p["region"]]), years_1992_1997(t),
        "c_nation", "s_nation", acc)
