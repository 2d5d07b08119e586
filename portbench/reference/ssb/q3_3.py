"""Plain SSB Q3.3 (see portbench/queries/ssb/q3_3.py for the SQL)."""
from portbench.reference.common import isin
from portbench.reference.ssb.flight3 import (cities, revenue_by_places,
                                             years_1992_1997)


def run(t, p, acc):
    return revenue_by_places(
        t, isin(t["customer"]["c_city"], cities(p)),
        isin(t["supplier"]["s_city"], cities(p)), years_1992_1997(t),
        "c_city", "s_city", acc)
