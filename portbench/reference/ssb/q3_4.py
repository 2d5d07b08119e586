"""Plain SSB Q3.4 (see portbench/queries/ssb/q3_4.py for the SQL)."""
import numpy as np

from portbench.reference.common import isin
from portbench.reference.ssb.flight3 import cities, revenue_by_places


def run(t, p, acc):
    ym = np.datetime64(p["month"], "M").item().strftime("%b%Y")
    return revenue_by_places(
        t, isin(t["customer"]["c_city"], cities(p)),
        isin(t["supplier"]["s_city"], cities(p)),
        isin(t["date"]["d_yearmonth"], [ym]), "c_city", "s_city", acc)
