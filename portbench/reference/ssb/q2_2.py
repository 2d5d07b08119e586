"""Plain SSB Q2.2 (see portbench/queries/ssb/q2_2.py for the SQL): the
brands between the two bounds, compared as strings."""
from portbench.reference.common import isin
from portbench.reference.ssb.flight2 import revenue_by_brand


def run(t, p, acc):
    brand = t["part"]["p_brand1"]
    lo = f"{p['category']}{p['brand_lo']}"
    hi = f"{p['category']}{p['brand_lo'] + 7}"
    return revenue_by_brand(t, isin(brand, [b for b in brand.dictionary
                                            if lo <= b <= hi]),
                            p["region"], acc)
