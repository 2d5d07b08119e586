"""Star Schema Benchmark tables (O'Neil, O'Neil, Chen, rev. 3, 2009).

LINEORDER with only the 9 columns the 13 queries read, and the four
dimensions with the columns they filter and group on. Made on the
device from the seed, but for DATE (2,556 rows, made on the host).
What the SSB text leaves open follows TPC-H's clause 4.2.3, from which
SSB's generator derives; the configuration file lists each such choice
under `assumed`.

  LINEORDER  orders 1,500,000 x SF, 1 to 7 lines an order (about
             6,000,000 x SF rows); an order's lines share its date and
             customer
  CUSTOMER   30,000 x SF;  SUPPLIER 2,000 x SF
  PART       200,000 x floor(1 + log2 SF)
  DATE       1992-01-01 and the 2,555 days after it
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.generators.tpch import retail_price_cents
from portbench.harness.tables import Column

# TPC-H's 25 nations and their regions (clause 4.2.3)
NATIONS = [
    ("ALGERIA", "AFRICA"), ("ARGENTINA", "AMERICA"), ("BRAZIL", "AMERICA"),
    ("CANADA", "AMERICA"), ("EGYPT", "MIDDLE EAST"), ("ETHIOPIA", "AFRICA"),
    ("FRANCE", "EUROPE"), ("GERMANY", "EUROPE"), ("INDIA", "ASIA"),
    ("INDONESIA", "ASIA"), ("IRAN", "MIDDLE EAST"), ("IRAQ", "MIDDLE EAST"),
    ("JAPAN", "ASIA"), ("JORDAN", "MIDDLE EAST"), ("KENYA", "AFRICA"),
    ("MOROCCO", "AFRICA"), ("MOZAMBIQUE", "AFRICA"), ("PERU", "AMERICA"),
    ("CHINA", "ASIA"), ("ROMANIA", "EUROPE"), ("SAUDI ARABIA", "MIDDLE EAST"),
    ("VIETNAM", "ASIA"), ("RUSSIA", "EUROPE"), ("UNITED KINGDOM", "EUROPE"),
    ("UNITED STATES", "AMERICA")]
DATE_ROWS = 2556
START = np.datetime64("1992-01-01")
# an order's date: STARTDATE to ENDDATE - 151 days, as in TPC-H
LAST_ORDER_DAY = int((np.datetime64("1998-08-02") - START).astype(np.int64))
MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep",
          "Oct", "Nov", "Dec"]


def city(nation: str, digit: int) -> str:
    """A city: the nation's name cut or padded to 9 characters, then a
    digit ("UNITED KI1")."""
    return f"{nation[:9]:<9}{digit}"


def _coded(strings, dev):
    """(sorted distinct values, a tensor mapping each input position to
    its value's code)."""
    values = sorted(set(strings))
    at = {v: i for i, v in enumerate(values)}
    return values, torch.tensor([at[s] for s in strings], dtype=torch.int32,
                                device=dev)


def _geo(n: int, prefix: str, g, dev) -> dict:
    """city, nation and region columns of n rows: a nation uniform over
    the 25, a city uniform over its nation's 10."""
    nation = torch.randint(0, 25, (n,), generator=g, device=dev)
    digit = torch.randint(0, 10, (n,), generator=g, device=dev)
    cities, city_of = _coded([city(nm, d) for nm, _ in NATIONS
                              for d in range(10)], dev)
    nations, nation_of = _coded([nm for nm, _ in NATIONS], dev)
    regions, region_of = _coded([r for _, r in NATIONS], dev)
    return {f"{prefix}_city": Column(city_of[nation * 10 + digit], "string",
                                     cities),
            f"{prefix}_nation": Column(nation_of[nation], "string", nations),
            f"{prefix}_region": Column(region_of[nation], "string", regions)}


def date_table(dev) -> dict:
    days = START + np.arange(DATE_ROWS)
    y = days.astype("datetime64[Y]").astype(np.int64) + 1970
    m = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    d = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    doy = (days - days.astype("datetime64[Y]")).astype(np.int64)
    ym_values, ym_of = _coded([f"{MONTHS[mm - 1]}{yy}" for yy, mm in
                               zip(y.tolist(), m.tolist())], dev)
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)  # noqa
    return {"d_datekey": Column(t(y * 10000 + m * 100 + d), "int32"),
            "d_year": Column(t(y), "int32"),
            "d_yearmonthnum": Column(t(y * 100 + m), "int32"),
            "d_yearmonth": Column(ym_of, "string", ym_values),
            "d_weeknuminyear": Column(t(doy // 7 + 1), "int32")}


def generate(config: dict, seed: int, device) -> dict:
    sf = float(config["scale_factor"])
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_cust = int(round(30_000 * sf))
    n_supp = int(round(2_000 * sf))
    n_part = int(round(200_000 * math.floor(1 + math.log2(max(sf, 1)))))
    n_ord = int(round(1_500_000 * sf))

    def uniform(lo, hi, n):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=dev)

    customer = {"c_custkey": Column(torch.arange(1, n_cust + 1, device=dev,
                                                 dtype=torch.int32), "int32"),
                **_geo(n_cust, "c", g, dev)}
    supplier = {"s_suppkey": Column(torch.arange(1, n_supp + 1, device=dev,
                                                 dtype=torch.int32), "int32"),
                **_geo(n_supp, "s", g, dev)}
    mfgrs, mfgr_of = _coded([f"MFGR#{m}" for m in range(1, 6)], dev)
    cats, cat_of = _coded([f"MFGR#{m}{c}" for m in range(1, 6)
                           for c in range(1, 6)], dev)
    brands, brand_of = _coded([f"MFGR#{m}{c}{b}" for m in range(1, 6)
                               for c in range(1, 6) for b in range(1, 41)],
                              dev)
    m, c, b = uniform(0, 4, n_part), uniform(0, 4, n_part), \
        uniform(0, 39, n_part)
    part = {"p_partkey": Column(torch.arange(1, n_part + 1, device=dev,
                                             dtype=torch.int32), "int32"),
            "p_mfgr": Column(mfgr_of[m], "string", mfgrs),
            "p_category": Column(cat_of[m * 5 + c], "string", cats),
            "p_brand1": Column(brand_of[(m * 5 + c) * 40 + b], "string",
                               brands)}
    date = date_table(dev)

    lines = uniform(1, 7, n_ord)
    n_lo = int(lines.sum())

    def per_order(x):
        return torch.repeat_interleave(x, lines, output_size=n_lo)

    day_idx = per_order(uniform(0, LAST_ORDER_DAY, n_ord))
    # the customer of an order: never a multiple of 3 (TPC-H's rule)
    j = uniform(0, n_cust - n_cust // 3 - 1, n_ord)
    custkey = per_order(3 * (j // 2) + j % 2 + 1)
    partkey = uniform(1, n_part, n_lo)
    qty = uniform(1, 50, n_lo)
    disc = uniform(0, 10, n_lo)
    price = retail_price_cents(partkey)
    ext = qty * price
    lineorder = {
        "lo_orderdate": Column(date["d_datekey"].values[day_idx], "int32"),
        "lo_custkey": Column(custkey, "int32"),
        "lo_partkey": Column(partkey, "int32"),
        "lo_suppkey": Column(uniform(1, n_supp, n_lo), "int32"),
        "lo_quantity": Column(qty, "int32"),
        "lo_discount": Column(disc, "int32"),
        "lo_extendedprice": Column(ext, "int32"),
        "lo_revenue": Column(ext * (100 - disc) // 100, "int32"),
        "lo_supplycost": Column(6 * price // 10, "int32"),
    }
    return {"lineorder": lineorder, "date": date, "customer": customer,
            "supplier": supplier, "part": part}
