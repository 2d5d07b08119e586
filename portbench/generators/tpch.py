"""TPC-H tables after the specification's data generation rules.

TPC-H Standard Specification v3.0.1, clause 4.2.3, for the columns that
Q1, Q3, Q4, Q6 and Q12 read, made on the device from the seed in a few
large calls. What this departs from is listed under `assumed` in the
configuration file: float64 money, date32 dates, random streams that are
not dbgen's, no text columns.

Cardinalities (clause 4.2.5): CUSTOMER 150,000 x SF, ORDERS 1,500,000 x
SF, PART 200,000 x SF (only its key range is used: l_partkey sets
l_extendedprice through P_RETAILPRICE), LINEITEM 1 to 7 rows an order.
"""
from __future__ import annotations

import torch

from portbench.harness.tables import Column, date_day

# clause 4.2.2.13 and 4.2.3: the value lists, each in string order so
# that a code's order is its string's order
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
RETURNFLAGS = ["A", "N", "R"]
LINESTATUS = ["F", "O"]

STARTDATE = date_day("1992-01-01")
ENDDATE = date_day("1998-12-31")
CURRENTDATE = date_day("1995-06-17")


def _uniform(lo: int, hi: int, n: int, g: torch.Generator, dev,
             dtype=torch.int64) -> torch.Tensor:
    """n integers uniform in [lo, hi]."""
    return torch.randint(lo, hi + 1, (n,), generator=g, device=dev,
                         dtype=dtype)


def retail_price_cents(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE x 100 (clause 4.2.3): (90000 + ((key / 10) mod
    20001) + 100 x (key mod 1000))."""
    return 90000 + torch.remainder(partkey // 10, 20001) \
        + 100 * torch.remainder(partkey, 1000)


def sparse_orderkey(i: torch.Tensor) -> torch.Tensor:
    """O_ORDERKEY of the i-th order (0-based): only the first 8 of each
    32 keys are used (clause 4.2.3)."""
    return (i // 8) * 32 + i % 8 + 1


def generate(config: dict, seed: int, device) -> dict:
    sf = float(config["scale_factor"])
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_cust = int(round(150_000 * sf))
    n_ord = int(round(1_500_000 * sf))
    n_part = int(round(200_000 * sf))

    customer = {
        "c_custkey": Column(torch.arange(1, n_cust + 1, device=dev),
                            "int64"),
        "c_mktsegment": Column(_uniform(0, 4, n_cust, g, dev, torch.int32),
                               "string", SEGMENTS),
    }

    # O_CUSTKEY: uniform over the keys that are not a multiple of 3
    j = _uniform(0, n_cust - n_cust // 3 - 1, n_ord, g, dev)
    odate = _uniform(STARTDATE, ENDDATE - 151, n_ord, g, dev, torch.int32)
    orders = {
        "o_orderkey": Column(sparse_orderkey(torch.arange(n_ord, device=dev)),
                             "int64"),
        "o_custkey": Column(3 * (j // 2) + j % 2 + 1, "int64"),
        "o_orderdate": Column(odate, "date32"),
        "o_orderpriority": Column(_uniform(0, 4, n_ord, g, dev, torch.int32),
                                  "string", PRIORITIES),
        "o_shippriority": Column(torch.zeros(n_ord, dtype=torch.int32,
                                             device=dev), "int32"),
    }

    lines = _uniform(1, 7, n_ord, g, dev)
    n_li = int(lines.sum())
    okey = torch.repeat_interleave(orders["o_orderkey"].values, lines,
                                   output_size=n_li)
    l_odate = torch.repeat_interleave(odate, lines, output_size=n_li)
    qty = _uniform(1, 50, n_li, g, dev)
    partkey = _uniform(1, n_part, n_li, g, dev)
    price_cents = qty * retail_price_cents(partkey)
    ship = l_odate + _uniform(1, 121, n_li, g, dev, torch.int32)
    commit = l_odate + _uniform(30, 90, n_li, g, dev, torch.int32)
    receipt = ship + _uniform(1, 30, n_li, g, dev, torch.int32)
    # L_RETURNFLAG: R or A at random once received by CURRENTDATE, else N
    ra = torch.where(_uniform(0, 1, n_li, g, dev, torch.int32) == 0,
                     RETURNFLAGS.index("R"), RETURNFLAGS.index("A"))
    rflag = torch.where(receipt <= CURRENTDATE, ra,
                        RETURNFLAGS.index("N")).to(torch.int32)
    lstatus = (ship > CURRENTDATE).to(torch.int32)   # O after, F by
    lineitem = {
        "l_orderkey": Column(okey, "int64"),
        "l_quantity": Column(qty.to(torch.float64), "float64"),
        "l_extendedprice": Column(price_cents.to(torch.float64) / 100.0,
                                  "float64"),
        "l_discount": Column(_uniform(0, 10, n_li, g, dev).to(torch.float64)
                             / 100.0, "float64"),
        "l_tax": Column(_uniform(0, 8, n_li, g, dev).to(torch.float64)
                        / 100.0, "float64"),
        "l_returnflag": Column(rflag, "string", RETURNFLAGS),
        "l_linestatus": Column(lstatus, "string", LINESTATUS),
        "l_shipdate": Column(ship, "date32"),
        "l_commitdate": Column(commit, "date32"),
        "l_receiptdate": Column(receipt, "date32"),
        "l_shipmode": Column(_uniform(0, 6, n_li, g, dev, torch.int32),
                             "string", SHIPMODES),
    }
    return {"customer": customer, "orders": orders, "lineitem": lineitem}
