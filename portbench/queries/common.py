"""What the plans share: projections, added columns, dates.

A plan is a user's code against the port's public API
(arrow_go_tpu_torch.compute over DeviceBatches); these helpers build
DeviceBatches from columns a plan already has and turn ISO dates into
the date32 literals the plans compare with.
"""
from __future__ import annotations

import numpy as np

from arrow_go_tpu_torch import dtypes as dt
from arrow_go_tpu_torch.device import DeviceBatch


def project(db: DeviceBatch, names) -> DeviceBatch:
    """The named columns of a batch, in `names` order."""
    return DeviceBatch(
        dt.Schema([db.schema.field(db.schema.field_index(n)) for n in names]),
        [db.column(n) for n in names], db.length)


def with_columns(db: DeviceBatch, names, extra) -> DeviceBatch:
    """The named columns of `db` and then each (name, type, column) of
    `extra`."""
    base = project(db, names)
    return DeviceBatch(
        dt.Schema(list(base.schema.fields)
                  + [dt.Field(n, t) for n, t, _ in extra]),
        base.columns + [c for _, _, c in extra], db.length)


def day(iso: str) -> int:
    """A date32 literal: days since 1970-01-01."""
    return int(np.datetime64(iso, "D").astype(np.int64))


def add_months(iso: str, months: int) -> int:
    """The date32 literal of `iso` + `months` months (`iso` a first of
    a month)."""
    m = np.datetime64(iso, "M") + months
    return int(m.astype("datetime64[D]").astype(np.int64))


def add_years(iso: str, years: int) -> int:
    return add_months(iso, 12 * years)


def isin(name: str, values):
    """`name` IN (values), for a string column (the port compares a
    string column with a set, not with a string literal)."""
    import arrow_go_tpu_torch.compute as pc
    return pc.call("is_in", [pc.field(name)], {"value_set": list(values)})


def all_of(*conds):
    import arrow_go_tpu_torch.compute as pc
    pred = conds[0]
    for c in conds[1:]:
        pred = pc.call("and", [pred, c])
    return pred


def where(db: DeviceBatch, pred, names) -> DeviceBatch:
    """The named columns of the rows of `db` where `pred` holds."""
    import arrow_go_tpu_torch.compute as pc
    return pc.filter(project(db, names), pc.execute_scalar_expression(pred,
                                                                      db))


def join(left: DeviceBatch, right: DeviceBatch, lkey: str, rkey: str,
         out) -> DeviceBatch:
    """The inner join on left.lkey = right.rkey, keeping `out`."""
    import arrow_go_tpu_torch.compute as pc
    return pc.hash_join(left, right, left_keys=[lkey], right_keys=[rkey],
                        output_columns=list(out))


def ordered(g, keys, device):
    """A host result's rows in the order of `keys`, each a column name
    or (name, "descending")."""
    import arrow_go_tpu_torch.compute as pc
    sk = [pc.SortKey(k) if isinstance(k, str) else pc.SortKey(*k)
          for k in keys]
    return pc.take(g, pc.sort_indices(g, pc.SortOptions(sk), device=device))
