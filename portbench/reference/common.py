"""What the plain references share: dates, lookups by key, sums by
group. Plain torch over the generated tables (portbench.harness.tables
columns), on whatever device holds them; no code of the port.
"""
from __future__ import annotations

import numpy as np
import torch


def day(iso: str) -> int:
    return int(np.datetime64(iso, "D").astype(np.int64))


def add_months(iso: str, months: int) -> int:
    m = np.datetime64(iso, "M") + months
    return int(m.astype("datetime64[D]").astype(np.int64))


def codes_of(col, values) -> torch.Tensor:
    """The codes of a string column's `values`, as a tensor."""
    d = list(col.dictionary)
    return torch.tensor([d.index(v) for v in values if v in d],
                        dtype=torch.int32, device=col.values.device)


def isin(col, values) -> torch.Tensor:
    """col IN (values) for a string column."""
    return torch.isin(col.values, codes_of(col, values))


def row_of(keys: torch.Tensor, probe: torch.Tensor):
    """For each probe key, the row of `keys` (unique) holding it, and
    whether one does."""
    order = torch.argsort(keys)
    sk = keys[order]
    pos = torch.searchsorted(sk, probe).clamp(max=len(sk) - 1)
    hit = sk[pos] == probe
    return order[pos], hit


def group_sums(group: torch.Tensor, n: int, values, acc: torch.dtype):
    """Sums of each values tensor by group (0 <= group < n), in `acc`."""
    return [torch.zeros(n, dtype=acc, device=group.device).index_add_(
        0, group, v.to(acc)) for v in values]


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def strings(col, codes: torch.Tensor) -> np.ndarray:
    d = np.array(list(col.dictionary), dtype=object)
    return d[host(codes).astype(np.int64)]


def star(fact: dict, joins):
    """The fact rows that find a kept row in every dimension, and each
    dimension attribute asked for, per kept fact row.

    joins: [(fact key column, dimension table, dimension key column,
    dimension row mask or None, [attribute columns])]. Returns (mask
    over the fact rows, {attribute: values over the kept fact rows})."""
    keep = None
    rows = []
    for fk, dim, dk, dmask, attrs in joins:
        r, hit = row_of(dim[dk].values, fact[fk].values)
        ok = hit if dmask is None else hit & dmask[r]
        keep = ok if keep is None else keep & ok
        rows.append((r, dim, attrs))
    attrs = {}
    for r, dim, names in rows:
        for a in names:
            attrs[a] = dim[a].values[r[keep]]
    return keep, attrs


def grouped(keys, value: torch.Tensor, acc, sum_name: str, cols) -> dict:
    """SUM(value) GROUP BY the key tensors {name: values}: one row a
    group that occurs, string keys as their strings (cols[name] gives
    the column and its dictionary), other keys as int64, the sum as
    computed in `acc`, as int64 or float64."""
    names = list(keys)
    stacked = torch.stack([keys[n].long() for n in names], 1)
    uniq, inv = torch.unique(stacked, dim=0, return_inverse=True)
    s = torch.zeros(len(uniq), dtype=acc, device=value.device).index_add_(
        0, inv, value.to(acc))
    out = {}
    for i, n in enumerate(names):
        u = uniq[:, i]
        c = cols.get(n)
        out[n] = strings(c, u) if c is not None and c.dictionary is not None \
            else host(u).astype(np.int64)
    out[sum_name] = host(s).astype(np.float64 if s.dtype.is_floating_point
                                   else np.int64)
    return out


def sort_rows(table: dict, keys) -> dict:
    """The rows of `table` in the order of keys (each a column name or
    (name, "descending")), stable."""
    n = len(next(iter(table.values())))
    idx = list(range(n))
    for k in reversed(keys):
        name, desc = (k, False) if isinstance(k, str) else (k[0], True)
        col = table[name]
        idx.sort(key=lambda i: col[i], reverse=desc)
    return {k: v[idx] for k, v in table.items()}
