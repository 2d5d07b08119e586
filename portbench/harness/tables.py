"""The generated tables, as the benchmark hands them to both sides.

A generator returns {table: {column: Column}}: raw tensors on the
device. The port gets its own padded copies as DeviceBatches
(`to_port`); the plain reference reads the raw tensors, so nothing that
the port made reaches it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

_TORCH = {"int32": torch.int32, "int64": torch.int64,
          "float64": torch.float64, "date32": torch.int32,
          "string": torch.int32}


@dataclass
class Column:
    """One generated column: its values (a string column's int32 codes
    into `dictionary`, whose order is the strings' order) and its type:
    int32, int64, float64, date32 (days since 1970-01-01) or string."""

    values: torch.Tensor
    type: str
    dictionary: Optional[Sequence[str]] = None

    def __post_init__(self):
        want = _TORCH[self.type]
        if self.values.dtype != want:
            self.values = self.values.to(want)
        if (self.type == "string") != (self.dictionary is not None):
            raise ValueError("a string column, and only one, has a "
                             "dictionary")


Tables = Dict[str, Dict[str, Column]]


def date_day(iso: str) -> int:
    """Days since 1970-01-01 of an ISO date."""
    return int(np.datetime64(iso, "D").astype(np.int64))


def table_bytes(tables: Tables) -> int:
    return sum(c.values.numel() * c.values.element_size()
               for t in tables.values() for c in t.values())


def to_port(tables: Tables) -> dict:
    """Each table as the port's resident DeviceBatch: every column
    copied into a buffer padded as the port pads (pad_length), typed as
    the port types it, a string column with its dictionary values."""
    from arrow_go_tpu_torch import dtypes as dt
    from arrow_go_tpu_torch.device import DeviceBatch, DeviceColumn
    from arrow_go_tpu_torch.device.block import pad_length
    types = {"int32": dt.int32, "int64": dt.int64, "float64": dt.float64,
             "date32": dt.date32, "string": dt.string}
    out = {}
    for name, cols in tables.items():
        n = len(next(iter(cols.values())).values)
        P = pad_length(n)
        fields, dcols = [], []
        for cname, c in cols.items():
            buf = torch.zeros(P, dtype=c.values.dtype,
                              device=c.values.device)
            buf[:n] = c.values
            dictionary = None if c.dictionary is None else \
                np.array(list(c.dictionary), dtype=object)
            fields.append(dt.Field(cname, types[c.type]))
            dcols.append(DeviceColumn(buf, None, n, types[c.type],
                                      dictionary))
        out[name] = DeviceBatch(dt.Schema(fields), dcols, n)
    return out
