"""Dataset scan: multi-file tables with projection and predicate pushdown
feeding the device compute engine.

Port of arrow_go_tpu/dataset.py. A Dataset is a sorted set of parquet
fragments of one schema; a Scanner prunes each fragment's row groups by
the simple conjuncts of its filter (`column op literal`, with column
statistics and, for `==`, bloom filters: parquet/reader.py), reads each
kept row group onto the device with `read_batch_device` (one DeviceBatch
per row group, in file and row-group order), and evaluates the filter
there as one expression per batch, then the filter (K1). A nested
column comes back as a HostColumn, read on the host
(parquet/reader.read_field_host), as the JAX package's Scanner reads
it; any other column the device read cannot take raises, where the JAX
package's Scanner drops to its host reader. An `.arrow` or `.feather`
fragment is an Arrow IPC file (the JAX package's IpcFragment): its
record batches are read on the host (ipc.open_file, read_all),
projected and shipped to the device with host_batch_to_device, one
DeviceBatch a file; no guard prunes it. A `.csv` fragment (the JAX
package's CsvFragment) is read whole by formats.read_csv, its types
inferred file by file, projected and shipped the same way. Fragments
are scanned one after another on the calling thread.
"""
from __future__ import annotations

import glob as _glob
import os
import time
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import dtypes as dt
from . import torchenv
from .compute import expression as ex
from .compute.errors import ArrowInvalid
from .compute.functions import filter_
from .compute.nested_selection import null_rows
from .device.block import (DeviceBatch, HostArray, HostBatch,
                           concat_host_arrays, device_batch_to_host,
                           host_batch_to_device)
from .parquet import ParquetFile, read_batch_device

_OPS = {"equal": "==", "less": "<", "less_equal": "<=", "greater": ">",
        "greater_equal": ">="}
_FLIP = {"==": "==", "<": ">", "<=": ">=", ">": "<", ">=": "<="}


def _simple_guards(expr) -> List[Tuple[str, str, object]]:
    """The (column, op, literal) conjuncts of an expression that can prune
    row groups: comparisons of a column with a literal under `and`."""
    out: List[Tuple[str, str, object]] = []

    def walk(e):
        if not isinstance(e, ex.Call):
            return
        if e.function in ("and", "and_kleene"):
            walk(e.args[0])
            walk(e.args[1])
            return
        if e.function in _OPS and len(e.args) == 2:
            a, b = e.args
            if isinstance(a, ex.FieldRef) and isinstance(b, ex.Literal):
                out.append((a.path[0], _OPS[e.function], b.value))
            elif isinstance(b, ex.FieldRef) and isinstance(a, ex.Literal):
                out.append((b.path[0], _FLIP[_OPS[e.function]], a.value))
    walk(expr)
    return out


def _refs(e, need: set) -> None:
    if isinstance(e, ex.FieldRef):
        need.add(e.path[0])
    elif isinstance(e, ex.Call):
        for a in e.args:
            _refs(a, need)


class Fragment:
    """One scannable file."""

    def __init__(self, path: str):
        self.path = path

    def schema(self) -> dt.Schema:
        raise NotImplementedError

    def scan(self, columns, guards, use_threads: bool = True,
             device=None) -> List[HostBatch]:
        """The file's rows `guards` may match (all row groups of a file
        that is one unit), projected to `columns`, read on the host as
        batches (none when it has no rows)."""
        raise NotImplementedError


class ParquetFragment(Fragment):
    def schema(self) -> dt.Schema:
        with ParquetFile(self.path) as pf:
            return pf.schema

    def kept_row_groups(self, guards, bloom: bool = True) -> Tuple[list,
                                                                   int]:
        """(the row groups `guards` keep, the file's row groups)."""
        with ParquetFile(self.path) as pf:
            return self._kept(pf, guards, bloom), pf.num_row_groups

    def scan(self, columns, guards, use_threads: bool = True,
             device=None) -> List[HostBatch]:
        with ParquetFile(self.path) as pf:
            hb = pf.read_table(columns, guards or None,
                               use_threads=use_threads, device=device)
        return hb.to_batches() if hb.num_rows else []

    @staticmethod
    def _kept(pf, guards, bloom: bool = True) -> list:
        return [i for i in range(pf.num_row_groups)
                if not guards or pf._row_group_may_match(i, guards, bloom)]

    def device_batches(self, columns, guards, device,
                       times=None) -> Iterator[DeviceBatch]:
        with ParquetFile(self.path) as pf:
            for rg in self._kept(pf, guards):
                yield read_batch_device(pf, rg, columns=columns,
                                        device=device, times=times)


class _WholeFile(Fragment):
    """A file read whole on the host (`_read`) and shipped as one
    DeviceBatch, as the JAX package's IpcFragment and CsvFragment read
    the file's table and ship it."""

    def _read(self) -> HostBatch:
        raise NotImplementedError

    def scan(self, columns, guards, use_threads: bool = True,
             device=None) -> List[HostBatch]:
        hb = self._read()
        if columns:
            hb = hb.select(columns)
        return hb.to_batches() if hb.num_rows else []

    def kept_row_groups(self, guards, bloom: bool = True) -> Tuple[list,
                                                                   int]:
        """([0], 1): the file is one unit, which no guard prunes."""
        return [0], 1

    def device_batches(self, columns, guards, device,
                       times=None) -> Iterator[DeviceBatch]:
        """The file's rows, projected to `columns`, on `device` (none when
        it has no rows); `times` gathers the host read (`parse_s`) and
        the copy to the device (`h2d_s`)."""
        t0 = time.perf_counter()
        hb = self._read()
        if columns is not None:
            idx = [hb.schema.field_index(c) for c in columns]
            hb = HostBatch(dt.Schema([hb.schema.field(j) for j in idx]),
                           [hb.columns[j] for j in idx], hb.num_rows)
        if not hb.num_rows:
            return
        t1 = time.perf_counter()
        db = host_batch_to_device(hb, device)
        if times is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            times["parse_s"] = times.get("parse_s", 0.0) + t1 - t0
            times["h2d_s"] = times.get("h2d_s", 0.0) + \
                time.perf_counter() - t1
        yield db


class IpcFragment(_WholeFile):
    """An Arrow IPC file: its record batches in one DeviceBatch. Where the
    JAX scanner reads fragments on a thread pool, the port decompresses a
    file's bodies on one."""

    def schema(self) -> dt.Schema:
        from . import ipc
        r = ipc.open_file(self.path)
        try:
            return r.schema
        finally:
            r.close()

    def _read(self) -> HostBatch:
        from . import ipc
        r = ipc.open_file(self.path,
                          decompress_concurrency=os.cpu_count() or 1)
        try:
            return r.read_all()
        finally:
            r.close()


class CsvFragment(_WholeFile):
    """A csv file, read by read_csv: its types inferred from this file
    alone."""

    def schema(self) -> dt.Schema:
        from .formats import read_csv
        return read_csv(self.path).schema

    def _read(self) -> HostBatch:
        from .formats import read_csv
        return read_csv(self.path)


_FRAGMENTS = {".parquet": ParquetFragment, ".pq": ParquetFragment,
              ".arrow": IpcFragment, ".feather": IpcFragment,
              ".csv": CsvFragment}


class Dataset:
    """A collection of same-schema file fragments: a directory (every
    fragment below it, sorted), a glob pattern or a list of paths."""

    def __init__(self, paths: Union[str, Sequence[str]],
                 format: Optional[str] = None):
        if isinstance(paths, str):
            if os.path.isdir(paths):
                paths = sorted(
                    p for p in _glob.glob(os.path.join(paths, "**", "*"),
                                          recursive=True)
                    if os.path.splitext(p)[1] in _FRAGMENTS)
            else:
                paths = sorted(_glob.glob(paths)) or [paths]
        self.fragments: List[Fragment] = []
        for p in paths:
            ext = "." + format.lstrip(".") if format else \
                os.path.splitext(p)[1]
            if ext not in _FRAGMENTS:
                raise ArrowInvalid(f"unknown fragment format: {p}")
            self.fragments.append(_FRAGMENTS[ext](p))
        if not self.fragments:
            raise ArrowInvalid("empty dataset")
        self._schema = self.fragments[0].schema()

    @property
    def schema(self) -> dt.Schema:
        return self._schema

    def scanner(self, columns: Optional[List[str]] = None,
                filter: Optional[ex.Expression] = None,
                use_threads: bool = True, *, device=None) -> "Scanner":
        return Scanner(self, columns, filter, use_threads, device=device)

    def to_table(self, columns: Optional[List[str]] = None,
                 filter: Optional[ex.Expression] = None,
                 use_threads: bool = True, *, device=None) -> HostBatch:
        return self.scanner(columns, filter, use_threads,
                            device=device).to_table()

    def count_rows(self, filter: Optional[ex.Expression] = None,
                   device=None) -> int:
        return self.scanner(None, filter, device=device).count_rows()


class Scanner:
    """A projection (`columns`) and a filter over a Dataset. Batches are
    read and filtered on `device`, the card unless named. `use_threads`
    is the JAX scanner's staging knob (a worker pool over fragments):
    the port reads the fragments in order, one row group at a time onto
    the device, with the same rows in the same order."""

    def __init__(self, dataset: Dataset, columns=None, filter=None,
                 use_threads: bool = True, *, device=None):
        self.dataset = dataset
        self.columns = columns
        self.filter = filter
        self.use_threads = use_threads
        self.device = device
        self._guards = _simple_guards(filter) if filter is not None else []

    def _needed_columns(self) -> Optional[List[str]]:
        """The projection plus the filter's columns, in schema order (None:
        every column)."""
        if self.columns is None:
            return None
        need = set(self.columns)
        if self.filter is not None:
            _refs(self.filter, need)
        return [f.name for f in self.dataset.schema.fields if f.name in need]

    def row_groups(self, bloom: bool = True) -> List[Tuple[str, list, int]]:
        """Per fragment: its path, the row groups the filter's guards keep
        (by statistics, and by bloom filters unless `bloom` is false) and
        its row groups in all."""
        return [(f.path, *f.kept_row_groups(self._guards, bloom))
                for f in self.dataset.fragments]

    def device_batches(self, device=None,
                       times: Optional[dict] = None
                       ) -> Iterator[DeviceBatch]:
        """One DeviceBatch per row group the guards keep, in fragment and
        row-group order, read by read_batch_device onto `device` (the
        scanner's, else the card); the filter is not applied. `times`
        gathers read_batch_device's phase seconds over the scan."""
        dev = torchenv.device(device if device is not None else self.device)
        cols = self._needed_columns()
        for frag in self.dataset.fragments:
            yield from frag.device_batches(cols, self._guards, dev, times)

    def _filtered(self, times=None) -> Iterator[DeviceBatch]:
        for db in self.device_batches(times=times):
            if self.filter is not None:
                db = filter_(db, ex.execute_scalar_expression(self.filter,
                                                              db))
            yield db

    def batches(self, times: Optional[dict] = None) -> Iterator[HostBatch]:
        """The rows that pass the filter, projected to `columns`, one
        HostBatch per row group that keeps any; a string column keeps
        only the dictionary entries its rows use."""
        for db in self._filtered(times):
            if self.columns is not None:
                idx = [db.schema.field_index(c) for c in self.columns]
                db = DeviceBatch(dt.Schema([db.schema.field(i) for i in idx]),
                                 [db.columns[i] for i in idx], db.length)
            if db.length:
                hb = device_batch_to_host(db)
                yield HostBatch(hb.schema, [_used_entries(c)
                                            for c in hb.columns], hb.num_rows)

    def to_table(self, times: Optional[dict] = None) -> HostBatch:
        """Every batch in one HostBatch; a string column's dictionaries
        merge in first-occurrence order (concat_host_arrays). With no
        rows, the schema's fields (those of `columns`, in schema order)
        with empty columns."""
        batches = list(self.batches(times))
        if batches:
            first = batches[0]
            _same_types([b.schema for b in batches])
            return HostBatch(first.schema, [
                concat_host_arrays([b.columns[i] for b in batches])
                for i in range(len(first.columns))],
                sum(b.num_rows for b in batches))
        fields = [f for f in self.dataset.schema.fields
                  if self.columns is None or f.name in self.columns]
        return HostBatch(dt.Schema(fields), [_empty(f.type) for f in fields],
                         0)

    def count_rows(self) -> int:
        """The rows that pass the filter; fragments whose kept rows have
        other types raise, as to_table does."""
        kept = [db for db in self._filtered() if db.length]
        _same_types([db.schema for db in kept])
        return sum(db.length for db in kept)


def _same_types(schemas) -> None:
    """ArrowInvalid unless every batch's fields have the first's types (a
    csv fragment infers its own), as the JAX package's Table refuses
    chunks of another type."""
    for s in schemas[1:]:
        if [f.type for f in s.fields] != [f.type for f in schemas[0].fields]:
            raise ArrowInvalid(f"chunk type mismatch: {s} after "
                               f"{schemas[0]}")


def _used_entries(col: HostArray) -> HostArray:
    """A dictionary column with its dictionary cut to the entries its
    valid rows use, in their order (a row group's dictionary can be far
    longer than a filtered batch); a null row takes code 0."""
    if col.dictionary is None:
        return col
    valid = col.validity_bools()
    used, inv = np.unique(col.values[valid], return_inverse=True)
    codes = np.zeros(len(col), np.int32)
    codes[valid] = inv.reshape(-1)
    return HostArray(codes, col.mask, col.type, col.dictionary[used])


def _empty(t: dt.DataType) -> HostArray:
    out = null_rows(t, 0)
    out.mask = None
    return out


def dataset(paths, format: Optional[str] = None) -> Dataset:
    return Dataset(paths, format)
