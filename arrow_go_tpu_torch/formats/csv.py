"""CSV reader and writer (reference arrow/csv/reader.go:108, writer.go).

Port of arrow_go_tpu/formats/csv.py. The options mirror the reference's
functional options: delimiter, header handling, an explicit schema or
column types or type inference (bool, int64, float64, date32,
timestamp[us], string, in that order), null spellings, included
columns, chunked reading.

Two tiers read, and the input decides which, as in the JAX package:

- the numpy tier (`_read_csv_fast`) takes a whole unquoted buffer: one
  scan finds every line and delimiter, each column's cells become an
  S-dtype array parsed by array operations, columns convert on a thread
  pool. A quote, a comment option, a multi-character delimiter, ragged
  rows, no line, or a cell matrix past `_FAST_CELL_BUDGET` bytes sends
  the input to
- the csv-module tier (`_rows_to_batch`): rows from `csv.reader`, one
  numpy unicode array a column; ragged rows are padded with empty
  cells, which are null.

A type neither tier parses by arrays (decimal, a timestamp with a
timezone, a malformed cell) converts value by value (`_convert_column`).
The two tiers infer differently at the edges, as the JAX tiers do: the
numpy tier parses ints by digits (padded cells such as ' 12 ' are ints),
the csv-module tier through numpy's str -> int64 cast.

Results are HostBatches: `read_csv` and `CSVReader.read_all` give one,
`CSVReader` iterates them (chunk_size rows each, the schema pinned by
the first). A string or binary column is dictionary-coded (first-
occurrence codes of its cells), as everywhere in the port.
"""
from __future__ import annotations

import concurrent.futures as cf
import csv as _csv
import datetime
import decimal
import io
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

from .. import dtypes as dt
from ..array.record import host_batch
from ..compute.errors import ArrowInvalid
from ..device.block import (HostArray, HostBatch, concat_host_arrays,
                            from_pylist)
from ..ipc.core import coded_column

DEFAULT_NULLS = ("", "NULL", "null", "N/A", "n/a", "NA", "nan", "NaN")


@dataclass
class ReadOptions:
    delimiter: str = ","                    # reference WithComma
    has_header: bool = True                 # WithHeader
    column_names: Optional[List[str]] = None
    schema: Optional[dt.Schema] = None
    column_types: Optional[dict] = None     # WithColumnTypes (name -> type)
    include_columns: Optional[List[str]] = None  # WithIncludeColumns
    null_values: Sequence[str] = DEFAULT_NULLS   # WithNullReader
    chunk_size: int = 1 << 20               # WithChunk (rows per batch)
    comment: Optional[str] = None           # WithComment
    skip_rows: int = 0
    strings_can_be_null: bool = False
    true_values: Sequence[str] = ("true", "True", "TRUE", "1")
    false_values: Sequence[str] = ("false", "False", "FALSE", "0")

    def type_for(self, name: str) -> Optional[dt.DataType]:
        if self.column_types and name in self.column_types:
            return self.column_types[name]
        if self.schema is not None and self.schema.field_index(name) >= 0:
            return self.schema.field(self.schema.field_index(name)).type
        return None


_STRINGY = (dt.TypeId.STRING, dt.TypeId.LARGE_STRING, dt.TypeId.BINARY,
            dt.TypeId.LARGE_BINARY)


def _rows_column(lens: np.ndarray, data: np.ndarray,
                 mask: Optional[np.ndarray], t: dt.DataType) -> HostArray:
    """A string or binary column of rows with byte lengths `lens` laid end
    to end in `data` (a null row's length 0), dictionary-coded."""
    return coded_column(np.cumsum(lens, dtype=np.int64),
                        np.ascontiguousarray(data, np.uint8), mask, t)


# ---------------------------------------------------------------------------
# the value-by-value tier
# ---------------------------------------------------------------------------

def _infer_column_type(values: List[Optional[str]], opts: ReadOptions
                       ) -> dt.DataType:
    non_null = [v for v in values if v is not None]
    if not non_null:
        return dt.null

    def all_match(pred):
        return all(pred(v) for v in non_null)
    bools = set(opts.true_values) | set(opts.false_values)
    if all_match(lambda v: v in bools):
        return dt.bool_
    for parse, t in ((int, dt.int64), (float, dt.float64),
                     (datetime.date.fromisoformat, dt.date32),
                     (datetime.datetime.fromisoformat, dt.timestamp("us"))):
        try:
            for v in non_null:
                parse(v)
            return t
        except ValueError:
            pass
    return dt.string


def _convert_column(values: List[Optional[str]], t: dt.DataType,
                    opts: ReadOptions) -> HostArray:
    """Cells (None a null) parsed one by one into a column of t, as the
    JAX package's builders take them."""
    out = []
    for v in values:
        if v is None:
            out.append(None)
        elif t.id == dt.TypeId.BOOL:
            out.append(v in opts.true_values)
        elif t.is_integer:
            out.append(int(v))
        elif t.is_floating:
            out.append(float(v))
        elif t.id == dt.TypeId.DATE32:
            out.append(datetime.date.fromisoformat(v))
        elif t.id == dt.TypeId.TIMESTAMP:
            out.append(datetime.datetime.fromisoformat(v))
        elif t.is_decimal:
            out.append(decimal.Decimal(v))
        else:
            out.append(v)
    return from_pylist(out, t)


# ---------------------------------------------------------------------------
# the csv-module tier: numpy unicode arrays a column
# ---------------------------------------------------------------------------

def _strings_from_unicode(u: np.ndarray, valid: Optional[np.ndarray],
                          t: dt.DataType) -> HostArray:
    """A string or binary column of a numpy unicode array: encoded once to
    fixed-width bytes, the padding dropped by one boolean-matrix index."""
    n = len(u)
    s = np.char.encode(u, "utf-8")
    w = s.dtype.itemsize
    lens = np.char.str_len(s).astype(np.int64)
    if valid is not None:
        lens = np.where(valid, lens, 0)
    if w and n and int(lens.sum()):
        mat = np.frombuffer(s.tobytes(), dtype=np.uint8).reshape(n, w)
        data = mat[np.arange(w, dtype=np.int64)[None, :] < lens[:, None]]
    else:
        data = np.zeros(0, np.uint8)
    mask = valid if valid is not None and not valid.all() else None
    return _rows_column(lens, data, mask, t)


def _convert_column_vec(u: np.ndarray, isnull: np.ndarray,
                        t: dt.DataType, opts: ReadOptions
                        ) -> Optional[HostArray]:
    """Array parse of one csv-module column (u: numpy unicode array, null
    slots blanked to ""). None for a type it does not cover (decimal,
    a timestamp with a timezone) or a malformed cell: the caller parses
    that column value by value."""
    valid = ~isnull
    mask = None if not isnull.any() else valid
    try:
        if t.id == dt.TypeId.BOOL:
            return HostArray(np.isin(u, list(opts.true_values)), mask, t)
        if t.is_integer:
            return HostArray(np.where(isnull, "0", u).astype(np.int64)
                             .astype(t.np_dtype), mask, t)
        if t.is_floating:
            return HostArray(np.where(isnull, "0", u).astype(np.float64)
                             .astype(t.np_dtype), mask, t)
        if t.id == dt.TypeId.DATE32:
            return HostArray(np.where(isnull, "1970-01-01", u)
                             .astype("datetime64[D]").astype(np.int32),
                             mask, t)
        if t.id == dt.TypeId.TIMESTAMP and not t.tz:
            return HostArray(np.where(isnull, "1970-01-01", u)
                             .astype(f"datetime64[{t.unit}]")
                             .astype(np.int64), mask, t)
        if t.id in _STRINGY:
            return _strings_from_unicode(u, mask, t)
    except ValueError:
        return None
    return None


def _infer_type_vec(u: np.ndarray, isnull: np.ndarray,
                    opts: ReadOptions) -> dt.DataType:
    """Array type inference (bool, int64, float64, date32, timestamp,
    string)."""
    nn = u[~isnull]
    if nn.size == 0:
        return dt.null
    bools = list(set(opts.true_values) | set(opts.false_values))
    if np.isin(nn, bools).all():
        return dt.bool_
    for kind, t in ((np.int64, dt.int64), (np.float64, dt.float64)):
        try:
            nn.astype(kind)
            return t
        except ValueError:
            pass
    return _infer_temporal(nn, np.char.str_len(nn),
                           (np.char.find(nn, "-") == 4).all())[0]


def _infer_temporal(nn: np.ndarray, lens: np.ndarray, dash4: bool):
    """(date32, days) for ten-character ISO dates, (timestamp[us],
    microseconds) for ISO datetimes of at least 16, else (string, None):
    both tiers' last steps, with the values they parsed."""
    if dash4:
        if (lens == 10).all():
            try:
                return dt.date32, nn.astype("datetime64[D]").astype(np.int32)
            except ValueError:
                pass
        if (lens >= 16).all():
            try:
                return dt.timestamp("us"), \
                    nn.astype("datetime64[us]").astype(np.int64)
            except ValueError:
                pass
    return dt.string, None


def _rows_to_batch(rows, names, opts: ReadOptions,
                   fixed_schema: Optional[dt.Schema]) -> HostBatch:
    """csv rows -> a HostBatch. `fixed_schema` pins the output types
    (the streaming reader's, from its first chunk). A ragged row is
    padded with empty cells, which are null; a null spelling nulls a
    string column only under strings_can_be_null."""
    nulls_l = sorted(set(opts.null_values))
    keep = (set(opts.include_columns)
            if opts.include_columns is not None else None)
    ncol = len(names)
    rows = [r for r in rows if r]
    n = len(rows)
    lens = np.fromiter(map(len, rows), np.int64, count=n) if n else \
        np.zeros(0, np.int64)
    ragged = bool(n) and (int(lens.min(initial=ncol)) < ncol
                          or int(lens.max(initial=ncol)) > ncol)
    if ragged:
        rows = [r if len(r) == ncol
                else (list(r) + [""] * ncol)[:ncol] for r in rows]
    cols = list(zip(*rows)) if n else [()] * ncol

    out_cols, fields = [], []
    for i, name in enumerate(names):
        if keep is not None and name not in keep:
            continue
        u = (np.asarray(cols[i]) if n else np.zeros(0, "U1"))
        missing = (lens <= i) if ragged else np.zeros(n, np.bool_)
        spelled = np.isin(u, nulls_l) | missing
        if fixed_schema is not None:
            t = fixed_schema.field(fixed_schema.field_index(name)).type
        else:
            t = opts.type_for(name)
            if t is None:
                t = _infer_type_vec(u, spelled, opts)
                if t.id == dt.TypeId.NULL:
                    t = dt.string
        isnull = missing if t.id in _STRINGY and \
            not opts.strings_can_be_null else spelled
        arr = _convert_column_vec(u, isnull, t, opts)
        if arr is None:
            arr = _convert_column([None if isnull[j] else str(u[j])
                                   for j in range(n)], t, opts)
        out_cols.append(arr)
        fields.append(dt.Field(name, t))
    m = len(out_cols[0]) if out_cols else 0
    return HostBatch(dt.Schema(fields), out_cols, m)


# ---------------------------------------------------------------------------
# the numpy tier: byte-level, no per-row Python objects
# ---------------------------------------------------------------------------

_FAST_CELL_BUDGET = 1 << 31     # n_rows * max_field_width byte-matrix cap
_POW10 = 10 ** np.arange(19, dtype=np.int64)


def _sbytes_column(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """(byte matrix, S-dtype array) of one column's cells, zero-padded to
    the widest; MemoryError past the cell budget."""
    n = len(starts)
    w = int(lens.max(initial=0))
    if w == 0 or n == 0:
        return (np.zeros((n, 0), np.uint8),
                np.zeros(n, dtype="S1" if w == 0 else f"S{w}"))
    if n * w > _FAST_CELL_BUDGET:
        raise MemoryError("csv fast path cell budget")
    bufp = np.concatenate([buf, np.zeros(w, np.uint8)])
    if len(bufp) < (1 << 31):
        idx = starts.astype(np.int32)[:, None] + np.arange(w, dtype=np.int32)
    else:
        idx = starts[:, None] + np.arange(w, dtype=np.int64)
    mat = bufp[idx]
    mat[np.arange(w)[None, :] >= lens[:, None]] = 0
    return mat, np.frombuffer(mat.tobytes(), dtype=f"S{w}")


def _slice_concat(buf: np.ndarray, starts: np.ndarray,
                  ends: np.ndarray) -> np.ndarray:
    """buf[s:e) ranges concatenated in order (disjoint and ascending, with
    gaps of at least one byte between them, as csv cells are): one
    keep-mask pass over the buffer."""
    m = ends > starts
    s, e = starts[m], ends[m]
    delta = np.zeros(len(buf) + 1, np.int8)
    delta[s] = 1
    delta[e] = -1
    keep = np.cumsum(delta[:-1], dtype=np.int8).astype(np.bool_)
    return buf[keep]


def _parse_int_s(s: np.ndarray, isnull: np.ndarray) -> np.ndarray:
    """int64 of S-dtype cells by digit arithmetic (a cell padded with
    spaces parses as int() takes it); ValueError on a malformed non-null
    cell."""
    n = len(s)
    w = s.dtype.itemsize
    if w > 19:
        return np.where(isnull, b"0", s).astype(np.int64)
    mat = np.frombuffer(s.tobytes(), np.uint8).reshape(n, w)
    if (mat == 32).any():
        s = np.char.strip(s)
        mat = np.zeros((n, w), np.uint8)
        sw = s.dtype.itemsize
        mat[:, :sw] = np.frombuffer(s.tobytes(), np.uint8).reshape(n, sw)
    lens = (mat != 0).argmin(axis=1)
    lens[mat[:, w - 1] != 0] = w            # full-width cells: no NUL pad
    sign_ch = mat[:, 0]
    signed = (sign_ch == 45) | (sign_ch == 43)
    digit = mat - 48
    j = np.arange(w)[None, :]
    body = j < lens[:, None]
    body[:, 0] &= ~signed
    good = ((digit <= 9) | ~body).all(axis=1) & (lens > signed) & (~isnull)
    if not (good | isnull).all():
        bad = int(np.flatnonzero(~(good | isnull))[0])
        raise ValueError(f"invalid literal for int64: {s[bad]!r}")
    weights = _POW10[np.clip(lens[:, None] - 1 - j, 0, 18)] * body
    vals = (digit.astype(np.int64) * weights).sum(axis=1)
    vals = np.where(sign_ch == 45, -vals, vals)
    return np.where(isnull, np.int64(0), vals)


def _infer_type_s(s: np.ndarray, isnull: np.ndarray, opts: ReadOptions):
    """Inference over S-dtype cells, in _infer_column_type's order: (the
    type, the non-null cells' values as its storage when the inference
    parsed them, else None; the conversion scatters them instead of
    parsing the cells again)."""
    nn = s[~isnull]
    if nn.size == 0:
        return dt.null, None
    bools = [v.encode() for v in
             set(opts.true_values) | set(opts.false_values)]
    if np.isin(nn, bools).all():
        return dt.bool_, None
    try:
        return dt.int64, _parse_int_s(nn, np.zeros(len(nn), np.bool_))
    except ValueError:
        pass
    try:
        return dt.float64, nn.astype(np.float64)
    except ValueError:
        pass
    return _infer_temporal(nn, np.char.str_len(nn),
                           (np.char.find(nn, b"-") == 4).all())


def _convert_s_column(buf, starts, ends, clens, mat, s, isnull,
                      t: dt.DataType, opts: ReadOptions, parsed=None
                      ) -> Optional[HostArray]:
    """Typed parse of one numpy-tier column from its S-dtype cells (`s`
    and `isnull` are None for a declared string column that no null
    spelling can null: its bytes pass straight through; `parsed`, the
    non-null cells' storage values the inference parsed, 0 goes under a
    null). None for a type the tier does not parse."""
    n = len(starts)
    if t.id in _STRINGY:
        smask = None
        if opts.strings_can_be_null and isnull is not None and isnull.any():
            smask = ~isnull
            clens = np.where(isnull, 0, clens)
            ends = starts + clens
        if mat is not None and mat.shape[1]:
            dat = mat[np.arange(mat.shape[1])[None, :] < clens[:, None]]
        else:
            dat = _slice_concat(buf, starts, ends)
        return _rows_column(clens, dat, smask, t)
    mask = None if isnull is None or not isnull.any() else ~isnull
    if parsed is not None:
        vals = np.zeros(n, t.np_dtype)
        vals[~isnull] = parsed
        return HostArray(vals, mask, t)
    if t.id == dt.TypeId.BOOL:
        return HostArray(np.isin(s, [v.encode() for v in opts.true_values]),
                         mask, t)
    if t.is_integer:
        return HostArray(_parse_int_s(s, isnull).astype(t.np_dtype), mask, t)
    if t.is_floating:
        return HostArray(np.where(isnull, b"0", s).astype(np.float64)
                         .astype(t.np_dtype), mask, t)
    if t.id == dt.TypeId.DATE32:
        return HostArray(np.where(isnull, b"1970-01-01", s)
                         .astype("datetime64[D]").astype(np.int32), mask, t)
    if t.id == dt.TypeId.TIMESTAMP and not t.tz:
        return HostArray(np.where(isnull, b"1970-01-01", s)
                         .astype(f"datetime64[{t.unit}]").astype(np.int64),
                         mask, t)
    return None


def _read_csv_fast(data: bytes, opts: ReadOptions) -> Optional[HostBatch]:
    """Parse a whole unquoted csv buffer with numpy only; None when the
    input needs the csv-module tier (quotes, comments, ragged rows, a
    multi-character delimiter, no line, oversized cells)."""
    if opts.comment or len(opts.delimiter) != 1:
        return None
    buf = np.frombuffer(data, np.uint8)
    if (buf == ord('"')).any():
        return None
    nl = np.flatnonzero(buf == 10)
    if len(buf) and (len(nl) == 0 or nl[-1] != len(buf) - 1):
        nl = np.append(nl, len(buf))        # virtual trailing newline
    if len(nl) == 0:
        return None
    line_start = np.empty(len(nl), np.int64)
    line_start[0] = 0
    line_start[1:] = nl[:-1] + 1
    line_end = nl.astype(np.int64).copy()
    crlf = (line_end > line_start) & (buf[np.maximum(line_end - 1, 0)] == 13)
    line_end[crlf] -= 1

    k = opts.skip_rows
    if k >= len(nl):
        return None
    first = data[line_start[k]:line_end[k]].decode("utf-8")
    if opts.has_header:
        names = opts.column_names or first.split(opts.delimiter)
        first_data = k + 1
    else:
        names = opts.column_names or (
            opts.schema.names if opts.schema else
            [f"f{i}" for i in range(first.count(opts.delimiter) + 1)])
        first_data = k
    ncol = len(names)

    ls = line_start[first_data:]
    le = line_end[first_data:]
    nonempty = le > ls
    ls, le = ls[nonempty], le[nonempty]
    n = len(ls)
    dl = np.flatnonzero(buf == ord(opts.delimiter)).astype(np.int64)
    cnt = np.searchsorted(dl, le) - np.searchsorted(dl, ls)
    if n and not (cnt == ncol - 1).all():
        return None                         # ragged: csv-module tier
    ends = np.empty((n, ncol), np.int64)
    if ncol > 1 and n:
        base = np.searchsorted(dl, ls)
        ends[:, :-1] = dl[base[:, None] + np.arange(ncol - 1)[None, :]]
    ends[:, -1] = le
    starts = np.empty((n, ncol), np.int64)
    starts[:, 0] = ls
    starts[:, 1:] = ends[:, :-1] + 1

    nulls_b = [v.encode() for v in set(opts.null_values)]
    keep = (set(opts.include_columns)
            if opts.include_columns is not None else None)

    def one(i, name):
        clens = ends[:, i] - starts[:, i]
        t = opts.type_for(name)
        mat = s = isnull = parsed = None
        if t is None or t.id not in _STRINGY or opts.strings_can_be_null:
            mat, s = _sbytes_column(buf, starts[:, i], clens)
            isnull = np.isin(s, nulls_b)
        if t is None:
            t, parsed = _infer_type_s(s, isnull, opts)
            if t.id == dt.TypeId.NULL:
                t = dt.string
        arr = _convert_s_column(buf, starts[:, i], ends[:, i], clens,
                                mat, s, isnull, t, opts, parsed)
        if arr is None:                     # this column value by value
            arr = _convert_column(
                [None if isnull is not None and isnull[j]
                 else data[starts[j, i]:ends[j, i]].decode("utf-8")
                 for j in range(n)], t, opts)
        return arr, dt.Field(name, t)

    sel = [(i, nm) for i, nm in enumerate(names)
           if keep is None or nm in keep]
    try:
        if len(sel) > 1 and n > 65536:
            # numpy releases the interpreter lock: columns in parallel
            # (the reference's per-column goroutines, csv/reader.go:108)
            with cf.ThreadPoolExecutor(
                    min(len(sel), os.cpu_count() or 2)) as ex:
                res = list(ex.map(lambda a: one(*a), sel))
        else:
            res = [one(*a) for a in sel]
    except MemoryError:
        return None                         # cell budget: csv-module tier
    out_cols = [r[0] for r in res]
    m = len(out_cols[0]) if out_cols else 0
    return HostBatch(dt.Schema([r[1] for r in res]), out_cols, m)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _text_rows(f, opts: ReadOptions):
    """(names, row iterator) of a text stream: skip_rows dropped, comment
    rows filtered, the header (or the first row's width) read."""
    rows = _csv.reader(f, delimiter=opts.delimiter)
    for _ in range(opts.skip_rows):
        next(rows, None)
    it = iter(rows)
    if opts.comment:
        it = (r for r in it if not (r and r[0].startswith(opts.comment)))
    if opts.has_header:
        header = next(it, None)
        if header is None:
            raise ArrowInvalid("empty csv input")
        return opts.column_names or header, it
    first = next(it, None)
    if first is None and opts.schema is None:
        raise ArrowInvalid("empty csv input and no schema")
    names = opts.column_names or (
        opts.schema.names if opts.schema else
        [f"f{i}" for i in range(len(first))])
    if first is not None:
        it = _chain_one(first, it)
    return names, it


def _chain_one(first, it):
    yield first
    yield from it


def read_csv(source: Union[str, bytes, io.IOBase],
             options: Optional[ReadOptions] = None) -> HostBatch:
    """A whole csv input (a path, bytes or a file object) as one
    HostBatch; bytes and paths go through the numpy tier when they can."""
    opts = options or ReadOptions()
    raw: Optional[bytes] = None
    if isinstance(source, (bytes, bytearray, memoryview)):
        raw = bytes(source)
    elif isinstance(source, str):
        with open(source, "rb") as rf:
            raw = rf.read()
    if raw is not None:
        batch = _read_csv_fast(raw, opts)
        if batch is not None:
            return batch
        f = io.StringIO(raw.decode("utf-8"))
    elif isinstance(source, io.TextIOBase):
        f = source
    else:
        f = io.TextIOWrapper(source, "utf-8")
    names, it = _text_rows(f, opts)
    return _rows_to_batch(list(it), names, opts, None)


class CSVReader:
    """Streaming csv reader yielding HostBatches of `chunk_size` rows
    (reference csv.Reader with WithChunk, arrow/csv/reader.go:108),
    through the csv-module tier. The schema is inferred from (or given
    for) the first chunk and pinned for the rest of the stream."""

    def __init__(self, source, options: Optional[ReadOptions] = None):
        self.opts = options or ReadOptions()
        if isinstance(source, (bytes, bytearray, memoryview)):
            f = io.StringIO(bytes(source).decode("utf-8"))
        elif isinstance(source, str):
            f = open(source, "r", newline="")
        elif isinstance(source, io.TextIOBase):
            f = source
        else:
            f = io.TextIOWrapper(source, "utf-8")
        self._f = f
        try:
            self._names, self._it = _text_rows(f, self.opts)
        except ArrowInvalid:
            f.close()
            raise
        self._schema: Optional[dt.Schema] = None

    @property
    def schema(self) -> Optional[dt.Schema]:
        return self._schema

    def read_next_batch(self) -> Optional[HostBatch]:
        rows = []
        for row in self._it:
            rows.append(row)
            if len(rows) >= self.opts.chunk_size:
                break
        if not rows:
            return None
        batch = _rows_to_batch(rows, self._names, self.opts, self._schema)
        if self._schema is None:
            self._schema = batch.schema
        return batch

    def __iter__(self) -> Iterator[HostBatch]:
        while True:
            b = self.read_next_batch()
            if b is None:
                return
            yield b

    def read_all(self) -> HostBatch:
        """Every remaining row in one HostBatch (string dictionaries merged
        in first-occurrence order)."""
        batches = list(self)
        if not batches:
            raise ArrowInvalid("empty csv input")
        first = batches[0]
        return HostBatch(first.schema, [
            concat_host_arrays([b.columns[i] for b in batches])
            for i in range(len(first.columns))],
            sum(b.num_rows for b in batches))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_csv(source, options: Optional[ReadOptions] = None) -> CSVReader:
    return CSVReader(source, options)


@dataclass
class WriteOptions:
    delimiter: str = ","
    include_header: bool = True
    null_string: str = ""                   # reference WithNullWriter
    crlf: bool = False                      # WithCRLF
    bool_formatter: Optional[object] = None  # WithBoolWriter


def write_csv(data: Union[HostBatch, Sequence[HostBatch]], sink,
              options: Optional[WriteOptions] = None) -> None:
    """A HostBatch (or a sequence of them, one schema: the JAX package's
    Table) as csv text, row by row through `csv.writer`: nulls as
    null_string, bools by bool_formatter (true / false), floats by
    repr, bytes decoded as UTF-8, every other value by str; quoting is
    csv's minimal rule."""
    opts = options or WriteOptions()
    data = host_batch(data)
    batches = [data] if isinstance(data, HostBatch) else list(data)
    schema = batches[0].schema
    own = False
    if isinstance(sink, str):
        f = open(sink, "w", newline="")
        own = True
    elif isinstance(sink, io.TextIOBase):
        f = sink
    else:
        f = io.TextIOWrapper(sink, "utf-8")
    try:
        w = _csv.writer(f, delimiter=opts.delimiter,
                        lineterminator="\r\n" if opts.crlf else "\n")
        if opts.include_header:
            w.writerow(schema.names)
        bool_fmt = opts.bool_formatter or (lambda b: "true" if b else "false")
        for hb in batches:
            cols = [c.to_pylist() for c in hb.columns]
            for row in zip(*cols):
                w.writerow([opts.null_string if v is None
                            else (bool_fmt(v) if isinstance(v, bool)
                                  else _fmt(v))
                            for v in row])
        f.flush()
    finally:
        if own:
            f.close()
        elif isinstance(f, io.TextIOWrapper) and \
                not isinstance(sink, io.TextIOBase):
            f.detach()


def _fmt(v):
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, float):
        return repr(v)
    return v
