"""RecordBatch, ChunkedArray, Column and Table over HostArrays (after
arrow_go_tpu/array/record.py; reference arrow/record.go:26,
arrow/table.go:30,65,135).

A RecordBatch is a HostBatch (device/block.py), so every port function
that takes a HostBatch takes one; it adds the JAX constructor's checks
and static constructors. A Table is a schema plus one ChunkedArray a
column, kept apart until `combine_chunks`; the port's entry points that
take a HostBatch take a Table through `host_batch`, which combines its
chunks. A ChunkedArray's chunks are HostArrays of its one type, and a
batch's columns have its fields' types, as the JAX constructors check.
The compute functions that take a ChunkedArray (filter, take, the
aggregates, run_end_encode) combine it first, as the JAX ones do.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

from .. import dtypes as dt
from ..device.block import HostArray, HostBatch, from_pylist
from .arrays import array


class RecordBatch(HostBatch):
    """Schema + equal-length HostArray columns (the JAX RecordBatch)."""

    def __init__(self, schema: dt.Schema, columns: Sequence[HostArray],
                 num_rows: Optional[int] = None):
        if len(schema) != len(columns):
            raise ValueError("schema/column count mismatch")
        if num_rows is None:
            num_rows = len(columns[0]) if columns else 0
        for f, c in zip(schema.fields, columns):
            if len(c) != num_rows:
                raise ValueError(f"column {f.name} length {len(c)} != "
                                 f"{num_rows}")
            if c.type != f.type:
                raise ValueError(f"column {f.name} type {c.type} != schema "
                                 f"{f.type}")
        super().__init__(schema, list(columns), num_rows)

    @staticmethod
    def from_arrays(columns, names: Optional[Sequence[str]] = None,
                    metadata: dt.Metadata = dt.EMPTY_METADATA
                    ) -> "RecordBatch":
        """A RecordBatch of HostArrays named by `names` (or of a
        {name: HostArray} dict)."""
        if isinstance(columns, dict):
            names, columns = list(columns), list(columns.values())
        fields = [dt.Field(n, c.type, True)
                  for n, c in zip(names, columns)]
        return RecordBatch(dt.Schema(fields, metadata), columns)

    @staticmethod
    def from_pydict(data: Dict[str, object],
                    schema: Optional[dt.Schema] = None) -> "RecordBatch":
        if schema is not None:
            return RecordBatch(schema, [array(v, t) for v, t in
                                        zip(data.values(), schema.types)])
        return RecordBatch.from_arrays([array(v) for v in data.values()],
                                       list(data))

    def __repr__(self):
        return f"RecordBatch({self.schema}, num_rows={self.num_rows})"


class ChunkedArray:
    """List of same-type HostArray chunks viewed as one logical array."""

    def __init__(self, chunks: Sequence[HostArray],
                 type: Optional[dt.DataType] = None):
        chunks = list(chunks)
        if type is None:
            if not chunks:
                raise ValueError("need type for empty chunked array")
            type = chunks[0].type
        for c in chunks:
            if c.type != type:
                raise ValueError("chunk type mismatch")
        self._chunks = chunks
        self._type = type

    @property
    def type(self) -> dt.DataType:
        return self._type

    @property
    def chunks(self) -> List[HostArray]:
        return list(self._chunks)

    @property
    def num_chunks(self) -> int:
        return len(self._chunks)

    def chunk(self, i: int) -> HostArray:
        return self._chunks[i]

    def __len__(self) -> int:
        return sum(len(c) for c in self._chunks)

    @property
    def length(self) -> int:
        return len(self)

    @property
    def null_count(self) -> int:
        return sum(c.null_count for c in self._chunks)

    def combine(self) -> HostArray:
        """One HostArray of every chunk's rows (the only chunk as it is;
        no chunk gives an empty column of the type)."""
        from .concat import concat_arrays
        if len(self._chunks) == 1:
            return self._chunks[0]
        if not self._chunks:
            return from_pylist([], self._type)
        return concat_arrays(self._chunks)

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "ChunkedArray":
        if length is None:
            length = len(self) - offset
        out = []
        for c in self._chunks:
            if length <= 0:
                break
            n = len(c)
            if offset >= n:
                offset -= n
                continue
            take = min(n - offset, length)
            out.append(c.slice(offset, take))
            length -= take
            offset = 0
        return ChunkedArray(out, self._type)

    def __getitem__(self, i: int):
        if i < 0:
            i += len(self)
        for c in self._chunks:
            if i < len(c):
                return c[i]
            i -= len(c)
        raise IndexError(i)

    def to_pylist(self) -> list:
        out = []
        for c in self._chunks:
            out.extend(c.to_pylist())
        return out

    def equals(self, other: "ChunkedArray") -> bool:
        return self._type == other._type and \
            self.to_pylist() == other.to_pylist()

    def __repr__(self):
        return (f"ChunkedArray({self._type}, chunks={self.num_chunks}, "
                f"len={len(self)})")


class Column:
    """Field + chunked data (reference arrow.Column, table.go:65)."""

    def __init__(self, field: dt.Field, data: ChunkedArray):
        if data.type != field.type:
            raise ValueError("field/data type mismatch")
        self.field = field
        self.data = data

    @property
    def name(self) -> str:
        return self.field.name

    @property
    def type(self) -> dt.DataType:
        return self.field.type

    def __len__(self):
        return len(self.data)


class Table:
    """Schema + ChunkedArray columns (reference arrow.Table, table.go:30)."""

    def __init__(self, schema: dt.Schema, columns: Sequence[ChunkedArray],
                 num_rows: Optional[int] = None):
        if len(schema) != len(columns):
            raise ValueError("schema/column count mismatch")
        if num_rows is None:
            num_rows = len(columns[0]) if columns else 0
        self._schema = schema
        self._columns = list(columns)
        self._num_rows = num_rows

    @staticmethod
    def from_batches(batches: Sequence[HostBatch],
                     schema: Optional[dt.Schema] = None) -> "Table":
        """A Table of batches' rows, each batch a chunk."""
        if schema is None:
            if not batches:
                raise ValueError("need schema for empty table")
            schema = batches[0].schema
        cols = [ChunkedArray([b.column(i) for b in batches],
                             schema.field(i).type)
                for i in range(len(schema))]
        return Table(schema, cols, sum(b.num_rows for b in batches))

    @staticmethod
    def from_arrays(columns: Sequence[HostArray],
                    names: Sequence[str]) -> "Table":
        fields = [dt.Field(n, c.type) for n, c in zip(names, columns)]
        return Table(dt.Schema(fields),
                     [ChunkedArray([c], f.type)
                      for c, f in zip(columns, fields)])

    @staticmethod
    def from_pydict(data: Dict[str, object],
                    schema: Optional[dt.Schema] = None) -> "Table":
        return Table.from_batches([RecordBatch.from_pydict(data, schema)])

    @property
    def schema(self) -> dt.Schema:
        return self._schema

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def num_columns(self) -> int:
        return len(self._columns)

    @property
    def columns(self) -> List[ChunkedArray]:
        return list(self._columns)

    def column(self, i: Union[int, str]) -> ChunkedArray:
        if isinstance(i, str):
            idx = self._schema.field_index(i)
            if idx < 0:
                raise KeyError(i)
            i = idx
        return self._columns[i]

    def __getitem__(self, key) -> ChunkedArray:
        return self.column(key)

    def slice(self, offset: int, length: Optional[int] = None) -> "Table":
        if length is None:
            length = self._num_rows - offset
        length = max(min(length, self._num_rows - offset), 0)
        return Table(self._schema, [c.slice(offset, length)
                                    for c in self._columns], length)

    def select(self, names: Sequence[str]) -> "Table":
        idxs = [self._schema.field_index(n) for n in names]
        return Table(dt.Schema([self._schema.field(i) for i in idxs],
                               self._schema.metadata),
                     [self._columns[i] for i in idxs], self._num_rows)

    def combine_chunks(self) -> "Table":
        return Table(self._schema, [ChunkedArray([c.combine()], c.type)
                                    for c in self._columns], self._num_rows)

    def to_batches(self, max_chunksize: Optional[int] = None
                   ) -> List[RecordBatch]:
        """The rows as RecordBatches of at most `max_chunksize` rows (one
        batch without it), over the combined chunks."""
        cols = [c.combine() for c in self._columns]
        n = self._num_rows
        if max_chunksize is None or n <= max_chunksize:
            return [RecordBatch(self._schema, cols, n)]
        return [RecordBatch(self._schema, [c.slice(s, min(max_chunksize,
                                                          n - s))
                                           for c in cols],
                            min(max_chunksize, n - s))
                for s in range(0, n, max_chunksize)]

    def to_pydict(self) -> Dict[str, list]:
        return {f.name: c.to_pylist()
                for f, c in zip(self._schema.fields, self._columns)}

    def equals(self, other: "Table") -> bool:
        return self._schema.equals(other.schema) and \
            self.to_pydict() == other.to_pydict()

    def __eq__(self, other):
        if isinstance(other, Table):
            return self.equals(other)
        return NotImplemented

    __hash__ = object.__hash__

    def __repr__(self):
        return f"Table({self._schema}, num_rows={self._num_rows})"


def host_batch(data):
    """What an entry point that takes a HostBatch works on: a Table's
    chunks combined into one RecordBatch; anything else (a HostBatch, a
    RecordBatch, a DeviceBatch, a sequence of batches) as it is."""
    if isinstance(data, Table):
        return data.to_batches()[0]
    return data


def record_batch(data, names: Optional[Sequence[str]] = None,
                 schema: Optional[dt.Schema] = None) -> RecordBatch:
    """A RecordBatch of a {name: values} dict (each column by `array`,
    under `schema`'s types when given, else its values' type) or of a
    list of columns named by `names`. ValueError when the columns'
    lengths differ."""
    if isinstance(data, dict):
        return RecordBatch.from_pydict(data, schema)
    return RecordBatch.from_arrays([array(c) for c in data], names)


def table(data, names: Optional[Sequence[str]] = None,
          schema: Optional[dt.Schema] = None) -> Table:
    """A Table of one chunk: `record_batch`'s rows."""
    if isinstance(data, dict):
        return Table.from_pydict(data, schema)
    return Table.from_arrays([array(c) for c in data], names)
