"""ChunkedArray over HostArrays (after arrow_go_tpu/array/record.py:120-200;
reference arrow.Chunked, arrow/table.go:135): same-typed chunks viewed
as one logical column, kept apart until `combine` concatenates them
(device/block.concat_host_arrays). The compute functions that take a
ChunkedArray (filter, take, the aggregates, run_end_encode) combine it
first, as the JAX ones do.

A string column's chunks are dictionary-coded HostArrays; a chunk whose
type is dictionary<int32, T> counts as a chunk of type T, the field type
a port schema gives such a column.

`record_batch` and `table` (after arrow_go_tpu/array/record.py:324-335)
both build a HostBatch, the port's RecordBatch and Table.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .. import dtypes as dt
from ..device.block import (HostArray, HostBatch, concat_host_arrays,
                            from_pylist)
from .arrays import _same_type, array, field_type


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
            if not _same_type(c.type, type):
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
        return sum(len(c) - int(c.validity_bools().sum())
                   for c in self._chunks)

    def combine(self) -> HostArray:
        """One HostArray of every chunk's rows (the only chunk as it is;
        no chunk gives an empty column of the type)."""
        if len(self._chunks) == 1:
            return self._chunks[0]
        if not self._chunks:
            return from_pylist([], self._type)
        return concat_host_arrays(self._chunks)

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
                return c.slice(i, 1).to_pylist()[0]
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


def record_batch(data, names: Optional[Sequence[str]] = None,
                 schema: Optional[dt.Schema] = None) -> HostBatch:
    """A HostBatch of a {name: values} dict (each column by `array`, under
    `schema`'s types when given, else its values' type) or of a list of
    HostArrays named by `names`. ValueError when the columns' lengths
    differ."""
    if isinstance(data, dict):
        if schema is not None:
            cols = [array(v, f.type) for v, f in zip(data.values(),
                                                     schema.fields)]
        else:
            cols = [array(v) for v in data.values()]
            schema = dt.Schema([dt.Field(k, field_type(c))
                                for k, c in zip(data, cols)])
    else:
        cols = [array(c) for c in data]
        schema = dt.Schema([dt.Field(k, field_type(c))
                            for k, c in zip(names, cols)])
    n = len(cols[0]) if cols else 0
    for f, c in zip(schema.fields, cols):
        if len(c) != n:
            raise ValueError(f"column {f.name} length {len(c)} != {n}")
    return HostBatch(schema, cols, n)


def table(data, names: Optional[Sequence[str]] = None,
          schema: Optional[dt.Schema] = None) -> HostBatch:
    """`record_batch`: the port's Table is one HostBatch."""
    return record_batch(data, names, schema)
