"""Arrow IPC: the streaming format and the random-access file format.

Port of arrow_go_tpu/ipc (reference arrow/ipc: reader.go:97 the stream
reader, writer.go:125 the stream writer, file_reader.go:248 and
file_writer.go:267 the file with its footer, internal/dictutils the
dictionary ids, body compression). The writers take the port's
HostBatches, the readers give HostBatches (ipc/core.py says how each
type is laid out); `read_all` gives a Table of them, a chunk each, as
the JAX package does.

new_stream / open_stream: the streaming format.
new_file / open_file:     the file format ("ARROW1" magic and footer).

A field of a DictionaryType is written as indices with its dictionary in
a DictionaryBatch, sent again whenever a batch's dictionary differs from
the one sent: as a replacement, or, by a StreamWriter made with
`emit_dictionary_deltas`, as a delta when it extends the one sent. A
reader applies both. Bodies may be compressed with "lz4" (the LZ4 frame
format) or "zstd", on a thread pool with `compression_concurrency` and
`decompress_concurrency`. A truncated or malformed input raises
ArrowInvalid.
"""
from __future__ import annotations

import io
import mmap
import struct
from typing import BinaryIO, Dict, List, Optional, Union

import numpy as np

from .. import dtypes as dt
from ..array.record import host_batch
from ..compute.errors import ArrowInvalid
from ..device.block import (ExtensionArray, HostArray, HostBatch,
                            concat_host_arrays, dictionary_as_array,
                            dictionary_from_array)
from . import core, metadata as md
from .fb import Builder, Reader as FbReader

MAGIC = b"ARROW1"


class DictMapper:
    """Dictionary ids (reference internal/dictutils Mapper, dict.go:59):
    every dictionary-typed field, depth first, gets the next id."""

    def __init__(self):
        self.field_to_id: Dict[int, int] = {}
        self.id_to_field: Dict[int, dt.Field] = {}

    def assign(self, schema: dt.Schema) -> None:
        def walk(f: dt.Field):
            t = f.type
            if t.id == dt.TypeId.DICTIONARY:
                did = len(self.id_to_field)
                self.field_to_id[id(f)] = did
                self.id_to_field[did] = f
                t = t.value_type
            for cf in t.fields():
                walk(cf)
        for f in schema.fields:
            walk(f)


def _dictionaries(schema: dt.Schema, columns, mapper: DictMapper) -> dict:
    """{id: dictionary values} of a batch's dictionary fields."""
    out = {}

    def walk(f: dt.Field, arr: HostArray):
        if f.type.id == dt.TypeId.EXTENSION:
            arr = arr.storage
        if f.type.id == dt.TypeId.DICTIONARY:
            out[mapper.field_to_id[id(f)]] = arr.dict_values
            return
        for cf, ca in zip(f.type.fields(), arr.children):
            walk(cf, ca)
    for f, c in zip(schema.fields, columns):
        walk(f, c)
    return out


def _same(a, b) -> bool:
    return a is b or (len(a) == len(b) and bool(np.all(a == b)))


class StreamWriter:
    """IPC stream writer (reference ipc/writer.go:125). `endianness="big"`
    writes a big-endian stream (the schema flag and swapped buffers);
    `emit_dictionary_deltas` sends a dictionary that extends the one
    sent as a delta of its new entries (reference WithDictionaryDeltas),
    where the JAX writer always sends a replacement."""

    def __init__(self, sink: BinaryIO, schema: dt.Schema,
                 compression: Optional[str] = None,
                 endianness: str = "little",
                 compression_concurrency: int = 0,
                 emit_dictionary_deltas: bool = False):
        core.codec_id(compression)          # an unknown codec raises
        self.sink = sink
        self.schema = schema
        self.compression = compression
        self.compression_concurrency = compression_concurrency
        self._big = endianness == "big"
        self._deltas = emit_dictionary_deltas
        self.mapper = DictMapper()
        self.mapper.assign(schema)
        self._wrote_schema = False
        self._sent: Dict[int, object] = {}
        self._closed = False
        self._pos = 0

    def _put(self, data) -> None:
        self.sink.write(data)
        self._pos += len(data)

    def _message(self, meta: bytes, parts, body_len: int) -> tuple:
        """Write one framed message; (its offset, framed length, body)."""
        at = self._pos
        framed = core.frame_message(meta)
        self._put(framed)
        for p in parts:
            self._put(p)
        return at, len(framed), body_len

    def _write_schema(self) -> None:
        self._put(core.frame_message(core.build_schema_message(
            self.schema, self.mapper.field_to_id, int(self._big))))
        self._wrote_schema = True

    def _batch(self, columns, types, n: int, **kw) -> tuple:
        meta, parts, body_len = core.build_record_batch_parts(
            columns, types, n, self.compression,
            compress_concurrency=self.compression_concurrency,
            big=self._big, **kw)
        return self._message(meta, parts, body_len)

    def _write_dictionaries(self, batch: HostBatch) -> List[tuple]:
        blocks = []
        for did, values in _dictionaries(self.schema, batch.columns,
                                         self.mapper).items():
            prev = self._sent.get(did)
            if prev is not None and _same(prev, values):
                continue
            vt = self.mapper.id_to_field[did].type.value_type
            delta = self._deltas and prev is not None and \
                len(values) > len(prev) and _same(prev, values[:len(prev)])
            new = values[len(prev):] if delta else values
            blocks.append(self._batch([dictionary_as_array(new, vt)], [vt],
                                      len(new), dictionary_id=did,
                                      is_delta=delta))
            self._sent[did] = values
        return blocks

    def write(self, batch: HostBatch) -> None:
        """Write a HostBatch (a RecordBatch, or a Table's combined
        chunks)."""
        batch = host_batch(batch)
        if self._closed:
            raise ArrowInvalid("writer closed")
        if not self._wrote_schema:
            self._write_schema()
        self._write_dictionaries(batch)
        self._batch(batch.columns, [f.type for f in self.schema.fields],
                    batch.num_rows)

    def write_table(self, table) -> None:
        """Write each of `table.to_batches()` (a Table's combined
        chunks, one batch) as a record batch."""
        for b in table.to_batches():
            self.write(b)

    def _end(self) -> None:
        if not self._wrote_schema:
            self._write_schema()
        self._put(core.EOS)

    def close(self) -> None:
        if not self._closed:
            self._end()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Bytes:
    """A byte source read by position: a memoryview (bytes, a map), or a
    seekable file."""

    def __init__(self, source):
        self.view = self.file = None
        if isinstance(source, (bytes, bytearray, memoryview, mmap.mmap)):
            self.view = memoryview(source).cast("B")
            self.size = len(self.view)
        else:
            self.file = source
            self.size = source.seek(0, io.SEEK_END)

    def read(self, at: int, n: int):
        if at < 0 or n < 0 or at + n > self.size:
            raise ArrowInvalid(f"IPC input of {self.size} bytes ends "
                               f"before {at + n}")
        if self.view is not None:
            return self.view[at: at + n]
        self.file.seek(at)
        return self.file.read(n)


class _Reader:
    """What the stream and file readers share: the schema, the
    dictionaries and the batch loads (`decompress_s`: the seconds their
    bodies took to decompress)."""

    decompress_s = 0.0

    def _set_schema(self, sr: FbReader) -> None:
        memo: Dict[int, dt.Field] = {}
        self._big = sr.i16(0) == 1
        self.schema = md.read_schema(sr, memo)
        self.mapper_fields = memo
        self._field_ids = {id(f): did for did, f in memo.items()}
        self.dictionaries: Dict[int, object] = {}

    def _field_id(self, f: dt.Field) -> Optional[int]:
        return self._field_ids.get(id(f))

    def _load_dictionary(self, r: FbReader, body) -> None:
        db = r.table(2)
        did = db.i64(0)
        f = self.mapper_fields.get(did)
        if f is None:
            raise ArrowInvalid(f"dictionary batch of unknown id {did}")
        vt = f.type.value_type
        rb = db.table(1)
        if rb is None:
            raise ArrowInvalid("dictionary batch without its data")
        br = core.BodyReader(rb, body, big=self._big)
        values = dictionary_from_array(core.load_array(br, vt, {}), vt)
        self.decompress_s += br.decompress_s
        if db.bool_(2) and did in self.dictionaries:     # a delta
            values = np.concatenate([self.dictionaries[did], values])
        self.dictionaries[did] = values

    def _load_batch(self, r: FbReader, body) -> HostBatch:
        rb = r.table(2)
        if rb is None:
            raise ArrowInvalid("record batch message without its header")
        br = core.BodyReader(rb, body, self.decompress_concurrency,
                             self._big)
        cols = [core.load_array(br, f.type, self.dictionaries,
                                self._field_id(f), self._field_id)
                for f in self.schema.fields]
        self.decompress_s += br.decompress_s
        n = br.num_rows
        if any(len(c) != n for c in cols):
            raise ArrowInvalid(f"a column's length differs from the "
                               f"batch's {n} rows")
        return HostBatch(self.schema, cols, n)

    def read_all(self):
        """Every batch as a Table, a chunk each (the JAX reader's)."""
        from ..array.record import Table
        return Table.from_batches(list(self), self.schema)


def _concat_batches(schema: dt.Schema, batches: List[HostBatch]
                    ) -> HostBatch:
    if len(batches) == 1:
        return batches[0]
    if not batches:
        from ..compute.nested_selection import null_rows
        cols = []
        for f in schema.fields:
            t = f.type.storage_type if f.type.id == dt.TypeId.EXTENSION \
                else f.type
            col = null_rows(t, 0)
            col.mask = None
            cols.append(ExtensionArray(f.type, col)
                        if f.type.id == dt.TypeId.EXTENSION else col)
        return HostBatch(schema, cols, 0)
    cols = []
    for i, f in enumerate(schema.fields):
        parts = [b.columns[i] for b in batches]
        if f.type.id == dt.TypeId.EXTENSION:
            cols.append(ExtensionArray(f.type, concat_host_arrays(
                [p.storage for p in parts])))
        else:
            cols.append(concat_host_arrays(parts))
    return HostBatch(schema, cols, sum(b.num_rows for b in batches))


class StreamReader(_Reader):
    """IPC stream reader (reference ipc/reader.go:97): bytes or a
    binary file object."""

    def __init__(self, source: Union[BinaryIO, bytes],
                 decompress_concurrency: int = 0):
        if isinstance(source, (bytes, bytearray, memoryview)):
            self._view, self._at, self.src = memoryview(source).cast("B"), \
                0, None
        else:
            self._view, self.src = None, source
        self.decompress_concurrency = decompress_concurrency
        r, _ = self._read_message()
        if r is None or r.u8(1) != md.MSG_SCHEMA:
            raise ArrowInvalid("expected schema message")
        sr = r.table(2)
        if sr is None:
            raise ArrowInvalid("schema message without its schema")
        self._set_schema(sr)

    def _read(self, n: int):
        if self._view is not None:
            out = self._view[self._at: self._at + n]
            self._at += len(out)
            return out
        return self.src.read(n)

    def _read_exact(self, n: int, what: str):
        out = self._read(n)
        if len(out) != n:
            raise ArrowInvalid(f"IPC stream ends inside {what} ({len(out)} "
                               f"of {n} bytes)")
        return out

    def _read_message(self):
        head = self._read(4)
        if len(head) < 4:
            return None, None
        (w,) = struct.unpack("<I", head)
        size = w
        if w == core.CONTINUATION:
            (size,) = struct.unpack("<i", self._read_exact(4, "a message "
                                                              "length"))
        if size == 0:
            return None, None
        if size < 0:
            raise ArrowInvalid(f"message length {size}")
        r = FbReader.root(bytes(self._read_exact(size, "a message")))
        body_len = r.i64(3)
        if body_len < 0:
            raise ArrowInvalid(f"message body length {body_len}")
        body = self._read_exact(body_len, "a message body") if body_len \
            else b""
        return r, body

    def read_next_batch(self) -> Optional[HostBatch]:
        while True:
            r, body = self._read_message()
            if r is None:
                return None
            ht = r.u8(1)
            if ht == md.MSG_DICTIONARY_BATCH:
                self._load_dictionary(r, body)
            elif ht == md.MSG_RECORD_BATCH:
                return self._load_batch(r, body)
            else:
                raise ArrowInvalid(f"unexpected message header {ht}")

    def __iter__(self):
        while True:
            b = self.read_next_batch()
            if b is None:
                return
            yield b


class FileWriter(StreamWriter):
    """Random-access file writer: the magic, the stream's messages and a
    footer of the schema and the blocks (reference
    ipc/file_writer.go:267). Each changed dictionary is written again in
    full."""

    def __init__(self, sink: BinaryIO, schema: dt.Schema,
                 compression: Optional[str] = None,
                 endianness: str = "little",
                 compression_concurrency: int = 0):
        super().__init__(sink, schema, compression, endianness,
                         compression_concurrency)
        self._blocks: List[tuple] = []
        self._dict_blocks: List[tuple] = []
        self._put(MAGIC + b"\0\0")

    def write(self, batch: HostBatch) -> None:
        """Write a HostBatch (a RecordBatch, or a Table's combined
        chunks)."""
        batch = host_batch(batch)
        if self._closed:
            raise ArrowInvalid("writer closed")
        if not self._wrote_schema:
            self._write_schema()
        self._dict_blocks.extend(self._write_dictionaries(batch))
        self._blocks.append(self._batch(
            batch.columns, [f.type for f in self.schema.fields],
            batch.num_rows))

    def close(self) -> None:
        if self._closed:
            return
        self._end()
        fb = Builder(1024)
        schema_off = md.write_schema(fb, self.schema, self.mapper.field_to_id,
                                     int(self._big))

        def blocks_vec(blocks):
            fb.start_vector(24, len(blocks), 8)
            for off, mlen, blen in reversed(blocks):
                fb.prep(8, 24)
                fb.prepend("<q", blen)
                fb.pad(4)
                fb.prepend("<i", mlen)
                fb.prepend("<q", off)
            return fb.end_vector()

        rb_vec = blocks_vec(self._blocks)
        dict_vec = blocks_vec(self._dict_blocks)
        fb.start_object(5)
        fb.add(0, "<h", md.METADATA_V5, 0)
        fb.add_offset(1, schema_off)
        fb.add_offset(2, dict_vec)
        fb.add_offset(3, rb_vec)
        footer = fb.finish(fb.end_object())
        self._put(footer)
        self._put(struct.pack("<i", len(footer)))
        self._put(MAGIC)
        self._closed = True


class FileReader(_Reader):
    """Random-access file reader (reference ipc/file_reader.go:248):
    bytes, a binary file object or a path; with `use_mmap` a path is
    mapped and the columns are views of the map (file_reader.go:228)."""

    def __init__(self, source: Union[BinaryIO, bytes, str],
                 use_mmap: bool = False, decompress_concurrency: int = 0):
        self.decompress_concurrency = decompress_concurrency
        self._file = None
        if isinstance(source, str):
            self._file = open(source, "rb")
            if use_mmap:
                source = mmap.mmap(self._file.fileno(), 0,
                                   access=mmap.ACCESS_READ)
            else:
                source = self._file
        self.src = _Bytes(source)
        size = self.src.size
        if size < 20:
            raise ArrowInvalid("file too small for arrow file format")
        if bytes(self.src.read(0, 6)) != MAGIC:
            raise ArrowInvalid("bad arrow file magic")
        if bytes(self.src.read(size - 6, 6)) != MAGIC:
            raise ArrowInvalid("bad arrow file trailing magic")
        (flen,) = struct.unpack("<i", bytes(self.src.read(size - 10, 4)))
        if not 0 < flen <= size - 18:
            raise ArrowInvalid(f"footer length {flen} in a {size}-byte file")
        r = FbReader.root(bytes(self.src.read(size - 10 - flen, flen)))
        sr = r.table(1)
        if sr is None:
            raise ArrowInvalid("file footer without its schema")
        self._set_schema(sr)
        self._blocks = [self._block(r, 3, i) for i in range(r.vector_len(3))]
        self._dict_blocks = [self._block(r, 2, i)
                             for i in range(r.vector_len(2))]
        self._dicts_loaded = False

    @staticmethod
    def _block(r: FbReader, slot: int, i: int) -> tuple:
        pos = r.vector_struct_pos(slot, i, 24)
        return r.get("<q", pos), r.get("<i", pos + 8), r.get("<q", pos + 16)

    @property
    def num_record_batches(self) -> int:
        return len(self._blocks)

    def _read_at(self, off: int, mlen: int, blen: int):
        raw = self.src.read(off, mlen)
        if mlen < 8:
            raise ArrowInvalid(f"message block of {mlen} bytes")
        (w,) = struct.unpack_from("<I", raw, 0)
        skip = 8 if w == core.CONTINUATION else 4
        (size,) = struct.unpack_from("<i", raw, skip - 4)
        if not 0 < size <= mlen - skip:
            raise ArrowInvalid(f"message of {size} bytes in a {mlen}-byte "
                               f"block")
        return FbReader.root(bytes(raw[skip: skip + size])), \
            self.src.read(off + mlen, blen)

    def _ensure_dictionaries(self) -> None:
        if not self._dicts_loaded:
            for block in self._dict_blocks:
                r, body = self._read_at(*block)
                if r.u8(1) != md.MSG_DICTIONARY_BATCH:
                    raise ArrowInvalid("dictionary block holds another "
                                       "message")
                self._load_dictionary(r, body)
            self._dicts_loaded = True

    def get_batch(self, i: int) -> HostBatch:
        self._ensure_dictionaries()
        r, body = self._read_at(*self._blocks[i])
        if r.u8(1) != md.MSG_RECORD_BATCH:
            raise ArrowInvalid("record batch block holds another message")
        return self._load_batch(r, body)

    def __iter__(self):
        for i in range(self.num_record_batches):
            yield self.get_batch(i)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def new_stream(sink, schema: dt.Schema, compression: Optional[str] = None,
               **options) -> StreamWriter:
    return StreamWriter(sink, schema, compression, **options)


def open_stream(source, decompress_concurrency: int = 0) -> StreamReader:
    return StreamReader(source, decompress_concurrency)


def new_file(sink, schema: dt.Schema, compression: Optional[str] = None,
             **options) -> FileWriter:
    return FileWriter(sink, schema, compression, **options)


def open_file(source, use_mmap: bool = False,
              decompress_concurrency: int = 0) -> FileReader:
    return FileReader(source, use_mmap=use_mmap,
                      decompress_concurrency=decompress_concurrency)


def dt_chunked_empty(t: dt.DataType):
    """An empty ChunkedArray of type t (a column of a Table of no batch)."""
    from ..array.record import ChunkedArray
    return ChunkedArray([], t)
