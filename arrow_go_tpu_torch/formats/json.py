"""Line-delimited JSON reader and writer (reference
arrow/array/json_reader.go and the arrjson integration format's
record-level semantics).

Port of arrow_go_tpu/formats/json.py. Each non-empty line is one JSON
object; without a schema every key becomes a column, in order of first
appearance, its type inferred from its values as the JAX package's
builders infer it (compute/scalars.infer_type: the first non-null value
decides; objects become structs, arrays lists). The columns are built
by device/block.from_pylist. `read_json` gives one HostBatch.
"""
from __future__ import annotations

import io
import json as _json
from dataclasses import dataclass
from typing import Optional, Sequence, Union

from .. import dtypes as dt
from ..array.record import host_batch
from ..compute.scalars import infer_type
from ..device.block import HostBatch, from_pylist


@dataclass
class ReadOptions:
    schema: Optional[dt.Schema] = None


def read_json(source: Union[str, bytes, io.IOBase],
              options: Optional[ReadOptions] = None) -> HostBatch:
    """Newline-delimited JSON objects (a path, bytes or a file object)
    as one HostBatch; a missing key or a JSON null is a null."""
    opts = options or ReadOptions()
    if isinstance(source, (bytes, bytearray, memoryview)):
        text = bytes(source).decode("utf-8")
    elif isinstance(source, str):
        with open(source) as f:
            text = f.read()
    else:
        raw = source.read()
        text = raw.decode("utf-8") if isinstance(raw, bytes) else raw

    records = [_json.loads(line) for line in map(str.strip,
                                                 text.splitlines()) if line]
    if opts.schema is not None:
        schema = opts.schema
    else:
        keys = {}
        for r in records:
            for k in r:
                keys.setdefault(k, None)
        schema = dt.Schema([dt.Field(k, infer_type([r.get(k)
                                                    for r in records]))
                            for k in keys])
    cols = [from_pylist([r.get(f.name) for r in records], f.type)
            for f in schema.fields]
    return HostBatch(schema, cols, len(records))


def write_json(data: Union[HostBatch, Sequence[HostBatch]], sink) -> None:
    """One JSON object a row (`json.dumps` of its Python values: bytes
    decoded as UTF-8, Decimals as strings, tuples as lists), each on its
    own line, to a path, a text stream or a binary stream."""
    data = host_batch(data)
    batches = [data] if isinstance(data, HostBatch) else list(data)
    names = batches[0].schema.names
    out = io.StringIO()
    for hb in batches:
        cols = [c.to_pylist() for c in hb.columns]
        for row in zip(*cols):
            out.write(_json.dumps({k: _jsonable(v)
                                   for k, v in zip(names, row)}) + "\n")
    text = out.getvalue()
    if isinstance(sink, str):
        with open(sink, "w") as f:
            f.write(text)
    elif isinstance(sink, io.TextIOBase):
        sink.write(text)
    else:
        sink.write(text.encode("utf-8"))


def _jsonable(v):
    import decimal
    import numpy as np
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, list):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return [_jsonable(x) for x in v]
    return v
