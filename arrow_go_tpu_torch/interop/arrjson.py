"""The Arrow integration-test JSON format (reference
arrow/internal/arrjson/arrjson.go, the cross-implementation golden data
that archery drives): {"schema": ..., "dictionaries": [...],
"batches": [...]}.

Port of arrow_go_tpu/interop/arrjson.py over the port's HostBatches:
`write_arrjson` takes HostBatches and gives the JAX writer's text for
the same rows, `read_arrjson` gives HostBatches. A column is written
under its schema field's type, as the IPC writer lays it out
(ipc/core.py): a string or binary column (dictionary-coded in the port)
as offsets and rows gathered by `_row_bytes`, a view column as the
views and the one variadic buffer of `_views`, a list view laid out in
order (`_list_view_compacted`), a run_end_encoded slice with its runs
cut to it; every column from row 0, as the JAX writer compacts a slice.
64-bit integers are decimal strings (uint64 its unsigned value),
decimals their unscaled integers as strings, unions carry TYPE_ID (and
a dense union's OFFSET) and no validity. A dictionary field's values go
to the file-level "dictionaries" section, ids in schema pre-order, from
the first batch. Read back, a string, binary or view column becomes the
port's coded column (`coded_column`), a fixed_size_binary one codes over
its distinct rows, a dictionary field its indices with the port's
dictionary values.
"""
from __future__ import annotations

import json as _json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..device.block import (HostArray, HostBatch, ListViewArray,
                            RunEndEncodedArray, UnionArray,
                            dictionary_as_array, dictionary_from_array,
                            nested_array, null_array)
from ..ipc.core import (_list_view_compacted, _offsets, _ree_rebased,
                        _row_bytes, _view_rows, _views, coded_column)
from ..ops.decimal import from_ints
from ..ops.decode import fixed_size_codes

_UNITS = {0: "SECOND", 1: "MILLISECOND", 2: "MICROSECOND", 3: "NANOSECOND"}
_UNIT_OF = {"SECOND": "s", "MILLISECOND": "ms", "MICROSECOND": "us",
            "NANOSECOND": "ns"}


# -- type <-> json ----------------------------------------------------------

def _type_to_json(t: dt.DataType) -> Dict[str, Any]:
    tid = t.id
    if tid == dt.TypeId.NULL:
        return {"name": "null"}
    if tid == dt.TypeId.BOOL:
        return {"name": "bool"}
    if t.is_integer:
        return {"name": "int", "bitWidth": t.bit_width,
                "isSigned": t.is_signed_integer}
    if t.is_floating:
        prec = {16: "HALF", 32: "SINGLE", 64: "DOUBLE"}[t.bit_width]
        return {"name": "floatingpoint", "precision": prec}
    simple = {dt.TypeId.STRING: "utf8", dt.TypeId.BINARY: "binary",
              dt.TypeId.LARGE_STRING: "largeutf8",
              dt.TypeId.LARGE_BINARY: "largebinary",
              dt.TypeId.LIST: "list", dt.TypeId.LARGE_LIST: "largelist",
              dt.TypeId.STRUCT: "struct", dt.TypeId.STRING_VIEW: "utf8view",
              dt.TypeId.BINARY_VIEW: "binaryview",
              dt.TypeId.LIST_VIEW: "listview",
              dt.TypeId.LARGE_LIST_VIEW: "largelistview",
              dt.TypeId.RUN_END_ENCODED: "runendencoded"}
    if tid in simple:
        return {"name": simple[tid]}
    if t.is_decimal:
        return {"name": "decimal", "precision": t.precision,
                "scale": t.scale, "bitWidth": t.bit_width}
    if tid == dt.TypeId.FIXED_SIZE_BINARY:
        return {"name": "fixedsizebinary", "byteWidth": t.byte_width}
    if tid == dt.TypeId.DATE32:
        return {"name": "date", "unit": "DAY"}
    if tid == dt.TypeId.DATE64:
        return {"name": "date", "unit": "MILLISECOND"}
    if tid in (dt.TypeId.TIME32, dt.TypeId.TIME64):
        return {"name": "time", "unit": _UNITS[int(t.unit)],
                "bitWidth": t.bit_width}
    if tid == dt.TypeId.TIMESTAMP:
        out = {"name": "timestamp", "unit": _UNITS[int(t.unit)]}
        if t.tz:
            out["timezone"] = t.tz
        return out
    if tid == dt.TypeId.DURATION:
        return {"name": "duration", "unit": _UNITS[int(t.unit)]}
    if tid == dt.TypeId.FIXED_SIZE_LIST:
        return {"name": "fixedsizelist", "listSize": t.list_size}
    if tid == dt.TypeId.MAP:
        return {"name": "map", "keysSorted": t.keys_sorted}
    if tid == dt.TypeId.INTERVAL_MONTHS:
        return {"name": "interval", "unit": "YEAR_MONTH"}
    if tid == dt.TypeId.INTERVAL_DAY_TIME:
        return {"name": "interval", "unit": "DAY_TIME"}
    if tid == dt.TypeId.INTERVAL_MONTH_DAY_NANO:
        return {"name": "interval", "unit": "MONTH_DAY_NANO"}
    if tid in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION):
        mode = "SPARSE" if tid == dt.TypeId.SPARSE_UNION else "DENSE"
        return {"name": "union", "mode": mode,
                "typeIds": list(t.type_codes)}
    raise ArrowNotImplemented(f"arrjson type {t}")


def _type_from_json(j: Dict[str, Any], children: List[dt.Field]
                    ) -> dt.DataType:
    n = j["name"]
    if n == "null":
        return dt.null
    if n == "bool":
        return dt.bool_
    if n == "int":
        key = (j["bitWidth"], j.get("isSigned", False))
        return {(8, True): dt.int8, (16, True): dt.int16,
                (32, True): dt.int32, (64, True): dt.int64,
                (8, False): dt.uint8, (16, False): dt.uint16,
                (32, False): dt.uint32, (64, False): dt.uint64}[key]
    if n == "floatingpoint":
        return {"HALF": dt.float16, "SINGLE": dt.float32,
                "DOUBLE": dt.float64}[j["precision"]]
    simple = {"utf8": dt.string, "binary": dt.binary,
              "largeutf8": dt.large_string, "largebinary": dt.large_binary,
              "utf8view": dt.string_view, "binaryview": dt.binary_view}
    if n in simple:
        return simple[n]
    if n == "decimal":
        ctor = {32: dt.decimal32, 64: dt.decimal64, 128: dt.decimal128,
                256: dt.decimal256}[j.get("bitWidth", 128)]
        return ctor(j["precision"], j["scale"])
    if n == "fixedsizebinary":
        return dt.fixed_size_binary(j["byteWidth"])
    if n == "date":
        return dt.date32 if j["unit"] == "DAY" else dt.date64
    if n == "time":
        unit = _UNIT_OF[j["unit"]]
        return dt.time32(unit) if j["bitWidth"] == 32 else dt.time64(unit)
    if n == "timestamp":
        return dt.timestamp(_UNIT_OF[j["unit"]], j.get("timezone"))
    if n == "duration":
        return dt.duration(_UNIT_OF[j["unit"]])
    if n == "list":
        return dt.list_(children[0])
    if n == "largelist":
        return dt.large_list(children[0])
    if n == "fixedsizelist":
        return dt.fixed_size_list(children[0], j["listSize"])
    if n == "struct":
        return dt.struct(children)
    if n == "map":
        entries = children[0].type
        return dt.map_(entries.field(0).type, entries.field(1).type,
                       j.get("keysSorted", False))
    if n == "interval":
        return {"YEAR_MONTH": dt.month_interval,
                "DAY_TIME": dt.day_time_interval,
                "MONTH_DAY_NANO": dt.month_day_nano_interval}[j["unit"]]
    if n == "union":
        ctor = dt.sparse_union if j["mode"] == "SPARSE" else dt.dense_union
        return ctor(children, j.get("typeIds"))
    if n == "listview":
        return dt.ListViewType(children[0])
    if n == "largelistview":
        return dt.LargeListViewType(children[0])
    if n == "runendencoded":
        return dt.run_end_encoded(children[0].type, children[1].type)
    raise ArrowNotImplemented(f"arrjson type {n!r}")


class _DictMemo:
    """Dictionary ids (the reference's dictutils Mapper/Memo,
    arrjson.go:706-716,781): assigned in schema pre-order on write, taken
    from the file on read."""

    def __init__(self):
        self.value_fields: Dict[int, dt.Field] = {}   # id -> value field
        self.value_jsons: Dict[int, Dict] = {}        # id -> field json
        self._next = 0

    def new_id(self) -> int:
        i = self._next
        self._next += 1
        return i


def _field_to_json(f: dt.Field, memo: Optional[_DictMemo] = None
                   ) -> Dict[str, Any]:
    t = f.type
    if t.id == dt.TypeId.DICTIONARY:
        vt = t.value_type
        out = {"name": f.name, "type": _type_to_json(vt),
               "nullable": f.nullable}
        if memo is not None:
            # the id is taken before descending: _collect_dictionaries
            # walks in the same pre-order
            did = memo.new_id()
            memo.value_fields[did] = dt.Field(f.name, vt, f.nullable)
            out["dictionary"] = {"id": did,
                                 "indexType": _type_to_json(t.index_type),
                                 "isOrdered": bool(t.ordered)}
        out["children"] = [_field_to_json(c, memo) for c in vt.fields()]
        return out
    return {"name": f.name, "type": _type_to_json(t),
            "nullable": f.nullable,
            "children": [_field_to_json(c, memo) for c in t.fields()]}


def _field_from_json(j: Dict[str, Any],
                     memo: Optional[_DictMemo] = None) -> dt.Field:
    children = [_field_from_json(c, memo) for c in j.get("children", [])]
    t = _type_from_json(j["type"], children)
    dj = j.get("dictionary")
    if dj is not None:
        idx_t = _type_from_json(dj["indexType"], [])
        if memo is not None:
            memo.value_fields[dj["id"]] = dt.Field(j["name"], t)
            memo.value_jsons[dj["id"]] = j
        t = dt.dictionary(idx_t, t, dj.get("isOrdered", False))
    return dt.Field(j["name"], t, j.get("nullable", True))


# -- column <-> json --------------------------------------------------------

def _split_rows(ends: np.ndarray, data: np.ndarray) -> List[bytes]:
    raw = data.tobytes()
    bounds = [0] + ends.tolist()
    return [raw[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def _view_json(view: np.ndarray, is_bin: bool) -> Dict[str, Any]:
    ln = int(view[:4].view("<i4")[0])
    if ln <= 12:
        b = view[4:4 + ln].tobytes()
        return {"SIZE": ln,
                "INLINED": b.hex().upper() if is_bin else b.decode("utf-8")}
    return {"SIZE": ln, "PREFIX_HEX": view[4:8].tobytes().hex().upper(),
            "BUFFER_INDEX": int(view[8:12].view("<i4")[0]),
            "OFFSET": int(view[12:16].view("<i4")[0])}


def _column_to_json(name: str, arr: HostArray, t: dt.DataType
                    ) -> Dict[str, Any]:
    """The column json of `arr` under field type `t`."""
    tid = t.id
    n = len(arr)
    out: Dict[str, Any] = {"name": name, "count": n}
    if tid == dt.TypeId.NULL:
        return out
    if tid in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION):
        # unions carry no validity of their own (arrjson.go:834 TYPE_ID)
        out["TYPE_ID"] = arr.type_ids.tolist()
        if tid == dt.TypeId.DENSE_UNION:
            out["OFFSET"] = arr.value_offsets.tolist()
        out["children"] = [_column_to_json(f.name, c, f.type)
                           for f, c in zip(t.fields(), arr.children)]
        return out
    if tid == dt.TypeId.RUN_END_ENCODED:
        out["children"] = [_column_to_json(f.name, c, f.type) for f, c in
                           zip(t.fields(), _ree_rebased(arr))]
        return out
    out["VALIDITY"] = arr.validity_bools().astype(np.int64).tolist()
    if tid == dt.TypeId.DICTIONARY:
        # the indices only; the values go to the file-level
        # "dictionaries" section (arrjson.go:776 Dictionary)
        iv = np.asarray(arr.values).tolist()
        out["DATA"] = [str(v) for v in iv] \
            if t.index_type.bit_width == 64 else iv
        return out
    if tid == dt.TypeId.INTERVAL_DAY_TIME:
        out["DATA"] = [{"days": int(d), "milliseconds": int(m)}
                       for d, m in arr.values.tolist()]
        return out
    if tid == dt.TypeId.INTERVAL_MONTH_DAY_NANO:
        out["DATA"] = [{"months": int(m), "days": int(d),
                        "nanoseconds": int(ns)}
                       for m, d, ns in arr.values.tolist()]
        return out
    if tid in (dt.TypeId.STRING_VIEW, dt.TypeId.BINARY_VIEW):
        views, var = _views(*_row_bytes(arr))
        is_bin = tid == dt.TypeId.BINARY_VIEW
        out["VIEWS"] = [_view_json(v, is_bin) for v in views]
        out["VARIADIC_DATA_BUFFERS"] = [var.tobytes().hex().upper()] \
            if len(var) else []
        return out
    if tid in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        arr = _list_view_compacted(arr)
        out["OFFSET"] = arr.offsets.tolist()
        out["SIZE"] = arr.sizes.tolist()
        out["children"] = [_column_to_json(t.value_field.name,
                                           arr.children[0], t.value_type)]
        return out
    if tid == dt.TypeId.BOOL:
        out["DATA"] = np.asarray(arr.values, np.int64).tolist()
        return out
    if t.is_integer or t.is_temporal and t.np_dtype is not None \
            and t.np_dtype.names is None:
        # unsigned bits may sit in signed storage: read them unsigned
        vals = np.asarray(arr.values).view(t.np_dtype).tolist()
        out["DATA"] = [str(v) for v in vals] if t.bit_width == 64 else vals
        return out
    if t.is_floating:
        out["DATA"] = np.asarray(arr.values, np.float64).tolist()
        return out
    if t.is_decimal:
        out["DATA"] = [str(u) for u in arr.unscaled()]
        return out
    if tid in (dt.TypeId.STRING, dt.TypeId.LARGE_STRING,
               dt.TypeId.BINARY, dt.TypeId.LARGE_BINARY):
        ends, data = _row_bytes(arr)
        out["OFFSET"] = _offsets(ends, t.offset_dtype).tolist()
        rows = _split_rows(ends, data)
        out["DATA"] = [r.decode("utf-8") for r in rows] if t.is_utf8 \
            else [r.hex().upper() for r in rows]
        return out
    if tid == dt.TypeId.FIXED_SIZE_BINARY:
        zero = bytes(t.byte_width)
        table = list(arr.dict_values) or [zero]
        codes = np.asarray(arr.values, np.int64).tolist()
        out["DATA"] = [(bytes(table[c]) if ok else zero).hex().upper()
                       for c, ok in zip(codes,
                                        arr.validity_bools().tolist())]
        return out
    if tid in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST, dt.TypeId.MAP):
        off = np.asarray(arr.offsets, np.int64)
        lo = int(off[0]) if n else 0
        child = arr.children[0].slice(lo, int(off[-1]) - lo) if n else \
            arr.children[0].slice(0, 0)
        out["OFFSET"] = (off - lo).tolist()
        f = t.fields()[0]
        out["children"] = [_column_to_json(f.name, child, f.type)]
        return out
    if tid == dt.TypeId.FIXED_SIZE_LIST:
        f = t.value_field
        out["children"] = [_column_to_json(
            f.name, arr.children[0].slice(0, n * t.list_size), f.type)]
        return out
    if tid == dt.TypeId.STRUCT:
        out["children"] = [_column_to_json(f.name, c, f.type)
                           for f, c in zip(t.fields(), arr.children)]
        return out
    raise ArrowNotImplemented(f"arrjson column {t}")


def _column_from_json(j: Dict[str, Any], f: dt.Field,
                      fj: Optional[Dict[str, Any]] = None,
                      dicts: Optional[Dict[int, object]] = None
                      ) -> HostArray:
    """`fj`: the schema-field json of this column (its dictionary id and
    its children's jsons); `dicts`: id -> the port's dictionary values."""
    t = f.type
    n = j["count"]
    tid = t.id
    cjs = (fj or {}).get("children", [])

    def kids():
        return [_column_from_json(cj, cf, cjs[i] if i < len(cjs) else None,
                                  dicts)
                for i, (cj, cf) in enumerate(zip(j["children"],
                                                 t.fields()))]

    if tid == dt.TypeId.NULL:
        return null_array(n)
    if tid in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION):
        offsets = np.array(j["OFFSET"], np.int32) \
            if tid == dt.TypeId.DENSE_UNION else None
        return UnionArray(t, np.array(j["TYPE_ID"], np.int8), kids(),
                          offsets)
    if tid == dt.TypeId.RUN_END_ENCODED:
        ends, values = kids()
        return RunEndEncodedArray(ends, values, n)
    valid = np.array(j.get("VALIDITY", [1] * n), np.bool_)
    mask = None if valid.all() else valid
    if tid == dt.TypeId.DICTIONARY:
        did = (fj or {}).get("dictionary", {}).get("id")
        dic = (dicts or {}).get(did)
        if dic is None:
            raise ArrowInvalid(f"arrjson: no dictionary for id={did}")
        return HostArray(np.array([int(v) for v in j["DATA"]],
                                  t.index_type.np_dtype), mask, t, dic)
    if tid == dt.TypeId.BOOL:
        return HostArray(np.array(j["DATA"], np.bool_), mask, t)
    if tid in (dt.TypeId.INTERVAL_DAY_TIME,
               dt.TypeId.INTERVAL_MONTH_DAY_NANO):
        keys = t.np_dtype.names
        return HostArray(np.array([tuple(int(v[k]) for k in keys)
                                   for v in j["DATA"]], t.np_dtype),
                         mask, t)
    if t.np_dtype is not None and (t.is_numeric or t.is_temporal):
        return HostArray(np.array([int(v) if isinstance(v, str) else v
                                   for v in j["DATA"]], t.np_dtype), mask, t)
    if t.is_decimal:
        ints = [int(v) for v in j["DATA"]]
        return HostArray(from_ints(ints, t.limbs) if t.limbs
                         else np.array(ints, t.np_dtype), mask, t)
    if tid in (dt.TypeId.STRING, dt.TypeId.LARGE_STRING,
               dt.TypeId.BINARY, dt.TypeId.LARGE_BINARY):
        off = np.array(j["OFFSET"], np.int64)
        blob = "".join(j["DATA"]).encode("utf-8") if t.is_utf8 else \
            b"".join(bytes.fromhex(v) for v in j["DATA"])
        data = np.frombuffer(blob, np.uint8)
        return coded_column(off[1:] - off[0], data[off[0]:off[-1]], mask, t)
    if tid in (dt.TypeId.STRING_VIEW, dt.TypeId.BINARY_VIEW):
        is_bin = tid == dt.TypeId.BINARY_VIEW
        bufs = [bytes.fromhex(h) for h in j.get("VARIADIC_DATA_BUFFERS", [])]
        raw = bytearray(16 * n)
        for i, v in enumerate(j.get("VIEWS", [])):
            base = 16 * i
            raw[base:base + 4] = int(v["SIZE"]).to_bytes(4, "little",
                                                         signed=True)
            if "INLINED" in v:
                b = bytes.fromhex(v["INLINED"]) if is_bin \
                    else v["INLINED"].encode("utf-8")
                raw[base + 4:base + 4 + len(b)] = b
            else:
                raw[base + 4:base + 8] = bytes.fromhex(v["PREFIX_HEX"])
                raw[base + 8:base + 12] = int(v["BUFFER_INDEX"]).to_bytes(
                    4, "little")
                raw[base + 12:base + 16] = int(v["OFFSET"]).to_bytes(
                    4, "little")
        return coded_column(*_view_rows(np.frombuffer(bytes(raw), np.uint8),
                                        bufs, n), mask, t)
    if tid == dt.TypeId.FIXED_SIZE_BINARY:
        w = t.byte_width
        rows = np.frombuffer(b"".join(bytes.fromhex(v) for v in j["DATA"]),
                             np.uint8).reshape(n, w).copy()
        codes, dictionary = fixed_size_codes(
            torch.from_numpy(rows),
            None if mask is None else torch.from_numpy(mask))
        return HostArray(codes.numpy(), mask, t, dictionary)
    if tid in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST, dt.TypeId.MAP):
        return nested_array(t, n, mask, kids(),
                            np.array(j["OFFSET"], t.offset_dtype))
    if tid in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        return ListViewArray(t, mask, np.array(j["OFFSET"], t.offset_dtype),
                             np.array(j["SIZE"], t.offset_dtype), kids()[0])
    if tid in (dt.TypeId.STRUCT, dt.TypeId.FIXED_SIZE_LIST):
        return nested_array(t, n, mask, kids())
    raise ArrowNotImplemented(f"arrjson column {t}")


# -- file level -------------------------------------------------------------

def _collect_dictionaries(t: dt.DataType, arr: HostArray, memo: _DictMemo,
                          out: Dict[int, object]) -> None:
    """Pre-order walk matching _field_to_json's ids: each dictionary id
    paired with the values of this batch's column."""
    if t.id == dt.TypeId.DICTIONARY:
        did = memo.new_id()
        if did not in out and arr.dict_values is not None:
            out[did] = arr.dict_values
        return
    for cf, ca in zip(t.fields(), arr.children):
        _collect_dictionaries(cf.type, ca, memo, out)


def write_arrjson(batches: List[HostBatch], sink=None) -> str:
    """The integration JSON text of `batches` (the JAX writer's, for the
    same rows: `json.dumps(doc, indent=2)`); written to `sink` too, a
    path or a text file object, when given."""
    schema = batches[0].schema if batches else dt.Schema([])
    memo = _DictMemo()
    fields_json = [_field_to_json(f, memo) for f in schema.fields]
    doc: Dict[str, Any] = {
        "schema": {"fields": fields_json},
        "batches": [{"count": hb.num_rows,
                     "columns": [_column_to_json(f.name, c, f.type)
                                 for f, c in zip(schema.fields,
                                                 hb.columns)]}
                    for hb in batches],
    }
    if memo.value_fields and batches:
        values: Dict[int, object] = {}
        walk = _DictMemo()          # a fresh counter, the same pre-order
        for f, c in zip(schema.fields, batches[0].columns):
            _collect_dictionaries(f.type, c, walk, values)
        doc["dictionaries"] = []
        for did in sorted(values):
            vf = memo.value_fields[did]
            col = dictionary_as_array(values[did], vf.type)
            doc["dictionaries"].append(
                {"id": did, "data": {"count": len(col), "columns": [
                    _column_to_json(vf.name, col, vf.type)]}})
    text = _json.dumps(doc, indent=2)
    if sink is not None:
        if isinstance(sink, str):
            with open(sink, "w") as fobj:
                fobj.write(text)
        else:
            sink.write(text)
    return text


def read_arrjson(source) -> List[HostBatch]:
    """HostBatches of integration JSON: text, bytes, a path or a file
    object."""
    if isinstance(source, str) and source.lstrip().startswith("{"):
        doc = _json.loads(source)
    elif isinstance(source, (bytes, bytearray)):
        doc = _json.loads(source)
    elif isinstance(source, str):
        with open(source) as fobj:
            doc = _json.load(fobj)
    else:
        doc = _json.load(source)
    memo = _DictMemo()
    fjs = doc["schema"]["fields"]
    fields = [_field_from_json(fj, memo) for fj in fjs]
    schema = dt.Schema(fields)
    # a dictionary's values may be of another dictionary's type: parse
    # until every id resolves (arrjson.go:781)
    dicts: Dict[int, object] = {}
    todo = list(doc.get("dictionaries", []))
    for _ in range(len(todo) + 1):
        rest = []
        for dj in todo:
            did = dj["id"]
            vf = memo.value_fields.get(did)
            if vf is None:
                raise ArrowInvalid(f"arrjson: unknown dictionary id {did}")
            try:
                col = _column_from_json(dj["data"]["columns"][0], vf,
                                        memo.value_jsons.get(did), dicts)
            except ArrowInvalid:
                rest.append(dj)
                continue
            dicts[did] = dictionary_from_array(col, vf.type)
        if not rest:
            break
        todo = rest
    return [HostBatch(schema, [_column_from_json(cj, f, fj, dicts)
                               for f, fj, cj in zip(fields, fjs,
                                                    bj["columns"])],
                      bj["count"])
            for bj in doc.get("batches", [])]
