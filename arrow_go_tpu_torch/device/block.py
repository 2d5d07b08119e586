"""Device block format of the port: a column in device memory.

As in the JAX package (arrow_go_tpu/device/block.py), a column on the
device is a fixed-width, bucket-padded tensor plus packed validity
words, with the logical row count carried separately. The padding rule
(`pad_length`) is the JAX package's, so both packages hold the same
padded shapes and the parity tests compare like with like.

Validity words are int32 tensors that carry the u32 bit patterns of the
JAX package's words (LSB-first: word w bit b <-> row w*32+b); torch's
uint32 supports too few operations, so every shift of a word is masked
afterwards (ops/bitmap.py).

Values are stored in their type's `torch_dtype`: uint16, uint32 and
uint64 as the raw bits in int16, int32 and int64 (dtypes.py). Every
conversion between numpy and the device here is a bit-for-bit view,
so a HostArray holds numpy's unsigned dtype and the device its signed
storage of the same bits.

Strings and binary values are dictionary-encoded at ingest, as in the
JAX package: int32 codes live on the device, the values stay in a host
dictionary (a numpy object array of str or bytes) that rides the column.
A fixed_size_binary column is coded the same way, over its distinct
values in byte order (the JAX package's np.unique of the rows;
ops/decode.fixed_size_codes). A host column keeps the same storage under
its own type (a StringArray is typed string), goes to the device as a
dictionary<int32, T> column with its codes as they are, and comes back
from `from_device` as a DictionaryArray, as in the JAX package.

A decimal128 or decimal256 column holds a (padded, 2) or (padded, 4)
int64 matrix of little-endian limbs (dtypes.py); every other column a
1-D tensor. Its host values are the same (n, k) matrix, and
`HostArray.to_pylist` gives `decimal.Decimal` values for every decimal
type, as the JAX package's DecimalArray does.

Results that leave the device (the group-sized output of group_by)
come back as a numpy-backed HostBatch.

Nested columns (list, large_list, fixed_size_list, struct, map) are
HostArrays of child HostArrays; in a DeviceBatch one rides as a
HostColumn, as does every column whose type the block format does not
carry (`DataType.on_device`). A list of a flat type also has a
device form, DeviceListColumn (offsets plus a flat child DeviceColumn),
whose take (`list_take_device`) expands the child runs with K2's
hi-only fills on the card. A run_end_encoded column is a HostArray too
(RunEndEncodedArray, children run_ends and values), and so are a list
view (ListViewArray: offsets and sizes into one child), a union
(UnionArray: int8 type codes, a dense one's int32 offsets, a child a
field) and an extension column (ExtensionArray: its storage HostArray).

The other types of the JAX package's set: a null column holds a length
only (on the device int8 zeros with all-false validity words, as the
JAX package's to_device gives it); month_interval is int32 values (on
the device too); day_time_interval and month_day_nano_interval hold
numpy structured values and stay on the host; large_string,
large_binary, string_view and binary_view are dictionary-coded as
string and binary are, on the host and on the device.
"""
from __future__ import annotations

import datetime
import decimal as pydec
import itertools
import operator
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import dtypes as dt
from .. import torchenv
from ..ops.convert import host_view, storage_view
from ..ops.decimal import to_ints
from ..utils.metrics import metrics

LANE = 128
WORD_BITS = 32


def pad_length(n: int) -> int:
    """Bucketed padding: next multiple of pow2ceil(n)/8, min 128."""
    n = max(int(n), 1)
    if n <= LANE:
        return LANE
    p = 1 << (n - 1).bit_length()          # pow2 ceiling
    step = max(p // 8, LANE)
    return (n + step - 1) // step * step


def _pack_words(mask: np.ndarray, padded: int) -> np.ndarray:
    """bool mask -> packed uint32 validity words (LSB-first), padding bits 0."""
    full = np.zeros(padded, dtype=np.bool_)
    full[: len(mask)] = mask
    bits = np.packbits(full, bitorder="little")  # uint8 LSB-first
    return bits.view(np.uint32) if bits.nbytes % 4 == 0 else np.pad(
        bits, (0, 4 - bits.nbytes % 4)).view(np.uint32)


def _unpack_words(words: np.ndarray, n: int) -> np.ndarray:
    bits = np.ascontiguousarray(words).view(np.uint8)
    return np.unpackbits(bits, bitorder="little")[:n].astype(np.bool_)


def _value_type(t: dt.DataType) -> dt.DataType:
    return t.value_type if t.id == dt.TypeId.DICTIONARY else t


def row_mask(padded: int, length, device) -> torch.Tensor:
    """mask[i] = i < length (length a Python int or a 0-d tensor)."""
    return torch.arange(padded, device=device) < length


def valid_rows(validity: Optional[torch.Tensor], padded: int, length,
               device) -> torch.Tensor:
    """mask[i] = i < length and validity bit i is set (or no words)."""
    m = row_mask(padded, length, device)
    if validity is not None:
        from ..ops import bitmap
        m = m & bitmap.expand_words(validity, padded)
    return m


@dataclass(init=False)
class DeviceColumn:
    """One column resident in device memory.

    values:   tensor, shape (padded,), or (padded, k) limbs for
              decimal128 / decimal256
    validity: int32 words carrying u32 bit patterns, shape (padded/32,),
              or None (all valid)
    length:   logical row count
    type:     the logical type (dictionary(int32, string) for strings)
    dict_values: the host values the codes of a dictionary column index
              (numpy object array), else None; `dictionary` gives them
              as an Array of the value type, as the JAX DeviceColumn's
    """

    values: torch.Tensor
    validity: Optional[torch.Tensor]
    length: int
    type: dt.DataType
    dict_values: Optional[np.ndarray] = None
    _mask_cache: Optional[torch.Tensor] = None

    def __init__(self, values: torch.Tensor,
                 validity: Optional[torch.Tensor], length: int,
                 type: dt.DataType, dictionary=None,
                 _mask_cache: Optional[torch.Tensor] = None):
        """`dictionary` as the JAX DeviceColumn takes it, an Array of the
        value type, or as the port keeps it, numpy values."""
        if isinstance(dictionary, HostArray):
            dictionary = dictionary_from_array(dictionary,
                                               _value_type(type))
        self.values, self.validity = values, validity
        self.length, self.type = length, type
        self.dict_values = dictionary
        self._mask_cache = _mask_cache
        if self.values.shape[0] % WORD_BITS:
            raise ValueError(
                f"padded length {self.values.shape[0]} not word-aligned")
        if self.validity is not None and (
                self.validity.shape[0] * WORD_BITS != self.values.shape[0]):
            raise ValueError(
                f"validity words {self.validity.shape[0]} != padded/32")

    @property
    def padded(self) -> int:
        return self.values.shape[0]

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def dictionary(self) -> Optional["HostArray"]:
        """The values the codes index as an Array of the value type (the
        JAX DeviceColumn's), or None."""
        if self.dict_values is None:
            return None
        return dictionary_as_array(self.dict_values, _value_type(self.type))

    @property
    def null_count(self) -> int:
        """The null rows of [0, length) (a popcount of the words; one
        read of the device)."""
        if self.validity is None:
            return 0
        from ..ops import bitmap
        return self.length - int(bitmap.popcount_words(self.validity))

    def with_values(self, values: torch.Tensor) -> "DeviceColumn":
        return DeviceColumn(values, self.validity, self.length, self.type,
                            self.dict_values)

    def validity_mask(self) -> torch.Tensor:
        """Expanded bool mask over the padded domain (False beyond length),
        cached after the first expansion (columns are never mutated in
        place; transforms build new columns)."""
        if self._mask_cache is None:
            self._mask_cache = valid_rows(self.validity, self.padded,
                                          self.length, self.device)
        return self._mask_cache


@dataclass
class HostColumn:
    """A column that rides a DeviceBatch but stays on the host (the
    JAX package's HostColumn): a nested one, or one of another type the
    device block format does not carry (`DataType.on_device`). Batch
    filter, take and join select it on the host
    (compute/nested_selection.py); a device kernel refuses it."""

    array: "HostArray"

    @property
    def length(self) -> int:
        return len(self.array)

    @property
    def type(self) -> dt.DataType:
        return self.array.type

    @property
    def null_count(self) -> int:
        return self.array.null_count


@dataclass
class DeviceBatch:
    """Schema + device columns: the device-resident RecordBatch. A
    nested column is a HostColumn."""

    schema: dt.Schema
    columns: List[Union[DeviceColumn, HostColumn]]
    length: int

    def column(self, key) -> DeviceColumn:
        if isinstance(key, str):
            i = self.schema.field_index(key)
            if i < 0:
                raise KeyError(f"no column {key!r}")
            key = i
        return self.columns[key]

    @property
    def padded(self) -> int:
        for c in self.columns:
            if isinstance(c, DeviceColumn):
                return c.padded
        return pad_length(self.length)

    @property
    def device_columns(self) -> List[DeviceColumn]:
        return [c for c in self.columns if isinstance(c, DeviceColumn)]


def _words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    w = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(w.copy()).to(device)


def dictionary_values(values, t: dt.DataType) -> np.ndarray:
    """A dictionary's values as a numpy object array of str (string,
    large_string, string_view: from str or UTF-8 bytes) or bytes (the
    binary types)."""
    if t.is_utf8:
        vals = [v.decode() if isinstance(v, (bytes, bytearray, memoryview))
                else str(v) for v in values]
    else:
        vals = [bytes(v) for v in values]
    out = np.empty(len(vals), dtype=object)
    out[:] = vals
    return out


def dictionary_as_array(values, vt: dt.DataType) -> "HostArray":
    """A dictionary's values as an Array of its value type (a string-like
    or fixed_size_binary one coded over the same values)."""
    if vt.codes_on_device:
        return HostArray(np.arange(len(values), dtype=np.int32), None, vt,
                         values)
    return HostArray(np.asarray(values, vt.np_dtype), None, vt)


def dictionary_from_array(arr: "HostArray", vt: dt.DataType):
    """An Array of a dictionary's values as the port keeps them: an
    object array of str / bytes (a string-like or fixed_size_binary value
    type) or the values."""
    if vt.codes_on_device:
        return dictionary_values(arr.dict_values[np.asarray(arr.values)], vt)
    return arr.values


def dictionary_type(values) -> dt.DataType:
    """The type of a column of str or bytes values: by the numpy dtype
    where it names one (bytes "S": binary, "U": string, even with no
    row), else binary for bytes values and string otherwise."""
    kind = getattr(values, "dtype", np.dtype(object)).kind
    if kind in "SU":
        return dt.binary if kind == "S" else dt.string
    return dt.binary if len(values) and isinstance(
        values[0], (bytes, bytearray)) else dt.string


def factorize(values: np.ndarray, mask: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(int32 codes, dictionary) of a string/bytes array, the dictionary
    in first-occurrence order of the valid rows (the JAX package's
    DictionaryBuilder order); null rows take code 0."""
    values = np.asarray(values)
    live = values if mask is None else values[mask]
    if not len(live):
        return np.zeros(len(values), np.int32), values[:0].astype(object)
    if values.dtype == object:
        try:
            return _factorize_objects(values, mask, live)
        except TypeError:               # an unhashable value: sort below
            pass
    uniq, first, inv = np.unique(live, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    code_of = np.empty(len(uniq), np.int32)
    code_of[order] = np.arange(len(uniq), dtype=np.int32)
    codes = np.zeros(len(values), np.int32)
    if mask is None:
        codes[:] = code_of[inv.reshape(-1)]
    else:
        codes[mask] = code_of[inv.reshape(-1)]
    return codes, uniq[order].astype(object)


def _factorize_objects(values: np.ndarray, mask, live: np.ndarray):
    """factorize of an object array by a dict memo (first occurrence
    order, hashing each value once, no sort)."""
    rows = live.tolist()
    uniq = list(dict.fromkeys(rows))
    index = {v: i for i, v in enumerate(uniq)}
    got = np.fromiter(map(index.__getitem__, rows), np.int32, len(rows))
    codes = got if mask is None else np.zeros(len(values), np.int32)
    if mask is not None:
        codes[mask] = got
    out = np.empty(len(uniq), dtype=object)
    out[:] = uniq
    return codes, out


def storage_zeros(t: dt.DataType, P: int) -> np.ndarray:
    """Zeroed host storage of P values of t: (P, k) int64 limbs for a
    decimal128 / decimal256, else P of its numpy dtype."""
    if t.limbs:
        return np.zeros((P, t.limbs), np.int64)
    return np.zeros(P, dtype=t.np_dtype)


def _host_values(vals: np.ndarray, t: dt.DataType) -> np.ndarray:
    """Padded host values of t (limbs as uint64 or int64) as their torch
    storage, checked against t's shape and dtype."""
    if t.limbs:
        ok = vals.ndim == 2 and vals.shape[1] == t.limbs and \
            vals.dtype in (np.uint64, np.int64)
        want = f"(P, {t.limbs}) uint64 limbs"
    else:
        ok = vals.ndim == 1 and vals.dtype == t.np_dtype
        want = f"1-D {t.np_dtype}"
    if not ok:
        raise ValueError(f"expected {want}, got {vals.ndim}-D {vals.dtype}")
    vals = np.ascontiguousarray(vals).copy()
    return vals.view(np.int64) if t.limbs else storage_view(vals, t)


def batch_from_numpy(fields: Sequence[Tuple[str, str]],
                     columns: Sequence[tuple],
                     length: int, device=None) -> DeviceBatch:
    """DeviceBatch from already padded host buffers.

    fields:  (name, type) per column, the type a DataType or its name
             (`dt.type_for_name`), e.g. ("l_okey", "int64").
    columns: (values, validity words or None) per column: the padded
             values ndarray and the uint32 validity words, exactly what
             `np.asarray` gives for a JAX DeviceColumn's `.values` and
             `.validity`, so both packages hold bit-identical inputs. A
             string, binary or fixed_size_binary field takes (int32
             codes, words, dictionary values): a dictionary(int32, ...)
             column. A decimal128 / decimal256 field takes its (P, k)
             limbs.
    """
    dev = torchenv.device(device)
    if len(fields) != len(columns):
        raise ValueError("one (values, validity) pair per field")
    flds, cols = [], []
    padded = None
    for (name, tname), col in zip(fields, columns):
        ft = tname if isinstance(tname, dt.DataType) else \
            dt.type_for_name(tname)
        vals, words = col[0], col[1]
        t, dictionary = ft, None
        if ft.codes_on_device:
            if len(col) != 3:
                raise ValueError(f"column {name!r}: a {ft} column takes "
                                 f"(codes, words, dictionary)")
            t = dt.dictionary(dt.int32, ft)
            dictionary = dictionary_values(col[2], ft)
        vals = np.asarray(vals)
        try:
            host = _host_values(vals, t)
        except ValueError as e:
            raise ValueError(f"column {name!r}: {e}") from None
        if padded is None:
            padded = vals.shape[0]
        if vals.shape[0] != padded or padded < length:
            raise ValueError(f"column {name!r}: padded length "
                             f"{vals.shape[0]} does not fit the batch")
        v = torch.from_numpy(host).to(dev)
        w = None if words is None else _words_to_tensor(words, dev)
        flds.append(dt.Field(name, ft))
        cols.append(DeviceColumn(v, w, int(length), t, dictionary))
    return DeviceBatch(dt.Schema(flds), cols, int(length))


def batch_to_device(data, device=None,
                    pad: Optional[int] = None) -> DeviceBatch:
    """A padded DeviceBatch on `device` (the card unless named) of a
    RecordBatch, a HostBatch or a Table (its chunks combined;
    host_batch_to_device: a column the block format does not carry
    rides as a HostColumn, as in the JAX package), or of a dict of
    null-free numpy columns (all of one length).

    A string column is a numpy str/object array (dictionary-encoded here,
    first-occurrence order) or an (int32 codes, values) pair taken as it
    stands; bytes values make a binary column. A HostArray goes as it
    is: one the device block format does not carry as a HostColumn
    (`DataType.on_device`), a flat one as a DeviceColumn with its
    validity."""
    if not isinstance(data, dict):
        from ..array.record import host_batch
        return host_batch_to_device(host_batch(data), device, pad)
    hosts = {k: v for k, v in data.items() if isinstance(v, HostArray)}
    flat = {k: v for k, v in data.items() if k not in hosts}
    if not hosts:
        return _flat_batch_to_device(data, device, pad)
    n = len(next(iter(hosts.values())))
    P = pad if pad is not None else pad_length(n)
    db = _flat_batch_to_device(flat, device, P) if flat else None
    if db is not None and db.length != n:
        raise ValueError(f"columns of {db.length} and {n} rows")
    dev = torchenv.device(device)
    fields, cols = [], []
    for name in data:
        if name in hosts:
            a = hosts[name]
            if len(a) != n:
                raise ValueError(f"column {name!r} has {len(a)} rows, "
                                 f"not {n}")
            fields.append(dt.Field(name, a.type))
            cols.append(host_array_to_device(a, dev, P) if a.type.on_device
                        else HostColumn(a))
        else:
            i = db.schema.field_index(name)
            fields.append(db.schema.field(i))
            cols.append(db.columns[i])
    return DeviceBatch(dt.Schema(fields), cols, n)


def _flat_batch_to_device(data: Dict[str, object], device,
                          pad: Optional[int]) -> DeviceBatch:
    names = list(data)
    fields, columns = [], []
    n = None
    for name in names:
        v = data[name]
        if isinstance(v, tuple):
            codes, dictionary = np.asarray(v[0], np.int32), v[1]
            st = dictionary_type(dictionary)
        else:
            v = np.asarray(v)
            codes = dictionary = None
            if v.dtype.kind in "USO":
                st = dictionary_type(v)
                codes, dictionary = factorize(v)
        m = len(codes if codes is not None else v)
        n = m if n is None else n
        if m != n:
            raise ValueError(f"column {name!r} has {m} rows, not {n}")
        if codes is None:
            t = dt.from_numpy_dtype(v.dtype)
            host = np.zeros(pad if pad is not None else pad_length(n),
                            dtype=t.np_dtype)
            host[:n] = v
            fields.append((name, t))
            columns.append((host, None))
            continue
        host = np.zeros(pad if pad is not None else pad_length(n), np.int32)
        host[:n] = codes
        fields.append((name, st.name))
        columns.append((host, None, dictionary))
    return batch_from_numpy(fields, columns, n or 0, device)


# ---------------------------------------------------------------------------
# host results
# ---------------------------------------------------------------------------

def decimal_value(unscaled: int, scale: int) -> pydec.Decimal:
    """unscaled * 10**-scale, exact whatever the digits (the JAX
    package's DecimalArray.value)."""
    return pydec.Decimal(unscaled).scaleb(-scale, pydec.Context(prec=80))


# the JAX package's class of each type id (array/arrays.py fills it)
_CLASSES: Dict[dt.TypeId, type] = {}


def _class_for(t: dt.DataType) -> type:
    """The class of a column of type t, by its type id (a string column
    a StringArray, a dictionary column a DictionaryArray)."""
    return _CLASSES.get(t.id, HostArray)


class HostArray:
    """A numpy-backed column: values[:n] plus an optional bool mask
    (True = valid). A coded column (a string-like or fixed_size_binary
    type, or a dictionary type) holds codes in `values` and the values
    they index in `dict_values`, a numpy array (str / bytes objects for
    a string-like value type). A DictionaryArray's `dictionary` is those
    values as an Array of its value type, as in the JAX package.

    A nested column (list, large_list, map, fixed_size_list, struct)
    has no `values`: a list or map holds `offsets` (n + 1, the type's
    offset dtype, absolute into its child, so a slice shares the child)
    and one child HostArray (a map's is struct<key, value>); a
    fixed_size_list one child whose rows [i * k, (i + 1) * k) are row
    i's (present under null rows too); a struct one child of n rows a
    field.

    HostArray is the port's `Array` (array/arrays.py): constructing one
    gives the JAX package's class for its type (NumericArray,
    StringArray, ListArray, ...; `_class_for`), each a subclass with
    the JAX methods, and every port function keeps taking them. A slice
    remembers the array it was cut from (`offset`), so `data`, its
    Arrow layout as an ArrayData, is that array's at the slice's offset
    as in the JAX package; an array made from an ArrayData
    (`make_array`) keeps it."""

    _data = None        # the ArrayData it was made from (make_array)
    _base = None        # the array a slice was cut from
    _offset = 0         # the slice's first row in that array's layout

    def __new__(cls, *args, **kwargs):
        if cls is HostArray:
            t = args[2] if len(args) > 2 else kwargs.get("type")
            if t is not None:
                cls = _class_for(t)
        return object.__new__(cls)

    def __init__(self, values: Optional[np.ndarray],
                 mask: Optional[np.ndarray], type: dt.DataType,
                 dict_values: Optional[np.ndarray] = None, *,
                 offsets: Optional[np.ndarray] = None,
                 children: Sequence["HostArray"] = (),
                 length: Optional[int] = None):
        self.values = None if values is None else np.asarray(values)
        self.mask = None if mask is None else np.asarray(mask, np.bool_)
        self.type = type
        self.dict_values = dict_values
        self.offsets = None if offsets is None else np.asarray(offsets)
        self.children = list(children)
        if self.values is not None:
            self.length = len(self.values)
        elif self.offsets is not None:
            self.length = len(self.offsets) - 1
        else:
            self.length = int(length)

    def __len__(self) -> int:
        return self.length

    def validity_bools(self) -> np.ndarray:
        if self.mask is None:
            return np.full(self.length, self.type.id != dt.TypeId.NULL)
        return self.mask

    def unscaled(self, i: Optional[int] = None):
        """A decimal array's unscaled values as Python ints (row i's
        alone when i is given, as the JAX DecimalArray's `unscaled`)."""
        if i is not None:
            return self.slice(i, 1).unscaled()[0]
        if self.type.limbs:
            return to_ints(self.values).tolist()
        return self.values.tolist()

    # -- the JAX package's Array ------------------------------------------
    @property
    def offset(self) -> int:
        """The first row in the layout `data` holds (0 unless sliced)."""
        return self._offset

    @property
    def data(self):
        """The Arrow layout of the array as an ArrayData (array/layout.py):
        built on each call, a slice's being its source's at `offset`."""
        if self._data is not None:
            return self._data
        if self._base is not None:
            return self._base.data.slice(self._offset - self._base._offset,
                                         self.length)
        from ..array.arrays import array_data
        return array_data(self)

    def _sliced(self, out: "HostArray", offset: int) -> "HostArray":
        """`out`, rows cut from `offset` on, remembering its source."""
        out._base = self._base if self._base is not None else self
        out._offset = self._offset + offset
        return out

    @property
    def null_count(self) -> int:
        if self.type.id == dt.TypeId.NULL:
            return self.length
        return int(self.length - np.count_nonzero(self.validity_bools()))

    def is_valid(self, i: int) -> bool:
        if self.mask is not None:
            return bool(self.mask[i])
        if type(self).validity_bools is HostArray.validity_bools:
            return self.type.id != dt.TypeId.NULL
        return bool(self.validity_bools()[i])

    def is_null(self, i: int) -> bool:
        return not self.is_valid(i)

    def value(self, i: int):
        """Row i's Python value, read whatever its validity."""
        row = self.slice(i, 1)
        if row.mask is not None:
            row.mask = None
        return row.to_pylist()[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                raise ValueError("only step-1 slices supported")
            return self.slice(start, stop - start)
        if i < 0:
            i += len(self)
        if self.is_null(i):
            return None
        return self.value(i)

    def __iter__(self):
        return iter(self.to_pylist())

    def to_numpy(self, zero_copy_only: bool = True) -> np.ndarray:
        """The values: a flat column's numpy values, else an object array
        of `to_pylist`."""
        if self.values is not None and self.dict_values is None:
            return self.values
        out = np.empty(self.length, dtype=object)
        out[:] = self.to_pylist()
        return out

    def equals(self, other: "HostArray") -> bool:
        """Same type, length and Python values (array/compare.py)."""
        from ..array.compare import array_equal
        return array_equal(self, other)

    def __eq__(self, other):
        if isinstance(other, HostArray):
            return self.equals(other)
        return NotImplemented

    __hash__ = object.__hash__

    def __repr__(self) -> str:
        vals = self.to_pylist()
        if len(vals) > 20:
            vals = vals[:20] + ["..."]
        return f"<{type(self).__name__}({self.type})>{vals}"

    def _nested_values(self) -> list:
        t, n = self.type, self.length
        if t.id == dt.TypeId.STRUCT:
            cols = [c.to_pylist() for c in self.children]
            names = [f.name for f in t.fields()]
            return [dict(zip(names, row)) for row in zip(*cols)] if cols \
                else [{} for _ in range(n)]
        if t.id == dt.TypeId.FIXED_SIZE_LIST:
            k = t.list_size
            child = self.children[0].slice(0, n * k).to_pylist()
            return [child[i * k:(i + 1) * k] for i in range(n)]
        off = self.offsets.astype(np.int64)
        lo = int(off[0]) if n else 0
        child = self.children[0].slice(lo, int(off[-1]) - lo) if n else \
            self.children[0].slice(0, 0)
        if t.id == dt.TypeId.MAP:
            keys = child.children[0].to_pylist()
            items = child.children[1].to_pylist()
            entries = list(zip(keys, items))
        else:
            entries = child.to_pylist()
        rel = (off - lo).tolist()
        return [entries[a:b] for a, b in zip(rel[:-1], rel[1:])]

    def to_pylist(self) -> list:
        """Python values; a dictionary column's codes decode to its
        dictionary's values, a decimal's unscaled ints to Decimals, a
        list's rows to lists, a map's to lists of (key, value) tuples
        and a struct's to dicts (the JAX package's to_pylist); a null
        column's rows are None, an interval's tuples."""
        if self.type.id == dt.TypeId.NULL:
            return [None] * self.length
        if self.type.is_nested:
            vals = self._nested_values()
        elif self.type.is_decimal:
            vals = [decimal_value(u, self.type.scale)
                    for u in self.unscaled()]
        else:
            vals = self.values.tolist()
        oks = self.validity_bools().tolist()
        if self.dict_values is not None:
            # a numeric, bool or temporal dictionary as Python values
            # (float32 widened), as the JAX package gives them
            d = self.dict_values
            if isinstance(d, np.ndarray) and d.dtype != object and \
                    d.ndim == 1:
                d = d.tolist()
            vals = [d[c] if ok else None for c, ok in zip(vals, oks)]
        if self.mask is None:
            return vals
        return [v if ok else None for v, ok in zip(vals, oks)]

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "HostArray":
        """Rows [offset, offset + length) (to the end without a length;
        views of the same buffers; a list's child is shared, a
        fixed_size_list's and a struct's children are sliced)."""
        if length is None:
            length = self.length - offset
        end = min(offset + length, self.length)
        offset = min(offset, end)
        mask = None if self.mask is None else self.mask[offset:end]
        t = self.type
        cls = type(self)
        if t.id == dt.TypeId.NULL:
            out = cls(None, None, t, length=end - offset)
        elif not t.is_nested:
            out = cls(self.values[offset:end], mask, t, self.dict_values)
        elif t.id == dt.TypeId.STRUCT:
            out = cls(None, mask, t, children=[
                c.slice(offset, end - offset) for c in self.children],
                length=end - offset)
        elif t.id == dt.TypeId.FIXED_SIZE_LIST:
            k = t.list_size
            out = cls(None, mask, t, children=[
                self.children[0].slice(offset * k, (end - offset) * k)],
                length=end - offset)
        else:
            out = cls(None, mask, t, offsets=self.offsets[offset:end + 1],
                      children=self.children)
        return self._sliced(out, offset)


class RunEndEncodedArray(HostArray):
    """A run_end_encoded column (the JAX package's RunEndEncodedArray):
    children (run_ends, values), run i covering logical rows
    [run_ends[i - 1], run_ends[i]) of the unsliced array, with value
    values[i]. It has no validity of its own (a null is a null run
    value). A slice keeps the children and moves `offset`."""

    def __init__(self, run_ends: HostArray, values: HostArray, length: int,
                 offset: int = 0):
        self.type = dt.run_end_encoded(run_ends.type, values.type)
        self.mask = self.dict_values = self.offsets = None
        self.children = [run_ends, values]
        self.length = int(length)
        self._offset = int(offset)

    @property
    def run_ends(self) -> HostArray:
        return self.children[0]

    @property
    def values(self) -> HostArray:   # the values child, as in the JAX type
        return self.children[1]

    def _physical_index(self, i: int) -> int:
        return int(np.searchsorted(self.run_ends.values, self.offset + i,
                                   side="right"))

    def _runs(self):
        """(first run, the row count of each run from it on) over the
        logical rows [offset, offset + length)."""
        ends = self.run_ends.values.astype(np.int64)
        lo, hi = self.offset, self.offset + self.length
        first = int(np.searchsorted(ends, lo, side="right"))
        last = int(np.searchsorted(ends, hi, side="left")) + 1
        cut = np.clip(ends[first:last], lo, hi)
        return first, np.diff(cut, prepend=lo)

    def is_valid(self, i: int) -> bool:
        return bool(self.values.validity_bools()[self._physical_index(i)])

    def value(self, i: int):
        return self.values.slice(self._physical_index(i), 1).to_pylist()[0]

    def decode(self) -> HostArray:
        """The logical rows: each run's value repeated over its rows
        (np.repeat of the run lengths, where the JAX package searches
        each row's run)."""
        first, lens = self._runs()
        vals = self.values.slice(first, len(lens))
        if vals.type.is_nested:
            from ..compute.nested_selection import take_host_vec
            return take_host_vec(vals, np.repeat(
                np.arange(len(lens), dtype=np.int64), lens))
        mask = None if vals.mask is None else np.repeat(vals.mask, lens)
        return HostArray(np.repeat(vals.values, lens, axis=0), mask,
                         vals.type, vals.dict_values)

    def to_pylist(self) -> list:
        return self.decode().to_pylist()

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "RunEndEncodedArray":
        if length is None:
            length = self.length - offset
        end = min(offset + length, self.length)
        offset = min(offset, end)
        return RunEndEncodedArray(self.run_ends, self.values, end - offset,
                                  self.offset + offset)


class ListViewArray(HostArray):
    """A list_view or large_list_view column (the JAX package's
    ListViewArray): `offsets` and `sizes` (n each, the type's offset
    dtype) into one child, row i being the child's rows [offsets[i],
    offsets[i] + sizes[i]), in any order. A slice keeps the child."""

    def __new__(cls, *args, **kwargs):
        t = args[0] if args else kwargs.get("t")
        if cls is ListViewArray and t is not None and \
                t.id == dt.TypeId.LARGE_LIST_VIEW:
            cls = LargeListViewArray
        return object.__new__(cls)

    def __init__(self, t: dt.DataType, mask: Optional[np.ndarray],
                 offsets: np.ndarray, sizes: np.ndarray, child: HostArray):
        self.type = t
        self.values = self.dict_values = None
        self.mask = None if mask is None else np.asarray(mask, np.bool_)
        self.offsets = np.ascontiguousarray(offsets, t.offset_dtype)
        self.sizes = np.ascontiguousarray(sizes, t.offset_dtype)
        self.children = [child]
        self.length = len(self.offsets)

    def to_pylist(self) -> list:
        off = self.offsets.astype(np.int64)
        size = self.sizes.astype(np.int64)
        lo = int(off.min()) if self.length else 0
        hi = int((off + size).max()) if self.length else 0
        entries = self.children[0].slice(lo, hi - lo).to_pylist()
        rows = [entries[a - lo:a - lo + b]
                for a, b in zip(off.tolist(), size.tolist())]
        return [v if ok else None
                for v, ok in zip(rows, self.validity_bools().tolist())]

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "ListViewArray":
        if length is None:
            length = self.length - offset
        end = min(offset + length, self.length)
        offset = min(offset, end)
        mask = None if self.mask is None else self.mask[offset:end]
        return self._sliced(ListViewArray(
            self.type, mask, self.offsets[offset:end],
            self.sizes[offset:end], self.children[0]), offset)


class LargeListViewArray(ListViewArray):
    """A large_list_view column: int64 offsets and sizes."""


class UnionArray(HostArray):
    """A sparse or dense union column (the JAX package's UnionArray):
    `type_ids` (int8 type codes, n) and one child a field; a dense
    union also `value_offsets` (int32, n) into the child its code
    names, a sparse union's children having the union's rows (a slice
    slices them; a dense union's slice shares them). A union has no
    validity of its own: row i is valid when its child's row is, as the
    JAX package's `is_valid` reads it."""

    def __init__(self, t: dt.DataType, type_ids: np.ndarray,
                 children: Sequence[HostArray],
                 value_offsets: Optional[np.ndarray] = None):
        self.type = t
        self.values = self.dict_values = self.offsets = self.mask = None
        self.type_ids = np.ascontiguousarray(type_ids, np.int8)
        self.value_offsets = None if value_offsets is None else \
            np.ascontiguousarray(value_offsets, np.int32)
        self.children = list(children)
        self.length = len(self.type_ids)

    @property
    def dense(self) -> bool:
        return self.type.id == dt.TypeId.DENSE_UNION

    def child(self, i: int) -> HostArray:
        return self.children[i]

    def child_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(the child index of each row, its row in that child)."""
        lut = np.zeros(256, np.int64)
        for k, code in enumerate(self.type.type_codes):
            lut[code & 0xFF] = k
        cid = lut[self.type_ids.view(np.uint8)]
        pos = self.value_offsets.astype(np.int64) if self.dense else \
            np.arange(self.length, dtype=np.int64)
        return cid, pos

    def validity_bools(self) -> np.ndarray:
        cid, pos = self.child_rows()
        out = np.zeros(self.length, np.bool_)
        for k, c in enumerate(self.children):
            sel = cid == k
            if sel.any():
                out[sel] = c.validity_bools()[pos[sel]]
        return out

    def to_pylist(self) -> list:
        cid, pos = self.child_rows()
        values = [c.to_pylist() if (cid == k).any() else []
                  for k, c in enumerate(self.children)]
        return [values[k][p] for k, p in zip(cid.tolist(), pos.tolist())]

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "UnionArray":
        if length is None:
            length = self.length - offset
        end = min(offset + length, self.length)
        offset = min(offset, end)
        if self.dense:
            out = UnionArray(self.type, self.type_ids[offset:end],
                             self.children, self.value_offsets[offset:end])
        else:
            out = UnionArray(self.type, self.type_ids[offset:end],
                             [c.slice(offset, end - offset)
                              for c in self.children])
        return self._sliced(out, offset)


class ExtensionArray(HostArray):
    """An extension column (the JAX package's ExtensionArray): its
    storage HostArray under the extension type, whose values, validity,
    slices and takes are the storage's."""

    def __init__(self, t: dt.DataType, storage: HostArray):
        self.type = t
        self.values = self.dict_values = self.offsets = None
        self.mask = storage.mask
        self.children = [storage]
        self.length = len(storage)

    @property
    def storage(self) -> HostArray:
        return self.children[0]

    def validity_bools(self) -> np.ndarray:
        return self.storage.validity_bools()

    def to_pylist(self) -> list:
        return self.storage.to_pylist()

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "ExtensionArray":
        return self._sliced(ExtensionArray(
            self.type, self.storage.slice(offset, length)), offset)


def null_array(n: int) -> HostArray:
    """A column of n rows of the null type."""
    return HostArray(None, None, dt.null, length=n)


def nested_array(t: dt.DataType, length: int, mask: Optional[np.ndarray],
                 children: Sequence[HostArray],
                 offsets: Optional[np.ndarray] = None) -> HostArray:
    """A nested HostArray of type t (offsets for a list, large_list or
    map, in the type's offset dtype); a mask with no null is dropped."""
    if mask is not None and np.asarray(mask).all():
        mask = None
    if offsets is not None:
        offsets = np.ascontiguousarray(offsets, dtype=t.offset_dtype)
    return HostArray(None, mask, t, offsets=offsets, children=children,
                     length=length)


def _coerce(v, t: dt.DataType):
    """A Python value as its column's storage (the JAX NumericBuilder's
    coercions): a date as its days, a datetime as its units."""
    if t.id == dt.TypeId.DATE32 and isinstance(v, datetime.date):
        return (v - datetime.date(1970, 1, 1)).days
    if t.id == dt.TypeId.TIMESTAMP and isinstance(v, datetime.datetime):
        epoch = datetime.datetime(1970, 1, 1, tzinfo=v.tzinfo)
        return int((v - epoch).total_seconds() * t.unit.multiplier)
    return v


def from_pylist(values: Sequence, t: dt.DataType) -> HostArray:
    """A HostArray of t from Python values, None a null row (the JAX
    package's `array(values, t)` for the types the port builds this
    way): bool, the integers and floats, date32 (dates or days),
    timestamp (datetimes or units), the decimals (Decimals, floats or
    unscaled ints), the binary-like types and fixed_size_binary
    (dictionary-coded, first-occurrence order), struct (dicts; a missing
    key is a null field), list, large_list and fixed_size_list (lists; a
    null fixed-size row holds list_size null children), map (dicts or
    (key, value) pairs) and a dictionary type (its values, coded in
    first-occurrence order). Another type raises ArrowNotImplemented."""
    n = len(values)
    ok = np.fromiter(map(operator.is_not, values, itertools.repeat(None)),
                     np.bool_, n)
    mask = None if ok.all() else ok
    if t.id == dt.TypeId.NULL:
        return null_array(n)
    if t.id == dt.TypeId.DICTIONARY:
        memo: Dict[object, int] = {}
        codes = np.zeros(n, t.index_type.np_dtype)
        for i, v in enumerate(values):
            if v is not None:
                key = bytes(v) if isinstance(v, (bytearray, memoryview)) \
                    else v
                codes[i] = memo.setdefault(key, len(memo))
        uniq = list(memo)
        cls = _CLASSES[dt.TypeId.DICTIONARY]
        if t.value_type.codes_on_device:
            return cls(codes, mask, t, dictionary_values(uniq, t.value_type))
        d = from_pylist(uniq, t.value_type)
        return cls(codes, mask, t, d.values)
    if t.id == dt.TypeId.MAP:
        rows = [[] if v is None else list(v.items() if isinstance(v, dict)
                                           else v) for v in values]
        off = np.zeros(n + 1, np.int64)
        np.cumsum([len(r) for r in rows], out=off[1:])
        child = from_pylist([{"key": k, "value": x} for r in rows
                             for k, x in r], t.value_type)
        return nested_array(t, n, mask, [child], off)
    if t.is_decimal or (t.np_dtype is not None and t.np_dtype.names):
        from ..compute.scalars import array_of      # decimal, interval
        return array_of(values, t)
    if t.codes_on_device:
        obj = np.empty(n, dtype=object)
        if t.is_utf8:           # factorize reads the valid rows only
            obj[:] = values
        else:
            obj[:] = [b"" if v is None else v.encode()
                      if isinstance(v, str) else v for v in values]
        codes, dictionary = factorize(obj, ok)
        return HostArray(codes, mask, t, dictionary_values(dictionary, t))
    if t.id == dt.TypeId.STRUCT:
        cols = [from_pylist([None if v is None else v.get(f.name)
                             for v in values], f.type) for f in t.fields()]
        return nested_array(t, n, mask, cols)
    if t.id == dt.TypeId.FIXED_SIZE_LIST:
        k = t.list_size
        rows = [[None] * k if v is None else list(v) for v in values]
        if any(len(r) != k for r in rows):
            raise ValueError("fixed size list length mismatch")
        return nested_array(t, n, mask, [from_pylist(
            [x for r in rows for x in r], t.value_type)])
    if t.id in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST):
        lens = [0 if v is None else len(v) for v in values]
        off = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=off[1:])
        child = from_pylist([x for v in values if v is not None for x in v],
                            t.value_type)
        return nested_array(t, n, mask, [child], off)
    if t.np_dtype is None or t.is_nested or t.id == dt.TypeId.EXTENSION \
            or t.limbs:
        from ..compute.errors import ArrowNotImplemented
        raise ArrowNotImplemented(f"a {t} column from Python values")
    out = np.zeros(n, t.np_dtype)
    if ok.any():
        present = values if mask is None else \
            [v for v in values if v is not None]
        if t.id in (dt.TypeId.DATE32, dt.TypeId.TIMESTAMP):
            present = [_coerce(v, t) for v in present]
        out[ok] = present
    return HostArray(out, mask, t)


class HostBatch:
    """Schema + HostArrays: the host-side RecordBatch of the port, which
    the readers return. It carries the JAX RecordBatch's methods and the
    JAX Table's (`from_batches`, `combine_chunks`, which gives the batch
    itself, and `to_batches`), so code written for either runs on a read
    result; its `column` is the array, where a JAX Table's is a
    ChunkedArray (array/record.py has RecordBatch and Table)."""

    def __init__(self, schema: dt.Schema, columns: List[HostArray],
                 num_rows: int):
        self.schema = schema
        self.columns = list(columns)
        self.num_rows = num_rows

    def _like(self, schema: dt.Schema, columns: List[HostArray],
              num_rows: int) -> "HostBatch":
        return type(self)(schema, columns, num_rows)

    @classmethod
    def from_arrays(cls, arrays, names: Optional[Sequence[str]] = None,
                    metadata: dt.Metadata = dt.EMPTY_METADATA
                    ) -> "HostBatch":
        """A batch of a {name: HostArray} dict, or of HostArrays named by
        `names`, each field of its array's type."""
        if isinstance(arrays, dict):
            names, cols = list(arrays), list(arrays.values())
        else:
            cols = list(arrays)
        n = len(cols[0]) if cols else 0
        return cls(dt.Schema([dt.Field(k, a.type)
                              for k, a in zip(names, cols)], metadata),
                   cols, n)

    @classmethod
    def from_pydict(cls, data: Dict[str, object],
                    schema: Optional[dt.Schema] = None) -> "HostBatch":
        from ..array.record import RecordBatch
        rb = RecordBatch.from_pydict(data, schema)
        return cls(rb.schema, rb.columns, rb.num_rows)

    @classmethod
    def from_batches(cls, batches: Sequence["HostBatch"],
                     schema: Optional[dt.Schema] = None) -> "HostBatch":
        """One batch of the batches' rows in order (their columns
        concatenated, array/concat.py)."""
        from ..array.concat import concat_arrays
        if schema is None:
            if not batches:
                raise ValueError("need schema for empty table")
            schema = batches[0].schema
        if len(batches) == 1:
            return cls(schema, batches[0].columns, batches[0].num_rows)
        cols = [concat_arrays([b.columns[i] for b in batches], f.type)
                if batches else from_pylist([], f.type)
                for i, f in enumerate(schema.fields)]
        return cls(schema, cols, sum(b.num_rows for b in batches))

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, i: Union[str, int]) -> HostArray:
        if isinstance(i, str):
            name, i = i, self.schema.field_index(i)
            if i < 0:
                raise KeyError(f"no column {name!r}")
        return self.columns[i]

    def __getitem__(self, key) -> HostArray:
        return self.column(key)

    def column_name(self, i: int) -> str:
        return self.schema.field(i).name

    def select(self, names: Sequence[str]) -> "HostBatch":
        idxs = [self.schema.field_index(n) for n in names]
        return self._like(dt.Schema([self.schema.field(i) for i in idxs],
                                    self.schema.metadata),
                          [self.columns[i] for i in idxs], self.num_rows)

    def set_column(self, i: int, field: dt.Field,
                   col: HostArray) -> "HostBatch":
        cols = list(self.columns)
        cols[i] = col
        return self._like(self.schema.set_field(i, field), cols,
                          self.num_rows)

    def add_column(self, i: int, field: dt.Field,
                   col: HostArray) -> "HostBatch":
        cols = list(self.columns)
        cols.insert(i, col)
        return self._like(self.schema.add_field(i, field), cols,
                          self.num_rows)

    def to_pydict(self) -> Dict[str, list]:
        return {f.name: c.to_pylist()
                for f, c in zip(self.schema.fields, self.columns)}

    def to_pylist(self) -> List[dict]:
        d = self.to_pydict()
        return [dict(zip(d, row)) for row in zip(*d.values())] if d else []

    def equals(self, other: "HostBatch", check_metadata: bool = False
               ) -> bool:
        """The same schema and the same Python values a column."""
        return self.schema.equals(other.schema, check_metadata) and all(
            a.equals(b) for a, b in zip(self.columns, other.columns))

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "HostBatch":
        """Rows [offset, offset + length) (views of the same buffers)."""
        if length is None:
            length = self.num_rows - offset
        end = min(offset + length, self.num_rows)
        return self._like(self.schema, [c.slice(offset, length)
                                        for c in self.columns],
                          max(end - offset, 0))

    def combine_chunks(self) -> "HostBatch":
        """The batch itself: its columns are one chunk each."""
        return self

    def to_batches(self, max_chunksize: Optional[int] = None
                   ) -> List["HostBatch"]:
        """The rows as batches of at most `max_chunksize` rows (the
        batch itself without it)."""
        n = self.num_rows
        if max_chunksize is None or n <= max_chunksize:
            return [self]
        return [self.slice(s, min(max_chunksize, n - s))
                for s in range(0, n, max_chunksize)]


def _concat_nested(arrays: Sequence[HostArray], mask) -> HostArray:
    t = arrays[0].type
    n = sum(len(a) for a in arrays)
    if t.id == dt.TypeId.STRUCT:
        return nested_array(t, n, mask, [
            concat_host_arrays([a.children[i] for a in arrays])
            for i in range(len(arrays[0].children))])
    if t.id == dt.TypeId.FIXED_SIZE_LIST:
        k = t.list_size
        return nested_array(t, n, mask, [concat_host_arrays(
            [a.children[0].slice(0, len(a) * k) for a in arrays])])
    parts, offs, base = [], [np.zeros(1, np.int64)], 0
    for a in arrays:
        off = a.offsets.astype(np.int64)
        lo = int(off[0]) if len(a) else 0
        hi = int(off[-1]) if len(a) else 0
        parts.append(a.children[0].slice(lo, hi - lo))
        offs.append(off[1:] - lo + base)
        base += hi - lo
    return nested_array(t, n, mask, [concat_host_arrays(parts)],
                        np.concatenate(offs))


def _concat_list_views(arrays: Sequence[HostArray], mask) -> HostArray:
    from ..compute.nested_selection import expand_runs, take_host_vec
    children, sizes = [], []
    for a in arrays:
        size = np.where(a.validity_bools(), a.sizes.astype(np.int64), 0)
        children.append(take_host_vec(a.children[0], expand_runs(
            a.offsets.astype(np.int64), size)))
        sizes.append(size)
    size = np.concatenate(sizes)
    off = np.zeros(len(size), np.int64)
    np.cumsum(size[:-1], out=off[1:])
    return ListViewArray(arrays[0].type, mask, off, size,
                         concat_host_arrays(children))


def concat_host_arrays(arrays: Sequence[HostArray]) -> HostArray:
    """One HostArray of the arrays' rows in order. Dictionary arrays that
    share one dictionary keep it; otherwise their dictionaries merge in
    first-occurrence order and the codes are mapped into the merged one.
    Nested arrays concatenate their children (a list's offsets
    rebased; a list view's rows compacted in order, a null row empty,
    as the JAX package's builder rebuilds them). Unions and extension
    columns raise ArrowNotImplemented: the JAX package has no builder
    for them (array/concat.py)."""
    first = arrays[0]
    t = first.type
    if t.id == dt.TypeId.NULL:
        return null_array(sum(len(a) for a in arrays))
    if t.id in (dt.TypeId.SPARSE_UNION, dt.TypeId.DENSE_UNION,
                dt.TypeId.EXTENSION):
        from ..compute.errors import ArrowNotImplemented
        raise ArrowNotImplemented(f"concat of {t} columns")
    mask = None
    if any(a.mask is not None for a in arrays):
        mask = np.concatenate([a.validity_bools() for a in arrays])
    if t.id in (dt.TypeId.LIST_VIEW, dt.TypeId.LARGE_LIST_VIEW):
        return _concat_list_views(arrays, mask)
    if first.type.is_nested:
        return _concat_nested(arrays, mask)
    if first.dict_values is None or all(
            a.dict_values is first.dict_values or np.array_equal(
                a.dict_values, first.dict_values) for a in arrays[1:]):
        values = np.concatenate([a.values for a in arrays])
        return HostArray(values, mask, first.type, first.dict_values)
    codes, merged = factorize(np.concatenate([a.dict_values
                                              for a in arrays]))
    parts, base = [], 0
    for a in arrays:
        remap = codes[base:base + len(a.dict_values)]
        base += len(a.dict_values)
        parts.append(remap[np.clip(a.values, 0, max(len(remap) - 1, 0))]
                     if len(remap) else np.zeros(len(a), np.int32))
    return HostArray(np.concatenate(parts).astype(np.int32), mask,
                     first.type, merged)


def host_array_to_device(arr: HostArray, dev,
                         pad: Optional[int] = None) -> DeviceColumn:
    """A flat HostArray as a DeviceColumn on `dev`: values padded to `pad`
    (default pad_length(n)), validity words when it has a mask; a coded
    column keeps its codes and dictionary (a string-like or
    fixed_size_binary column of type T as a dictionary<int32, T> column,
    as the JAX to_device gives it); a null column is
    int8 zeros with all-false words; an extension column is its
    storage's column under the extension type. A column the block
    format does not carry raises ArrowNotImplemented (it rides a batch
    as a HostColumn; a list of a flat type goes to the device by
    list_to_device)."""
    if not arr.type.on_device:
        from ..compute.errors import ArrowNotImplemented
        raise ArrowNotImplemented(f"a {arr.type} column stays on the host")
    n = len(arr)
    P = pad_length(n) if pad is None else pad
    if arr.type.id == dt.TypeId.NULL:
        return DeviceColumn(torch.zeros(P, dtype=torch.int8, device=dev),
                            torch.zeros(P // WORD_BITS, dtype=torch.int32,
                                        device=dev), n, arr.type)
    if arr.type.id == dt.TypeId.EXTENSION:
        col = host_array_to_device(arr.storage, dev, P)
        return DeviceColumn(col.values, col.validity, n, arr.type)
    t = dt.dictionary(dt.int32, arr.type) if arr.type.codes_on_device \
        else arr.type
    host = storage_zeros(t, P)
    host[:n] = arr.values
    words = None if arr.mask is None else _words_to_tensor(
        _pack_words(arr.mask, P), dev)
    return DeviceColumn(torch.from_numpy(storage_view(host, t)).to(
        dev), words, n, t, arr.dict_values)


def check_storage(col: DeviceColumn) -> DeviceColumn:
    """`col` as it is; AssertionError when its values are not held in
    its type's storage dtype (`DataType.device_dtype`), the rule every
    DeviceColumn a compute function returns keeps, so that a kernel, a
    cast or a sort reads them as their type."""
    want = col.type.device_dtype
    if want is not None and col.values.dtype != want:
        raise AssertionError(f"{col.type} column held as "
                             f"{col.values.dtype}, not {want}")
    return col


def column_to_host(col: DeviceColumn) -> HostArray:
    """The [0, length) rows of a DeviceColumn as a HostArray (read
    through `metrics.host_read`)."""
    n = col.length
    if col.type.id == dt.TypeId.NULL:
        return null_array(n)
    if col.type.id == dt.TypeId.EXTENSION:
        return ExtensionArray(col.type, column_to_host(DeviceColumn(
            col.values, col.validity, n, col.type.storage_type)))
    mask = None
    if col.validity is not None:
        mask = _unpack_words(metrics.host_read(
            col.validity, "column_validity").view(np.uint32), n)
    return HostArray(host_view(metrics.host_read(col.values[:n],
                                                 "column_values"), col.type),
                     mask, col.type, col.dict_values)


def host_batch_to_device(hb: HostBatch, device=None,
                         pad: Optional[int] = None) -> DeviceBatch:
    """A HostBatch as a DeviceBatch on `device` (the card unless named),
    each column padded to `pad` (default pad_length of its rows); a
    column the block format does not carry rides as a HostColumn."""
    dev = torchenv.device(device)
    P = pad if pad is not None else pad_length(hb.num_rows)
    return DeviceBatch(hb.schema, [
        host_array_to_device(c, dev, P) if c.type.on_device
        else HostColumn(c) for c in hb.columns], hb.num_rows)


def device_batch_to_host(db: DeviceBatch) -> HostBatch:
    """The [0, length) rows of a DeviceBatch as a HostBatch: a coded
    column whose field is not a dictionary comes back decoded to the
    field's type (the JAX batch_from_device)."""
    cols = []
    for f, c in zip(db.schema.fields, db.columns):
        a = c.array if isinstance(c, HostColumn) else column_to_host(c)
        if a.type.id == dt.TypeId.DICTIONARY and \
                f.type.id != dt.TypeId.DICTIONARY:
            a = a.decode()
        cols.append(a)
    return HostBatch(db.schema, cols, db.length)


# ---------------------------------------------------------------------------
# the JAX package's names (arrow_go_tpu/device/block.py:435-623)
# ---------------------------------------------------------------------------

def to_device(arr: HostArray, pad: Optional[int] = None,
              device=None) -> DeviceColumn:
    """A HostArray as a DeviceColumn on `device` (the card unless named),
    padded to `pad` (host_array_to_device)."""
    return host_array_to_device(arr, torchenv.device(device), pad)


def as_dictionary(arr: HostArray) -> HostArray:
    """A string-like or fixed_size_binary column as the dictionary<int32,
    T> column of the same codes: the class the JAX from_device gives a
    column that went through the device. Any other column as it is."""
    if not arr.type.codes_on_device:
        return arr
    return HostArray(arr.values, arr.mask, dt.dictionary(dt.int32, arr.type),
                     arr.dict_values)


def from_device(col: DeviceColumn) -> HostArray:
    """The [0, length) rows of a DeviceColumn (column_to_host): a coded
    column a DictionaryArray, as in the JAX package."""
    return column_to_host(col)


def array_from_host(vals: np.ndarray, mask: Optional[np.ndarray],
                    t: dt.DataType, dictionary, n: int) -> HostArray:
    """The host tail of `from_device`: a HostArray of type t from values
    already read off the device (their first n rows, in the device's
    storage dtype or the host's) and an unpacked bool mask (dropped
    when it clears no row); a dictionary column keeps `dictionary`."""
    if t.id == dt.TypeId.NULL:
        return null_array(n)
    if mask is not None:
        mask = np.asarray(mask, np.bool_)[:n]
        if mask.all():
            mask = None
    vals = np.asarray(vals)[:n]
    if t.limbs:
        vals = np.ascontiguousarray(vals).view(np.int64)
    elif t.np_dtype is not None and vals.dtype != t.np_dtype:
        vals = host_view(vals, t)
    return HostArray(vals, mask, t, dictionary)


def batch_from_device(db: DeviceBatch):
    """The [0, length) rows of a DeviceBatch as a RecordBatch (a
    HostColumn's array as it is)."""
    from ..array.record import RecordBatch
    hb = device_batch_to_host(db)
    return RecordBatch(hb.schema, hb.columns, hb.num_rows)


# ---------------------------------------------------------------------------
# list<flat> columns on the device
# ---------------------------------------------------------------------------

@dataclass
class DeviceListColumn:
    """A list of a flat type in device memory (the JAX package's
    DeviceListColumn): padded int32 offsets (P + 1, absolute into the
    child, the tail repeating the last one) and a flat child
    DeviceColumn. Its take (`list_take_device`) gathers the offsets,
    expands the child runs with two running-max fills (K2's hi-only mode
    on the card) and takes the child once."""

    offsets: torch.Tensor           # int32 (P + 1,)
    child: DeviceColumn
    validity: Optional[torch.Tensor]  # int32 words over the rows, or None
    length: int
    type: dt.DataType

    @property
    def padded(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    @property
    def null_count(self) -> int:
        if self.validity is None:
            return 0
        return self.length - int(self.validity_mask().sum())

    def validity_mask(self) -> torch.Tensor:
        """Valid rows over the padded domain (False beyond length)."""
        return valid_rows(self.validity, self.padded, self.length,
                          self.device)


def list_to_device(arr: HostArray, pad: Optional[int] = None,
                   device=None) -> DeviceListColumn:
    """A list or large_list HostArray of a flat type as a
    DeviceListColumn on `device` (the card unless named): its offsets
    rebased to 0 (a sliced array's start at the child's row 0), the
    child's rows [first, last offset) as a DeviceColumn."""
    if arr.type.id not in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST) or \
            arr.type.value_type.is_nested:
        from ..compute.errors import ArrowNotImplemented
        raise ArrowNotImplemented(f"list_to_device of {arr.type}")
    dev = torchenv.device(device)
    n = len(arr)
    P = pad if pad is not None else pad_length(n)
    host_off = arr.offsets.astype(np.int64)
    base = int(host_off[0]) if n else 0
    last = int(host_off[-1]) if n else 0
    if last - base >= 1 << 31:
        raise ValueError("list_to_device: the child passes int32 offsets")
    off = np.zeros(P + 1, np.int32)
    off[:n + 1] = host_off - base
    off[n + 1:] = off[n]
    child = host_array_to_device(arr.children[0].slice(base, last - base),
                                 dev)
    words = None if arr.mask is None else _words_to_tensor(
        _pack_words(arr.mask, P), dev)
    return DeviceListColumn(torch.from_numpy(off).to(dev), child, words, n,
                            arr.type)


def list_from_device(col: DeviceListColumn) -> HostArray:
    """The [0, length) rows of a DeviceListColumn as a list HostArray
    (offsets in the type's offset dtype, the child cut at the last
    offset)."""
    n = col.length
    off = col.offsets[:n + 1].cpu().numpy().astype(col.type.offset_dtype)
    child = column_to_host(col.child).slice(0, int(off[-1]) if n else 0)
    mask = None if col.validity is None else _unpack_words(
        col.validity.cpu().numpy().view(np.uint32), n)
    return HostArray(None, mask, col.type, offsets=off, children=[child])


def list_take_device(col: DeviceListColumn, idx: torch.Tensor,
                     count: int) -> DeviceListColumn:
    """Take on a list column on its device: rows idx[i] for i < count
    (idx over the output's padded domain, -1 = a null row). Gathers the
    offsets, expands the child runs (a scatter of each row's position
    and output start, then two running-max fills: K2's hi-only mode
    `cummax_u32` on the card) and takes the child once. One host read
    sizes the child output (count, then materialize)."""
    from ..ops import bitmap, selection
    from ..ops.scan import cummax_u32
    P_out = idx.shape[0]
    dev = idx.device
    idx = idx.to(torch.int64)
    safe = idx.clamp(0, col.padded - 1)
    offsets = col.offsets.to(torch.int64)
    starts = offsets.index_select(0, safe)
    lens = offsets.index_select(0, safe + 1) - starts
    in_row = (idx >= 0) & row_mask(P_out, count, dev)
    if col.validity is not None:
        bits = (col.validity.index_select(0, safe // WORD_BITS)
                >> (safe % WORD_BITS).to(torch.int32)) & 1
        in_row = in_row & (bits == 1)
    lens = torch.where(in_row, lens, 0)
    starts = torch.where(in_row, starts, 0)
    new_off = torch.zeros(P_out + 1, dtype=torch.int64, device=dev)
    torch.cumsum(lens, 0, out=new_off[1:])
    total = int(new_off[P_out])                 # the one host read
    cap = pad_length(max(total, 1))
    # each non-empty row marks its first child slot, an empty or null row
    # a spare slot of its own past `cap` (the JAX scatter's mode="drop"):
    # no two rows share a slot, so a plain scatter is exact (one shared
    # spare slot serialises its writers on the card)
    pos = torch.arange(P_out, dtype=torch.int64, device=dev)
    tgt = torch.where(lens > 0, new_off[:-1].clamp(0, cap - 1), cap + pos)
    seeds = torch.zeros((2, cap + P_out), dtype=torch.int64, device=dev)
    seeds[0].scatter_(0, tgt, pos)
    seeds[1].scatter_(0, tgt, new_off[:-1])
    rowpos = cummax_u32(seeds[0, :cap].contiguous())
    fill_start_out = cummax_u32(seeds[1, :cap].contiguous())
    j = torch.arange(cap, dtype=torch.int64, device=dev)
    child_idx = starts.index_select(0, rowpos) + (j - fill_start_out)
    child_idx = torch.where(j < total, child_idx, -1)
    child = col.child
    new_child = DeviceColumn(
        selection.gather(child.values, child_idx),
        selection.take_validity(child.validity, child_idx, total, cap),
        total, child.type, child.dict_values)
    return DeviceListColumn(new_off.to(torch.int32), new_child,
                            bitmap.pack_mask(in_row), count, col.type)


from ..array import arrays as _arrays  # noqa: E402,F401  (registers _CLASSES)
