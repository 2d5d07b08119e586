"""Substrait bridge: ExtendedExpression <-> the port's expression trees.

Port of arrow_go_tpu/compute/substrait.py (reference arrow/compute/exprs:
builders.go expression -> substrait proto, exec.go substrait -> compute
expression, types.go arrow <-> substrait types). The protobuf messages
(substrait-io/substrait proto/substrait/{algebra,type,
extended_expression}) are written and read by hand over
interop/protowire. An ExtendedExpression's bytes are the JAX
serializer's for the same expressions and schema, but for the producer
string of its version message ("arrow_go_tpu_torch").

Each call's output type is written by `_infer_output_type`, an own copy
of the JAX package's static rule (arrow_go_tpu/compute/expression.py:
306-343), which types a Python int literal as int64; it serves the
encoder only, and `compile_expression` keeps the eager result's type.
The decoder resolves names through the port's `default_registry`:
Substrait's `and` / `or` become `and_kleene` / `or_kleene`, and an
`overflow: SILENT` option the `_unchecked` name.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from .. import dtypes as dt
from ..interop import protowire as pw
from . import kernels
from .errors import ArrowInvalid, ArrowNotImplemented
from .expression import Call, Expression, FieldRef, Literal, call, literal
from .scalars import infer_type

_URI_PREFIX = "https://github.com/substrait-io/substrait/blob/main/extensions/"
URI_ARITHMETIC = _URI_PREFIX + "functions_arithmetic.yaml"
URI_COMPARISON = _URI_PREFIX + "functions_comparison.yaml"
URI_BOOLEAN = _URI_PREFIX + "functions_boolean.yaml"
URI_STRING = _URI_PREFIX + "functions_string.yaml"
URI_ROUNDING = _URI_PREFIX + "functions_rounding.yaml"

NULLABLE = 1
REQUIRED = 2

# the producer of the version message: the one field whose bytes differ
# from the JAX serializer's ("arrow_go_tpu")
PRODUCER = "arrow_go_tpu_torch"

# substrait function name -> (uri, our function name); overflow-sensitive
# arithmetic resolves to checked/unchecked by the "overflow" option
_FROM_SUBSTRAIT = {
    "equal": "equal", "not_equal": "not_equal", "gt": "greater",
    "lt": "less", "gte": "greater_equal", "lte": "less_equal",
    "is_null": "is_null", "is_not_null": "is_valid",
    "is_nan": "is_nan", "is_finite": "is_finite",
    "and": "and_kleene", "or": "or_kleene", "not": "invert", "xor": "xor",
    "add": "add", "subtract": "subtract", "multiply": "multiply",
    "divide": "divide", "negate": "negate", "power": "power",
    "sqrt": "sqrt", "abs": "abs", "modulus": "mod",
    "ceil": "ceil", "floor": "floor", "round": "round",
    "concat": "binary_join_element_wise",
}

_TO_SUBSTRAIT = {
    "equal": ("equal", URI_COMPARISON), "not_equal": ("not_equal", URI_COMPARISON),
    "greater": ("gt", URI_COMPARISON), "less": ("lt", URI_COMPARISON),
    "greater_equal": ("gte", URI_COMPARISON),
    "less_equal": ("lte", URI_COMPARISON),
    "is_null": ("is_null", URI_COMPARISON),
    "is_valid": ("is_not_null", URI_COMPARISON),
    "is_nan": ("is_nan", URI_COMPARISON),
    "is_finite": ("is_finite", URI_COMPARISON),
    "and": ("and", URI_BOOLEAN), "and_kleene": ("and", URI_BOOLEAN),
    "or": ("or", URI_BOOLEAN), "or_kleene": ("or", URI_BOOLEAN),
    "invert": ("not", URI_BOOLEAN), "xor": ("xor", URI_BOOLEAN),
    "add": ("add", URI_ARITHMETIC), "subtract": ("subtract", URI_ARITHMETIC),
    "multiply": ("multiply", URI_ARITHMETIC),
    "divide": ("divide", URI_ARITHMETIC),
    "negate": ("negate", URI_ARITHMETIC), "power": ("power", URI_ARITHMETIC),
    "sqrt": ("sqrt", URI_ARITHMETIC), "abs": ("abs", URI_ARITHMETIC),
    "ceil": ("ceil", URI_ROUNDING), "floor": ("floor", URI_ROUNDING),
}
for _n in ("add", "subtract", "multiply", "divide", "negate", "power",
           "sqrt", "abs"):
    _TO_SUBSTRAIT[_n + "_unchecked"] = _TO_SUBSTRAIT[_n]

_OVERFLOW_FUNCS = {"add", "subtract", "multiply", "divide", "negate",
                   "power", "abs"}

# -- types (substrait type.proto oneof field numbers) -----------------------

_KIND_TO_TYPE = {1: dt.bool_, 2: dt.int8, 3: dt.int16, 5: dt.int32,
                 7: dt.int64, 10: dt.float32, 11: dt.float64,
                 12: dt.string, 13: dt.binary, 16: dt.date32}

_TYPE_TO_KIND = {dt.TypeId.BOOL: 1, dt.TypeId.INT8: 2, dt.TypeId.INT16: 3,
                 dt.TypeId.INT32: 5, dt.TypeId.INT64: 7,
                 dt.TypeId.FLOAT32: 10, dt.TypeId.FLOAT64: 11,
                 dt.TypeId.STRING: 12, dt.TypeId.LARGE_STRING: 12,
                 dt.TypeId.BINARY: 13, dt.TypeId.LARGE_BINARY: 13,
                 dt.TypeId.DATE32: 16}


def _encode_type(t: dt.DataType, nullable: bool) -> bytearray:
    out = bytearray()
    nul = NULLABLE if nullable else REQUIRED
    if t.id == dt.TypeId.TIMESTAMP:
        sub = bytearray()
        pw.put_field_varint(sub, 2, nul)
        # precision_timestamp(_tz) field 40/41 in modern substrait;
        # deprecated timestamp kinds 14/29 remain the interop baseline
        pw.put_field_msg(out, 29 if t.tz else 14, sub)
        return out
    if t.id == dt.TypeId.TIME64:
        sub = bytearray()
        pw.put_field_varint(sub, 2, nul)
        pw.put_field_msg(out, 17, sub)
        return out
    if t.is_decimal:
        sub = bytearray()
        pw.put_field_varint(sub, 1, t.scale)
        pw.put_field_varint(sub, 2, t.precision)
        pw.put_field_varint(sub, 4, nul)
        pw.put_field_msg(out, 24, sub)
        return out
    if t.id == dt.TypeId.FIXED_SIZE_BINARY:
        sub = bytearray()
        pw.put_field_varint(sub, 1, t.byte_width)
        pw.put_field_varint(sub, 3, nul)
        pw.put_field_msg(out, 23, sub)
        return out
    if t.id in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST):
        sub = bytearray()
        pw.put_field_msg(sub, 1, _encode_type(t.value_type,
                                              t.value_field.nullable))
        pw.put_field_varint(sub, 3, nul)
        pw.put_field_msg(out, 27, sub)
        return out
    if t.id == dt.TypeId.STRUCT:
        sub = bytearray()
        for f in t.fields():
            pw.put_field_msg(sub, 1, _encode_type(f.type, f.nullable))
        pw.put_field_varint(sub, 3, nul)
        pw.put_field_msg(out, 25, sub)
        return out
    if t.id == dt.TypeId.MAP:
        sub = bytearray()
        pw.put_field_msg(sub, 1, _encode_type(t.key_type, False))
        pw.put_field_msg(sub, 2, _encode_type(t.item_type,
                                              t.item_field.nullable))
        pw.put_field_varint(sub, 4, nul)
        pw.put_field_msg(out, 28, sub)
        return out
    kind = _TYPE_TO_KIND.get(t.id)
    if kind is None:
        raise ArrowNotImplemented(f"substrait type for {t}")
    sub = bytearray()
    pw.put_field_varint(sub, 2, nul)
    pw.put_field_msg(out, kind, sub)
    return out


def _decode_type(b: bytes) -> Tuple[dt.DataType, bool]:
    for fid, _, v in pw.fields(b):
        d = pw.to_dict(v)
        if fid in _KIND_TO_TYPE:
            return _KIND_TO_TYPE[fid], pw.first(d, 2, 0) != REQUIRED
        if fid == 14:
            return dt.timestamp("us"), pw.first(d, 2, 0) != REQUIRED
        if fid == 29:
            return dt.timestamp("us", "UTC"), pw.first(d, 2, 0) != REQUIRED
        if fid == 17:
            return dt.time64("us"), pw.first(d, 2, 0) != REQUIRED
        if fid == 24:
            return (dt.decimal128(pw.first(d, 2, 38), pw.first(d, 1, 0)),
                    pw.first(d, 4, 0) != REQUIRED)
        if fid == 23:
            return (dt.fixed_size_binary(pw.first(d, 1, 0)),
                    pw.first(d, 3, 0) != REQUIRED)
        if fid == 27:
            inner, inner_null = _decode_type(d[1][0])
            return (dt.list_(dt.Field("element", inner, inner_null)),
                    pw.first(d, 3, 0) != REQUIRED)
        if fid == 25:
            fields_ = []
            for i, tb in enumerate(d.get(1, [])):
                it, inull = _decode_type(tb)
                fields_.append(dt.Field(f"f{i}", it, inull))
            return dt.struct(fields_), pw.first(d, 3, 0) != REQUIRED
        if fid == 28:
            kt, _ = _decode_type(d[1][0])
            vt, vnull = _decode_type(d[2][0])
            return dt.map_(kt, vt), pw.first(d, 4, 0) != REQUIRED
    raise ArrowNotImplemented("unknown substrait type kind")


# -- schema (NamedStruct) ----------------------------------------------------

def _walk_names(t: dt.DataType, names: List[str]) -> None:
    if t.id == dt.TypeId.STRUCT:
        for f in t.fields():
            names.append(f.name)
            _walk_names(f.type, names)
    elif t.id in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST):
        _walk_names(t.value_type, names)
    elif t.id == dt.TypeId.MAP:
        _walk_names(t.key_type, names)
        _walk_names(t.item_type, names)


def serialize_schema(schema: dt.Schema) -> bytes:
    """Schema -> substrait NamedStruct bytes (reference types.go
    ToSubstraitType + pyarrow.substrait.serialize_schema parity)."""
    out = bytearray()
    struct_body = bytearray()
    for f in schema.fields:
        pw.put_field_str(out, 1, f.name)
        nested: List[str] = []
        _walk_names(f.type, nested)
        for n in nested:
            pw.put_field_str(out, 1, n)
        pw.put_field_msg(struct_body, 1, _encode_type(f.type, f.nullable))
    pw.put_field_msg(out, 2, struct_body)
    return bytes(out)


def deserialize_schema(data: bytes) -> dt.Schema:
    d = pw.to_dict(bytes(data))
    names = [v.decode("utf-8") for v in d.get(1, [])]
    struct_d = pw.to_dict(d[2][0]) if 2 in d else {}
    fields_: List[dt.Field] = []
    ni = [0]

    def next_name() -> str:
        n = names[ni[0]] if ni[0] < len(names) else f"f{ni[0]}"
        ni[0] += 1
        return n

    def consume_names(t: dt.DataType) -> dt.DataType:
        if t.id == dt.TypeId.STRUCT:
            return dt.struct([dt.Field(next_name(), consume_names(f.type),
                                       f.nullable) for f in t.fields()])
        if t.id in (dt.TypeId.LIST, dt.TypeId.LARGE_LIST):
            inner = consume_names(t.value_type)
            return dt.list_(dt.Field("element", inner,
                                     t.value_field.nullable))
        if t.id == dt.TypeId.MAP:
            kt = consume_names(t.key_type)
            vt = consume_names(t.item_type)
            return dt.map_(kt, vt)
        return t

    for tb in struct_d.get(1, []):
        name = next_name()
        t, nullable = _decode_type(tb)
        fields_.append(dt.Field(name, consume_names(t), nullable))
    return dt.Schema(fields_)


# -- literals ----------------------------------------------------------------

def _encode_literal(v, out: bytearray) -> None:
    """Literal message body (algebra.proto Expression.Literal)."""
    import datetime as _dt_
    if v is None:
        # null literal needs a type; default to i64 null
        pw.put_field_msg(out, 29, _encode_type(dt.int64, True))
        return
    if isinstance(v, bool):
        pw.put_field_varint(out, 1, 1 if v else 0)
        return
    if isinstance(v, int):
        pw.put_field_varint(out, 7, v)
        return
    if isinstance(v, float):
        pw.put_field_double(out, 11, v)
        return
    if isinstance(v, str):
        pw.put_field_str(out, 12, v)
        return
    if isinstance(v, (bytes, bytearray)):
        pw.put_field_bytes(out, 13, bytes(v))
        return
    if isinstance(v, _dt_.date) and not isinstance(v, _dt_.datetime):
        days = (v - _dt_.date(1970, 1, 1)).days
        pw.put_field_varint(out, 16, days)
        return
    raise ArrowNotImplemented(f"substrait literal for {type(v)}")


def _decode_literal(b: bytes):
    import datetime as _dt_
    import struct as _struct
    for fid, wt, v in pw.fields(b):
        if fid == 1:
            return bool(v)
        if fid in (2, 3, 5, 7):
            if v >= 1 << 63:
                v -= 1 << 64
            return v
        if fid == 10:
            return _struct.unpack("<f", v)[0]
        if fid == 11:
            return _struct.unpack("<d", v)[0]
        if fid == 12:
            return v.decode("utf-8")
        if fid == 13:
            return bytes(v)
        if fid == 16:
            # a negative int32 is a sign-extended 10-byte varint (the
            # JAX decoder subtracts 2**32 from it and overflows)
            if v >= 1 << 63:
                v -= 1 << 64
            elif v >= 1 << 31:
                v -= 1 << 32
            return _dt_.date(1970, 1, 1) + _dt_.timedelta(days=int(v))
        if fid == 29:
            return None
        if fid in (50, 51):  # type variation / nullable flags
            continue
    raise ArrowNotImplemented("unsupported substrait literal")


# -- expressions -------------------------------------------------------------

class _ExtensionSet:
    """Accumulates extension URIs + function anchors during serialization
    (reference exprs/builders.go ExtensionIDSet)."""

    def __init__(self):
        self.uris: Dict[str, int] = {}
        self.functions: Dict[Tuple[str, str], int] = {}

    def uri_anchor(self, uri: str) -> int:
        if uri not in self.uris:
            self.uris[uri] = len(self.uris) + 1
        return self.uris[uri]

    def function_anchor(self, uri: str, name: str) -> int:
        key = (uri, name)
        if key not in self.functions:
            self.functions[key] = len(self.functions) + 1
            self.uri_anchor(uri)
        return self.functions[key]


def _field_index(schema: dt.Schema, ref: FieldRef) -> List[int]:
    idxs: List[int] = []
    t: Optional[dt.DataType] = None
    for part in ref.path:
        if t is None:
            i = schema.field_index(part) if isinstance(part, str) else part
            t = schema.field(i).type
        else:
            if t.id != dt.TypeId.STRUCT:
                raise ArrowInvalid(f"cannot select {part} in {t}")
            i = ([f.name for f in t.fields()].index(part)
                 if isinstance(part, str) else part)
            t = t.fields()[i].type
        idxs.append(i)
    return idxs


def _infer_output_type(expr: Expression, schema: dt.Schema) -> dt.DataType:
    """The JAX package's static output type of `expr` (an own copy of
    arrow_go_tpu/compute/expression.py:306-343): a field's top-level
    type (a nested path's first step), a literal's inferred type (a
    Python int is int64), bool for compares and the boolean functions,
    the common numeric type of binary arithmetic (float64 for the
    float-only functions over ints), the argument's for unary
    arithmetic; ArrowInvalid for anything else."""
    if isinstance(expr, FieldRef):
        idx = schema.field_index(expr.path[0]) \
            if isinstance(expr.path[0], str) else expr.path[0]
        return schema.field(idx).type
    if isinstance(expr, Literal):
        return infer_type([expr.value])
    if isinstance(expr, Call):
        f = expr.function
        if f in kernels._COMPARE or f in ("and", "or", "xor", "and_not",
                                          "and_kleene", "or_kleene",
                                          "and_not_kleene", "invert",
                                          "is_null", "is_valid", "is_nan",
                                          "is_finite", "is_in"):
            return dt.bool_
        if f == "cast":
            o = expr.options
            return o["to_type"] if isinstance(o, dict) else o
        if f in kernels._ARITH_BINARY:
            a = _infer_output_type(expr.args[0], schema)
            b = _infer_output_type(expr.args[1], schema)
            to = dt.common_numeric_type(a, b)
            if f in kernels._FLOAT_ONLY and not to.is_floating:
                to = dt.float64
            return to
        if f in kernels._ARITH_UNARY:
            a = _infer_output_type(expr.args[0], schema)
            if f in kernels._FLOAT_ONLY and not a.is_floating:
                return dt.float64
            return a
        if f in ("fill_null", "if_else"):
            return _infer_output_type(expr.args[-1] if f == "fill_null"
                                      else expr.args[1], schema)
    raise ArrowInvalid(f"cannot infer output type of {expr!r}")


def _encode_expression(expr: Expression, schema: dt.Schema,
                       ext: _ExtensionSet) -> bytearray:
    out = bytearray()
    if isinstance(expr, Literal):
        lit = bytearray()
        _encode_literal(expr.value, lit)
        pw.put_field_msg(out, 1, lit)
        return out
    if isinstance(expr, FieldRef):
        idxs = _field_index(schema, expr)
        seg = bytearray()
        for i in reversed(idxs):
            inner = seg
            seg = bytearray()
            sf = bytearray()
            if i:
                pw.put_field_varint(sf, 1, i)
            if inner:
                pw.put_field_msg(sf, 2, inner)
            pw.put_field_msg(seg, 2, sf)
        fr = bytearray()
        pw.put_field_msg(fr, 1, seg)
        pw.put_field_msg(fr, 4, bytearray())  # root_reference
        pw.put_field_msg(out, 2, fr)
        return out
    if isinstance(expr, Call):
        fname = expr.function
        if fname == "cast":
            to = expr.options["to_type"] if isinstance(expr.options, dict) \
                else expr.options
            c = bytearray()
            pw.put_field_msg(c, 1, _encode_type(to, True))
            pw.put_field_msg(c, 2, _encode_expression(expr.args[0], schema,
                                                      ext))
            pw.put_field_varint(c, 3, 2)  # FAILURE_BEHAVIOR_THROW_EXCEPTION
            pw.put_field_msg(out, 11, c)
            return out
        if fname == "if_else":
            it = bytearray()
            clause = bytearray()
            pw.put_field_msg(clause, 1, _encode_expression(expr.args[0],
                                                           schema, ext))
            pw.put_field_msg(clause, 2, _encode_expression(expr.args[1],
                                                           schema, ext))
            pw.put_field_msg(it, 1, clause)
            pw.put_field_msg(it, 2, _encode_expression(expr.args[2], schema,
                                                       ext))
            pw.put_field_msg(out, 6, it)
            return out
        if fname not in _TO_SUBSTRAIT:
            raise ArrowNotImplemented(f"substrait mapping for {fname!r}")
        sname, uri = _TO_SUBSTRAIT[fname]
        anchor = ext.function_anchor(uri, sname)
        sf = bytearray()
        pw.put_field_varint(sf, 1, anchor)
        try:
            base = fname[:-10] if fname.endswith("_unchecked") else fname
            out_t = _infer_output_type(Call(base, expr.args, expr.options),
                                       schema)
            pw.put_field_msg(sf, 3, _encode_type(out_t, True))
        except Exception:
            pass
        for a in expr.args:
            arg = bytearray()
            pw.put_field_msg(arg, 3, _encode_expression(a, schema, ext))
            pw.put_field_msg(sf, 4, arg)
        if sname in _OVERFLOW_FUNCS:
            opt = bytearray()
            pw.put_field_str(opt, 1, "overflow")
            pw.put_field_str(
                opt, 2,
                "SILENT" if fname.endswith("_unchecked") else "ERROR")
            pw.put_field_msg(sf, 5, opt)
        pw.put_field_msg(out, 3, sf)
        return out
    raise ArrowNotImplemented(f"substrait encode {type(expr)}")


def _decode_field_ref(b: bytes, schema: Optional[dt.Schema]) -> FieldRef:
    d = pw.to_dict(b)
    if 1 not in d:
        raise ArrowNotImplemented("only direct field references supported")
    idxs: List[int] = []
    seg = d[1][0]
    while seg:
        sd = pw.to_dict(seg)
        if 2 not in sd:
            raise ArrowNotImplemented("non-struct reference segment")
        fd = pw.to_dict(sd[2][0])
        idxs.append(pw.first(fd, 1, 0))
        seg = pw.first(fd, 2, b"")
    # resolve to names when we have a schema (friendlier expressions)
    if schema is not None:
        parts: List[Union[str, int]] = []
        t: Optional[dt.DataType] = None
        ok = True
        for i in idxs:
            if t is None:
                if i >= len(schema.fields):
                    ok = False
                    break
                parts.append(schema.field(i).name)
                t = schema.field(i).type
            elif t.id == dt.TypeId.STRUCT and i < t.num_fields:
                parts.append(t.fields()[i].name)
                t = t.fields()[i].type
            else:
                ok = False
                break
        if ok:
            return FieldRef(*parts)
    return FieldRef(*idxs)


def _decode_expression(b: bytes, schema: Optional[dt.Schema],
                       functions: Dict[int, str]) -> Expression:
    d = pw.to_dict(b)
    if 1 in d:
        return literal(_decode_literal(d[1][0]))
    if 2 in d:
        return _decode_field_ref(d[2][0], schema)
    if 3 in d:
        sf = pw.to_dict(d[3][0])
        anchor = pw.first(sf, 1, 0)
        sname = functions.get(anchor)
        if sname is None:
            raise ArrowInvalid(f"unresolved function anchor {anchor}")
        sname = sname.split(":")[0]
        our = _FROM_SUBSTRAIT.get(sname)
        if our is None:
            raise ArrowNotImplemented(f"substrait function {sname!r}")
        overflow = None
        for ob in sf.get(5, []):
            od = pw.to_dict(ob)
            if pw.first(od, 1, b"").decode("utf-8", "replace") == "overflow":
                prefs = [x.decode() for x in od.get(2, [])]
                overflow = prefs[0] if prefs else None
        if overflow == "SILENT" and our + "_unchecked" != our:
            from .registry import default_registry
            if our + "_unchecked" in default_registry():
                our = our + "_unchecked"
        args = []
        for ab in sf.get(4, []):
            ad = pw.to_dict(ab)
            if 3 not in ad:
                raise ArrowNotImplemented("enum/type function arguments")
            args.append(_decode_expression(ad[3][0], schema, functions))
        return call(our, args)
    if 11 in d:
        cd = pw.to_dict(d[11][0])
        to_t, _ = _decode_type(cd[1][0])
        inner = _decode_expression(cd[2][0], schema, functions)
        return call("cast", [inner], {"to_type": to_t})
    if 6 in d:
        it = pw.to_dict(d[6][0])
        clause = pw.to_dict(it[1][0])
        cond = _decode_expression(clause[1][0], schema, functions)
        then = _decode_expression(clause[2][0], schema, functions)
        els = _decode_expression(it[2][0], schema, functions)
        return call("if_else", [cond, then, els])
    raise ArrowNotImplemented(f"substrait expression fields {sorted(d)}")


# -- ExtendedExpression -------------------------------------------------------

class BoundExpressions:
    """Deserialized ExtendedExpression: schema + named expression trees
    (mirrors pyarrow.substrait.BoundExpressions / reference exprs exec)."""

    def __init__(self, schema: dt.Schema, expressions: Dict[str, Expression]):
        self.schema = schema
        self.expressions = expressions

    def __repr__(self):
        return f"BoundExpressions({self.schema!r}, {self.expressions!r})"


def serialize_expressions(exprs, names: Optional[List[str]] = None,
                          schema: Optional[dt.Schema] = None) -> bytes:
    """Expressions + schema -> substrait ExtendedExpression bytes.

    exprs: list of expressions with parallel `names`, or {name: expr}.
    """
    if isinstance(exprs, dict):
        names = list(exprs.keys())
        exprs = list(exprs.values())
    if schema is None or names is None:
        raise ArrowInvalid("serialize_expressions needs names and schema")
    ext = _ExtensionSet()
    bodies = []
    for e, n in zip(exprs, names):
        eb = _encode_expression(e, schema, ext)
        ref = bytearray()
        pw.put_field_msg(ref, 1, eb)
        pw.put_field_str(ref, 3, n)
        bodies.append(ref)
    out = bytearray()
    for uri, anchor in ext.uris.items():
        u = bytearray()
        pw.put_field_varint(u, 1, anchor)
        pw.put_field_str(u, 2, uri)
        pw.put_field_msg(out, 1, u)
    for (uri, name), anchor in ext.functions.items():
        f = bytearray()
        pw.put_field_varint(f, 1, ext.uris[uri])
        pw.put_field_varint(f, 2, anchor)
        pw.put_field_str(f, 3, name)
        decl = bytearray()
        pw.put_field_msg(decl, 3, f)
        pw.put_field_msg(out, 2, decl)
    for ref in bodies:
        pw.put_field_msg(out, 3, ref)
    pw.put_field_msg(out, 4, bytearray(serialize_schema(schema)))
    ver = bytearray()
    pw.put_field_varint(ver, 2, 44)
    pw.put_field_str(ver, 5, PRODUCER)
    pw.put_field_msg(out, 7, ver)
    return bytes(out)


def deserialize_expressions(data: bytes) -> BoundExpressions:
    d = pw.to_dict(bytes(data))
    schema = deserialize_schema(d[4][0]) if 4 in d else dt.Schema([])
    functions: Dict[int, str] = {}
    for db in d.get(2, []):
        dd = pw.to_dict(db)
        if 3 in dd:
            fd = pw.to_dict(dd[3][0])
            functions[pw.first(fd, 2, 0)] = \
                pw.first(fd, 3, b"").decode("utf-8")
    out: Dict[str, Expression] = {}
    for rb in d.get(3, []):
        rd = pw.to_dict(rb)
        names = [x.decode("utf-8") for x in rd.get(3, [])]
        expr = _decode_expression(rd[1][0], schema, functions)
        out[names[0] if names else f"expr{len(out)}"] = expr
    return BoundExpressions(schema, out)
