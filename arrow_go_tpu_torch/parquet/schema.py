"""Parquet <-> port schema conversion for flat columns.

Port of the flat-column part of arrow_go_tpu/parquet/schema.py
(reference parquet/schema + parquet/pqarrow/schema.go): BOOLEAN, INT32,
INT64, FLOAT and DOUBLE leaves, required or optional, directly under the
root. Groups (lists, maps, structs), other physical types and logical
annotations the port has no type for raise ArrowNotImplemented.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from .. import dtypes as dt
from ..compute.errors import ArrowNotImplemented
from . import format as fmt


@dataclass
class ColumnDescriptor:
    """Leaf column: physical type + levels info
    (reference parquet/schema/column.go)."""

    path: Tuple[str, ...]
    physical_type: fmt.Type
    type_length: int
    max_def_level: int
    max_rep_level: int
    arrow_type: dt.DataType
    schema_elements: List[fmt.SchemaElement]  # root-to-leaf elements


_PHYSICAL = {dt.TypeId.BOOL: fmt.Type.BOOLEAN, dt.TypeId.INT32: fmt.Type.INT32,
             dt.TypeId.INT64: fmt.Type.INT64,
             dt.TypeId.FLOAT32: fmt.Type.FLOAT,
             dt.TypeId.FLOAT64: fmt.Type.DOUBLE}
_LOGICAL = {fmt.Type.BOOLEAN: dt.bool_, fmt.Type.INT32: dt.int32,
            fmt.Type.INT64: dt.int64, fmt.Type.FLOAT: dt.float32,
            fmt.Type.DOUBLE: dt.float64}


def physical_for(t: dt.DataType) -> Tuple[fmt.Type, int]:
    """(physical type, type_length) of a port type."""
    try:
        return _PHYSICAL[t.id], 0
    except KeyError:
        raise ArrowNotImplemented(
            f"no parquet physical type for {t}") from None


def schema_to_elements(schema: dt.Schema
                       ) -> Tuple[List[fmt.SchemaElement],
                                  List[ColumnDescriptor]]:
    """Port schema -> flat SchemaElement list + leaf columns."""
    root = fmt.SchemaElement(name="schema", num_children=len(schema))
    elements = [root]
    leaves: List[ColumnDescriptor] = []
    for f in schema.fields:
        phys, tlen = physical_for(f.type)
        rep = fmt.Repetition.OPTIONAL if f.nullable else \
            fmt.Repetition.REQUIRED
        el = fmt.SchemaElement(name=f.name, type=int(phys),
                               repetition_type=int(rep))
        elements.append(el)
        leaves.append(ColumnDescriptor((f.name,), phys, tlen,
                                       1 if f.nullable else 0, 0, f.type,
                                       [el]))
    return elements, leaves


def _type_of(el: fmt.SchemaElement) -> dt.DataType:
    phys = fmt.Type(el.type)
    lt = el.logicalType
    plain_int = lt is not None and lt.INTEGER is not None and \
        bool(lt.INTEGER.isSigned) and lt.INTEGER.bitWidth == {
            fmt.Type.INT32: 32, fmt.Type.INT64: 64}.get(phys)
    if (lt is not None and not plain_int) or el.converted_type not in (
            None, int(fmt.ConvertedType.INT_32),
            int(fmt.ConvertedType.INT_64)) or phys not in _LOGICAL:
        raise ArrowNotImplemented(
            f"column {el.name!r}: physical {phys.name} with logical "
            f"{lt} / converted {el.converted_type} is not ported")
    return _LOGICAL[phys]


def elements_to_schema(elements: List[fmt.SchemaElement]
                       ) -> Tuple[dt.Schema, List[ColumnDescriptor]]:
    """Parquet SchemaElement list -> port schema + leaf descriptors."""
    root = elements[0]
    n = root.num_children or 0
    if len(elements) != n + 1 or any(el.num_children
                                     for el in elements[1:]):
        raise ArrowNotImplemented("nested parquet columns are not ported")
    fields: List[dt.Field] = []
    leaves: List[ColumnDescriptor] = []
    for el in elements[1:]:
        rep = fmt.Repetition(el.repetition_type or 0)
        if rep == fmt.Repetition.REPEATED:
            raise ArrowNotImplemented(
                f"repeated column {el.name!r} is not ported")
        nullable = rep == fmt.Repetition.OPTIONAL
        t = _type_of(el)
        fields.append(dt.Field(el.name, t, nullable))
        leaves.append(ColumnDescriptor((el.name,), fmt.Type(el.type),
                                       el.type_length or 0,
                                       1 if nullable else 0, 0, t, [el]))
    return dt.Schema(fields), leaves
