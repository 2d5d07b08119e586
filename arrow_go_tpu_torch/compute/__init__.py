"""Compute functions of the port (mirrors arrow_go_tpu.compute): the
registry's functions, the expression front and its Substrait bridge
(`serialize_expressions`, `deserialize_expressions`), run-end encoding,
scalars, and the typed wrappers (`add` ... `stddev`, each
fn(a[, b], options=None, device=None) over call_function; `sum`, `min`,
`max`, `abs`, `round`, `any` and `all` shadow the builtins here, as in
the JAX package)."""
from typing import Optional

from .. import dtypes as dt
from .cast import CastOptions, can_cast, cast_device
from .errors import (ArrowError, ArrowIndexError, ArrowInvalid, ArrowKeyError,
                     ArrowNotImplemented)
from .expression import (Expression, FieldRef, Literal, call,
                         compile_expression, execute_scalar_expression,
                         field, literal, project)
from .functions import (CountOptions, FilterOptions, MakeStructOptions,
                        SetLookupOptions, SortKey, SortOptions, TakeOptions,
                        VarianceOptions,
                        agg_all, agg_any, agg_count, agg_count_distinct,
                        agg_max, agg_mean, agg_min, agg_product, agg_stddev,
                        agg_sum, agg_variance, dictionary_encode, fill_null,
                        filter_, if_else, index_in, is_in, make_struct,
                        min_max, sort, sort_indices, take, unique,
                        value_counts)
from .groupby import group_by
from .join import PROBE_CHUNK_DEFAULT, hash_join
from .kernels import (arithmetic_binary, arithmetic_unary, boolean_binary,
                      compare, round_, round_to_multiple)
from .registry import (FunctionRegistry, call_function, default_registry,
                       new_child_registry)
from .run_ends import run_end_decode, run_end_encode
from .scalars import Scalar, make_array_from_scalar, parse_scalar, scalar
from .substrait import (BoundExpressions, deserialize_expressions,
                        serialize_expressions)
from .temporal import ceil_temporal, floor_temporal, round_temporal

filter = filter_  # noqa: A001  (the reference's name)


def cast(values, target_type: dt.DataType,
         options: Optional[CastOptions] = None, safe: bool = True,
         device=None):
    """`values` (a DeviceColumn or a HostArray) as `target_type`, through
    the registry's cast (a HostArray moves to `device`, the card unless
    named)."""
    if options is None and not safe:
        options = CastOptions.unsafe()
    return call_function("cast", [values], {"to_type": target_type,
                                            "options": options},
                         device=device)



def _wrap1(name: str):
    def fn(a, options=None, device=None):
        return call_function(name, [a], options, device=device)
    fn.__name__ = fn.__qualname__ = name
    return fn


def _wrap2(name: str):
    def fn(a, b, options=None, device=None):
        return call_function(name, [a, b], options, device=device)
    fn.__name__ = fn.__qualname__ = name
    return fn


_UNARY_WRAPPERS = (
    "negate", "abs", "sign", "sqrt", "exp", "ln", "log2", "log10", "log1p",
    "sin", "cos", "tan", "asin", "acos", "atan", "floor", "ceil", "trunc",
    "round", "invert", "is_null", "is_valid", "is_nan", "is_finite",
    "bit_wise_not", "sum", "min", "max", "mean", "count", "count_distinct",
    "any", "all", "product", "variance", "stddev")
_BINARY_WRAPPERS = (
    "add", "subtract", "multiply", "divide", "power", "mod", "atan2",
    "equal", "not_equal", "less", "less_equal", "greater", "greater_equal",
    "xor", "and_not", "and_kleene", "or_kleene", "shift_left",
    "shift_right", "bit_wise_and", "bit_wise_or", "bit_wise_xor")
globals().update({n: _wrap1(n) for n in _UNARY_WRAPPERS})
globals().update({n: _wrap2(n) for n in _BINARY_WRAPPERS})
and_ = _wrap2("and")
or_ = _wrap2("or")

__all__ = ["ArrowError", "ArrowIndexError", "ArrowInvalid", "ArrowKeyError",
           "ArrowNotImplemented", "Expression", "FieldRef",
           "Literal", "call", "compile_expression",
           "execute_scalar_expression", "field", "literal", "project",
           "CountOptions", "FilterOptions",
           "MakeStructOptions", "make_struct", "value_counts",
           "SetLookupOptions", "SortKey", "SortOptions", "TakeOptions",
           "VarianceOptions", "agg_all", "agg_any", "agg_count",
           "agg_count_distinct", "agg_max", "agg_mean", "agg_min",
           "agg_product", "agg_stddev", "agg_sum", "agg_variance",
           "dictionary_encode", "fill_null", "filter", "filter_", "if_else",
           "index_in", "is_in", "min_max", "sort", "sort_indices", "take",
           "unique", "group_by", "PROBE_CHUNK_DEFAULT", "hash_join",
           "arithmetic_binary", "arithmetic_unary", "boolean_binary",
           "compare", "round_", "round_to_multiple", "CastOptions", "can_cast", "cast",
           "cast_device", "FunctionRegistry", "call_function",
           "default_registry", "new_child_registry", "ceil_temporal",
           "floor_temporal", "round_temporal", "run_end_decode",
           "run_end_encode", "Scalar", "make_array_from_scalar",
           "parse_scalar", "scalar", "and_", "or_", "BoundExpressions",
           "deserialize_expressions", "serialize_expressions",
           *_UNARY_WRAPPERS, *_BINARY_WRAPPERS]
