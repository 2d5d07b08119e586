"""Compute functions of the port (mirrors arrow_go_tpu.compute)."""
from typing import Optional

from .. import dtypes as dt
from .cast import CastOptions, can_cast, cast_device
from .errors import (ArrowError, ArrowIndexError, ArrowInvalid, ArrowKeyError,
                     ArrowNotImplemented)
from .expression import (call, execute_scalar_expression, field, literal,
                         project)
from .functions import (CountOptions, FilterOptions, MakeStructOptions,
                        SetLookupOptions, SortKey, SortOptions, TakeOptions,
                        VarianceOptions,
                        agg_all, agg_any, agg_count, agg_count_distinct,
                        agg_max, agg_mean, agg_min, agg_product, agg_stddev,
                        agg_sum, agg_variance, dictionary_encode, fill_null,
                        filter_, if_else, index_in, is_in, make_struct,
                        min_max, sort_indices, take, unique, value_counts)
from .groupby import group_by
from .join import PROBE_CHUNK_DEFAULT, hash_join
from .kernels import (arithmetic_binary, arithmetic_unary, boolean_binary,
                      compare, invert, is_finite, is_nan, is_null, is_valid,
                      round_, round_to_multiple)
from .registry import (FunctionRegistry, call_function, default_registry,
                       new_child_registry)
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

__all__ = ["ArrowError", "ArrowIndexError", "ArrowInvalid", "ArrowKeyError",
           "ArrowNotImplemented", "call", "execute_scalar_expression",
           "field", "literal", "project", "CountOptions", "FilterOptions",
           "MakeStructOptions", "make_struct", "value_counts",
           "SetLookupOptions", "SortKey", "SortOptions", "TakeOptions",
           "VarianceOptions", "agg_all", "agg_any", "agg_count",
           "agg_count_distinct", "agg_max", "agg_mean", "agg_min",
           "agg_product", "agg_stddev", "agg_sum", "agg_variance",
           "dictionary_encode", "fill_null", "filter", "filter_", "if_else",
           "index_in", "is_in", "min_max", "sort_indices", "take", "unique",
           "group_by", "PROBE_CHUNK_DEFAULT", "hash_join",
           "arithmetic_binary", "arithmetic_unary", "boolean_binary",
           "compare", "invert", "is_finite", "is_nan", "is_null", "is_valid",
           "round_", "round_to_multiple", "CastOptions", "can_cast", "cast",
           "cast_device", "FunctionRegistry", "call_function",
           "default_registry", "new_child_registry", "ceil_temporal",
           "floor_temporal", "round_temporal"]
