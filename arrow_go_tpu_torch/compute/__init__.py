"""Compute functions of the port (mirrors arrow_go_tpu.compute)."""
from .errors import (ArrowError, ArrowIndexError, ArrowInvalid, ArrowKeyError,
                     ArrowNotImplemented)
from .expression import call, execute_scalar_expression, field, literal
from .functions import (CountOptions, FilterOptions, SetLookupOptions,
                        SortKey, SortOptions, TakeOptions, VarianceOptions,
                        agg_all, agg_any, agg_count, agg_count_distinct,
                        agg_max, agg_mean, agg_min, agg_product, agg_stddev,
                        agg_sum, agg_variance, dictionary_encode, fill_null,
                        filter_, if_else, index_in, is_in, min_max,
                        sort_indices, take, unique)
from .groupby import group_by
from .join import PROBE_CHUNK_DEFAULT, hash_join
from .kernels import (arithmetic_binary, arithmetic_unary, boolean_binary,
                      compare, invert, is_finite, is_nan, is_null, is_valid)

filter = filter_  # noqa: A001  (the reference's name)

__all__ = ["ArrowError", "ArrowIndexError", "ArrowInvalid", "ArrowKeyError",
           "ArrowNotImplemented", "call", "execute_scalar_expression",
           "field", "literal", "CountOptions", "FilterOptions",
           "SetLookupOptions", "SortKey", "SortOptions", "TakeOptions",
           "VarianceOptions", "agg_all", "agg_any", "agg_count",
           "agg_count_distinct", "agg_max", "agg_mean", "agg_min",
           "agg_product", "agg_stddev", "agg_sum", "agg_variance",
           "dictionary_encode", "fill_null", "filter", "filter_", "if_else",
           "index_in", "is_in", "min_max", "sort_indices", "take", "unique",
           "group_by", "PROBE_CHUNK_DEFAULT", "hash_join",
           "arithmetic_binary", "arithmetic_unary", "boolean_binary",
           "compare", "invert", "is_finite", "is_nan", "is_null", "is_valid"]
