"""Compute functions of the port (mirrors arrow_go_tpu.compute)."""
from .errors import (ArrowError, ArrowIndexError, ArrowInvalid, ArrowKeyError,
                     ArrowNotImplemented)
from .expression import call, execute_scalar_expression, field, literal
from .functions import (CountOptions, FilterOptions, SortKey, SortOptions,
                        TakeOptions, agg_count, agg_max, agg_mean, agg_min,
                        agg_sum, filter_, min_max, sort_indices, take)
from .groupby import group_by
from .join import hash_join

filter = filter_  # noqa: A001  (the reference's name)

__all__ = ["ArrowError", "ArrowIndexError", "ArrowInvalid", "ArrowKeyError",
           "ArrowNotImplemented", "call", "execute_scalar_expression",
           "field", "literal", "CountOptions", "FilterOptions",
           "SortKey", "SortOptions", "TakeOptions", "agg_count", "agg_max",
           "agg_mean", "agg_min", "agg_sum", "filter", "filter_", "min_max",
           "sort_indices", "take", "group_by", "hash_join"]
