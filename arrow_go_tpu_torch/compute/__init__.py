"""Compute functions of the port (mirrors arrow_go_tpu.compute)."""
from .errors import (ArrowError, ArrowIndexError, ArrowInvalid, ArrowKeyError,
                     ArrowNotImplemented)
from .expression import call, execute_scalar_expression, field, literal
from .functions import (FilterOptions, TakeOptions, filter_, sort_indices,
                        take)
from .groupby import group_by
from .join import hash_join

filter = filter_  # noqa: A001  (the reference's name)

__all__ = ["ArrowError", "ArrowIndexError", "ArrowInvalid", "ArrowKeyError",
           "ArrowNotImplemented", "call", "execute_scalar_expression",
           "field", "literal", "FilterOptions", "TakeOptions", "filter",
           "filter_", "sort_indices", "take", "group_by", "hash_join"]
