"""Compute-layer errors (reference returns wrapped arrow errors)."""


class ArrowError(Exception):
    pass


class ArrowInvalid(ArrowError, ValueError):
    """Invalid argument / overflow / failed safety check."""


class ArrowIndexError(ArrowError, IndexError):
    """Out-of-bounds take index."""


class ArrowNotImplemented(ArrowError, NotImplementedError):
    """No kernel for the given types."""


class ArrowKeyError(ArrowError, KeyError):
    """Unknown function name."""
