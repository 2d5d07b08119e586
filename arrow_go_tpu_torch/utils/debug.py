"""Debug assertions (the reference's `assert` build tag:
arrow/internal/debug/assert_on.go:25 toggles debug.Assert).

Port of arrow_go_tpu/utils/debug.py, under the same two environment
flags, read once at import: `AGT_ASSERT=1` makes `debug_assert` a real
check (otherwise it does nothing, so hot paths pay nothing), and
`AGT_DEBUG=1` makes `debug_log` print to stderr
(arrow/internal/debug/log_on.go:31).
"""
from __future__ import annotations

import os
import sys

_ASSERT = os.environ.get("AGT_ASSERT", "") not in ("", "0")
_DEBUG = os.environ.get("AGT_DEBUG", "") not in ("", "0")


if _ASSERT:
    def debug_assert(cond, msg: str = "debug assertion failed") -> None:
        if not cond:
            raise AssertionError(msg)
else:
    def debug_assert(cond, msg: str = "") -> None:  # noqa: ARG001
        pass


if _DEBUG:
    def debug_log(*args) -> None:
        print("[agt-debug]", *args, file=sys.stderr, flush=True)
else:
    def debug_log(*args) -> None:  # noqa: ARG001
        pass
