"""HostArray equality, approximate equality and the edit-script diff
(after arrow_go_tpu/array/compare.py; reference arrow/array/compare.go
and diff.go). Both arrays are compared by type and length first, then by
their Python values (`to_pylist`): a coded column by the values its
codes name. A string column and a dictionary<int32, string> column of
the same values differ, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from ..device.block import HostArray


def array_equal(a: HostArray, b: HostArray) -> bool:
    if a.type != b.type or len(a) != len(b):
        return False
    return a.to_pylist() == b.to_pylist()


def array_approx_equal(a: HostArray, b: HostArray, atol: float = 1e-5,
                       nans_equal: bool = False) -> bool:
    """Elementwise equality with float tolerance
    (reference arrayApproxEqual)."""
    if a.type != b.type or len(a) != len(b):
        return False
    if not a.type.is_floating:
        return array_equal(a, b)
    for x, y in zip(a.to_pylist(), b.to_pylist()):
        if x is None or y is None:
            if x is not y:
                return False
            continue
        if math.isnan(x) or math.isnan(y):
            if nans_equal and math.isnan(x) and math.isnan(y):
                continue
            return False
        if abs(x - y) > atol:
            return False
    return True


class DiffEdit:
    """One edit: insert (into target) or delete (from base)."""

    __slots__ = ("op", "index", "value")

    def __init__(self, op: str, index: int, value):
        self.op = op        # '+' insert, '-' delete
        self.index = index
        self.value = value

    def __repr__(self):
        return f"{self.op}[{self.index}]={self.value!r}"

    def __eq__(self, other):
        return (self.op, self.index, self.value) == \
            (other.op, other.index, other.value)


def diff(base: HostArray, target: HostArray) -> List[DiffEdit]:
    """The edit script turning base into target, from the longest
    common subsequence of their values (reference arrow/array/diff.go):
    on a tie a delete comes before an insert."""
    a = base.to_pylist()
    b = target.to_pylist()
    n, m = len(a), len(b)
    # the O(nm) LCS table (diffs are of test-sized arrays)
    lcs = np.zeros((n + 1, m + 1), dtype=np.int64)
    for i in range(n - 1, -1, -1):
        for j in range(m - 1, -1, -1):
            if a[i] == b[j]:
                lcs[i][j] = lcs[i + 1][j + 1] + 1
            else:
                lcs[i][j] = max(lcs[i + 1][j], lcs[i][j + 1])
    out: List[DiffEdit] = []
    i = j = 0
    while i < n and j < m:
        if a[i] == b[j]:
            i += 1
            j += 1
        elif lcs[i + 1][j] >= lcs[i][j + 1]:
            out.append(DiffEdit("-", i, a[i]))
            i += 1
        else:
            out.append(DiffEdit("+", j, b[j]))
            j += 1
    out.extend(DiffEdit("-", k, a[k]) for k in range(i, n))
    out.extend(DiffEdit("+", k, b[k]) for k in range(j, m))
    return out
