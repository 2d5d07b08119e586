"""Substitution parameters and the query order, drawn from the seed.

A mix file gives each query its substitution rules as data, one rule a
parameter (TPC-H clause 2.4.x.3 for TPC-H):

  {"int": [lo, hi]}                 an integer uniform in [lo, hi]
  {"even": [lo, hi]}                the middle integer of one of the
                                    sets' equal strata of [lo, hi]
  {"choice": [v, ...]}              one of the values
  {"distinct": {"k": 2, "of": [...]}}  k different values, in drawn order
  {"day": ["1995-03-01", "1995-03-31"]}  an ISO day uniform in the range
  {"month": ["1993-01", "1997-10"]} the first day of a month in the range
  {"year": [1993, 1997]}            a year uniform in the range
  anything else                     a constant, taken as it stands

Each query gets `sets_per_query` such sets. A numeric rule's range is
cut into that many equal strata, and the k-th set draws from the k-th,
so that every seed's sets spread over the whole range alike and the
seed changes which values, not how much work. Where the work steps
within a stratum (a filtered batch that crosses one of the port's
padded sizes), an "even" rule gives every seed the same values, the
k-th set the middle of the k-th stratum, in an order of the sets drawn
from the seed. The stream runs the
mix's queries (each `weight` times) in one permutation drawn from the
seed, repeated; the k-th instance of a query takes its set k mod sets.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _stratum(rng: np.random.Generator, n: int, k: int, of: int) -> int:
    """An offset in [0, n), uniform within the k-th of `of` equal strata
    (uniform over [0, n) where there are fewer values than strata)."""
    if n < of:
        return int(rng.integers(n))
    lo, hi = k * n // of, (k + 1) * n // of
    return lo + int(rng.integers(hi - lo))


def _middle(lo: int, hi: int, k: int, of: int) -> int:
    """The middle integer of the k-th of `of` equal strata of [lo, hi]."""
    n = hi - lo + 1
    a, b = k * n // of, max((k + 1) * n // of, k * n // of + 1)
    return lo + (a + b - 1) // 2


def _draw(rule, rng: np.random.Generator, k: int, of: int):
    if not isinstance(rule, dict) or len(rule) != 1:
        return rule
    (kind, arg), = rule.items()
    if kind in ("int", "year"):
        return arg[0] + _stratum(rng, arg[1] - arg[0] + 1, k, of)
    if kind == "choice":
        return arg[int(rng.integers(len(arg)))]
    if kind == "distinct":
        idx = rng.permutation(len(arg["of"]))[:arg["k"]]
        return [arg["of"][i] for i in idx]
    if kind == "day":
        lo, hi = (np.datetime64(d, "D") for d in arg)
        n = int((hi - lo).astype(np.int64)) + 1
        return str(lo + _stratum(rng, n, k, of))
    if kind == "month":
        lo, hi = (np.datetime64(m, "M") for m in arg)
        n = int((hi - lo).astype(np.int64)) + 1
        return str((lo + _stratum(rng, n, k, of)).astype("datetime64[D]"))
    return rule


def draw_sets(mix: dict, seed: int) -> Dict[str, List[dict]]:
    """{query: [params, ...]}, sets_per_query sets a query."""
    rng = np.random.default_rng([seed, 1])
    turns = np.random.default_rng([seed, 3])
    n = int(mix["sets_per_query"])
    sets = {}
    for q, spec in mix["queries"].items():
        rules = spec.get("params", {})
        turn = turns.permutation(n)
        sets[q] = [{name: _middle(*r["even"], int(turn[k]), n)
                    if isinstance(r, dict) and list(r) == ["even"]
                    else _draw(r, rng, k, n) for name, r in rules.items()}
                   for k in range(n)]
    return sets


def order(mix: dict, seed: int) -> List[str]:
    """One round of the stream: each query `weight` times, permuted."""
    names = [q for q, spec in mix["queries"].items()
             for _ in range(int(spec.get("weight", 1)))]
    rng = np.random.default_rng([seed, 2])
    return [names[i] for i in rng.permutation(len(names))]


def schedule(mix: dict, seed: int):
    """The endless stream: (query, set index) pairs."""
    round_ = order(mix, seed)
    sets = int(mix["sets_per_query"])
    seen: Dict[str, int] = {}
    while True:
        for q in round_:
            k = seen.get(q, 0)
            seen[q] = k + 1
            yield q, k % sets


def instances(mix: dict, seed: int) -> List[Tuple[str, int]]:
    """Every (query, set index) pair of the mix once: what set-up warms."""
    return [(q, k) for q in mix["queries"]
            for k in range(int(mix["sets_per_query"]))]
