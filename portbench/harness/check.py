"""The comparison that decides `correct`.

Every answer of the window is held against the plain reference's answer
for its query and substitution set, computed once the window has
closed. An answer is {column: numpy array}, rows in the query's ORDER
BY. Against the reference's columns:

  answers_missing  answers that raised or never came (limit 0)
  answers_wrong    answers whose row count, or any string, integer,
                   date or count column, differs from the reference in
                   any row (limit 0: these are exact)
  sum_rel_gap      the widest relative gap |got - want| / |want| of a
                   float column (sums and means of float64 money), over
                   every row of every answer; only where the reference
                   has float columns

Each number's limit comes from the configuration file's `limits`.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def normalize(result) -> Dict[str, np.ndarray]:
    """A plan's host result (a RecordBatch, or {name: values}) as
    {name: numpy array}: strings as objects, numbers as they are."""
    if hasattr(result, "to_pydict"):
        result = result.to_pydict()
    out = {}
    for k, v in result.items():
        a = np.asarray(v if isinstance(v, (list, tuple, np.ndarray))
                       else [v])
        if a.dtype.kind in "USO":
            a = a.astype(object)
        out[k] = a
    return out


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]):
    """(exact part equal, widest relative gap of the float columns or
    None where there are none)."""
    ok, gap = True, None
    for name, w in want.items():
        g = got.get(name)
        if g is None or len(g) != len(w):
            ok = False
            continue
        if w.dtype.kind == "f":
            g = np.asarray(g, dtype=np.float64)
            w = w.astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
            rel = np.where((g == w), 0.0, rel)
            m = float(np.max(rel)) if len(rel) else 0.0
            if not np.isfinite(m):
                m = float("inf")
            gap = m if gap is None else max(gap, m)
        elif len(w) and (g.dtype.kind in "fc" or list(g) != list(w)):
            ok = False
    return ok, gap


def judge(answers, wants: Dict[tuple, dict], limits: Dict[str, float]):
    """The numbers compared, each {"value", "limit"}, and `correct`."""
    missing = wrong = 0
    gap: Optional[float] = None
    for a in answers:
        if a.error is not None or a.result is None:
            missing += 1
            continue
        ok, g = compare(a.result, wants[(a.query, a.set_index)])
        wrong += 0 if ok else 1
        if g is not None:
            gap = g if gap is None else max(gap, g)
    checks = {"answers_missing": missing, "answers_wrong": wrong}
    if gap is not None:
        checks["sum_rel_gap"] = gap
    checks = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    correct = bool(answers) and all(c["value"] <= c["limit"]
                                    for c in checks.values())
    return correct, checks


def report_lines(checks: dict) -> List[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]
