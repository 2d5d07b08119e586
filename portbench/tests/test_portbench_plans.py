"""Each plan against its plain reference, the port on the CPU, every
substitution set of the mix drawn from two seeds."""
import json

import pytest
import torch

from portbench.harness import check, params, stream, tables
from portbench.harness.spec import HERE, load_cell
from portbench.tests.conftest import ROOT, small_cell

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
CASES = [(w, q) for w in CELLS for q in load_cell(w).mix["queries"]]

_made = {}


def _tables(cell, seed):
    key = (cell.config["name"], seed)
    if key not in _made:
        gen = cell.generator().generate(cell.config, seed, "cpu")
        _made[key] = (gen, tables.to_port(gen))
    return _made[key]


@pytest.mark.parametrize("workload,query", CASES)
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 7])
def test_plan_matches_reference(workload, query, seed):
    cell = small_cell(workload)
    gen, port = _tables(cell, seed)
    plan, ref = cell.plans()[query], cell.references()[query]
    acc = {"float64": torch.float64, "int64": torch.int64}[
        cell.config["accumulate"]]
    ctx = stream.Ctx(torch.device("cpu"))
    for p in params.draw_sets(cell.mix, seed)[query]:
        got = check.normalize(plan.run(port, p, ctx))
        want = check.normalize(ref.run(gen, p, acc))
        ok, gap = check.compare(got, want)
        assert ok, (query, p)
        assert gap is None or gap <= cell.config["limits"]["sum_rel_gap"]


def test_every_query_has_a_plan_and_a_reference():
    for w in CELLS:
        cell = load_cell(w)
        for q in cell.mix["queries"]:
            assert (HERE / "queries" / cell.family / f"{q}.py").exists()
            assert (HERE / "reference" / cell.family / f"{q}.py").exists()


def test_an_even_rule_gives_every_seed_the_same_values():
    from portbench.harness import params
    mix = {"sets_per_query": 4, "queries": {"q": {"params": {
        "delta": {"even": [60, 120]}, "year": {"year": [1993, 1997]}}}}}
    seen = set()
    for seed in (1, 2 ** 31 + 5, 3 * 10 ** 9):
        sets = params.draw_sets(mix, seed)["q"]
        assert sorted(p["delta"] for p in sets) == [67, 82, 97, 112]
        seen.add(tuple(p["delta"] for p in sets))
    assert len(seen) > 1          # the order is the seed's
    assert params._middle(1, 3, 0, 4) == 1      # fewer values than sets
