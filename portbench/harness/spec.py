"""Finds a cell's files by the names in BENCHMARK.json.

  BENCHMARK.json                    the cell (workload), its config and
                                    traffic names, the metric lists
  portbench/configs/<config>.json   sizes, precision, limits; `family`
                                    names the generator and the queries
  portbench/generators/<family>.py  generate(config, seed, device)
  portbench/mixes/<traffic>.json    queries, weights, substitution rules
  portbench/queries/<family>/<q>.py run(tables, params, ctx): the plan
  portbench/reference/<family>/<q>.py run(tables, params, acc): numpy /
                                    plain torch
  portbench/e2e_metrics/<name>.py   read(window) -> value or None
  portbench/layer_metrics/<name>.py read(trace) -> value or None

Nothing here names a cell, a query or a metric.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent.parent        # portbench/
ROOT = HERE.parent


def load_module(path: Path):
    """The module at `path`, loaded under a name of its own path."""
    name = "portbench_file." + "_".join(path.relative_to(HERE).with_suffix(
        "").parts).replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def family(self) -> str:
        return self.config["family"]

    def generator(self):
        return load_module(HERE / "generators" / f"{self.family}.py")

    def plans(self) -> Dict[str, object]:
        return {q: load_module(HERE / "queries" / self.family / f"{q}.py")
                for q in self.mix["queries"]}

    def references(self) -> Dict[str, object]:
        return {q: load_module(HERE / "reference" / self.family / f"{q}.py")
                for q in self.mix["queries"]}


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if "workloads" not in m
            or cell in m["workloads"]]


def load_cell(workload: str, benchmark: Path = ROOT / "BENCHMARK.json"
              ) -> Cell:
    spec = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {benchmark.name}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(workload, int(w["chips"]), config, mix,
                _for_cell(spec["end_to_end"], workload),
                _for_cell(spec["per_layer"], workload))


def reader(kind: str, name: str):
    """A metric's reader: e2e_metrics/<name>.py or layer_metrics/<name>.py."""
    return load_module(HERE / kind / f"{name}.py").read
