"""The benchmark's own tests (run with `python -m pytest portbench/tests`).

A test that needs a CUDA card carries the `card` marker and decides
inside itself whether there is one, skipping with a reason where there
is none. The rest run on the CPU, the port on device="cpu", at scales
far below the configurations'.
"""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small scales at which the CPU runs a query in milliseconds
SMALL = {"tpch-sf10": 0.005, "ssb-sf20": 0.01}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips with a reason without one")


def small_cell(workload: str):
    """The cell of BENCHMARK.json, its configuration cut to SMALL."""
    from portbench.harness.spec import load_cell
    cell = load_cell(workload)
    cell.config = dict(cell.config, scale_factor=SMALL[cell.config["name"]])
    return cell


@pytest.fixture
def workloads():
    return [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
