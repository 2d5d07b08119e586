"""The result line and the command's refusal without a card."""
import json
import os
import subprocess
import sys

import pytest

from portbench.harness import cell as runner
from portbench.tests.conftest import ROOT, small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_keys(trace, capsys):
    c = small_cell("tpch-sf10.join")
    out = runner.run_cell(c, 2 ** 31 + 3, 0.6, bool(trace), device="cpu")
    runner.emit(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert all(k in line for k in KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in line["device"]
    names = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == names
    last = captured.err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") for s in last)
    for name, chk in line["checks"].items():
        assert set(chk) == {"value", "limit"}


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "tpch-sf10.join", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, env=env, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_command_refuses_outside_a_checkout(tmp_path):
    """Only BENCHMARK.json and portbench/: the port is not there."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "tpch-sf10.join", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "arrow_go_tpu_torch" in r.stderr


def test_benchmark_json_names():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [m["name"] for m in b["end_to_end"]] == [
        "queries_per_s", "query_ms_p95", "query_ms_geomean", "setup_s"]
    assert [m["name"] for m in b["per_layer"]] == [
        "hash_join_ms_per_query", "group_by_ms_per_query",
        "sort_device_ms_per_query", "k1_roofline_share",
        "device_idle_share"]
    assert all(m["moves"] == "queries_per_s" for m in b["per_layer"])
    assert all(w["chips"] == 1 for w in b["workloads"])
    for m in b["end_to_end"]:
        assert (ROOT / "portbench" / "e2e_metrics" / f"{m['name']}.py"
                ).exists()
    for m in b["per_layer"]:
        assert (ROOT / "portbench" / "layer_metrics" / f"{m['name']}.py"
                ).exists()
