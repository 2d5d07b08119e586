"""On the card: one short run of each cell through the command, its
result correct and on the GPU. Skips without a card; run it there with
`python -m pytest portbench/tests -m card`."""
import json
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT


def _card_count():
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_cells_on_the_card(workloads, trace):
    if _card_count() < 1:
        pytest.skip("no CUDA card on this machine")
    for w in workloads:
        r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            w, "--seed", "2147483659", "--seconds", "3",
                            "--trace", str(trace)], capture_output=True,
                           text=True, cwd=ROOT, timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert line["correct"] is True, line["checks"]
        assert line["device"]["platform"] == "gpu"
