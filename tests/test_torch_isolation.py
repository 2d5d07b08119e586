"""The port stands alone: it imports neither JAX nor the JAX package (nor
its native codec library) nor pyarrow nor zstandard nor triton, and it
never moves to the CPU unless asked."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import arrow_go_tpu_torch
from arrow_go_tpu_torch import torchenv
from arrow_go_tpu_torch.device.block import batch_to_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(arrow_go_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "arrow_go_tpu", "arrow_go_tpu.native", "pyarrow",
             "zstandard", "triton")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, arrow_go_tpu_torch, arrow_go_tpu_torch.compute\n"
            "import arrow_go_tpu_torch.parquet\n"
            "import arrow_go_tpu_torch.ops.reductions\n"
            f"bad = [m for m in sys.modules if m in {FORBIDDEN!r}"
            f" or m.startswith({tuple(f + '.' for f in FORBIDDEN)!r})]\n"
            "print(repr(bad))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PKG.rglob("*.py"))
    + [ROOT / "chip_smoke.py"]))
def test_no_forbidden_module_level_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torchenv.device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_to_device({"a": np.arange(10)})
    db = batch_to_device({"a": np.arange(10)}, device="cpu")
    assert db.column("a").values.device.type == "cpu"


def test_wrappers_take_the_plain_version_only_on_cpu():
    from arrow_go_tpu_torch.ops import compaction, reductions, scan
    kernels = (compaction.compact_flagged, scan.cummax_u64_lanes,
               reductions.reduce)
    before = [k.launches for k in kernels]
    keep = torch.tensor([True, False, True])
    assert compaction.compact_flagged(keep, (torch.arange(3),))[0].tolist() \
        == [0, 2, 1]
    x = torch.tensor([3, 1, 2])
    assert scan.cummax_u64_lanes(x, [x])[1].tolist() == [3, 3, 3]
    assert reductions.reduce(x, None, 2, "sum").item() == 4
    assert [k.launches for k in kernels] == before


def test_scan_runs_on_the_card_unless_asked(monkeypatch):
    import io
    from arrow_go_tpu_torch import parquet as tpq
    buf = io.BytesIO()
    tpq.write_table({"a": np.arange(10)}, buf)
    pf = tpq.ParquetFile(buf.getvalue())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpq.read_batch_device(pf, 0)
    db = tpq.read_batch_device(pf, 0, device="cpu")
    assert db.column("a").values[:10].tolist() == list(range(10))
