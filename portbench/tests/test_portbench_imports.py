"""What the benchmark loads: never JAX or the JAX package (compared by
whole top-level names: arrow_go_tpu_torch is not arrow_go_tpu), no
reference that imports the port, nothing from benchmarks/."""
import ast
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

PORTBENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "arrow_go_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


SOURCES = sorted(p for p in PORTBENCH.rglob("*.py")
                 if "tests" not in p.relative_to(PORTBENCH).parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN


REFS = sorted((PORTBENCH / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFS,
                         ids=[str(p.relative_to(ROOT)) for p in REFS])
def test_reference_imports_nothing_of_the_port(path):
    for m in _imports(path):
        top = m.split(".")[0]
        assert top != "arrow_go_tpu_torch", m
        if top == "portbench":
            assert m.startswith("portbench.reference"), m


def test_nothing_reads_the_jax_benchmarks():
    for p in SOURCES:
        text = p.read_text()
        for name in ("benchmarks/", "bench.py", "BENCH_"):
            assert name not in text, (p, name)


def test_a_run_loads_no_jax_module():
    """A whole run on the CPU in a fresh process, then sys.modules."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.tests.conftest import small_cell\n"
        "from portbench.harness import cell as c\n"
        "out = c.run_cell(small_cell('tpch-sf10.join'), 5, 0.3, False, "
        "device='cpu')\n"
        "assert out is not None and out['correct'], out\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "arrow_go_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench.harness import cell
    monkeypatch.setitem(sys.modules, "arrow_go_tpu_torchx", sys)
    assert "arrow_go_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "arrow_go_tpu.compute", sys)
    assert "arrow_go_tpu" in cell.forbidden_modules()


@pytest.mark.parametrize("stage", ["references", "metric readers"])
def test_a_module_loaded_after_the_window_withholds_the_result(
        stage, monkeypatch):
    """The check runs last: a reference or a metric reader that loads
    the JAX package still leaves the run without a result."""
    import types

    from portbench.harness import cell as runner
    from portbench.tests.conftest import small_cell

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    c = small_cell("tpch-sf10.join")
    if stage == "references":
        refs = c.references

        def references():
            load_jax()
            return refs()
        monkeypatch.setattr(c, "references", references)
    else:
        read = runner._read

        def _read(*a):
            load_jax()
            return read(*a)
        monkeypatch.setattr(runner, "_read", _read)
    assert runner.run_cell(c, 7, 0.3, False, device="cpu") is None
