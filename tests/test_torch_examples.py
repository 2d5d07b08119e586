"""The port's example programs against the JAX package's:
examples/torch_end_to_end.py prints every value examples/end_to_end.py
prints (the parquet and IPC byte sizes aside: the port's writers
differ, ROADMAP §3) and returns them; examples/torch_distributed_query.py at 4 gloo
ranks prints the lines examples/distributed_query.py prints on a
4-device CPU mesh (the mesh line aside); both at one rank in this
process give the values of chip_smoke.py's numpy oracles."""
import os
import pathlib
import re
import subprocess
import sys
import tempfile

import pytest

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
BYTES = re.compile(r"(wrote|\() ?\d+ bytes")


def _lines(text: str) -> list:
    """The printed lines, byte sizes blanked."""
    return [BYTES.sub(r"\1 N bytes", ln) for ln in text.splitlines()
            if ln.strip()]


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    """(the JAX demo's printed text, the port demo's printed text and
    returned values), each main() at its default size."""
    import io
    from contextlib import redirect_stdout
    jax_demo = chip_smoke._example("end_to_end")
    port_demo = chip_smoke._example("torch_end_to_end")
    root = tmp_path_factory.mktemp("jax_demo")
    with pytest.MonkeyPatch.context() as mp:     # the JAX demo's directory
        mp.setattr(tempfile, "mkdtemp", lambda prefix="": str(root))
        with redirect_stdout(io.StringIO()) as jout:
            jax_demo.main()
    with redirect_stdout(io.StringIO()) as tout:
        got = port_demo.main(device="cpu")
    return jout.getvalue(), tout.getvalue(), got


def test_end_to_end_prints_the_jax_demos_values(demos):
    jax_text, port_text, _ = demos
    want, got = _lines(jax_text), _lines(port_text)
    assert len(want) == 10 and want[-1] == "END-TO-END OK"
    assert got == want
    # the two lines that differ, they differ only by their byte counts
    assert sum(BYTES.search(ln) is not None
               for ln in port_text.splitlines()) == 2


def test_end_to_end_returns_what_it_prints(demos):
    _, text, got = demos
    lines = text.splitlines()
    assert f"[csv] {got['csv_rows']} rows, schema {got['csv_names']}" \
        in lines
    assert f"[parquet] wrote {got['parquet_bytes']} bytes, " \
        f"{got['row_groups']} row groups" in lines
    assert f"[group_by] {got['group_by']}" in lines
    assert f"[join+sort] {got['ranked']}" in lines
    assert f"[ipc] zstd file roundtrip ok ({got['ipc_bytes']} bytes)" \
        in lines
    assert f"[flightsql] top region: {got['top_region']}" in lines
    # every printed value is chip_smoke.py's numpy oracle's
    chip_smoke.check_end_to_end(got, chip_smoke.end_to_end_oracle(1000))
    assert set(got["stage_s"]) == {"csv", "parquet", "scan", "device scan",
                                   "group_by", "join+sort", "ipc", "flight",
                                   "flightsql"}


def _run(cmd, env_extra) -> str:
    env = dict(os.environ, **env_extra)
    paths = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + paths)
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


def test_distributed_query_prints_the_jax_scripts_lines():
    want = _run([sys.executable, str(EXAMPLES / "distributed_query.py")],
                {"JAX_PLATFORMS": "cpu",
                 "XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    got = _run([sys.executable, str(EXAMPLES / "torch_distributed_query.py"),
                "--device", "cpu", "--processes", "4"],
               {"OMP_NUM_THREADS": "1"})
    want, got = want.splitlines(), got.splitlines()
    assert want[0] == "mesh: 4 devices (cpu)"
    assert got[0] == "mesh: 4 ranks (cpu, gloo)"
    assert len(want) == 7
    assert got[1:] == want[1:]


def test_distributed_query_at_one_rank_matches_numpy(capsys):
    mod = chip_smoke._example("torch_distributed_query")
    got = mod.run(device="cpu")
    want = chip_smoke.distributed_oracle(mod)
    assert got == want
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "mesh: 1 ranks (cpu, gloo)"
    assert out[-1] == f"string 2-key group-by: {want['string_groups']} groups"
