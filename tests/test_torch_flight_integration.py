"""The 13 Flight integration scenarios
(arrow_go_tpu_torch/flight/integration.py), the two FlightSQL ones
included: each port to port, then crossed with the JAX runner both ways
(the JAX server with the port's client, the port's server with the JAX
client), and the CLI's server in a subprocess driven by the port's
client."""
import os
import select
import subprocess
import sys

import pytest

from arrow_go_tpu_torch.flight import integration as tfi

NAMES = sorted(tfi.SCENARIOS)


def test_the_ported_scenarios():
    """Every JAX scenario, the FlightSQL ones included, is ported."""
    grpc = pytest.importorskip("grpc")  # noqa: F841
    from arrow_go_tpu.flight import integration as jfi
    assert len(NAMES) == 13
    assert set(NAMES) == set(jfi.SCENARIOS)
    assert {"flight_sql", "flight_sql:ingestion"} <= set(NAMES)
    with pytest.raises(KeyError, match="no flight integration scenario"):
        tfi.scenario("flight_sql:nope")


@pytest.mark.parametrize("name", NAMES)
def test_port_to_port(name):
    tfi.run_scenario_inprocess(name)


@pytest.mark.parametrize("name", NAMES)
def test_jax_server_port_client(name):
    pytest.importorskip("grpc")
    from arrow_go_tpu.flight import integration as jfi
    srv = jfi.run_scenario_server(name, block=False)
    try:
        tfi.run_scenario_client(name, f"grpc://localhost:{srv.port}")
    finally:
        srv.shutdown()


@pytest.mark.parametrize("name", NAMES)
def test_port_server_jax_client(name):
    pytest.importorskip("grpc")
    from arrow_go_tpu.flight import integration as jfi
    srv = tfi.run_scenario_server(name, block=False)
    try:
        jfi.run_scenario_client(name, f"grpc://localhost:{srv.port}")
    finally:
        srv.shutdown()


def test_cli_server_in_a_process():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen(
        [sys.executable, "-m", "arrow_go_tpu_torch.cli",
         "flight-integration", "server", "--scenario", "ordered"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert select.select([p.stdout], [], [], 60)[0], "no server line"
        line = p.stdout.readline()
        assert "serving on port" in line, (line, p.stderr.read()
                                           if p.poll() is not None else "")
        port = int(line.rsplit(" ", 1)[1])
        tfi.run_scenario_client("ordered", f"grpc://127.0.0.1:{port}")
    finally:
        p.kill()
        p.communicate(timeout=30)
