"""The JAX package's own test files, share 2 of 3, run against the port
(tests/torch_jax_suite.py): every case passes there but those EXPECTED
lists, each with its reason."""
import pytest

import torch_jax_suite as suite

FILES = suite.shard(1, 3)


@pytest.fixture(scope="module")
def outcome(tmp_path_factory):
    return suite.run_files(FILES, tmp_path_factory.mktemp("jax_suite"))


@pytest.mark.parametrize("name", FILES)
def test_the_jax_file_runs_on_the_port(name, outcome):
    suite.check(name, outcome[name])
