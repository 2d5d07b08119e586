"""The JAX package's own test files, share 1 of 3, run against the port
(tests/torch_jax_suite.py): every case passes there but those EXPECTED
lists, each with its reason."""
import pytest

import torch_jax_suite as suite

FILES = suite.shard(0, 3)


@pytest.fixture(scope="module")
def outcome(tmp_path_factory):
    return suite.run_files(FILES, tmp_path_factory.mktemp("jax_suite"))


@pytest.mark.parametrize("name", FILES)
def test_the_jax_file_runs_on_the_port(name, outcome):
    suite.check(name, outcome[name])


def test_every_jax_test_file_is_run_or_listed():
    files = suite.jax_test_files()
    assert len(files) >= 35
    assert set(suite.WHOLE_FILE) <= set(files)
    shares = [suite.shard(i, 3) for i in range(3)]
    run = [f for s in shares for f in s]
    assert sorted(run + list(suite.WHOLE_FILE)) == files
    assert set(suite.EXPECTED) <= set(run)


def test_every_listed_case_has_a_reason_of_the_four_kinds():
    kinds = (suite.JAX_ARRAYS, "a module replaced on purpose: ",
             "a private name: ", "a deviation: ROADMAP.md section 3, ")
    for reasons in (suite.WHOLE_FILE, *suite.EXPECTED.values()):
        for case, why in reasons.items():
            assert why.startswith(kinds), (case, why)


def test_the_rewrite_touches_module_references_only():
    src = ('import arrow_go_tpu as agt\nfrom arrow_go_tpu import ipc\n'
           'from arrow_go_tpu.compute import cast\n'
           'x = "arrow_go_tpu.parquet"\ny = "arrow_go_tpu sqlite example"\n'
           'import arrow_go_tpu_torch\n')
    assert suite.rewrite(src) == (
        'import arrow_go_tpu_torch as agt\nfrom arrow_go_tpu_torch import '
        'ipc\nfrom arrow_go_tpu_torch.compute import cast\n'
        'x = "arrow_go_tpu_torch.parquet"\n'
        'y = "arrow_go_tpu sqlite example"\nimport arrow_go_tpu_torch\n')
