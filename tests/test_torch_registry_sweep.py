"""The registry-wide parity sweep (tests/torch_registry_sweep.py), its
one-argument inputs: every function that both default registries
register and that takes one argument, on each input class of UNARY,
through both packages' `call_function` on the CPU. The two- and
three-argument inputs and the direct calls on a Table are in
test_torch_registry_sweep_pairs.py."""
import re

import pytest

from torch_registry_sweep import (CASES, EXEMPT, NAMES, UNARY, check_case,
                                  inputs_of)


def test_the_sweep_covers_every_function_both_registries_register():
    assert len(NAMES) >= 166
    assert all(inputs_of(n) for n in NAMES)


def test_every_exempt_entry_is_a_case_and_names_its_pr():
    cases = set(CASES)
    for key, dev in EXEMPT.items():
        assert key in cases, key
        assert re.search(r"\bPRs? \d+", dev.reason), key


ONE_ARG = [(n, k) for n, k in CASES if k in UNARY]


@pytest.mark.parametrize("name,key", ONE_ARG,
                         ids=[f"{n}-{k}" for n, k in ONE_ARG])
def test_registry_function_matches_jax(name, key):
    check_case(name, key)
