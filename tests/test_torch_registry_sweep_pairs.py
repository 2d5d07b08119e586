"""The registry-wide parity sweep (tests/torch_registry_sweep.py), its
two- and three-argument inputs (PAIRS, TRIPLES) through both packages'
`call_function` on the CPU, and the direct compute calls on a
two-chunk Table (TABLE_CALLS)."""
import pytest

from torch_registry_sweep import (CASES, TABLE_CALLS, UNARY, check_case,
                                  check_table_call)

MORE_ARGS = [(n, k) for n, k in CASES if k not in UNARY]


@pytest.mark.parametrize("name,key", MORE_ARGS,
                         ids=[f"{n}-{k}" for n, k in MORE_ARGS])
def test_registry_function_matches_jax(name, key):
    check_case(name, key)


@pytest.mark.parametrize("name", list(TABLE_CALLS))
def test_direct_call_on_a_table_matches_jax(name):
    check_table_call(name)
