"""The control: the plain reference in the next lower precision than the
configuration states (float32 for float64 money; int32 for int64 sums)
put in the program's place must come out not correct, while the program
comes out correct on the same tables. `portbench/control.py` reads the
same on the card at the cells' own sizes; here at small sizes, so the
int32 sums of SSB overflow only where its sums pass 2**31."""
import pytest

from portbench import control
from portbench.tests.conftest import small_cell


def _failed(checks):
    return any(c["value"] > c["limit"] for c in checks.values())


@pytest.mark.parametrize("workload", ["tpch-sf10.join", "tpch-sf10.agg",
                                      "ssb-sf20.star"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11, 12345678901])
def test_control_is_not_correct(workload, seed):
    r = control.readings(small_cell(workload), seed, "cpu")
    assert _failed(r["control"]), r
    assert not _failed(r["program"]), r

