"""A run with the timed path broken underneath comes out not correct:
once for each fault a query stream can have. (A cell of one chip has no
exchange between chips to leave out.)"""
import pytest

import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch.device import DeviceBatch
from portbench.harness import cell as runner
from portbench.tests.conftest import small_cell

CELLS = ["tpch-sf10.join", "tpch-sf10.agg", "ssb-sf20.star"]


def _run(workload, **kw):
    return runner.run_cell(small_cell(workload), 2 ** 31 + 1, 0.5, False,
                           device="cpu", **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_half_the_rows_left_out(workload, monkeypatch):
    """Every filter keeps only the first half of the rows it keeps."""
    real = pc.filter

    def halved(batch, mask, *a, **kw):
        out = real(batch, mask, *a, **kw)
        if isinstance(out, DeviceBatch):
            return DeviceBatch(out.schema, out.columns, out.length // 2)
        return out

    monkeypatch.setattr(pc, "filter", halved)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_state_returned_unchanged(workload):
    """Each query answers with its first answer, whatever its set."""
    def stale(run_query):
        first = {}

        def call(q, k):
            if q not in first:
                first[q] = run_query(q, k)
            return first[q]
        return call

    assert _run(workload, wrap_query=stale)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_where_produced(workload):
    """One number of every answer changed by one unit in its last place
    of interest: an integer by 1, a float by a millionth."""
    def altered(run_query):
        def call(q, k):
            out = run_query(q, k)
            d = out.to_pydict() if hasattr(out, "to_pydict") else dict(out)
            name = list(d)[-1]
            v = d[name]
            vals = list(v) if isinstance(v, list) else [v]
            if vals:
                x = vals[0]
                vals[0] = x + 1 if isinstance(x, int) else x * (1 + 1e-6)
            d[name] = vals
            return d
        return call

    assert _run(workload, wrap_query=altered)["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_a_failing_query_is_missing(workload):
    """Every query raises once set-up has warmed it."""
    def failing(run_query):
        warmed = set()

        def call(q, k):
            if (q, k) in warmed:
                raise RuntimeError("planted")
            warmed.add((q, k))
            return run_query(q, k)
        return call

    out = _run(workload, wrap_query=failing)
    assert out["correct"] is False and out["failed"] == out["attempted"]
