"""The port's multi-process tier: `multiproc.launch` starts two workers
of `python -m arrow_go_tpu_torch.parallel.multiproc_worker` on the CPU,
joined by a gloo process group over localhost, and each checks the
tier's five workloads against numpy (the checks of ci/multiproc_worker.py,
which tests/test_multiproc.py runs for the JAX package)."""
import json

from arrow_go_tpu_torch.parallel import multiproc


def test_two_process_distributed_tier():
    done = multiproc.launch("arrow_go_tpu_torch.parallel.multiproc_worker",
                            2, ["--rows", "8192", "--device", "cpu"],
                            timeout=300, capture=True)
    line = [ln for ln in done[0].stdout.splitlines()
            if ln.startswith('{"multiproc"')][-1]
    res = json.loads(line)["multiproc"]
    assert res["ok"] and res["processes"] == 2
    assert res["backend"] == "gloo"
    assert set(res["checks"]) == {"group_by", "join_multikey",
                                  "join_zipf_hotkey", "sort_multikey",
                                  "streamed_shuffle"}
