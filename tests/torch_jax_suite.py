"""Run the JAX package's own test files against the port.

Each JAX test file in `tests/` (a `test_*.py` without `torch` in its
name) is copied with `tests/fixtures.py` into a temporary directory,
`arrow_go_tpu` is rewritten to `arrow_go_tpu_torch` in its imports and
module references, and a `conftest.py` maps the port's default device to
the CPU (`torchenv.device`, as the port's own tests do with
`monkeypatch`) before the port is imported. The file then runs in a
`python -m pytest` subprocess under its own timeout, and the ids of the
cases that fail or error are held against `EXPECTED`: every entry there
is a case the port answers differently on purpose, with its reason. A
case that fails and is not listed fails the check, and so does a listed
case that now passes.

`WHOLE_FILE` lists the files that cannot run against the port at all.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent

# Reasons, one of four kinds.
JAX_ARRAYS = "feeds jax arrays to ops"


def replaced(what: str) -> str:
    return f"a module replaced on purpose: {what}"


def private(name: str) -> str:
    return f"a private name: {name}"


def deviation(entry: str) -> str:
    return f"a deviation: ROADMAP.md section 3, {entry}"


WHOLE_FILE = {
    "test_compaction.py": JAX_ARRAYS
    + " (ops.compaction's Pallas stitch on jax.numpy inputs; the port's K1 "
    "is held against the JAX one in test_torch_kernels.py)",
    "test_device_decode.py": JAX_ARRAYS
    + " (the JAX device decoders on jax.numpy pages; the port's are held "
    "against them in test_torch_decode.py)",
    "test_parallel.py": replaced(
        "parallel/ on torch.distributed, one process per card "
        "(test_torch_dist_*.py hold it against the JAX mesh)"),
    "test_dist_generalized.py": replaced(
        "parallel/ on torch.distributed, one process per card "
        "(test_torch_dist_*.py)"),
    "test_multiproc.py": replaced(
        "parallel.multiproc on torch.distributed, driven by ci/ scripts of "
        "the JAX package (test_torch_multiproc.py)"),
    "test_bench_harness.py": replaced(
        "the JAX benchmark harness, bench.py, which the port does not carry"),
}

_NESTED_FILTER = deviation(
    "PR 11: the port's DeviceBatch filter takes a batch with HostColumns "
    "(nested columns) and filters them on the host; the JAX one refuses it")
_PLAIN_STRINGS = deviation(
    "PR 24: the port's device read takes PLAIN string pages (decoded on the "
    "host into first-occurrence codes); the JAX one refuses them")
_PB2 = replaced("flight.Flight_pb2 (protobuf) by flight.messages")
_SQL_PB2 = replaced("flight.FlightSql_pb2 (protobuf) by flight.sql_messages")
_GRPC = replaced("grpc by flight.rpc: a failed call raises "
                 "flight.rpc.RpcError, not grpc.RpcError")
_FFI = replaced("cdata's cffi handle (cdata.ffi) by ctypes")
_JAXENV = replaced("jaxenv by torchenv (utils.memwatch reads torch.cuda)")

# file -> {test id (a class's cases as Class::name; parameters in
# brackets) -> reason}
EXPECTED: dict[str, dict[str, str]] = {
    "test_device_ops.py": {
        'test_bitmap_words_roundtrip': JAX_ARRAYS,
        'test_device_list_column_take_filter': JAX_ARRAYS,
        'test_f64_bits_arithmetic_matches_bitcast':
            private("ops.sort._f64_bits_arith"),
        'test_filter_indices': JAX_ARRAYS,
        'test_filter_indices_with_null_mask': JAX_ARRAYS,
        'test_gather_and_take_validity': JAX_ARRAYS,
        'test_hashtable_group_sum': JAX_ARRAYS,
        'test_hashtable_high_load': JAX_ARRAYS,
        'test_hashtable_probe': JAX_ARRAYS,
        'test_reduction_no_validity[pallas]': JAX_ARRAYS,
        'test_reduction_no_validity[xla]': JAX_ARRAYS,
        'test_reductions_parity[pallas-float32-max]': JAX_ARRAYS,
        'test_reductions_parity[pallas-float32-min]': JAX_ARRAYS,
        'test_reductions_parity[pallas-float32-sum]': JAX_ARRAYS,
        'test_reductions_parity[pallas-float64-max]': JAX_ARRAYS,
        'test_reductions_parity[pallas-float64-min]': JAX_ARRAYS,
        'test_reductions_parity[pallas-float64-sum]': JAX_ARRAYS,
        'test_reductions_parity[pallas-int32-max]': JAX_ARRAYS,
        'test_reductions_parity[pallas-int32-min]': JAX_ARRAYS,
        'test_reductions_parity[pallas-int32-sum]': JAX_ARRAYS,
        'test_reductions_parity[pallas-int64-max]': JAX_ARRAYS,
        'test_reductions_parity[pallas-int64-min]': JAX_ARRAYS,
        'test_reductions_parity[pallas-int64-sum]': JAX_ARRAYS,
        'test_reductions_parity[pallas-uint32-max]': JAX_ARRAYS,
        'test_reductions_parity[pallas-uint32-min]': JAX_ARRAYS,
        'test_reductions_parity[pallas-uint32-sum]': JAX_ARRAYS,
        'test_reductions_parity[xla-float32-max]': JAX_ARRAYS,
        'test_reductions_parity[xla-float32-min]': JAX_ARRAYS,
        'test_reductions_parity[xla-float32-sum]': JAX_ARRAYS,
        'test_reductions_parity[xla-float64-max]': JAX_ARRAYS,
        'test_reductions_parity[xla-float64-min]': JAX_ARRAYS,
        'test_reductions_parity[xla-float64-sum]': JAX_ARRAYS,
        'test_reductions_parity[xla-int32-max]': JAX_ARRAYS,
        'test_reductions_parity[xla-int32-min]': JAX_ARRAYS,
        'test_reductions_parity[xla-int32-sum]': JAX_ARRAYS,
        'test_reductions_parity[xla-int64-max]': JAX_ARRAYS,
        'test_reductions_parity[xla-int64-min]': JAX_ARRAYS,
        'test_reductions_parity[xla-int64-sum]': JAX_ARRAYS,
        'test_reductions_parity[xla-uint32-max]': JAX_ARRAYS,
        'test_reductions_parity[xla-uint32-min]': JAX_ARRAYS,
        'test_reductions_parity[xla-uint32-sum]': JAX_ARRAYS,
        'test_take_bounds_check': JAX_ARRAYS,
    },
    "test_device_pipeline.py": {
        'test_device_batch_filter_rejects_nested': _NESTED_FILTER,
    },
    "test_extensions.py": {
        'test_opaque_metadata_roundtrip': private("Array._data"),
        'test_uuid_ipc_roundtrip': private("Array._data"),
    },
    "test_flight.py": {
        'test_cancel_and_renew_actions': _PB2,
        'test_session_options_actions': _PB2,
        'test_unimplemented_action_raises': _GRPC,
    },
    "test_flightsql.py": {
        'test_bad_sql_raises': _GRPC,
        'test_cancel_query_action': _SQL_PB2,
        'test_tables_with_included_schema': _SQL_PB2,
    },
    "test_ipc.py": {
        'test_big_endian_file_roundtrip': private("FileReader._swap"),
        'test_big_endian_stream_roundtrip': private("StreamReader._swap"),
    },
    "test_misc_components.py": {
        'test_cdata_pyarrow_interop[vals0-typ0]': _FFI,
        'test_cdata_pyarrow_interop[vals1-typ1]': _FFI,
        'test_cdata_pyarrow_interop[vals2-typ2]': _FFI,
        'test_cdata_pyarrow_interop[vals3-typ3]': _FFI,
        'test_cdata_pyarrow_interop[vals4-typ4]': _FFI,
        'test_cdata_pyarrow_interop[vals5-typ5]': _FFI,
        'test_cdata_roundtrip_ours': _FFI,
        'test_device_memory_watcher': _JAXENV,
        'test_device_memory_watcher_detects_leak': _JAXENV,
    },
    "test_parquet.py": {
        'test_codecs_both_directions[brotli]':
            private("parquet.compress._brotli_backend"),
    },
    "test_parquet_device_read.py": {
        'test_device_read_unsupported_falls_through': _PLAIN_STRINGS,
    },
    "test_parquet_properties.py": {
        'test_adaptive_bloom_filter_sizes_to_ndv':
            private("parquet.bloom._hash_value"),
    },
    "test_view_types.py": {
        'test_factorize_long_strings_vectorized':
            private("device.block._factorize_binary"),
        'test_factorize_view_types_no_row_loop':
            private("device.block._factorize_binary"),
    },
}

# a module reference: `import arrow_go_tpu`, `from arrow_go_tpu ...` or a
# dotted path (in code or in a string); not prose such as a server name
_WORD = re.compile(r"(?:(?<=import )|(?<=from ))arrow_go_tpu\b|"
                   r"\barrow_go_tpu(?=\.)")

_CONFTEST = '''\
import os

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest

from arrow_go_tpu_torch import torchenv

_card = torchenv.device


def _cpu(dev=None):
    return _card("cpu" if dev is None else dev)


torchenv.device = _cpu


@pytest.fixture
def rng():
    return np.random.default_rng(42)
'''


def jax_test_files() -> list[str]:
    """Every JAX test file in tests/, by name."""
    return sorted(p.name for p in TESTS.glob("test_*.py")
                  if "torch" not in p.name)


def rewrite(src: str) -> str:
    """The JAX test's source with the port in place of the JAX package."""
    return _WORD.sub("arrow_go_tpu_torch", src)


def run_files(names: list, workdir: Path, timeout: float = 600.0) -> dict:
    """Run JAX test files against the port, in one pytest process; the
    outcome of each case, by file: {file: {"passed": set, "failed":
    {id: message}, "skipped": set}}."""
    d = workdir / "suite"
    d.mkdir(parents=True, exist_ok=True)
    (d / "conftest.py").write_text(_CONFTEST)
    (d / "fixtures.py").write_text(rewrite(
        (TESTS / "fixtures.py").read_text()))
    for name in names:
        (d / name).write_text(rewrite((TESTS / name).read_text()))
    xml = workdir / "junit.xml"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env["JAX_PLATFORMS"] = "cpu"
    cmd = [sys.executable, "-m", "pytest", *names, "-q", "-m", "not slow",
           "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist",
           "--rootdir", str(d), "-o", "addopts=", f"--junitxml={xml}"]
    proc = subprocess.run(cmd, cwd=d, env=env, capture_output=True,
                          text=True, timeout=timeout)
    if not xml.exists():
        raise AssertionError(
            f"pytest wrote no report (rc {proc.returncode})\n"
            f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    out = {name: {"passed": set(), "failed": {}, "skipped": set()}
           for name in names}
    for case in ET.parse(xml).getroot().iter("testcase"):
        module, _, cls = case.get("classname", "").partition(".")
        res = out.get(module + ".py")
        if res is None:
            raise AssertionError(f"a case of no file asked for: "
                                 f"{case.get('classname')}")
        cid = f"{cls}::{case.get('name')}" if cls else case.get("name")
        bad = case.find("failure")
        if bad is None:
            bad = case.find("error")
        if bad is not None:
            res["failed"][cid] = (bad.get("message") or "")[:300]
        elif case.find("skipped") is not None:
            res["skipped"].add(cid)
        else:
            res["passed"].add(cid)
    return out


def check(name: str, res: dict) -> None:
    """Hold one file's outcome to EXPECTED: every failing case listed,
    every listed case failing."""
    want = EXPECTED.get(name, {})
    unlisted = {k: v for k, v in res["failed"].items() if k not in want}
    fixed = sorted(k for k in want if k in res["passed"])
    missing = sorted(k for k in want
                     if k not in res["failed"] and k not in res["passed"])
    problems = []
    if unlisted:
        problems.append("failed and not in EXPECTED:\n" + "\n".join(
            f"  {k}: {v}" for k, v in sorted(unlisted.items())))
    if fixed:
        problems.append("in EXPECTED but passes now (take it out):\n"
                        + "\n".join(f"  {k}" for k in fixed))
    if missing:
        problems.append("in EXPECTED but not run:\n"
                        + "\n".join(f"  {k}" for k in missing))
    assert not problems, f"{name}:\n" + "\n".join(problems)


def shard(i: int, n: int) -> list[str]:
    """The i-th of n shares of the runnable JAX test files."""
    files = [f for f in jax_test_files() if f not in WHOLE_FILE]
    return files[i::n]


if __name__ == "__main__":
    # python tests/torch_jax_suite.py: every runnable file in one process,
    # with the counts the harness's tests hold
    import tempfile
    files = [f for f in jax_test_files() if f not in WHOLE_FILE]
    with tempfile.TemporaryDirectory() as tmp:
        outcome = run_files(files, Path(tmp))
    for f in files:
        r = outcome[f]
        print(f"{f}: {len(r['passed'])} passed, {len(r['failed'])} failed, "
              f"{len(r['skipped'])} skipped")
    print("passed", sum(len(r["passed"]) for r in outcome.values()),
          "failed", sum(len(r["failed"]) for r in outcome.values()),
          "listed", sum(len(v) for v in EXPECTED.values()))
