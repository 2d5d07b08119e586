"""The port stands alone: it imports neither JAX nor the JAX package (nor
its native codec library, nor its ci/ workers) nor pyarrow nor zstandard
nor xxhash nor flatbuffers nor triton nor cffi nor protobuf nor grpc nor
h2 nor hpack (its Flight runs on its own gRPC with those blocked), its own
codec library is built from its own source with no switch or fallback,
and it never moves to the CPU unless asked."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import arrow_go_tpu_torch
from arrow_go_tpu_torch import torchenv
from arrow_go_tpu_torch.device.block import batch_to_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(arrow_go_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "arrow_go_tpu", "arrow_go_tpu.native", "pyarrow",
             "zstandard", "xxhash", "triton", "ci", "flatbuffers", "cffi",
             "google.protobuf", "cryptography", "grpc", "h2", "hpack")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, arrow_go_tpu_torch, arrow_go_tpu_torch.compute\n"
            "import arrow_go_tpu_torch.parquet\n"
            "import arrow_go_tpu_torch.ops.reductions\n"
            "import arrow_go_tpu_torch.native as native\n"
            "import arrow_go_tpu_torch.compute.groupby\n"
            "import arrow_go_tpu_torch.compute.join\n"
            "import arrow_go_tpu_torch.ops.hashing\n"
            "import arrow_go_tpu_torch.parquet.device_read\n"
            "import arrow_go_tpu_torch.compute.cast\n"
            "import arrow_go_tpu_torch.compute.temporal\n"
            "import arrow_go_tpu_torch.compute.registry\n"
            "import arrow_go_tpu_torch.ops.convert\n"
            "import arrow_go_tpu_torch.ops.decimal\n"
            "import arrow_go_tpu_torch.ops.decode\n"
            "import arrow_go_tpu_torch.parquet.writer\n"
            "import arrow_go_tpu_torch.parquet.bloom\n"
            "import arrow_go_tpu_torch.dataset\n"
            "import arrow_go_tpu_torch.parallel\n"
            "import arrow_go_tpu_torch.parallel.mesh\n"
            "import arrow_go_tpu_torch.parallel.shuffle\n"
            "import arrow_go_tpu_torch.parallel.aggregate\n"
            "import arrow_go_tpu_torch.parallel.join\n"
            "import arrow_go_tpu_torch.parallel.sort\n"
            "import arrow_go_tpu_torch.parallel.dist\n"
            "import arrow_go_tpu_torch.parallel.overlap\n"
            "import arrow_go_tpu_torch.parallel.api\n"
            "import arrow_go_tpu_torch.parallel.multiproc\n"
            "import arrow_go_tpu_torch.parallel.multiproc_worker\n"
            "import arrow_go_tpu_torch.ops.hashtable\n"
            "import arrow_go_tpu_torch.compute.nested_selection\n"
            "import arrow_go_tpu_torch.parquet.levels\n"
            "import arrow_go_tpu_torch.parquet.reader\n"
            "import arrow_go_tpu_torch.compute.run_ends\n"
            "import arrow_go_tpu_torch.compute.scalars\n"
            "import arrow_go_tpu_torch.tensor\n"
            "import arrow_go_tpu_torch.utils\n"
            "import arrow_go_tpu_torch.utils.metrics\n"
            "import arrow_go_tpu_torch.utils.memwatch\n"
            "import arrow_go_tpu_torch.utils.debug\n"
            "import arrow_go_tpu_torch.ipc\n"
            "import arrow_go_tpu_torch.ipc.fb\n"
            "import arrow_go_tpu_torch.ipc.metadata\n"
            "import arrow_go_tpu_torch.ipc.core\n"
            "import arrow_go_tpu_torch.parquet.variant\n"
            "import arrow_go_tpu_torch.extensions\n"
            "import arrow_go_tpu_torch.formats\n"
            "import arrow_go_tpu_torch.formats.csv\n"
            "import arrow_go_tpu_torch.formats.json\n"
            "import arrow_go_tpu_torch.formats.avro\n"
            "import arrow_go_tpu_torch.interop\n"
            "import arrow_go_tpu_torch.interop.protowire\n"
            "import arrow_go_tpu_torch.interop.arrjson\n"
            "import arrow_go_tpu_torch.compute.substrait\n"
            "import arrow_go_tpu_torch.cdata\n"
            "import arrow_go_tpu_torch.parquet.encryption\n"
            "import arrow_go_tpu_torch.parquet.keytools\n"
            "import arrow_go_tpu_torch.cli\n"
            "import arrow_go_tpu_torch.flight\n"
            "import arrow_go_tpu_torch.flight.hpack\n"
            "import arrow_go_tpu_torch.flight.h2\n"
            "import arrow_go_tpu_torch.flight.rpc\n"
            "import arrow_go_tpu_torch.flight.messages\n"
            "import arrow_go_tpu_torch.flight.wire\n"
            "import arrow_go_tpu_torch.flight.service\n"
            "import arrow_go_tpu_torch.flight.session\n"
            "import arrow_go_tpu_torch.flight.integration\n"
            "import arrow_go_tpu_torch.flight.sql_messages\n"
            "import arrow_go_tpu_torch.flight.sql\n"
            "import arrow_go_tpu_torch.flight.dbapi\n"
            "import arrow_go_tpu_torch.array\n"
            "import arrow_go_tpu_torch.array.record\n"
            "import arrow_go_tpu_torch.array.compare\n"
            "import arrow_go_tpu_torch.array.arrays\n"
            "import arrow_go_tpu_torch.interop.pyarrow_interop\n"
            "import arrow_go_tpu_torch.memory\n"
            "import arrow_go_tpu_torch.memory.buffer\n"
            "arrow_go_tpu_torch.interop, arrow_go_tpu_torch.cdata\n"
            "arrow_go_tpu_torch.flight\n"
            "arrow_go_tpu_torch.compute.default_registry()\n"
            f"bad = [m for m in sys.modules if m in {FORBIDDEN!r}"
            f" or m.startswith({tuple(f + '.' for f in FORBIDDEN)!r})]\n"
            "print(repr(bad), native._lib is None)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    # importing the codec loader neither imports the JAX package's
    # native library nor builds or loads its own
    assert r.stdout.strip() == "[] True"


def test_codecs_are_the_ports_own_with_no_switch_or_fallback():
    """csrc/codecs.cc is built from the port's tree alone, and nothing
    turns the library off or swaps in a Python codec."""
    from arrow_go_tpu_torch import native
    assert native.SOURCE.parent == PKG / "csrc"
    text = native.SOURCE.read_text()
    assert "arrow_go_tpu/" not in text.split("//", 1)[0]
    assert all(not ln.lstrip().startswith("#include \"")
               for ln in text.splitlines())
    src = (PKG / "native.py").read_text()
    assert "environ" not in src and "except" not in src


def test_the_scan_reaches_the_new_modules():
    """The AST scan below covers every module of the package, these
    included."""
    scanned = {str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")}
    for mod in ("compute/run_ends.py", "compute/scalars.py", "tensor.py",
                "utils/__init__.py", "utils/metrics.py", "utils/memwatch.py",
                "utils/debug.py", "ipc/__init__.py", "ipc/fb.py",
                "ipc/metadata.py", "ipc/core.py", "parquet/variant.py",
                "formats/__init__.py", "formats/csv.py", "formats/json.py",
                "formats/avro.py", "interop/__init__.py",
                "interop/protowire.py", "interop/arrjson.py",
                "compute/substrait.py", "cdata.py",
                "parquet/encryption.py", "parquet/keytools.py", "cli.py",
                "flight/__init__.py", "flight/hpack.py", "flight/h2.py",
                "flight/rpc.py", "flight/messages.py", "flight/wire.py",
                "flight/service.py", "flight/session.py",
                "flight/integration.py", "flight/sql_messages.py",
                "flight/sql.py", "flight/dbapi.py", "array/__init__.py",
                "array/record.py", "array/compare.py", "array/arrays.py",
                "memory/__init__.py", "memory/buffer.py",
                "interop/pyarrow_interop.py", "array/layout.py",
                "array/builders.py", "array/concat.py",
                "memory/bitutil.py", "device/__init__.py"):
        assert f"arrow_go_tpu_torch/{mod}" in scanned, mod


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PKG.rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "examples" / "torch_end_to_end.py",
       ROOT / "examples" / "torch_distributed_query.py"]))
def test_no_forbidden_module_level_imports(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torchenv.device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_to_device({"a": np.arange(10)})
    db = batch_to_device({"a": np.arange(10)}, device="cpu")
    assert db.column("a").values.device.type == "cpu"


def test_wrappers_take_the_plain_version_only_on_cpu():
    from arrow_go_tpu_torch.ops import compaction, reductions, scan
    from arrow_go_tpu_torch.utils.metrics import metrics
    kernels = ("kernel.K1", "kernel.K2", "kernel.K3")
    before = [metrics.counter(k) for k in kernels]
    keep = torch.tensor([True, False, True])
    assert compaction.compact_flagged(keep, (torch.arange(3),))[0].tolist() \
        == [0, 2, 1]
    x = torch.tensor([3, 1, 2])
    assert scan.cummax_u64_lanes(x, [x])[1].tolist() == [3, 3, 3]
    # K2's hi-only mode, as the join state's fills call it
    assert scan.cummax_u32(torch.tensor([2, 0, 5, 1])).tolist() == \
        [2, 2, 5, 5]
    assert reductions.reduce(x, None, 2, "sum").item() == 4
    # the join's fills (forward, and the reverse fill of a full outer
    # join), its compactions and the first-occurrence fill of an encode
    from arrow_go_tpu_torch import dtypes
    from arrow_go_tpu_torch.ops import hashing
    from arrow_go_tpu_torch.parallel import join
    k = torch.tensor([1, 2, 2, 5])
    ok = torch.tensor([True, True, True, False])
    st = join.join_sorted_state(k, ok, k.flip(0), ok, "full outer")
    assert int(st.total) == 6          # 2 x 2 pairs, two unmatched
    assert join.local_join_semi(k, ok, k[:1], ok[:1], "left semi").tolist() \
        == [True, False, False, False]
    res = hashing.encode_codes(k.flip(0), dtypes.int64, None, 4)
    assert res.codes.tolist() == [0, 1, 1, 2]
    assert [metrics.counter(k) for k in kernels] == before


def test_scan_runs_on_the_card_unless_asked(monkeypatch):
    import io
    from arrow_go_tpu_torch import parquet as tpq
    buf = io.BytesIO()
    tpq.write_table({"a": np.arange(10)}, buf)
    pf = tpq.ParquetFile(buf.getvalue())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpq.read_batch_device(pf, 0)
    db = tpq.read_batch_device(pf, 0, device="cpu")
    assert db.column("a").values[:10].tolist() == list(range(10))


def test_dataset_scan_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    from arrow_go_tpu_torch import parquet as tpq
    from arrow_go_tpu_torch.dataset import dataset
    tpq.write_table({"a": np.arange(10)}, str(tmp_path / "a.parquet"))
    ds = dataset(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(ds.scanner().device_batches())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.to_table()
    db = next(ds.scanner().device_batches(device="cpu"))
    assert db.column("a").values[:10].tolist() == list(range(10))


def test_distributed_tier_runs_on_the_card_unless_asked(monkeypatch):
    """The tier's mesh and its table-level entry points resolve the card
    when no device is named, and starting no process group on the way."""
    import torch.distributed as dist
    from arrow_go_tpu_torch import dtypes as dt, parallel
    from arrow_go_tpu_torch.device.block import HostArray, HostBatch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hb = HostBatch(dt.Schema([dt.Field("k", dt.int64)]),
                   [HostArray(np.arange(4), None, dt.int64)], 4)
    for call in (lambda: parallel.make_mesh(),
                 lambda: parallel.distributed_group_by(hb, "k",
                                                       [("k", "count")]),
                 lambda: parallel.distributed_sort(hb, "k"),
                 lambda: parallel.distributed_hash_join(hb, hb, "k")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not dist.is_initialized()


def test_front_and_utilities_run_on_the_card_unless_asked(monkeypatch):
    """run_end_encode and sort of a host array, a HostBatch expression, a
    scalar's numeric cast, the typed wrappers over host arrays, the
    memory watcher, the trace and Tensor.to_device resolve the card when
    no device is named."""
    import arrow_go_tpu_torch.compute as pc
    from arrow_go_tpu_torch import dtypes
    from arrow_go_tpu_torch.device.block import HostArray, HostBatch
    from arrow_go_tpu_torch.tensor import tensor
    from arrow_go_tpu_torch.utils import DeviceMemoryWatcher, trace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = HostArray(np.arange(5000), None, dtypes.int64)
    hb = HostBatch.from_arrays({"a": a})

    def with_trace():
        with trace():
            pass

    for call in (lambda: pc.run_end_encode(a), lambda: pc.sort(a),
                 lambda: pc.execute_scalar_expression(pc.field("a") > 1, hb),
                 lambda: pc.scalar(5).cast(dtypes.float64),
                 lambda: pc.add(a, 1), lambda: DeviceMemoryWatcher(),
                 with_trace, lambda: tensor(np.eye(2)).to_device()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_formats_run_on_the_card_unless_asked(monkeypatch, tmp_path):
    """The formats read and write on the host and name no device; a csv
    dataset's scan resolves the card when no device is named; the Avro
    zstandard codec is the port's own decoder, reached with no import of
    the zstandard package."""
    from arrow_go_tpu_torch.dataset import dataset
    from arrow_go_tpu_torch.formats import avro, read_csv
    (tmp_path / "a.csv").write_text("a,b\n1,x\n2,y\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read_csv(str(tmp_path / "a.csv")).num_rows == 2
    ds = dataset(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(ds.scanner().device_batches())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ds.to_table()
    db = next(ds.scanner().device_batches(device="cpu"))
    assert db.column("a").values[:2].tolist() == [1, 2]
    text = (PKG / "formats" / "avro.py").read_text()
    assert "zstandard" not in {n.split(".")[0] for node in ast.walk(
        ast.parse(text)) if isinstance(node, (ast.Import, ast.ImportFrom))
        for n in ([a.name for a in node.names] if isinstance(
            node, ast.Import) else [node.module or ""])}
    assert avro.native.zstd_decompress.__module__ == \
        "arrow_go_tpu_torch.native"


def test_flight_runs_with_grpc_protobuf_and_pyarrow_blocked():
    """A port server and client trade batches, actions and two scenarios
    (one of them the FlightSQL scenario over the SQLite example server)
    in a process where importing grpc, google.protobuf, h2, hpack,
    pyarrow or the JAX package fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {('grpc', 'google', 'h2', 'hpack', 'pyarrow', 'jax', 'arrow_go_tpu')!r}:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from arrow_go_tpu_torch import dtypes as dt, flight as fl\n"
        "from arrow_go_tpu_torch.device.block import HostArray, HostBatch\n"
        "from arrow_go_tpu_torch.flight import integration\n"
        "hb = HostBatch(dt.Schema([dt.Field('a', dt.int64, False)]),\n"
        "               [HostArray(np.arange(100000), None, dt.int64)], 100000)\n"
        "class S(fl.FlightServerBase):\n"
        "    def do_get(self, ctx, t): return hb.schema, [hb, hb]\n"
        "    def do_action(self, ctx, a): yield fl.Result(a.body[::-1])\n"
        "with S('grpc://127.0.0.1:0') as s:\n"
        "    with fl.FlightClient(f'grpc://127.0.0.1:{s.port}') as c:\n"
        "        got = c.do_get(fl.Ticket(b'x')).read_all()\n"
        "        body = list(c.do_action(fl.Action('r', b'abc')))[0].body\n"
        "integration.run_scenario_inprocess('session_options')\n"
        "integration.run_scenario_inprocess('flight_sql')\n"
        "print(got.num_rows, int(got.column('a').combine().values.sum()),"
        " body)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[-2] == f"200000 {2 * sum(range(100000))} b'cba'"
