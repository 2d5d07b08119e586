"""The port's API surface against the JAX package's, name by name: every
public name a JAX module defines at its top level (a function, class or
constant of arrow_go_tpu/**.py) exists in the port's module of the same
path, and every public method or property of the JAX data-model classes
(the arrays, builders, record batches and tables, the types, schemas,
fields and metadata) exists on the port's class of the same name. The
only exceptions are the names in EXEMPT, each with the reason or the
port's counterpart."""
import ast
import importlib
import inspect
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

# JAX modules the port has no file for, each with its counterpart
EXEMPT_MODULES = {
    "arrow_go_tpu.jaxenv": "TPU-only (on_tpu, pallas_interpret): the "
                           "port's torchenv picks the card",
    "arrow_go_tpu.utils.rowhash": "decided in PR 17: the codec library's "
                                  "gather_rows / factorize walks",
    "arrow_go_tpu.flight.Flight_pb2": "protobuf DESCRIPTOR: the port's "
                                      "own wire format (flight/messages)",
    "arrow_go_tpu.flight.FlightSql_pb2": "protobuf DESCRIPTOR: the port's "
                                         "own wire format "
                                         "(flight/sql_messages)",
}

# top-level JAX names the port does not define, each with its reason
EXEMPT = {
    "arrow_go_tpu.cdata.ffi": "the cffi handle: the port's C data "
                              "interface is on ctypes",
    "arrow_go_tpu.ipc.core.build_record_batch_message":
        "a message of ArrayData columns: the port writes HostArrays "
        "(ipc.core.build_record_batch_parts)",
    "arrow_go_tpu.ipc.core.swap_endian_data":
        "ArrayData byte swap: the port swaps as it writes and reads "
        "(ipc.core.collect_body / BodyReader with big=True)",
    "arrow_go_tpu.ops.compaction.BLOCK": "TPU tile rows of the Pallas "
                                         "stitch (csrc/compaction.cu "
                                         "has its own)",
    "arrow_go_tpu.ops.scan.BLOCK_ROWS": "TPU tile rows of the Pallas scan "
                                        "(csrc/scan.cu has its own)",
    "arrow_go_tpu.ops.reductions.LANE": "TPU lane width of the Pallas "
                                        "reduction",
    "arrow_go_tpu.ops.reductions.WORDS_PER_LANE_ROW": "TPU-only: the "
                                                      "Pallas tile shape",
    "arrow_go_tpu.ops.reductions.reduce_pallas": "TPU-only: the port's "
                                                 "K3 is csrc/reduce.cu "
                                                 "(ops.reductions.reduce)",
    "arrow_go_tpu.ops.reductions.reduce_xla": "TPU-only: the plain "
                                              "version is "
                                              "ops.reductions._reduce_plain",
    "arrow_go_tpu.ops.groupagg.INNER": "TPU-only: the v5e reduce-window "
                                       "scan length",
    "arrow_go_tpu.ops.groupagg.chunked_cumsum": "TPU-only: a v5e "
                                                "reduce-window scan "
                                                "(torch.cumsum)",
    "arrow_go_tpu.ops.groupagg.chunked_cummax": "TPU-only: a v5e "
                                                "reduce-window scan "
                                                "(torch.cummax)",
    "arrow_go_tpu.ops.decimal.U64": "a jnp dtype alias: the port's limbs "
                                    "are int64 carrying u64 bits",
    "arrow_go_tpu.ops.selection.INT_IDX": "a jnp dtype alias: the port's "
                                          "indices are int64",
    "arrow_go_tpu.ops.decode.delta_decode_jit": "TPU-only: a jitted "
                                                "decoder (ops.decode."
                                                "delta_decode)",
    "arrow_go_tpu.ops.decode.rle_hybrid_decode_jit": "TPU-only: a jitted "
                                                     "decoder (ops.decode."
                                                     "rle_hybrid_decode)",
    "arrow_go_tpu.ops.decode.pad_segments": "TPU-only: pads segments to "
                                            "jit shapes",
    "arrow_go_tpu.ops.decode.rle_decode_device": "TPU-only: the port "
                                                 "decodes RLE runs with "
                                                 "ops.decode."
                                                 "rle_hybrid_decode",
    "arrow_go_tpu.parallel.join.BIG": "the JAX join's sentinel key: the "
                                      "port's join sorts validity first "
                                      "(parallel.dist.BIG marks hot "
                                      "slots)",
}


def _jax_modules():
    for p in sorted((ROOT / "arrow_go_tpu").rglob("*.py")):
        parts = list(p.relative_to(ROOT / "arrow_go_tpu").with_suffix(
            "").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield p, ".".join(["arrow_go_tpu"] + parts)


def _defined(path: pathlib.Path) -> set:
    """The public names a module binds at its top level by def, class or
    assignment."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


MODULES = [(p, m) for p, m in _jax_modules() if _defined(p)]


def test_every_jax_module_is_walked():
    mods = {m for _, m in MODULES}
    assert {"arrow_go_tpu.array.arrays", "arrow_go_tpu.array.builders",
            "arrow_go_tpu.memory.bitutil", "arrow_go_tpu.dtypes",
            "arrow_go_tpu.device.block", "arrow_go_tpu.parquet.reader"} <= mods
    assert len(MODULES) > 80
    assert set(EXEMPT_MODULES) <= mods
    for name in EXEMPT:
        mod, _, attr = name.rpartition(".")
        assert mod in mods and attr in _defined(
            dict((m, p) for p, m in MODULES)[mod]), name


@pytest.mark.parametrize("path,module", MODULES, ids=[m for _, m in MODULES])
def test_every_public_jax_name_is_in_the_port(path, module):
    if module in EXEMPT_MODULES:
        port = module.replace("arrow_go_tpu", "arrow_go_tpu_torch", 1)
        with pytest.raises(ImportError):
            importlib.import_module(port)
        return
    port = importlib.import_module(
        module.replace("arrow_go_tpu", "arrow_go_tpu_torch", 1))
    missing = sorted(n for n in _defined(path)
                     if not hasattr(port, n) and f"{module}.{n}" not in EXEMPT)
    assert missing == [], module
    for n in _defined(path):
        if f"{module}.{n}" in EXEMPT:
            assert not hasattr(port, n), f"{module}.{n} is no longer missing"


# ---------------------------------------------------------------------------
# the data-model classes' methods
# ---------------------------------------------------------------------------

CLASS_MODULES = ["array.arrays", "array.builders", "array.record",
                 "array.concat", "dtypes", "memory.bitutil",
                 "memory.buffer", "device.block"]

# public JAX methods or properties a port class lacks, each with why
EXEMPT_METHODS = {
    "ListArray.values": "a nested column's `values` is None: its child is "
                        "children[0] (ROADMAP §3)",
    "ListViewArray.values": "its child is children[0] (ROADMAP §3)",
    "FixedSizeListArray.values": "its child is children[0] (ROADMAP §3)",
}


def _class_methods():
    out = []
    for rel in CLASS_MODULES:
        jm = importlib.import_module(f"arrow_go_tpu.{rel}")
        tm = importlib.import_module(f"arrow_go_tpu_torch.{rel}")
        for name, obj in vars(jm).items():
            if not isinstance(obj, type) or obj.__module__ != jm.__name__ \
                    or name.startswith("_"):
                continue
            for attr in vars(obj):
                if attr.startswith("_"):
                    continue
                out.append((rel, name, attr, tm))
    return out


CLASS_METHODS = _class_methods()


def _instance_attrs(cls) -> set:
    """The attributes a port class's instances carry: its slots and every
    `self.<name> =` of its classes' code."""
    out = set()
    for k in cls.__mro__:
        if not k.__module__.startswith("arrow_go_tpu_torch"):
            continue
        out |= set(getattr(k, "__slots__", ()))
        try:
            src = inspect.getsource(k)
        except OSError:          # a class made by type(): no source
            continue
        out |= set(re.findall(r"self\.(\w+)\s*=", src))
    return out


@pytest.mark.parametrize("rel,cls,attr,tm", CLASS_METHODS,
                         ids=[f"{r}.{c}.{a}" for r, c, a, _ in CLASS_METHODS])
def test_every_public_jax_method_is_on_the_port_class(rel, cls, attr, tm):
    key = f"{cls}.{attr}"
    port_cls = getattr(tm, cls)
    if key in EXEMPT_METHODS:
        assert not hasattr(port_cls, attr), f"{key} is no longer missing"
        return
    assert hasattr(port_cls, attr) or attr in _instance_attrs(port_cls), key


# ---------------------------------------------------------------------------
# the names this surface added, each against the JAX one
# ---------------------------------------------------------------------------

def test_the_native_names_match():
    import numpy as np
    from arrow_go_tpu import native as jn
    from arrow_go_tpu.parquet import encodings as je
    from arrow_go_tpu_torch import native as tn
    rng = np.random.default_rng(3)
    assert tn.available() is True
    v = rng.integers(0, 1 << 13, 999).astype(np.uint32)
    for w in (0, 1, 13, 32):
        vw = v & np.uint32((1 << w) - 1) if w < 32 else v
        assert tn.bitpack32(vw, w) == jn.bitpack32(vw, w)
        np.testing.assert_array_equal(
            tn.bitunpack32(jn.bitpack32(vw, w), 999, w),
            jn.bitunpack32(jn.bitpack32(vw, w), 999, w))
    vals = [bytes(rng.integers(0, 256, rng.integers(0, 9)).astype(np.uint8))
            for _ in range(200)]
    blob = je.plain_encode(je.fmt.Type.BYTE_ARRAY, vals)
    for a, b in zip(tn.byte_array_unpack(blob, 200),
                    jn.byte_array_unpack(blob, 200)):
        np.testing.assert_array_equal(a, b)
    off = np.concatenate([[0], np.cumsum([len(x) for x in vals])])
    data = np.frombuffer(b"".join(vals), np.uint8)
    for valid in (None, rng.random(200) < 0.7):
        for a, b in zip(tn.factorize_offsets(data, off, valid),
                        jn.factorize_offsets(data, off, valid)):
            np.testing.assert_array_equal(a, b)


def test_the_host_decoders_match():
    import numpy as np
    from arrow_go_tpu.parquet import encodings as je
    from arrow_go_tpu_torch.parquet import encodings as te
    rng = np.random.default_rng(4)
    ints = rng.integers(-(1 << 50), 1 << 50, 700)
    enc = je.delta_binary_packed_encode(ints)
    for n in (None, 5, 700):
        (a, ua), (b, ub) = je.delta_binary_packed_decode(enc, n), \
            te.delta_binary_packed_decode(enc, n)
        np.testing.assert_array_equal(a, b)
        assert ua == ub
    vals = [bytes(rng.integers(97, 100, rng.integers(0, 6)).astype(np.uint8))
            for _ in range(150)]
    d = je.delta_length_byte_array_encode(vals)
    assert te.delta_length_byte_array_decode(d, 150) == \
        je.delta_length_byte_array_decode(d, 150) == vals
    d = je.delta_byte_array_encode(vals)
    assert te.delta_byte_array_decode(d, 150) == \
        je.delta_byte_array_decode(d, 150) == vals
    lv = rng.integers(0, 8, 333).astype(np.uint32)
    raw = je.rle_encode(lv, 3)
    np.testing.assert_array_equal(te.rle_decode(raw, 333, 3),
                                  je.rle_decode(raw, 333, 3))
    np.testing.assert_array_equal(te.rle_decode(b"", 4, 0),
                                  je.rle_decode(b"", 4, 0))
    e = je.levels_encode_v1(lv, 3)
    (a, ua), (b, ub) = je.levels_decode_v1(e, 333, 3), \
        te.levels_decode_v1(e, 333, 3)
    np.testing.assert_array_equal(a, b)
    assert ua == ub
    blob = je.plain_encode(je.fmt.Type.BYTE_ARRAY, vals)
    for a, b in zip(te.byte_array_decode_vectorized(blob, 150),
                    je.byte_array_decode_vectorized(blob, 150)):
        np.testing.assert_array_equal(a, b)


def test_the_adaptive_bloom_filter_matches():
    import numpy as np
    from arrow_go_tpu.parquet import bloom as jb
    from arrow_go_tpu.parquet import format as jfmt
    from arrow_go_tpu_torch.parquet import bloom as tb
    from arrow_go_tpu_torch.parquet import format as tfmt
    assert (tb.MIN_BLOOM_BYTES, tb.MAX_BLOOM_BYTES) == \
        (jb.MIN_BLOOM_BYTES, jb.MAX_BLOOM_BYTES)
    for ndv in (1, 500, 10_000):
        assert tb.optimal_num_bytes(ndv) == jb.optimal_num_bytes(ndv)
    rng = np.random.default_rng(5)
    for n, max_bytes in ((50, 1 << 12), (3000, 1 << 16), (40_000, 1 << 14)):
        vals = rng.integers(0, n, 2 * n).tolist()
        got = tb.build_bloom_filter_adaptive(vals, tfmt.Type.INT64,
                                             max_bytes=max_bytes)
        want = jb.build_bloom_filter_adaptive(vals, jfmt.Type.INT64,
                                              max_bytes=max_bytes)
        np.testing.assert_array_equal(got.blocks, want.blocks)
    ta, ja = tb.AdaptiveBloomFilter(1 << 14), jb.AdaptiveBloomFilter(1 << 14)
    for v in range(3000):
        ta.insert(v, tfmt.Type.INT32)
        ja.insert(v, jfmt.Type.INT32)
    assert (ta.num_distinct, ta.size()) == (ja.num_distinct, ja.size())
    np.testing.assert_array_equal(ta.finalize().blocks,
                                  ja.finalize().blocks)
    for ab in (ta, ja):
        with pytest.raises(ValueError):
            ab.insert_hash(1)


def test_the_reader_functions_and_fragment_scans_match(tmp_path):
    import numpy as np
    import arrow_go_tpu as jagt
    from arrow_go_tpu import dataset as jds, formats as jformats
    from arrow_go_tpu import ipc as jipc, parquet as jpq
    from arrow_go_tpu.parquet import reader as jreader
    from arrow_go_tpu_torch import dataset as tds
    from arrow_go_tpu_torch.parquet import reader as treader
    t = jagt.table({"id": list(range(100)),
                    "s": [["a", "b", None][i % 3] for i in range(100)]})
    pq = str(tmp_path / "f.parquet")
    with open(pq, "wb") as f:
        jpq.write_table(t, f, row_group_size=50, write_bloom_filters=True)
    jpf, tpf = jpq.ParquetFile(pq), treader.ParquetFile(pq)
    for fn in ("read_column_index", "read_offset_index"):
        a, b = getattr(treader, fn)(tpf, 1, 0), getattr(jreader, fn)(jpf, 1, 0)
        assert (a is None) == (b is None)
        if a is not None:
            for k in type(b).FIELDS.values():     # (the thrift structs
                assert repr(getattr(a, k[0])) == \
                    repr(getattr(b, k[0])), (fn, k)   # of each package)
    a, b = treader.read_bloom_filter(tpf, 0, 0), \
        jreader.read_bloom_filter(jpf, 0, 0)
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a.blocks, b.blocks)
    arrow = str(tmp_path / "f.arrow")
    with open(arrow, "wb") as f:
        w = jipc.new_file(f, t.schema)
        for rb in t.to_batches():
            w.write(rb)
        w.close()
    csv = str(tmp_path / "f.csv")
    jformats.write_csv(t, csv)
    for path in (pq, arrow, csv):
        jf = jds.Dataset(path).fragments[0]
        tf = tds.Dataset(path).fragments[0]
        want = jf.scan(["id"], [("id", ">=", 60)])
        got = tf.scan(["id"], [("id", ">=", 60)], device="cpu")
        assert [b.to_pydict() for b in got] == \
            [b.to_pydict() for b in want], path


def test_the_parallel_names():
    from arrow_go_tpu_torch.parallel.aggregate import GroupAggSpec
    from arrow_go_tpu_torch.parallel.shuffle import ShuffleResult
    assert GroupAggSpec("sum").agg == "sum"
    assert ShuffleResult._fields == ("data", "counts", "overflow")


# ---------------------------------------------------------------------------
# the signatures: a call written against the JAX package binds the same
# way on the port
# ---------------------------------------------------------------------------

# functions and methods (and constructors) whose JAX parameters the port
# does not take as the JAX package does, each with why
EXEMPT_SIGNATURES = {
    "arrow_go_tpu.array.arrays.Array.__init__":
        "a port array is built from its values, mask, type and "
        "dictionary; `make_array(data)` takes the JAX ArrayData form "
        "(ROADMAP §3, PR 22)",
    "arrow_go_tpu.device.block.batch_to_device":
        "`batch_to_device(data, device=None, pad=None)` keeps the port's "
        "argument order (ROADMAP §3, PR 22)",
    "arrow_go_tpu.dtypes.UnionType.__init__":
        "the abstract base takes its type id and name; the concrete "
        "SparseUnionType / DenseUnionType take (fields, type_codes) as "
        "the JAX ones do",
    "arrow_go_tpu.ipc.core.collect_body":
        "IPC plumbing over a HostArray and its type (the JAX one walks "
        "an ArrayData), with the byte order",
    "arrow_go_tpu.ipc.core.build_record_batch_parts":
        "IPC plumbing: the port's columns are HostArrays, typed by the "
        "schema's field types, with the byte order",
    "arrow_go_tpu.ipc.core.load_array":
        "IPC plumbing: the port's reader resolves dictionaries by id and "
        "field ids",
    "arrow_go_tpu.ops.decode.parse_delta_segments":
        "the port's parse reads every width to 64 and the stream's own "
        "count; its result tuple is its device decode's",
    "arrow_go_tpu.ops.groupagg.segment_min_max":
        "the port's group keys are one int64 key; the JAX ones are "
        "(flag, hi, lo) u32 lanes for the TPU",
    "arrow_go_tpu.ops.reductions.reduce":
        "`impl=` picks the TPU's Pallas or XLA path and `mask=` feeds it; "
        "the port's K3 wrapper picks its path from the tensor",
    "arrow_go_tpu.ops.reductions.mean":
        "`impl=` is TPU-only, as for reduce",
    "arrow_go_tpu.parallel.mesh.make_mesh":
        "the port's mesh is a torch.distributed group, one process per "
        "card, not n_devices of one process",
    "arrow_go_tpu.parallel.mesh.initialize_multihost":
        "torch.distributed's init_method, world_size and rank take the "
        "place of the JAX coordinator arguments",
    "arrow_go_tpu.parallel.multiproc.collect":
        "gathers over the port's process group, which it is given",
    "arrow_go_tpu.parallel.multiproc.worker_env":
        "a worker's environment on torch.distributed has no local "
        "device list",
    "arrow_go_tpu.parallel.multiproc.launch":
        "launches `python -m <module>` workers of one card each; core "
        "pinning and local device lists are JAX-process knobs",
    "arrow_go_tpu.parallel.shuffle.shuffle_shard_fn":
        "the shard function runs over the port's process group, not a "
        "part count of one process's devices",
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _callables():
    """(key, JAX callable, port callable) for every public function and
    every public method or constructor of a public class that a JAX
    module defines and the port's module of the same path also has."""
    out = []
    for _, module in MODULES:
        if module in EXEMPT_MODULES:
            continue
        jm = importlib.import_module(module)
        tm = importlib.import_module(
            module.replace("arrow_go_tpu", "arrow_go_tpu_torch", 1))
        for name, obj in vars(jm).items():
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != jm.__name__ or not hasattr(tm, name):
                continue
            if inspect.isfunction(obj):
                out.append((f"{module}.{name}", obj, getattr(tm, name)))
            elif isinstance(obj, type):
                port_cls = getattr(tm, name)
                for attr, m in vars(obj).items():
                    if attr.startswith("_") and attr != "__init__":
                        continue
                    pm = inspect.getattr_static(port_cls, attr, None)
                    m, pm = (getattr(x, "__func__", x) for x in (m, pm))
                    if inspect.isfunction(m) and callable(pm):
                        out.append((f"{module}.{name}.{attr}", m, pm))
    return out


def _params(fn) -> list:
    return [p for p in inspect.signature(fn).parameters.values()
            if p.name not in ("self", "cls")]


def _signature_faults(jf, tf) -> list:
    """What a JAX call of `jf` would bind differently on `tf`: a JAX
    parameter the port lacks, and JAX positional parameters that are not
    the port's first ones, in order."""
    jp, tp = _params(jf), _params(tf)
    names = {p.name for p in tp}
    faults = [f"lacks {p.name!r}" for p in jp
              if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
              and p.name not in names]
    jpos = [p.name for p in jp if p.kind in _POSITIONAL]
    tpos = [p.name for p in tp if p.kind in _POSITIONAL]
    if tpos[:len(jpos)] != jpos:
        faults.append(f"positional {jpos} but the port's are {tpos}")
    return faults


CALLABLES = _callables()


def test_the_signature_walk_covers_the_api():
    keys = {k for k, _, _ in CALLABLES}
    assert len(keys) > 900
    assert {"arrow_go_tpu.parquet.writer.write_table",
            "arrow_go_tpu.parquet.reader.ParquetFile.read_row_group",
            "arrow_go_tpu.dataset.Scanner.__init__",
            "arrow_go_tpu.compute.can_cast"} <= keys
    assert set(EXEMPT_SIGNATURES) <= keys


@pytest.mark.parametrize("key,jf,tf", CALLABLES,
                         ids=[k for k, _, _ in CALLABLES])
def test_every_jax_signature_binds_on_the_port(key, jf, tf):
    faults = _signature_faults(jf, tf)
    if key in EXEMPT_SIGNATURES:
        assert faults, f"{key} binds as the JAX one now: take it out of " \
                       f"EXEMPT_SIGNATURES"
        return
    assert faults == [], key
