"""CLI tools of the port (arrow_go_tpu/cli.py; reference L7:
arrow/ipc/cmd/arrow-cat, arrow-ls, parquet/cmd/parquet_reader,
parquet_schema, file<->stream converters, arrow-json-integration-test).

Usage:
    python -m arrow_go_tpu_torch.cli cat file.arrow|file.parquet|file.csv
    python -m arrow_go_tpu_torch.cli ls file.arrow|file.parquet
    python -m arrow_go_tpu_torch.cli schema file.parquet
    python -m arrow_go_tpu_torch.cli convert in.(arrow|parquet|csv) out.(arrow|parquet|csv)
    python -m arrow_go_tpu_torch.cli json-integration --mode ... --json ... --arrow ...

Tables are HostBatches. A parquet file is read by `parquet.read_table`,
whose columns decode on the card unless `--device` names another device
(`--device cpu`); the text printed for a file is the JAX CLI's.
`flight-integration` lists, serves and runs the Flight integration
scenarios (flight/integration.py), the two FlightSQL ones included.
"""
from __future__ import annotations

import argparse


_PARQUET = (".parquet", ".pq")
_IPC_FILE = (".arrow", ".feather", ".ipc")
_JSON = (".json", ".jsonl", ".ndjson")


def _read_any(path: str, device=None):
    """The file's rows as one batch (a reader's Table combined)."""
    from .array.record import host_batch
    return host_batch(_read_file(path, device))


def _read_file(path: str, device=None):
    from . import formats, ipc, parquet
    if path.endswith(_PARQUET):
        return parquet.read_table(path, device=device)
    if path.endswith(_IPC_FILE):
        with open(path, "rb") as f:
            return ipc.open_file(f).read_all()
    if path.endswith(".arrows"):
        with open(path, "rb") as f:
            return ipc.open_stream(f).read_all()
    if path.endswith(".csv"):
        return formats.read_csv(path)
    if path.endswith(_JSON):
        return formats.read_json(path)
    if path.endswith(".avro"):
        return formats.read_avro(path)
    raise SystemExit(f"unknown format: {path}")


def _write_any(hb, path: str):
    from . import formats, ipc, parquet
    if path.endswith(_PARQUET):
        parquet.write_table(hb, path)
    elif path.endswith(_IPC_FILE) or path.endswith(".arrows"):
        new = ipc.new_stream if path.endswith(".arrows") else ipc.new_file
        with open(path, "wb") as f:
            with new(f, hb.schema) as w:
                w.write(hb)
    elif path.endswith(".csv"):
        formats.write_csv(hb, path)
    elif path.endswith(_JSON):
        formats.write_json(hb, path)
    else:
        raise SystemExit(f"unknown output format: {path}")


def cmd_cat(args):
    t = _read_any(args.file, args.device)
    n = args.rows if args.rows is not None else t.num_rows
    d = t.slice(0, min(n, t.num_rows)).to_pydict()
    print("\t".join(d.keys()))
    for row in zip(*d.values()):
        print("\t".join("" if v is None else str(v) for v in row))


def cmd_ls(args):
    t = _read_any(args.file, args.device)
    print(f"rows: {t.num_rows}")
    for f in t.schema.fields:
        null = "" if f.nullable else " not null"
        print(f"  {f.name}: {f.type}{null}")


def cmd_schema(args):
    """Detailed parquet metadata dump (reference
    parquet/cmd/parquet_reader/main.go column/stats listing +
    parquet_schema)."""
    if not args.file.endswith(_PARQUET):
        cmd_ls(args)
        return
    from . import parquet
    from .parquet import format as fmt
    with parquet.ParquetFile(args.file) as pf:
        print(f"rows: {pf.num_rows}  row_groups: {pf.num_row_groups}")
        print(f"created_by: {pf.metadata.created_by}")
        for f in pf.schema.fields:
            print(f"  {f.name}: {f.type}")
        for i, rg in enumerate(pf.metadata.row_groups or []):
            print(f"  row group {i}: rows={rg.num_rows} "
                  f"bytes={rg.total_compressed_size}")
            for ci, col in enumerate(rg.columns or []):
                m = col.meta_data
                if m is None:
                    continue
                encs = ",".join(fmt.Encoding(e).name
                                for e in (m.encodings or []))
                line = (f"    column {ci} {'.'.join(m.path_in_schema)}:"
                        f" values={m.num_values}"
                        f" codec={fmt.Codec(m.codec or 0).name}"
                        f" encodings=[{encs}]"
                        f" compressed={m.total_compressed_size}"
                        f" uncompressed={m.total_uncompressed_size}")
                st = m.statistics
                if st is not None and st.null_count is not None:
                    line += f" nulls={st.null_count}"
                print(line)


def cmd_convert(args):
    _write_any(_read_any(args.src, args.device), args.dst)
    print(f"wrote {args.dst}")


def _pydict(batches) -> dict:
    """The rows of HostBatches of one schema as {name: values}."""
    out = {f.name: [] for f in batches[0].schema.fields} if batches else {}
    for b in batches:
        for k, v in b.to_pydict().items():
            out[k].extend(v)
    return out


def cmd_json_integration(args):
    """The archery integration-harness tool (reference
    arrow/ipc/cmd/arrow-json-integration-test/main.go): convert the
    integration JSON format <-> Arrow IPC files, or VALIDATE that a JSON
    file and an arrow file hold identical data."""
    from . import ipc
    from .interop import arrjson

    def read_json_batches(path):
        with open(path) as f:
            return arrjson.read_arrjson(f.read())

    def read_arrow_batches(path):
        with open(path, "rb") as f:
            r = ipc.open_file(f)
            return [r.get_batch(i) for i in range(r.num_record_batches)]

    if args.mode == "JSON_TO_ARROW":
        batches = read_json_batches(args.json)
        with open(args.arrow, "wb") as f:
            with ipc.new_file(f, batches[0].schema) as w:
                for b in batches:
                    w.write(b)
        print(f"wrote {args.arrow}")
    elif args.mode == "ARROW_TO_JSON":
        out = arrjson.write_arrjson(read_arrow_batches(args.arrow))
        with open(args.json, "w") as f:
            f.write(out)
        print(f"wrote {args.json}")
    else:  # VALIDATE
        jb = read_json_batches(args.json)
        ab = read_arrow_batches(args.arrow)
        if jb[0].schema != ab[0].schema:
            raise SystemExit(f"schema mismatch:\n  json: {jb[0].schema}\n"
                             f"  arrow: {ab[0].schema}")
        if _pydict(jb) != _pydict(ab):
            raise SystemExit("data mismatch between json and arrow files")
        print("validation passed")


def cmd_flight_integration(args):
    """The archery Flight integration drivers (reference
    arrow/flight/cmd/arrow-flight-integration-{server,client}) over the
    scenarios of flight/integration.py."""
    from .flight import integration as fi
    if args.role == "list":
        for name in sorted(fi.SCENARIOS):
            print(name)
        return
    if args.scenario is None:
        raise SystemExit("--scenario is required for server/client")
    if args.role == "server":
        fi.run_scenario_server(args.scenario, args.port)
    else:
        fi.run_scenario_client(args.scenario,
                               args.uri or f"grpc://localhost:{args.port}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="arrow_go_tpu_torch.cli")
    p.add_argument("--device", default=None,
                   help="the device parquet columns decode on (the card "
                        "unless named; 'cpu' for the CPU)")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("cat", help="print rows")
    c.add_argument("file")
    c.add_argument("--rows", type=int, default=None)
    c.set_defaults(fn=cmd_cat)
    l = sub.add_parser("ls", help="show schema + row count")
    l.add_argument("file")
    l.set_defaults(fn=cmd_ls)
    s = sub.add_parser("schema", help="detailed file metadata")
    s.add_argument("file")
    s.set_defaults(fn=cmd_schema)
    v = sub.add_parser("convert", help="convert between formats")
    v.add_argument("src")
    v.add_argument("dst")
    v.set_defaults(fn=cmd_convert)
    j = sub.add_parser(
        "json-integration",
        help="integration JSON <-> IPC convert/validate "
             "(arrow-json-integration-test)")
    j.add_argument("--mode", required=True,
                   choices=["JSON_TO_ARROW", "ARROW_TO_JSON", "VALIDATE"])
    j.add_argument("--json", required=True)
    j.add_argument("--arrow", required=True)
    j.set_defaults(fn=cmd_json_integration)
    fi = sub.add_parser(
        "flight-integration",
        help="archery Flight scenario server/client "
             "(arrow-flight-integration-server/-client)")
    fi.add_argument("role", choices=["server", "client", "list"])
    fi.add_argument("--scenario", default=None)
    fi.add_argument("--port", type=int, default=0)
    fi.add_argument("--uri", default=None)
    fi.set_defaults(fn=cmd_flight_integration)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
