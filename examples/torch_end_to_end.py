"""End-to-end demo of the PyTorch/CUDA port: every major subsystem in one
pipeline (the port's counterpart of examples/end_to_end.py).

CSV ingest -> parquet (bloom filters, multiple row groups) -> dataset
scan with predicate pushdown + a filter on the card -> device group-by ->
hash join -> sort -> Arrow IPC -> Flight serve and read back ->
FlightSQL query over sqlite, each stage's output the next one's input.

Run: python examples/torch_end_to_end.py              (the CUDA card)
     python examples/torch_end_to_end.py --device cpu
     python examples/torch_end_to_end.py --rows 1048576
"""
import argparse
import io
import os
import sys
import tempfile
import time

if __package__ in (None, ""):     # run as a script: the repo importable
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

import arrow_go_tpu_torch as agt  # noqa: E402
from arrow_go_tpu_torch import compute as pc  # noqa: E402
from arrow_go_tpu_torch import flight as fl  # noqa: E402
from arrow_go_tpu_torch import formats, ipc, parquet, torchenv  # noqa: E402
from arrow_go_tpu_torch.dataset import dataset  # noqa: E402
from arrow_go_tpu_torch.device.block import batch_to_device  # noqa: E402
from arrow_go_tpu_torch.ops import reductions  # noqa: E402
from arrow_go_tpu_torch.parquet.device_read import (  # noqa: E402
    read_batch_device)

REGIONS = ["east", "west", "north"]


def csv_text(rows: int) -> bytes:
    """The demo's orders as csv text: order_id, a region in turn and an
    amount of ((7 i) mod 100) + 0.5."""
    return b"order_id,region,amount\n" + b"".join(
        f"{i},{REGIONS[i % 3]},{(i * 7) % 100}.5\n".encode()
        for i in range(rows))


def main(rows: int = 1000, device=None, root=None) -> dict:
    """Run the nine steps over `rows` orders on `device` (the card unless
    named), writing into the directory `root` (by default a temporary one,
    removed after the run). Returns every printed value by name, with the
    ranked HostBatch under "ranked_batch" and each step's seconds under
    "stage_s"."""
    if root is None:
        with tempfile.TemporaryDirectory(prefix="agt_torch_demo_") as tmp:
            return main(rows, device, tmp)
    dev = torchenv.device(device)
    tmp = root
    out, stage_s = {}, {}
    clock = [time.perf_counter()]

    def done(stage):
        if dev.type == "cuda":
            import torch
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stage_s[stage] = now - clock[0]
        clock[0] = now

    # 1. CSV ingest
    orders = formats.read_csv(csv_text(rows))
    out.update(csv_rows=orders.num_rows, csv_names=orders.schema.names)
    print(f"[csv] {orders.num_rows} rows, schema {orders.schema.names}")
    done("csv")

    # 2. parquet with bloom filters, multiple row groups
    pq_path = os.path.join(tmp, "orders.parquet")
    parquet.write_table(orders, pq_path, row_group_size=max(rows // 4, 1),
                        write_bloom_filters=True, compression="snappy",
                        write_page_index=False)
    out.update(parquet_bytes=os.path.getsize(pq_path),
               row_groups=parquet.ParquetFile(pq_path).num_row_groups)
    print(f"[parquet] wrote {out['parquet_bytes']} bytes, "
          f"{out['row_groups']} row groups")
    done("parquet")

    # 3. dataset scan: row-group pruning + the filter on the card (K1)
    ds = dataset(tmp)
    hot = ds.to_table(filter=(pc.field("amount") > 50) &
                      (pc.field("order_id") >= rows // 2), device=dev)
    out["scan_rows"] = hot.num_rows
    print(f"[scan] filtered to {hot.num_rows} rows "
          f"(pushdown skipped row groups below id {rows // 2})")
    done("scan")

    # 3b. device scan fast path: pages decode on the card; strings arrive
    # as dictionary codes; the sum is K3
    pf = parquet.ParquetFile(pq_path)
    db = read_batch_device(pf, 0, device=dev)
    amt = db.column("amount")
    dev_sum = float(reductions.reduce(amt.values, amt.validity, amt.length,
                                      "sum"))
    out.update(device_sum=dev_sum, device_rows=amt.length)
    print(f"[device scan] row group 0 decoded in HBM, "
          f"sum(amount)={dev_sum} over {amt.length} rows")
    done("device scan")

    # 4. group-by on the card
    by_region = pc.group_by(batch_to_device(hot, dev), "region",
                            [("amount", "sum"), ("amount", "count"),
                             ("amount", "max")])
    out["group_by"] = by_region.to_pydict()
    print(f"[group_by] {out['group_by']}")
    done("group_by")

    # 5. join with a dimension table
    dims = agt.record_batch({"region": REGIONS,
                             "manager": ["ann", "bo", "chi"]})
    joined = pc.hash_join(by_region, dims, "region", device=dev)
    # 6. sort by sum descending
    idx = pc.sort_indices(joined, pc.SortOptions(
        keys=[pc.SortKey("amount_sum", "descending")]), device=dev)
    ranked = pc.take(joined, idx, device=dev)
    out.update(ranked=ranked.to_pydict(), ranked_batch=ranked)
    print(f"[join+sort] {out['ranked']}")
    done("join+sort")

    # 7. IPC roundtrip
    buf = io.BytesIO()
    with ipc.new_file(buf, ranked.schema, compression="zstd") as w:
        w.write(ranked)
    back = ipc.open_file(buf.getvalue()).read_all()
    assert back.to_pydict() == ranked.to_pydict()
    out["ipc_bytes"] = len(buf.getvalue())
    print(f"[ipc] zstd file roundtrip ok ({out['ipc_bytes']} bytes)")
    done("ipc")

    # 8. Flight serve + readback
    class Srv(fl.FlightServerBase):
        def do_get(self, ctx, ticket):
            return back

    with Srv("grpc://127.0.0.1:0") as srv:
        with fl.FlightClient(f"grpc://127.0.0.1:{srv.port}") as client:
            got = client.do_get(fl.Ticket(b"ranked")).read_all()
    assert got.to_pydict() == back.to_pydict()
    out["flight"] = True
    print("[flight] served + read back over gRPC")
    done("flight")

    # 9. FlightSQL over sqlite
    with fl.SQLiteFlightSQLServer() as sqlsrv:
        with fl.FlightSQLClient(f"grpc://127.0.0.1:{sqlsrv.port}") as sc:
            sc.execute_update(
                "CREATE TABLE summary (region TEXT, total REAL)")
            for r, s in zip(got.column("region").to_pylist(),
                            got.column("amount_sum").to_pylist()):
                sc.execute_update(
                    f"INSERT INTO summary VALUES ('{r}', {s})")
            top = sc.execute_query(
                "SELECT region FROM summary ORDER BY total DESC LIMIT 1")
    out["top_region"] = top.column("region").to_pylist()[0]
    print(f"[flightsql] top region: {out['top_region']}")
    done("flightsql")
    print("END-TO-END OK")
    out["stage_s"] = stage_s
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args()
    main(args.rows, args.device)
