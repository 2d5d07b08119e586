"""Chip smoke test of the PyTorch/CUDA port (arrow_go_tpu_torch).

Runs on one NVIDIA card and fails (non-zero exit, no result line)
without one. Phases:

  1. device: the card's name and power limit (nvidia-smi);
  2. build:  the port's CUDA kernels, compiled from csrc/ with nvcc;
  3. K1 (compact_flagged), K2 (cummax_u64_lanes, and its hi-only mode
     cummax_u32) and K3 (reduce, reduce_with_count) against their plain
     PyTorch versions over a sweep of lengths, densities and types: K1
     and K2 bit for bit, each case launched twice (K1 over its whole
     length, with views at an element offset that are not 16-byte
     aligned and with 16 mixed-width payloads; K2 with 0 to 4 lo lanes
     and offset views too), K3 bit for
     bit for ints, min, max and (exact) products, float sums at rtol
     1e-9 (f64) and 1e-5 (f32), its counts exact, and every K3 result
     identical over two launches and over two launches with another
     between them (K3 again, in phase 6, on the very columns Q6 and the
     summary reduce);
  4. Q3 (filter -> hash join -> group-by -> sort, the pipeline of
     benchmarks/engine_e2e.py) from device-resident batches at TPC-H
     SF10 scale (59,986,052 lineitem rows), checked against a numpy
     oracle, with each kernel's launch count over one run of it; one
     more run broken down by stage (host clock), one under
     torch.profiler (device time by kernel and the device's idle
     share), and one that captures what each K1 call site hands K1,
     timed at each of those shapes;
  5. the same tables (plus l_qty) written to parquet bytes by the
     port's writer, then scanned onto the card (read_batch_device),
     with the host-parse / host-to-device / device-decode split;
  6. from parquet bytes: TPC-H Q6 (predicate -> filter -> expression ->
     SUM/COUNT), the lineitem summary aggregates, and Q3, each checked
     against a numpy oracle, each with its kernels' launch counts;
  7. K2 and K3 timed at the shapes of those paths, beside their plain
     versions, a one-call PyTorch yardstick and their memory-bound
     least time;
  8. the engine's own files: lineitem (plus l_tax, l_lstatus, l_rflag)
     and orders written SNAPPY with the settings of engine_e2e.py, and
     the two key columns DELTA_BINARY_PACKED, each scanned back bit for
     bit (string columns by codes and dictionary) with the scan's
     decompress split; TPC-H Q1 (string group keys, sums, means,
     COUNT(*), ORDER BY the keys) device-resident and from the snappy
     bytes against a numpy oracle, profiled once, with K1 timed at each
     of its Q1 call sites; every other group-by aggregation (min, max,
     first, last, count, any, all, product) over the scanned lineitem
     against numpy;
  9. the joins: lineitem and orders gain TPC-H's ship mode, receipt and
     commit dates, order priority and customer key, beside a customer
     table (spec 4.2.3); TPC-H Q4 (EXISTS as a semi join), Q12 (an
     inner join carrying strings, IN, CASE) and Q13 (a left outer join)
     device-resident against numpy, each profiled once; every join type
     over DeviceBatch (inner, outer) and HostBatch (all eight, the
     probe chunked at PROBE_CHUNK_DEFAULT rows) inputs with null keys,
     out-rows and per-column checksums against numpy; is_in, index_in,
     unique, dictionary_encode, count_distinct, product, variance,
     stddev, any and all over the scanned lineitem against numpy;
     if_else and fill_null over its string columns (two dictionaries,
     string scalars, a null condition) and a join of a DeviceBatch with
     a HostBatch whose dictionary is not in first-occurrence order,
     against numpy; every K1 and K2 call of one more run of Q4, Q12,
     Q13, the sweep and the functions against the plain version; K2's
     hi-only mode timed at Q13's and Q4's join lengths;
  10. dates, times and casts over the snappy lineitem, whose l_sdate
     is a DATE column (date32) since this phase's file was written with
     its type: TPC-H Q6 on it (`typed_q6`); floor/ceil/round_temporal
     by year, quarter, month and week over every row and a
     timestamp("ms", "+05:30") rounded to the hour, then the revenue by
     ship year (`temporal`); the cast chains, the safety checks, the
     float-to-int saturation, float16 and the unsigned order of l_okey
     as uint64 and uint32 (`casts`); Q6's predicate through
     call_function with a host array to the card and back
     (`registry`); each against numpy, every K1 and K3 call of these
     paths held against the plain version;
  11. decimals: l_qty, l_price and l_disc as DECIMAL(15,2) in 16-byte
     FIXED_LEN_BYTE_ARRAY (decimal128, beside the DATE l_sdate) and
     l_qty, l_price, l_disc and l_tax in INT64 (decimal64, beside the
     two flags), both files SNAPPY from the port's writer, their values
     exactly the cents of the float columns; both scanned on the card
     and held bit for bit (`decimal_scan`); TPC-H Q6 from the FLBA
     bytes with Decimal literals and a decimal128(31, 4) product
     (`decimal_q6`), Q1's l_price * (1 - l_disc) over every row
     (`disc_price`), Q1's sums, minima, maxima and counts on decimal64
     (`decimal_q1`), agg_sum of decimal64 l_price through K3
     (`decimal_sum`) and the decimal128 descending sort
     (`decimal_sort`), each exact against numpy's int64 arithmetic;
     every K1 call of decimal Q6 and Q1 and the K3 call of the sum held
     against the plain version (`decimal_path_checks`); decimal128 and
     decimal256 arithmetic, compares and a sort on random full-width
     limbs against Python integers, and FLOAT16, fixed_size_binary(12)
     and INT96 files scanned on the card (`limb_checks`);
  12. datasets from other writers: the lineitem (sorted by l_sdate, in
     8 files of equal l_sdate ranges), orders (sorted by o_odate, 2
     files, a bloom filter on o_custkey) and customer (C_NAME as TPC-H
     writes it, once with its dictionary past 1 MiB so that it falls
     back to PLAIN, once DELTA_LENGTH_BYTE_ARRAY, once DELTA_BYTE_ARRAY)
     written zstd at level 3 in the Arrow C++ writer's layout (row
     groups of 1,048,576 rows, 1 MiB pages, statistics on) into a
     temporary directory; Q6 through the dataset scanner, its row groups
     pruned by l_sdate statistics (`dataset_q6`) and not
     (`dataset_q6_unpruned`); TPC-H Q10 (`dataset_q10`); one customer's
     orders by o_custkey == k, pruned by statistics and bloom filters
     (`dataset_lookup`); c_name in each encoding held bit for bit with
     its codes in first-occurrence order (`string_pages`); the file
     bytes beside a snappy lineitem and the host zstd decoder's MB/s
     (`zstd`); every K1, K2 and K3 call of one more run of dataset Q6
     and Q10 against the plain version (`dataset_path_checks`);
  13. the distributed tier (arrow_go_tpu_torch.parallel) on one NCCL
     process group of world size 1, every exchange through NCCL's
     all_to_all, over the first 14,996,512 lineitem rows (about a
     quarter of SF10's) and every order: TPC-H Q1's keys with sum, mean, count, min
     and max of three columns through distributed_group_by
     (`dist_q1`); lineitem joined with the orders of a date window by
     make_distributed_join, all six join types (`dist_join`); Zipf(1.1)
     lineitem keys joined with every order, hot_k=16, inner and left
     outer, the Zipf side probing (hot path A) and building (hot path
     B), each equal to the same join without hot keys
     (`dist_hot_join`); orders sorted on (o_odate, o_okey) by
     distributed_sort (`dist_sort`); the chunk-pipelined streamed
     group-by by l_okey beside the barrier form (`dist_streamed`,
     `dist_barrier`); each against numpy, with the exchange's bytes and
     the peak memory (`dist`), a `dist_profile` of Q1 and the inner
     join, and every K1 and K2 call of one more run of each path against
     the plain version (`dist_path_checks`);
  14. nested types on the same SF10 arrays: a list<double> of each
     order's l_price on the card (DeviceListColumn: offsets from the
     counts of l_okey, the child by one stable sort), its take by 15 M
     seeded indices, 5% null, with repeats (K2's hi-only fills), its
     filter by o_odate < 720 (K1, then the take), value_counts of l_okey
     and of o_odate, l_price filtered as one column by Q6's predicate
     (K1) and the scalar aggregates of l_qty as int8 and as uint32 +
     2**31 (K3), each exact against numpy (`nested`, `nested_profile`),
     every K1, K2 and K3 call of one more run of each path against the
     plain version (`nested_path_checks`);
  15. the compute front on the same arrays: TPC-H Q6 built with the
     expression operators and run through compile_expression, its two
     expressions under torch.cuda's sync debug mode "error", then the
     filter (K1) and pc.sum / pc.count (K3), exact against numpy, its
     mask bit for bit the eager one, timed beside the eager Q6
     (`compiled_q6`); l_okey and o_odate sorted on the card and
     run-end encoded, their run starts compacted by K1, exact against
     numpy, decoded back bit for bit (`run_ends`); DeviceMemoryWatcher
     around a warm Q3 and a compiled Q6 (`memwatch`); the registry's Q6
     under the metrics registry, and a compiled Q6 under the profiler
     trace, its K1 / K3 kernel events beside the launch counters
     (`metrics`); a tensor of two columns on the card (`tensor`); every
     K1 and K3 call of one more run of each path against the plain
     version (`front_path_checks`);
  16. the remaining types on the same arrays: l_smode cast to
     string_view and o_opri to large_string by the registry's casts
     (each a re-typed dictionary), TPC-H Q12 over them with its key
     typed string_view, exact against numpy and equal to the string Q12
     of the same call, both timed (`q12_views`); an orders HostBatch
     with a null column, a month_interval, o_opri as large_string and
     as binary_view and a bool8 extension, filtered as a DeviceBatch by
     o_odate < 720 on K1 (`typed_filter`); the same orders with
     day_time and month_day_nano intervals, a dense and a sparse union,
     a list_view<double> of each order's l_price and a uuid extension,
     through the host route by that predicate and by 3.75 M seeded take
     indices (a quarter of the orders since PR 22), 5% null, with ms and
     peak host bytes a column
     (`host_types_filter`); each exact against numpy, and every K1 and
     K2 call of one more run of Q12 views and typed_filter against the
     plain version (`types_path_checks`);
  17. the variant type and Arrow IPC on the same arrays: l_price,
     l_disc, l_qty and l_sdate written by the port's new_file in record
     batches of 1,048,576 rows, uncompressed, lz4 frame and zstd (the
     lz4 and zstd bodies their first 8 batches: cuts of the script's
     time), each
     read back by open_file, sent to the card batch by batch and run
     through TPC-H Q6 (K1, K3), exact against numpy, every column bit
     for bit, with the write ms, the read split (parse, decompress, copy
     to the card, compute), the bytes and the uncompressed read's device
     idle share (`ipc_q6`); o_opri as a dictionary field with one
     dictionary delta and o_custkey through new_stream / open_stream in
     15 batches, exact (`ipc_stream`); the lineitem sorted by l_sdate in
     8 lz4 .arrow files in a temporary directory, Q6 through the dataset
     scanner (one device batch a file), equal to `ipc_q6` and to phase
     12's parquet `dataset_q6` (`ipc_dataset_q6`); 16,384 orders as
     parquet.variant objects of o_okey, o_odate and o_opri (a cut: the
     variant Builder encodes row by row in Python), shredded to typed_value int64 /
     int32 / string, round-tripped through the port's parquet writer and
     reader and an IPC stream, unshredded and held row by row against
     the source, the shredded o_odate filtered by < 720 on the card (K1)
     against the plain column's filter (`variant`); every K1 and K3 call
     of one more run of the uncompressed `ipc_q6`, `ipc_dataset_q6` and
     the variant filter against the plain version (`ipc_path_checks`);
  18. the file formats over the first 1,500,303 rows (a quarter of TPC-H
     SF1's lineitem; a cut of depth) of the same arrays: Q1's seven columns
     as csv text built by array operations (l_sdate as ISO dates, the
     flags as letters, floats as their repr), its first 65,536 rows
     byte for byte the port's write_csv, read by read_csv on its numpy
     tier with every column held against its source, TPC-H Q1 on the
     card (`csv_q1`); the Q6 columns of the same text by
     include_columns, Q6 on the card with the device's idle share of
     read plus query (`csv_q6`); Q6 batch by batch over open_csv of
     the first 524,288 rows, 262,144 a batch, the schema pinned
     (`csv_stream`); the Q6 rows sorted by l_sdate as 8 .csv files in a
     temporary directory, Q6 through the dataset scanner, equal to
     csv_q6 (`csv_dataset_q6`); the Q6 columns as an Avro object
     container file of 65,536-record blocks for each codec (null,
     deflate, snappy, zstandard), read by OCFReader.read_all, every
     column bit for bit, Q6 on the card (`avro_q6`); 262,144 orders
     through write_json (its bytes json.dumps of each row) and
     read_json, filtered by o_odate < 720 on the card (K1) and their
     o_custkey summed (K3) (`json_orders`); every K1 and K3 call of the
     device work of those paths against the plain version
     (`formats_path_checks`); each exact against numpy, float sums at
     rtol 1e-9;
  19. the interchange surface: Q6's predicate and revenue serialized
     as a Substrait ExtendedExpression over the SF10 lineitem's schema,
     decoded (`and` as and_kleene) and run over that lineitem on the
     card, its count and revenue the eager Q6's of the same call bit
     for bit, with the bytes and the serialize, deserialize, Substrait
     and eager ms; Q1's disc_price and charge through Substrait bit for
     bit against compute_q1's (`substrait_q6`); the Q6 columns as 58
     HostBatches of 1,048,576 rows through export_stream into an
     ArrowArrayStream and import_stream (each batch copied out), each to
     the card for Q6, every column bit for bit, with the export, copy,
     host-to-device and compute ms and the device's idle share, one
     batch through export_device_array / import_device_array and a
     device_type of 2 refused (`cdata_q6`); 262,144 orders with o_opri
     a dictionary field through write_arrjson and read_arrjson, filtered
     by o_odate < 720 on the card (K1) and o_custkey summed (K3)
     (`arrjson_orders`); every K1 and K3 call of those paths against the
     plain version (`interop_path_checks`);
  20. parquet modular encryption, in a temporary directory: the Q6
     columns of the first 6,001,215 rows (TPC-H SF1's lineitem) written
     AES_GCM_V1, uniform, with an encrypted footer, in the dataset's
     layout (1,048,576-row groups, 1 MiB pages, snappy) with a page
     index and an l_qty bloom filter, read back by parquet.read_table
     bit for bit, and Q6 from the file on the card (each page decrypted
     by the port's AES on the host, decoded on the card, K1 and K3)
     against numpy, with the read split (parse, decrypt, decompress,
     copy, decode), the decryption's GB/s and the device idle share
     (`enc_q6`); the page index and bloom filter of that file,
     decrypted and held against the rows (`enc_index_bloom`); 1,048,576
     rows AES_GCM_CTR_V1 with a signed plaintext footer, column keys on
     l_price and l_disc and an AAD prefix that is not stored: the
     plaintext columns read with no keys, l_price with none, with a
     wrong key and without the prefix refused, Q6 with the keys
     (`enc_ctr_columns`); 65,536 rows under a CryptoFactory with double
     wrapping over an in-memory KMS, Q6 (`enc_kms`); cli.main ls,
     schema, cat --rows 5 and convert (.parquet -> .arrow -> .parquet)
     against the numpy values (`cli`); every K1 and K3 call of enc_q6
     and enc_ctr_columns against the plain version
     (`encryption_path_checks`);
  21. Arrow Flight on the port's own gRPC, in a temporary directory:
     the Q6 columns of the first 6,001,215 rows sorted by l_sdate,
     written with WriterProperties (data page v2, format 2.6, l_sdate
     DELTA_BINARY_PACKED in zstd, l_qty a dictionary in snappy, l_price
     and l_disc snappy, no statistics on l_disc, l_sdate declared the
     sorting column, key/value metadata, 1,048,576-row groups, 1 MiB
     pages), its footer checked (`flight_file`); the file read by
     parquet.read_table in a spawned server process and served in
     1,048,576-row HostBatches; TPC-H Q6 over a DoGet stream, each
     batch to the card (K1, K3), every column bit for bit, with the
     stream, copy and compute ms, the IPC body MB/s, the same bytes over
     a plain loopback socket and the device idle share (`flight_q6`);
     DoPut of the same batches, each acknowledged with its row count and
     l_qty sum (`flight_put`); DoExchange against a port server in this
     process that runs Q6 on the card per received batch and returns
     one row (`flight_exchange`); the 11 ported integration scenarios
     port to port (`flight_scenarios`); every K1 and K3 call of
     flight_q6 and flight_exchange against the plain version
     (`flight_path_checks`);
  22. Flight SQL: the Q6 columns of the first 1,048,576 rows at their
     widths (l_price, l_disc float64; l_qty, l_sdate int32) ingested
     into a port SQLite example server in this process by execute_ingest
     (`flightsql_ingest`); TPC-H Q6 from a FlightSQL query (the four
     columns by execute_query: GetFlightInfo and DoGet each run the
     query on the server; batch to the card, K1, K3) against numpy and
     SQLite's own aggregate through a prepared statement with Q6's
     bounds bound as parameters, with the query / copy / compute split,
     the IPC body bytes and the device idle share (`flightsql_q6`); the
     query's l_disc in 4 chunks as a ChunkedArray filtered by Q6's mask
     on the card (K1), held by array_equal against numpy (`chunked`);
     the DB-API driver: the parameterised Q6 aggregate through a cursor,
     an executemany rolled back and one committed, each counted
     (`flightsql_dbapi`); get_tables, get_sql_info, get_xdbc_type_info
     and get_primary_keys on lineitem (`flightsql_catalog`); the two
     FlightSQL integration scenarios port to port
     (`flightsql_scenarios`); every K1 and K3 call of flightsql_q6 and
     the chunked filter against the plain version
     (`flightsql_path_checks`);
  23. the examples, each stage's output the next one's input: the
     end-to-end demo (examples/torch_end_to_end.py) over 1,048,576
     orders in a temporary directory: csv text read by read_csv, written
     to snappy parquet with bloom filters in 4 row groups, scanned by
     the dataset with the order_id guard pruning 2 row groups and the
     amount filter on the card (K1), row group 0's amount summed by K3,
     grouped by region on the card, joined with a dimension batch,
     sorted, through an IPC zstd file, served and read back over
     Flight, and ranked by a FlightSQL query over sqlite; every printed
     value against numpy, each stage's seconds (`end_to_end`); the
     distributed example (examples/torch_distributed_query.py) at world
     size 1 on one NCCL group, its counts against numpy
     (`distributed_example`); pyarrow_interop: without pyarrow its first
     call raises ImportError, with it the ranked batch round-trips
     (`pyarrow_interop`); every K1, K2 and K3 call of one more run of
     each example against the plain version (`examples_path_checks`);
  24. the parquet encodings other writers use, over the first 6,001,215
     rows (SF1's lineitem), in a temporary directory: three files
     written by the port's writer with data page v2 in the dataset's
     layout (1,048,576-row groups, 1 MiB pages, zstd level 3,
     statistics): bss_delta (l_price, l_disc, l_qty BYTE_STREAM_SPLIT;
     l_ts, a timestamp[us] of the ship day and a seeded time of day,
     and l_sday, the day as int64, DELTA_BINARY_PACKED, l_ts's widest
     miniblock over 32 bits; l_isr, l_rflag == "R", PLAIN), flba_bss
     and flba_delta (the money columns DECIMAL(15,2) in 16-byte FLBA,
     BYTE_STREAM_SPLIT or DELTA_BYTE_ARRAY), each page's encoding
     checked (`encodings_files`); each file scanned on the card, every
     column bit for bit, with the parse / copy / decode split and each
     bss_delta column's decode alone (`encodings_scan`); TPC-H Q6 from
     bss_delta with the ship date as an l_ts range (K1, K3), its count
     the date Q6's (`ts_q6`); decimal Q6 from flba_bss and flba_delta
     (K1), exact (`encodings_decimal_q6`); a BOOLEAN RLE page of l_isr
     (rle_encode at width 1, with and without 5% nulls) through the
     device read's page plan, exact, and, where pyarrow is installed,
     bss_delta's rows written by pyarrow (v2: l_isr RLE), scanned bit
     for bit, Q6 from it equal to Q6 from bss_delta (`rle_booleans`);
     every K1 and K3 call of each Q6 against the plain version
     (`encodings_path_checks`);
  25. the JAX data-model API (arrays_phases) over the first 6,001,215
     rows (SF1's lineitem): the Q6 and Q1 columns as ArrayData layouts
     (all-set validity bitmaps and the values; l_rflag and l_lstatus as
     dictionary layout), `make_array` of each, a RecordBatch a
     1,048,576-row batch, Table.from_batches, select, combine_chunks and
     to_batches (`arrays_table`, with each stage's seconds); Q6 (K1, K3)
     and Q1 (K1) from `batch_to_device` of that batch, exact against
     numpy (`arrays_q6`, `arrays_q1`); batch_from_device of Q6's
     columns equal to their source (`arrays_round_trip`); the first
     1,048,576 orders through make_builder(...).append_values (1% of
     o_opri nulls), each column `to_device`, the o_odate window's filter
     (K1) exact against numpy, bitutil.count_set_bits of o_opri's
     validity equal to its device words' popcount (`arrays_orders`);
     every K1 and K3 call of the three paths against the plain version
     (`arrays_path_checks`);
  26. the JAX package's host API (hostapi_phases) over the first
     6,001,215 rows (SF1's lineitem) as a Table of ChunkedArrays in
     1,048,576-row chunks, every call on host objects, the port moving
     the data to the card itself: Q6 with its predicate built by the
     compute wrappers (greater_equal, less, and_, ...), pc.filter of the
     Table (a Table; K1) and pc.sum of pc.multiply (K3), exact against
     numpy (`hostapi_q6`); floor_temporal of l_sdate (date32) by month,
     then unique and value_counts on the host (`hostapi_temporal`);
     is_in of l_okey against a seeded 1% value set and fill_null of a
     1%-null l_disc (`hostapi_lookups`); the Table through
     ipc.new_stream(...).write_table and back, Q6 of the read batch equal
     to the Table's, and through parquet.write_table with a positional
     row_group_size, read_row_group(2, row_range=(1000, 50000)) equal to
     numpy's slice (`hostapi_writers`); every K1 and K3 call of each
     stage against the plain version (`hostapi_path_checks`);
  27. the JAX string and dictionary arrays (strings_phases) over SF1's
     rows: Tables of string columns built with `array`, TPC-H Q12 from
     them (K1, K2), the round trip, IPC and parquet with the JAX writer
     defaults, pyarrow's arrays (`strings_*` lines);
  28. the repaired parity faults (repairs_phases) over SF1's rows
     (6,001,215 lineitem and 1,500,000 orders rows) written to parquet
     in a temporary directory and read back as Tables of six and two
     chunks: sort_indices and sort of the lineitem Table by (l_okey
     descending, l_sdate), bit for bit against np.lexsort
     (`repairs_sort`); make_struct of two ChunkedArray columns
     (`repairs_struct`); call_function("unique") of the orders' o_opri
     strings, a utf8 StringArray (`repairs_unique`); the sum (K3) of
     if_else(l_sdate > 10000, l_qty int64, l_price float64), exact
     against numpy's truncating astype, its storage int64
     (`repairs_if_else_sum`); every kernel call of each stage against
     the plain version (`repairs_path_checks`);
  29. a `kernels` JSON line, then the last line
     {"ok": true, "device": {"platform": "gpu", ...}}.

With --timing-only it skips phases 3, 15, 16, 17 and 29 and, of phase 9,
all but the three queries and K2's timings, and holds no call of phases
10 to 14 and 18 to 28 against the plain version: a run that times every
path and kernel shape using only entry points that earlier trees have
too, so that two trees can be run in turns on one card (copy this
script into a tree unpacked with `git archive` and run it there, then
here, here, there). Phases 8 to 14 and 18 to 28 run only in a tree
that has their entry points.

With --only flight (or flightsql, examples, encodings, arrays, hostapi,
strings, repairs) it runs phases 1 and 2, makes the data (but for
examples) and runs phase 21 (or 22, 23, 24, 25, 26, 27, 28) alone, then
prints the phase's launches and errors and no `kernels` or ok line: a
quick check of that phase on the card.

Usage: python3 chip_smoke.py [--sf 10] [--timing-only]
                             [--only flight|flightsql|examples|encodings|
                                     arrays|hostapi|strings|repairs]
"""
from __future__ import annotations

import argparse
import decimal
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import arrow_go_tpu_torch as agt
import arrow_go_tpu_torch.compute as pc
from arrow_go_tpu_torch import cuda_build, dtypes as dt
from arrow_go_tpu_torch import parquet as tpq
from arrow_go_tpu_torch.device.block import (DeviceBatch, DeviceColumn,
                                             HostArray, HostBatch)
from arrow_go_tpu_torch.ops import bitmap, compaction, reductions, scan
from arrow_go_tpu_torch.utils.metrics import metrics

LINEITEM_SF1 = 6_001_215          # TPC-H spec 4.2.5: lineitem rows at SF1
LINEITEM_SF10 = 59_986_052        # ... and at SF10
CUTOFF = 10000
HBM_BYTES_PER_S = 3.35e12         # H100 SXM memory rate (data sheet)
# TPC-H Q6 with its validation substitutions (spec 2.4.6): the year
# 1994 as days since 1970-01-01, DISCOUNT 0.06 +- 0.01, QUANTITY 24
Q6_DATE_LO, Q6_DATE_HI = 8766, 9131
Q6_DISC_LO, Q6_DISC_HI = 0.05, 0.07
Q6_QTY = 24
KERNELS = ("K1", "K2", "K3")     # kernel.K1 ... in utils/metrics.py
# the engine's snappy lineitem annotates l_sdate as DATE (a tree without
# the temporal types writes it as INT32)
LI_TYPES = {"l_sdate": dt.date32} if hasattr(dt, "date32") else None


def make_data(n_li: int, n_ord: int):
    """benchmarks/engine_e2e.py:make_data (seed 7)."""
    rng = np.random.default_rng(7)
    li = {
        "l_okey": rng.integers(0, n_ord, n_li).astype(np.int64),
        "l_price": np.round(rng.uniform(1.0, 1000.0, n_li), 2),
        "l_disc": np.round(rng.uniform(0.0, 0.1, n_li), 2),
        "l_sdate": rng.integers(8000, 12000, n_li).astype(np.int32),
    }
    orders = {
        "o_okey": np.arange(n_ord, dtype=np.int64),
        "o_odate": rng.integers(700, 740, n_ord).astype(np.int32),
    }
    return li, orders


def add_quantity(li) -> None:
    """l_qty: TPC-H L_QUANTITY, uniform in [1, 50] (spec 4.2.3), from a
    generator of its own so the make_data columns stay as they were."""
    n = len(li["l_okey"])
    li["l_qty"] = np.random.default_rng(8).integers(1, 51, n).astype(
        np.int32)


def project(db: DeviceBatch, names) -> DeviceBatch:
    """The named columns of a batch, fields and columns both in `names`
    order."""
    return DeviceBatch(
        dt.Schema([db.schema.field(db.schema.field_index(n)) for n in names]),
        [db.column(n) for n in names], db.length)


def compute_q3(li_db: DeviceBatch, ord_db: DeviceBatch, cutoff: int,
               mark=lambda stage: None) -> HostBatch:
    """The port's Q3 (benchmarks/engine_e2e.py:compute_ours):

        SELECT o_odate, SUM(l_price * (1 - l_disc)), COUNT(*)
        FROM lineitem JOIN orders ON l_okey = o_okey
        WHERE l_sdate > cutoff GROUP BY o_odate ORDER BY 2 DESC

    `mark(stage)` is called as each stage ends (the profile's timer).
    """
    mask = pc.execute_scalar_expression(
        pc.call("greater", [pc.field("l_sdate"), pc.literal(cutoff)]), li_db)
    mark("predicate")
    # l_sdate is consumed by the mask: project it away before the filter
    li_f = pc.filter(project(li_db, ["l_okey", "l_price", "l_disc"]), mask)
    mark("filter")
    joined = pc.hash_join(li_f, ord_db, left_keys=["l_okey"],
                          right_keys=["o_okey"],
                          output_columns=["l_price", "l_disc", "o_odate"])
    mark("hash_join")
    rev = pc.execute_scalar_expression(pc.call("multiply", [
        pc.field("l_price"),
        pc.call("subtract", [pc.literal(1.0), pc.field("l_disc")])]), joined)
    jb = DeviceBatch(dt.Schema([dt.Field("o_odate", dt.int32),
                                dt.Field("rev", dt.float64)]),
                     [joined.column("o_odate"), rev], joined.length)
    mark("revenue")
    g = pc.group_by(jb, "o_odate", [("rev", "sum"), ("rev", "count")])
    mark("group_by")
    idx = pc.sort_indices(g.column("rev_sum"), order="descending")
    out = HostBatch.from_arrays({nm: pc.take(g.column(nm), idx)
                                 for nm in g.schema.names})
    mark("sort_take")
    return out


def q3_oracle(li, orders, cutoff: int):
    """numpy Q3: (o_odate by descending revenue, counts, revenues)."""
    m = li["l_sdate"] > cutoff
    key = orders["o_odate"][li["l_okey"][m]].astype(np.int64)
    rev = (li["l_price"] * (1.0 - li["l_disc"]))[m]
    base = int(orders["o_odate"].min())
    cnt = np.bincount(key - base)
    tot = np.bincount(key - base, weights=rev)
    present = np.flatnonzero(cnt)
    order = present[np.argsort(-tot[present], kind="stable")]
    return order + base, cnt[order], tot[order]


def check_q3(out: HostBatch, oracle) -> None:
    odate, cnt, tot = oracle
    got = out.to_pydict()
    if out.num_rows != len(odate):
        raise AssertionError(f"Q3: {out.num_rows} groups, oracle "
                             f"{len(odate)}")
    if got["o_odate"] != odate.tolist():
        raise AssertionError("Q3: group order differs from the oracle")
    if got["rev_count"] != cnt.tolist():
        raise AssertionError("Q3: counts differ from the oracle")
    np.testing.assert_allclose(got["rev_sum"], tot, rtol=1e-9)
    rs = np.asarray(got["rev_sum"])
    if not np.all(np.isfinite(rs)) or np.any(np.diff(rs) > 0):
        raise AssertionError("Q3: revenues not finite and descending")


def q6_expression():
    """TPC-H Q6's WHERE clause: a conjunction of five comparisons."""
    f, lit, call = pc.field, pc.literal, pc.call
    conds = [call("greater_equal", [f("l_sdate"), lit(Q6_DATE_LO)]),
             call("less", [f("l_sdate"), lit(Q6_DATE_HI)]),
             call("greater_equal", [f("l_disc"), lit(Q6_DISC_LO)]),
             call("less_equal", [f("l_disc"), lit(Q6_DISC_HI)]),
             call("less", [f("l_qty"), lit(Q6_QTY)])]
    pred = conds[0]
    for c in conds[1:]:
        pred = call("and", [pred, c])
    return pred


def q6_revenue(li_db: DeviceBatch):
    """Q6 up to its aggregates: l_price * l_disc over the rows that pass
    the WHERE clause (the column Q6's SUM reduces)."""
    mask = pc.execute_scalar_expression(q6_expression(), li_db)
    li_f = pc.filter(project(li_db, ["l_price", "l_disc"]), mask)
    return pc.execute_scalar_expression(
        pc.call("multiply", [pc.field("l_price"), pc.field("l_disc")]), li_f)


def compute_q6(li_db: DeviceBatch) -> dict:
    """The port's TPC-H Q6:

        SELECT SUM(l_price * l_disc), COUNT(*) FROM lineitem
        WHERE l_sdate >= 8766 AND l_sdate < 9131
          AND l_disc >= 0.05 AND l_disc <= 0.07 AND l_qty < 24
    """
    rev = q6_revenue(li_db)
    return {"revenue": pc.agg_sum(rev),
            "count": pc.agg_count(rev, pc.CountOptions("all"))}


def q6_rows(li) -> np.ndarray:
    """The rows that pass Q6's WHERE clause, by numpy."""
    return ((li["l_sdate"] >= Q6_DATE_LO) & (li["l_sdate"] < Q6_DATE_HI)
            & (li["l_disc"] >= Q6_DISC_LO) & (li["l_disc"] <= Q6_DISC_HI)
            & (li["l_qty"] < Q6_QTY))


def q6_oracle(li) -> dict:
    m = q6_rows(li)
    return {"revenue": float(np.sum(li["l_price"][m] * li["l_disc"][m])),
            "count": int(m.sum())}


def check_q6(got: dict, want: dict) -> None:
    if got["count"] != want["count"] or want["count"] < 1:
        raise AssertionError(f"Q6: count {got['count']}, oracle "
                             f"{want['count']}")
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-9)


SUMMARY_COLUMNS = ["l_qty", "l_sdate", "l_price"]


def compute_summary(li_db: DeviceBatch) -> dict:
    """SELECT COUNT(*), SUM(l_qty), MIN(l_sdate), MAX(l_sdate),
    AVG(l_price), SUM(l_price) FROM lineitem."""
    qty, sdate, price = (li_db.column(c) for c in SUMMARY_COLUMNS)
    return {"count": pc.agg_count(qty, pc.CountOptions("all")),
            "sum_qty": pc.agg_sum(qty), "min_sdate": pc.agg_min(sdate),
            "max_sdate": pc.agg_max(sdate), "avg_price": pc.agg_mean(price),
            "sum_price": pc.agg_sum(price)}


def summary_reductions(li_db: DeviceBatch) -> list:
    """(column, op) of the K3 launches of compute_summary (AVG(l_price)
    reduces as SUM(l_price) does)."""
    qty, sdate, price = (li_db.column(c) for c in SUMMARY_COLUMNS)
    return [(qty, "sum"), (sdate, "min"), (sdate, "max"), (price, "sum")]


def summary_oracle(li) -> dict:
    return {"count": len(li["l_qty"]),
            "sum_qty": int(li["l_qty"].sum(dtype=np.int64)),
            "min_sdate": int(li["l_sdate"].min()),
            "max_sdate": int(li["l_sdate"].max()),
            "avg_price": float(li["l_price"].mean()),
            "sum_price": float(li["l_price"].sum())}


def check_summary(got: dict, want: dict) -> None:
    for k in ("count", "sum_qty", "min_sdate", "max_sdate"):
        if got[k] != want[k] or type(got[k]) is not int:
            raise AssertionError(f"summary {k}: {got[k]!r}, oracle "
                                 f"{want[k]!r}")
    for k in ("avg_price", "sum_price"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9)


# TPC-H Q1 (spec 2.4.1) with its validation substitution DELTA = 90:
# 1998-12-01 - 90 days as days since 1970-01-01
Q1_SHIPDATE_MAX = 10471
# TPC-H spec 4.2.3: CURRENTDATE 1995-06-17 as days since 1970-01-01
CURRENT_DATE = 9298
RFLAG_VALUES = np.array(["N", "R", "A"], dtype=object)
LSTATUS_VALUES = np.array(["O", "F"], dtype=object)
Q1_COLUMNS = ["l_rflag", "l_lstatus", "l_qty", "l_price", "l_disc",
              "l_tax", "l_sdate"]
Q1_SUMS = [("l_qty", "sum"), ("l_price", "sum"), ("disc_price", "sum"),
           ("charge", "sum"), ("l_qty", "mean"), ("l_price", "mean"),
           ("l_disc", "mean"), ("l_qty", "count_all")]


def add_q1_columns(li) -> None:
    """l_tax, l_lstatus and l_rflag after TPC-H spec 4.2.3 (CURRENTDATE
    = day 9298), from a generator of their own (seed 9), so the earlier
    columns stay as they were. The two flags are (int32 codes, values)
    pairs: the codes index RFLAG_VALUES / LSTATUS_VALUES."""
    rng = np.random.default_rng(9)
    sdate = li["l_sdate"]
    n = len(sdate)
    li["l_tax"] = rng.integers(0, 9, n) / 100.0
    li["l_lstatus"] = ((sdate <= CURRENT_DATE).astype(np.int32),
                       LSTATUS_VALUES)
    returned = sdate + rng.integers(1, 31, n) <= CURRENT_DATE
    ra = rng.integers(1, 3, n).astype(np.int32)     # 1 R, 2 A
    li["l_rflag"] = (np.where(returned, ra, 0).astype(np.int32),
                     RFLAG_VALUES)


def compute_q1(li_db: DeviceBatch, mark=lambda stage: None) -> HostBatch:
    """The port's TPC-H Q1:

        SELECT l_rflag, l_lstatus, SUM(l_qty), SUM(l_price),
               SUM(l_price * (1 - l_disc)),
               SUM(l_price * (1 - l_disc) * (1 + l_tax)),
               AVG(l_qty), AVG(l_price), AVG(l_disc), COUNT(*)
        FROM lineitem WHERE l_sdate <= 10471
        GROUP BY l_rflag, l_lstatus ORDER BY l_rflag, l_lstatus

    `mark(stage)` is called as each stage ends (the profile's timer).
    """
    f, lit, call = pc.field, pc.literal, pc.call
    mask = pc.execute_scalar_expression(
        call("less_equal", [f("l_sdate"), lit(Q1_SHIPDATE_MAX)]), li_db)
    mark("predicate")
    li_f = pc.filter(project(li_db, Q1_COLUMNS[:-1]), mask)
    mark("filter")
    disc_price = pc.execute_scalar_expression(call("multiply", [
        f("l_price"), call("subtract", [lit(1.0), f("l_disc")])]), li_f)
    with_dp = DeviceBatch(
        dt.Schema(list(li_f.schema.fields)
                  + [dt.Field("disc_price", dt.float64)]),
        li_f.columns + [disc_price], li_f.length)
    charge = pc.execute_scalar_expression(call("multiply", [
        f("disc_price"), call("add", [lit(1.0), f("l_tax")])]), with_dp)
    gb = DeviceBatch(
        dt.Schema(list(with_dp.schema.fields)
                  + [dt.Field("charge", dt.float64)]),
        with_dp.columns + [charge], with_dp.length)
    mark("expressions")
    g = pc.group_by(gb, ["l_rflag", "l_lstatus"], Q1_SUMS)
    mark("group_by")
    idx = pc.sort_indices(g, pc.SortOptions([pc.SortKey("l_rflag"),
                                             pc.SortKey("l_lstatus")]))
    out = pc.take(g, idx)
    mark("sort_take")
    return out


def q1_oracle(li) -> dict:
    """numpy Q1 over the combined flag code, rows in (l_rflag, l_lstatus)
    string order: the key strings, exact counts and integer sums, float
    sums and means."""
    m = li["l_sdate"] <= Q1_SHIPDATE_MAX
    rcode, rvals = li["l_rflag"]
    scode, svals = li["l_lstatus"]
    key = (rcode[m].astype(np.int64) * len(svals) + scode[m])
    nk = len(rvals) * len(svals)
    price, disc = li["l_price"][m], li["l_disc"][m]
    disc_price = price * (1.0 - disc)
    cnt = np.bincount(key, minlength=nk)
    # integer sums far below 2**53 are exact in float64
    qty = np.bincount(key, weights=li["l_qty"][m], minlength=nk).astype(
        np.int64)
    sums = {c: np.bincount(key, weights=w, minlength=nk) for c, w in (
        ("l_price", price), ("disc_price", disc_price),
        ("charge", disc_price * (1.0 + li["l_tax"][m])), ("l_disc", disc))}
    ks = np.array(sorted(np.flatnonzero(cnt), key=lambda k: (
        rvals[k // len(svals)], svals[k % len(svals)])), np.int64)
    return {"l_rflag": [rvals[k // len(svals)] for k in ks],
            "l_lstatus": [svals[k % len(svals)] for k in ks],
            "l_qty_sum": qty[ks].tolist(),
            "l_price_sum": sums["l_price"][ks],
            "disc_price_sum": sums["disc_price"][ks],
            "charge_sum": sums["charge"][ks],
            "l_qty_mean": qty[ks] / cnt[ks],
            "l_price_mean": sums["l_price"][ks] / cnt[ks],
            "l_disc_mean": sums["l_disc"][ks] / cnt[ks],
            "l_qty_count_all": cnt[ks].tolist()}


def check_q1(out: HostBatch, want: dict) -> None:
    """Keys and their order, counts and integer sums exact; float sums
    and means at rtol 1e-9."""
    got = out.to_pydict()
    if out.num_rows != len(want["l_rflag"]) or out.num_rows < 1:
        raise AssertionError(f"Q1: {out.num_rows} groups, oracle "
                             f"{len(want['l_rflag'])}")
    for k in ("l_rflag", "l_lstatus", "l_qty_sum", "l_qty_count_all"):
        if got[k] != want[k]:
            raise AssertionError(f"Q1 {k}: {got[k]!r}, oracle {want[k]!r}")
    for k in ("l_price_sum", "disc_price_sum", "charge_sum", "l_qty_mean",
              "l_price_mean", "l_disc_mean"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)


AGG_SET = [("l_sdate", "min"), ("l_sdate", "max"), ("l_price", "first"),
           ("l_price", "last"), ("l_price", "count"), ("big_qty", "any"),
           ("big_qty", "all"), ("l_pfac", "product")]


def product_factors(n: int) -> np.ndarray:
    """int64 factors, 1 but for about 30 twos and 30 minus ones at SF10
    (seed 10): every group's true product fits int64."""
    rng = np.random.default_rng(10)
    u = rng.random(n)
    return np.where(u < 5e-7, 2, np.where(u > 1 - 5e-7, -1, 1))


def compute_aggs(li_db: DeviceBatch, pfac) -> HostBatch:
    """Every aggregation that Q1 does not run, grouped by l_rflag over
    the scanned lineitem: MIN/MAX(l_sdate), FIRST/LAST(l_price),
    COUNT(l_price), ANY/ALL(l_qty > 25) and PRODUCT(l_pfac) (`pfac`, a
    device column of product_factors)."""
    big = pc.execute_scalar_expression(
        pc.call("greater", [pc.field("l_qty"), pc.literal(25)]), li_db)
    gb = DeviceBatch(
        dt.Schema([li_db.schema.field(li_db.schema.field_index(c))
                   for c in ("l_rflag", "l_sdate", "l_price")]
                  + [dt.Field("big_qty", dt.bool_),
                     dt.Field("l_pfac", dt.int64)]),
        [li_db.column(c) for c in ("l_rflag", "l_sdate", "l_price")]
        + [big, pfac], li_db.length)
    return pc.group_by(gb, "l_rflag", AGG_SET)


def aggs_oracle(li, pfac) -> dict:
    """numpy per l_rflag group, groups in first-occurrence order."""
    codes, values = li["l_rflag"]
    groups = sorted(np.unique(codes).tolist(),
                    key=lambda g: int(np.argmax(codes == g)))
    out = {k: [] for k in ["l_rflag"] + [f"{c}_{a}" for c, a in AGG_SET]}
    for g in groups:
        rows = np.flatnonzero(codes == g)
        sdate, price = li["l_sdate"][rows], li["l_price"][rows]
        big = li["l_qty"][rows] > 25
        f = pfac[rows]
        prod = (2 ** int((f == 2).sum())) * (-1) ** int((f == -1).sum())
        for k, v in (("l_rflag", values[g]), ("l_sdate_min", sdate.min()),
                     ("l_sdate_max", sdate.max()),
                     ("l_price_first", price[0]),
                     ("l_price_last", price[-1]),
                     ("l_price_count", len(rows)),
                     ("big_qty_any", big.any()), ("big_qty_all", big.all()),
                     ("l_pfac_product", prod)):
            out[k].append(v.item() if hasattr(v, "item") else v)
    return out


def check_aggs(out: HostBatch, want: dict) -> None:
    """Every value exact (first and last are row values, not sums)."""
    got = out.to_pydict()
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"aggregations {k}: {got[k]!r}, oracle "
                                 f"{v!r}")


# TPC-H spec 4.2.3: the five order priorities and the seven ship modes,
# each list in string order, so a code's order is its string's order
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                       "5-LOW"], dtype=object)
SHIPMODES = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK"], dtype=object)
# Q4: two of make_data's 40 o_odate days (about 5% of orders; TPC-H's
# three-month window keeps 3.8%)
Q4_ODATE_LO, Q4_ODATE_HI = 700, 702
# Q12 with its validation substitutions (spec 2.4.12): SHIPMODE1 MAIL,
# SHIPMODE2 SHIP, the year from 1994-01-01 (day 8766) rebased by 234
# days onto the repo's l_sdate span: l_rdate in [9000, 9365)
Q12_MODES = ["MAIL", "SHIP"]
Q12_HIGH = ["1-URGENT", "2-HIGH"]
Q12_RDATE_LO, Q12_RDATE_HI = 9000, 9365


def add_join_columns(li, orders) -> None:
    """The columns TPC-H Q4, Q12 and Q13 read, after TPC-H spec 4.2.3,
    each from a generator of its own so the earlier columns stay as they
    were: o_opri (seed 11; (codes, PRIORITIES)), o_custkey (seed 12; in
    [1, n_cust], never a multiple of 3, n_cust = orders / 10), l_smode
    ((codes, SHIPMODES)), l_rdate = l_sdate + U[1, 30] and l_cdate =
    l_sdate + U[30, 90] - U[1, 121] (seed 13). The spec offsets
    l_cdate from the order date; it is rebased on l_sdate here because
    make_data draws l_sdate independently of o_odate. Returns the
    customer table: c_custkey = 1..n_cust."""
    n_ord = len(orders["o_okey"])
    rng = np.random.default_rng(11)
    orders["o_opri"] = (rng.integers(0, 5, n_ord).astype(np.int32),
                        PRIORITIES)
    n_cust = len(customer_table(n_ord)["c_custkey"])
    rng = np.random.default_rng(12)
    j = rng.integers(0, n_cust - n_cust // 3, n_ord)
    orders["o_custkey"] = 3 * (j // 2) + j % 2 + 1
    rng = np.random.default_rng(13)
    n = len(li["l_sdate"])
    sdate = li["l_sdate"]
    li["l_smode"] = (rng.integers(0, 7, n).astype(np.int32), SHIPMODES)
    li["l_rdate"] = (sdate + rng.integers(1, 31, n)).astype(np.int32)
    li["l_cdate"] = (sdate + rng.integers(30, 91, n)
                     - rng.integers(1, 122, n)).astype(np.int32)
    return customer_table(n_ord)


def customer_table(n_ord: int) -> dict:
    """c_custkey = 1..n_cust, n_cust = orders / 10 (at least 3)."""
    return {"c_custkey": np.arange(1, max(n_ord // 10, 3) + 1,
                                   dtype=np.int64)}


def _sorted_by_key(g: HostBatch, key: str) -> HostBatch:
    return pc.take(g, pc.sort_indices(g, pc.SortOptions([pc.SortKey(key)])))


def q4_exists(ord_f: DeviceBatch, li_f: DeviceBatch) -> DeviceColumn:
    """EXISTS (lineitem row with l_okey = o_okey) per order row: the left
    semi verdict hash_join's record path selects rows by, on the device."""
    from arrow_go_tpu_torch.compute.join import semi_verdict
    verdict = semi_verdict(ord_f, li_f, ["o_okey"], ["l_okey"], "left semi")
    return DeviceColumn(verdict, None, ord_f.length, dt.bool_)


def compute_q4(li_db: DeviceBatch, ord_db: DeviceBatch,
               mark=lambda stage: None) -> HostBatch:
    """The port's TPC-H Q4:

        SELECT o_opri, COUNT(*) FROM orders
        WHERE o_odate >= 700 AND o_odate < 702
          AND EXISTS (SELECT * FROM lineitem
                      WHERE l_okey = o_okey AND l_cdate < l_rdate)
        GROUP BY o_opri ORDER BY o_opri
    """
    f, lit, call = pc.field, pc.literal, pc.call
    o_mask = pc.execute_scalar_expression(call("and", [
        call("greater_equal", [f("o_odate"), lit(Q4_ODATE_LO)]),
        call("less", [f("o_odate"), lit(Q4_ODATE_HI)])]), ord_db)
    ord_f = pc.filter(project(ord_db, ["o_okey", "o_opri"]), o_mask)
    l_mask = pc.execute_scalar_expression(
        call("less", [f("l_cdate"), f("l_rdate")]), li_db)
    li_f = pc.filter(project(li_db, ["l_okey"]), l_mask)
    mark("filters")
    hits = pc.filter(ord_f, q4_exists(ord_f, li_f))
    mark("semi_join")
    g = pc.group_by(hits, "o_opri", [("o_okey", "count_all")])
    mark("group_by")
    out = _sorted_by_key(g, "o_opri")
    mark("sort_take")
    return out


def q4_oracle(li, orders) -> dict:
    codes, values = orders["o_opri"]
    odate = orders["o_odate"]
    exists = np.zeros(len(odate), np.bool_)
    m = li["l_cdate"] < li["l_rdate"]
    exists[li["l_okey"][m]] = True
    keep = exists & (odate >= Q4_ODATE_LO) & (odate < Q4_ODATE_HI)
    cnt = np.bincount(codes[keep], minlength=len(values))
    present = [c for c in np.argsort(values) if cnt[c]]
    return {"o_opri": [values[c] for c in present],
            "o_okey_count_all": [int(cnt[c]) for c in present]}


def q12_predicate():
    """Q12's lineitem predicate: l_smode IN ('MAIL', 'SHIP') AND l_cdate <
    l_rdate AND l_sdate < l_cdate AND l_rdate in [9000, 9365)."""
    f, lit, call = pc.field, pc.literal, pc.call
    pred = call("is_in", [f("l_smode")], {"value_set": Q12_MODES})
    for c in (call("less", [f("l_cdate"), f("l_rdate")]),
              call("less", [f("l_sdate"), f("l_cdate")]),
              call("greater_equal", [f("l_rdate"), lit(Q12_RDATE_LO)]),
              call("less", [f("l_rdate"), lit(Q12_RDATE_HI)])):
        pred = call("and", [pred, c])
    return pred


def compute_q12(li_db: DeviceBatch, ord_db: DeviceBatch,
                mark=lambda stage: None, key_type=None) -> HostBatch:
    """The port's TPC-H Q12 (its group key's field typed `key_type`,
    utf8 unless named):

        SELECT l_smode,
               SUM(CASE WHEN o_opri IN ('1-URGENT', '2-HIGH') THEN 1
                        ELSE 0 END),
               SUM(CASE WHEN o_opri NOT IN ('1-URGENT', '2-HIGH') THEN 1
                        ELSE 0 END)
        FROM orders JOIN lineitem ON o_okey = l_okey
        WHERE (q12_predicate) GROUP BY l_smode ORDER BY l_smode
    """
    f, lit, call = pc.field, pc.literal, pc.call
    mask = pc.execute_scalar_expression(q12_predicate(), li_db)
    li_f = pc.filter(project(li_db, ["l_okey", "l_smode"]), mask)
    mark("filter")
    joined = pc.hash_join(li_f, project(ord_db, ["o_okey", "o_opri"]),
                          left_keys=["l_okey"], right_keys=["o_okey"],
                          output_columns=["l_smode", "o_opri"])
    mark("hash_join")
    high = call("is_in", [f("o_opri")], {"value_set": Q12_HIGH})
    cols = [pc.execute_scalar_expression(
        call("if_else", [cond, lit(1), lit(0)]), joined)
        for cond in (high, call("invert", [high]))]
    gb = DeviceBatch(dt.Schema([dt.Field("l_smode", key_type or dt.string),
                                dt.Field("high", dt.int64),
                                dt.Field("low", dt.int64)]),
                     [joined.column("l_smode")] + cols, joined.length)
    mark("case")
    g = pc.group_by(gb, "l_smode", [("high", "sum"), ("low", "sum")])
    mark("group_by")
    out = _sorted_by_key(g, "l_smode")
    mark("sort_take")
    return out


def q12_oracle(li, orders) -> dict:
    mcodes, modes = li["l_smode"]
    pcodes, pvalues = orders["o_opri"]
    cdate, rdate = li["l_cdate"], li["l_rdate"]
    m = (np.isin(modes[mcodes], Q12_MODES) & (cdate < rdate)
         & (li["l_sdate"] < cdate) & (rdate >= Q12_RDATE_LO)
         & (rdate < Q12_RDATE_HI))
    high = np.isin(pvalues[pcodes[li["l_okey"][m]]], Q12_HIGH)
    k = len(modes)
    hi = np.bincount(mcodes[m][high], minlength=k)
    lo = np.bincount(mcodes[m][~high], minlength=k)
    present = [c for c in np.argsort(modes) if hi[c] + lo[c]]
    return {"l_smode": [modes[c] for c in present],
            "high_sum": [int(hi[c]) for c in present],
            "low_sum": [int(lo[c]) for c in present]}


def compute_q13(cust_db: DeviceBatch, ord_db: DeviceBatch,
                mark=lambda stage: None) -> HostBatch:
    """The port's TPC-H Q13 (without its o_comment NOT LIKE predicate:
    the repo has no comment column and no LIKE):

        SELECT c_count, COUNT(*) AS custdist FROM (
            SELECT c_custkey, COUNT(o_okey) AS c_count
            FROM customer LEFT OUTER JOIN orders ON c_custkey = o_custkey
            GROUP BY c_custkey)
        GROUP BY c_count ORDER BY custdist DESC, c_count DESC
    """
    joined = pc.hash_join(cust_db, project(ord_db, ["o_okey", "o_custkey"]),
                          left_keys=["c_custkey"], right_keys=["o_custkey"],
                          join_type="left outer",
                          output_columns=["c_custkey", "o_okey"])
    mark("hash_join")
    per_cust = pc.group_by(joined, "c_custkey", [("o_okey", "count")])
    mark("group_by_customer")
    counts = agt.batch_to_device({"c_count": per_cust.column(
        "o_okey_count").values}, device=cust_db.columns[0].device)
    g = pc.group_by(counts, "c_count", [("c_count", "count_all")])
    mark("group_by_count")
    idx = pc.sort_indices(g, pc.SortOptions([
        pc.SortKey("c_count_count_all", "descending"),
        pc.SortKey("c_count", "descending")]))
    out = pc.take(g, idx)
    mark("sort_take")
    return out


def q13_oracle(orders, n_cust: int) -> dict:
    per_cust = np.bincount(orders["o_custkey"], minlength=n_cust + 1)[1:]
    dist = np.bincount(per_cust)
    present = np.flatnonzero(dist)
    order = sorted(present.tolist(), key=lambda c: (-dist[c], -c))
    return {"c_count": order,
            "c_count_count_all": [int(dist[c]) for c in order]}


def join_row_counts(li, orders, n_cust: int) -> dict:
    """The row counts of Q4, Q12 and Q13's inputs and stages (numpy)."""
    mcodes, modes = li["l_smode"]
    cdate, rdate = li["l_cdate"], li["l_rdate"]
    odate = orders["o_odate"]
    late = cdate < rdate
    q12 = (np.isin(modes[mcodes], Q12_MODES) & late
           & (li["l_sdate"] < cdate) & (rdate >= Q12_RDATE_LO)
           & (rdate < Q12_RDATE_HI))
    has_order = np.bincount(orders["o_custkey"], minlength=n_cust + 1)[1:]
    return {
        "q4": {"orders": len(odate),
               "orders_in_window": int(((odate >= Q4_ODATE_LO)
                                        & (odate < Q4_ODATE_HI)).sum()),
               "lineitem": len(cdate), "lineitem_commit_before_receipt":
               int(late.sum())},
        "q12": {"lineitem_passing": int(q12.sum())},
        "q13": {"customers": n_cust, "orders": len(odate),
                "customers_without_orders": int((has_order == 0).sum()),
                "joined_rows": len(odate) + int((has_order == 0).sum())}}


def check_rows(what: str, out: HostBatch, want: dict) -> None:
    """Every column of the result exactly as the oracle has it, rows in
    its order."""
    got = out.to_pydict()
    if out.num_rows < 1 or list(got) != list(want):
        raise AssertionError(f"{what}: columns {list(got)}, {out.num_rows} "
                             f"rows; oracle {list(want)}")
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"{what} {k}: {got[k]!r}, oracle {v!r}")


def one_batch(t):
    """A reader's result as one batch: a Table's chunks combined, a batch
    as it is."""
    return t.to_batches()[0]


def write_parquets(jobs: dict, file_s: dict) -> dict:
    """write_parquet of each {name: (table, *arguments)}, a thread a file
    (the codecs and most of numpy release the GIL): {name: bytes}, and
    each file's own seconds, taken while the others ran, into `file_s`.
    Their wall time is not the sum of serial writes that scripts before
    the threads printed as `write_s`."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(k, args):
        t0 = time.perf_counter()
        out = write_parquet(*args)
        file_s[k] = time.perf_counter() - t0
        return out
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {k: pool.submit(timed, k, args) for k, args in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def write_parquet(table: dict, compression: str = "none",
                  column_encodings=None, types=None) -> bytes:
    """One row group, dictionary on (PLAIN past the 1 MiB dictionary
    limit), 8 MiB data pages: the layout of
    benchmarks/engine_e2e.py:write_parquet_ours, UNCOMPRESSED unless
    `compression` names its codec (snappy)."""
    buf = io.BytesIO()
    # (older trees' writers take no column_encodings and no types)
    extra = {"column_encodings": column_encodings} if column_encodings \
        else {}
    if types:
        extra["types"] = types
    tpq.write_table(table, buf, data_page_size=8 << 20,
                    compression=compression, write_page_index=False, **extra)
    return buf.getvalue()


def scan_parquet(blob: bytes, columns=None, device=None,
                 times=None) -> DeviceBatch:
    """Row group 0 of a parquet file onto the device."""
    return tpq.read_batch_device(tpq.ParquetFile(blob), 0, columns=columns,
                                 device=device, times=times)


# ---------------------------------------------------------------------------
# kernel checks and timings
# ---------------------------------------------------------------------------

_INT_VIEW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(_INT_VIEW[t.element_size()])


def _max_abs_err(got, want) -> float:
    """Max |kernel - plain| over payloads, on their bit patterns as ints;
    raises unless they are bit-identical."""
    err = 0.0
    for g, w in zip(got, want):
        gb, wb = _bits(g), _bits(w)
        if g.numel():
            err = max(err, float((gb.to(torch.float64)
                                  - wb.to(torch.float64)).abs().max()))
        if not torch.equal(gb, wb):
            raise AssertionError(f"kernel differs from plain version "
                                 f"({g.dtype}, n={g.numel()}, err={err})")
    return err


def _time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _payloads(kind: str, n: int, g: torch.Generator, dev):
    def ints(dtype):
        return torch.randint(-2 ** 31, 2 ** 31, (n,), generator=g,
                             device=dev, dtype=torch.int64).to(dtype)
    if kind == "bool":
        return (torch.rand(n, generator=g, device=dev) < 0.5,)
    if kind == "int32":
        return (ints(torch.int32),)
    if kind == "int64":
        return (ints(torch.int64) * 3 + 1,)
    if kind == "float16":
        return (torch.randn(n, generator=g, device=dev).to(torch.float16),)
    if kind == "float64":
        return (torch.randn(n, generator=g, device=dev,
                            dtype=torch.float64),)
    return (ints(torch.int64), torch.randn(n, generator=g, device=dev,
                                           dtype=torch.float64),
            ints(torch.int32))


K1_TILE = compaction._TILE
# 1,572,864: Q13's customers, padded (the outer join's null-key rows)
K1_SIZES = (1, 31, K1_TILE - 1, K1_TILE, K1_TILE + 1, 8191, 8192, 65_537,
            1_572_864, 67_108_864)
# 18,350,080 and 42,729,472: Q13's and Q4's join lengths at SF10
K2_SIZES = (1, 31, 8191, 8192, 65_537, 18_350_080, 33_554_432, 42_729_472,
            67_108_864)
K1_MIXED = (torch.bool, torch.int8, torch.int16, torch.float16, torch.int32,
            torch.float32, torch.int64, torch.float64)


def _mixed_payloads(n: int, g: torch.Generator, dev) -> tuple:
    """16 payloads, two of each of K1_MIXED: 1-, 2-, 4- and 8-byte."""
    out = []
    for dtype in K1_MIXED * 2:
        bits = torch.randint(-2 ** 62, 2 ** 62, (n,), generator=g,
                             device=dev)
        if dtype == torch.bool:
            out.append(bits > 0)
        else:
            out.append(bits.to(_INT_VIEW[dtype.itemsize]).view(dtype))
    return tuple(out)


def _k1_case(keep, pays) -> float:
    """K1 against its plain version over the whole length, twice (a
    ticket left set by the first launch would show in the second)."""
    err = 0.0
    for _ in range(2):
        got = compaction.compact_flagged(keep, pays)
        want = compaction.compact_flagged_plain(keep, pays)
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(got, want))
    return err


def check_k1(dev, sizes=K1_SIZES) -> float:
    """K1 bit for bit against its plain version over the whole length:
    sizes around one and two tiles, densities 0 to 1, every element
    size; 16 mixed payloads; keep and payloads as views at an element
    offset (not 16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(1)
    err = 0.0
    cases = 0
    for n in sizes:
        for density in (0.0, 0.01, 0.5, 1.0):
            keep = torch.rand(n, generator=g, device=dev) < density
            for kind in ("bool", "int32", "int64", "float16", "float64",
                         "three"):
                err = max(err, _k1_case(keep, _payloads(kind, n, g, dev)))
                cases += 1
            if n <= 65_537 or density == 0.5:
                err = max(err, _k1_case(keep, _mixed_payloads(n, g, dev)))
                cases += 1
        for off in (1, 3):
            # views at an element offset: keep and every payload start
            # off elements into a larger tensor
            keep = (torch.rand(n + off, generator=g, device=dev) < 0.5)[off:]
            pays = tuple(p[off:] for p in _payloads("three", n + off, g, dev)
                         + _mixed_payloads(n + off, g, dev)[:13])
            assert all(p.data_ptr() % 16 for p in (keep,) + pays[:3])
            err = max(err, _k1_case(keep, pays))
            cases += 1
    print(f"K1 check: {cases} cases bit-identical to the plain version "
          f"over the whole length, each launched twice")
    return err


def _u32(n: int, g: torch.Generator, dev) -> torch.Tensor:
    return torch.randint(0, 2 ** 32, (n,), generator=g, device=dev)


def _join_like_lanes(n: int, total: int, g: torch.Generator, dev,
                     set_share: float, random_hi: bool = False):
    """Lanes as the join's expansion scatters them: owner bases (monotone,
    or random u32 with `random_hi`) at set slots, zero (unset) slots
    elsewhere, nothing past `total`."""
    j = torch.arange(n, device=dev, dtype=torch.int64)
    is_set = (torch.rand(n, generator=g, device=dev) < set_share) & (
        j < total)
    is_set[0] = total > 0
    hi = torch.where(is_set, _u32(n, g, dev) if random_hi else j, 0)
    los = [torch.where(is_set, _u32(n, g, dev), 0) for _ in range(2)]
    return hi, los


def _fill_inputs(n: int, g: torch.Generator, dev):
    """The join state's one-lane fills (cummax_u32): run-start marks that
    grow along the rows, zero elsewhere (R_before, L_before), and
    grp_L_end's input, imax - end-of-run marks, reversed."""
    marks = torch.cumsum(torch.randint(0, 3, (n,), generator=g,
                                       device=dev), 0)
    at = torch.rand(n, generator=g, device=dev) < 0.3
    imax = (1 << 31) - 1
    return (torch.where(at, marks, 0),
            torch.flip(imax - torch.where(at, marks, imax), (0,)))


def _k2_case(hi, los) -> float:
    """K2 against its plain version, launched twice (look-back scratch
    left stale by the first launch would show in the second). No lo lane
    is the hi-only mode, called through cummax_u32 as the join state
    calls it."""
    if los:
        want = scan.cummax_u64_lanes_plain(hi, los)

        def run():
            return scan.cummax_u64_lanes(hi, los)
    else:
        want = [scan.cummax_u32_plain(hi)]

        def run():
            return [scan.cummax_u32(hi)]
    err = 0.0
    for _ in range(2):
        got = run()
        torch.cuda.synchronize()
        err = max(err, _max_abs_err(got, want))
    return err


def check_k2(dev, sizes=K2_SIZES) -> float:
    """K2 bit for bit against its plain version at every size, each case
    launched twice: the join's pack lanes (one and two lo lanes, as the
    encode and the expansion call it, and three and four), and the
    hi-only mode on the join state's fills (run-start marks, the
    reversed fill) and on random u32 values; both modes on views at an
    element offset (not 16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(2)
    err = 0.0
    cases = 0
    for n in sizes:
        for share, random_hi in ((0.001, False), (0.3, False), (1.0, False),
                                 (0.3, True)):
            hi, los = _join_like_lanes(n, n - n // 9, g, dev, share,
                                       random_hi)
            for lanes in (los[:1], los):    # the encode's, the expansion's
                err = max(err, _k2_case(hi, lanes))
                cases += 1
        more = [_u32(n, g, dev) for _ in range(2)]
        for lanes in (los + more[:1], los + more):
            err = max(err, _k2_case(hi, lanes))
            cases += 1
        for x in _fill_inputs(n, g, dev) + (_u32(n, g, dev),):
            err = max(err, _k2_case(x, []))
            cases += 1
        hi, los = _join_like_lanes(n + 1, n, g, dev, 0.3)
        hi, los = hi[1:], [lo[1:] for lo in los]
        assert hi.data_ptr() % 16 and los[0].data_ptr() % 16
        for lanes in (los, []):
            err = max(err, _k2_case(hi, lanes))
            cases += 1
    print(f"K2 check: {cases} cases bit-identical to the plain version, "
          f"each launched twice")
    return err


def capture_k1(fn):
    """Run fn once with every K1 call site of the engine recording what
    it hands K1. Returns (fn's result, [(site, keep, payloads)]), site
    being the function that asked for the compaction."""
    from arrow_go_tpu_torch.compute import join as cjoin
    from arrow_go_tpu_torch.ops import groupagg, selection
    from arrow_go_tpu_torch.parallel import join as pjoin
    calls = []

    def recording(keep, payloads):
        payloads = tuple(payloads)
        caller = sys._getframe(1).f_code.co_name
        if caller == "compact_runs":           # groupagg's thin wrapper
            caller = sys._getframe(2).f_code.co_name
        calls.append((caller, keep, payloads))
        return compaction.compact_flagged(keep, payloads)

    mods = (selection, groupagg, pjoin, cjoin)
    saved = [m.compact_flagged for m in mods]
    for m in mods:
        m.compact_flagged = recording
    try:
        out = fn()
    finally:
        for m, f in zip(mods, saved):
            m.compact_flagged = f
    return out, calls


def check_path_calls(name: str, fn, counted: dict, k3: bool = False):
    """Run fn once with every K1 and K2 call site holding each call's
    result against the plain version on the same inputs, bit for bit
    (these launches compare; they are not the path's counted run), and
    with `k3` every K3 call of the aggregates (reduce_with_count_host)
    and of `reduce` itself too, as check_k3 holds K3. Fails unless as many calls were held as
    `counted` says the path's counted run launched. Returns (fn's
    result, {kernel: summary})."""
    from arrow_go_tpu_torch.compute import join as cjoin, run_ends
    from arrow_go_tpu_torch.ops import groupagg, hashing, selection
    from arrow_go_tpu_torch.parallel import join as pjoin
    seen = {"K1": [], "K2": []}
    if k3:
        seen["K3"] = []
    reduce_host = reductions.reduce_with_count_host
    reduce_dev = reductions.reduce
    fill_u32 = scan.cummax_u32

    def k1(keep, payloads):
        payloads = tuple(payloads)
        got = compaction.compact_flagged(keep, payloads)
        if keep.shape[0]:
            seen["K1"].append((keep.shape[0], len(payloads), _max_abs_err(
                got, compaction.compact_flagged_plain(keep, payloads))))
        return got

    def k2(hi, los):
        los = list(los)
        got = scan.cummax_u64_lanes(hi, los)
        if hi.shape[0]:
            seen["K2"].append((hi.shape[0], len(los), _max_abs_err(
                got, scan.cummax_u64_lanes_plain(hi, los))))
        return got

    def k2_fill(x):
        # the hi-only mode, shown as 0 lo lanes
        got = fill_u32(x)
        if x.shape[0]:
            seen["K2"].append((x.shape[0], 0, _max_abs_err(
                [got], [scan.cummax_u32_plain(x)])))
        return got

    def k3_held(values, op, acc, want) -> None:
        if values.dtype.is_floating_point and op == "sum":
            ok = np.isclose(acc, want, rtol=K3_RTOL[values.dtype], atol=0)
        else:
            ok = acc == want
        if not ok:
            raise AssertionError(f"{name}: K3 {acc!r}, plain {want!r}")
        seen["K3"].append((values.shape[0], 1, abs(acc - want)))

    def k3_host(values, validity, n, op):
        acc, count = reduce_host(values, validity, n, op)
        want, want_count = reductions.reduce_with_count_plain(
            values, validity, n, op)
        if count != int(want_count):
            raise AssertionError(f"{name}: K3 count {count}, plain "
                                 f"{int(want_count)}")
        k3_held(values, op, acc, want.item())
        return acc, count

    def k3_reduce(values, validity, n, op):
        got = reduce_dev(values, validity, n, op)
        k3_held(values, op, got.item(), reductions.reduce_plain(
            values, validity, n, op).item())
        return got

    patches = [(m, "compact_flagged", k1)
               for m in (selection, groupagg, pjoin, cjoin, run_ends)] + [
        (pjoin, "cummax_u64_lanes", k2), (hashing, "cummax_u64_lanes", k2),
        (pjoin, "cummax_u32", k2_fill), (scan, "cummax_u32", k2_fill)] + (
        [(reductions, "reduce_with_count_host", k3_host),
         (reductions, "reduce", k3_reduce)] if k3 else [])
    saved = [(m, attr, getattr(m, attr)) for m, attr, _ in patches]
    for m, attr, f in patches:
        setattr(m, attr, f)
    try:
        out = fn()
    finally:
        for m, attr, f in saved:
            setattr(m, attr, f)
    summary = {}
    for k, calls in seen.items():
        if len(calls) != counted[k]:
            raise AssertionError(f"{name}: held {len(calls)} {k} calls "
                                 f"against the plain version, counted "
                                 f"{counted[k]} launches")
        summary[k] = {"calls": len(calls),
                      "shapes": sorted({(n, lanes) for n, lanes, _ in calls}),
                      "max_abs_err": max((e for *_, e in calls), default=0.0)}
    return out, summary


def _k1_library(keep, pays):
    """One PyTorch call that computes K1's kept rows: boolean indexing
    of the payloads stacked as rows (one element size) or packed side by
    side as bytes (mixed sizes)."""
    sizes = {p.element_size() for p in pays}
    if len(sizes) == 1:
        stacked = torch.stack([_bits(p) for p in pays])
        return lambda: stacked[:, keep]
    packed = torch.cat([p.view(torch.uint8).view(-1, p.element_size())
                        for p in pays], 1)
    return lambda: packed[keep]


def time_k1(calls) -> list:
    """K1 at each shape the main path hands it (capture_k1), on those
    very inputs: kernel, plain version and library call, and the bound:
    keep read once and every payload read and written once. copy_ms is
    a device copy of every payload (one `copy_` each): the rate a plain
    read and write of the same payload bytes reaches on this card."""
    out = []
    for site, keep, pays in calls:
        P = keep.numel()
        nbytes = P + 2 * sum(p.numel() * p.element_size() for p in pays)
        copies = [torch.empty_like(p) for p in pays]
        out.append({
            "site": site, "P": P, "kept": int(keep.sum()),
            "payloads": "+".join(str(p.dtype).replace("torch.", "")
                                 for p in pays),
            "ms": _time_ms(lambda: compaction.compact_flagged(keep, pays),
                           20),
            "plain_ms": _time_ms(
                lambda: compaction.compact_flagged_plain(keep, pays), 5),
            "library_ms": _time_ms(_k1_library(keep, pays), 10),
            "copy_ms": _time_ms(lambda: [c.copy_(p) for c, p in
                                         zip(copies, pays)], 10),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bytes": nbytes,
        })
        del copies
    return out


def time_k2(dev, n: int, total: int) -> dict:
    """K2 at the Q3 join expansion's shape: cap slots, hi + 2 lo lanes.
    copy_ms is a device copy of the three lanes (one `copy_` each): the
    rate a plain read and write of the same bytes reaches."""
    g = torch.Generator(device=dev).manual_seed(4)
    hi, los = _join_like_lanes(n, total, g, dev, 1.0)
    packs = torch.stack([(hi << 32) | lo for lo in los])
    nbytes = 2 * 8 * n * (1 + len(los))
    copies = [torch.empty_like(hi) for _ in range(1 + len(los))]
    return {
        "ms": _time_ms(lambda: scan.cummax_u64_lanes(hi, los), 20),
        "plain_ms": _time_ms(lambda: scan.cummax_u64_lanes_plain(hi, los),
                             5),
        "library_ms": _time_ms(lambda: torch.cummax(packs, 1), 10),
        "copy_ms": _time_ms(lambda: [c.copy_(t) for c, t in
                                     zip(copies, [hi] + los)], 10),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "shape": f"n={n}, hi + 2 lo lanes",
    }


K3_SIZES = (1, 31, 127, 128, 8191, 65_537, 16_777_216, 67_108_864)
K3_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64)
K3_RTOL = {torch.float32: 1e-5, torch.float64: 1e-9}


def _k3_inputs(dtype, n: int, P: int, g: torch.Generator, dev):
    """(values for sum/min/max, values for prod) over P rows, junk in
    [n, P). Float values are uniform in [0, 1), so a float sum has no
    cancellation to amplify the order-of-addition error; product values
    are +-1 with a few powers of two, so every product is exact in any
    order and is compared bit for bit."""
    if dtype.is_floating_point:
        v = torch.rand(P, generator=g, device=dev, dtype=dtype)
        junk = torch.tensor([float("nan"), float("inf"), float("-inf"),
                             torch.finfo(dtype).max], dtype=dtype, device=dev)
    else:
        info = torch.iinfo(dtype)
        v = torch.randint(info.min, info.max, (P,), generator=g, device=dev,
                          dtype=torch.int64).to(dtype)
        junk = torch.tensor([info.min, info.max], dtype=dtype, device=dev)
    sign = torch.rand(P, generator=g, device=dev) < 0.5
    prod = torch.where(sign, 1, -1).to(dtype)
    twos = torch.randint(0, max(n, 1), (12,), generator=g, device=dev)
    prod[twos[:6]] = 2
    if dtype.is_floating_point:
        prod[twos[6:]] = 0.5
    tail = torch.randint(0, len(junk), (P - n,), generator=g, device=dev)
    for t in (v, prod):
        t[n:] = junk[tail]
    return v, prod


def _k3_words(density, n: int, P: int, g: torch.Generator, dev):
    """Validity words with the given share of set bits (all bits in
    [n, P) set, so only `i < n` keeps the junk out), or None."""
    if density is None:
        return None
    bits = torch.rand(P, generator=g, device=dev) < density
    bits[n:] = True
    return bitmap.pack_mask(bits)


def _k3_compare(got, again, want, dtype, op, what) -> float:
    """|kernel - plain|; raises unless two launches gave the same bits
    and the kernel agrees with the plain version (bit for bit, or at
    K3_RTOL for float sums)."""
    if not torch.equal(_bits(got.reshape(1)), _bits(again.reshape(1))):
        raise AssertionError(f"K3 {what}: two launches differ")
    g, w = got.item(), want.item()
    if isinstance(g, float) and np.isnan(g) and np.isnan(w):
        return 0.0                   # NaN payloads are not compared
    if dtype.is_floating_point and op == "sum":
        ok = np.isclose(g, w, rtol=K3_RTOL[dtype], atol=0)
    else:
        ok = torch.equal(_bits(got.reshape(1)), _bits(want.reshape(1)))
    if not ok:
        raise AssertionError(f"K3 {what}: {g!r} vs plain {w!r}")
    return abs(g - w)


def _k3_with_count(x, words, n, op, other, dtype, what) -> float:
    """reduce_with_count against reduce_plain + count_valid: the count
    exact, the accumulator as _k3_compare holds it, and the pair the
    same over two launches, and over two more with a launch on `other`
    (another input) between them, so that a ticket left set would show."""
    want, want_count = reductions.reduce_with_count_plain(x, words, n, op)
    runs = [reductions.reduce_with_count(x, words, n, op) for _ in range(2)]
    runs.append(reductions.reduce_with_count(x, words, n, op))
    reductions.reduce_with_count(*other)
    runs.append(reductions.reduce_with_count(x, words, n, op))
    err = 0.0
    for (acc, count), (again, count2) in zip(runs[::2], runs[1::2]):
        if count.item() != want_count.item() or \
                count2.item() != want_count.item():
            raise AssertionError(f"K3 count {what}: {count.item()} / "
                                 f"{count2.item()}, plain "
                                 f"{want_count.item()}")
        err = max(err, _k3_compare(acc, again, want, dtype, op,
                                   f"with count {what}"))
    if not torch.equal(_bits(runs[0][0].reshape(1)),
                       _bits(runs[2][0].reshape(1))):
        raise AssertionError(f"K3 {what}: a launch between two launches "
                             f"changed the result")
    return err


def check_k3(dev, sizes=K3_SIZES) -> float:
    """K3 over the sweep, through reduce and through reduce_with_count
    (whose count must be exact)."""
    g = torch.Generator(device=dev).manual_seed(5)
    other_v = torch.rand(1024, generator=g, device=dev, dtype=torch.float64)
    other = (other_v, _k3_words(0.3, 999, 1024, g, dev), 999, "sum")
    err = 0.0
    cases = 0
    for n in sizes:
        P = agt.pad_length(n)
        for dtype in K3_DTYPES:
            v, prod = _k3_inputs(dtype, n, P, g, dev)
            for density in (None, 0.0, 0.5, 1.0):
                words = _k3_words(density, n, P, g, dev)
                for op in reductions.OPS:
                    x = prod if op == "prod" else v
                    what = f"{dtype} {op} n={n} density={density}"
                    got = reductions.reduce(x, words, n, op)
                    again = reductions.reduce(x, words, n, op)
                    want = reductions.reduce_plain(x, words, n, op)
                    err = max(err, _k3_compare(got, again, want, dtype, op,
                                               what))
                    err = max(err, _k3_with_count(x, words, n, op, other,
                                                  dtype, what))
                    cases += 1
            if not dtype.is_floating_point:
                continue
            # NaN in a counted row propagates; in a null row it does not
            row = n // 2
            v[row] = float("nan")
            prod[row] = float("nan")
            bits = torch.ones(P, dtype=torch.bool, device=dev)
            bits[row] = False
            hidden = bitmap.pack_mask(bits)
            for words, nan in ((None, True), (hidden, False)):
                for op in reductions.OPS:
                    x = prod if op == "prod" else v
                    got = reductions.reduce(x, words, n, op)
                    want = reductions.reduce_plain(x, words, n, op)
                    if bool(torch.isnan(got)) != nan:
                        raise AssertionError(f"K3 NaN {dtype} {op} n={n}: "
                                             f"{got.item()!r}")
                    what = f"NaN {dtype} {op} n={n} nan={nan}"
                    err = max(err, _k3_compare(
                        got, reductions.reduce(x, words, n, op), want,
                        dtype, op, what))
                    err = max(err, _k3_with_count(x, words, n, op, other,
                                                  dtype, what))
                    cases += 1
    torch.cuda.synchronize()
    print(f"K3 check: {cases} cases through reduce and reduce_with_count; "
          f"ints, min, max and products bit-identical to the plain "
          f"version, float sums within rtol, counts exact, results the "
          f"same over repeated and interleaved launches; max |kernel - "
          f"plain| {err!r}")
    return err


def check_k3_at(what: str, reductions_of_path) -> float:
    """K3 against its plain version on the very inputs a path hands it:
    each (column, op) reduced as agg_* reduces it (values, validity
    words, length), compared as check_k3 compares."""
    err = 0.0
    for col, op in reductions_of_path:
        x, w, n = col.values, col.validity, col.length
        err = max(err, _k3_compare(
            reductions.reduce(x, w, n, op), reductions.reduce(x, w, n, op),
            reductions.reduce_plain(x, w, n, op), x.dtype, op,
            f"{what} {x.dtype} {op} n={n} P={x.shape[0]}"))
    shapes = sorted({(c.length, c.padded, str(c.values.dtype))
                     for c, _ in reductions_of_path})
    print(f"K3 at the {what} shapes (n, P, dtype) {shapes}: "
          f"{len(reductions_of_path)} reductions agree with the plain "
          f"version; max |kernel - plain| {err!r}", flush=True)
    return err


def time_k3(dev, P: int, n: int) -> list:
    """K3 at the lineitem summary's shape (P padded rows, n real): an
    f64 sum without validity (SUM(l_price)) and an int32 min with
    validity words at density 0.5. The library call is one torch call
    over the n rows (with a where() against a precomputed mask when
    there is validity); the bound reads the n values (and their words)
    once at the memory rate."""
    g = torch.Generator(device=dev).manual_seed(6)
    f64 = torch.rand(P, generator=g, device=dev, dtype=torch.float64)
    i32 = torch.randint(-2 ** 31, 2 ** 31, (P,), generator=g, device=dev,
                        dtype=torch.int64).to(torch.int32)
    words = _k3_words(0.5, n, P, g, dev)
    mask = bitmap.expand_words(words, P)[:n]
    imax = torch.iinfo(torch.int32).max
    out = []
    for name, x, w, op, lib in (
            ("f64 sum, no validity", f64, None, "sum",
             lambda: torch.sum(f64[:n])),
            ("int32 min, validity 0.5", i32, words, "min",
             lambda: torch.where(mask, i32[:n], imax).amin())):
        nbytes = n * x.element_size() + (0 if w is None else -(-n // 32) * 4)
        out.append({
            "shape": f"{name}, P={P}, n={n}",
            "ms": _time_ms(lambda: reductions.reduce(x, w, n, op), 50),
            "plain_ms": _time_ms(
                lambda: reductions.reduce_plain(x, w, n, op), 10),
            "library_ms": _time_ms(lib, 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        })
    return out


def profile_device(fn, check, top: int = 12) -> dict:
    """The device activity (kernels, copies, fills) of one unsynchronized
    run of `fn` under torch.profiler. Their summed time over the run's
    wall time is the device's busy share (one stream, so activities do
    not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    check(out)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3,
                               calls + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
            "top_device_ms": [[name[:90], ms, calls]
                              for name, (ms, calls) in ranked]}


def profile_stages(run, check) -> dict:
    """Where one run's time goes: the host-clock time of each stage of
    `run(mark)` (synchronized at each stage's end), then the device
    activity of one more run (profile_device)."""
    stages = {}
    last = [0.0]

    def mark(stage):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[stage] = (now - last[0]) * 1e3
        last[0] = now

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    check(run(mark))
    return {"stages_ms": stages, **profile_device(lambda: run(
        lambda stage: None), check)}


def profile_q3(li_db, ord_db, oracle) -> dict:
    return profile_stages(
        lambda mark: compute_q3(li_db, ord_db, CUTOFF, mark),
        lambda out: check_q3(out, oracle))


def _nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def kernel_launches() -> dict:
    """Launches of K1, K2 and K3 counted so far (utils/metrics.py)."""
    return {k: metrics.counter(f"kernel.{k}").count for k in KERNELS}


def run_path(name: str, fn, needs):
    """Drive one path once, counting each kernel's launches from just
    before it to just after; fails unless each kernel in `needs`
    launched. Returns (result, counts)."""
    before = kernel_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: n - before[k] for k, n in kernel_launches().items()}
    missing = [k for k in needs if counts[k] < 1]
    if missing:
        raise AssertionError(f"{name} did not launch {missing}: {counts}")
    return out, counts


def timed(fn, reps: int = 3):
    """(outputs, host-clock ms of each run), each run ending in a
    device synchronize."""
    outs, runs = [], []
    for _ in range(reps):
        t = time.perf_counter()
        outs.append(fn())
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    return outs, runs


def check_scan(dbs: dict, sources: dict, types=None) -> None:
    """Every scanned column equals its numpy source over [0, n), at the
    padded length pad_length(n): values bit for bit; a string column,
    given as (codes, values), by its codes and its dictionary; a column
    named in `types` has that type."""
    for tname, db in dbs.items():
        for name, want in sources[tname].items():
            c = db.column(name)
            if types and name in types and c.type != types[name]:
                raise AssertionError(f"scan {tname}.{name}: type {c.type}")
            if isinstance(want, tuple):
                want, values = want
                if c.dict_values is None or \
                        list(c.dict_values) != list(values):
                    raise AssertionError(f"scan {tname}.{name}: dictionary "
                                         f"{c.dict_values!r}")
            n = len(want)
            if db.length != n or c.length != n or \
                    c.padded != agt.pad_length(n) or c.validity is not None:
                raise AssertionError(f"scan {tname}.{name}: length "
                                     f"{c.length}/{n}, padded {c.padded}")
            got = c.values[:n].cpu().numpy()
            if got.dtype != want.dtype or not np.array_equal(
                    got.view(f"u{got.itemsize}"),
                    want.view(f"u{want.itemsize}")):
                raise AssertionError(f"scan {tname}.{name}: values differ")


def time_scan(blobs: dict, dev, sources: dict, types=None,
              check=None) -> dict:
    """Three scans of every column of both files, the first checked
    against the numpy sources (by `check`, check_scan unless named):
    each run's ms, and the median run's host-parse / host-to-device /
    device-decode split."""
    runs = []
    for i in range(3):
        phases = {}
        t = time.perf_counter()
        dbs = {k: scan_parquet(b, device=dev, times=phases)
               for k, b in blobs.items()}
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t) * 1e3, phases))
        if i == 0:
            (check or check_scan)(dbs, sources, types)
        del dbs
    med = sorted(runs, key=lambda r: r[0])[1]
    file_bytes = sum(len(b) for b in blobs.values())
    return {"ms_runs": [r[0] for r in runs], "ms_median": med[0],
            "median_split_ms": {k[:-2] + "_ms": v * 1e3
                                for k, v in med[1].items()},
            "file_bytes": file_bytes,
            "file_gb_per_s": file_bytes / med[0] / 1e6, "verified": True}


def _print_ptxas(names) -> None:
    """Each source's kernels: how many, their registers, and any spill."""
    for name in names:
        lib = cuda_build.library_path(name)
        lines = lib.with_name(lib.name + ".log").read_text().splitlines()
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                if "registers" in ln]
        spills = [ln.strip() for ln in lines if any(
            int(b) for b in re.findall(r"(\d+) bytes spill", ln))]
        print(f"ptxas {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
              f"registers, spills: {spills or 'none'}")


def profile_q1(li_db, want) -> dict:
    return profile_stages(lambda mark: compute_q1(li_db, mark),
                          lambda out: check_q1(out, want))


def print_k1_shapes(line: str, k1s) -> None:
    for t in k1s:
        print(f"K1 at {t['site']} (P={t['P']}, {t['payloads']}, "
              f"kept {t['kept']}): kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"copy {t['copy_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    print(json.dumps({line: k1s}), flush=True)


def q1_phases(li, orders, dev) -> dict:
    """This slice's paths: the engine's snappy files (every column read
    back bit for bit, with the decompress split), DELTA_BINARY_PACKED
    key columns, TPC-H Q1 device-resident and from snappy bytes, K1 at
    Q1's call sites, and every other aggregation over the scanned
    lineitem. Returns each path's launch counts."""
    launches = {}
    add_q1_columns(li)
    t0, file_s = time.perf_counter(), {}
    files = write_parquets({
        "lineitem": (li, "snappy", None, LI_TYPES),
        "orders": (orders, "snappy"),
        "l_okey": ({"l_okey": li["l_okey"]}, "snappy",
                   {"l_okey": "delta_binary_packed"}),
        "o_okey": ({"o_okey": orders["o_okey"]}, "snappy",
                   {"o_okey": "delta_binary_packed"})}, file_s)
    write_s = time.perf_counter() - t0
    snappy = {k: files[k] for k in ("lineitem", "orders")}
    delta = {k: files[k] for k in ("l_okey", "o_okey")}
    encodings = {}
    for tname, blob in {**snappy, **delta}.items():
        pf = tpq.ParquetFile(blob)
        for c in pf.metadata.row_groups[0].columns:
            encodings[f"{tname}.{c.meta_data.path_in_schema[0]}"] = [
                tpq.format.Encoding(e).name for e in c.meta_data.encodings]
    print(json.dumps({"parquet_snappy": {
        "write_s": write_s, "write_file_s": file_s,
        "bytes": {k: len(b) for k, b in {**snappy, **delta}.items()},
        "encodings": encodings}}), flush=True)
    print(json.dumps({"scan_snappy": time_scan(
        snappy, dev, {"lineitem": li, "orders": orders}, LI_TYPES)}),
        flush=True)
    print(json.dumps({"scan_delta": time_scan(
        delta, dev, {"l_okey": {"l_okey": li["l_okey"]},
                     "o_okey": {"o_okey": orders["o_okey"]}})}), flush=True)

    want = q1_oracle(li)
    n_li = len(li["l_sdate"])
    li_db = agt.batch_to_device({c: li[c] for c in Q1_COLUMNS}, device=dev)
    out, launches["Q1"] = run_path("Q1", lambda: compute_q1(li_db),
                                   ("K1",))
    check_q1(out, want)
    outs, runs = timed(lambda: compute_q1(li_db))
    for out in outs:
        check_q1(out, want)
    n_pass = int(sum(out.column("l_qty_count_all").to_pylist()))
    print(json.dumps({"q1": {
        "lineitem_rows": n_li, "rows_passing": n_pass,
        "selectivity": n_pass / n_li, "groups": out.num_rows,
        "result": out.to_pydict(), "ms_runs": runs,
        "ms_median": float(np.median(runs)),
        "rows_per_s": n_li / float(np.median(runs)) * 1e3,
        "launches_per_run": launches["Q1"], "verified": True}}), flush=True)
    print(json.dumps({"q1_profile": profile_q1(li_db, want)}), flush=True)
    out, calls = capture_k1(lambda: compute_q1(li_db))
    check_q1(out, want)
    if len(calls) != launches["Q1"]["K1"]:
        raise AssertionError(f"captured {len(calls)} K1 calls of Q1, "
                             f"counted {launches['Q1']['K1']}")
    k1s = time_k1(calls)
    del calls, li_db
    print_k1_shapes("k1_q1_shapes", k1s)

    def q1_from_bytes():
        return compute_q1(scan_parquet(snappy["lineitem"], Q1_COLUMNS, dev))
    out, launches["Q1 from bytes"] = run_path("Q1 from bytes",
                                              q1_from_bytes, ("K1",))
    check_q1(out, want)
    outs, runs = timed(q1_from_bytes)
    for out in outs:
        check_q1(out, want)
    print(json.dumps({"q1_from_bytes": {
        "ms_runs": runs, "ms_median": float(np.median(runs)),
        "launches_per_run": launches["Q1 from bytes"], "verified": True}}),
        flush=True)

    # the other aggregations, over the scanned (snappy) lineitem
    pfac_np = product_factors(n_li)
    li_s = scan_parquet(snappy["lineitem"],
                        ["l_rflag", "l_sdate", "l_price", "l_qty"], dev)
    pfac = agt.batch_to_device({"l_pfac": pfac_np}, device=dev).column(0)
    want_aggs = aggs_oracle(li, pfac_np)
    out, launches["aggregations"] = run_path(
        "aggregations", lambda: compute_aggs(li_s, pfac), ("K1",))
    check_aggs(out, want_aggs)
    outs, runs = timed(lambda: compute_aggs(li_s, pfac))
    for out in outs:
        check_aggs(out, want_aggs)
    print(json.dumps({"aggregations": {
        "result": out.to_pydict(), "ms_runs": runs,
        "ms_median": float(np.median(runs)),
        "launches_per_run": launches["aggregations"], "verified": True}}),
        flush=True)
    return {"launches": launches, "k1s": k1s, "snappy": snappy}


# the join sweep's sides: lineitem rows with l_cdate < l_rdate shipped
# before day 9200 (11 M rows at SF10, over PROBE_CHUNK_DEFAULT, so the
# HostBatch route streams them in chunks) and orders dated before day
# 710 (a quarter); every 101st lineitem and 97th order key is null
SWEEP_SDATE_MAX = 9200
SWEEP_ODATE_MAX = 710
SWEEP_HOWS = ("inner", "left outer", "right outer", "full outer",
              "left semi", "left anti", "right semi", "right anti")


def sweep_sides(li, orders):
    """numpy sides of the join sweep: {column: (values, valid or None,
    dictionary or None)} for lineitem (l_okey, l_smode) and orders
    (o_okey, o_opri)."""
    m = (li["l_cdate"] < li["l_rdate"]) & (li["l_sdate"] < SWEEP_SDATE_MAX)
    r = orders["o_odate"] < SWEEP_ODATE_MAX
    lk, rk = li["l_okey"][m], orders["o_okey"][r]
    return ({"l_okey": (lk, np.arange(len(lk)) % 101 != 0, None),
             "l_smode": (li["l_smode"][0][m], None, SHIPMODES)},
            {"o_okey": (rk, np.arange(len(rk)) % 97 != 0, None),
             "o_opri": (orders["o_opri"][0][r], None, PRIORITIES)})


def sweep_host_batch(side: dict) -> HostBatch:
    arrays = {}
    for name, (vals, valid, dictionary) in side.items():
        t = dt.int64 if dictionary is None else dt.string
        arrays[name] = HostArray(vals, valid, t, dictionary)
    return HostBatch.from_arrays(arrays)


def sweep_oracle(left: dict, right: dict, how: str) -> dict:
    """{output column: (valid rows, sum of the valid values)} of the
    join, a string column summed by its value's index in SHIPMODES or
    PRIORITIES, and the output row count under "rows"."""
    lk, lvalid, _ = left["l_okey"]
    rk, rvalid, _ = right["o_okey"]
    pos = np.full(int(max(lk.max(initial=0), rk.max(initial=0))) + 1, -1)
    pos[rk[rvalid]] = np.flatnonzero(rvalid)
    lmatch = np.where(lvalid, pos[lk], -1)
    li_in = np.flatnonzero(lmatch >= 0)
    rmatched = np.zeros(len(rk), np.bool_)
    rmatched[lmatch[li_in]] = True
    none = np.zeros(0, np.int64)
    l_un, r_un = np.flatnonzero(lmatch < 0), np.flatnonzero(~rmatched)
    li, ri = {
        "inner": (li_in, lmatch[li_in]),
        "left outer": (np.arange(len(lk)), lmatch),
        "right outer": (np.concatenate([li_in, np.full(len(r_un), -1)]),
                        np.concatenate([lmatch[li_in], r_un])),
        "full outer": (np.concatenate([li_in, l_un,
                                       np.full(len(r_un), -1)]),
                       np.concatenate([lmatch[li_in],
                                       np.full(len(l_un), -1), r_un])),
        "left semi": (li_in, None), "left anti": (l_un, None),
        "right semi": (None, np.flatnonzero(rmatched)),
        "right anti": (None, r_un)}[how]
    out = {}
    for side, idx in ((left, li), (right, ri)):
        if idx is None:
            continue
        for name, (vals, valid, _) in side.items():
            ok = idx >= 0
            if valid is not None:
                ok[ok] = valid[idx[ok]]
            out[name] = (int(ok.sum()), int(vals[idx[ok]].sum()))
        out["rows"] = len(idx)
    return out


def _canonical(dictionary) -> np.ndarray:
    """Each value's index in SHIPMODES or PRIORITIES (the sweep's string
    columns), what sweep_oracle sums."""
    index = {v: i for names in (SHIPMODES, PRIORITIES)
             for i, v in enumerate(names)}
    return np.array([index[v] for v in dictionary] or [0], np.int64)


def sweep_checksums(out) -> dict:
    """sweep_oracle's summary of a join result (HostBatch or DeviceBatch;
    a DeviceBatch sums on its device)."""
    res = {}
    if isinstance(out, HostBatch):
        res["rows"] = out.num_rows
        for f, c in zip(out.schema.fields, out.columns):
            ok = c.validity_bools()
            vals = c.values if c.dict_values is None else _canonical(
                c.dict_values)[c.values]
            res[f.name] = (int(ok.sum()), int(vals[ok].astype(np.int64).sum()))
        return res
    res["rows"] = out.length
    for f, c in zip(out.schema.fields, out.columns):
        ok = c.validity_mask()
        vals = c.values.to(torch.int64)
        if c.dict_values is not None:
            vals = torch.from_numpy(_canonical(c.dict_values)).to(
                vals.device).index_select(0, vals.clamp(0))
        res[f.name] = tuple(torch.stack([
            ok.sum(), torch.where(ok, vals, 0).sum()]).tolist())
    return res


def sweep_join(how: str, route: str, hosts, devs):
    left, right = (hosts if route == "host" else devs)
    return pc.hash_join(left, right, left_keys=["l_okey"],
                        right_keys=["o_okey"], join_type=how,
                        device=devs[0].columns[0].device)


def compute_functions(li_s: DeviceBatch, pfac: DeviceColumn) -> dict:
    """The set-lookup, vector-hash and scalar-aggregate functions over
    the scanned lineitem columns (and the product factors)."""
    rflag, lstatus, qty, price, okey = (li_s.column(c) for c in (
        "l_rflag", "l_lstatus", "l_qty", "l_price", "l_okey"))
    big = pc.execute_scalar_expression(
        pc.call("greater", [pc.field("l_qty"), pc.literal(25)]), li_s)
    from arrow_go_tpu_torch.device.block import column_to_host
    return {
        "is_in": column_to_host(pc.is_in(rflag, value_set=["R", "A"])),
        "index_in": column_to_host(pc.index_in(lstatus,
                                               value_set=["F", "X", "O"])),
        "unique_rflag": column_to_host(pc.unique(rflag)).to_pylist(),
        "unique_qty": column_to_host(pc.unique(qty)).to_pylist(),
        "dictionary_encode": column_to_host(pc.dictionary_encode(qty)),
        "count_distinct": pc.agg_count_distinct(okey),
        "product": pc.agg_product(pfac),
        "variance": pc.agg_variance(price), "stddev": pc.agg_stddev(price),
        "any": pc.agg_any(big), "all": pc.agg_all(big)}


def _first_occurrence(values: np.ndarray) -> np.ndarray:
    uniq, first = np.unique(values, return_index=True)
    return uniq[np.argsort(first, kind="stable")]


def functions_oracle(li, pfac) -> dict:
    rcodes, rvalues = li["l_rflag"]
    scodes, svalues = li["l_lstatus"]
    qty = li["l_qty"]
    uqty = _first_occurrence(qty)
    code_of = np.zeros(int(qty.max()) + 1, np.int32)
    code_of[uqty] = np.arange(len(uqty), dtype=np.int32)
    where = {"F": 0, "X": 1, "O": 2}
    f = pfac
    return {
        "is_in": np.isin(rvalues[rcodes], ["R", "A"]),
        "index_in": np.array([where[v] for v in svalues])[scodes],
        "unique_rflag": rvalues[_first_occurrence(rcodes)].tolist(),
        "unique_qty": uqty.tolist(),
        "dictionary_encode": (code_of[qty], uqty),
        "count_distinct": int(np.count_nonzero(np.bincount(li["l_okey"]))),
        "product": (2 ** int((f == 2).sum())) * (-1) ** int((f == -1).sum()),
        "variance": float(np.var(li["l_price"])),
        "stddev": float(np.std(li["l_price"])),
        "any": bool((qty > 25).any()), "all": bool((qty > 25).all())}


def check_functions(got: dict, want: dict) -> None:
    """Lookups, codes, distinct values and counts exact; variance and
    standard deviation at rtol 1e-9."""
    for k in ("is_in", "index_in"):
        h = got[k]
        if h.mask is not None and not h.mask.all() or \
                not np.array_equal(h.values, want[k]):
            raise AssertionError(f"functions {k}: differs from numpy")
    codes, dictionary = want["dictionary_encode"]
    de = got["dictionary_encode"]
    if not np.array_equal(de.values, codes) or \
            de.dict_values.tolist() != dictionary.tolist():
        raise AssertionError("functions dictionary_encode: differs")
    for k in ("unique_rflag", "unique_qty", "count_distinct", "product",
              "any", "all"):
        if got[k] != want[k]:
            raise AssertionError(f"functions {k}: {got[k]!r}, numpy "
                                 f"{want[k]!r}")
    for k in ("variance", "stddev"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)


def fill_lengths(run) -> list:
    """The length of every join-state fill (cummax_u32) of one run."""
    from arrow_go_tpu_torch.parallel import join as pjoin
    seen, fill = [], pjoin.cummax_u32

    def recording(x):
        seen.append(x.shape[0])
        return fill(x)
    pjoin.cummax_u32 = recording
    try:
        run()
    finally:
        pjoin.cummax_u32 = fill
    return seen


def time_k2_fill(dev, n: int, what: str) -> dict:
    """K2's hi-only mode as the join state's forward fills call it
    (cummax_u32: one lane of monotone run-start marks, zero elsewhere)
    at n slots, held bit for bit against its plain version. The bound:
    one int64 lane read and one written, 16 B a slot; copy_ms: one
    `copy_` of the lane, the same bytes. (An older tree has no
    cummax_u32_plain; the hi lane of a zero-lo-lane call is the same
    function.)"""
    g = torch.Generator(device=dev).manual_seed(7)
    x, _ = _fill_inputs(n, g, dev)
    plain = getattr(scan, "cummax_u32_plain", None) or (
        lambda t: scan.cummax_u64_lanes_plain(t, [torch.zeros_like(t)])[0])
    err = _max_abs_err([scan.cummax_u32(x)], [plain(x)])
    dst = torch.empty_like(x)
    return {"shape": f"n={n}, one lane (cummax_u32, {what})",
            "max_abs_err": err,
            "ms": _time_ms(lambda: scan.cummax_u32(x), 20),
            "plain_ms": _time_ms(lambda: plain(x), 3),
            "library_ms": _time_ms(lambda: torch.cummax(x, 0), 5),
            "copy_ms": _time_ms(lambda: dst.copy_(x), 10),
            "bound_ms": 16 * n / HBM_BYTES_PER_S * 1e3}


def _string_ids(col: DeviceColumn, names) -> torch.Tensor:
    """Each row of [0, length) as its string's index in `names`, -1 where
    null, on the column's device."""
    at = {v: i for i, v in enumerate(names)}
    table = torch.tensor([at[v] for v in col.dict_values] or [-1],
                         device=col.device)
    ids = table.index_select(0, col.values.to(torch.int64).clamp(
        0, table.shape[0] - 1))
    return torch.where(col.validity_mask(), ids, -1)[:col.length]


def check_string_selections(li_s: DeviceBatch, li) -> dict:
    """if_else and fill_null over string operands on the card, over the
    scanned lineitem: if_else(l_qty > 25, l_rflag, l_lstatus), two
    dictionaries, every 13th condition null; fill_null of l_rflag with
    every 7th row null, from l_lstatus, from a value of its dictionary
    and from one that is not. Every row's string against numpy."""
    dev, n = li_s.columns[0].device, li_s.length
    rflag, lstatus = li_s.column("l_rflag"), li_s.column("l_lstatus")
    rows = torch.arange(li_s.padded, device=dev)
    big = pc.execute_scalar_expression(
        pc.call("greater", [pc.field("l_qty"), pc.literal(25)]), li_s)
    cond = DeviceColumn(big.values, bitmap.pack_mask(rows % 13 != 0), n,
                        dt.bool_)
    holed = DeviceColumn(rflag.values, bitmap.pack_mask(rows % 7 != 0), n,
                         rflag.type, rflag.dict_values)
    rcodes, rvalues = li["l_rflag"]
    scodes, svalues = li["l_lstatus"]
    names = sorted(set(rvalues) | set(svalues) | {"X"})
    at = {v: i for i, v in enumerate(names)}
    r_ids = np.array([at[v] for v in rvalues])[rcodes]
    s_ids = np.array([at[v] for v in svalues])[scodes]
    j = np.arange(n)
    hole = j % 7 == 0
    present = rvalues[-1]
    cases = {
        "if_else": (pc.if_else(cond, rflag, lstatus), np.where(
            j % 13 == 0, -1, np.where(li["l_qty"] > 25, r_ids, s_ids))),
        "fill_null column": (pc.fill_null(holed, lstatus),
                             np.where(hole, s_ids, r_ids)),
        "fill_null present": (pc.fill_null(holed, present),
                              np.where(hole, at[present], r_ids)),
        "fill_null absent": (pc.fill_null(holed, "X"),
                             np.where(hole, at["X"], r_ids))}
    for what, (out, want) in cases.items():
        if not torch.equal(_string_ids(out, names),
                           torch.from_numpy(want).to(dev)):
            raise AssertionError(f"{what} over strings differs from numpy")
    return {"rows": n, "cases": list(cases)}


# F5's right side: ship modes over a dictionary in string order, not in
# first-occurrence order; TRAIN and BARGE match no lineitem
MIXED_MODES = np.array(["TRAIN", "SHIP", "BARGE", "AIR", "MAIL"],
                       dtype=object)
MIXED_IDS = np.array([11, 22, 33, 44, 55], dtype=np.int64)


def check_mixed_join(left_db: DeviceBatch, left: dict) -> dict:
    """The mixed route on the card: the join sweep's lineitem side as a
    DeviceBatch, joined on l_smode with a HostBatch of MIXED_MODES
    (right and full outer). Row count, the valid count and sum of l_okey
    and r_id, and the right-only rows in the HostBatch's row order (the
    order its renumbering gives), against numpy."""
    dictionary = np.array(sorted(MIXED_MODES), dtype=object)
    at = {v: i for i, v in enumerate(dictionary)}
    t = dt.string
    right = HostBatch.from_arrays({
        "r_mode": HostArray(np.array([at[m] for m in MIXED_MODES], np.int32),
                            None, t, dictionary),
        "r_id": HostArray(MIXED_IDS, None, dt.int64)})
    lk, lvalid, _ = left["l_okey"]
    smode = SHIPMODES[left["l_smode"][0]]
    rid_of = dict(zip(MIXED_MODES, MIXED_IDS))
    matched = np.isin(smode, MIXED_MODES)
    right_only = [i for m, i in zip(MIXED_MODES, MIXED_IDS)
                  if m not in set(SHIPMODES)]
    rids = np.array([rid_of.get(m, 0) for m in SHIPMODES])[
        left["l_smode"][0]][matched]
    res = {}
    for how in ("right outer", "full outer"):
        keep = matched if how == "right outer" else np.ones_like(matched)
        want = {"rows": int(keep.sum()) + len(right_only),
                "l_okey": (int((keep & lvalid).sum()),
                           int(lk[keep & lvalid].sum())),
                "r_id": (int(matched.sum()) + len(right_only),
                         int(rids.sum()) + int(sum(right_only))),
                "right_only": right_only}
        out = pc.hash_join(left_db, right, left_keys=["l_smode"],
                           right_keys=["r_mode"], join_type=how)
        no_left = ~out.column("l_smode").validity_mask()[:out.length]
        got = {"rows": out.length}
        for name in ("l_okey", "r_id"):
            c = out.column(name)
            ok = c.validity_mask()
            got[name] = tuple(torch.stack([
                ok.sum(), torch.where(ok, c.values, 0).sum()]).tolist())
        got["right_only"] = out.column("r_id").values[:out.length][
            no_left].tolist()
        if got != want:
            raise AssertionError(f"mixed-route {how} join: {got} vs numpy "
                                 f"{want}")
        res[how] = got["rows"]
    return res


SWEEP_TIMED_RUNS = 1    # timed runs a join sweep case (3 before the
                        # encodings phase: a cut)


def join_phases(li, orders, dev, snappy, card: str,
                timing_only: bool = False) -> dict:
    """This slice's paths, at the scale of `li`: TPC-H Q4 (semi join),
    Q12 (inner join carrying strings, IN, CASE) and Q13 (left outer
    join) device-resident, every join type of both routes over the
    sweep's sides, the mixed route, the set-lookup / vector-hash /
    aggregate functions and the string selections over the scanned
    lineitem, each against numpy. Returns each path's launch counts and
    K2's times at Q13's and Q4's join lengths. With `timing_only`, only
    the three queries (not held call by call) and K2's times."""
    launches = {}
    customer = add_join_columns(li, orders)
    li_db = agt.batch_to_device({c: li[c] for c in (
        "l_okey", "l_sdate", "l_cdate", "l_rdate", "l_smode")}, device=dev)
    ord_db = agt.batch_to_device({c: orders[c] for c in (
        "o_okey", "o_odate", "o_opri", "o_custkey")}, device=dev)
    cust_db = agt.batch_to_device(customer, device=dev)
    n_cust = len(customer["c_custkey"])
    queries = (
        ("q4", lambda mark=lambda s: None: compute_q4(li_db, ord_db, mark),
         q4_oracle(li, orders)),
        ("q12", lambda mark=lambda s: None: compute_q12(li_db, ord_db,
                                                        mark),
         q12_oracle(li, orders)),
        ("q13", lambda mark=lambda s: None: compute_q13(cust_db, ord_db,
                                                        mark),
         q13_oracle(orders, n_cust)))
    row_counts = join_row_counts(li, orders, n_cust)
    held = {}
    for name, run, want in queries:
        out, launches[name.upper()] = run_path(name.upper(), run,
                                               ("K1", "K2"))
        check_rows(name, out, want)
        if not timing_only:
            out, held[name] = check_path_calls(name, run,
                                               launches[name.upper()])
            check_rows(name, out, want)
        outs, runs = timed(run)
        for out in outs:
            check_rows(name, out, want)
        print(json.dumps({name: {
            "rows": row_counts[name], "result": out.to_pydict(),
            "ms_runs": runs,
            "ms_median": float(np.median(runs)),
            "launches_per_run": launches[name.upper()], "card": card,
            "verified": True}}), flush=True)
        print(json.dumps({f"{name}_profile": profile_stages(
            run, lambda out: check_rows(name, out, want))}), flush=True)
    k2_fills = [time_k2_fill(dev, max(fill_lengths(run)), name)
                for name, run, _ in queries if name in ("q13", "q4")]
    for k2 in k2_fills:
        print(f"K2 at {k2['shape']}: kernel {k2['ms']:.4f} ms, plain "
              f"{k2['plain_ms']:.4f} ms, library {k2['library_ms']:.4f} ms, "
              f"bound {k2['bound_ms']:.4f} ms (one lane in, one out)")
    print(json.dumps({"k2_fills": k2_fills}), flush=True)
    del li_db, ord_db, cust_db
    if timing_only:
        return {"launches": launches, "k2_fills": k2_fills}

    # every join type, both routes, over the sweep's sides
    sides = sweep_sides(li, orders)
    from arrow_go_tpu_torch.device.block import host_batch_to_device
    hosts = tuple(sweep_host_batch(s) for s in sides)
    devs = tuple(host_batch_to_device(h, dev) for h in hosts)
    cases = [(how, "device") for how in SWEEP_HOWS[:4]] + [
        (how, "host") for how in SWEEP_HOWS]
    wants = {how: sweep_oracle(*sides, how) for how in SWEEP_HOWS}

    def sweep_all():
        for how, route in cases:
            got = sweep_checksums(sweep_join(how, route, hosts, devs))
            if got != wants[how]:
                raise AssertionError(f"join sweep {how} ({route}): {got} "
                                     f"vs numpy {wants[how]}")
    _, launches["joins"] = run_path("joins", sweep_all, ("K1", "K2"))
    _, held["joins"] = check_path_calls("joins", sweep_all,
                                        launches["joins"])
    per_type = {}
    for how, route in cases:
        outs, runs = timed(lambda: sweep_join(how, route, hosts, devs),
                           SWEEP_TIMED_RUNS)
        for out in outs:
            if sweep_checksums(out) != wants[how]:
                raise AssertionError(f"join sweep {how} ({route}) timed run")
        per_type[f"{how} ({route})"] = {
            "rows": wants[how]["rows"], "ms_runs": runs,
            "ms_median": float(np.median(runs))}
    print(json.dumps({"joins": {
        "left_rows": hosts[0].num_rows, "right_rows": hosts[1].num_rows,
        "probe_chunk": pc.PROBE_CHUNK_DEFAULT,
        "chunked": hosts[0].num_rows > pc.PROBE_CHUNK_DEFAULT,
        "by_type": per_type, "launches_per_run": launches["joins"],
        "card": card, "verified": True}}), flush=True)
    print(json.dumps({"mixed_route": check_mixed_join(devs[0], sides[0])}),
          flush=True)
    del hosts, devs

    # the functions, over the scanned (snappy) lineitem
    li_s = scan_parquet(snappy["lineitem"], ["l_rflag", "l_lstatus", "l_qty",
                                             "l_price", "l_okey"], dev)
    pfac_np = product_factors(len(li["l_okey"]))
    pfac = agt.batch_to_device({"l_pfac": pfac_np}, device=dev).column(0)
    want = functions_oracle(li, pfac_np)
    got, launches["functions"] = run_path(
        "functions", lambda: compute_functions(li_s, pfac),
        ("K1", "K2", "K3"))
    check_functions(got, want)
    got, held["functions"] = check_path_calls(
        "functions", lambda: compute_functions(li_s, pfac),
        launches["functions"])
    check_functions(got, want)
    outs, runs = timed(lambda: compute_functions(li_s, pfac))
    for got in outs:
        check_functions(got, want)
    print(json.dumps({"functions": {
        k: got[k] for k in ("unique_rflag", "count_distinct", "product",
                            "variance", "stddev", "any", "all")}
        | {"ms_runs": runs, "ms_median": float(np.median(runs)),
           "launches_per_run": launches["functions"], "card": card,
           "verified": True}}), flush=True)
    print(json.dumps({"string_selections": check_string_selections(li_s,
                                                                   li)}),
          flush=True)
    # every K1 and K2 call of these paths, on its own inputs
    print(json.dumps({"path_checks": held}), flush=True)
    errs = {k: max(h[k]["max_abs_err"] for h in held.values())
            for k in ("K1", "K2")}
    errs["K2"] = max([errs["K2"]] + [k2["max_abs_err"] for k2 in k2_fills])
    return {"launches": launches, "k2_fills": k2_fills, "errs": errs}


# ---------------------------------------------------------------------------
# dates, times and casts over the snappy lineitem (l_sdate a DATE column)
# ---------------------------------------------------------------------------

Q6_COLUMNS = ["l_price", "l_disc", "l_sdate", "l_qty"]
# the timestamp phase's zone: a fixed offset (TPC-H's dates carry none)
TS_ZONE = "+05:30"
TS_OFFSET_MS = (5 * 3600 + 30 * 60) * 1000
HOUR_MS = 3_600_000
DAY_MS = 86_400_000


def _days(d64: np.ndarray) -> np.ndarray:
    return d64.astype("datetime64[D]").astype(np.int64)


def temporal_oracle(sdate: np.ndarray) -> dict:
    """numpy datetime64 arithmetic (no code shared with the port): each
    row's year, quarter, month and Monday-week start as days; the next
    month's start (a calendar ceil is strictly greater); the nearer of
    the two (half up, at the midpoint in ns, which is a whole number of
    days times 2)."""
    d = sdate.astype("datetime64[D]")
    month = d.astype("datetime64[M]")
    quarter = (month.astype(np.int64) // 3 * 3).astype("datetime64[M]")
    start, end = _days(month), _days(month + 1)
    days = sdate.astype(np.int64)
    return {"year": _days(d.astype("datetime64[Y]")),
            "quarter": _days(quarter), "month": start,
            "week": (days + 3) // 7 * 7 - 3, "ceil_month": end,
            "round_month": np.where(2 * (days - start) < end - start,
                                    start, end)}


ROUNDINGS = {"year": ("floor_temporal", "year"),
             "quarter": ("floor_temporal", "quarter"),
             "month": ("floor_temporal", "month"),
             "week": ("floor_temporal", "week"),
             "ceil_month": ("ceil_temporal", "month"),
             "round_month": ("round_temporal", "month")}


def revenue_by_year(li_s: DeviceBatch) -> HostBatch:
    """SELECT year(l_sdate), SUM(l_price * (1 - l_disc)), COUNT(*)
    GROUP BY 1: the shape of TPC-H Q7/Q9's extract(year from
    l_shipdate), the year as floor_temporal's first day of it."""
    year = pc.floor_temporal(li_s.column("l_sdate"), unit="year")
    rev = pc.execute_scalar_expression(pc.call("multiply", [
        pc.field("l_price"),
        pc.call("subtract", [pc.literal(1.0), pc.field("l_disc")])]), li_s)
    gb = DeviceBatch(dt.Schema([dt.Field("year", year.type),
                                dt.Field("rev", dt.float64)]), [year, rev],
                     li_s.length)
    return pc.group_by(gb, "year", [("rev", "sum"), ("rev", "count")])


def revenue_by_year_oracle(li) -> dict:
    year = _days(li["l_sdate"].astype("datetime64[D]").astype(
        "datetime64[Y]"))
    keys, first, inv = np.unique(year, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first)               # first-occurrence order
    rev = li["l_price"] * (1.0 - li["l_disc"])
    return {"year": keys[order].tolist(),
            "rev_sum": np.bincount(inv, weights=rev)[order],
            "rev_count": np.bincount(inv)[order].tolist()}


def check_revenue_by_year(out: HostBatch, want: dict) -> None:
    got = out.to_pydict()
    if got["year"] != want["year"] or got["rev_count"] != want["rev_count"]:
        raise AssertionError(f"revenue by year: {got['year']} "
                             f"{got['rev_count']}, oracle {want}")
    np.testing.assert_allclose(got["rev_sum"], want["rev_sum"], rtol=1e-9)


def _host(col: DeviceColumn) -> np.ndarray:
    return col.values[:col.length].cpu().numpy()


def _equal(what: str, got: np.ndarray, want: np.ndarray) -> None:
    """Bit for bit (a float by its bit pattern)."""
    if got.dtype.kind == "f":
        got, want = got.view(f"u{got.itemsize}"), want.view(
            f"u{want.itemsize}")
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int(np.count_nonzero(got != want)) if got.shape == \
            want.shape else -1
        raise AssertionError(f"{what}: {bad} rows differ from numpy")


def _raises(what: str, fn) -> str:
    """The message of the ArrowInvalid that fn raises."""
    try:
        fn()
    except pc.ArrowInvalid as e:
        return str(e)
    raise AssertionError(f"{what} did not raise ArrowInvalid")


def _sync_ms(fn):
    """(fn's result, its host-clock ms, ending in a device sync)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def timestamp_phase(li_s: DeviceBatch, okey: DeviceColumn) -> dict:
    """A timestamp("ms", "+05:30") column made on the card from l_sdate
    (midnight UTC plus l_okey's residue in the day, as ms), rounded to
    the hour, against numpy."""
    ms = pc.arithmetic_binary("add", pc.arithmetic_binary(
        "multiply", pc.cast_device(li_s.column("l_sdate"), dt.int64),
        DAY_MS), pc.arithmetic_binary("mod", okey, DAY_MS))
    ts = pc.cast_device(ms, dt.timestamp("ms", TS_ZONE))
    out, t_ms = _sync_ms(lambda: pc.round_temporal(ts, unit="hour"))
    local = _host(ms) + TS_OFFSET_MS
    lo = local // HOUR_MS * HOUR_MS
    want = np.where(local - lo < HOUR_MS // 2, lo, lo + HOUR_MS) \
        - TS_OFFSET_MS
    _equal("round_temporal(timestamp[ms, +05:30], hour)", _host(out), want)
    return {"round_hour_ms": t_ms, "type": str(out.type)}


def cast_phase(li_s: DeviceBatch, okey: DeviceColumn, li) -> dict:
    """The casts of the slice against numpy, over the scanned lineitem
    and l_okey: the date32 -> timestamp chains, the time truncation
    check, int32 -> int8 -> uint8 -> int64, an int8 overflow, float64 ->
    int64 safe (raises) and unsafe (truncates; NaN and +-1e20 saturate),
    float64 -> float32 and float16, and l_okey as uint64 and uint32 with
    values above 2**63 and 2**31: compares and sort_indices in numpy's
    unsigned order. Returns each step's ms."""
    sdate, qty, price = (li_s.column(c) for c in ("l_sdate", "l_qty",
                                                  "l_price"))
    days = li["l_sdate"].astype(np.int64)
    times = {}

    def timed_cast(what, fn):
        out, times[what] = _sync_ms(fn)
        return out

    unsafe = pc.CastOptions.unsafe()
    # date32 has no unit: the cast keeps the day number (as the JAX
    # package's does); the instants go through int64 ms
    same = timed_cast("date32->timestamp[ms]", lambda: pc.cast_device(
        sdate, dt.timestamp("ms")))
    _equal("date32 -> timestamp[ms]", _host(same), days)
    ms = pc.cast_device(pc.arithmetic_binary(
        "multiply", pc.cast_device(sdate, dt.int64), DAY_MS),
        dt.timestamp("ms"))
    secs = timed_cast("timestamp[ms]->timestamp[s]", lambda: pc.cast_device(
        ms, dt.timestamp("s")))
    _equal("timestamp[ms] -> timestamp[s]", _host(secs), days * 86_400)
    back = pc.cast_device(pc.arithmetic_binary(
        "divide", pc.cast_device(secs, dt.int64), 86_400), dt.date32)
    _equal("date32 -> ... -> date32", _host(back), li["l_sdate"])
    off = pc.cast_device(pc.arithmetic_binary(
        "add", pc.cast_device(ms, dt.int64), pc.arithmetic_binary(
            "mod", okey, 1000)), dt.timestamp("ms"))
    _raises("timestamp[ms] -> [s] off the second", lambda: pc.cast_device(
        off, dt.timestamp("s")))
    trunc = pc.cast_device(off, dt.timestamp("s"),
                           pc.CastOptions(allow_time_truncate=True))
    _equal("timestamp[ms] -> [s] truncated", _host(trunc),
           (days * DAY_MS + li["l_okey"] % 1000) // 1000)
    # int32 -> int8 -> uint8 -> int64
    q8 = timed_cast("int32->int8", lambda: pc.cast_device(qty, dt.int8))
    q64 = pc.cast_device(pc.cast_device(q8, dt.uint8), dt.int64)
    _equal("l_qty int32 -> int8 -> uint8 -> int64", _host(q64),
           li["l_qty"].astype(np.int64))
    _raises("int64 -> int8 overflow", lambda: pc.cast_device(okey, dt.int8))
    # float64 -> int64: safe raises on the fractions, unsafe truncates
    _raises("float64 -> int64 safe", lambda: pc.cast_device(price,
                                                            dt.int64))
    p = price.values.clone()
    p[:3] = torch.tensor([float("nan"), 1e20, -1e20], dtype=torch.float64)
    pcol = DeviceColumn(p, None, price.length, dt.float64)
    i64 = timed_cast("float64->int64 unsafe", lambda: pc.cast_device(
        pcol, dt.int64, unsafe))
    ph = _host(pcol)
    want = np.trunc(np.where(np.isnan(ph), 0.0, np.clip(
        ph, -1e18, 1e18))).astype(np.int64)
    want[1], want[2] = 2 ** 63 - 1, -2 ** 63      # the clamp saturates
    _equal("float64 -> int64 unsafe", _host(i64), want)
    for to, npd in ((dt.float32, np.float32), (dt.float16, np.float16)):
        out = timed_cast(f"float64->{to}", lambda: pc.cast_device(pcol, to))
        with np.errstate(over="ignore"):      # +-1e20 -> +-inf in float16
            _equal(f"float64 -> {to}", _host(out), ph.astype(npd))
    # l_okey as uint64 above 2**63 and as uint32 above 2**31
    raw = okey.values.clone()
    raw[1::2] |= -(1 << 63)
    u64 = DeviceColumn(raw, None, okey.length, dt.uint64)
    # (Knuth's multiplicative hash spreads the keys over all of uint32)
    u32 = pc.cast_device(pc.arithmetic_binary("multiply", okey,
                                              2_654_435_761), dt.uint32,
                         unsafe)
    out = {"ms": times}
    for col in (u64, u32):
        h = _host(col).view(col.type.np_dtype)
        lim = int(np.iinfo(col.type.np_dtype).max // 2 + 1)
        for op, npop in (("greater", np.greater),
                         ("less_equal", np.less_equal)):
            got = _host(pc.compare(op, col, lim))
            if not np.array_equal(got, npop(h, np.array(lim, h.dtype))):
                raise AssertionError(f"{col.type} {op} {lim} differs")
        perm, out[f"sort_{col.type}_ms"] = _sync_ms(
            lambda: _host(pc.sort_indices(col)))
        sv = h[perm]
        if not (np.all(sv[1:] >= sv[:-1]) and np.all(
                (sv[1:] != sv[:-1]) | (perm[1:] > perm[:-1]))
                and np.array_equal(np.bincount(perm, minlength=len(h)),
                                   np.ones(len(h), np.int64))):
            raise AssertionError(f"sort_indices of {col.type} is not "
                                 f"numpy's stable unsigned order")
        out[f"above_half_{col.type}"] = int(np.count_nonzero(
            h > np.array(lim, h.dtype)))
    return out


def registry_q6(li_s: DeviceBatch, disc_host: HostArray):
    """TPC-H Q6 through call_function over the card's columns, and one
    HostArray argument (l_disc * 100, to the card and back)."""
    cf = pc.call_function
    c = {n: li_s.column(n) for n in Q6_COLUMNS}
    dates = cf("and", [cf("greater_equal", [c["l_sdate"], Q6_DATE_LO]),
                       cf("less", [c["l_sdate"], Q6_DATE_HI])])
    disc = cf("and", [cf("greater_equal", [c["l_disc"], Q6_DISC_LO]),
                      cf("less_equal", [c["l_disc"], Q6_DISC_HI])])
    mask = cf("and", [cf("and", [dates, disc]),
                      cf("less", [c["l_qty"], Q6_QTY])])
    kept = cf("filter", [project(li_s, ["l_price", "l_disc"]), mask])
    rev = cf("multiply", [kept.column("l_price"), kept.column("l_disc")])
    return ({"revenue": cf("sum", [rev]),
             "count": cf("count", [rev], pc.CountOptions("all"))},
            cf("multiply", [disc_host, 100.0]))


def typed_phases(li, snappy: dict, dev, card: str,
                 timing_only: bool = False) -> dict:
    """This slice's paths over the snappy lineitem with its DATE
    l_sdate: Q6, the temporal rounding and the revenue by year, the
    casts, and Q6 through the registry, each against numpy; every K1 and
    K3 call of Q6, the revenue by year and the registry's Q6 held
    against the plain version (not with `timing_only`). Returns each
    path's launch counts and the largest kernel - plain difference."""
    launches, held = {}, {}
    li_s = scan_parquet(snappy["lineitem"], Q6_COLUMNS, dev)
    okey = scan_parquet(snappy["lineitem"], ["l_okey"], dev).column(0)
    sdate = li_s.column("l_sdate")
    if sdate.type != dt.date32:
        raise AssertionError(f"l_sdate scanned as {sdate.type}")
    q6_want = q6_oracle(li)
    disc_host = HostArray(li["l_disc"], None, dt.float64)
    paths = (
        ("typed Q6", "typed_q6", lambda: compute_q6(li_s),
         lambda out: check_q6(out, q6_want), ("K1", "K3")),
        ("revenue by year", "revenue_by_year", lambda: revenue_by_year(
            li_s), lambda out, want=revenue_by_year_oracle(li):
            check_revenue_by_year(out, want), ("K1",)),
        ("registry Q6", "registry_q6", lambda: registry_q6(li_s, disc_host),
         lambda out: check_q6(out[0], q6_want), ("K1", "K3")))
    runs = {}
    for name, key, run, check, needs in paths:
        out, launches[name] = run_path(name, run, needs)
        check(out)
        if not timing_only:
            out, held[key] = check_path_calls(key, run, launches[name])
            check(out)
        outs, runs[key] = timed(run)
        for out in outs:
            check(out)
    print(json.dumps({"typed_q6": {
        **compute_q6(li_s), "l_sdate_type": str(sdate.type),
        "selectivity": q6_want["count"] / sdate.length,
        "ms_runs": runs["typed_q6"],
        "ms_median": float(np.median(runs["typed_q6"])),
        "launches_per_run": launches["typed Q6"], "card": card,
        "verified": True}}), flush=True)

    want = temporal_oracle(li["l_sdate"])
    rounding_ms = {}
    for k, (fn, unit) in ROUNDINGS.items():
        out = getattr(pc, fn)(sdate, unit=unit)
        if out.type != dt.date32:
            raise AssertionError(f"{fn}({unit}) gave {out.type}")
        _equal(f"{fn}({unit})", _host(out).astype(np.int64), want[k])
        rounding_ms[k] = _time_ms(lambda: getattr(pc, fn)(sdate, unit=unit),
                                  3)
    del out
    print(json.dumps({"temporal": {
        "rows": sdate.length, "rounding_ms": rounding_ms,
        "timestamp": timestamp_phase(li_s, okey),
        "revenue_by_year": revenue_by_year(li_s).to_pydict(),
        "revenue_by_year_ms_runs": runs["revenue_by_year"],
        "revenue_by_year_ms_median": float(np.median(
            runs["revenue_by_year"])),
        "launches_per_run": launches["revenue by year"], "card": card,
        "verified": True}}), flush=True)

    print(json.dumps({"casts": {**cast_phase(li_s, okey, li), "card": card,
                                "verified": True}}), flush=True)

    got, disc100 = registry_q6(li_s, disc_host)
    if not isinstance(disc100, HostArray):
        raise AssertionError("call_function kept a host argument's result "
                             "on the card")
    _equal("call_function(multiply, [HostArray, 100.0])", disc100.values,
           li["l_disc"] * 100.0)
    print(json.dumps({"registry": {
        **got, "host_argument_rows": len(disc100),
        "ms_runs": runs["registry_q6"],
        "ms_median": float(np.median(runs["registry_q6"])),
        "launches_per_run": launches["registry Q6"], "card": card,
        "verified": True}}), flush=True)
    errs = {"K1": 0.0, "K3": 0.0}
    if not timing_only:
        print(json.dumps({"typed_path_checks": held}), flush=True)
        errs["K1"] = max(h["K1"]["max_abs_err"] for h in held.values())
        kept = pc.call_function("filter", [
            project(li_s, ["l_price", "l_disc"]),
            pc.execute_scalar_expression(q6_expression(), li_s)])
        rev = pc.call_function("multiply", [kept.column("l_price"),
                                            kept.column("l_disc")])
        errs["K3"] = check_k3_at("typed Q6 and registry Q6", [
            (q6_revenue(li_s), "sum"), (rev, "sum")])
    return {"launches": launches, "errs": errs}

# ---------------------------------------------------------------------------
# decimals: TPC-H's money columns as DECIMAL(15,2)
# ---------------------------------------------------------------------------

MONEY128 = dt.decimal128(15, 2) if hasattr(dt, "decimal128") else None
MONEY64 = dt.decimal64(15, 2) if hasattr(dt, "decimal64") else None
LIMB_ROWS = 1 << 20               # rows of the limb checks and small files


def money_cents(li) -> dict:
    """The decimal sources: the unscaled DECIMAL(15,2) values (cents) of
    exactly the float columns the other phases use."""
    return {"l_price": np.rint(li["l_price"] * 100).astype(np.int64),
            "l_disc": np.rint(li["l_disc"] * 100).astype(np.int64),
            "l_tax": np.rint(li["l_tax"] * 100).astype(np.int64),
            "l_qty": li["l_qty"].astype(np.int64) * 100}


def decimal_q6(li_d: DeviceBatch):
    """TPC-H Q6 over DECIMAL money columns up to its SUM: the predicate
    (Decimal literals for the discount range, an int quantity that the
    decimal kernels scale), the DeviceBatch filter (K1, each limb a
    payload) and l_price * l_disc as decimal128(31, 4)."""
    c, cmp, both = li_d.column, pc.compare, pc.boolean_binary
    mask = both("and", cmp("greater_equal", c("l_sdate"), Q6_DATE_LO),
                cmp("less", c("l_sdate"), Q6_DATE_HI))
    mask = both("and", mask, cmp("greater_equal", c("l_disc"),
                                 decimal.Decimal("0.05")))
    mask = both("and", mask, cmp("less_equal", c("l_disc"),
                                 decimal.Decimal("0.07")))
    mask = both("and", mask, cmp("less", c("l_qty"), Q6_QTY))
    kept = pc.filter(project(li_d, ["l_price", "l_disc"]), mask)
    return pc.arithmetic_binary("multiply", kept.column("l_price"),
                                kept.column("l_disc"))


def _limb_ints(col: DeviceColumn, n: int) -> tuple:
    """(low limbs, high limbs) of a decimal128 column's rows [0, n) on
    the host."""
    v = col.values[:n].cpu().numpy()
    return v[:, 0], v[:, 1]


def check_limbs(what: str, col: DeviceColumn, want: np.ndarray) -> None:
    """A decimal128 column whose values fit int64 equals `want` (int64)
    exactly: the low limb is the value, the high limb its sign."""
    lo, hi = _limb_ints(col, len(want))
    if col.length != len(want):
        raise AssertionError(f"{what}: {col.length} rows, numpy "
                             f"{len(want)}")
    _equal(f"{what} low limbs", lo, want)
    _equal(f"{what} high limbs", hi, want >> 63)


def decimal_q6_check(cents, keep):
    want = cents["l_price"][keep] * cents["l_disc"][keep]

    def check(rev):
        if str(rev.type) != "decimal128(31, 4)":
            raise AssertionError(f"decimal Q6: product type {rev.type}")
        check_limbs("decimal Q6 l_price * l_disc", rev, want)
    return check, want


def disc_price(li_d: DeviceBatch):
    """Q1's l_price * (1 - l_disc) on decimal128: a scaled int scalar, a
    subtract and a limb multiply over every row."""
    return pc.arithmetic_binary("multiply", li_d.column("l_price"),
                                pc.arithmetic_binary(
                                    "subtract", 1, li_d.column("l_disc")))


DEC_Q1_AGGS = [(c, a) for c in ("l_qty", "l_price", "l_disc", "l_tax")
               for a in ("sum", "min", "max", "count")]


def decimal_q1(li_i: DeviceBatch) -> HostBatch:
    """Q1's sums, minima, maxima and counts of the decimal64 money
    columns by (l_rflag, l_lstatus), over every row."""
    return pc.group_by(li_i, ["l_rflag", "l_lstatus"], DEC_Q1_AGGS)


def decimal_q1_oracle(li, cents) -> dict:
    """Exact int64 sums, minima, maxima and counts by group, keyed by the
    (l_rflag, l_lstatus) strings."""
    rcode, rvals = li["l_rflag"]
    scode, svals = li["l_lstatus"]
    key = rcode.astype(np.int64) * len(svals) + scode
    order = np.argsort(key, kind="stable")
    skey = key[order]
    starts = np.flatnonzero(np.r_[True, skey[1:] != skey[:-1]])
    out = {}
    for k0, a, b in zip(skey[starts], starts, np.r_[starts[1:],
                                                    len(skey)]):
        out[(rvals[k0 // len(svals)], svals[k0 % len(svals)])] = {
            "count": int(b - a)}
    for c in ("l_qty", "l_price", "l_disc", "l_tax"):
        v = cents[c][order]
        for fn, name in ((np.add, "sum"), (np.minimum, "min"),
                         (np.maximum, "max")):
            red = fn.reduceat(v, starts)
            for (key_, got), x in zip(out.items(), red):
                got[f"{c}_{name}"] = int(x)
    return out


def check_decimal_q1(out: HostBatch, want: dict) -> None:
    got = out.to_pydict()
    if out.num_rows != len(want):
        raise AssertionError(f"decimal Q1: {out.num_rows} groups, numpy "
                             f"{len(want)}")
    for r in range(out.num_rows):
        w = want[(got["l_rflag"][r], got["l_lstatus"][r])]
        for c, a in DEC_Q1_AGGS:
            g = got[f"{c}_{a}"][r]
            if a == "count":
                ok = g == w["count"]
            else:
                ok = type(g).__name__ == "Decimal" and g.as_tuple()[2] == -2 \
                    and g == decimal.Decimal(w[f"{c}_{a}"]).scaleb(-2)
            if not ok:
                raise AssertionError(f"decimal Q1 {c}_{a} row {r}: {g!r}, "
                                     f"numpy {w}")


def check_decimal_scan(dbs: dict, sources: dict, types=None) -> None:
    """Every scanned column equals its source over [0, n): a decimal128
    column by its limbs (the cents sign-extended), a decimal64 or
    date32 column bit for bit, a string column by codes and dictionary;
    every column has its written type."""
    for tname, db in dbs.items():
        plain = {}
        for name, want in sources[tname].items():
            c = db.column(name)
            if c.type != types[tname].get(name, c.type):
                raise AssertionError(f"scan {tname}.{name}: type {c.type}")
            if c.type.is_decimal and c.type.limbs:
                check_limbs(f"scan {tname}.{name}", c, want)
            else:
                plain[name] = want
        check_scan({tname: project(db, list(plain))}, {tname: plain})


def _random_limbs(rng, n: int, k: int) -> np.ndarray:
    a = rng.integers(0, 2**64, (n, k), dtype=np.uint64, endpoint=False)
    special = np.array([0, 1, 2**64 - 1, 2**63, 2**63 - 1, 2**32],
                       np.uint64)
    a[:4096] = special[rng.integers(0, len(special), (4096, k))]
    return a.view(np.int64)


def limb_checks(dev) -> dict:
    """decimal128 and decimal256 add, subtract, multiply, the six
    compares and an ascending sort with nulls over LIMB_ROWS rows of
    random full-width limbs, each held against Python integers mod
    2**128 / 2**256; then FLOAT16, fixed_size_binary(12) and INT96 files
    of LIMB_ROWS rows scanned on the card against numpy."""
    from arrow_go_tpu_torch.ops import decimal as tdec
    rng = np.random.default_rng(21)
    n = LIMB_ROWS
    P = agt.pad_length(n)
    out = {}
    for t in (dt.decimal128(38, 2), dt.decimal256(76, 2)):
        k, M = t.limbs, 1 << (64 * t.limbs)
        a, b = _random_limbs(rng, n, k), _random_limbs(rng, n, k)
        b[:1000] = a[:1000]
        mask = rng.random(n) < 0.9
        words = bitmap.pack_mask(torch.from_numpy(np.pad(
            mask, (0, P - n))).to(dev))

        def col(x):
            v = np.zeros((P, k), np.int64)
            v[:n] = x
            return DeviceColumn(torch.from_numpy(v).to(dev), words, n, t)
        ca, cb = col(a), col(b)
        ia, ib = tdec.to_ints(a), tdec.to_ints(b)
        ms = {}
        for op, fn in (("add", lambda x, y: (x + y) % M),
                       ("subtract", lambda x, y: (x - y) % M),
                       ("multiply", lambda x, y: (x * y) % M)):
            res, ms[op] = _sync_ms(lambda: pc.arithmetic_binary(op, ca, cb))
            got = tdec.to_ints(res.values[:n].cpu().numpy()) % M
            if not np.array_equal(got[mask], fn(ia, ib)[mask]):
                raise AssertionError(f"{t} {op} differs from Python ints")
        for op, fn in (("equal", np.equal), ("not_equal", np.not_equal),
                       ("less", np.less), ("less_equal", np.less_equal),
                       ("greater", np.greater),
                       ("greater_equal", np.greater_equal)):
            res, ms[op] = _sync_ms(lambda: pc.compare(op, ca, cb))
            got = res.values[:n].cpu().numpy()
            if not np.array_equal(got[mask], fn(ia, ib).astype(bool)[mask]):
                raise AssertionError(f"{t} {op} differs from Python ints")
        perm, ms["sort"] = _sync_ms(lambda: pc.sort_indices(ca))
        # valid rows by value, then the null rows, which (as in the JAX
        # package) keep sorting by the values they hold
        live, dead = np.flatnonzero(mask), np.flatnonzero(~mask)
        want = np.concatenate([live[np.argsort(ia[live], kind="stable")],
                               dead[np.argsort(ia[dead], kind="stable")]])
        _equal(f"{t} sort_indices", perm.values[:n].cpu().numpy(), want)
        out[str(t)] = {"rows": n, "ms": ms}
        del ca, cb, res, perm
    out["files"] = fixed_files(rng, dev)
    return out


def fixed_files(rng, dev) -> dict:
    """FLOAT16, fixed_size_binary(12) and INT96 columns of LIMB_ROWS rows
    (with nulls), written SNAPPY by the port's writer and scanned on the
    card: float16 bit for bit, the binary rows through their codes and
    dictionary, the INT96 rows as their ns timestamps."""
    n = LIMB_ROWS
    mask = rng.random(n) < 0.9
    h = rng.standard_normal(n).astype(np.float16)
    fsb = rng.integers(0, 4, (n, 12)).astype(np.uint8)
    ts = rng.integers(-4 * 10**18, 4 * 10**18, n)
    buf = io.BytesIO()
    tpq.write_table({"h": h, "f": fsb, "t": ts}, buf,
                    masks={"h": mask, "f": mask, "t": mask},
                    types={"h": dt.float16, "f": dt.fixed_size_binary(12),
                           "t": dt.timestamp("ns")},
                    compression="snappy", write_page_index=False,
                    data_page_size=1 << 20,
                    int96_timestamps=True)
    blob = buf.getvalue()
    times = {}
    db, ms = _sync_ms(lambda: scan_parquet(blob, device=dev, times=times))
    valid = db.column("h").validity_mask()[:n].cpu().numpy()
    _equal("FLOAT16 validity", valid, mask)
    _equal("FLOAT16 scan", _host(db.column("h"))[mask], h[mask])
    _equal("INT96 scan", _host(db.column("t"))[mask], ts[mask])
    f = db.column("f")
    rows = np.frombuffer(b"".join(f.dict_values), np.uint8).reshape(-1, 12)
    _equal("fixed_size_binary scan", rows[_host(f)][mask], fsb[mask])
    encs = {c.meta_data.path_in_schema[0]: [
        tpq.format.Encoding(e).name for e in c.meta_data.encodings]
        for c in tpq.ParquetFile(blob).metadata.row_groups[0].columns}
    return {"rows": n, "file_bytes": len(blob), "scan_ms": ms,
            "split_ms": {k[:-2] + "_ms": v * 1e3 for k, v in times.items()},
            "encodings": encs, "fixed_size_binary_distinct":
            len(f.dict_values), "verified": True}


def data_page_encodings(blob) -> dict:
    """Each column's data pages (v1 and v2) of row group 0 counted by
    encoding: a FLBA chunk whose dictionary passed its limit shows
    RLE_DICTIONARY pages, then PLAIN ones. `blob`: bytes or a path."""
    from arrow_go_tpu_torch.parquet.device_read import _iter_pages
    pf = tpq.ParquetFile(blob)
    out = {}
    for c in pf.metadata.row_groups[0].columns:
        kinds = []
        for hdr, _ in _iter_pages(pf, c):
            h = hdr.data_page_header or hdr.data_page_header_v2
            if h is not None:
                kinds.append(tpq.format.Encoding(h.encoding or 0).name)
        out[c.meta_data.path_in_schema[0]] = {
            k: kinds.count(k) for k in dict.fromkeys(kinds)}
        out[c.meta_data.path_in_schema[0]]["order"] = list(
            dict.fromkeys(kinds))
    return out


def decimal_phases(li, dev, card: str, q6_count: int,
                   timing_only: bool = False) -> dict:
    """This slice's paths at the scale of `li`: the two decimal files
    (FLBA decimal128 and INT64 decimal64) scanned and held bit for bit
    against their sources; decimal Q6 from the FLBA bytes; Q1's
    disc_price over every row; Q1's sums, minima, maxima and counts on
    decimal64; agg_sum of decimal64 l_price (K3); the decimal128
    descending sort; the limb checks and the small FLOAT16 /
    fixed_size_binary / INT96 files. Every K1 call of decimal Q6 and
    decimal Q1 and the K3 call of the decimal sum are held against the
    plain version (not with `timing_only`). Returns each path's launch
    counts and the largest kernel - plain difference."""
    cents = money_cents(li)
    n = len(cents["l_price"])
    t0 = time.perf_counter()
    flba = write_parquet({"l_sdate": li["l_sdate"], "l_qty": cents["l_qty"],
                          "l_price": cents["l_price"],
                          "l_disc": cents["l_disc"]}, "snappy",
                         types={"l_sdate": dt.date32, "l_qty": MONEY128,
                                "l_price": MONEY128, "l_disc": MONEY128})
    flba_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    int64 = write_parquet({"l_rflag": li["l_rflag"],
                           "l_lstatus": li["l_lstatus"],
                           **{c: cents[c] for c in ("l_qty", "l_price",
                                                    "l_disc", "l_tax")}},
                          "snappy", types={c: MONEY64 for c in (
                              "l_qty", "l_price", "l_disc", "l_tax")})
    int64_s = time.perf_counter() - t0
    blobs = {"flba": flba, "int64": int64}
    encodings = {}
    for fname, blob in blobs.items():
        pf = tpq.ParquetFile(blob)
        for c in pf.metadata.row_groups[0].columns:
            encodings[f"{fname}.{c.meta_data.path_in_schema[0]}"] = [
                tpq.format.Encoding(e).name for e in c.meta_data.encodings]
    print(json.dumps({"decimal_pages": data_page_encodings(flba)}),
          flush=True)
    sources = {"flba": {"l_sdate": li["l_sdate"], "l_qty": cents["l_qty"],
                        "l_price": cents["l_price"],
                        "l_disc": cents["l_disc"]},
               "int64": {"l_rflag": li["l_rflag"],
                         "l_lstatus": li["l_lstatus"],
                         **{c: cents[c] for c in ("l_qty", "l_price",
                                                  "l_disc", "l_tax")}}}
    types = {"flba": {"l_sdate": dt.date32, "l_qty": MONEY128,
                      "l_price": MONEY128, "l_disc": MONEY128},
             "int64": {c: MONEY64 for c in ("l_qty", "l_price", "l_disc",
                                            "l_tax")}}
    scan = time_scan(blobs, dev, sources, types, check=check_decimal_scan)
    print(json.dumps({"decimal_scan": {
        **scan, "bytes": {k: len(b) for k, b in blobs.items()},
        "write_s": {"flba": flba_s, "int64": int64_s},
        "encodings": encodings, "card": card}}), flush=True)
    print(json.dumps({"decimal_scan_profile": profile_device(
        lambda: [scan_parquet(b, device=dev) for b in blobs.values()],
        lambda dbs: None, top=10)}), flush=True)

    launches, held, runs = {}, {}, {}
    keep = ((li["l_sdate"] >= Q6_DATE_LO) & (li["l_sdate"] < Q6_DATE_HI)
            & (cents["l_disc"] >= 5) & (cents["l_disc"] <= 7)
            & (cents["l_qty"] < Q6_QTY * 100))
    if int(keep.sum()) != q6_count:
        raise AssertionError(f"decimal Q6 keeps {int(keep.sum())} rows, "
                             f"the int Q6 {q6_count}")
    q6_check, q6_want = decimal_q6_check(cents, keep)
    q6_cols = ["l_sdate", "l_qty", "l_price", "l_disc"]

    def q6_from_bytes():
        return decimal_q6(scan_parquet(flba, q6_cols, dev))
    li_d = scan_parquet(flba, None, dev)
    li_i = scan_parquet(int64, None, dev)
    price64 = li_i.column("l_price")
    dp_want = cents["l_price"] * (100 - cents["l_disc"])
    q1_want = decimal_q1_oracle(li, cents)
    sort_want = np.argsort(-cents["l_price"], kind="stable")
    price128 = li_d.column("l_price")

    def check_sum(x):
        if x != int(cents["l_price"].sum()):
            raise AssertionError(f"decimal64 agg_sum(l_price) {x!r}")

    def check_disc_price(col):
        if str(col.type) != "decimal128(32, 4)":
            raise AssertionError(f"disc_price type {col.type}")
        check_limbs("disc_price", col, dp_want)

    def check_sort(perm):
        _equal("decimal128 sort_indices descending",
               perm.values[:n].cpu().numpy(), sort_want)
    paths = (
        ("decimal Q6", "decimal_q6", q6_from_bytes, q6_check, ("K1",)),
        ("disc_price", "disc_price", lambda: disc_price(li_d),
         check_disc_price, ()),
        ("decimal Q1", "decimal_q1", lambda: decimal_q1(li_i),
         lambda out: check_decimal_q1(out, q1_want), ("K1",)),
        ("decimal sum", "decimal_sum", lambda: pc.agg_sum(price64),
         check_sum, ("K3",)),
        ("decimal sort", "decimal_sort", lambda: pc.sort_indices(
            price128, order="descending"), check_sort, ()))
    for name, key, run, check, needs in paths:
        out, launches[name] = run_path(name, run, needs)
        check(out)
        if not timing_only and "K1" in needs:
            out, held[key] = check_path_calls(key, run, launches[name])
            check(out)
        outs, runs[key] = timed(run)
        for out in outs:
            check(out)
        del outs, out

    def line(key, name, **extra):
        print(json.dumps({key: {
            **extra, "ms_runs": runs[key],
            "ms_median": float(np.median(runs[key])),
            "launches_per_run": launches[name], "card": card,
            "verified": True}}), flush=True)
    rev = decimal_q6(li_d)
    revenue = int(_limb_ints(rev, rev.length)[0].sum())
    if revenue != int(q6_want.sum()):
        raise AssertionError(f"decimal Q6 revenue {revenue}")
    outs, compute_runs = timed(lambda: decimal_q6(li_d))
    for out in outs:
        q6_check(out)
    line("decimal_q6", "decimal Q6", rows=rev.length,
         revenue=str(decimal.Decimal(revenue).scaleb(-4)), product_type=str(
             rev.type), from_bytes=True, compute_ms_runs=compute_runs,
         compute_ms_median=float(np.median(compute_runs)))
    del rev, outs, out
    line("disc_price", "disc_price", rows=n, type="decimal128(32, 4)",
         profile=profile_device(lambda: disc_price(li_d), check_disc_price,
                                top=6))
    line("decimal_q1", "decimal Q1", groups=len(q1_want),
         result={f"{r}|{s}": v for (r, s), v in q1_want.items()})
    line("decimal_sum", "decimal sum", rows=n,
         unscaled=int(cents["l_price"].sum()))
    line("decimal_sort", "decimal sort", rows=n, order="descending")
    errs = {"K1": 0.0, "K3": 0.0}
    if not timing_only:
        print(json.dumps({"decimal_path_checks": held}), flush=True)
        errs["K1"] = max(h["K1"]["max_abs_err"] for h in held.values())
        errs["K3"] = check_k3_at("decimal sum", [(price64, "sum")])
    del li_d, li_i, price64, price128
    print(json.dumps({"limb_checks": {**limb_checks(dev), "card": card,
                                      "verified": True}}), flush=True)
    return {"launches": launches, "errs": errs}


# ---------------------------------------------------------------------------
# datasets from other writers: zstd files of many row groups with
# statistics and bloom filters, strings in PLAIN and DELTA pages
# ---------------------------------------------------------------------------

# the Arrow C++ parquet writer's defaults: row groups of at most
# parquet::DEFAULT_MAX_ROW_GROUP_LENGTH rows, 1 MiB data pages, a 1 MiB
# dictionary page limit; zstd at level 3 (Polars' default codec)
DATASET_ROWS_PER_GROUP = 1 << 20
DATASET_PAGE_BYTES = 1 << 20
DATASET_DICT_LIMIT = 1 << 20
DATASET_LEVEL = 3
DATASET_TIMED_RUNS = 1  # timed runs of dataset Q6 and Q10 (3 before the
                        # encodings phase: a cut)
LI_DATASET_FILES, ORD_DATASET_FILES = 8, 2
LI_DATASET_COLUMNS = ["l_okey", "l_sdate", "l_qty", "l_price", "l_disc",
                      "l_rflag"]
Q10_COLUMNS = ["l_okey", "l_price", "l_disc", "l_rflag"]
Q10_TOP = 20
STRING_ENCODINGS = {"plain": None,
                    "delta_length": "delta_length_byte_array",
                    "delta": "delta_byte_array"}


def customer_names(custkey: np.ndarray) -> np.ndarray:
    """C_NAME = "Customer#" and the key in 9 digits (TPC-H spec 4.2.3)."""
    out = np.empty(len(custkey), dtype=object)
    out[:] = ["Customer#%09d" % k for k in custkey.tolist()]
    return out


def dataset_tables(li, orders, cust) -> tuple:
    """The dataset's three tables: the lineitem columns sorted stably by
    l_sdate (a table clustered by ship date), the orders by o_odate, and
    the customers with their names."""
    order = np.argsort(li["l_sdate"], kind="stable")
    codes, values = li["l_rflag"]
    lis = {c: li[c][order] for c in LI_DATASET_COLUMNS if c != "l_rflag"}
    lis["l_rflag"] = (codes[order], values)
    order = np.argsort(orders["o_odate"], kind="stable")
    ords = {c: orders[c][order] for c in ("o_okey", "o_odate", "o_custkey")}
    keys = cust["c_custkey"]
    return lis, ords, {"c_custkey": keys, "c_name": (
        np.arange(len(keys), dtype=np.int32), customer_names(keys))}


def _rows(table: dict, a: int, b: int) -> dict:
    return {k: (v[0][a:b], v[1]) if isinstance(v, tuple) else v[a:b]
            for k, v in table.items()}


def write_dataset(root: str, lis, ords, cust, compression: str = "zstd",
                  rows_per_group: int = DATASET_ROWS_PER_GROUP,
                  dict_limit: int = DATASET_DICT_LIMIT,
                  tables=("lineitem", "orders", "customer")) -> dict:
    """The dataset's files under `root`, one directory a table: the
    lineitem in LI_DATASET_FILES files of equal l_sdate ranges, the
    orders in ORD_DATASET_FILES of equal row counts (a bloom filter on
    o_custkey), the customers once per c_name encoding (PLAIN where its
    dictionary passes `dict_limit`, DELTA_LENGTH_BYTE_ARRAY,
    DELTA_BYTE_ARRAY). Returns {table: [paths]}."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    opts = dict(compression=compression, compression_level=DATASET_LEVEL
                if compression == "zstd" else None,
                data_page_size=DATASET_PAGE_BYTES,
                row_group_size=rows_per_group,
                dictionary_pagesize_limit=dict_limit, write_page_index=False)
    out, jobs = {}, []

    def write(table, name, data, **extra):
        d = os.path.join(root, table)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, name)
        jobs.append((path, data, extra))
        out.setdefault(table, []).append(path)
    if "lineitem" in tables:
        cuts = lineitem_cuts(lis["l_sdate"])
        for i in range(LI_DATASET_FILES):
            write("lineitem", f"part-{i}.parquet",
                  _rows(lis, cuts[i], cuts[i + 1]))
    if "orders" in tables:
        cuts = np.linspace(0, len(ords["o_okey"]), ORD_DATASET_FILES + 1
                           ).astype(int).tolist()
        for i in range(ORD_DATASET_FILES):
            write("orders", f"part-{i}.parquet",
                  _rows(ords, cuts[i], cuts[i + 1]),
                  write_bloom_filters=["o_custkey"])
    if "customer" in tables:
        for name, encoding in STRING_ENCODINGS.items():
            write(f"customer_{name}", "part-0.parquet", cust,
                  column_encodings={"c_name": encoding} if encoding
                  else None)
    # the files are written side by side, one thread a file: the codecs
    # and most of numpy release the GIL
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        for f in [pool.submit(tpq.write_table, data, path, **opts, **extra)
                  for path, data, extra in jobs]:
            f.result()
    return out


def q6_over_batches(batches) -> dict:
    """Q6's SUM (K3) and COUNT over batches, each filtered (K1) by the
    WHERE clause, added across batches."""
    revenue, count = 0.0, 0
    for db in batches:
        rev = q6_revenue(db)
        if rev.length:
            revenue += pc.agg_sum(rev)
        count += rev.length
    return {"revenue": revenue, "count": count}


def dataset_q6(ds, dev, times=None, pruned: bool = True) -> dict:
    """TPC-H Q6 over a lineitem dataset: its WHERE clause as the
    scanner's filter, whose guards prune row groups by l_sdate's
    statistics (unless not `pruned`: every batch)."""
    sc = ds.scanner(columns=Q6_COLUMNS,
                    filter=q6_expression() if pruned else None, device=dev)
    return q6_over_batches(sc.device_batches(times=times))


def q10_window():
    """Q10's order-date window: Q4's two days (4.99% of the orders)."""
    f, lit, call = pc.field, pc.literal, pc.call
    return call("and", [call("greater_equal", [f("o_odate"),
                                               lit(Q4_ODATE_LO)]),
                        call("less", [f("o_odate"), lit(Q4_ODATE_HI)])])


def dataset_q10(li_ds, ord_ds, cust_ds, dev) -> HostBatch:
    """TPC-H Q10 (spec 2.4.10) as far as the tables go:

        SELECT c_custkey, c_name, SUM(l_price * (1 - l_disc)) AS revenue
        FROM customer, orders, lineitem
        WHERE c_custkey = o_custkey AND l_okey = o_okey
          AND o_odate in the window AND l_rflag = 'R'
        GROUP BY c_custkey, c_name ORDER BY revenue DESC LIMIT 20

    (c_acctbal, c_phone, n_name, c_address and c_comment are left out:
    the tables have no such columns). The orders in the window come
    from the scanner's to_table; each lineitem batch is filtered by
    l_rflag (its own dictionary's 'R'), inner-joined to them and summed
    by o_custkey; the partial sums are combined, the top 20 taken, and
    their names read from the customer dataset."""
    f, lit, call = pc.field, pc.literal, pc.call
    orders = one_batch(ord_ds.to_table(columns=["o_okey", "o_custkey"],
                                       filter=q10_window(), device=dev))
    ord_db = agt.device.block.host_batch_to_device(orders, dev)
    returned = call("equal", [f("l_rflag"), lit("R")])
    rev_expr = call("multiply", [f("l_price"), call("subtract", [
        lit(1.0), f("l_disc")])])
    keys, sums = [], []
    for db in li_ds.scanner(columns=Q10_COLUMNS, filter=returned,
                            device=dev).device_batches():
        li_f = pc.filter(project(db, ["l_okey", "l_price", "l_disc"]),
                         pc.execute_scalar_expression(returned, db))
        if not li_f.length:
            continue
        j = pc.hash_join(li_f, ord_db, left_keys=["l_okey"],
                         right_keys=["o_okey"],
                         output_columns=["l_price", "l_disc", "o_custkey"])
        rev = pc.execute_scalar_expression(rev_expr, j)
        g = pc.group_by(DeviceBatch(
            dt.Schema([dt.Field("o_custkey", dt.int64),
                       dt.Field("rev", dt.float64)]),
            [j.column("o_custkey"), rev], j.length), "o_custkey",
            [("rev", "sum")])
        keys.append(g.column("o_custkey").values)
        sums.append(g.column("rev_sum").values)
    both = agt.batch_to_device({"o_custkey": np.concatenate(keys),
                                "rev": np.concatenate(sums)}, device=dev)
    g = pc.group_by(both, "o_custkey", [("rev", "sum")])
    idx = pc.sort_indices(g.column("rev_sum"), order="descending")
    top = {nm: pc.take(g.column(nm), idx).values[:Q10_TOP]
           for nm in ("o_custkey", "rev_sum")}
    names = cust_ds.to_table(columns=["c_custkey", "c_name"], filter=call(
        "is_in", [f("c_custkey")], {"value_set": top["o_custkey"].tolist()}),
        device=dev).to_pydict()
    name_of = dict(zip(names["c_custkey"], names["c_name"]))
    return HostBatch.from_arrays({
        "c_custkey": HostArray(top["o_custkey"], None, dt.int64),
        "c_name": HostArray(np.array([name_of[k] for k in top[
            "o_custkey"].tolist()], dtype=object), None, dt.string),
        "revenue": HostArray(top["rev_sum"], None, dt.float64)})


def q10_oracle(li, orders) -> dict:
    """numpy Q10: the top customers' keys, names and revenues."""
    in_window = (orders["o_odate"] >= Q4_ODATE_LO) & (
        orders["o_odate"] < Q4_ODATE_HI)
    codes, values = li["l_rflag"]
    m = (values[codes] == "R") & in_window[li["l_okey"]]
    cust = orders["o_custkey"][li["l_okey"][m]]
    rev = np.bincount(cust, weights=(li["l_price"] * (1 - li["l_disc"]))[m])
    present = np.flatnonzero(np.bincount(cust, minlength=len(rev)))
    top = present[np.argsort(-rev[present], kind="stable")][:Q10_TOP]
    return {"c_custkey": top.tolist(),
            "c_name": customer_names(top).tolist(), "revenue": rev[top]}


def check_q10(out: HostBatch, want: dict) -> None:
    got = out.to_pydict()
    if got["c_custkey"] != want["c_custkey"] or \
            got["c_name"] != want["c_name"]:
        raise AssertionError(f"Q10: customers {got['c_custkey']} / "
                             f"{got['c_name'][:2]}..., oracle "
                             f"{want['c_custkey']}")
    np.testing.assert_allclose(got["revenue"], want["revenue"], rtol=1e-9)


def dataset_lookup(ord_ds, key: int, dev) -> dict:
    """The orders of one customer through to_table(o_custkey == key),
    and the row groups kept by statistics alone and by statistics and
    the bloom filter."""
    f, lit, call = pc.field, pc.literal, pc.call
    expr = call("equal", [f("o_custkey"), lit(key)])
    sc = ord_ds.scanner(columns=["o_okey"], filter=expr, device=dev)
    kept = [sum(len(k) for _, k, _ in sc.row_groups(bloom))
            for bloom in (False, True)]
    okeys = one_batch(sc.to_table()).column("o_okey").values
    return {"key": key, "rows": len(okeys), "o_okey": np.sort(okeys),
            "kept_by_stats": kept[0], "kept_by_bloom": kept[1]}


def check_string_pages(ds, names: np.ndarray, dev, times=None) -> int:
    """c_name scanned from a customer dataset: each batch's values are
    the names of its rows, bit for bit, and its codes number them in
    order of first occurrence. Returns the rows checked."""
    start = 0
    for db in ds.scanner(columns=["c_name"], device=dev).device_batches(
            times=times):
        c = db.column("c_name")
        codes = c.values[:c.length].cpu().numpy()
        got = c.dict_values[codes]
        want = names[start:start + c.length]
        if c.validity is not None or not np.array_equal(got, want):
            raise AssertionError("string pages: values differ")
        # codes by first occurrence: each code is at most one past the
        # largest before it, and the largest is the dictionary's last
        run = np.maximum.accumulate(np.concatenate(([-1], codes)))
        if (codes > run[:-1] + 1).any() or \
                run[-1] + 1 != len(c.dict_values):
            raise AssertionError("string pages: codes not in first-"
                                 "occurrence order")
        start += c.length
    if start != len(names):
        raise AssertionError(f"string pages: {start} rows of {len(names)}")
    return start


def zstd_decode_rate(paths) -> dict:
    """The host zstd decoder over every page of the files, timed alone:
    MB of output per second, pages and bytes."""
    from arrow_go_tpu_torch import native
    from arrow_go_tpu_torch.parquet.device_read import _iter_pages
    pages = []
    for path in paths:
        with tpq.ParquetFile(path) as pf:
            for rg in pf.metadata.row_groups:
                for c in rg.columns:
                    pages += [(bytes(body), hdr.uncompressed_page_size)
                              for hdr, body in _iter_pages(pf, c)]
    t0 = time.perf_counter()
    for body, size in pages:
        native.zstd_decompress(body, size)
    sec = time.perf_counter() - t0
    out = sum(size for _, size in pages)
    return {"pages": len(pages), "in_bytes": sum(len(b) for b, _ in pages),
            "out_bytes": out, "s": sec, "mb_per_s": out / sec / 1e6}


def dataset_phases(li, orders, dev, card: str,
                   timing_only: bool = False) -> dict:
    """This slice's paths at the scale of `li`: the lineitem, orders and
    customer tables written as a zstd dataset of many files and row
    groups (write_dataset) into a temporary directory; Q6 pruned by
    statistics and not, Q10, the bloom-filter lookups, the three string
    encodings and the codec, each against numpy. Every K1, K2 and K3
    call of one more run of dataset Q6 and Q10 is held against the plain
    version (not with `timing_only`). Returns each path's launch counts
    and the largest kernel - plain difference."""
    import os
    import tempfile
    from arrow_go_tpu_torch.dataset import dataset
    t_phase = time.perf_counter()
    lis, ords, cus = dataset_tables(li, orders,
                                    customer_table(len(orders["o_okey"])))
    names = cus["c_name"][1]
    launches, runs, held = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = write_dataset(os.path.join(root, "zstd"), lis, ords, cus)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        snappy = write_dataset(os.path.join(root, "snappy"), lis, ords, cus,
                               compression="snappy", tables=("lineitem",))
        snappy_s = time.perf_counter() - t0
        sets = {t: dataset(os.path.dirname(p[0])) for t, p in paths.items()}
        li_ds, ord_ds = sets["lineitem"], sets["orders"]
        nbytes = {t: sum(os.path.getsize(p) for p in ps)
                  for t, ps in paths.items()}
        print(json.dumps({"dataset": {
            "files": {t: len(p) for t, p in paths.items()},
            "row_groups": {t: sum(n for *_, n in d.scanner().row_groups())
                           for t, d in sets.items()},
            "zstd_bytes": nbytes, "snappy_lineitem_bytes": sum(
                os.path.getsize(p) for p in snappy["lineitem"]),
            "write_s": write_s, "snappy_write_s": snappy_s,
            "card": card}}), flush=True)

        def line(key, **extra):
            print(json.dumps({key: {
                **extra, "ms_runs": runs[key],
                "ms_median": float(np.median(runs[key])), "card": card,
                "verified": True}}), flush=True)

        def kept(ds, expr):
            rgs = ds.scanner(filter=expr).row_groups()
            return {"kept": sum(len(k) for _, k, _ in rgs),
                    "total": sum(n for *_, n in rgs)}
        q6_want = q6_oracle(li)

        def q6():
            return dataset_q6(li_ds, dev)

        def q6_unpruned():
            return dataset_q6(li_ds, dev, pruned=False)
        results = {}
        for key, name, run in (("dataset_q6", "dataset Q6", q6),
                               ("dataset_q6_unpruned", "dataset Q6 unpruned",
                                q6_unpruned)):
            got, launches[name] = run_path(name, run, ("K1", "K3"))
            check_q6(got, q6_want)
            results[key] = got
            outs, runs[key] = timed(run, DATASET_TIMED_RUNS)
            for out in outs:
                check_q6(out, q6_want)
            split = {}
            dataset_q6(li_ds, dev, split, pruned=run is q6)
            line(key, **got, row_groups=kept(
                li_ds, q6_expression() if run is q6 else None),
                split_ms={k[:-2] + "_ms": v * 1e3 for k, v in split.items()},
                launches_per_run=launches[name])

        q10_want = q10_oracle(li, orders)

        def q10():
            return dataset_q10(li_ds, ord_ds, sets["customer_plain"], dev)
        out, launches["dataset Q10"] = run_path("dataset Q10", q10,
                                                ("K1", "K2"))
        check_q10(out, q10_want)
        outs, runs["dataset_q10"] = timed(q10, DATASET_TIMED_RUNS)
        for out in outs:
            check_q10(out, q10_want)
        f, lit, call = pc.field, pc.literal, pc.call
        line("dataset_q10", top=out.to_pydict(),
             orders_row_groups=kept(ord_ds, q10_window()),
             lineitem_row_groups=kept(li_ds, call("equal", [
                 f("l_rflag"), lit("R")])),
             left_out="c_acctbal, c_phone, n_name, c_address, c_comment "
                      "(no such columns)",
             launches_per_run=launches["dataset Q10"])

        ck = orders["o_custkey"]
        n_cust = len(names)
        keys = [int(ck[i]) for i in np.linspace(0, len(ck) - 1, 4
                                                ).astype(int)] + \
            [3, 3 * (n_cust // 9 + 1), 3 * (n_cust // 6 + 1), 3 * (
                n_cust // 3)]
        lookups = []
        for k in keys:
            t0 = time.perf_counter()
            r = dataset_lookup(ord_ds, k, dev)
            r["ms"] = (time.perf_counter() - t0) * 1e3
            want = np.sort(orders["o_okey"][ck == k])
            if not np.array_equal(r.pop("o_okey"), want):
                raise AssertionError(f"lookup {k}: rows differ from numpy")
            lookups.append(r)
        print(json.dumps({"dataset_lookup": {
            "lookups": lookups, "card": card, "verified": True}}),
            flush=True)

        pages = {}
        for name in STRING_ENCODINGS:
            split = {}
            t0 = time.perf_counter()
            rows = check_string_pages(sets[f"customer_{name}"], names, dev,
                                      split)
            pages[name] = {
                "rows": rows, "bytes": nbytes[f"customer_{name}"],
                "ms": (time.perf_counter() - t0) * 1e3,
                "host_decode_ms": split.get("strings_s", 0.0) * 1e3,
                "split_ms": {k[:-2] + "_ms": v * 1e3
                             for k, v in split.items()}}
        print(json.dumps({"string_pages": {**pages, "card": card,
                                           "verified": True}}), flush=True)
        print(json.dumps({"zstd": {
            "bytes": nbytes, "snappy_lineitem_bytes": sum(
                os.path.getsize(p) for p in snappy["lineitem"]),
            "level": DATASET_LEVEL,
            "decode": zstd_decode_rate(paths["lineitem"]),
            "card": card}}), flush=True)
        errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
        if not timing_only:
            out, held["dataset_q6"] = check_path_calls(
                "dataset_q6", q6, launches["dataset Q6"], k3=True)
            check_q6(out, q6_want)
            out, held["dataset_q10"] = check_path_calls(
                "dataset_q10", q10, launches["dataset Q10"], k3=True)
            check_q10(out, q10_want)
            print(json.dumps({"dataset_path_checks": held}), flush=True)
            for k in errs:
                errs[k] = max(h[k]["max_abs_err"] for h in held.values())
    print(json.dumps({"dataset_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs, "q6": results["dataset_q6"]}


# ---------------------------------------------------------------------------
# the distributed tier (arrow_go_tpu_torch.parallel) at world size 1
# ---------------------------------------------------------------------------

DIST_AGGS = [(c, a) for c in ("l_qty", "l_price", "l_disc")
             for a in ("sum", "mean", "count", "min", "max")]
DIST_ODATE_MAX = 736              # orders kept by the join sweep's window
DIST_HOWS = ["inner", "left outer", "right outer", "full outer",
             "left semi", "left anti"]
ZIPF_S = 1.1                      # the hot join's probe-key skew
HOT_K = 16
STREAM_TABLE = 1 << 25            # hash slots of the streamed group-by


def host_batch(table: dict, names) -> HostBatch:
    """A HostBatch of the named columns of a numpy table; an (int32
    codes, values) pair becomes a dictionary column."""
    cols = {}
    for nm in names:
        v = table[nm]
        if isinstance(v, tuple):
            cols[nm] = HostArray(v[0], None, dt.string, v[1])
        else:
            cols[nm] = HostArray(v, None, dt.from_numpy_dtype(v.dtype))
    return HostBatch.from_arrays(cols)


def dist_q1_oracle(li) -> dict:
    """Q1's keys with sum, mean, count, min and max of l_qty, l_price and
    l_disc per (l_rflag, l_lstatus), groups in code order (numpy)."""
    rcode, rvals = li["l_rflag"]
    scode, svals = li["l_lstatus"]
    key = rcode.astype(np.int64) * len(svals) + scode
    groups = np.flatnonzero(np.bincount(key, minlength=len(rvals)
                                        * len(svals)))
    out = {"l_rflag": [rvals[g // len(svals)] for g in groups],
           "l_lstatus": [svals[g % len(svals)] for g in groups]}
    masks = [key == g for g in groups]
    counts = [int(m.sum()) for m in masks]
    for c in ("l_qty", "l_price", "l_disc"):
        v = li[c]
        sums = [_np_sum(v, m) for m in masks]
        big = np.inf if v.dtype.kind == "f" else np.iinfo(v.dtype).max
        out.update({f"{c}_sum": sums,
                    f"{c}_mean": [x / k for x, k in zip(sums, counts)],
                    f"{c}_count": counts,
                    f"{c}_min": [v.min(where=m, initial=big).item()
                                 for m in masks],
                    f"{c}_max": [v.max(where=m, initial=-big).item()
                                 for m in masks]})
    return {k: out[k] for k in ["l_rflag", "l_lstatus"] + [
        f"{c}_{a}" for c, a in DIST_AGGS]}


def check_dist_q1(out: HostBatch, want: dict) -> None:
    """Keys, order, counts, minima and maxima exact; sums and means at
    rtol 1e-9."""
    got = out.to_pydict()
    if list(got) != list(want):
        raise AssertionError(f"dist_q1 columns {list(got)}")
    for k, v in want.items():
        if k.endswith(("_sum", "_mean")) and isinstance(v[0], float):
            if not np.allclose(got[k], v, rtol=1e-9, atol=0):
                raise AssertionError(f"dist_q1 {k}: {got[k]}, numpy {v}")
        elif got[k] != v:
            raise AssertionError(f"dist_q1 {k}: {got[k]}, numpy {v}")


def _np_sum(a: np.ndarray, where=None):
    total = np.sum(a, where=True if where is None else where)
    return float(total) if a.dtype.kind == "f" else int(total)


def _sum(t: torch.Tensor):
    """A column's sum: float64 for floats, exact int64 for the rest."""
    if t.dtype.is_floating_point:
        return float(t.to(torch.float64).sum())
    return int(t.to(torch.int64).sum())


def join_sums(lk, lp, rk, rp, right_unique: bool = True) -> dict:
    """numpy, for each join type: rows and per-column sums of lk/lp JOIN
    rk/rp, the right side's keys unique (or the left's:
    right_unique=False); unmatched rows carry 0 payloads and their own
    side's key; for semi/anti the verdict's rows."""
    uk, mk = (rk, lk) if right_unique else (lk, rk)   # unique, many
    pos = np.full(int(max(lk.max(), rk.max())) + 1, -1, np.int64)
    pos[uk] = np.arange(len(uk))
    at = pos[mk]
    m = at >= 0                       # many-side rows that match
    per_u = np.bincount(at[m], minlength=len(uk))     # pairs a unique row
    hit = per_u > 0                   # unique-side rows that match
    lhit, rhit = (m, hit) if right_unique else (hit, m)
    up, mp = (rp, lp) if right_unique else (lp, rp)
    # pairs: one per matching many-side row
    pairs = {"rows": int(m.sum()), "key": _np_sum(mk, m),
             "matched": int(m.sum())}
    many_sum = _np_sum(mp, m)
    uniq_sum = float(np.dot(up.astype(np.float64), per_u)) \
        if up.dtype.kind == "f" else int(np.dot(up.astype(np.int64), per_u))
    pairs["lpay"], pairs["rpay"] = (many_sum, uniq_sum) if right_unique \
        else (uniq_sum, many_sum)
    out = {"left semi": {"rows": int(lhit.sum())},
           "left anti": {"rows": int((~lhit).sum())}}
    for how in ("inner", "left outer", "right outer", "full outer"):
        o = dict(pairs)
        if how in ("left outer", "full outer"):
            o["rows"] += int((~lhit).sum())
            o["key"] += _np_sum(lk, ~lhit)
            o["lpay"] += _np_sum(lp, ~lhit)
        if how in ("right outer", "full outer"):
            o["rows"] += int((~rhit).sum())
            o["key"] += _np_sum(rk, ~rhit)
            o["rpay"] += _np_sum(rp, ~rhit)
        out[how] = o
    return out


def dist_join_sums(how: str, out, n_groups: int) -> dict:
    """The same sums over a distributed join's outputs (each group's
    [0, n) prefix; semi/anti: the verdict)."""
    if how in ("left semi", "left anti"):
        return {"rows": int(out[0].sum())}
    got = {"rows": 0, "key": 0, "lpay": 0, "rpay": 0, "matched": 0}
    for g in range(n_groups):
        keys, lp, rp, rmatch, n = out[5 * g: 5 * g + 5]
        n = int(n[0])
        got["rows"] += n
        got["key"] += _sum(keys[0][:n])
        got["lpay"] += _sum(lp[0][:n])
        got["rpay"] += _sum(rp[0][:n])
        got["matched"] += int(rmatch[:n].sum())
    return got


def check_join_sums(what: str, got: dict, want: dict) -> None:
    for k, w in want.items():
        g = got[k]
        ok = np.isclose(g, w, rtol=1e-9, atol=0) if isinstance(w, float) \
            else g == w
        if not ok:
            raise AssertionError(f"{what} {k}: {g}, numpy {w}")


def zipf_keys(n: int, n_keys: int, dev) -> torch.Tensor:
    """n keys over [0, n_keys), the key of rank r (1-based) drawn with
    probability proportional to r**-ZIPF_S (inverse CDF of uniforms of
    seed 14, on the device), ranks mapped to keys by a fixed random
    permutation so that the hot keys spread over the key range."""
    rng = np.random.default_rng(14)
    w = np.arange(1, n_keys + 1, dtype=np.float64) ** -ZIPF_S
    cdf = torch.from_numpy(np.cumsum(w) / w.sum()).to(dev)
    u = torch.from_numpy(rng.random(n)).to(dev)
    ranks = torch.searchsorted(cdf, u).clamp(max=n_keys - 1)
    return torch.from_numpy(rng.permutation(n_keys)).to(dev)[ranks]


DIST_TIMED_RUNS = 1     # timed runs a dist path (3 before the encodings
                        # phase: a cut)
# lineitem rows of the dist paths (all of SF10's before the host-API
# phase: a cut): about a quarter, a multiple of the streamed group-by's 4
# chunks, which read no row past the last whole chunk
DIST_ROWS = LINEITEM_SF10 // 16 * 4


def dist_phases(li, orders, dev, card: str,
                timing_only: bool = False) -> dict:
    """This slice's paths on one NCCL process group of world size 1
    (tcp://127.0.0.1:<free port>), every exchange through NCCL:
    `dist_q1` (distributed_group_by of every lineitem row by the two Q1
    flags), `dist_join` (make_distributed_join of lineitem with the
    orders of o_odate < DIST_ODATE_MAX, all six types), `dist_hot_join`
    (Zipf(1.1) lineitem keys over all orders, hot_k=16, inner and left
    outer: path A with the Zipf keys probing, path B with them as the
    build side; each equal to the hot_k=0 join), `dist_sort`
    (distributed_sort of orders on (o_odate, o_okey)) and
    `dist_streamed` (make_group_by_sum_streamed against
    make_group_by_sum by l_okey), each against numpy after one counted
    run, then DIST_TIMED_RUNS timed runs. Every K1 and K2 call of one
    more run of each
    path is held against the plain version (not with `timing_only`).
    Returns each path's launch counts and the largest kernel - plain
    difference."""
    import torch.distributed as tdist
    from arrow_go_tpu_torch.parallel.mesh import free_port
    t_phase = time.perf_counter()
    tdist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
        world_size=1, rank=0)
    try:
        out = _dist_paths(li, orders, dev, card, timing_only)
    finally:
        tdist.destroy_process_group()
    print(json.dumps({"dist_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return out


def _dist_paths(li, orders, dev, card, timing_only) -> dict:
    import torch.distributed as tdist
    from arrow_go_tpu_torch.parallel import api as papi
    from arrow_go_tpu_torch.parallel import aggregate, mesh as pmesh
    from arrow_go_tpu_torch.parallel import dist as pdist, overlap
    mesh = pmesh.make_mesh(dev)
    if tdist.get_backend() != "nccl" or mesh.world_size != 1:
        raise AssertionError(f"dist: {tdist.get_backend()} group of "
                             f"{mesh.world_size}")
    n_li, n_ord = len(li["l_okey"]), len(orders["o_okey"])
    launches, paths, runs, held = {}, {}, {}, {}
    oracle_s = [0.0]                  # host time of the numpy oracles

    def oracle(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        oracle_s[0] += time.perf_counter() - t0
        return out

    def run(key, name, fn, check, needs, **extra):
        """One counted run, DIST_TIMED_RUNS timed runs, each checked; the
        exchange's bytes and the peak memory of the counted run."""
        for f in (pmesh.all_to_all, pmesh.all_gather):
            f.bytes = 0
        torch.cuda.reset_peak_memory_stats()
        got, launches[name] = run_path(name, fn, needs)
        check(got)
        moved = pmesh.all_to_all.bytes + pmesh.all_gather.bytes
        peak = torch.cuda.max_memory_allocated()
        outs, runs[key] = timed(fn, DIST_TIMED_RUNS)
        for o in outs:
            check(o)
        paths[key] = {**extra, "ms_runs": runs[key],
                      "ms_median": float(np.median(runs[key])),
                      "exchange_bytes": moved, "peak_mem_bytes": peak,
                      "launches_per_run": launches[name]}
        return got

    # ---- dist_q1: the HostBatch API over every lineitem row
    li_hb = host_batch(li, ["l_rflag", "l_lstatus", "l_qty", "l_price",
                            "l_disc"])
    q1_want = oracle(dist_q1_oracle, li)

    def q1():
        # after the local pre-aggregation a rank ships one row a group
        return papi.distributed_group_by(
            li_hb, ["l_rflag", "l_lstatus"], DIST_AGGS, mesh=mesh, cap=1024)
    out = run("dist_q1", "dist Q1", q1, lambda o: check_dist_q1(o, q1_want),
              ("K1",), rows=n_li, groups=len(q1_want["l_rflag"]))

    # ---- dist_join: lineitem JOIN the orders of a date window, six types
    keep = orders["o_odate"] < DIST_ODATE_MAX
    l_key, l_pay = li["l_okey"], li["l_price"]
    o_key, o_pay = orders["o_okey"][keep], orders["o_odate"][keep]
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    lk, lp, rk, rp = on(l_key), on(l_pay), on(o_key), on(o_pay)
    lval = torch.ones(n_li, dtype=torch.bool, device=dev)
    rval = torch.ones(len(o_key), dtype=torch.bool, device=dev)
    lnull = torch.zeros(n_li, dtype=torch.bool, device=dev)
    join_fns = {}
    wants = oracle(join_sums, l_key, l_pay, o_key, o_pay)
    for how in DIST_HOWS:
        fn = pdist.make_distributed_join(
            mesh, cap_shuffle=n_li, cap_out=n_li + len(o_key), how=how)
        args = (lk, lp, lval, rk, rp, rval) + (
            (lnull,) if how in ("left semi", "left anti") else ())
        want = wants[how]

        def call(fn=fn, args=args):
            return fn(*args)

        def check(o, how=how, want=want):
            if bool(o[-1]):
                raise AssertionError(f"dist_join {how}: overflow")
            check_join_sums(f"dist_join {how}", dist_join_sums(how, o, 1),
                            want)
        run(f"dist_join {how}", f"dist join {how}", call, check,
            ("K1", "K2"), rows=want["rows"], probe_rows=n_li,
            build_rows=len(o_key))
        join_fns[how] = (call, check)

    # ---- dist_hot_join: Zipf probe keys, paths A and B, against hot_k=0
    zk = zipf_keys(n_li, n_ord, dev)
    z_key = zk.cpu().numpy()
    okey, odate = on(orders["o_okey"]), on(orders["o_odate"])
    oval = torch.ones(n_ord, dtype=torch.bool, device=dev)
    counts = np.bincount(z_key, minlength=n_ord)
    top = np.sort(counts)[::-1][:HOT_K]
    hot_kw = {"hot_k": HOT_K, "hot_thresh": int(top[-1]) // 2,
              "cap_hot": 1024, "cap_hot_out": n_li + n_ord}
    sides = {"A": ((zk, lp, lval, okey, odate, oval),
                   (z_key, l_pay, orders["o_okey"], orders["o_odate"],
                    True)),
             "B": ((okey, odate, oval, zk, lp, lval),
                   (orders["o_okey"], orders["o_odate"], z_key, l_pay,
                    False))}
    hot = {}
    for side, (args, host) in sides.items():
        wants = oracle(join_sums, *host)
        for how in ("inner", "left outer"):
            want = wants[how]
            kw = {"cap_shuffle": max(n_li, n_ord), "cap_out": n_li + n_ord,
                  "how": how}
            fn = pdist.make_distributed_join(mesh, **kw, **hot_kw)
            plain = pdist.make_distributed_join(mesh, **kw)

            def call(fn=fn, args=args):
                return fn(*args)

            def check(o, how=how, want=want, side=side):
                if bool(o[-1]):
                    raise AssertionError(f"dist_hot_join {side} {how}: "
                                         "overflow")
                got = dist_join_sums(how, o, 3)
                check_join_sums(f"dist_hot_join {side} {how}", got, want)
                # the hot paths took rows: path A's or path B's group
                n_hot = int(o[9 if side == "A" else 14][0])
                if n_hot < 1:
                    raise AssertionError(f"dist_hot_join {side} {how}: "
                                         "no row took the hot path")
            key = f"dist_hot_join {side} {how}"
            run(key, f"dist hot join {side} {how}", call, check,
                ("K1", "K2"), rows=want["rows"], hot_keys=HOT_K,
                top_key_rows=int(top[0]))
            flat = plain(*args)
            check_join_sums(f"{key} hot_k=0", dist_join_sums(how, flat, 1),
                            want)
            hot[key] = (call, check)

    # ---- dist_sort: orders on (o_odate, o_okey) through the API
    ord_hb = host_batch(orders, ["o_odate", "o_okey", "o_custkey"])
    order = oracle(np.lexsort, (orders["o_okey"], orders["o_odate"]))

    def sort():
        return papi.distributed_sort(ord_hb, ["o_odate", "o_okey"],
                                     mesh=mesh)

    def check_sort(o):
        for c in ("o_odate", "o_okey", "o_custkey"):
            if not np.array_equal(o.column(c).values, orders[c][order]):
                raise AssertionError(f"dist_sort {c} differs from lexsort")
    run("dist_sort", "dist sort", sort, check_sort, (), rows=n_ord)

    # ---- dist_streamed: the chunk pipeline against the barrier form
    qty = on(li["l_qty"].astype(np.int64))
    sums_want = oracle(np.bincount, l_key, weights=li["l_qty"],
                       minlength=n_ord)
    cnt_want = oracle(np.bincount, l_key, minlength=n_ord)
    present = np.flatnonzero(cnt_want)
    streamed = overlap.make_group_by_sum_streamed(
        mesh, cap=n_li // 4 + 1, n_chunks=4, table_size=STREAM_TABLE)
    barrier = aggregate.make_group_by_sum(mesh, cap=n_li)

    def check_groups(what, keys, sums, counts, n_groups, overflow):
        if bool(overflow) or n_groups != len(present):
            raise AssertionError(f"{what}: {n_groups} groups, numpy "
                                 f"{len(present)}, overflow {bool(overflow)}")
        o = torch.argsort(keys)
        if not (np.array_equal(keys[o].cpu().numpy(), present)
                and np.array_equal(sums[o].cpu().numpy(),
                                   sums_want[present].astype(np.int64))
                and np.array_equal(counts[o].cpu().numpy(),
                                   cnt_want[present])):
            raise AssertionError(f"{what}: groups differ from numpy")

    def stream():
        return streamed(lk, qty, lval)

    def check_stream(o):
        tk, sums, counts, occ, ng, ov = o
        check_groups("dist_streamed", tk[occ], sums[occ], counts[occ],
                     int(ng[0]), ov)

    def barrier_run():
        return barrier(lk, qty, lval)

    def check_barrier(o):
        gk, sums, counts, ng, ov = o
        n = int(ng[0])
        check_groups("dist_barrier", gk[:n], sums[:n], counts[:n], n, ov)
    run("dist_streamed", "dist streamed", stream, check_stream, (),
        rows=n_li, groups=len(present), n_chunks=4,
        table_size=STREAM_TABLE)
    run("dist_barrier", "dist barrier", barrier_run, check_barrier, ("K1",),
        rows=n_li, groups=len(present))

    print(json.dumps({"dist": {
        "world_size": mesh.world_size, "backend": tdist.get_backend(),
        "device": str(mesh.device), "paths": paths,
        "streamed_vs_barrier_ms": [paths["dist_streamed"]["ms_median"],
                                   paths["dist_barrier"]["ms_median"]],
        "oracle_s": oracle_s[0], "card": card, "verified": True}}),
        flush=True)
    print(json.dumps({"dist_profile": {
        "dist_q1": profile_device(q1, lambda o: check_dist_q1(o, q1_want)),
        "dist_join inner": profile_device(*join_fns["inner"])}}),
        flush=True)
    errs = {"K1": 0.0, "K2": 0.0}
    if not timing_only:
        checks = {"dist_q1": (q1, lambda o: check_dist_q1(o, q1_want),
                              "dist Q1")}
        for how, (call, check) in join_fns.items():
            checks[f"dist_join {how}"] = (call, check, f"dist join {how}")
        for key, (call, check) in hot.items():
            checks[key] = (call, check, "dist hot join" + key[13:])
        checks["dist_sort"] = (sort, check_sort, "dist sort")
        checks["dist_streamed"] = (stream, check_stream, "dist streamed")
        checks["dist_barrier"] = (barrier_run, check_barrier, "dist barrier")
        t0 = time.perf_counter()
        for key, (call, check, name) in checks.items():
            o, held[key] = check_path_calls(key, call, launches[name])
            check(o)
        print(json.dumps({"dist_path_checks": {
            **held, "s": time.perf_counter() - t0}}), flush=True)
        for k in errs:
            errs[k] = max(h[k]["max_abs_err"] for h in held.values())
    return {"launches": launches, "errs": errs}


# ---------------------------------------------------------------------------
# nested types: a list column on the card, value_counts, the column filter
# and the narrow / unsigned aggregates
# ---------------------------------------------------------------------------

NESTED_ODATE_MAX = 720            # the list filter keeps o_odate < 720
NESTED_TAKE_NULL = 0.05           # share of null take indices


def order_price_lists(okey: torch.Tensor, price: torch.Tensor,
                      n_ord: int) -> tuple:
    """(list<double> of each order's l_price on the card, the sort's
    permutation): offsets from the counts of l_okey, the child ordered
    by one stable sort of l_okey."""
    dev = okey.device
    sidx = torch.sort(okey, stable=True).indices
    counts = torch.bincount(okey, minlength=n_ord)
    P = agt.pad_length(n_ord)
    off = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=off[1:n_ord + 1])
    off[n_ord + 1:] = off[n_ord]
    n = okey.shape[0]
    child = torch.zeros(agt.pad_length(n), dtype=torch.float64, device=dev)
    child[:n] = price.index_select(0, sidx)
    return agt.DeviceListColumn(
        off.to(torch.int32), DeviceColumn(child, None, n, dt.float64), None,
        n_ord, dt.list_(dt.float64)), sidx


def check_list_build(col, sidx: torch.Tensor, li) -> tuple:
    """The list column against numpy: the sort a stable permutation of
    l_okey, the offsets the counts' prefix sums, the child l_price in that
    order, bit for bit. Returns the host offsets and child."""
    okey, n_ord = li["l_okey"], col.length
    s = sidx.cpu().numpy()
    k = okey[s]
    if not ((np.diff(k) >= 0).all() and (np.diff(s)[np.diff(k) == 0] > 0
                                         ).all()):
        raise AssertionError("nested: the l_okey sort is not stable")
    if not (np.bincount(s, minlength=len(okey)) == 1).all():
        raise AssertionError("nested: the l_okey sort is no permutation")
    off = np.concatenate(([0], np.cumsum(np.bincount(okey,
                                                     minlength=n_ord))))
    _equal("nested list offsets", col.offsets[:n_ord + 1].cpu().numpy(),
           off.astype(np.int32))
    child = li["l_price"][s]
    _equal("nested list child", _host(col.child).view(np.int64),
           child.view(np.int64))
    return off, child


def list_take_oracle(off: np.ndarray, child: np.ndarray, idx: np.ndarray):
    """(offsets, child, validity) of rows idx (-1 = null) of the list
    (off, child), with numpy (the port's expand_runs)."""
    from arrow_go_tpu_torch.compute.nested_selection import expand_runs
    ok = idx >= 0
    safe = np.where(ok, idx, 0)
    starts = np.where(ok, off[:-1][safe], 0)
    lens = np.where(ok, np.diff(off)[safe], 0)
    out_off = np.concatenate(([0], np.cumsum(lens)))
    return out_off, child[expand_runs(starts, lens)], ok


def check_list_take(what: str, out, want) -> None:
    off, child, ok = want
    n = out.length
    if n != len(ok):
        raise AssertionError(f"{what}: {n} rows, numpy {len(ok)}")
    _equal(f"{what} offsets", out.offsets[:n + 1].cpu().numpy(),
           off.astype(np.int32))
    _equal(f"{what} child", _host(out.child).view(np.int64),
           child.view(np.int64))
    words = out.validity.cpu().numpy().view(np.uint32)
    _equal(f"{what} validity", np.unpackbits(
        words.view(np.uint8), bitorder="little")[:n].astype(bool), ok)


def value_counts_oracle(v: np.ndarray, n_keys: int):
    """(values, counts) of v's distinct values (ints in [0, n_keys)) in
    first-occurrence order, with numpy in O(n): the first row of each
    value by a reversed scatter."""
    counts = np.bincount(v, minlength=n_keys)
    first = np.full(n_keys, len(v), np.int64)
    first[v[::-1]] = np.arange(len(v) - 1, -1, -1)
    keys = np.flatnonzero(counts)
    keys = keys[np.argsort(first[keys], kind="stable")]
    return keys, counts[keys]


def check_value_counts(what: str, got: HostArray, v, n_keys: int,
                       base: int = 0) -> int:
    keys, counts = value_counts_oracle(v - base, n_keys)
    _equal(f"{what} values", got.children[0].values.astype(np.int64),
           keys + base)
    _equal(f"{what} counts", got.children[1].values, counts)
    if got.children[0].mask is not None:
        raise AssertionError(f"{what}: a null entry without nulls")
    return len(keys)


def same_result(what: str, got, want) -> None:
    """A repeated run's result bit for bit equal to the first, verified
    one (on the device for a list column or a DeviceColumn)."""
    if isinstance(want, agt.DeviceListColumn):
        n = want.length
        same = (got.length == n and torch.equal(
            got.offsets[:n + 1], want.offsets[:n + 1]) and torch.equal(
            got.validity, want.validity) and torch.equal(
            _bits(got.child.values[:got.child.length]),
            _bits(want.child.values[:want.child.length])))
    elif isinstance(want, DeviceColumn):
        same = got.length == want.length and torch.equal(
            _bits(got.values[:got.length]), _bits(want.values[:want.length]))
    elif isinstance(want, HostArray):
        same = all(np.array_equal(g.values, w.values) for g, w in zip(
            got.children, want.children))
    else:
        same = got == want
    if not same:
        raise AssertionError(f"{what}: a repeated run differs from the "
                             f"first")


def nested_phases(li, orders, dev, card: str,
                  timing_only: bool = False) -> dict:
    """This slice's paths on the SF10 arrays already in memory: a
    list<double> of each order's l_price on the card (DeviceListColumn),
    `nested_take` (list_take_device by 15 M seeded indices, 5% null,
    with repeats: K2's hi-only fills), `nested_filter` (the list filter
    by o_odate < 720: K1 then the take), `value_counts` of l_okey and of
    o_odate, `column_filter` (F13: l_price by Q6's predicate, K1) and
    `narrow_aggregates` (F8 / F9: l_qty as int8 and as uint32 + 2**31,
    K3), each exact against numpy after one counted run, then 3 timed
    runs (`nested` line: ms and peak bytes a path), a `nested_profile`
    of the take, and every K1, K2 and K3 call of one more run of each
    path held against the plain version (`nested_path_checks`; not with
    `timing_only`). Returns each path's launch counts and the largest
    kernel - plain difference."""
    t_phase = time.perf_counter()
    n_li, n_ord = len(li["l_okey"]), len(orders["o_okey"])
    okey = torch.from_numpy(li["l_okey"]).to(dev)
    price = torch.from_numpy(li["l_price"]).to(dev)
    t0 = time.perf_counter()
    col, sidx = order_price_lists(okey, price, n_ord)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    t_oracle = time.perf_counter()
    off, child = check_list_build(col, sidx, li)
    del sidx, okey, price

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    P_out = agt.pad_length(n_ord)
    idx = torch.full((P_out,), -1, dtype=torch.int64, device=dev)
    idx[:n_ord] = torch.randint(0, n_ord, (n_ord,), generator=g, device=dev)
    null = torch.rand(n_ord, generator=g, device=dev) < NESTED_TAKE_NULL
    idx[:n_ord] = torch.where(null, -1, idx[:n_ord])
    idx_np = idx[:n_ord].cpu().numpy()
    ords = agt.batch_to_device({"o_odate": orders["o_odate"]}, device=dev)
    keep = pc.call_function("less", [ords.column("o_odate"),
                                     NESTED_ODATE_MAX])
    li_db = agt.batch_to_device({c: li[c] for c in Q6_COLUMNS}, device=dev)
    q6_mask = pc.execute_scalar_expression(q6_expression(), li_db)
    price_col = li_db.column("l_price")
    del li_db
    q6_keep = q6_rows(li)
    qty = torch.from_numpy(li["l_qty"]).to(dev)
    P_li = agt.pad_length(n_li)
    qty8 = torch.zeros(P_li, dtype=torch.int8, device=dev)
    qty8[:n_li] = qty.to(torch.int8)
    qty_u32 = torch.zeros(P_li, dtype=torch.int32, device=dev)
    qty_u32[:n_li] = qty + torch.iinfo(torch.int32).min  # + 2**31, bits
    del qty
    q8 = DeviceColumn(qty8, None, n_li, dt.int8)
    qu = DeviceColumn(qty_u32, None, n_li, dt.uint32)
    okey_col = agt.batch_to_device({"l_okey": li["l_okey"]},
                                   device=dev).column(0)
    odate_col = ords.column("o_odate")

    def narrow_aggs():
        return {"int8": [pc.agg_sum(q8), pc.agg_mean(q8), pc.agg_min(q8),
                         pc.agg_max(q8)],
                "uint32": [pc.agg_sum(qu), pc.agg_mean(qu), pc.agg_min(qu),
                           pc.agg_max(qu)]}

    q = li["l_qty"].astype(np.int64)
    aggs_want = {"int8": [int(q.sum()), float(q.sum()) / n_li, int(q.min()),
                          int(q.max())],
                 "uint32": [int(q.sum()) + n_li * 2 ** 31,
                            float(int(q.sum()) + n_li * 2 ** 31) / n_li,
                            int(q.min()) + 2 ** 31, int(q.max()) + 2 ** 31]}
    take_want = list_take_oracle(off, child, idx_np)
    filt_want = list_take_oracle(off, child, np.flatnonzero(
        orders["o_odate"] < NESTED_ODATE_MAX))
    price_want = li["l_price"][q6_keep]
    del child

    def check_filter(out):
        _equal("column_filter", _host(out).view(np.int64),
               price_want.view(np.int64))

    def check_aggs(got):
        if got != aggs_want:
            raise AssertionError(f"narrow_aggregates {got}, numpy "
                                 f"{aggs_want}")

    distinct = {}

    def check_vc(what, v, n_keys, base=0):
        def check(out):
            distinct[what] = check_value_counts(what, out, v, n_keys, base)
        return check

    paths = {
        "nested take": (lambda: agt.list_take_device(col, idx, n_ord),
                        lambda out: check_list_take("nested_take", out,
                                                    take_want), ("K2",)),
        "nested filter": (lambda: pc.filter_(col, keep),
                          lambda out: check_list_take("nested_filter", out,
                                                      filt_want),
                          ("K1", "K2")),
        "value_counts l_okey": (lambda: pc.value_counts(okey_col),
                                check_vc("value_counts l_okey",
                                         li["l_okey"], n_ord), ("K2",)),
        "value_counts o_odate": (lambda: pc.value_counts(odate_col),
                                 check_vc("value_counts o_odate",
                                          orders["o_odate"], 64, 700),
                                 ("K2",)),
        "column filter": (lambda: pc.filter_(price_col, q6_mask),
                          check_filter, ("K1",)),
        "narrow aggregates": (narrow_aggs, check_aggs, ("K3",)),
    }
    launches, runs, peaks, held, firsts = {}, {}, {}, {}, {}
    host_s = time.perf_counter() - t_oracle
    for name, (fn, check, needs) in paths.items():
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, launches[name] = run_path(name, fn, needs)
        peaks[name] = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        check(out)
        host_s += time.perf_counter() - t0
        firsts[name] = out
        outs, runs[name] = timed(fn)
        for out in outs:
            same_result(name, out, firsts[name])
        del outs
    take_rows = int(take_want[0][-1])
    print(json.dumps({"nested": {
        "orders": n_ord, "lineitem_rows": n_li, "list_build_ms": build_ms,
        "setup_and_oracles_s": host_s,
        "take_rows": n_ord, "take_child_rows": take_rows,
        "filter_rows": len(filt_want[2]),
        "filter_child_rows": int(filt_want[0][-1]),
        "distinct": distinct, "column_filter_rows": len(price_want),
        "ms_runs": runs,
        "ms_median": {k: float(np.median(v)) for k, v in runs.items()},
        "peak_bytes": peaks, "launches_per_run": launches,
        "card": card, "verified": True}}), flush=True)
    print(json.dumps({"nested_profile": profile_device(
        lambda: agt.list_take_device(col, idx, n_ord),
        lambda out: same_result("nested take", out, firsts["nested take"]))}),
        flush=True)
    errs = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    if not timing_only:
        for name, (fn, check, _) in paths.items():
            out, held[name] = check_path_calls(
                name, fn, launches[name], k3=name == "narrow aggregates")
            same_result(name, out, firsts[name])
            del out
        print(json.dumps({"nested_path_checks": held}), flush=True)
        for k in errs:
            errs[k] = max((h[k]["max_abs_err"] for h in held.values()
                           if k in h), default=0.0)
    print(json.dumps({"nested_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


# ---------------------------------------------------------------------------
# the compute front, run-end encoding and the utilities
# ---------------------------------------------------------------------------

FRONT_TENSOR_ROWS = 1 << 20        # rows of the tensor check
K1_KERNELS = ("count_kernel", "scatter_kernel")    # csrc/compaction.cu
K3_KERNELS = ("reduce_kernel",)                    # csrc/reduce.cu


def q6_operators():
    """Q6's WHERE clause and revenue built with the operator methods:
    (predicate, revenue)."""
    f = pc.field
    pred = ((f("l_sdate") >= Q6_DATE_LO) & (f("l_sdate") < Q6_DATE_HI)
            & (f("l_disc") >= Q6_DISC_LO) & (f("l_disc") <= Q6_DISC_HI)
            & (f("l_qty") < Q6_QTY))
    return pred, f("l_price") * f("l_disc")


class sync_errors:
    """torch.cuda's sync debug mode "error" over a region: any operation
    that waits for the device from the host raises."""

    def __enter__(self):
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        return False


def compile_q6(schema):
    """Q6 through compile_expression: the predicate over `schema`, the
    revenue over the filtered (l_price, l_disc). Returns run(li_db) ->
    (the Q6 dict, the mask); both expressions run under sync_errors."""
    pred, rev = q6_operators()
    pred_fn = pc.compile_expression(pred, schema)
    kept = ["l_price", "l_disc"]
    rev_fn = pc.compile_expression(rev, dt.Schema(
        [schema.field(schema.field_index(n)) for n in kept]))

    def run(li_db: DeviceBatch):
        with sync_errors():
            mask = pred_fn(li_db)
        li_f = pc.filter(project(li_db, kept), mask)
        with sync_errors():
            r = rev_fn(li_f)
        return {"revenue": pc.sum(r),
                "count": pc.count(r, pc.CountOptions("all"))}, mask
    return run


def graph_costs(li_db: DeviceBatch, mask) -> dict:
    """What a CUDA graph of Q6's compiled predicate would save and cost:
    the predicate captured once over static copies of its columns and
    replayed, beside its eager evaluation and the copy of the columns
    into the static buffers that each call of a graph needs (CUDA events,
    mean of 5). The replay's mask must equal `mask`."""
    pred = pc.compile_expression(q6_operators()[0], li_db.schema)
    static = [DeviceColumn(c.values.clone(), None, c.length, c.type)
              for c in li_db.columns]
    sdb = DeviceBatch(li_db.schema, static, li_db.length)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pred(sdb)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pred(sdb)
    graph.replay()
    _equal("graph replay of the Q6 predicate", _host(out), _host(mask))
    q6_cols = [li_db.column(n) for n in Q6_COLUMNS]
    q6_static = [sdb.column(n) for n in Q6_COLUMNS]

    def copy_in():
        for dst, src in zip(q6_static, q6_cols):
            dst.values.copy_(src.values)
    return {"graph_replay_ms": _time_ms(graph.replay, 5),
            "eager_predicate_ms": _time_ms(lambda: pred(li_db), 5),
            "input_copy_ms": _time_ms(copy_in, 5),
            "input_bytes": sum(c.values.numel() * c.values.element_size()
                               for c in q6_cols)}


def run_end_oracle(v: np.ndarray):
    """(sorted v, run ends int32, run values) by numpy."""
    s = np.sort(v)
    vals, counts = np.unique(s, return_counts=True)
    return s, np.cumsum(counts).astype(np.int32), vals


def check_runs(what: str, ree, want) -> None:
    s, ends, vals = want
    _equal(f"{what} run ends", ree.run_ends.values, ends)
    _equal(f"{what} run values", ree.values.values, vals)
    if ree.values.mask is not None:
        raise AssertionError(f"{what}: a null run without nulls")
    _equal(f"{what} decode", pc.run_end_decode(ree).values, s)


def encode_sorted(col: DeviceColumn, times: dict = None):
    """pc.sort of a column, then run_end_encode of it; with `times`, ms
    of the sort, of the run detection (K1 compacts the starts; one count
    read back) and of the host copy of starts and values, each ending in
    a device synchronize."""
    from arrow_go_tpu_torch.compute import run_ends as ree
    if times is None:
        return pc.run_end_encode(pc.sort(col))
    srt, times["sort_ms"] = _sync_ms(lambda: pc.sort(col))
    (starts, vals, ok), times["detect_ms"] = _sync_ms(
        lambda: ree.device_runs(srt))
    host, times["host_copy_ms"] = _sync_ms(
        lambda: (starts.cpu().numpy(), vals.cpu().numpy(),
                 ok.cpu().numpy()))
    del host
    return pc.run_end_encode(srt)


def kernel_events(trace_path: str) -> dict:
    """CUDA kernel events of a Chrome trace, counted by the name of each
    K1 and K3 kernel (the demangled name without its "void ", template
    arguments and parameters: torch's own reductions are
    at::native::reduce_kernel)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = [re.sub(r"^void ", "", e.get("name", "")).split("<")[0].split(
        "(")[0] for e in events if e.get("cat") == "kernel"]
    return {k: names.count(k) for k in K1_KERNELS + K3_KERNELS}


def front_phases(li, orders, dev, card: str) -> dict:
    """This slice's paths over the SF10 arrays already in memory:
    `compiled_q6` (Q6 built with the operator methods, through
    compile_expression, then filter (K1) and pc.sum / pc.count (K3);
    exact against numpy, its mask bit for bit the eager q6_expression's,
    its two expressions under sync debug "error"), `run_ends` (pc.sort of
    l_okey and of o_odate, then run_end_encode, whose run starts K1
    compacts; exact against numpy, and run_end_decode gives the sorted
    column back), `memwatch` (DeviceMemoryWatcher around a warm Q3 and a
    compiled Q6), `metrics` (the registry's Q6 under metrics.enable(),
    and the trace's K1 / K3 kernel events of a compiled Q6 beside the
    launch counters), `tensor` and `front_path_checks` (every K1 and K3
    call of one more run of each path against the plain version).
    Returns each path's launch counts and the largest kernel - plain
    difference."""
    from arrow_go_tpu_torch.tensor import tensor
    from arrow_go_tpu_torch.utils import (DeviceMemoryWatcher,
                                          device_live_bytes, trace)
    t_phase = time.perf_counter()
    n_li = len(li["l_okey"])
    cols = ["l_okey", "l_price", "l_disc", "l_sdate", "l_qty"]
    li_db = agt.batch_to_device({c: li[c] for c in cols}, device=dev)
    ord_db = agt.batch_to_device(orders, device=dev)
    launches, held, runs = {}, {}, {}

    # compiled Q6 against numpy and the eager mask
    q6_want = q6_oracle(li)
    compiled = compile_q6(li_db.schema)
    (got, mask), launches["compiled Q6"] = run_path(
        "compiled Q6", lambda: compiled(li_db), ("K1", "K3"))
    check_q6(got, q6_want)
    eager = pc.execute_scalar_expression(q6_expression(), li_db)
    _equal("compiled Q6 mask", _host(mask), _host(eager))
    _equal("compiled Q6 mask validity",
           mask.validity_mask()[:n_li].cpu().numpy(),
           eager.validity_mask()[:n_li].cpu().numpy())
    graph = graph_costs(li_db, mask)
    del mask, eager
    outs, runs["compiled"] = timed(lambda: compiled(li_db)[0])
    for out in outs:
        check_q6(out, q6_want)
    outs, runs["eager"] = timed(lambda: compute_q6(li_db))
    for out in outs:
        check_q6(out, q6_want)
    print(json.dumps({"compiled_q6": {
        **got, "oracle": q6_want, "rows": n_li,
        "ms_runs": runs["compiled"],
        "ms_median": float(np.median(runs["compiled"])),
        "eager_ms_runs": runs["eager"],
        "eager_ms_median": float(np.median(runs["eager"])),
        "no_host_sync": True, "mask_equals_eager": True, "graph": graph,
        "launches_per_run": launches["compiled Q6"], "card": card,
        "verified": True}}), flush=True)

    # run-end encoding of the sorted keys
    okey, odate = li_db.column("l_okey"), ord_db.column("o_odate")
    t0 = time.perf_counter()
    want = {"l_okey": run_end_oracle(li["l_okey"]),
            "o_odate": run_end_oracle(orders["o_odate"])}
    oracle_s = time.perf_counter() - t0
    ree_info = {}
    for name, col in (("l_okey", okey), ("o_odate", odate)):
        path = f"run_end_encode {name}"
        ree, launches[path] = run_path(path, lambda col=col: encode_sorted(
            col), ("K1",))
        check_runs(path, ree, want[name])
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = {}
        ree = encode_sorted(col, times)
        peak = torch.cuda.max_memory_allocated() - base
        check_runs(path, ree, want[name])
        t0 = time.perf_counter()
        pc.run_end_decode(ree)
        times["decode_ms"] = (time.perf_counter() - t0) * 1e3
        ree_info[name] = {"rows": col.length, "runs": len(ree.values),
                          **times, "peak_bytes": peak,
                          "launches_per_run": launches[path]}
    if ree_info["l_okey"]["runs"] != len(want["l_okey"][2]):
        raise AssertionError("l_okey runs differ from numpy")
    print(json.dumps({"run_ends": {**ree_info, "oracle_s": oracle_s,
                                   "card": card, "verified": True}}),
          flush=True)

    # the leak check: a warm Q3 and a compiled Q6
    oracle = q3_oracle(li, orders, CUTOFF)
    check_q3(compute_q3(li_db, ord_db, CUTOFF), oracle)      # warm-up
    check_q6(compiled(li_db)[0], q6_want)
    live = device_live_bytes()
    if live is None:
        raise AssertionError("device_live_bytes gave None on the card")
    with DeviceMemoryWatcher(tolerance=1 << 20) as w:
        check_q3(compute_q3(li_db, ord_db, CUTOFF), oracle)
        check_q6(compiled(li_db)[0], q6_want)
    print(json.dumps({"memwatch": {
        "start_bytes": w.start, "end_bytes": w.end, "growth_bytes": w.growth,
        "tolerance_bytes": 1 << 20, "warmed_up": True, "card": card,
        "verified": True}}), flush=True)

    # the metrics registry and the profiler trace
    disc_host = HostArray(li["l_disc"], None, dt.float64)
    metrics.reset()
    metrics.enable()
    try:
        got, _ = registry_q6(li_db, disc_host)
    finally:
        metrics.disable()
    check_q6(got, q6_want)
    snap = {k: {"calls": s.calls, "rows": s.rows, "host_ms": s.total_s * 1e3}
            for k, s in metrics.snapshot().ops.items()}
    metrics.reset()
    with tempfile.TemporaryDirectory() as d:
        with trace("compiled_q6", log_dir=d, device=dev):
            check_q6(compiled(li_db)[0], q6_want)
        torch.cuda.synchronize()
        counted = kernel_launches()
        path = os.path.join(d, "compiled_q6.json")
        trace_bytes = os.path.getsize(path)
        events = kernel_events(path)
    print(json.dumps({"metrics": {
        "registry_q6": snap, "trace_bytes": trace_bytes,
        "trace_kernel_events": events,
        "counted_launches": {"K1": counted["K1"], "K3": counted["K3"]},
        "card": card, "verified": True}}), flush=True)

    # a tensor of two lineitem columns
    m = np.stack([li["l_price"][:FRONT_TENSOR_ROWS],
                  li["l_disc"][:FRONT_TENSOR_ROWS]], 1)
    on_card = tensor(m).to_device()
    _equal("tensor", on_card.cpu().numpy(), m)
    print(json.dumps({"tensor": {"shape": list(on_card.shape),
                                 "device": str(on_card.device),
                                 "card": card, "verified": True}}),
          flush=True)
    del on_card

    paths = {"compiled Q6": (lambda: compiled(li_db)[0],
                             lambda out: check_q6(out, q6_want), True),
             "run_end_encode l_okey": (
                 lambda: encode_sorted(okey),
                 lambda out: check_runs("l_okey", out, want["l_okey"]),
                 False),
             "run_end_encode o_odate": (
                 lambda: encode_sorted(odate),
                 lambda out: check_runs("o_odate", out, want["o_odate"]),
                 False)}
    for name, (fn, check, k3) in paths.items():
        out, held[name] = check_path_calls(name, fn, launches[name], k3=k3)
        check(out)
    print(json.dumps({"front_path_checks": held}), flush=True)
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K3")}
    print(json.dumps({"front_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


TYPES_TAKE_NULL = 0.05            # share of null take indices
# the host take's indices: a quarter of the orders (all of them before
# the arrays phase; a cut that keeps the script in its time limit)
TYPES_TAKE_SHARE = 4


def _months(odate: np.ndarray) -> np.ndarray:
    return (odate // 30).astype(np.int32)


def typed_orders(orders) -> tuple:
    """(HostBatch, numpy oracle columns) of the orders with one column of
    each new type the block format carries: o_okey; a null column;
    months from o_odate as month_interval (null where o_okey % 11 ==
    0); o_opri as large_string and as binary_view bytes (through the
    registry's casts); o_odate even as bool8 (null where o_okey % 13 ==
    0)."""
    from arrow_go_tpu_torch import extensions
    from arrow_go_tpu_torch.device.block import ExtensionArray, null_array
    okey, odate = orders["o_okey"], orders["o_odate"]
    n = len(okey)
    pcodes, pvalues = orders["o_opri"]
    opri = HostArray(pcodes, None, dt.string, pvalues)
    m_ok, b_ok = okey % 11 != 0, okey % 13 != 0
    cols = {
        "o_okey": HostArray(okey, None, dt.int64),
        "o_null": null_array(n),
        "o_months": HostArray(_months(odate), m_ok, dt.month_interval),
        "o_opri_large": pc.call_function("cast_large_string", [opri]),
        "o_opri_bytes": pc.call_function("cast_binary_view", [opri]),
        "o_even": ExtensionArray(extensions.bool8, HostArray(
            (odate % 2 == 0).astype(np.int8), b_ok, dt.int8)),
    }
    want = {"o_okey": (okey, None), "o_months": (_months(odate), m_ok),
            "o_opri_large": ((pcodes, list(pvalues)), None),
            "o_opri_bytes": ((pcodes, [v.encode() for v in pvalues]),
                             None),
            "o_even": ((odate % 2 == 0).astype(np.int8), b_ok)}
    return HostBatch.from_arrays(cols), want


def check_typed_filter(out: HostBatch, want: dict, keep: np.ndarray):
    """Every column of the filtered batch exactly as numpy selects it:
    values (a code column's codes, its dictionary unchanged) under
    validity, validity, row count; the null column a length with no
    valid row; each type kept."""
    n = int(keep.sum())
    if out.num_rows != n:
        raise AssertionError(f"typed_filter: {out.num_rows} rows, numpy {n}")
    null = out.column("o_null")
    if null.type != dt.null or len(null) != n or null.validity_bools().any():
        raise AssertionError("typed_filter: the null column")
    for name, (vals, ok) in want.items():
        col = out.column(name)
        ok = np.ones(len(keep), np.bool_) if ok is None else ok
        _equal(f"typed_filter {name} validity", col.validity_bools(),
               ok[keep])
        if col.dict_values is not None:       # codes into the dictionary
            codes, values = vals
            if list(col.dict_values) != list(values):
                raise AssertionError(f"typed_filter {name}: dictionary")
            got, vals = col.values, codes
        else:
            got = (col.storage if name == "o_even" else col).values
        sel = ok[keep]
        _equal(f"typed_filter {name}", got[sel], vals[keep][sel])
    types = {f.name: str(getattr(c.type, "value_type", c.type))
             for f, c in zip(out.schema.fields, out.columns)}
    if types["o_months"] != "month_interval" or types["o_opri_large"] != \
            "large_utf8" or types["o_opri_bytes"] != "binary_view" or \
            types["o_even"] != "extension<arrow.bool8, storage=int8>":
        raise AssertionError(f"typed_filter types: {types}")


def host_typed_orders(orders, li, dev) -> tuple:
    """(HostBatch, numpy parts) of the orders with the columns that stay
    on the host: day_time_interval (o_odate days, o_okey * 37 % 1 day in
    ms) and month_day_nano_interval (o_odate // 30 months, o_odate % 30
    days, o_okey us in ns); a dense union<int64 o_okey, utf8 o_opri>
    and a sparse union of the same children, o_okey's parity choosing;
    a list_view<double> of each order's l_price (the nested phase's
    offsets and its stably sorted child, built on the card) with its
    sizes; a uuid (16 bytes, o_okey big-endian then 0x40 .. 0x4f)."""
    from arrow_go_tpu_torch import extensions
    from arrow_go_tpu_torch.device.block import (ExtensionArray,
                                                 ListViewArray, UnionArray)
    okey, odate = orders["o_okey"], orders["o_odate"]
    n = len(okey)
    pcodes, pvalues = orders["o_opri"]
    day_time = np.zeros(n, dt.day_time_interval.np_dtype)
    day_time["days"] = odate
    day_time["milliseconds"] = okey * 37 % DAY_MS
    mdn = np.zeros(n, dt.month_day_nano_interval.np_dtype)
    mdn["months"], mdn["days"] = _months(odate), odate % 30
    mdn["nanoseconds"] = okey * 1000
    odd = (okey % 2).astype(np.int8)
    fields = [dt.Field("k", dt.int64), dt.Field("p", dt.string)]
    opri = HostArray(pcodes, None, dt.string, pvalues)
    kids = [HostArray(okey, None, dt.int64), opri]
    rank = np.zeros(n, np.int32)
    for k in (0, 1):
        rank[odd == k] = np.arange(int((odd == k).sum()), dtype=np.int32)
    dense = UnionArray(dt.dense_union(fields), odd, [
        HostArray(okey[odd == 0], None, dt.int64),
        HostArray(pcodes[odd == 1], None, opri.type, pvalues)], rank)
    sparse = UnionArray(dt.sparse_union(fields), odd, kids)
    col, sidx = order_price_lists(torch.from_numpy(li["l_okey"]).to(dev),
                                  torch.from_numpy(li["l_price"]).to(dev), n)
    off = col.offsets[:n + 1].cpu().numpy().astype(np.int64)
    child = col.child.values[:col.child.length].cpu().numpy()
    del col, sidx
    sizes = np.diff(off)
    lview = ListViewArray(dt.list_view(dt.float64), None, off[:-1], sizes,
                          HostArray(child, None, dt.float64))
    raw = np.zeros((n, 16), np.uint8)
    raw[:, :8] = okey.astype(">u8").view(np.uint8).reshape(n, 8)
    raw[:, 8:] = np.arange(0x40, 0x48, dtype=np.uint8)
    raw[:, 15] |= 0x40
    uuids = raw.view("S16").reshape(n).astype(object)
    uuid = ExtensionArray(extensions.uuid, HostArray(
        np.arange(n, dtype=np.int32), None, dt.fixed_size_binary(16),
        uuids))
    hb = HostBatch.from_arrays({"o_day_time": HostArray(
        day_time, None, dt.day_time_interval), "o_mdn": HostArray(
        mdn, None, dt.month_day_nano_interval), "o_dense": dense,
        "o_sparse": sparse, "o_prices": lview, "o_uuid": uuid})
    parts = {"okey": okey, "pcodes": pcodes, "odd": odd, "rank": rank,
             "day_time": day_time, "mdn": mdn, "off": off, "sizes": sizes,
             "child": child, "uuids": uuids}
    return hb, parts


def check_host_types(what: str, cols: dict, parts: dict,
                     idx: np.ndarray) -> None:
    """Each host column's rows idx (-1 = a null row) exactly as numpy
    gives them: values under validity, validity, a dense union's codes
    and offsets (a null row on one null row appended to child 0, under
    code 0), a sparse union's children, a list view's sizes, running-sum
    offsets and child, a uuid's codes into its unchanged dictionary."""
    neg = idx < 0
    safe = np.where(neg, 0, idx)
    ok = ~neg
    for name, key in (("o_day_time", "day_time"), ("o_mdn", "mdn")):
        c = cols[name]
        _equal(f"{what} {name} validity", c.validity_bools(), ok)
        if not np.array_equal(c.values[ok], parts[key][safe][ok]):
            raise AssertionError(f"{what} {name}: values differ")
    odd, rank = parts["odd"][safe], parts["rank"][safe]
    d = cols["o_dense"]
    n0 = int((parts["odd"] == 0).sum())
    _equal(f"{what} o_dense codes", d.type_ids, np.where(neg, 0, odd).astype(
        np.int8))
    _equal(f"{what} o_dense offsets", d.value_offsets,
           np.where(neg, n0, rank).astype(np.int32))
    if len(d.children[0]) != n0 + int(neg.any()):
        raise AssertionError(f"{what} o_dense: child 0 has "
                             f"{len(d.children[0])} rows")
    _equal(f"{what} o_dense validity", d.validity_bools(), ok)
    s = cols["o_sparse"]
    _equal(f"{what} o_sparse codes", s.type_ids, odd.astype(np.int8))
    _equal(f"{what} o_sparse validity", s.validity_bools(), ok)
    for k, want in ((0, parts["okey"]), (1, parts["pcodes"])):
        ch = s.children[k]
        _equal(f"{what} o_sparse child {k} validity", ch.validity_bools(),
               ok)
        _equal(f"{what} o_sparse child {k}", ch.values[ok], want[safe][ok])
    lv = cols["o_prices"]
    sizes = np.where(neg, 0, parts["sizes"][safe])
    off = np.zeros(len(idx), np.int64)
    np.cumsum(sizes[:-1], out=off[1:])
    _equal(f"{what} o_prices sizes", lv.sizes, sizes)
    _equal(f"{what} o_prices offsets", lv.offsets, off)
    _equal(f"{what} o_prices validity", lv.validity_bools(), ok)
    starts = np.repeat(parts["off"][:-1][safe] - off, sizes)
    pos = starts + np.arange(int(sizes.sum()), dtype=np.int64)
    _equal(f"{what} o_prices child", lv.children[0].values,
           parts["child"][pos])
    u = cols["o_uuid"]
    if u.storage.dict_values is not parts["uuids"]:
        raise AssertionError(f"{what} o_uuid: the dictionary was copied")
    _equal(f"{what} o_uuid validity", u.validity_bools(), ok)
    _equal(f"{what} o_uuid codes", u.storage.values[ok],
           safe[ok].astype(np.int32))


def host_types_runs(hb: HostBatch, parts: dict, keep: np.ndarray,
                    idx: np.ndarray) -> dict:
    """The host route of the batch by the predicate (filter) and by the
    take indices: the whole batch once through pc.filter / pc.take,
    checked; then each column's take_host_vec alone under tracemalloc
    (numpy's allocations only: a few hooks a call), its ms and its peak
    host bytes."""
    import tracemalloc
    from arrow_go_tpu_torch.compute.nested_selection import take_host_vec
    keep_arr = HostArray(keep, None, dt.bool_)
    take_arr = HostArray(np.where(idx < 0, 0, idx), idx >= 0, dt.int64)
    out = {}
    for what, run, rows in (
            ("filter", lambda: pc.filter(hb, keep_arr),
             np.flatnonzero(keep)),
            ("take", lambda: pc.take(hb, take_arr), idx)):
        t0 = time.perf_counter()
        got = run()
        batch_ms = (time.perf_counter() - t0) * 1e3
        check_host_types(what, {f.name: c for f, c in zip(
            got.schema.fields, got.columns)}, parts, rows)
        del got
        per = {}
        for f, c in zip(hb.schema.fields, hb.columns):
            tracemalloc.start()
            t0 = time.perf_counter()
            take_host_vec(c, rows)
            ms = (time.perf_counter() - t0) * 1e3
            peak = tracemalloc.get_traced_memory()[1]
            tracemalloc.stop()
            per[f.name] = {"ms": ms, "peak_host_bytes": peak}
        out[what] = {"rows": len(rows), "batch_ms": batch_ms,
                     "columns": per}
    return out


def types_phases(li, orders, dev, card: str) -> dict:
    """This slice's paths over the SF10 arrays already in memory:
    `q12_views` (l_smode cast to string_view and o_opri to large_string
    by the registry's casts, each timed; TPC-H Q12 over them with its
    key typed string_view, exact against numpy and equal to the string
    Q12 of this call, both timed), `typed_filter` (an orders HostBatch
    with a null column, a month_interval, o_opri as large_string and as
    binary_view and a bool8, filtered as a DeviceBatch by o_odate < 720:
    K1; exact against numpy), `host_types_filter` (the same orders with
    day_time / month_day_nano intervals, a dense and a sparse union, a
    list_view<double> of each order's l_price and a uuid, through the
    host route by the same predicate and by a quarter of the orders'
    count of seeded take indices (3.75 M at SF10), 5% null; exact
    against numpy, ms and peak host bytes a column) and
    `types_path_checks` (every K1 and K2 call of one more run of Q12
    views and typed_filter against the plain version). Returns each
    path's launch counts and the largest kernel - plain difference."""
    t_phase = time.perf_counter()
    launches, held, runs = {}, {}, {}
    mcodes, modes = li["l_smode"]
    pcodes, pvalues = orders["o_opri"]
    smode = HostArray(mcodes, None, dt.string, modes)
    opri = HostArray(pcodes, None, dt.string, pvalues)
    # (the registry is built at its first call: warm it on one row)
    pc.call_function("cast_string_view", [smode.slice(0, 1)])
    t0 = time.perf_counter()
    smode_v = pc.call_function("cast_string_view", [smode])
    cast_sv_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    opri_l = pc.call_function("cast_large_string", [opri])
    cast_ls_ms = (time.perf_counter() - t0) * 1e3
    if smode_v.values is not mcodes or opri_l.values is not pcodes or \
            list(smode_v.dict_values) != list(modes):
        raise AssertionError("q12_views: a cast copied the codes")
    li_cols = {c: li[c] for c in ("l_okey", "l_sdate", "l_cdate",
                                  "l_rdate")}
    li_s = agt.batch_to_device({**li_cols, "l_smode": smode}, device=dev)
    li_v = agt.batch_to_device({**li_cols, "l_smode": smode_v}, device=dev)
    ord_cols = {c: orders[c] for c in ("o_okey", "o_odate")}
    ord_s = agt.batch_to_device({**ord_cols, "o_opri": opri}, device=dev)
    ord_v = agt.batch_to_device({**ord_cols, "o_opri": opri_l}, device=dev)
    want = q12_oracle(li, orders)

    def q12_views():
        return compute_q12(li_v, ord_v, key_type=dt.string_view)
    out, launches["Q12 views"] = run_path("Q12 views", q12_views,
                                          ("K1", "K2"))
    check_rows("q12_views", out, want)
    key_t = out.column("l_smode").type
    key_t = getattr(key_t, "value_type", key_t)
    if str(key_t) != "string_view" or str(li_v.schema.field(4).type) != \
            "string_view" or str(ord_v.schema.field(2).type) != "large_utf8":
        raise AssertionError(f"q12_views: key typed {out.schema}")
    outs, runs["views"] = timed(q12_views)
    for o in outs:
        check_rows("q12_views", o, want)
    outs, runs["strings"] = timed(lambda: compute_q12(li_s, ord_s))
    for o in outs:
        check_rows("q12 strings", o, want)
    if outs[-1].to_pydict() != out.to_pydict():
        raise AssertionError("q12_views differs from the string Q12")
    views_ms = float(np.median(runs["views"]))
    strings_ms = float(np.median(runs["strings"]))
    print(json.dumps({"q12_views": {
        "result": out.to_pydict(), "key_type": str(key_t),
        "cast_string_view_ms": cast_sv_ms, "cast_large_string_ms": cast_ls_ms,
        "cast_rows": {"l_smode": len(mcodes), "o_opri": len(pcodes)},
        "ms_runs": runs["views"], "ms_median": views_ms,
        "strings_ms_runs": runs["strings"], "strings_ms_median": strings_ms,
        "views_over_strings": views_ms / strings_ms,
        "launches_per_run": launches["Q12 views"], "card": card,
        "verified": True}}), flush=True)
    del li_s, ord_s

    # the typed orders batch through the DeviceBatch filter (K1)
    keep = orders["o_odate"] < NESTED_ODATE_MAX
    hb, typed_want = typed_orders(orders)
    from arrow_go_tpu_torch.device.block import (device_batch_to_host,
                                                 host_batch_to_device)
    t0 = time.perf_counter()
    db = host_batch_to_device(hb, dev)
    torch.cuda.synchronize()
    to_device_ms = (time.perf_counter() - t0) * 1e3
    if not all(isinstance(c, DeviceColumn) for c in db.columns):
        raise AssertionError("typed_filter: a column stayed on the host")
    ords = agt.batch_to_device({"o_odate": orders["o_odate"]}, device=dev)
    mask = pc.call_function("less", [ords.column("o_odate"),
                                     NESTED_ODATE_MAX])

    def typed_filter():
        return pc.filter(db, mask)
    got, launches["typed_filter"] = run_path("typed_filter", typed_filter,
                                             ("K1",))
    check_typed_filter(device_batch_to_host(got), typed_want, keep)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    outs, runs["typed_filter"] = timed(typed_filter)
    peak = torch.cuda.max_memory_allocated() - base
    for o in outs:
        check_typed_filter(device_batch_to_host(o), typed_want, keep)
    del outs, got
    print(json.dumps({"typed_filter": {
        "rows": len(keep), "kept": int(keep.sum()),
        "columns": {f.name: str(getattr(c.type, "value_type", c.type))
                    for f, c in zip(db.schema.fields, db.columns)},
        "to_device_ms": to_device_ms, "ms_runs": runs["typed_filter"],
        "ms_median": float(np.median(runs["typed_filter"])),
        "peak_bytes": peak, "launches_per_run": launches["typed_filter"],
        "card": card, "verified": True}}), flush=True)

    # the host-resident types through take_host_vec
    t0 = time.perf_counter()
    hhb, parts = host_typed_orders(orders, li, dev)
    build_s = time.perf_counter() - t0
    n_ord = len(keep)
    g = np.random.default_rng(13)
    n_take = n_ord // TYPES_TAKE_SHARE
    idx = g.integers(0, n_ord, n_take)
    idx[g.random(n_take) < TYPES_TAKE_NULL] = -1
    host = host_types_runs(hhb, parts, keep, idx)
    print(json.dumps({"host_types_filter": {
        **host, "build_s": build_s, "child_rows": len(parts["child"]),
        "columns": {f.name: str(f.type) for f in hhb.schema.fields},
        "card": card, "verified": True}}), flush=True)
    del hhb, parts

    paths = {"Q12 views": (q12_views,
                           lambda o: check_rows("q12_views", o, want)),
             "typed_filter": (typed_filter, lambda o: check_typed_filter(
                 device_batch_to_host(o), typed_want, keep))}
    for name, (fn, check) in paths.items():
        o, held[name] = check_path_calls(name, fn, launches[name])
        check(o)
    print(json.dumps({"types_path_checks": held}), flush=True)
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K2")}
    print(json.dumps({"types_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}



# ---------------------------------------------------------------------------
# the variant type and Arrow IPC: Q6 from IPC bytes, an IPC stream with a
# dictionary delta, a dataset of .arrow fragments, and a shredded variant
# ---------------------------------------------------------------------------

IPC_BATCH_ROWS = 1 << 20          # rows of a record batch (58 at SF10)
IPC_CODECS = (None, "lz4", "zstd")
# the compressed bodies' record batches (of 58 at SF10), cuts that keep
# the script in its time limit: zstd's first (its write, the port's
# encoder on one thread a buffer), lz4's since the interop phase
IPC_COMPRESSED_BATCHES = 8
IPC_THREADS = os.cpu_count() or 8  # (de)compression threads
IPC_Q6_COLUMNS = ["l_price", "l_disc", "l_qty", "l_sdate"]
IPC_STREAM_BATCHES = 15
VARIANT_ROWS = 1 << 14            # rows of the variant column (a cut)
VARIANT_ODATE_MAX = 720           # the shredded o_odate's filter
IPC_TYPES = {"l_price": dt.float64, "l_disc": dt.float64, "l_qty": dt.int32,
             "l_sdate": dt.int32, "l_okey": dt.int64}


def write_ipc(sink, table: dict, names, compression=None, rows=None,
              start: int = 0, stop=None):
    """Rows [start, stop) of the named numpy columns as an Arrow IPC
    file (the port's new_file), in record batches of `rows` (default
    IPC_BATCH_ROWS), bodies compressed on IPC_THREADS threads. Returns
    the batches written."""
    from arrow_go_tpu_torch import ipc
    types = IPC_TYPES
    rows = rows or IPC_BATCH_ROWS
    schema = dt.Schema([dt.Field(c, types[c], False) for c in names])
    stop = len(table[names[0]]) if stop is None else stop
    n = 0
    with ipc.new_file(sink, schema, compression,
                      compression_concurrency=IPC_THREADS) as w:
        for a in range(start, stop, rows):
            b = min(a + rows, stop)
            w.write(HostBatch(schema, [HostArray(table[c][a:b], None,
                                                 types[c]) for c in names],
                              b - a))
            n += 1
    return n


def _same_bits(what: str, got: np.ndarray, want: np.ndarray) -> None:
    if got.dtype != want.dtype or not np.array_equal(
            got.view(np.uint8), np.ascontiguousarray(want).view(np.uint8)):
        raise AssertionError(f"{what}: the IPC read differs bit for bit")


def ipc_q6(blob, dev, times=None, source=None) -> dict:
    """TPC-H Q6 over an IPC file's record batches: each read on the host
    (open_file, bodies decompressed on IPC_THREADS threads), sent to the
    card (host_batch_to_device) and filtered (K1), its SUM on K3, added
    across batches. `times` gathers the read (`read_s`, of which
    `decompress_s`), the copy (`h2d_s`) and the compute (`compute_s`);
    with `source` each batch's columns are held bit for bit against the
    numpy columns, outside the timed spans."""
    from arrow_go_tpu_torch import ipc
    from arrow_go_tpu_torch.device.block import host_batch_to_device
    r = ipc.open_file(blob, decompress_concurrency=IPC_THREADS)
    revenue, count, row = 0.0, 0, 0
    spans = {"read_s": 0.0, "h2d_s": 0.0, "compute_s": 0.0}
    for i in range(r.num_record_batches):
        t0 = time.perf_counter()
        hb = r.get_batch(i)
        t1 = time.perf_counter()
        db = host_batch_to_device(hb, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rev = q6_revenue(db)
        if rev.length:
            revenue += pc.agg_sum(rev)
        count += rev.length
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(spans, (t1 - t0, t2 - t1, t3 - t2)):
            spans[k] += v
        if source is not None:
            for f, c in zip(hb.schema.fields, hb.columns):
                _same_bits(f"ipc_q6 {f.name} batch {i}", c.values,
                           source[f.name][row:row + hb.num_rows])
        row += hb.num_rows
    if times is not None:
        times.update(spans, decompress_s=r.decompress_s,
                     batches=r.num_record_batches, rows=row)
    return {"revenue": revenue, "count": count}


def ipc_dataset_q6(ds, dev, times=None) -> dict:
    """TPC-H Q6 over a dataset of .arrow fragments: the scanner's device
    batches (one a file), filtered and summed as dataset_q6."""
    sc = ds.scanner(columns=Q6_COLUMNS, filter=q6_expression(), device=dev)
    return q6_over_batches(sc.device_batches(times=times))


def lineitem_cuts(sdate: np.ndarray) -> list:
    """Row bounds of LI_DATASET_FILES files of equal l_sdate ranges over
    a lineitem sorted by l_sdate."""
    edges = np.linspace(int(sdate[0]), int(sdate[-1]) + 1,
                        LI_DATASET_FILES + 1)
    return np.searchsorted(sdate, edges).tolist()


def write_ipc_dataset(root: str, lis: dict, compression: str = "lz4"
                      ) -> list:
    """The sorted lineitem's Q6 columns and l_okey as LI_DATASET_FILES
    .arrow files under `root` (the parquet dataset's l_sdate ranges and
    record batches of its row-group size), one thread a file. Returns
    the paths."""
    from concurrent.futures import ThreadPoolExecutor
    cuts = lineitem_cuts(lis["l_sdate"])
    names = Q6_COLUMNS + ["l_okey"]
    paths = [os.path.join(root, f"part-{i}.arrow")
             for i in range(LI_DATASET_FILES)]

    def one(i):
        with open(paths[i], "wb") as f:
            write_ipc(f, lis, names, compression, DATASET_ROWS_PER_GROUP,
                      cuts[i], cuts[i + 1])
    os.makedirs(root, exist_ok=True)
    with ThreadPoolExecutor(max_workers=LI_DATASET_FILES) as pool:
        for f in [pool.submit(one, i) for i in range(LI_DATASET_FILES)]:
            f.result()
    return paths


def stream_orders(orders) -> tuple:
    """The orders' o_opri (a dictionary field, its dictionary grown by
    one delta) and o_custkey through new_stream / open_stream in
    IPC_STREAM_BATCHES batches: the first half of the batches carry a
    dictionary of the priorities their rows use, the rest all five.
    Returns (the stream's bytes, the read HostBatch, ms of write, read)."""
    from arrow_go_tpu_torch import ipc
    codes, values = orders["o_opri"]
    ck = orders["o_custkey"]
    n = len(ck)
    # first batches: only priorities 0-2, then the other two appended
    early = codes < 3
    order = np.concatenate([np.flatnonzero(early), np.flatnonzero(~early)])
    codes, ck = codes[order], ck[order]
    t = dt.dictionary(dt.int32, dt.string)
    schema = dt.Schema([dt.Field("o_opri", t), dt.Field("o_custkey",
                                                        dt.int64, False)])
    cuts = np.linspace(0, n, IPC_STREAM_BATCHES + 1).astype(int)
    sink = io.BytesIO()
    t0 = time.perf_counter()
    with ipc.new_stream(sink, schema, emit_dictionary_deltas=True) as w:
        for a, b in zip(cuts[:-1], cuts[1:]):
            d = values[:3] if codes[a:b].max() < 3 else values
            w.write(HostBatch(schema, [HostArray(codes[a:b], None, t, d),
                                       HostArray(ck[a:b], None, dt.int64)],
                              b - a))
    write_ms = (time.perf_counter() - t0) * 1e3
    blob = sink.getbuffer()
    t0 = time.perf_counter()
    got = one_batch(ipc.open_stream(blob).read_all())
    read_ms = (time.perf_counter() - t0) * 1e3
    opri = got.column("o_opri")
    if list(opri.dict_values) != list(values) or not np.array_equal(
            opri.values, codes) or not np.array_equal(
            got.column("o_custkey").values, ck):
        raise AssertionError("ipc_stream: the orders differ after the "
                             "stream")
    return blob, got, write_ms, read_ms


def variant_orders(orders, n: int):
    """A parquet.variant column of the first n orders, each row the
    object {o_okey, o_odate, o_opri} (the variant Builder, row by row)."""
    from arrow_go_tpu_torch import extensions as ext
    from arrow_go_tpu_torch.device.block import ExtensionArray, from_pylist
    from arrow_go_tpu_torch.parquet import variant as pv
    codes, values = orders["o_opri"]
    objs = [{"o_okey": k, "o_odate": d, "o_opri": values[c]}
            for k, d, c in zip(orders["o_okey"][:n].tolist(),
                               orders["o_odate"][:n].tolist(),
                               codes[:n].tolist())]
    rows = []
    for o in objs:
        meta, val = pv.encode(o)
        rows.append({"metadata": meta, "value": val})
    return objs, ExtensionArray(ext.variant, from_pylist(
        rows, ext.variant.storage_type))


def variant_to_card(sh, dev) -> DeviceBatch:
    """The shredded o_okey and o_odate typed_values as a DeviceBatch."""
    from arrow_go_tpu_torch.device.block import host_batch_to_device
    typed = sh.storage.children[2]
    cols = {name: typed.children[typed.type.field_index(name)].children[1]
            for name in ("o_okey", "o_odate")}
    return host_batch_to_device(HostBatch.from_arrays(cols), dev)


def variant_filter(db: DeviceBatch):
    """The shredded typed_values on the card filtered by o_odate <
    VARIANT_ODATE_MAX (K1)."""
    mask = pc.call_function("less", [db.column("o_odate"),
                                     VARIANT_ODATE_MAX])
    return pc.filter(db, mask)


def check_variant_filter(out, orders, n: int) -> None:
    keep = orders["o_odate"][:n] < VARIANT_ODATE_MAX
    for name in ("o_okey", "o_odate"):
        got = out.column(name).values[:out.length].cpu().numpy()
        if out.column(name).validity is not None or not np.array_equal(
                got, orders[name][:n][keep]):
            raise AssertionError(f"variant filter: {name} differs from the "
                                 f"plain column's filter")


def variant_phase(orders, dev, card: str) -> tuple:
    """The variant line: VARIANT_ROWS orders as variant objects, shredded
    (typed_value int64 / int32 / string), round-tripped through the
    port's parquet writer and reader and through an IPC stream, each
    equal to the shredded column, unshredded and held row by row against
    the source objects; the shredded o_okey and o_odate sent to the card
    and filtered there by o_odate (K1) against the plain column's
    filter. Returns (the filter's path function, its check, its
    launches)."""
    from arrow_go_tpu_torch import extensions as ext, ipc
    from arrow_go_tpu_torch.device.block import ExtensionArray
    from arrow_go_tpu_torch.parquet import variant as pv
    n = min(VARIANT_ROWS, len(orders["o_okey"]))
    ms = {}
    t0 = time.perf_counter()
    objs, col = variant_orders(orders, n)
    ms["build"] = (time.perf_counter() - t0) * 1e3
    shred_t = dt.struct([dt.Field("o_okey", dt.int64),
                         dt.Field("o_odate", dt.int32),
                         dt.Field("o_opri", dt.string)])
    t0 = time.perf_counter()
    sh = ext.shred_variant(col, shred_t)
    ms["shred"] = (time.perf_counter() - t0) * 1e3
    want = sh.to_pylist()
    t0 = time.perf_counter()
    sink = io.BytesIO()
    tpq.write_table({"v": sh}, sink, compression="none",
                    write_page_index=False)
    ms["parquet_write"] = (time.perf_counter() - t0) * 1e3
    pq_bytes = len(sink.getvalue())
    t0 = time.perf_counter()
    pf = tpq.ParquetFile(sink.getvalue())
    from_pq = tpq.read_batch_device(pf, 0, columns=["v"], device=dev
                                    ).column("v").array
    ms["parquet_read"] = (time.perf_counter() - t0) * 1e3
    if pf.schema.field(0).type != sh.type or from_pq.to_pylist() != want:
        raise AssertionError("variant: the parquet round trip differs")
    t0 = time.perf_counter()
    sink = io.BytesIO()
    schema = dt.Schema([dt.Field("v", sh.type)])
    with ipc.new_stream(sink, schema) as w:
        w.write(HostBatch(schema, [sh], n))
    back = one_batch(ipc.open_stream(sink.getvalue()).read_all()).column(
        "v")
    ms["ipc_round_trip"] = (time.perf_counter() - t0) * 1e3
    if back.type != sh.type or back.to_pylist() != want:
        raise AssertionError("variant: the IPC round trip differs")
    back = ExtensionArray(ext.VariantType(back.type.storage_type),
                          back.storage)
    t0 = time.perf_counter()
    un = ext.unshred_variant(back)
    ms["unshred"] = (time.perf_counter() - t0) * 1e3
    for i, row in enumerate(un.to_pylist()):
        if pv.decode(row["metadata"], row["value"]) != objs[i]:
            raise AssertionError(f"variant: row {i} differs after the "
                                 f"round trips")
    typed = sh.storage.children[2]
    shredded = all(typed.children[j].children[0].validity_bools().sum()
                   == 0 for j in range(3))

    t0 = time.perf_counter()
    db = variant_to_card(sh, dev)
    torch.cuda.synchronize()
    ms["to_card"] = (time.perf_counter() - t0) * 1e3

    def fn():
        return variant_filter(db)

    def check(out):
        check_variant_filter(out, orders, n)
    out, launches = run_path("variant filter", fn, ("K1",))
    check(out)
    outs, runs = timed(fn)
    for o in outs:
        check(o)
    print(json.dumps({"variant": {
        "rows": n, "rows_cut_from": len(orders["o_okey"]),
        "shred_type": str(shred_t), "fully_shredded": bool(shredded),
        "parquet_bytes": pq_bytes, "ms": ms,
        "filter_ms_runs": runs, "filter_ms_median": float(np.median(runs)),
        "kept": int((orders["o_odate"][:n] < VARIANT_ODATE_MAX).sum()),
        "launches_per_run": launches, "card": card, "verified": True}}),
        flush=True)
    return fn, check, launches


def ipc_phases(li, orders, dev, card: str, dataset_q6_result=None) -> dict:
    """This slice's paths over the SF10 arrays already in memory:
    `ipc_q6` (the Q6 columns written by new_file in record batches of
    IPC_BATCH_ROWS, uncompressed, lz4 frame and zstd (its first
    IPC_COMPRESSED_BATCHES batches, as the lz4 one), each read back by
    open_file and run through Q6 on the card, exact against numpy with
    the read split and the bytes; the uncompressed read's device idle
    share; every column bit for bit), `ipc_stream` (o_opri as a
    dictionary field with one delta, and o_custkey, through new_stream
    and open_stream), `ipc_dataset_q6` (the lineitem sorted by l_sdate
    as LI_DATASET_FILES lz4 .arrow fragments in a temporary directory,
    Q6 through the dataset scanner, its count equal to ipc_q6's and the
    parquet dataset_q6's of this run and its revenue at rtol 1e-9),
    `variant` (variant_phase) and
    `ipc_path_checks` (every K1 and K3 call of one more run of the
    uncompressed ipc_q6, ipc_dataset_q6 and the variant filter against
    the plain version). Returns each path's launch counts and the
    largest kernel - plain difference."""
    import tempfile
    from arrow_go_tpu_torch.dataset import dataset
    t_phase = time.perf_counter()
    launches, held = {}, {}
    want = q6_oracle(li)
    n_li = len(li["l_okey"])
    lines = {}
    for codec in IPC_CODECS:
        key = codec or "none"
        rows = n_li if codec is None else min(
            n_li, IPC_COMPRESSED_BATCHES * IPC_BATCH_ROWS)
        cwant = want if rows == n_li else q6_oracle(_rows(li, 0, rows))
        sink = io.BytesIO()
        t0 = time.perf_counter()
        batches = write_ipc(sink, li, IPC_Q6_COLUMNS, codec, stop=rows)
        write_ms = (time.perf_counter() - t0) * 1e3
        blob = sink.getbuffer()
        if codec is None:
            plain = blob                  # kept for the profile and checks
        name = f"IPC Q6 {key}"
        got, launches[name] = run_path(
            name, lambda: ipc_q6(blob, dev), ("K1", "K3"))
        check_q6(got, cwant)
        split = {}
        again = ipc_q6(blob, dev, split, source=li)
        check_q6(again, cwant)
        if again != got:
            raise AssertionError(f"{name}: two reads differ")
        read_ms = sum(split[k] for k in ("read_s", "h2d_s",
                                         "compute_s")) * 1e3
        lines[key] = {
            **got, "batches": batches, "rows": rows, "rows_cut_from": n_li,
            "bytes": len(blob), "body_bytes": rows * 24, "write_ms": write_ms,
            "read_ms": read_ms, "split_ms": {
                "parse": (split["read_s"] - split["decompress_s"]) * 1e3,
                "decompress": split["decompress_s"] * 1e3,
                "to_card": split["h2d_s"] * 1e3,
                "compute": split["compute_s"] * 1e3},
            "launches_per_run": launches[name], "verified_bits": True}
        del sink, blob
    prof = profile_device(lambda: ipc_q6(plain, dev),
                          lambda out: check_q6(out, want), top=6)
    lines["none"]["profile"] = prof
    print(json.dumps({"ipc_q6": {**lines, "oracle": want, "threads":
                                 IPC_THREADS, "card": card,
                                 "verified": True}}), flush=True)

    blob, got, write_ms, read_ms = stream_orders(orders)
    print(json.dumps({"ipc_stream": {
        "rows": got.num_rows, "batches": IPC_STREAM_BATCHES,
        "bytes": len(blob), "write_ms": write_ms, "read_ms": read_ms,
        "dictionary": list(got.column("o_opri").dict_values), "card": card,
        "verified": True}}), flush=True)
    launches["IPC stream"] = {k: 0 for k in KERNELS}
    del blob, got

    order = np.argsort(li["l_sdate"], kind="stable")
    lis = {c: li[c][order] for c in Q6_COLUMNS + ["l_okey"]}
    del order
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = write_ipc_dataset(root, lis)
        ds_write_s = time.perf_counter() - t0
        del lis
        ds = dataset(root)
        got, launches["IPC dataset Q6"] = run_path(
            "IPC dataset Q6", lambda: ipc_dataset_q6(ds, dev), ("K1", "K3"))
        check_q6(got, want)
        if got["count"] != lines["none"]["count"] or not np.isclose(
                got["revenue"], lines["none"]["revenue"], rtol=1e-9,
                atol=0):
            raise AssertionError("ipc_dataset_q6 differs from ipc_q6")
        if dataset_q6_result is not None and (
                got["count"] != dataset_q6_result["count"]
                or not np.isclose(got["revenue"],
                                  dataset_q6_result["revenue"], rtol=1e-9,
                                  atol=0)):
            raise AssertionError(f"ipc_dataset_q6 {got} differs from the "
                                 f"parquet dataset_q6 {dataset_q6_result}")
        split = {}
        t0 = time.perf_counter()
        check_q6(ipc_dataset_q6(ds, dev, split), want)
        runs = [(time.perf_counter() - t0) * 1e3]
        print(json.dumps({"ipc_dataset_q6": {
            **got, "files": len(paths), "bytes": sum(
                os.path.getsize(p) for p in paths), "write_s": ds_write_s,
            "compression": "lz4", "ms_runs": runs,
            "ms_median": float(np.median(runs)),
            "split_ms": {k[:-2] + "_ms": v * 1e3 for k, v in split.items()},
            "equals_parquet_dataset_q6": dataset_q6_result is not None,
            "launches_per_run": launches["IPC dataset Q6"], "card": card,
            "verified": True}}), flush=True)

        vfn, vcheck, launches["variant filter"] = variant_phase(
            orders, dev, card)
        paths = {"ipc_q6": (lambda: ipc_q6(plain, dev),
                            lambda o: check_q6(o, want), "IPC Q6 none"),
                 "ipc_dataset_q6": (lambda: ipc_dataset_q6(ds, dev),
                                    lambda o: check_q6(o, want),
                                    "IPC dataset Q6"),
                 "variant": (vfn, vcheck, "variant filter")}
        for key, (fn, check, name) in paths.items():
            out, held[key] = check_path_calls(key, fn, launches[name],
                                              k3=key != "variant")
            check(out)
    print(json.dumps({"ipc_path_checks": held}), flush=True)
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K3")}
    print(json.dumps({"ipc_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


# ---------------------------------------------------------------------------
# phase 18: the file formats (CSV, line-delimited JSON, Avro)
# ---------------------------------------------------------------------------

# lineitem rows of the CSV and Avro paths (a cut: a quarter of TPC-H
# SF1's lineitem since the encodings phase, half since the interop
# phase, SF1's before)
FORMATS_ROWS = LINEITEM_SF1 // 4
CSV_CHECK_ROWS = 1 << 16          # rows held against the port's write_csv
CSV_STREAM_ROWS = 1 << 19         # rows of the streamed read (a cut)
CSV_STREAM_CHUNK = 1 << 18
AVRO_BLOCK_ROWS = 1 << 16         # records an Avro block
AVRO_CODECS = ("null", "deflate", "snappy", "zstandard")
AVRO_SYNC = bytes(range(16))
AVRO_Q6_SCHEMA = {"type": "record", "name": "lineitem", "fields": [
    {"name": "l_price", "type": "double"},
    {"name": "l_disc", "type": ["null", "double"]},
    {"name": "l_qty", "type": "int"},
    {"name": "l_sdate", "type": {"type": "int", "logicalType": "date"}}]}
JSON_ROWS = 1 << 18               # orders of the JSON path (a cut)
JSON_ODATE_MAX = 720              # its filter keeps o_odate < 720
JSON_COLUMNS = ["o_okey", "o_custkey", "o_odate", "o_opri"]
FORMATS_THREADS = os.cpu_count() or 8


def _table_cells(keys: np.ndarray, text) -> tuple:
    """(uint8 matrix, lengths) of each row's cell: `text(k)` of its int
    key k, formatted once a distinct key (a loop over the keys present,
    not over the rows) and gathered by key."""
    lo = int(keys.min(initial=0))
    k = keys.astype(np.int64) - lo
    present = np.flatnonzero(np.bincount(k, minlength=1))
    cells = [text(int(v) + lo).encode() for v in present]
    width = max(map(len, cells), default=1)
    at = np.zeros(int(present[-1]) + 1 if len(present) else 1, np.int64)
    at[present] = np.arange(len(present))
    mat = np.zeros((len(cells), width), np.uint8)
    for i, c in enumerate(cells):
        mat[i, :len(c)] = np.frombuffer(c, np.uint8)
    lens = np.array([len(c) for c in cells], np.int64)
    return mat[at[k]], lens[at[k]]


def _rows_bytes(cells) -> bytes:
    """Segments (matrix, lengths) of every row laid end to end, row after
    row, as bytes."""
    full = np.concatenate([m for m, _ in cells], 1)
    keep = np.concatenate([np.arange(m.shape[1])[None, :] < np.asarray(
        lens)[:, None] for m, lens in cells], 1)
    return full[keep].tobytes()


def _const_cells(n: int, b: bytes) -> tuple:
    return (np.tile(np.frombuffer(b, np.uint8), (n, 1)),
            np.full(n, len(b), np.int64))


def _csv_cells(table: dict, name: str, a: int, b: int) -> tuple:
    """The csv cells of rows [a, b) of one lineitem column: a flag as its
    letter, l_sdate as an ISO date, l_qty as its digits, a float (a whole
    number of hundredths, as make_data's and add_q1_columns' are) as its
    repr, each distinct value formatted once (_table_cells)."""
    v = table[name]
    if isinstance(v, tuple):
        codes, values = v
        return _table_cells(codes[a:b], lambda c: values[c])
    v = v[a:b]
    if name == "l_sdate":
        return _table_cells(v, lambda d: str(np.datetime64(d, "D")))
    if v.dtype.kind == "f":
        cents = np.rint(v * 100).astype(np.int64)
        if not np.array_equal(cents / 100.0, v):
            raise AssertionError(f"{name}: a float that is not a whole "
                                 f"number of hundredths")
        return _table_cells(cents, lambda c: repr(c / 100.0))
    return _table_cells(v, str)


def csv_text(table: dict, names, a: int = 0, b=None) -> bytes:
    """Rows [a, b) of the named lineitem columns as csv text with a header
    line, built by array operations (byte matrices, no loop over rows):
    what the port's write_csv writes for the same rows with l_sdate as
    its ISO strings."""
    col = table[names[0]]
    b = len(col[0] if isinstance(col, tuple) else col) if b is None else b
    cells = []
    for i, name in enumerate(names):
        cells.append(_csv_cells(table, name, a, b))
        cells.append(_const_cells(b - a, b"\n" if i == len(names) - 1
                                  else b","))
    return (",".join(names) + "\n").encode() + _rows_bytes(cells)


def csv_writer_batch(table: dict, names, n: int) -> HostBatch:
    """The first n rows of the named lineitem columns as the HostBatch
    whose write_csv bytes csv_text gives: the flags as strings, l_sdate
    as its ISO strings (a string column), the rest as they are."""
    from arrow_go_tpu_torch.device.block import dictionary_values
    fields, cols = [], []
    for name in names:
        v = table[name]
        if isinstance(v, tuple):
            cols.append(HostArray(v[0][:n], None, dt.string,
                                  dictionary_values(v[1], dt.string)))
            fields.append(dt.Field(name, dt.string))
        elif name == "l_sdate":
            iso = np.datetime_as_string(v[:n].astype("datetime64[D]"))
            uniq, inv = np.unique(iso, return_inverse=True)
            cols.append(HostArray(inv.astype(np.int32), None, dt.string,
                                  dictionary_values(uniq, dt.string)))
            fields.append(dt.Field(name, dt.string))
        else:
            t = dt.from_numpy_dtype(v.dtype)
            cols.append(HostArray(v[:n], None, t))
            fields.append(dt.Field(name, t))
    return HostBatch(dt.Schema(fields), cols, n)


def check_csv_writer(table: dict, names, text: bytes, n: int) -> int:
    """The port's write_csv of the first n rows equals the first n rows
    of `text` byte for byte. Returns the bytes compared."""
    from arrow_go_tpu_torch.formats import write_csv
    sink = io.StringIO()
    write_csv(csv_writer_batch(table, names, n), sink)
    want = sink.getvalue().encode()
    if text[:len(want)] != want or text[len(want) - 1:len(want)] != b"\n":
        raise AssertionError("csv text differs from the port's write_csv")
    return len(want)


def _same_column(what: str, got: HostArray, want, t: dt.DataType) -> None:
    """A read column equals its numpy source: its type, no nulls, values
    bit for bit; a flag, given as (codes, values), by its letters."""
    if got.type.id == dt.TypeId.DICTIONARY:
        got = got.decode()
    gt = got.type
    if got.mask is not None or gt.id != t.id:
        raise AssertionError(f"{what}: read as {gt} with "
                             f"{0 if got.mask is None else (~got.mask).sum()}"
                             f" nulls, not {t}")
    if isinstance(want, tuple):
        codes, values = want
        where = {v: i for i, v in enumerate(values)}
        remap = np.array([where[v] for v in got.dict_values], np.int32)
        if not np.array_equal(remap[got.values], codes):
            raise AssertionError(f"{what}: letters differ from the source")
        return
    want = np.asarray(want)
    if got.values.dtype.itemsize != want.dtype.itemsize or not \
            np.array_equal(got.values.view(np.uint8),
                           np.ascontiguousarray(want).view(np.uint8)):
        raise AssertionError(f"{what}: values differ from the source")


CSV_TYPES = {"l_rflag": dt.string, "l_lstatus": dt.string,
             "l_qty": dt.int64, "l_price": dt.float64, "l_disc": dt.float64,
             "l_tax": dt.float64, "l_sdate": dt.date32}


def check_read(what: str, hb: HostBatch, table: dict, names, a: int,
               b: int, types) -> None:
    """Every column of a read HostBatch against rows [a, b) of its numpy
    source (l_qty widened to the type the reader gives it)."""
    if hb.schema.names != list(names) or hb.num_rows != b - a:
        raise AssertionError(f"{what}: read {hb.schema.names}, "
                             f"{hb.num_rows} rows")
    for name in names:
        t = types[name]
        v = table[name]
        want = (v[0][a:b], v[1]) if isinstance(v, tuple) else \
            v[a:b].astype(t.np_dtype if t.id != dt.TypeId.DATE32
                          else np.int32)
        ft = hb.schema.field(hb.schema.field_index(name)).type
        if ft != t:
            raise AssertionError(f"{what} {name}: typed {ft}, not {t}")
        _same_column(f"{what} {name}", hb.column(name), want, t)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def to_card(read, dev, times: dict):
    """Run `read` (-> HostBatch) and ship its result to `dev` (the card):
    (HostBatch, DeviceBatch), `times` gaining read_s and h2d_s."""
    from arrow_go_tpu_torch.device.block import host_batch_to_device
    t0 = time.perf_counter()
    hb = read()
    t1 = time.perf_counter()
    db = host_batch_to_device(hb, dev)
    _sync(dev)
    times["read_s"] = times.get("read_s", 0.0) + t1 - t0
    times["h2d_s"] = times.get("h2d_s", 0.0) + time.perf_counter() - t1
    return hb, db


def _compute(fn, dev, times: dict):
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    times["compute_s"] = times.get("compute_s", 0.0) + \
        time.perf_counter() - t0
    return out


def csv_q1(text: bytes, dev, times: dict):
    """TPC-H Q1 from csv text: read_csv (the numpy tier), the batch to
    the card, compute_q1. Returns (HostBatch, DeviceBatch, Q1's rows)."""
    from arrow_go_tpu_torch.formats import read_csv
    hb, db = to_card(lambda: read_csv(text), dev, times)
    return hb, db, _compute(lambda: compute_q1(db), dev, times)


def csv_q6(text: bytes, dev, times: dict):
    """TPC-H Q6 from the Q6 columns of csv text (include_columns)."""
    from arrow_go_tpu_torch.formats import csv
    hb, db = to_card(lambda: csv.read_csv(text, csv.ReadOptions(
        include_columns=Q6_COLUMNS)), dev, times)
    return hb, db, _compute(lambda: compute_q6(db), dev, times)


def csv_stream_q6(text: bytes, dev, times: dict) -> tuple:
    """Q6 batch by batch over open_csv(chunk_size=CSV_STREAM_CHUNK): each
    batch to the card, filtered (K1), summed (K3), added up; every batch
    in the first's schema. Returns (Q6, batches)."""
    from arrow_go_tpu_torch.device.block import host_batch_to_device
    from arrow_go_tpu_torch.formats import csv
    revenue, count, n, schema = 0.0, 0, 0, None
    t0 = time.perf_counter()
    with csv.open_csv(text, csv.ReadOptions(
            chunk_size=CSV_STREAM_CHUNK,
            include_columns=Q6_COLUMNS)) as r:
        for hb in r:
            if schema is None:
                schema = hb.schema
            elif hb.schema != schema:
                raise AssertionError("csv_stream: a batch left the pinned "
                                     "schema")
            q = compute_q6(host_batch_to_device(hb, dev))
            revenue += q["revenue"]
            count += q["count"]
            n += 1
    _sync(dev)
    times["s"] = time.perf_counter() - t0
    return {"revenue": revenue, "count": count}, n


def write_csv_dataset(root: str, lis: dict, names) -> list:
    """The sorted lineitem's named columns as LI_DATASET_FILES .csv files
    of equal l_sdate ranges under `root` (csv_text). Returns the paths."""
    cuts = lineitem_cuts(lis["l_sdate"])
    paths = []
    for i in range(LI_DATASET_FILES):
        paths.append(os.path.join(root, f"part-{i}.csv"))
        with open(paths[-1], "wb") as f:
            f.write(csv_text(lis, names, cuts[i], cuts[i + 1]))
    return paths


def _varint_cells(v: np.ndarray) -> tuple:
    """Avro's zigzag varints of int64 values as (uint8 matrix, lengths)."""
    zz = ((v.astype(np.int64) << 1) ^ (v.astype(np.int64) >> 63)).view(
        np.uint64)
    lens = np.ones(len(v), np.int64)
    for k in range(1, 10):
        lens += zz >= (np.uint64(1) << np.uint64(7 * k))
    width = int(lens.max(initial=1))
    k = np.arange(width)
    groups = ((zz[:, None] >> (np.uint64(7) * k.astype(np.uint64)))
              & np.uint64(0x7F)).astype(np.uint8)
    more = (k[None, :] < lens[:, None] - 1).astype(np.uint8) << 7
    return groups | more, lens


def _avro_long(v: int) -> bytes:
    m, n = _varint_cells(np.array([v], np.int64))
    return m[0, :n[0]].tobytes()


def avro_records(table: dict, a: int, b: int) -> tuple:
    """Rows [a, b) of l_price, l_disc, l_qty, l_sdate as Avro records of
    AVRO_Q6_SCHEMA (l_disc under union branch 1): (their bytes end to
    end, each record's end offset)."""
    n = b - a
    f8 = [(np.ascontiguousarray(table[c][a:b], "<f8").view(np.uint8)
           .reshape(n, 8), np.full(n, 8, np.int64))
          for c in ("l_price", "l_disc")]
    cells = [f8[0], _const_cells(n, b"\x02"), f8[1],
             _varint_cells(table["l_qty"][a:b]),
             _varint_cells(table["l_sdate"][a:b])]
    ends = np.cumsum(sum(lens for _, lens in cells))
    return _rows_bytes(cells), ends


def write_avro(records: bytes, ends: np.ndarray, codec: str) -> bytes:
    """An Avro object container file of AVRO_Q6_SCHEMA with `codec`,
    AVRO_BLOCK_ROWS records a block (`records` and their end offsets
    from avro_records): snappy blocks carry their CRC-32 suffix."""
    import zlib
    from arrow_go_tpu_torch import native
    meta = {b"avro.schema": json.dumps(AVRO_Q6_SCHEMA).encode(),
            b"avro.codec": codec.encode()}
    out = [b"Obj\x01", _avro_long(len(meta))]
    for k, v in meta.items():
        out += [_avro_long(len(k)), k, _avro_long(len(v)), v]
    out += [_avro_long(0), AVRO_SYNC]
    bounds = np.concatenate([[0], ends])
    for r in range(0, len(ends), AVRO_BLOCK_ROWS):
        s = min(r + AVRO_BLOCK_ROWS, len(ends))
        body = records[int(bounds[r]):int(bounds[s])]
        if codec == "deflate":
            z = zlib.compressobj(1, zlib.DEFLATED, -15)   # fast, raw
            body = z.compress(body) + z.flush()
        elif codec == "snappy":
            body = bytes(native.snappy_compress(body)) + \
                (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "big")
        elif codec == "zstandard":
            body = bytes(native.zstd_compress(body))
        out += [_avro_long(s - r), _avro_long(len(body)), body, AVRO_SYNC]
    return b"".join(out)


def avro_q6(blob: bytes, dev, times: dict):
    """TPC-H Q6 from an Avro file: OCFReader.read_all (the array tier),
    the batch to the card, compute_q6; `times` gains the reader's
    decompress_s and decode_s."""
    from arrow_go_tpu_torch.formats import OCFReader

    def read():
        r = OCFReader(blob)
        hb = r.read_all()
        times["decompress_s"] = r.decompress_s
        times["decode_s"] = r.decode_s
        return hb
    hb, db = to_card(read, dev, times)
    return hb, db, _compute(lambda: compute_q6(db), dev, times)


AVRO_TYPES = {"l_price": dt.float64, "l_disc": dt.float64,
              "l_qty": dt.int32, "l_sdate": dt.date32}


def orders_json_batch(orders, n: int) -> HostBatch:
    """The first n orders' o_okey, o_custkey, o_odate and o_opri (a
    string column) as a HostBatch."""
    from arrow_go_tpu_torch.device.block import dictionary_values
    codes, values = orders["o_opri"]
    cols = {"o_okey": HostArray(orders["o_okey"][:n], None, dt.int64),
            "o_custkey": HostArray(orders["o_custkey"][:n], None,
                                   dt.int64),
            "o_odate": HostArray(orders["o_odate"][:n], None, dt.int32),
            "o_opri": HostArray(codes[:n], None, dt.string,
                                dictionary_values(values, dt.string))}
    return HostBatch(dt.Schema([dt.Field(k, dt.string if k == "o_opri"
                                         else a.type)
                                for k, a in cols.items()]),
                     list(cols.values()), n)


def orders_json_text(orders, n: int) -> bytes:
    """The bytes the JAX package's write_json gives for the same rows:
    json.dumps of each row's object, one a line."""
    codes, values = orders["o_opri"]
    rows = zip(orders["o_okey"][:n].tolist(), orders["o_custkey"][:n].tolist(),
               orders["o_odate"][:n].tolist(), values[codes[:n]].tolist())
    return "".join(json.dumps(dict(zip(JSON_COLUMNS, r))) + "\n"
                   for r in rows).encode()


def json_filter(db: DeviceBatch) -> dict:
    """o_custkey of the orders with o_odate < JSON_ODATE_MAX, filtered on
    the card (K1) and summed (K3)."""
    mask = pc.call_function("less", [db.column("o_odate"), JSON_ODATE_MAX])
    kept = pc.filter(project(db, ["o_custkey"]), mask)
    return {"sum": pc.agg_sum(kept.column("o_custkey")) if kept.length
            else 0, "count": kept.length}


def json_orders(blob: bytes, dev, times: dict):
    """read_json of the orders' lines, the batch to the card, json_filter."""
    from arrow_go_tpu_torch.formats import read_json
    hb, db = to_card(lambda: read_json(blob), dev, times)
    return hb, db, _compute(lambda: json_filter(db), dev, times)


def _ms(times: dict) -> dict:
    return {k[:-2] + "_ms": v * 1e3 for k, v in times.items()}


def formats_phases(li, orders, dev, card: str,
                   timing_only: bool = False) -> dict:
    """This slice's paths over the first FORMATS_ROWS rows of the arrays
    already in memory (a quarter of TPC-H SF1's lineitem; a cut of
    depth):
    `csv_q1` (Q1's seven columns as csv text built by csv_text, its first
    CSV_CHECK_ROWS rows held byte for byte against the port's write_csv,
    read by read_csv on the numpy tier, every column held against its
    source, Q1 on the card against q1_oracle), `csv_q6` (the Q6 columns of
    the same text by include_columns, Q6 on the card, the device's idle
    share of read plus query), `csv_stream` (Q6 batch by batch over
    open_csv of the first CSV_STREAM_ROWS rows, the schema pinned),
    `csv_dataset_q6` (the Q6 rows sorted by l_sdate as LI_DATASET_FILES
    .csv files in a temporary directory, Q6 through the dataset
    scanner, equal to csv_q6), `avro_q6` (the Q6 columns in an Avro file
    of each codec, read by OCFReader.read_all, every column bit for
    bit, Q6 on the card), `json_orders` (JSON_ROWS orders through
    write_json, byte for byte, and read_json, filtered by o_odate on the
    card and o_custkey summed) and `formats_path_checks` (every K1 and K3
    call of those paths' device work against the plain version; not with
    `timing_only`). Returns each path's launch counts and the largest
    kernel - plain difference."""
    from arrow_go_tpu_torch.dataset import dataset
    t_phase = time.perf_counter()
    n = min(FORMATS_ROWS, len(li["l_okey"]))
    src = _rows(li, 0, n)
    launches, dbs, checks = {}, {}, {}

    # csv_q1
    t0 = time.perf_counter()
    text = csv_text(src, Q1_COLUMNS)
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    checked = check_csv_writer(src, Q1_COLUMNS, text, min(CSV_CHECK_ROWS, n))
    writer_ms = (time.perf_counter() - t0) * 1e3
    q1_want = q1_oracle(src)
    times = {}
    (hb, dbs["csv_q1"], out), launches["CSV Q1"] = run_path(
        "CSV Q1", lambda: csv_q1(text, dev, times), ("K1",))
    check_q1(out, q1_want)
    check_read("csv_q1", hb, src, Q1_COLUMNS, 0, n, CSV_TYPES)
    del hb
    checks["csv_q1"] = (lambda: compute_q1(dbs["csv_q1"]),
                        lambda o: check_q1(o, q1_want), "CSV Q1")
    print(json.dumps({"csv_q1": {
        "rows": n, "rows_cut_from": len(li["l_okey"]), "bytes": len(text),
        "text_build_ms": build_ms, "writer_rows_checked": min(
            CSV_CHECK_ROWS, n), "writer_bytes_checked": checked,
        "writer_ms": writer_ms, **_ms(times),
        "launches_per_run": launches["CSV Q1"], "card": card,
        "verified": True}}), flush=True)

    # csv_q6: the counted run under the profiler (read plus query)
    want = q6_oracle(src)
    times, got = {}, {}

    def q6_profiled():
        return profile_device(lambda: csv_q6(text, dev, times),
                              lambda o: got.update(out=o), top=6)
    prof, launches["CSV Q6"] = run_path("CSV Q6", q6_profiled, ("K1", "K3"))
    hb, dbs["csv_q6"], q6 = got["out"]
    check_q6(q6, want)
    check_read("csv_q6", hb, src, [c for c in Q1_COLUMNS
                                   if c in Q6_COLUMNS], 0, n, CSV_TYPES)
    del hb
    checks["csv_q6"] = (lambda: compute_q6(dbs["csv_q6"]),
                        lambda o: check_q6(o, want), "CSV Q6")
    print(json.dumps({"csv_q6": {
        **q6, "oracle": want, "rows": n, **_ms(times),
        "profile": prof, "launches_per_run": launches["CSV Q6"],
        "card": card, "verified": True}}), flush=True)

    # csv_stream: the csv-module tier over the first CSV_STREAM_ROWS rows
    m = min(CSV_STREAM_ROWS, n)
    cut = _line_end(text, m) if m < n else len(text)
    stream_want = q6_oracle(_rows(src, 0, m))
    times = {}
    (sq6, batches), launches["CSV stream Q6"] = run_path(
        "CSV stream Q6", lambda: csv_stream_q6(text[:cut], dev, times),
        ("K1", "K3"))
    check_q6(sq6, stream_want)
    print(json.dumps({"csv_stream": {
        **sq6, "rows": m, "rows_cut_from": n, "chunk": CSV_STREAM_CHUNK,
        "batches": batches, "ms": times["s"] * 1e3,
        "launches_per_run": launches["CSV stream Q6"], "card": card,
        "verified": True}}), flush=True)
    del text

    # csv_dataset_q6
    order = np.argsort(src["l_sdate"], kind="stable")
    lis = {c: src[c][order] for c in Q6_COLUMNS}
    del order
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = write_csv_dataset(root, lis, Q6_COLUMNS)
        write_s = time.perf_counter() - t0
        del lis
        t0 = time.perf_counter()
        ds = dataset(root)
        open_s = time.perf_counter() - t0
        times = {}

        def ds_q6():
            sc = ds.scanner(columns=Q6_COLUMNS, filter=q6_expression(),
                            device=dev)
            batches = list(sc.device_batches(times=times))
            return batches, _compute(lambda: q6_over_batches(batches),
                                     dev, times)
        (dbs["csv_dataset_q6"], dq6), launches["CSV dataset Q6"] = run_path(
            "CSV dataset Q6", ds_q6, ("K1", "K3"))
        check_q6(dq6, want)
        if dq6["count"] != q6["count"] or not np.isclose(
                dq6["revenue"], q6["revenue"], rtol=1e-9, atol=0):
            raise AssertionError(f"csv_dataset_q6 {dq6} differs from "
                                 f"csv_q6 {q6}")
        print(json.dumps({"csv_dataset_q6": {
            **dq6, "files": len(paths), "bytes": sum(
                os.path.getsize(p) for p in paths), "write_s": write_s,
            "dataset_open_s": open_s, **_ms(times),
            "equals_csv_q6": True,
            "launches_per_run": launches["CSV dataset Q6"], "card": card,
            "verified": True}}), flush=True)
    checks["csv_dataset_q6"] = (
        lambda: q6_over_batches(dbs["csv_dataset_q6"]),
        lambda o: check_q6(o, want), "CSV dataset Q6")

    # avro_q6: one file a codec
    t0 = time.perf_counter()
    records, ends = avro_records(src, 0, n)
    encode_ms = (time.perf_counter() - t0) * 1e3
    lines = {}
    for codec in AVRO_CODECS:
        t0 = time.perf_counter()
        blob = write_avro(records, ends, codec)
        write_ms = (time.perf_counter() - t0) * 1e3
        name = f"Avro Q6 {codec}"
        times = {}
        (hb, db, aq6), launches[name] = run_path(
            name, lambda: avro_q6(blob, dev, times), ("K1", "K3"))
        check_q6(aq6, want)
        check_read(name, hb, src, list(AVRO_TYPES), 0, n, AVRO_TYPES)
        if aq6 != q6 and not (aq6["count"] == q6["count"] and np.isclose(
                aq6["revenue"], q6["revenue"], rtol=1e-9, atol=0)):
            raise AssertionError(f"{name} {aq6} differs from csv_q6 {q6}")
        if codec == "null":
            dbs["avro_q6"] = db
        del hb, db
        lines[codec] = {**aq6, "bytes": len(blob), "write_ms": write_ms,
                        **_ms(times), "launches_per_run": launches[name],
                        "verified_bits": True}
        del blob
    del records, ends
    checks["avro_q6"] = (lambda: compute_q6(dbs["avro_q6"]),
                         lambda o: check_q6(o, want), "Avro Q6 null")
    print(json.dumps({"avro_q6": {
        **lines, "rows": n, "block_rows": AVRO_BLOCK_ROWS,
        "encode_ms": encode_ms, "oracle": want, "card": card,
        "verified": True}}), flush=True)

    # json_orders
    k = min(JSON_ROWS, len(orders["o_okey"]))
    from arrow_go_tpu_torch.formats import write_json
    t0 = time.perf_counter()
    sink = io.BytesIO()
    write_json(orders_json_batch(orders, k), sink)
    jw_ms = (time.perf_counter() - t0) * 1e3
    blob = sink.getvalue()
    if blob != orders_json_text(orders, k):
        raise AssertionError("json_orders: write_json's bytes differ from "
                             "json.dumps of the rows")
    keep = orders["o_odate"][:k] < JSON_ODATE_MAX
    jwant = {"sum": int(orders["o_custkey"][:k][keep].sum()),
             "count": int(keep.sum())}
    times = {}
    (hb, dbs["json_orders"], jgot), launches["JSON orders"] = run_path(
        "JSON orders", lambda: json_orders(blob, dev, times), ("K1", "K3"))
    for name, t in (("o_okey", dt.int64), ("o_custkey", dt.int64),
                    ("o_odate", dt.int64)):
        _same_column(f"json_orders {name}", hb.column(name),
                     orders[name][:k].astype(np.int64), t)
    _same_column("json_orders o_opri", hb.column("o_opri"),
                 (orders["o_opri"][0][:k], orders["o_opri"][1]), dt.string)
    del hb

    def check_json(o):
        if o != jwant:
            raise AssertionError(f"json_orders: {o}, numpy {jwant}")
    check_json(jgot)
    checks["json_orders"] = (lambda: json_filter(dbs["json_orders"]),
                             check_json, "JSON orders")
    print(json.dumps({"json_orders": {
        **jgot, "rows": k, "rows_cut_from": len(orders["o_okey"]),
        "bytes": len(blob), "write_ms": jw_ms, **_ms(times),
        "writer_equals_dumps": True,
        "launches_per_run": launches["JSON orders"], "card": card,
        "verified": True}}), flush=True)
    del blob

    held = {}
    if not timing_only:
        for key, (fn, check, name) in checks.items():
            out, held[key] = check_path_calls(key, fn, launches[name],
                                              k3=True)
            check(out)
        print(json.dumps({"formats_path_checks": held}), flush=True)
    dbs.clear()
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K3")}
    print(json.dumps({"formats_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


# ---------------------------------------------------------------------------
# phase 19: the interchange surface (Substrait, the C data interface, the
# integration JSON)
# ---------------------------------------------------------------------------

SUBSTRAIT_COLUMNS = ["l_price", "l_disc", "l_qty", "l_sdate", "l_tax"]
CDATA_BATCH_ROWS = IPC_BATCH_ROWS  # rows of a streamed batch (58 at SF10)
ARRJSON_ROWS = JSON_ROWS           # orders of the integration JSON (a cut)
ARROW_DEVICE_CUDA = 2              # kDLCUDA: refused by the import


def substrait_q6(be, db: DeviceBatch) -> dict:
    """TPC-H Q6 from decoded Substrait expressions: `pred` (its `and`s
    decoded as and_kleene) filters l_price and l_disc (K1), `revenue`
    multiplies them, and the SUM runs on K3."""
    mask = pc.execute_scalar_expression(be.expressions["pred"], db)
    li_f = pc.filter(project(db, ["l_price", "l_disc"]), mask)
    rev = pc.execute_scalar_expression(be.expressions["revenue"], li_f)
    return {"revenue": pc.agg_sum(rev),
            "count": pc.agg_count(rev, pc.CountOptions("all"))}


def q1_projections(db: DeviceBatch) -> tuple:
    """Q1's disc_price and charge as compute_q1 evaluates them (charge
    over disc_price as a column), over every row of `db`."""
    f, lit, call = pc.field, pc.literal, pc.call
    dp = pc.execute_scalar_expression(call("multiply", [
        f("l_price"), call("subtract", [lit(1.0), f("l_disc")])]), db)
    with_dp = DeviceBatch(dt.Schema(list(db.schema.fields)
                                    + [dt.Field("disc_price", dt.float64)]),
                          db.columns + [dp], db.length)
    return dp, pc.execute_scalar_expression(call("multiply", [
        f("disc_price"), call("add", [lit(1.0), f("l_tax")])]), with_dp)


def q1_substrait_expressions() -> dict:
    """The same two projections as one tree each, for Substrait."""
    f, lit, call = pc.field, pc.literal, pc.call
    dp = call("multiply", [f("l_price"), call("subtract", [lit(1.0),
                                                            f("l_disc")])])
    return {"disc_price": dp, "charge": call("multiply", [
        dp, call("add", [lit(1.0), f("l_tax")])])}


def q6_host_batches(li, rows: int = CDATA_BATCH_ROWS) -> list:
    """The Q6 columns as HostBatches of `rows` rows (views of the
    arrays), typed as IPC_TYPES."""
    schema = dt.Schema([dt.Field(c, IPC_TYPES[c], False)
                        for c in IPC_Q6_COLUMNS])
    n = len(li["l_okey"])
    return [HostBatch(schema, [HostArray(li[c][a:min(a + rows, n)], None,
                                         IPC_TYPES[c])
                               for c in IPC_Q6_COLUMNS], min(a + rows, n) - a)
            for a in range(0, n, rows)]


def cdata_q6(batches: list, dev, times=None, source=None) -> dict:
    """TPC-H Q6 over an ArrowArrayStream: `batches` exported by
    export_stream into a stream the port allocates, read by import_stream
    (each batch copied out of the exported buffers, its array released),
    sent to the card (host_batch_to_device), filtered (K1) and summed
    (K3), added across batches. `times` gathers the read (`read_s`: the
    producer's get_next and the copy), the copy to the card (`h2d_s`)
    and the compute (`compute_s`); with `source` each batch's columns
    are held bit for bit against the numpy columns, outside the spans."""
    from arrow_go_tpu_torch import cdata
    from arrow_go_tpu_torch.device.block import host_batch_to_device
    p = cdata.stream_handle()
    cdata.export_stream((batches[0].schema, batches), p)
    r = cdata.import_stream(p)
    revenue, count, row, n = 0.0, 0, 0, 0
    spans = {"read_s": 0.0, "h2d_s": 0.0, "compute_s": 0.0}
    while True:
        t0 = time.perf_counter()
        hb = r.read_next_batch()
        if hb is None:
            break
        t1 = time.perf_counter()
        db = host_batch_to_device(hb, dev)
        _sync(dev)
        t2 = time.perf_counter()
        rev = q6_revenue(db)
        if rev.length:
            revenue += pc.agg_sum(rev)
        count += rev.length
        _sync(dev)
        t3 = time.perf_counter()
        for k, v in zip(spans, (t1 - t0, t2 - t1, t3 - t2)):
            spans[k] += v
        if source is not None:
            for f, c in zip(hb.schema.fields, hb.columns):
                _same_bits(f"cdata_q6 {f.name} batch {n}", c.values,
                           source[f.name][row:row + hb.num_rows])
        row += hb.num_rows
        n += 1
    if times is not None:
        times.update(spans, batches=n, rows=row)
    return {"revenue": revenue, "count": count}


def cdata_export_s(batches: list) -> float:
    """Seconds of the producer's side alone: every batch exported
    through the stream's get_next and released unread."""
    import ctypes
    from arrow_go_tpu_torch import cdata
    p = cdata.stream_handle()
    cdata.export_stream((batches[0].schema, batches), p)
    c = cdata.ArrowArrayStream.from_address(p)
    a = cdata.ArrowArray()
    t0 = time.perf_counter()
    while True:
        if c.get_next(ctypes.pointer(c), ctypes.pointer(a)) != 0:
            raise AssertionError("cdata_q6: get_next failed")
        if not a.release:
            break
        a.release(ctypes.pointer(a))
    s = time.perf_counter() - t0
    c.release(ctypes.pointer(c))
    return s


def check_device_array(hb: HostBatch) -> dict:
    """One batch's l_price through export_device_array and
    import_device_array, bit for bit; the same export with device_type
    2 (CUDA) refused with ArrowInvalid, then released."""
    import ctypes
    from arrow_go_tpu_torch import cdata
    from arrow_go_tpu_torch.compute.errors import ArrowInvalid
    col = hb.column("l_price")
    d = cdata.device_array_handle()
    s, _ = cdata.schema_handles()
    t0 = time.perf_counter()
    cdata.export_device_array(col, d, s)
    back = cdata.import_device_array(d, s)
    ms = (time.perf_counter() - t0) * 1e3
    _same_bits("device array l_price", back.values, col.values)
    d = cdata.device_array_handle()
    cdata.export_device_array(col, d, s)
    dev_arr = cdata.ArrowDeviceArray.from_address(d)
    dev_arr.device_type = ARROW_DEVICE_CUDA
    try:
        cdata.import_device_array(d, s)
    except ArrowInvalid:
        pass
    else:
        raise AssertionError("a device_type of 2 was imported")
    dev_arr.array.release(ctypes.pointer(dev_arr.array))
    return {"rows": len(col), "ms": ms, "cuda_device_type_refused": True}


def arrjson_orders_batch(orders, n: int) -> HostBatch:
    """The first n orders' o_okey, o_custkey, o_odate, and o_opri as a
    dictionary field (int32 indices, its values in the file's
    dictionaries section)."""
    hb = orders_json_batch(orders, n)
    o_opri = dt.dictionary(dt.int32, dt.string)
    col = hb.column("o_opri")
    return HostBatch(dt.Schema([dt.Field(f.name, o_opri if f.name == "o_opri"
                                         else f.type)
                                for f in hb.schema.fields]),
                     [HostArray(col.values, None, o_opri, col.dict_values)
                      if c is col else c for c in hb.columns], n)


def arrjson_orders(text: str, dev, times: dict):
    """read_arrjson of the orders' text, the batch to the card,
    json_filter."""
    from arrow_go_tpu_torch.interop.arrjson import read_arrjson
    hb, db = to_card(lambda: read_arrjson(text)[0], dev, times)
    return hb, db, _compute(lambda: json_filter(db), dev, times)


def interop_phases(li, orders, dev, card: str,
                   timing_only: bool = False) -> dict:
    """This slice's paths: `substrait_q6` (Q6's predicate and revenue
    serialized as a Substrait ExtendedExpression over the SF10 lineitem's
    schema, decoded, and run over that lineitem on the card: its count
    and revenue equal the eager compute_q6 of the same call, bit for
    bit, and the oracle at rtol 1e-9; Q1's disc_price and charge through
    Substrait bit for bit against compute_q1's), `cdata_q6` (the Q6
    columns as HostBatches of CDATA_BATCH_ROWS rows through export_stream
    and import_stream, each batch to the card, Q6 per batch; one batch
    through the device array, a CUDA device_type refused),
    `arrjson_orders` (ARRJSON_ROWS orders, o_opri a dictionary field,
    through write_arrjson and read_arrjson, filtered on the card and
    summed) and `interop_path_checks` (every K1 and K3 call of those
    paths against the plain version; not with `timing_only`). Returns
    each path's launch counts and the largest kernel - plain
    difference."""
    from arrow_go_tpu_torch.interop.arrjson import write_arrjson
    t_phase = time.perf_counter()
    launches, checks = {}, {}
    n_li = len(li["l_okey"])
    want = q6_oracle(li)

    # substrait_q6, over the lineitem on the card
    db = agt.batch_to_device({c: li[c] for c in SUBSTRAIT_COLUMNS},
                             device=dev)
    exprs = {"pred": q6_expression(), "revenue": pc.call(
        "multiply", [pc.field("l_price"), pc.field("l_disc")])}
    t0 = time.perf_counter()
    blob = pc.serialize_expressions(exprs, schema=db.schema)
    ser_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    be = pc.deserialize_expressions(blob)
    de_ms = (time.perf_counter() - t0) * 1e3
    got, launches["Substrait Q6"] = run_path(
        "Substrait Q6", lambda: substrait_q6(be, db), ("K1", "K3"))
    check_q6(got, want)
    eager = compute_q6(db)
    if got != eager:
        raise AssertionError(f"substrait_q6 {got} is not the eager Q6 "
                             f"{eager} bit for bit")
    outs, runs = timed(lambda: substrait_q6(be, db))
    outs_e, runs_e = timed(lambda: compute_q6(db))
    for out in outs + outs_e:
        if out != eager:
            raise AssertionError(f"substrait_q6: a run gave {out}")
    q1_blob = pc.serialize_expressions(q1_substrait_expressions(),
                                       schema=db.schema)
    q1_be = pc.deserialize_expressions(q1_blob)
    dp, charge = q1_projections(db)
    for name, col in (("disc_price", dp), ("charge", charge)):
        via = pc.execute_scalar_expression(q1_be.expressions[name], db)
        _equal(f"substrait {name}", _host(via).view(np.int64),
               _host(col).view(np.int64))
    del dp, charge, via
    checks["substrait_q6"] = (lambda: substrait_q6(be, db),
                              lambda o: check_q6(o, want), "Substrait Q6")
    print(json.dumps({"substrait_q6": {
        **got, "oracle": want, "rows": n_li, "bytes": len(blob),
        "q1_bytes": len(q1_blob), "serialize_ms": ser_ms,
        "deserialize_ms": de_ms, "pred_function":
            be.expressions["pred"].function,
        "ms_runs": runs, "ms_median": float(np.median(runs)),
        "eager_ms_runs": runs_e, "eager_ms_median": float(np.median(runs_e)),
        "equals_eager_bits": True, "q1_projections_equal_bits": True,
        "launches_per_run": launches["Substrait Q6"], "card": card,
        "verified": True}}), flush=True)

    # cdata_q6: an ArrowArrayStream of the Q6 columns
    batches = q6_host_batches(li)
    got, launches["C stream Q6"] = run_path(
        "C stream Q6", lambda: cdata_q6(batches, dev), ("K1", "K3"))
    check_q6(got, want)
    split = {}
    again = cdata_q6(batches, dev, split, source=li)
    if again != got:
        raise AssertionError("cdata_q6: two reads differ")
    export_s = cdata_export_s(batches)
    prof = profile_device(lambda: cdata_q6(batches, dev),
                          lambda out: check_q6(out, want), top=6)
    device_array = check_device_array(batches[0])
    checks["cdata_q6"] = (lambda: cdata_q6(batches, dev),
                          lambda o: check_q6(o, want), "C stream Q6")
    print(json.dumps({"cdata_q6": {
        **got, "oracle": want, "batches": split["batches"],
        "rows": split["rows"], "body_bytes": split["rows"] * 24,
        "export_ms": export_s * 1e3,
        "import_copy_ms": (split["read_s"] - export_s) * 1e3,
        "read_ms": split["read_s"] * 1e3, "to_card_ms": split["h2d_s"] * 1e3,
        "compute_ms": split["compute_s"] * 1e3, "profile": prof,
        "device_array": device_array, "verified_bits": True,
        "launches_per_run": launches["C stream Q6"], "card": card,
        "verified": True}}), flush=True)

    # arrjson_orders
    k = min(ARRJSON_ROWS, len(orders["o_okey"]))
    hb_src = arrjson_orders_batch(orders, k)
    t0 = time.perf_counter()
    text = write_arrjson([hb_src])
    write_ms = (time.perf_counter() - t0) * 1e3
    keep = orders["o_odate"][:k] < JSON_ODATE_MAX
    jwant = {"sum": int(orders["o_custkey"][:k][keep].sum()),
             "count": int(keep.sum())}
    times = {}
    (hb, jdb, jgot), launches["arrjson orders"] = run_path(
        "arrjson orders", lambda: arrjson_orders(text, dev, times),
        ("K1", "K3"))
    for name, t in (("o_okey", dt.int64), ("o_custkey", dt.int64),
                    ("o_odate", dt.int32)):
        _same_column(f"arrjson_orders {name}", hb.column(name),
                     orders[name][:k], t)
    _same_column("arrjson_orders o_opri", hb.column("o_opri"),
                 (orders["o_opri"][0][:k], orders["o_opri"][1]), dt.string)
    if hb.schema.field(3).type != hb_src.schema.field(3).type:
        raise AssertionError("arrjson_orders: o_opri is not read back as "
                             "its dictionary field")
    del hb

    def check_arrjson(o):
        if o != jwant:
            raise AssertionError(f"arrjson_orders: {o}, numpy {jwant}")
    check_arrjson(jgot)
    checks["arrjson_orders"] = (lambda: json_filter(jdb), check_arrjson,
                                "arrjson orders")
    print(json.dumps({"arrjson_orders": {
        **jgot, "rows": k, "rows_cut_from": len(orders["o_okey"]),
        "bytes": len(text.encode()), "write_ms": write_ms, **_ms(times),
        "launches_per_run": launches["arrjson orders"], "card": card,
        "verified": True}}), flush=True)
    del text

    held = {}
    if not timing_only:
        for key, (fn, check, name) in checks.items():
            out, held[key] = check_path_calls(key, fn, launches[name],
                                              k3=True)
            check(out)
        print(json.dumps({"interop_path_checks": held}), flush=True)
    del db, jdb, batches
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K3")}
    print(json.dumps({"interop_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


ENC_ROWS = LINEITEM_SF1            # rows of enc_q6 (TPC-H SF1's lineitem)
ENC_CTR_ROWS = 1 << 20             # rows of enc_ctr_columns
ENC_KMS_ROWS = 1 << 16             # rows of enc_kms and of the cli file
ENC_FOOTER_KEY = bytes(range(16))
ENC_COLUMN_KEY = bytes(range(100, 132))
ENC_AAD_PREFIX = b"tpch-lineitem-sf1"
ENC_MASTER_KEYS = {"kf": bytes(range(200, 216)),
                   "kc": bytes(range(50, 82))}


def _q6_table(li, n: int) -> dict:
    return {c: li[c][:n] for c in Q6_COLUMNS}


def write_encrypted(path: str, table: dict, encryption, **extra) -> int:
    """The table as a snappy parquet file in the dataset's layout (row
    groups of DATASET_ROWS_PER_GROUP rows, DATASET_PAGE_BYTES pages, the
    DATASET_DICT_LIMIT dictionary limit) under `encryption`; returns its
    bytes."""
    extra.setdefault("write_page_index", False)
    tpq.write_table(table, path, compression="snappy",
                    data_page_size=DATASET_PAGE_BYTES,
                    row_group_size=DATASET_ROWS_PER_GROUP,
                    dictionary_pagesize_limit=DATASET_DICT_LIMIT,
                    encryption=encryption, **extra)
    return os.path.getsize(path)


def encrypted_q6(path: str, decryption, dev, times=None,
                 columns=Q6_COLUMNS) -> dict:
    """TPC-H Q6 over an encrypted file: each row group's pages decrypted
    on the host (the port's AES), decoded on the card (read_batch_device)
    and run through Q6 (K1 filter, K3 sum), added across row groups."""
    pf = tpq.ParquetFile(path, decryption=decryption)
    try:
        return q6_over_batches(
            tpq.read_batch_device(pf, i, columns, device=dev, times=times)
            for i in range(pf.num_row_groups))
    finally:
        pf.close()


def check_read_table(what: str, t, table: dict, n: int) -> None:
    """Every column of a read_table result equals its numpy source over
    [0, n), bit for bit."""
    hb = one_batch(t)
    if hb.num_rows != n:
        raise AssertionError(f"{what}: {hb.num_rows} rows, wrote {n}")
    for f, c in zip(hb.schema.fields, hb.columns):
        _same_bits(f"{what} {f.name}", c.values, table[f.name][:n])


class LocalKms:
    """An in-memory KMS: master keys by id, a key wrapped as base64 of
    nonce || AES-GCM ciphertext || tag under its master key, with the
    port's own AES-GCM."""

    def __init__(self, master_keys: dict):
        self.master_keys = master_keys

    def wrap_key(self, key_bytes: bytes, master_key_identifier: str) -> str:
        import base64
        from arrow_go_tpu_torch import native
        nonce = os.urandom(12)
        ct = native.aes_gcm_encrypt(
            self.master_keys[master_key_identifier], nonce, key_bytes)
        return base64.b64encode(nonce + bytes(ct)).decode()

    def unwrap_key(self, wrapped_key: str,
                   master_key_identifier: str) -> bytes:
        import base64
        from arrow_go_tpu_torch import native
        raw = base64.b64decode(wrapped_key)
        return bytes(native.aes_gcm_decrypt(
            self.master_keys[master_key_identifier], raw[:12], raw[12:]))


def check_index_bloom(path: str, decryption, table: dict) -> dict:
    """enc_q6's page index and l_qty's bloom filter, decrypted: each row
    group's ColumnIndex min / max are its l_qty's, its OffsetIndex's
    pages start at row 0 and ascend within the chunk, and the bloom
    filter holds every l_qty value and few others."""
    pf = tpq.ParquetFile(path, decryption=decryption)
    li = pf._leaf_index_of("l_qty")
    pages, false_pos, rg_rows = 0, 0, 0
    for rg in range(pf.num_row_groups):
        n = pf.metadata.row_groups[rg].num_rows
        q = table["l_qty"][rg_rows:rg_rows + n]
        ci = pf.read_column_index(rg, li)
        got = [int(np.frombuffer(v, np.int32)[0])
               for v in (ci.min_values[0], ci.max_values[0])]
        if got != [int(q.min()), int(q.max())] or ci.null_pages != [False]:
            raise AssertionError(f"enc_index_bloom: row group {rg} column "
                                 f"index {got}")
        locs = pf.read_offset_index(rg, li).page_locations
        firsts = [p.first_row_index for p in locs]
        offs = [p.offset for p in locs]
        if firsts[0] != 0 or firsts != sorted(firsts) or offs != sorted(
                offs) or firsts[-1] >= n:
            raise AssertionError(f"enc_index_bloom: row group {rg} offset "
                                 f"index {firsts}")
        pages += len(locs)
        bf = pf.read_bloom_filter(rg, li)
        if not all(bf.check(int(v), tpq.format.Type.INT32)
                   for v in np.unique(q)):
            raise AssertionError(f"enc_index_bloom: row group {rg} bloom "
                                 f"filter misses a value")
        false_pos += sum(bf.check(v, tpq.format.Type.INT32)
                         for v in range(1000, 2000))
        rg_rows += n
    pf.close()
    if false_pos > 0.05 * 1000 * pf.num_row_groups:
        raise AssertionError(f"enc_index_bloom: {false_pos} false positives")
    return {"row_groups": pf.num_row_groups, "pages": pages,
            "bloom_false_positives_per_1000": false_pos / pf.num_row_groups}


def cli_phase(root: str, table: dict, dev) -> dict:
    """cli.main ls, schema, cat --rows 5 and convert (.parquet -> .arrow
    -> .parquet) on a plaintext file of the table, each held against
    the numpy columns."""
    import contextlib
    from arrow_go_tpu_torch import cli

    def run(*argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--device", str(dev), *argv])
        return buf.getvalue()
    n = len(table["l_qty"])
    src = os.path.join(root, "cli.parquet")
    tpq.write_table(table, src, compression="snappy", write_page_index=False)
    t0 = time.perf_counter()
    ls = run("ls", src)
    want = [f"rows: {n}"] + [f"  {c}: {dt.from_numpy_dtype(table[c].dtype)}"
                             " not null" for c in table]
    if ls.splitlines() != want:
        raise AssertionError(f"cli ls: {ls!r}")
    schema = run("schema", src)
    if f"rows: {n}  row_groups: 1" not in schema or \
            schema.count("codec=SNAPPY") != len(table):
        raise AssertionError(f"cli schema: {schema!r}")
    cat = run("cat", "--rows", "5", src).splitlines()
    rows = ["\t".join(table)] + ["\t".join(str(table[c][i].item())
                                           for c in table) for i in range(5)]
    if cat != rows:
        raise AssertionError(f"cli cat: {cat!r}, numpy {rows!r}")
    arrow, back = os.path.join(root, "cli.arrow"), os.path.join(
        root, "cli_back.parquet")
    run("convert", src, arrow)
    run("convert", arrow, back)
    check_read_table("cli convert", tpq.read_table(back, device=dev), table,
                     n)
    return {"rows": n, "ms": (time.perf_counter() - t0) * 1e3,
            "ls_lines": len(want), "schema_bytes": len(schema)}


def encryption_phases(li, dev, card: str, timing_only: bool = False) -> dict:
    """This slice's paths, over the first rows of the SF10 arrays, all
    files in a temporary directory: `enc_q6` (the Q6 columns of
    ENC_ROWS rows written AES_GCM_V1, uniform, encrypted footer, in the
    dataset's layout with a page index and an l_qty bloom filter; read
    by parquet.read_table and held bit for bit; Q6 from the file on the
    card against the oracle, with the read split, the decryption rate
    and the device idle share), `enc_ctr_columns` (ENC_CTR_ROWS rows,
    AES_GCM_CTR_V1, a signed plaintext footer, column keys on l_price
    and l_disc, an AAD prefix that is not stored: the plaintext columns
    read with no keys, l_price with none and a wrong key refused, Q6
    with the keys), `enc_kms` (ENC_KMS_ROWS rows under a CryptoFactory
    with double wrapping over an in-memory KMS), `enc_index_bloom`,
    `cli` and `encryption_path_checks` (every K1 and K3 call of enc_q6
    and enc_ctr_columns against the plain version; not with
    `timing_only`). Returns each path's launch counts and the largest
    kernel - plain difference."""
    from arrow_go_tpu_torch.parquet import keytools
    t_phase = time.perf_counter()
    launches, checks = {}, {}
    root_dir = tempfile.TemporaryDirectory()
    root = root_dir.name
    dec = tpq.FileDecryptionProperties(footer_key=ENC_FOOTER_KEY)

    # enc_q6: SF1's lineitem Q6 columns, uniform AES_GCM_V1
    n = min(ENC_ROWS, len(li["l_okey"]))
    table = _q6_table(li, n)
    want = q6_oracle(table)
    path = os.path.join(root, "enc_q6.parquet")
    t0 = time.perf_counter()
    nbytes = write_encrypted(path, table, tpq.FileEncryptionProperties(
        footer_key=ENC_FOOTER_KEY), write_page_index=True,
        write_bloom_filters=["l_qty"])
    write_ms = (time.perf_counter() - t0) * 1e3
    with open(path, "rb") as f:
        if f.read(4) != b"PARE":
            raise AssertionError("enc_q6: the file does not start PARE")
    t0 = time.perf_counter()
    hb = tpq.read_table(path, decryption=dec, device=dev)
    read_table_ms = (time.perf_counter() - t0) * 1e3
    check_read_table("enc_q6 read_table", hb, table, n)
    del hb
    got, launches["encrypted Q6"] = run_path(
        "encrypted Q6", lambda: encrypted_q6(path, dec, dev), ("K1", "K3"))
    check_q6(got, want)
    splits = []
    for _ in range(3):
        times = {}
        t0 = time.perf_counter()
        again = encrypted_q6(path, dec, dev, times)
        times["ms"] = (time.perf_counter() - t0) * 1e3
        if again != got:
            raise AssertionError(f"enc_q6: a run gave {again}, first {got}")
        splits.append(times)
    split = min(splits, key=lambda t: t["ms"])
    pf = tpq.ParquetFile(path, decryption=dec)
    cipher_bytes = sum(c.meta_data.total_compressed_size
                       for rg in pf.metadata.row_groups for c in rg.columns)
    pf.close()
    prof = profile_device(lambda: encrypted_q6(path, dec, dev),
                          lambda o: check_q6(o, want), top=6)
    checks["enc_q6"] = (lambda: encrypted_q6(path, dec, dev),
                        lambda o: check_q6(o, want), "encrypted Q6")
    print(json.dumps({"enc_q6": {
        **got, "oracle": want, "rows": n, "file_bytes": nbytes,
        "ciphertext_bytes": cipher_bytes, "write_ms": write_ms,
        "read_table_ms": read_table_ms, "ms_runs": [t["ms"] for t in splits],
        "split_ms": {k[:-2] + "_ms": v * 1e3 for k, v in split.items()
                     if k.endswith("_s")},
        "decrypt_gb_per_s": cipher_bytes / split["decrypt_s"] / 1e9,
        "profile": prof, "launches_per_run": launches["encrypted Q6"],
        "card": card, "verified": True}}), flush=True)

    # enc_index_bloom, on enc_q6's file
    print(json.dumps({"enc_index_bloom": {
        **check_index_bloom(path, dec, table), "card": card,
        "verified": True}}), flush=True)

    # enc_ctr_columns: CTR pages, a signed plaintext footer, column keys
    k = min(ENC_CTR_ROWS, n)
    ctr_table = _q6_table(li, k)
    ctr_want = q6_oracle(ctr_table)
    cpath = os.path.join(root, "enc_ctr.parquet")
    cbytes = write_encrypted(cpath, ctr_table, tpq.FileEncryptionProperties(
        footer_key=ENC_FOOTER_KEY, plaintext_footer=True,
        algorithm="AES_GCM_CTR_V1", aad_prefix=ENC_AAD_PREFIX,
        store_aad_prefix=False,
        column_keys={"l_price": ENC_COLUMN_KEY, "l_disc": ENC_COLUMN_KEY}))
    no_keys = tpq.FileDecryptionProperties(aad_prefix=ENC_AAD_PREFIX)
    plain = tpq.read_table(cpath, columns=["l_sdate", "l_qty"],
                           decryption=no_keys, device=dev)
    check_read_table("enc_ctr_columns plaintext", plain, ctr_table, k)
    refused = {
        "no_keys": _raises("enc_ctr_columns l_price", lambda:
                                   tpq.read_table(cpath, columns=["l_price"],
                                                  decryption=no_keys,
                                                  device=dev)),
        "wrong_key": _raises(
            "enc_ctr_columns wrong key", lambda: tpq.read_table(
                cpath, columns=["l_price"], device=dev,
                decryption=tpq.FileDecryptionProperties(
                    footer_key=ENC_FOOTER_KEY, aad_prefix=ENC_AAD_PREFIX,
                    column_keys={"l_price": ENC_FOOTER_KEY,
                                 "l_disc": ENC_COLUMN_KEY}))),
        "no_aad_prefix": _raises(
            "enc_ctr_columns no prefix", lambda: tpq.read_table(
                cpath, device=dev, decryption=tpq.FileDecryptionProperties(
                    footer_key=ENC_FOOTER_KEY,
                    column_keys={"l_price": ENC_COLUMN_KEY,
                                 "l_disc": ENC_COLUMN_KEY})))}
    keys = tpq.FileDecryptionProperties(
        footer_key=ENC_FOOTER_KEY, aad_prefix=ENC_AAD_PREFIX,
        column_keys={"l_price": ENC_COLUMN_KEY, "l_disc": ENC_COLUMN_KEY})
    times = {}
    got, launches["CTR column-key Q6"] = run_path(
        "CTR column-key Q6", lambda: encrypted_q6(cpath, keys, dev, times),
        ("K1", "K3"))
    check_q6(got, ctr_want)
    checks["enc_ctr_columns"] = (lambda: encrypted_q6(cpath, keys, dev),
                                 lambda o: check_q6(o, ctr_want),
                                 "CTR column-key Q6")
    print(json.dumps({"enc_ctr_columns": {
        **got, "oracle": ctr_want, "rows": k, "file_bytes": cbytes,
        "plaintext_columns_read_with_no_keys": True, "refused": refused,
        "split_ms": {k2[:-2] + "_ms": v * 1e3 for k2, v in times.items()},
        "launches_per_run": launches["CTR column-key Q6"], "card": card,
        "verified": True}}), flush=True)

    # enc_kms: envelope encryption, double wrapping, an in-memory KMS
    m = min(ENC_KMS_ROWS, n)
    kms_table = _q6_table(li, m)
    kms_want = q6_oracle(kms_table)
    factory = keytools.CryptoFactory(lambda cfg: LocalKms(ENC_MASTER_KEYS))
    kcfg = keytools.KmsConnectionConfig()
    eprops = factory.file_encryption_properties(
        kcfg, keytools.EncryptionConfiguration(
            footer_key="kf", column_keys={"kc": ["l_price", "l_disc"]},
            double_wrapping=True))
    kpath = os.path.join(root, "enc_kms.parquet")
    kbytes = write_encrypted(kpath, kms_table, eprops)
    kdec = factory.file_decryption_properties(kcfg)
    check_read_table("enc_kms read_table",
                     tpq.read_table(kpath, decryption=kdec, device=dev),
                     kms_table, m)
    got, launches["KMS Q6"] = run_path(
        "KMS Q6", lambda: encrypted_q6(kpath, kdec, dev), ("K1", "K3"))
    check_q6(got, kms_want)
    print(json.dumps({"enc_kms": {
        **got, "oracle": kms_want, "rows": m, "file_bytes": kbytes,
        "double_wrapping": True,
        "footer_key_material": json.loads(eprops.footer_key_metadata)[
            "keyMaterialType"],
        "launches_per_run": launches["KMS Q6"], "card": card,
        "verified": True}}), flush=True)

    # cli: ls, schema, cat and convert on a plaintext file
    print(json.dumps({"cli": {**cli_phase(root, kms_table, dev),
                              "card": card, "verified": True}}), flush=True)

    held = {}
    if not timing_only:
        for key, (fn, check, name) in checks.items():
            out, held[key] = check_path_calls(key, fn, launches[name],
                                              k3=True)
            check(out)
        print(json.dumps({"encryption_path_checks": held}), flush=True)
    root_dir.cleanup()
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K3")}
    print(json.dumps({"encryption_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


FLIGHT_ROWS = LINEITEM_SF1         # rows of the Flight paths (SF1's lineitem)
FLIGHT_BATCH_ROWS = 1 << 20        # rows of a served HostBatch
FLIGHT_SORT_COLUMN = Q6_COLUMNS.index("l_sdate")
FLIGHT_METADATA = {"tpch.table": "lineitem", "tpch.scale": "1",
                   "sorted_by": "l_sdate"}
FLIGHT_CREATED_BY = "arrow_go_tpu_torch flight phase"
FLIGHT_CODECS = {"l_price": "SNAPPY", "l_disc": "SNAPPY", "l_sdate": "ZSTD",
                 "l_qty": "SNAPPY"}


def flight_writer_properties(rows_per_group: int = DATASET_ROWS_PER_GROUP,
                             page_bytes: int = DATASET_PAGE_BYTES):
    """The WriterProperties of the served file: data page v2, format
    2.6, l_sdate DELTA_BINARY_PACKED in zstd, l_qty a dictionary in
    snappy, l_price and l_disc snappy, no statistics on l_disc, the rows
    declared sorted by l_sdate, the dataset's layout."""
    return tpq.WriterProperties(
        data_page_version="2.0", version="2.6", created_by=FLIGHT_CREATED_BY,
        compression="snappy", data_page_size=page_bytes,
        max_row_group_length=rows_per_group,
        sorting_columns=[tpq.SortingColumn(FLIGHT_SORT_COLUMN)],
        column_properties={
            "l_sdate": {"encoding": "delta_binary_packed",
                        "compression": "zstd"},
            "l_qty": {"use_dictionary": True, "compression": "snappy"},
            "l_price": {"compression": "snappy"},
            "l_disc": {"compression": "snappy", "write_statistics": False}})


def flight_table(li, n: int) -> dict:
    """The first n rows of the Q6 columns, sorted by l_sdate (stable), as
    the served file declares them."""
    order = np.argsort(li["l_sdate"][:n], kind="stable")
    return {c: li[c][:n][order] for c in Q6_COLUMNS}


def flight_batch(table: dict) -> HostBatch:
    """The table as one HostBatch (REQUIRED fields, IPC_TYPES) whose
    schema carries FLIGHT_METADATA."""
    schema = dt.Schema([dt.Field(c, IPC_TYPES[c], False) for c in Q6_COLUMNS],
                       dt.Metadata(FLIGHT_METADATA))
    return HostBatch(schema, [HostArray(table[c], None, IPC_TYPES[c])
                              for c in Q6_COLUMNS], len(table["l_qty"]))


def write_flight_file(path: str, table: dict, **layout) -> int:
    tpq.write_table(flight_batch(table), path,
                    properties=flight_writer_properties(**layout))
    return os.path.getsize(path)


def check_flight_footer(path: str) -> dict:
    """The served file's footer against its properties: format version
    2, created_by, only DATA_PAGE_V2 data pages, each column's codec,
    l_sdate DELTA_BINARY_PACKED, l_qty dictionary-coded, no statistics
    on l_disc, the sorting column in every row group and the key/value
    metadata."""
    from arrow_go_tpu_torch.parquet.device_read import _iter_pages
    pf = tpq.ParquetFile(path)
    md = pf.metadata
    kv = {k.key: k.value for k in md.key_value_metadata or []}
    pages, codecs = {}, {}
    try:
        if (md.version, md.created_by, kv) != (2, FLIGHT_CREATED_BY,
                                               FLIGHT_METADATA):
            raise AssertionError(f"flight file footer: {md.version} "
                                 f"{md.created_by!r} {kv}")
        for rg in md.row_groups:
            if [(s.column_idx, bool(s.descending), bool(s.nulls_first))
                    for s in rg.sorting_columns or []] != \
                    [(FLIGHT_SORT_COLUMN, False, False)]:
                raise AssertionError("flight file: a row group's sorting "
                                     "columns")
            for ch in rg.columns:
                m = ch.meta_data
                name = m.path_in_schema[0]
                codecs[name] = tpq.format.Codec(m.codec).name
                for hdr, _ in _iter_pages(pf, ch):
                    ptype = tpq.format.PageType(hdr.type).name
                    sub = hdr.data_page_header_v2 or \
                        hdr.dictionary_page_header or hdr.data_page_header
                    pages.setdefault(name, set()).add(
                        (ptype, tpq.format.Encoding(sub.encoding).name))
                if (m.statistics is None) != (name == "l_disc"):
                    raise AssertionError(f"flight file: {name} statistics")
    finally:
        pf.close()
    data_kinds = {p for v in pages.values() for p, _ in v} - {
        "DICTIONARY_PAGE"}
    if data_kinds != {"DATA_PAGE_V2"} or codecs != FLIGHT_CODECS or \
            ("DATA_PAGE_V2", "DELTA_BINARY_PACKED") not in pages["l_sdate"] \
            or ("DICTIONARY_PAGE", "PLAIN") not in pages["l_qty"]:
        raise AssertionError(f"flight file pages {pages}, codecs {codecs}")
    return {"version": md.version, "created_by": md.created_by,
            "row_groups": len(md.row_groups), "codecs": codecs,
            "pages": {k: sorted(map(list, v)) for k, v in pages.items()},
            "sorting_column": Q6_COLUMNS[FLIGHT_SORT_COLUMN],
            "key_value_metadata": kv}


def _loopback_server(batches, listener) -> None:
    """The transport's yardstick: each accepted connection is sent the
    batches' column buffers, the bytes of their IPC bodies, by sendall."""
    while True:
        try:
            conn, _ = listener.accept()
        except OSError:
            return
        with conn:
            for b in batches:
                for c in b.columns:
                    conn.sendall(memoryview(np.ascontiguousarray(c.values)
                                            ).cast("B"))


def flight_server_main(path: str, rows: int, pipe) -> None:
    """The served process: the file read through the port's read front
    (decoded on the CPU, as this host-side service asks), served in
    HostBatches of `rows` rows by DoGet, DoPut acknowledging each batch
    with its row count and l_qty sum, and the loopback yardstick on a
    second port. Sends (Flight port, yardstick port, row count), then
    serves until the pipe says stop."""
    import socket
    import threading
    from arrow_go_tpu_torch import flight as fl
    hb = one_batch(tpq.read_table(path, device="cpu"))
    batches = [hb.slice(a, rows) for a in range(0, hb.num_rows, rows)]

    class Server(fl.FlightServerBase):
        def do_get(self, ctx, ticket):
            return hb.schema, batches

        def do_put(self, ctx, desc, reader):
            for b in reader:
                qty = int(b.column("l_qty").values.astype(np.int64).sum())
                yield f"{b.num_rows}:{qty}".encode()

    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(4)
    threading.Thread(target=_loopback_server, args=(batches, listener),
                     daemon=True).start()
    with Server("grpc://127.0.0.1:0") as srv:
        pipe.send((srv.port, listener.getsockname()[1], hb.num_rows))
        pipe.recv()
    listener.close()


def start_flight_server(path: str, rows: int = FLIGHT_BATCH_ROWS):
    """flight_server_main in a spawned process, so that the server's and
    the client's Python do not share one interpreter lock; returns
    (process, pipe, (Flight port, yardstick port, rows))."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    ours, theirs = ctx.Pipe()
    proc = ctx.Process(target=flight_server_main, args=(path, rows, theirs),
                       daemon=True)
    proc.start()
    t0 = time.perf_counter()
    while not ours.poll(0.5):
        if not proc.is_alive() or time.perf_counter() - t0 > 300:
            proc.kill()
            raise AssertionError("the flight server process did not start")
    return proc, ours, ours.recv()


def stop_flight_server(proc, pipe) -> None:
    pipe.send("stop")
    proc.join(30)
    if proc.is_alive():
        proc.kill()
        proc.join(10)


def flight_q6(client, dev, times=None, source=None) -> dict:
    """TPC-H Q6 over a DoGet stream: each HostBatch the port's client
    reads to the card (host_batch_to_device), filtered (K1) and summed
    (K3), added across batches. `times` gathers the wait on the stream
    (`stream_s`: the call and each batch's arrival and IPC decode, the
    transport overlapping the card work), the copy to the card (`h2d_s`),
    the compute (`compute_s`), the batches, rows and IPC body bytes;
    with `source` each batch is held bit for bit against it, outside
    the spans."""
    from arrow_go_tpu_torch import flight as fl
    from arrow_go_tpu_torch.device.block import host_batch_to_device
    t_call = time.perf_counter()
    reader = client.do_get(fl.Ticket(b"lineitem"))
    revenue, count, row, n, body = 0.0, 0, 0, 0, 0
    spans = {"stream_s": time.perf_counter() - t_call, "h2d_s": 0.0,
             "compute_s": 0.0}
    while True:
        t0 = time.perf_counter()
        hb = reader.read_next_batch()
        if hb is None:
            break
        t1 = time.perf_counter()
        db = host_batch_to_device(hb, dev)
        _sync(dev)
        t2 = time.perf_counter()
        rev = q6_revenue(db)
        if rev.length:
            revenue += pc.agg_sum(rev)
        count += rev.length
        _sync(dev)
        t3 = time.perf_counter()
        for k, v in zip(spans, (t1 - t0, t2 - t1, t3 - t2)):
            spans[k] += v
        body += sum(c.values.nbytes for c in hb.columns)
        if source is not None:
            for f, c in zip(hb.schema.fields, hb.columns):
                _same_bits(f"flight_q6 {f.name} batch {n}", c.values,
                           source[f.name][row:row + hb.num_rows])
        row += hb.num_rows
        n += 1
    if times is not None:
        times.update(spans, batches=n, rows=row, body_bytes=body)
    return {"revenue": revenue, "count": count}


def flight_stream_ms(client) -> tuple:
    """(ms, IPC body bytes) of one DoGet read to its end with no other
    work: the transport's own time."""
    from arrow_go_tpu_torch import flight as fl
    t0 = time.perf_counter()
    body = sum(c.values.nbytes for hb in client.do_get(fl.Ticket(
        b"lineitem")) for c in hb.columns)
    return (time.perf_counter() - t0) * 1e3, body


def loopback_ms(port: int, nbytes: int) -> float:
    """ms to receive `nbytes` from the yardstick server into one buffer
    over a plain loopback socket."""
    import socket
    buf = bytearray(nbytes)
    mv = memoryview(buf)
    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        got = 0
        while got < nbytes:
            k = s.recv_into(mv[got:])
            if not k:
                raise AssertionError("the yardstick closed early")
            got += k
    return (time.perf_counter() - t0) * 1e3


def flight_batches(table: dict, rows: int = FLIGHT_BATCH_ROWS) -> list:
    hb = flight_batch(table)
    return [hb.slice(a, rows) for a in range(0, hb.num_rows, rows)]


def flight_put(client, batches) -> list:
    """DoPut of `batches`; each acknowledgement must be the batch's row
    count and l_qty sum."""
    from arrow_go_tpu_torch import flight as fl
    acks = client.do_put(fl.FlightDescriptor.for_path("lineitem"),
                         batches[0].schema, batches)
    want = [f"{b.num_rows}:{int(b.column('l_qty').values.sum(dtype=np.int64))}"
            .encode() for b in batches]
    if acks != want:
        raise AssertionError(f"flight_put: acknowledgements {acks[:3]}..., "
                             f"want {want[:3]}...")
    return acks


def q6_exchange_server(dev):
    """A port Flight server whose DoExchange moves each received batch to
    `dev`, runs Q6 on it (K1, K3) and returns Q6's one-row result."""
    from arrow_go_tpu_torch import flight as fl
    from arrow_go_tpu_torch.device.block import host_batch_to_device
    schema = dt.Schema([dt.Field("revenue", dt.float64, False),
                        dt.Field("count", dt.int64, False)])

    class Server(fl.FlightServerBase):
        def do_exchange(self, ctx, desc, reader):
            revenue, count = 0.0, 0
            for hb in reader:
                rev = q6_revenue(host_batch_to_device(hb, dev))
                if rev.length:
                    revenue += pc.agg_sum(rev)
                count += rev.length
            return HostBatch(schema, [
                HostArray(np.array([revenue]), None, dt.float64),
                HostArray(np.array([count], np.int64), None, dt.int64)], 1)
    return Server("grpc://127.0.0.1:0")


def flight_exchange(client, batches) -> dict:
    from arrow_go_tpu_torch import flight as fl
    out = one_batch(client.do_exchange(fl.FlightDescriptor.for_command(
        b"q6"), batches[0].schema, batches).read_all())
    return {"revenue": float(out.column("revenue").values[0]),
            "count": int(out.column("count").values[0])}


def flight_scenarios() -> dict:
    """The ported integration scenarios, port server with port client:
    seconds each (a failure raises)."""
    import contextlib
    from arrow_go_tpu_torch.flight import integration
    out = {}
    for name in sorted(integration.SCENARIOS):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # the runners' lines
            integration.run_scenario_inprocess(name)
        out[name] = time.perf_counter() - t0
    return out


def flight_phases(li, dev, card: str, timing_only: bool = False) -> dict:
    """This slice's paths over the first FLIGHT_ROWS rows of the Q6
    columns, sorted by l_sdate, in a temporary directory: the file
    written with flight_writer_properties and its footer checked
    (`flight_file`); served from a spawned process (`flight_server`);
    `flight_q6` (DoGet, each batch to the card, Q6 with K1 and K3, beside
    the same bytes over a plain loopback socket), `flight_put` (DoPut,
    every batch acknowledged), `flight_exchange` (DoExchange against a
    port server in this process that runs Q6 on the card),
    `flight_scenarios` and `flight_path_checks` (every K1 and K3 call of
    flight_q6 and flight_exchange against the plain version; not with
    `timing_only`). Each path is timed as a median of 3 after one
    counted run. Returns the launch counts and the largest kernel -
    plain difference."""
    from arrow_go_tpu_torch import flight as fl
    t_phase = time.perf_counter()
    launches, checks = {}, {}
    root_dir = tempfile.TemporaryDirectory()
    n = min(FLIGHT_ROWS, len(li["l_okey"]))
    table = flight_table(li, n)
    want = q6_oracle(table)
    path = os.path.join(root_dir.name, "lineitem_q6.parquet")
    t0 = time.perf_counter()
    nbytes = write_flight_file(path, table)
    write_ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"flight_file": {
        **check_flight_footer(path), "rows": n, "file_bytes": nbytes,
        "write_ms": write_ms, "card": card, "verified": True}}), flush=True)

    t0 = time.perf_counter()
    proc, pipe, (port, yard_port, served) = start_flight_server(path)
    start_ms = (time.perf_counter() - t0) * 1e3
    exch = None
    try:
        if served != n:
            raise AssertionError(f"the server read {served} rows, wrote {n}")
        client = fl.FlightClient(f"grpc://127.0.0.1:{port}")
        # flight_q6
        got, launches["Flight Q6"] = run_path(
            "Flight Q6", lambda: flight_q6(client, dev), ("K1", "K3"))
        check_q6(got, want)
        split = {}
        if flight_q6(client, dev, split, source=table) != got:
            raise AssertionError("flight_q6: two streams differ")
        runs = []
        for _ in range(3):
            times = {}
            t0 = time.perf_counter()
            if flight_q6(client, dev, times) != got:
                raise AssertionError("flight_q6: a run differs")
            times["ms"] = (time.perf_counter() - t0) * 1e3
            runs.append(times)
        med = sorted(runs, key=lambda t: t["ms"])[1]
        body = split["body_bytes"]
        streams = [flight_stream_ms(client) for _ in range(3)]
        if any(b != body for _, b in streams):
            raise AssertionError("flight_q6: a stream's bytes differ")
        stream_ms = sorted(ms for ms, _ in streams)[1]
        yard = sorted(loopback_ms(yard_port, body) for _ in range(3))[1]
        prof = profile_device(lambda: flight_q6(client, dev),
                              lambda o: check_q6(o, want), top=6)
        checks["flight_q6"] = (lambda: flight_q6(client, dev),
                               lambda o: check_q6(o, want), "Flight Q6")
        print(json.dumps({"flight_q6": {
            **got, "oracle": want, "rows": split["rows"],
            "batches": split["batches"], "ipc_body_bytes": body,
            "ms_runs": [t["ms"] for t in runs], "ms_median": med["ms"],
            "stream_wait_ms": med["stream_s"] * 1e3,
            "stream_ms_runs": [ms for ms, _ in streams],
            "stream_ms": stream_ms, "stream_mb_per_s": body / stream_ms / 1e3,
            "copy_ms": med["h2d_s"] * 1e3,
            "compute_ms": med["compute_s"] * 1e3,
            "loopback_socket_ms": yard,
            "loopback_socket_mb_per_s": body / yard / 1e3,
            "server_start_ms": start_ms, "profile": prof,
            "verified_bits": True,
            "launches_per_run": launches["Flight Q6"], "card": card,
            "verified": True}}), flush=True)

        # flight_put
        batches = flight_batches(table)
        _, launches["Flight put"] = run_path(
            "Flight put", lambda: flight_put(client, batches), ())
        put_runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            flight_put(client, batches)
            put_runs.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"flight_put": {
            "rows": n, "batches": len(batches), "ipc_body_bytes": body,
            "ms_runs": put_runs, "ms_median": float(np.median(put_runs)),
            "mb_per_s": body / float(np.median(put_runs)) / 1e3,
            "acknowledged": True, "card": card, "verified": True}}),
            flush=True)
        client.close()

        # flight_exchange: the server side on the card, in this process
        exch = q6_exchange_server(dev)
        exch.serve()
        xclient = fl.FlightClient(f"grpc://127.0.0.1:{exch.port}")
        got, launches["Flight exchange"] = run_path(
            "Flight exchange", lambda: flight_exchange(xclient, batches),
            ("K1", "K3"))
        check_q6(got, want)
        outs, x_runs = timed(lambda: flight_exchange(xclient, batches))
        for out in outs:
            check_q6(out, want)
        checks["flight_exchange"] = (
            lambda: flight_exchange(xclient, batches),
            lambda o: check_q6(o, want), "Flight exchange")
        print(json.dumps({"flight_exchange": {
            **got, "oracle": want, "rows": n, "ipc_body_bytes": body,
            "ms_runs": x_runs, "ms_median": float(np.median(x_runs)),
            "mb_per_s": body / float(np.median(x_runs)) / 1e3,
            "launches_per_run": launches["Flight exchange"], "card": card,
            "verified": True}}), flush=True)

        scen = flight_scenarios()
        print(json.dumps({"flight_scenarios": {
            "passed": sorted(scen), "s": scen, "card": card,
            "verified": True}}), flush=True)

        held = {}
        if not timing_only:
            for key, (fn, check, name) in checks.items():
                out, held[key] = check_path_calls(key, fn, launches[name],
                                                  k3=True)
                check(out)
            print(json.dumps({"flight_path_checks": held}), flush=True)
        xclient.close()
    finally:
        if exch is not None:
            exch.shutdown()
        stop_flight_server(proc, pipe)
        root_dir.cleanup()
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K3")}
    print(json.dumps({"flight_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


FLIGHTSQL_ROWS = 1 << 20           # rows of the FlightSQL paths (a cut)
FLIGHTSQL_TIMED_RUNS = 1           # timed runs of flightsql_q6 (a cut from 3)
FLIGHTSQL_CHUNKS = 4               # chunks of the ChunkedArray check
FLIGHTSQL_MARK = 99_999            # l_sdate of the DB-API's inserted rows
FLIGHTSQL_DBAPI_ROWS = 1000
Q6_SQL = "SELECT l_price, l_disc, l_qty, l_sdate FROM lineitem"
Q6_AGG_SQL = ("SELECT SUM(l_price * l_disc), COUNT(*) FROM lineitem "
              "WHERE l_sdate >= ? AND l_sdate < ? AND l_disc >= ? "
              "AND l_disc <= ? AND l_qty < ?")
Q6_PARAMS = (Q6_DATE_LO, Q6_DATE_HI, Q6_DISC_LO, Q6_DISC_HI, Q6_QTY)


def flightsql_batch(table: dict) -> HostBatch:
    """The Q6 columns as one HostBatch at their widths (IPC_TYPES)."""
    schema = dt.Schema([dt.Field(c, IPC_TYPES[c], False) for c in Q6_COLUMNS])
    return HostBatch(schema, [HostArray(table[c], None, IPC_TYPES[c])
                              for c in Q6_COLUMNS], len(table["l_qty"]))


def flightsql_q6(client, dev, times=None, keep=None) -> dict:
    """TPC-H Q6 from a FlightSQL query: Q6_SQL by GetFlightInfo (the
    server runs the query for its schema and row count) and DoGet (it
    runs it again and streams the result), the HostBatch to the card,
    compute_q6 (K1, K3). `times` gathers the GetFlightInfo and DoGet
    seconds (`info_s`, `doget_s`: the server's two runs of the query,
    the columns' inference and the IPC stream), the copy (`h2d_s`), the
    compute (`compute_s`), the rows, the IPC body bytes and the result's
    column types; `keep` (a dict) receives the HostBatch."""
    from arrow_go_tpu_torch.device.block import host_batch_to_device
    t0 = time.perf_counter()
    info = client.execute(Q6_SQL)
    t1 = time.perf_counter()
    hb = one_batch(client.do_get(info.endpoints[0].ticket).read_all())
    t2 = time.perf_counter()
    db = host_batch_to_device(hb, dev)
    _sync(dev)
    t3 = time.perf_counter()
    out = compute_q6(db)
    _sync(dev)
    t4 = time.perf_counter()
    if info.total_records != hb.num_rows:
        raise AssertionError(f"flightsql_q6: FlightInfo says "
                             f"{info.total_records} rows, DoGet gave "
                             f"{hb.num_rows}")
    if times is not None:
        times.update(info_s=t1 - t0, doget_s=t2 - t1, h2d_s=t3 - t2,
                     compute_s=t4 - t3, rows=hb.num_rows,
                     body_bytes=sum(c.values.nbytes for c in hb.columns),
                     types={f.name: str(f.type) for f in hb.schema.fields})
    if keep is not None:
        keep["batch"] = hb
    return out


def sqlite_q6(client) -> dict:
    """SQLite's own Q6 aggregate: Q6_AGG_SQL prepared, Q6's bounds bound
    as a one-row parameter batch, executed."""
    from arrow_go_tpu_torch.flight import sql as fsql
    ps = client.prepare(Q6_AGG_SQL)
    try:
        ps.set_parameters(fsql.table({f"p{i}": [v] for i, v in
                                      enumerate(Q6_PARAMS)}))
        out = one_batch(ps.execute())
    finally:
        ps.close()
    return {"revenue": float(out.columns[0].values[0]),
            "count": int(out.columns[1].values[0])}


def chunked_filter(hb: HostBatch, keep: np.ndarray, dev):
    """The batch's l_disc in FLIGHTSQL_CHUNKS chunks as a ChunkedArray,
    filtered by Q6's mask on `dev` (filter_ combines it: one K1)."""
    from arrow_go_tpu_torch.array import ChunkedArray
    col = hb.column("l_disc")
    step = -(-len(col) // FLIGHTSQL_CHUNKS)
    ca = ChunkedArray([col.slice(a, step) for a in range(0, len(col), step)],
                      col.type)
    out = pc.filter_(ca, HostArray(keep, None, dt.bool_), device=dev)
    return ca, out


def check_chunked(ca, out, keep: np.ndarray) -> None:
    from arrow_go_tpu_torch.array import array_equal
    want = HostArray(ca.combine().values[keep], None, ca.type)
    if ca.num_chunks != FLIGHTSQL_CHUNKS or not array_equal(out, want):
        raise AssertionError(f"chunked: {ca.num_chunks} chunks, filter of "
                             f"{len(out)} rows, numpy {len(want)}")


def flightsql_dbapi(uri: str, want: dict) -> dict:
    """Through dbapi.connect: the parameterised Q6 aggregate by a Cursor
    (held against `want`), an executemany of FLIGHTSQL_DBAPI_ROWS rows
    inside the implicit transaction (counted there) rolled back and
    counted as gone,
    then another committed and counted as kept, then deleted. Returns
    ms of each step."""
    from arrow_go_tpu_torch.flight import dbapi
    ms = {}
    rows = [(float(i), 0.0, 1, FLIGHTSQL_MARK)
            for i in range(FLIGHTSQL_DBAPI_ROWS)]
    count_sql = "SELECT COUNT(*) FROM lineitem WHERE l_sdate = ?"
    with dbapi.connect(uri) as conn:
        cur = conn.cursor()
        t0 = time.perf_counter()
        cur.execute(Q6_AGG_SQL, Q6_PARAMS)
        revenue, count = cur.fetchone()
        ms["q6_cursor"] = (time.perf_counter() - t0) * 1e3
        check_q6({"revenue": revenue, "count": count}, want)
        if cur.description[1][0] != "COUNT(*)" or cur.rowcount != 1:
            raise AssertionError(f"flightsql_dbapi: {cur.description}")
        for end in ("rollback", "commit"):
            t0 = time.perf_counter()
            cur.executemany("INSERT INTO lineitem (l_price, l_disc, l_qty, "
                            "l_sdate) VALUES (?, ?, ?, ?)", rows)
            inserted = cur.rowcount
            inside = cur.execute(count_sql, (FLIGHTSQL_MARK,)).fetchone()[0]
            if not inserted == inside == len(rows):
                raise AssertionError(f"flightsql_dbapi: {inserted} rows "
                                     f"inserted, {inside} seen inside the "
                                     f"transaction")
            getattr(conn, end)()
            ms[f"executemany_{end}"] = (time.perf_counter() - t0) * 1e3
            kept = cur.execute(count_sql, (FLIGHTSQL_MARK,)).fetchone()[0]
            if kept != (0 if end == "rollback" else len(rows)):
                raise AssertionError(f"flightsql_dbapi: {kept} rows after "
                                     f"{end}")
        cur.execute("DELETE FROM lineitem WHERE l_sdate = ?",
                    (FLIGHTSQL_MARK,))
        conn.commit()
        if cur.execute(count_sql, (FLIGHTSQL_MARK,)).fetchone()[0] != 0:
            raise AssertionError("flightsql_dbapi: the rows were not "
                                 "deleted")
    return ms


def flightsql_catalog(client) -> dict:
    """get_tables, get_sql_info, get_xdbc_type_info and get_primary_keys
    on lineitem, each result checked; ms each."""
    from arrow_go_tpu_torch.flight import SqlInfo
    from arrow_go_tpu_torch.flight import sql as fsql
    out = {}

    def call(name, fn, check):
        t0 = time.perf_counter()
        got = fn()
        out[name] = (time.perf_counter() - t0) * 1e3
        if not check(got):
            raise AssertionError(f"flightsql_catalog: {name} "
                                 f"{got.to_pydict()}")

    call("get_tables", lambda: client.get_tables(
        table_name_filter_pattern="lineitem"),
        lambda t: t.to_pydict() == {
            "catalog_name": ["main"], "db_schema_name": ["main"],
            "table_name": ["lineitem"], "table_type": ["TABLE"]})
    call("get_sql_info", client.get_sql_info,
         lambda t: dict(zip(t.column("info_name").to_pylist(),
                            t.column("value").to_pylist())) == {
             SqlInfo.FLIGHT_SQL_SERVER_NAME: "arrow_go_tpu sqlite example",
             SqlInfo.FLIGHT_SQL_SERVER_VERSION: "1.0.0",
             SqlInfo.FLIGHT_SQL_SERVER_READ_ONLY: False,
             SqlInfo.FLIGHT_SQL_SERVER_SQL: True,
             SqlInfo.FLIGHT_SQL_SERVER_TRANSACTION: 1,
             SqlInfo.SQL_IDENTIFIER_QUOTE_CHAR: '"',
             SqlInfo.SQL_KEYWORDS: ["SELECT", "FROM", "WHERE", "INSERT"]})
    call("get_xdbc_type_info", client.get_xdbc_type_info,
         lambda t: t.column("type_name").to_pylist() ==
         ["INTEGER", "REAL", "TEXT", "BLOB"] and
         t.column("data_type").to_pylist() == [4, 8, 12, -3])
    call("get_xdbc_type_info_real", lambda: client.get_xdbc_type_info(8),
         lambda t: t.column("type_name").to_pylist() == ["REAL"])
    call("get_primary_keys", lambda: client.get_primary_keys("lineitem"),
         lambda t: t.num_rows == 0 and
         t.schema == fsql.SCHEMA_PRIMARY_KEYS)
    return out


def flightsql_scenarios() -> dict:
    """The two FlightSQL integration scenarios, port server with port
    client: seconds each (a failure raises)."""
    import contextlib
    from arrow_go_tpu_torch.flight import integration
    out = {}
    for name in ("flight_sql", "flight_sql:ingestion"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):   # the runners' lines
            integration.run_scenario_inprocess(name)
        out[name] = time.perf_counter() - t0
    return out


def flightsql_phases(li, dev, card: str, timing_only: bool = False) -> dict:
    """This slice's paths over the first FLIGHTSQL_ROWS rows of the Q6
    columns, against a port SQLiteFlightSQLServer on an ephemeral
    loopback port in this process (its threads): `flightsql_ingest`,
    `flightsql_q6` (timed as the median of FLIGHTSQL_TIMED_RUNS after
    one counted run; each run takes seconds of the host's Python),
    `chunked`, `flightsql_dbapi`, `flightsql_catalog`,
    `flightsql_scenarios` and `flightsql_path_checks` (every K1 and K3
    call of flightsql_q6 and the chunked filter against the plain
    version; not with `timing_only`). Returns the launch counts and the
    largest kernel - plain difference."""
    import sqlite3                    # the server's backend: no sqlite, no phase
    from arrow_go_tpu_torch.flight import sql as fsql
    t_phase = time.perf_counter()
    launches, held = {}, {}
    n = min(FLIGHTSQL_ROWS, len(li["l_okey"]))
    table = {c: li[c][:n] for c in Q6_COLUMNS}
    want = q6_oracle(table)
    srv = fsql.SQLiteFlightSQLServer("grpc://127.0.0.1:0")
    t0 = time.perf_counter()
    srv.serve()
    start_ms = (time.perf_counter() - t0) * 1e3
    uri = f"grpc://127.0.0.1:{srv.port}"
    client = fsql.FlightSQLClient(uri)
    try:
        # flightsql_ingest
        batch = flightsql_batch(table)
        t0 = time.perf_counter()
        acked = client.execute_ingest(batch, "lineitem")
        ingest_ms = (time.perf_counter() - t0) * 1e3
        stored = one_batch(client.execute_query(
            "SELECT COUNT(*) AS n FROM lineitem")).column("n").values[0]
        if not acked == stored == n:
            raise AssertionError(f"flightsql_ingest: {n} rows sent, "
                                 f"{acked} acknowledged, {stored} stored")
        print(json.dumps({"flightsql_ingest": {
            "rows": n, "acknowledged": acked, "stored": int(stored),
            "ms": ingest_ms, "rows_per_s": n / ingest_ms * 1e3,
            "sqlite_version": sqlite3.sqlite_version,
            "server_start_ms": start_ms, "card": card,
            "verified": True}}), flush=True)

        # flightsql_q6 (the counted run keeps its batch for `chunked`)
        kept = {}
        got, launches["FlightSQL Q6"] = run_path(
            "FlightSQL Q6", lambda: flightsql_q6(client, dev, keep=kept),
            ("K1", "K3"))
        check_q6(got, want)
        lite = sqlite_q6(client)
        check_q6(lite, want)
        check_q6(got, lite)
        runs = []
        for _ in range(FLIGHTSQL_TIMED_RUNS):
            times = {}
            t0 = time.perf_counter()
            if flightsql_q6(client, dev, times) != got:
                raise AssertionError("flightsql_q6: a run differs")
            times["ms"] = (time.perf_counter() - t0) * 1e3
            runs.append(times)
        med = sorted(runs, key=lambda t: t["ms"])[len(runs) // 2]
        prof = profile_device(lambda: flightsql_q6(client, dev),
                              lambda o: check_q6(o, want), top=6)
        print(json.dumps({"flightsql_q6": {
            **got, "oracle": want, "sqlite": lite, "rows": med["rows"],
            "column_types": med["types"], "ipc_body_bytes": med["body_bytes"],
            "ms_runs": [t["ms"] for t in runs], "ms_median": med["ms"],
            "query_ms": (med["info_s"] + med["doget_s"]) * 1e3,
            "get_flight_info_ms": med["info_s"] * 1e3,
            "do_get_ms": med["doget_s"] * 1e3,
            "copy_ms": med["h2d_s"] * 1e3,
            "compute_ms": med["compute_s"] * 1e3, "profile": prof,
            "launches_per_run": launches["FlightSQL Q6"], "card": card,
            "verified": True}}), flush=True)

        # chunked: the query result's l_disc as a ChunkedArray
        hb = kept["batch"]
        keep = q6_rows({c: hb.column(c).values for c in Q6_COLUMNS})
        (ca, out), launches["chunked filter"] = run_path(
            "chunked filter", lambda: chunked_filter(hb, keep, dev), ("K1",))
        check_chunked(ca, out, keep)
        print(json.dumps({"chunked": {
            "chunks": ca.num_chunks, "rows": len(ca), "kept": len(out),
            "type": str(ca.type), "launches_per_run":
            launches["chunked filter"], "card": card, "verified": True}}),
            flush=True)

        print(json.dumps({"flightsql_dbapi": {
            "ms": flightsql_dbapi(uri, want),
            "rows_a_transaction": FLIGHTSQL_DBAPI_ROWS, "card": card,
            "verified": True}}), flush=True)
        print(json.dumps({"flightsql_catalog": {
            "ms": flightsql_catalog(client), "card": card,
            "verified": True}}), flush=True)
        scen = flightsql_scenarios()
        print(json.dumps({"flightsql_scenarios": {
            "passed": sorted(scen), "s": scen, "card": card,
            "verified": True}}), flush=True)

        if not timing_only:
            q6_out, held["flightsql_q6"] = check_path_calls(
                "flightsql_q6", lambda: flightsql_q6(client, dev),
                launches["FlightSQL Q6"], k3=True)
            check_q6(q6_out, want)
            (ca, out), held["chunked"] = check_path_calls(
                "chunked", lambda: chunked_filter(hb, keep, dev),
                launches["chunked filter"])
            check_chunked(ca, out, keep)
            print(json.dumps({"flightsql_path_checks": held}), flush=True)
    finally:
        client.close()
        srv.shutdown()
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K3")}
    print(json.dumps({"flightsql_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


EXAMPLE_ROWS = 1 << 20             # orders of the end-to-end demo
EXAMPLE_REGIONS = ["east", "west", "north"]
EXAMPLE_MANAGERS = ["ann", "bo", "chi"]


def _example(name: str):
    """examples/<name>.py of this tree, loaded as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_oracle(rows: int) -> dict:
    """What the end-to-end demo prints over `rows` orders, from numpy:
    order i has region i mod 3 and amount (7 i mod 100) + 0.5; the scan
    keeps amount > 50 and i >= rows // 2; row group 0 is the first
    rows // 4 orders; groups in first-occurrence order; the ranking by
    the sum descending (the sums differ), each region's manager."""
    i = np.arange(rows, dtype=np.int64)
    region = i % 3
    amount = (i * 7) % 100 + 0.5
    keep = (amount > 50) & (i >= rows // 2)
    kr, ka = region[keep], amount[keep]
    _, first = np.unique(kr, return_index=True)
    order = kr[np.sort(first)]
    groups = {"region": [EXAMPLE_REGIONS[r] for r in order],
              "amount_sum": [float(ka[kr == r].sum()) for r in order],
              "amount_count": [int((kr == r).sum()) for r in order],
              "amount_max": [float(ka[kr == r].max()) for r in order]}
    rank = np.argsort(-np.asarray(groups["amount_sum"]), kind="stable")
    ranked = {k: [v[j] for j in rank] for k, v in groups.items()}
    ranked["manager"] = [EXAMPLE_MANAGERS[EXAMPLE_REGIONS.index(r)]
                         for r in ranked["region"]]
    return {"csv_rows": rows, "csv_names": ["order_id", "region", "amount"],
            "row_groups": 4, "scan_rows": int(keep.sum()),
            "device_sum": float(amount[:rows // 4].sum()),
            "device_rows": rows // 4, "group_by": groups, "ranked": ranked,
            "flight": True, "top_region": ranked["region"][0]}


def check_end_to_end(got: dict, want: dict) -> None:
    """Every printed value of the demo exactly the oracle's (the sums are
    of halves, exact in float64 in any order)."""
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"end_to_end {k}: {got[k]!r}, numpy {v!r}")


def distributed_oracle(dq) -> dict:
    """The distributed example's counts at world size 1, from numpy over
    its own data functions."""
    q, s = dq.query_data(1), dq.skew_data(1)
    valid = q["valid"]
    rk_counts = np.bincount(s["rk"], minlength=int(s["rk"].max()) + 1)
    return {"groups": len(np.unique(q["keys"][valid])),
            "pairs": int(valid.sum()),        # a permutation: one match each
            "sorted_rows": int(valid.sum()),
            "sorted_min": int(q["amounts"][valid].min()),
            "sorted_max": int(q["amounts"][valid].max()),
            "skew_groups": len(np.unique(s["zkeys"])),
            "hot_rows": int((s["zkeys"] == 7).sum()),
            "hot_pairs": int(rk_counts[s["zkeys"]].sum()),
            "string_groups": len(set(zip(s["s1"].tolist(),
                                         s["s2"].tolist())))}


def pyarrow_check(batch: HostBatch) -> dict:
    """pyarrow_interop as this machine allows: without pyarrow, the first
    call raises ImportError("pyarrow not available"); with it, the demo's
    ranked batch round-trips through table_to_pyarrow and
    table_from_pyarrow. Either branch asserts."""
    from arrow_go_tpu_torch.interop import pyarrow_interop as px
    if importlib.util.find_spec("pyarrow") is None:
        try:
            px.type_to_pyarrow(dt.int64)
        except ImportError as e:
            if str(e) != "pyarrow not available":
                raise
            return {"pyarrow": None, "first_call": f"ImportError: {e}"}
        raise AssertionError("pyarrow_interop ran without pyarrow")
    table = px.table_to_pyarrow(batch)
    table.validate(full=True)
    back = px.table_from_pyarrow(table)
    if back.to_pydict() != batch.to_pydict() or \
            back.schema != batch.schema:
        raise AssertionError("pyarrow round trip of the ranked batch")
    import pyarrow
    return {"pyarrow": pyarrow.__version__, "rows": table.num_rows,
            "round_trip": True}


def examples_phases(dev, card: str, timing_only: bool = False) -> dict:
    """This slice's paths: examples/torch_end_to_end.main at EXAMPLE_ROWS
    orders on the card in a temporary directory (`end_to_end`: every
    printed value against end_to_end_oracle, each stage's seconds of the
    counted run), examples/torch_distributed_query.run at world size 1
    on one NCCL group (`distributed_example`, its counts against
    distributed_oracle), the pyarrow check of this machine
    (`pyarrow_interop`), and every K1, K2 and K3 call of one more run of
    each example against the plain version (`examples_path_checks`; not
    with `timing_only`). Returns the launch counts and the largest
    kernel - plain difference."""
    t_phase = time.perf_counter()
    e2e = _example("torch_end_to_end")
    dq = _example("torch_distributed_query")
    launches, held = {}, {}
    want = end_to_end_oracle(EXAMPLE_ROWS)
    with tempfile.TemporaryDirectory() as root:
        def demo(run: str):
            os.mkdir(os.path.join(root, run))
            return e2e.main(EXAMPLE_ROWS, dev, os.path.join(root, run))
        t0 = time.perf_counter()
        got, launches["end_to_end"] = run_path(
            "end_to_end", lambda: demo("counted"), ("K1", "K3"))
        ms = (time.perf_counter() - t0) * 1e3
        check_end_to_end(got, want)
        print(json.dumps({"end_to_end": {
            "rows": EXAMPLE_ROWS, "ms": ms,
            "stage_ms": {k: v * 1e3 for k, v in got["stage_s"].items()},
            "scan_rows": got["scan_rows"], "device_sum": got["device_sum"],
            "group_by": got["group_by"], "top_region": got["top_region"],
            "parquet_bytes": got["parquet_bytes"],
            "ipc_bytes": got["ipc_bytes"],
            "launches_per_run": launches["end_to_end"], "card": card,
            "verified": True}}), flush=True)
        if not timing_only:
            again, held["end_to_end"] = check_path_calls(
                "end_to_end", lambda: demo("held"),
                launches["end_to_end"], k3=True)
            check_end_to_end(again, want)

    dwant = distributed_oracle(dq)
    t0 = time.perf_counter()
    dgot, launches["distributed_example"] = run_path(
        "distributed_example", lambda: dq.run(dev), ())
    dms = (time.perf_counter() - t0) * 1e3
    if dgot != dwant:
        raise AssertionError(f"distributed example: {dgot}, numpy {dwant}")
    print(json.dumps({"distributed_example": {
        **dgot, "world_size": 1, "backend": "nccl", "ms": dms,
        "launches_per_run": launches["distributed_example"], "card": card,
        "verified": True}}), flush=True)
    if not timing_only:
        dagain, held["distributed_example"] = check_path_calls(
            "distributed_example", lambda: dq.run(dev),
            launches["distributed_example"])
        if dagain != dwant:
            raise AssertionError("distributed example: the held run differs")
        print(json.dumps({"examples_path_checks": held}), flush=True)

    print(json.dumps({"pyarrow_interop": {
        **pyarrow_check(got["ranked_batch"]), "card": card,
        "verified": True}}), flush=True)
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K2", "K3")}
    print(json.dumps({"examples_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


# ---------------------------------------------------------------------------
# the parquet encodings other writers use, over SF1's lineitem rows
# ---------------------------------------------------------------------------

ENCODINGS_ROWS = LINEITEM_SF1      # rows of the encodings phase (SF1)
US_PER_DAY = 86_400_000_000
TS_US = dt.timestamp("us") if hasattr(dt, "timestamp") else None
BSS, DBP, DBA = "byte_stream_split", "delta_binary_packed", "delta_byte_array"
# each file's columns in encodings other than the writer's default (the
# rest: l_isr PLAIN, l_sdate dictionary-coded)
ENCODING_FILES = {
    "bss_delta": {"l_price": BSS, "l_disc": BSS, "l_qty": BSS,
                  "l_ts": DBP, "l_sday": DBP},
    "flba_bss": {"l_price": BSS, "l_disc": BSS, "l_qty": BSS},
    "flba_delta": {"l_price": DBA, "l_disc": DBA, "l_qty": DBA}}
TS_Q6_COLUMNS = ["l_price", "l_disc", "l_qty", "l_ts"]
DEC_Q6_COLUMNS = ["l_sdate", "l_qty", "l_price", "l_disc"]


def encodings_sources(li, n: int) -> dict:
    """The three files' columns over the first n rows. bss_delta: l_price
    and l_disc (float64), l_qty (int64), l_ts (timestamp[us]: l_sdate's
    day in us plus a seeded offset within the day, so its unsorted
    deltas need miniblocks about 48 bits wide), l_sday (l_sdate as
    int64: the same rows' narrow DELTA column) and l_isr (BOOLEAN,
    l_rflag == "R"); the FLBA files: l_sdate and the money columns as
    DECIMAL(15,2) cents in 16-byte FLBA."""
    sdate = li["l_sdate"][:n]
    codes, values = li["l_rflag"]
    offset = np.random.default_rng(21).integers(0, US_PER_DAY, n)
    a = {"l_price": li["l_price"][:n], "l_disc": li["l_disc"][:n],
         "l_qty": li["l_qty"][:n].astype(np.int64),
         "l_ts": sdate.astype(np.int64) * US_PER_DAY + offset,
         "l_sday": sdate.astype(np.int64),
         "l_isr": codes[:n] == list(values).index("R")}
    cents = money_cents({c: li[c][:n] for c in ("l_price", "l_disc",
                                                "l_tax", "l_qty")})
    fixed = {"l_sdate": sdate, "l_qty": cents["l_qty"],
             "l_price": cents["l_price"], "l_disc": cents["l_disc"]}
    return {"bss_delta": a, "flba_bss": fixed, "flba_delta": fixed}


def encodings_types(name: str) -> dict:
    if name == "bss_delta":
        return {"l_ts": TS_US}
    return {"l_sdate": dt.date32, "l_qty": MONEY128, "l_price": MONEY128,
            "l_disc": MONEY128}


def write_encodings_file(path: str, name: str, table: dict) -> int:
    """One of ENCODING_FILES in the dataset's layout (row groups of
    DATASET_ROWS_PER_GROUP rows, DATASET_PAGE_BYTES pages, zstd level
    DATASET_LEVEL, statistics) in DATA_PAGE_V2 pages; returns its
    bytes."""
    tpq.write_table(table, path, types=encodings_types(name),
                    properties=tpq.WriterProperties(
                        data_page_version="2.0", compression="zstd",
                        compression_level=DATASET_LEVEL,
                        data_page_size=DATASET_PAGE_BYTES,
                        max_row_group_length=DATASET_ROWS_PER_GROUP,
                        column_properties={
                            c: {"encoding": e}
                            for c, e in ENCODING_FILES[name].items()}))
    return os.path.getsize(path)


def file_batches(path: str, dev, columns=None, times=None) -> list:
    """Every row group of a file on the card (read_batch_device)."""
    with tpq.ParquetFile(path) as pf:
        return [tpq.read_batch_device(pf, i, columns, device=dev,
                                      times=times)
                for i in range(pf.num_row_groups)]


def widest_delta(path: str, column: str) -> int:
    """The widest DELTA_BINARY_PACKED miniblock of a column's pages."""
    from arrow_go_tpu_torch.ops import decode as dd
    from arrow_go_tpu_torch.parquet import device_read as tdr
    widest = 0
    with tpq.ParquetFile(path) as pf:
        li_, desc = tdr._leaf_of(pf, column)
        clock = tdr._Clock(None, None)
        for rg in range(pf.num_row_groups):
            chunk = pf.metadata.row_groups[rg].columns[li_]
            for hdr, body in tdr._iter_pages(pf, chunk):
                if hdr.data_page_header_v2 is None:
                    continue
                nv, _, vals, _ = tdr._split_page(
                    hdr, body, desc, chunk.meta_data.codec or 0, clock)
                widest = max(widest, int(dd.parse_delta_segments(vals)[2]
                                         .max()))
    return widest


def check_encodings_scan(what: str, batches: list, table: dict) -> None:
    """Every column of a file's row-group batches equals its source, bit
    for bit (a decimal by its limbs)."""
    row0 = 0
    for db in batches:
        n = db.length
        for c in db.schema.names:
            want = np.asarray(table[c])[row0:row0 + n]
            col = db.column(c)
            if col.type.limbs:
                check_limbs(f"{what} {c}", col, want)
            else:
                _equal(f"{what} {c}", col.values[:n].cpu().numpy(), want)
        row0 += n
    if row0 != len(table["l_price"]):
        raise AssertionError(f"{what}: {row0} rows scanned")


def ts_q6_expression():
    """Q6's WHERE clause with the ship date as l_ts in [the first us of
    1994, the first us of 1995): the same rows as the day range."""
    f, lit, call = pc.field, pc.literal, pc.call
    conds = [call("greater_equal", [f("l_ts"), lit(Q6_DATE_LO * US_PER_DAY)]),
             call("less", [f("l_ts"), lit(Q6_DATE_HI * US_PER_DAY)]),
             call("greater_equal", [f("l_disc"), lit(Q6_DISC_LO)]),
             call("less_equal", [f("l_disc"), lit(Q6_DISC_HI)]),
             call("less", [f("l_qty"), lit(Q6_QTY)])]
    pred = conds[0]
    for c in conds[1:]:
        pred = call("and", [pred, c])
    return pred


def ts_q6(path: str, dev, times=None) -> dict:
    """TPC-H Q6 from a bss_delta file: each row group scanned on the card,
    filtered by ts_q6_expression (K1), l_price * l_disc summed (K3),
    added across row groups."""
    revenue, count = 0.0, 0
    for db in file_batches(path, dev, TS_Q6_COLUMNS, times):
        mask = pc.execute_scalar_expression(ts_q6_expression(), db)
        kept = pc.filter(project(db, ["l_price", "l_disc"]), mask)
        rev = pc.execute_scalar_expression(
            pc.call("multiply", [pc.field("l_price"), pc.field("l_disc")]),
            kept)
        if rev.length:
            revenue += pc.agg_sum(rev)
        count += rev.length
    return {"revenue": revenue, "count": count}


def file_decimal_q6(path: str, dev, times=None) -> list:
    """decimal_q6 from an FLBA file: each row group's product
    column (K1 filter, limb multiply)."""
    return [decimal_q6(db)
            for db in file_batches(path, dev, DEC_Q6_COLUMNS, times)]


def rle_boolean_pages(bits: np.ndarray, dev, rng) -> dict:
    """The l_isr value stream as a BOOLEAN RLE page (a 4-byte length,
    then encodings.rle_encode at width 1) decoded through the device
    read's page plan on the card, without and with a definition-level
    stream that nulls 5% of the rows, held exactly against numpy."""
    from arrow_go_tpu_torch.parquet import device_read as tdr
    from arrow_go_tpu_torch.parquet import encodings as tenc
    from arrow_go_tpu_torch.parquet.schema import ColumnDescriptor
    n = len(bits)
    present = rng.random(n) >= 0.05
    desc = ColumnDescriptor(("l_isr",), tpq.format.Type.BOOLEAN, 0, 1, 0,
                            dt.bool_, [])
    out = {}
    for kind, defs in (("required", None), ("nulls", present)):
        vals = bits if defs is None else bits[defs]
        body = tenc.rle_encode(vals.astype(np.uint32), 1)
        stream = len(body).to_bytes(4, "little") + body
        def_stream = None if defs is None else tenc.rle_encode(
            defs.astype(np.uint32), 1)
        host = {}
        decode = tdr._plan_page((n, def_stream, stream,
                                 tpq.format.Encoding.RLE), desc, np.bool_,
                                False, False, tdr._Stager(dev), host, "p.")
        shipped = tdr._ship(host, dev)
        (got, mask), ms = _sync_ms(lambda: decode(shipped))
        if defs is None:
            if mask is not None:
                raise AssertionError("RLE booleans: a mask without levels")
            _equal("RLE booleans", got.cpu().numpy(), bits)
        else:
            _equal("RLE booleans' validity", mask.cpu().numpy(), defs)
            _equal("RLE booleans under nulls", got.cpu().numpy()[defs],
                   vals)
        out[kind] = {"stream_bytes": len(stream), "decode_ms": ms}
    return out


def pyarrow_encodings(path: str, table: dict) -> dict:
    """bss_delta's rows as pyarrow writes them: data page v2, no
    dictionary, l_price and l_disc BYTE_STREAM_SPLIT, l_ts
    DELTA_BINARY_PACKED, l_isr (pyarrow's v2 default) RLE; the dataset's
    layout. Returns the file's bytes and pyarrow's version."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    cols = {c: table[c] for c in ("l_price", "l_disc", "l_qty", "l_isr")}
    cols["l_ts"] = pa.array(table["l_ts"], pa.timestamp("us"))
    pq.write_table(pa.table(cols), path, data_page_version="2.0",
                   use_dictionary=False, compression="zstd",
                   compression_level=DATASET_LEVEL,
                   row_group_size=DATASET_ROWS_PER_GROUP,
                   data_page_size=DATASET_PAGE_BYTES,
                   use_byte_stream_split=["l_price", "l_disc"],
                   column_encoding={"l_ts": "DELTA_BINARY_PACKED"})
    return {"pyarrow": pa.__version__, "file_bytes": os.path.getsize(path)}


def encodings_phases(li, dev, card: str, timing_only: bool = False) -> dict:
    """This slice's paths over the first ENCODINGS_ROWS rows (SF1's
    lineitem), the files in a temporary directory: `encodings_files`
    (the three ENCODING_FILES written by the port's writer, side by side,
    each page's encodings, l_ts's widest DELTA miniblock, which must pass
    32 bits), `encodings_scan` (each file scanned on the card by
    read_batch_device and held bit for bit against its source, with the
    host-parse / copy / device-decode split, and each bss_delta column's
    device decode alone), `ts_q6` (Q6 from bss_delta with the ship date
    as an l_ts range, its count the date Q6's on the same rows),
    `encodings_decimal_q6` (decimal Q6 from flba_bss and flba_delta),
    `rle_booleans` (rle_boolean_pages; with pyarrow installed also
    bss_delta's rows written by pyarrow, its l_isr pages RLE, scanned bit
    for bit and Q6 from it equal to Q6 from bss_delta) and
    `encodings_path_checks` (every K1 and K3 call of each Q6 against the
    plain version; not with `timing_only`). Returns each path's launch
    counts and the largest kernel - plain difference."""
    t_phase = time.perf_counter()
    stages = {}

    def stage(name):
        """Adds the seconds since the last mark to stages[name]."""
        now = time.perf_counter()
        stages[name] = stages.get(name, 0.0) + now - stage.mark
        stage.mark = now
    stage.mark = t_phase
    n = min(ENCODINGS_ROWS, len(li["l_okey"]))
    tables = encodings_sources(li, n)
    stage("sources_s")
    root_dir = tempfile.TemporaryDirectory()
    paths = {name: os.path.join(root_dir.name, f"{name}.parquet")
             for name in ENCODING_FILES}
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(paths)) as pool:
        nbytes = dict(zip(paths, pool.map(
            lambda name: write_encodings_file(paths[name], name,
                                              tables[name]), paths)))
    write_s = time.perf_counter() - t0
    widest = widest_delta(paths["bss_delta"], "l_ts")
    if widest <= 32:
        raise AssertionError(f"l_ts's widest DELTA miniblock is {widest} "
                             f"bits, not over 32")
    encs = {name: data_page_encodings(p) for name, p in paths.items()}
    for name, want in ENCODING_FILES.items():
        for c, e in want.items():
            if encs[name][c]["order"] != [e.upper()]:
                raise AssertionError(f"{name}.{c}: pages {encs[name][c]}")
    print(json.dumps({"encodings_files": {
        "rows": n, "file_bytes": nbytes, "write_s": write_s,
        "page_encodings": encs, "l_ts_widest_delta_bits": widest,
        "l_sday_widest_delta_bits": widest_delta(paths["bss_delta"],
                                                 "l_sday"),
        "card": card}}), flush=True)
    stage("write_s")

    scans = {}
    for name, p in paths.items():
        times = {}
        t0 = time.perf_counter()
        batches = file_batches(p, dev, None, times)
        times["ms"] = (time.perf_counter() - t0) * 1e3
        check_encodings_scan(name, batches, tables[name])
        del batches
        scans[name] = {k[:-2] + "_ms" if k.endswith("_s") else k: v * 1e3
                       if k.endswith("_s") else v for k, v in times.items()}
    columns = {}
    for c in tables["bss_delta"]:
        times = {}
        file_batches(paths["bss_delta"], dev, [c], times)
        columns[c] = {"decode_ms": times["decode_s"] * 1e3,
                      "parse_ms": times["parse_s"] * 1e3,
                      "encoding": encs["bss_delta"][c]["order"]}
    print(json.dumps({"encodings_scan": {
        "split_ms": scans, "bss_delta_columns": columns, "card": card,
        "verified": True}}), flush=True)
    stage("scan_s")

    launches, checks = {}, {}
    a = tables["bss_delta"]
    q6_want = q6_oracle({"l_sdate": li["l_sdate"][:n], **a})
    got, launches["ts Q6"] = run_path(
        "ts Q6", lambda: ts_q6(paths["bss_delta"], dev), ("K1", "K3"))
    check_q6(got, q6_want)
    times = {}
    again, ms = _sync_ms(lambda: ts_q6(paths["bss_delta"], dev, times))
    if again != got:
        raise AssertionError(f"ts Q6: a run gave {again}, first {got}")
    checks["ts_q6"] = (lambda: ts_q6(paths["bss_delta"], dev),
                       lambda o: check_q6(o, q6_want), "ts Q6")
    print(json.dumps({"ts_q6": {
        **got, "oracle": q6_want, "ms": ms, "split_ms": _ms(times),
        "launches_per_run": launches["ts Q6"], "card": card,
        "verified": True}}), flush=True)
    stage("ts_q6_s")

    fixed = tables["flba_bss"]
    keep = ((fixed["l_sdate"] >= Q6_DATE_LO) & (fixed["l_sdate"] < Q6_DATE_HI)
            & (fixed["l_disc"] >= 5) & (fixed["l_disc"] <= 7)
            & (fixed["l_qty"] < Q6_QTY * 100))
    if int(keep.sum()) != q6_want["count"]:
        raise AssertionError(f"decimal Q6 keeps {int(keep.sum())} rows, "
                             f"ts Q6 {q6_want['count']}")
    q6_check, dec_want = decimal_q6_check(fixed, keep)

    def check_dec(revs):
        rows = [r.length for r in revs]
        if sum(rows) != len(dec_want):
            raise AssertionError(f"decimal Q6: {sum(rows)} rows kept")
        lo = np.concatenate([_limb_ints(r, r.length)[0] for r in revs])
        hi = np.concatenate([_limb_ints(r, r.length)[1] for r in revs])
        for r in revs:
            if str(r.type) != "decimal128(31, 4)":
                raise AssertionError(f"decimal Q6: product type {r.type}")
        _equal("decimal Q6 low limbs", lo, dec_want)
        _equal("decimal Q6 high limbs", hi, dec_want >> 63)
    dec = {}
    for name in ("flba_bss", "flba_delta"):
        key = f"decimal Q6 ({name})"
        revs, launches[key] = run_path(
            key, lambda: file_decimal_q6(paths[name], dev), ("K1",))
        check_dec(revs)
        times = {}
        revs, ms = _sync_ms(lambda: file_decimal_q6(paths[name], dev,
                                                    times))
        check_dec(revs)
        checks[name] = ((lambda p=paths[name]: file_decimal_q6(p, dev)),
                        check_dec, key)
        dec[name] = {"rows_kept": int(keep.sum()), "ms": ms,
                     "split_ms": _ms(times),
                     "launches_per_run": launches[key]}
    print(json.dumps({"encodings_decimal_q6": {
        **dec, "card": card, "verified": True}}), flush=True)
    stage("decimal_q6_s")

    rle = {"pages": rle_boolean_pages(a["l_isr"], dev,
                                      np.random.default_rng(22))}
    stage("rle_pages_s")
    if importlib.util.find_spec("pyarrow") is None:
        rle["pyarrow"] = None
    else:
        ppath = os.path.join(root_dir.name, "pyarrow.parquet")
        rle.update(pyarrow_encodings(ppath, a))
        pencs = data_page_encodings(ppath)
        if [pencs[c]["order"] for c in ("l_isr", "l_ts", "l_price")] != [
                ["RLE"], ["DELTA_BINARY_PACKED"], ["BYTE_STREAM_SPLIT"]]:
            raise AssertionError(f"pyarrow's pages: {pencs}")
        # l_isr's RLE pages bit for bit; Q6 below reads the others
        check_encodings_scan("pyarrow", file_batches(ppath, dev, ["l_isr"]),
                             {c: a[c] for c in ("l_isr", "l_price")})
        pgot, launches["pyarrow ts Q6"] = run_path(
            "pyarrow ts Q6", lambda: ts_q6(ppath, dev), ("K1", "K3"))
        if pgot != got:
            raise AssertionError(f"Q6 from pyarrow's file {pgot}, from "
                                 f"the port's {got}")
        checks["pyarrow_ts_q6"] = (lambda: ts_q6(ppath, dev),
                                   lambda o: check_q6(o, q6_want),
                                   "pyarrow ts Q6")
        rle.update(page_encodings=pencs, q6=pgot,
                   launches_per_run=launches["pyarrow ts Q6"])
    print(json.dumps({"rle_booleans": {
        **rle, "branch": "pyarrow" if rle.get("pyarrow") else
        "page level only", "card": card, "verified": True}}), flush=True)
    stage("pyarrow_s")

    held = {}
    if not timing_only:
        for key, (fn, check, name) in checks.items():
            out, held[key] = check_path_calls(key, fn, launches[name],
                                              k3=True)
            check(out)
        print(json.dumps({"encodings_path_checks": held}), flush=True)
    root_dir.cleanup()
    stage("path_checks_s")
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K3")}
    print(json.dumps({"encodings_phase": {
        "s": time.perf_counter() - t_phase, **stages, "card": card}}),
        flush=True)
    return {"launches": launches, "errs": errs}


ARRAYS_ROWS = LINEITEM_SF1        # rows of the arrays phase (SF1)
ARRAYS_BATCH_ROWS = 1 << 20       # rows a RecordBatch of the Table
ARRAYS_ORDERS = 1 << 20           # orders built through the builders
ARRAYS_NULL_SHARE = 0.01          # o_opri rows appended as nulls
ARRAYS_ODATE = (710, 720)         # the orders' o_odate window
ARRAYS_NUMERIC = {"l_okey": dt.int64, "l_qty": dt.int32,
                  "l_price": dt.float64, "l_disc": dt.float64,
                  "l_tax": dt.float64, "l_sdate": dt.int32}
ARRAYS_FLAGS = ("l_rflag", "l_lstatus")


def string_data(values) -> "object":
    """An ArrayData of a string column of `values` (offsets and data)."""
    from arrow_go_tpu_torch.array.arrays import ArrayData
    from arrow_go_tpu_torch.memory.buffer import Buffer
    raw = [v.encode() for v in values]
    off = np.zeros(len(raw) + 1, np.int32)
    np.cumsum([len(v) for v in raw], out=off[1:])
    return ArrayData(dt.string, len(raw), [None, Buffer.wrap(off),
                                           Buffer.from_bytes(b"".join(raw))])


def lineitem_layouts(li, n: int, rows: int) -> list:
    """{column: ArrayData} a batch of `rows` lineitem rows, its first n:
    the numeric columns as an all-set validity bitmap and their values
    (views of the arrays), the two flags as dictionary layout (int32
    indices, the flag values a string dictionary)."""
    from arrow_go_tpu_torch.array.arrays import ArrayData
    from arrow_go_tpu_torch.memory import bitutil
    from arrow_go_tpu_torch.memory.buffer import Buffer
    valid = Buffer(bitutil.pack_bits(np.ones(rows, np.bool_)))
    dicts = {c: string_data(li[c][1]) for c in ARRAYS_FLAGS}
    out = []
    for a in range(0, n, rows):
        m = min(rows, n - a)
        bits = valid.slice(0, bitutil.bytes_for_bits(m))
        datas = {c: ArrayData(t, m, [bits, Buffer.wrap(li[c][a:a + m])])
                 for c, t in ARRAYS_NUMERIC.items()}
        for c in ARRAYS_FLAGS:
            datas[c] = ArrayData(dt.dictionary(dt.int32, dt.string), m,
                                 [None, Buffer.wrap(li[c][0][a:a + m])],
                                 dictionary=dicts[c])
        out.append(datas)
    return out


def orders_values(orders, m: int):
    """(o_okey, o_odate, o_opri with a seeded ARRAYS_NULL_SHARE of None)
    of the first m orders, as the builders take them."""
    rng = np.random.default_rng(21)
    codes, values = orders["o_opri"]
    pri = values[codes[:m]].tolist()
    for i in np.flatnonzero(rng.random(m) < ARRAYS_NULL_SHARE).tolist():
        pri[i] = None
    return orders["o_okey"][:m], orders["o_odate"][:m], pri


def build_orders(okey, odate, pri) -> dict:
    """The three orders columns through make_builder(...).append_values
    (a None of o_opri goes to append_null)."""
    out = {}
    for name, t, vals in (("o_okey", dt.int64, okey),
                          ("o_odate", dt.date32, odate),
                          ("o_opri", dt.string, pri)):
        b = agt.make_builder(t)
        b.append_values(vals)
        out[name] = b.finish()
    return out


def orders_window(cols: dict, dev) -> dict:
    """o_okey, o_odate and o_opri each `to_device`, then the o_odate
    window's filter (K1): rows kept, and the valid o_opri among them."""
    from arrow_go_tpu_torch.device import to_device
    db = DeviceBatch(dt.Schema([dt.Field(k, a.type)
                                for k, a in cols.items()]),
                     [to_device(a, device=dev) for a in cols.values()],
                     len(cols["o_okey"]))
    f, lit, call = pc.field, pc.literal, pc.call
    mask = pc.execute_scalar_expression(call("and", [
        call("greater_equal", [f("o_odate"), lit(ARRAYS_ODATE[0])]),
        call("less", [f("o_odate"), lit(ARRAYS_ODATE[1])])]), db)
    kept = pc.filter(db, mask)
    return {"kept": kept.length,
            "kept_opri_valid": pc.agg_count(kept.column("o_opri"))}


def arrays_phases(li, orders, dev, card: str,
                  timing_only: bool = False) -> dict:
    """The JAX data-model API on the card, over the first ARRAYS_ROWS
    rows (SF1's lineitem) of the SF10 arrays: the Q6 and Q1 columns as
    ArrayData layouts (lineitem_layouts), `make_array` of each, one
    `RecordBatch.from_arrays` a 1,048,576-row batch, `Table.from_batches`,
    `select`, `combine_chunks` and `to_batches()[0]`; then Q6 (K1, K3)
    and Q1 (K1, group_by) from `batch_to_device` of that batch, exact
    against numpy (`arrays_q6`, `arrays_q1`); `batch_from_device` of
    Q6's columns equal to their source (`arrays_round_trip`); the first
    ARRAYS_ORDERS orders through make_builder(...).append_values (1% of
    o_opri append_null), each column `to_device`, the o_odate window's
    filter (K1) and its count exact against numpy, and
    bitutil.count_set_bits of o_opri's validity equal to the popcount
    of its device words (`arrays_orders`); every K1 and K3 call of the
    three paths against the plain version (`arrays_path_checks`; not
    with `timing_only`). Returns each path's launch counts and the
    largest kernel - plain difference."""
    from arrow_go_tpu_torch.array.arrays import make_array
    from arrow_go_tpu_torch.memory import bitutil
    t_phase = time.perf_counter()
    n = min(ARRAYS_ROWS, len(li["l_okey"]))
    sub = {c: li[c][:n] for c in ARRAYS_NUMERIC}
    sub.update({c: (li[c][0][:n], li[c][1]) for c in ARRAYS_FLAGS})
    layouts = lineitem_layouts(li, n, ARRAYS_BATCH_ROWS)
    stages = {}
    t0 = time.perf_counter()
    arrays = [{c: make_array(d) for c, d in b.items()} for b in layouts]
    stages["make_array_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches = [agt.RecordBatch.from_arrays(list(b.values()), list(b))
               for b in arrays]
    table = agt.Table.from_batches(batches)
    stages["from_batches_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    combined = table.select(Q1_COLUMNS).combine_chunks()
    stages["combine_chunks_s"] = time.perf_counter() - t0
    rb = combined.to_batches()[0]
    if (table.num_rows, combined.column(0).num_chunks, rb.num_rows) != (
            n, 1, n) or table.column("l_price").num_chunks != len(batches):
        raise AssertionError(f"arrays: table of {table.num_rows} rows, "
                             f"batch of {rb.num_rows}")
    print(json.dumps({"arrays_table": {
        "rows": n, "batches": len(batches), "columns": table.schema.names,
        "selected": rb.schema.names,
        "classes": sorted({type(a).__name__ for b in arrays
                           for a in b.values()}), **stages,
        "card": card}}), flush=True)

    launches, checks = {}, {}
    q6_want = q6_oracle(sub)
    q1_want = q1_oracle(sub)
    got, launches["arrays Q6"] = run_path(
        "arrays Q6", lambda: compute_q6(agt.batch_to_device(rb, device=dev)),
        ("K1", "K3"))
    check_q6(got, q6_want)
    db, to_card_ms = _sync_ms(lambda: agt.batch_to_device(rb, device=dev))
    outs, q6_runs = timed(lambda: compute_q6(db))
    for out in outs:
        check_q6(out, q6_want)
    checks["q6"] = (lambda: compute_q6(agt.batch_to_device(rb, device=dev)),
                    lambda o: check_q6(o, q6_want), "arrays Q6")
    print(json.dumps({"arrays_q6": {
        **got, "oracle": q6_want, "to_card_ms": to_card_ms,
        "compute_ms_runs": q6_runs,
        "compute_ms_median": float(np.median(q6_runs)),
        "launches_per_run": launches["arrays Q6"], "card": card,
        "verified": True}}), flush=True)
    out, launches["arrays Q1"] = run_path(
        "arrays Q1", lambda: compute_q1(agt.batch_to_device(rb, device=dev)),
        ("K1",))
    check_q1(out, q1_want)
    out, q1_ms = _sync_ms(lambda: compute_q1(db))
    check_q1(out, q1_want)
    checks["q1"] = (lambda: compute_q1(agt.batch_to_device(rb, device=dev)),
                    lambda o: check_q1(o, q1_want), "arrays Q1")
    print(json.dumps({"arrays_q1": {
        "groups": out.num_rows, "compute_ms": q1_ms,
        "launches_per_run": launches["arrays Q1"], "card": card,
        "verified": True}}), flush=True)

    src = rb.select(Q6_COLUMNS)
    t0 = time.perf_counter()
    back = agt.device.batch_from_device(project(db, Q6_COLUMNS))
    from_card_s = time.perf_counter() - t0
    if not isinstance(back, agt.RecordBatch) or not back.equals(src):
        raise AssertionError("arrays: batch_from_device of Q6's columns "
                             "differs from its source")
    del db
    print(json.dumps({"arrays_round_trip": {
        "rows": back.num_rows, "columns": back.schema.names,
        "from_card_s": from_card_s, "card": card, "equal": True}}),
        flush=True)

    m = min(ARRAYS_ORDERS, len(orders["o_okey"]))
    okey, odate, pri = orders_values(orders, m)
    t0 = time.perf_counter()
    cols = build_orders(okey, odate, pri)
    build_s = time.perf_counter() - t0
    nulls = np.array([p is None for p in pri])
    keep = (odate >= ARRAYS_ODATE[0]) & (odate < ARRAYS_ODATE[1])
    o_want = {"kept": int(keep.sum()),
              "kept_opri_valid": int((keep & ~nulls).sum())}
    if [type(a).__name__ for a in cols.values()] != [
            "NumericArray", "Date32Array", "StringArray"] or \
            cols["o_opri"].null_count != int(nulls.sum()):
        raise AssertionError(f"arrays: built {cols}")

    def check_orders(got):
        if got != o_want:
            raise AssertionError(f"arrays orders: {got}, numpy {o_want}")
    got, launches["arrays orders"] = run_path(
        "arrays orders", lambda: orders_window(cols, dev), ("K1",))
    check_orders(got)
    checks["orders"] = (lambda: orders_window(cols, dev), check_orders,
                        "arrays orders")
    from arrow_go_tpu_torch.device import to_device
    words = to_device(cols["o_opri"], device=dev).validity
    host_bits = bitutil.count_set_bits(cols["o_opri"].data.validity.data,
                                       0, m)
    dev_bits = int(bitmap.popcount_words(words))
    if host_bits != dev_bits or host_bits != m - int(nulls.sum()):
        raise AssertionError(f"arrays: count_set_bits {host_bits}, device "
                             f"popcount {dev_bits}")
    print(json.dumps({"arrays_orders": {
        "rows": m, "nulls": int(nulls.sum()), "build_s": build_s,
        "builder_rows_per_s": 3 * m / build_s, **got,
        "set_bits": host_bits, "launches_per_run": launches["arrays orders"],
        "card": card, "verified": True}}), flush=True)

    held = {}
    if not timing_only:
        for key, (fn, check, name) in checks.items():
            out, held[key] = check_path_calls(name, fn, launches[name],
                                              k3=True)
            check(out)
        print(json.dumps({"arrays_path_checks": held}), flush=True)
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K3")}
    print(json.dumps({"arrays_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


HOSTAPI_ROWS = LINEITEM_SF1       # rows of the host-API phase (SF1)
HOSTAPI_CHUNK_ROWS = 1 << 20      # rows a chunk of its Table's columns
HOSTAPI_TYPES = {"l_okey": dt.int64, "l_price": dt.float64,
                 "l_disc": dt.float64, "l_qty": dt.int32,
                 "l_sdate": dt.date32}
HOSTAPI_SET_SHARE = 0.01          # the is_in value set: 1% of the order keys
HOSTAPI_NULL_SHARE = 0.01         # l_disc rows made null for fill_null
HOSTAPI_ROW_GROUP = 2             # read_row_group(2, row_range=...)
HOSTAPI_ROW_RANGE = (1_000, 50_000)


def hostapi_table(li, n: int):
    """A Table of the first n rows of HOSTAPI_TYPES' columns, each a
    ChunkedArray of HOSTAPI_CHUNK_ROWS-row HostArrays (views of the
    arrays; l_sdate typed date32)."""
    from arrow_go_tpu_torch.array.record import ChunkedArray, Table
    schema = dt.Schema([dt.Field(c, t) for c, t in HOSTAPI_TYPES.items()])
    cols = [ChunkedArray([HostArray(li[c][a:min(a + HOSTAPI_CHUNK_ROWS, n)],
                                    None, t)
                          for a in range(0, n, HOSTAPI_CHUNK_ROWS)], t)
            for c, t in HOSTAPI_TYPES.items()]
    return Table(schema, cols, n)


def hostapi_q6(t) -> dict:
    """TPC-H Q6 in the JAX package's host-API style over a Table (or a
    batch): the predicate from the columns through the compute wrappers,
    `pc.filter` of the whole table, `pc.sum` of `pc.multiply`. Each call
    takes host arrays and moves them to the card itself."""
    sd, disc, qty = (t.column(c) for c in ("l_sdate", "l_disc", "l_qty"))
    mask = pc.and_(pc.and_(pc.and_(pc.and_(
        pc.greater_equal(sd, Q6_DATE_LO), pc.less(sd, Q6_DATE_HI)),
        pc.greater_equal(disc, Q6_DISC_LO)), pc.less_equal(disc, Q6_DISC_HI)),
        pc.less(qty, Q6_QTY))
    kept = pc.filter(t, mask)
    return {"revenue": pc.sum(pc.multiply(kept.column("l_price"),
                                          kept.column("l_disc"))),
            "count": kept.num_rows, "kept_class": type(kept).__name__}


def month_floor_oracle(days: np.ndarray) -> np.ndarray:
    """Each date32 day floored to its month's first day, by numpy."""
    return days.astype("datetime64[D]").astype("datetime64[M]").astype(
        "datetime64[D]").astype(np.int64).astype(np.int32)


def first_occurrence_counts(v: np.ndarray) -> tuple:
    """(distinct values in first-occurrence order, each one's count)."""
    vals, first, counts = np.unique(v, return_index=True, return_counts=True)
    order = np.argsort(first, kind="stable")
    return vals[order], counts[order]


def hostapi_temporal(t) -> dict:
    """floor_temporal of the host l_sdate column by month (a DeviceColumn
    on the card, as the JAX package returns), then `pc.unique` and
    `pc.value_counts` of it brought to the host."""
    from arrow_go_tpu_torch.device import from_device
    months = pc.floor_temporal(t.column("l_sdate"), unit="month")
    hm = from_device(months)
    return {"months": hm, "unique": pc.unique(hm),
            "value_counts": pc.value_counts(hm)}


def check_hostapi_temporal(got: dict, days: np.ndarray) -> int:
    want = month_floor_oracle(days)
    if not np.array_equal(np.asarray(got["months"].values), want):
        raise AssertionError("hostapi: floor_temporal by month differs "
                             "from numpy")
    vals, counts = first_occurrence_counts(want)
    u, vc = got["unique"], got["value_counts"]
    if not isinstance(u, HostArray) or \
            not np.array_equal(np.asarray(u.values), vals):
        raise AssertionError("hostapi: unique of the months differs")
    if not np.array_equal(np.asarray(vc.children[0].values), vals) or \
            not np.array_equal(np.asarray(vc.children[1].values), counts):
        raise AssertionError("hostapi: value_counts of the months differs")
    return len(vals)


def hostapi_lookups(t, value_set: HostArray, disc: HostArray) -> dict:
    """`pc.is_in` of the host l_okey column against a host value set and
    `pc.fill_null` of a host l_disc with nulls: host results."""
    return {"is_in": pc.is_in(t.column("l_okey"), value_set=value_set),
            "fill_null": pc.fill_null(disc, 0.0)}


def check_hostapi_lookups(got: dict, okey: np.ndarray, vs: np.ndarray,
                          disc: np.ndarray, valid: np.ndarray) -> int:
    hit = np.isin(okey, vs)
    isin, filled = got["is_in"], got["fill_null"]
    if not isinstance(isin, HostArray) or isin.mask is not None and \
            not isin.mask.all() or \
            not np.array_equal(np.asarray(isin.values), hit):
        raise AssertionError("hostapi: is_in differs from numpy")
    want = np.where(valid, disc, 0.0)
    if not isinstance(filled, HostArray) or filled.null_count or \
            not np.array_equal(np.asarray(filled.values).view(np.int64),
                               want.view(np.int64)):
        raise AssertionError("hostapi: fill_null differs from numpy")
    return int(hit.sum())


def hostapi_write_read(t, root: str) -> dict:
    """The Table through `ipc.new_stream(...).write_table` and back, Q6 of
    the read batch; the Table through `parquet.write_table` with a
    positional row_group_size and row group HOSTAPI_ROW_GROUP's
    HOSTAPI_ROW_RANGE read back by `read_row_group(row_range=)`."""
    stream = os.path.join(root, "lineitem.arrows")
    times = {}
    t0 = time.perf_counter()
    with open(stream, "wb") as f:
        w = agt.ipc.new_stream(f, t.schema)
        w.write_table(t)
        w.close()
    times["ipc_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(stream, "rb") as f:
        back = agt.ipc.open_stream(f.read()).read_all()
    times["ipc_read_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q6 = hostapi_q6(back)
    times["ipc_q6_s"] = time.perf_counter() - t0
    path = os.path.join(root, "lineitem.parquet")
    t0 = time.perf_counter()
    tpq.write_table(t, path, HOSTAPI_CHUNK_ROWS, compression="none",
                    write_page_index=False)
    times["parquet_write_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pf = tpq.ParquetFile(path)
    rg = pf.read_row_group(HOSTAPI_ROW_GROUP, row_range=HOSTAPI_ROW_RANGE)
    times["row_range_read_s"] = time.perf_counter() - t0
    return {"q6": q6, "row_groups": pf.num_row_groups, "rows": rg,
            "bytes": {"ipc": os.path.getsize(stream),
                      "parquet": os.path.getsize(path)}, **times}


def check_hostapi_rows(rg, sub: dict) -> None:
    """The row_range read equals numpy's slice of each column, bit for
    bit."""
    a = HOSTAPI_ROW_GROUP * HOSTAPI_CHUNK_ROWS + HOSTAPI_ROW_RANGE[0]
    n = HOSTAPI_ROW_RANGE[1]
    if rg.num_rows != n or rg.schema.names != list(HOSTAPI_TYPES):
        raise AssertionError(f"hostapi: row_range read {rg.num_rows} rows "
                             f"of {rg.schema.names}")
    for c in HOSTAPI_TYPES:
        col = rg.column(c)
        want = sub[c][a:a + n]
        got = np.asarray(col.values)[:n]
        if col.null_count or not np.array_equal(
                got.view(f"u{got.dtype.itemsize}"),
                want.view(f"u{want.dtype.itemsize}")):
            raise AssertionError(f"hostapi: row_range column {c} differs")


def hostapi_phases(li, dev, card: str, timing_only: bool = False) -> dict:
    """The JAX package's host API on the card, over the first HOSTAPI_ROWS
    rows (SF1's lineitem) of the SF10 arrays as a Table of ChunkedArrays
    (HOSTAPI_CHUNK_ROWS-row chunks): every call takes host objects and
    the port moves the data to the card itself. Q6 through the compute
    wrappers and `pc.filter` of the Table (K1, K3; `hostapi_q6`);
    floor_temporal by month, then unique and value_counts on the host
    (`hostapi_temporal`); is_in against a seeded 1% value set and
    fill_null of a 1%-null l_disc (`hostapi_lookups`); the Table through
    an IPC stream's write_table and back with Q6 again, and through
    parquet.write_table with a positional row_group_size, one row group
    read back by read_row_group(row_range=) (`hostapi_writers`); each
    exact against numpy (Q6's revenue within check_q6's tolerance), each
    stage driven once by run_path, and every K1 and K3 call of each
    stage held against the plain version (`hostapi_path_checks`; not
    with `timing_only`). Returns each stage's launch counts and the
    largest kernel - plain difference."""
    t_phase = time.perf_counter()
    n = min(HOSTAPI_ROWS, len(li["l_okey"]))
    sub = {c: li[c][:n] for c in HOSTAPI_TYPES}
    t = hostapi_table(li, n)
    rng = np.random.default_rng(24)
    n_keys = int(li["l_okey"].max()) + 1
    vs = np.sort(rng.choice(n_keys, int(n_keys * HOSTAPI_SET_SHARE),
                            replace=False)).astype(np.int64)
    value_set = HostArray(vs, None, dt.int64)
    valid = rng.random(n) >= HOSTAPI_NULL_SHARE
    disc = HostArray(sub["l_disc"], valid, dt.float64)
    launches, checks, stages = {}, {}, {}

    def stage(key, name, fn, check, needs):
        t0 = time.perf_counter()
        out, launches[name] = run_path(name, fn, needs)
        stages[key] = time.perf_counter() - t0
        checked = check(out)
        checks[key] = (fn, check, name)
        return out, checked

    q6_want = q6_oracle(sub)

    def check_q6_table(got):
        if got["kept_class"] != "Table":
            raise AssertionError(f"hostapi: filter of a Table gave a "
                                 f"{got['kept_class']}")
        check_q6(got, q6_want)
    got, _ = stage("q6", "hostapi Q6", lambda: hostapi_q6(t),
                   check_q6_table, ("K1", "K3"))
    print(json.dumps({"hostapi_q6": {
        "rows": n, "chunks": t.column("l_price").num_chunks,
        "revenue": got["revenue"], "count": got["count"],
        "oracle": q6_want, "s": stages["q6"],
        "launches_per_run": launches["hostapi Q6"], "card": card,
        "verified": True}}), flush=True)

    out, months = stage(
        "temporal", "hostapi temporal", lambda: hostapi_temporal(t),
        lambda o: check_hostapi_temporal(o, sub["l_sdate"]), ("K1", "K2"))
    print(json.dumps({"hostapi_temporal": {
        "months": months, "s": stages["temporal"],
        "launches_per_run": launches["hostapi temporal"], "card": card,
        "verified": True}}), flush=True)

    out, hits = stage(
        "lookups", "hostapi lookups",
        lambda: hostapi_lookups(t, value_set, disc),
        lambda o: check_hostapi_lookups(o, sub["l_okey"], vs,
                                        sub["l_disc"], valid), ())
    print(json.dumps({"hostapi_lookups": {
        "value_set": len(vs), "is_in_hits": hits,
        "nulls_filled": int((~valid).sum()), "s": stages["lookups"],
        "launches_per_run": launches["hostapi lookups"], "card": card,
        "verified": True}}), flush=True)

    with tempfile.TemporaryDirectory() as root:
        def check_writers(o):
            if (o["q6"]["count"], o["q6"]["revenue"]) != (
                    got["count"], got["revenue"]):
                raise AssertionError(f"hostapi: Q6 of the IPC read "
                                     f"{o['q6']}, of the Table {got}")
            check_hostapi_rows(o["rows"], sub)
        wr, _ = stage("writers", "hostapi writers",
                      lambda: hostapi_write_read(t, root), check_writers,
                      ("K1", "K3"))
        print(json.dumps({"hostapi_writers": {
            "row_groups": wr["row_groups"], "bytes": wr["bytes"],
            "row_range": [HOSTAPI_ROW_GROUP, *HOSTAPI_ROW_RANGE],
            **{k: v for k, v in wr.items() if k.endswith("_s")},
            "s": stages["writers"],
            "launches_per_run": launches["hostapi writers"], "card": card,
            "verified": True}}), flush=True)

        held = {}
        if not timing_only:
            for key, (fn, check, name) in checks.items():
                if not any(launches[name].values()):
                    continue
                o, held[key] = check_path_calls(name, fn, launches[name],
                                                k3=True)
                check(o)
            print(json.dumps({"hostapi_path_checks": held}), flush=True)
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K2", "K3")}
    print(json.dumps({"hostapi_phase": {
        "s": time.perf_counter() - t_phase, "stages_s": stages,
        "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


def _line_end(text: bytes, rows: int) -> int:
    """The offset just past the header and `rows` lines of csv text."""
    nl = np.flatnonzero(np.frombuffer(text, np.uint8) == 10)
    return int(nl[rows]) + 1


STRINGS_ROWS = LINEITEM_SF1       # lineitem rows of the strings phase (SF1)
STRINGS_ORDERS = 1_500_000        # its orders (TPC-H spec 4.2.5 at SF1)
STRINGS_PYARROW_ROWS = 1 << 16    # rows of the pyarrow import
# TPC-H spec 4.2.3: L_SHIPINSTRUCT's four values, in string order
SHIPINSTRUCTS = np.array(["COLLECT COD", "DELIVER IN PERSON", "NONE",
                          "TAKE BACK RETURN"], dtype=object)
STRINGS_Q12_COLUMNS = ["l_okey", "l_smode", "l_sdate", "l_rdate",
                       "l_cdate"]


def strings_rows(li, orders):
    """SF1's rows of the SF10 arrays, as make_data's dicts: the first
    STRINGS_ROWS lineitem rows, their l_okey taken mod STRINGS_ORDERS so
    that each row's order is one of the first STRINGS_ORDERS orders, and
    l_sinstruct drawn uniform over SHIPINSTRUCTS (seed 25); those
    orders' o_okey and o_opri."""
    n = min(STRINGS_ROWS, len(li["l_okey"]))
    m = min(STRINGS_ORDERS, len(orders["o_okey"]))
    sub = {c: li[c][:n] for c in ("l_sdate", "l_rdate", "l_cdate")}
    sub["l_okey"] = li["l_okey"][:n] % m
    codes, modes = li["l_smode"]
    sub["l_smode"] = (codes[:n], modes)
    sub["l_sinstruct"] = (np.random.default_rng(25).integers(
        0, len(SHIPINSTRUCTS), n).astype(np.int32), SHIPINSTRUCTS)
    pcodes, pvalues = orders["o_opri"]
    return sub, {"o_okey": orders["o_okey"][:m],
                 "o_opri": (pcodes[:m], pvalues)}


STRINGS_TYPES = {"l_smode": (dt.string, "StringArray"),
                 "l_sinstruct": (dt.string, "StringArray"),
                 "o_opri": (dt.string, "StringArray"),
                 "o_opri_dict": (dt.dictionary(dt.int32, dt.string),
                                 "DictionaryArray")}


def strings_tables(sub, ords) -> tuple:
    """The lineitem and orders Tables as a JAX user builds them: `array`
    of numpy object arrays for l_smode and l_sinstruct and of numpy
    arrays for the numbers, `array` of a Python list for o_opri, and
    o_opri again as an explicit dictionary<int32, string> column
    (o_opri_dict). Each string column's type and class are held to the
    JAX package's rules. Returns (lineitem, orders, seconds by
    column)."""
    secs, li_cols, ord_cols = {}, {}, {}
    for c in ("l_okey", "l_sdate", "l_rdate", "l_cdate"):
        li_cols[c] = agt.array(sub[c])
    for c in ("l_smode", "l_sinstruct"):
        codes, values = sub[c]
        obj = values[codes]
        t0 = time.perf_counter()
        li_cols[c] = agt.array(obj)
        secs[c] = time.perf_counter() - t0
    pcodes, pvalues = ords["o_opri"]
    pri = pvalues[pcodes].tolist()
    ord_cols["o_okey"] = agt.array(ords["o_okey"])
    t0 = time.perf_counter()
    ord_cols["o_opri"] = agt.array(pri)
    secs["o_opri"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ord_cols["o_opri_dict"] = agt.array(pri, STRINGS_TYPES["o_opri_dict"][0])
    secs["o_opri_dict"] = time.perf_counter() - t0
    for name, a in {**li_cols, **ord_cols}.items():
        want_t, want_cls = STRINGS_TYPES.get(name, (a.type, type(a).__name__))
        if a.type != want_t or type(a).__name__ != want_cls:
            raise AssertionError(f"strings {name}: {type(a).__name__} of "
                                 f"{a.type}, not {want_cls} of {want_t}")
    d = ord_cols["o_opri_dict"].dictionary
    first = list(dict.fromkeys(pri))
    if type(d).__name__ != "StringArray" or d.to_pylist() != first:
        raise AssertionError(f"strings o_opri_dict: dictionary {d!r}")
    return agt.table(li_cols), agt.table(ord_cols), secs


def strings_q12(li_t, ord_t, dev) -> HostBatch:
    """TPC-H Q12 from the Tables through the public API: batch_to_device
    of each, then compute_q12 (the filter and the hash encodes on K1,
    the join's expansion on K2, group_by)."""
    li_db = agt.batch_to_device(li_t.select(STRINGS_Q12_COLUMNS), device=dev)
    ord_db = agt.batch_to_device(ord_t.select(["o_okey", "o_opri"]),
                                 device=dev)
    return compute_q12(li_db, ord_db)


def check_strings_q12(out, want: dict) -> None:
    """Q12's counts exactly as `want`, its l_smode key the DictionaryArray
    (with an Array dictionary) the JAX from_device gives."""
    key = out.column("l_smode")
    if type(key).__name__ != "DictionaryArray" or \
            type(key.dictionary).__name__ != "StringArray":
        raise AssertionError(f"strings Q12: key {type(key).__name__} "
                             f"of {key.type}")
    got = {c: out.column(c).to_pylist()
           for c in ("l_smode", "high_sum", "low_sum")}
    if got != want:
        raise AssertionError(f"strings Q12: {got}, want {want}")


def _same_strings(what: str, got, src) -> None:
    """A read column equal to its source, value for value (a coded
    column by the values its codes name)."""
    if got.dict_values is None:
        same = np.array_equal(got.values, src.values)
    else:
        same = np.array_equal(got.dict_values[got.values],
                              src.dict_values[src.values])
    if len(got) != len(src) or not same:
        raise AssertionError(f"strings {what}: the values differ")


def strings_files(tables: dict, root: str, dev) -> dict:
    """Each Table through an IPC stream (write_table, read_all) and
    through parquet.write_table with the JAX defaults (snappy, page
    index; v1 dictionary pages PLAIN_DICTIONARY) and read_table on
    `dev`: each read a Table, its fields typed as the JAX readers give
    them (a dictionary field kept by IPC, utf8 from parquet), each
    column equal to its source. Returns seconds and bytes."""
    out = {}
    for name, t in tables.items():
        src = one_batch(t)
        sink = io.BytesIO()
        t0 = time.perf_counter()
        with agt.ipc.new_stream(sink, t.schema) as w:
            w.write_table(t)
        back = agt.ipc.open_stream(sink.getvalue()).read_all()
        out[f"{name}_ipc_s"] = time.perf_counter() - t0
        out[f"{name}_ipc_bytes"] = len(sink.getvalue())
        if type(back).__name__ != "Table" or back.schema != t.schema:
            raise AssertionError(f"strings {name} ipc: {back.schema}")
        got = one_batch(back)
        for f in t.schema.fields:
            c = got.column(f.name)
            if type(c).__name__ != type(src.column(f.name)).__name__:
                raise AssertionError(f"strings {name} ipc {f.name}: "
                                     f"{type(c).__name__}")
            _same_strings(f"{name} ipc {f.name}", c, src.column(f.name))
        path = os.path.join(root, f"{name}.parquet")
        t0 = time.perf_counter()
        tpq.write_table(t, path)
        out[f"{name}_parquet_write_s"] = time.perf_counter() - t0
        out[f"{name}_parquet_bytes"] = os.path.getsize(path)
        with tpq.ParquetFile(path) as pf:
            for ch in pf.metadata.row_groups[0].columns:
                encs = {tpq.format.Encoding(e).name
                        for e in ch.meta_data.encodings}
                if ch.meta_data.codec != tpq.format.Codec.SNAPPY or \
                        ch.column_index_offset is None or \
                        "RLE_DICTIONARY" in encs:
                    raise AssertionError(f"strings {name} parquet: "
                                         f"{ch.meta_data}")
        t0 = time.perf_counter()
        back = tpq.read_table(path, device=dev)
        out[f"{name}_parquet_read_s"] = time.perf_counter() - t0
        want = [dt.Field(f.name, f.type.value_type
                         if f.type.id == dt.TypeId.DICTIONARY else f.type,
                         f.nullable) for f in t.schema.fields]
        if type(back).__name__ != "Table" or \
                [(f.name, f.type) for f in back.schema.fields] != \
                [(f.name, f.type) for f in want] or \
                type(back.column(0)).__name__ != "ChunkedArray":
            raise AssertionError(f"strings {name} parquet: {back.schema}")
        got = one_batch(back)
        for f in t.schema.fields:
            _same_strings(f"{name} parquet {f.name}", got.column(f.name),
                          src.column(f.name))
    return out


def strings_pyarrow(sub) -> dict:
    """pyarrow's string and dictionary arrays of the first
    STRINGS_PYARROW_ROWS ship modes imported (`string`, a StringArray;
    dictionary<int32, string>, a DictionaryArray) and exported back.
    Fails, where pyarrow is missing, as any phase fails."""
    import pyarrow as pa
    from arrow_go_tpu_torch.interop.pyarrow_interop import (
        array_from_pyarrow, array_to_pyarrow)
    codes, modes = sub["l_smode"]
    vals = modes[codes[:STRINGS_PYARROW_ROWS]].tolist()
    t0 = time.perf_counter()
    for parr, t, cls in (
            (pa.array(vals, pa.string()), dt.string, "StringArray"),
            (pa.array(vals, pa.string()).dictionary_encode(),
             dt.dictionary(dt.int32, dt.string), "DictionaryArray")):
        a = array_from_pyarrow(parr)
        if a.type != t or type(a).__name__ != cls:
            raise AssertionError(f"strings pyarrow: {type(a).__name__} of "
                                 f"{a.type} from {parr.type}")
        back = array_to_pyarrow(a)
        if back.type != parr.type or back.to_pylist() != vals:
            raise AssertionError(f"strings pyarrow: {back.type} back")
    return {"pyarrow": pa.__version__, "rows": len(vals),
            "s": time.perf_counter() - t0}


def strings_phases(li, orders, dev, card: str,
                   timing_only: bool = False) -> dict:
    """The JAX string and dictionary arrays on the card, over SF1's rows
    of the SF10 arrays (strings_rows): the Tables built as a JAX user
    builds them (strings_tables: each string column's type and class
    held), TPC-H Q12 from them through batch_to_device (K1, K2; its key
    the DictionaryArray from_device gives), exact against numpy and
    against compute_q12 of the same rows given as numpy codes
    (`strings_q12`); batch_from_device of the two string columns,
    StringArrays over the codes they left with (`strings_round_trip`);
    the Tables through IPC and parquet with the JAX writer defaults in a
    temporary directory (`strings_files`); pyarrow's string and
    dictionary arrays imported (`strings_pyarrow`); every K1 and K2 call
    of Q12 held against the plain version (`strings_path_checks`; not
    with `timing_only`). Returns the path's launch counts and the
    largest kernel - plain difference."""
    t_phase = time.perf_counter()
    sub, ords = strings_rows(li, orders)
    t0 = time.perf_counter()
    li_t, ord_t, col_s = strings_tables(sub, ords)
    build_s = time.perf_counter() - t0
    print(json.dumps({"strings_tables": {
        "lineitem_rows": li_t.num_rows, "orders_rows": ord_t.num_rows,
        "types": {f.name: str(f.type) for t in (li_t, ord_t)
                  for f in t.schema.fields if f.name in STRINGS_TYPES},
        "build_s": build_s, "array_s": col_s, "card": card}}), flush=True)

    want = q12_oracle(sub, ords)
    launches = {}
    out, launches["strings Q12"] = run_path(
        "strings Q12", lambda: strings_q12(li_t, ord_t, dev), ("K1", "K2"))
    check_strings_q12(out, want)
    out, q12_ms = _sync_ms(lambda: strings_q12(li_t, ord_t, dev))
    check_strings_q12(out, want)
    ref = compute_q12(
        agt.batch_to_device({c: sub[c] for c in STRINGS_Q12_COLUMNS},
                            device=dev),
        agt.batch_to_device({"o_okey": ords["o_okey"],
                             "o_opri": ords["o_opri"]}, device=dev))
    check_strings_q12(ref, want)
    print(json.dumps({"strings_q12": {
        **want, "ms": q12_ms, "launches_per_run": launches["strings Q12"],
        "key_class": type(out.column("l_smode")).__name__,
        "equals_numpy_codes_q12": True, "card": card, "verified": True}}),
        flush=True)

    src = one_batch(li_t.select(["l_smode", "l_sinstruct"]))
    t0 = time.perf_counter()
    back = agt.device.batch_from_device(agt.batch_to_device(src, device=dev))
    trip_s = time.perf_counter() - t0
    for f in src.schema.fields:
        a, b = back.column(f.name), src.column(f.name)
        if type(a).__name__ != "StringArray" or a.type != dt.string or \
                not np.array_equal(a.values, b.values) or \
                a.dict_values is not b.dict_values:
            raise AssertionError(f"strings round trip {f.name}: "
                                 f"{type(a).__name__} of {a.type}")
    print(json.dumps({"strings_round_trip": {
        "rows": back.num_rows, "s": trip_s, "card": card,
        "equal": True}}), flush=True)

    with tempfile.TemporaryDirectory() as root:
        files = strings_files({"lineitem": li_t, "orders": ord_t}, root, dev)
    print(json.dumps({"strings_files": {**files, "card": card,
                                        "verified": True}}), flush=True)
    print(json.dumps({"strings_pyarrow": strings_pyarrow(sub)}), flush=True)

    held = {}
    if not timing_only:
        out, held["q12"] = check_path_calls(
            "strings Q12", lambda: strings_q12(li_t, ord_t, dev),
            launches["strings Q12"])
        check_strings_q12(out, want)
        print(json.dumps({"strings_path_checks": held}), flush=True)
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K2")}
    print(json.dumps({"strings_phase": {
        "s": time.perf_counter() - t_phase, "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


# ---------------------------------------------------------------------------
# the repaired parity faults F15-F22 on the card
# ---------------------------------------------------------------------------

REPAIRS_ROWS = LINEITEM_SF1       # lineitem rows of the repairs phase (SF1)
REPAIRS_ORDERS = 1_500_000        # orders rows (SF1)
REPAIRS_ROW_GROUP = 1_048_576     # rows a parquet row group: six chunks
REPAIRS_CUTOFF = 10_000           # if_else: l_qty where l_sdate > it
REPAIRS_KEYS = [("l_okey", "descending"), ("l_sdate", "ascending")]


def repairs_tables(li, orders, root: str) -> tuple:
    """SF1's lineitem (l_okey, l_sdate as date32, l_qty as int64,
    l_price) and orders (o_okey, o_opri as a string column) written by
    parquet.write_table into `root` in REPAIRS_ROW_GROUP-row groups and
    read back on the card by parquet.read_table: Tables of six and two
    chunks, as a user reads them. Returns (lineitem, orders, sources,
    seconds)."""
    n = min(REPAIRS_ROWS, len(li["l_okey"]))
    m = min(REPAIRS_ORDERS, len(orders["o_okey"]))
    src = {"l_okey": li["l_okey"][:n], "l_sdate": li["l_sdate"][:n],
           "l_qty": li["l_qty"][:n].astype(np.int64),
           "l_price": li["l_price"][:n]}
    pcodes, pvalues = orders["o_opri"]
    li_t = agt.table({"l_okey": src["l_okey"],
                      "l_sdate": HostArray(src["l_sdate"], None, dt.date32),
                      "l_qty": src["l_qty"], "l_price": src["l_price"]})
    ord_t = agt.table({"o_okey": orders["o_okey"][:m],
                       "o_opri": HostArray(pcodes[:m], None, dt.string,
                                           pvalues)})
    secs, back = {}, {}
    for name, t in (("lineitem", li_t), ("orders", ord_t)):
        path = os.path.join(root, f"{name}.parquet")
        t0 = time.perf_counter()
        tpq.write_table(t, path, REPAIRS_ROW_GROUP, compression="none",
                        write_page_index=False)
        secs[f"{name}_write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back[name] = tpq.read_table(path)
        secs[f"{name}_read_s"] = time.perf_counter() - t0
    src["o_opri"] = pvalues[pcodes[:m]]
    return back["lineitem"], back["orders"], src, secs


def repairs_sort_options():
    return pc.SortOptions([pc.SortKey(c, o) for c, o in REPAIRS_KEYS])


def repairs_sort_oracle(src: dict) -> dict:
    """np.lexsort's order of the lineitem rows (l_okey descending, then
    l_sdate, stable) and each column taken by it."""
    order = np.lexsort((src["l_sdate"], -src["l_okey"])).astype(np.int64)
    return {"order": order, **{c: src[c][order] for c in (
        "l_okey", "l_sdate", "l_qty", "l_price")}}


def check_repairs_sort(idx, table, want: dict) -> np.ndarray:
    """F15: sort_indices of the Table bit for bit against np.lexsort, and
    the sorted Table's columns numpy's take by that order."""
    got = np.asarray(idx.values)
    if type(idx).__name__ != "NumericArray" or not np.array_equal(
            got, want["order"]):
        raise AssertionError(f"repairs: sort_indices of the Table differs "
                             f"from np.lexsort ({type(idx).__name__})")
    if type(table).__name__ != "Table" or \
            table.num_rows != len(want["order"]):
        raise AssertionError(f"repairs: sort of a Table gave a "
                             f"{type(table).__name__}")
    for c in ("l_okey", "l_sdate", "l_qty", "l_price"):
        col = np.asarray(table.column(c).combine().values)
        if not np.array_equal(col, want[c]):
            raise AssertionError(f"repairs: sorted column {c} differs")
    return want["order"]


def check_repairs_struct(st, src: dict) -> str:
    """F16: make_struct of two ChunkedArray columns, each child its
    source column."""
    if type(st).__name__ != "StructArray" or len(st) != len(src["l_okey"]):
        raise AssertionError(f"repairs: make_struct gave "
                             f"{type(st).__name__}")
    for child, c in zip(st.children, ("l_okey", "l_sdate")):
        if not np.array_equal(np.asarray(child.values), src[c]):
            raise AssertionError(f"repairs: make_struct child {c} differs")
    return str(st.type)


def check_repairs_unique(u, src: dict) -> list:
    """F17: the registry's unique of the string column is a utf8
    StringArray of the distinct values in first-occurrence order."""
    vals, first = np.unique(src["o_opri"], return_index=True)
    want = vals[np.argsort(first, kind="stable")].tolist()
    if type(u).__name__ != "StringArray" or u.type != dt.string or \
            u.to_pylist() != want:
        raise AssertionError(f"repairs: unique gave {type(u).__name__} of "
                             f"{u.type}: {u.to_pylist()[:8]}")
    return want


def repairs_if_else_sum(db: DeviceBatch) -> dict:
    """F22: if_else(l_sdate > REPAIRS_CUTOFF, l_qty int64, l_price float64)
    on the card, its storage asserted to be the int64 of its type, and
    its sum (K3)."""
    mask = pc.call_function("greater", [db.column("l_sdate"),
                                        REPAIRS_CUTOFF])
    picked = pc.if_else(mask, db.column("l_qty"), db.column("l_price"))
    agt.device.block.check_storage(picked)
    if picked.type != dt.int64 or picked.values.dtype != torch.int64:
        raise AssertionError(f"repairs: if_else gave {picked.type} held "
                             f"as {picked.values.dtype}")
    return {"sum": pc.sum(picked), "type": str(picked.type),
            "storage": str(picked.values.dtype)}


def repairs_phases(li, orders, dev, card: str,
                   timing_only: bool = False) -> dict:
    """The repaired parity faults on the card, over SF1's rows of the
    SF10 arrays (repairs_tables: written to parquet in a temporary
    directory, read back as Tables of six and two chunks): F15
    sort_indices of the lineitem Table by (l_okey descending, l_sdate),
    bit for bit against np.lexsort, and `sort` of it, a Table
    (`repairs_sort`); F16 make_struct of two of its ChunkedArray columns
    (`repairs_struct`); F17 call_function("unique") of the orders
    Table's o_opri strings, a utf8 StringArray equal to numpy's
    first-occurrence values (`repairs_unique`); F22 the sum (K3) of
    if_else(l_sdate > cutoff, l_qty int64, l_price float64) on the card,
    held against numpy's truncating astype, its storage int64
    (`repairs_if_else_sum`); every K1, K2 and K3 call of each stage
    against the plain version (`repairs_path_checks`; not with
    `timing_only`). Each stage is driven once by run_path and timed
    once more. Returns each stage's launch counts and the largest
    kernel - plain difference."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        li_t, ord_t, src, io_s = repairs_tables(li, orders, root)
    chunks = li_t.column("l_okey").num_chunks
    print(json.dumps({"repairs_tables": {
        "lineitem_rows": li_t.num_rows, "orders_rows": ord_t.num_rows,
        "lineitem_chunks": chunks,
        "orders_chunks": ord_t.column("o_opri").num_chunks, **io_s,
        "card": card}}), flush=True)
    db = agt.batch_to_device(li_t.select(["l_sdate", "l_qty", "l_price"]),
                             device=dev)
    pick = np.where(src["l_sdate"] > REPAIRS_CUTOFF, src["l_qty"],
                    src["l_price"].astype(np.int64))
    sum_want = int(pick.sum())
    sort_want = repairs_sort_oracle(src)
    launches, checks, ms = {}, {}, {}

    def stage(key, name, fn, check, needs=()):
        out, launches[name] = run_path(name, fn, needs)
        checked = check(out)
        out, ms[key] = _sync_ms(fn)
        check(out)
        checks[key] = (fn, check, name)
        return checked

    order = stage("sort", "repairs sort", lambda: (
        pc.sort_indices(li_t, repairs_sort_options()),
        pc.sort(li_t, repairs_sort_options())),
        lambda o: check_repairs_sort(o[0], o[1], sort_want))
    print(json.dumps({"repairs_sort": {
        "rows": li_t.num_rows, "chunks": chunks, "keys": REPAIRS_KEYS,
        "first": int(order[0]), "ms": ms["sort"],
        "launches_per_run": launches["repairs sort"], "card": card,
        "verified": True}}), flush=True)
    st = stage("struct", "repairs struct", lambda: pc.make_struct(
        li_t.column("l_okey"), li_t.column("l_sdate")),
        lambda o: check_repairs_struct(o, src))
    print(json.dumps({"repairs_struct": {
        "type": st, "ms": ms["struct"],
        "launches_per_run": launches["repairs struct"], "card": card,
        "verified": True}}), flush=True)
    uniq = stage("unique", "repairs unique", lambda: pc.call_function(
        "unique", [ord_t.column("o_opri")]),
        lambda o: check_repairs_unique(o, src))
    print(json.dumps({"repairs_unique": {
        "rows": ord_t.num_rows, "values": uniq, "ms": ms["unique"],
        "launches_per_run": launches["repairs unique"], "card": card,
        "verified": True}}), flush=True)

    def check_sum(o):
        if o["sum"] != sum_want:
            raise AssertionError(f"repairs: sum of if_else {o['sum']}, "
                                 f"numpy {sum_want}")
        return o
    got = stage("if_else_sum", "repairs if_else sum",
                lambda: repairs_if_else_sum(db), check_sum, ("K3",))
    print(json.dumps({"repairs_if_else_sum": {
        **got, "oracle": sum_want, "cutoff": REPAIRS_CUTOFF,
        "ms": ms["if_else_sum"],
        "launches_per_run": launches["repairs if_else sum"], "card": card,
        "verified": True}}), flush=True)

    held = {}
    if not timing_only:
        for key, (fn, check, name) in checks.items():
            if not any(launches[name].values()):
                continue
            o, held[key] = check_path_calls(name, fn, launches[name],
                                            k3=True)
            check(o)
        print(json.dumps({"repairs_path_checks": held}), flush=True)
    errs = {k: max((h[k]["max_abs_err"] for h in held.values() if k in h),
                   default=0.0) for k in ("K1", "K2", "K3")}
    print(json.dumps({"repairs_phase": {
        "s": time.perf_counter() - t_phase, "stages_ms": ms,
        "card": card}}), flush=True)
    return {"launches": launches, "errs": errs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor of the data (default 10)")
    ap.add_argument("--timing-only", action="store_true",
                    help="skip the kernel sweeps (phase 3) and the final "
                         "kernels and ok lines: a run that times every "
                         "path and kernel shape, for comparing two trees "
                         "in turns on one card")
    ap.add_argument("--only", choices=["flight", "flightsql", "examples",
                                       "encodings", "arrays", "hostapi",
                                       "strings", "repairs"],
                    help="run only this phase, on the data of --sf, after "
                         "the build: no kernel sweeps, no other phase, "
                         "and neither the kernels nor the ok line")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = _nvidia_smi()
    print(f"card: {card}", flush=True)
    t_start = time.perf_counter()

    sources = ["compaction", "scan", "reduce"]
    t_build = cuda_build.build(sources)
    print(f"build: {t_build:.1f} s (nvcc, sm_90a)", flush=True)
    _print_ptxas(sources)
    # the host codecs (csrc/codecs.cc; older trees have none)
    if importlib.util.find_spec("arrow_go_tpu_torch.native"):
        from arrow_go_tpu_torch import native
        t0 = time.perf_counter()
        print(f"build: {native.build().name} in "
              f"{time.perf_counter() - t0:.1f} s (g++)", flush=True)

    n_li = LINEITEM_SF10 if args.sf == 10 else int(round(LINEITEM_SF1
                                                         * args.sf))
    n_ord = n_li // 4
    if args.only == "examples":
        out = examples_phases(dev, card)
    elif args.only == "arrays":
        li, orders = make_data(n_li, n_ord)
        add_quantity(li)
        add_q1_columns(li)
        add_join_columns(li, orders)
        out = arrays_phases(li, orders, dev, card)
    elif args.only == "hostapi":
        li, _ = make_data(n_li, n_ord)
        add_quantity(li)
        out = hostapi_phases(li, dev, card)
    elif args.only == "strings":
        li, orders = make_data(n_li, n_ord)
        add_join_columns(li, orders)
        out = strings_phases(li, orders, dev, card)
    elif args.only == "repairs":
        li, orders = make_data(n_li, n_ord)
        add_quantity(li)
        add_join_columns(li, orders)
        out = repairs_phases(li, orders, dev, card)
    elif args.only == "encodings":
        li, _ = make_data(n_li, n_ord)
        add_quantity(li)
        add_q1_columns(li)
        out = encodings_phases(li, dev, card)
    elif args.only:
        li, _ = make_data(n_li, n_ord)
        add_quantity(li)
        phase = flight_phases if args.only == "flight" else flightsql_phases
        out = phase(li, dev, card)
    if args.only:
        print(json.dumps({f"{args.only}_only": {
            "launches": out["launches"], "max_abs_err": out["errs"]}}))
        print(f"total: {time.perf_counter() - t_start:.1f} s "
              f"({args.only} only)")
        return 0

    if args.timing_only:
        k1_err = k2_err = k3_err = 0.0
    else:
        k1_err = check_k1(dev)
        k2_err = check_k2(dev)
        k3_err = check_k3(dev)

    t0 = time.perf_counter()
    li, orders = make_data(n_li, n_ord)
    li_db = agt.batch_to_device(li, device=dev)
    ord_db = agt.batch_to_device(orders, device=dev)
    oracle = q3_oracle(li, orders, CUTOFF)
    torch.cuda.synchronize()
    print(f"q3 data: {n_li} lineitem rows, {n_ord} orders, padded "
          f"{li_db.padded}/{ord_db.padded}, set-up "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # device-resident Q3: counts from 0, one run, counts read after it
    torch.cuda.reset_peak_memory_stats()
    out, launches = run_path("Q3", lambda: compute_q3(li_db, ord_db, CUTOFF),
                             ("K1", "K2"))
    check_q3(out, oracle)
    outs, runs = timed(lambda: compute_q3(li_db, ord_db, CUTOFF))
    for out in outs:
        check_q3(out, oracle)
    med = float(np.median(runs))
    peak = torch.cuda.max_memory_allocated()
    n_joined = int(sum(out.column("rev_count").to_pylist()))
    print(json.dumps({"q3": {
        "sf": args.sf, "lineitem_rows": n_li, "orders_rows": n_ord,
        "joined_rows": n_joined, "groups": out.num_rows,
        "ms_runs": runs, "ms_median": med, "rows_per_s": n_li / med * 1e3,
        "peak_mem_bytes": peak, "launches_per_run": launches,
        "verified": True}}), flush=True)
    print(json.dumps({"q3_profile": profile_q3(li_db, ord_db, oracle)}),
          flush=True)
    # K1 at each of its Q3 shapes, on the inputs one Q3 run hands it
    out, calls = capture_k1(lambda: compute_q3(li_db, ord_db, CUTOFF))
    check_q3(out, oracle)
    if len(calls) != launches["K1"]:
        raise AssertionError(f"captured {len(calls)} K1 calls of Q3, "
                             f"counted {launches['K1']}")
    k1s = time_k1(calls)
    del calls
    print_k1_shapes("k1_shapes", k1s)
    P_li = li_db.padded
    cap = agt.pad_length(n_joined)
    del li_db, ord_db

    # the same tables as parquet bytes, written by the port's writer
    add_quantity(li)
    t0, file_s = time.perf_counter(), {}
    blobs = write_parquets({"lineitem": (li,), "orders": (orders,)}, file_s)
    write_s = time.perf_counter() - t0
    encodings = {}
    for tname, blob in blobs.items():
        pf = tpq.ParquetFile(blob)
        for c in pf.metadata.row_groups[0].columns:
            encodings[f"{tname}.{c.meta_data.path_in_schema[0]}"] = [
                tpq.format.Encoding(e).name for e in c.meta_data.encodings]
    print(json.dumps({"parquet": {
        "write_s": write_s, "write_file_s": file_s,
        "bytes": {k: len(b) for k, b in blobs.items()},
        "encodings": encodings}}), flush=True)

    # scan: both files, every column, three runs with the phase split
    sources = {"lineitem": li, "orders": orders}
    print(json.dumps({"scan": time_scan(blobs, dev, sources)}), flush=True)

    # Q6 from parquet bytes
    q6_cols = ["l_price", "l_disc", "l_sdate", "l_qty"]
    q6_want = q6_oracle(li)

    def q6_from_bytes():
        return compute_q6(scan_parquet(blobs["lineitem"], q6_cols, dev))
    got, q6_launches = run_path("Q6", q6_from_bytes, ("K1", "K3"))
    check_q6(got, q6_want)
    li_q6 = scan_parquet(blobs["lineitem"], q6_cols, dev)
    k3_err = max(k3_err, check_k3_at("Q6", [(q6_revenue(li_q6), "sum")]))
    outs, compute_runs = timed(lambda: compute_q6(li_q6))
    del li_q6
    outs_e2e, e2e_runs = timed(q6_from_bytes)
    for out in outs + outs_e2e:
        check_q6(out, q6_want)
    print(json.dumps({"q6": {
        **got, "oracle": q6_want, "selectivity": got["count"] / n_li,
        "compute_ms_runs": compute_runs,
        "compute_ms_median": float(np.median(compute_runs)),
        "from_bytes_ms_runs": e2e_runs,
        "from_bytes_ms_median": float(np.median(e2e_runs)),
        "launches_per_run": q6_launches, "verified": True}}), flush=True)
    print(json.dumps({"q6_from_bytes_profile": profile_device(
        q6_from_bytes, lambda out: check_q6(out, q6_want), top=8)}),
        flush=True)

    # the lineitem summary aggregates from parquet bytes
    sum_want = summary_oracle(li)
    got, sum_launches = run_path(
        "summary", lambda: compute_summary(scan_parquet(
            blobs["lineitem"], SUMMARY_COLUMNS, dev)), ("K3",))
    check_summary(got, sum_want)
    li_sum = scan_parquet(blobs["lineitem"], SUMMARY_COLUMNS, dev)
    k3_err = max(k3_err, check_k3_at("summary", summary_reductions(li_sum)))
    outs, sum_runs = timed(lambda: compute_summary(li_sum))
    del li_sum
    for out in outs:
        check_summary(out, sum_want)
    print(json.dumps({"summary": {
        **got, "compute_ms_runs": sum_runs,
        "compute_ms_median": float(np.median(sum_runs)),
        "launches_per_run": sum_launches, "verified": True}}), flush=True)

    # Q3 from parquet bytes
    def q3_from_bytes():
        return compute_q3(
            scan_parquet(blobs["lineitem"],
                         ["l_okey", "l_price", "l_disc", "l_sdate"], dev),
            scan_parquet(blobs["orders"], None, dev), CUTOFF)
    out, q3b_launches = run_path("Q3 from bytes", q3_from_bytes,
                                 ("K1", "K2"))
    check_q3(out, oracle)
    outs, runs = timed(q3_from_bytes)
    for out in outs:
        check_q3(out, oracle)
    print(json.dumps({"q3_from_bytes": {
        "ms_runs": runs, "ms_median": float(np.median(runs)),
        "launches_per_run": q3b_launches, "verified": True}}), flush=True)

    k1 = next(t for t in k1s if t["site"] == "filter_with_payload")
    k2 = time_k2(dev, cap, n_joined)
    k3s = time_k3(dev, P_li, n_li)
    for name, t in [("K2", k2)] + [("K3", t) for t in k3s]:
        print(f"{name} at {t['shape']}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms")
    print(json.dumps({"k2_k3_timed": [k2] + k3s}), flush=True)
    # (an older tree, run with --timing-only, has no Q1 entry points)
    q1 = q1_phases(li, orders, dev) if hasattr(pc, "SortOptions") else None
    # (an older tree may have no join entry points and no temporal types)
    typed = hasattr(pc, "floor_temporal") and q1 is not None
    if args.timing_only:
        if hasattr(pc, "hash_join") and q1 is not None:
            join_phases(li, orders, dev, q1["snappy"], card, timing_only=True)
        if typed:
            typed_phases(li, q1["snappy"], dev, card, timing_only=True)
        if typed and MONEY128 is not None:
            decimal_phases(li, dev, card, q6_want["count"],
                           timing_only=True)
        if importlib.util.find_spec("arrow_go_tpu_torch.dataset"):
            dataset_phases(li, orders, dev, card, timing_only=True)
        if importlib.util.find_spec("arrow_go_tpu_torch.parallel.api"):
            dist_phases(_rows(li, 0, DIST_ROWS), orders, dev, card,
                        timing_only=True)
        if hasattr(agt, "list_take_device"):
            nested_phases(li, orders, dev, card, timing_only=True)
        if importlib.util.find_spec("arrow_go_tpu_torch.formats") and \
                "o_opri" in orders:
            formats_phases(li, orders, dev, card, timing_only=True)
        if importlib.util.find_spec("arrow_go_tpu_torch.cdata") and \
                "o_opri" in orders:
            interop_phases(li, orders, dev, card, timing_only=True)
        if importlib.util.find_spec("arrow_go_tpu_torch.parquet.keytools"):
            encryption_phases(li, dev, card, timing_only=True)
        if importlib.util.find_spec("arrow_go_tpu_torch.flight"):
            flight_phases(li, dev, card, timing_only=True)
        if importlib.util.find_spec("arrow_go_tpu_torch.flight.sql"):
            flightsql_phases(li, dev, card, timing_only=True)
        if os.path.exists(os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "examples", "torch_end_to_end.py")):
            examples_phases(dev, card, timing_only=True)
        if hasattr(tpq.encodings, "byte_stream_split_encode"):
            encodings_phases(li, dev, card, timing_only=True)
        if hasattr(agt, "make_builder"):
            arrays_phases(li, orders, dev, card, timing_only=True)
        if hasattr(agt.ipc.StreamWriter, "write_table"):
            hostapi_phases(li, dev, card, timing_only=True)
        if hasattr(agt.device.block, "as_dictionary"):
            strings_phases(li, orders, dev, card, timing_only=True)
        if hasattr(agt.device.block, "check_storage"):
            repairs_phases(li, orders, dev, card, timing_only=True)
        print(f"total: {time.perf_counter() - t_start:.1f} s (timing only)")
        return 0
    joins = join_phases(li, orders, dev, q1["snappy"], card)
    k1_err = max(k1_err, joins["errs"]["K1"])
    k2_err = max(k2_err, joins["errs"]["K2"])
    types = typed_phases(li, q1["snappy"], dev, card)
    k1_err = max(k1_err, types["errs"]["K1"])
    k3_err = max(k3_err, types["errs"]["K3"])
    decs = decimal_phases(li, dev, card, q6_want["count"])
    k1_err = max(k1_err, decs["errs"]["K1"])
    k3_err = max(k3_err, decs["errs"]["K3"])
    dsets = dataset_phases(li, orders, dev, card)
    k1_err = max(k1_err, dsets["errs"]["K1"])
    k2_err = max(k2_err, dsets["errs"]["K2"])
    k3_err = max(k3_err, dsets["errs"]["K3"])
    dists = dist_phases(_rows(li, 0, DIST_ROWS), orders, dev, card)
    k1_err = max(k1_err, dists["errs"]["K1"])
    k2_err = max(k2_err, dists["errs"]["K2"])
    nested = nested_phases(li, orders, dev, card)
    k1_err = max(k1_err, nested["errs"]["K1"])
    k2_err = max(k2_err, nested["errs"]["K2"])
    k3_err = max(k3_err, nested["errs"]["K3"])
    front = front_phases(li, orders, dev, card)
    k1_err = max(k1_err, front["errs"]["K1"])
    k3_err = max(k3_err, front["errs"]["K3"])
    more = types_phases(li, orders, dev, card)
    k1_err = max(k1_err, more["errs"]["K1"])
    k2_err = max(k2_err, more["errs"]["K2"])
    ipcs = ipc_phases(li, orders, dev, card, dsets["q6"])
    k1_err = max(k1_err, ipcs["errs"]["K1"])
    k3_err = max(k3_err, ipcs["errs"]["K3"])
    fmts = formats_phases(li, orders, dev, card)
    k1_err = max(k1_err, fmts["errs"]["K1"])
    k3_err = max(k3_err, fmts["errs"]["K3"])
    inter = interop_phases(li, orders, dev, card)
    k1_err = max(k1_err, inter["errs"]["K1"])
    k3_err = max(k3_err, inter["errs"]["K3"])
    encs = encryption_phases(li, dev, card)
    k1_err = max(k1_err, encs["errs"]["K1"])
    k3_err = max(k3_err, encs["errs"]["K3"])
    flights = flight_phases(li, dev, card)
    k1_err = max(k1_err, flights["errs"]["K1"])
    k3_err = max(k3_err, flights["errs"]["K3"])
    fsql = flightsql_phases(li, dev, card)
    k1_err = max(k1_err, fsql["errs"]["K1"])
    k3_err = max(k3_err, fsql["errs"]["K3"])
    exs = examples_phases(dev, card)
    k1_err = max(k1_err, exs["errs"]["K1"])
    k2_err = max(k2_err, exs["errs"]["K2"])
    k3_err = max(k3_err, exs["errs"]["K3"])
    pqe = encodings_phases(li, dev, card)
    k1_err = max(k1_err, pqe["errs"]["K1"])
    k3_err = max(k3_err, pqe["errs"]["K3"])
    arrs = arrays_phases(li, orders, dev, card)
    k1_err = max(k1_err, arrs["errs"]["K1"])
    k3_err = max(k3_err, arrs["errs"]["K3"])
    hapi = hostapi_phases(li, dev, card)
    k1_err = max(k1_err, hapi["errs"]["K1"])
    k2_err = max(k2_err, hapi["errs"]["K2"])
    k3_err = max(k3_err, hapi["errs"]["K3"])
    strs = strings_phases(li, orders, dev, card)
    k1_err = max(k1_err, strs["errs"]["K1"])
    k2_err = max(k2_err, strs["errs"]["K2"])
    reps = repairs_phases(li, orders, dev, card)
    k1_err = max(k1_err, reps["errs"]["K1"])
    k2_err = max(k2_err, reps["errs"]["K2"])
    k3_err = max(k3_err, reps["errs"]["K3"])
    k3 = k3s[0]
    by_path = {"Q3": launches, "Q6 from bytes": q6_launches,
               "summary from bytes": sum_launches,
               "Q3 from bytes": q3b_launches, **q1["launches"],
               **joins["launches"], **types["launches"],
               **decs["launches"], **dsets["launches"],
               **dists["launches"], **nested["launches"],
               **front["launches"], **more["launches"],
               **ipcs["launches"], **fmts["launches"],
               **inter["launches"], **encs["launches"],
               **flights["launches"], **fsql["launches"],
               **exs["launches"], **pqe["launches"], **arrs["launches"],
               **hapi["launches"], **strs["launches"],
               **reps["launches"]}
    kernels = [
        {"name": "compact_flagged", "route": "cuda",
         "source": "arrow_go_tpu_torch/csrc/compaction.cu",
         "replaces": "arrow_go_tpu/ops/compaction.py:103",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "bytes",
         "library_ms": k1["library_ms"]},
        {"name": "cummax_u64_lanes", "route": "cuda",
         "source": "arrow_go_tpu_torch/csrc/scan.cu",
         "replaces": "arrow_go_tpu/ops/scan.py:38",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": k2["library_ms"]},
        {"name": "reduce", "route": "cuda",
         "source": "arrow_go_tpu_torch/csrc/reduce.cu",
         "replaces": "arrow_go_tpu/ops/reductions.py:132",
         "launches": q6_launches["K3"], "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes",
         "library_ms": k3["library_ms"]},
    ]
    for kern, key in zip(kernels, KERNELS):
        # `launches` counts every path run_path drove once
        kern["launches_by_path"] = {p: c[key] for p, c in by_path.items()}
        kern["launches"] = sum(kern["launches_by_path"].values())
    kernels[0]["q1_filter"] = next(t for t in q1["k1s"]
                                   if t["site"] == "filter_with_payload")
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
