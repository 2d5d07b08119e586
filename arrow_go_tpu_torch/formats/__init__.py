"""File format readers and writers: CSV, line-delimited JSON and Avro
(reference arrow/csv, arrow/array/json_reader.go, arrow/avro).

Port of arrow_go_tpu/formats. Readers give HostBatches."""
from . import avro, csv, json  # noqa: F401
from .avro import OCFReader, read_avro  # noqa: F401
from .csv import CSVReader, open_csv, read_csv, write_csv  # noqa: F401
from .json import read_json, write_json  # noqa: F401
