"""Parquet of the port: footer and schema on the host, values decoded on
the device (mirrors arrow_go_tpu.parquet for flat numeric columns)."""
from . import format  # noqa: F401
from .device_read import read_batch_device, read_column_device
from .reader import ParquetFile
from .writer import write_table

__all__ = ["ParquetFile", "read_batch_device", "read_column_device",
           "write_table"]
