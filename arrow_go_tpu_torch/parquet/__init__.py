"""Parquet of the port: footer and schema on the host, values decoded on
the device (mirrors arrow_go_tpu.parquet), modular encryption and its
key tools (`parquet.keytools`), the read front that returns
HostBatches, and the writer with its WriterProperties."""
from . import format  # noqa: F401
from . import keytools  # noqa: F401
from .device_read import read_batch_device, read_column_device
from .encryption import (ColumnEncryptionProperties, FileDecryptionProperties,
                         FileEncryptionProperties)
from .reader import ParquetFile, ReaderProperties, read_table
from .writer import SortingColumn, WriterProperties, write_table

__all__ = ["ColumnEncryptionProperties", "FileDecryptionProperties",
           "FileEncryptionProperties", "ParquetFile", "ReaderProperties",
           "keytools", "read_batch_device", "read_column_device",
           "read_table", "SortingColumn", "WriterProperties", "write_table"]
