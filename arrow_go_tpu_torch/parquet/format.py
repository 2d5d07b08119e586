"""parquet.thrift structure definitions (field ids per the parquet-format
spec; reference parquet/internal/gen-go/parquet).

The port's own copy of arrow_go_tpu/parquet/format.py: the structs and
enums that the footer, the page headers and the writer use."""
from __future__ import annotations

import enum

from .thrift import ThriftStruct


class Type(enum.IntEnum):
    BOOLEAN = 0
    INT32 = 1
    INT64 = 2
    INT96 = 3
    FLOAT = 4
    DOUBLE = 5
    BYTE_ARRAY = 6
    FIXED_LEN_BYTE_ARRAY = 7


class Repetition(enum.IntEnum):
    REQUIRED = 0
    OPTIONAL = 1
    REPEATED = 2


class Codec(enum.IntEnum):
    UNCOMPRESSED = 0
    SNAPPY = 1
    GZIP = 2
    LZO = 3
    BROTLI = 4
    LZ4 = 5
    ZSTD = 6
    LZ4_RAW = 7


class Encoding(enum.IntEnum):
    PLAIN = 0
    PLAIN_DICTIONARY = 2
    RLE = 3
    BIT_PACKED = 4
    DELTA_BINARY_PACKED = 5
    DELTA_LENGTH_BYTE_ARRAY = 6
    DELTA_BYTE_ARRAY = 7
    RLE_DICTIONARY = 8
    BYTE_STREAM_SPLIT = 9


class PageType(enum.IntEnum):
    DATA_PAGE = 0
    INDEX_PAGE = 1
    DICTIONARY_PAGE = 2
    DATA_PAGE_V2 = 3


class ConvertedType(enum.IntEnum):
    UTF8 = 0
    MAP = 1
    MAP_KEY_VALUE = 2
    LIST = 3
    ENUM = 4
    DECIMAL = 5
    DATE = 6
    TIME_MILLIS = 7
    TIME_MICROS = 8
    TIMESTAMP_MILLIS = 9
    TIMESTAMP_MICROS = 10
    UINT_8 = 11
    UINT_16 = 12
    UINT_32 = 13
    UINT_64 = 14
    INT_8 = 15
    INT_16 = 16
    INT_32 = 17
    INT_64 = 18
    JSON = 19
    BSON = 20
    INTERVAL = 21


# -- logical types (union of empty/parametered structs) ---------------------

class StringType(ThriftStruct):
    FIELDS = {}


class MapLType(ThriftStruct):
    FIELDS = {}


class ListLType(ThriftStruct):
    FIELDS = {}


class EnumType(ThriftStruct):
    FIELDS = {}


class DateLType(ThriftStruct):
    FIELDS = {}


class NullLType(ThriftStruct):
    FIELDS = {}


class DecimalLType(ThriftStruct):
    FIELDS = {1: ("scale", "i32"), 2: ("precision", "i32")}


class MilliSeconds(ThriftStruct):
    FIELDS = {}


class MicroSeconds(ThriftStruct):
    FIELDS = {}


class NanoSeconds(ThriftStruct):
    FIELDS = {}


class TimeUnitU(ThriftStruct):
    FIELDS = {1: ("MILLIS", MilliSeconds), 2: ("MICROS", MicroSeconds),
              3: ("NANOS", NanoSeconds)}

    @property
    def unit_str(self):
        if self.MILLIS is not None:
            return "ms"
        if self.MICROS is not None:
            return "us"
        return "ns"


class TimeLType(ThriftStruct):
    FIELDS = {1: ("isAdjustedToUTC", "bool"), 2: ("unit", TimeUnitU)}


class TimestampLType(ThriftStruct):
    FIELDS = {1: ("isAdjustedToUTC", "bool"), 2: ("unit", TimeUnitU)}


class IntLType(ThriftStruct):
    FIELDS = {1: ("bitWidth", "i8"), 2: ("isSigned", "bool")}


class JsonLType(ThriftStruct):
    FIELDS = {}


class BsonLType(ThriftStruct):
    FIELDS = {}


class UUIDLType(ThriftStruct):
    FIELDS = {}


class Float16LType(ThriftStruct):
    FIELDS = {}


class VariantLType(ThriftStruct):
    FIELDS = {1: ("specification_version", "i8")}


class LogicalType(ThriftStruct):
    FIELDS = {1: ("STRING", StringType), 2: ("MAP", MapLType),
              3: ("LIST", ListLType), 4: ("ENUM", EnumType),
              5: ("DECIMAL", DecimalLType), 6: ("DATE", DateLType),
              7: ("TIME", TimeLType), 8: ("TIMESTAMP", TimestampLType),
              10: ("INTEGER", IntLType), 11: ("UNKNOWN", NullLType),
              12: ("JSON", JsonLType), 13: ("BSON", BsonLType),
              14: ("UUID", UUIDLType), 15: ("FLOAT16", Float16LType),
              16: ("VARIANT", VariantLType)}


class SchemaElement(ThriftStruct):
    FIELDS = {1: ("type", "i32"), 2: ("type_length", "i32"),
              3: ("repetition_type", "i32"), 4: ("name", "string"),
              5: ("num_children", "i32"), 6: ("converted_type", "i32"),
              7: ("scale", "i32"), 8: ("precision", "i32"),
              9: ("field_id", "i32"), 10: ("logicalType", LogicalType)}


class Statistics(ThriftStruct):
    FIELDS = {1: ("max", "binary"), 2: ("min", "binary"),
              3: ("null_count", "i64"), 4: ("distinct_count", "i64"),
              5: ("max_value", "binary"), 6: ("min_value", "binary"),
              7: ("is_max_value_exact", "bool"),
              8: ("is_min_value_exact", "bool")}


class KeyValue(ThriftStruct):
    FIELDS = {1: ("key", "string"), 2: ("value", "string")}


class PageEncodingStats(ThriftStruct):
    FIELDS = {1: ("page_type", "i32"), 2: ("encoding", "i32"),
              3: ("count", "i32")}


class ColumnMetaData(ThriftStruct):
    FIELDS = {1: ("type", "i32"), 2: ("encodings", ("list", "i32")),
              3: ("path_in_schema", ("list", "string")),
              4: ("codec", "i32"), 5: ("num_values", "i64"),
              6: ("total_uncompressed_size", "i64"),
              7: ("total_compressed_size", "i64"),
              8: ("key_value_metadata", ("list", KeyValue)),
              9: ("data_page_offset", "i64"),
              10: ("index_page_offset", "i64"),
              11: ("dictionary_page_offset", "i64"),
              12: ("statistics", Statistics),
              13: ("encoding_stats", ("list", PageEncodingStats)),
              14: ("bloom_filter_offset", "i64"),
              15: ("bloom_filter_length", "i32")}


class EncryptionWithFooterKey(ThriftStruct):
    FIELDS = {}


class EncryptionWithColumnKey(ThriftStruct):
    FIELDS = {1: ("path_in_schema", ("list", "string")),
              2: ("key_metadata", "binary")}


class ColumnCryptoMetaData(ThriftStruct):
    """Union (reference parquet.thrift ColumnCryptoMetaData,
    gen-go/parquet/parquet.go:11353)."""
    FIELDS = {1: ("ENCRYPTION_WITH_FOOTER_KEY", EncryptionWithFooterKey),
              2: ("ENCRYPTION_WITH_COLUMN_KEY", EncryptionWithColumnKey)}


class ColumnChunk(ThriftStruct):
    FIELDS = {1: ("file_path", "string"), 2: ("file_offset", "i64"),
              3: ("meta_data", ColumnMetaData),
              4: ("offset_index_offset", "i64"),
              5: ("offset_index_length", "i32"),
              6: ("column_index_offset", "i64"),
              7: ("column_index_length", "i32"),
              8: ("crypto_metadata", ColumnCryptoMetaData),
              9: ("encrypted_column_metadata", "binary")}


class SortingColumn(ThriftStruct):
    FIELDS = {1: ("column_idx", "i32"), 2: ("descending", "bool"),
              3: ("nulls_first", "bool")}


class RowGroup(ThriftStruct):
    FIELDS = {1: ("columns", ("list", ColumnChunk)),
              2: ("total_byte_size", "i64"), 3: ("num_rows", "i64"),
              4: ("sorting_columns", ("list", SortingColumn)),
              5: ("file_offset", "i64"),
              6: ("total_compressed_size", "i64"), 7: ("ordinal", "i16")}


class TypeDefinedOrder(ThriftStruct):
    FIELDS = {}


class ColumnOrder(ThriftStruct):
    FIELDS = {1: ("TYPE_ORDER", TypeDefinedOrder)}


class AesGcmV1(ThriftStruct):
    FIELDS = {1: ("aad_prefix", "binary"), 2: ("aad_file_unique", "binary"),
              3: ("supply_aad_prefix", "bool")}


class AesGcmCtrV1(ThriftStruct):
    FIELDS = {1: ("aad_prefix", "binary"), 2: ("aad_file_unique", "binary"),
              3: ("supply_aad_prefix", "bool")}


class EncryptionAlgorithm(ThriftStruct):
    """Union (reference gen-go/parquet/parquet.go:14915)."""
    FIELDS = {1: ("AES_GCM_V1", AesGcmV1), 2: ("AES_GCM_CTR_V1", AesGcmCtrV1)}


class FileCryptoMetaData(ThriftStruct):
    FIELDS = {1: ("encryption_algorithm", EncryptionAlgorithm),
              2: ("key_metadata", "binary")}


class FileMetaData(ThriftStruct):
    FIELDS = {1: ("version", "i32"),
              2: ("schema", ("list", SchemaElement)),
              3: ("num_rows", "i64"),
              4: ("row_groups", ("list", RowGroup)),
              5: ("key_value_metadata", ("list", KeyValue)),
              6: ("created_by", "string"),
              7: ("column_orders", ("list", ColumnOrder)),
              8: ("encryption_algorithm", EncryptionAlgorithm),
              9: ("footer_signing_key_metadata", "binary")}


class DataPageHeader(ThriftStruct):
    FIELDS = {1: ("num_values", "i32"), 2: ("encoding", "i32"),
              3: ("definition_level_encoding", "i32"),
              4: ("repetition_level_encoding", "i32"),
              5: ("statistics", Statistics)}


class IndexPageHeader(ThriftStruct):
    FIELDS = {}


class DictionaryPageHeader(ThriftStruct):
    FIELDS = {1: ("num_values", "i32"), 2: ("encoding", "i32"),
              3: ("is_sorted", "bool")}


class DataPageHeaderV2(ThriftStruct):
    FIELDS = {1: ("num_values", "i32"), 2: ("num_nulls", "i32"),
              3: ("num_rows", "i32"), 4: ("encoding", "i32"),
              5: ("definition_levels_byte_length", "i32"),
              6: ("repetition_levels_byte_length", "i32"),
              7: ("is_compressed", "bool"), 8: ("statistics", Statistics)}


class PageHeader(ThriftStruct):
    FIELDS = {1: ("type", "i32"), 2: ("uncompressed_page_size", "i32"),
              3: ("compressed_page_size", "i32"), 4: ("crc", "i32"),
              5: ("data_page_header", DataPageHeader),
              6: ("index_page_header", IndexPageHeader),
              7: ("dictionary_page_header", DictionaryPageHeader),
              8: ("data_page_header_v2", DataPageHeaderV2)}
