"""The messages of FlightSql.proto (arrow.flight.protocol.sql) on the
port's protobuf codec (flight/messages.py), in place of the generated
FlightSql_pb2: the 32 top-level messages with their nested messages and
enums, google.protobuf.Any with `pack_any` / `unpack_any`, and the
SqlInfo ids that sql.py names.

The bytes equal FlightSql_pb2's, but for the order of a map's entries
(insertion order here; protobuf leaves it undefined). proto3 `optional`
fields keep explicit presence: None when unset, and `HasField` reads it.
"""
from __future__ import annotations

from ..compute.errors import ArrowNotImplemented
from .messages import Field, _message

PACKAGE = "arrow.flight.protocol.sql"
TYPE_PREFIX = "type.googleapis.com/"


def _opt(number: int, name: str, kind: str) -> Field:
    return Field(number, name, kind, presence=True)


CommandStatementQuery = _message(
    "CommandStatementQuery", Field(1, "query", "string"),
    _opt(2, "transaction_id", "bytes"))
TicketStatementQuery = _message("TicketStatementQuery",
                                Field(1, "statement_handle", "bytes"))
CommandPreparedStatementQuery = _message(
    "CommandPreparedStatementQuery",
    Field(1, "prepared_statement_handle", "bytes"))
ActionCreatePreparedStatementRequest = _message(
    "ActionCreatePreparedStatementRequest", Field(1, "query", "string"),
    _opt(2, "transaction_id", "bytes"))
ActionCreatePreparedStatementResult = _message(
    "ActionCreatePreparedStatementResult",
    Field(1, "prepared_statement_handle", "bytes"),
    Field(2, "dataset_schema", "bytes"),
    Field(3, "parameter_schema", "bytes"))
ActionClosePreparedStatementRequest = _message(
    "ActionClosePreparedStatementRequest",
    Field(1, "prepared_statement_handle", "bytes"))
CommandStatementUpdate = _message(
    "CommandStatementUpdate", Field(1, "query", "string"),
    _opt(2, "transaction_id", "bytes"))
CommandPreparedStatementUpdate = _message(
    "CommandPreparedStatementUpdate",
    Field(1, "prepared_statement_handle", "bytes"))
DoPutUpdateResult = _message("DoPutUpdateResult",
                             Field(1, "record_count", "int64"))
CommandGetCatalogs = _message("CommandGetCatalogs")
CommandGetDbSchemas = _message(
    "CommandGetDbSchemas", _opt(1, "catalog", "string"),
    _opt(2, "db_schema_filter_pattern", "string"))
CommandGetTables = _message(
    "CommandGetTables", _opt(1, "catalog", "string"),
    _opt(2, "db_schema_filter_pattern", "string"),
    _opt(3, "table_name_filter_pattern", "string"),
    Field(4, "table_types", "string", repeated=True),
    Field(5, "include_schema", "bool"))
CommandGetTableTypes = _message("CommandGetTableTypes")
CommandGetPrimaryKeys = _message(
    "CommandGetPrimaryKeys", _opt(1, "catalog", "string"),
    _opt(2, "db_schema", "string"), Field(3, "table", "string"))
CommandGetSqlInfo = _message(
    "CommandGetSqlInfo", Field(1, "info", "uint32", repeated=True))
CommandGetXdbcTypeInfo = _message("CommandGetXdbcTypeInfo",
                                  _opt(1, "data_type", "int32"))
CommandGetExportedKeys = _message(
    "CommandGetExportedKeys", _opt(1, "catalog", "string"),
    _opt(2, "db_schema", "string"), Field(3, "table", "string"))
CommandGetImportedKeys = _message(
    "CommandGetImportedKeys", _opt(1, "catalog", "string"),
    _opt(2, "db_schema", "string"), Field(3, "table", "string"))
CommandGetCrossReference = _message(
    "CommandGetCrossReference", _opt(1, "pk_catalog", "string"),
    _opt(2, "pk_db_schema", "string"), Field(3, "pk_table", "string"),
    _opt(4, "fk_catalog", "string"), _opt(5, "fk_db_schema", "string"),
    Field(6, "fk_table", "string"))
SubstraitPlan = _message("SubstraitPlan", Field(1, "plan", "bytes"),
                         Field(2, "version", "string"))
CommandStatementSubstraitPlan = _message(
    "CommandStatementSubstraitPlan",
    Field(1, "plan", "message", SubstraitPlan),
    _opt(2, "transaction_id", "bytes"))
ActionCreatePreparedSubstraitPlanRequest = _message(
    "ActionCreatePreparedSubstraitPlanRequest",
    Field(1, "plan", "message", SubstraitPlan),
    _opt(2, "transaction_id", "bytes"))
TableDefinitionOptions = _message(
    "TableDefinitionOptions", Field(1, "if_not_exist", "enum"),
    Field(2, "if_exists", "enum"),
    TABLE_NOT_EXIST_OPTION_UNSPECIFIED=0, TABLE_NOT_EXIST_OPTION_CREATE=1,
    TABLE_NOT_EXIST_OPTION_FAIL=2, TABLE_EXISTS_OPTION_UNSPECIFIED=0,
    TABLE_EXISTS_OPTION_FAIL=1, TABLE_EXISTS_OPTION_APPEND=2,
    TABLE_EXISTS_OPTION_REPLACE=3)
CommandStatementIngest = _message(
    "CommandStatementIngest",
    Field(1, "table_definition_options", "message", TableDefinitionOptions),
    Field(2, "table", "string"), _opt(3, "schema", "string"),
    _opt(4, "catalog", "string"), Field(5, "temporary", "bool"),
    _opt(6, "transaction_id", "bytes"),
    Field(1000, "options", "map", "string"),
    TableDefinitionOptions=TableDefinitionOptions)
DoPutPreparedStatementResult = _message(
    "DoPutPreparedStatementResult",
    _opt(1, "prepared_statement_handle", "bytes"))
ActionBeginTransactionRequest = _message("ActionBeginTransactionRequest")
ActionBeginTransactionResult = _message(
    "ActionBeginTransactionResult", Field(1, "transaction_id", "bytes"))
ActionEndTransactionRequest = _message(
    "ActionEndTransactionRequest", Field(1, "transaction_id", "bytes"),
    Field(2, "action", "enum"),
    END_TRANSACTION_UNSPECIFIED=0, END_TRANSACTION_COMMIT=1,
    END_TRANSACTION_ROLLBACK=2)
ActionBeginSavepointRequest = _message(
    "ActionBeginSavepointRequest", Field(1, "transaction_id", "bytes"),
    Field(2, "name", "string"))
ActionBeginSavepointResult = _message(
    "ActionBeginSavepointResult", Field(1, "savepoint_id", "bytes"))
ActionEndSavepointRequest = _message(
    "ActionEndSavepointRequest", Field(1, "savepoint_id", "bytes"),
    Field(2, "action", "enum"),
    END_SAVEPOINT_UNSPECIFIED=0, END_SAVEPOINT_RELEASE=1,
    END_SAVEPOINT_ROLLBACK=2)
ActionCancelQueryRequest = _message("ActionCancelQueryRequest",
                                    Field(1, "info", "bytes"))
ActionCancelQueryResult = _message(
    "ActionCancelQueryResult", Field(1, "result", "enum"),
    CANCEL_RESULT_UNSPECIFIED=0, CANCEL_RESULT_CANCELLED=1,
    CANCEL_RESULT_CANCELLING=2, CANCEL_RESULT_NOT_CANCELLABLE=3)

MESSAGES = (CommandStatementQuery, TicketStatementQuery,
            CommandPreparedStatementQuery,
            ActionCreatePreparedStatementRequest,
            ActionCreatePreparedStatementResult,
            ActionClosePreparedStatementRequest, CommandStatementUpdate,
            CommandPreparedStatementUpdate, DoPutUpdateResult,
            CommandGetCatalogs, CommandGetDbSchemas, CommandGetTables,
            CommandGetTableTypes, CommandGetPrimaryKeys, CommandGetSqlInfo,
            CommandGetXdbcTypeInfo, CommandGetExportedKeys,
            CommandGetImportedKeys, CommandGetCrossReference, SubstraitPlan,
            CommandStatementSubstraitPlan,
            ActionCreatePreparedSubstraitPlanRequest, CommandStatementIngest,
            DoPutPreparedStatementResult, ActionBeginTransactionRequest,
            ActionBeginTransactionResult, ActionEndTransactionRequest,
            ActionBeginSavepointRequest, ActionBeginSavepointResult,
            ActionEndSavepointRequest, ActionCancelQueryRequest,
            ActionCancelQueryResult)
_BY_NAME = {m.__name__: m for m in MESSAGES}

# ---------------------------------------------------------------------------
# google.protobuf.Any: how a command travels in FlightDescriptor.cmd, a
# Ticket or an action's body
# ---------------------------------------------------------------------------

Any = _message("Any", Field(1, "type_url", "string"),
               Field(2, "value", "bytes"))


def pack_any(msg) -> bytes:
    return Any(type_url=f"{TYPE_PREFIX}{PACKAGE}.{type(msg).__name__}",
               value=msg.SerializeToString()).SerializeToString()


def unpack_any(data: bytes):
    """The message an Any carries, found by the last name of its type
    URL (ArrowNotImplemented when it names none of FlightSql.proto's); a
    URL outside the package gives the message unset, as Any.Unpack
    leaves it."""
    a = Any.FromString(data)
    full = a.type_url.rsplit("/", 1)[-1]
    cls = _BY_NAME.get(full.rsplit(".", 1)[-1])
    if cls is None:
        raise ArrowNotImplemented(f"flight sql command {a.type_url}")
    if full != f"{PACKAGE}.{cls.__name__}":
        return cls()
    return cls.FromString(a.value)


class SqlInfo:
    """The SqlInfo ids the port's servers use (a subset of the spec's
    enum; reference gen FlightSql.pb.go)."""
    FLIGHT_SQL_SERVER_NAME = 0
    FLIGHT_SQL_SERVER_VERSION = 1
    FLIGHT_SQL_SERVER_ARROW_VERSION = 2
    FLIGHT_SQL_SERVER_READ_ONLY = 3
    FLIGHT_SQL_SERVER_SQL = 4
    FLIGHT_SQL_SERVER_SUBSTRAIT = 5
    FLIGHT_SQL_SERVER_TRANSACTION = 8
    SQL_DDL_CATALOG = 500
    SQL_DDL_SCHEMA = 501
    SQL_DDL_TABLE = 502
    SQL_IDENTIFIER_CASE = 503
    SQL_IDENTIFIER_QUOTE_CHAR = 504
    SQL_QUOTED_IDENTIFIER_CASE = 505
    SQL_ALL_TABLES_ARE_SELECTABLE = 506
    SQL_NULL_ORDERING = 507
    SQL_KEYWORDS = 508
