"""Arrow Flight SQL of the port (after arrow_go_tpu/flight/sql.py;
reference arrow/flight/flightsql: server.go:591 dispatch, client.go:132
Execute, schema_ref's well-known schemas, and the SQLite example
server), on the port's own gRPC and FlightSql.proto messages
(sql_messages.py).

Commands travel as `google.protobuf.Any`-packed messages inside
FlightDescriptor.cmd, a Ticket or an action's body, as the spec has
them. Results are HostBatches where the JAX package returns Tables: a
query's columns are typed as the JAX `table(dict)` types them
(array/record.table: compute/scalars.infer_type, the first non-null
value deciding; no row or no value gives the null type) and built by
device/block.from_pylist.
A handler's error reaches the client as `rpc.RpcError` with status
UNKNOWN, where the JAX client raises `grpc.RpcError`.
"""
from __future__ import annotations

import threading
import uuid
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..compute.errors import ArrowInvalid, ArrowNotImplemented
from ..array.record import Table, host_batch, table
from ..device.block import HostArray, HostBatch, UnionArray, from_pylist
from . import messages as fm
from . import sql_messages as sqlpb
from .service import (Action, FlightClient, FlightDescriptor, FlightEndpoint,
                      FlightInfo, FlightServerBase, Result, Ticket,
                      _schema_from_ipc_bytes, _schema_to_ipc_bytes)
from .sql_messages import SqlInfo, pack_any, unpack_any  # noqa: F401


def _string_list(nullable: bool = True) -> dt.DataType:
    return dt.list_(dt.Field("item", dt.string, nullable))


# well-known result schemas (reference flightsql/schema_ref)
SCHEMA_CATALOGS = dt.Schema([dt.Field("catalog_name", dt.string, False)])
SCHEMA_DB_SCHEMAS = dt.Schema([
    dt.Field("catalog_name", dt.string),
    dt.Field("db_schema_name", dt.string, False)])
SCHEMA_TABLES = dt.Schema([
    dt.Field("catalog_name", dt.string),
    dt.Field("db_schema_name", dt.string),
    dt.Field("table_name", dt.string, False),
    dt.Field("table_type", dt.string, False)])
SCHEMA_TABLES_WITH_SCHEMA = dt.Schema(
    SCHEMA_TABLES.fields + [dt.Field("table_schema", dt.binary, False)])
SCHEMA_TABLE_TYPES = dt.Schema([dt.Field("table_type", dt.string, False)])
SCHEMA_PRIMARY_KEYS = dt.Schema([
    dt.Field("catalog_name", dt.string),
    dt.Field("db_schema_name", dt.string),
    dt.Field("table_name", dt.string, False),
    dt.Field("column_name", dt.string, False),
    dt.Field("key_sequence", dt.int32, False),
    dt.Field("key_name", dt.string)])
SCHEMA_IMPORTED_EXPORTED_KEYS = dt.Schema([
    dt.Field("pk_catalog_name", dt.string),
    dt.Field("pk_db_schema_name", dt.string),
    dt.Field("pk_table_name", dt.string, False),
    dt.Field("pk_column_name", dt.string, False),
    dt.Field("fk_catalog_name", dt.string),
    dt.Field("fk_db_schema_name", dt.string),
    dt.Field("fk_table_name", dt.string, False),
    dt.Field("fk_column_name", dt.string, False),
    dt.Field("key_sequence", dt.int32, False),
    dt.Field("fk_key_name", dt.string),
    dt.Field("pk_key_name", dt.string),
    dt.Field("update_rule", dt.uint8, False),
    dt.Field("delete_rule", dt.uint8, False)])
SCHEMA_IMPORTED_KEYS = SCHEMA_IMPORTED_EXPORTED_KEYS
SCHEMA_EXPORTED_KEYS = SCHEMA_IMPORTED_EXPORTED_KEYS
SCHEMA_CROSS_REFERENCE = SCHEMA_IMPORTED_EXPORTED_KEYS
_INT32_LIST_MAP = dt.map_(dt.int32, dt.list_(dt.Field("item", dt.int32)))
SQL_INFO_VALUE_TYPE = dt.dense_union([
    dt.Field("string_value", dt.string),
    dt.Field("bool_value", dt.bool_),
    dt.Field("bigint_value", dt.int64),
    dt.Field("int32_bitmask", dt.int32),
    dt.Field("string_list", _string_list()),
    dt.Field("int32_to_int32_list_map", _INT32_LIST_MAP),
], [0, 1, 2, 3, 4, 5])
SCHEMA_SQL_INFO = dt.Schema([
    dt.Field("info_name", dt.uint32, False),
    dt.Field("value", SQL_INFO_VALUE_TYPE, False)])
SCHEMA_XDBC_TYPE_INFO = dt.Schema([
    dt.Field("type_name", dt.string, False),
    dt.Field("data_type", dt.int32, False),
    dt.Field("column_size", dt.int32),
    dt.Field("literal_prefix", dt.string),
    dt.Field("literal_suffix", dt.string),
    dt.Field("create_params", _string_list(False)),
    dt.Field("nullable", dt.int32, False),
    dt.Field("case_sensitive", dt.bool_, False),
    dt.Field("searchable", dt.int32, False),
    dt.Field("unsigned_attribute", dt.bool_),
    dt.Field("fixed_prec_scale", dt.bool_, False),
    dt.Field("auto_increment", dt.bool_),
    dt.Field("local_type_name", dt.string),
    dt.Field("minimum_scale", dt.int32),
    dt.Field("maximum_scale", dt.int32),
    dt.Field("sql_data_type", dt.int32, False),
    dt.Field("datetime_subcode", dt.int32),
    dt.Field("num_prec_radix", dt.int32),
    dt.Field("interval_precision", dt.int32)])


def _rows_table(names: List[str], rows: list) -> HostBatch:
    """A query's rows as a HostBatch (a column a name; a repeated name
    keeps its last column, as a dict does in the JAX package)."""
    cols = list(zip(*rows)) if rows else [[] for _ in names]
    return host_batch(table({n: list(c) for n, c in zip(names, cols)}))


def _strings(values) -> HostArray:
    return from_pylist(list(values), dt.string)


def _int32(values) -> HostArray:
    return HostArray(np.asarray(list(values), np.int32), None, dt.int32)


def _sql_info_table(info: Dict[int, object]) -> HostBatch:
    """The SqlInfo result: uint32 info_name and the dense-union value
    (six children, the int32 bitmask and the map empty)."""
    names = sorted(info)
    type_codes = np.zeros(len(names), np.int8)
    offsets = np.zeros(len(names), np.int32)
    strings, bools, ints, slists = [], [], [], []
    for i, k in enumerate(names):
        v = info[k]
        if isinstance(v, bool):
            type_codes[i], offsets[i] = 1, len(bools)
            bools.append(v)
        elif isinstance(v, int):
            type_codes[i], offsets[i] = 2, len(ints)
            ints.append(v)
        elif isinstance(v, str):
            type_codes[i], offsets[i] = 0, len(strings)
            strings.append(v)
        elif isinstance(v, (list, tuple)):
            type_codes[i], offsets[i] = 4, len(slists)
            slists.append(list(v))
        else:
            raise ArrowInvalid(f"unsupported SqlInfo value {v!r}")
    children = [_strings(strings), from_pylist(bools, dt.bool_),
                from_pylist(ints, dt.int64), from_pylist([], dt.int32),
                from_pylist(slists, _string_list()),
                from_pylist([], _INT32_LIST_MAP)]
    value = UnionArray(SQL_INFO_VALUE_TYPE, type_codes, children, offsets)
    return HostBatch(SCHEMA_SQL_INFO, [
        HostArray(np.asarray(names, np.uint32), None, dt.uint32), value],
        len(names))


class FlightSQLServerBase(FlightServerBase):
    """Dispatching Flight SQL server: override the do_get_* / execute
    handlers (reference BaseServer unimplemented-stub pattern,
    flightsql/server.go:284). A handler returns a HostBatch or a
    (schema, batches) pair."""

    # -- overridables ------------------------------------------------------
    def get_flight_info_statement(self, ctx, query: str,
                                  descriptor: FlightDescriptor) -> FlightInfo:
        raise ArrowNotImplemented("GetFlightInfoStatement")

    def do_get_statement(self, ctx, handle: bytes):
        raise ArrowNotImplemented("DoGetStatement")

    def get_flight_info_tables(self, ctx, cmd, descriptor) -> FlightInfo:
        return FlightInfo(SCHEMA_TABLES, descriptor,
                          [FlightEndpoint(Ticket(descriptor.command))], -1, -1)

    def do_get_tables(self, ctx, cmd):
        raise ArrowNotImplemented("DoGetTables")

    def do_get_catalogs(self, ctx):
        raise ArrowNotImplemented("DoGetCatalogs")

    def do_get_db_schemas(self, ctx, cmd):
        raise ArrowNotImplemented("DoGetDbSchemas")

    def do_get_table_types(self, ctx):
        raise ArrowNotImplemented("DoGetTableTypes")

    def do_get_prepared_statement(self, ctx, handle: bytes):
        raise ArrowNotImplemented("DoGetPreparedStatement")

    def create_prepared_statement(self, ctx, query: str
                                  ) -> Tuple[bytes, Optional[dt.Schema]]:
        raise ArrowNotImplemented("CreatePreparedStatement")

    def close_prepared_statement(self, ctx, handle: bytes) -> None:
        pass

    def execute_update(self, ctx, query: str) -> int:
        raise ArrowNotImplemented("ExecuteUpdate")

    def do_get_primary_keys(self, ctx, cmd):
        raise ArrowNotImplemented("DoGetPrimaryKeys")

    def do_get_imported_keys(self, ctx, cmd):
        raise ArrowNotImplemented("DoGetImportedKeys")

    def do_get_exported_keys(self, ctx, cmd):
        raise ArrowNotImplemented("DoGetExportedKeys")

    def do_get_cross_reference(self, ctx, cmd):
        raise ArrowNotImplemented("DoGetCrossReference")

    def do_get_xdbc_type_info(self, ctx, cmd):
        raise ArrowNotImplemented("DoGetXdbcTypeInfo")

    def sql_info(self, ctx, ids) -> Dict[int, object]:
        """Return {SqlInfo id: value}; `ids` empty means all registered
        (reference server.go RegisterSqlInfo + GetSqlInfo)."""
        info = getattr(self, "_registered_sql_info", {})
        if ids:
            info = {k: v for k, v in info.items() if k in set(ids)}
        return info

    def register_sql_info(self, id_: int, value) -> None:
        if not hasattr(self, "_registered_sql_info"):
            self._registered_sql_info: Dict[int, object] = {}
        self._registered_sql_info[id_] = value

    def get_flight_info_substrait(self, ctx, plan: bytes,
                                  descriptor) -> FlightInfo:
        raise ArrowNotImplemented("GetFlightInfoSubstraitPlan")

    def execute_ingest(self, ctx, cmd, reader) -> int:
        """CommandStatementIngest: bulk-load the DoPut stream into `cmd.table`
        (reference flightsql/server.go DoPutCommandStatementIngest)."""
        raise ArrowNotImplemented("ExecuteIngest")

    def bind_prepared_statement(self, ctx, handle: bytes, reader) -> bytes:
        """Bind DoPut parameter batches to a prepared statement; returns the
        (possibly updated) handle (reference DoPutPreparedStatementQuery)."""
        raise ArrowNotImplemented("BindPreparedStatement")

    def execute_prepared_update(self, ctx, handle: bytes, reader) -> int:
        raise ArrowNotImplemented("ExecutePreparedUpdate")

    def begin_transaction(self, ctx) -> bytes:
        raise ArrowNotImplemented("BeginTransaction")

    def end_transaction(self, ctx, transaction_id: bytes,
                        commit: bool) -> None:
        raise ArrowNotImplemented("EndTransaction")

    def begin_savepoint(self, ctx, transaction_id: bytes,
                        name: str) -> bytes:
        """Create a named savepoint inside a transaction; returns its id
        (reference flightsql/server.go BeginSavepoint:529)."""
        raise ArrowNotImplemented("BeginSavepoint")

    def end_savepoint(self, ctx, savepoint_id: bytes,
                      release: bool) -> None:
        """Release (commit) or roll back to a savepoint (reference
        flightsql/server.go EndSavepoint)."""
        raise ArrowNotImplemented("EndSavepoint")

    def cancel_query(self, ctx, info) -> int:
        """Cancel a running query (`info` a messages.FlightInfo); returns
        an ActionCancelQueryResult.CancelResult value (reference
        flightsql/server.go CancelQuery:186; superseded by the standard
        CancelFlightInfo action but still part of the protocol)."""
        raise ArrowNotImplemented("CancelQuery")

    # -- dispatch ----------------------------------------------------------
    _GET_SCHEMAS = {}  # filled below class body

    def get_flight_info(self, ctx, descriptor: FlightDescriptor) -> FlightInfo:
        cmd = unpack_any(descriptor.command)
        if isinstance(cmd, sqlpb.CommandStatementQuery):
            return self.get_flight_info_statement(ctx, cmd.query, descriptor)
        if isinstance(cmd, sqlpb.CommandStatementSubstraitPlan):
            return self.get_flight_info_substrait(
                ctx, cmd.plan.plan if cmd.plan else b"", descriptor)
        schema = self._GET_SCHEMAS.get(type(cmd))
        if schema is not None:
            if isinstance(cmd, sqlpb.CommandGetTables) and cmd.include_schema:
                schema = SCHEMA_TABLES_WITH_SCHEMA
            return FlightInfo(schema, descriptor,
                              [FlightEndpoint(Ticket(descriptor.command))],
                              -1, -1)
        if isinstance(cmd, sqlpb.CommandPreparedStatementQuery):
            out = self.do_get_prepared_statement(
                ctx, cmd.prepared_statement_handle)
            schema = out.schema if isinstance(out, HostBatch) else out[0]
            return FlightInfo(schema, descriptor,
                              [FlightEndpoint(Ticket(descriptor.command))],
                              -1, -1)
        raise ArrowNotImplemented(f"GetFlightInfo for {type(cmd).__name__}")

    def do_get(self, ctx, ticket: Ticket):
        cmd = unpack_any(ticket.ticket)
        if isinstance(cmd, sqlpb.TicketStatementQuery):
            return self.do_get_statement(ctx, cmd.statement_handle)
        if isinstance(cmd, sqlpb.CommandGetTables):
            return self.do_get_tables(ctx, cmd)
        if isinstance(cmd, sqlpb.CommandGetCatalogs):
            return self.do_get_catalogs(ctx)
        if isinstance(cmd, sqlpb.CommandGetDbSchemas):
            return self.do_get_db_schemas(ctx, cmd)
        if isinstance(cmd, sqlpb.CommandGetTableTypes):
            return self.do_get_table_types(ctx)
        if isinstance(cmd, sqlpb.CommandGetPrimaryKeys):
            return self.do_get_primary_keys(ctx, cmd)
        if isinstance(cmd, sqlpb.CommandGetImportedKeys):
            return self.do_get_imported_keys(ctx, cmd)
        if isinstance(cmd, sqlpb.CommandGetExportedKeys):
            return self.do_get_exported_keys(ctx, cmd)
        if isinstance(cmd, sqlpb.CommandGetCrossReference):
            return self.do_get_cross_reference(ctx, cmd)
        if isinstance(cmd, sqlpb.CommandGetSqlInfo):
            return _sql_info_table(self.sql_info(ctx, list(cmd.info)))
        if isinstance(cmd, sqlpb.CommandGetXdbcTypeInfo):
            return self.do_get_xdbc_type_info(ctx, cmd)
        if isinstance(cmd, sqlpb.CommandPreparedStatementQuery):
            return self.do_get_prepared_statement(
                ctx, cmd.prepared_statement_handle)
        raise ArrowNotImplemented(f"DoGet for {type(cmd).__name__}")

    def do_put(self, ctx, descriptor, reader):
        """DoPutUpdateResult goes back raw and DoPutPreparedStatementResult
        packed in an Any, as the JAX server sends them."""
        cmd = unpack_any(descriptor.command)
        if isinstance(cmd, sqlpb.CommandStatementUpdate):
            n = self.execute_update(ctx, cmd.query)
            yield sqlpb.DoPutUpdateResult(record_count=n).SerializeToString()
            return
        if isinstance(cmd, sqlpb.CommandStatementIngest):
            n = self.execute_ingest(ctx, cmd, reader)
            yield sqlpb.DoPutUpdateResult(record_count=n).SerializeToString()
            return
        if isinstance(cmd, sqlpb.CommandPreparedStatementQuery):
            handle = self.bind_prepared_statement(
                ctx, cmd.prepared_statement_handle, reader)
            yield pack_any(sqlpb.DoPutPreparedStatementResult(
                prepared_statement_handle=handle))
            return
        if isinstance(cmd, sqlpb.CommandPreparedStatementUpdate):
            n = self.execute_prepared_update(
                ctx, cmd.prepared_statement_handle, reader)
            yield sqlpb.DoPutUpdateResult(record_count=n).SerializeToString()
            return
        raise ArrowNotImplemented(f"DoPut for {type(cmd).__name__}")

    def do_action(self, ctx, action: Action) -> Iterator[Result]:
        if action.type == "CreatePreparedStatement":
            req = unpack_any(action.body)
            handle, schema = self.create_prepared_statement(ctx, req.query)
            res = sqlpb.ActionCreatePreparedStatementResult(
                prepared_statement_handle=handle,
                dataset_schema=_schema_to_ipc_bytes(schema) if schema else b"")
            yield Result(pack_any(res))
            return
        if action.type == "ClosePreparedStatement":
            req = unpack_any(action.body)
            self.close_prepared_statement(ctx, req.prepared_statement_handle)
            return
        if action.type == "BeginTransaction":
            tid = self.begin_transaction(ctx)
            yield Result(pack_any(
                sqlpb.ActionBeginTransactionResult(transaction_id=tid)))
            return
        if action.type == "EndTransaction":
            req = unpack_any(action.body)
            commit = (req.action ==
                      sqlpb.ActionEndTransactionRequest.END_TRANSACTION_COMMIT)
            self.end_transaction(ctx, req.transaction_id, commit)
            return
        if action.type == "BeginSavepoint":
            req = unpack_any(action.body)
            sid = self.begin_savepoint(ctx, req.transaction_id, req.name)
            yield Result(pack_any(
                sqlpb.ActionBeginSavepointResult(savepoint_id=sid)))
            return
        if action.type == "EndSavepoint":
            req = unpack_any(action.body)
            release = (req.action ==
                       sqlpb.ActionEndSavepointRequest.END_SAVEPOINT_RELEASE)
            self.end_savepoint(ctx, req.savepoint_id, release)
            return
        if action.type == "CancelQuery":
            req = unpack_any(action.body)
            result = self.cancel_query(ctx, fm.FlightInfo.FromString(req.info))
            yield Result(pack_any(
                sqlpb.ActionCancelQueryResult(result=result)))
            return
        raise ArrowNotImplemented(f"action {action.type}")

    def list_actions(self, ctx):
        yield ("CreatePreparedStatement", "create a prepared statement")
        yield ("ClosePreparedStatement", "close a prepared statement")
        yield ("BeginTransaction", "begin a transaction")
        yield ("EndTransaction", "commit or roll back a transaction")
        yield ("BeginSavepoint", "create a savepoint in a transaction")
        yield ("EndSavepoint", "release or roll back to a savepoint")
        yield ("CancelQuery", "cancel a running query")


FlightSQLServerBase._GET_SCHEMAS = {
    sqlpb.CommandGetTables: SCHEMA_TABLES,
    sqlpb.CommandGetCatalogs: SCHEMA_CATALOGS,
    sqlpb.CommandGetDbSchemas: SCHEMA_DB_SCHEMAS,
    sqlpb.CommandGetTableTypes: SCHEMA_TABLE_TYPES,
    sqlpb.CommandGetPrimaryKeys: SCHEMA_PRIMARY_KEYS,
    sqlpb.CommandGetImportedKeys: SCHEMA_IMPORTED_EXPORTED_KEYS,
    sqlpb.CommandGetExportedKeys: SCHEMA_IMPORTED_EXPORTED_KEYS,
    sqlpb.CommandGetCrossReference: SCHEMA_IMPORTED_EXPORTED_KEYS,
    sqlpb.CommandGetSqlInfo: SCHEMA_SQL_INFO,
    sqlpb.CommandGetXdbcTypeInfo: SCHEMA_XDBC_TYPE_INFO,
}


def _batches(data) -> Tuple[dt.Schema, list]:
    """(schema, batches) of a HostBatch (a RecordBatch, or a Table's
    combined chunks) or a (schema, batches) pair."""
    data = host_batch(data)
    if isinstance(data, HostBatch):
        return data.schema, [data]
    schema, batches = data
    return schema, list(batches)


class FlightSQLClient:
    """Reference flightsql/client.go:132. Each result is one HostBatch."""

    def __init__(self, location: str):
        self._inner = FlightClient(location)

    def close(self):
        self._inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def execute(self, query: str) -> FlightInfo:
        cmd = sqlpb.CommandStatementQuery(query=query)
        return self._inner.get_flight_info(
            FlightDescriptor.for_command(pack_any(cmd)))

    def do_get(self, ticket: Ticket):
        return self._inner.do_get(ticket)

    def execute_query(self, query: str) -> Table:
        info = self.execute(query)
        return self._inner.do_get(info.endpoints[0].ticket).read_all()

    def execute_update(self, query: str) -> int:
        """A DoPut of the command's descriptor, an empty schema and no
        batch; the count comes back raw in the first acknowledgement."""
        cmd = sqlpb.CommandStatementUpdate(query=query)
        desc = FlightDescriptor.for_command(pack_any(cmd))
        acks = self._inner.do_put(desc, dt.Schema([]), [])
        if acks:
            return sqlpb.DoPutUpdateResult.FromString(acks[0]).record_count
        return 0

    def _get(self, cmd) -> Table:
        desc = FlightDescriptor.for_command(pack_any(cmd))
        info = self._inner.get_flight_info(desc)
        return self._inner.do_get(info.endpoints[0].ticket).read_all()

    def get_catalogs(self) -> Table:
        return self._get(sqlpb.CommandGetCatalogs())

    def get_db_schemas(self, catalog: Optional[str] = None) -> Table:
        return self._get(sqlpb.CommandGetDbSchemas(catalog=catalog))

    def get_tables(self, catalog=None, db_schema_filter_pattern=None,
                   table_name_filter_pattern=None,
                   table_types=()) -> Table:
        return self._get(sqlpb.CommandGetTables(
            catalog=catalog,
            db_schema_filter_pattern=db_schema_filter_pattern,
            table_name_filter_pattern=table_name_filter_pattern,
            table_types=list(table_types)))

    def get_table_types(self) -> Table:
        return self._get(sqlpb.CommandGetTableTypes())

    def get_primary_keys(self, table: str, catalog=None,
                         db_schema=None) -> Table:
        return self._get(sqlpb.CommandGetPrimaryKeys(
            catalog=catalog, db_schema=db_schema, table=table))

    def get_imported_keys(self, table: str, catalog=None,
                          db_schema=None) -> Table:
        return self._get(sqlpb.CommandGetImportedKeys(
            catalog=catalog, db_schema=db_schema, table=table))

    def get_exported_keys(self, table: str, catalog=None,
                          db_schema=None) -> Table:
        return self._get(sqlpb.CommandGetExportedKeys(
            catalog=catalog, db_schema=db_schema, table=table))

    def get_cross_reference(self, pk_table: str, fk_table: str,
                            pk_catalog=None, pk_db_schema=None,
                            fk_catalog=None, fk_db_schema=None) -> Table:
        return self._get(sqlpb.CommandGetCrossReference(
            pk_catalog=pk_catalog, pk_db_schema=pk_db_schema,
            pk_table=pk_table, fk_catalog=fk_catalog,
            fk_db_schema=fk_db_schema, fk_table=fk_table))

    def get_sql_info(self, info=()) -> Table:
        return self._get(sqlpb.CommandGetSqlInfo(info=list(info)))

    def get_xdbc_type_info(self, data_type: Optional[int] = None
                           ) -> Table:
        return self._get(sqlpb.CommandGetXdbcTypeInfo(data_type=data_type))

    def execute_substrait(self, plan: bytes, version: str = "") -> Table:
        cmd = sqlpb.CommandStatementSubstraitPlan(
            plan=sqlpb.SubstraitPlan(plan=plan, version=version))
        return self._get(cmd)

    def execute_ingest(self, data, table: str, *, catalog=None,
                       db_schema=None, temporary: bool = False,
                       if_exists: str = "fail",
                       transaction_id: Optional[bytes] = None) -> int:
        """Bulk-load `data` (a HostBatch or a (schema, batches) pair) into
        `table` (reference flightsql/client.go ExecuteIngest)."""
        TDO = sqlpb.TableDefinitionOptions
        tdo = TDO(if_not_exist=TDO.TABLE_NOT_EXIST_OPTION_CREATE,
                  if_exists={"fail": 1, "append": 2, "replace": 3}[if_exists])
        cmd = sqlpb.CommandStatementIngest(
            table_definition_options=tdo, table=table, catalog=catalog,
            schema=db_schema, temporary=temporary,
            transaction_id=transaction_id)
        desc = FlightDescriptor.for_command(pack_any(cmd))
        schema, batches = _batches(data)
        acks = self._inner.do_put(desc, schema, batches)
        return sum(sqlpb.DoPutUpdateResult.FromString(a).record_count
                   for a in acks)

    def begin_transaction(self) -> bytes:
        results = list(self._inner.do_action(
            Action("BeginTransaction",
                   pack_any(sqlpb.ActionBeginTransactionRequest()))))
        return unpack_any(results[0].body).transaction_id

    def _end_transaction(self, tid: bytes, commit: bool) -> None:
        act = (sqlpb.ActionEndTransactionRequest.END_TRANSACTION_COMMIT
               if commit else
               sqlpb.ActionEndTransactionRequest.END_TRANSACTION_ROLLBACK)
        list(self._inner.do_action(Action(
            "EndTransaction",
            pack_any(sqlpb.ActionEndTransactionRequest(
                transaction_id=tid, action=act)))))

    def commit(self, transaction_id: bytes) -> None:
        self._end_transaction(transaction_id, True)

    def rollback(self, transaction_id: bytes) -> None:
        self._end_transaction(transaction_id, False)

    def begin_savepoint(self, transaction_id: bytes, name: str) -> bytes:
        """reference flightsql/client.go BeginSavepoint."""
        results = list(self._inner.do_action(Action(
            "BeginSavepoint",
            pack_any(sqlpb.ActionBeginSavepointRequest(
                transaction_id=transaction_id, name=name)))))
        return unpack_any(results[0].body).savepoint_id

    def _end_savepoint(self, savepoint_id: bytes, release: bool) -> None:
        act = (sqlpb.ActionEndSavepointRequest.END_SAVEPOINT_RELEASE
               if release else
               sqlpb.ActionEndSavepointRequest.END_SAVEPOINT_ROLLBACK)
        list(self._inner.do_action(Action(
            "EndSavepoint",
            pack_any(sqlpb.ActionEndSavepointRequest(
                savepoint_id=savepoint_id, action=act)))))

    def release_savepoint(self, savepoint_id: bytes) -> None:
        self._end_savepoint(savepoint_id, True)

    def rollback_savepoint(self, savepoint_id: bytes) -> None:
        self._end_savepoint(savepoint_id, False)

    def cancel_query(self, info) -> int:
        """Cancel via the Flight SQL CancelQuery action (reference
        flightsql/client.go CancelQuery; see also cancel_flight_info for
        the standard action). `info` is a FlightInfo or its message;
        returns a CancelResult enum value."""
        raw = info.SerializeToString() if hasattr(info, "SerializeToString") \
            else info.to_proto().SerializeToString()
        results = list(self._inner.do_action(Action(
            "CancelQuery",
            pack_any(sqlpb.ActionCancelQueryRequest(info=raw)))))
        return unpack_any(results[0].body).result

    def prepare(self, query: str) -> "PreparedStatement":
        req = sqlpb.ActionCreatePreparedStatementRequest(query=query)
        results = list(self._inner.do_action(
            Action("CreatePreparedStatement", pack_any(req))))
        res = unpack_any(results[0].body)
        schema = (_schema_from_ipc_bytes(res.dataset_schema)
                  if res.dataset_schema else None)
        return PreparedStatement(self, res.prepared_statement_handle, schema)


class PreparedStatement:
    def __init__(self, client: FlightSQLClient, handle: bytes,
                 schema: Optional[dt.Schema]):
        self._client = client
        self.handle = handle
        self.dataset_schema = schema

    def _descriptor(self, cls) -> FlightDescriptor:
        return FlightDescriptor.for_command(pack_any(cls(
            prepared_statement_handle=self.handle)))

    def execute(self) -> Table:
        inner = self._client._inner
        info = inner.get_flight_info(
            self._descriptor(sqlpb.CommandPreparedStatementQuery))
        return inner.do_get(info.endpoints[0].ticket).read_all()

    def set_parameters(self, data) -> None:
        """DoPut parameter-binding (reference client.go bindParameters); the
        server may return an updated handle in an Any-packed
        DoPutPreparedStatementResult."""
        schema, batches = _batches(data)
        acks = self._client._inner.do_put(
            self._descriptor(sqlpb.CommandPreparedStatementQuery), schema,
            batches)
        for a in acks:
            if not a:
                continue
            res = unpack_any(a)
            if res.prepared_statement_handle:
                self.handle = res.prepared_statement_handle

    def execute_update(self, data=None) -> int:
        schema, batches = (dt.Schema([]), []) if data is None \
            else _batches(data)
        acks = self._client._inner.do_put(
            self._descriptor(sqlpb.CommandPreparedStatementUpdate), schema,
            batches)
        return sum(sqlpb.DoPutUpdateResult.FromString(a).record_count
                   for a in acks)

    def close(self) -> None:
        req = sqlpb.ActionClosePreparedStatementRequest(
            prepared_statement_handle=self.handle)
        list(self._client._inner.do_action(
            Action("ClosePreparedStatement", pack_any(req))))


# ---------------------------------------------------------------------------
# SQLite-backed example server (reference flightsql/example — the SQLite
# server used by the cross-language integration scenarios)
# ---------------------------------------------------------------------------

_FK_RULES = {"CASCADE": 0, "RESTRICT": 1, "SET NULL": 2, "NO ACTION": 3,
             "SET DEFAULT": 4}


def _rows_of(batch: HostBatch) -> list:
    """A batch's rows as tuples of Python values."""
    return list(zip(*(c.to_pylist() for c in batch.columns)))


class SQLiteFlightSQLServer(FlightSQLServerBase):
    """Flight SQL over an in-memory sqlite3 database: one connection in
    autocommit mode, shared by the server's threads under a lock;
    transactions are BEGIN / COMMIT / ROLLBACK statements on it."""

    def __init__(self, location: str = "grpc://127.0.0.1:0",
                 db_path: str = ":memory:"):
        super().__init__(location)
        import sqlite3
        self._conn = sqlite3.connect(db_path, check_same_thread=False,
                                     isolation_level=None)
        self._lock = threading.Lock()
        self._prepared: Dict[bytes, str] = {}
        self._bound: Dict[bytes, list] = {}
        self.register_sql_info(SqlInfo.FLIGHT_SQL_SERVER_NAME,
                               "arrow_go_tpu sqlite example")
        self.register_sql_info(SqlInfo.FLIGHT_SQL_SERVER_VERSION, "1.0.0")
        self.register_sql_info(SqlInfo.FLIGHT_SQL_SERVER_READ_ONLY, False)
        self.register_sql_info(SqlInfo.FLIGHT_SQL_SERVER_SQL, True)
        self.register_sql_info(SqlInfo.FLIGHT_SQL_SERVER_TRANSACTION, 1)
        self.register_sql_info(SqlInfo.SQL_IDENTIFIER_QUOTE_CHAR, '"')
        self.register_sql_info(
            SqlInfo.SQL_KEYWORDS, ["SELECT", "FROM", "WHERE", "INSERT"])

    def _query_to_table(self, query: str, params=()) -> HostBatch:
        with self._lock:
            cur = self._conn.execute(query, params)
            rows = cur.fetchall()
            names = [d[0] for d in cur.description or []]
        return _rows_table(names, rows)

    def get_flight_info_statement(self, ctx, query, descriptor):
        """Runs the query to learn its schema and row count; DoGet runs
        it again (the JAX server's behaviour)."""
        t = self._query_to_table(query)
        ticket = pack_any(sqlpb.TicketStatementQuery(
            statement_handle=query.encode()))
        return FlightInfo(t.schema, descriptor,
                          [FlightEndpoint(Ticket(ticket))], t.num_rows, -1)

    def do_get_statement(self, ctx, handle: bytes):
        return self._query_to_table(handle.decode())

    def do_get_catalogs(self, ctx):
        return HostBatch(SCHEMA_CATALOGS, [_strings(["main"])], 1)

    def do_get_db_schemas(self, ctx, cmd):
        return HostBatch(SCHEMA_DB_SCHEMAS,
                      [_strings(["main"]), _strings(["main"])], 1)

    def do_get_tables(self, ctx, cmd):
        q = "SELECT name, type FROM sqlite_master WHERE type IN ('table','view')"
        if cmd.table_name_filter_pattern:
            q += f" AND name LIKE '{cmd.table_name_filter_pattern}'"
        with self._lock:
            rows = self._conn.execute(q).fetchall()
        names = [r[0] for r in rows]
        types = ["TABLE" if r[1] == "table" else "VIEW" for r in rows]
        n = len(names)
        cols = [_strings(["main"] * n), _strings(["main"] * n),
                _strings(names), _strings(types)]
        schema = SCHEMA_TABLES
        if cmd.include_schema:
            sql_to_arrow = {"INTEGER": dt.int64, "REAL": dt.float64,
                            "TEXT": dt.string, "BLOB": dt.binary}
            blobs = []
            for t in names:
                with self._lock:
                    info = self._conn.execute(
                        f'PRAGMA table_info("{t}")').fetchall()
                fs = [dt.Field(r[1],
                               sql_to_arrow.get((r[2] or "").upper(),
                                                dt.string),
                               not r[3]) for r in info]
                blobs.append(_schema_to_ipc_bytes(dt.Schema(fs)))
            cols.append(from_pylist(blobs, dt.binary))
            schema = SCHEMA_TABLES_WITH_SCHEMA
        return HostBatch(schema, cols, n)

    def do_get_table_types(self, ctx):
        return HostBatch(SCHEMA_TABLE_TYPES, [_strings(["TABLE", "VIEW"])], 2)

    def create_prepared_statement(self, ctx, query):
        """Runs the query for its schema; a query that needs parameters
        has none until they are bound."""
        import sqlite3
        handle = uuid.uuid4().bytes
        self._prepared[handle] = query
        try:
            t = self._query_to_table(query)
        except sqlite3.ProgrammingError:
            return handle, None
        return handle, t.schema

    def do_get_prepared_statement(self, ctx, handle: bytes):
        """The query with its first bound parameter row, if any."""
        params = self._bound.get(handle)
        return self._query_to_table(self._prepared[handle],
                                    params[0] if params else ())

    def close_prepared_statement(self, ctx, handle: bytes) -> None:
        self._prepared.pop(handle, None)

    def execute_update(self, ctx, query: str) -> int:
        with self._lock:
            cur = self._conn.execute(query)
        return cur.rowcount

    # -- catalog metadata ---------------------------------------------------
    def do_get_primary_keys(self, ctx, cmd):
        with self._lock:
            rows = self._conn.execute(
                f'PRAGMA table_info("{cmd.table}")').fetchall()
        pk = sorted([r for r in rows if r[5] > 0], key=lambda r: r[5])
        n = len(pk)
        return HostBatch(SCHEMA_PRIMARY_KEYS, [
            _strings(["main"] * n), _strings(["main"] * n),
            _strings([cmd.table] * n), _strings([r[1] for r in pk]),
            _int32([r[5] for r in pk]), _strings([None] * n)], n)

    def _foreign_keys(self, fk_table: str):
        with self._lock:
            return self._conn.execute(
                f'PRAGMA foreign_key_list("{fk_table}")').fetchall()

    @staticmethod
    def _fk_rows_to_table(fk_tables: List[str], fks) -> HostBatch:
        """PRAGMA foreign_key_list rows (id, seq, table (pk), from (fk
        column), to (pk column), on_update, on_delete, match), each of
        the foreign-key table named beside it."""
        n = len(fks)
        rule = [HostArray(np.asarray([_FK_RULES.get(r[k], 3) for r in fks],
                                     np.uint8), None, dt.uint8)
                for k in (5, 6)]
        return HostBatch(SCHEMA_IMPORTED_EXPORTED_KEYS, [
            _strings(["main"] * n), _strings(["main"] * n),
            _strings([r[2] for r in fks]),
            _strings([r[4] or "" for r in fks]),
            _strings(["main"] * n), _strings(["main"] * n),
            _strings(fk_tables), _strings([r[3] for r in fks]),
            _int32([r[1] + 1 for r in fks]),
            _strings([None] * n), _strings([None] * n)] + rule, n)

    def do_get_imported_keys(self, ctx, cmd):
        # keys this table imports (its foreign keys)
        fks = self._foreign_keys(cmd.table)
        return self._fk_rows_to_table([cmd.table] * len(fks), fks)

    def do_get_exported_keys(self, ctx, cmd):
        # keys other tables import FROM cmd.table
        with self._lock:
            tables = [r[0] for r in self._conn.execute(
                "SELECT name FROM sqlite_master WHERE type='table'")]
        out = [(t, fk) for t in tables for fk in self._foreign_keys(t)
               if fk[2] == cmd.table]
        return self._fk_rows_to_table([t for t, _ in out],
                                      [fk for _, fk in out])

    def do_get_cross_reference(self, ctx, cmd):
        fks = [fk for fk in self._foreign_keys(cmd.fk_table)
               if fk[2] == cmd.pk_table]
        return self._fk_rows_to_table([cmd.fk_table] * len(fks), fks)

    def do_get_xdbc_type_info(self, ctx, cmd):
        # sqlite storage classes (reference example/type_info.go)
        infos = [  # (name, xdbc data_type code)
            ("INTEGER", 4), ("REAL", 8), ("TEXT", 12), ("BLOB", -3)]
        if cmd.HasField("data_type"):
            infos = [i for i in infos if i[1] == cmd.data_type]
        n = len(infos)
        codes = _int32([i[1] for i in infos])

        def nulls(t):
            return from_pylist([None] * n, t)

        def const(v, t):
            return from_pylist([v] * n, t)
        return HostBatch(SCHEMA_XDBC_TYPE_INFO, [
            _strings([i[0] for i in infos]), codes, nulls(dt.int32),
            nulls(dt.string), nulls(dt.string),
            from_pylist([[] for _ in infos], _string_list(False)),
            _int32([1] * n), const(False, dt.bool_), _int32([3] * n),
            nulls(dt.bool_), const(False, dt.bool_), nulls(dt.bool_),
            nulls(dt.string), nulls(dt.int32), nulls(dt.int32), codes,
            nulls(dt.int32), nulls(dt.int32), nulls(dt.int32)], n)

    # -- ingest / prepared parameters / transactions ------------------------
    _SQL_TYPES = {dt.TypeId.BOOL: "INTEGER", dt.TypeId.INT8: "INTEGER",
                  dt.TypeId.INT16: "INTEGER", dt.TypeId.INT32: "INTEGER",
                  dt.TypeId.INT64: "INTEGER", dt.TypeId.UINT8: "INTEGER",
                  dt.TypeId.UINT16: "INTEGER", dt.TypeId.UINT32: "INTEGER",
                  dt.TypeId.UINT64: "INTEGER", dt.TypeId.FLOAT32: "REAL",
                  dt.TypeId.FLOAT64: "REAL", dt.TypeId.STRING: "TEXT",
                  dt.TypeId.LARGE_STRING: "TEXT", dt.TypeId.BINARY: "BLOB",
                  dt.TypeId.LARGE_BINARY: "BLOB"}

    def execute_ingest(self, ctx, cmd, reader) -> int:
        first = reader.read_next_batch()
        if first is None:
            return 0
        schema = first.schema
        opts = cmd.table_definition_options or sqlpb.TableDefinitionOptions()
        TDO = sqlpb.TableDefinitionOptions
        cols = ", ".join(
            f'"{f.name}" {self._SQL_TYPES.get(f.type.id, "TEXT")}'
            for f in schema.fields)
        tmp = "TEMPORARY " if cmd.temporary else ""
        with self._lock:
            exists = self._conn.execute(
                "SELECT 1 FROM sqlite_master WHERE name=?",
                (cmd.table,)).fetchone()
            if exists and opts.if_exists == TDO.TABLE_EXISTS_OPTION_FAIL:
                raise ArrowInvalid(f"table {cmd.table} already exists")
            if exists and opts.if_exists == TDO.TABLE_EXISTS_OPTION_REPLACE:
                self._conn.execute(f'DROP TABLE "{cmd.table}"')
                exists = None
            if not exists:
                if opts.if_not_exist == TDO.TABLE_NOT_EXIST_OPTION_FAIL:
                    raise ArrowInvalid(f"table {cmd.table} does not exist")
                self._conn.execute(
                    f'CREATE {tmp}TABLE "{cmd.table}" ({cols})')
        n = 0
        ph = ", ".join("?" * len(schema.fields))
        ins = f'INSERT INTO "{cmd.table}" VALUES ({ph})'
        batch = first
        while batch is not None:
            rows = _rows_of(batch)
            with self._lock:
                self._conn.executemany(ins, rows)
            n += batch.num_rows
            batch = reader.read_next_batch()
        return n

    @staticmethod
    def _parameters(reader) -> list:
        params = []
        batch = reader.read_next_batch() if reader is not None else None
        while batch is not None:
            params.extend(_rows_of(batch))
            batch = reader.read_next_batch()
        return params

    def bind_prepared_statement(self, ctx, handle: bytes, reader) -> bytes:
        self._bound[handle] = self._parameters(reader)
        return handle

    def execute_prepared_update(self, ctx, handle: bytes, reader) -> int:
        query = self._prepared[handle]
        params = self._parameters(reader)
        with self._lock:
            if params:
                cur = self._conn.executemany(query, params)
            else:
                cur = self._conn.execute(query)
        return cur.rowcount

    def begin_transaction(self, ctx) -> bytes:
        tid = uuid.uuid4().bytes
        with self._lock:
            self._conn.execute("BEGIN")
        return tid

    def end_transaction(self, ctx, transaction_id: bytes,
                        commit: bool) -> None:
        with self._lock:
            self._conn.execute("COMMIT" if commit else "ROLLBACK")

    def begin_savepoint(self, ctx, transaction_id: bytes,
                        name: str) -> bytes:
        sid = f"sp_{uuid.uuid4().hex[:12]}"
        with self._lock:
            self._conn.execute(f"SAVEPOINT {sid}")
        return sid.encode()

    def end_savepoint(self, ctx, savepoint_id: bytes,
                      release: bool) -> None:
        sp = savepoint_id.decode()
        if not sp.startswith("sp_") or not sp[3:].isalnum():
            raise ArrowInvalid("unknown savepoint")
        with self._lock:
            self._conn.execute(
                f"RELEASE SAVEPOINT {sp}" if release
                else f"ROLLBACK TO SAVEPOINT {sp}")

    def cancel_query(self, ctx, info) -> int:
        # sqlite queries run synchronously inside DoGet: by the time a
        # cancel arrives there is nothing in flight
        return sqlpb.ActionCancelQueryResult.CANCEL_RESULT_NOT_CANCELLABLE
