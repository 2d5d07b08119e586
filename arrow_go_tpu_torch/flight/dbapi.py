"""DB-API 2.0 (PEP 249) driver over the port's Flight SQL (after
arrow_go_tpu/flight/dbapi.py; reference
arrow/flight/flightsql/driver/driver.go, the Go `database/sql` driver).

`connect("grpc://host:port")` returns a PEP 249 Connection. Parameter
style: qmark ('?'), the reference driver's positional placeholders.
Parameters go to the server as a one-row HostBatch (a column a
parameter, typed as `sql.table` types it) through the prepared
statement's DoPut binding. A statement that changes data opens a
transaction first when none is open (`commit` / `rollback` end it);
`fetch_arrow_table` gives the result as the client's read gives it, a
Table.
"""
from __future__ import annotations

import datetime
import time
from typing import Any, List, Optional, Sequence, Tuple

from .. import dtypes as dt
from ..device.block import HostBatch
from .sql import FlightSQLClient, table

apilevel = "2.0"
threadsafety = 1          # threads may share the module, not connections
paramstyle = "qmark"


class Error(Exception):
    pass


class InterfaceError(Error):
    pass


class DatabaseError(Error):
    pass


class OperationalError(DatabaseError):
    pass


class ProgrammingError(DatabaseError):
    pass


class NotSupportedError(DatabaseError):
    pass


# -- type constructors / singletons (PEP 249 §Type Objects) ----------------
Date = datetime.date
Time = datetime.time
Timestamp = datetime.datetime


def DateFromTicks(ticks):
    return Date(*time.localtime(ticks)[:3])


def TimeFromTicks(ticks):
    return Time(*time.localtime(ticks)[3:6])


def TimestampFromTicks(ticks):
    return Timestamp(*time.localtime(ticks)[:6])


def Binary(b):
    return bytes(b)


class _TypeObject:
    def __init__(self, *ids):
        self._ids = set(ids)

    def __eq__(self, other):
        return other in self._ids


STRING = _TypeObject(dt.TypeId.STRING, dt.TypeId.LARGE_STRING)
BINARY = _TypeObject(dt.TypeId.BINARY, dt.TypeId.LARGE_BINARY,
                     dt.TypeId.FIXED_SIZE_BINARY)
NUMBER = _TypeObject(dt.TypeId.INT8, dt.TypeId.INT16, dt.TypeId.INT32,
                     dt.TypeId.INT64, dt.TypeId.UINT8, dt.TypeId.UINT16,
                     dt.TypeId.UINT32, dt.TypeId.UINT64, dt.TypeId.FLOAT32,
                     dt.TypeId.FLOAT64, dt.TypeId.BOOL)
DATETIME = _TypeObject(dt.TypeId.TIMESTAMP, dt.TypeId.DATE32,
                       dt.TypeId.DATE64, dt.TypeId.TIME32, dt.TypeId.TIME64)
ROWID = _TypeObject()


def connect(location: str, **kwargs) -> "Connection":
    """Open a DB-API connection to a Flight SQL server
    (`grpc://host:port`)."""
    return Connection(location, **kwargs)


class Connection:
    def __init__(self, location: str):
        self._client: Optional[FlightSQLClient] = FlightSQLClient(location)
        self._txn: Optional[bytes] = None

    # -- PEP 249 ------------------------------------------------------------
    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None

    def commit(self) -> None:
        if self._txn is not None:
            self._require().commit(self._txn)
            self._txn = None

    def rollback(self) -> None:
        if self._txn is not None:
            self._require().rollback(self._txn)
            self._txn = None

    def cursor(self) -> "Cursor":
        return Cursor(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internal ------------------------------------------------------------
    def _require(self) -> FlightSQLClient:
        if self._client is None:
            raise InterfaceError("connection is closed")
        return self._client

    def _begin_if_needed(self) -> None:
        """Open the implicit transaction; a server that has no
        transactions leaves the connection in autocommit, as the JAX
        driver does."""
        if self._txn is None:
            try:
                self._txn = self._require().begin_transaction()
            except Exception:
                self._txn = None


_DML_PREFIXES = ("insert", "update", "delete", "create", "drop", "alter",
                 "replace")


def _parameter_table(parameters: Sequence[Any]) -> HostBatch:
    return table({f"p{i}": [v] for i, v in enumerate(parameters)})


class Cursor:
    arraysize = 1

    def __init__(self, conn: Connection):
        self._conn = conn
        self._table: Optional[HostBatch] = None
        self._rows: List[Tuple] = []
        self._pos = 0
        self.rowcount = -1
        self.description: Optional[List[Tuple]] = None

    # -- PEP 249 -------------------------------------------------------------
    def close(self) -> None:
        self._table = None
        self._rows = []

    def execute(self, operation: str, parameters: Sequence[Any] = ()
                ) -> "Cursor":
        client = self._conn._require()
        is_dml = operation.lstrip().lower().startswith(_DML_PREFIXES)
        if is_dml:
            self._conn._begin_if_needed()
            if parameters:
                ps = client.prepare(operation)
                try:
                    self.rowcount = ps.execute_update(
                        _parameter_table(parameters))
                finally:
                    ps.close()
            else:
                self.rowcount = client.execute_update(operation)
            self._set_table(None)
            return self
        if parameters:
            ps = client.prepare(operation)
            try:
                ps.set_parameters(_parameter_table(parameters))
                t = ps.execute()
            finally:
                ps.close()
        else:
            t = client.execute_query(operation)
        self._set_table(t)
        return self

    def executemany(self, operation: str, seq_of_parameters) -> "Cursor":
        client = self._conn._require()
        self._conn._begin_if_needed()
        seq = list(seq_of_parameters)
        if not seq:
            self.rowcount = 0
            return self
        ps = client.prepare(operation)
        try:
            cols = list(zip(*seq))
            self.rowcount = ps.execute_update(
                table({f"p{i}": list(c) for i, c in enumerate(cols)}))
        finally:
            ps.close()
        self._set_table(None)
        return self

    def fetchone(self) -> Optional[Tuple]:
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def fetchmany(self, size: Optional[int] = None) -> List[Tuple]:
        size = size or self.arraysize
        out = self._rows[self._pos:self._pos + size]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[Tuple]:
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def fetch_arrow_table(self):
        """Extension: the whole result set as one Table (the reference
        driver exposes the same through its Rows)."""
        if self._table is None:
            raise ProgrammingError("no result set")
        return self._table

    def setinputsizes(self, sizes) -> None:
        pass

    def setoutputsize(self, size, column=None) -> None:
        pass

    def __iter__(self):
        while True:
            row = self.fetchone()
            if row is None:
                return
            yield row

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- internal -------------------------------------------------------------
    def _set_table(self, t: Optional[HostBatch]) -> None:
        self._table = t
        self._pos = 0
        if t is None:
            self._rows = []
            self.description = None
            return
        self.description = [
            (f.name, f.type.id, None, None, None, None, f.nullable)
            for f in t.schema.fields]
        d = t.to_pydict()
        self._rows = list(zip(*d.values())) if d else []
        self.rowcount = t.num_rows
