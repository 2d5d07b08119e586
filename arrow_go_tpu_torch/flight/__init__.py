"""Arrow Flight RPC of the port (mirrors arrow_go_tpu.flight, reference
arrow/flight) on its own gRPC: `hpack` and `h2` (HTTP/2 with prior
knowledge over a socket), `rpc` (gRPC's framing, status and metadata; a
client channel and a threaded server), `messages` (Flight.proto on the
port's protobuf wire codec), `wire` (the hand-framed FlightData data
plane), `service`, `session`, `sql_messages` (FlightSql.proto), `sql`
(Flight SQL: the dispatching server, the client and the SQLite example
server), `dbapi` (the PEP 249 driver) and `integration` (the scenarios).
It imports no grpc, protobuf or pyarrow."""
from . import messages  # noqa: F401
from .rpc import RpcError, StatusCode  # noqa: F401
from .service import (Action, FlightClient, FlightDataReader,  # noqa: F401
                      FlightDescriptor, FlightEndpoint, FlightInfo,
                      FlightServerBase, Result, Ticket,
                      batches_to_flight_data)
from . import sql_messages  # noqa: F401
from .sql import (FlightSQLClient, FlightSQLServerBase,  # noqa: F401
                  PreparedStatement, SQLiteFlightSQLServer, SqlInfo)
from .session import CookieMiddleware, Session, SessionManager  # noqa: F401
from . import dbapi  # noqa: F401  (PEP 249 driver, database/sql analog)
