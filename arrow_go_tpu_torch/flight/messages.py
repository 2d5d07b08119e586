"""The messages of Flight.proto (arrow.flight.protocol) on the port's
protobuf wire codec (interop/protowire.py), in place of the generated
Flight_pb2: the 27 top-level messages with their nested messages and
enums, the CancelStatus enum and google.protobuf.Timestamp.

Each message class lists its fields as (number, name, kind); the codec
writes them in field-number order and skips a proto3 scalar at its
default, as protobuf serializes, so the bytes equal Flight_pb2's (a
map's entries go in insertion order, which protobuf leaves undefined; a
repeated number is packed, as proto3 writes it, and read packed or
not). A map's `sub` is its value's message class, or "string".
A message field or an explicit-presence field (`optional`, a oneof
member) is None when unset. The method names follow the generated
classes: `SerializeToString`, `FromString`, `HasField`, `WhichOneof`.
"""
from __future__ import annotations

import math
import struct
from typing import Dict, Optional, Tuple

from ..interop import protowire as pw

_VARINT = {"uint64", "uint32", "int64", "int32", "bool", "enum"}
_SIGNED = {"int64", "int32", "enum"}


class Field:
    __slots__ = ("number", "name", "kind", "sub", "repeated", "presence",
                 "oneof")

    def __init__(self, number: int, name: str, kind: str, sub=None,
                 repeated: bool = False, presence: bool = False,
                 oneof: Optional[str] = None):
        self.number, self.name, self.kind, self.sub = number, name, kind, sub
        self.repeated, self.oneof = repeated, oneof
        self.presence = not repeated and (
            presence or oneof is not None or kind == "message")

    def default(self):
        if self.kind == "map":
            return {}
        if self.repeated:
            return []
        if self.presence:
            return None
        return {"string": "", "bytes": b"", "bool": False,
                "double": 0.0}.get(self.kind, 0)


class Message:
    """A message: keyword construction, bytes both ways, presence."""

    FIELDS: Tuple[Field, ...] = ()

    def __init__(self, **kw):
        for f in self.FIELDS:
            setattr(self, f.name, f.default())
        for k, v in kw.items():
            if k not in self._by_name():
                raise TypeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, list(v) if isinstance(v, tuple) else v)

    @classmethod
    def _by_name(cls) -> Dict[str, Field]:
        d = cls.__dict__.get("_names")
        if d is None:
            d = {f.name: f for f in cls.FIELDS}
            cls._names = d
        return d

    @classmethod
    def _by_number(cls) -> Dict[int, Field]:
        d = cls.__dict__.get("_numbers")
        if d is None:
            d = {f.number: f for f in cls.FIELDS}
            cls._numbers = d
        return d

    # -- presence ----------------------------------------------------------

    def HasField(self, name: str) -> bool:
        f = self._by_name()[name]
        if not f.presence:
            raise ValueError(f"field {name!r} has no presence")
        return getattr(self, name) is not None

    def WhichOneof(self, group: str) -> Optional[str]:
        for f in self.FIELDS:
            if f.oneof == group and getattr(self, f.name) is not None:
                return f.name
        return None

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and all(
            getattr(self, f.name) == getattr(other, f.name)
            for f in self.FIELDS)

    def __repr__(self) -> str:
        parts = [f"{f.name}={getattr(self, f.name)!r}" for f in self.FIELDS
                 if getattr(self, f.name) != f.default()]
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- encoding ------------------------------------------------------------

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for f in sorted(self.FIELDS, key=lambda f: f.number):
            v = getattr(self, f.name)
            if f.kind == "map":
                for k, mv in v.items():
                    entry = bytearray()
                    pw.put_field_str(entry, 1, k)
                    if f.sub == "string":
                        pw.put_field_str(entry, 2, mv)
                    else:
                        pw.put_field_bytes(entry, 2, mv.SerializeToString())
                    pw.put_field_bytes(out, f.number, bytes(entry))
            elif f.repeated and f.kind in _VARINT:
                if v:
                    packed = bytearray()
                    for x in v:
                        pw.put_varint(packed, int(x))
                    pw.put_field_bytes(out, f.number, bytes(packed))
            elif f.repeated:
                for x in v:
                    _put(out, f, x)
            elif f.presence:
                if v is not None:
                    _put(out, f, v)
            elif _nonzero(v):
                _put(out, f, v)
        return bytes(out)

    @classmethod
    def FromString(cls, data) -> "Message":
        msg = cls()
        nums = cls._by_number()
        for number, wt, raw in pw.fields(data):
            f = nums.get(number)
            if f is not None and f.repeated and f.kind in _VARINT and \
                    wt == pw.WT_BYTES:
                raw, p = bytes(raw), 0
                while p < len(raw):
                    x, p = pw.get_varint(raw, p)
                    getattr(msg, f.name).append(_get(f, x))
                continue
            if f is None or wt != _wire_type(f):
                continue                          # an unknown field
            if f.kind == "map":
                d = pw.to_dict(raw)
                key = bytes(pw.first(d, 1, b"")).decode("utf-8")
                value = pw.first(d, 2, b"")
                getattr(msg, f.name)[key] = (
                    bytes(value).decode("utf-8") if f.sub == "string"
                    else f.sub.FromString(value))
                continue
            v = _get(f, raw)
            if f.repeated:
                getattr(msg, f.name).append(v)
                continue
            if f.oneof is not None:
                for g in cls.FIELDS:
                    if g.oneof == f.oneof:
                        setattr(msg, g.name, None)
            setattr(msg, f.name, v)
        return msg


def _nonzero(v) -> bool:
    if isinstance(v, float):
        return v != 0.0 or math.copysign(1.0, v) < 0
    return bool(v)


def _wire_type(f: Field) -> int:
    if f.kind in _VARINT:
        return pw.WT_VARINT
    if f.kind in ("double", "sfixed64"):
        return pw.WT_FIXED64
    return pw.WT_BYTES


def _put(out: bytearray, f: Field, v) -> None:
    if f.kind in _VARINT:
        pw.put_field_varint(out, f.number, int(v))
    elif f.kind == "double":
        pw.put_field_double(out, f.number, v)
    elif f.kind == "sfixed64":
        pw.tag(out, f.number, pw.WT_FIXED64)
        out.extend(struct.pack("<q", v))
    elif f.kind == "string":
        pw.put_field_str(out, f.number, v)
    elif f.kind == "bytes":
        pw.put_field_bytes(out, f.number, bytes(v))
    else:                                          # a message
        pw.put_field_bytes(out, f.number, v.SerializeToString())


def _get(f: Field, raw):
    if f.kind in _VARINT:
        if f.kind == "bool":
            return bool(raw)
        if f.kind in _SIGNED and raw >= 1 << 63:
            raw -= 1 << 64
        return raw
    if f.kind == "double":
        return struct.unpack("<d", bytes(raw))[0]
    if f.kind == "sfixed64":
        return struct.unpack("<q", bytes(raw))[0]
    if f.kind == "string":
        return bytes(raw).decode("utf-8")
    if f.kind == "bytes":
        return bytes(raw)
    return f.sub.FromString(raw)


def _message(name: str, *fields: Field, **consts) -> type:
    return type(name, (Message,), {"FIELDS": fields, **consts})


# --------------------------------------------------------------------------
# google.protobuf.Timestamp and the enums
# --------------------------------------------------------------------------

Timestamp = _message("Timestamp", Field(1, "seconds", "int64"),
                     Field(2, "nanos", "int32"))

CANCEL_STATUS_UNSPECIFIED = 0
CANCEL_STATUS_CANCELLED = 1
CANCEL_STATUS_CANCELLING = 2
CANCEL_STATUS_NOT_CANCELLABLE = 3

# --------------------------------------------------------------------------
# Flight.proto
# --------------------------------------------------------------------------

HandshakeRequest = _message("HandshakeRequest",
                            Field(1, "protocol_version", "uint64"),
                            Field(2, "payload", "bytes"))
HandshakeResponse = _message("HandshakeResponse",
                             Field(1, "protocol_version", "uint64"),
                             Field(2, "payload", "bytes"))
BasicAuth = _message("BasicAuth", Field(2, "username", "string"),
                     Field(3, "password", "string"))
Empty = _message("Empty")
ActionType = _message("ActionType", Field(1, "type", "string"),
                      Field(2, "description", "string"))
Criteria = _message("Criteria", Field(1, "expression", "bytes"))
Action = _message("Action", Field(1, "type", "string"),
                  Field(2, "body", "bytes"))
Result = _message("Result", Field(1, "body", "bytes"))
SchemaResult = _message("SchemaResult", Field(1, "schema", "bytes"))
FlightDescriptor = _message(
    "FlightDescriptor", Field(1, "type", "enum"), Field(2, "cmd", "bytes"),
    Field(3, "path", "string", repeated=True),
    UNKNOWN=0, PATH=1, CMD=2)
Ticket = _message("Ticket", Field(1, "ticket", "bytes"))
Location = _message("Location", Field(1, "uri", "string"))
FlightEndpoint = _message(
    "FlightEndpoint", Field(1, "ticket", "message", Ticket),
    Field(2, "location", "message", Location, repeated=True),
    Field(3, "expiration_time", "message", Timestamp),
    Field(4, "app_metadata", "bytes"))
FlightInfo = _message(
    "FlightInfo", Field(1, "schema", "bytes"),
    Field(2, "flight_descriptor", "message", FlightDescriptor),
    Field(3, "endpoint", "message", FlightEndpoint, repeated=True),
    Field(4, "total_records", "int64"), Field(5, "total_bytes", "int64"),
    Field(6, "ordered", "bool"), Field(7, "app_metadata", "bytes"))
PollInfo = _message(
    "PollInfo", Field(1, "info", "message", FlightInfo),
    Field(2, "flight_descriptor", "message", FlightDescriptor),
    Field(3, "progress", "double", presence=True),
    Field(4, "expiration_time", "message", Timestamp))
CancelFlightInfoRequest = _message(
    "CancelFlightInfoRequest", Field(1, "info", "message", FlightInfo))
RenewFlightEndpointRequest = _message(
    "RenewFlightEndpointRequest",
    Field(1, "endpoint", "message", FlightEndpoint))
CancelFlightInfoResult = _message("CancelFlightInfoResult",
                                  Field(1, "status", "enum"))
FlightData = _message(
    "FlightData", Field(1, "flight_descriptor", "message", FlightDescriptor),
    Field(2, "data_header", "bytes"), Field(3, "app_metadata", "bytes"),
    Field(1000, "data_body", "bytes"))
PutResult = _message("PutResult", Field(1, "app_metadata", "bytes"))

StringListValue = _message("StringListValue",
                           Field(1, "values", "string", repeated=True))
SessionOptionValue = _message(
    "SessionOptionValue",
    Field(1, "string_value", "string", oneof="option_value"),
    Field(2, "bool_value", "bool", oneof="option_value"),
    Field(3, "int64_value", "sfixed64", oneof="option_value"),
    Field(4, "double_value", "double", oneof="option_value"),
    Field(5, "string_list_value", "message", StringListValue,
          oneof="option_value"),
    StringListValue=StringListValue)
SetSessionOptionsRequest = _message(
    "SetSessionOptionsRequest",
    Field(1, "session_options", "map", SessionOptionValue))
SetSessionOptionsError = _message("Error", Field(1, "value", "enum"))
SetSessionOptionsResult = _message(
    "SetSessionOptionsResult",
    Field(1, "errors", "map", SetSessionOptionsError),
    Error=SetSessionOptionsError, ERROR_VALUE_UNSPECIFIED=0,
    ERROR_VALUE_INVALID_NAME=1, ERROR_VALUE_INVALID_VALUE=2,
    ERROR_VALUE_ERROR=3)
GetSessionOptionsRequest = _message("GetSessionOptionsRequest")
GetSessionOptionsResult = _message(
    "GetSessionOptionsResult",
    Field(1, "session_options", "map", SessionOptionValue))
CloseSessionRequest = _message("CloseSessionRequest")
CloseSessionResult = _message(
    "CloseSessionResult", Field(1, "status", "enum"),
    STATUS_UNSPECIFIED=0, STATUS_CLOSED=1, STATUS_CLOSING=2,
    STATUS_NOT_CLOSEABLE=3)

MESSAGES = (HandshakeRequest, HandshakeResponse, BasicAuth, Empty,
            ActionType, Criteria, Action, CancelFlightInfoRequest,
            RenewFlightEndpointRequest, Result, CancelFlightInfoResult,
            SchemaResult, FlightDescriptor, FlightInfo, PollInfo,
            FlightEndpoint, Location, Ticket, FlightData, PutResult,
            SessionOptionValue, SetSessionOptionsRequest,
            SetSessionOptionsResult, GetSessionOptionsRequest,
            GetSessionOptionsResult, CloseSessionRequest,
            CloseSessionResult)
