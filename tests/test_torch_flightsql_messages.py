"""The port's FlightSql.proto messages
(arrow_go_tpu_torch/flight/sql_messages.py) against the generated
FlightSql_pb2 of the JAX package: every field of every message by
number, name, type and presence; every message, and Any, built with its
fields set gives FlightSql_pb2's bytes (the map field compared by parsed
value) and reads FlightSql_pb2's bytes back field by field."""
import random

import pytest

pytest.importorskip("google.protobuf")

from google.protobuf import any_pb2  # noqa: E402
from google.protobuf.descriptor import FieldDescriptor as FD  # noqa: E402

from arrow_go_tpu.flight import FlightSql_pb2 as sp  # noqa: E402
from arrow_go_tpu.flight import sql as jsql  # noqa: E402
from arrow_go_tpu_torch.compute.errors import ArrowNotImplemented  # noqa: E402
from arrow_go_tpu_torch.flight import sql_messages as tm  # noqa: E402

_KIND = {FD.TYPE_UINT64: "uint64", FD.TYPE_UINT32: "uint32",
         FD.TYPE_INT64: "int64", FD.TYPE_INT32: "int32",
         FD.TYPE_BOOL: "bool", FD.TYPE_ENUM: "enum",
         FD.TYPE_STRING: "string", FD.TYPE_BYTES: "bytes",
         FD.TYPE_MESSAGE: "message"}
NAMES = [m.__name__ for m in tm.MESSAGES]


def _port_class(desc):
    if desc.full_name == "google.protobuf.Any":
        return tm.Any
    return getattr(tm, desc.name)


def _pb_class(desc):
    if desc.full_name == "google.protobuf.Any":
        return any_pb2.Any
    if desc.containing_type is not None:
        return getattr(getattr(sp, desc.containing_type.name), desc.name)
    return getattr(sp, desc.name)


def _descriptor(name):
    return any_pb2.Any.DESCRIPTOR if name == "Any" else \
        getattr(sp, name).DESCRIPTOR


def test_the_32_messages_and_their_enums():
    assert sorted(NAMES) == sorted(sp.DESCRIPTOR.message_types_by_name)
    assert len(NAMES) == 32
    for name in NAMES:
        for e in getattr(sp, name).DESCRIPTOR.enum_types:
            for v in e.values:
                assert getattr(getattr(tm, name), v.name) == v.number
    tdo = sp.CommandStatementIngest.TableDefinitionOptions
    for e in tdo.DESCRIPTOR.enum_types:
        for v in e.values:
            assert getattr(tm.CommandStatementIngest.TableDefinitionOptions,
                           v.name) == v.number
    for k, v in vars(jsql.SqlInfo).items():
        if not k.startswith("_"):
            assert getattr(tm.SqlInfo, k) == v


def _walk(desc, seen):
    if desc.full_name in seen:
        return
    seen.add(desc.full_name)
    yield desc
    for f in desc.fields:
        if f.message_type is not None:
            yield from _walk(f.message_type, seen)


@pytest.mark.parametrize("name", NAMES + ["Any"])
def test_fields_match_the_descriptor(name):
    for desc in _walk(_descriptor(name), set()):
        if desc.GetOptions().map_entry:
            continue
        ours = {f.number: f for f in _port_class(desc).FIELDS}
        assert set(ours) == {f.number for f in desc.fields}, desc.full_name
        for f in desc.fields:
            o = ours[f.number]
            assert o.name == f.name
            if f.message_type is not None and \
                    f.message_type.GetOptions().map_entry:
                assert o.kind == "map" and o.sub == "string"
                continue
            assert o.kind == _KIND[f.type], (desc.full_name, f.name)
            assert o.repeated == f.is_repeated
            assert o.presence == f.has_presence, (desc.full_name, f.name)


def _value(f, rng, depth):
    t = f.type
    if t == FD.TYPE_STRING:
        return rng.choice(["", "a", "ünïcode", "x" * rng.randrange(200)])
    if t == FD.TYPE_BYTES:
        return bytes(rng.randrange(256) for _ in range(rng.randrange(300)))
    if t == FD.TYPE_BOOL:
        return rng.random() < 0.5
    if t == FD.TYPE_ENUM:
        return rng.choice([v.number for v in f.enum_type.values])
    if t == FD.TYPE_UINT32:
        return rng.choice([0, 1, 508, 2**32 - 1, rng.randrange(2**20)])
    if t == FD.TYPE_INT64:
        return rng.choice([0, -1, -2**63, 2**63 - 1, rng.randrange(-9, 9)])
    if t == FD.TYPE_INT32:
        return rng.choice([0, -1, -3, 12, 2**31 - 1, -2**31])
    return _random_pair(f.message_type, rng, depth + 1)


def _random_pair(desc, rng, depth=0):
    """(a FlightSql_pb2 message, the port's equal message) with each
    field set at random (an optional field sometimes set to its default,
    which it still writes)."""
    pm, om = _pb_class(desc)(), _port_class(desc)()
    for f in desc.fields:
        if rng.random() < 0.25 or depth > 3:
            continue
        if f.message_type is not None and \
                f.message_type.GetOptions().map_entry:
            for _ in range(rng.randrange(4)):
                key = rng.choice(["", "k", "key_two", "ü"])
                val = rng.choice(["", "v", "välue"])
                getattr(pm, f.name)[key] = val
                getattr(om, f.name)[key] = val
            continue
        if f.is_repeated:
            for _ in range(rng.randrange(5)):
                v = _value(f, rng, depth)
                getattr(pm, f.name).append(v)
                getattr(om, f.name).append(v)
            continue
        v = _value(f, rng, depth)
        if f.message_type is not None:
            getattr(pm, f.name).CopyFrom(v[0])
            setattr(om, f.name, v[1])
        else:
            setattr(pm, f.name, v)
            setattr(om, f.name, v)
    return pm, om


def _has_map(desc) -> bool:
    return any(f.message_type is not None and
               f.message_type.GetOptions().map_entry
               for d in _walk(desc, set()) for f in d.fields)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", NAMES + ["Any"])
def test_bytes_both_ways(name, seed):
    rng = random.Random(hash((name, seed)) & 0xFFFFFFFF)
    desc = _descriptor(name)
    pm, om = _random_pair(desc, rng)
    theirs, ours = pm.SerializeToString(), om.SerializeToString()
    if not _has_map(desc):
        assert ours == theirs
    # each side reads the other's bytes to an equal message, field by
    # field, presence included
    back = _port_class(desc).FromString(theirs)
    assert back == om
    for f in desc.fields:
        if f.has_presence:
            assert back.HasField(f.name) == pm.HasField(f.name), f.name
    again = type(pm)()
    again.ParseFromString(ours)
    assert again == pm


@pytest.mark.parametrize("name", NAMES)
def test_pack_any_matches_protobuf_any(name):
    rng = random.Random(name)
    pm, om = _random_pair(getattr(sp, name).DESCRIPTOR, rng)
    theirs = jsql.pack_any(pm)
    if not _has_map(pm.DESCRIPTOR):
        assert tm.pack_any(om) == theirs
    assert tm.unpack_any(theirs) == om
    assert jsql.unpack_any(tm.pack_any(om)) == pm


def test_unpack_any_refusals_and_foreign_urls():
    bad = tm.Any(type_url="type.googleapis.com/x.y.NoSuchCommand").\
        SerializeToString()
    with pytest.raises(ArrowNotImplemented, match="flight sql command"):
        tm.unpack_any(bad)
    # a known name outside the package: an unset message, as Any.Unpack
    # leaves it in the JAX package
    other = tm.Any(type_url="type.googleapis.com/other.CommandStatementQuery",
                   value=tm.CommandStatementQuery(query="q")
                   .SerializeToString()).SerializeToString()
    assert tm.unpack_any(other) == tm.CommandStatementQuery()
    assert jsql.unpack_any(other) == sp.CommandStatementQuery()


def test_packed_and_unpacked_repeated_numbers_read_alike():
    packed = sp.CommandGetSqlInfo(info=[0, 508, 2**32 - 1]) \
        .SerializeToString()
    unpacked = b"".join(b"\x08" + bytes(v) for v in ([0], [0xFC, 0x03]))
    assert tm.CommandGetSqlInfo.FromString(packed).info == [0, 508,
                                                           2**32 - 1]
    assert tm.CommandGetSqlInfo.FromString(unpacked).info == [0, 508]
    assert tm.CommandGetSqlInfo().SerializeToString() == b""
