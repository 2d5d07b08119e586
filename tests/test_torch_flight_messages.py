"""The port's Flight messages (arrow_go_tpu_torch/flight/messages.py)
against the generated Flight_pb2 of the JAX package: every field of
every message by number, name and type, and random messages' bytes in
both directions (the map fields compared by parsed value)."""
import random

import pytest

pytest.importorskip("google.protobuf")

from google.protobuf.descriptor import FieldDescriptor as FD  # noqa: E402

from arrow_go_tpu.flight import Flight_pb2 as fp  # noqa: E402
from arrow_go_tpu_torch.flight import messages as tm  # noqa: E402

_KIND = {FD.TYPE_UINT64: "uint64", FD.TYPE_INT64: "int64",
         FD.TYPE_INT32: "int32", FD.TYPE_BOOL: "bool", FD.TYPE_ENUM: "enum",
         FD.TYPE_SFIXED64: "sfixed64", FD.TYPE_DOUBLE: "double",
         FD.TYPE_STRING: "string", FD.TYPE_BYTES: "bytes",
         FD.TYPE_MESSAGE: "message"}
NAMES = [m.__name__ for m in tm.MESSAGES]


def _port_class(desc):
    if desc.full_name == "google.protobuf.Timestamp":
        return tm.Timestamp
    if desc.name == "StringListValue":
        return tm.StringListValue
    if desc.full_name.endswith("SetSessionOptionsResult.Error"):
        return tm.SetSessionOptionsError
    return getattr(tm, desc.name)


def test_the_27_messages_and_the_enums():
    assert sorted(NAMES) == sorted(fp.DESCRIPTOR.message_types_by_name)
    assert len(NAMES) == 27
    for e in fp.DESCRIPTOR.enum_types_by_name.values():
        for v in e.values:
            assert getattr(tm, v.name) == v.number
    assert tm.FlightDescriptor.PATH == fp.FlightDescriptor.PATH
    assert tm.FlightDescriptor.CMD == fp.FlightDescriptor.CMD
    assert tm.CloseSessionResult.STATUS_CLOSED == \
        fp.CloseSessionResult.STATUS_CLOSED
    assert tm.SetSessionOptionsResult.ERROR_VALUE_INVALID_NAME == \
        fp.SetSessionOptionsResult.ERROR_VALUE_INVALID_NAME


def _walk(desc, seen):
    if desc.full_name in seen:
        return
    seen.add(desc.full_name)
    yield desc
    for f in desc.fields:
        if f.message_type is not None:
            yield from _walk(f.message_type, seen)


@pytest.mark.parametrize("name", NAMES)
def test_fields_match_the_descriptor(name):
    for desc in _walk(getattr(fp, name).DESCRIPTOR, set()):
        if desc.GetOptions().map_entry:
            continue
        ours = {f.number: f for f in _port_class(desc).FIELDS}
        assert set(ours) == {f.number for f in desc.fields}, desc.full_name
        for f in desc.fields:
            o = ours[f.number]
            assert o.name == f.name
            if f.message_type is not None and \
                    f.message_type.GetOptions().map_entry:
                assert o.kind == "map"
                continue
            assert o.kind == _KIND[f.type], (desc.full_name, f.name)
            assert o.repeated == f.is_repeated
            assert o.presence == f.has_presence, (desc.full_name, f.name)
            oneof = f.containing_oneof
            assert o.oneof == (oneof.name if oneof is not None and
                               not oneof.name.startswith("_") else None)


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
    if t == FD.TYPE_UINT64:
        return rng.choice([0, 1, 2**64 - 1, rng.randrange(2**40)])
    if t in (FD.TYPE_INT64, FD.TYPE_SFIXED64):
        return rng.choice([0, -1, -2**63, 2**63 - 1, rng.randrange(-9, 9)])
    if t == FD.TYPE_INT32:
        return rng.choice([0, -1, 999_999_999, -2**31])
    if t == FD.TYPE_DOUBLE:
        return rng.choice([0.0, -0.0, 0.1, -1e300, 1.0])
    return _random_pair(f.message_type, rng, depth + 1)


def _random_pair(desc, rng, depth=0):
    """(a Flight_pb2 message, the port's equal message) with each field
    set at random."""
    pb = getattr(fp, desc.name, None)
    if desc.full_name == "google.protobuf.Timestamp":
        from google.protobuf import timestamp_pb2
        pb = timestamp_pb2.Timestamp
    elif desc.containing_type is not None:
        pb = getattr(getattr(fp, desc.containing_type.name), desc.name)
    pm, om = pb(), _port_class(desc)()
    oneof_done = set()
    for f in desc.fields:
        if rng.random() < 0.3 or depth > 3:
            continue
        oneof = f.containing_oneof
        if oneof is not None and not oneof.name.startswith("_"):
            if oneof.name in oneof_done:
                continue
            oneof_done.add(oneof.name)
        if f.message_type is not None and \
                f.message_type.GetOptions().map_entry:
            vf = f.message_type.fields_by_name["value"]
            for _ in range(rng.randrange(4)):
                key = rng.choice(["", "k", "key_two", "ü"])
                p, o = _random_pair(vf.message_type, rng, depth + 1)
                getattr(pm, f.name)[key].CopyFrom(p)
                getattr(om, f.name)[key] = o
            continue
        if f.is_repeated:
            for _ in range(rng.randrange(4)):
                v = _value(f, rng, depth)
                if f.message_type is not None:
                    getattr(pm, f.name).add().CopyFrom(v[0])
                    getattr(om, f.name).append(v[1])
                else:
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


def _has_map(desc, seen=None) -> bool:
    return any(f.message_type is not None and
               f.message_type.GetOptions().map_entry
               for d in _walk(desc, set()) for f in d.fields)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", NAMES)
def test_bytes_both_ways(name, seed):
    rng = random.Random(hash((name, seed)) & 0xFFFFFFFF)
    desc = getattr(fp, name).DESCRIPTOR
    pm, om = _random_pair(desc, rng)
    theirs, ours = pm.SerializeToString(), om.SerializeToString()
    if not _has_map(desc):
        assert ours == theirs
    # each side parses the other's bytes to an equal message
    assert _port_class(desc).FromString(theirs) == om
    back = type(pm)()
    back.ParseFromString(ours)
    assert back == pm


def test_presence_and_oneof():
    v = tm.SessionOptionValue(bool_value=False)
    assert v.WhichOneof("option_value") == "bool_value"
    assert v.SerializeToString() == \
        fp.SessionOptionValue(bool_value=False).SerializeToString()
    w = tm.SessionOptionValue.FromString(
        fp.SessionOptionValue(int64_value=0).SerializeToString())
    assert w.WhichOneof("option_value") == "int64_value" and \
        w.int64_value == 0
    p = tm.PollInfo(progress=0.0)
    assert p.HasField("progress") and not p.HasField("info")
    assert p.SerializeToString() == fp.PollInfo(progress=0.0) \
        .SerializeToString()
    assert not tm.PollInfo.FromString(b"").HasField("progress")
    # a negative int64 is ten varint bytes, as protobuf writes it
    info = tm.FlightInfo(total_records=-1, total_bytes=-1)
    assert info.SerializeToString() == fp.FlightInfo(
        total_records=-1, total_bytes=-1).SerializeToString()
    assert tm.FlightInfo.FromString(info.SerializeToString()) \
        .total_records == -1


def test_unknown_fields_are_skipped():
    raw = fp.FlightData(data_header=b"h", data_body=b"b",
                        app_metadata=b"m").SerializeToString()
    assert tm.Ticket.FromString(raw) == tm.Ticket()
    with pytest.raises(TypeError):
        tm.Ticket(nope=1)
