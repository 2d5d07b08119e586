"""The hand-framed FlightData wire codec, the data plane (after
arrow_go_tpu/flight/wire.py; reference record_batch_writer.go:97,
record_batch_reader.go:40-70). FlightData's protobuf wire shape
(flight_descriptor = 1, data_header = 2, app_metadata = 3,
data_body = 1000) is framed by hand on interop/protowire.py so that:

  send:    each IPC body buffer is written once, straight into the DATA
           frames (the serialized message is a list of buffers that
           rpc.py hands to `sendmsg` unjoined);
  receive: data_body is a memoryview of the received message.
"""
from __future__ import annotations

import queue
import threading
from typing import List, Optional, Sequence, Union

from ..interop import protowire as pw
from . import messages as fm

_TAG_DESC = (1 << 3) | pw.WT_BYTES
_TAG_HEADER = (2 << 3) | pw.WT_BYTES
_TAG_APPMETA = (3 << 3) | pw.WT_BYTES
_TAG_BODY = (1000 << 3) | pw.WT_BYTES


def _vint(v: int) -> bytes:
    b = bytearray()
    pw.put_varint(b, v)
    return bytes(b)


class RawFlightData:
    """FlightData on the data plane: `data_body` is a buffer or a list of
    buffer parts, written into the frame without a join."""

    __slots__ = ("data_header", "app_metadata", "_body_parts", "_body_len",
                 "_descriptor_bytes", "_descriptor")

    def __init__(self, data_header: bytes = b"", body_parts: Sequence = (),
                 body_len: Optional[int] = None, app_metadata: bytes = b"",
                 descriptor_bytes: Optional[bytes] = None,
                 flight_descriptor=None):
        self.data_header = data_header
        self.app_metadata = app_metadata
        self._body_parts = list(body_parts)
        self._body_len = (sum(len(p) for p in self._body_parts)
                          if body_len is None else body_len)
        self._descriptor = flight_descriptor
        self._descriptor_bytes = descriptor_bytes
        if flight_descriptor is not None and descriptor_bytes is None:
            self._descriptor_bytes = flight_descriptor.SerializeToString()

    def HasField(self, name: str) -> bool:
        if name == "flight_descriptor":
            return self._descriptor_bytes is not None
        raise ValueError(name)

    @property
    def flight_descriptor(self) -> Optional[fm.Message]:
        if self._descriptor is None and self._descriptor_bytes is not None:
            self._descriptor = fm.FlightDescriptor.FromString(
                self._descriptor_bytes)
        return self._descriptor

    @property
    def data_body(self) -> Union[bytes, memoryview]:
        if len(self._body_parts) == 1:
            return self._body_parts[0]
        return b"".join(bytes(p) for p in self._body_parts)

    def serialize(self) -> List:
        """The message as buffers: tags and lengths, the header, and the
        body's parts as they are."""
        pieces: List = []
        if self._descriptor_bytes:
            pieces += [_vint(_TAG_DESC), _vint(len(self._descriptor_bytes)),
                       self._descriptor_bytes]
        pieces += [_vint(_TAG_HEADER), _vint(len(self.data_header)),
                   self.data_header]
        if self.app_metadata:
            pieces += [_vint(_TAG_APPMETA), _vint(len(self.app_metadata)),
                       self.app_metadata]
        pieces += [_vint(_TAG_BODY), _vint(self._body_len)]
        pieces.extend(self._body_parts)
        return pieces


def serialize_flight_data(msg):
    """The rpc serializer of FlightData: a RawFlightData's buffers, a list
    already framed by pipeline_frames as it is, a message's bytes."""
    if isinstance(msg, RawFlightData):
        return msg.serialize()
    if isinstance(msg, list):
        return msg
    return msg.SerializeToString()


def pipeline_frames(stream, depth: int = 2):
    """Frames FlightData on a worker thread, `depth` messages ahead of
    the consumer, so that framing overlaps the socket writes. Closing the
    generator stops the worker, which closes `stream`."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done, stop = object(), threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        it = iter(stream)
        try:
            for fd in it:
                if not put(serialize_flight_data(fd)):
                    return
            put(done)
        except BaseException as e:          # surfaced to the consumer
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None and stop.is_set():
                close()

    t = threading.Thread(target=worker, daemon=True, name="flight-frames")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def parse_flight_data(buf) -> RawFlightData:
    """The rpc deserializer of FlightData: data_body stays a memoryview
    of `buf`."""
    mv = memoryview(buf)
    header = app_meta = b""
    desc_bytes: Optional[bytes] = None
    body: List = []
    blen = 0
    for field, wt, val in pw.fields(mv):
        if wt != pw.WT_BYTES:
            continue
        if field == 2:
            header = bytes(val)
        elif field == 1000:
            body, blen = [val], len(val)
        elif field == 1:
            desc_bytes = bytes(val)
        elif field == 3:
            app_meta = bytes(val)
    return RawFlightData(data_header=header, body_parts=body, body_len=blen,
                         app_metadata=app_meta, descriptor_bytes=desc_bytes)
