"""TensorBoard event-file writer without dependencies (the port's own copy
of ``rsuper_tpu/utils/tb_events.py``).

Scalar events are serialised with a small hand-written protobuf encoder
into the TFRecord framing TensorBoard reads (length + masked-crc32c header,
payload, payload crc), so no tensorflow or tensorboardX is needed.

Wire format (tensorboard.compat.proto.event_pb2):
  Event   { double wall_time = 1; int64 step = 2;
            string file_version = 3; Summary summary = 5; }
  Summary { repeated Value value = 1; }
  Value   { string tag = 1; float simple_value = 2; }
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f64(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _f32(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _int(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: Optional[int] = None,
           file_version: Optional[str] = None,
           summary: Optional[bytes] = None) -> bytes:
    msg = _f64(1, wall_time)
    if step is not None:
        msg += _int(2, step)
    if file_version is not None:
        msg += _bytes(3, file_version.encode())
    if summary is not None:
        msg += _bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _bytes(1, tag.encode()) + _f32(2, float(value))
    return _bytes(1, val)


class EventWriter:
    """Append scalar events to ``events.out.tfevents.<ts>.<host>``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        rec = (header + struct.pack("<I", _masked_crc(header))
               + payload + struct.pack("<I", _masked_crc(payload)))
        with open(self.path, "ab") as f:
            f.write(rec)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step=int(step),
                           summary=_scalar_summary(tag, value)))

    def flush(self) -> None:  # records are written synchronously
        pass
