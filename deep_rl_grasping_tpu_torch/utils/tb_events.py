"""Minimal TensorBoard event-file writer (no TensorFlow dependency); the
port's own copy of deep_rl_grasping_tpu/utils/tb_events.py.

The reference logs custom scalars (success_rate, curriculum lambda, losses)
to TensorBoard through TF1 summary ops (reference:
manipulation_main/training/sb_helper.py:40-53 TensorboardCallback). This
module writes binary `events.out.tfevents.*` files readable by TensorBoard
by hand-encoding the two protobuf messages involved (Event, Summary) and the
TFRecord framing (length + masked CRC32C), so no TF runtime is needed on the
training host.

Wire format
-----------
TFRecord:  uint64 length | uint32 masked_crc32c(length) | payload
           | uint32 masked_crc32c(payload)
Event:     field 1 wall_time (double), field 2 step (int64),
           field 9 file_version (string, first record only),
           field 5 summary (Summary message)
Summary:   repeated field 1 = Value{ field 1 tag (string),
                                     field 2 simple_value (float) }
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected


def _build_table():
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_POLY if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _field_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _field_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _field_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _summary_value(tag: str, value: float) -> bytes:
    return _field_bytes(1, _field_bytes(1, tag.encode()) + _field_float(2, value))


def encode_event(step: int | None = None, wall_time: float | None = None,
                 scalars: dict | None = None,
                 file_version: str | None = None) -> bytes:
    msg = _field_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        msg += _field_varint(2, int(step))
    if file_version is not None:
        msg += _field_bytes(9, file_version.encode())
    if scalars:
        summary = b"".join(_summary_value(k, float(v)) for k, v in scalars.items())
        msg += _field_bytes(5, summary)
    return msg


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header))
            + payload + struct.pack("<I", masked_crc32c(payload)))


# ---------------------------------------------------------------- writer

class TensorBoardWriter:
    """Append-only scalar writer producing `events.out.tfevents.*` files."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname())
        self._file = open(os.path.join(log_dir, fname), "wb")
        # TensorBoard requires a leading file_version event ("brain.Event:2").
        self._file.write(frame_record(encode_event(file_version="brain.Event:2")))
        self._file.flush()

    def add_scalars(self, step: int, scalars: dict):
        self._file.write(frame_record(encode_event(step=step, scalars=scalars)))
        # Flush per call: records are tens of bytes at chunk cadence, and an
        # unflushed writer loses the whole run's curves on any non-clean exit
        # (the CSV sinks flush per row; the TB file must not be the lossy one).
        self._file.flush()

    def flush(self):
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.flush()
            self._file.close()


# ---------------------------------------------------------------- reader
# (used by tests and scripts/plot.py to load curves without TensorBoard)

def read_events(path: str):
    """Yield (step, wall_time, {tag: value}) from an event file, verifying
    the record CRCs exactly as TensorBoard's RecordReader does."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        (len_crc,) = struct.unpack_from("<I", data, off + 8)
        if masked_crc32c(data[off:off + 8]) != len_crc:
            raise ValueError("length CRC mismatch at offset %d" % off)
        payload = data[off + 12: off + 12 + length]
        (data_crc,) = struct.unpack_from("<I", data, off + 12 + length)
        if masked_crc32c(payload) != data_crc:
            raise ValueError("payload CRC mismatch at offset %d" % off)
        off += 16 + length
        yield _decode_event(payload)


def _read_varint(buf, off):
    val = 0
    shift = 0
    while True:
        b = buf[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7


def _decode_fields(buf):
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, off = _read_varint(buf, off)
        elif wire == 1:
            val = struct.unpack_from("<d", buf, off)[0]
            off += 8
        elif wire == 5:
            val = struct.unpack_from("<f", buf, off)[0]
            off += 4
        elif wire == 2:
            n, off = _read_varint(buf, off)
            val = buf[off:off + n]
            off += n
        else:
            raise ValueError("unsupported wire type %d" % wire)
        yield field, wire, val


def _decode_event(payload):
    step = 0
    wall = 0.0
    scalars = {}
    for field, wire, val in _decode_fields(payload):
        if field == 1 and wire == 1:
            wall = val
        elif field == 2 and wire == 0:
            step = val
        elif field == 5 and wire == 2:
            for f2, w2, v2 in _decode_fields(val):
                if f2 == 1 and w2 == 2:
                    tag = None
                    simple = None
                    for f3, w3, v3 in _decode_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            simple = v3
                    if tag is not None and simple is not None:
                        scalars[tag] = simple
    return step, wall, scalars
