"""Dependency-free TensorBoard scalar event writer.

The port's copy of det3d_tpu/utils/tfevents.py. Replaces the reference's
tensorboardX / torch SummaryWriter dependency (reference:
det3d/torchie/trainer/hooks/logger/tensorboard.py) with a direct
implementation of the TFRecord event-file format: each record is

    [len: uint64le][masked_crc32c(len): uint32le][data][masked_crc32c(data)]

where data is a serialized ``tensorflow.Event`` proto. Only the fields
TensorBoard's scalar dashboard reads are emitted (wall_time, step,
file_version, summary.value{tag, simple_value}), hand-encoded in protobuf
wire format — no protobuf, tensorflow, or torch imports.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, with the TFRecord masking
# ---------------------------------------------------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(wall_time: float, step: int, tag: str,
                  value: float) -> bytes:
    # Summary.Value: tag=1 (string), simple_value=2 (float)
    val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    summary = _f_bytes(1, val)                 # Summary.value = 1 (repeated)
    # Event: wall_time=1 (double), step=2 (int64), summary=5 (message)
    return _f_double(1, wall_time) + _f_varint(2, int(step)) \
        + _f_bytes(5, summary)


def _version_event(wall_time: float) -> bytes:
    # Event.file_version = 3 (string)
    return _f_double(1, wall_time) + _f_bytes(3, b"brain.Event:2")


class TfEventWriter:
    """Scalar-only event writer, API-compatible subset of SummaryWriter."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d" % (
            time.time(), socket.gethostname(), os.getpid())
        self._f = open(os.path.join(log_dir, fname), "wb")
        self._write(_version_event(time.time()))

    def _write(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event)
        self._f.write(struct.pack("<I", _masked_crc(event)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_scalar_event(time.time(), step, tag, value))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()
