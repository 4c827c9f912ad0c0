"""TensorBoard-compatible event writer (``rtfs_net_tpu/system/tb_writer.py``;
reference: vendored rank-zero ``TensorBoardLogger``,
``src/system/tensorboard.py:40-294``).

Self-contained: hand-encodes the Event protobuf wire format and the
tfevents record framing (length + masked CRC32C: the repo's native
extension's ``crc32c`` where it builds, else a pure-Python table, as the
JAX writer does), so scalar and hparams logging needs neither the
tensorboard package nor protobuf. Files are readable by standard
TensorBoard.
"""
from __future__ import annotations

import functools
import os
import socket
import struct
import time
from typing import Dict


# ----------------------------------------------------------------- crc32c
def _make_crc_table():
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


@functools.cache
def _native_crc32c():
    """The native extension's ``crc32c``, or None where it does not build
    (resolved at the first record, so importing this module builds nothing)."""
    from .._native import load_native

    native = load_native()
    return getattr(native, "crc32c", None)


def crc32c_py(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes) -> int:
    native = _native_crc32c()
    return native(data) if native is not None else crc32c_py(data)


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_string(field: int, s: bytes) -> bytes:
    return _key(field, 2) + _varint(len(s)) + s


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _summary_value(tag: str, value: float) -> bytes:
    inner = _pb_string(1, tag.encode()) + _pb_float(2, float(value))
    return _pb_string(1, inner)  # Summary.value (field 1, repeated)


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    return _pb_double(1, wall_time) + _pb_varint(2, step) + body


class EventWriter:
    """Append-only tfevents file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._write_event(_event(time.time(), 0, _pb_string(3, b"brain.Event:2")))

    def _write_event(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        body = _pb_string(5, _summary_value(tag, value))
        self._write_event(_event(time.time(), step, body))

    def close(self):
        self._f.close()


class TensorBoardLogger:
    """Scalar logger with an hparams yaml dump, writing under
    ``<save_dir>/<name>/<version>``."""

    def __init__(self, save_dir: str, name: str = "default", version: str = "version_0"):
        self.log_dir = os.path.join(save_dir, name, version)
        self._writer = None

    def add_scalar(self, tag: str, value, step: int):
        if self._writer is None:
            self._writer = EventWriter(self.log_dir)
        self._writer.add_scalar(tag, float(value), int(step))

    def log_hyperparams(self, params: Dict):
        import yaml

        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "hparams.yaml"), "w") as f:
            yaml.safe_dump(_sanitize(params), f)

    def finalize(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def _sanitize(obj):
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if obj is None or isinstance(obj, (int, float, str, bool)):
        return obj
    return str(obj)
