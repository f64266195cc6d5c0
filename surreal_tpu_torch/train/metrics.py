"""Metrics sink: TensorBoard scalars (port of surreal_tpu/train/metrics.py).

Tags are `<section>/<key>` ("learner/kl", "eval/return_mean"), as in the
reference. The event file is written here directly, since the card's
machine has no tensorboard package: TFRecord framing (a little-endian
uint64 length, its masked CRC-32C, the bytes, their masked CRC-32C) around
hand-encoded `Event{wall_time, step, summary{value{tag, simple_value}}}`
protocol buffers, after a first `Event{wall_time, file_version}`.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Mapping


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def _masked_crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # int64 as protobuf encodes it
    while True:
        byte, n = n & 0x7F, n >> 7
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, *, file_version: str | None = None,
           tag: str | None = None, value: float = 0.0) -> bytes:
    out = b"\x09" + struct.pack("<d", wall_time)  # field 1, double
    if step:
        out += b"\x10" + _varint(step)  # field 2, int64
    if file_version is not None:
        out += _field(3, file_version.encode())
    if tag is not None:
        summary_value = _field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
        out += _field(5, _field(1, summary_value))  # summary { value { ... } }
    return out


def _record(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", _masked_crc32c(length)) + data
            + struct.pack("<I", _masked_crc32c(data)))


class MetricsWriter:
    """TensorBoard event-file writer; `logdir=None` writes nothing."""

    def __init__(self, logdir: str | None, section: str = "learner",
                 flush_every_s: float = 10.0):
        self.section = section
        self._file = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
            self._file = open(os.path.join(logdir, name), "wb")
            self._file.write(_record(_event(time.time(), file_version="brain.Event:2")))
        self._last_flush = time.monotonic()
        self._flush_every = flush_every_s

    def write(self, step: int, scalars: Mapping[str, float], section: str | None = None) -> None:
        sec = section or self.section
        if self._file is None:
            return
        for k, v in scalars.items():
            self._file.write(_record(_event(time.time(), int(step), tag=f"{sec}/{k}",
                                            value=float(v))))
        if time.monotonic() - self._last_flush > self._flush_every:
            self._file.flush()
            self._last_flush = time.monotonic()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
