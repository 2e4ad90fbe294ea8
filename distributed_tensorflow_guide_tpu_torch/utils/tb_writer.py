"""Minimal TensorBoard scalar-event writer — no TF dependency.

Reference equivalent: TensorFlow's ``SummarySaverHook`` writing TF
``Event`` protos that TensorBoard renders. Neither ``tensorboard`` nor
``tensorflow`` is a dependency, so this module hand-encodes the two tiny
protos involved and the TFRecord framing around them — ~100 lines,
stdlib only, and the output opens in stock TensorBoard.

Wire format (tensorflow/core/util/event.proto, …/framework/summary.proto,
…/lib/io/record_writer):

    record  := len:uint64le  masked_crc32c(len):uint32le
               data:bytes    masked_crc32c(data):uint32le
    Event   := 1: wall_time (double)  2: step (int64)
               3: file_version (string, first record only)  5: Summary
    Summary := 1: repeated Value { 1: tag (string), 2: simple_value (float) }

crc32c is the Castagnoli CRC (not zlib's crc32); masking is TF's
``((crc >> 15) | (crc << 17)) + 0xa282ead8``.
"""

from __future__ import annotations

import socket
import struct
import time
from pathlib import Path
from typing import Mapping

# -- crc32c (Castagnoli, reflected poly 0x82F63B78), table-driven ------------

_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf encoding ----------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _scalar_summary(values: Mapping[str, float]) -> bytes:
    out = b""
    for tag, v in values.items():
        val = (_len_field(1, tag.encode()) +
               _field(2, 5) + struct.pack("<f", float(v)))
        out += _len_field(1, val)
    return out


def _event(wall_time: float, step: int, *, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    ev = _field(1, 1) + struct.pack("<d", wall_time)
    ev += _field(2, 0) + _varint(step)
    if file_version is not None:
        ev += _len_field(3, file_version.encode())
    if summary is not None:
        ev += _len_field(5, summary)
    return ev


def _record(data: bytes) -> bytes:
    hdr = struct.pack("<Q", len(data))
    return (hdr + struct.pack("<I", _masked_crc(hdr)) +
            data + struct.pack("<I", _masked_crc(data)))


class SummaryWriter:
    """Append scalar events to an ``events.out.tfevents.*`` file in
    ``logdir``; TensorBoard picks it up live."""

    def __init__(self, logdir: str | Path):
        self.logdir = Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._fh = (self.logdir / name).open("ab")
        self._fh.write(_record(_event(time.time(), 0,
                                      file_version="brain.Event:2")))
        self._fh.flush()

    def scalars(self, step: int, values: Mapping[str, float]) -> None:
        ev = _event(time.time(), step, summary=_scalar_summary(values))
        self._fh.write(_record(ev))
        # flush per event: records must survive a crash/SIGKILL (the fault
        # mode runtime/multiprocess injects) and be visible to a live
        # TensorBoard; event volume is low (scalars only)
        self._fh.flush()

    def log_metrics(self, snapshot: Mapping[str, object],
                    step: int) -> None:
        """Write an ``obs.metrics Registry.snapshot()`` as one scalar
        event: plain counters/gauges keep their (labeled) name, histogram
        dicts expand to ``<name>_count`` / ``<name>_sum`` (bucket detail
        stays in the Prometheus exposition — TB scalars can't render it)."""
        scalars: dict[str, float] = {}
        for name, v in snapshot.items():
            if isinstance(v, Mapping):
                scalars[f"{name}_count"] = float(v.get("count", 0))
                scalars[f"{name}_sum"] = float(v.get("sum", 0.0))
            else:
                scalars[name] = float(v)
        if scalars:
            self.scalars(step, scalars)

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_scalars(path: str | Path) -> list[tuple[int, dict[str, float]]]:
    """Decode an event file written by :class:`SummaryWriter` (test helper /
    offline consumer). Returns ``[(step, {tag: value}), ...]`` skipping the
    file_version record. Validates CRCs."""
    raw = Path(path).read_bytes()
    out: list[tuple[int, dict[str, float]]] = []
    off = 0
    while off < len(raw):
        if off + 12 > len(raw):
            break  # truncated tail (crash mid-write) == EOF, like TF's reader
        (ln,) = struct.unpack_from("<Q", raw, off)
        if off + 12 + ln + 4 > len(raw):
            break  # payload or trailing CRC incomplete
        hdr = raw[off:off + 8]
        (hcrc,) = struct.unpack_from("<I", raw, off + 8)
        data = raw[off + 12:off + 12 + ln]
        (dcrc,) = struct.unpack_from("<I", raw, off + 12 + ln)
        if _masked_crc(hdr) != hcrc or _masked_crc(data) != dcrc:
            raise ValueError(f"corrupt record at offset {off}")
        off += 12 + ln + 4
        step, scalars = 0, {}
        i = 0
        while i < len(data):
            key, i = _read_varint(data, i)
            num, wire = key >> 3, key & 7
            if wire == 1:
                i += 8
            elif wire == 0:
                val, i = _read_varint(data, i)
                if num == 2:
                    step = val
            elif wire == 5:
                i += 4
            elif wire == 2:
                ln2, i = _read_varint(data, i)
                payload = data[i:i + ln2]
                i += ln2
                if num == 5:
                    scalars = _decode_summary(payload)
        if scalars:
            out.append((step, scalars))
    return out


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    shift = n = 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _decode_summary(data: bytes) -> dict[str, float]:
    out: dict[str, float] = {}
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        if key >> 3 != 1 or key & 7 != 2:
            break
        ln, i = _read_varint(data, i)
        val = data[i:i + ln]
        i += ln
        tag, simple = "", 0.0
        j = 0
        while j < len(val):
            k2, j = _read_varint(val, j)
            num, wire = k2 >> 3, k2 & 7
            if wire == 2:
                ln2, j = _read_varint(val, j)
                if num == 1:
                    tag = val[j:j + ln2].decode()
                j += ln2
            elif wire == 5:
                if num == 2:
                    (simple,) = struct.unpack_from("<f", val, j)
                j += 4
            elif wire == 0:
                _, j = _read_varint(val, j)
            elif wire == 1:
                j += 8
        if tag:
            out[tag] = simple
    return out
