"""TensorBoard event-file writer and reader (stdlib only).

Copy of ``viet_tts_tpu/utils/tfevents.py``, so the port logs without
tensorboardX. A TFEvent file is a sequence of length-prefixed protobuf
``Event`` records framed with masked CRC-32C (the TFRecord format), and
the two message types needed (scalar and histogram ``Summary``) are small,
so this module writes the format directly:

    record  := uint64 len | uint32 masked_crc(len) | data | uint32 masked_crc(data)
    mask(c) := ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32, c = CRC-32C(data)

Proto schema subset (tensorflow/core/util/event.proto + summary.proto):

    Event { double wall_time=1; int64 step=2;
            oneof { string file_version=3; Summary summary=5; } }
    Summary { repeated Value value=1; }
    Summary.Value { string tag=1; float simple_value=2; HistogramProto histo=5; }
    HistogramProto { double min=1,max=2,num=3,sum=4,sum_squares=5;
                     repeated double bucket_limit=6, bucket=7 [packed]; }

Files written here open in stock TensorBoard.  `read_events` re-parses a
file (CRC-verified) for tests and offline inspection.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Iterator, List, Optional, Tuple

# --------------------------------------------------------------------------
# CRC-32C (Castagnoli), reflected polynomial 0x82F63B78 — table-driven
# --------------------------------------------------------------------------

_CRC_TABLE: List[int] = []
for _n in range(256):
    _c = _n
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


# --------------------------------------------------------------------------
# minimal protobuf encoding
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF  # int64 two's complement
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


def _f_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _f_packed_doubles(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return _f_bytes(field, payload)


def _histogram_proto(values) -> bytes:
    """HistogramProto from a flat value array, with tensorboardX-style
    exponential buckets (edge growth 1.1x, mirrored for negatives)."""
    import numpy as np

    v = np.asarray(values, np.float64).ravel()
    if v.size == 0:
        v = np.zeros(1)
    limits = _default_bins()
    counts, _ = np.histogram(v, np.concatenate([[-np.inf], limits]))
    # drop trailing empty buckets (format allows it; files stay small)
    nz = np.nonzero(counts)[0]
    end = int(nz[-1]) + 1 if nz.size else 1
    msg = (
        _f_double(1, float(v.min()))
        + _f_double(2, float(v.max()))
        + _f_double(3, float(v.size))
        + _f_double(4, float(v.sum()))
        + _f_double(5, float(np.square(v).sum()))
        + _f_packed_doubles(6, limits[:end])
        + _f_packed_doubles(7, counts[:end])
    )
    return msg


_BINS_CACHE: Optional["object"] = None


def _default_bins():
    """tensorboardX's default_bins: +-1e-12 * 1.1^k grid up to ~1e20."""
    global _BINS_CACHE
    if _BINS_CACHE is None:
        import numpy as np

        pos = [1e-12]
        while pos[-1] < 1e20:
            pos.append(pos[-1] * 1.1)
        _BINS_CACHE = np.asarray([-x for x in reversed(pos)] + [0.0] + pos)
    return _BINS_CACHE


def _summary_value(tag: str, *, simple_value=None, histo=None) -> bytes:
    msg = _f_bytes(1, tag.encode("utf-8"))
    if simple_value is not None:
        msg += _f_float(2, float(simple_value))
    if histo is not None:
        msg += _f_bytes(5, histo)
    return msg


def _event(step: int, summary_values: List[bytes] = (),
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    msg = _f_double(1, time.time() if wall_time is None else wall_time)
    msg += _f_varint(2, int(step))
    if file_version is not None:
        msg += _f_bytes(3, file_version.encode("utf-8"))
    if summary_values:
        summary = b"".join(_f_bytes(1, v) for v in summary_values)
        msg += _f_bytes(5, summary)
    return msg


# --------------------------------------------------------------------------
# writer / reader
# --------------------------------------------------------------------------


class EventWriter:
    """Drop-in for the tensorboardX SummaryWriter subset the framework
    uses: add_scalar / add_histogram / flush / close."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()), socket.gethostname().split(".")[0] or "host",
        )
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write(_event(0, file_version="brain.Event:2"))

    def _write(self, event_bytes: bytes) -> None:
        header = struct.pack("<Q", len(event_bytes))
        self._f.write(
            header
            + struct.pack("<I", _masked_crc(header))
            + event_bytes
            + struct.pack("<I", _masked_crc(event_bytes))
        )

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(step, [_summary_value(tag, simple_value=value)]))

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._write(
            _event(step, [_summary_value(tag, histo=_histogram_proto(values))])
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# ---- reader (tests / offline inspection) ----------------------------------


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _parse_fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        elif wire == 5:
            val = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        else:  # pragma: no cover - groups unused
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def read_events(path: str) -> List[dict]:
    """Parse a TFEvent file back to dicts (CRC-verified):
    {"step", "wall_time", "file_version"?, "values": {tag: float | dict}}.
    Histogram values decode to {"min","max","num","sum"} summaries."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (length,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        if hcrc != _masked_crc(header):
            raise ValueError(f"header CRC mismatch at byte {i}")
        body = data[i + 12:i + 12 + length]
        (dcrc,) = struct.unpack("<I", data[i + 12 + length:i + 16 + length])
        if dcrc != _masked_crc(body):
            raise ValueError(f"data CRC mismatch at byte {i}")
        i += 16 + length
        ev = {"values": {}}
        for field, _, val in _parse_fields(body):
            if field == 1:
                ev["wall_time"] = val
            elif field == 2:
                ev["step"] = val
            elif field == 3:
                ev["file_version"] = val.decode("utf-8")
            elif field == 5:
                for f1, _, value_msg in _parse_fields(val):
                    if f1 != 1:
                        continue
                    tag = sv = histo = None
                    for f2, _, v2 in _parse_fields(value_msg):
                        if f2 == 1:
                            tag = v2.decode("utf-8")
                        elif f2 == 2:
                            sv = v2
                        elif f2 == 5:
                            histo = {
                                {1: "min", 2: "max", 3: "num", 4: "sum"}.get(f3): v3
                                for f3, _, v3 in _parse_fields(v2)
                                if f3 in (1, 2, 3, 4)
                            }
                    if tag is not None:
                        ev["values"][tag] = histo if histo is not None else sv
        out.append(ev)
    return out
