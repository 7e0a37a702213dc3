"""TFRecord feature declarations + tf.Example wire-format parsing (the
port's own copy of ``dali_tpu/tfrecord.py``).

Reference: ``dali/python/nvidia/dali/tfrecord.py`` (FixedLenFeature/VarLenFeature)
and ``dali/operators/reader/parser/tf_feature.h`` / ``tfrecord_parser.h``. The
parser here decodes the protobuf wire format directly (no protobuf dependency):
Example → Features → map<string, Feature{bytes_list|float_list|int64_list}>.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np


class Feature:
    def __init__(self, shape, dtype, default_value=None, partial_shape=False):
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.default_value = default_value
        self.partial_shape = partial_shape


def FixedLenFeature(shape, dtype, default_value=None):
    return Feature(shape, dtype, default_value)


def VarLenFeature(dtype, default_value=None):
    return Feature(None, dtype, default_value)


# dtype tags matching the reference tfrecord module
string = "string"
int64 = "int64"
float32 = "float32"


# -- protobuf wire parsing ---------------------------------------------------------


def _read_varint(buf: memoryview, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, buf[pos : pos + ln]
            pos += ln
        elif wire == 0:
            v, pos = _read_varint(buf, pos)
            yield field, v
        elif wire == 5:
            yield field, buf[pos : pos + 4]
            pos += 4
        elif wire == 1:
            yield field, buf[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"Unsupported wire type {wire}")


def parse_example(payload: bytes) -> Dict[str, np.ndarray]:
    """Parse a serialized tf.Example into {name: bytes | int64 array | float array}."""
    out = {}
    mv = memoryview(payload)
    for field, val in _iter_fields(mv):
        if field != 1:  # Example.features
            continue
        for ffield, fval in _iter_fields(val):
            if ffield != 1:  # Features.feature (map entry)
                continue
            name = None
            feature = None
            for kf, kv in _iter_fields(fval):
                if kf == 1:
                    name = bytes(kv).decode()
                elif kf == 2:
                    feature = kv
            if name is None or feature is None:
                continue
            out[name] = _parse_feature(feature)
    return out


def _parse_feature(buf: memoryview):
    for field, val in _iter_fields(buf):
        if field == 1:  # BytesList
            items = [bytes(v) for f, v in _iter_fields(val) if f == 1]
            return items
        if field == 2:  # FloatList
            floats = []
            for f, v in _iter_fields(val):
                if f == 1:
                    if isinstance(v, (bytes, memoryview)):  # packed
                        floats.extend(struct.unpack(f"<{len(v)//4}f", bytes(v)))
                    else:
                        floats.append(struct.unpack("<f", struct.pack("<I", v))[0])
            return np.asarray(floats, np.float32)
        if field == 3:  # Int64List
            ints = []
            for f, v in _iter_fields(val):
                if f == 1:
                    if isinstance(v, (bytes, memoryview)):  # packed varints
                        mv = memoryview(v)
                        pos = 0
                        while pos < len(mv):
                            x, pos = _read_varint(mv, pos)
                            ints.append(x)
                    else:
                        ints.append(v)
            # a negative int64 is its two's complement as a 10-byte varint
            return np.asarray([x - (1 << 64) if x >= 1 << 63 else x for x in ints], np.int64)
    return []


def read_record(f) -> bytes:
    """Read one TFRecord (length-prefixed + CRCs) from a file object."""
    hdr = f.read(12)
    if len(hdr) < 12:
        return None
    (length,) = struct.unpack("<Q", hdr[:8])
    payload = f.read(length)
    f.read(4)  # data crc
    return payload


def build_index(path: str):
    """(offset, size) per record — the analogue of tools/tfrecord2idx."""
    entries = []
    with open(path, "rb") as f:
        while True:
            off = f.tell()
            hdr = f.read(12)
            if len(hdr) < 12:
                break
            (length,) = struct.unpack("<Q", hdr[:8])
            f.seek(length + 4, 1)
            entries.append((off, length + 16))
    return entries


def write_index(tfrecord_path: str, index_path: str):
    with open(index_path, "w") as f:
        for off, size in build_index(tfrecord_path):
            f.write(f"{off} {size}\n")


def write_example(features: Dict[str, object]) -> bytes:
    """Serialize a tf.Example (for tests/tools)."""

    def varint(v):
        v &= (1 << 64) - 1  # a negative int64 as its two's complement
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                out += bytes([b7])
                return out

    def field(num, wire, payload):
        return varint((num << 3) | wire) + payload

    def ld(num, payload):
        return field(num, 2, varint(len(payload)) + payload)

    feats = b""
    for name, value in features.items():
        if isinstance(value, bytes):
            flist = ld(1, ld(1, value))  # BytesList
        elif isinstance(value, str):
            flist = ld(1, ld(1, value.encode()))
        else:
            arr = np.asarray(value)
            if np.issubdtype(arr.dtype, np.integer):
                body = b"".join(varint(int(v)) for v in arr.reshape(-1))
                flist = ld(3, ld(1, body))  # Int64List packed
            else:
                body = struct.pack(f"<{arr.size}f", *arr.reshape(-1).astype(np.float32))
                flist = ld(2, ld(1, body))  # FloatList packed
        entry = ld(1, name.encode()) + ld(2, flist)
        feats += ld(1, entry)
    example = ld(1, feats)
    return example


def write_record(f, payload: bytes):
    """Append one TFRecord (CRCs zeroed — readers here don't verify)."""
    f.write(struct.pack("<Q", len(payload)))
    f.write(b"\x00" * 4)
    f.write(payload)
    f.write(b"\x00" * 4)
