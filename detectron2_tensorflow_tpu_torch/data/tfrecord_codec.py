"""TFRecord framing and the ``tf.train.Example`` codec, without TensorFlow.

Port of the JAX package's ``data/tfrecord_codec.py``; the bytes are the
same, so either package reads what the other writes.

TFRecord framing (tensorflow/core/lib/io/record_writer.cc):

    uint64  length          (little-endian)
    uint32  masked_crc32c(length bytes)
    bytes   payload[length]
    uint32  masked_crc32c(payload)

with ``masked = (rotr15(crc) + 0xa282ead8) & 0xffffffff`` over the
Castagnoli CRC-32. The CRC runs in C (``csrc/crc32c.cpp``, built by ``g++``
at first use, see ``kernels.load_host``): a reader checks it on every
record, and the Python loop, kept as :func:`crc32c_reference`, takes tens of
milliseconds for one COCO-sized JPEG. A failed build raises; nothing falls
back to the loop.

tf.train.Example wire format (standard protobuf):

    Example    { Features features = 1; }
    Features   { map<string, Feature> feature = 1; }
    Feature    { oneof { BytesList b = 1; FloatList f = 2; Int64List i = 3; } }
    BytesList  { repeated bytes value = 1; }
    FloatList  { repeated float value = 1 [packed]; }
    Int64List  { repeated int64 value = 1 [packed]; }

The decoder accepts both packed and unpacked repeated scalars (any
conforming writer); the encoder emits packed (what TF emits).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from .. import kernels

# -- crc32c (Castagnoli) -------------------------------------------------------

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = np.zeros(256, np.uint32)
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ (poly if c & 1 else 0)
            table[n] = c
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """Castagnoli CRC-32 of ``data``, by the C loop."""
    data = bytes(data)
    return int(kernels.load_host("crc32c").crc32c(data, len(data)))


def crc32c_reference(data: bytes) -> int:
    """The plain version of :func:`crc32c`: the same table loop in Python."""
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- TFRecord framing ----------------------------------------------------------


def write_record(fh, payload: bytes) -> None:
    header = struct.pack("<Q", len(payload))
    fh.write(header)
    fh.write(struct.pack("<I", _masked_crc(header)))
    fh.write(payload)
    fh.write(struct.pack("<I", _masked_crc(payload)))


def index_records(path: str) -> List[Tuple[int, int]]:
    """[(payload_offset, payload_length)] for every record in a shard —
    O(records) seeks, no payload reads (lazy datasets index once and read
    on demand)."""
    out = []
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        pos = 0
        while pos + 12 <= size:
            header = fh.read(8)
            (length,) = struct.unpack("<Q", header)
            fh.seek(4, 1)  # length crc
            out.append((pos + 12, length))
            pos += 12 + length + 4
            fh.seek(pos)
    return out


def read_record_at(path: str, offset: int, length: int,
                   verify: bool = False) -> bytes:
    with open(path, "rb") as fh:
        fh.seek(offset)
        payload = fh.read(length)
        if verify:
            (crc,) = struct.unpack("<I", fh.read(4))
            if crc != _masked_crc(payload):
                raise ValueError(f"TFRecord crc mismatch at {path}:{offset}")
    return payload


def read_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """Stream every record payload of a shard (with CRC verification)."""
    for off, length in index_records(path):
        yield read_record_at(path, off, length, verify=verify)


# -- protobuf primitives -------------------------------------------------------


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


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


# -- tf.train.Example ----------------------------------------------------------
# Features are tagged unions: ("bytes", [bytes...]) | ("float", ndarray) |
# ("int64", ndarray) — mirroring BytesList / FloatList / Int64List.


def bytes_feature(values: Sequence[bytes]):
    return ("bytes", [bytes(v) for v in values])


def float_feature(values):
    return ("float", np.asarray(values, np.float32).reshape(-1))


def int64_feature(values):
    return ("int64", np.asarray(values, np.int64).reshape(-1))


def encode_example(features: Dict[str, tuple]) -> bytes:
    entries = []
    for name, (kind, values) in features.items():
        if kind == "bytes":
            lst = b"".join(_ld(1, v) for v in values)
            feat = _ld(1, lst)
        elif kind == "float":
            packed = np.asarray(values, "<f4").tobytes()
            feat = _ld(2, _ld(1, packed))
        elif kind == "int64":
            packed = b"".join(
                _varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in values
            )
            feat = _ld(3, _ld(1, packed))
        else:
            raise ValueError(f"unknown feature kind {kind!r}")
        entry = _ld(1, name.encode()) + _ld(2, feat)
        entries.append(_ld(1, entry))
    return _ld(1, b"".join(entries))


def _decode_list(kind_field: int, body: memoryview):
    """Decode BytesList/FloatList/Int64List content (repeated field 1,
    packed or not)."""
    pos = 0
    if kind_field == 1:  # bytes
        out = []
        while pos < len(body):
            tag, pos = _read_varint(body, pos)
            assert tag == (1 << 3 | 2), tag
            n, pos = _read_varint(body, pos)
            out.append(bytes(body[pos:pos + n]))
            pos += n
        return ("bytes", out)
    if kind_field == 2:  # float
        floats: List[float] = []
        chunks = []
        while pos < len(body):
            tag, pos = _read_varint(body, pos)
            wire = tag & 7
            if wire == 2:  # packed
                n, pos = _read_varint(body, pos)
                chunks.append(np.frombuffer(body[pos:pos + n], "<f4"))
                pos += n
            else:  # unpacked fixed32
                chunks.append(np.frombuffer(body[pos:pos + 4], "<f4"))
                pos += 4
        return (
            "float",
            np.concatenate(chunks) if chunks else np.zeros(0, np.float32),
        )
    if kind_field == 3:  # int64
        vals: List[int] = []
        while pos < len(body):
            tag, pos = _read_varint(body, pos)
            wire = tag & 7
            if wire == 2:  # packed varints
                n, pos = _read_varint(body, pos)
                end = pos + n
                while pos < end:
                    v, pos = _read_varint(body, pos)
                    vals.append(v - (1 << 64) if v >= 1 << 63 else v)
            else:  # unpacked varint
                v, pos = _read_varint(body, pos)
                vals.append(v - (1 << 64) if v >= 1 << 63 else v)
        return ("int64", np.asarray(vals, np.int64))
    raise ValueError(f"unknown Feature oneof field {kind_field}")


def _skip(buf: memoryview, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _read_varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire}")
    return pos


def decode_example(data: bytes) -> Dict[str, tuple]:
    """Serialized tf.train.Example -> {name: tagged feature} (see above)."""
    buf = memoryview(data)
    features: Dict[str, tuple] = {}

    def parse_entry(entry: memoryview):
        pos = 0
        name = None
        feat = None
        while pos < len(entry):
            tag, pos = _read_varint(entry, pos)
            field, wire = tag >> 3, tag & 7
            if field == 1 and wire == 2:
                n, pos = _read_varint(entry, pos)
                name = bytes(entry[pos:pos + n]).decode()
                pos += n
            elif field == 2 and wire == 2:
                n, pos = _read_varint(entry, pos)
                feat = entry[pos:pos + n]
                pos += n
            else:
                pos = _skip(entry, pos, wire)
        if name is None or feat is None:
            return
        fpos = 0
        while fpos < len(feat):
            tag, fpos = _read_varint(feat, fpos)
            field, wire = tag >> 3, tag & 7
            if wire == 2 and field in (1, 2, 3):
                n, fpos = _read_varint(feat, fpos)
                features[name] = _decode_list(field, feat[fpos:fpos + n])
                fpos += n
            else:
                fpos = _skip(feat, fpos, wire)

    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # Example.features
            n, pos = _read_varint(buf, pos)
            fbuf = buf[pos:pos + n]
            pos += n
            fpos = 0
            while fpos < len(fbuf):
                ftag, fpos = _read_varint(fbuf, fpos)
                ffield, fwire = ftag >> 3, ftag & 7
                if ffield == 1 and fwire == 2:  # map entry
                    n2, fpos = _read_varint(fbuf, fpos)
                    parse_entry(fbuf[fpos:fpos + n2])
                    fpos += n2
                else:
                    fpos = _skip(fbuf, fpos, fwire)
        else:
            pos = _skip(buf, pos, wire)
    return features
