"""TFRecord IO without a tensorflow dependency (counterpart of
``ray_tpu/data/tfrecords.py``): the record framing, CRC32C and the
``tf.train.Example`` protobuf codec, in pure Python and bit-compatible
with the reference's files (a file one side writes, the other reads).

Format: each record is ``u64le length | u32le masked_crc32c(length) |
data | u32le masked_crc32c(data)``; ``data`` is a serialized
``tf.train.Example`` whose features are Bytes/Float/Int64 lists.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

import numpy as np

# ------------------------------------------------------------------ crc32c
_CRC_TABLE = []
_POLY = 0x82F63B78
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf plumbing
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


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


# tf.train.Feature: oneof { BytesList=1, FloatList=2, Int64List=3 };
# each list's values are field 1 (floats packed f32, ints packed varint).
def _encode_feature(value: Any) -> bytes:
    if isinstance(value, (bytes, str, np.bytes_, np.str_)):
        values = [value]
    elif isinstance(value, np.ndarray):
        values = list(value)
    elif isinstance(value, (list, tuple)):
        values = list(value)
    else:
        values = [value]
    if not values:
        return _len_delim(1, b"")  # empty bytes_list
    head = values[0]
    if isinstance(head, (bytes, np.bytes_)):
        body = b"".join(_len_delim(1, bytes(v)) for v in values)
        return _len_delim(1, body)
    if isinstance(head, (str, np.str_)):
        body = b"".join(_len_delim(1, str(v).encode()) for v in values)
        return _len_delim(1, body)
    if isinstance(head, (float, np.floating)):
        packed = struct.pack(f"<{len(values)}f",
                             *[float(v) for v in values])
        return _len_delim(2, _len_delim(1, packed))
    if isinstance(head, (int, np.integer, bool, np.bool_)):
        packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                          for v in values)
        return _len_delim(3, _len_delim(1, packed))
    raise TypeError(f"cannot encode feature value of type {type(head)}")


def encode_example(row: Dict[str, Any]) -> bytes:
    """Serialize one row as tf.train.Example."""
    entries = b""
    for key in sorted(row):
        entry = _len_delim(1, key.encode()) + _len_delim(
            2, _encode_feature(row[key]))
        entries += _len_delim(1, entry)  # Features.feature map entry
    return _len_delim(1, entries)  # Example.features


def _decode_list(body: bytes, kind: int):
    """Decode BytesList/FloatList/Int64List message bodies."""
    pos, out = 0, []
    while pos < len(body):
        tag, pos = _read_varint(body, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, pos = _read_varint(body, pos)
            chunk = body[pos:pos + ln]
            pos += ln
            if kind == 1:  # bytes
                out.append(chunk)
            elif kind == 2:  # packed floats
                out.extend(struct.unpack(f"<{ln // 4}f", chunk))
            else:  # packed int64 varints
                p = 0
                while p < ln:
                    v, p = _read_varint(chunk, p)
                    out.append(v - (1 << 64) if v >= (1 << 63) else v)
        elif wire == 5:  # unpacked float
            out.append(struct.unpack("<f", body[pos:pos + 4])[0])
            pos += 4
        elif wire == 0:  # unpacked int64
            v, pos = _read_varint(body, pos)
            out.append(v - (1 << 64) if v >= (1 << 63) else v)
        else:
            raise ValueError(f"bad wire type {wire} in list field {field}")
    return out


def decode_example(data: bytes) -> Dict[str, list]:
    """Parse a serialized tf.train.Example into {key: values list}."""
    out: Dict[str, list] = {}
    pos = 0
    while pos < len(data):  # Example
        tag, pos = _read_varint(data, pos)
        ln, pos = _read_varint(data, pos)
        features = data[pos:pos + ln]
        pos += ln
        if tag >> 3 != 1:
            continue
        fpos = 0
        while fpos < len(features):  # Features.feature entries
            ftag, fpos = _read_varint(features, fpos)
            fln, fpos = _read_varint(features, fpos)
            entry = features[fpos:fpos + fln]
            fpos += fln
            if ftag >> 3 != 1:
                continue
            key, values = None, []
            epos = 0
            while epos < len(entry):  # map entry: key=1, Feature=2
                etag, epos = _read_varint(entry, epos)
                eln, epos = _read_varint(entry, epos)
                payload = entry[epos:epos + eln]
                epos += eln
                if etag >> 3 == 1:
                    key = payload.decode()
                else:  # Feature: oneof list kind
                    ppos = 0
                    while ppos < len(payload):
                        ptag, ppos = _read_varint(payload, ppos)
                        pln, ppos = _read_varint(payload, ppos)
                        values = _decode_list(
                            payload[ppos:ppos + pln], ptag >> 3)
                        ppos += pln
            if key is not None:
                out[key] = values
    return out


# ------------------------------------------------------------ file framing
_LEN = struct.Struct("<Q")
_CRC = struct.Struct("<I")


def write_record(fh, data: bytes) -> None:
    header = _LEN.pack(len(data))
    fh.write(header)
    fh.write(_CRC.pack(_masked_crc(header)))
    fh.write(data)
    fh.write(_CRC.pack(_masked_crc(data)))


def read_records(fh, check_integrity: bool = True) -> Iterator[bytes]:
    """Iterate raw record payloads. The length CRC is always checked
    (framing integrity); with ``check_integrity=True`` (the default,
    matching the reference reader) the per-record DATA CRC is verified
    too, so payload corruption that leaves the length field intact
    cannot pass silently into training data. Pass
    ``check_integrity=False`` to trade that check for read speed."""
    while True:
        header = fh.read(8)
        if len(header) < 8:
            return
        crc = fh.read(4)
        if _CRC.unpack(crc)[0] != _masked_crc(header):
            raise ValueError("TFRecord length CRC mismatch (corrupt file)")
        (length,) = _LEN.unpack(header)
        data = fh.read(length)
        if len(data) < length:
            raise ValueError("TFRecord truncated mid-record")
        data_crc = fh.read(4)
        if check_integrity:
            if len(data_crc) < 4:
                raise ValueError("TFRecord truncated mid-record")
            if _CRC.unpack(data_crc)[0] != _masked_crc(data):
                raise ValueError(
                    "TFRecord data CRC mismatch (corrupt record)")
        yield data


def examples_to_block(rows: List[Dict[str, list]]):
    """Columnarize decoded examples: single-element features become
    scalars, multi-element ones stay arrays (reference read_tfrecords
    column semantics)."""
    if not rows:
        return {}
    keys = sorted(set().union(*rows))
    block = {}
    for k in keys:
        vals = []
        for r in rows:
            v = r.get(k, [])
            vals.append(v[0] if len(v) == 1 else np.asarray(v))
        if all(isinstance(v, (int, float, np.integer, np.floating))
               for v in vals):
            block[k] = np.asarray(vals)
        else:  # bytes or variable-length features: object column
            col = np.empty(len(vals), dtype=object)
            col[:] = vals
            block[k] = col
    return block
