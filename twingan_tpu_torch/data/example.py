"""Minimal tf.train.Example protobuf wire codec (no protobuf dependency).

A copy of ``twingan_tpu/data/example.py``: the port keeps its own, so that
it imports nothing of the JAX package. Both packages write the same bytes
for the same features and read each other's records.

Implements exactly the subset the TFRecord datasets use:

    Example     { Features features = 1; }
    Features    { map<string, Feature> feature = 1; }
    Feature     { oneof kind { BytesList bytes_list = 1;
                               FloatList float_list = 2;
                               Int64List int64_list = 3; } }
    BytesList   { repeated bytes value = 1; }
    FloatList   { repeated float value = 1 [packed = true]; }
    Int64List   { repeated int64 value = 1 [packed = true]; }

Values are python types: list[bytes], numpy float32 array, numpy int64 array.
The record payload enters as a zero-copy mmap memoryview (TFRecordReader);
each BytesList element is materialized with one bytes() copy at decode.
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np

FeatureValue = Union[list, bytes, np.ndarray]


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _read_varint(buf, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _write_tag(out: bytearray, field: int, wire_type: int) -> None:
    _write_varint(out, (field << 3) | wire_type)


def _write_len_delimited(out: bytearray, field: int, payload: bytes) -> None:
    _write_tag(out, field, 2)
    _write_varint(out, len(payload))
    out += payload


# --------------------------------------------------------------------- #
# Encoding
# --------------------------------------------------------------------- #

def _encode_feature(value: FeatureValue) -> bytes:
    inner = bytearray()
    if isinstance(value, (bytes, bytearray, memoryview, str)):
        value = [value]
    if isinstance(value, (list, tuple)) and (not value or isinstance(value[0], (bytes, bytearray, memoryview, str))):
        # BytesList (field 1 of Feature).
        blist = bytearray()
        for v in value:
            if isinstance(v, str):
                v = v.encode("utf-8")
            _write_len_delimited(blist, 1, bytes(v))
        _write_len_delimited(inner, 1, bytes(blist))
        return bytes(inner)
    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.floating):
        packed = arr.astype("<f4").tobytes()
        flist = bytearray()
        _write_len_delimited(flist, 1, packed)  # packed floats
        _write_len_delimited(inner, 2, bytes(flist))
        return bytes(inner)
    if np.issubdtype(arr.dtype, np.integer) or arr.dtype == np.bool_:
        ilist = bytearray()
        packed = bytearray()
        for v in arr.astype(np.int64).reshape(-1):
            _write_varint(packed, int(v) & 0xFFFFFFFFFFFFFFFF)
        _write_len_delimited(ilist, 1, bytes(packed))
        _write_len_delimited(inner, 3, bytes(ilist))
        return bytes(inner)
    raise TypeError(f"unsupported feature value type: {type(value)} / {arr.dtype}")


def encode_example(features: Mapping[str, FeatureValue]) -> bytes:
    """Serialize a feature dict to tf.train.Example wire bytes."""
    feats = bytearray()
    for name, value in features.items():
        entry = bytearray()
        _write_len_delimited(entry, 1, name.encode("utf-8"))
        _write_len_delimited(entry, 2, _encode_feature(value))
        _write_len_delimited(feats, 1, bytes(entry))
    out = bytearray()
    _write_len_delimited(out, 1, bytes(feats))
    return bytes(out)


# --------------------------------------------------------------------- #
# Decoding
# --------------------------------------------------------------------- #

def _skip_field(buf, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        size, pos = _read_varint(buf, pos)
        pos += size
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wire_type}")
    return pos


def _iter_fields(buf, pos: int, end: int):
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire_type = tag >> 3, tag & 7
        if wire_type == 2:
            size, pos = _read_varint(buf, pos)
            yield field, buf[pos : pos + size]
            pos += size
        else:
            start = pos
            pos = _skip_field(buf, pos, wire_type)
            yield field, buf[start:pos]


def _decode_feature(buf) -> FeatureValue:
    mv = memoryview(buf)
    for field, payload in _iter_fields(mv, 0, len(mv)):
        if field == 1:  # BytesList
            values = [bytes(p) for f, p in _iter_fields(payload, 0, len(payload)) if f == 1]
            return values
        if field == 2:  # FloatList (packed or repeated)
            floats: list = []
            for f, p in _iter_fields(payload, 0, len(payload)):
                if f == 1:
                    floats.append(np.frombuffer(p, "<f4"))
            return np.concatenate(floats) if floats else np.zeros((0,), np.float32)
        if field == 3:  # Int64List
            ints = []
            for f, p in _iter_fields(payload, 0, len(payload)):
                if f == 1:
                    pos = 0
                    while pos < len(p):
                        v, pos = _read_varint(p, pos)
                        if v >= 1 << 63:
                            v -= 1 << 64
                        ints.append(v)
            return np.asarray(ints, np.int64)
    return []


class Example(dict):
    """Decoded feature dict: name -> list[bytes] | float32 array | int64 array."""


def decode_example(payload: bytes | memoryview) -> Example:
    mv = memoryview(payload)
    out = Example()
    for field, features_buf in _iter_fields(mv, 0, len(mv)):
        if field != 1:
            continue
        for f, entry in _iter_fields(features_buf, 0, len(features_buf)):
            if f != 1:
                continue
            name = None
            value = None
            for ef, epayload in _iter_fields(entry, 0, len(entry)):
                if ef == 1:
                    name = bytes(epayload).decode("utf-8")
                elif ef == 2:
                    value = _decode_feature(epayload)
            if name is not None:
                out[name] = value
    return out
