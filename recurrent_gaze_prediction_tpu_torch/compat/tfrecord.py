"""Pure-Python TFRecord codec for the reference's action-task records: the
port's copy of the JAX package's `compat/tfrecord.py` (numpy only).

The reference serializes per-frame examples to TFRecord
(`create_tfrecords.py:157-203`) and parses them with fixed shapes
(`read_tfrecord.py:6-51`): bytes features keyed

    /input/frame          float32 [98, 98, 3]
    /input/c3d            float32 [1024, 7, 7]
    /input/gazemaps_gt    float32 [49, 49]
    /input/gazemaps_pred  float32 [49, 49]
    /label/label          uint8   [13]

This module reads and writes that exact container WITHOUT TensorFlow: the
TFRecord framing (u64 length + masked crc32c + payload + crc) and the
tf.train.Example proto (Example.features=1 -> Features.feature=1 map ->
Feature.bytes_list=1 -> BytesList.value=1) are written out here, on the
protobuf wire helpers of `compat/caffemodel.py`. Files written by either
package are byte-identical; tests/test_torch_interop.py holds both
directions against the JAX package and against real tf.io where
tensorflow imports.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

import numpy as np

from .caffemodel import _encode_field, _encode_varint, _iter_fields

# ------------------------------------------------------------- crc32c

_CRC32C_POLY = 0x82F63B78
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _CRC32C_POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- record framing

def iter_tfrecords(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return  # clean EOF on a record boundary
            if len(header) < 12:
                # 1-11 bytes left: the file was truncated MID-HEADER
                # (interrupted copy) — fail like the mid-payload case
                # instead of silently yielding an incomplete dataset
                raise IOError(
                    f"truncated TFRecord: {len(header)} trailing header "
                    f"bytes (need 12)")
            length, crc_len = struct.unpack("<QI", header)
            if verify_crc and _masked_crc(header[:8]) != crc_len:
                raise IOError("corrupt TFRecord length crc")
            payload = f.read(length)
            crc_bytes = f.read(4)
            if len(payload) < length or len(crc_bytes) < 4:
                # truncated file (interrupted copy): without this check a
                # short read either raised a bare struct.error or, with
                # verify_crc=False, yielded a short corrupt payload
                raise IOError(
                    f"truncated TFRecord: expected {length}+4 payload "
                    f"bytes, got {len(payload)}+{len(crc_bytes)}")
            crc_data = struct.unpack("<I", crc_bytes)[0]
            if verify_crc and _masked_crc(payload) != crc_data:
                raise IOError("corrupt TFRecord payload crc")
            yield payload


def write_tfrecords(path: str, payloads) -> None:
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))


# ------------------------------------------------------ Example proto

def _encode_bytes_feature(value: bytes) -> bytes:
    bytes_list = _encode_field(1, 2, _encode_varint(len(value)) + value)
    return _encode_field(1, 2, _encode_varint(len(bytes_list)) + bytes_list)


def encode_example(features: dict[str, bytes]) -> bytes:
    """{key: raw bytes} -> serialized tf.train.Example."""
    body = b""
    for key, value in features.items():
        kb = key.encode()
        feature = _encode_bytes_feature(value)
        entry = (_encode_field(1, 2, _encode_varint(len(kb)) + kb)
                 + _encode_field(2, 2, _encode_varint(len(feature))
                                 + feature))
        body += _encode_field(1, 2, _encode_varint(len(entry)) + entry)
    return _encode_field(1, 2, _encode_varint(len(body)) + body)


def decode_example(payload: bytes) -> dict[str, bytes]:
    """serialized Example -> {key: raw bytes} (bytes_list features only)."""
    out: dict[str, bytes] = {}
    for f1, w1, features_msg in _iter_fields(memoryview(payload)):
        if f1 != 1 or w1 != 2:
            continue
        for f2, w2, entry in _iter_fields(features_msg):
            if f2 != 1 or w2 != 2:
                continue
            key: Optional[str] = None
            raw: Optional[bytes] = None
            for f3, w3, v3 in _iter_fields(entry):
                if f3 == 1 and w3 == 2:
                    key = bytes(v3).decode()
                elif f3 == 2 and w3 == 2:           # Feature
                    for f4, w4, v4 in _iter_fields(v3):
                        if f4 == 1 and w4 == 2:     # BytesList
                            for f5, w5, v5 in _iter_fields(v4):
                                if f5 == 1 and w5 == 2:
                                    raw = bytes(v5)
            if key is not None and raw is not None:
                out[key] = raw
    return out


# --------------------------------------------- reference record schema

SCHEMA = {
    "/input/frame": (np.float32, (98, 98, 3)),
    "/input/c3d": (np.float32, (1024, 7, 7)),
    "/input/gazemaps_gt": (np.float32, (49, 49)),
    "/input/gazemaps_pred": (np.float32, (49, 49)),
    "/label/label": (np.uint8, (13,)),
}


def read_reference_tfrecord(path: str) -> list[dict[str, np.ndarray]]:
    """Parse a reference-format TFRecord file into per-frame dicts with the
    fixed shapes of `read_tfrecord.py:34-49`."""
    examples = []
    for payload in iter_tfrecords(path):
        raw = decode_example(payload)
        example = {}
        for key, (dtype, shape) in SCHEMA.items():
            if key in raw:
                example[key] = np.frombuffer(raw[key],
                                             dtype=dtype).reshape(shape)
        examples.append(example)
    return examples


def write_reference_tfrecord(path: str,
                             examples: list[dict[str, np.ndarray]]) -> None:
    """Write reference-format records (readable by the reference's
    tf.data pipeline)."""
    payloads = []
    for example in examples:
        features = {}
        for key, (dtype, shape) in SCHEMA.items():
            if key in example:
                arr = np.ascontiguousarray(example[key], dtype=dtype)
                assert arr.shape == shape, (key, arr.shape)
                features[key] = arr.tobytes()
        payloads.append(encode_example(features))
    write_tfrecords(path, payloads)
