"""Minimal Caffe .caffemodel reader for the C3D (Sports-1M) weights: the
port's copy of the JAX package's `compat/caffemodel.py` (numpy only), with
`c3d_params_from_caffemodel` returning the port's C3D weights.

The reference consumes the pretrained `conv3d_deepnetA_sport1m_iter_1900000`
binary through the Caffe C++ tools; this module reads the weights directly
with a small protobuf WIRE-FORMAT walker — no caffe, no protoc schema
needed. Field numbers follow the C3D-v1.0 fork's caffe.proto (2014-era):

    NetParameter:       layers = 2 (repeated LayerParameter message)
    LayerParameter:     name = 4 (string), blobs = 6 (repeated BlobProto)
    BlobProto (5-D):    num=1, channels=2, length=3, height=4, width=5
                        (varints), data = 6 (packed float)

The same dimension order [num, channels, length, height, width] appears in
the C3D feature-blob files (`extract_C3D_features.py:13-76`), which is the
strongest in-repo evidence for the layout. A writer for the same format
lives here too so the parser is round-trip tested without the (external,
multi-hundred-MB) Sports-1M download.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

import numpy as np

from ..utils import log


# ------------------------------------------------------------ wire format

def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over one message's bytes.
    wire 0 -> int, wire 2 -> memoryview, wire 5 -> 4 raw bytes,
    wire 1 -> 8 raw bytes."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            value = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            value = bytes(buf[pos:pos + 4])
            pos += 4
        elif wire == 1:
            value = bytes(buf[pos:pos + 8])
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire} (field {field})")
        yield field, wire, value


def _encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _encode_field(field: int, wire: int, payload: bytes) -> bytes:
    return _encode_varint((field << 3) | wire) + payload


# ---------------------------------------------------------------- parsing

def _try_parse_blobshape(value: memoryview) -> Optional[list[int]]:
    """Parse field-7 bytes as BlobShape{dim=1 repeated varint}, or None.

    Field 7 is AMBIGUOUS across schema generations: modern caffe puts
    `shape` there, but the C3D-era proto puts `diff` (packed floats)
    there — float bytes usually fail to walk as submessage fields, and
    when they coincidentally do, the caller's shape-product check below
    rejects them. Returns None unless the bytes cleanly parse as
    positive dims."""
    dims: list[int] = []
    try:
        for f, w, v in _iter_fields(value):
            if f != 1:
                return None  # BlobShape has only field 1
            if w == 0:                       # unpacked varint
                dims.append(v)
            elif w == 2:                     # packed varints
                pos = 0
                while pos < len(v):
                    dim, pos = _read_varint(v, pos)
                    dims.append(dim)
            else:
                return None
    except (ValueError, IndexError):
        return None
    if not dims or any(d <= 0 for d in dims):
        return None
    return dims


def _parse_blob(buf: memoryview, legacy_4d: bool = False) -> np.ndarray:
    """BlobProto bytes -> array, across the three schema generations:

      C3D/V1 era:  num=1 channels=2 length=3 height=4 width=5 (varints),
                   data = 6 (packed or unpacked float), diff = 7
      modern:      shape = 7 (BlobShape{dim=1 repeated varint}),
                   data = 5, diff = 6 (packed float); legacy 4-D dims
                   num=1 channels=2 height=3 width=4

    Fields 5/6/7 therefore collide between eras (modern `diff` = C3D
    `data`; C3D `diff` = modern `shape`), so float payloads are
    accumulated PER FIELD and the era is resolved afterwards by which
    (shape, payload) pair's sizes agree — a snapshot that carries diffs
    never corrupts the weights. The field-3/4 varints are ambiguous
    between the 5-D (`length`) and 4-D layouts, so the caller passes
    `legacy_4d` from the NetParameter framing.
    """
    dims = {}
    floats: dict[int, object] = {}  # field -> ndarray (packed) or list
    shape7 = None
    for field, wire, value in _iter_fields(buf):
        if wire == 0 and 1 <= field <= 5:
            dims[field] = value
        elif field in (5, 6) and wire == 2:
            # packed float payload: data(6)/diff(7) in the C3D era,
            # data(5)/diff(6) in modern files. A wire-2 field 5 cannot be
            # the `width` varint, so there is no clash with the 5-D dims.
            # A packed repeated field may be SPLIT across several chunks
            # (streamed/merged messages) — concatenate within the field.
            chunk = np.frombuffer(bytes(value), dtype="<f4")
            prev = floats.get(field)
            if isinstance(prev, np.ndarray):
                floats[field] = np.concatenate([prev, chunk])
            elif isinstance(prev, list):
                prev.extend(chunk.tolist())
            else:
                floats[field] = chunk
        elif field in (5, 6) and wire == 5:        # unpacked float entry
            # accumulate in a list: np.append per element is O(n^2) and
            # takes hours on conv5b/fc-scale blobs
            prev = floats.get(field)
            if not isinstance(prev, list):
                prev = list(prev) if prev is not None else []
                floats[field] = prev
            prev.append(struct.unpack("<f", value)[0])
        elif field == 7 and wire == 2:
            shape7 = _try_parse_blobshape(value)   # None when it's a diff
    payloads = {f: (np.asarray(v, np.float32) if isinstance(v, list) else v)
                for f, v in floats.items()}
    if not payloads:
        raise ValueError("blob without data")
    if shape7:
        n = int(np.prod(shape7))
        # modern layout: data=5 (diff=6 ignored); fall back to field 6
        # only when 5 is absent (V0-era writers that kept data at 6)
        for f in (5, 6):
            if f in payloads and payloads[f].size == n:
                return payloads[f].reshape(shape7).astype(np.float32)
    # C3D/V1/V0 dim headers: data lives at 6 (C3D) or 5; when BOTH float
    # fields are present without a usable shape, field 6 is the C3D-era
    # data and field 5 would be modern data — try each against the dims
    shape5 = [dims.get(i, 1) for i in range(1, 6)]  # 5-D [n,c,l,h,w]
    shape4 = [dims.get(i, 1) for i in range(1, 5)]  # legacy 4-D [n,c,h,w]
    shapes = ([shape4, shape5] if (legacy_4d and 5 not in dims)
              else [shape5, shape4])
    for shape in shapes:
        for f in (6, 5):
            if f in payloads and payloads[f].size == int(np.prod(shape)):
                return payloads[f].reshape(shape).astype(np.float32)
    # header/dim mismatch: return flat rather than guessing
    data = payloads.get(6, payloads.get(5))
    log.warn("blob dims %s != data size %d; leaving flat", shape5,
             data.size)
    return data.astype(np.float32)


def _parse_layer_message(buf: memoryview, name_field: int, blob_field: int,
                         legacy_4d: bool = False
                         ) -> tuple[Optional[str], list]:
    name = None
    blobs = []
    for lf, lw, lv in _iter_fields(buf):
        if lf == name_field and lw == 2:
            name = bytes(lv).decode("utf-8", "replace")
        elif lf == blob_field and lw == 2:
            blobs.append(_parse_blob(lv, legacy_4d=legacy_4d))
    return name, blobs


def parse_caffemodel(path: str) -> dict[str, list[np.ndarray]]:
    """.caffemodel -> {layer_name: [blob, ...]}.

    Accepts all three NetParameter framings:

      V1 (the C3D fork, BVLC `V1LayerParameter`):
        layers = 2 { name = 4, blobs = 6 }
      V0 (oldest, `LayerConnection`/`V0LayerParameter`):
        layers = 2 { layer = 1 { name = 1, blobs = 50 } }
      modern (caffe 1.0 `LayerParameter`):
        layer = 100 { name = 1, blobs = 7 }
    """
    with open(path, "rb") as f:
        raw = memoryview(f.read())
    layers: dict[str, list[np.ndarray]] = {}
    for field, wire, value in _iter_fields(raw):
        if wire != 2 or field not in (2, 100):   # layers / layer
            continue
        if field == 100:                          # modern LayerParameter
            name, blobs = _parse_layer_message(value, 1, 7, legacy_4d=True)
        else:                                     # V1LayerParameter
            name, blobs = _parse_layer_message(value, 4, 6)
            if not blobs:
                # V0 fallback: nested V0LayerParameter at field 1
                for lf, lw, lv in _iter_fields(value):
                    if lf == 1 and lw == 2:
                        v0_name, v0_blobs = _parse_layer_message(
                            lv, 1, 50, legacy_4d=True)
                        if v0_blobs:
                            name = name or v0_name
                            blobs = v0_blobs
                        break
        if name and blobs:
            layers[name] = blobs
    return layers


def c3d_params_from_caffemodel(path: str) -> dict:
    """Sports-1M .caffemodel -> `models/c3d.init_params`-shaped dict of f32
    CPU tensors (conv [out, in, kd, kh, kw], fc [out, in])."""
    from ..models import c3d as c3d_model

    layers = parse_caffemodel(path)
    arrays = {}
    for name, blobs in layers.items():
        if len(blobs) < 2:
            continue
        w, b = blobs[0], blobs[1]
        b = b.reshape(-1)
        if w.ndim == 5 and name.startswith("fc"):
            # InnerProduct blobs appear as (out,in,1,1,1) in the C3D-era
            # writer AND as (1,1,1,out,in) in V1-era NetParameters; strip
            # singleton dims and require exactly a 2-D matrix left over
            nontrivial = [d for d in w.shape if d != 1]
            if len(nontrivial) != 2:
                raise ValueError(
                    f"fc blob {name} has shape {w.shape}; cannot infer "
                    f"(out, in) matrix")
            w = w.reshape(nontrivial)
        arrays[name] = (w, b)
        log.info("caffemodel layer %s: w%s b%s", name, w.shape, b.shape)
    return c3d_model.params_from_caffe_arrays(arrays)


# ----------------------------------------------------------------- writer

def _encode_blob(blob: np.ndarray) -> bytes:
    blob = np.asarray(blob, np.float32)
    assert blob.ndim == 5
    out = b""
    for i, dim in enumerate(blob.shape, start=1):
        out += _encode_field(i, 0, _encode_varint(int(dim)))
    payload = blob.astype("<f4").tobytes()
    out += _encode_field(6, 2, _encode_varint(len(payload)) + payload)
    return out


def write_caffemodel(path: str, layers: dict[str, list[np.ndarray]]) -> None:
    """Write the C3D-era format (for round-trip tests)."""
    body = b""
    for name, blobs in layers.items():
        layer = _encode_field(4, 2, _encode_varint(len(name))
                              + name.encode())
        for blob in blobs:
            encoded = _encode_blob(blob)
            layer += _encode_field(6, 2, _encode_varint(len(encoded))
                                   + encoded)
        body += _encode_field(2, 2, _encode_varint(len(layer)) + layer)
    with open(path, "wb") as f:
        f.write(body)
