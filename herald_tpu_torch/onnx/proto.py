"""Protobuf wire-format codec for the ONNX message subset (the port's own
copy of `herald_tpu/onnx/proto.py`: the same `SCHEMAS`, constants,
`encode` and `decode`).

No `onnx` package is needed: the field numbers follow the public
onnx.proto (proto3), so the bytes are a standard `.onnx` file. A message
is a dict {'field_name': value}; repeated fields are lists, sub-messages
nested dicts. Wire format: a message is a sequence of (key, value) with
key = varint(field_number << 3 | wire_type); wire_type 0 = varint, 1 =
fixed64, 2 = length-delimited (strings, bytes, sub-messages, packed
repeated scalars), 5 = fixed32. Repeated numerics are written packed; the
decoder reads both forms.

Two additions for tables of many GB:
- `write(f, message, d)` writes the bytes of `encode(message, d)` to a
  file. A `bytes` field may hold a `Payload` (its size known in advance,
  its bytes written by a function): every length prefix is computed
  first, then the payload streams to the file, so it is never held whole.
- `decode` of a `memoryview` returns memoryviews for `bytes` fields, and
  `load_mapped(path)` decodes a file through a read-only `mmap`: an
  initializer's `raw_data` is then a view of the mapped file, neither
  read nor copied until its rows are used.
"""

from __future__ import annotations

import io
import mmap
import struct
from typing import Callable, Dict, List, Tuple, Union

# ---------------------------------------------------------------------
# schema: message -> {field_number: (name, kind)}
# kind: 'int' (varint), 'float' (fixed32), 'str', 'bytes',
#       'msg:<Message>'; prefix 'rep:' marks repeated fields.
# Field numbers follow the public onnx.proto.
# ---------------------------------------------------------------------
SCHEMAS: Dict[str, Dict[int, Tuple[str, str]]] = {
    "ModelProto": {
        1: ("ir_version", "int"),
        2: ("producer_name", "str"),
        3: ("producer_version", "str"),
        4: ("domain", "str"),
        5: ("model_version", "int"),
        6: ("doc_string", "str"),
        7: ("graph", "msg:GraphProto"),
        8: ("opset_import", "rep:msg:OperatorSetIdProto"),
    },
    "OperatorSetIdProto": {
        1: ("domain", "str"),
        2: ("version", "int"),
    },
    "GraphProto": {
        1: ("node", "rep:msg:NodeProto"),
        2: ("name", "str"),
        5: ("initializer", "rep:msg:TensorProto"),
        10: ("doc_string", "str"),
        11: ("input", "rep:msg:ValueInfoProto"),
        12: ("output", "rep:msg:ValueInfoProto"),
        13: ("value_info", "rep:msg:ValueInfoProto"),
    },
    "NodeProto": {
        1: ("input", "rep:str"),
        2: ("output", "rep:str"),
        3: ("name", "str"),
        4: ("op_type", "str"),
        5: ("attribute", "rep:msg:AttributeProto"),
        6: ("doc_string", "str"),
        7: ("domain", "str"),
    },
    "AttributeProto": {
        1: ("name", "str"),
        2: ("f", "float"),
        3: ("i", "int"),
        4: ("s", "bytes"),
        5: ("t", "msg:TensorProto"),
        7: ("floats", "rep:float"),
        8: ("ints", "rep:int"),
        9: ("strings", "rep:bytes"),
        20: ("type", "int"),
    },
    "TensorProto": {
        1: ("dims", "rep:int"),
        2: ("data_type", "int"),
        4: ("float_data", "rep:float"),
        7: ("int64_data", "rep:int"),
        8: ("name", "str"),
        9: ("raw_data", "bytes"),
    },
    "ValueInfoProto": {
        1: ("name", "str"),
        2: ("type", "msg:TypeProto"),
        3: ("doc_string", "str"),
    },
    "TypeProto": {
        1: ("tensor_type", "msg:TypeProto.Tensor"),
    },
    "TypeProto.Tensor": {
        1: ("elem_type", "int"),
        2: ("shape", "msg:TensorShapeProto"),
    },
    "TensorShapeProto": {
        1: ("dim", "rep:msg:TensorShapeProto.Dimension"),
    },
    "TensorShapeProto.Dimension": {
        1: ("dim_value", "int"),
        2: ("dim_param", "str"),
    },
}

# AttributeProto.type values (public onnx.proto AttributeType)
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8

# TensorProto.DataType values (public onnx.proto)
DT_FLOAT, DT_INT32, DT_INT64, DT_BOOL, DT_FLOAT16 = 1, 6, 7, 9, 10
DT_DOUBLE, DT_BFLOAT16 = 11, 16


class Payload:
    """The value of a `bytes` field that `write` streams to its file:
    `nbytes` long, written by `write_to(f)`."""

    def __init__(self, nbytes: int, write_to: Callable[[io.RawIOBase],
                                                       None]):
        self.nbytes = int(nbytes)
        self.write_to = write_to


# an encoded message: bytes, with a Payload wherever one is streamed
_Parts = List[Union[bytes, Payload]]


def _write_varint(buf: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64          # proto int64 negative: 10-byte twos-complement
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data, pos: int) -> Tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if out >= 1 << 63:        # negative int64
        out -= 1 << 64
    return out, pos


def _key(field: int, wtype: int) -> int:
    return (field << 3) | wtype


def _encode_scalar(buf: bytearray, field: int, kind: str, v) -> None:
    if kind == "int":
        _write_varint(buf, _key(field, 0))
        _write_varint(buf, int(v))
    elif kind == "float":
        _write_varint(buf, _key(field, 5))
        buf += struct.pack("<f", float(v))
    elif kind in ("str", "bytes"):
        raw = v.encode() if kind == "str" else bytes(v)
        _write_varint(buf, _key(field, 2))
        _write_varint(buf, len(raw))
        buf += raw
    else:
        raise ValueError(f"unknown scalar kind {kind}")


def _size(parts: _Parts) -> int:
    return sum(p.nbytes if isinstance(p, Payload) else len(p)
               for p in parts)


def _parts(message: str, d: dict) -> _Parts:
    """The encoding of `d` as bytes runs and the Payloads between them."""
    schema = SCHEMAS[message]
    by_name = {name: (num, kind) for num, (name, kind) in schema.items()}
    parts: _Parts = []
    buf = bytearray()

    def flush():
        nonlocal buf
        if buf:
            parts.append(bytes(buf))
            buf = bytearray()

    for name, value in d.items():
        num, kind = by_name[name]
        rep = kind.startswith("rep:")
        k = kind[4:] if rep else kind
        vals = value if rep else [value]
        if k.startswith("msg:"):
            sub = k[4:]
            for v in vals:
                inner = _parts(sub, v)
                _write_varint(buf, _key(num, 2))
                _write_varint(buf, _size(inner))
                for p in inner:
                    if isinstance(p, Payload):
                        flush()
                        parts.append(p)
                    else:
                        buf += p
        elif rep and k in ("int", "float"):
            # packed encoding (proto3 default for repeated numerics)
            payload = bytearray()
            for v in vals:
                if k == "int":
                    _write_varint(payload, int(v))
                else:
                    payload += struct.pack("<f", float(v))
            _write_varint(buf, _key(num, 2))
            _write_varint(buf, len(payload))
            buf += payload
        else:
            for v in vals:
                if isinstance(v, Payload):
                    _write_varint(buf, _key(num, 2))
                    _write_varint(buf, v.nbytes)
                    flush()
                    parts.append(v)
                else:
                    _encode_scalar(buf, num, k, v)
    flush()
    return parts


def write(f, message: str, d: dict) -> int:
    """Write the bytes of `encode(message, d)` to the binary file `f`,
    each Payload streamed in place; returns the bytes written."""
    n = 0
    for p in _parts(message, d):
        if isinstance(p, Payload):
            at = f.tell()
            p.write_to(f)
            if f.tell() - at != p.nbytes:
                raise ValueError(f"payload wrote {f.tell() - at} bytes, "
                                 f"declared {p.nbytes}")
            n += p.nbytes
        else:
            f.write(p)
            n += len(p)
    return n


def encode(message: str, d: dict) -> bytes:
    out = io.BytesIO()
    write(out, message, d)
    return out.getvalue()


def decode(message: str, data) -> dict:
    """`data`: bytes, or a memoryview (then `bytes` fields stay views of
    it)."""
    schema = SCHEMAS[message]
    out: dict = {}
    pos = 0
    n = len(data)
    while pos < n:
        key, pos = _read_varint(data, pos)
        field, wtype = key >> 3, key & 7
        entry = schema.get(field)
        # read the value per wire type
        if wtype == 0:
            v, pos = _read_varint(data, pos)
        elif wtype == 5:
            (v,) = struct.unpack_from("<f", data, pos)
            pos += 4
        elif wtype == 1:
            (v,) = struct.unpack_from("<d", data, pos)
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(data, pos)
            v = data[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        if entry is None:
            continue                       # unknown field: skip
        name, kind = entry
        rep = kind.startswith("rep:")
        k = kind[4:] if rep else kind
        if k.startswith("msg:"):
            v = decode(k[4:], v)
        elif k == "str":
            v = bytes(v).decode() if isinstance(
                v, (bytes, bytearray, memoryview)) else v
        elif rep and k in ("int", "float") and wtype == 2:
            # packed repeated scalars
            vals = []
            p = 0
            while p < len(v):
                if k == "int":
                    x, p = _read_varint(v, p)
                else:
                    (x,) = struct.unpack_from("<f", v, p)
                    p += 4
                vals.append(x)
            out.setdefault(name, []).extend(vals)
            continue
        if rep:
            out.setdefault(name, []).append(v)
        else:
            out[name] = v
    return out


def load_mapped(path: str) -> Tuple[dict, mmap.mmap]:
    """Decode the ModelProto file at `path` through a read-only mmap: (the
    message, the map). `bytes` fields are views of the map, which must
    outlive them."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    return decode("ModelProto", memoryview(mm)), mm
