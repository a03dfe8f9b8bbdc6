"""The protobuf wire format of the ONNX subset the exporter and importer
use, encoded and decoded without `google.protobuf`.

The subset is the JAX package's `onnx_subset.proto`: ModelProto,
GraphProto, NodeProto, AttributeProto, TensorProto, ValueInfoProto,
TypeProto (and its Tensor), TensorShapeProto (and its Dimension) and
OperatorSetIdProto, with the field numbers and types of the public ONNX
schema.  The encoder writes what protobuf's proto3 encoder writes: the
fields in field-number order; a singular scalar only when it is not its
default; a message field and a member of a ``oneof`` whenever set; a
repeated numeric field packed (proto3's default).  The decoder reads
packed and unpacked repeated numbers alike and skips unknown fields.

A message is built as a list of chunks and joined once, and a ``bytes``
field may be any contiguous buffer (`memoryview` of a numpy array), so
a 553 MB ``raw_data`` is copied once, into the file's bytes; decoded
``bytes`` fields are `memoryview` slices of the input, not copies.
"""
from __future__ import annotations

import struct

__all__ = ["encode", "decode", "ModelProto", "GraphProto", "NodeProto",
           "AttributeProto", "TensorProto", "ValueInfoProto", "TypeProto",
           "TypeProtoTensor", "TensorShapeProto", "Dimension",
           "OperatorSetIdProto"]

# field modes: singular (written unless default), oneof (written when
# set), repeated (one record per item), packed (one record for all)
_ONE, _ONEOF, _REP, _PACKED = "one", "oneof", "repeated", "packed"

# message -> [(field number, name, type, mode)], in field-number order
_SCHEMA = {
    "AttributeProto": [
        (1, "name", "string", _ONE), (2, "f", "float", _ONE),
        (3, "i", "int64", _ONE), (4, "s", "bytes", _ONE),
        (5, "t", "TensorProto", _ONE), (6, "g", "GraphProto", _ONE),
        (7, "floats", "float", _PACKED), (8, "ints", "int64", _PACKED),
        (9, "strings", "bytes", _REP), (10, "tensors", "TensorProto", _REP),
        (11, "graphs", "GraphProto", _REP), (20, "type", "enum", _ONE)],
    "ValueInfoProto": [
        (1, "name", "string", _ONE), (2, "type", "TypeProto", _ONE),
        (3, "doc_string", "string", _ONE)],
    "NodeProto": [
        (1, "input", "string", _REP), (2, "output", "string", _REP),
        (3, "name", "string", _ONE), (4, "op_type", "string", _ONE),
        (5, "attribute", "AttributeProto", _REP),
        (6, "doc_string", "string", _ONE), (7, "domain", "string", _ONE)],
    "ModelProto": [
        (1, "ir_version", "int64", _ONE),
        (2, "producer_name", "string", _ONE),
        (3, "producer_version", "string", _ONE),
        (4, "domain", "string", _ONE), (5, "model_version", "int64", _ONE),
        (6, "doc_string", "string", _ONE),
        (7, "graph", "GraphProto", _ONE),
        (8, "opset_import", "OperatorSetIdProto", _REP)],
    "GraphProto": [
        (1, "node", "NodeProto", _REP), (2, "name", "string", _ONE),
        (5, "initializer", "TensorProto", _REP),
        (10, "doc_string", "string", _ONE),
        (11, "input", "ValueInfoProto", _REP),
        (12, "output", "ValueInfoProto", _REP),
        (13, "value_info", "ValueInfoProto", _REP)],
    "TensorProto": [
        (1, "dims", "int64", _PACKED), (2, "data_type", "int32", _ONE),
        (4, "float_data", "float", _PACKED),
        (5, "int32_data", "int32", _PACKED),
        (6, "string_data", "bytes", _REP),
        (7, "int64_data", "int64", _PACKED), (8, "name", "string", _ONE),
        (9, "raw_data", "bytes", _ONE),
        (10, "double_data", "double", _PACKED),
        (11, "uint64_data", "uint64", _PACKED),
        (12, "doc_string", "string", _ONE)],
    "TensorShapeProto": [(1, "dim", "Dimension", _REP)],
    "Dimension": [(1, "dim_value", "int64", _ONEOF),
                  (2, "dim_param", "string", _ONEOF)],
    "TypeProto": [(1, "tensor_type", "TypeProtoTensor", _ONEOF)],
    "TypeProtoTensor": [(1, "elem_type", "int32", _ONE),
                        (2, "shape", "TensorShapeProto", _ONE)],
    "OperatorSetIdProto": [(1, "domain", "string", _ONE),
                           (2, "version", "int64", _ONE)],
}

_VARINT = {"int64", "int32", "uint64", "enum"}
_DEFAULT = {"string": "", "bytes": b"", "float": 0.0, "double": 0.0}
_WIRE = {"float": 5, "double": 1, "string": 2, "bytes": 2}


class _Message:
    """A message of the subset: attributes named as the schema's fields;
    repeated fields are lists, an unset message field or oneof member is
    None."""

    _kind = None

    def __init__(self, **fields):
        for _, name, typ, mode in _SCHEMA[self._kind]:
            if mode in (_REP, _PACKED):
                value = []
            elif mode == _ONEOF or typ in _SCHEMA:
                value = None
            else:
                value = _DEFAULT.get(typ, 0)
            setattr(self, name, value)
        for name, value in fields.items():
            if not hasattr(self, name):
                raise AttributeError(f"{self._kind} has no field {name!r}")
            setattr(self, name, value)

    def __repr__(self):
        return f"<{self._kind}>"


def _make(kind):
    return type(kind, (_Message,), {"_kind": kind})


ModelProto = _make("ModelProto")
GraphProto = _make("GraphProto")
NodeProto = _make("NodeProto")
AttributeProto = _make("AttributeProto")
TensorProto = _make("TensorProto")
ValueInfoProto = _make("ValueInfoProto")
TypeProto = _make("TypeProto")
TypeProtoTensor = _make("TypeProtoTensor")
TensorShapeProto = _make("TensorShapeProto")
Dimension = _make("Dimension")
OperatorSetIdProto = _make("OperatorSetIdProto")
_CLASSES = {c._kind: c for c in (
    ModelProto, GraphProto, NodeProto, AttributeProto, TensorProto,
    ValueInfoProto, TypeProto, TypeProtoTensor, TensorShapeProto, Dimension,
    OperatorSetIdProto)}

# AttributeProto.AttributeType and TensorProto.DataType values
FLOAT, INT, STRING, TENSOR, GRAPH, FLOATS, INTS = 1, 2, 3, 4, 5, 6, 7


# -- encoding ----------------------------------------------------------------

def _varint(v):
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        byte = v & 0x7F
        v >>= 7
        if v:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(num, wire):
    return _varint((num << 3) | wire)


def _scalar_bytes(typ, v):
    if typ in _VARINT:
        return _varint(int(v))
    if typ == "float":
        return struct.pack("<f", v)
    return struct.pack("<d", v)


def _blob(v):
    """A string or bytes-like value as a contiguous byte buffer."""
    if isinstance(v, str):
        return v.encode()
    if isinstance(v, (bytes, bytearray)):
        return v
    return memoryview(v).cast("B")


def _encode(msg, out):
    """Append `msg`'s encoding to the chunk list `out`; returns its size."""
    size = 0
    for num, name, typ, mode in _SCHEMA[msg._kind]:
        value = getattr(msg, name)
        if mode == _PACKED:
            if not value:
                continue
            payload = b"".join(_scalar_bytes(typ, v) for v in value)
            head = _tag(num, 2) + _varint(len(payload))
            out += (head, payload)
            size += len(head) + len(payload)
            continue
        if mode == _REP:
            items = value
        elif mode == _ONEOF or typ in _SCHEMA:
            items = [] if value is None else [value]
        elif _WIRE.get(typ) == 2:
            items = [value] if len(_blob(value)) else []
        else:
            items = [] if value == 0 else [value]
        for item in items:
            if typ in _SCHEMA:
                sub = []
                n = _encode(item, sub)
                head = _tag(num, 2) + _varint(n)
                out.append(head)
                out += sub
                size += len(head) + n
            elif _WIRE.get(typ) == 2:
                data = _blob(item)
                head = _tag(num, 2) + _varint(len(data))
                out += (head, data)
                size += len(head) + len(data)
            else:
                rec = _tag(num, 0 if typ in _VARINT else _WIRE[typ]) + \
                    _scalar_bytes(typ, item)
                out.append(rec)
                size += len(rec)
    return size


def encode(msg):
    """The message's wire bytes, joined once."""
    chunks = []
    _encode(msg, chunks)
    return b"".join(chunks)


# -- decoding ----------------------------------------------------------------

def _read_varint(buf, pos):
    shift = result = 0
    while True:
        byte = buf[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, pos
        shift += 7


def _signed(v, typ):
    if typ in ("int64", "int32", "enum") and v >= 1 << 63:
        v -= 1 << 64
    return v


def _unpack(typ, data):
    """The values of a packed repeated field."""
    if typ == "float":
        return list(struct.unpack(f"<{len(data) // 4}f", data))
    if typ == "double":
        return list(struct.unpack(f"<{len(data) // 8}d", data))
    vals, pos = [], 0
    while pos < len(data):
        v, pos = _read_varint(data, pos)
        vals.append(_signed(v, typ))
    return vals


def _decode(kind, buf):
    msg = _CLASSES[kind]()
    fields = {num: (name, typ, mode)
              for num, name, typ, mode in _SCHEMA[kind]}
    pos, end = 0, len(buf)
    while pos < end:
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            raw, pos = _read_varint(buf, pos)
        elif wire == 1:
            raw, pos = buf[pos:pos + 8], pos + 8
        elif wire == 5:
            raw, pos = buf[pos:pos + 4], pos + 4
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            raw, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"onnx wire: unsupported wire type {wire} in "
                             f"{kind}")
        if num not in fields:
            continue                       # an unknown field: skipped
        name, typ, mode = fields[num]
        if typ in _SCHEMA:
            value = _decode(typ, raw)
        elif typ == "string":
            value = bytes(raw).decode()
        elif typ == "bytes":
            value = raw
        elif wire == 2:                    # a packed run of numbers
            getattr(msg, name).extend(_unpack(typ, raw))
            continue
        elif typ in _VARINT:
            value = _signed(raw, typ)
        else:
            value = struct.unpack("<f" if typ == "float" else "<d",
                                  raw)[0]
        if mode in (_REP, _PACKED):
            getattr(msg, name).append(value)
        else:
            setattr(msg, name, value)
    return msg


def decode(kind, data):
    """A `kind` message (a schema name, e.g. "ModelProto") from its wire
    bytes; ``bytes`` fields are views of `data`."""
    return _decode(kind, memoryview(data))
