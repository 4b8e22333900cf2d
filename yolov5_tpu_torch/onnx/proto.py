"""Dependency-free ONNX protobuf wire-format writer/reader.

A copy of ``yolov5_tpu/onnx/proto.py`` (numpy and ``struct`` only), so that
the port writes and reads ``.onnx`` files without the ``onnx`` package and
without importing the JAX package. ``tests/test_torch_export.py`` holds the
copy to its original: both serialise a model to the same bytes and each
parses the other's file. The field numbers follow the published
``onnx.proto`` at IR version 8 / opset 13.

Wire format refresher (https://protobuf.dev/programming-guides/encoding/):
  tag = (field_number << 3) | wire_type
  wire types: 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# ---------------------------------------------------------------------------
# low-level encoding


def _varint(value: int) -> bytes:
    """Unsigned LEB128. Negative ints are encoded as 64-bit two's complement
    (protobuf int64 semantics)."""
    if value < 0:
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field_number: int, wire_type: int) -> bytes:
    return _varint((field_number << 3) | wire_type)


def fv(field_number: int, value: int) -> bytes:
    """varint field"""
    return _key(field_number, 0) + _varint(int(value))


def fb(field_number: int, data: bytes) -> bytes:
    """length-delimited field (bytes / string / sub-message / packed)"""
    if isinstance(data, str):
        data = data.encode("utf-8")
    return _key(field_number, 2) + _varint(len(data)) + data


def ff(field_number: int, value: float) -> bytes:
    """float (32-bit) field"""
    return _key(field_number, 5) + struct.pack("<f", float(value))


def packed_varints(field_number: int, values) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return fb(field_number, payload)


# ---------------------------------------------------------------------------
# ONNX TensorProto.DataType

FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING, BOOL = range(1, 10)
FLOAT16, DOUBLE, UINT32, UINT64 = 10, 11, 12, 13
BFLOAT16 = 16

_NP_TO_ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.uint16): UINT16,
    np.dtype(np.int16): INT16,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
    np.dtype(np.uint32): UINT32,
    np.dtype(np.uint64): UINT64,
}
_ONNX_TO_NP = {v: k for k, v in _NP_TO_ONNX.items()}


def onnx_dtype(np_dtype) -> int:
    dt = np.dtype(np_dtype)
    if dt not in _NP_TO_ONNX:
        raise ValueError(f"no ONNX data type for {dt}")
    return _NP_TO_ONNX[dt]


def np_dtype(onnx_type: int):
    if onnx_type == BFLOAT16:
        # numpy has no bfloat16; reader widens to float32 (jax/ml_dtypes
        # round-trips are handled by the caller if needed)
        return np.dtype(np.float32)
    return _ONNX_TO_NP[onnx_type]


# ---------------------------------------------------------------------------
# message builders (bottom-up, each returns serialized bytes)


def tensor(name: str, array: np.ndarray) -> bytes:
    """TensorProto: dims=1, data_type=2, name=8, raw_data=9."""
    array = np.ascontiguousarray(array)
    out = packed_varints(1, array.shape) if array.ndim else b""
    out += fv(2, onnx_dtype(array.dtype))
    out += fb(8, name)
    out += fb(9, array.tobytes())
    return out


def _tensor_shape(shape) -> bytes:
    """TensorShapeProto: dim=1; Dimension: dim_value=1 | dim_param=2."""
    dims = b""
    for d in shape:
        dims += fb(1, fb(2, d) if isinstance(d, str) else fv(1, int(d)))
    return dims


def value_info(name: str, elem_type: int, shape) -> bytes:
    """ValueInfoProto: name=1, type=2. TypeProto: tensor_type=1.
    TypeProto.Tensor: elem_type=1, shape=2."""
    tt = fv(1, elem_type) + fb(2, _tensor_shape(shape))
    return fb(1, name) + fb(2, fb(1, tt))


# AttributeProto.AttributeType
AT_FLOAT, AT_INT, AT_STRING, AT_TENSOR, AT_GRAPH = 1, 2, 3, 4, 5
AT_FLOATS, AT_INTS, AT_STRINGS = 6, 7, 8


def attribute(name: str, value) -> bytes:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
    strings=9, type=20."""
    out = fb(1, name)
    if isinstance(value, bool):
        out += fv(3, int(value)) + fv(20, AT_INT)
    elif isinstance(value, int):
        out += fv(3, value) + fv(20, AT_INT)
    elif isinstance(value, float):
        out += ff(2, value) + fv(20, AT_FLOAT)
    elif isinstance(value, (str, bytes)):
        out += fb(4, value) + fv(20, AT_STRING)
    elif isinstance(value, np.ndarray):
        out += fb(5, tensor(name + "_value", value)) + fv(20, AT_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            out += b"".join(fv(8, int(v)) for v in value) + fv(20, AT_INTS)
        elif all(isinstance(v, float) for v in value):
            out += b"".join(ff(7, v) for v in value) + fv(20, AT_FLOATS)
        elif all(isinstance(v, (str, bytes)) for v in value):
            out += b"".join(fb(9, v) for v in value) + fv(20, AT_STRINGS)
        else:
            raise TypeError(f"mixed attribute list for {name!r}: {value!r}")
    else:
        raise TypeError(f"unsupported attribute {name!r} = {value!r}")
    return out


def node(op_type: str, inputs, outputs, name: str = "", attrs: dict | None = None,
         domain: str = "") -> bytes:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5, domain=7."""
    out = b"".join(fb(1, i) for i in inputs)
    out += b"".join(fb(2, o) for o in outputs)
    if name:
        out += fb(3, name)
    out += fb(4, op_type)
    for k, v in (attrs or {}).items():
        out += fb(5, attribute(k, v))
    if domain:
        out += fb(7, domain)
    return out


def graph(nodes, name: str, inputs, outputs, initializers) -> bytes:
    """GraphProto: node=1, name=2, initializer=5, input=11, output=12."""
    out = b"".join(fb(1, n) for n in nodes)
    out += fb(2, name)
    out += b"".join(fb(5, t) for t in initializers)
    out += b"".join(fb(11, vi) for vi in inputs)
    out += b"".join(fb(12, vi) for vi in outputs)
    return out


def model(graph_bytes: bytes, opset: int = 13, ir_version: int = 8,
          producer: str = "yolov5_tpu", producer_version: str = "1.0",
          doc: str = "", metadata: dict | None = None) -> bytes:
    """ModelProto: ir_version=1, producer_name=2, producer_version=3,
    model_version=5, doc_string=6, graph=7, opset_import=8, metadata_props=14.
    OperatorSetIdProto: domain=1, version=2. StringStringEntryProto: key=1,
    value=2."""
    out = fv(1, ir_version)
    out += fb(2, producer)
    out += fb(3, producer_version)
    if doc:
        out += fb(6, doc)
    out += fb(7, graph_bytes)
    out += fb(8, fv(2, opset))  # default domain ""
    for k, v in (metadata or {}).items():
        out += fb(14, fb(1, str(k)) + fb(2, str(v)))
    return out


# ---------------------------------------------------------------------------
# reader: generic wire parser + schema-driven decode into plain dicts


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_wire(buf: bytes):
    """Parse one message's fields -> {field_number: [raw values]}.
    Length-delimited values stay bytes (caller recurses per schema)."""
    fields: dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        fn, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 1:
            v = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")
        fields.setdefault(fn, []).append(v)
    return fields


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _unpack_varints(raw_list) -> list[int]:
    """Repeated int64 arrives either packed (one bytes blob) or unpacked."""
    out = []
    for item in raw_list:
        if isinstance(item, (bytes, bytearray)):
            pos = 0
            while pos < len(item):
                v, pos = _read_varint(item, pos)
                out.append(_signed64(v))
        else:
            out.append(_signed64(item))
    return out


@dataclass
class Tensor:
    name: str
    array: np.ndarray


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    attrs: dict = field(default_factory=dict)


@dataclass
class Graph:
    name: str
    nodes: list[Node]
    inputs: list[tuple[str, int, list]]   # (name, elem_type, shape)
    outputs: list[tuple[str, int, list]]
    initializers: dict[str, np.ndarray]


@dataclass
class Model:
    ir_version: int
    opset: int
    producer: str
    graph: Graph
    metadata: dict


def _parse_tensor(buf: bytes) -> Tensor:
    f = parse_wire(buf)
    dims = _unpack_varints(f.get(1, []))
    data_type = f[2][0]
    name = f.get(8, [b""])[0].decode("utf-8", "replace")
    dt = np_dtype(data_type)
    if 9 in f:  # raw_data
        raw = f[9][0]
        if data_type == BFLOAT16:  # widen to float32 (numpy has no bf16)
            u32 = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = u32.view(np.float32)
        else:
            arr = np.frombuffer(raw, dt)
    elif 4 in f:  # float_data (packed or not)
        vals = []
        for item in f[4]:
            if isinstance(item, (bytes, bytearray)):
                vals.extend(struct.unpack(f"<{len(item) // 4}f", item))
            else:
                vals.append(item)
        arr = np.array(vals, np.float32)
    elif 7 in f:  # int64_data
        arr = np.array(_unpack_varints(f[7]), np.int64)
    elif 5 in f:  # int32_data
        arr = np.array(_unpack_varints(f[5]), dt if dt.itemsize <= 4 else np.int32)
    else:
        arr = np.zeros(0, dt)
    return Tensor(name, arr.reshape(dims).astype(dt, copy=False))


def _parse_attribute(buf: bytes):
    f = parse_wire(buf)
    name = f[1][0].decode()
    at = f.get(20, [0])[0]
    if at == AT_INT:
        return name, _signed64(f[3][0])
    if at == AT_FLOAT:
        return name, f[2][0]
    if at == AT_STRING:
        return name, f[4][0].decode("utf-8", "replace")
    if at == AT_TENSOR:
        return name, _parse_tensor(f[5][0]).array
    if at == AT_INTS:
        return name, _unpack_varints(f.get(8, []))
    if at == AT_FLOATS:
        return name, [v for v in f.get(7, [])]
    if at == AT_STRINGS:
        return name, [s.decode("utf-8", "replace") for s in f.get(9, [])]
    return name, None  # graphs/unknown: not needed by the mini-runtime


def _parse_value_info(buf: bytes):
    f = parse_wire(buf)
    name = f[1][0].decode()
    elem_type, shape = 0, []
    if 2 in f:
        tp = parse_wire(f[2][0])
        if 1 in tp:  # tensor_type
            tt = parse_wire(tp[1][0])
            elem_type = tt.get(1, [0])[0]
            if 2 in tt:
                for dim_buf in parse_wire(tt[2][0]).get(1, []):
                    d = parse_wire(dim_buf)
                    if 1 in d:
                        shape.append(_signed64(d[1][0]))
                    elif 2 in d:
                        shape.append(d[2][0].decode())
                    else:
                        shape.append(None)
    return name, elem_type, shape


def _parse_node(buf: bytes) -> Node:
    f = parse_wire(buf)
    return Node(
        op_type=f[4][0].decode(),
        inputs=[s.decode() for s in f.get(1, [])],
        outputs=[s.decode() for s in f.get(2, [])],
        name=f.get(3, [b""])[0].decode(),
        attrs=dict(_parse_attribute(a) for a in f.get(5, [])),
    )


def _parse_graph(buf: bytes) -> Graph:
    f = parse_wire(buf)
    inits = [_parse_tensor(t) for t in f.get(5, [])]
    return Graph(
        name=f.get(2, [b""])[0].decode(),
        nodes=[_parse_node(n) for n in f.get(1, [])],
        inputs=[_parse_value_info(v) for v in f.get(11, [])],
        outputs=[_parse_value_info(v) for v in f.get(12, [])],
        initializers={t.name: t.array for t in inits},
    )


def parse_model(buf: bytes) -> Model:
    f = parse_wire(buf)
    opset = 0
    for op in f.get(8, []):
        o = parse_wire(op)
        domain = o.get(1, [b""])[0]
        if domain in (b"", b"ai.onnx"):
            opset = max(opset, _signed64(o.get(2, [0])[0]))
    meta = {}
    for m in f.get(14, []):
        mm = parse_wire(m)
        meta[mm[1][0].decode()] = mm[2][0].decode()
    return Model(
        ir_version=f.get(1, [0])[0],
        opset=opset,
        producer=f.get(2, [b""])[0].decode(),
        graph=_parse_graph(f[7][0]),
        metadata=meta,
    )
