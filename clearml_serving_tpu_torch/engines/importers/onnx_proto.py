"""Zero-dependency ONNX protobuf parser (wire format, schema-driven).

The port's copy of ``clearml_serving_tpu/engines/importers/onnx_proto.py``
(numpy only), unchanged but for this paragraph. The serving image has no
``onnx`` package, and the ONNX file format is plain protobuf: a generic
tag/varint/length-delimited decoder plus the (stable, public) ONNX message
schema is all that is needed to read ModelProto files. Only the fields the
importers consume are mapped; unknown fields are skipped per protobuf
rules, so files from any exporter version parse. The GraphDef importer
reads TF's messages with the same decoder.

Schema reference: onnx/onnx.proto3 (public spec). Wire format: protobuf
encoding spec (varint wire type 0, 64-bit 1, length-delimited 2, 32-bit 5).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError("unsupported protobuf wire type {}".format(wire_type))
    return pos


def _zigzag_to_signed(v: int, bits: int = 64) -> int:
    # ONNX int64 fields use plain (two's complement) varints, not zigzag;
    # negative values arrive as 10-byte varints — wrap back to signed
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


# field kinds: "varint" | "svarint" | "bytes" | "string" | "float" |
#              ("message", schema) ; repeated=True collects lists, and
#              repeated varint/float fields also accept packed encoding.
Field = Tuple[str, Any, bool]

TENSOR_SHAPE_DIM = {1: ("dim_value", "svarint", False), 2: ("dim_param", "string", False)}
TENSOR_SHAPE = {1: ("dim", ("message", TENSOR_SHAPE_DIM), True)}
TENSOR_TYPE = {1: ("elem_type", "varint", False), 2: ("shape", ("message", TENSOR_SHAPE), False)}
TYPE_PROTO = {1: ("tensor_type", ("message", TENSOR_TYPE), False)}
VALUE_INFO = {1: ("name", "string", False), 2: ("type", ("message", TYPE_PROTO), False)}

TENSOR = {
    1: ("dims", "svarint", True),
    2: ("data_type", "varint", False),
    4: ("float_data", "float", True),
    5: ("int32_data", "svarint", True),
    6: ("string_data", "bytes", True),
    7: ("int64_data", "svarint", True),
    8: ("name", "string", False),
    9: ("raw_data", "bytes", False),
    10: ("double_data", "double", True),
    11: ("uint64_data", "varint", True),
}

ATTRIBUTE: Dict[int, Field] = {
    1: ("name", "string", False),
    2: ("f", "float32", False),
    3: ("i", "svarint", False),
    4: ("s", "bytes", False),
    5: ("t", ("message", TENSOR), False),
    7: ("floats", "float", True),
    8: ("ints", "svarint", True),
    9: ("strings", "bytes", True),
    10: ("tensors", ("message", TENSOR), True),
    20: ("type", "varint", False),
}

NODE = {
    1: ("input", "string", True),
    2: ("output", "string", True),
    3: ("name", "string", False),
    4: ("op_type", "string", False),
    5: ("attribute", ("message", ATTRIBUTE), True),
    7: ("domain", "string", False),
}

GRAPH = {
    1: ("node", ("message", NODE), True),
    2: ("name", "string", False),
    5: ("initializer", ("message", TENSOR), True),
    11: ("input", ("message", VALUE_INFO), True),
    12: ("output", ("message", VALUE_INFO), True),
    13: ("value_info", ("message", VALUE_INFO), True),
}

OPSET_ID = {1: ("domain", "string", False), 2: ("version", "svarint", False)}

MODEL = {
    1: ("ir_version", "svarint", False),
    2: ("producer_name", "string", False),
    5: ("model_version", "svarint", False),
    7: ("graph", ("message", GRAPH), False),
    8: ("opset_import", ("message", OPSET_ID), True),
}


def _parse_message(buf: bytes, schema: Dict[int, Field]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field_no, wire_type = tag >> 3, tag & 0x7
        spec = schema.get(field_no)
        if spec is None:
            pos = _skip_field(buf, pos, wire_type)
            continue
        name, kind, repeated = spec
        values: List[Any] = []
        if isinstance(kind, tuple):  # nested message
            if wire_type != 2:
                # same field number, wrong wire type: this buffer is a
                # DIFFERENT message type than the schema (e.g. probing a
                # SavedModel with the GraphDef schema, whose field 1 is the
                # varint schema_version) — skip instead of misreading the
                # varint as a length and walking off the buffer
                pos = _skip_field(buf, pos, wire_type)
                continue
            n, pos = _read_varint(buf, pos)
            values.append(_parse_message(buf[pos : pos + n], kind[1]))
            pos += n
        elif kind in ("varint", "svarint"):
            if wire_type == 2:  # packed repeated
                n, pos = _read_varint(buf, pos)
                stop = pos + n
                while pos < stop:
                    v, pos = _read_varint(buf, pos)
                    values.append(_zigzag_to_signed(v) if kind == "svarint" else v)
            else:
                v, pos = _read_varint(buf, pos)
                values.append(_zigzag_to_signed(v) if kind == "svarint" else v)
        elif kind in ("bytes", "string"):
            n, pos = _read_varint(buf, pos)
            raw = buf[pos : pos + n]
            pos += n
            values.append(raw.decode("utf-8", "replace") if kind == "string" else raw)
        elif kind == "float32":  # single fixed32
            values.append(struct.unpack_from("<f", buf, pos)[0])
            pos += 4
        elif kind == "float":  # repeated float (packed or not)
            if wire_type == 2:
                n, pos = _read_varint(buf, pos)
                values.extend(
                    struct.unpack_from("<{}f".format(n // 4), buf, pos)
                )
                pos += n
            else:
                values.append(struct.unpack_from("<f", buf, pos)[0])
                pos += 4
        elif kind == "double":
            if wire_type == 2:
                n, pos = _read_varint(buf, pos)
                values.extend(
                    struct.unpack_from("<{}d".format(n // 8), buf, pos)
                )
                pos += n
            else:
                values.append(struct.unpack_from("<d", buf, pos)[0])
                pos += 8
        else:
            raise ValueError("unknown field kind {!r}".format(kind))
        if repeated:
            out.setdefault(name, []).extend(values)
        else:
            out[name] = values[-1]
    return out


def parse_model(data: bytes) -> Dict[str, Any]:
    """ONNX ModelProto bytes -> nested dict of the mapped fields."""
    return _parse_message(data, MODEL)


# TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_BFLOAT16 = 16


def tensor_to_numpy(t: Dict[str, Any]) -> np.ndarray:
    """Materialize a parsed TensorProto (raw_data or typed repeated fields)."""
    dims = [int(d) for d in t.get("dims", [])]
    dt = int(t.get("data_type", 1))
    if dt == _BFLOAT16:
        raw = t.get("raw_data", b"")
        # bfloat16 = top 16 bits of float32
        u16 = np.frombuffer(raw, np.uint16)
        arr = (u16.astype(np.uint32) << 16).view(np.float32)
        return arr.reshape(dims)
    if dt not in _DTYPES:
        raise ValueError("unsupported ONNX tensor data_type {}".format(dt))
    np_dtype = _DTYPES[dt]
    raw = t.get("raw_data")
    if raw:
        return np.frombuffer(raw, np_dtype).reshape(dims).copy()
    if dt == 10 and t.get("int32_data"):
        # FLOAT16 typed storage holds uint16 BIT PATTERNS in int32_data
        # (ONNX spec) — reinterpret, never numeric-cast
        return (
            np.asarray(t["int32_data"], np.int32)
            .astype(np.uint16)
            .view(np.float16)
            .reshape(dims)
        )
    for field, cast in (
        ("float_data", np.float32),
        ("int32_data", np.int32),
        ("int64_data", np.int64),
        ("double_data", np.float64),
        ("uint64_data", np.uint64),
    ):
        if t.get(field):
            return np.asarray(t[field], cast).astype(np_dtype).reshape(dims)
    return np.zeros(dims, np_dtype)


def value_info_shape(vi: Dict[str, Any]) -> List[Any]:
    """Static dims as ints; dynamic dims (dim_param / absent) as None."""
    tt = (vi.get("type") or {}).get("tensor_type") or {}
    dims = (tt.get("shape") or {}).get("dim") or []
    out: List[Any] = []
    for d in dims:
        if "dim_value" in d and int(d["dim_value"]) > 0:
            out.append(int(d["dim_value"]))
        else:
            out.append(None)
    return out
