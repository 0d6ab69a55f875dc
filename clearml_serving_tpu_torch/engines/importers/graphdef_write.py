"""A minimal writer of frozen TF GraphDefs (protobuf wire format, public
spec), without TensorFlow: the bytes TF serializes for a frozen inference
graph of Placeholder, Const and op nodes. It writes the graphs the GraphDef
importer's tests and ``chip_smoke.py`` serve; ``cnn_graphdef`` writes the
``cnn`` bundle's network (models/cnn.py) as TF would hold it: NHWC, HWIO
kernels, SAME convolutions, VALID 2x2 max-pools, the NHWC flatten."""

from __future__ import annotations

import struct

import numpy as np

_TF_DTYPES = {"float32": 1, "int32": 3, "int64": 9}


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def len_field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def varint_field(num: int, value: int) -> bytes:
    if value < 0:
        value += 1 << 64
    return _varint(num << 3) + _varint(value)


def f32_field(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def shape(dims) -> bytes:
    return b"".join(len_field(2, varint_field(1, d)) for d in dims)


def tensor(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    return (varint_field(1, _TF_DTYPES[arr.dtype.name])
            + len_field(2, shape(arr.shape))
            + len_field(4, arr.tobytes()))


def attr(key: str, value: bytes) -> bytes:
    return len_field(5, len_field(1, key.encode()) + len_field(2, value))


def attr_tensor(key, arr):
    return attr(key, len_field(8, tensor(arr)))


def attr_type(key, enum):
    return attr(key, varint_field(6, enum))


def attr_shape(key, dims):
    return attr(key, len_field(7, shape(dims)))


def attr_s(key, s):
    return attr(key, len_field(2, s.encode()))


def attr_i(key, v):
    return attr(key, varint_field(3, v))


def attr_f(key, v):
    return attr(key, f32_field(4, v))


def attr_ilist(key, vals):
    return attr(key, len_field(1, b"".join(varint_field(3, v) for v in vals)))


def node(name, op, inputs=(), *attrs) -> bytes:
    body = len_field(1, name.encode()) + len_field(2, op.encode())
    for ref in inputs:
        body += len_field(3, ref.encode())
    return body + b"".join(attrs)


def graphdef(*nodes) -> bytes:
    return b"".join(len_field(1, n) for n in nodes)


def const(name, arr) -> bytes:
    return node(name, "Const", (), attr_tensor("value", np.ascontiguousarray(arr)))


def cnn_graphdef(params, in_hw=(28, 28), in_ch=1) -> bytes:
    """The ``cnn`` bundle's network over its reference-layout tree (numpy
    f32: ``{"conv": [{"k" HWIO, "b"}], "dense": [{"w", "b"}] * 2}``) as a
    frozen GraphDef with input ``image`` [-1, H, W] and output ``logits``."""
    h, w = in_hw
    nodes = [node("image", "Placeholder", (), attr_type("dtype", 1),
                  attr_shape("shape", [-1, h, w])),
             const("to_nhwc", np.asarray([-1, h, w, in_ch], np.int32))]
    nodes.append(node("x0", "Reshape", ("image", "to_nhwc")))
    x = "x0"
    for i, layer in enumerate(params["conv"]):
        nodes += [const("k{}".format(i), np.asarray(layer["k"], np.float32)),
                  const("b{}".format(i), np.asarray(layer["b"], np.float32)),
                  node("conv{}".format(i), "Conv2D", (x, "k{}".format(i)),
                       attr_s("padding", "SAME"), attr_ilist("strides", [1, 1, 1, 1]),
                       attr_s("data_format", "NHWC")),
                  node("bias{}".format(i), "BiasAdd", ("conv{}".format(i), "b{}".format(i))),
                  node("relu{}".format(i), "Relu", ("bias{}".format(i),)),
                  node("pool{}".format(i), "MaxPool", ("relu{}".format(i),),
                       attr_s("padding", "VALID"), attr_ilist("ksize", [1, 2, 2, 1]),
                       attr_ilist("strides", [1, 2, 2, 1]))]
        x = "pool{}".format(i)
    d1, d2 = params["dense"]
    nodes += [const("flat_shape", np.asarray([-1, np.asarray(d1["w"]).shape[0]], np.int32)),
              node("flat", "Reshape", (x, "flat_shape")),
              const("w1", np.asarray(d1["w"], np.float32)), const("c1", np.asarray(d1["b"], np.float32)),
              node("mm1", "MatMul", ("flat", "w1")), node("h1", "BiasAdd", ("mm1", "c1")),
              node("r1", "Relu", ("h1",)),
              const("w2", np.asarray(d2["w"], np.float32)), const("c2", np.asarray(d2["b"], np.float32)),
              node("mm2", "MatMul", ("r1", "w2")), node("logits", "BiasAdd", ("mm2", "c2"))]
    return graphdef(*nodes)
