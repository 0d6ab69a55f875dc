"""TF GraphDef -> torch importer (no TF dependency).

Counterpart of ``clearml_serving_tpu/engines/importers/graphdef_import.py``,
with the reference's scope: FROZEN inference graphs (constants folded into
the graph), the ``model.graphdef`` flavor, and TF1-style SavedModel
``saved_model.pb`` files whose MetaGraphDef embeds a frozen GraphDef. TF2
SavedModels with external variable shards are out of scope; convert those
offline with tf2onnx (examples/tensorflow/readme.md) and serve the .onnx.

GraphDef is plain protobuf, parsed with the ONNX importer's schema-driven
decoder (``onnx_proto._parse_message``); the ancestors of the outputs are
evaluated in order as torch ops on the bundle's device. TF's layouts are
kept at the graph's edges (NHWC tensors, HWIO kernels): a convolution or a
pool permutes to NCHW around its torch call. Constants of 64 elements or
more are parameters on the device, loaded once; smaller ones stay static on
the host (shapes, axes, permutations), and the first call copies any of
them an op needs on the device once, so a CUDA-graph capture after it
copies nothing. An op outside the set raises at the first call with the
reference's tf2onnx recipe; the wrong number of inputs raises its arity
message.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .onnx_import import torch_dtype_of
from .onnx_proto import _parse_message

# -- TF protobuf schemas ------------------------------------------------------

_TENSOR_SHAPE_DIM = {1: ("size", "svarint", False), 2: ("name", "string", False)}
_TENSOR_SHAPE = {
    2: ("dim", ("message", _TENSOR_SHAPE_DIM), True),
    3: ("unknown_rank", "varint", False),
}
_TENSOR = {
    1: ("dtype", "varint", False),
    2: ("tensor_shape", ("message", _TENSOR_SHAPE), False),
    4: ("tensor_content", "bytes", False),
    5: ("float_val", "float", True),
    6: ("double_val", "double", True),
    7: ("int_val", "svarint", True),
    8: ("string_val", "bytes", True),
    10: ("int64_val", "svarint", True),
    11: ("bool_val", "varint", True),
}
_ATTR_LIST = {
    2: ("s", "bytes", True),
    3: ("i", "svarint", True),
    4: ("f", "float", True),
    5: ("b", "varint", True),
    6: ("type", "varint", True),
    7: ("shape", ("message", _TENSOR_SHAPE), True),
    8: ("tensor", ("message", _TENSOR), True),
}
_ATTR_VALUE = {
    1: ("list", ("message", _ATTR_LIST), False),
    2: ("s", "bytes", False),
    3: ("i", "svarint", False),
    4: ("f", "float32", False),
    5: ("b", "varint", False),
    6: ("type", "varint", False),
    7: ("shape", ("message", _TENSOR_SHAPE), False),
    8: ("tensor", ("message", _TENSOR), False),
}
_ATTR_ENTRY = {
    1: ("key", "string", False),
    2: ("value", ("message", _ATTR_VALUE), False),
}
_NODE_DEF = {
    1: ("name", "string", False),
    2: ("op", "string", False),
    3: ("input", "string", True),
    5: ("attr", ("message", _ATTR_ENTRY), True),
}
_GRAPH_DEF = {1: ("node", ("message", _NODE_DEF), True)}
# TF1 SavedModel wrapper: SavedModel.meta_graphs[0].graph_def
_META_GRAPH = {2: ("graph_def", ("message", _GRAPH_DEF), False)}
_SAVED_MODEL = {2: ("meta_graphs", ("message", _META_GRAPH), True)}

# tensorflow DataType enum -> numpy (bfloat16 widens to float32, as the
# reference's Const parse does)
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, 14: "bfloat16", 17: np.uint16,
    19: np.float16, 22: np.uint32, 23: np.uint64,
}


def _torch_dtype(enum: int) -> torch.dtype:
    dt = _DTYPES.get(int(enum))
    if dt is None:
        raise ValueError("unsupported TF dtype enum {}".format(enum))
    if dt == "bfloat16":
        return torch.bfloat16
    return torch_dtype_of(dt)


def _tensor_to_np(t: Dict[str, Any]) -> np.ndarray:
    enum = int(t.get("dtype", 1))
    dims = [int(d.get("size", -1)) for d in (t.get("tensor_shape") or {}).get("dim", [])]
    content = t.get("tensor_content")
    if enum == 14:  # DT_BFLOAT16: reinterpret the bit patterns, not cast
        if content:
            bits = np.frombuffer(content, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
            return arr.reshape(dims) if dims else arr.reshape(())
        return np.zeros(dims or (), np.float32)
    dtype = _DTYPES.get(enum)
    if dtype is None:
        raise ValueError("unsupported TF dtype enum {}".format(enum))
    if content:
        arr = np.frombuffer(content, dtype=np.dtype(dtype))
        return arr.reshape(dims) if dims else arr.reshape(())
    for key, cast in (
        ("float_val", np.float32), ("double_val", np.float64),
        ("int_val", np.int32), ("int64_val", np.int64), ("bool_val", np.bool_),
    ):
        vals = t.get(key)
        if vals:
            arr = np.asarray(vals, cast).astype(dtype)
            if not dims:
                return arr.reshape(()) if arr.size == 1 else arr
            if arr.size == 1 and int(np.prod(dims)) != 1:
                arr = np.full(dims, arr.reshape(())[()])  # splat encoding
            return arr.reshape(dims)
    # empty tensor
    return np.zeros(dims or (), np.dtype(dtype))


def _attrs(node: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    return {e["key"]: e.get("value", {}) for e in node.get("attr", []) if "key" in e}


def parse_graphdef(data: bytes) -> List[Dict[str, Any]]:
    """GraphDef bytes (or a TF1 SavedModel wrapper) -> node list."""
    nodes: List[Dict[str, Any]] = []
    try:
        graph = _parse_message(data, _GRAPH_DEF)
        nodes = graph.get("node") or []
    except Exception:  # a format probe: fall through to the SavedModel parse
        pass
    # real SavedModel files lead with saved_model_schema_version (field 1,
    # varint), which the GraphDef probe skips -> zero nodes -> fall through
    if not nodes:
        try:
            saved = _parse_message(data, _SAVED_MODEL)
        except Exception:
            saved = {}
        metas = saved.get("meta_graphs") or []
        if metas and metas[0].get("graph_def"):
            nodes = metas[0]["graph_def"].get("node") or []
    if not nodes:
        raise ValueError("no nodes parsed: not a frozen GraphDef/SavedModel")
    return nodes


# -- interpreter --------------------------------------------------------------

def _nhwc_to_nchw(x):
    return x.permute(0, 3, 1, 2)


def _nchw_to_nhwc(x):
    return x.permute(0, 2, 3, 1)


def _same_pads(size: int, k: int, stride: int, dilation: int = 1):
    """TF's SAME padding of one spatial dim: (lo, hi), the odd one high."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max(0, (out - 1) * stride + eff - size)
    return total // 2, total - total // 2


def _pad_hw(x, pads, value: float):
    """Pad an NCHW tensor's H and W by [(lo, hi), (lo, hi)]."""
    (hl, hh), (wl, wh) = pads
    if not (hl or hh or wl or wh):
        return x
    return F.pad(x, [wl, wh, hl, hh], value=value)


class _GraphInterpreter:
    """Topological evaluator over a frozen node list (NHWC convention)."""

    # training/serialization machinery that must never auto-detect as a
    # model output (frozen graphs often keep dead Saver/init leftovers)
    _NON_OUTPUT_OPS = {
        "Const", "NoOp", "Placeholder", "Assert", "SaveV2", "RestoreV2",
        "Assign", "AssignVariableOp", "VariableV2", "VarHandleOp",
        "MergeV2Checkpoints", "ShardedFilename",
    }

    def __init__(self, nodes: List[Dict[str, Any]], outputs: Optional[List[str]] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.nodes = {n["name"]: n for n in nodes if n.get("name")}
        order_all = [n["name"] for n in nodes if n.get("name")]
        placeholders: List[str] = []
        self.input_shapes: Dict[str, List[int]] = {}
        consumed = set()
        for n in nodes:
            if n.get("op") in ("Placeholder", "PlaceholderWithDefault"):
                placeholders.append(n["name"])
                shape = _attrs(n).get("shape", {}).get("shape") or {}
                self.input_shapes[n["name"]] = [
                    int(d.get("size", -1)) for d in shape.get("dim", [])
                ]
            for ref in n.get("input", []):
                consumed.add(self._base(ref))
        if outputs:
            self.output_names = outputs
        else:
            self.output_names = [
                n["name"] for n in nodes
                if n["name"] not in consumed
                and n.get("op") not in self._NON_OUTPUT_OPS
            ] or [order_all[-1]]
        # evaluate ONLY the ancestors of the outputs: frozen graphs keep dead
        # Saver/init/label-map leftovers whose unsupported ops or dtypes
        # must not break import of the inference subgraph
        needed = set()
        stack = [self._base(o) for o in self.output_names]
        while stack:
            name = stack.pop()
            if name in needed:
                continue
            needed.add(name)
            node = self.nodes.get(name)
            if node is None:
                raise ValueError("output {!r} not in graph".format(name))
            stack.extend(self._base(r) for r in node.get("input", []))
        self.order = [n for n in order_all if n in needed]
        self.input_names = [p for p in placeholders if p in needed]
        self.consts: Dict[str, np.ndarray] = {}
        for name in self.order:
            n = self.nodes[name]
            if n.get("op") == "Const":
                self.consts[name] = _tensor_to_np(
                    _attrs(n)["value"].get("tensor", {})
                )
        # large consts become device params (weights); small ones stay host
        # (shape/axis operands that must be static)
        self.param_names = [k for k, v in self.consts.items() if v.size >= 64]
        # a small const's device copy, made at its first use as an operand
        self.device_consts: Dict[str, torch.Tensor] = {}
        # node name -> the values whose last reader it is (run() drops them)
        last: Dict[str, str] = {}
        for name in self.order:
            for ref in self.nodes[name].get("input", []):
                if not ref.startswith("^"):
                    last[self._base(ref)] = name
        keep = {self._base(o) for o in self.output_names}
        self.dead_after: Dict[str, List[str]] = {}
        for value, reader in last.items():
            if value not in keep:
                self.dead_after.setdefault(reader, []).append(value)

    @staticmethod
    def _base(ref: str) -> str:
        ref = ref.lstrip("^")
        return ref.split(":", 1)[0]

    def init_params(self) -> Dict[str, np.ndarray]:
        return {k: self.consts[k] for k in self.param_names}

    def run(self, params: Dict[str, Any], *inputs):
        if len(inputs) != len(self.input_names):
            raise ValueError(
                "graph expects {} inputs {} but got {}".format(
                    len(self.input_names), self.input_names, len(inputs)
                )
            )
        env: Dict[str, Any] = {}
        for name, value in zip(self.input_names, inputs):
            env[name] = value.float() if value.dtype == torch.float64 else value
        for name in self.order:
            if name in env:
                continue
            node = self.nodes[name]
            op = node.get("op")
            if op in ("NoOp", "Assert", "Placeholder"):
                continue
            if op == "Const":
                env[name] = (
                    params[name] if name in self.param_names else self.consts[name]
                )
                continue
            args = []
            for ref in node.get("input", []):
                if ref.startswith("^"):
                    continue  # control dependency
                base, _, idx = ref.partition(":")
                v = env.get(base)
                if v is None:
                    raise ValueError(
                        "node {!r} consumed before producer {!r}".format(name, base)
                    )
                if idx and int(idx) > 0:
                    v = v[int(idx)]  # multi-output producer (tuple)
                elif isinstance(v, tuple):
                    v = v[0]
                args.append(v)
            env[name] = self._eval(op, node, args)
            for value in self.dead_after.get(name, ()):
                env.pop(value, None)
        outs = []
        for ref in self.output_names:
            v = env[self._base(ref)]
            outs.append(v[0] if isinstance(v, tuple) else v)
        return outs

    @staticmethod
    def _static(x) -> np.ndarray:
        """Operand that must be host-static (shapes, axes, permutations)."""
        if isinstance(x, torch.Tensor):
            raise ValueError("GraphDef import: a shape or axis operand must be a constant")
        return np.asarray(x)

    def _t(self, node_name: str, slot: int, x) -> torch.Tensor:
        """An operand as a device tensor (a static one copied once)."""
        if isinstance(x, torch.Tensor):
            return x
        key = "{}:{}".format(node_name, slot)
        t = self.device_consts.get(key)
        if t is None:
            arr = np.asarray(x)
            t = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
                device=self.device, dtype=torch_dtype_of(arr.dtype))
            self.device_consts[key] = t
        return t

    def _eval(self, op: str, node: Dict[str, Any], args: List[Any]):
        attrs = _attrs(node)
        name = node.get("name")
        args = [self._t(name, i, a) if op not in _STATIC_OPERAND_OPS or i == 0 else a
                for i, a in enumerate(args)]

        def attr_i(key, default=0):
            return int(attrs.get(key, {}).get("i", default))

        def attr_f(key, default=0.0):
            return float(attrs.get(key, {}).get("f", default))

        def attr_s(key, default=b""):
            v = attrs.get(key, {}).get("s", default)
            return v.decode() if isinstance(v, (bytes, bytearray)) else v

        def attr_ilist(key):
            return [int(v) for v in (attrs.get(key, {}).get("list") or {}).get("i", [])]

        if op in ("Identity", "StopGradient", "PreventGradient", "Snapshot",
                  "CheckNumerics", "PlaceholderWithDefault"):
            return args[0]
        if op == "MatMul":
            a, b = args
            if attr_i("transpose_a"):
                a = a.transpose(-1, -2)
            if attr_i("transpose_b"):
                b = b.transpose(-1, -2)
            return torch.matmul(a, b)
        if op in ("BatchMatMul", "BatchMatMulV2"):
            a, b = args
            if attr_i("adj_x"):
                a = a.transpose(-1, -2)
            if attr_i("adj_y"):
                b = b.transpose(-1, -2)
            return torch.matmul(a, b)
        if op == "BiasAdd":
            x, bias = args
            if attr_s("data_format", b"NHWC") == "NCHW" and x.ndim == 4:
                return x + bias.reshape(1, -1, 1, 1)
            return x + bias
        if op in ("Add", "AddV2"):
            return args[0] + args[1]
        if op == "AddN":
            out = args[0]
            for a in args[1:]:
                out = out + a
            return out
        if op == "Sub":
            return args[0] - args[1]
        if op == "Mul":
            return args[0] * args[1]
        if op in ("RealDiv", "Div"):
            return args[0] / args[1]
        if op == "Maximum":
            return torch.maximum(args[0], args[1])
        if op == "Minimum":
            return torch.minimum(args[0], args[1])
        if op == "Rsqrt":
            return torch.rsqrt(args[0])
        if op == "Sqrt":
            return torch.sqrt(args[0])
        if op == "Exp":
            return torch.exp(args[0])
        if op == "Log":
            return torch.log(args[0])
        if op == "Neg":
            return -args[0]
        if op == "Abs":
            return torch.abs(args[0])
        if op == "Square":
            return torch.square(args[0])
        if op == "Relu":
            return torch.relu(args[0])
        if op == "Relu6":
            return torch.clamp(args[0], 0, 6)
        if op == "LeakyRelu":
            return F.leaky_relu(args[0], attr_f("alpha", 0.2))
        if op == "Elu":
            return F.elu(args[0])
        if op == "Sigmoid":
            return torch.sigmoid(args[0])
        if op == "Tanh":
            return torch.tanh(args[0])
        if op == "Softplus":
            return torch.logaddexp(args[0], torch.zeros_like(args[0]))
        if op == "Softmax":
            return torch.softmax(args[0], dim=-1)
        if op == "LogSoftmax":
            return torch.log_softmax(args[0], dim=-1)
        if op == "Conv2D":
            x, w = args  # w HWIO (TF layout)
            strides = attr_ilist("strides") or [1, 1, 1, 1]
            dilations = attr_ilist("dilations") or [1, 1, 1, 1]
            fmt = attr_s("data_format", b"NHWC")
            sp = slice(1, 3) if fmt == "NHWC" else slice(2, 4)
            x = _nhwc_to_nchw(x) if fmt == "NHWC" else x
            kh, kw = w.shape[0], w.shape[1]
            st, dl = strides[sp], dilations[sp]
            if attr_s("padding", b"VALID") == "SAME":
                pads = [_same_pads(x.shape[2], kh, st[0], dl[0]),
                        _same_pads(x.shape[3], kw, st[1], dl[1])]
                x = _pad_hw(x, pads, 0.0)
            out = F.conv2d(x, w.permute(3, 2, 0, 1), stride=st, dilation=dl)
            return _nchw_to_nhwc(out) if fmt == "NHWC" else out
        if op == "DepthwiseConv2dNative":
            x, w = args  # w [H, W, C, M] -> grouped conv with C groups
            strides = attr_ilist("strides") or [1, 1, 1, 1]
            fmt = attr_s("data_format", b"NHWC")
            if fmt == "NHWC":
                x = _nhwc_to_nchw(x)
                st = strides[1:3]
            else:
                st = strides[2:4]
            c = x.shape[1]
            kh, kw = w.shape[0], w.shape[1]
            # HWIO with I = 1, O = C*M -> OIHW
            k = w.reshape(kh, kw, 1, -1).permute(3, 2, 0, 1)
            if attr_s("padding", b"VALID") == "SAME":
                x = _pad_hw(x, [_same_pads(x.shape[2], kh, st[0]),
                                _same_pads(x.shape[3], kw, st[1])], 0.0)
            out = F.conv2d(x, k, stride=st, groups=c)
            return _nchw_to_nhwc(out) if fmt == "NHWC" else out
        if op in ("MaxPool", "AvgPool"):
            x = args[0]
            ksize = attr_ilist("ksize") or [1, 1, 1, 1]
            strides = attr_ilist("strides") or [1, 1, 1, 1]
            padding = attr_s("padding", b"VALID")
            if ksize[0] != 1 or ksize[3] != 1 or strides[0] != 1 or strides[3] != 1:
                raise ValueError("GraphDef import: {} over the batch or channel axis "
                                 "(node {!r})".format(op, name))
            x = _nhwc_to_nchw(x)
            k, st = ksize[1:3], strides[1:3]
            pads = ([_same_pads(x.shape[2], k[0], st[0]), _same_pads(x.shape[3], k[1], st[1])]
                    if padding == "SAME" else [(0, 0), (0, 0)])
            if op == "MaxPool":
                out = F.max_pool2d(_pad_hw(x, pads, float("-inf")), k, st)
            else:
                c = x.shape[1]
                ones = torch.ones((c, 1, k[0], k[1]), dtype=x.dtype, device=x.device)
                summed = F.conv2d(_pad_hw(x, pads, 0.0), ones, stride=st, groups=c)
                counts = F.conv2d(_pad_hw(torch.ones_like(x), pads, 0.0), ones, stride=st,
                                  groups=c)
                out = summed / counts
            return _nchw_to_nhwc(out)
        if op in ("FusedBatchNorm", "FusedBatchNormV2", "FusedBatchNormV3"):
            x, scale, offset, mean, var = args[:5]
            eps = attr_f("epsilon", 1e-4)
            inv = torch.rsqrt(var + eps) * scale
            bias = offset - mean * inv
            if attr_s("data_format", b"NHWC") == "NCHW" and x.ndim == 4:
                inv = inv.reshape(1, -1, 1, 1)
                bias = bias.reshape(1, -1, 1, 1)
            return (x * inv + bias,)  # tuple: output :0 is y
        if op == "Reshape":
            shape = [int(v) for v in self._static(args[1]).reshape(-1)]
            return torch.reshape(args[0], shape)
        if op == "Squeeze":
            dims = attr_ilist("squeeze_dims") or attr_ilist("axis")
            return args[0].squeeze(tuple(dims)) if dims else args[0].squeeze()
        if op == "ExpandDims":
            return args[0].unsqueeze(int(self._static(args[1])))
        if op == "Transpose":
            perm = [int(v) for v in self._static(args[1]).reshape(-1)]
            return args[0].permute(perm)
        if op == "ConcatV2":
            axis = int(self._static(args[-1]))
            return torch.cat([self._t(name, i, a) for i, a in enumerate(args[:-1])], dim=axis)
        if op == "Pack":
            return torch.stack([self._t(name, i, a) for i, a in enumerate(args)],
                               dim=attr_i("axis"))
        if op in ("Mean", "Sum", "Max", "Min"):
            axes = tuple(int(v) for v in self._static(args[1]).reshape(-1))
            keep = bool(attr_i("keep_dims"))
            x = args[0]
            if op == "Mean":
                return x.mean(dim=axes, keepdim=keep)
            if op == "Sum":
                return x.sum(dim=axes, keepdim=keep)
            return (x.amax if op == "Max" else x.amin)(dim=axes, keepdim=keep)
        if op in ("Pad", "PadV2"):
            pads = self._static(args[1]).astype(int).tolist()
            value = float(self._static(args[2])) if len(args) > 2 else 0.0
            flat = [v for lo, hi in reversed(pads) for v in (lo, hi)]
            return F.pad(args[0], flat, value=value)
        if op == "ArgMax":
            axis = int(self._static(args[1])) if len(args) > 1 else -1
            return torch.argmax(args[0], dim=axis).to(_torch_dtype(attr_i("output_type", 9)))
        if op == "Cast":
            return args[0].to(_torch_dtype(attr_i("DstT", 1)))
        if op == "Shape":
            return np.asarray(tuple(args[0].shape), np.int32)  # static on the host
        raise ValueError(
            "GraphDef op {!r} (node {!r}) is not supported by the native "
            "importer; convert the model offline with tf2onnx and serve the "
            ".onnx (examples/tensorflow/readme.md)".format(op, node.get("name"))
        )


# ops whose operands after the first are host-static (shapes, axes,
# permutations, paddings) or converted by the op itself
_STATIC_OPERAND_OPS = {"Reshape", "ExpandDims", "Transpose", "ConcatV2", "Pack", "Mean", "Sum",
                       "Max", "Min", "Pad", "PadV2", "ArgMax"}


def find_graphdef_file(path) -> Optional[Path]:
    path = Path(path)
    if path.is_file() and path.suffix in (".graphdef", ".pb"):
        return path
    if path.is_dir():
        cands = sorted(path.glob("*.graphdef")) + sorted(path.glob("*.pb"))
        if cands:
            return cands[0]
    return None


def load_graphdef_bundle(path, outputs: Optional[List[str]] = None, device="cuda"):
    """Frozen GraphDef/TF1-SavedModel file -> (bundle, params on
    ``device``), the same surface as load_onnx_bundle."""
    gd_file = find_graphdef_file(path)
    if gd_file is None:
        raise ValueError("no .graphdef/.pb file found at {}".format(path))
    interp = _GraphInterpreter(parse_graphdef(gd_file.read_bytes()), outputs, device)
    params = {k: torch.from_numpy(np.require(v, requirements=["C", "W"])).to(
        device=interp.device, dtype=torch_dtype_of(v.dtype))
        for k, v in interp.init_params().items()}
    for name in interp.param_names:
        # run() reads weights from params; keeping the host numpy copies
        # alive would double per-model host memory for nothing
        del interp.consts[name]

    def apply(params, *inputs):
        outs = interp.run(params, *inputs)
        return outs[0] if len(outs) == 1 else tuple(outs)

    bundle = SimpleNamespace(
        apply=apply,
        config={
            "arch": "graphdef",
            "source": str(gd_file),
            "inputs": interp.input_names,
            "outputs": interp.output_names,
            "input_shapes": interp.input_shapes,
        },
        input_names=interp.input_names,
        output_names=interp.output_names,
    )
    return bundle, params
