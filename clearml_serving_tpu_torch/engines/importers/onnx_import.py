"""ONNX -> torch importer: stock ``.onnx`` graphs become servable bundles.

Counterpart of ``clearml_serving_tpu/engines/importers/onnx_import.py``,
which interprets the graph into a JAX function for jit. This one interprets
it into torch ops on the bundle's device, so the ``jax`` engine runs it
eagerly on the CPU and as one CUDA graph per bucket key on the card.

Static/tensor hybrid evaluation, as in the reference: exporters emit
shape-metaprogram chains (Shape -> Gather -> Unsqueeze -> Concat ->
Reshape). ``Shape`` of a tensor is a numpy array, and any node whose inputs
are all static (numpy) is computed with numpy on the host, so shape chains
fold on the host and ``Reshape`` sees a static shape (``_is_static``,
``_static_ints``). Initializers of the float family with more than 64
elements are parameters: they go to the device once, at load; the rest stay
static.

Where an op mixes a static value with a device tensor, the static value is
copied to the device once and kept per node and input (``_Eval.tensor``):
the key's eager warm-up run, which precedes its capture, makes every such
constant, so the capture issues no host-to-device copy (a copy inside a
capture fails the capture; nothing patches that over). Values follow JAX's
32-bit mode: float64 inputs and constants become float32, as jit would.
Gather indices are clamped into range (JAX's gathers never fault; a CUDA
index fault would end the process's context).

The op set is the reference's (74 ops); any other op raises by name at
load with the reference's words, and a call with the wrong number of
inputs raises its arity message.
"""

from __future__ import annotations

import math
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import onnx_proto

_ATTR_KIND = {1: "f", 2: "i", 3: "s", 4: "t", 6: "floats", 7: "ints", 8: "strings"}


def _attrs(node: dict) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for a in node.get("attribute", []):
        t = int(a.get("type", 0))
        key = _ATTR_KIND.get(t)
        if key is None:  # graph/tensors attrs unsupported here
            if "t" in a:
                key = "t"
            else:
                continue
        val = a.get(key)
        if key == "s" and isinstance(val, bytes):
            val = val.decode("utf-8", "replace")
        elif key == "strings":
            val = [v.decode("utf-8", "replace") if isinstance(v, bytes) else v for v in val]
        elif key == "t":
            val = onnx_proto.tensor_to_numpy(val)
        out[a["name"]] = val
    return out


def _is_static(v) -> bool:
    return isinstance(v, np.ndarray) or np.isscalar(v)


def _all_static(vals: Sequence[Any]) -> bool:
    return all(_is_static(v) for v in vals if v is not None)


def _static_ints(v, what: str) -> List[int]:
    if not _is_static(v):
        raise ValueError(
            "ONNX import: {} must be statically resolvable (got traced value)".format(what)
        )
    return [int(x) for x in np.asarray(v).reshape(-1)]


_CAST_DTYPES = dict(onnx_proto._DTYPES)
_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64, np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint16): torch.uint16, np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
}


def torch_dtype_of(np_dtype) -> torch.dtype:
    """A numpy dtype's torch dtype in JAX's 32-bit mode (float64 -> float32)."""
    dt = np.dtype(np_dtype)
    if dt == np.float64:
        return torch.float32
    return _TORCH[dt]


def canonical(t: torch.Tensor) -> torch.Tensor:
    """A device input in JAX's 32-bit mode: float64 becomes float32."""
    return t.float() if t.dtype == torch.float64 else t


class _Eval:
    """One node's evaluation: its interpreter's device and constants."""

    __slots__ = ("interp", "index")

    def __init__(self, interp, index: int):
        self.interp = interp
        self.index = index

    @property
    def device(self) -> torch.device:
        return self.interp.device

    def tensor(self, v, slot: int = 0) -> Optional[torch.Tensor]:
        """``v`` as a device tensor; a static value's copy is made once per
        (node, input, value) and kept."""
        if v is None or isinstance(v, torch.Tensor):
            return v
        arr = np.asarray(v)
        key = (self.index, slot)
        cache = self.interp.consts.setdefault(key, [])
        for host, dev in cache:
            if host.shape == arr.shape and host.dtype == arr.dtype and np.array_equal(host, arr):
                return dev
        dev = torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
            device=self.device, dtype=torch_dtype_of(arr.dtype))
        cache.append((arr.copy(), dev))
        return dev

    def tensors(self, vals: Sequence[Any]) -> List[Optional[torch.Tensor]]:
        return [self.tensor(v, i) for i, v in enumerate(vals)]


class _Interpreter:
    """Walks a parsed GraphProto once per call."""

    def __init__(self, graph: dict, device):
        self.graph = graph
        self.device = torch.device(device)
        self.nodes = graph.get("node", [])
        self.initializers: Dict[str, np.ndarray] = {
            t["name"]: onnx_proto.tensor_to_numpy(t)
            for t in graph.get("initializer", [])
        }
        init_names = set(self.initializers)
        self.input_names = [
            vi["name"] for vi in graph.get("input", []) if vi["name"] not in init_names
        ]
        self.output_names = [vi["name"] for vi in graph.get("output", [])]
        self.input_shapes = {
            vi["name"]: onnx_proto.value_info_shape(vi)
            for vi in graph.get("input", [])
            if vi["name"] not in init_names
        }
        # float-family initializers are parameters on the device;
        # integer/small tensors stay static so meta ops (Reshape shapes,
        # Slice bounds, Gather indices) fold on the host
        self.param_names = [
            n
            for n, arr in self.initializers.items()
            if arr.dtype.kind == "f" and arr.size > 64
        ]
        # (node index, input slot) -> [(host value, device copy)]
        self.consts: Dict[Tuple[int, int], list] = {}
        # node index -> the values whose last reader it is: run() drops
        # them there, so a call holds only its live values (a CUDA graph's
        # pool then holds no more than a forward needs at once)
        last: Dict[str, int] = {}
        for i, node in enumerate(self.nodes):
            for n in node.get("input", []):
                if n:
                    last[n] = i
        keep = set(self.output_names)
        self.dead_after: Dict[int, List[str]] = {}
        for n, i in last.items():
            if n not in keep:
                self.dead_after.setdefault(i, []).append(n)
        self._check_ops()

    def _check_ops(self) -> None:
        missing = sorted(
            {
                n.get("op_type", "?")
                for n in self.nodes
                if n.get("op_type") not in _OPS
            }
        )
        if missing:
            raise ValueError(
                "ONNX import: unsupported op(s): {} (supported: {})".format(
                    ", ".join(missing), ", ".join(sorted(_OPS))
                )
            )

    def init_params(self) -> Dict[str, np.ndarray]:
        return {n: self.initializers[n] for n in self.param_names}

    def run(self, params: Dict[str, Any], *inputs) -> Tuple:
        if len(inputs) != len(self.input_names):
            raise ValueError(
                "expected {} inputs {}, got {}".format(
                    len(self.input_names), self.input_names, len(inputs)
                )
            )
        env: Dict[str, Any] = dict(self.initializers)
        env.update(params)  # device leaves shadow static copies
        env.update(zip(self.input_names, [
            canonical(x) if isinstance(x, torch.Tensor) else x for x in inputs]))
        for i, node in enumerate(self.nodes):
            op = _OPS[node["op_type"]]
            ins = [env[n] if n else None for n in node.get("input", [])]
            outs = op(_Eval(self, i), node, ins, _attrs(node))
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for name, val in zip(node.get("output", []), outs):
                if name:
                    env[name] = val
            for name in self.dead_after.get(i, ()):
                env.pop(name, None)
        return tuple(env[n] for n in self.output_names)


# -- op implementations -------------------------------------------------------
# Each op: fn(ev, node, inputs, attrs) -> output(s); numpy when every input
# is static, torch otherwise.

_OPS: Dict[str, Callable] = {}


def _op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn

    return deco


def _binary(fn_np, fn_t):
    def impl(ev, node, ins, attrs):
        if _all_static(ins[:2]):
            return fn_np(ins[0], ins[1])
        a, b = ev.tensors(ins[:2])
        return fn_t(a, b)

    return impl


_OPS["Add"] = _binary(np.add, torch.add)
_OPS["Sub"] = _binary(np.subtract, torch.subtract)
_OPS["Mul"] = _binary(np.multiply, torch.multiply)
_OPS["Div"] = _binary(np.divide, torch.true_divide)
_OPS["Pow"] = _binary(np.power, torch.pow)
_OPS["Equal"] = _binary(np.equal, torch.eq)
_OPS["Greater"] = _binary(np.greater, torch.gt)
_OPS["GreaterOrEqual"] = _binary(np.greater_equal, torch.ge)
_OPS["Less"] = _binary(np.less, torch.lt)
_OPS["LessOrEqual"] = _binary(np.less_equal, torch.le)
_OPS["And"] = _binary(np.logical_and, torch.logical_and)
_OPS["Or"] = _binary(np.logical_or, torch.logical_or)


def _unary(fn_np, fn_t):
    def impl(ev, node, ins, attrs):
        return fn_np(ins[0]) if _is_static(ins[0]) else fn_t(ins[0])

    return impl


_OPS["Relu"] = _unary(lambda x: np.maximum(x, 0), lambda x: torch.clamp_min(x, 0))
_OPS["Neg"] = _unary(np.negative, torch.negative)
_OPS["Abs"] = _unary(np.abs, torch.abs)
_OPS["Exp"] = _unary(np.exp, torch.exp)
_OPS["Log"] = _unary(np.log, torch.log)
_OPS["Sqrt"] = _unary(np.sqrt, torch.sqrt)
_OPS["Tanh"] = _unary(np.tanh, torch.tanh)
_OPS["Floor"] = _unary(np.floor, torch.floor)
_OPS["Ceil"] = _unary(np.ceil, torch.ceil)
_OPS["Reciprocal"] = _unary(lambda x: np.divide(1.0, x), lambda x: torch.true_divide(1.0, x))
_OPS["Not"] = _unary(np.logical_not, torch.logical_not)
_OPS["Identity"] = _unary(lambda x: x, lambda x: x)


@_op("Sigmoid")
def _sigmoid(ev, node, ins, attrs):
    if _is_static(ins[0]):
        return 1.0 / (1.0 + np.exp(-np.asarray(ins[0], np.float32)))
    return torch.sigmoid(ins[0])


@_op("Erf")
def _erf(ev, node, ins, attrs):
    if _is_static(ins[0]):
        return np.vectorize(math.erf)(np.asarray(ins[0], np.float64)).astype(
            np.asarray(ins[0]).dtype
        )
    return torch.erf(ins[0])


@_op("Gelu")
def _gelu(ev, node, ins, attrs):
    approx = attrs.get("approximate", "none") == "tanh"
    return F.gelu(ev.tensor(ins[0]), approximate="tanh" if approx else "none")


@_op("LeakyRelu")
def _leaky_relu(ev, node, ins, attrs):
    x = ins[0]
    alpha = float(attrs.get("alpha", 0.01))
    if _is_static(x):
        return np.where(x >= 0, x, alpha * x)
    return torch.where(x >= 0, x, alpha * x)


@_op("Elu")
def _elu(ev, node, ins, attrs):
    x = ins[0]
    alpha = float(attrs.get("alpha", 1.0))
    if _is_static(x):
        return np.where(x >= 0, x, alpha * (np.exp(x) - 1.0))
    return torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


@_op("Clip")
def _clip(ev, node, ins, attrs):
    lo = ins[1] if len(ins) > 1 and ins[1] is not None else attrs.get("min")
    hi = ins[2] if len(ins) > 2 and ins[2] is not None else attrs.get("max")
    out = ins[0]
    if _is_static(out):
        if lo is not None:
            out = np.maximum(out, lo)
        if hi is not None:
            out = np.minimum(out, hi)
        return out
    if lo is not None:
        out = torch.maximum(out, ev.tensor(lo, 1))
    if hi is not None:
        out = torch.minimum(out, ev.tensor(hi, 2))
    return out


@_op("Softmax")
def _softmax(ev, node, ins, attrs):
    return torch.softmax(ev.tensor(ins[0]), dim=int(attrs.get("axis", -1)))


@_op("LogSoftmax")
def _log_softmax(ev, node, ins, attrs):
    return torch.log_softmax(ev.tensor(ins[0]), dim=int(attrs.get("axis", -1)))


@_op("Softplus")
def _softplus(ev, node, ins, attrs):
    x = ev.tensor(ins[0])
    return torch.logaddexp(x, torch.zeros_like(x))


@_op("HardSigmoid")
def _hard_sigmoid(ev, node, ins, attrs):
    alpha = float(attrs.get("alpha", 0.2))
    beta = float(attrs.get("beta", 0.5))
    if _is_static(ins[0]):
        return np.clip(alpha * ins[0] + beta, 0.0, 1.0)
    return torch.clamp(alpha * ins[0] + beta, 0.0, 1.0)


@_op("Where")
def _where(ev, node, ins, attrs):
    if _all_static(ins):
        return np.where(ins[0], ins[1], ins[2])
    cond, a, b = ev.tensors(ins[:3])
    return torch.where(cond.bool(), a, b)


def _nary(fn_np, fn_t):
    def impl(ev, node, ins, attrs):
        if _all_static(ins):
            out = ins[0]
            for v in ins[1:]:
                out = fn_np(out, v)
            return out
        ts = ev.tensors(ins)
        out = ts[0]
        for v in ts[1:]:
            out = fn_t(out, v)
        return out

    return impl


_OPS["Min"] = _nary(np.minimum, torch.minimum)
_OPS["Max"] = _nary(np.maximum, torch.maximum)
_OPS["Sum"] = _nary(np.add, torch.add)


@_op("MatMul")
def _matmul(ev, node, ins, attrs):
    if _all_static(ins[:2]):
        return np.matmul(ins[0], ins[1])
    a, b = ev.tensors(ins[:2])
    return torch.matmul(a, b)


@_op("Gemm")
def _gemm(ev, node, ins, attrs):
    if _all_static(ins):
        a, b = ins[0], ins[1]
        swap, mm = np.swapaxes, np.matmul
    else:
        ts = ev.tensors(ins)
        a, b = ts[0], ts[1]
        ins = ts
        swap, mm = torch.swapaxes, torch.matmul
    if int(attrs.get("transA", 0)):
        a = swap(a, -1, -2)
    if int(attrs.get("transB", 0)):
        b = swap(b, -1, -2)
    out = mm(a, b) * float(attrs.get("alpha", 1.0))
    if len(ins) > 2 and ins[2] is not None:
        out = out + float(attrs.get("beta", 1.0)) * ins[2]
    return out


@_op("Einsum")
def _einsum(ev, node, ins, attrs):
    if _all_static(ins):
        return np.einsum(attrs["equation"], *ins)
    return torch.einsum(attrs["equation"], *ev.tensors(ins))


def _conv_pads(attrs, spatial: int, in_shape, k_shape, strides, dilations):
    pads = attrs.get("pads")
    auto = attrs.get("auto_pad", "NOTSET")
    if pads:
        p = [int(x) for x in pads]
        return [(p[i], p[i + spatial]) for i in range(spatial)]
    if auto in ("SAME_UPPER", "SAME_LOWER"):
        out = []
        for i in range(spatial):
            eff_k = (k_shape[i] - 1) * dilations[i] + 1
            total = max(
                0,
                (-(in_shape[i] // -strides[i]) - 1) * strides[i] + eff_k - in_shape[i],
            )
            lo = total // 2
            hi = total - lo
            out.append((hi, lo) if auto == "SAME_LOWER" else (lo, hi))
        return out
    return [(0, 0)] * spatial


def _pad_spatial(x: torch.Tensor, pads, value: float) -> torch.Tensor:
    """Pad the trailing spatial dims by ``pads`` [(lo, hi)] (F.pad's order:
    the last dim first)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [int(lo), int(hi)]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@_op("Conv")
def _conv(ev, node, ins, attrs):
    x, w = ev.tensor(ins[0], 0), ev.tensor(ins[1], 1)
    spatial = w.dim() - 2
    strides = [int(s) for s in attrs.get("strides", [1] * spatial)]
    dilations = [int(d) for d in attrs.get("dilations", [1] * spatial)]
    groups = int(attrs.get("group", 1))
    pads = _conv_pads(attrs, spatial, list(x.shape[2:]), list(w.shape[2:]), strides, dilations)
    out = _CONV[spatial](_pad_spatial(x, pads, 0.0), w, stride=strides, dilation=dilations,
                         groups=groups)
    if len(ins) > 2 and ins[2] is not None:
        out = out + ev.tensor(ins[2], 2).reshape((1, -1) + (1,) * spatial)
    return out


def _pool(ev, node, ins, attrs, is_avg=False):
    x = ev.tensor(ins[0])
    kernel = [int(k) for k in attrs["kernel_shape"]]
    spatial = len(kernel)
    strides = [int(s) for s in attrs.get("strides", [1] * spatial)]
    dilations = [int(d) for d in attrs.get("dilations", [1] * spatial)]
    pads = _conv_pads(attrs, spatial, list(x.shape[2:]), kernel, strides, dilations)
    if int(attrs.get("ceil_mode", 0)):
        # ceil output size = extend the high pad so the last (partial) window
        # exists; pad cells are -inf for max and left out of the average's
        # count, as ONNX ceil_mode means
        pads = list(pads)
        for i in range(spatial):
            eff_k = (kernel[i] - 1) * dilations[i] + 1
            span = x.shape[2 + i] + pads[i][0] + pads[i][1] - eff_k
            out_ceil = -(-span // strides[i]) + 1
            needed = (out_ceil - 1) * strides[i] + eff_k
            extra = needed - (x.shape[2 + i] + pads[i][0] + pads[i][1])
            if extra > 0:
                pads[i] = (pads[i][0], pads[i][1] + extra)
    if not is_avg:
        return _MAXPOOL[spatial](_pad_spatial(x, pads, float("-inf")), kernel, strides,
                                 dilation=dilations)
    # a window's sum as a grouped convolution with a ones kernel (dilations
    # included), then the reference's divisor
    c = x.shape[1]
    ones = torch.ones((c, 1) + tuple(kernel), dtype=x.dtype, device=x.device)
    summed = _CONV[spatial](_pad_spatial(x, pads, 0.0), ones, stride=strides,
                            dilation=dilations, groups=c)
    if int(attrs.get("count_include_pad", 0)):
        return summed / float(np.prod(kernel))
    counts = _CONV[spatial](_pad_spatial(torch.ones_like(x), pads, 0.0), ones, stride=strides,
                            dilation=dilations, groups=c)
    return summed / counts


@_op("MaxPool")
def _max_pool(ev, node, ins, attrs):
    return _pool(ev, node, ins, attrs)


@_op("AveragePool")
def _avg_pool(ev, node, ins, attrs):
    return _pool(ev, node, ins, attrs, is_avg=True)


@_op("GlobalAveragePool")
def _global_avg_pool(ev, node, ins, attrs):
    x = ins[0]
    axes = tuple(range(2, x.ndim))
    if _is_static(x):
        return np.mean(x, axis=axes, keepdims=True)
    return x.mean(dim=axes, keepdim=True)


@_op("BatchNormalization")
def _batch_norm(ev, node, ins, attrs):
    eps = float(attrs.get("epsilon", 1e-5))
    if _all_static(ins[:5]):
        x, scale, bias, mean, var = ins[:5]
        sqrt = np.sqrt
    else:
        x, scale, bias, mean, var = ev.tensors(ins[:5])
        sqrt = torch.sqrt
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = 1.0 / sqrt(var + eps)
    return (x - mean.reshape(shape)) * (scale * inv).reshape(shape) + bias.reshape(shape)


@_op("LayerNormalization")
def _layer_norm(ev, node, ins, attrs):
    axis = int(attrs.get("axis", -1))
    eps = float(attrs.get("epsilon", 1e-5))
    if _all_static(ins):
        x = ins[0]
        axes = tuple(range(axis % x.ndim, x.ndim))
        mean = np.mean(x, axis=axes, keepdims=True)
        var = np.mean((x - mean) ** 2, axis=axes, keepdims=True)
        out = (x - mean) / np.sqrt(var + eps)
    else:
        ins = ev.tensors(ins)
        x = ins[0]
        axes = tuple(range(axis % x.ndim, x.ndim))
        mean = x.mean(dim=axes, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
        out = (x - mean) / torch.sqrt(var + eps)
    if len(ins) > 1 and ins[1] is not None:
        out = out * ins[1]
    if len(ins) > 2 and ins[2] is not None:
        out = out + ins[2]
    return out


@_op("Flatten")
def _flatten(ev, node, ins, attrs):
    x = ins[0]
    axis = int(attrs.get("axis", 1))
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape((lead, -1))


@_op("Shape")
def _shape(ev, node, ins, attrs):
    shape = np.asarray(tuple(ins[0].shape), np.int64)
    start = int(attrs.get("start", 0))
    end = attrs.get("end")
    return shape[start : int(end) if end is not None else None]


@_op("Reshape")
def _reshape(ev, node, ins, attrs):
    target = _static_ints(ins[1], "Reshape shape")
    x = ins[0]
    shape = []
    for i, d in enumerate(target):
        if d == 0 and not int(attrs.get("allowzero", 0)):
            shape.append(x.shape[i])
        else:
            shape.append(d)
    return x.reshape(tuple(shape))


@_op("Transpose")
def _transpose(ev, node, ins, attrs):
    perm = attrs.get("perm")
    x = ins[0]
    if perm is None:
        perm = list(reversed(range(x.ndim)))
    perm = [int(p) for p in perm]
    return np.transpose(x, perm) if _is_static(x) else x.permute(perm)


def _axes_attr_or_input(ins, attrs, what: str):
    axes = attrs.get("axes")
    if axes is None and len(ins) > 1 and ins[1] is not None:
        axes = _static_ints(ins[1], what)
    return axes


@_op("Squeeze")
def _squeeze(ev, node, ins, attrs):
    x = ins[0]
    axes = _axes_attr_or_input(ins, attrs, "Squeeze axes")
    if _is_static(x):
        return np.squeeze(x) if axes is None else np.squeeze(x, axis=tuple(int(a) for a in axes))
    if axes is None:
        return x.squeeze()
    return x.squeeze(tuple(int(a) for a in axes))


@_op("Unsqueeze")
def _unsqueeze(ev, node, ins, attrs):
    x = ins[0]
    axes = _axes_attr_or_input(ins, attrs, "Unsqueeze axes")
    out = x
    for a in sorted(int(a) for a in axes):
        out = np.expand_dims(out, a) if _is_static(out) else out.unsqueeze(a)
    return out


@_op("Concat")
def _concat(ev, node, ins, attrs):
    axis = int(attrs.get("axis", 0))
    if _all_static(ins):
        return np.concatenate(ins, axis=axis)
    return torch.cat(ev.tensors(ins), dim=axis)


@_op("Split")
def _split(ev, node, ins, attrs):
    x = ins[0]
    axis = int(attrs.get("axis", 0))
    sizes = attrs.get("split")
    if sizes is None and len(ins) > 1 and ins[1] is not None:
        sizes = _static_ints(ins[1], "Split sizes")
    if sizes is None:
        n = int(attrs.get("num_outputs", len(node.get("output", []))))
        per = -(-x.shape[axis] // n)
        sizes = [per] * (n - 1) + [x.shape[axis] - per * (n - 1)]
    sizes = [int(s) for s in sizes]
    if _is_static(x):
        bounds = np.cumsum(sizes)[:-1]
        return tuple(np.split(x, [int(b) for b in bounds], axis=axis))
    return tuple(torch.split(x, sizes, dim=axis))


@_op("Slice")
def _slice(ev, node, ins, attrs):
    x = ins[0]
    if len(ins) > 1 and ins[1] is not None:  # opset >= 10: inputs
        starts = _static_ints(ins[1], "Slice starts")
        ends = _static_ints(ins[2], "Slice ends")
        axes = (
            _static_ints(ins[3], "Slice axes")
            if len(ins) > 3 and ins[3] is not None
            else list(range(len(starts)))
        )
        steps = (
            _static_ints(ins[4], "Slice steps")
            if len(ins) > 4 and ins[4] is not None
            else [1] * len(starts)
        )
    else:  # legacy attribute form
        starts = [int(v) for v in attrs["starts"]]
        ends = [int(v) for v in attrs["ends"]]
        axes = [int(v) for v in attrs.get("axes", range(len(starts)))]
        steps = [1] * len(starts)
    static = _is_static(x)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % x.ndim
        limit = x.shape[ax]
        # ONNX clamps INT_MAX/INT_MIN sentinels
        st = max(-limit, min(st, limit))
        en = max(-limit - 1, min(en, limit))
        slicer: List[Any] = [slice(None)] * x.ndim
        if static or sp > 0:
            slicer[ax] = slice(st, en, sp)
        else:
            # torch slices take positive steps only: flip, then slice forward
            s, e, p = slice(st, en, sp).indices(limit)
            x = x.flip(ax)
            s, e = limit - 1 - s, limit - 1 - e
            slicer[ax] = slice(s, e, -p)
        x = x[tuple(slicer)]
    return x


@_op("Gather")
def _gather(ev, node, ins, attrs):
    axis = int(attrs.get("axis", 0))
    data, idx = ins[0], ins[1]
    if _all_static(ins[:2]):
        return np.take(data, np.asarray(idx), axis=axis)
    data = ev.tensor(data, 0)
    axis = axis % data.dim()
    n = data.shape[axis]
    if _is_static(idx) and np.asarray(idx).ndim == 0:
        i = int(np.asarray(idx))
        return data.select(axis, min(max(i + n if i < 0 else i, 0), n - 1))
    idx = ev.tensor(idx, 1).long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    out = data.index_select(axis, idx.reshape(-1))
    return out.reshape(tuple(data.shape[:axis]) + tuple(idx.shape) + tuple(data.shape[axis + 1:]))


@_op("Expand")
def _expand(ev, node, ins, attrs):
    shape = _static_ints(ins[1], "Expand shape")
    x = ins[0]
    # ONNX Expand uses bidirectional broadcast; dims of 1 in shape keep x's
    target = list(shape)
    if len(target) < x.ndim:
        target = [1] * (x.ndim - len(target)) + target
    xs = [1] * (len(target) - x.ndim) + list(x.shape)
    full = tuple(max(t, s) for t, s in zip(target, xs))
    return np.broadcast_to(x, full) if _is_static(x) else x.broadcast_to(full)


@_op("Tile")
def _tile(ev, node, ins, attrs):
    reps = tuple(_static_ints(ins[1], "Tile repeats"))
    return np.tile(ins[0], reps) if _is_static(ins[0]) else torch.tile(ins[0], reps)


def _pad_along(x: torch.Tensor, axis: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """numpy's ``edge``/``reflect`` padding of one axis, from slices."""
    n = x.shape[axis]
    parts = []
    if lo:
        if mode == "edge":
            parts.append(x.narrow(axis, 0, 1).repeat_interleave(lo, dim=axis))
        else:
            parts.append(x.narrow(axis, 1, lo).flip(axis))
    parts.append(x)
    if hi:
        if mode == "edge":
            parts.append(x.narrow(axis, n - 1, 1).repeat_interleave(hi, dim=axis))
        else:
            parts.append(x.narrow(axis, n - 1 - hi, hi).flip(axis))
    return torch.cat(parts, dim=axis) if len(parts) > 1 else x


@_op("Pad")
def _pad(ev, node, ins, attrs):
    x = ins[0]
    mode = attrs.get("mode", "constant")
    pads = (
        _static_ints(ins[1], "Pad pads")
        if len(ins) > 1 and ins[1] is not None
        else [int(v) for v in attrs["pads"]]
    )
    value = 0.0
    if len(ins) > 2 and ins[2] is not None:
        value = float(np.asarray(ins[2]).reshape(())) if _is_static(ins[2]) else ins[2]
    n = x.ndim
    pairs = [(pads[i], pads[i + n]) for i in range(n)]
    if _is_static(x) and not isinstance(value, torch.Tensor):
        if mode == "constant":
            return np.pad(x, pairs, constant_values=value)
        return np.pad(x, pairs, mode={"reflect": "reflect", "edge": "edge"}[mode])
    x = ev.tensor(x, 0)
    if mode == "constant":
        flat = [v for lo, hi in reversed(pairs) for v in (lo, hi)]
        if isinstance(value, torch.Tensor):
            # a traced fill value: the zero-padded input plus the value
            # where the padding is
            border = F.pad(torch.zeros_like(x), flat, value=1.0)
            return F.pad(x, flat) + border * value.to(x.dtype)
        return F.pad(x, flat, value=value)
    mode = {"reflect": "reflect", "edge": "edge"}[mode]
    for axis, (lo, hi) in enumerate(pairs):
        x = _pad_along(x, axis, lo, hi, mode)
    return x


@_op("Cast")
def _cast(ev, node, ins, attrs):
    to = int(attrs["to"])
    x = ins[0]
    if to == onnx_proto._BFLOAT16:
        return ev.tensor(x).to(torch.bfloat16)
    dtype = _CAST_DTYPES[to]
    if _is_static(x):
        return np.asarray(x).astype(dtype)
    return x.to(torch_dtype_of(dtype))


@_op("Constant")
def _constant(ev, node, ins, attrs):
    if "value" in attrs:
        return attrs["value"]
    for k, cast in (
        ("value_float", np.float32), ("value_int", np.int64),
        ("value_floats", np.float32), ("value_ints", np.int64),
    ):
        if k in attrs:
            return np.asarray(attrs[k], cast)
    raise ValueError("Constant node without value")


@_op("ConstantOfShape")
def _constant_of_shape(ev, node, ins, attrs):
    shape = _static_ints(ins[0], "ConstantOfShape shape")
    value = attrs.get("value")
    if value is None:
        return np.zeros(shape, np.float32)
    v = np.asarray(value).reshape(-1)[0]
    return np.full(shape, v, np.asarray(value).dtype)


@_op("Range")
def _range(ev, node, ins, attrs):
    s, l, d = (np.asarray(_static_value(v, "Range bounds")).reshape(()) for v in ins[:3])
    return np.arange(s, l, d)


def _static_value(v, what: str):
    if not _is_static(v):
        raise ValueError(
            "ONNX import: {} must be statically resolvable (got traced value)".format(what))
    return v


_REDUCE_NP = {"mean": np.mean, "sum": np.sum, "max": np.max, "min": np.min, "prod": np.prod}


def _reduce_t(fn: str, x: torch.Tensor, axes, keepdims: bool) -> torch.Tensor:
    if axes is None:
        axes = tuple(range(x.dim()))
    if fn == "mean":
        return x.mean(dim=axes, keepdim=keepdims)
    if fn == "sum":
        return x.sum(dim=axes, keepdim=keepdims)
    if fn == "max":
        return x.amax(dim=axes, keepdim=keepdims)
    if fn == "min":
        return x.amin(dim=axes, keepdim=keepdims)
    # prod takes one dim at a time, highest first so the others keep their place
    for a in sorted((a % x.dim() for a in axes), reverse=True):
        x = x.prod(dim=a, keepdim=keepdims)
    return x


def _reduce(fn_name):
    def impl(ev, node, ins, attrs):
        x = ins[0]
        axes = attrs.get("axes")
        if axes is None and len(ins) > 1 and ins[1] is not None:
            axes = _static_ints(ins[1], "Reduce axes")
        keepdims = bool(int(attrs.get("keepdims", 1)))
        if axes is None and int(attrs.get("noop_with_empty_axes", 0)):
            return x
        axes = None if axes is None else tuple(int(a) for a in axes)
        if _is_static(x):
            return _REDUCE_NP[fn_name](x, axis=axes, keepdims=keepdims)
        return _reduce_t(fn_name, x, axes, keepdims)

    return impl


_OPS["ReduceMean"] = _reduce("mean")
_OPS["ReduceSum"] = _reduce("sum")
_OPS["ReduceMax"] = _reduce("max")
_OPS["ReduceMin"] = _reduce("min")
_OPS["ReduceProd"] = _reduce("prod")


def _arg(fn_np, fn_t):
    def impl(ev, node, ins, attrs):
        axis = int(attrs.get("axis", 0))
        keep = int(attrs.get("keepdims", 1))
        if _is_static(ins[0]):
            out = fn_np(ins[0], axis=axis)
            if keep:
                out = np.expand_dims(out, axis)
            return out.astype(np.int64)
        return fn_t(ins[0], dim=axis, keepdim=bool(keep))

    return impl


_OPS["ArgMax"] = _arg(np.argmax, torch.argmax)
_OPS["ArgMin"] = _arg(np.argmin, torch.argmin)


@_op("Dropout")
def _dropout(ev, node, ins, attrs):
    return ins[0]  # inference mode


@_op("Trilu")
def _trilu(ev, node, ins, attrs):
    k = 0
    if len(ins) > 1 and ins[1] is not None:
        k = _static_ints(ins[1], "Trilu k")[0]
    upper = int(attrs.get("upper", 1))
    if _is_static(ins[0]):
        return np.triu(ins[0], k) if upper else np.tril(ins[0], k)
    return torch.triu(ins[0], k) if upper else torch.tril(ins[0], k)


@_op("CumSum")
def _cumsum(ev, node, ins, attrs):
    axis = _static_ints(ins[1], "CumSum axis")[0]
    return np.cumsum(ins[0], axis=axis) if _is_static(ins[0]) else torch.cumsum(ins[0], dim=axis)


# -- public API ---------------------------------------------------------------


def find_onnx_file(path) -> Optional[Path]:
    p = Path(path)
    if p.is_file() and p.suffix == ".onnx":
        return p
    if p.is_dir():
        cands = sorted(p.glob("*.onnx")) or sorted(p.glob("**/model.onnx"))
        if cands:
            return cands[0]
    return None


def load_onnx_bundle(path, device="cuda") -> Tuple[SimpleNamespace, Dict[str, Any]]:
    """Load a stock .onnx file as (bundle, params on ``device``), the same
    surface as native bundles (engines/jax_engine.py load_bundle):
    ``bundle.apply(params, *inputs)`` -> output (a tuple if the graph has
    several)."""
    onnx_file = find_onnx_file(path)
    if onnx_file is None:
        raise ValueError("no .onnx file found at {}".format(path))
    model = onnx_proto.parse_model(onnx_file.read_bytes())
    graph = model.get("graph") or {}
    interp = _Interpreter(graph, device)
    params = {k: torch.from_numpy(np.require(v, requirements=["C", "W"])).to(
        device=interp.device, dtype=torch_dtype_of(v.dtype))
        for k, v in interp.init_params().items()}
    # the device copies shadow these in run(); keeping the host numpy copies
    # alive would double per-model host memory for nothing
    for name in interp.param_names:
        del interp.initializers[name]

    def apply(params, *inputs):
        outs = interp.run(params, *inputs)
        return outs[0] if len(outs) == 1 else outs

    bundle = SimpleNamespace(
        apply=apply,
        config={
            "arch": "onnx",
            "source": str(onnx_file),
            "inputs": interp.input_names,
            "outputs": interp.output_names,
            "input_shapes": interp.input_shapes,
            "opset": [o.get("version") for o in model.get("opset_import", [])],
            "producer": model.get("producer_name", ""),
        },
        input_names=interp.input_names,
        output_names=interp.output_names,
    )
    return bundle, params
