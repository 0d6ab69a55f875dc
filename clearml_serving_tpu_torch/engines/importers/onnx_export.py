"""Write a torch module as an ONNX file, without the ``onnx`` package.

torch's classic (TorchScript-based) exporter calls into ``onnx`` only to
inline onnxscript functions, which classic-exported graphs do not use; that
hook is bypassed, as the reference's TorchScript importer bypasses it, so
the export works where ``onnx`` is not installed. Every input and output
gets a dynamic batch axis. The port serves such files with
``onnx_import``; tests and ``chip_smoke.py`` write their graphs with this.
"""

from __future__ import annotations

import io
from typing import Sequence


def _bypass_onnxscript_inlining() -> bool:
    """Replace the exporter's onnxscript hook by a pass-through (True), or
    leave it (False: this torch keeps it elsewhere)."""
    try:
        from torch.onnx._internal.torchscript_exporter import onnx_proto_utils
    except ImportError:
        return False
    if getattr(onnx_proto_utils._add_onnxscript_fn, "__name__", "") != "_passthrough":
        def _passthrough(model_bytes, custom_opsets):
            return model_bytes

        onnx_proto_utils._add_onnxscript_fn = _passthrough
    return True


def export_onnx_bytes(module, args: Sequence, input_names=None) -> bytes:
    """``module`` (eval mode) traced on the example ``args`` -> ModelProto
    bytes, batch dims dynamic."""
    import torch

    _bypass_onnxscript_inlining()
    names = list(input_names or ["input_{}".format(i) for i in range(len(args))])
    buf = io.BytesIO()
    module.eval()
    torch.onnx.export(module, tuple(args), buf, input_names=names,
                      dynamic_axes={n: {0: "batch"} for n in names}, dynamo=False)
    return buf.getvalue()


def apply_module(apply_fn, params):
    """A ``torch.nn.Module`` running ``apply_fn(params, *inputs)``, its
    parameter tree's tensors registered as buffers (so an export writes them
    as initializers and a TorchScript trace keeps them)."""
    import torch

    class _Apply(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self._leaves = []

            def walk(node, prefix):
                if isinstance(node, dict):
                    return {k: walk(v, "{}_{}".format(prefix, k)) for k, v in node.items()}
                if isinstance(node, (list, tuple)):
                    return [walk(v, "{}_{}".format(prefix, i)) for i, v in enumerate(node)]
                name = "p" + prefix
                self.register_buffer(name, node)
                self._leaves.append(name)
                return name

            self._names = walk(params, "")

        def _tree(self, node):
            if isinstance(node, dict):
                return {k: self._tree(v) for k, v in node.items()}
            if isinstance(node, list):
                return [self._tree(v) for v in node]
            return getattr(self, node)

        def forward(self, *inputs):
            return apply_fn(self._tree(self._names), *inputs)

    return _Apply()
