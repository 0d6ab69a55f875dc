"""TorchScript importer: a ``model.pt`` served by running it.

Counterpart of ``clearml_serving_tpu/engines/importers/torchscript_import.py``.
The reference exports the scripted module to ONNX in memory only to reach
JAX; the port runs the module itself: ``torch.jit.load(map_location=
device)``, ``eval()``, under ``torch.inference_mode()`` with the JIT's
optimizing passes off (``torch.jit.optimized_execution(False)``), so its
first calls run the graph as written and a CUDA-graph capture after the
warm-up run records the same kernels as eager calls. The reference's
contract stays: the endpoint's input spec is required (``load_bundle``
refuses a ``.pt`` without one), and the bundle's config says
``arch: "torchscript"`` with the endpoint's example shapes and dtypes.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


def load_torchscript_bundle(
    path,
    example_shapes: Sequence[Sequence[int]],
    example_dtypes: Optional[Sequence[str]] = None,
    device="cuda",
) -> Tuple[Any, Dict[str, Any]]:
    """TorchScript file -> (bundle, params), the surface of the other
    importers; the module holds its own weights, so ``params`` is empty."""
    module = torch.jit.load(str(path), map_location=torch.device(device))
    module.eval()

    def apply(params, *inputs):
        with torch.inference_mode(), torch.jit.optimized_execution(False):
            return module(*inputs)

    bundle = SimpleNamespace(
        apply=apply,
        module=module,
        config={
            "arch": "torchscript",
            "source": str(path),
            "input_shapes": [list(s) for s in example_shapes],
            "input_dtypes": list(example_dtypes or []),
        },
    )
    return bundle, {}
