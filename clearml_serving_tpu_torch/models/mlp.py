"""Tabular MLP (the iris-classifier class of workloads).

Counterpart of ``clearml_serving_tpu/models/mlp.py``: ReLU between dense
layers, ``x`` cast to the config's dtype, weights ``[in, out]`` so
``x @ w`` reads as in the reference and its tree carries over unchanged.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import register_model
from .params import torch_dtype, tree_to


def convert_params(np_tree, device="cuda"):
    """The reference's ``{"layers": [{"w", "b"}, ...]}`` on ``device``."""
    return {"layers": [{"w": l["w"], "b": l["b"]} for l in tree_to(np_tree, device)["layers"]]}


@register_model("mlp")
def build(config: dict) -> SimpleNamespace:
    in_dim = int(config.get("in_dim", 4))
    hidden = [int(h) for h in config.get("hidden", [64, 64])]
    out_dim = int(config.get("out_dim", 3))
    dtype = torch_dtype(config.get("dtype") or "float32")
    dims = [in_dim] + hidden + [out_dim]

    def init(generator: torch.Generator):
        dev = generator.device
        layers = []
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.randn((a, b), generator=generator, device=dev) * (2.0 / a) ** 0.5
            layers.append({"w": w.to(dtype), "b": torch.zeros(b, dtype=dtype, device=dev)})
        return {"layers": layers}

    def apply(params, x):
        x = x.to(dtype)
        layers = params["layers"]
        for layer in layers[:-1]:
            x = F.relu(x @ layer["w"] + layer["b"])
        last = layers[-1]
        return x @ last["w"] + last["b"]

    return SimpleNamespace(init=init, apply=apply, config=config,
                           convert_params=convert_params)
