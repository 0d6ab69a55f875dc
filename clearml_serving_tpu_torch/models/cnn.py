"""Small conv net (the MNIST-CNN class of workloads).

Counterpart of ``clearml_serving_tpu/models/cnn.py``, which runs NHWC with
HWIO kernels. The port runs NCHW (cuDNN's layout), so ``convert_params``
lays the weights out once: kernels HWIO -> OIHW, and the first dense
layer's rows, which the reference orders by the NHWC flatten (h, w, c),
permuted to the NCHW flatten's (c, h, w). ``padding="SAME"`` at stride 1
with 3x3 kernels is a padding of 1; the reference's ``VALID`` 2x2
``reduce_window`` is ``max_pool2d`` in floor mode (7 -> 3 at the second
pool). A ``[B, H, W]`` input gets its channel dimension appended.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F

from . import register_model
from .params import torch_dtype, tree_to


def _geometry(config: dict):
    in_hw = tuple(int(d) for d in config.get("in_hw", (28, 28)))
    channels = [int(c) for c in config.get("channels", [32, 64])]
    h, w = in_hw
    for _ in channels:
        h, w = h // 2, w // 2
    return in_hw, channels, h, w


@register_model("cnn")
def build(config: dict) -> SimpleNamespace:
    in_hw, channels, out_h, out_w = _geometry(config)
    in_ch = int(config.get("in_ch", 1))
    dense = int(config.get("dense", 128))
    out_dim = int(config.get("out_dim", 10))
    dtype = torch_dtype(config.get("dtype", "float32"))
    flat = out_h * out_w * (channels[-1] if channels else in_ch)

    def init(generator: torch.Generator):
        """Random weights in the reference's layout (HWIO kernels, rows of
        the NHWC flatten)."""
        dev = generator.device

        def normal(shape, fan_in):
            w = torch.randn(shape, generator=generator, device=dev) * (2.0 / fan_in) ** 0.5
            return w.to(dtype)

        params = {"conv": [], "dense": []}
        ch = in_ch
        for c in channels:
            params["conv"].append({"k": normal((3, 3, ch, c), 9 * ch),
                                   "b": torch.zeros(c, dtype=dtype, device=dev)})
            ch = c
        params["dense"] = [
            {"w": normal((flat, dense), flat), "b": torch.zeros(dense, dtype=dtype, device=dev)},
            {"w": normal((dense, out_dim), dense),
             "b": torch.zeros(out_dim, dtype=dtype, device=dev)},
        ]
        return params

    def convert_params(np_tree, device="cuda"):
        """The reference's tree -> OIHW kernels and dense rows in the NCHW
        flatten's order, on ``device``."""
        tree = tree_to(np_tree, device)
        conv = [{"k": layer["k"].permute(3, 2, 0, 1).contiguous(), "b": layer["b"]}
                for layer in tree["conv"]]
        d1, d2 = tree["dense"]
        c = channels[-1] if channels else in_ch
        w1 = d1["w"].reshape(out_h, out_w, c, -1).permute(2, 0, 1, 3).reshape(flat, -1)
        return {"conv": conv, "dense": [{"w": w1.contiguous(), "b": d1["b"]},
                                        {"w": d2["w"], "b": d2["b"]}]}

    def apply(params, x):
        # x: [B, H, W, C] (a [B, H, W] input gets a channel dim appended)
        if x.dim() == 3:
            x = x[..., None]
        x = x.to(dtype).permute(0, 3, 1, 2)
        for layer in params["conv"]:
            x = F.conv2d(x, layer["k"], padding=1)
            x = F.relu(x + layer["b"][None, :, None, None])
            x = F.max_pool2d(x, 2, 2)
        x = x.reshape(x.shape[0], -1)
        d1, d2 = params["dense"]
        x = F.relu(x @ d1["w"] + d1["b"])
        return x @ d2["w"] + d2["b"]

    return SimpleNamespace(init=init, apply=apply, config=config,
                           convert_params=convert_params)
