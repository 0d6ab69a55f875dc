"""Parameter leaves carried into the port: numpy arrays (the JAX package's
trees pulled to numpy, ``bfloat16`` through ml_dtypes) or tensors (a bundle
file's, ``utils/flax_msgpack.py``) -> tensors on a device."""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def to_tensor(a, device) -> torch.Tensor:
    """One array leaf on ``device``, dtype kept (one copy)."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def tree_to(tree, device):
    """``to_tensor`` over every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    return to_tensor(tree, device)


def torch_dtype(name) -> torch.dtype:
    if str(name) not in DTYPES:
        raise ValueError("unsupported dtype {!r}".format(name))
    return DTYPES[str(name)]
