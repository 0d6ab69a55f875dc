"""Weight quantization: int8 per-channel and group-int4 (w4a16) leaves.

Counterpart of ``clearml_serving_tpu/ops/quant.py``. The leaf formats, the
nibble layout and the arithmetic are the reference's, so a tree quantized
here equals one quantized by the JAX package bit for bit on the same f32
input (``torch.round`` and ``jnp.round`` both round half to even; the
divisions stay in f32)::

    int8: {"_q8": int8 [..., K, N],     "_scale":  f32 [..., 1, N]}
    int4: {"_q4": uint8 [..., K//2, N], "_scale4": f32 [..., K//g, N]}

int4 levels are symmetric in [-8, 7], stored as unsigned nibbles (q + 8);
rows 2i and 2i+1 of the weight pack into the low and high nibble of byte
row i. ``_scale4`` holds one f32 scale per (group of g input rows, output
column); K not divisible by the group falls back to one group.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def quantize_int8(w: torch.Tensor, axis: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (float) -> (w_int8, scale_f32). ``axis`` is the reduction (input)
    axis; scales are per output channel."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant(q [K, N]) in x's dtype."""
    return (x @ dequantize(q, scale, x.dtype)).to(x.dtype)


INT4_GROUP = 128  # input rows per scale group (AWQ/GPTQ convention)


def int4_groups(k: int, group: int = INT4_GROUP) -> int:
    """Number of scale groups for a K-row input dim: K // group, or one
    per-channel group when K does not divide (the reference's rule)."""
    return k // group if group and k % group == 0 else 1


def quantize_int4(w: torch.Tensor, axis: int = -2,
                  group: int = INT4_GROUP) -> Tuple[torch.Tensor, torch.Tensor]:
    """w float [..., K, N] -> (packed uint8 [..., K//2, N], scale f32
    [..., K//group, N])."""
    if axis not in (-2, w.dim() - 2):
        raise ValueError("int4 quantization packs along axis -2")
    k, n = w.shape[-2], w.shape[-1]
    if k % 2:
        raise ValueError("int4 packing needs an even input dim, got {}".format(k))
    g = k // int4_groups(k, group)
    lead = tuple(w.shape[:-2])
    shaped = w.float().reshape(*lead, k // g, g, n)
    absmax = shaped.abs().amax(dim=-2, keepdim=True)                 # [.., K//g, 1, N]
    scale = torch.where(absmax > 0, absmax / 7.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(shaped / scale), -8, 7)
    u = (q + 8).to(torch.uint8).reshape(*lead, k, n)
    packed = u[..., 0::2, :] | (u[..., 1::2, :] << 4)                # [.., K//2, N]
    return packed.contiguous(), scale.squeeze(-2)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_int4``: [..., K, N] in ``dtype``."""
    k2, n = packed.shape[-2], packed.shape[-1]
    lead = tuple(packed.shape[:-2])
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    q = torch.stack([lo, hi], dim=-2)                                 # [.., K//2, 2, N]
    qf = q.reshape(*lead, k2 * 2, n).float() - 8.0
    ng = scale.shape[-2]
    g = (k2 * 2) // ng
    shaped = qf.reshape(*lead, ng, g, n) * scale[..., :, None, :]
    return shaped.reshape(qf.shape).to(dtype)


def detect_weight_quant(params: Any) -> str:
    """"int4"/"int8" when the tree already holds packed quantized leaves,
    else ""."""
    if isinstance(params, dict):
        if "_q4" in params:
            return "int4"
        if "_q8" in params:
            return "int8"
        for value in params.values():
            found = detect_weight_quant(value)
            if found:
                return found
        return ""
    if isinstance(params, (list, tuple)):
        for value in params:
            found = detect_weight_quant(value)
            if found:
                return found
    return ""


# projection matrices that quantize; norms and embeddings keep their dtype
# (the MoE expert stacks of the reference quantize the same way)
QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
    "w_gate_e", "w_up_e", "w_down_e",
})


def quantize_llama_params(params: Dict[str, Any], bits: int = 8,
                          group: int = INT4_GROUP) -> Dict[str, Any]:
    """Quantize every projection matrix of a llama parameter tree (per-layer
    list or ``[L, in, out]`` stacked) to int8, or group-int4 with
    ``bits=4``. Leaves stay on their device; the full-precision tree is not
    modified."""
    if bits not in (4, 8):
        raise ValueError("bits must be 4 or 8, got {}".format(bits))

    def _q(tree):
        if isinstance(tree, dict):
            out = {}
            for key, value in tree.items():
                if key in QUANT_KEYS:
                    # axis -2 is the input (reduction) dim of [in, out] and
                    # of stacked [L, in, out] alike
                    if bits == 4:
                        qv, s = quantize_int4(value, axis=-2, group=group)
                        out[key] = {"_q4": qv, "_scale4": s}
                    else:
                        qv, s = quantize_int8(value, axis=-2)
                        out[key] = {"_q8": qv, "_scale": s}
                else:
                    out[key] = _q(value)
            return out
        if isinstance(tree, list):
            return [_q(v) for v in tree]
        return tree

    return _q(params)
