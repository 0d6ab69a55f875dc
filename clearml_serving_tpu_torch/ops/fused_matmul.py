"""w4a16 fused dequant-matmul: a CUDA kernel for Hopper and its plain version.

Counterpart of ``clearml_serving_tpu/ops/fused_matmul.py``: the Pallas
kernel ``fused_int4_matmul`` (body ``_w4a16_kernel``) and its XLA reference
``int4_matmul_xla``. It computes ``y = x @ dequant(W)`` on group-int4
weights (``ops/quant.py``)::

    x        [..., K]      activations (bf16 for the kernel)
    packed   [K//2, N]     uint8, rows 2i / 2i+1 in the low / high nibble
                           of byte row i, each stored as level + 8
    scale    [K//g, N]     f32, one scale per (group of g rows, column)
    y        [..., N]      in x's dtype

The wrapper launches the hand-written kernel (``csrc/fused_int4_matmul.cu``)
for CUDA tensors and computes the plain version for CPU tensors. On CUDA it
launches the kernel at any row count (the kernel streams x in tiles; the
TPU kernel's 256-row VMEM limit does not carry over) or raises a
``ValueError`` naming the gate: up to 16 rows the decode tiling
(``mma.sync``, ``cp.async``), above it the block tiling (``wgmma`` fed by
TMA). ``fused_int4_matmul.launches`` counts the calls that launched the
kernel (one per call, also when a split of K adds a second, summing
launch).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import load_library
from .quant import dequantize_int4

# the kernel's gates (csrc/fused_int4_matmul.cu): K rows per tensor-core
# k-step, the column multiple of its 16-byte copies and tensor-map rows,
# the columns of the block tiling's grid (65535 CTA columns of 128 on grid
# y) and the rows its C entry point takes (a 32-bit int)
KERNEL_K_STEP = 16
KERNEL_N_MULTIPLE = 16
KERNEL_COL_BLOCK = 128
KERNEL_MAX_COLS = 65535 * KERNEL_COL_BLOCK
KERNEL_MAX_ROWS = 2 ** 31 - 1


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version (the reference's ``int4_matmul_xla``): ``x @
    dequantize_int4(packed, scale, dtype or x.dtype)``, in the promoted
    type of the two, as JAX promotes them."""
    w = dequantize_int4(packed, scale, dtype or x.dtype)
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    return x.to(out_dtype) @ w.to(out_dtype)


def int4_kernel_unsupported_reason(x: torch.Tensor, packed: torch.Tensor,
                                   scale: torch.Tensor) -> Optional[str]:
    """Why the CUDA kernel does not take (x, packed, scale): ``"<gate>:
    <detail>"``, or None when it does. Checks shapes, dtypes, layout and
    placement; it reads no tensor values."""
    if packed.dim() != 2 or scale.dim() != 2:
        return "2-D: the kernel takes 2-D packed/scale (got {}D/{}D); stacked trees " \
               "are sliced per layer".format(packed.dim(), scale.dim())
    if packed.dtype != torch.uint8:
        return "packed.dtype: packed weights must be uint8 nibbles, got {}".format(packed.dtype)
    if scale.dtype != torch.float32:
        return "scale.dtype: scales must be float32, got {}".format(scale.dtype)
    if x.dtype != torch.bfloat16:
        return "x.dtype: the kernel takes bfloat16 activations, got {}".format(x.dtype)
    k2, n = packed.shape
    k = x.shape[-1]
    if k % 2:
        return "K: the input dim must be even, got {}".format(k)
    if k != 2 * k2:
        return "K: x has {} columns, packed holds {} rows".format(k, 2 * k2)
    ng = scale.shape[0]
    if scale.shape[1] != n:
        return "scale.shape: scale output dim {} != weight output dim {}".format(
            scale.shape[1], n)
    if ng < 1 or k % ng:
        return "groups: {} scale groups do not divide K={}".format(ng, k)
    group = k // ng
    if group % KERNEL_K_STEP:
        return "group: group size {} is not a multiple of {} (even, whole tensor-core " \
               "k-steps)".format(group, KERNEL_K_STEP)
    if n % KERNEL_N_MULTIPLE:
        return "N: N={} is not a multiple of {} (16-byte row copies)".format(
            n, KERNEL_N_MULTIPLE)
    if n > KERNEL_MAX_COLS:
        return "N: N={} exceeds the grid's {} column tiles of {}".format(
            n, KERNEL_MAX_COLS // KERNEL_COL_BLOCK, KERNEL_COL_BLOCK)
    m = x.numel() // k if k else 0
    if m == 0:
        return "rows: empty activation batch"
    if m > KERNEL_MAX_ROWS:
        return "rows: {} rows exceed the kernel's 32-bit row count ({})".format(
            m, KERNEL_MAX_ROWS)
    operands = (x, packed, scale)
    if not all(t.is_contiguous() for t in operands):
        return "contiguous: every operand must be contiguous"
    if len({t.device for t in operands}) != 1:
        return "device: operands on several devices: {}".format(
            sorted({str(t.device) for t in operands}))
    if any(t.data_ptr() % 16 for t in operands):
        return "alignment: every operand must start on a 16-byte boundary"
    return None


def fused_int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor, *,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ dequant(packed [K//2, N], scale [G, N]) -> [..., N]``.

    CPU tensors take ``int4_matmul_plain`` (``dtype`` pins its dequant
    dtype, the model's activation dtype). CUDA tensors launch the kernel on
    the current stream (no synchronisation; output in x's dtype) or raise.
    A call whose tiles do not fill the card splits K across CTAs: it then
    allocates the f32 workspace the library asks for, and the kernel's
    second pass adds the splits in a fixed order (the same bits on every
    call)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scale, dtype)
    if x.device.type != "cuda":
        raise ValueError("fused_int4_matmul runs on cuda or cpu, got {}".format(x.device))
    reason = int4_kernel_unsupported_reason(x, packed, scale)
    if reason is not None:
        raise ValueError("fused_int4_matmul gate " + reason)
    k2, n = packed.shape
    k = 2 * k2
    m = x.numel() // k
    group = k // scale.shape[0]
    lib = load_library()
    ws_bytes = ctypes.c_longlong(0)
    rc = lib.tpu_torch_fused_int4_workspace(m, k, n, group, ctypes.byref(ws_bytes))
    if rc != 0:
        raise RuntimeError("fused_int4_matmul workspace query failed: cudaError {}".format(rc))
    out = torch.empty(tuple(x.shape[:-1]) + (n,), dtype=x.dtype, device=x.device)
    # split-K partial sums, allocated on the current stream for this call only
    ws = (torch.empty(ws_bytes.value, dtype=torch.uint8, device=x.device)
          if ws_bytes.value else None)
    rc = lib.tpu_torch_fused_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, k, n, group, ws_bytes.value,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("fused_int4_matmul kernel launch failed: cudaError {}".format(rc))
    fused_int4_matmul.launches += 1
    return out


fused_int4_matmul.launches = 0
