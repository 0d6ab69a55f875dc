"""Paged decode attention: a CUDA kernel for Hopper and its plain version.

Counterpart of ``clearml_serving_tpu/ops/paged_attention.py`` (the Pallas
kernel ``paged_attention`` and its XLA reference ``paged_attention_xla``).
Layout, head-major pools as in the reference::

    q            [B, Hkv, G, D]   one new token per sequence, query heads
                                  grouped under their shared KV head (GQA)
    k/v pools    [Hkv, N, P, D]   bf16, or int8 with f32 scales [Hkv, N, P]
    page_table   [B, PP]  int32   page ids into the pools
    lengths      [B]      int32   tokens present in each sequence

``paged_attention`` launches the hand-written kernel in
``csrc/paged_attention.cu`` for CUDA tensors and computes
``paged_attention_ref`` for CPU tensors. On CUDA it launches the kernel or
raises: operands outside the kernel's gates (see ``check_kernel_gates``) are
a ``ValueError`` naming the gate, never a silent detour to the plain
version. ``paged_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import load_library

# the kernel's gates (csrc/paged_attention.cu)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_MAX_GROUP = 8
KERNEL_PAGE_SIZES = (16, 32)


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                        k_scale=None, v_scale=None):
    """Plain PyTorch version (the reference's ``paged_attention_xla``).

    Gathers every table entry's page, masks tokens at or past the length,
    and takes a stable softmax in f32; zero-length rows give zeros. int8
    pools dequantize in f32 with the per-(token, head) scales and cast to
    the query dtype before the attention math, as the reference does."""
    b, hkv, _g, d = q.shape
    p = k_pool.shape[2]
    pp = page_table.shape[1]
    idx = page_table.long()
    k = k_pool[:, idx].reshape(hkv, b, pp * p, d)
    v = v_pool[:, idx].reshape(hkv, b, pp * p, d)
    if k_scale is not None:
        ks = k_scale[:, idx].reshape(hkv, b, pp * p, 1)
        vs = v_scale[:, idx].reshape(hkv, b, pp * p, 1)
        k = (k.float() * ks).to(q.dtype)
        v = (v.float() * vs).to(q.dtype)
    t_idx = torch.arange(pp * p, device=q.device)[None]
    valid = (t_idx < lengths.long()[:, None])[:, None, None, :]      # [B,1,1,T]
    scores = torch.einsum("bkgd,kbtd->bkgt", q.float(), k.float()) * (d ** -0.5)
    scores = scores.masked_fill(~valid, float("-inf"))
    row_max = scores.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    probs = torch.exp(scores - row_max).masked_fill(~valid, 0.0)
    denom = probs.sum(dim=-1, keepdim=True)
    probs = (probs / torch.where(denom == 0.0, 1.0, denom)).to(v.dtype)
    out = torch.einsum("bkgt,kbtd->bkgd", probs, v)
    return out.to(q.dtype)


def _need(cond: bool, gate: str, detail: str) -> None:
    if not cond:
        raise ValueError("paged_attention gate {}: {}".format(gate, detail))


def check_kernel_gates(q, k_pool, v_pool, page_table, lengths,
                       k_scale=None, v_scale=None) -> None:
    """Raise ``ValueError`` naming the gate when the CUDA kernel does not
    take these operands. Checks shapes, dtypes, contiguity and that all
    operands share one device; it reads no tensor values."""
    _need(q.dim() == 4, "q.shape", "q must be [B, Hkv, G, D], got {}".format(tuple(q.shape)))
    b, hkv, g, d = q.shape
    _need(q.dtype == torch.bfloat16, "q.dtype",
          "the kernel takes bfloat16 queries, got {}".format(q.dtype))
    _need(d in KERNEL_HEAD_DIMS, "head_dim",
          "head_dim must be one of {}, got {}".format(KERNEL_HEAD_DIMS, d))
    _need(1 <= g <= KERNEL_MAX_GROUP, "group",
          "G = query heads per KV head must be 1..{}, got {}".format(KERNEL_MAX_GROUP, g))
    _need(k_pool.dim() == 4 and k_pool.shape[0] == hkv and k_pool.shape[3] == d,
          "pool.shape", "pools must be [Hkv={}, N, P, D={}], got {}".format(
              hkv, d, tuple(k_pool.shape)))
    _need(v_pool.shape == k_pool.shape, "pool.shape",
          "k/v pools differ: {} vs {}".format(tuple(k_pool.shape), tuple(v_pool.shape)))
    _need(k_pool.shape[2] in KERNEL_PAGE_SIZES, "page_size",
          "page_size must be one of {}, got {}".format(KERNEL_PAGE_SIZES, k_pool.shape[2]))
    _need(k_pool.dtype == v_pool.dtype and k_pool.dtype in (torch.bfloat16, torch.int8),
          "pool.dtype", "pools must both be bfloat16 or both int8, got {} / {}".format(
              k_pool.dtype, v_pool.dtype))
    quantized = k_pool.dtype == torch.int8
    if quantized:
        _need(k_scale is not None and v_scale is not None, "scales",
              "int8 pools need k_scale/v_scale")
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            _need(s.dtype == torch.float32 and tuple(s.shape) == tuple(k_pool.shape[:3]),
                  "scales", "{} must be float32 {}, got {} {}".format(
                      name, tuple(k_pool.shape[:3]), s.dtype, tuple(s.shape)))
    else:
        _need(k_scale is None and v_scale is None, "scales",
              "scales given but the pools are not int8")
    _need(page_table.dim() == 2 and page_table.shape[0] == b
          and page_table.dtype == torch.int32, "page_table",
          "page_table must be int32 [B={}, PP], got {} {}".format(
              b, page_table.dtype, tuple(page_table.shape)))
    _need(tuple(lengths.shape) == (b,) and lengths.dtype == torch.int32, "lengths",
          "lengths must be int32 [B={}], got {} {}".format(b, lengths.dtype,
                                                          tuple(lengths.shape)))
    operands = [q, k_pool, v_pool, page_table, lengths]
    if quantized:
        operands += [k_scale, v_scale]
    _need(all(t.is_contiguous() for t in operands), "contiguous",
          "every operand must be contiguous")
    _need(len({t.device for t in operands}) == 1, "device",
          "operands on several devices: {}".format(sorted({str(t.device) for t in operands})))


def paged_attention(q, k_pool, v_pool, page_table, lengths, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged GQA decode attention, ``[B, Hkv, G, D]`` in q's dtype.

    CPU tensors take ``paged_attention_ref``; CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise."""
    if k_pool.dtype == torch.int8 and k_scale is None:
        raise ValueError("int8 KV pools need k_scale/v_scale operands (per-token dequant)")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError("paged_attention runs on cuda or cpu, got {}".format(q.device))
    check_kernel_gates(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale)
    b, hkv, g, d = q.shape
    _, n_pages, page_size, _ = k_pool.shape
    out = torch.empty_like(q)
    quantized = k_pool.dtype == torch.int8
    rc = load_library().tpu_torch_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hkv, g, d, n_pages, page_size, page_table.shape[1], int(quantized),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed: cudaError {}".format(rc))
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
