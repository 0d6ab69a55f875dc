"""The CUDA kernels' gates, checked against an engine's shape facts.

An engine on the card builds pools and weights for a configuration before
any request arrives; a configuration outside a kernel's gates would
otherwise fail every request at its first launch. ``check_engine_gates``
runs each wrapper's own gate check (``ops/paged_attention.py``,
``ops/fused_matmul.py``) on meta tensors of the shapes the engine will pass,
so the rules and the words are the wrappers': a ``ValueError`` reading
``"<kernel> gate <gate>: <detail>"``. The wrappers still check every call.
The plain versions that CPU tensors take have no gates.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from .fused_matmul import int4_kernel_unsupported_reason
from .paged_attention import RAGGED_QB, check_kernel_gates, check_ragged_gates


def check_engine_gates(*, page_size: int, n_kv_heads: int, head_dim: int, group: int,
                       dtype: torch.dtype, kv_dtype: torch.dtype, ragged: bool = False,
                       tree_width: Optional[int] = None,
                       int4_weights: Iterable[Tuple[str, int, int, int]] = ()) -> None:
    """Raise ``ValueError`` naming the first gate that a kernel of the
    engine's path does not pass.

    ``group`` is query heads per KV head, ``dtype`` the model's (queries
    and int4 activations), ``kv_dtype`` the pools' (int8 pools carry f32
    scales). ``ragged`` adds the ragged kernel's gates, ``tree_width`` (the
    ancestor-list width, ``spec_k + 1`` on tree engines) its draft-tree
    mask's. ``int4_weights`` lists each int4 projection as ``(name, K, N,
    groups)``."""
    meta = torch.device("meta")
    i32 = dict(dtype=torch.int32, device=meta)
    q = torch.empty((RAGGED_QB, n_kv_heads, group, head_dim), dtype=dtype, device=meta)
    pool = torch.empty((n_kv_heads, 2, page_size, head_dim), dtype=kv_dtype, device=meta)
    scales = {}
    if kv_dtype == torch.int8:
        scale = torch.empty((n_kv_heads, 2, page_size), dtype=torch.float32, device=meta)
        scales = {"k_scale": scale, "v_scale": scale}
    table, lens = torch.empty((1, 1), **i32), torch.empty((1,), **i32)
    check_kernel_gates(q[:1], pool, pool, table, lens, **scales)
    if ragged:
        tree_anc = None if tree_width is None else torch.empty((RAGGED_QB, tree_width), **i32)
        check_ragged_gates(q, pool, pool, table, lens, lens, lens, block_rows=lens,
                           block_q0=lens, tree_anc=tree_anc, **scales)
    for name, k, n, groups in int4_weights:
        reason = int4_kernel_unsupported_reason(
            torch.empty((1, k), dtype=dtype, device=meta),
            torch.empty((k // 2, n), dtype=torch.uint8, device=meta),
            torch.empty((groups, n), dtype=torch.float32, device=meta))
        if reason is not None:
            raise ValueError("fused_int4_matmul gate {} (weight {})".format(reason, name))
