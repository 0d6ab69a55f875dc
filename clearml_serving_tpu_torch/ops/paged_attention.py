"""Paged attention: CUDA kernels for Hopper and their plain versions.

Counterpart of ``clearml_serving_tpu/ops/paged_attention.py``: the Pallas
kernels ``paged_attention`` (decode) and ``ragged_paged_attention`` (mixed
prefill-chunk and decode rows in one launch) and their XLA references
``paged_attention_xla`` / ``ragged_paged_attention_xla``. Layout of the
decode kernel, head-major pools as in the reference::

    q            [B, Hkv, G, D]   one new token per sequence, query heads
                                  grouped under their shared KV head (GQA)
    k/v pools    [Hkv, N, P, D]   bf16, or int8 with f32 scales [Hkv, N, P]
    page_table   [B, PP]  int32   page ids into the pools
    lengths      [B]      int32   tokens present in each sequence

The ragged kernel takes a flat token axis ``q [T, Hkv, G, D]`` whose rows
are laid out by ``ragged_layout`` (see the section below).

Each wrapper launches its hand-written kernel (``csrc/paged_attention.cu``,
``csrc/ragged_paged_attention.cu``) for CUDA tensors and computes its plain
version for CPU tensors. On CUDA it launches the kernel or raises: operands
outside the kernel's gates are a ``ValueError`` naming the gate, never a
silent detour to the plain version. ``<wrapper>.launches`` counts kernel
launches.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from . import launch_counts
from ._build import load_library

# the kernels' gates (csrc/paged_attention.cu, csrc/ragged_paged_attention.cu):
# head_dim 256 is Gemma's; 96 (Phi-3-mini) is not taken
KERNEL_HEAD_DIMS = (64, 128, 256)
KERNEL_MAX_GROUP = 8
KERNEL_PAGE_SIZES = (16, 32)

# The decode kernel splits each row's key range across CTAs: spans are a
# multiple of SPLIT_QUANTUM tokens (kSpanQuantum in csrc/paged_attention.cu:
# four warps' 16-token tiles, whole pages of 16 and of 32), sized so that a
# full table gives about SPLIT_TARGET_CTAS CTAs (four per SM of an H100's
# 132), and never shorter than SPLIT_MIN_SPAN tokens: in development
# timings on an H100 a call's fixed cost (the two grids, the length and
# page-table reads before the first copy, the combine) made shorter spans
# slower at every batch timed, 1 x 2048 tokens included. At the engine's
# table (129 pages of 16) and 8 rows that is 9 spans of 256 tokens. The
# query heads (G) do not enter: a span's bytes do not depend on them, and
# its partials (G * D floats) stay under an eighth of its int8 K/V bytes
# (2 * 256 * D) up to G = 8.
SPLIT_QUANTUM = 64
SPLIT_TARGET_CTAS = 4 * 132
SPLIT_MIN_SPAN = 256


@functools.lru_cache(maxsize=256)
def split_plan(batch: int, hkv: int, pages_per_seq: int, page_size: int):
    """(splits, span) of the decode kernel's key-range split, from shapes
    alone (never from ``lengths``, which lives on the device: reading it
    would synchronise the host and break CUDA-graph capture). ``span`` is a
    positive multiple of ``SPLIT_QUANTUM`` and ``splits * span`` covers the
    table's ``pages_per_seq * page_size`` tokens with no split wholly past
    them."""
    capacity = pages_per_seq * page_size

    def quanta(tokens):
        return max(1, -(-tokens // SPLIT_QUANTUM))

    span = max(quanta(-(-capacity * max(1, batch * hkv) // SPLIT_TARGET_CTAS)),
               quanta(SPLIT_MIN_SPAN))
    span = min(span, quanta(capacity)) * SPLIT_QUANTUM
    return max(1, -(-capacity // span)), span


def _gather_rows(pool, scale, page_table, dtype):
    """Each table row's pages as one sequence: [Hkv, R, PP*P, D] in
    ``dtype`` (int8 pools dequantized in f32 with their per-token scales,
    then cast, as the reference does)."""
    hkv, _n, p, d = pool.shape
    r, pp = page_table.shape
    idx = page_table.long()
    rows = pool[:, idx].reshape(hkv, r, pp * p, d)
    if scale is None:
        return rows
    return (rows.float() * scale[:, idx].reshape(hkv, r, pp * p, 1)).to(dtype)


def _attend(q, k, v, valid):
    """Masked softmax attention of one query per batch entry over its own
    gathered sequence: q [B, Hkv, G, D], k/v [Hkv, B, C, D], valid [B, C].
    The decode and ragged plain versions both end here, so a ragged decode
    row computes exactly the decode version's arithmetic."""
    d = q.shape[-1]
    valid = valid[:, None, None, :]                                 # [B,1,1,C]
    scores = torch.einsum("bkgd,kbtd->bkgt", q.float(), k.float()) * (d ** -0.5)
    scores = scores.masked_fill(~valid, float("-inf"))
    row_max = scores.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    probs = torch.exp(scores - row_max).masked_fill(~valid, 0.0)
    denom = probs.sum(dim=-1, keepdim=True)
    probs = (probs / torch.where(denom == 0.0, 1.0, denom)).to(v.dtype)
    out = torch.einsum("bkgt,kbtd->bkgd", probs, v)
    return out.to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                        k_scale=None, v_scale=None):
    """Plain PyTorch version (the reference's ``paged_attention_xla``).

    Gathers every table entry's page, masks tokens at or past the length,
    and takes a stable softmax in f32; zero-length rows give zeros. int8
    pools dequantize in f32 with the per-(token, head) scales and cast to
    the query dtype before the attention math, as the reference does."""
    k = _gather_rows(k_pool, k_scale, page_table, q.dtype)
    v = _gather_rows(v_pool, v_scale, page_table, q.dtype)
    t_idx = torch.arange(k.shape[2], device=q.device)[None]
    return _attend(q, k, v, t_idx < lengths.long()[:, None])


def _need(cond: bool, gate: str, detail: str, kernel: str = "paged_attention") -> None:
    if not cond:
        raise ValueError("{} gate {}: {}".format(kernel, gate, detail))


def _check_heads_and_pools(q, k_pool, v_pool, k_scale, v_scale, kernel: str) -> bool:
    """The gates both kernels share: q [*, Hkv, G, D] bf16 and the pools
    with their scales. Returns whether the pools are int8."""
    def need(cond, gate, detail):
        _need(cond, gate, detail, kernel)

    need(q.dim() == 4, "q.shape", "q must be 4-D [*, Hkv, G, D], got {}".format(tuple(q.shape)))
    _, hkv, g, d = q.shape
    need(q.dtype == torch.bfloat16, "q.dtype",
         "the kernel takes bfloat16 queries, got {}".format(q.dtype))
    need(d in KERNEL_HEAD_DIMS, "head_dim",
         "head_dim must be one of {}, got {}".format(KERNEL_HEAD_DIMS, d))
    need(1 <= g <= KERNEL_MAX_GROUP, "group",
         "G = query heads per KV head must be 1..{}, got {}".format(KERNEL_MAX_GROUP, g))
    need(k_pool.dim() == 4 and k_pool.shape[0] == hkv and k_pool.shape[3] == d,
         "pool.shape", "pools must be [Hkv={}, N, P, D={}], got {}".format(
             hkv, d, tuple(k_pool.shape)))
    need(v_pool.shape == k_pool.shape, "pool.shape",
         "k/v pools differ: {} vs {}".format(tuple(k_pool.shape), tuple(v_pool.shape)))
    need(k_pool.shape[2] in KERNEL_PAGE_SIZES, "page_size",
         "page_size must be one of {}, got {}".format(KERNEL_PAGE_SIZES, k_pool.shape[2]))
    need(k_pool.dtype == v_pool.dtype and k_pool.dtype in (torch.bfloat16, torch.int8),
         "pool.dtype", "pools must both be bfloat16 or both int8, got {} / {}".format(
             k_pool.dtype, v_pool.dtype))
    quantized = k_pool.dtype == torch.int8
    if quantized:
        need(k_scale is not None and v_scale is not None, "scales",
             "int8 pools need k_scale/v_scale")
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            need(sc.dtype == torch.float32 and tuple(sc.shape) == tuple(k_pool.shape[:3]),
                 "scales", "{} must be float32 {}, got {} {}".format(
                     name, tuple(k_pool.shape[:3]), sc.dtype, tuple(sc.shape)))
    else:
        need(k_scale is None and v_scale is None, "scales",
             "scales given but the pools are not int8")
    return quantized


def _check_placement(operands, kernel: str) -> None:
    _need(all(t.is_contiguous() for t in operands), "contiguous",
          "every operand must be contiguous", kernel)
    _need(len({t.device for t in operands}) == 1, "device",
          "operands on several devices: {}".format(sorted({str(t.device) for t in operands})),
          kernel)


def check_kernel_gates(q, k_pool, v_pool, page_table, lengths,
                       k_scale=None, v_scale=None) -> None:
    """Raise ``ValueError`` naming the gate when the CUDA kernel does not
    take these operands. Checks shapes, dtypes, contiguity and that all
    operands share one device; it reads no tensor values."""
    quantized = _check_heads_and_pools(q, k_pool, v_pool, k_scale, v_scale, "paged_attention")
    b = q.shape[0]
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
    _check_placement(operands, "paged_attention")


def paged_attention(q, k_pool, v_pool, page_table, lengths, *,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged GQA decode attention, ``[B, Hkv, G, D]`` in q's dtype.

    CPU tensors take ``paged_attention_ref``; CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise. On CUDA a
    call is two grids, the key-range split (``split_plan``) and the
    combine of its f32 partials, and counts one launch."""
    if k_pool.dtype == torch.int8 and k_scale is None:
        raise ValueError("int8 KV pools need k_scale/v_scale operands (per-token dequant)")
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError("paged_attention runs on cuda or cpu, got {}".format(q.device))
    check_kernel_gates(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale)
    b, hkv, g, d = q.shape
    _, n_pages, page_size, _ = k_pool.shape
    pages_per_seq = page_table.shape[1]
    splits, span = split_plan(b, hkv, pages_per_seq, page_size)
    out = torch.empty_like(q)
    # the f32 partials in one buffer: acc [B, Hkv, S, G, D], then m and l
    # [B, Hkv, S, G] each (one allocation: the wrapper's host time is part
    # of every eager decode step)
    n_acc, n_ml = b * hkv * splits * g * d, b * hkv * splits * g
    part = torch.empty(n_acc + 2 * n_ml, dtype=torch.float32, device=q.device)
    acc = part.data_ptr()
    quantized = k_pool.dtype == torch.int8
    rc = load_library().tpu_torch_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        acc, acc + 4 * n_acc, acc + 4 * (n_acc + n_ml),
        b, hkv, g, d, n_pages, page_size, pages_per_seq, int(quantized), splits, span,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("paged_attention kernel launch failed: cudaError {}".format(rc))
    launch_counts.add(paged_attention)
    return out


paged_attention.launches = 0
# launches a CUDA-graph capture's warm-up run made (set-up work, taken out
# of ``launches``)
paged_attention.setup_launches = 0


# -- ragged paged attention ------------------------------------------------------
#
# One launch over rows at mixed phases (prefill chunks, decode tokens),
# flattened token-major::
#
#     q            [T, Hkv, G, D]   every row's tokens, segment by segment
#     page_table   [R, PP]          one row per batch row
#     kv_lens      [R]              tokens present per row INCLUDING this
#                                   step's (K/V are written before the call)
#     row_starts   [R], row_lens [R]  the ragged row map (row_lens 0 = idle)
#     tree_anc     [T, DMAX]        optional ancestor lists of draft-tree
#                                   verify rows (``tree_ancestors``; -2 in
#                                   column 0 keeps a token plain causal)
#
# Query i of row r sits at absolute position kv_lens[r] - row_lens[r] + i
# and attends KV positions up to its own (a tree query: its row's history
# and its listed ancestors among them). The kernel's layout is q-block
# aligned (``ragged_layout``): each row's segment starts at a multiple of
# ``RAGGED_QB``, so every block of RAGGED_QB tokens belongs to one row,
# named by ``block_rows`` / ``block_q0``.

# The CUDA kernel's query block (kQB in csrc/ragged_paged_attention.cu):
# 8 tokens times G query heads gives Llama-3-8B's G=4 two 16-row tensor-core
# tiles, while a decode row (one query) pads only 7 tokens.
RAGGED_QB = 8


@functools.lru_cache(maxsize=256)
def ragged_split_plan(t: int, n_rows: int, hkv: int, pages_per_seq: int, page_size: int):
    """(splits, span) of the ragged kernel's key-range split, from shapes
    alone (never from ``kv_lens``, ``row_lens`` or the block map, which live
    on the device: reading them would synchronise the host and break
    CUDA-graph capture). Only a row of at most ``RAGGED_QB`` queries splits,
    so at most min(T/RAGGED_QB, R) rows split; the plan is ``split_plan``'s
    for that many rows: ``splits`` span slots a row and the least span,
    ``span`` tokens (at least ``SPLIT_MIN_SPAN``, a multiple of
    ``SPLIT_QUANTUM``), ``splits * span`` covering the table's
    ``pages_per_seq * page_size`` tokens. The kernel decides on the device
    which rows split and into how many of the slots (spans of ``span``
    tokens or wider): those whose keys exceed 3 spans and a span past the
    launch's longest prefill chunk. At the engine's shapes (T 312, R 8,
    Hkv 8, 129 pages of 16) that is 9 slots of 256 tokens."""
    return split_plan(max(1, min(t // RAGGED_QB, n_rows)), hkv, pages_per_seq, page_size)


def ragged_partial_sizes(n_rows: int, hkv: int, splits: int, groups: int, head_dim: int):
    """(acc, m) element counts of the ragged kernel's f32 partials for a
    split plan: acc [R, Hkv, S, RAGGED_QB, G, D], m and l [R, Hkv, S,
    RAGGED_QB, G] each; none when nothing splits (S = 1)."""
    if splits == 1:
        return 0, 0
    n_ml = n_rows * hkv * splits * RAGGED_QB * groups
    return n_ml * head_dim, n_ml


def ragged_layout(row_lens, q_block: int = RAGGED_QB, total: Optional[int] = None):
    """Host-side layout of a ragged batch: returns (row_starts [R],
    block_rows [NB], block_q0 [NB], t_pad) as numpy int32, with every row's
    flat segment aligned to ``q_block`` (the kernel's one-row-per-q-block
    contract). ``total`` pads the flat token axis to a fixed size; blocks
    not owned by any row carry -1."""
    lens = np.asarray(row_lens, np.int32)
    starts = np.zeros(lens.shape[0], np.int32)
    off = 0
    for r, n in enumerate(lens):
        starts[r] = off
        if n > 0:
            off += -(-int(n) // q_block) * q_block
    t_pad = -(-max(off, 1) // q_block) * q_block
    if total is not None:
        if total < t_pad:
            raise ValueError(
                "ragged layout needs {} tokens but total={}".format(t_pad, total)
            )
        t_pad = -(-int(total) // q_block) * q_block
    nb = t_pad // q_block
    block_rows = np.full(nb, -1, np.int32)
    block_q0 = np.zeros(nb, np.int32)
    for r, n in enumerate(lens):
        if n <= 0:
            continue
        b0 = int(starts[r]) // q_block
        for j in range(-(-int(n) // q_block)):
            block_rows[b0 + j] = r
            block_q0[b0 + j] = j * q_block
    return starts, block_rows, block_q0, int(t_pad)


# the CUDA kernel turns each query's ancestor list into a 64-bit mask of
# in-row offsets, read once per query (csrc/ragged_paged_attention.cu)
KERNEL_MAX_TREE_WIDTH = 64


def tree_ancestors(parents, n_nodes=None, *, width=None):
    """Host-side tree mask metadata for a draft-tree verify row: per-node
    ancestor lists (the reference's ``tree_ancestors``).

    ``parents`` [N] int32 with ``parents[0] == -1`` and ``parents[j] < j``
    (``llm.spec_proposer.DraftForest`` layout). Returns ``[N, width]``
    int32 where row j lists the in-row indices of node j's root-to-node
    path, itself included, -1 padded. ``width`` defaults to N (the deepest
    possible chain). Dead nodes (>= ``n_nodes``) get all -1 rows: they
    still mask causally but match no ancestor, so they attend history only.

    ``anc[t, 0] == -2`` is the plain-causal sentinel of the attention
    functions; this function never emits it (the engine stamps it on every
    token outside a tree row)."""
    parents = np.asarray(parents, np.int32)
    n = parents.shape[0]
    live = n if n_nodes is None else int(n_nodes)
    w = n if width is None else int(width)
    out = np.full((n, w), -1, np.int32)
    for j in range(live):
        chain = []
        node = j
        while node >= 0:
            chain.append(node)
            node = int(parents[node])
        if len(chain) > w:
            raise ValueError(
                "tree depth {} exceeds ancestor width {}".format(len(chain), w))
        out[j, : len(chain)] = chain[::-1]
    return out


def ragged_paged_attention_ref(q, k_pool, v_pool, page_table, kv_lens,
                               row_starts, row_lens, k_scale=None, v_scale=None,
                               tree_anc=None):
    """Plain PyTorch version (the reference's ``ragged_paged_attention_xla``).

    Returns [T, Hkv, G, D] with zeros at tokens no row owns. Each token's
    causal bound selects the keys of its row's gathered pages; the attention
    itself is the decode version's (``_attend``), so a decode row's output
    is bitwise the decode plain version's on the same operands.

    ``tree_anc`` ([T, DMAX] int32) prunes draft-tree verify rows inside the
    causal bound: a token attends its row's history plus the in-row indices
    listed in its row of ``tree_anc``; ``tree_anc[t, 0] == -2`` keeps token
    t plain causal (the ``tree_ancestors`` layout)."""
    t = q.shape[0]
    dev = q.device
    t_idx = torch.arange(t, device=dev)
    starts = row_starts.long()
    ends = starts + row_lens.long()
    in_row = (t_idx[None, :] >= starts[:, None]) & (t_idx[None, :] < ends[:, None])  # [R, T]
    tok_valid = in_row.any(dim=0)
    tok_row = in_row.to(torch.uint8).argmax(dim=0)                                   # first row
    kv = kv_lens.long()
    qi = t_idx - starts[tok_row]
    base = (kv - row_lens.long())[tok_row]
    bound = torch.where(tok_valid, torch.minimum(base + qi + 1, kv[tok_row]), 0)     # [T]
    k = _gather_rows(k_pool, k_scale, page_table, q.dtype)[:, tok_row]              # [Hkv,T,C,D]
    v = _gather_rows(v_pool, v_scale, page_table, q.dtype)[:, tok_row]
    cap = torch.arange(k.shape[2], device=dev)[None, :]
    valid = cap < bound[:, None]                                                     # [T, C]
    if tree_anc is not None:
        off = cap - base[:, None]
        anc = (off[:, :, None] == tree_anc.long()[:, None, :]).any(dim=-1)
        plain = (tree_anc[:, 0] == -2)[:, None]
        valid = valid & (plain | (off < 0) | anc)
    return _attend(q, k, v, valid)


def check_ragged_gates(q, k_pool, v_pool, page_table, kv_lens, row_starts, row_lens,
                       block_rows=None, block_q0=None, k_scale=None, v_scale=None,
                       tree_anc=None) -> None:
    """Raise ``ValueError`` naming the gate when the CUDA ragged kernel does
    not take these operands; it reads no tensor values."""
    kernel = "ragged_paged_attention"

    def need(cond, gate, detail):
        _need(cond, gate, detail, kernel)

    need(block_rows is not None and block_q0 is not None, "block_map",
         "the kernel needs the host-built q-block map block_rows/block_q0 (ragged_layout)")
    quantized = _check_heads_and_pools(q, k_pool, v_pool, k_scale, v_scale, kernel)
    t = q.shape[0]
    need(t % RAGGED_QB == 0, "q_block",
         "the flat token count {} must be a multiple of RAGGED_QB={}".format(t, RAGGED_QB))
    r = page_table.shape[0] if page_table.dim() == 2 else -1
    need(page_table.dim() == 2 and page_table.dtype == torch.int32, "page_table",
         "page_table must be int32 [R, PP], got {} {}".format(
             page_table.dtype, tuple(page_table.shape)))
    for name, x in (("kv_lens", kv_lens), ("row_starts", row_starts), ("row_lens", row_lens)):
        need(tuple(x.shape) == (r,) and x.dtype == torch.int32, name,
             "{} must be int32 [R={}], got {} {}".format(name, r, x.dtype, tuple(x.shape)))
    for name, x in (("block_rows", block_rows), ("block_q0", block_q0)):
        need(tuple(x.shape) == (t // RAGGED_QB,) and x.dtype == torch.int32, "block_map",
             "{} must be int32 [T/RAGGED_QB={}], got {} {}".format(
                 name, t // RAGGED_QB, x.dtype, tuple(x.shape)))
    operands = [q, k_pool, v_pool, page_table, kv_lens, row_starts, row_lens, block_rows,
                block_q0]
    if tree_anc is not None:
        need(tree_anc.dtype == torch.int32 and tree_anc.dim() == 2
             and tree_anc.shape[0] == t
             and 1 <= tree_anc.shape[1] <= KERNEL_MAX_TREE_WIDTH, "tree_anc",
             "tree_anc must be int32 [T={}, DMAX] with 1 <= DMAX <= {}, got {} {}".format(
                 t, KERNEL_MAX_TREE_WIDTH, tree_anc.dtype, tuple(tree_anc.shape)))
        operands.append(tree_anc)
    if quantized:
        operands += [k_scale, v_scale]
    _check_placement(operands, kernel)


def ragged_paged_attention(q, k_pool, v_pool, page_table, kv_lens, row_starts, row_lens, *,
                           block_rows: Optional[torch.Tensor] = None,
                           block_q0: Optional[torch.Tensor] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           tree_anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged paged attention over mixed rows, ``[T, Hkv, G, D]`` in q's
    dtype.

    CPU tensors take ``ragged_paged_attention_ref`` (which needs no block
    map and packs rows densely or aligned alike); CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise. The kernel
    reads the row map through ``block_rows``/``block_q0``, and a short
    row's block through ``row_starts`` (``ragged_layout``'s). On CUDA a call
    is two grids, the attention (short rows' keys split by
    ``ragged_split_plan``) and the combine of the split rows' f32 partials,
    and counts one launch. ``tree_anc`` ([T, DMAX] int32,
    ``tree_ancestors`` layout, -2 in column 0 for plain-causal tokens)
    selects the kernel's draft-tree mask; it is counted in ``.launches``
    like any other launch, and in ``.tree_launches`` besides."""
    if k_pool.dtype == torch.int8 and k_scale is None:
        raise ValueError("int8 KV pools need k_scale/v_scale operands (per-token dequant)")
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, k_pool, v_pool, page_table, kv_lens,
                                          row_starts, row_lens, k_scale, v_scale, tree_anc)
    if q.device.type != "cuda":
        raise ValueError("ragged_paged_attention runs on cuda or cpu, got {}".format(q.device))
    check_ragged_gates(q, k_pool, v_pool, page_table, kv_lens, row_starts, row_lens,
                       block_rows, block_q0, k_scale, v_scale, tree_anc)
    t, hkv, g, d = q.shape
    _, n_pages, page_size, _ = k_pool.shape
    n_rows, pages_per_seq = page_table.shape
    splits, span = ragged_split_plan(t, n_rows, hkv, pages_per_seq, page_size)
    out = torch.empty_like(q)
    # the f32 partials in one buffer: acc, then m and l (one allocation: the
    # wrapper's host time is part of every eager ragged step)
    n_acc, n_ml = ragged_partial_sizes(n_rows, hkv, splits, g, d)
    part = acc = m = l = None
    if n_acc:
        part = torch.empty(n_acc + 2 * n_ml, dtype=torch.float32, device=q.device)
        acc = part.data_ptr()
        m, l = acc + 4 * n_acc, acc + 4 * (n_acc + n_ml)
    quantized = k_pool.dtype == torch.int8
    rc = load_library().tpu_torch_ragged_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        page_table.data_ptr(), kv_lens.data_ptr(), row_starts.data_ptr(), row_lens.data_ptr(),
        block_rows.data_ptr(), block_q0.data_ptr(),
        tree_anc.data_ptr() if tree_anc is not None else None, out.data_ptr(), acc, m, l,
        t // RAGGED_QB, hkv, g, d, n_pages, page_size, pages_per_seq, n_rows, int(quantized),
        tree_anc.shape[1] if tree_anc is not None else 0, splits, span,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError("ragged_paged_attention kernel launch failed: cudaError {}".format(rc))
    launch_counts.add(ragged_paged_attention)
    if tree_anc is not None:
        launch_counts.add(ragged_paged_attention, attr="tree_launches")
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.tree_launches = 0
ragged_paged_attention.setup_launches = 0
