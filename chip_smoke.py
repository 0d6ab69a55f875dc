#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100 SXM).

    python3 chip_smoke.py

Drives the port (``clearml_serving_tpu_torch``) phase by phase; any failure
exits non-zero before the result lines are printed:

1. the card's name and power limit, torch / CUDA / nvcc versions;
2. builds the CUDA kernels from ``clearml_serving_tpu_torch/csrc`` (set-up
   time, printed with the compiler's register report);
3. holds the paged decode kernel (the key-range split and its combine)
   against its plain PyTorch version on the card at the main path's shapes
   (bf16 and int8 pools), and times it in CUDA-graph replays and eagerly
   at 8 rows x 1024 and x 2048 tokens and at mixed lengths, beside its
   bound, the plain version (at 8 x 1024) and, as a yardstick that reads no
   page table, SDPA over the same K/V gathered contiguous;
3b. the same for the ragged kernel over mixed rows (decode, prefill chunks
   at history 0 and mid-history, idle rows, multi-step pads, page-crossing
   tails; P 16/32, G 4/8, D 64/128, bf16/int8), timed at a mixed shape and
   a prefill shape;
   Then the ragged kernel's draft-tree mask (``tree_anc``): chain, forest
   and dead-node verify rows of k+1 = 5 tokens beside decode rows and a
   chunk, at phase 5d's verify launch (no chunk, no row long enough to
   split) and at the same launch with longer rows (every row's keys
   split), bf16 and int8, against the plain version (a chain must give the
   unmasked launch's bits), timed beside the same launch without the mask
   and, at the verify launches, beside it with its key-range split off;
3c. the w4a16 matmul kernel against its plain version at every Llama-3-8B
   projection shape, M 1 and 8 (the decode tiling), 312 (the ragged flat
   axis) and 2048 (the longest prefill bucket; not the lm_head, which a
   prefill runs on the last row only; both through the block tiling), two
   calls giving the same bits, timed beside its bound, the plain version, a
   bf16 ``torch.matmul`` on the dequantized weight and PyTorch's
   ``_weight_int4pack_mm``; then summed over one decode step's 225 calls
   at M = 8 and one ragged step's 224 projection calls at M = 312;
4. a small model on the card against the same weights in float32 on the CPU
   (prefill + paged decode logits, bf16 and int8 KV);
4b. the same model's ``forward_ragged`` over mixed batches;
4c. 4 and 4b again on int4 weights (the same packed codes on both sides);
4d. the same model's ``forward_ragged`` with chain and forest verify rows
   (last-token and per-position verify logits);
5. the main path: Llama-3-8B at full width (32 layers, dim 4096, bf16,
   random weights from a seed) behind the port's HTTP server, a paged KV
   cache (max_batch 8, max_seq_len 2048, page_size 16, decode_steps 4),
   four concurrent chat completions (two streaming) with bf16 KV, then again
   with int8 KV on the same weights; every kernel of the path must have
   launched (paged attention: once per layer per decode step);
5b. the ragged main path: the same server under ``scheduler: ragged``
   (step_token_budget 256), four staggered chats with 600-1500-token
   prompts, bf16 then int8 KV: mixed launches must have run, the ragged
   kernel once per layer per ragged step, the decode kernel once per layer
   per decode step and chained ragged window step;
5c. the w4a16 main path: the same weights quantized to group-int4 on the
   card (``weight_quant: int4``, bf16 KV) under phase 5's traffic with two
   of its prompts swapped for long ones (prefill buckets 1024 and 2048),
   then phase 5b's: the int4 kernel once per projection per forward call (7
   per layer and the lm_head) and ``health()["weights"]``; then a short
   two-dispatch run on int8 weights;
5d. speculative verify rows: the same server under ``scheduler: ragged``
   with ``speculation: ngram``, ``spec_k`` 4, four staggered repetitive
   chats (one at temperature 0.7): a plain ragged arm, a chain arm, a tree
   arm (``spec_branch`` 2) on bf16 KV, a plain and a tree arm on int8 KV; verify
   rows and tree depths must show, the ragged kernel once per layer per
   ragged step, its tree variant once per layer per verify step; decode
   tokens per launch, TTFT and tokens/s per arm, and whether the greedy
   streams equal the plain arm's (reported, not asserted; where a greedy
   stream leaves the plain arm's, the top-2 logit margin at that token);
5e. pipelined decode: one decode chunk (8 rows at 0-1500 tokens, 4 steps)
   captured into a CUDA graph and replayed must equal the eager chunk on a
   clone of its pools bit for bit, tokens and pages, for bf16 and int8 KV
   and int4 weights, greedy and sampled (a replay counts n_layers x 4
   decode-attention and 225 x 4 int4 launches, a capture none); then phase
   5's traffic and a steadier one (eight chats of 128 tokens) at depth 1
   (serial, eager) and depth 2 (graphs captured by the endpoint's
   ``warmup``): equal greedy contents, no capture while serving, and each
   arm's wall ms per decode step, dispatch and retire ms and tok/s;
6. where the time goes: one profiled pass of each scheduler (bf16 KV; the
   two-dispatch path at depth 2 and at depth 1), one of phase 5d's tree arm
   and one of the two-dispatch path on int4 weights;
7. the request lifecycle of the default route: Llama-3-8B at full width
   behind the HTTP app (bf16 KV, depth 2 with graphs, max_batch 8) with the
   reference's default lifecycle knobs (max_pending 32, a 30 s watchdog,
   preemption, brownout). 8 batch-class chats at 128 tokens alone, then with
   an interactive arrival (a preemption; every batch content must equal its
   unpreempted run), then on an engine with preemption off (the
   interactive TTFT with and without preemption); 40 concurrent chats at 16
   tokens (200s and 429s, each 429 with Retry-After and ``code:
   overloaded``, beside the observed admission drain rate); a 1 ms TTFT
   budget on a 2048-bucket prompt (408) and a 1 s ``timeout`` that cuts a
   stream (an SSE error event); the drain with 4 streams in flight (new
   chats 503 ``draining``, the streams finish, every page back); on an
   engine with a 2 s watchdog, a 6 s retire stall injected while 4 chats
   have chunks in flight (503 ``engine_stalled``, /ready 503 then 200, free
   pages and the next chat's content as before the trip). The decode kernel
   once per layer per decode step of the default engine's traffic.

The last three lines of standard output are the card line, the ``kernels``
JSON line (every kernel, and the ragged kernel's tree variant) and
``{"ok": true, "device": {...}}``. Timings are CUDA-event
times on the card; ``bound_ms`` is computed from this run's operands.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import torch

CARD_BW = 3.35e12          # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
CARD_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
TOL = 2e-2                 # bf16 output rounding + another summation order
# the card; the phases take it from here, so a rehearsal can set "cpu"
DEV = "cuda"


def log(*parts) -> None:
    print(*parts, flush=True)


def sync() -> None:
    if torch.device(DEV).type == "cuda":
        torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernel vs plain version ------------------------------------------


def paged_operands(gen, *, lengths, hkv=8, g=4, d=128, page_size=16, pp=129,
                   quant=False, layers=1):
    """Random operands shaped like one decode step of the main path: pools
    of ``layers`` layers (so timing can rotate through more than L2 holds),
    a page table whose entries past each length are random page ids."""
    from clearml_serving_tpu_torch.models.llama import kv_store

    dev = torch.device(DEV)
    b = len(lengths)
    n = b * pp + 1
    q = torch.randn(b, hkv, g, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(layers, hkv, n, page_size, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(layers, hkv, n, page_size, d, generator=gen, device=dev).bfloat16()
    ks = vs = None
    if quant:
        k, ks = kv_store(k, "int8", torch.bfloat16)
        v, vs = kv_store(v, "int8", torch.bfloat16)
    perm = torch.randperm(n - 1, generator=gen, device=dev).int() + 1
    table = perm.reshape(b, pp).clone()
    for i, length in enumerate(lengths):
        live = -(-int(length) // page_size)
        table[i, live:] = torch.randint(0, n, (pp - live,), generator=gen,
                                        device=dev, dtype=torch.int32)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table,
                lengths=torch.tensor(lengths, dtype=torch.int32, device=dev))


def layer_args(ops, li=0):
    kw = {}
    if ops["ks"] is not None:
        kw = {"k_scale": ops["ks"][li], "v_scale": ops["vs"][li]}
    return (ops["q"], ops["k"][li], ops["v"][li], ops["table"], ops["lengths"]), kw


def check_kernel(ops, label) -> float:
    """Kernel vs the plain version in f32 on the same operands; a second
    launch with every table entry past the lengths poisoned (out of range)
    must give the same bits, so those entries are never read."""
    from clearml_serving_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_ref,
    )

    (q, k, v, table, lengths), kw = layer_args(ops)
    out = paged_attention(q, k, v, table, lengths, **kw)
    quant = ops["ks"] is not None
    ref = paged_attention_ref(q.float(), k if quant else k.float(),
                              v if quant else v.float(), table, lengths, **kw)
    out2 = out
    if q.is_cuda:  # the plain version gathers every entry; the kernel must not
        poisoned = table.clone()
        page_size = k.shape[2]
        for i, length in enumerate(lengths.tolist()):
            poisoned[i, -(-length // page_size):] = 2 ** 30
        out2 = paged_attention(q, k, v, poisoned, lengths, **kw)
    sync()
    err = float((out.float() - ref).abs().max())
    ok = torch.allclose(out.float(), ref, rtol=TOL, atol=TOL)
    zero_rows = [i for i, n in enumerate(lengths.tolist()) if n == 0]
    log("  {:<44} max_abs_err {:.3e}  {}".format(label, err, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("paged_attention disagrees with its plain version: " + label)
    if not torch.equal(out, out2):
        raise AssertionError("paged_attention read page-table entries past a length")
    if zero_rows and not torch.equal(out[zero_rows], torch.zeros_like(out[zero_rows])):
        raise AssertionError("zero-length rows are not zeros")
    return err


def time_launches(fn, n_layers, iters) -> float:
    """Mean ms per call, rotating through the layers' pools (the previous
    calls' reads evict most of a layer from L2, as in a decode step)."""
    for li in range(n_layers):
        fn(li)
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_layers)
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def time_graph(fn, n_layers, iters) -> float:
    """Mean ms per call of ``iters`` calls captured in one CUDA graph and
    replayed: device time without the host's per-call cost (an int4 decode
    call is shorter than its wrapper's Python work, so ``time_launches``
    would time the host). Rotates through the layers' operands as
    ``time_launches`` does."""
    for li in range(n_layers):
        fn(li)
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_layers)
    graph.replay()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    sync()
    del graph
    return start.elapsed_time(end) / iters


def bound(ops):
    """(ms, "bytes" | "operations"): least time for the function on these
    operands: each input byte the function needs read once (q, the live
    tokens' K/V rows and scales, their page-table entries, the lengths), the
    output written once, over the card's memory rate; or its FLOPs (QK and
    PV, 4*G*D per live token and head) over the bf16 peak; whichever is
    larger."""
    q, k = ops["q"], ops["k"]
    b, hkv, g, d = q.shape
    page_size = k.shape[3]
    live = int(ops["lengths"].sum())
    pages = sum(-(-n // page_size) for n in ops["lengths"].tolist())
    kv = 2 * live * hkv * d * k.element_size()
    scales = 2 * live * hkv * 4 if ops["ks"] is not None else 0
    io = 2 * q.numel() * q.element_size() + pages * 4 + b * 4
    nbytes = kv + scales + io
    flops = 4 * g * d * live * hkv
    t_bytes, t_ops = nbytes / CARD_BW, flops / CARD_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(gen) -> dict:
    from clearml_serving_tpu_torch.ops.paged_attention import (
        paged_attention, paged_attention_ref,
    )

    log("phase 3: paged_attention kernel vs plain version (atol=rtol={})".format(TOL))
    mixed = [0, 1, 17, 1024, 2048, 700, 1500, 64]
    err_bf16 = max(
        check_kernel(paged_operands(gen, lengths=mixed), "bf16 B8 Hkv8 G4 D128 P16 mixed"),
        check_kernel(paged_operands(gen, lengths=mixed, d=64),
                     "bf16 B8 Hkv8 G4 D64 P16 mixed"),
        check_kernel(paged_operands(gen, lengths=[1024] * 8),
                     "bf16 B8 Hkv8 G4 D128 P16 8x1024"),
        check_kernel(paged_operands(gen, lengths=[2048] * 8),
                     "bf16 B8 Hkv8 G4 D128 P16 8x2048"),
    )
    err_int8 = max(
        check_kernel(paged_operands(gen, lengths=mixed, quant=True),
                     "int8 B8 Hkv8 G4 D128 P16 mixed"),
        check_kernel(paged_operands(gen, lengths=mixed, page_size=32, pp=65, g=8,
                                    quant=True), "int8 B8 Hkv8 G8 D128 P32 mixed"),
        check_kernel(paged_operands(gen, lengths=[1024] * 8, quant=True),
                     "int8 B8 Hkv8 G4 D128 P16 8x1024"),
        check_kernel(paged_operands(gen, lengths=[2048] * 8, quant=True),
                     "int8 B8 Hkv8 G4 D128 P16 8x2048"),
    )
    timings = {}
    layers = 4
    for quant in (False, True):
        for case, lengths in PAGED_CASES.items():
            ops = paged_operands(gen, lengths=lengths, quant=quant, layers=layers)

            def kernel(li, ops=ops):
                args, kw = layer_args(ops, li)
                paged_attention(*args, **kw)

            def plain(li, ops=ops):
                args, kw = layer_args(ops, li)
                paged_attention_ref(*args, **kw)

            before = paged_attention.launches
            graph_ms = time_graph(kernel, layers, 200)
            eager_ms = time_launches(kernel, layers, 200)
            plain_ms = time_launches(plain, layers, 10) if case == "8x1024" else None
            paged_attention.launches = before   # timing launches are not the main path's
            name = "{}_{}".format("int8" if quant else "bf16", case)
            b_ms, b_by = bound(ops)
            timings[name] = dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                                 bound_ms=b_ms, bound_by=b_by, share=b_ms / graph_ms,
                                 sdpa_gathered_ms=sdpa_yardstick(ops, layers))
            log("  {}: graph_ms {:.4f}  eager_ms {:.4f}  plain_ms {}  bound_ms {:.5f} "
                "({:.1f}% of bound)  sdpa over gathered K/V {}".format(
                    name, graph_ms, eager_ms,
                    "{:.4f}".format(plain_ms) if plain_ms is not None else "-", b_ms,
                    100 * b_ms / graph_ms, timings[name]["sdpa_gathered_ms"]))
            del ops
            torch.cuda.empty_cache()
    return dict(err_bf16=err_bf16, err_int8=err_int8, timings=timings)


# phase 3's timed batches: every row at 1024 and at 2048 tokens, and mixed lengths
PAGED_CASES = {"8x1024": [1024] * 8, "8x2048": [2048] * 8,
               "mixed": [0, 1, 17, 1024, 2048, 700, 1500, 64]}


def sdpa_yardstick(ops, n_layers):
    """A yardstick, not the same function: ms of one
    ``scaled_dot_product_attention`` call over the same K/V already gathered
    contiguous (dequantized to bf16 for int8 pools), so it reads no page
    table; the port never calls it. Timed in a CUDA graph over the layers.
    None for batches of unequal lengths (they would need a mask)."""
    lengths = ops["lengths"].tolist()
    if len(set(lengths)) != 1:
        return None
    q = ops["q"]
    b, hkv, g, d = q.shape
    page_size = ops["k"].shape[3]
    pages = ops["table"][:, : -(-lengths[0] // page_size)].long()
    qq = q.reshape(b, hkv * g, 1, d)
    kv = []
    for li in range(n_layers):
        pair = []
        for pool, scale in ((ops["k"][li], ops["ks"]), (ops["v"][li], ops["vs"])):
            rows = pool[:, pages].reshape(hkv, b, -1, d)
            if scale is not None:
                rows = (rows.float() * scale[li][:, pages].reshape(hkv, b, -1, 1)).bfloat16()
            pair.append(rows.transpose(0, 1)[:, :, : lengths[0]].contiguous())
        kv.append(pair)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_graph(lambda li: sdpa(qq, kv[li][0], kv[li][1], enable_gqa=True), n_layers, 200)
    del kv
    return ms


# -- phase 3b: ragged kernel vs plain version -------------------------------------


def ragged_operands(gen, rows, *, hkv=8, g=4, d=128, page_size=16, quant=False, layers=1,
                    unowned_blocks=0, flat=None, pages_per_seq=None):
    """Random operands of one ragged launch. ``rows``: (span on the flat
    axis, query tokens, history before them) per row; a span longer than
    its queries is a multi-step decode row whose positions 1.. are pads.
    ``unowned_blocks`` q blocks no row owns close the flat axis, or q
    blocks no row owns pad it to ``flat`` tokens. The page table has
    ``pages_per_seq`` columns (default: one more than the longest row
    needs); entries past each row's kv_len are random page ids."""
    from clearml_serving_tpu_torch.models.llama import kv_store
    from clearml_serving_tpu_torch.ops.paged_attention import RAGGED_QB, ragged_layout

    dev = torch.device(DEV)
    r = len(rows)
    spans = [s for s, _, _ in rows]
    starts, block_rows, block_q0, t_pad = ragged_layout(spans, RAGGED_QB, total=flat)
    block_rows = list(block_rows) + [-1] * unowned_blocks
    block_q0 = list(block_q0) + [0] * unowned_blocks
    t_pad += unowned_blocks * RAGGED_QB
    row_lens = [n for _, n, _ in rows]
    kv_lens = [n + h for _, n, h in rows]
    pp = pages_per_seq or -(-max(kv_lens) // page_size) + 1
    n_pages = r * pp + 1
    q = torch.randn(t_pad, hkv, g, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(layers, hkv, n_pages, page_size, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(layers, hkv, n_pages, page_size, d, generator=gen, device=dev).bfloat16()
    ks = vs = None
    if quant:
        k, ks = kv_store(k, "int8", torch.bfloat16)
        v, vs = kv_store(v, "int8", torch.bfloat16)
    table = (torch.randperm(n_pages - 1, generator=gen, device=dev).int() + 1).reshape(r, pp)
    for i, length in enumerate(kv_lens):
        live = -(-length // page_size)
        table[i, live:] = torch.randint(0, n_pages, (pp - live,), generator=gen, device=dev,
                                        dtype=torch.int32)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=dev)

    return dict(q=q, k=k, v=v, ks=ks, vs=vs, table=table.contiguous(), kv_lens=i32(kv_lens),
                starts=i32(starts), row_lens=i32(row_lens), block_rows=i32(block_rows),
                block_q0=i32(block_q0))


def ragged_args(ops, li=0, table=None):
    kw = {"block_rows": ops["block_rows"], "block_q0": ops["block_q0"]}
    if ops["ks"] is not None:
        kw.update(k_scale=ops["ks"][li], v_scale=ops["vs"][li])
    return (ops["q"], ops["k"][li], ops["v"][li],
            ops["table"] if table is None else table, ops["kv_lens"], ops["starts"],
            ops["row_lens"]), kw


def check_ragged(ops, label, tree_anc=None) -> float:
    """Ragged kernel vs the plain version in f32 on the same operands (with
    ``tree_anc``, both masked by it); tokens no row owns (multi-step pads,
    alignment pads, unowned blocks) must be exact zeros, and a second
    launch with every table entry past each row's kv_len poisoned must
    give the same bits."""
    from clearml_serving_tpu_torch.ops.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref,
    )

    args, kw = ragged_args(ops)
    q, k, v = args[:3]
    out = ragged_paged_attention(*args, **kw, tree_anc=tree_anc)
    quant = ops["ks"] is not None
    scales = {key: kw[key] for key in ("k_scale", "v_scale") if key in kw}
    ref = ragged_paged_attention_ref(q.float(), k if quant else k.float(),
                                     v if quant else v.float(), *args[3:], **scales,
                                     tree_anc=tree_anc)
    poisoned = ops["table"].clone()
    page_size = k.shape[2]
    for i, length in enumerate(ops["kv_lens"].tolist()):
        poisoned[i, -(-length // page_size):] = 2 ** 30
    args2, kw2 = ragged_args(ops, table=poisoned)
    out2 = ragged_paged_attention(*args2, **kw2, tree_anc=tree_anc)
    sync()
    owned = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    for s, n in zip(ops["starts"].tolist(), ops["row_lens"].tolist()):
        owned[s:s + n] = True
    err = float((out.float() - ref).abs().max())
    ok = torch.allclose(out.float(), ref, rtol=TOL, atol=TOL)
    log("  {:<52} max_abs_err {:.3e}  {}".format(label, err, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("ragged_paged_attention disagrees with its plain version: " + label)
    if not torch.equal(out, out2):
        raise AssertionError("ragged_paged_attention read page-table entries past a kv_len")
    if not torch.equal(out[~owned], torch.zeros_like(out[~owned])):
        raise AssertionError("tokens no row owns are not exact zeros: " + label)
    return err


def ragged_bound(ops, tree_anc=None):
    """(ms, "bytes" | "operations"): least time for the launch on these
    operands: each live row's K/V (and scales) up to its kv_len read once,
    q and out once, the live rows' table entries (and ``tree_anc``), over
    the memory rate; or 4*G*D*Hkv FLOPs per visible (query, key) pair (the
    causal pairs, a tree query's in-row pairs only its listed ancestors)
    over the bf16 peak; whichever is larger."""
    q, k = ops["q"], ops["k"]
    t, hkv, g, d = q.shape
    page_size = k.shape[3]
    rows = [(kv, n, s) for kv, n, s in zip(ops["kv_lens"].tolist(), ops["row_lens"].tolist(),
                                           ops["starts"].tolist()) if n]
    live = sum(kv for kv, _, _ in rows)
    kv_bytes = 2 * live * hkv * d * k.element_size()
    scales = 2 * live * hkv * 4 if ops["ks"] is not None else 0
    io = 2 * q.numel() * q.element_size() + 4 * sum(-(-kv // page_size) for kv, _, _ in rows)
    causal = sum((kv - n) * n + n * (n + 1) // 2 for kv, n, _ in rows)
    if tree_anc is not None:
        io += tree_anc.numel() * 4
        anc = tree_anc.cpu()
        for _kv, n, s in rows:
            for i in range(n):
                if int(anc[s + i, 0]) != -2:
                    causal -= (i + 1) - int((anc[s + i] >= 0).sum())
    flops = 4 * g * d * hkv * causal
    t_bytes, t_ops = (kv_bytes + scales + io) / CARD_BW, flops / CARD_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# seven decode rows at kv_len 1024 and one 128-token chunk ending at 1024
RAGGED_MIXED = [(1, 1, 1023)] * 7 + [(128, 128, 896)]
# one 512-token chunk ending at 2048
RAGGED_PREFILL = [(512, 512, 1536)]


def phase_ragged_kernel(gen) -> dict:
    from clearml_serving_tpu_torch.ops.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref,
    )

    log("phase 3b: ragged_paged_attention kernel vs plain version (atol=rtol={})".format(TOL))
    # decode rows, a 4-token multi-step span (3 pads), chunks at history 0
    # and mid-history whose tails cross page boundaries, an idle row, a
    # chunk longer than two q blocks, two unowned blocks at the end
    mix = [(1, 1, 1023), (4, 1, 300), (37, 37, 0), (0, 0, 0), (19, 19, 77), (1, 1, 0),
           (130, 130, 517), (1, 1, 64)]
    cases = [
        ("bf16 G4 D128 P16", {}),
        ("bf16 G8 D128 P32", dict(g=8, page_size=32)),
        ("bf16 G4 D64 P32", dict(d=64, page_size=32)),
        ("bf16 G8 D64 P16", dict(g=8, d=64)),
        ("int8 G4 D128 P16", dict(quant=True)),
        ("int8 G8 D128 P32", dict(g=8, page_size=32, quant=True)),
        ("int8 G4 D64 P16", dict(d=64, quant=True)),
        ("int8 G8 D64 P32", dict(g=8, d=64, page_size=32, quant=True)),
    ]
    errs = {"bf16": 0.0, "int8": 0.0}
    for label, kw in cases:
        ops = ragged_operands(gen, mix, unowned_blocks=2, **kw)
        err = check_ragged(ops, "mixed rows " + label)
        name = "int8" if kw.get("quant") else "bf16"
        errs[name] = max(errs[name], err)
    for label, rows in (("mixed shape", RAGGED_MIXED), ("prefill shape", RAGGED_PREFILL)):
        for quant in (False, True):
            ops = ragged_operands(gen, rows, quant=quant)
            err = check_ragged(ops, "{} {} G4 D128 P16".format(label, "int8" if quant else "bf16"))
            name = "int8" if quant else "bf16"
            errs[name] = max(errs[name], err)
    timings = {}
    layers = 4
    for shape, rows, quants in (("mixed", RAGGED_MIXED, (False, True)),
                                ("prefill", RAGGED_PREFILL, (False,))):
        for quant in quants:
            ops = ragged_operands(gen, rows, quant=quant, layers=layers)

            def kernel(li, ops=ops):
                args, kw = ragged_args(ops, li)
                ragged_paged_attention(*args, **kw)

            def plain(li, ops=ops):
                args, kw = ragged_args(ops, li)
                kw.pop("block_rows")
                kw.pop("block_q0")
                ragged_paged_attention_ref(*args, **kw)

            before = ragged_paged_attention.launches
            args, kw = ragged_args(ops)
            once, again = ragged_paged_attention(*args, **kw), ragged_paged_attention(*args, **kw)
            sync()
            if not torch.equal(once, again):
                raise AssertionError("two ragged calls on the same inputs differ")
            graph_ms = time_graph(kernel, layers, 200)
            eager_ms = time_launches(kernel, layers, 100)
            plain_ms = time_launches(plain, layers, 4)
            ragged_paged_attention.launches = before  # not the main path's launches
            b_ms, b_by = ragged_bound(ops)
            key = "{}_{}".format(shape, "int8" if quant else "bf16")
            timings[key] = dict(ms=graph_ms, eager_ms=eager_ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by, share=b_ms / graph_ms)
            if shape == "prefill":
                timings[key]["sdpa_gathered_ms"] = sdpa_causal_yardstick(ops, layers)
            log("  {} shape {}: graph_ms {:.4f}  eager_ms {:.4f}  plain_ms {:.4f}  bound_ms "
                "{:.4f} ({})  ({:.1f}% of bound){}".format(
                    shape, "int8" if quant else "bf16", graph_ms, eager_ms, plain_ms, b_ms, b_by,
                    100 * b_ms / graph_ms,
                    "  sdpa over gathered K/V {}".format(timings[key]["sdpa_gathered_ms"])
                    if shape == "prefill" else ""))
            del ops
            torch.cuda.empty_cache()
    return dict(err_bf16=errs["bf16"], err_int8=errs["int8"], timings=timings)


def sdpa_causal_yardstick(ops, n_layers):
    """A yardstick, not the same function: ms of one
    ``scaled_dot_product_attention`` call with a lower-right causal mask
    (``torch.nn.attention.bias.causal_lower_right``) over one chunk row's
    K/V already gathered contiguous (bf16 pools only), so it reads no page
    table; the port never calls it. Timed in a CUDA graph over the layers;
    None (with the error) where the call is refused."""
    from torch.nn.attention.bias import causal_lower_right

    (kv_len,) = ops["kv_lens"].tolist()
    q = ops["q"]
    t, hkv, g, d = q.shape
    page_size = ops["k"].shape[3]
    pages = ops["table"][0, : -(-kv_len // page_size)].long()
    qq = q.reshape(1, t, hkv * g, d).transpose(1, 2)
    kv = [[pool[:, pages].reshape(hkv, -1, d)[None, :, :kv_len].contiguous()
           for pool in (ops["k"][li], ops["v"][li])] for li in range(n_layers)]
    mask = causal_lower_right(t, kv_len)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        return time_graph(lambda li: sdpa(qq, kv[li][0], kv[li][1], attn_mask=mask,
                                          enable_gqa=True), n_layers, 50)
    except Exception as exc:  # a yardstick only: record why it is missing
        log("  sdpa yardstick refused: {}".format(str(exc).splitlines()[0][:200]))
        return None


# a draft-tree launch with a chunk: four verify rows of k+1 = 5 tokens at
# 1024 history, three decode rows at 1024, one 128-token chunk ending at
# 1024 (no row's keys reach a span past the chunk's, so none splits)
RAGGED_TREE = [(5, 5, 1024)] * 4 + [(1, 1, 1023)] * 3 + [(128, 128, 896)]
# the verify launch of phase 5d's tree arm (its chats hold 300 to 550
# tokens): four verify rows of 5 and two decode rows, no chunk row, two idle
# rows (R 8), on the engine's table (129 pages of 16) and flat axis (312
# tokens): no row holds more than 3 spans' keys, so none splits
RAGGED_VERIFY = ([(5, 5, 300), (5, 5, 380), (5, 5, 460), (5, 5, 550), (1, 1, 420), (1, 1, 500)]
                 + [(0, 0, 0)] * 2)
# the same launch later in longer chats: every row splits, 6 long rows of 8
# heads into 2 spans each (of 512 to 768 keys)
RAGGED_VERIFY_LONG = ([(5, 5, 900), (5, 5, 1100), (5, 5, 1300), (5, 5, 1500), (1, 1, 1000),
                       (1, 1, 1400)] + [(0, 0, 0)] * 2)
VERIFY_LAYOUT = dict(flat=312, pages_per_seq=129)
# a verify row's topology as (parents, live nodes): a chain, the n-gram
# forest at spec_branch 2 (a depth-3 primary branch and one root sibling),
# and a tree whose last two nodes are dead (past its live nodes)
TREE_TOPOLOGIES = {"chain": ([-1, 0, 1, 2, 3], 5), "forest": ([-1, 0, 1, 2, 0], 5),
                   "dead_nodes": ([-1, 0, 0, -1, -1], 3)}
# (shape, rows, layout, topologies timed)
TREE_SHAPES = [("tree", RAGGED_TREE, {}, ("chain", "forest")),
               ("verify", RAGGED_VERIFY, VERIFY_LAYOUT, ("chain", "forest")),
               ("verify_long", RAGGED_VERIFY_LONG, VERIFY_LAYOUT, ("forest",))]


def tree_anc_for(ops, topology):
    """[T, k+1] ancestor lists: each verify row (5 query tokens) takes
    ``topology`` (parents, live nodes); decode and chunk tokens keep the -2
    plain-causal sentinel."""
    from clearml_serving_tpu_torch.ops.paged_attention import tree_ancestors

    parents, n_nodes = topology
    anc = torch.full((ops["q"].shape[0], len(parents)), -1, dtype=torch.int32)
    anc[:, 0] = -2
    row_anc = torch.from_numpy(tree_ancestors(parents, n_nodes, width=len(parents)))
    for s, n in zip(ops["starts"].tolist(), ops["row_lens"].tolist()):
        if n == len(parents):
            anc[s:s + n] = row_anc
    return anc.to(ops["q"].device)


@contextlib.contextmanager
def fixed_span(span=None):
    """Calls made inside run the ragged kernel with spans of ``span``
    tokens (a multiple of 64), or with its key-range split off (None: one
    span covering the whole table): a timing comparison only; the port
    always takes ``ragged_split_plan``."""
    from clearml_serving_tpu_torch.ops import paged_attention as pa

    plan = pa.ragged_split_plan

    def fixed(t, n_rows, hkv, pages_per_seq, page_size):
        capacity = pages_per_seq * page_size
        whole = -(-capacity // pa.SPLIT_QUANTUM) * pa.SPLIT_QUANTUM
        width = min(span or whole, whole)
        return max(1, -(-capacity // width)), width

    pa.ragged_split_plan = fixed
    try:
        yield
    finally:
        pa.ragged_split_plan = plan


TREE_PAIRS = 10  # alternating (masked, unmasked) graph replays per case


def graph_turns(fns, n_layers, iters, turns):
    """ms per call of each of ``fns``, each captured once in a CUDA graph
    of ``iters`` calls (rotating through the layers) and replayed in turns
    a, b, ..., a, b, ...: one list of ``turns`` times per function."""
    graphs = []
    for fn in fns:
        for li in range(n_layers):
            fn(li)
        sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(iters):
                fn(i % n_layers)
        graph.replay()
        graphs.append(graph)
    sync()
    times = tuple([] for _ in fns)
    for _ in range(turns):
        for graph, out in zip(graphs, times):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            graph.replay()
            end.record()
            sync()
            out.append(start.elapsed_time(end) / iters)
    del graphs
    return times


def phase_tree_kernel(gen) -> dict:
    """The ragged kernel's draft-tree mask at TREE_SHAPES: verify rows of
    every topology beside decode rows (and a chunk), bf16 and int8, against
    the plain version; a chain topology must give the plain-causal launch's
    bits. Then each timed launch is timed beside the same launch without
    the mask, the plain version and the bound, and at the verify shapes
    beside the same launch with its key-range split off."""
    from clearml_serving_tpu_torch.ops.paged_attention import (
        ragged_paged_attention, ragged_paged_attention_ref,
    )

    log("phase 3b (tree_anc): ragged kernel's draft-tree mask vs plain version "
        "(atol=rtol={})".format(TOL))
    errs = {"bf16": 0.0, "int8": 0.0}
    timings = {}
    layers = 4
    for shape, rows, layout, timed in TREE_SHAPES:
        for quant in (False, True):
            name = "int8" if quant else "bf16"
            for topo, topology in TREE_TOPOLOGIES.items():
                ops = ragged_operands(gen, rows, quant=quant, layers=layers, **layout)
                anc = tree_anc_for(ops, topology)
                errs[name] = max(errs[name], check_ragged(
                    ops, "{} shape {} {} G4 D128 P16".format(shape, topo, name), tree_anc=anc))
                args, kw = ragged_args(ops)
                if topo == "chain":
                    same = torch.equal(ragged_paged_attention(*args, **kw, tree_anc=anc),
                                       ragged_paged_attention(*args, **kw))
                    sync()
                    if not same:
                        raise AssertionError("a chain topology changed the kernel's bits: "
                                             + shape)
                if topo not in timed:
                    continue

                def kernel(li, ops=ops, anc=anc):
                    args, kw = ragged_args(ops, li)
                    ragged_paged_attention(*args, **kw, tree_anc=anc)

                def untree(li, ops=ops):
                    args, kw = ragged_args(ops, li)
                    ragged_paged_attention(*args, **kw)

                def unsplit(li):
                    with fixed_span():
                        kernel(li)

                def plain(li, ops=ops, anc=anc):
                    args, kw = ragged_args(ops, li)
                    kw.pop("block_rows")
                    kw.pop("block_q0")
                    ragged_paged_attention_ref(*args, **kw, tree_anc=anc)

                before = (ragged_paged_attention.launches, ragged_paged_attention.tree_launches)
                # the mask's cost: graph replays of the masked and the unmasked
                # launch in alternating pairs (their difference is smaller than
                # the spread of back-to-back timings)
                masked, unmasked = graph_turns((kernel, untree), layers, 100, TREE_PAIRS)
                kernel_ms, untree_ms = min(masked), min(unmasked)
                diffs = sorted(a - b for a, b in zip(masked, unmasked))
                row = dict(ms=kernel_ms, untree_ms=untree_ms,
                           mask_cost_ms=diffs[len(diffs) // 2],
                           mask_cost_spread_ms=[diffs[0], diffs[-1]])
                split_note = ""
                if shape.startswith("verify"):
                    # the split's worth on the verify launches: the same tree
                    # launch with one span, in alternating pairs
                    split, whole = graph_turns((kernel, unsplit), layers, 100, TREE_PAIRS)
                    gains = sorted(b - a for a, b in zip(split, whole))
                    row.update(one_span_ms=min(whole), split_gain_ms=gains[len(gains) // 2],
                               split_gain_spread_ms=[gains[0], gains[-1]])
                    split_note = ("; with one span {:.4f}, one span - split median {:.5f}, "
                                  "range {:.5f} .. {:.5f}".format(
                                      min(whole), gains[len(gains) // 2], gains[0], gains[-1]))
                eager_ms = time_launches(kernel, layers, 100)
                plain_ms = time_launches(plain, layers, 4)
                # not the main path's launches
                ragged_paged_attention.launches, ragged_paged_attention.tree_launches = before
                b_ms, b_by = ragged_bound(ops, anc)
                row.update(eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           share=b_ms / kernel_ms)
                timings["{}_{}_{}".format(shape, topo, name)] = row
                log("  {} shape {} {}: graph_ms {:.4f} (same launch without the mask {:.4f}; "
                    "masked - unmasked over {} alternating pairs: median {:.5f}, range {:.5f} "
                    ".. {:.5f}{})  eager_ms {:.4f}  plain_ms {:.4f}  bound_ms {:.4f} ({})  "
                    "({:.1f}% of bound)".format(
                        shape, topo, name, kernel_ms, untree_ms, len(diffs),
                        diffs[len(diffs) // 2], diffs[0], diffs[-1], split_note, eager_ms,
                        plain_ms, b_ms, b_by, 100 * b_ms / kernel_ms))
                del ops
                torch.cuda.empty_cache()
    return dict(err_bf16=errs["bf16"], err_int8=errs["int8"], timings=timings)


# -- phase 3c: the w4a16 matmul kernel vs plain version ---------------------------

# Llama-3-8B's projections as (K, N), with their calls per decode step (one
# forward over 32 layers: 7 projections per layer and the lm_head)
INT4_SHAPES = {
    "wq/wo": ((4096, 4096), 64),
    "wk/wv": ((4096, 1024), 64),
    "w_gate/w_up": ((4096, 14336), 64),
    "w_down": ((14336, 4096), 32),
    "lm_head": ((4096, 128256), 1),
}
INT4_PRIMARY = ("w_gate/w_up", 8)   # the kernels line's headline call
# one decode row; a decode batch; the shortest prefill bucket (the block
# tiling's 64-token instance); the ragged flat axis; the longest prefill
# bucket
INT4_ROWS = (1, 8, 64, 312, 2048)


def int4_rows(name, rows=INT4_ROWS):
    """The row counts the main path gives a projection: a prefill takes
    the lm_head on its last row only."""
    return [m for m in rows if name != "lm_head" or m <= 312]


def int4_bound(m, k, n, groups):
    """(ms, "bytes" | "operations"): least time for x [m, k] @ dequant(W
    [k, n]): the packed codes, the scales, x and the output each moved once
    over the memory rate, or 2*m*k*n operations over the bf16 peak."""
    nbytes = k * n // 2 + groups * n * 4 + m * k * 2 + m * n * 2
    t_bytes, t_ops = nbytes / CARD_BW, 2.0 * m * k * n / CARD_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_int4(x, qs):
    """PyTorch's own w4a16 product on the same function, or the error that
    refused it: ``_weight_int4pack_mm`` on the codes repacked by
    ``_convert_weight_to_int4pack`` ([N, K/2] uint8, even K in the high
    nibble) with zero offsets (it dequantizes (code - 8) * scale + zero).
    Returns (call(i) on copy i of the weights, None) or (None, error).
    Timed only; the port never calls it."""
    try:
        packed = []
        for q, s in qs:
            repacked = (((q & 0xF) << 4) | (q >> 4)).t().contiguous()
            sz = torch.stack([s, torch.zeros_like(s)], dim=-1).bfloat16().contiguous()
            packed.append((torch.ops.aten._convert_weight_to_int4pack(repacked, 8), sz,
                           2 * q.shape[0] // s.shape[0]))

        def call(i):
            w, sz, group = packed[i]
            return torch.ops.aten._weight_int4pack_mm(x, w, group, sz)

        call(0)
        return call, None
    except Exception as ex:  # the yardstick only: a refusal is recorded, not fatal
        return None, "{}: {}".format(type(ex).__name__, str(ex).splitlines()[0][:200])


def phase_int4_kernel(gen) -> dict:
    """Kernel vs the plain version computed in f32 on the same bf16 inputs
    at every projection shape and each of INT4_ROWS; then times at each:
    the kernel, the plain version as the card would run it (bf16 dequant,
    then torch.matmul), a bf16 torch.matmul on the dequantized weight and
    the library's int4 product, rotating through copies of the weights that
    together exceed the 50 MB L2. Device times come from CUDA-graph
    replays; ``eager_ms`` is the kernel called through its Python wrapper
    one call after another, the per-call cost the host-bound main path
    pays."""
    from clearml_serving_tpu_torch.ops.fused_matmul import (
        fused_int4_matmul, int4_matmul_plain,
    )
    from clearml_serving_tpu_torch.ops.quant import dequantize_int4, quantize_int4

    log("phase 3c: fused_int4_matmul kernel vs plain version (atol=rtol={})".format(TOL))
    dev = torch.device(DEV)
    err = 0.0
    timings = {}
    for name, ((k, n), _calls) in INT4_SHAPES.items():
        w = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
        q, s = quantize_int4(w)
        del w
        groups = s.shape[0]
        copies = max(2, -(-120_000_000 // (q.numel() + s.numel() * 4)))
        qs = [(q, s)] + [(q.clone(), s.clone()) for _ in range(copies - 1)]
        w_bf16 = dequantize_int4(q, s, torch.bfloat16)
        copies_bf16 = max(2, -(-120_000_000 // (w_bf16.numel() * 2)))
        ws = [w_bf16] + [w_bf16.clone() for _ in range(copies_bf16 - 1)]
        for m in int4_rows(name):
            x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
            out = fused_int4_matmul(x, q, s)
            again = fused_int4_matmul(x, q, s)
            ref = int4_matmul_plain(x.float(), q, s, torch.float32)
            sync()
            if not torch.equal(out, again):
                raise AssertionError("fused_int4_matmul gave other bits on a second call: "
                                     "{} M={}".format(name, m))
            e = float((out.float() - ref).abs().max())
            ok = bool(torch.isfinite(out).all()) and torch.allclose(out.float(), ref,
                                                                    rtol=TOL, atol=TOL)
            log("  {:<12} x[{}, {}] @ W[{}, {}]  max_abs_err {:.3e}  {}".format(
                name, m, k, k, n, e, "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("fused_int4_matmul disagrees with its plain version: "
                                     "{} M={}".format(name, m))
            err = max(err, e)
            del out, again, ref
            before = fused_int4_matmul.launches

            def kernel(i, x=x):
                fused_int4_matmul(x, *qs[i])

            def plain(i, x=x):
                int4_matmul_plain(x, *qs[i], torch.bfloat16)

            def bf16(i, x=x):
                torch.matmul(x, ws[i])

            iters = 400 if m <= 16 else 100 if m <= 512 else 20
            row = dict(ms=time_graph(kernel, copies, iters),
                       eager_ms=time_launches(kernel, copies, iters),
                       plain_ms=time_graph(plain, copies, max(4, copies)),
                       bf16_ms=time_graph(bf16, copies_bf16, iters))
            lib_call, lib_err = library_int4(x, qs)
            row["library_ms"] = None
            row["library_error"] = lib_err
            if lib_call is not None:
                got = lib_call(0).float()
                want = int4_matmul_plain(x.float(), q, s, torch.float32)
                lib_diff = float((got - want).abs().max())
                if torch.allclose(got, want, rtol=TOL, atol=TOL):
                    row["library_ms"] = time_graph(lib_call, copies, iters)
                else:
                    row["library_error"] = "disagrees with the plain version: max_abs_err " \
                                           "{:.3e}".format(lib_diff)
                del got, want
            fused_int4_matmul.launches = before
            row["bound_ms"], row["bound_by"] = int4_bound(m, k, n, groups)
            row["max_abs_err"] = e
            timings[(name, m)] = row
            log("    kernel_ms {ms:.4f} (eager {eager_ms:.4f})  plain_ms {plain_ms:.4f}  bf16_ms "
                "{bf16_ms:.4f}  library_ms {lib}  bound_ms {bound_ms:.4f} ({bound_by}, "
                "{share:.1f}% of bound){note}".format(
                    lib="{:.4f}".format(row["library_ms"]) if row["library_ms"] else "null",
                    share=100 * row["bound_ms"] / row["ms"],
                    note="  [library: {}]".format(lib_err or row["library_error"])
                    if row["library_error"] else "", **row))
            del x
        del qs, ws, q, s, w_bf16
        torch.cuda.empty_cache()
    # the 225 calls of one decode step at M = 8, from the per-shape times
    step = {key: sum(timings[(name, 8)][key] * calls
                     for name, (_shape, calls) in INT4_SHAPES.items())
            for key in ("ms", "eager_ms", "plain_ms", "bf16_ms", "bound_ms")}
    libs = [timings[(name, 8)]["library_ms"] for name in INT4_SHAPES]
    step["library_ms"] = (sum(t * calls for t, (_s, calls) in zip(libs, INT4_SHAPES.values()))
                          if all(t is not None for t in libs) else None)
    log("  one decode step's 225 calls at M=8: kernel {ms:.4f} ms (eager {eager_ms:.4f}; "
        "{share:.1f}% of bound), bound {bound_ms:.4f} ms, library {lib} ms, bf16 matmul "
        "{bf16_ms:.4f} ms, plain {plain_ms:.4f} ms".format(
            lib="{:.4f}".format(step["library_ms"]) if step["library_ms"] is not None
            else "null", share=100 * step["bound_ms"] / step["ms"], **step))
    # the 224 projection calls of one ragged step on the 312-token flat axis
    # (its lm_head runs on the rows' last tokens only)
    projections = [(name, calls) for name, (_shape, calls) in INT4_SHAPES.items()
                   if name != "lm_head"]
    ragged = {key: sum(timings[(name, 312)][key] * calls for name, calls in projections)
              for key in ("ms", "eager_ms", "plain_ms", "bf16_ms", "bound_ms")}
    libs = [timings[(name, 312)]["library_ms"] for name, _calls in projections]
    ragged["library_ms"] = (sum(t * calls for t, (_n, calls) in zip(libs, projections))
                            if all(t is not None for t in libs) else None)
    log("  one ragged step's 224 projection calls at M=312: kernel {ms:.4f} ms (eager "
        "{eager_ms:.4f}; {share:.1f}% of bound), bound {bound_ms:.4f} ms, library {lib} ms, "
        "bf16 matmul {bf16_ms:.4f} ms, plain {plain_ms:.4f} ms".format(
            lib="{:.4f}".format(ragged["library_ms"]) if ragged["library_ms"] is not None
            else "null", share=100 * ragged["bound_ms"] / ragged["ms"], **ragged))
    return dict(err=err, timings=timings, decode_step=step, ragged_step=ragged)


# -- phase 4: small model on the card vs float32 on the CPU ----------------------


SMALL_MODEL = {"vocab_size": 512, "dim": 512, "n_layers": 2, "n_heads": 8,
               "n_kv_heads": 4, "head_dim": 128, "ffn_dim": 1024, "rope_theta": 500000.0}


def _to(tree, device, dtype=None):
    """A parameter tree on ``device``; floating leaves cast to ``dtype``
    when given, quantized codes and scales moved as they are."""
    if isinstance(tree, dict):
        return {k: _to(v, device, None if k in ("_q4", "_scale4", "_q8", "_scale") else dtype)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device, dtype) for v in tree]
    return tree.to(device=device, dtype=dtype) if dtype is not None else tree.to(device)


def small_model_params(gen_seed: int, weight_quant: str = ""):
    """(bf16 weights on the card, the same values in float32 on the CPU);
    with ``weight_quant`` both sides hold the same quantized codes and
    scales, made from the bf16 values."""
    from clearml_serving_tpu_torch.models.llama import init_params
    from clearml_serving_tpu_torch.ops.quant import quantize_llama_params

    cpu_params = init_params(dict(SMALL_MODEL, dtype="float32"),
                             torch.Generator().manual_seed(gen_seed), device="cpu")
    card_params = _to(cpu_params, DEV, torch.bfloat16)
    ref_params = _to(card_params, "cpu", torch.float32)    # the same bf16 values
    if weight_quant:
        ref_params = quantize_llama_params(ref_params, bits=4 if weight_quant == "int4" else 8)
        card_params = _to(ref_params, DEV, torch.bfloat16)
    return card_params, ref_params


def int4_launches_per_forward(model) -> int:
    """fused_int4_matmul launches of one forward call of an int4 model on
    the card: 7 projections per layer and the lm_head (0 otherwise)."""
    if model.weight_quant != "int4" or model.device.type != "cuda":
        return 0
    return 7 * model.n_layers + 1


def check_int4_launches(model, launches: int, forwards: int, label: str) -> None:
    want = int4_launches_per_forward(model) * forwards
    if launches != want:
        raise AssertionError("{}: fused_int4_matmul launched {} times for {} forward calls "
                             "(want {})".format(label, launches, forwards, want))


def phase_small_model(gen_seed: int, weight_quant: str = "") -> None:
    """Prefill + 4 paged decode steps of a 2-layer model with head_dim 128
    (G=2) in bf16 on the card (paged attention kernel) against the same
    weights in float32 on the CPU (plain version). Teacher-forced on the
    CPU model's greedy tokens. Tolerance: 5% of the largest reference logit
    (bf16 activations round every op to 2**-8 relative, int8 K/V codes to
    1/254 of each vector's range), and the same top-1 token in 90% of rows;
    a wrong attention moves the logits by their own scale."""
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul

    if weight_quant:
        log("phase 4c: small model on {} weights, card (bf16, kernels) vs CPU (float32, "
            "plain versions)".format(weight_quant))
    else:
        log("phase 4: small model, card (bf16, kernel) vs CPU (float32, plain version)")
    base = SMALL_MODEL
    card_params, ref_params = small_model_params(gen_seed, weight_quant)
    for kv_quant in (("",) if weight_quant else ("", "int8")):
        cfg = dict(base, kv_quant=kv_quant)
        models = {
            "card": Llama(dict(cfg, dtype="bfloat16"), card_params),
            "cpu": Llama(dict(cfg, dtype="float32"), ref_params),
        }
        prompt = torch.randint(0, 256, (2, 40), generator=torch.Generator().manual_seed(1))
        lens = [40, 23]
        int4_before = fused_int4_matmul.launches
        logits = {}
        caches = {}
        for name, model in models.items():
            dev = model.device
            cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                                 num_pages=16, page_size=16, max_slots=2,
                                 dtype=model.dtype, kv_quant=kv_quant, device=dev)
            steps = []
            for slot, n in enumerate(lens):
                last, mini = model.prefill(prompt[slot:slot + 1].to(dev),
                                           torch.tensor([n], device=dev))
                scales = ((mini["k_scale"][:, 0, :n], mini["v_scale"][:, 0, :n])
                          if kv_quant else ())
                cache.write_prompt(slot, mini["k"][:, 0, :n], mini["v"][:, 0, :n], n,
                                   *scales)
                steps.append(last.float().cpu())
            logits[name] = [torch.cat(steps)]
            caches[name] = cache
        tokens = logits["cpu"][0].argmax(-1)
        for _step in range(4):
            for name, model in models.items():
                dev = model.device
                cache = caches[name]
                pool = cache.pool
                lengths0 = torch.as_tensor(pool.lengths().copy())
                wp, wo = [], []
                for slot in range(2):
                    start = pool.slot_length(slot)
                    pool.extend(slot, 1)
                    ((page, off),) = pool.token_coords(slot, start, 1)
                    wp.append(page)
                    wo.append(off)
                kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                      if kv_quant else {})
                out = model.decode_paged(
                    tokens.to(dev), cache.k, cache.v,
                    torch.as_tensor(pool.page_table(4), device=dev), lengths0.to(dev),
                    torch.tensor(wp, device=dev), torch.tensor(wo, device=dev), **kw,
                )
                logits[name].append(out.float().cpu())
            tokens = logits["cpu"][-1].argmax(-1)
        sync()
        # two prefills and four decode steps on the card
        int4_launches = fused_int4_matmul.launches - int4_before
        check_int4_launches(models["card"], int4_launches, len(lens) + 4, "phase 4c")
        card = torch.stack(logits["card"])
        ref = torch.stack(logits["cpu"])
        err = float((card - ref).abs().max())
        agree = float((card.argmax(-1) == ref.argmax(-1)).float().mean())
        finite = bool(torch.isfinite(card).all())
        log("  kv={:<5} logits max_abs_err {:.3e} (scale {:.2f}), top-1 agreement {:.2f}, "
            "fused_int4_matmul launches {}".format(kv_quant or "bf16", err,
                                                   float(ref.abs().max()), agree,
                                                   int4_launches))
        if not finite or err > 0.05 * float(ref.abs().max()) or agree < 0.9:
            raise AssertionError("small model on the card disagrees with the CPU reference")


def phase_small_ragged(gen_seed: int, weight_quant: str = "") -> None:
    """Three mixed ``forward_ragged`` steps of phase 4's model, bf16 on the
    card (ragged kernel, q-block aligned layout) against the same weights
    in float32 on the CPU (plain version, the same layout): decode rows at
    several histories, prefill chunks at history 0 and mid-history, an
    idle row. Histories are prefilled on each side; each later step's
    decode tokens are the CPU model's greedy tokens from the step before.
    The tolerance is phase 4's, 5% of the largest reference logit, and 0.9
    top-1 agreement over 33 rows, where a row agrees when the card's top
    token is the reference's or ties with it inside that tolerance: bf16
    activations (and int8 codes of bf16 vs f32 K/V, one apart at rounding
    ties) flip the odd near-tied row, and a flip inside the logit tolerance
    says nothing about the kernel. The strict agreement is printed beside
    it."""
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul
    from clearml_serving_tpu_torch.ops.paged_attention import RAGGED_QB, ragged_layout

    log("phase 4{}: small model forward_ragged{}, card (bf16, kernels) vs CPU "
        "(float32, plain versions)".format("c" if weight_quant else "b",
                                           " on {} weights".format(weight_quant)
                                           if weight_quant else ""))
    card_params, ref_params = small_model_params(gen_seed, weight_quant)
    # (history, query tokens per step): decode rows take one token a step
    rows = [(40, 1), (23, 1), (9, 1), (0, 20), (17, 12), (31, 1), (5, 9), (0, 0),
            (50, 1), (12, 1), (3, 6), (28, 1)]
    r = len(rows)
    prompt = torch.randint(0, 256, (r, 64), generator=torch.Generator().manual_seed(2))
    for kv_quant in (("",) if weight_quant else ("", "int8")):
        cfg = dict(SMALL_MODEL, kv_quant=kv_quant)
        int4_before = fused_int4_matmul.launches
        models = {
            "card": Llama(dict(cfg, dtype="bfloat16"), card_params),
            "cpu": Llama(dict(cfg, dtype="float32"), ref_params),
        }
        caches = {}
        for name, model in models.items():
            dev = model.device
            cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                                 num_pages=64, page_size=16, max_slots=r,
                                 dtype=model.dtype, kv_quant=kv_quant, device=dev)
            for slot, (hist, _n) in enumerate(rows):
                if hist:
                    _last, mini = model.prefill(prompt[slot:slot + 1, :hist].to(dev),
                                                torch.tensor([hist], device=dev))
                    scales = ((mini["k_scale"][:, 0], mini["v_scale"][:, 0])
                              if kv_quant else ())
                    cache.write_prompt(slot, mini["k"][:, 0], mini["v"][:, 0], hist, *scales)
            caches[name] = cache
        row_lens = [n for _h, n in rows]
        starts, block_rows, block_q0, t = ragged_layout(row_lens, RAGGED_QB)
        live = [slot for slot, n in enumerate(row_lens) if n]
        decode_tok = prompt[:, 0].clone()
        logits = {"card": [], "cpu": []}
        for step in range(3):
            for name, model in models.items():
                dev = model.device
                cache = caches[name]
                pool = cache.pool
                flat = {key: torch.zeros(t, dtype=torch.int32) for key in
                        ("tokens", "tok_pos", "tok_row", "write_page", "write_offset")}
                tok_valid = torch.zeros(t, dtype=torch.bool)
                row_last = torch.zeros(r, dtype=torch.int32)
                kv_lens = torch.zeros(r, dtype=torch.int32)
                for slot, (hist, n) in enumerate(rows):
                    if not n:
                        continue
                    s = int(starts[slot])
                    pre = pool.slot_length(slot)
                    pool.extend(slot, n)
                    coords = pool.token_coords(slot, pre, n)
                    if n == 1:
                        flat["tokens"][s] = decode_tok[slot] if step else prompt[slot, hist]
                    else:
                        flat["tokens"][s:s + n] = prompt[slot, pre:pre + n]
                    flat["tok_pos"][s:s + n] = pre + torch.arange(n)
                    flat["tok_row"][s:s + n] = slot
                    flat["write_page"][s:s + n] = torch.tensor([p for p, _ in coords])
                    flat["write_offset"][s:s + n] = torch.tensor([o for _, o in coords])
                    tok_valid[s:s + n] = True
                    row_last[slot] = s + n - 1
                    kv_lens[slot] = pre + n
                blocks = {}
                if torch.device(dev).type == "cuda":
                    blocks = {"block_rows": torch.as_tensor(block_rows, device=dev),
                              "block_q0": torch.as_tensor(block_q0, device=dev)}
                kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                      if kv_quant else {})
                out = model.forward_ragged(
                    flat["tokens"].long().to(dev), flat["tok_pos"].to(dev),
                    flat["tok_row"].to(dev), tok_valid.to(dev), row_last.to(dev),
                    cache.k, cache.v, torch.as_tensor(pool.page_table(8), device=dev),
                    kv_lens.to(dev), torch.as_tensor(starts, device=dev),
                    torch.tensor(row_lens, dtype=torch.int32, device=dev),
                    flat["write_page"].to(dev), flat["write_offset"].to(dev),
                    **blocks, **kw)
                logits[name].append(out.float().cpu()[live])
            decode_tok = torch.zeros(r, dtype=torch.long)
            decode_tok[live] = logits["cpu"][-1].argmax(-1)
        sync()
        # the histories' prefills and three mixed steps on the card
        int4_launches = fused_int4_matmul.launches - int4_before
        check_int4_launches(models["card"], int4_launches,
                            sum(1 for hist, _n in rows if hist) + 3, "phase 4c ragged")
        card = torch.stack(logits["card"])
        ref = torch.stack(logits["cpu"])
        err = float((card - ref).abs().max())
        limit = 0.05 * float(ref.abs().max())
        top = card.argmax(-1, keepdim=True)
        strict = float((top[..., 0] == ref.argmax(-1)).float().mean())
        agree = float((ref.amax(-1) - ref.gather(-1, top)[..., 0] <= limit).float().mean())
        finite = bool(torch.isfinite(card).all())
        log("  kv={:<5} logits max_abs_err {:.3e} (scale {:.2f}), top-1 agreement {:.2f} "
            "(strict {:.2f}) over {} rows, fused_int4_matmul launches {}".format(
                kv_quant or "bf16", err, float(ref.abs().max()), agree, strict,
                card.shape[0] * card.shape[1], int4_launches))
        if not finite or err > limit or agree < 0.9:
            raise AssertionError("forward_ragged on the card disagrees with the CPU reference")


def phase_small_verify(gen_seed: int) -> None:
    """One ``forward_ragged`` step of phase 4's model with speculative
    verify rows: chain and forest rows of k+1 = 5 tokens at several
    histories (a forest node at its path depth's RoPE position) beside
    decode rows, a prefill chunk and an idle row, bf16 on the card (ragged
    kernel with its tree mask, q-block aligned layout) against the same
    weights in float32 on the CPU (plain version, the same layout). Both
    the last-token logits and the per-position verify logits are held to
    phase 4b's tolerance (5% of the largest reference logit, 0.9 top-1
    agreement up to ties inside it)."""
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops.paged_attention import (
        RAGGED_QB, ragged_layout, ragged_paged_attention, tree_ancestors,
    )

    log("phase 4d: small model forward_ragged with verify rows, card (bf16, kernels) vs "
        "CPU (float32, plain versions)")
    card_params, ref_params = small_model_params(gen_seed)
    # (history, query tokens, verify topology)
    rows = [(40, 5, "chain"), (23, 1, None), (9, 5, "forest"), (0, 20, None),
            (31, 5, "forest"), (0, 0, None), (12, 5, "chain"), (28, 1, None)]
    depth_of = {"chain": [0, 1, 2, 3, 4], "forest": [0, 1, 2, 3, 1]}
    r = len(rows)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, 256, (r, 64), generator=gen)
    row_lens = [n for _h, n, _t in rows]
    starts, block_rows, block_q0, t = ragged_layout(row_lens, RAGGED_QB)
    tokens = torch.zeros(t, dtype=torch.long)
    tok_pos = torch.zeros(t, dtype=torch.int32)
    tok_row = torch.zeros(t, dtype=torch.int32)
    tok_valid = torch.zeros(t, dtype=torch.bool)
    row_last = torch.zeros(r, dtype=torch.int32)
    kv_lens = torch.zeros(r, dtype=torch.int32)
    anc = torch.full((t, 5), -1, dtype=torch.int32)
    anc[:, 0] = -2
    row_logit_idx = torch.zeros(r, 5, dtype=torch.int32)
    for slot, (hist, n, topo) in enumerate(rows):
        if not n:
            continue
        s = int(starts[slot])
        tokens[s:s + n] = prompt[slot, hist:hist + n]
        depth = torch.tensor(depth_of[topo]) if topo else torch.arange(n)
        if topo:
            anc[s:s + n] = torch.from_numpy(tree_ancestors(*TREE_TOPOLOGIES[topo], width=5))
        tok_pos[s:s + n] = hist + depth
        tok_row[s:s + n] = slot
        tok_valid[s:s + n] = True
        row_last[slot] = s + n - 1
        kv_lens[slot] = hist + n
        row_logit_idx[slot] = s + torch.clamp(torch.arange(5), max=n - 1)
    live = [slot for slot, n in enumerate(row_lens) if n]
    for kv_quant in ("", "int8"):
        cfg = dict(SMALL_MODEL, kv_quant=kv_quant)
        models = {
            "card": Llama(dict(cfg, dtype="bfloat16"), card_params),
            "cpu": Llama(dict(cfg, dtype="float32"), ref_params),
        }
        outs = {}
        tree_before = ragged_paged_attention.tree_launches
        for name, model in models.items():
            dev = model.device
            cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                                 num_pages=64, page_size=16, max_slots=r,
                                 dtype=model.dtype, kv_quant=kv_quant, device=dev)
            pool = cache.pool
            write_page = torch.zeros(t, dtype=torch.int32)
            write_offset = torch.zeros(t, dtype=torch.int32)
            for slot, (hist, n, _topo) in enumerate(rows):
                if hist:
                    _last, mini = model.prefill(prompt[slot:slot + 1, :hist].to(dev),
                                                torch.tensor([hist], device=dev))
                    scales = ((mini["k_scale"][:, 0], mini["v_scale"][:, 0])
                              if kv_quant else ())
                    cache.write_prompt(slot, mini["k"][:, 0], mini["v"][:, 0], hist, *scales)
                if n:
                    s = int(starts[slot])
                    pool.extend(slot, n)
                    coords = pool.token_coords(slot, hist, n)
                    write_page[s:s + n] = torch.tensor([p for p, _ in coords])
                    write_offset[s:s + n] = torch.tensor([o for _, o in coords])
            blocks = {}
            if torch.device(dev).type == "cuda":
                blocks = {"block_rows": torch.as_tensor(block_rows, device=dev),
                          "block_q0": torch.as_tensor(block_q0, device=dev)}
            kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale} if kv_quant else {})
            last, gathered = model.forward_ragged(
                tokens.to(dev), tok_pos.to(dev), tok_row.to(dev), tok_valid.to(dev),
                row_last.to(dev), cache.k, cache.v,
                torch.as_tensor(pool.page_table(8), device=dev), kv_lens.to(dev),
                torch.as_tensor(starts, device=dev),
                torch.tensor(row_lens, dtype=torch.int32, device=dev),
                write_page.to(dev), write_offset.to(dev), **blocks, **kw,
                row_logit_idx=row_logit_idx.to(dev), tree_anc=anc.to(dev))
            outs[name] = torch.cat([last.float().cpu()[live],
                                    gathered.float().cpu()[live].reshape(-1, last.shape[-1])])
        sync()
        tree_launches = ragged_paged_attention.tree_launches - tree_before
        if models["card"].device.type == "cuda" and tree_launches != models["card"].n_layers:
            raise AssertionError("phase 4d: {} tree launches for one forward call of {} "
                                 "layers".format(tree_launches, models["card"].n_layers))
        card, ref = outs["card"], outs["cpu"]
        err = float((card - ref).abs().max())
        limit = 0.05 * float(ref.abs().max())
        top = card.argmax(-1, keepdim=True)
        strict = float((top[:, 0] == ref.argmax(-1)).float().mean())
        agree = float((ref.amax(-1) - ref.gather(-1, top)[:, 0] <= limit).float().mean())
        finite = bool(torch.isfinite(card).all())
        log("  kv={:<5} last + verify logits max_abs_err {:.3e} (scale {:.2f}), top-1 "
            "agreement {:.2f} (strict {:.2f}) over {} rows, tree launches {}".format(
                kv_quant or "bf16", err, float(ref.abs().max()), agree, strict,
                card.shape[0], tree_launches))
        if not finite or err > limit or agree < 0.9:
            raise AssertionError("forward_ragged verify rows on the card disagree with the "
                                 "CPU reference")


# -- phase 5: the main path --------------------------------------------------------

PROMPTS = [
    "Write a haiku about the sea.",
    "Explain paged attention in two sentences.",
    "List three prime numbers larger than one hundred, separated by commas.",
    "What is the capital of France? Answer in one word, then say why it matters.",
]


async def post_chat(session, url, prompt, stream, max_tokens, sampling=None):
    body = {"model": "llama3-8b", "messages": [{"role": "user", "content": prompt}],
            "max_tokens": max_tokens, "stream": stream, **(sampling or {})}
    t0 = time.perf_counter()
    async with session.post(url, json=body) as r:
        if r.status != 200:
            raise AssertionError("HTTP {}: {}".format(r.status, await r.text()))
        if not stream:
            out = await r.json()
            return dict(content=out["choices"][0]["message"]["content"],
                        tokens=out["usage"]["completion_tokens"], ttft_s=None,
                        total_s=time.perf_counter() - t0)
        pieces, ttft = [], None
        async for raw in r.content:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[len("data: "):])
            if "error" in chunk:
                raise AssertionError("stream error: {}".format(chunk["error"]))
            piece = chunk["choices"][0]["delta"].get("content")
            if piece:
                ttft = ttft or time.perf_counter() - t0
                pieces.append(piece)
        return dict(content="".join(pieces), tokens=None, ttft_s=ttft,
                    total_s=time.perf_counter() - t0)


async def serve_and_chat(engine, tokenizer, max_tokens=32, profiler=None, prompts=PROMPTS,
                         warmup="off"):
    """Start the port's app on a local port (aux ``engine.warmup`` mode
    ``warmup``), warm it up with the same prompts (first-use costs of every
    prefill bucket), zero the counts (their values at that point are kept
    as ``warm_counters``), POST the chats concurrently (the first two
    streaming) and read the counts."""
    import aiohttp
    from aiohttp import web

    from clearml_serving_tpu_torch.llm.openai_api import LLMEngineRequest
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention
    from clearml_serving_tpu_torch.serving.main import build_app

    app = build_app(LLMEngineRequest(engine, tokenizer, "llama3-8b", warmup=warmup))
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    url = "http://127.0.0.1:{}/serve/openai/v1/chat/completions".format(port)
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            await asyncio.gather(*[post_chat(s, url, p, False, 4) for p in prompts])
            await engine.wait_drained()
            warm_counters = dict(engine.counters)
            paged_attention.launches = 0
            fused_int4_matmul.launches = 0
            for key in engine.counters:
                engine.counters[key] = 0
            engine.ttft_ms.clear()
            if profiler is not None:
                profiler.start()
            t0 = time.perf_counter()
            results = await asyncio.gather(*[
                post_chat(s, url, p, stream=i < 2, max_tokens=max_tokens)
                for i, p in enumerate(prompts)
            ])
            wall = time.perf_counter() - t0
            await engine.wait_drained()
            if profiler is not None:
                sync()
                profiler.stop()
            launches = paged_attention.launches
            counters = dict(engine.counters, ttft_ms=sorted(engine.ttft_ms),
                            int4_launches=fused_int4_matmul.launches,
                            warm_counters=warm_counters,
                            pipeline=engine.lifecycle_stats()["pipeline"])
    finally:
        await runner.cleanup()
    return results, wall, launches, counters


def _engine(params, kv_quant, preset, cuda_graphs=True, **knobs):
    from clearml_serving_tpu_torch.llm.openai_api import build_engine

    cfg = {"preset": preset, "cache": "paged", "max_batch": 8, "max_seq_len": 2048,
           "page_size": 16, "decode_steps": 4, "seed": 0, **knobs}
    if kv_quant:
        cfg["kv_quant"] = kv_quant
    return build_engine(cfg, device=DEV, params=params, cuda_graphs=cuda_graphs)


def expected_weight_bytes(preset: str, weight_quant: str) -> int:
    """Bytes of every weight leaf of ``preset`` in bf16, its projections in
    ``weight_quant``'s leaf format: what ``health()["weights"]["bytes"]``
    must read."""
    from clearml_serving_tpu_torch.models.llama import resolve_config
    from clearml_serving_tpu_torch.ops.quant import int4_groups

    cfg = resolve_config({"preset": preset})
    dim, ffn, vocab = int(cfg["dim"]), int(cfg["ffn_dim"]), int(cfg["vocab_size"])
    heads, kv = int(cfg["n_heads"]), int(cfg["n_kv_heads"])
    hd = dim // heads

    def leaf(k, n):
        if weight_quant == "int4":
            return k * n // 2 + int4_groups(k) * n * 4
        if weight_quant == "int8":
            return k * n + n * 4
        return k * n * 2

    layer = 2 * dim * 2 + sum(leaf(k, n) for k, n in (
        (dim, heads * hd), (dim, kv * hd), (dim, kv * hd), (heads * hd, dim),
        (dim, ffn), (dim, ffn), (ffn, dim)))
    return vocab * dim * 2 + dim * 2 + leaf(dim, vocab) + int(cfg["n_layers"]) * layer


def check_weights(engine, preset: str, weight_quant: str) -> dict:
    weights = engine.health()["weights"]
    want = {"quant": weight_quant or "none", "bytes": expected_weight_bytes(preset, weight_quant)}
    if weights != want:
        raise AssertionError("health()['weights'] reads {}, want {}".format(weights, want))
    return weights


def check_int4_route(engine, c, label) -> None:
    """The int4 kernel once per projection per forward call of the run."""
    forwards = c["prefills"] + c["decode_steps"] + c["ragged_steps"] + c["ragged_chain_steps"]
    check_int4_launches(engine.model, c["int4_launches"], forwards, label)


def phase_main_path(params, kv_quant: str, preset: str = "llama3-8b", weight_quant: str = "",
                    max_tokens: int = 32, prompts=PROMPTS) -> dict:
    from clearml_serving_tpu_torch.llm import shapes

    knobs = {"weight_quant": weight_quant} if weight_quant else {}
    engine, tokenizer = _engine(params, kv_quant, preset, **knobs)
    weights = check_weights(engine, preset, weight_quant)
    pools = engine.paged_cache.pool_bytes()
    prefill_rows = [shapes.bucket_for(len(tokenizer.encode_chat(tokenizer.apply_chat_template(
        [{"role": "user", "content": p}]))), engine._buckets, engine.max_seq_len)
        for p in prompts]
    results, wall, launches, c = asyncio.run(
        serve_and_chat(engine, tokenizer, max_tokens=max_tokens, prompts=prompts))
    n_layers = engine.model.n_layers
    check_int4_route(engine, c, "main path " + (weight_quant or "bf16"))
    del engine
    if torch.device(DEV).type == "cuda":
        torch.cuda.empty_cache()
    streamed = [r for r in results if r["ttft_s"] is not None]
    steps = c["decode_steps"]
    out = dict(
        weights=weight_quant or "bf16", weight_bytes=weights["bytes"],
        int4_launches=c["int4_launches"], prefills=c["prefills"], prefill_rows=prefill_rows,
        kv=kv_quant or "bf16", wall_s=wall, launches=launches, decode_steps=steps,
        tokens=c["tokens_emitted"],
        # engine-side: request parsed -> first token emitted
        ttft_ms=c["ttft_ms"],
        # client-side, streamed requests: POST -> first SSE chunk with text
        # (random bytes are often held back as partial UTF-8)
        first_text_ms=[r["ttft_s"] * 1e3 for r in streamed],
        # tokens the engine emitted for the four requests over their wall time
        decode_tok_s=c["tokens_emitted"] / wall,
        # engine host time per decode step (chunks end in a device->host read)
        step_ms=c["decode_ms"] / max(1, steps),
        prefill_ms=c["prefill_ms"] / max(1, c["prefills"]),
        pool_gib=(pools["kv"] + pools["scale"]) / 2 ** 30,
    )
    log("  weights={weights} ({weight_bytes} bytes) kv={kv}: wall {wall_s:.3f} s, {tokens} "
        "tokens, decode steps {decode_steps} ({step_ms:.2f} ms each), prefill {prefill_ms:.2f} "
        "ms each, paged_attention launches {launches}, fused_int4_matmul launches "
        "{int4_launches}, prefill rows {prefill_rows}, TTFT {ttft_ms} ms, "
        "{decode_tok_s:.1f} tok/s aggregate, pools {pool_gib:.2f} GiB".format(**out))
    log("  contents:", json.dumps([r["content"][:24] for r in results]))
    if not all(r["content"] for r in results):
        raise AssertionError("an empty completion")
    if any(r["tokens"] is not None and r["tokens"] != max_tokens for r in results):
        raise AssertionError("a completion stopped before max_tokens")
    if steps == 0 or launches != n_layers * steps:
        raise AssertionError("paged_attention launched {} times for {} decode steps of {} "
                             "layers".format(launches, steps, n_layers))
    return out


def phase_profile(params, scheduler: str = "two_dispatch", weight_quant: str = "",
                  pipeline_depth=None, cuda_graphs: bool = True, traffic=None) -> dict:
    """The bf16-KV main-path run of a scheduler once more under torch.profiler
    (two-dispatch: phase 5's traffic, or ``traffic``, a ``PIPELINE_TRAFFIC``
    entry): device time by kernel name, each ported kernel's time (the
    union of its grids' intervals) and the device's busy share of the run's
    wall time (the union of all kernel intervals). Profiling adds host
    overhead, so these shares describe this pass only. On a two-dispatch
    pass whose decode chunks replayed graphs, the decode kernel's and the
    int4 kernel's instances in the trace must equal their ``launches``
    counts over the same window: a replay adds the counts its capture
    recorded, and this holds them to kernels the card ran. Other passes
    count every launch in the wrapper and only print the comparison: an
    eager pass's trace has come up short (1020 of 1024 counted grids on an
    H100), and so has a graph pass's (4095 of 4096), as if the profiler
    dropped records. A graph pass whose trace disagrees is therefore
    profiled once more, on a fresh engine: a launch that did not run would
    make the second trace disagree too, and then the phase fails."""
    out = _profiled_pass(params, scheduler, weight_quant, pipeline_depth, cuda_graphs, traffic)
    if out["checked"] and not out["trace_agrees"]:
        log("  the trace disagrees with the counts: profiling the pass once more")
        out = _profiled_pass(params, scheduler, weight_quant, pipeline_depth, cuda_graphs,
                             traffic)
        if not out["trace_agrees"]:
            raise AssertionError("the trace holds {} decode-attention and {} int4 grids, the "
                                 "counts say {} and {}".format(
                                     out["traced_paged"], out["traced_int4"],
                                     out["paged_launches"], out["int4_launches"]))
    return out


def _profiled_pass(params, scheduler, weight_quant, pipeline_depth, cuda_graphs,
                   traffic) -> dict:
    """One profiled pass of ``phase_profile``: its numbers, and whether
    the trace's decode-attention and int4 grids equal the counts
    (``trace_agrees``; ``checked`` on a two-dispatch pass with graphs)."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    knobs = {"weight_quant": weight_quant} if weight_quant else {}
    if pipeline_depth is not None:
        knobs["pipeline_depth"] = pipeline_depth
    label = "phase5"
    if scheduler == "ragged":
        engine, tokenizer = _engine(params, "", "llama3-8b", cuda_graphs, **RAGGED_KNOBS, **knobs)
        _results, wall, c = asyncio.run(serve_ragged(engine, tokenizer, profiler=prof))
        label = "phase5b"
    elif scheduler == "ragged-tree":
        # phase 5d's tree arm under its traffic
        engine, tokenizer = _engine(params, "", "llama3-8b", cuda_graphs, **TREE_KNOBS, **knobs)
        _results, wall, c = asyncio.run(serve_ragged(
            engine, tokenizer, max_tokens=SPEC_MAX_TOKENS, profiler=prof, prompts=SPEC_PROMPTS,
            samplings=SPEC_SAMPLINGS))
        label = "phase5d"
    else:
        label, prompts, max_tokens = traffic or ("phase5", PROMPTS, 32)
        engine, tokenizer = _engine(params, "", "llama3-8b", cuda_graphs, **knobs)
        _results, wall, launches, c = asyncio.run(serve_and_chat(
            engine, tokenizer, max_tokens=max_tokens, profiler=prof, prompts=prompts))
        c["paged_launches"] = launches
    depth, graphs = engine.pipeline_depth, engine._graphs is not None
    del engine
    torch.cuda.empty_cache()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) / 1e3)

    def busy_ms(match=lambda name: True):
        """ms of the union of the matching kernels' intervals: a grid
        launched as a programmatic dependent shows from its early start,
        while it waits on the grid before it, so a sum would count the
        overlap twice."""
        busy, end = 0.0, None
        for t0, t1 in sorted((e.time_range.start, e.time_range.end)
                             for e in kernels if match(e.name)):
            if end is None or t0 > end:
                busy += t1 - t0
                end = t1
            elif t1 > end:
                busy += t1 - end
                end = t1
        return busy / 1e3

    busy = busy_ms() * 1e3
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the decode kernel's two grids (csrc/paged_attention.cu)
    attn = busy_ms(lambda k: "paged_split_kernel" in k or "paged_combine_kernel" in k)
    # the ragged kernel's two grids (csrc/ragged_paged_attention.cu)
    ragged = busy_ms(lambda k: "ragged_attention_" in k)
    int4 = busy_ms(lambda k: "w4a16_" in k)
    # one split grid per decode-attention call, one main grid per int4 call
    # (csrc/paged_attention.cu, csrc/fused_int4_matmul.cu)
    traced_paged = sum("paged_split_kernel" in e.name for e in kernels)
    traced_int4 = sum("w4a16_decode_kernel" in e.name or "w4a16_block_kernel" in e.name
                      for e in kernels)
    out = dict(scheduler=scheduler, traffic=label, weights=weight_quant or "bf16", depth=depth,
               graphs=graphs, wall_ms=wall * 1e3,
               device_busy_ms=busy / 1e3, busy_share=busy / 1e3 / (wall * 1e3),
               kernel_ms=total, paged_attention_ms=attn, ragged_attention_ms=ragged,
               int4_matmul_ms=int4, decode_steps=c["decode_steps"],
               step_ms=c["decode_ms"] / max(1, c["decode_steps"]),
               ragged_steps=c["ragged_steps"], graph_replays=c["graph_replays"],
               paged_launches=c["paged_launches"], traced_paged=traced_paged,
               int4_launches=c["int4_launches"], traced_int4=traced_int4,
               top=[(k[:60], v) for k, v in top])
    log("  profiled {weights}-weight {scheduler} pass, {traffic} traffic (depth {depth}, graphs "
        "{graphs}): wall {wall_ms:.1f} ms, device busy "
        "{device_busy_ms:.1f} ms ({busy_share:.1%}), kernels {kernel_ms:.1f} ms, paged "
        "attention {paged_attention_ms:.2f} ms over {decode_steps} decode steps "
        "({step_ms:.2f} ms each), ragged "
        "attention {ragged_attention_ms:.2f} ms over {ragged_steps} ragged steps, int4 "
        "matmul {int4_matmul_ms:.2f} ms; {graph_replays} replays; in the trace "
        "{traced_paged} decode-attention and {traced_int4} int4 grids, counted "
        "{paged_launches} and {int4_launches}".format(**out))
    out["checked"] = scheduler == "two_dispatch" and graphs
    out["trace_agrees"] = (traced_paged, traced_int4) == (c["paged_launches"],
                                                          c["int4_launches"])
    for name, ms in top:
        log("    {:9.2f} ms  {}".format(ms, name[:100]))
    return out


# -- phase 5b: the ragged main path ------------------------------------------------

RAGGED_KNOBS = {"scheduler": "ragged", "step_token_budget": 256}
_NOTES = ("Meeting notes, platform team. The paged KV cache keeps every sequence in "
          "fixed-size pages, so memory holds only the tokens that exist. The ragged "
          "scheduler packs decode rows and prompt chunks into one launch per step, and "
          "the token budget bounds how much prefill rides beside the decode batch. ")
# about 600 to 1500 tokens each through the byte tokenizer
LONG_PROMPTS = [
    "Summarise these notes in one paragraph. " + (_NOTES * 7)[:n]
    for n in (560, 860, 1160, 1460)
]


async def serve_ragged(engine, tokenizer, max_tokens=32, profiler=None, prompts=None,
                       samplings=None):
    """Start the port's app, warm it up with the prompts (default: the four
    long ones), zero the counts, then POST the chats (the first two
    streaming) staggered: each is sent once every earlier one has its first
    token, so every admission's chunk rows share launches with live decode
    rows. Returns (results, wall seconds, counters with ttft_ms, step_rows
    and the kernels' launches)."""
    import aiohttp
    from aiohttp import web

    from clearml_serving_tpu_torch.llm.openai_api import LLMEngineRequest
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul
    from clearml_serving_tpu_torch.ops.paged_attention import (
        paged_attention, ragged_paged_attention,
    )
    from clearml_serving_tpu_torch.serving.main import build_app

    app = build_app(LLMEngineRequest(engine, tokenizer, "llama3-8b"))
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    url = "http://127.0.0.1:{}/serve/openai/v1/chat/completions".format(port)
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            prompts = prompts or LONG_PROMPTS
            samplings = samplings or [None] * len(prompts)
            await asyncio.gather(*[post_chat(s, url, p, False, 4) for p in prompts])
            paged_attention.launches = 0
            ragged_paged_attention.launches = 0
            ragged_paged_attention.tree_launches = 0
            fused_int4_matmul.launches = 0
            for key in engine.counters:
                engine.counters[key] = 0
            for key in engine.step_rows:
                engine.step_rows[key] = 0
            engine.ttft_ms.clear()
            if profiler is not None:
                profiler.start()
            t0 = time.perf_counter()
            tasks = []
            for i, prompt in enumerate(prompts):
                while len(engine.ttft_ms) < i:
                    await asyncio.sleep(0.002)
                tasks.append(asyncio.ensure_future(
                    post_chat(s, url, prompt, stream=i < 2, max_tokens=max_tokens,
                              sampling=samplings[i])))
            results = await asyncio.gather(*tasks)
            wall = time.perf_counter() - t0
            await engine.wait_drained()
            if profiler is not None:
                sync()
                profiler.stop()
            counters = dict(engine.counters, ttft_ms=list(engine.ttft_ms),
                            step_rows=dict(engine.step_rows),
                            paged_launches=paged_attention.launches,
                            ragged_launches=ragged_paged_attention.launches,
                            tree_launches=ragged_paged_attention.tree_launches,
                            int4_launches=fused_int4_matmul.launches)
    finally:
        await runner.cleanup()
    return results, wall, counters


def phase_ragged_main_path(params, kv_quant: str, preset: str = "llama3-8b",
                           weight_quant: str = "") -> dict:
    knobs = {"weight_quant": weight_quant} if weight_quant else {}
    engine, tokenizer = _engine(params, kv_quant, preset, **RAGGED_KNOBS, **knobs)
    weights = check_weights(engine, preset, weight_quant)
    prompt_tokens = [len(tokenizer.encode_chat(tokenizer.apply_chat_template(
        [{"role": "user", "content": p}]))) for p in LONG_PROMPTS]
    results, wall, c = asyncio.run(serve_ragged(engine, tokenizer))
    n_layers = engine.model.n_layers
    check_int4_route(engine, c, "ragged main path " + (weight_quant or "bf16"))
    del engine
    if torch.device(DEV).type == "cuda":
        torch.cuda.empty_cache()
    steps = c["ragged_steps"]
    out = dict(
        weights=weight_quant or "bf16", weight_bytes=weights["bytes"],
        int4_launches=c["int4_launches"],
        kv=kv_quant or "bf16", wall_s=wall, prompt_tokens=prompt_tokens,
        tokens=c["tokens_emitted"], ragged_steps=steps, step_rows=c["step_rows"],
        ragged_decode_tokens=c["ragged_decode_tokens"],
        ragged_chain_steps=c["ragged_chain_steps"], decode_steps=c["decode_steps"],
        ragged_launches=c["ragged_launches"], paged_launches=c["paged_launches"],
        # engine-side: request parsed -> first token emitted, in arrival order
        ttft_ms=c["ttft_ms"],
        decode_tok_s=c["tokens_emitted"] / wall,
        # engine host time per ragged step (each ends in a device->host read)
        ragged_step_ms=c["ragged_ms"] / max(1, steps),
        step_ms=c["decode_ms"] / max(1, c["decode_steps"]),
    )
    log("  weights={weights} kv={kv}: prompts {prompt_tokens} tokens, wall {wall_s:.3f} s, "
        "{tokens} tokens, {decode_tok_s:.1f} tok/s aggregate; ragged steps {ragged_steps} "
        "({ragged_step_ms:.2f} ms each), rows {step_rows}, chained window steps "
        "{ragged_chain_steps}; decode steps {decode_steps} ({step_ms:.2f} ms each); launches "
        "ragged {ragged_launches} paged {paged_launches} int4 {int4_launches}; TTFT {ttft_ms} "
        "ms".format(**out))
    log("  contents:", json.dumps([r["content"][:24] for r in results]))
    if not all(r["content"] for r in results):
        raise AssertionError("an empty completion")
    if any(r["tokens"] is not None and r["tokens"] != 32 for r in results) or \
            c["tokens_emitted"] != 32 * len(LONG_PROMPTS):
        raise AssertionError("a completion stopped before max_tokens")
    if c["step_rows"]["prefill"] < 8 or c["step_rows"]["decode"] < 1:
        raise AssertionError("no mixed launches: step rows {}".format(c["step_rows"]))
    if steps == 0 or c["ragged_launches"] != n_layers * steps:
        raise AssertionError("ragged_paged_attention launched {} times for {} ragged steps of "
                             "{} layers".format(c["ragged_launches"], steps, n_layers))
    if c["paged_launches"] != n_layers * (c["decode_steps"] + c["ragged_chain_steps"]):
        raise AssertionError("paged_attention launched {} times for {} decode steps and {} "
                             "chained window steps of {} layers".format(
                                 c["paged_launches"], c["decode_steps"],
                                 c["ragged_chain_steps"], n_layers))
    return out


# -- phase 5d: speculative verify rows on the ragged main path ----------------

SPEC_KNOBS = dict(RAGGED_KNOBS, speculation="ngram", spec_k=4)
TREE_KNOBS = dict(SPEC_KNOBS, spec_tree=True, spec_branch=2)
# (arm, KV, knobs): on bf16 KV the plain ragged arm the greedy streams are
# held to, then chain and tree verify rows; on int8 KV a plain and a tree arm
SPEC_ARMS = [("plain", "", RAGGED_KNOBS), ("chain", "", SPEC_KNOBS), ("tree", "", TREE_KNOBS),
             ("plain", "int8", RAGGED_KNOBS), ("tree", "int8", TREE_KNOBS)]
# repetitive chats (the n-gram proposer drafts from repeats); the third
# samples at temperature 0.7 among its 40 likeliest tokens (the random
# weights' lm_head is zero past the 256 byte ids, which render as nothing)
SPEC_PROMPTS = [
    "Copy this list exactly: " + "red, green, blue, " * 24,
    "Continue the pattern: " + "1 2 3 4 5 6 7 8 9 10 " * 12,
    "Say it again and again: " + "the quick brown fox. " * 20,
    "Repeat: " + "ab ab ab ab cd cd cd cd " * 14,
]
SPEC_SAMPLINGS = [None, None, {"temperature": 0.7, "top_k": 40}, None]
SPEC_MAX_TOKENS = 64


def first_difference(a: str, b: str):
    """Index of the first differing character of two strings (None when
    they are equal)."""
    if a == b:
        return None
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))


def phase_spec_main_path(params, arm: str, kv_quant: str, knobs: dict,
                         preset: str = "llama3-8b") -> dict:
    """Llama-3-8B behind the HTTP app under ``scheduler: ragged`` (budget
    256) with the arm's speculation knobs; four staggered repetitive chats,
    one sampled. Checks verify rows ran (and tree depths on the tree arm)
    and the launch identities: the ragged kernel once per layer per ragged
    step, its tree variant once per layer per verify step of a tree
    engine, the decode kernel once per layer per decode and chained window
    step."""
    engine, tokenizer = _engine(params, kv_quant, preset, **knobs)
    streams = record_streams(engine)
    results, wall, c = asyncio.run(serve_ragged(
        engine, tokenizer, max_tokens=SPEC_MAX_TOKENS, prompts=SPEC_PROMPTS,
        samplings=SPEC_SAMPLINGS))
    ragged = engine.health()["ragged"]
    n_layers = engine.model.n_layers
    del engine
    if torch.device(DEV).type == "cuda":
        torch.cuda.empty_cache()
    steps = c["ragged_steps"]
    out = dict(
        arm=arm, kv=kv_quant or "bf16", wall_s=wall, tokens=c["tokens_emitted"],
        ragged_steps=steps, verify_steps=c["ragged_verify_steps"], step_rows=c["step_rows"],
        decode_steps=c["decode_steps"], ragged_chain_steps=c["ragged_chain_steps"],
        ragged_launches=c["ragged_launches"], tree_launches=c["tree_launches"],
        paged_launches=c["paged_launches"],
        # decode tokens a ragged launch committed (accepted drafts + bonus)
        accepted_per_launch=c["ragged_decode_tokens"] / max(1, steps),
        ttft_ms=c["ttft_ms"], tok_s=c["tokens_emitted"] / wall,
        ragged_step_ms=c["ragged_ms"] / max(1, steps),
        spec_acceptance=ragged["spec_acceptance"], spec_tree_depth=ragged["spec_tree_depth"],
        spec_proposer=ragged["spec_proposer"],
        contents=[r["content"] for r in results],
        # each chat's (prompt ids, generated ids), from its last request
        token_ids=[next((p, ids) for p, ids in streams.items()
                        if prompt in tokenizer.decode(p)) for prompt in SPEC_PROMPTS],
    )
    log("  {arm} kv={kv}: wall {wall_s:.3f} s, {tokens} tokens, {tok_s:.1f} tok/s; ragged "
        "steps {ragged_steps} ({ragged_step_ms:.2f} ms each; {verify_steps} with verify "
        "rows), {accepted_per_launch:.3f} decode tokens per launch, rows {step_rows}; "
        "launches ragged {ragged_launches} (tree {tree_launches}) paged {paged_launches}; "
        "TTFT {ttft_ms} ms; proposer {spec_proposer}".format(**out))
    if not all(r["content"] for r in results):
        raise AssertionError("an empty completion")
    if c["tokens_emitted"] != SPEC_MAX_TOKENS * len(SPEC_PROMPTS):
        raise AssertionError("a completion stopped before max_tokens: {} tokens".format(
            c["tokens_emitted"]))
    if steps == 0 or c["ragged_launches"] != n_layers * steps:
        raise AssertionError("ragged_paged_attention launched {} times for {} ragged steps of "
                             "{} layers".format(c["ragged_launches"], steps, n_layers))
    if c["paged_launches"] != n_layers * (c["decode_steps"] + c["ragged_chain_steps"]):
        raise AssertionError("paged_attention launched {} times for {} decode and {} chained "
                             "steps".format(c["paged_launches"], c["decode_steps"],
                                            c["ragged_chain_steps"]))
    tree = bool(knobs.get("spec_tree"))
    if c["tree_launches"] != (n_layers * c["ragged_verify_steps"] if tree else 0):
        raise AssertionError("{} tree launches for {} verify steps ({} arm)".format(
            c["tree_launches"], c["ragged_verify_steps"], arm))
    if knobs.get("speculation") and c["step_rows"]["spec_verify"] < 1:
        raise AssertionError("no verify rows ran: {}".format(c["step_rows"]))
    if tree and ragged["spec_tree_depth"]["count"] < 1:
        raise AssertionError("no tree acceptance depth recorded")
    return out


def record_streams(engine) -> dict:
    """Wraps ``engine.generate`` so that every request's generated token ids
    are kept, by prompt ids (a later request with the same prompt replaces
    an earlier one: the timed run replaces the warm-up)."""
    streams = {}
    generate = engine.generate

    async def recording(request):
        ids = streams[tuple(request.prompt_ids)] = []
        async for token in generate(request):
            ids.append(token)
            yield token

    engine.generate = recording
    return streams


def logit_margins(model, prompt_ids, ids, step, other):
    """At generated position ``step`` of a greedy stream: the top logit, the
    top-2 margin of the model's logits and the logit of ``ids[step]`` less
    that of ``other`` (the token another arm took there), from one bf16
    prefill of the prompt and the stream's first ``step`` tokens (the
    logits are bf16 values: distinct ones near a top logit in [2**e,
    2**(e+1)) lie at least 2**(e-7) apart)."""
    seq = list(prompt_ids) + list(ids[:step])
    tokens = torch.tensor([seq], dtype=torch.long, device=model.device)
    logits, _cache = model.prefill(tokens, torch.tensor([len(seq)]))
    logits = logits[0]
    top = torch.topk(logits, 2).values
    return dict(top1=float(top[0]), top2_margin=float(top[0] - top[1]),
                taken_minus_other=float(logits[ids[step]] - logits[other]),
                taken_is_argmax=int(logits.argmax()) == ids[step])


def compare_spec_streams(spec_runs, model=None) -> None:
    """Each speculative arm's greedy contents against the plain ragged arm's
    on the same KV (bf16 cuBLAS at other row counts may flip a near tie at
    full width: reported, not asserted), and the tree arm's against the
    chain arm's. With ``model``, at the first generated token where an arm
    leaves the plain arm's greedy stream, logs the top-2 logit margin of
    that step (``logit_margins`` on the plain arm's prefix)."""
    greedy = [i for i, sampling in enumerate(SPEC_SAMPLINGS) if sampling is None]
    for run in spec_runs:
        if run["arm"] == "plain":
            continue
        plain_run = next(r for r in spec_runs if r["arm"] == "plain" and r["kv"] == run["kv"])
        run["greedy_vs_plain"] = [first_difference(run["contents"][i], plain_run["contents"][i])
                                  for i in greedy]
        run["greedy_margins"] = []
        for i in greedy:
            prompt_ids, ids = plain_run["token_ids"][i]
            _prompt, spec_ids = run["token_ids"][i]
            step = next((j for j, (a, b) in enumerate(zip(ids, spec_ids)) if a != b), None)
            if step is None or model is None:
                continue
            margins = dict(chat=i, token=step, plain=ids[step], spec=spec_ids[step],
                           **logit_margins(model, prompt_ids, ids, step, spec_ids[step]))
            run["greedy_margins"].append(margins)
            log("  {} kv={} chat {}: first differing token {} (plain {} vs {} {}): top logit "
                "{:.4g}, top-2 margin {:.4g}, logit(plain) - logit({}) {:.4g}, plain's token "
                "is the argmax: {}".format(
                    run["arm"], run["kv"], i, step, ids[step], run["arm"], spec_ids[step],
                    margins["top1"], margins["top2_margin"], run["arm"],
                    margins["taken_minus_other"], margins["taken_is_argmax"]))
        chain_run = next((r for r in spec_runs if r["arm"] == "chain" and r["kv"] == run["kv"]),
                         None)
        if run["arm"] == "tree" and chain_run is not None:
            run["greedy_vs_chain"] = [
                first_difference(run["contents"][i], chain_run["contents"][i]) for i in greedy]
        log("  {} kv={}: greedy streams match the plain ragged arm's: {} (first differing "
            "character per greedy chat: {}; against the chain arm: {})".format(
                run["arm"], run["kv"], all(d is None for d in run["greedy_vs_plain"]),
                run["greedy_vs_plain"], run.get("greedy_vs_chain", "n/a")))


# -- phase 5e: pipelined decode, each chunk one CUDA-graph replay -------------------

# (KV, weights) of the graph checks
GRAPH_CASES = [("", ""), ("int8", ""), ("", "int4")]
# one decode chunk's rows: seven slots at 40-1500 tokens and an idle one
CHUNK_LENGTHS = [1500, 40, 700, 1000, 300, 1200, 90, 0]
CHUNK_STEPS = 4


def graph_chunk_case(params, kv_quant: str, weights: str, sampled: bool) -> dict:
    """One Llama-3-8B decode chunk (8 rows, 4 steps, the engine's page
    table) captured into a CUDA graph (``DecodeGraphs``) and replayed,
    against ``run_chunk`` run eagerly on a clone of the same pools: the
    tokens, the device chain and every pool page must be equal bit for
    bit; a replay adds n_layers x steps decode-attention launches (and 225
    x steps int4 ones), the capture none; the counts one replay added are
    returned. Random pool contents; one row's
    token comes from a host override. Times a replay and an eager chunk
    (CUDA events, means over 5 and 3 runs)."""
    import types

    from clearml_serving_tpu_torch.llm.decode_graph import ChunkLayout, DecodeGraphs, run_chunk
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.llm.sampling import gumbel_noise
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention

    n = CHUNK_STEPS
    model = Llama(dict({"preset": "llama3-8b"}, **({"kv_quant": kv_quant} if kv_quant else {})),
                  params)
    b, page = len(CHUNK_LENGTHS), 32 if kv_quant else 16
    pages_per_seq = -(-(2048 + n) // page)
    cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                         num_pages=sum(-(-(t + n) // page) for t in CHUNK_LENGTHS) + 1,
                         page_size=page, max_slots=b, dtype=model.dtype, kv_quant=kv_quant,
                         device=DEV)
    gen = torch.Generator(DEV).manual_seed(5)
    if kv_quant:
        for pool in (cache.k, cache.v):
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen, device=DEV))
        for scale in (cache.k_scale, cache.v_scale):
            scale.copy_(torch.rand(scale.shape, generator=gen, device=DEV) * 0.02)
    else:
        for pool in (cache.k, cache.v):
            pool.copy_(torch.randn(pool.shape, generator=gen, device=DEV))
    layout = ChunkLayout(b, pages_per_seq, n)
    i32 = torch.zeros(layout.size_i32, dtype=torch.int32, pin_memory=True)
    f32 = torch.zeros(layout.size_f32, dtype=torch.float32, pin_memory=True)
    v = layout.views(i32.numpy(), f32.numpy())
    for slot, length in enumerate(CHUNK_LENGTHS[:-1]):
        cache.pool.allocate(slot, length + n)
        for i, (pg, off) in enumerate(cache.pool.token_coords(slot, length, n)):
            v["write_pages"][slot, i], v["write_offsets"][slot, i] = pg, off
    v["page_table"][:] = cache.pool.page_table(pages_per_seq)
    v["lengths0"][:] = CHUNK_LENGTHS
    v["temperature"][:] = [0.7, 0.0, 1.0, 0.7, 0.0, 1.3, 0.7, 0.0] if sampled else 0.0
    v["top_k"][:] = [0, 0, 40, 0, 0, 0, 20, 0]
    v["top_p"][:] = [1.0, 1.0, 1.0, 0.9, 1.0, 1.0, 0.95, 1.0]
    v["override_tokens"][1], v["override_mask"][1] = 65, 1
    chain = torch.randint(0, 256, (b,), generator=gen, device=DEV, dtype=torch.int32)
    noise = gumbel_noise((n, b, model.vocab_size), gen, DEV) if sampled else None
    pools = ("k", "v", "k_scale", "v_scale")
    eager_cache = types.SimpleNamespace(kv_quant=kv_quant, **{
        name: None if getattr(cache, name) is None else getattr(cache, name).clone()
        for name in pools})
    dev_views = layout.views(i32.to(DEV), f32.to(DEV))
    eager = run_chunk(model, eager_cache, dev_views, chain, noise, n)
    graphs = DecodeGraphs(model, cache, layout, n)
    graphs.chain.copy_(chain)
    paged_attention.launches = fused_int4_matmul.launches = 0
    graphs.capture(greedy=not sampled)
    if (paged_attention.launches, fused_int4_matmul.launches) != (0, 0):
        raise AssertionError("a capture counted launches")
    out = graphs.replay(not sampled, i32, f32, noise)
    sync()
    label = "{} KV, {} weights, {}".format(kv_quant or "bf16", weights or "bf16",
                                          "sampled" if sampled else "greedy")
    if not torch.equal(out, eager) or not torch.equal(graphs.chain, eager[:, -1]):
        raise AssertionError("graph replay tokens differ from the eager chunk ({})".format(label))
    for name in pools:
        if getattr(cache, name) is not None and not torch.equal(getattr(cache, name),
                                                                getattr(eager_cache, name)):
            raise AssertionError("graph replay wrote other {} pages ({})".format(name, label))
    # the counts one replay added, as measured (the kernels line prints them)
    per_replay = {"paged_attention": paged_attention.launches,
                  "fused_int4_matmul": fused_int4_matmul.launches}
    want = {"paged_attention": model.n_layers * n,
            "fused_int4_matmul": int4_launches_per_forward(model) * n}
    if per_replay != want:
        raise AssertionError("a replay counted {} launches, want {} ({})".format(
            per_replay, want, label))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graphs.replay(not sampled, i32, f32, noise)
    end.record()
    sync()
    replay_ms = start.elapsed_time(end) / 5
    start.record()
    for _ in range(3):
        run_chunk(model, eager_cache, dev_views, chain, noise, n)
    end.record()
    sync()
    eager_ms = start.elapsed_time(end) / 3
    del graphs, cache, eager_cache
    torch.cuda.empty_cache()
    log("  {}: replay bitwise the eager chunk; {:.3f} ms a chunk replayed, {:.3f} ms "
        "eager".format(label, replay_ms, eager_ms))
    return dict(kv=kv_quant or "bf16", weights=weights or "bf16",
                variant="sampled" if sampled else "greedy", replay_ms=replay_ms,
                eager_ms=eager_ms, bitwise=True, launches_per_replay=per_replay)


# phase 5's traffic, and a steadier one: eight chats of 128 tokens
PIPELINE_TRAFFIC = [("phase5", PROMPTS, 32), ("steady", PROMPTS * 2, 128)]


# (label, depth, cuda_graphs): the eager serial loop, graphs in the serial
# loop, graphs in the pipeline; the middle arm splits the graphs' gain from
# the pipelining's
PIPELINE_ARMS = [("eager1", 1, False), ("graphs1", 1, True), ("graphs2", 2, True)]


def phase_pipeline_arms(params, preset: str = "llama3-8b", traffics=PIPELINE_TRAFFIC) -> list:
    """Each traffic in each of ``PIPELINE_ARMS`` on the same engine config
    and weights (graph arms captured by the endpoint's ``warmup:
    startup``): the greedy contents must be equal across the arms, the
    decode kernel launched n_layers times per decode step, and a graph arm
    must have captured both variants at warmup and none while serving, one
    replay per chunk. Reports wall ms per decode step (the loop's time in
    decode steps over the steps; at depth 2 a chunk computing under a
    prefill's host time is not in it), the mean dispatch and retire ms, and
    tok/s."""
    runs = []
    for traffic, prompts, max_tokens in traffics:
        arms = {}
        for arm, depth, cuda_graphs in PIPELINE_ARMS:
            engine, tokenizer = _engine(params, "", preset, cuda_graphs, pipeline_depth=depth)
            results, wall, launches, c = asyncio.run(serve_and_chat(
                engine, tokenizer, max_tokens=max_tokens, prompts=prompts,
                warmup="startup" if cuda_graphs else "off"))
            n_layers = engine.model.n_layers
            graphs = engine._graphs is not None
            depth = engine.pipeline_depth
            del engine
            if torch.device(DEV).type == "cuda":
                torch.cuda.empty_cache()
            warm, pipe = c["warm_counters"], c["pipeline"]
            steps = c["decode_steps"]
            out = dict(
                traffic=traffic, arm=arm, depth=depth, graphs=graphs, wall_s=wall,
                tokens=c["tokens_emitted"], decode_steps=steps, launches=launches,
                step_ms=c["decode_ms"] / max(1, steps),
                dispatch_ms=pipe["dispatch_ms"]["sum_ms"] / max(1, pipe["dispatch_ms"]["count"]),
                retire_ms=pipe["retire_ms"]["sum_ms"] / max(1, pipe["retire_ms"]["count"]),
                decode_tok_s=c["tokens_emitted"] / wall,
                prefill_ms=c["prefill_ms"] / max(1, c["prefills"]),
                warmup_captures=warm["graph_captures"], serve_captures=c["serve_captures"],
                replays=c["graph_replays"], chunks=c["decode_chunks"],
                contents=[r["content"] for r in results])
            log("  {traffic} {arm} (depth {depth}, graphs {graphs}): wall {wall_s:.3f} s, "
                "{tokens} tokens, {decode_tok_s:.1f} tok/s, {decode_steps} decode steps at "
                "{step_ms:.2f} ms each, dispatch {dispatch_ms:.2f} ms, retire {retire_ms:.2f} "
                "ms, prefill {prefill_ms:.2f} ms; captures {warmup_captures} at warmup, "
                "{serve_captures} serving; replays {replays} of {chunks} chunks".format(**out))
            if steps == 0 or launches != n_layers * steps:
                raise AssertionError("paged_attention launched {} times for {} decode steps "
                                     "of {} layers".format(launches, steps, n_layers))
            if c["tokens_emitted"] != max_tokens * len(prompts):
                raise AssertionError("a completion stopped before max_tokens")
            on_card = torch.device(DEV).type == "cuda"
            if graphs != (cuda_graphs and on_card) or (graphs and (
                    warm["graph_captures"] != 2 or warm["serve_captures"] != 0
                    or c["serve_captures"] != 0 or c["graph_replays"] != c["decode_chunks"])):
                raise AssertionError("{} {}: graphs {}, captures {} at warmup, {} / {} while "
                                     "serving, {} replays of {} chunks".format(
                                         traffic, arm, graphs, warm["graph_captures"],
                                         warm["serve_captures"], c["serve_captures"],
                                         c["graph_replays"], c["decode_chunks"]))
            arms[arm] = out
        base = arms[PIPELINE_ARMS[0][0]]["contents"]
        for arm, out in arms.items():
            if out["contents"] != base:
                raise AssertionError("{}: greedy contents differ between {} and {}: {}".format(
                    traffic, PIPELINE_ARMS[0][0], arm,
                    [first_difference(a, b) for a, b in zip(base, out["contents"])]))
        log("  {}: greedy contents equal in {}".format(traffic, ", ".join(arms)))
        for out in arms.values():
            out["contents"] = [text[:24] for text in out["contents"]]
            runs.append(out)
    return runs


# -- phase 7: the request lifecycle of the default route ------------------------

LIFECYCLE_PROMPT = "Write a short story about a lighthouse keeper and a storm."
BATCH_PROMPTS = ["Batch job {}: describe the paged KV cache and its page table.".format(i)
                 for i in range(8)]


@contextlib.asynccontextmanager
async def served(engine, tokenizer):
    """The port's app for ``engine`` on a local port: yields (app, base
    URL, client session); the app's cleanup stops the engine."""
    import aiohttp
    from aiohttp import web

    from clearml_serving_tpu_torch.llm.openai_api import LLMEngineRequest
    from clearml_serving_tpu_torch.serving.main import build_app

    app = build_app(LLMEngineRequest(engine, tokenizer, "llama3-8b"))
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    base = "http://127.0.0.1:{}".format(runner.addresses[0][1])
    try:
        async with aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600)) as s:
            yield app, base, s
    finally:
        await runner.cleanup()


async def lifecycle_chat(session, base, prompt, max_tokens, stream=False, **fields) -> dict:
    """One chat through the lifecycle: its status, ``Retry-After``, error
    code and stage, content (streamed or not), the SSE error event's type,
    and the client's time to the first content piece."""
    body = {"model": "llama3-8b", "messages": [{"role": "user", "content": prompt}],
            "max_tokens": max_tokens, "stream": stream, **fields}
    t0 = time.perf_counter()
    async with session.post(base + "/serve/openai/v1/chat/completions", json=body) as r:
        out = dict(status=r.status, retry_after=r.headers.get("Retry-After"), code=None,
                   stage=None, content="", tokens=None, error=None, first_text_s=None)
        if r.status != 200:
            payload = await r.json()
            out.update(code=payload.get("code"), stage=payload.get("stage"))
        elif not stream:
            payload = await r.json()
            out.update(content=payload["choices"][0]["message"]["content"],
                       tokens=payload["usage"]["completion_tokens"])
        else:
            pieces = []
            async for raw in r.content:
                line = raw.decode().strip()
                if not line.startswith("data: {"):
                    continue
                chunk = json.loads(line[len("data: "):])
                if "error" in chunk:
                    out["error"] = chunk["error"]["type"]
                    continue
                piece = chunk["choices"][0]["delta"].get("content")
                if piece:
                    out["first_text_s"] = out["first_text_s"] or time.perf_counter() - t0
                    pieces.append(piece)
            out["content"] = "".join(pieces)
    out["total_s"] = time.perf_counter() - t0
    return out


async def until(predicate, timeout: float, what: str) -> None:
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("timed out after {} s waiting for {}".format(timeout, what))
        await asyncio.sleep(0.005)


def release_card_memory() -> None:
    """Return a dropped engine's pools and graph memory to the card."""
    gc.collect()
    if torch.device(DEV).type == "cuda":
        torch.cuda.empty_cache()


async def preemption_run(engine, s, base, interactive: bool) -> dict:
    """8 batch-class chats at 128 tokens; with ``interactive``, one
    interactive chat once each has 16 tokens. Returns the batch contents,
    the interactive's engine-side TTFT and client-side first text, and the
    engine's preemptions."""
    preempted0 = engine.counters["preemptions"]
    emitted0 = engine.counters["tokens_emitted"]
    batch = [asyncio.ensure_future(lifecycle_chat(s, base, p, 128, priority="batch"))
             for p in BATCH_PROMPTS]
    await until(lambda: engine.active_slots == 8, 120, "8 batch chats decoding")
    await until(lambda: engine.counters["tokens_emitted"] - emitted0 >= 8 * 16, 120,
                "16 tokens of each batch chat")
    ttft_ms = first_text_ms = None
    if interactive:
        seen = len(engine.ttft_ms)
        hi = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 16, stream=True)
        # the only request admitted for the first time meanwhile (a
        # resumed victim keeps its first TTFT)
        new = list(engine.ttft_ms)[seen:]
        if hi["status"] != 200 or hi["error"] or len(new) != 1:
            raise AssertionError("interactive chat: {}, new TTFTs {}".format(hi, new))
        ttft_ms = new[0]
        first_text_ms = hi["first_text_s"] and hi["first_text_s"] * 1e3
    done = await asyncio.gather(*batch)
    await engine.wait_drained()
    if any(d["status"] != 200 or d["tokens"] != 128 for d in done):
        raise AssertionError("a batch chat failed: {}".format(
            [(d["status"], d["tokens"], d["code"]) for d in done]))
    return dict(contents=[d["content"] for d in done], ttft_ms=ttft_ms,
                first_text_ms=first_text_ms,
                preemptions=engine.counters["preemptions"] - preempted0)


async def default_engine_runs(engine, tokenizer, card: str) -> dict:
    """On one app: the preemption runs (8 batch chats alone, then with an
    interactive arrival), 40 concurrent chats at 16 tokens under the
    default admission bound, a 1 ms TTFT budget on a 2048-bucket prompt, a
    total budget that cuts a stream, then the drain with 4 streams in
    flight."""
    from clearml_serving_tpu_torch.serving.main import drain_app

    async with served(engine, tokenizer) as (app, base, s):
        # the preemption runs come first: the overload below raises the
        # brownout stage, whose batch cap would shorten batch chats
        control = await preemption_run(engine, s, base, interactive=False)
        contended = await preemption_run(engine, s, base, interactive=True)
        if contended["preemptions"] < 1:
            raise AssertionError("no batch chat was preempted")
        same = [a == b for a, b in zip(control["contents"], contended["contents"])]
        log("  preemption: {} preemption(s); batch contents equal to the unpreempted run: "
            "{}; interactive TTFT {:.2f} ms (engine), first text {} ms (client) ({})".format(
                contended["preemptions"], same, contended["ttft_ms"],
                contended["first_text_ms"], card))
        if not all(same):
            raise AssertionError("a preempted batch stream left its unpreempted run")
        t0 = time.perf_counter()
        burst = await asyncio.gather(*[lifecycle_chat(s, base, PROMPTS[i % len(PROMPTS)], 16)
                                       for i in range(40)])
        burst_s = time.perf_counter() - t0
        times = list(engine._admit_times)
        drain_rate = (len(times) - 1) / (times[-1] - times[0]) if len(times) > 1 else None
        ok = [b for b in burst if b["status"] == 200]
        shed = [b for b in burst if b["status"] == 429]
        if len(ok) + len(shed) != 40 or not 1 <= len(shed) <= 8:
            raise AssertionError("overload: {} x 200, {} x 429 of 40 (other: {})".format(
                len(ok), len(shed), [b["status"] for b in burst]))
        if any(b["code"] != "overloaded" or not b["retry_after"] or int(b["retry_after"]) < 1
               for b in shed):
            raise AssertionError("a 429 without Retry-After or code overloaded: {}".format(shed))
        if any(b["tokens"] != 16 for b in ok):
            raise AssertionError("a served chat stopped short of 16 tokens")
        retry_after = sorted(int(b["retry_after"]) for b in shed)
        log("  overload: 40 concurrent chats -> {} x 200, {} x 429 in {:.3f} s; Retry-After "
            "{} s beside the observed admission drain rate {} /s ({})".format(
                len(ok), len(shed), burst_s, retry_after,
                None if drain_rate is None else round(drain_rate, 3), card))
        await engine.wait_drained()
        # a 1 ms TTFT budget cannot hold a 2048-bucket prefill
        ttft = await lifecycle_chat(s, base, LONG_PROMPTS[-1], 8, ttft_timeout=0.001)
        if (ttft["status"], ttft["code"], ttft["stage"]) != (408, "deadline_exceeded", "ttft"):
            raise AssertionError("ttft budget: {}".format(ttft))
        cut = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 1024, stream=True, timeout=1.0)
        if cut["status"] != 200 or cut["error"] != "DeadlineExceededError" or not cut["content"]:
            raise AssertionError("timeout did not cut the stream: {}".format(cut))
        log("  deadlines: ttft_timeout 0.001 s on a 2048-bucket prompt -> {} {} ({}); timeout "
            "1.0 s cut a 1024-token stream after {} characters in {:.3f} s ({})".format(
                ttft["status"], ttft["code"], ttft["stage"], len(cut["content"]),
                cut["total_s"], card))
        await engine.wait_drained()
        # the drain: 4 streams in flight, a new chat meanwhile
        streams = [asyncio.ensure_future(lifecycle_chat(s, base, p, 64, stream=True))
                   for p in PROMPTS]
        await until(lambda: engine.active_slots == 4, 120, "4 streams decoding")
        t0 = time.perf_counter()
        drain = asyncio.ensure_future(drain_app(app, timeout=60.0))
        await asyncio.sleep(0.05)
        late = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 8)
        async with s.get(base + "/ready") as r:
            ready = (r.status, (await r.json())["status"])
        finished = await asyncio.gather(*streams)
        await drain
        drain_s = time.perf_counter() - t0
        if (late["status"], late["code"], bool(late["retry_after"])) != (503, "draining", True):
            raise AssertionError("a chat during the drain: {}".format(late))
        if ready != (503, "draining"):
            raise AssertionError("/ready during the drain: {}".format(ready))
        if any(f["status"] != 200 or f["error"] or not f["content"] for f in finished):
            raise AssertionError("an in-flight stream did not finish: {}".format(finished))
        await engine.wait_drained()
        pool = engine.paged_cache.pool
        if engine.health()["ready"] or pool.free_pages != pool.num_pages - 1:
            raise AssertionError("after the drain: ready {} free pages {} of {}".format(
                engine.health()["ready"], pool.free_pages, pool.num_pages - 1))
        log("  drain: 4 streams in flight finished with 200, a new chat got 503 draining, "
            "/ready 503 draining; drained and stopped in {:.3f} s, every page back "
            "({})".format(drain_s, card))
    return dict(control=control, contended=contended, ok=len(ok), shed=len(shed),
                retry_after=retry_after, drain_rate=drain_rate, burst_s=burst_s,
                ttft_status=ttft["status"], cut_chars=len(cut["content"]), drain_s=drain_s)


async def watchdog_run(engine, tokenizer, card: str) -> dict:
    """A 2 s watchdog; the retire leg stalls 6 s (injected) while 4 chats
    have chunks in flight: they get 503 engine_stalled, /ready reads 503
    until recovery, then 200; the pool's free pages and the next greedy
    chat's content equal those before the trip."""
    from clearml_serving_tpu_torch.llm import faults

    async with served(engine, tokenizer) as (_app, base, s):
        before = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 32)
        await engine.wait_drained()
        free0 = engine.paged_cache.pool.free_pages
        victims = [asyncio.ensure_future(lifecycle_chat(s, base, p, 512)) for p in PROMPTS]
        await until(lambda: engine.active_slots == 4 and len(engine._inflight) > 0, 120,
                    "4 chats with chunks in flight")
        faults.configure([{"point": "engine.decode.stall", "action": "delay", "delay": 6.0,
                           "times": 1}])
        try:
            t_503 = t_200 = None
            t0 = time.perf_counter()
            while t_200 is None and time.perf_counter() - t0 < 60:
                async with s.get(base + "/ready") as r:
                    now = time.perf_counter()
                    if r.status == 503 and t_503 is None:
                        t_503 = now
                    elif r.status == 200 and t_503 is not None:
                        t_200 = now
                await asyncio.sleep(0.02)
            outcomes = await asyncio.gather(*victims)
        finally:
            faults.clear()
        await engine.wait_drained()
        free1 = engine.paged_cache.pool.free_pages
        after = await lifecycle_chat(s, base, LIFECYCLE_PROMPT, 32)
        trips = engine.counters["watchdog_trips"]
        await engine.wait_drained()
    codes = [(o["status"], o["code"]) for o in outcomes]
    if codes != [(503, "engine_stalled")] * 4 or trips != 1:
        raise AssertionError("watchdog: victims {} trips {}".format(codes, trips))
    if t_503 is None or t_200 is None:
        raise AssertionError("/ready never went 503 then 200")
    if free1 != free0 or after["content"] != before["content"] or after["status"] != 200:
        raise AssertionError("after recovery: free pages {} vs {}, content equal {}".format(
            free1, free0, after["content"] == before["content"]))
    log("  watchdog: 4 in-flight chats -> 503 engine_stalled, one trip; /ready 503 -> 200 "
        "in {:.3f} s (trip to ready, most of it the injected 6 s stall's remainder); free "
        "pages {} before, {} after; the next chat's content equals the one before "
        "({})".format(
            t_200 - t_503, free0, free1, card))
    return dict(trip_to_ready_s=t_200 - t_503, free_pages=free1, trips=trips)


def phase_lifecycle(params, card: str, preset: str = "llama3-8b") -> dict:
    """Phase 7: the default route's request lifecycle at full width, bf16
    KV, default depth 2 with graphs, max_batch 8, behind the HTTP app, with
    the reference's default lifecycle knobs (max_pending 32, a 30 s
    watchdog, preemption, brownout): preemption (8 batch chats, one
    interactive) against the same chats alone and against an engine with
    preemption off; the overload burst, the deadlines and the drain; the
    watchdog on an engine with a 2 s interval. The decode kernel must have
    launched once per layer per decode step of the default engine's
    traffic."""
    from clearml_serving_tpu_torch.ops.paged_attention import paged_attention

    t_phase = time.perf_counter()
    engine, tokenizer = _engine(params, "", preset)
    defaults = (engine.max_pending, engine._watchdog_interval, engine._preempt,
                engine._brownout is not None)
    if defaults != (32, 30.0, True, True):
        raise AssertionError("default lifecycle knobs: {}".format(defaults))
    n_layers = engine.model.n_layers
    paged_attention.launches = 0
    for key in engine.counters:
        engine.counters[key] = 0
    runs = asyncio.run(default_engine_runs(engine, tokenizer, card))
    c = dict(engine.counters)
    launches = paged_attention.launches
    if c["decode_steps"] == 0 or launches != n_layers * c["decode_steps"]:
        raise AssertionError("paged_attention launched {} times for {} decode steps".format(
            launches, c["decode_steps"]))
    control, contended = runs.pop("control"), runs.pop("contended")
    del engine
    release_card_memory()

    async def unpreempted_run(engine, tokenizer):
        async with served(engine, tokenizer) as (_app, base, s):
            return await preemption_run(engine, s, base, interactive=True)

    engine, tokenizer = _engine(params, "", preset, preemption=False)
    unpreempted = asyncio.run(unpreempted_run(engine, tokenizer))
    del engine
    release_card_memory()
    if unpreempted["preemptions"] or unpreempted["contents"] != control["contents"]:
        raise AssertionError("preemption off: {} preemptions, contents equal {}".format(
            unpreempted["preemptions"], unpreempted["contents"] == control["contents"]))
    log("  interactive TTFT with preemption {:.2f} ms, without {:.2f} ms (engine; client "
        "first text {} vs {} ms) ({})".format(
            contended["ttft_ms"], unpreempted["ttft_ms"], contended["first_text_ms"],
            unpreempted["first_text_ms"], card))
    engine, tokenizer = _engine(params, "", preset, watchdog_interval=2)
    watchdog = asyncio.run(watchdog_run(engine, tokenizer, card))
    del engine
    release_card_memory()
    out = dict(card=card, preemptions=contended["preemptions"],
               ttft_ms_preempt=contended["ttft_ms"], ttft_ms_no_preempt=unpreempted["ttft_ms"],
               first_text_ms_preempt=contended["first_text_ms"],
               first_text_ms_no_preempt=unpreempted["first_text_ms"],
               launches=launches, decode_steps=c["decode_steps"], sheds=c["sheds_queue"],
               deadline_ttft=c["deadline_ttft"], deadline_total=c["deadline_total"],
               **runs, **watchdog, seconds=time.perf_counter() - t_phase)
    log("  phase 7 in {:.1f} s".format(out["seconds"]))
    return out


def llama3_8b_params() -> dict:
    """Phase 5's weights: Llama-3-8B at full width on the card, random from
    seed 0. Random weights emit random ids; the byte tokenizer renders only
    ids < 256, so the lm_head keeps its columns for the 256 byte ids and
    zeroes the rest: the model then writes text (and never EOS)."""
    from clearml_serving_tpu_torch.models.llama import init_params

    t0 = time.perf_counter()
    params = init_params({"preset": "llama3-8b"}, torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    params["lm_head"][:, 256:] = 0
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  [params["embed"], params["lm_head"], params["final_norm"]]
                  + [w for layer in params["layers"] for w in layer.values()])
    log("  weights {:.2f} GB made in {:.1f} s".format(n_bytes / 1e9, time.perf_counter() - t0))
    return params


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from clearml_serving_tpu_torch.models.llama import Llama
    from clearml_serving_tpu_torch.ops import _build
    from clearml_serving_tpu_torch.ops.quant import quantize_llama_params

    t_start = time.perf_counter()
    card = card_line()
    log("phase 1: card", card)
    log("  torch {} cuda {} device {} x{}".format(
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-1]
    log("  nvcc", nvcc)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 2: build kernels")
    t0 = time.perf_counter()
    _build.load_library()
    log("  built in {:.1f} s ({})".format(
        time.perf_counter() - t0, _build.BUILD_DIR / _build.LIB_NAME))
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  ptxas:", line.strip())

    gen = torch.Generator("cuda").manual_seed(0)
    kern = phase_kernels(gen)
    rkern = phase_ragged_kernel(gen)
    tkern = phase_tree_kernel(gen)
    int4k = phase_int4_kernel(gen)
    phase_small_model(0)
    phase_small_ragged(0)
    phase_small_verify(0)
    phase_small_model(0, "int4")
    phase_small_ragged(0, "int4")

    log("phase 5: main path, llama3-8b full width bf16 behind the HTTP server")
    params = llama3_8b_params()
    runs = [phase_main_path(params, ""), phase_main_path(params, "int8")]
    log("phase 5b: ragged main path, llama3-8b full width, scheduler ragged, "
        "step_token_budget 256")
    ragged_runs = [phase_ragged_main_path(params, ""), phase_ragged_main_path(params, "int8")]
    log("phase 5c: w4a16 main path, llama3-8b full width, int4 weights quantized on the card")
    t0 = time.perf_counter()
    # after the lm_head's columns past the byte ids are zeroed: a zero column
    # quantizes to scale 1.0 and level 0, so it stays exactly zero
    qparams = quantize_llama_params(params, bits=4)
    sync()
    log("  quantized in {:.1f} s".format(time.perf_counter() - t0))
    # the packed tree with its redundant knob under phase 5's traffic with
    # two long prompts (prefills of 1024 and 2048 rows through the kernel),
    # then 5b's; then build_engine quantizes the bf16 tree to int8 itself
    long_prefills = PROMPTS[:2] + [LONG_PROMPTS[0], LONG_PROMPTS[-1]]
    int4_runs = [phase_main_path(qparams, "", weight_quant="int4", prompts=long_prefills),
                 phase_ragged_main_path(qparams, "", weight_quant="int4")]
    if max(int4_runs[0]["prefill_rows"]) <= 512:
        raise AssertionError("no int4 prefill above 512 rows: {}".format(
            int4_runs[0]["prefill_rows"]))
    int8_run = phase_main_path(params, "", weight_quant="int8", max_tokens=8)
    log("phase 5d: speculative verify rows, llama3-8b full width, scheduler ragged, "
        "step_token_budget 256, speculation ngram, spec_k 4")
    spec_runs = [phase_spec_main_path(params, arm, kv, knobs) for arm, kv, knobs in SPEC_ARMS]
    compare_spec_streams(spec_runs, Llama({"preset": "llama3-8b"}, params))
    for run in spec_runs:
        run["contents"] = [text[:24] for text in run["contents"]]
        del run["token_ids"]
    log("phase 5e: pipelined decode, llama3-8b full width, each decode chunk one CUDA-graph "
        "replay")
    graph_cases = [graph_chunk_case(qparams if weights else params, kv, weights, sampled)
                   for kv, weights in GRAPH_CASES for sampled in (False, True)]
    pipeline_runs = phase_pipeline_arms(params)
    log("phase 6: where the time goes")
    prof = phase_profile(params)
    serial_prof = phase_profile(params, pipeline_depth=1, cuda_graphs=False)
    # the steadier traffic in each arm of phase 5e
    steady_profs = [phase_profile(params, pipeline_depth=depth, cuda_graphs=cuda_graphs,
                                  traffic=PIPELINE_TRAFFIC[1])
                    for _arm, depth, cuda_graphs in PIPELINE_ARMS]
    ragged_prof = phase_profile(params, "ragged")
    tree_prof = phase_profile(params, "ragged-tree")
    int4_prof = phase_profile(qparams, weight_quant="int4")
    log("phase 7: request lifecycle, llama3-8b full width behind the HTTP server, default "
        "lifecycle knobs")
    lifecycle = phase_lifecycle(params, card)

    t = kern["timings"]
    rt = rkern["timings"]
    tt = tkern["timings"]
    tree_bf16 = next(r for r in spec_runs if r["arm"] == "tree" and r["kv"] == "bf16")
    tree_int8 = next(r for r in spec_runs if r["arm"] == "tree" and r["kv"] == "int8")

    def per_replay(kernel, kv, weights):
        """The launches one replay of phase 5e's greedy chunk added."""
        return next(g["launches_per_replay"][kernel] for g in graph_cases
                    if (g["kv"], g["weights"], g["variant"]) == (kv, weights, "greedy"))
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/paged_attention.cu",
        "replaces": "clearml_serving_tpu/ops/paged_attention.py:399",
        "tpu": "ops/paged_attention.py:399",
        "launches": runs[0]["launches"],
        "launches_int8": runs[1]["launches"],
        # counted in one replay of phase 5e's decode chunk (bf16 / int8 KV)
        "launches_per_replay": per_replay("paged_attention", "bf16", "bf16"),
        "launches_per_replay_int8": per_replay("paged_attention", "int8", "bf16"),
        "max_abs_err": kern["err_bf16"],
        "max_err_bf16": kern["err_bf16"],
        "max_err_int8": kern["err_int8"],
        # primary shape: 8 rows x 1024 tokens, bf16 pools; CUDA-graph device
        # time (eager_ms: calls one after another through the wrapper)
        "ms": t["bf16_8x1024"]["ms"],
        "eager_ms": t["bf16_8x1024"]["eager_ms"],
        "plain_ms": t["bf16_8x1024"]["plain_ms"],
        "bound_ms": t["bf16_8x1024"]["bound_ms"],
        "bound_by": t["bf16_8x1024"]["bound_by"],
        "library_ms": None,
        # a yardstick that reads no page table: SDPA over the K/V gathered contiguous
        "sdpa_gathered_ms": t["bf16_8x1024"]["sdpa_gathered_ms"],
        "ms_int8": t["int8_8x1024"]["ms"],
        "plain_ms_int8": t["int8_8x1024"]["plain_ms"],
        "bound_ms_int8": t["int8_8x1024"]["bound_ms"],
        "per_case": [dict(case=name, **row) for name, row in t.items()],
        "launches_ragged_path": ragged_runs[0]["paged_launches"],
    }, {
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "clearml_serving_tpu/ops/paged_attention.py:881",
        "tpu": "ops/paged_attention.py:881",
        "launches": ragged_runs[0]["ragged_launches"],
        "launches_int8": ragged_runs[1]["ragged_launches"],
        "max_abs_err": rkern["err_bf16"],
        "max_err_bf16": rkern["err_bf16"],
        "max_err_int8": rkern["err_int8"],
        # primary shape: the mixed launch (7 decode rows at 1024 + a 128-token
        # chunk); CUDA-graph device time (eager_ms: calls one after another
        # through the wrapper)
        "ms": rt["mixed_bf16"]["ms"],
        "eager_ms": rt["mixed_bf16"]["eager_ms"],
        "plain_ms": rt["mixed_bf16"]["plain_ms"],
        "bound_ms": rt["mixed_bf16"]["bound_ms"],
        "bound_by": rt["mixed_bf16"]["bound_by"],
        "library_ms": None,
        "ms_int8": rt["mixed_int8"]["ms"],
        "eager_ms_int8": rt["mixed_int8"]["eager_ms"],
        "plain_ms_int8": rt["mixed_int8"]["plain_ms"],
        "bound_ms_int8": rt["mixed_int8"]["bound_ms"],
        # one 512-token chunk at history 1536
        "ms_prefill": rt["prefill_bf16"]["ms"],
        "eager_ms_prefill": rt["prefill_bf16"]["eager_ms"],
        "plain_ms_prefill": rt["prefill_bf16"]["plain_ms"],
        "bound_ms_prefill": rt["prefill_bf16"]["bound_ms"],
        "bound_by_prefill": rt["prefill_bf16"]["bound_by"],
        # a yardstick that reads no page table: SDPA, lower-right causal,
        # over the prefill row's K/V gathered contiguous
        "sdpa_gathered_ms_prefill": rt["prefill_bf16"]["sdpa_gathered_ms"],
        "per_case": [dict(case=name, **row) for name, row in rt.items()],
    }, {
        "name": "ragged_paged_attention[tree_anc]",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "clearml_serving_tpu/ops/paged_attention.py:701",
        "tpu": "ops/paged_attention.py:701-722, the tree branch of the kernel called at :881",
        # phase 5d's tree arm: once per layer per verify step
        "launches": tree_bf16["tree_launches"],
        "launches_int8": tree_int8["tree_launches"],
        "max_abs_err": tkern["err_bf16"],
        "max_err_bf16": tkern["err_bf16"],
        "max_err_int8": tkern["err_int8"],
        # primary shape: phase 5d's verify launch (4 forest verify rows of 5 at
        # 300-550 history, 2 decode rows, every row's keys split); CUDA-graph
        # device time (eager_ms: calls one after another)
        "ms": tt["verify_forest_bf16"]["ms"],
        "eager_ms": tt["verify_forest_bf16"]["eager_ms"],
        "plain_ms": tt["verify_forest_bf16"]["plain_ms"],
        "bound_ms": tt["verify_forest_bf16"]["bound_ms"],
        "bound_by": tt["verify_forest_bf16"]["bound_by"],
        "library_ms": None,
        # the same launch without the mask, in graph replays alternating
        # with it; mask_cost_ms: the median of the pairs' differences
        "ms_without_mask": tt["verify_forest_bf16"]["untree_ms"],
        "mask_cost_ms": tt["verify_forest_bf16"]["mask_cost_ms"],
        # the same launch with one span (split off), alternating with it;
        # split_gain_ms: the median of (one span - split)
        "ms_one_span": tt["verify_forest_bf16"]["one_span_ms"],
        "split_gain_ms": tt["verify_forest_bf16"]["split_gain_ms"],
        "ms_chain": tt["verify_chain_bf16"]["ms"],
        "ms_int8": tt["verify_forest_int8"]["ms"],
        "eager_ms_int8": tt["verify_forest_int8"]["eager_ms"],
        "ms_int8_without_mask": tt["verify_forest_int8"]["untree_ms"],
        "mask_cost_ms_int8": tt["verify_forest_int8"]["mask_cost_ms"],
        "ms_int8_one_span": tt["verify_forest_int8"]["one_span_ms"],
        "plain_ms_int8": tt["verify_forest_int8"]["plain_ms"],
        "bound_ms_int8": tt["verify_forest_int8"]["bound_ms"],
        "per_case": [dict(case=name, **row) for name, row in tt.items()],
    }, {
        "name": "fused_int4_matmul",
        "route": "cuda",
        "source": "clearml_serving_tpu_torch/csrc/fused_int4_matmul.cu",
        "replaces": "clearml_serving_tpu/ops/fused_matmul.py:271",
        "tpu": "ops/fused_matmul.py:271",
        # phase 5c under phase 5's traffic with long prompts: 225 per forward call
        "launches": int4_runs[0]["int4_launches"],
        "launches_ragged_path": int4_runs[1]["int4_launches"],
        # counted in one replay of phase 5e's decode chunk on int4 weights
        "launches_per_replay": per_replay("fused_int4_matmul", "bf16", "int4"),
        "max_abs_err": int4k["err"],
        # primary call: a decode batch through w_gate / w_up
        "shape": "x[{1},4096] @ W[4096,14336] ({0})".format(*INT4_PRIMARY),
        **{key: int4k["timings"][INT4_PRIMARY][key]
           for key in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                       "library_error", "bf16_ms")},
        # the 225 calls of one decode step at M = 8, summed from the shapes' times
        "decode_step": int4k["decode_step"],
        # the block tiling: one ragged step's 224 projection calls at M = 312
        "ragged_step": int4k["ragged_step"],
        "per_shape": [dict(shape=name, m=m, **row)
                      for (name, m), row in int4k["timings"].items()],
    }]}
    log("main path:", json.dumps({"runs": runs, "ragged_runs": ragged_runs,
                                  "int4_runs": int4_runs, "int8_run": int8_run,
                                  "spec_runs": spec_runs, "graph_cases": graph_cases,
                                  "pipeline_runs": pipeline_runs,
                                  "profile": prof, "serial_profile": serial_prof,
                                  "steady_profiles": steady_profs,
                                  "ragged_profile": ragged_prof,
                                  "tree_profile": tree_prof,
                                  "int4_profile": int4_prof,
                                  "lifecycle": lifecycle}))
    log("total {:.1f} s".format(time.perf_counter() - t_start))
    print(card)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
