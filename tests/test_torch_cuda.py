"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc: the CUDA
paged attention kernels (decode and ragged, the ragged one with and without
its draft-tree mask) and the w4a16 matmul against their plain PyTorch
versions, their gates and launch counts, and the engine on the card under
both schedulers, with bf16 and int4 weights and with speculative verify
rows, and its request lifecycle over CUDA-graph replays (watchdog recovery,
a capture inside the watchdog's grace, a preemption), the prefix cache's
shared pages and its host-RAM tier's stream-ordered copies. They skip
elsewhere. This file
imports neither jax nor the JAX package, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance for kernel vs plain version: atol = rtol = 2e-2 (bf16 output
rounding and another summation order; the plain version computes in f32 on
the same operands)."""

import asyncio
import ctypes
import json
import time
import types

import pytest
import torch

from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.models.llama import Llama, init_params, kv_store
from clearml_serving_tpu_torch.ops._build import load_library
from clearml_serving_tpu_torch.ops.fused_matmul import fused_int4_matmul, int4_matmul_plain
from clearml_serving_tpu_torch.ops.paged_attention import (
    RAGGED_QB,
    paged_attention,
    paged_attention_ref,
    ragged_layout,
    ragged_paged_attention,
    ragged_paged_attention_ref,
    ragged_split_plan,
    split_plan,
    tree_ancestors,
)
from clearml_serving_tpu_torch.ops.quant import quantize_int4, quantize_llama_params

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-2, atol=2e-2)
MIXED = [0, 1, 17, 130, 511, 64, 32, 300]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run this file on the card)")
    return torch.device("cuda")


def _operands(dev, *, g, d, page_size, quant, lengths=MIXED, hkv=4, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    b = len(lengths)
    pp = -(-max(lengths) // page_size) + 1
    n = b * pp + 1
    q = torch.randn(b, hkv, g, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(hkv, n, page_size, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(hkv, n, page_size, d, generator=gen, device=dev).bfloat16()
    scales = {}
    if quant:
        k, ks = kv_store(k, "int8", torch.bfloat16)
        v, vs = kv_store(v, "int8", torch.bfloat16)
        scales = {"k_scale": ks, "v_scale": vs}
    table = (torch.randperm(n - 1, generator=gen, device=dev).int() + 1).reshape(b, pp)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, table.contiguous(), lens, scales


@pytest.mark.parametrize("page_size", [16, 32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_kernel_matches_plain_version(cuda, quant, g, d, page_size):
    q, k, v, table, lens, scales = _operands(cuda, g=g, d=d, page_size=page_size,
                                             quant=quant)
    before = paged_attention.launches
    out = paged_attention(q, k, v, table, lens, **scales)
    assert paged_attention.launches == before + 1
    ref = paged_attention_ref(q.float(), k if quant else k.float(),
                              v if quant else v.float(), table, lens, **scales)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref, **TOL)
    assert torch.equal(out[0], torch.zeros_like(out[0]))  # length 0 -> zeros


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_table_entries_past_the_length_are_never_read(cuda, quant):
    q, k, v, table, lens, scales = _operands(cuda, g=4, d=128, page_size=16, quant=quant)
    out = paged_attention(q, k, v, table, lens, **scales)
    poisoned = table.clone()
    for i, n in enumerate(lens.tolist()):
        poisoned[i, -(-n // 16):] = 2 ** 30   # an out-of-range read would fault
    out2 = paged_attention(q, k, v, poisoned, lens, **scales)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


def _span_lengths(page_size, hkv=4):
    """Twelve lengths at every boundary of the kernel's key-range split for
    a table of more than three spans: 0, 1, a page, each span's edges, and
    the table's capacity."""
    pp = 1
    while True:  # the plan depends on the table width: find one with > 3 spans
        splits, span = split_plan(12, hkv, pp, page_size)
        if pp * page_size > 3 * span:
            break
        pp += 1
    lengths = [0, 1, page_size - 1, page_size, span - 1, span, span + 1, 2 * span - 1,
               2 * span, 2 * span + 1, 3 * span, pp * page_size]
    return lengths, splits, span


@pytest.mark.parametrize("page_size", [16, 32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 3, 4, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_kernel_at_every_span_boundary(cuda, quant, g, d, page_size):
    lengths, splits, _span = _span_lengths(page_size)
    assert splits >= 4
    q, k, v, table, lens, scales = _operands(cuda, g=g, d=d, page_size=page_size,
                                             quant=quant, lengths=lengths)
    pp = table.shape[1]
    table = table[:, :pp - 1].contiguous()  # capacity = the longest length
    out = paged_attention(q, k, v, table, lens, **scales)
    ref = paged_attention_ref(q.float(), k if quant else k.float(),
                              v if quant else v.float(), table, lens, **scales)
    poisoned = table.clone()
    for i, n in enumerate(lengths):
        poisoned[i, -(-n // page_size):] = 2 ** 30   # an out-of-range read would fault
    out2 = paged_attention(q, k, v, poisoned, lens, **scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, **TOL)
    assert torch.equal(out, out2)
    assert torch.equal(out[0], torch.zeros_like(out[0]))  # length 0 -> zeros


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_two_calls_give_equal_bits(cuda, quant):
    q, k, v, table, lens, scales = _operands(cuda, g=4, d=128, page_size=16, quant=quant,
                                             lengths=[2000, 1, 700, 0, 1024, 63, 64, 65])
    before = paged_attention.launches
    out = paged_attention(q, k, v, table, lens, **scales)
    again = paged_attention(q, k, v, table, lens, **scales)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 2  # two grids a call, one count
    assert torch.equal(out, again)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_graph_captured_call_gives_the_eager_bits(cuda, quant):
    # a host read of a device value in the wrapper would make the capture raise
    q, k, v, table, lens, scales = _operands(cuda, g=4, d=128, page_size=16, quant=quant,
                                             lengths=[1500, 17, 0, 256, 1024, 255, 600, 1])
    eager = paged_attention(q, k, v, table, lens, **scales)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = paged_attention(q, k, v, table, lens, **scales)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    lens.copy_(torch.tensor([3, 17, 1, 0, 1024, 2000, 600, 64], dtype=torch.int32))
    graph.replay()  # new lengths, same graph: no length was baked in on the host
    ref = paged_attention(q, k, v, table, lens, **scales)
    torch.cuda.synchronize()
    assert torch.equal(captured, ref)


def test_gate_violation_raises_on_cuda(cuda):
    q, k, v, table, lens, _ = _operands(cuda, g=4, d=64, page_size=16, quant=False)
    with pytest.raises(ValueError, match="gate q.dtype"):
        paged_attention(q.float(), k, v, table, lens)
    with pytest.raises(ValueError, match="gate page_table"):
        paged_attention(q, k, v, table.long(), lens)


def test_engine_on_the_card_runs_the_kernel(cuda):
    cfg = {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4,
           "n_kv_heads": 2, "head_dim": 64, "ffn_dim": 512, "dtype": "bfloat16"}
    model = Llama(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda))
    engine = LLMEngineCore(model, max_batch=2, max_seq_len=128, decode_steps=4,
                           page_size=16, prefill_buckets=[32, 64])

    async def run():
        async def one(n):
            return [t async for t in engine.generate(
                GenRequest(prompt_ids=list(range(1, n + 1)), max_new_tokens=9))]
        return await asyncio.gather(one(5), one(40), one(20))

    paged_attention.launches = 0
    streams = asyncio.run(run())
    assert all(1 <= len(s) <= 9 for s in streams)
    assert paged_attention.launches == model.n_layers * engine.counters["decode_steps"] > 0
    pool = engine.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1


# small models of the paged path's families at head_dim 256 and 128: Gemma's
# deltas (tied, offset norms, GeGLU, embed scale) with one and with eight
# query heads per KV head, Qwen2's biases, Llama-3.1's scaled RoPE
FAMILY_CFGS = {
    "gemma_g1": {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 2, "n_kv_heads": 2,
                 "head_dim": 256, "ffn_dim": 512, "dtype": "bfloat16", "tie_embeddings": True,
                 "norm_offset": True, "hidden_act": "gelu_pytorch_tanh", "embed_scale": 16.0},
    "gemma_g8": {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 8, "n_kv_heads": 1,
                 "head_dim": 256, "ffn_dim": 512, "dtype": "bfloat16", "tie_embeddings": True,
                 "norm_offset": True, "hidden_act": "gelu_pytorch_tanh", "embed_scale": 16.0},
    "qwen2": {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4, "n_kv_heads": 1,
              "head_dim": 128, "ffn_dim": 512, "dtype": "bfloat16", "attn_bias": True},
    "llama3_rope": {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4,
                    "n_kv_heads": 2, "head_dim": 64, "ffn_dim": 512, "dtype": "bfloat16",
                    "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                                     "original_max_position_embeddings": 32}},
}


@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("family", sorted(FAMILY_CFGS))
def test_family_engine_on_the_card_runs_the_kernels(cuda, family, kv_quant, scheduler):
    """Each family's engine builds past the gates and serves through the
    kernels: every decode step one paged launch a layer, every ragged step
    one ragged launch a layer, and every page comes back."""
    cfg = dict(FAMILY_CFGS[family], **({"kv_quant": kv_quant} if kv_quant else {}))
    model = Llama(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda))
    knobs = {"scheduler": "ragged", "step_token_budget": 16} if scheduler == "ragged" else {}
    engine = LLMEngineCore(model, max_batch=2, max_seq_len=128, decode_steps=4,
                           page_size=32 if kv_quant else 16, prefill_buckets=[32, 64], **knobs)

    async def run():
        async def one(n, delay):
            await asyncio.sleep(delay)
            return [t async for t in engine.generate(
                GenRequest(prompt_ids=list(range(1, n + 1)), max_new_tokens=9))]
        return await asyncio.gather(one(5, 0.0), one(40, 0.05), one(20, 0.1))

    paged_attention.launches = 0
    ragged_paged_attention.launches = 0
    streams = asyncio.run(run())
    c = engine.counters
    engine.stop()
    assert all(1 <= len(s) <= 9 for s in streams)
    assert ragged_paged_attention.launches == model.n_layers * c["ragged_steps"]
    assert paged_attention.launches == model.n_layers * (
        c["decode_steps"] + c["ragged_chain_steps"]) > 0
    if scheduler == "ragged":
        assert c["ragged_steps"] > 0
    pool = engine.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1


# ragged rows: (span in the flat axis, query tokens, history before them).
# Decode rows, a 4-token multi-step decode span (positions 1..3 are pads),
# prefill chunks at history 0 and mid-history crossing page boundaries, an
# idle row, a chunk longer than two q blocks.
RAGGED_ROWS = [(1, 1, 40), (4, 1, 17), (13, 13, 0), (0, 0, 0), (9, 9, 35), (1, 1, 0),
               (21, 21, 100)]


def _ragged_operands(dev, *, g, d, page_size, quant, rows=RAGGED_ROWS, hkv=4, seed=0,
                     extra_blocks=2, pp=None):
    gen = torch.Generator(dev).manual_seed(seed)
    spans = [s for s, _, _ in rows]
    row_lens = torch.tensor([n for _, n, _ in rows], dtype=torch.int32)
    kv_lens = row_lens + torch.tensor([h for _, _, h in rows], dtype=torch.int32)
    starts, block_rows, block_q0, t_pad = ragged_layout(spans, RAGGED_QB)
    t_pad += extra_blocks * RAGGED_QB         # unowned blocks at the end
    block_rows = list(block_rows) + [-1] * extra_blocks
    block_q0 = list(block_q0) + [0] * extra_blocks
    r = len(rows)
    pp = pp or -(-int(kv_lens.max()) // page_size) + 1
    n = r * pp + 1
    q = torch.randn(t_pad, hkv, g, d, generator=gen, device=dev).bfloat16()
    k = torch.randn(hkv, n, page_size, d, generator=gen, device=dev).bfloat16()
    v = torch.randn(hkv, n, page_size, d, generator=gen, device=dev).bfloat16()
    scales = {}
    if quant:
        k, ks = kv_store(k, "int8", torch.bfloat16)
        v, vs = kv_store(v, "int8", torch.bfloat16)
        scales = {"k_scale": ks, "v_scale": vs}
    table = (torch.randperm(n - 1, generator=gen, device=dev).int() + 1).reshape(r, pp)
    i32 = dict(dtype=torch.int32, device=dev)
    args = (q, k, v, table.contiguous(), kv_lens.to(dev), torch.tensor(starts, **i32),
            row_lens.to(dev))
    blocks = dict(block_rows=torch.tensor(block_rows, **i32),
                  block_q0=torch.tensor(block_q0, **i32))
    return args, blocks, scales


def _owned(args):
    _q, _k, _v, _table, _kv, starts, row_lens = args
    owned = torch.zeros(args[0].shape[0], dtype=torch.bool)
    for s, n in zip(starts.tolist(), row_lens.tolist()):
        owned[s:s + n] = True
    return owned.to(args[0].device)


@pytest.mark.parametrize("page_size", [16, 32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_ragged_kernel_matches_plain_version(cuda, quant, g, d, page_size):
    args, blocks, scales = _ragged_operands(cuda, g=g, d=d, page_size=page_size, quant=quant)
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*args, **blocks, **scales)
    assert ragged_paged_attention.launches == before + 1
    q, k, v = args[:3]
    ref = ragged_paged_attention_ref(q.float(), k if quant else k.float(),
                                     v if quant else v.float(), *args[3:], **scales)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), ref, **TOL)
    owned = _owned(args)
    # multi-step pads, alignment pads and unowned blocks: exact zeros
    assert torch.equal(out[~owned], torch.zeros_like(out[~owned]))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_ragged_table_entries_past_kv_lens_are_never_read(cuda, quant):
    args, blocks, scales = _ragged_operands(cuda, g=4, d=128, page_size=16, quant=quant)
    out = ragged_paged_attention(*args, **blocks, **scales)
    table, kv_lens = args[3], args[4]
    poisoned = table.clone()
    for i, n in enumerate(kv_lens.tolist()):
        poisoned[i, -(-n // 16):] = 2 ** 30   # an out-of-range read would fault
    out2 = ragged_paged_attention(*args[:3], poisoned, *args[4:], **blocks, **scales)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


def test_ragged_gate_violations_raise_on_cuda(cuda):
    args, blocks, _ = _ragged_operands(cuda, g=4, d=64, page_size=16, quant=False)
    q = args[0]
    for bad in (torch.full((q.shape[0], 4), -2, dtype=torch.int64, device=cuda),
                torch.full((q.shape[0] - RAGGED_QB, 4), -2, dtype=torch.int32, device=cuda),
                torch.full((q.shape[0], 65), -2, dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError, match="ragged_paged_attention gate tree_anc"):
            ragged_paged_attention(*args, **blocks, tree_anc=bad)
    with pytest.raises(ValueError, match="gate block_map"):
        ragged_paged_attention(*args)
    with pytest.raises(ValueError, match="gate q_block"):
        ragged_paged_attention(q[:-1].contiguous(), *args[1:], **blocks)
    with pytest.raises(ValueError, match="gate q.dtype"):
        ragged_paged_attention(q.float(), *args[1:], **blocks)
    with pytest.raises(ValueError, match="gate page_table"):
        ragged_paged_attention(*args[:3], args[3].long(), *args[4:], **blocks)
    with pytest.raises(ValueError, match="gate head_dim"):
        ragged_paged_attention(q[..., :32].contiguous(), args[1][..., :32].contiguous(),
                               args[2][..., :32].contiguous(), *args[3:], **blocks)


def test_ragged_engine_on_the_card_runs_both_kernels(cuda):
    cfg = {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4,
           "n_kv_heads": 2, "head_dim": 64, "ffn_dim": 512, "dtype": "bfloat16"}
    model = Llama(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda))
    engine = LLMEngineCore(model, max_batch=2, max_seq_len=128, decode_steps=4,
                           page_size=16, scheduler="ragged", step_token_budget=16)

    async def run():
        async def one(n, delay):
            await asyncio.sleep(delay)
            return [t async for t in engine.generate(
                GenRequest(prompt_ids=list(range(1, n + 1)), max_new_tokens=9))]
        return await asyncio.gather(one(5, 0.0), one(40, 0.05), one(20, 0.1))

    paged_attention.launches = 0
    ragged_paged_attention.launches = 0
    streams = asyncio.run(run())
    c = engine.counters
    assert all(1 <= len(s) <= 9 for s in streams)
    assert c["ragged_steps"] > 0
    assert ragged_paged_attention.launches == model.n_layers * c["ragged_steps"]
    assert paged_attention.launches == model.n_layers * (
        c["decode_steps"] + c["ragged_chain_steps"])
    pool = engine.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1



# -- the ragged kernel's key-range split ------------------------------------------

SPLIT_CAPACITY = 1600  # a table of 100 pages of 16 (50 of 32): 7 slots of 256


def _split_rows(page_size):
    """(rows, capacity, span): decode rows at every boundary of the split
    (1, a page, a span's edges, 3 span, the longest that does not split, 3
    span + 1, the shortest that does, 4 span and 4 span + 1, the capacity;
    the kernel splits rows whose keys exceed 3 spans and a span past the
    launch's longest chunk, 130 keys here, into at most max(2, 128 / (8
    long rows * 4 heads)) = 4 spans: of 256 up to 4 span keys, of 320 at 4
    span + 1, of 448 at the capacity), verify rows of 5 queries at 3 span +
    1 (queries 0-3 see nothing in the last span) and at the capacity, a
    4-token multi-step span, rows of 8 (the longest that splits), 9 (the
    shortest that does not) and 130 queries, an idle row."""
    span = 256
    cap = SPLIT_CAPACITY
    rows = [(1, 1, n - 1) for n in (1, page_size - 1, page_size, span - 1, span, span + 1,
                                    3 * span, 3 * span + 1, 4 * span, 4 * span + 1, cap)]
    rows += [(5, 5, 3 * span - 4), (5, 5, cap - 5), (4, 1, 900), (8, 8, 3 * span + 3),
             (9, 9, 0), (130, 130, 0), (0, 0, 0)]
    return rows, cap, span


def _split_operands(cuda, *, g, d, page_size, quant, seed=0):
    rows, cap, span = _split_rows(page_size)
    args, blocks, scales = _ragged_operands(cuda, g=g, d=d, page_size=page_size, quant=quant,
                                            rows=rows, seed=seed, pp=cap // page_size)
    t, hkv = args[0].shape[:2]
    assert ragged_split_plan(t, len(rows), hkv, cap // page_size, page_size) == (7, span)
    return rows, args, blocks, scales


def _poisoned(args, page_size):
    """The page table with every entry past each row's kv_len out of range
    (a read of one would fault)."""
    table, kv_lens = args[3], args[4]
    poisoned = table.clone()
    for i, n in enumerate(kv_lens.tolist()):
        poisoned[i, -(-n // page_size):] = 2 ** 30
    return (*args[:3], poisoned, *args[4:])


@pytest.mark.parametrize("page_size", [16, 32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 3, 4, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_ragged_kernel_at_every_span_boundary(cuda, quant, g, d, page_size):
    _rows, args, blocks, scales = _split_operands(cuda, g=g, d=d, page_size=page_size,
                                                  quant=quant)
    out = ragged_paged_attention(*args, **blocks, **scales)
    q, k, v = args[:3]
    ref = ragged_paged_attention_ref(q.float(), k if quant else k.float(),
                                     v if quant else v.float(), *args[3:], **scales)
    out2 = ragged_paged_attention(*_poisoned(args, page_size), **blocks, **scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, **TOL)
    assert torch.equal(out, out2)
    owned = _owned(args)
    # multi-step pads, dead queries of split blocks and unowned blocks: exact zeros
    assert torch.equal(out[~owned], torch.zeros_like(out[~owned]))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_ragged_two_calls_give_equal_bits(cuda, quant):
    _rows, args, blocks, scales = _split_operands(cuda, g=4, d=128, page_size=16, quant=quant)
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*args, **blocks, **scales)
    again = ragged_paged_attention(*args, **blocks, **scales)
    torch.cuda.synchronize()
    assert ragged_paged_attention.launches == before + 2  # two grids a call, one count
    assert torch.equal(out, again)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_ragged_graph_captured_call_gives_the_eager_bits(cuda, quant):
    # a host read of a device value in the wrapper would make the capture raise
    _rows, args, blocks, scales = _split_operands(cuda, g=4, d=128, page_size=16, quant=quant)
    eager = ragged_paged_attention(*args, **blocks, **scales)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ragged_paged_attention(*args, **blocks, **scales)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    # new histories, same graph: no length was baked in on the host (each
    # short row 97 keys longer: other rows split, into spans of other widths)
    kv_lens, row_lens = args[4], args[6]
    short = ((row_lens >= 1) & (row_lens <= RAGGED_QB)).int()
    kv_lens.copy_(torch.minimum(kv_lens + 97 * short,
                                torch.tensor(SPLIT_CAPACITY, dtype=torch.int32, device=cuda)))
    graph.replay()
    ref = ragged_paged_attention(*args, **blocks, **scales)
    torch.cuda.synchronize()
    assert torch.equal(captured, ref)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_ragged_split_tree_rows(cuda, quant):
    """Verify rows whose keys are split: a forest masks only the span that
    holds the row's own keys (within 2e-2 of the plain version), and a
    chain gives the unmasked launch's bits; each tree call counts one
    launch and one tree launch, a plain call no tree launch."""
    rows, args, blocks, scales = _split_operands(cuda, g=4, d=128, page_size=16, quant=quant)
    verify = {i: TOPOLOGIES["forest"] for i, (_s, n, _h) in enumerate(rows) if n == 5}
    assert len(verify) == 2
    forest = _tree_anc(args, rows, verify, width=5)
    chain = _tree_anc(args, rows, {i: TOPOLOGIES["chain"] for i in verify}, width=5)
    launches, tree_launches = (ragged_paged_attention.launches,
                               ragged_paged_attention.tree_launches)
    _check_tree(args, blocks, scales, forest, quant)
    masked = ragged_paged_attention(*args, **blocks, **scales, tree_anc=chain)
    plain = ragged_paged_attention(*args, **blocks, **scales)
    torch.cuda.synchronize()
    assert torch.equal(masked, plain)
    assert ragged_paged_attention.launches == launches + 3
    assert ragged_paged_attention.tree_launches == tree_launches + 2


# -- the draft-tree mask -----------------------------------------------------------

# verify rows of k+1 = 5 tokens (rows 0, 2 and 5) beside decode rows, a
# prefill chunk and an idle row; the chunk and decode tokens keep the -2
# plain-causal sentinel in the same launch
TREE_ROWS = [(5, 5, 40), (1, 1, 17), (5, 5, 0), (13, 13, 9), (0, 0, 0), (5, 5, 100),
             (1, 1, 3)]
TOPOLOGIES = {
    "chain": ([-1, 0, 1, 2, 3], 5),
    "forest": ([-1, 0, 1, 0, 0], 5),      # a depth-2 branch and two siblings
    "dead_nodes": ([-1, 0, 0, -1, -1], 3),  # nodes 3, 4 past n_nodes
}


def _tree_anc(args, rows, topologies, width):
    """[T, width] ancestor lists: verify row i takes topologies[i] (parents,
    n_nodes); every other token -2."""
    starts = args[5].tolist()
    anc = torch.full((args[0].shape[0], width), -1, dtype=torch.int32)
    anc[:, 0] = -2
    for i, (parents, n_nodes) in topologies.items():
        s = starts[i]
        anc[s:s + len(parents)] = torch.from_numpy(
            tree_ancestors(parents, n_nodes, width=width))
    return anc.to(args[0].device)


def _check_tree(args, blocks, scales, anc, quant):
    before = ragged_paged_attention.launches
    out = ragged_paged_attention(*args, **blocks, **scales, tree_anc=anc)
    assert ragged_paged_attention.launches == before + 1
    q, k, v = args[:3]
    ref = ragged_paged_attention_ref(q.float(), k if quant else k.float(),
                                     v if quant else v.float(), *args[3:], **scales,
                                     tree_anc=anc)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref, **TOL)
    owned = _owned(args)
    assert torch.equal(out[~owned], torch.zeros_like(out[~owned]))
    return out


@pytest.mark.parametrize("topology", ["chain", "forest", "dead_nodes"])
@pytest.mark.parametrize("g,d,page_size", [(4, 128, 16), (8, 64, 32), (1, 256, 16),
                                           (8, 256, 32)])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tree_kernel_matches_plain_version(cuda, quant, g, d, page_size, topology):
    args, blocks, scales = _ragged_operands(cuda, g=g, d=d, page_size=page_size, quant=quant,
                                            rows=TREE_ROWS)
    parents, n_nodes = TOPOLOGIES[topology]
    anc = _tree_anc(args, TREE_ROWS, {0: (parents, n_nodes), 2: (parents, n_nodes),
                                      5: TOPOLOGIES["forest"]}, width=5)
    out = _check_tree(args, blocks, scales, anc, quant)
    plain = ragged_paged_attention(*args, **blocks, **scales)
    torch.cuda.synchronize()
    # the mask changes the verify rows only
    verify = torch.zeros(out.shape[0], dtype=torch.bool, device=cuda)
    for i in (0, 2, 5):
        s = int(args[5][i])
        verify[s:s + 5] = True
    assert torch.equal(out[~verify], plain[~verify])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_chain_topology_is_bitwise_the_plain_kernel(cuda, quant):
    args, blocks, scales = _ragged_operands(cuda, g=4, d=128, page_size=16, quant=quant,
                                            rows=TREE_ROWS)
    anc = _tree_anc(args, TREE_ROWS, {i: TOPOLOGIES["chain"] for i in (0, 2, 5)}, width=5)
    tree = ragged_paged_attention(*args, **blocks, **scales, tree_anc=anc)
    plain = ragged_paged_attention(*args, **blocks, **scales)
    torch.cuda.synchronize()
    assert torch.equal(tree, plain)


@pytest.mark.parametrize("case", ["dmax1", "dmax64_chain", "offsets_past_63"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_tree_kernel_widths(cuda, quant, case):
    """DMAX 1 (a root-only row, its dead nodes see history only), DMAX 64
    (a 64-node chain: every bit of the offset mask), and a 72-node tree
    whose lists name offsets 64..71 (the list scan past the mask)."""
    if case == "dmax1":
        rows = [(5, 5, 30), (1, 1, 9), (20, 20, 4)]
        topo, width = {0: ([-1, 0, 0, 0, 0], 1)}, 1
    elif case == "dmax64_chain":
        rows = [(64, 64, 30), (1, 1, 9), (20, 20, 4)]
        topo, width = {0: ([-1] + list(range(63)), 64)}, 64
    else:
        parents = [-1] + list(range(40)) + [0] * 16 + list(range(56, 71))
        rows = [(72, 72, 25), (1, 1, 9), (20, 20, 4)]
        topo, width = {0: (parents, 72)}, 64
    args, blocks, scales = _ragged_operands(cuda, g=4, d=128, page_size=16, quant=quant,
                                            rows=rows)
    anc = _tree_anc(args, rows, topo, width)
    if case == "offsets_past_63":
        assert int(anc.max()) >= 64
    _check_tree(args, blocks, scales, anc, quant)


@pytest.mark.parametrize("spec", [{"speculation": "ngram"},
                                  {"speculation": "ngram", "spec_tree": True}],
                         ids=["chain", "tree"])
def test_spec_engine_on_the_card_runs_the_kernels(cuda, spec):
    """Verify rows on the card: every ragged step launches the ragged
    kernel once per layer (tree steps with the mask), decode windows the
    decode kernel; a temperature-0.7 row completes beside greedy ones."""
    cfg = {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4,
           "n_kv_heads": 2, "head_dim": 64, "ffn_dim": 512, "dtype": "bfloat16"}
    model = Llama(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda))
    engine = LLMEngineCore(model, max_batch=3, max_seq_len=128, decode_steps=4,
                           page_size=16, scheduler="ragged", step_token_budget=24,
                           spec_k=4, **spec)

    async def run():
        async def one(ids, delay, temperature=0.0):
            await asyncio.sleep(delay)
            return [t async for t in engine.generate(GenRequest(
                prompt_ids=ids, max_new_tokens=24, temperature=temperature))]
        return await asyncio.gather(one([5, 9, 2, 17] * 5, 0.0),
                                    one([3, 3, 7] * 9, 0.05),
                                    one(list(range(1, 30)), 0.1, 0.7))

    paged_attention.launches = 0
    ragged_paged_attention.launches = 0
    streams = asyncio.run(run())
    c = engine.counters
    assert [len(s) for s in streams] == [24, 24, 24]
    ragged = engine.health()["ragged"]
    assert ragged["step_rows"]["spec_verify"] >= 1
    if spec.get("spec_tree"):
        assert ragged["spec_tree_depth"]["count"] >= 1
    assert ragged_paged_attention.launches == model.n_layers * c["ragged_steps"]
    assert paged_attention.launches == model.n_layers * (
        c["decode_steps"] + c["ragged_chain_steps"])
    pool = engine.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1

# -- the w4a16 matmul ------------------------------------------------------------

# Llama-3-8B's projections as (K, N)
LLAMA3_8B_PROJECTIONS = {
    "wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024), "wo": (4096, 4096),
    "w_gate": (4096, 14336), "w_up": (4096, 14336), "w_down": (14336, 4096),
    "lm_head": (4096, 128256),
}


def _int4_operands(dev, m, k, n, groups, seed=0):
    """bf16 activations ~N(0, 1) and random packed codes with scales that
    keep the outputs ~N(0, 1)."""
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
    q = torch.randint(0, 256, (k // 2, n), generator=gen, device=dev, dtype=torch.uint8)
    s = (torch.rand(groups, n, generator=gen, device=dev) + 0.5) * (0.5 / k ** 0.5)
    return x, q, s


def _check_int4(x, q, s):
    before = fused_int4_matmul.launches
    out = fused_int4_matmul(x, q, s, dtype=torch.bfloat16)
    assert fused_int4_matmul.launches == before + 1
    ref = int4_matmul_plain(x.float(), q, s, torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref, **TOL)


@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 128, 312])
@pytest.mark.parametrize("name", sorted(LLAMA3_8B_PROJECTIONS))
def test_int4_kernel_matches_plain_version_at_llama3_8b_shapes(cuda, name, m):
    k, n = LLAMA3_8B_PROJECTIONS[name]
    _check_int4(*_int4_operands(cuda, m, k, n, k // 128, seed=m))


@pytest.mark.parametrize("m,k,n,groups", [
    (5, 128, 64, 1),       # K = group: one group
    (20, 96, 48, 1),       # K % 128 != 0: the one-group fallback
    (3, 4096, 256, 1),     # one group across 32 pipeline stages
    (40, 240, 32, 5),      # groups of 48 end mid-stage
    (17, 512, 80, 32),     # groups of 16, eight end in every stage
], ids=["k_eq_group", "fallback_96", "group_4096", "group_48", "group_16"])
def test_int4_kernel_group_sizes(cuda, m, k, n, groups):
    _check_int4(*_int4_operands(cuda, m, k, n, groups))


def _int4_workspace_bytes(m, k, n, groups):
    """The split-K workspace the kernel asks for (0: K is not split)."""
    nbytes = ctypes.c_longlong(0)
    assert load_library().tpu_torch_fused_int4_workspace(m, k, n, k // groups,
                                                         ctypes.byref(nbytes)) == 0
    return nbytes.value


@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("k,n,groups", [
    (4800, 1024, 100),   # groups of 48: shares of 6-7 groups, stages end mid-group
    (4096, 1024, 256),   # groups of 16
    (4096, 1024, 1),     # one group of 4096: every share boundary inside it
    (4000, 64, 1),       # one group; 250 k-steps over 15 uneven shares
    (4000, 80, 1),       # the same over two column tiles, 48 columns past N
], ids=["group_48", "group_16", "one_group_4096", "one_group_4000", "one_group_n80"])
def test_int4_split_k_boundaries_inside_groups(cuda, k, n, groups, m):
    """Decode rows split K across CTAs; a share may start and end inside a
    group (16-row shares when K holds fewer groups than shares)."""
    assert _int4_workspace_bytes(m, k, n, groups) > 0
    _check_int4(*_int4_operands(cuda, m, k, n, groups, seed=k + m))


@pytest.mark.parametrize("m,name", [(1, "wk"), (8, "wq"), (16, "w_down"), (8, "w_gate")])
def test_int4_decode_calls_are_deterministic(cuda, m, name):
    """The split-K sum adds the shares in a fixed order: two calls on the
    same inputs give the same bits."""
    k, n = LLAMA3_8B_PROJECTIONS[name]
    x, q, s = _int4_operands(cuda, m, k, n, k // 128, seed=7)
    if name != "w_gate":
        assert _int4_workspace_bytes(m, k, n, k // 128) > 0
    first = fused_int4_matmul(x, q, s)
    second = fused_int4_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_int4_kernel_on_quantized_weights(cuda):
    """Real codes from the quantizer: the kernel against x @ dequantize."""
    gen = torch.Generator(cuda).manual_seed(3)
    w = torch.randn(1024, 768, generator=gen, device=cuda) * 1024 ** -0.5
    q, s = quantize_int4(w)
    x = torch.randn(8, 1024, generator=gen, device=cuda).bfloat16()
    _check_int4(x, q, s)


@pytest.mark.parametrize("m", [1024, 2048])
@pytest.mark.parametrize("name", ["w_gate", "w_down"])
def test_int4_kernel_matches_plain_version_at_prefill_rows(cuda, name, m):
    """Two-dispatch prefill buckets past 512 rows launch the kernel too."""
    k, n = LLAMA3_8B_PROJECTIONS[name]
    _check_int4(*_int4_operands(cuda, m, k, n, k // 128, seed=m))


# the block tiling (M > 16): each row count with every projection shape the
# main path gives it (the lm_head on gathered rows only, up to the ragged
# flat axis)
INT4_BLOCK_ROWS = [17, 24, 40, 64, 65, 127, 312, 1024, 2048]
INT4_SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "w_gate/w_up": (4096, 14336),
               "w_down": (14336, 4096), "lm_head": (4096, 128256)}


@pytest.mark.parametrize("m,name", [(m, name) for m in INT4_BLOCK_ROWS for name in INT4_SHAPES
                                    if name != "lm_head" or m <= 312])
def test_int4_block_tiling_matches_plain_version(cuda, m, name):
    k, n = INT4_SHAPES[name]
    _check_int4(*_int4_operands(cuda, m, k, n, k // 128, seed=m + n))


@pytest.mark.parametrize("m,k,n,groups", [
    (100, 512, 80, 32),     # groups of 16: four end in every stage; N past one CTA's 128 columns
    (65, 240, 32, 5),       # groups of 48; K ends 48 rows into its last stage
    (300, 1024, 400, 8),    # groups of 128; N = 400, a multiple of 16 but not of 128
    (130, 4000, 144, 1),    # the one-group fallback: K = 4000 ends inside a stage
], ids=["group_16", "group_48_k_tail", "group_128_n400", "one_group_4000"])
def test_int4_block_tiling_groups_and_edges(cuda, m, k, n, groups):
    _check_int4(*_int4_operands(cuda, m, k, n, groups, seed=m + k))


@pytest.mark.parametrize("m,k,n,groups", [
    (40, 4000, 64, 1),      # one CTA tile: K split 15 ways into 16-row shares of one group
    (24, 4800, 1024, 100),  # groups of 48: shares of 6-7 groups, stages end mid-group
    (312, 4096, 1024, 32),  # wk/wv on the ragged flat axis: 24 tiles, K split
    (64, 4096, 1024, 1),    # one group of 4096: every share boundary inside it
], ids=["one_group_4000", "group_48", "wk_312", "one_group_4096"])
def test_int4_block_split_k_boundaries_inside_groups(cuda, m, k, n, groups):
    """Block calls whose CTA tiles do not fill the card split K as decode
    calls do, and a share may start and end inside a group."""
    assert _int4_workspace_bytes(m, k, n, groups) > 0
    _check_int4(*_int4_operands(cuda, m, k, n, groups, seed=k + m))


@pytest.mark.parametrize("m,name", [(40, "wq/wo"), (312, "wk/wv"), (312, "w_gate/w_up"),
                                    (2048, "w_down")])
def test_int4_block_calls_are_deterministic(cuda, m, name):
    """No atomics in the block tiling either: two calls give the same bits."""
    k, n = INT4_SHAPES[name]
    x, q, s = _int4_operands(cuda, m, k, n, k // 128, seed=11)
    first = fused_int4_matmul(x, q, s)
    second = fused_int4_matmul(x, q, s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_int4_gate_violations_raise_on_cuda(cuda):
    x, q, s = _int4_operands(cuda, 4, 256, 128, 2)
    cases = [
        ((x.float(), q, s), "gate x.dtype"),
        ((x, q.to(torch.int8), s), "gate packed.dtype"),
        ((x, q, s.bfloat16()), "gate scale.dtype"),
        ((x, q[None], s[None]), "gate 2-D"),
        ((x[:, :128].contiguous(), q, s), "gate K"),
        ((x, q, s[:, :64]), "gate scale.shape"),
        ((x, q, torch.ones(3, 128, device=cuda)), "gate groups"),
        ((x[:, :48].contiguous(), q[:24], torch.ones(2, 128, device=cuda)), "gate group"),
        ((x, q[:, :8].contiguous(), s[:, :8].contiguous()), "gate N"),
        ((x[:0], q, s), "gate rows"),
        ((x, torch.zeros(128, 256, dtype=torch.uint8, device=cuda)[:, ::2], s),
         "gate contiguous"),
        ((x, q.cpu(), s), "gate device"),
    ]
    before = fused_int4_matmul.launches
    for args, gate in cases:
        with pytest.raises(ValueError, match=gate):
            fused_int4_matmul(*args)
    assert fused_int4_matmul.launches == before


@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
def test_int4_engine_on_the_card_runs_the_kernel(cuda, scheduler):
    cfg = {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4,
           "n_kv_heads": 2, "head_dim": 64, "ffn_dim": 512, "dtype": "bfloat16"}
    params = quantize_llama_params(
        init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda), bits=4)
    model = Llama(cfg, params)
    knobs = {"scheduler": "ragged", "step_token_budget": 16} if scheduler == "ragged" else {}
    engine = LLMEngineCore(model, max_batch=2, max_seq_len=128, decode_steps=4,
                           page_size=16, prefill_buckets=[32, 64], weight_quant="int4",
                           **knobs)

    async def run():
        async def one(n, delay):
            await asyncio.sleep(delay)
            return [t async for t in engine.generate(
                GenRequest(prompt_ids=list(range(1, n + 1)), max_new_tokens=9))]
        return await asyncio.gather(one(5, 0.0), one(40, 0.05), one(20, 0.1))

    fused_int4_matmul.launches = 0
    streams = asyncio.run(run())
    c = engine.counters
    assert all(1 <= len(s) <= 9 for s in streams)
    forwards = c["prefills"] + c["decode_steps"] + c["ragged_steps"] + c["ragged_chain_steps"]
    assert forwards > 0
    assert fused_int4_matmul.launches == (7 * model.n_layers + 1) * forwards
    assert engine.health()["weights"]["quant"] == "int4"


# -- kernel gates at engine construction --------------------------------------------

GATE_CFG = {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
            "head_dim": 64, "ffn_dim": 512, "dtype": "bfloat16"}


@pytest.mark.parametrize("cfg,knobs,gate", [
    ({}, {"page_size": 8}, "paged_attention gate page_size"),
    ({"head_dim": 96}, {}, "paged_attention gate head_dim"),
    ({"dtype": "float32"}, {}, "paged_attention gate q.dtype"),
    ({}, {"scheduler": "ragged", "speculation": "ngram", "spec_tree": True, "spec_k": 64},
     "ragged_paged_attention gate tree_anc"),
], ids=["page_size_8", "head_dim_96", "float32_model", "tree_spec_k_64"])
def test_engine_outside_a_gate_raises_at_construction(cuda, cfg, knobs, gate):
    cfg = dict(GATE_CFG, **cfg)
    model = Llama(cfg, init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda))
    kw = dict(max_batch=2, max_seq_len=128, decode_steps=4, page_size=16)
    kw.update(knobs)
    with pytest.raises(ValueError, match="^" + gate + ": "):
        LLMEngineCore(model, **kw)


def test_int4_engine_outside_the_kernel_gate_raises_at_construction(cuda):
    """A projection whose N is not a multiple of 16 (ffn_dim 520)."""
    cfg = dict(GATE_CFG, ffn_dim=520)
    params = quantize_llama_params(
        init_params(cfg, torch.Generator(cuda).manual_seed(0), device=cuda), bits=4)
    with pytest.raises(ValueError, match=r"^fused_int4_matmul gate N: .*layers\.0\.w_gate"):
        LLMEngineCore(Llama(cfg, params), max_batch=2, max_seq_len=128, page_size=16,
                      weight_quant="int4")


# -- the decode chunk in CUDA graphs ------------------------------------------------

SMALL_CFG = {"vocab_size": 512, "dim": 256, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
             "head_dim": 64, "ffn_dim": 512, "dtype": "bfloat16"}


def _small_model(dev, kv_quant="", weights=""):
    cfg = dict(SMALL_CFG, kv_quant=kv_quant) if kv_quant else SMALL_CFG
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    if weights:
        params = quantize_llama_params(params, bits=4)
    return Llama(cfg, params)


def _chunk_inputs(model, dev, kv_quant, sampled, b=4, n=4):
    """A cache with random pool contents, four slots at 9-90 tokens whose
    next n tokens are allocated (one row idle), and the chunk's packed host
    inputs (pinned) with one host override."""
    from clearml_serving_tpu_torch.llm.decode_graph import ChunkLayout
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache

    page = 32 if kv_quant else 16
    cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim, num_pages=40,
                         page_size=page, max_slots=b, dtype=model.dtype, kv_quant=kv_quant,
                         device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    if kv_quant:
        cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=gen, device=dev))
        cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=gen, device=dev))
        cache.k_scale.copy_(torch.rand(cache.k_scale.shape, generator=gen, device=dev) * 0.02)
        cache.v_scale.copy_(torch.rand(cache.v_scale.shape, generator=gen, device=dev) * 0.02)
    else:
        cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=dev))
        cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=dev))
    pp = 6
    layout = ChunkLayout(b, pp, n)
    i32 = torch.zeros(layout.size_i32, dtype=torch.int32, pin_memory=True)
    f32 = torch.zeros(layout.size_f32, dtype=torch.float32, pin_memory=True)
    v = layout.views(i32.numpy(), f32.numpy())
    lengths = [9, 40, 90, 0]
    for slot, length in enumerate(lengths[:3]):
        cache.pool.allocate(slot, length + n)
        for i, (p, o) in enumerate(cache.pool.token_coords(slot, length, n)):
            v["write_pages"][slot, i], v["write_offsets"][slot, i] = p, o
    v["page_table"][:] = cache.pool.page_table(pp)
    v["lengths0"][:] = lengths
    v["temperature"][:] = [0.8, 0.0, 1.2, 0.0] if sampled else 0.0
    v["top_k"][:] = [0, 0, 40, 0]
    v["top_p"][:] = [1.0, 1.0, 0.9, 1.0]
    v["override_tokens"][:] = [0, 300, 0, 0]
    v["override_mask"][:] = [0, 1, 0, 0]
    chain = torch.tensor([5, 0, 200, 9], dtype=torch.int32, device=dev)
    from clearml_serving_tpu_torch.llm.sampling import gumbel_noise
    noise = gumbel_noise((n, b, model.vocab_size), gen, dev) if sampled else None
    return cache, layout, i32, f32, chain, noise


def _pools(cache):
    return [t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_quant,weights", [("", ""), ("int8", ""), ("", "int4")],
                         ids=["bf16", "int8", "int4_weights"])
def test_graph_replay_is_bitwise_the_eager_chunk(cuda, kv_quant, weights, sampled):
    """One captured decode chunk's replay against ``run_chunk`` eagerly on
    cloned pools: the same tokens and every pool page bit for bit, the
    device chain advanced to the last step's tokens, and the launch counts
    of a replay (none for the capture)."""
    from clearml_serving_tpu_torch.llm.decode_graph import DecodeGraphs, run_chunk

    model = _small_model(cuda, kv_quant, weights)
    n = 4
    cache, layout, i32, f32, chain, noise = _chunk_inputs(model, cuda, kv_quant, sampled, n=n)
    eager_cache = types.SimpleNamespace(**{
        name: getattr(cache, name) if name == "kv_quant" or getattr(cache, name) is None
        else getattr(cache, name).clone() for name in ("k", "v", "k_scale", "v_scale", "kv_quant")})
    eager = run_chunk(model, eager_cache, layout.views(i32.to(cuda), f32.to(cuda)), chain,
                      noise, n)
    graphs = DecodeGraphs(model, cache, layout, n)
    graphs.chain.copy_(chain)
    paged_attention.launches = fused_int4_matmul.launches = 0
    graphs.capture(greedy=not sampled)
    assert (paged_attention.launches, fused_int4_matmul.launches) == (0, 0)
    out = graphs.replay(not sampled, i32, f32, noise)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.equal(graphs.chain, eager[:, -1])
    for got, want in zip(_pools(cache), _pools(eager_cache)):
        assert torch.equal(got, want)
    assert paged_attention.launches == model.n_layers * n
    assert fused_int4_matmul.launches == ((7 * model.n_layers + 1) * n if weights else 0)


@pytest.mark.parametrize("weights", ["", "int4"], ids=["bf16", "int4_weights"])
def test_engine_replays_graphs_after_warmup(cuda, weights):
    """Graphs at depth 1 and at depth 2 after ``warmup()``: both variants
    captured at warmup, no capture while serving, one replay per chunk,
    the kernels' counts per decode step, and greedy streams equal to the
    eager engine's (``cuda_graphs=False``, depth 1)."""
    model = _small_model(cuda, "", weights)
    kw = dict(max_batch=2, max_seq_len=128, decode_steps=4, page_size=16,
              prefill_buckets=[32, 64], weight_quant=weights or None)
    prompts = [list(range(1, 6)), list(range(3, 43)), list(range(7, 27))]

    async def run(engine):
        async def one(ids, temperature):
            return [t async for t in engine.generate(
                GenRequest(prompt_ids=ids, max_new_tokens=11, temperature=temperature))]
        return await asyncio.gather(*(one(p, 0.7 if i == 2 else 0.0)
                                      for i, p in enumerate(prompts)))

    streams = {}
    for arm, depth, graphs in (("eager", 1, False), ("graphs1", 1, True), ("graphs2", 2, True)):
        engine = LLMEngineCore(model, pipeline_depth=depth, cuda_graphs=graphs, **kw)
        if graphs:
            assert asyncio.run(engine.warmup())["graph_captures"] == 2
        for key in engine.counters:
            engine.counters[key] = 0
        paged_attention.launches = fused_int4_matmul.launches = 0
        streams[arm] = asyncio.run(run(engine))
        c = engine.counters
        assert paged_attention.launches == model.n_layers * c["decode_steps"] > 0
        if weights:
            forwards = c["prefills"] + c["decode_steps"]
            assert fused_int4_matmul.launches == (7 * model.n_layers + 1) * forwards
        assert c["serve_captures"] == 0
        assert c["graph_replays"] == (c["decode_chunks"] if graphs else 0)
        pool = engine.paged_cache.pool
        assert pool.free_pages == pool.num_pages - 1
        engine.stop()
    assert [len(s) for s in streams["graphs2"]] == [11, 11, 11]
    # the greedy streams
    assert streams["eager"][:2] == streams["graphs1"][:2] == streams["graphs2"][:2]


# -- the request lifecycle over graph replays --------------------------------------

LIFECYCLE_KW = dict(max_batch=4, max_seq_len=256, decode_steps=4, page_size=16,
                    prefill_buckets=[32, 64], eos_token_id=None, pipeline_depth=2)


async def _stream(engine, request):
    return [t async for t in engine.generate(request)]


def test_watchdog_recovers_with_a_graph_replay_in_flight(cuda):
    """Depth 2 with graphs captured at warmup: a 3 s retire stall (the
    ``engine.decode.stall`` seam) while three requests have replays in
    flight trips a 0.5 s watchdog. Those requests end with
    EngineStuckError, the engine is not ready until the stale leg landed
    and the stream finished the enqueued replays, the pool's free pages
    are where they were, and the next greedy stream equals the one before
    the trip."""
    from clearml_serving_tpu_torch.errors import EngineStuckError
    from clearml_serving_tpu_torch.llm import faults

    engine = LLMEngineCore(_small_model(cuda), watchdog_interval=0.5, **LIFECYCLE_KW)
    probe = dict(prompt_ids=list(range(3, 20)), max_new_tokens=24)

    async def outcome(request):
        try:
            await _stream(engine, request)
        except EngineStuckError:
            return "stuck"
        return "finished"

    async def run():
        await engine.warmup()
        before = await _stream(engine, GenRequest(**probe))
        await engine.wait_drained()
        free0 = engine.paged_cache.pool.free_pages
        victims = [GenRequest(prompt_ids=[5 + i, 9, 11], max_new_tokens=200) for i in range(3)]
        tasks = [asyncio.ensure_future(outcome(v)) for v in victims]
        while not (all(v.produced >= 1 for v in victims) and engine._inflight):
            await asyncio.sleep(0.001)
        faults.configure([{"point": "engine.decode.stall", "action": "delay", "delay": 3.0,
                           "times": 1}])
        saw_not_ready = False
        try:
            while not all(t.done() for t in tasks) or not engine.is_ready:
                saw_not_ready |= not engine.is_ready
                await asyncio.sleep(0.005)
        finally:
            faults.clear()
        await engine.wait_drained()
        free1 = engine.paged_cache.pool.free_pages
        after = await _stream(engine, GenRequest(**probe))
        await engine.wait_drained()
        return [t.result() for t in tasks], saw_not_ready, free0, free1, before, after

    outcomes, saw_not_ready, free0, free1, before, after = asyncio.run(
        asyncio.wait_for(run(), 120))
    assert outcomes == ["stuck"] * 3 and saw_not_ready
    assert engine.counters["watchdog_trips"] == 1
    assert free1 == free0 == engine.paged_cache.pool.num_pages - 1
    assert after == before and len(after) == 24
    assert engine.counters["graph_replays"] > 0 and engine.counters["serve_captures"] == 0
    engine.stop()


def test_capture_while_serving_does_not_trip_the_watchdog(cuda):
    """No warmup: each decode-chunk variant is captured at its first use,
    in the dispatch worker, while requests are active; each capture is
    stretched to at least 0.9 s, over four intervals of a 0.2 s watchdog
    and inside its grace of ten. No trip, both variants captured while
    serving, and the greedy stream equals that of an engine that captured
    at warmup."""
    model = _small_model(cuda)
    greedy = dict(prompt_ids=list(range(3, 20)), max_new_tokens=40)
    sampled = dict(prompt_ids=list(range(7, 30)), max_new_tokens=8, temperature=0.8)

    async def traffic(engine):
        return await asyncio.gather(_stream(engine, GenRequest(**greedy)),
                                    _stream(engine, GenRequest(**sampled)))

    warm = LLMEngineCore(model, **LIFECYCLE_KW)
    asyncio.run(warm.warmup())
    want = asyncio.run(traffic(warm))[0]
    warm.stop()
    engine = LLMEngineCore(model, watchdog_interval=0.2, **LIFECYCLE_KW)
    capture, durations = engine._graphs.capture, []

    def slow_capture(greedy, capture_error_mode="global"):
        t0 = time.perf_counter()
        capture(greedy, capture_error_mode=capture_error_mode)
        time.sleep(max(0.0, 0.9 - (time.perf_counter() - t0)))
        durations.append(time.perf_counter() - t0)

    engine._graphs.capture = slow_capture
    got = asyncio.run(asyncio.wait_for(traffic(engine), 120))[0]
    assert engine.counters["serve_captures"] == 2 and min(durations) >= 0.9
    assert engine.counters["watchdog_trips"] == 0
    assert got == want
    engine.stop()


def test_greedy_stream_is_bitwise_equal_across_a_preemption(cuda):
    """A batch-class stream preempted for an interactive arrival (depth 2,
    graphs) waits with its KV pages, resumes from them and gives the
    tokens of its unpreempted run, bit for bit."""
    model = _small_model(cuda)
    prompt = [(i * 7 + 3) % 250 + 1 for i in range(17)]
    kw = dict(LIFECYCLE_KW, max_batch=1)

    async def contended(engine):
        batch = GenRequest(prompt_ids=list(prompt), max_new_tokens=48, priority="batch")
        task = asyncio.ensure_future(_stream(engine, batch))
        while batch.produced < 8:
            await asyncio.sleep(0.001)
        hi = await _stream(engine, GenRequest(prompt_ids=[1, 9, 9], max_new_tokens=4))
        return await task, hi

    control = LLMEngineCore(model, **kw)
    want = asyncio.run(_stream(control, GenRequest(prompt_ids=list(prompt), max_new_tokens=48,
                                                   priority="batch")))
    control.stop()
    engine = LLMEngineCore(model, **kw)
    got, hi = asyncio.run(asyncio.wait_for(contended(engine), 120))
    assert engine.counters["preemptions"] == 1 and len(hi) == 4
    assert got == want
    pool = engine.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1
    engine.stop()


# -- the prefix cache: shared pages, copy on write ---------------------------------

def _random_cache(dev, kv_quant, num_pages=12, page_size=16):
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache

    cache = PagedKVCache(2, 4, 64, num_pages=num_pages, page_size=page_size, max_slots=3,
                         dtype=torch.bfloat16, kv_quant=kv_quant, device=dev)
    gen = torch.Generator(dev).manual_seed(11)
    if kv_quant:
        cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=gen, device=dev))
        cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=gen, device=dev))
        cache.k_scale.copy_(torch.rand(cache.k_scale.shape, generator=gen, device=dev))
        cache.v_scale.copy_(torch.rand(cache.v_scale.shape, generator=gen, device=dev))
    else:
        cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=dev))
        cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=dev))
    return cache


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_cow_device_copy_equals_a_host_copy(cuda, kv_quant):
    """Two slots whose tail pages are shared extend into them: the pool
    swaps in private pages, and ``apply_pending_cow`` copies the data
    planes (and the int8 scale rows) on the card; every pool equals the
    same copies made on the host, bit for bit."""
    cache = _random_cache(cuda, kv_quant)
    pool = cache.pool
    for slot, length in ((0, 21), (1, 40)):
        pool.allocate(slot, length)
        pool.ref_pages(pool.slot_pages(slot)[-1:])   # the tail page is shared
        pool.extend(slot, 1)
    assert pool.cow_events == 2
    pairs = list(pool._pending_cow)
    host = [t.cpu().clone() for t in _pools(cache)]
    for t in host:
        for src, dst in pairs:
            t[:, :, dst] = t[:, :, src]
    assert cache.apply_pending_cow() == 2
    torch.cuda.synchronize()
    for got, want in zip(_pools(cache), host):
        assert torch.equal(got.cpu(), want)
    assert pool.drain_pending_cow() == []


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_gather_of_shared_pages_equals_plain_indexing(cuda, kv_quant):
    """``gather_pages`` (a hit's dense mini cache, the page list padded
    with the null page) against token-by-token indexing of the pools."""
    cache = _random_cache(cuda, kv_quant)
    pages = [7, 3, 9, 0, 0]
    got = cache.gather_pages(pages)
    p = cache.pool.page_size
    for name, pool in zip(("k", "v", "k_scale", "v_scale"), _pools(cache)):
        want = torch.stack([pool[:, :, pages[t // p], t % p] for t in range(len(pages) * p)],
                           dim=1).unsqueeze(1)                    # [L, 1, S, Hkv(, D)]
        assert torch.equal(got[name], want)


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_hit_slot_decode_chunks_replayed_equal_eager(cuda, kv_quant):
    """A prefix-cache engine with graphs against the eager one
    (``cuda_graphs=False``), depth 2: a cold chat stores a 64-token head,
    then two chats hit it and decode with the shared pages in their page
    tables. The streams and every pool page but the null page are equal
    bit for bit, the hits mapped the stored page ids, and each engine gets
    every page back once the cache is emptied."""
    model = _small_model(cuda, kv_quant)
    page = 32 if kv_quant else 16
    kw = dict(LIFECYCLE_KW, page_size=page, prefix_cache=16, prefix_block=64)
    head = [(i * 7 + 3) % 250 + 1 for i in range(64)]
    prompts = [head + [5, 6, 7], head + list(range(20, 41)), head + [99] * 9]

    def run(graphs):
        engine = LLMEngineCore(model, cuda_graphs=graphs, **kw)
        paged_attention.launches = 0
        # the two hits prefill at once; they commit together, in slot
        # order, so their tails' page ids do not depend on which landed first
        commit = engine._commit_ready

        def in_slot_order():
            if engine._ready and len(engine._ready) == len(engine._admitting):
                landed = sorted(engine._ready, key=lambda item: item[1])
                engine._ready.clear()
                engine._ready.extend(landed)
                commit()

        engine._commit_ready = in_slot_order

        async def go():
            first = await _stream(engine, GenRequest(prompt_ids=prompts[0], max_new_tokens=12))
            rest = await asyncio.gather(*(_stream(engine, GenRequest(prompt_ids=p,
                                                                     max_new_tokens=12))
                                          for p in prompts[1:]))
            await engine.wait_drained()
            return [first] + list(rest)

        streams = asyncio.run(asyncio.wait_for(go(), 120))
        stats = engine._prefix.stats()
        assert (stats["hits"], stats["misses"], stats["hit_tokens"]) == (2, 1, 128)
        assert paged_attention.launches == model.n_layers * engine.counters["decode_steps"]
        pools = [t[:, :, 1:].clone() for t in _pools(engine.paged_cache)]
        hit = engine._prefix.lookup_pages(head + [1], 0)
        run_pages = list(hit["pages"])
        engine._prefix.release(hit)
        engine._prefix.max_nodes = 0
        with engine._prefix._lock:
            engine._prefix._evict_over_budget()
        pool = engine.paged_cache.pool
        assert pool.free_pages == pool.num_pages - 1
        assert engine.counters["graph_replays"] == (engine.counters["decode_chunks"]
                                                    if graphs else 0)
        engine.stop()
        return streams, pools, run_pages

    g_streams, g_pools, g_pages = run(True)
    e_streams, e_pools, e_pages = run(False)
    assert g_streams == e_streams and all(len(s) == 12 for s in g_streams)
    assert g_pages == e_pages and len(g_pages) == 64 // page
    for got, want in zip(g_pools, e_pools):
        assert torch.equal(got, want)


# -- the prefix cache's host-RAM tier ----------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_tier_round_trip_does_not_sync(cuda, kv_quant):
    """Demote three pages into the pinned tier and promote them into fresh
    pages under ``torch.cuda.set_sync_debug_mode("error")``: no call of
    the round trip synchronizes (the test itself waits for the copies by
    ``query()``, as time passing would); the promoted rows (and int8 scale
    rows) equal the demoted ones bit for bit."""
    cache = _random_cache(cuda, kv_quant)
    tier = cache.enable_host_tier(4)
    assert tier.pinned and all(t.is_pinned() for t in tier.slabs())
    pages, fresh = [3, 5, 6], [8, 9, 11]
    before = [t[:, :, pages].clone() for t in _pools(cache)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.ones(1, device=cuda).item()   # the mode catches a sync
        host_ids = cache.demote_pages(pages)
        while not all(ev.query() for _ids, ev in cache._demotions):
            time.sleep(0.001)
        cache.promote_pages(host_ids, fresh)
        while cache.reap_promotions() == 0:
            time.sleep(0.001)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert cache.promo_stage_waits == 0
    cache.demote_pages([2])          # keeps only the copies still landing
    assert len(cache._demotions) == 1
    for want, pool in zip(before, _pools(cache)):
        assert torch.equal(pool[:, :, fresh], want)
    stats = cache.tier_stats()
    assert (stats["demoted_pages_total"], stats["promoted_pages_total"],
            stats["promotions_reaped"], stats["host_pages_used"]) == (4, 3, 1, 1)


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_demoted_page_reallocated_and_written_at_once(cuda, kv_quant):
    """The engine's stream is busy (a sleep kernel) when three pages are
    demoted; their slot is freed, the same pages are allocated again and
    overwritten on the engine's stream at once, with no host wait. The
    host rows still equal the rows from before: the write waited for the
    copy."""
    cache = _random_cache(cuda, kv_quant)
    tier = cache.enable_host_tier(4)
    pool = cache.pool
    pool.allocate(0, 48)
    pages = pool.slot_pages(0)
    before = [t[:, :, pages].movedim(2, 0).cpu() for t in _pools(cache)]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)            # ~tens of ms of device time
    host_ids = cache.demote_pages(pages)
    pool.free(0)
    pool.allocate(1, 48)
    assert sorted(pool.slot_pages(1)) == sorted(pages)   # the same pages again
    for t in _pools(cache):
        t[:, :, pages] = -3 if t.dtype == torch.int8 else 7.0
    torch.cuda.synchronize()
    for want, slab in zip(before, tier.slabs()):
        assert torch.equal(slab[host_ids], want)
    assert all(bool((t[:, :, pages] != 0).all()) for t in _pools(cache))


def test_reap_promotions_with_force_and_without(cuda):
    """A promotion whose copies wait behind a busy engine stream is not
    reaped at a retire boundary (``query()``), is reaped once done, and
    ``force`` waits for the rest; ``overlap_ratio`` counts the wait."""
    cache = _random_cache(cuda, "")
    cache.enable_host_tier(4)
    host_ids = cache.demote_pages([2, 4])
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    cache.promote_pages(host_ids, [7, 8])
    assert cache.reap_promotions() == 0          # still behind the sleep
    assert cache.reap_promotions(force=True) == 1
    assert cache.promo_wait_ms > 0
    host_ids = cache.demote_pages([3])
    torch.cuda.synchronize()
    cache.promote_pages(host_ids, [9])
    torch.cuda.synchronize()
    assert cache.reap_promotions() == 1 and cache.reap_promotions(force=True) == 0
    stats = cache.tier_stats()
    assert stats["promotions_reaped"] == 2 and 0.0 <= stats["overlap_ratio"] < 1.0


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_promotion_beside_a_replay_in_flight_is_read_by_the_next_replay(cuda, kv_quant):
    """Depth 2 with graphs captured at warmup: a chat stores a 64-token
    head, which is spilled to the host tier; while a long chat keeps decode
    replays in flight, the head's second chat promotes it (its copies
    enqueued on the engine's stream behind the replay in flight) and its
    decode replays read the promoted pages. Both streams equal those of an
    engine without a tier whose second chat is an HBM hit, bit for bit."""
    model = _small_model(cuda, kv_quant)
    page = 32 if kv_quant else 16
    kw = dict(LIFECYCLE_KW, page_size=page, prefix_cache=16, prefix_block=64)
    head = [(i * 7 + 3) % 250 + 1 for i in range(64)]
    first, second = head + [5, 6, 7], head + list(range(20, 41))
    long_chat = [(i * 11 + 5) % 250 + 1 for i in range(40)]

    def run(tiered):
        engine = LLMEngineCore(model, prefix_cache_host_pages=16 if tiered else None, **kw)
        seen = []
        if tiered:
            real = engine.paged_cache.promote_pages

            def promote(host_ids, pages):
                seen.append(len(engine._inflight))
                real(host_ids, pages)

            engine.paged_cache.promote_pages = promote

        async def go():
            await engine.warmup()
            await _stream(engine, GenRequest(prompt_ids=first, max_new_tokens=4))
            await engine.wait_drained()
            if tiered:
                # the warmup's stored heads are demoted with it
                assert engine._prefix.spill(0) >= 64 // page
            busy = GenRequest(prompt_ids=long_chat, max_new_tokens=96)
            busy_task = asyncio.ensure_future(_stream(engine, busy))
            while busy.produced < 8:
                await asyncio.sleep(0.001)
            hit = await _stream(engine, GenRequest(prompt_ids=second, max_new_tokens=24))
            return hit, await busy_task

        streams = asyncio.run(asyncio.wait_for(go(), 180))
        stats = engine._prefix.stats()
        assert engine.counters["serve_captures"] == 0
        engine.stop()
        return streams, stats, seen

    (hit_t, busy_t), stats_t, seen = run(True)
    (hit_c, busy_c), stats_c, _ = run(False)
    assert stats_t["hits_by_tier"]["host"] == 1 and stats_c["hits_by_tier"]["host"] == 0
    assert seen and seen[0] >= 1          # a replay was queued when it promoted
    assert hit_t == hit_c and busy_t == busy_c


# -- the sampling surface: extras and logprob variants of the chunk -----------------

CHUNK_VARIANTS = [
    dict(greedy=True, extras=True), dict(greedy=False, extras=True),
    dict(greedy=False, extras=True, seeded=True), dict(greedy=True, lp=True),
    dict(greedy=False, lp=True), dict(greedy=False, extras=True, seeded=True, lp=True),
]


def _extras_inputs(layout, i32, f32, vocab, dev, b=4):
    """Extras rows in the chunk's staging views and a filled ExtrasState:
    a random histogram, bias and prompt mask; seeds on two rows."""
    from clearml_serving_tpu_torch.llm.decode_graph import ExtrasState

    v = layout.views(i32.numpy(), f32.numpy())
    v["active"][:] = [1, 1, 1, 0]
    v["seeds"][:] = [7, -1, 2 ** 31 - 1, 3]
    v["counters"][:] = [0, 5, 17, 2]
    v["min_new"][:] = [3, 0, 30, 0]
    v["stop"][:] = -1
    v["stop"][:, 0] = 257
    v["presence"][:] = [0.5, 0.0, 0.2, 0.0]
    v["frequency"][:] = [0.3, 0.0, 0.7, 0.0]
    v["repetition"][:] = [1.2, 1.0, 0.9, 1.0]
    state = ExtrasState(b, vocab, dev)
    gen = torch.Generator(dev).manual_seed(9)
    state.counts.copy_(torch.randint(0, 3, state.counts.shape, generator=gen, device=dev,
                                     dtype=torch.int32)
                       * (torch.rand(state.counts.shape, generator=gen, device=dev) < 0.05))
    state.bias.copy_(torch.randn(state.bias.shape, generator=gen, device=dev)
                     * (torch.rand(state.bias.shape, generator=gen, device=dev) < 0.02))
    state.pmask.copy_(torch.rand(state.pmask.shape, generator=gen, device=dev) < 0.03)
    return state


@pytest.mark.parametrize("variant", CHUNK_VARIANTS, ids=lambda v: "+".join(
    k for k, on in v.items() if on and k != "greedy") + ("_greedy" if v["greedy"] else "_sampled"))
def test_extras_variant_replay_is_bitwise_the_eager_chunk(cuda, variant):
    """Each new chunk variant captured and replayed against ``run_chunk``
    eagerly on cloned pools and extras rows: the tokens, the logprob
    outputs, the advanced histogram and every pool page bit for bit."""
    from clearml_serving_tpu_torch.llm.decode_graph import ChunkVariant, DecodeGraphs, run_chunk

    model = _small_model(cuda)
    n = 4
    key = ChunkVariant(**variant)
    cache, layout, i32, f32, chain, noise = _chunk_inputs(model, cuda, "", not key.greedy, n=n)
    state = _extras_inputs(layout, i32, f32, model.vocab_size, cuda)
    eager_state = types.SimpleNamespace(counts=state.counts.clone(), bias=state.bias,
                                        pmask=state.pmask)
    eager_cache = types.SimpleNamespace(kv_quant="", k=cache.k.clone(), v=cache.v.clone(),
                                        k_scale=None, v_scale=None)
    eager = run_chunk(model, eager_cache, layout.views(i32.to(cuda), f32.to(cuda)), chain,
                      noise, n, variant=key, state=eager_state, lp_k=5)
    graphs = DecodeGraphs(model, cache, layout, n, state_fn=lambda: state, lp_k=5)
    graphs.chain.copy_(chain)
    counts0 = state.counts.clone()
    graphs.capture(key)
    # the capture's warm-up run had no active row: the histogram is untouched
    assert torch.equal(state.counts, counts0)
    out = graphs.replay(key, i32, f32, noise)
    torch.cuda.synchronize()
    got, want = (out[0], eager[0]) if key.lp else (out, eager)
    assert torch.equal(got, want)
    if key.lp:
        for a, b in zip(out[1], eager[1]):
            assert torch.equal(a, b)
    assert torch.equal(state.counts, eager_state.counts)
    if key.extras:
        # the active rows' histograms grew by the chunk's tokens
        assert int((state.counts - counts0)[:3].sum()) == 3 * n
    assert torch.equal(cache.k, eager_cache.k) and torch.equal(cache.v, eager_cache.v)


@pytest.mark.parametrize("shape", [(512,), (4, 8, 1031)])
def test_prng_bits_on_the_card_equal_the_cpus(cuda, shape):
    """Threefry bits and uniforms bitwise on the card and the CPU; the
    Gumbel rows within 1e-6 (``log`` may differ by an ulp)."""
    from clearml_serving_tpu_torch.llm import prng

    for seed in (0, 1, 2 ** 31 - 1):
        for counter in (0, 1, 1000):
            keys = {}
            for dev in ("cpu", cuda):
                k1, k2 = prng.fold_in(*prng.prng_key(torch.tensor(seed, device=dev)),
                                      torch.tensor(counter, device=dev))
                keys[str(dev)] = (k1, k2)
            bits = [prng.random_bits(*keys[d], shape).cpu() for d in ("cpu", str(cuda))]
            assert torch.equal(bits[0], bits[1])
            unif = [prng.uniform(b, 1e-38, 1.0) for b in (bits[0], bits[1].to(cuda))]
            assert torch.equal(unif[0], unif[1].cpu())
    seeds = torch.tensor([0, 1, 2 ** 31 - 1, 5, -1], dtype=torch.int32)
    counters = torch.tensor([0, 9, 1000, 3, 4], dtype=torch.int32)
    cpu = prng.seeded_gumbel(seeds, counters, 4099)
    card = prng.seeded_gumbel(seeds.to(cuda), counters.to(cuda), 4099).cpu()
    torch.testing.assert_close(card, cpu, rtol=1e-6, atol=1e-6)


def test_commit_reset_beside_a_replay_in_flight(cuda):
    """Depth 2 with graphs: a slot that served a request with a strong bias
    is reused, mid-decode of a long seeded chat whose replays stay in
    flight, by a request with penalties and no bias; its reset rows are
    enqueued behind the replay in flight, so its stream (and the long
    chat's) equal those on fresh engines, and the eager engine at depth 1
    gives the same seeded streams."""
    model = _small_model(cuda)
    kw = dict(LIFECYCLE_KW, max_batch=2)
    long_chat = GenRequest(prompt_ids=[(i * 11 + 5) % 250 + 1 for i in range(40)],
                           max_new_tokens=96, temperature=0.8, top_p=0.9, seed=5,
                           presence_penalty=0.3)
    biased = dict(prompt_ids=list(range(3, 23)), max_new_tokens=6, logit_bias={97: 40.0})
    reuse = dict(prompt_ids=list(range(30, 50)), max_new_tokens=24, temperature=0.7,
                 seed=8, frequency_penalty=0.5, logprobs=2)

    def clone(r):
        return GenRequest(prompt_ids=list(r.prompt_ids), max_new_tokens=r.max_new_tokens,
                          temperature=r.temperature, top_p=r.top_p, seed=r.seed,
                          presence_penalty=r.presence_penalty)

    async def busy_run(engine, busy):
        await engine.warmup()
        first = await _stream(engine, GenRequest(**biased))
        assert first == [97] * 6
        task = asyncio.ensure_future(_stream(engine, busy))
        while busy.produced < 8:
            await asyncio.sleep(0.001)
        inflight = len(engine._inflight)
        again = GenRequest(**reuse)
        got = await _stream(engine, again)
        return got, again.logprob_entries, await task, inflight

    engine = LLMEngineCore(model, **kw)
    got, entries, long_got, inflight = asyncio.run(asyncio.wait_for(
        busy_run(engine, clone(long_chat)), 180))
    engine.stop()
    assert inflight >= 1
    for graphs, depth in ((True, 2), (False, 1)):
        alone = LLMEngineCore(model, **dict(kw, pipeline_depth=depth), cuda_graphs=graphs)
        solo = GenRequest(**reuse)
        want = asyncio.run(_stream(alone, solo))
        want_long = asyncio.run(_stream(alone, clone(long_chat)))
        alone.stop()
        assert got == want and long_got == want_long
        assert [e["top_ids"] for e in entries] == [e["top_ids"] for e in solo.logprob_entries]


# -- guided decoding: the guided variants of the chunk ------------------------------

def _guided_tables(dev, vocab=512):
    """Two grammars over the byte tokenizer in one combined table, padded to
    its power-of-two bucket as the engine lays it out, with the token byte
    arrays: (mask bits, byte table, token bytes, token lengths) on ``dev``,
    the bucket, and each grammar's start state."""
    import numpy as np

    from clearml_serving_tpu_torch.llm import guided
    from clearml_serving_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer(vocab)
    table = guided.token_byte_table(tok, vocab)
    grams = [guided.compile_guided(guided.GuidedSpec("regex", "[a-z]{1,30}"), tok, vocab, 257,
                                   token_bytes=table),
             guided.compile_guided(guided.GuidedSpec("json_object"), tok, vocab, 257,
                                   token_bytes=table)]
    masks, bytes_, starts, offset = [], [], [], 0
    for g in grams:
        bt = g.byte_trans.astype(np.int32)
        bytes_.append(np.where(bt == guided.DEAD, guided.DEAD, bt + offset).astype(np.int16))
        masks.append(g.mask_bits)
        starts.append(offset + g.start)
        offset += g.n_states
    bucket = 1
    while bucket < offset:
        bucket *= 2
    mask = np.zeros((bucket, masks[0].shape[1]), np.uint8)
    mask[:offset] = np.vstack(masks)
    byte = np.full((bucket, 256), guided.DEAD, np.int16)
    byte[:offset] = np.vstack(bytes_)
    tb, tl = guided.build_token_byte_arrays(table)
    tables = tuple(torch.from_numpy(a).to(dev) for a in (mask, byte, tb, tl))
    return tables, bucket, starts


GUIDED_VARIANTS = [dict(greedy=True), dict(greedy=False), dict(greedy=True, lp=True),
                   dict(greedy=False, extras=True, seeded=True)]


@pytest.mark.parametrize("variant", GUIDED_VARIANTS, ids=lambda v: "+".join(
    k for k, on in v.items() if on and k != "greedy") + ("_greedy" if v["greedy"] else
                                                        "_sampled"))
def test_guided_variant_replay_is_bitwise_the_eager_chunk(cuda, variant):
    """Each guided variant captured and replayed against ``run_chunk``
    eagerly on cloned pools: the tokens, the DFA states (host overrides on
    two rows, the device chain on the others), the state chain the replay
    leaves, and every pool page bit for bit."""
    from clearml_serving_tpu_torch.llm.decode_graph import ChunkVariant, DecodeGraphs, run_chunk

    model = _small_model(cuda)
    n = 4
    tables, bucket, starts = _guided_tables(cuda)
    key = ChunkVariant(**variant, guided=bucket)
    cache, layout, i32, f32, chain, noise = _chunk_inputs(model, cuda, "", not key.greedy, n=n)
    state = _extras_inputs(layout, i32, f32, model.vocab_size, cuda) if key.extras else None
    v = layout.views(i32.numpy(), f32.numpy())
    v["active"][:] = [1, 1, 1, 0]
    v["override_gstate"][:] = [starts[0], starts[1], -1, -1]
    v["override_gmask"][:] = [1, 1, 0, 0]
    # rows 2 and 3 read the chain: a mid-grammar state, and an idle row's
    gchain = torch.tensor([-1, -1, starts[1] + 1, starts[0]], dtype=torch.int32, device=cuda)
    eager_cache = types.SimpleNamespace(kv_quant="", k=cache.k.clone(), v=cache.v.clone(),
                                        k_scale=None, v_scale=None)
    eager_state = (types.SimpleNamespace(counts=state.counts.clone(), bias=state.bias,
                                         pmask=state.pmask) if state is not None else None)
    eager, eager_g = run_chunk(model, eager_cache, layout.views(i32.to(cuda), f32.to(cuda)),
                               chain, noise, n, variant=key, state=eager_state, lp_k=5,
                               tables=tables, gchain=gchain)
    graphs = DecodeGraphs(model, cache, layout, n, state_fn=lambda: state, lp_k=5,
                          tables_fn=lambda b: tables)
    graphs.chain.copy_(chain)
    graphs.gchain.copy_(gchain)
    graphs.capture(key)
    out, out_g = graphs.replay(key, i32, f32, noise)
    torch.cuda.synchronize()
    got, want = (out[0], eager[0]) if key.lp else (out, eager)
    assert torch.equal(got, want) and torch.equal(out_g, eager_g)
    assert torch.equal(graphs.gchain, eager_g) and torch.equal(graphs.chain, want[:, -1])
    if key.lp:
        for a, b in zip(out[1], eager[1]):
            assert torch.equal(a, b)
    # the idle row kept its state
    assert int(out_g[3]) == starts[0]
    assert torch.equal(cache.k, eager_cache.k) and torch.equal(cache.v, eager_cache.v)


def test_guided_mask_and_advance_on_the_card_equal_the_cpu(cuda):
    from clearml_serving_tpu_torch.llm.sampling import guided_advance, guided_mask

    tables, bucket, starts = _guided_tables(cuda)
    cpu = tuple(t.cpu() for t in tables)
    gen = torch.Generator().manual_seed(5)
    logits = torch.randn(8, 512, generator=gen)
    gstate = torch.randint(-1, bucket, (8,), generator=gen, dtype=torch.int32)
    gstate[:2] = torch.tensor(starts, dtype=torch.int32)
    sampled = torch.randint(0, 512, (8,), generator=gen, dtype=torch.int32)
    ok = torch.rand(8, generator=gen) < 0.8
    want_m = guided_mask(logits, gstate, cpu[0])
    got_m = guided_mask(logits.to(cuda), gstate.to(cuda), tables[0])
    assert torch.equal(got_m.cpu(), want_m)
    want_a = guided_advance(gstate, sampled, ok, *cpu[1:])
    got_a = guided_advance(gstate.to(cuda), sampled.to(cuda), ok.to(cuda), *tables[1:])
    assert torch.equal(got_a.cpu(), want_a)


def test_guided_tables_grow_beside_a_replay_in_flight(cuda):
    """Depth 2 with graphs: a small grammar decodes, a second one is
    appended to its bucket and a ``json_object`` grows the tables into a
    larger one while chunks are in flight; every greedy stream equals the
    eager depth-1 engine's, the guided variants were captured while
    serving, and once the chunks that read the outgrown bucket have run its
    buffers and graphs are gone."""
    from clearml_serving_tpu_torch.llm.guided import GuidedSpec
    from clearml_serving_tpu_torch.llm.tokenizer import ByteTokenizer

    specs = [GuidedSpec("regex", "[a-z]{1,40}"), GuidedSpec("regex", "(yes|no)"),
             GuidedSpec("json_object")]
    prompts = [[256] + [(11 * i + 5 * j) % 250 + 1 for j in range(20)] for i in range(3)]
    outs, buckets = {}, {}
    for arm, depth, graphs in (("eager", 1, False), ("graphs", 2, True)):
        engine = LLMEngineCore(_small_model(cuda), max_batch=4, max_seq_len=128, page_size=16,
                               eos_token_id=257, tokenizer=ByteTokenizer(512),
                               pipeline_depth=depth, cuda_graphs=graphs)

        async def run():
            tasks = []
            for spec, ids in zip(specs, prompts):
                r = GenRequest(prompt_ids=list(ids), max_new_tokens=48, guided=spec)
                tasks.append(asyncio.ensure_future(_stream(engine, r)))
                while r.produced < 2 and not tasks[-1].done():
                    await asyncio.sleep(0.001)
            got = await asyncio.gather(*tasks)
            await engine.wait_drained()
            return got

        seen = []
        sync_tables = engine._guided_device_tables

        def spy():
            seen.append(sync_tables())
            return seen[-1]

        engine._guided_device_tables = spy
        outs[arm] = asyncio.run(run())
        buckets[arm] = sorted(set(seen))
        engine._drop_outgrown_buckets()
        assert list(engine._gdev) == [seen[-1]] and not engine._gstale
        if graphs:
            labels = [k for k in engine.health()["graph_variants"] if "guided" in k]
            assert len(labels) >= 2 and engine.counters["serve_captures"] >= len(labels)
            assert {v.guided for v in engine._graphs._graphs if v.guided} == {seen[-1]}
        assert engine.health()["guided"]["refs"] == 0
        engine.stop()
    assert outs["graphs"] == outs["eager"]
    assert len(buckets["graphs"]) >= 2 and buckets["graphs"] == buckets["eager"]


def test_chat_through_the_processor_and_router(cuda, tmp_path):
    """The control plane on the card: an ``llm`` endpoint that the processor
    builds on its default device from the aux block (llama-tiny widened to
    the kernels' head width, bf16, warmed at the first request) answers one
    chat through ``build_app(processor)``, streamed and not, with the same
    content; its decode chunks are graph replays that launch the decode
    kernel once per layer and step, and nothing is captured while serving."""
    from aiohttp.test_utils import TestClient, TestServer

    from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
    from clearml_serving_tpu_torch.serving.main import build_app
    from clearml_serving_tpu_torch.serving.model_request_processor import (
        ModelRequestProcessor,
    )

    load_library()
    engine_cfg = {"preset": "llama-tiny", "config": {
        "dim": 256, "n_heads": 4, "n_kv_heads": 2, "head_dim": 64, "ffn_dim": 512,
        "dtype": "bfloat16"}, "cache": "paged", "max_batch": 2, "max_seq_len": 128,
        "prefill_buckets": [32, 64], "warmup": "startup"}
    mrp = ModelRequestProcessor(state_root=str(tmp_path), force_create=True, name="card")
    mrp.add_endpoint(ModelEndpoint(engine_type="llm", serving_url="tiny",
                                   auxiliary_cfg={"engine": engine_cfg}))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    body = {"model": "tiny", "max_tokens": 12,
            "messages": [{"role": "user", "content": "hello"}]}

    async def run():
        client = TestClient(TestServer(build_app(mrp)))
        await client.start_server()
        try:
            r = await client.post("/serve/openai/v1/chat/completions", json=body)
            assert r.status == 200, await r.text()
            plain = (await r.json())["choices"][0]["message"]["content"]
            engine = mrp._engine_processor_lookup["tiny"].engine
            await engine.wait_drained()
            paged_attention.launches = 0
            for key in ("decode_steps", "serve_captures", "graph_replays"):
                engine.counters[key] = 0
            r = await client.post("/serve/openai/v1/chat/completions",
                                  json=dict(body, stream=True))
            assert r.status == 200
            pieces = []
            for line in (await r.text()).splitlines():
                if line.startswith("data: {"):
                    pieces.append(json.loads(line[6:])["choices"][0]["delta"].get("content")
                                  or "")
            await engine.wait_drained()
            return plain, "".join(pieces), engine
        finally:
            await client.close()

    plain, streamed, engine = asyncio.run(run())
    assert streamed == plain
    assert engine.model.device.type == "cuda"
    assert engine.counters["graph_replays"] > 0 and engine.counters["serve_captures"] == 0
    assert paged_attention.launches == engine.model.n_layers * engine.counters["decode_steps"] > 0


def test_cli_and_inference_server_serve_a_chat_on_the_card(cuda, tmp_path):
    """The user's steps on the card: ``python -m clearml_serving_tpu_torch
    create``, ``model add --engine llm``, then ``python -m
    clearml_serving_tpu_torch.serving.main`` (its default device, ``cuda``)
    answers a chat, and SIGTERM drains it to exit 0."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import urllib.request
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, TPUSERVE_STATE_ROOT=str(tmp_path / "state"), TPUSERVE_PORT=str(port),
               TPUSERVE_HOST="127.0.0.1")
    config = json.dumps({"dim": 256, "n_heads": 4, "n_kv_heads": 2, "head_dim": 64,
                         "ffn_dim": 512, "dtype": "bfloat16"})
    for argv in (["create", "--name", "card"],
                 ["--yes", "model", "add", "--engine", "llm", "--endpoint", "tiny",
                  "--aux-config", "engine.preset=llama-tiny", "engine.config=" + config,
                  "engine.cache=paged", "engine.max_batch=2", "engine.max_seq_len=128",
                  "engine.prefill_buckets=[32,64]"]):
        out = subprocess.run([sys.executable, "-m", "clearml_serving_tpu_torch"] + argv,
                             cwd=str(root), env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
    server = subprocess.Popen([sys.executable, "-m", "clearml_serving_tpu_torch.serving.main"],
                              cwd=str(root), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    base = "http://127.0.0.1:{}".format(port)
    try:
        deadline = time.monotonic() + 300
        while True:
            try:
                with urllib.request.urlopen(base + "/ready", timeout=5) as r:
                    ready = json.loads(r.read())
                break
            except OSError:
                assert server.poll() is None and time.monotonic() < deadline, "server not up"
                time.sleep(0.5)
        assert ready["engines"]["tiny"]["ready"]
        body = {"model": "tiny", "max_tokens": 8,
                "messages": [{"role": "user", "content": "hello"}]}
        req = urllib.request.Request(base + "/serve/openai/v1/chat/completions",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200
            assert json.loads(r.read())["usage"]["completion_tokens"] >= 1
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            rc = server.wait(timeout=60)
        finally:
            if server.poll() is None:
                server.kill()
                server.wait(timeout=30)
    assert rc == 0, server.stdout.read()[-3000:]


# -- the replica fleet on one card ------------------------------------------------


def _replica_engines(model, dev, n=2, **kw):
    """``n`` engines over one model, replica 0 on the current stream and
    the others on their replica streams (as ``build_engine`` builds a
    fleet)."""
    from clearml_serving_tpu_torch.device import replica_stream

    engines = [LLMEngineCore(model, replica="r0", **kw)]
    for i in range(1, n):
        stream = replica_stream(dev, i)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            engines.append(LLMEngineCore(model, replica="r{}".format(i), **kw))
    return engines


def test_interactive_prefill_passes_a_chunked_batch_admission(cuda):
    """On the card, at depth 1 with graphs: a one-dispatch interactive
    admission that arrives while a chunked batch admission's segment train
    waits at the prefill gate (one segment per decode chunk) is not queued
    behind the train on the stream's prefill thread: its dispatch goes
    through between two of the train's segments, and its first token lands
    before the train's last segment does."""
    from clearml_serving_tpu_torch.llm.engine import _PrefillGate

    events = []

    class Recording(_PrefillGate):
        def deposit(self):
            with self._cond:
                super().deposit()
                events.append("D")

        def take(self, bypass=False):
            with self._cond:
                paced = self._active and not bypass
                taken = super().take(bypass)
                if taken:
                    events.append("P" if paced else "p")
                return taken

    load_library()
    engine = LLMEngineCore(_small_model(cuda), max_batch=3, max_seq_len=256, decode_steps=1,
                           page_size=16, prefill_buckets=[16, 64, 128], eos_token_id=None,
                           pipeline_depth=1, chunked_prefill_size=16)
    engine._prefill_gate = Recording(segments_per_chunk=1, stall_timeout=10.0)

    async def run():
        await engine.warmup()
        live = engine.generate(GenRequest(prompt_ids=[5, 1, 2], max_new_tokens=200))
        out_live = [await live.__anext__()]
        # 129 tokens: 9 segments of 16, one per decode chunk
        batch = asyncio.ensure_future(_stream(engine, GenRequest(
            prompt_ids=[5] + [i % 500 + 1 for i in range(128)], max_new_tokens=2,
            priority="batch")))
        while events.count("P") < 2:
            await asyncio.sleep(0.0005)
        mark = len(events)
        inter = engine.generate(GenRequest(prompt_ids=[5, 7, 8], max_new_tokens=2,
                                           priority="interactive"))
        out_inter = [await inter.__anext__()]
        paced_at_first = events.count("P")
        out_inter += [t async for t in inter]
        out_batch = await batch
        out_live += [t async for t in live]
        return out_live, out_batch, out_inter, mark, paced_at_first

    out_live, out_batch, out_inter, mark, paced = asyncio.run(asyncio.wait_for(run(), 120))
    engine.stop()
    assert len(out_live) == 200 and len(out_batch) == 2 and len(out_inter) == 2
    seq = "".join(events)
    assert seq.count("P") == 9, seq
    assert seq.index("p", mark) < seq.rindex("P"), seq
    assert paced < 9, seq


def test_two_engines_over_one_llama_decode_concurrently_bitwise(cuda):
    """Two replicas over ONE Llama, each on its own stream with its own
    pool and graphs (captured on capture streams of their own; each
    replica's prefills and steps on threads of its own): four streams on
    each at once give every token each engine gives alone."""
    load_library()
    model = _small_model(cuda)
    a, b = _replica_engines(model, cuda, **LIFECYCLE_KW)
    for e in (a, b):
        e._cohosted = True
    assert a.model is b.model and a._stream.cuda_stream != b._stream.cuda_stream
    assert a._workers["prefill"] is not b._workers["prefill"]
    prompts = {e: [[(e is b) * 50 + i * 11 + j % 97 + 1 for j in range(9 + 13 * i)]
                   for i in range(4)] for e in (a, b)}

    async def traffic(e):
        return await asyncio.gather(*[_stream(e, GenRequest(prompt_ids=p, max_new_tokens=48))
                                      for p in prompts[e]])

    async def run():
        await a.warmup()
        await b.warmup()
        alone = [await traffic(a), await traffic(b)]
        await a.wait_drained()
        await b.wait_drained()
        together = await asyncio.gather(traffic(a), traffic(b))
        return alone, list(together)

    alone, together = asyncio.run(asyncio.wait_for(run(), 240))
    assert together == alone
    assert alone[0] != alone[1]
    for e in (a, b):
        assert e.counters["graph_replays"] > 0 and e.counters["serve_captures"] == 0
        e.stop()


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_export_import_between_two_pools_is_bitwise(cuda, kv_quant):
    """Pages exported from one pool and imported into another (on another
    stream, as a decode replica's) hold the same bits."""
    from clearml_serving_tpu_torch.device import replica_stream

    src = _random_cache(cuda, kv_quant)
    side = replica_stream(cuda, 1)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        dst = _random_cache(cuda, kv_quant)
    pages = [3, 4, 7, 9]
    slabs = src.export_pages(pages)
    assert all(t.is_pinned() for t in slabs.values() if t is not None)
    fresh = [10, 2, 5, 8]
    dst.import_pages(slabs["hk"], slabs["hv"], fresh, slabs.get("hk_scale"),
                     slabs.get("hv_scale"))
    assert dst.reap_promotions(force=True) == 1
    back = dst.export_pages(fresh)
    for name, t in slabs.items():
        if t is not None:
            assert torch.equal(back[name], t), name
    for pool_src, pool_dst in zip(src._pools(), dst._pools()):
        assert torch.equal(pool_dst[:, :, fresh], pool_src[:, :, pages])


def test_device_gauges_make_no_context_in_a_fresh_process(cuda):
    """The statistics service's device gauges in a process without a CUDA
    context: no gauge and no context made; in this process (which holds
    one) the card's bytes in use and its size."""
    import subprocess
    import sys

    from prometheus_client import CollectorRegistry

    from clearml_serving_tpu_torch.statistics.metrics import StatisticsController

    code = ("import torch\n"
            "from prometheus_client import CollectorRegistry\n"
            "from clearml_serving_tpu_torch.statistics.metrics import StatisticsController\n"
            "r = CollectorRegistry()\n"
            "StatisticsController('', registry=r).update_device_gauges()\n"
            "print(torch.cuda.is_initialized(), "
            "r.get_sample_value('tpu_hbm_bytes_in_use', {'device': '0'}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    assert out == ["False", "None"]
    torch.zeros(1, device=cuda)
    registry = CollectorRegistry()
    StatisticsController("", registry=registry).update_device_gauges()
    used = registry.get_sample_value("tpu_hbm_bytes_in_use", {"device": "0"})
    limit = registry.get_sample_value("tpu_hbm_bytes_limit", {"device": "0"})
    assert used == torch.cuda.memory_allocated(0) and limit == torch.cuda.mem_get_info(0)[1]


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["bf16", "int8"])
def test_export_wire_import_between_two_pools_is_bitwise(cuda, kv_quant):
    """Pages exported from one card pool, framed by the socket KV wire,
    decoded (views into the frame) and imported into another pool hold
    the same bits."""
    from clearml_serving_tpu_torch.llm.kv_transport import KVShipment

    src = _random_cache(cuda, kv_quant)
    dst = _random_cache(cuda, kv_quant)
    pages = [3, 4, 7, 9]
    slabs = src.export_pages(pages)
    shipment = KVShipment(key=b"k" * 16, src="r0", prefix_len=4 * 16, page_size=16, lora=0,
                          hk=slabs["hk"], hv=slabs["hv"], hk_scale=slabs.get("hk_scale"),
                          hv_scale=slabs.get("hv_scale"))
    got = KVShipment.from_wire(shipment.to_wire())
    fresh = [10, 2, 5, 8]
    dst.import_pages(got.hk, got.hv, fresh, got.hk_scale, got.hv_scale)
    assert dst.reap_promotions(force=True) == 1
    back = dst.export_pages(fresh)
    for name, t in slabs.items():
        if t is not None:
            assert torch.equal(back[name], t), name
    for pool_src, pool_dst in zip(src._pools(), dst._pools()):
        assert torch.equal(pool_dst[:, :, fresh], pool_src[:, :, pages])


PROCESS_AUX = {"preset": "llama-tiny", "config": {"dim": 256, "head_dim": 64, "ffn_dim": 512},
               "cache": "paged", "max_batch": 2, "max_seq_len": 128, "prefill_buckets": [32, 64],
               "prefix_cache": 32, "prefix_block": 16, "seed": 0, "warmup": "startup"}


def test_process_fleet_on_the_card_gives_the_in_process_streams(cuda):
    """A two-worker process fleet on the card (each worker drawing the
    seed's weights on its own context) gives the greedy streams of an
    engine built in this process from the same aux keys; its workers are
    processes of their own, and ``stop()`` reaps them."""
    import os

    from clearml_serving_tpu_torch.llm.openai_api import build_engine

    prompts = [[i * 7 % 300 + 1 for i in range(n)] for n in (9, 40, 70)]

    async def run(engine):
        await engine.warmup()
        out = [await _stream(engine, GenRequest(prompt_ids=p, max_new_tokens=24))
               for p in prompts]
        await engine.wait_drained()
        return out

    import gc

    single, _ = build_engine(PROCESS_AUX, device="cuda")
    expected = asyncio.run(run(single))
    single.stop()
    del single
    gc.collect()
    allocated = torch.cuda.memory_allocated()
    group, _ = build_engine(dict(PROCESS_AUX, replicas=2, replica_backend="process"),
                            device="cuda")
    pids = [r.engine.pid for r in group.replicas]
    try:
        # this process makes no weight or pool of theirs
        assert torch.cuda.memory_allocated() - allocated < 64 << 20
        assert len(set(pids)) == 2 and os.getpid() not in pids
        assert asyncio.run(run(group)) == expected
        blocks = group.health()["replicas"]
        assert {b["device"] for b in blocks.values()} == {str(torch.device("cuda", 0))}
        for r in group.replicas:
            assert r.engine.device_memory()["allocated"] > 0
        assert all(b["counters"]["graph_replays"] > 0 for b in blocks.values()
                   if b["counters"]["decode_steps"])
    finally:
        group.stop()
    deadline = time.monotonic() + 30.0
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        time.sleep(0.2)
    assert not alive, "workers survived stop(): {}".format(alive)


# -- the ragged launch in CUDA graphs -------------------------------------------------

def _ragged_launch_inputs(model, dev, variant, kv_quant=""):
    """A cache with random pool contents and four rows on the flat axis of
    the engine's layout (q blocks of ``RAGGED_QB``): a 20-token prefill
    chunk at history 30, a decode row at 50 with the variant's window, a
    verify row of k + 1 = 5 at 40 (a forest on tree keys; greedy, or
    sampled on a sampled-verify key) or a decode row without one, and a
    decode row at 10. Returns (cache, layout, host_i32, host_f32, draws,
    extras state, guided tables)."""
    import numpy as np

    from clearml_serving_tpu_torch.llm.decode_graph import ExtrasState
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
    from clearml_serving_tpu_torch.llm.ragged_graph import RaggedLayout, ragged_draws

    b, k, steps, pp = 4, 4, variant.steps, 8
    page = 32 if kv_quant else 16
    cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                         num_pages=b * pp + 1, page_size=page, max_slots=b, dtype=model.dtype,
                         kv_quant=kv_quant, device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    if kv_quant:
        cache.k.copy_(torch.randint(-127, 128, cache.k.shape, generator=gen, device=dev))
        cache.v.copy_(torch.randint(-127, 128, cache.v.shape, generator=gen, device=dev))
        cache.k_scale.copy_(torch.rand(cache.k_scale.shape, generator=gen, device=dev) * 0.02)
        cache.v_scale.copy_(torch.rand(cache.v_scale.shape, generator=gen, device=dev) * 0.02)
    else:
        cache.k.copy_(torch.randn(cache.k.shape, generator=gen, device=dev))
        cache.v.copy_(torch.randn(cache.v.shape, generator=gen, device=dev))
    table = (1 + np.arange(b * pp, dtype=np.int32)).reshape(b, pp)
    verify = bool(variant.verify)
    pre = np.array([30, 50, 40, 10], np.int32)
    kind = ["chunk", "decode", "verify" if verify else "decode", "decode"]
    span = np.array([20, steps, k + 1 if verify else steps, steps], np.int32)
    row_lens = np.array([20, 1, k + 1 if verify else 1, 1], np.int32)
    tpad = -(-(48 + b * (RAGGED_QB - 1)) // RAGGED_QB) * RAGGED_QB
    starts, block_rows, block_q0, tpad = ragged_layout(span, RAGGED_QB, total=tpad)
    rng = np.random.default_rng(5)
    a = {name: np.zeros(tpad, np.int32) for name in ("tokens", "tok_pos", "tok_row",
                                                     "tok_valid", "write_page", "write_offset")}
    chain_wp = np.zeros((max(1, steps - 1), b), np.int32)[:steps - 1]
    chain_wo = np.zeros_like(chain_wp)
    depths = np.array([0, 1, 2, 1, 2], np.int32)
    parents = np.array([-1, 0, 1, 0, 3], np.int32)
    if variant.verify == "chain":
        depths, parents = np.arange(k + 1, dtype=np.int32), np.arange(-1, k, dtype=np.int32)
    for r in range(b):
        s, n, v = int(starts[r]), int(span[r]), int(row_lens[r])
        a["tokens"][s:s + n] = rng.integers(1, 256, n)
        a["tok_pos"][s:s + n] = pre[r] + (depths[:n] if kind[r] == "verify"
                                          else np.arange(n))
        a["tok_row"][s:s + n] = r
        a["tok_valid"][s:s + v] = 1
        for i in range(n):
            pos = int(pre[r]) + i
            page_id, off = int(table[r, pos // page]), pos % page
            if kind[r] == "decode" and i > 0:
                chain_wp[i - 1, r], chain_wo[i - 1, r] = page_id, off
            else:
                a["write_page"][s + i], a["write_offset"][s + i] = page_id, off
    row_logit_idx = starts[:, None] + np.minimum(np.arange(k + 1), row_lens[:, None] - 1)
    tree_anc = np.full((tpad, k + 1), -1, np.int32)
    tree_anc[:, 0] = -2
    if variant.verify == "tree":
        tree_anc[starts[2]:starts[2] + k + 1] = tree_ancestors(parents, k + 1, width=k + 1)
    spec = np.array([0, 0, 1, 0], np.int32) if verify else np.zeros(b, np.int32)
    sampled_rows = [1, 3] if not variant.greedy else []
    temperature = np.zeros(b, np.float32)
    temperature[sampled_rows] = 0.8
    if variant.sampled_verify:
        temperature[2] = 0.7
    arrays = dict(a, block_rows=block_rows, block_q0=block_q0, row_starts=starts,
                  row_lens=row_lens, row_last=starts + row_lens - 1, kv_lens=pre + row_lens,
                  page_table=table, chain_wp=chain_wp, chain_wo=chain_wo,
                  chain_mask=np.array([[0, 1, 0 if verify else 1, 1]] * (steps - 1), np.int32),
                  spec_mask=spec * (0 if variant.sampled_verify else 1),
                  sspec_mask=spec * (1 if variant.sampled_verify else 0),
                  drafts=np.tile(rng.integers(1, 256, k).astype(np.int32), (b, 1)),
                  row_logit_idx=row_logit_idx,
                  tree_tokens=np.tile(rng.integers(1, 256, k + 1).astype(np.int32), (b, 1)),
                  tree_parents=np.tile(parents, (b, 1)),
                  tree_n=np.full(b, k + 1, np.int32), tree_anc=tree_anc,
                  temperature=temperature, top_k=np.array([0, 40, 0, 0], np.int32),
                  top_p=np.array([1.0, 0.9, 1.0, 1.0], np.float32),
                  active=np.array([0, 1, 0 if verify else 1, 1], np.int32))
    state = tables = None
    if variant.extras:
        state = ExtrasState(b, model.vocab_size, dev)
        state.bias[1, 7] = 2.0
        state.pmask[3, 3:9] = True
        arrays.update(presence=np.full(b, 0.3, np.float32), frequency=np.full(b, 0.1, np.float32),
                      repetition=np.full(b, 1.2, np.float32),
                      seeds=np.array([-1, 11, -1, 5 if variant.seeded else -1], np.int32),
                      counters=np.array([0, 3, 0, 2], np.int32),
                      min_new=np.array([0, 2, 0, 0], np.int32))
    if variant.guided:
        tables, bucket, gstarts = _guided_tables(dev)
        assert bucket == variant.guided
        arrays["gstate"] = np.array([-1, gstarts[0], -1, gstarts[1]], np.int32)
    layout = RaggedLayout(b, tpad, RAGGED_QB, pp, 4, k)
    i32, f32 = layout.stage(arrays, pin=True)
    draws = ragged_draws(variant, b, model.vocab_size, k, gen, dev)
    return cache, layout, i32, f32, draws, state, tables


def _ragged_key(**kw):
    from clearml_serving_tpu_torch.llm.ragged_graph import RaggedVariant

    return RaggedVariant(**kw)


def _guided_bucket(dev):
    return _guided_tables(dev)[1]


RAGGED_KEYS = [
    ("q1", dict(steps=1), "", ""),
    ("q2_sampled", dict(steps=2, greedy=False), "", ""),
    ("q4", dict(steps=4), "", ""),
    ("q1_chain", dict(steps=1, verify="chain"), "", ""),
    ("q2_chain_sampled", dict(steps=2, verify="chain", sampled_verify=True, greedy=False),
     "", ""),
    ("q1_tree", dict(steps=1, verify="tree"), "", ""),
    ("q4_tree_sampled", dict(steps=4, verify="tree", sampled_verify=True), "", ""),
    ("q2_extras_seeded", dict(steps=2, greedy=False, extras=True, seeded=True), "", ""),
    ("q2_logprobs", dict(steps=2, lp=True), "", ""),
    ("q2_guided", dict(steps=2, guided=-1), "", ""),
    ("q2_tree_int8", dict(steps=2, verify="tree"), "int8", ""),
    ("q2_chain_int4", dict(steps=2, verify="chain", greedy=False), "", "int4"),
]


@pytest.mark.parametrize("name,key,kv_quant,weights", RAGGED_KEYS,
                         ids=[k[0] for k in RAGGED_KEYS])
def test_ragged_replay_is_bitwise_the_eager_launch(cuda, name, key, kv_quant, weights):
    """One captured ragged key's replays against ``run_ragged`` eagerly on
    cloned pools and extras rows: the same outputs (tokens, logits,
    acceptance, logprobs, DFA states) and every pool page but the null
    page bit for bit; the capture launches nothing that counts, and after
    three replays each kernel's count is three times its count a replay:
    the ragged kernel once a layer (its tree variant on tree keys), the
    decode kernel once a layer per chained step, the int4 kernel once per
    projection of every forward."""
    import numpy as np

    from clearml_serving_tpu_torch.llm.ragged_graph import RaggedGraphs, run_ragged

    if key.get("guided") == -1:
        key = dict(key, guided=_guided_bucket(cuda))
    variant = _ragged_key(**key)
    model = _small_model(cuda, kv_quant, weights)
    cache, layout, i32, f32, draws, state, tables = _ragged_launch_inputs(model, cuda, variant,
                                                                          kv_quant)
    clone = types.SimpleNamespace(**{
        name: getattr(cache, name) if name == "kv_quant" or getattr(cache, name) is None
        else getattr(cache, name).clone() for name in ("k", "v", "k_scale", "v_scale", "kv_quant")})
    eager_state = None
    if state is not None:
        eager_state = types.SimpleNamespace(counts=state.counts.clone(), bias=state.bias,
                                            pmask=state.pmask)
    eager = run_ragged(model, clone, layout.views(i32.to(cuda), f32.to(cuda)), variant, draws,
                       block_map=True, state=eager_state, tables=tables, lp_k=2)
    graphs = RaggedGraphs(model, cache, layout, block_map=True, spec=True,
                          state_fn=lambda: state, lp_k=2, tables_fn=lambda b: tables)
    counted = (ragged_paged_attention, paged_attention, fused_int4_matmul)
    for fn in counted:
        fn.launches = 0
    ragged_paged_attention.tree_launches = 0
    graphs.capture(variant)
    assert [fn.launches for fn in counted] == [0, 0, 0]
    assert ragged_paged_attention.tree_launches == 0
    out = graphs.replay(variant, i32, f32, draws)
    torch.cuda.synchronize()
    assert sorted(out) == sorted(eager)
    for field in eager:
        want, got = eager[field], out[field]
        if isinstance(want, tuple):
            assert all(torch.equal(g, w) for g, w in zip(got, want)), field
        else:
            assert torch.equal(got, want), field
    for got, want in zip(_pools(cache), _pools(clone)):
        assert torch.equal(got[:, :, 1:], want[:, :, 1:])
    if state is not None:
        assert torch.equal(state.counts, eager_state.counts)
    for _ in range(2):
        graphs.replay(variant, i32, f32, draws)
    torch.cuda.synchronize()
    layers, steps = model.n_layers, variant.steps
    assert ragged_paged_attention.launches == 3 * layers
    assert ragged_paged_attention.tree_launches == (3 * layers if variant.verify == "tree"
                                                    else 0)
    assert paged_attention.launches == 3 * layers * (steps - 1)
    forward = 7 * layers + 1
    int4 = forward + (1 if variant.verify else 0) + forward * (steps - 1)
    assert fused_int4_matmul.launches == (3 * int4 if weights else 0)
    # the shared pool's first capture takes segments of its own
    assert graphs.pool_growth[variant] > 0
    # the launch shapes did not change the pools' layout
    assert np.prod(cache.k.shape) == np.prod(clone.k.shape)


RAGGED_KW = dict(max_batch=4, max_seq_len=256, decode_steps=4, page_size=16,
                 prefill_buckets=[32, 64], scheduler="ragged", step_token_budget=48,
                 speculation="ngram", spec_k=4, spec_tree=True, spec_branch=2)
RAGGED_PROMPTS = [[5, 9, 2, 17, 5, 9, 2] * 3, [3, 3, 7, 3, 3, 7, 3] * 3,
                  [(i * 7 + 3) % 250 + 1 for i in range(90)],
                  [(i * 13 + 5) % 250 + 1 for i in range(60)]]


async def _ragged_traffic(engine, extra=None):
    """Two repetitive greedy chats (verify rows), a sampled chat and a long
    prompt submitted at once, so the schedule does not depend on timing:
    the budget admits them chunk by chunk beside the rows already decoding
    and verifying; ``extra``: the kwargs of a fifth request (a non-plain
    key), admitted into the first slot freed, beside the live rows."""
    rows = [(RAGGED_PROMPTS[0], {}), (RAGGED_PROMPTS[1], {}),
            (RAGGED_PROMPTS[2], dict(temperature=0.8)), (RAGGED_PROMPTS[3], {})]
    if extra is not None:
        rows.append((RAGGED_PROMPTS[3][:40], extra))
    requests = [GenRequest(prompt_ids=list(ids), max_new_tokens=24 + 8 * i, **kw)
                for i, (ids, kw) in enumerate(rows)]
    outs = await asyncio.gather(*(_stream(engine, r) for r in requests))
    await engine.wait_drained()
    return outs, [r.logprob_entries for r in requests]


def test_warmup_full_captures_every_plain_ragged_key(cuda):
    """``warmup(full=True)`` captures the two chunk variants and the 18
    plain ragged keys of a tree engine (windows 1, 2, 4 × no verify row,
    greedy or sampled verify rows × greedy or sampled plain rows); mixed
    ragged traffic afterwards captures nothing; every ragged step is a
    replay whose kernels' counts follow the steps; the greedy streams equal
    the eager engine's, and every pool page comes back."""
    model = _small_model(cuda)
    streams = {}
    for arm, graphs in (("eager", False), ("graphs", True)):
        engine = LLMEngineCore(model, cuda_graphs=graphs, **RAGGED_KW)
        out = asyncio.run(engine.warmup(full=True))
        assert out["graph_captures"] == (20 if graphs else 0)
        assert out["cow_buckets"] > 0 and out["ship_buckets"] == 0
        for key in engine.counters:
            engine.counters[key] = 0
        paged_attention.launches = ragged_paged_attention.launches = 0
        ragged_paged_attention.tree_launches = 0
        streams[arm], _lp = asyncio.run(_ragged_traffic(engine))
        c = engine.counters
        assert c["serve_captures"] == 0 and c["ragged_verify_steps"] > 0
        assert c["ragged_replays"] == (c["ragged_steps"] if graphs else 0) > -1
        assert ragged_paged_attention.launches == model.n_layers * c["ragged_steps"] > 0
        assert ragged_paged_attention.tree_launches == model.n_layers * c["ragged_verify_steps"]
        assert paged_attention.launches == model.n_layers * (c["decode_steps"]
                                                             + c["ragged_chain_steps"])
        if graphs:
            pools = engine.health()["graph_pool_bytes"]
            assert len([k for k in pools if k.startswith("ragged")]) == 18
            assert len(engine.health()["graph_variants"]) == 20
        pool = engine.paged_cache.pool
        assert pool.free_pages == pool.num_pages - 1
        engine.stop()
    assert streams["graphs"] == streams["eager"]


@pytest.mark.parametrize("extra,part", [(dict(logprobs=2), "logprobs"),
                                        (dict(temperature=0.9, seed=4), "extras+seeded")],
                         ids=["logprobs", "seeded"])
def test_non_plain_ragged_key_is_captured_at_first_use(cuda, extra, part):
    """After ``warmup(full=True)`` a request with logprobs (or a seed)
    admitted beside live rows makes its ragged key's first use a capture
    while serving, counted in ``serve_captures`` and timed in
    ``graph_variants``; its stream equals the eager engine's."""
    model = _small_model(cuda)
    outs = {}
    for arm, graphs in (("eager", False), ("graphs", True)):
        engine = LLMEngineCore(model, cuda_graphs=graphs, **RAGGED_KW)
        asyncio.run(engine.warmup(full=True))
        engine.counters["serve_captures"] = 0
        outs[arm] = asyncio.run(_ragged_traffic(engine, extra))
        if graphs:
            labels = [k for k in engine.health()["graph_variants"]
                      if k.startswith("ragged") and part in k]
            assert labels and engine.counters["serve_captures"] >= len(labels)
        engine.stop()
    assert outs["graphs"][0] == outs["eager"][0]
    if extra.get("logprobs"):
        got, want = outs["graphs"][1][4], outs["eager"][1][4]
        assert [e["id"] for e in got] == [e["id"] for e in want]
        assert [e["logprob"] for e in got] == [e["logprob"] for e in want]


def test_guided_bucket_growth_drops_its_ragged_graphs(cuda):
    """A guided ragged key captured over a bucket's tables; once that
    bucket is outgrown and its readers ran, ``_drop_outgrown_buckets``
    frees its tables and its ragged graphs (and their pool entries), and
    keeps the plain keys."""
    from clearml_serving_tpu_torch.llm.ragged_graph import RaggedVariant

    engine = LLMEngineCore(_small_model(cuda), **RAGGED_KW)
    tables, bucket, _starts = _guided_tables(cuda)
    engine._gdev[bucket] = tables[:2]
    engine._gtok_dev = tables[2:]
    guided, plain = RaggedVariant(steps=2, guided=bucket), RaggedVariant(steps=2)
    engine._warming = True
    engine._on_stream(engine._capture, guided)
    engine._on_stream(engine._capture, plain)
    engine._warming = False
    assert engine._ragged_graphs.captured(guided)
    assert guided.label() in engine.health()["graph_pool_bytes"]
    event = torch.cuda.Event()
    event.record(engine._stream)
    engine._gstale.append((bucket, event))
    torch.cuda.synchronize()
    engine._drop_outgrown_buckets()
    assert not engine._ragged_graphs.captured(guided) and engine._ragged_graphs.captured(plain)
    assert bucket not in engine._gdev and not engine._gstale
    assert guided.label() not in engine.health()["graph_pool_bytes"]
    engine.stop()


# -- the jax engine type: one CUDA graph per bucket key ------------------------

_BUNDLE_ARCHS = {
    "mlp": ("mlp", {"in_dim": 4, "hidden": [64, 64], "out_dim": 3}),
    "cnn": ("cnn", {"in_hw": [28, 28], "in_ch": 1, "channels": [32, 64], "dense": 128,
                    "out_dim": 10}),
    "bert": ("bert", {"preset": "bert-tiny", "vocab_size": 30522}),
}


def _bundle_payload(kind, dev, tmp_path):
    """(payload path, endpoint spec, make inputs(batch)) of one payload
    kind, from seed-0 weights made on the card."""
    from clearml_serving_tpu_torch import models
    from clearml_serving_tpu_torch.engines.importers.graphdef_write import cnn_graphdef
    from clearml_serving_tpu_torch.engines.importers.onnx_export import (
        apply_module,
        export_onnx_bytes,
    )
    from clearml_serving_tpu_torch.engines.jax_engine import save_bundle

    gen = torch.Generator(dev).manual_seed(0)
    cpu = torch.Generator().manual_seed(1)
    arch, cfg = _BUNDLE_ARCHS["bert" if kind == "bert" else
                              "mlp" if kind == "mlp" else "cnn"]
    bundle = models.build_model(arch, cfg)
    tree = bundle.init(gen)
    if arch == "bert":
        spec = dict(input_name=["input_ids", "attention_mask"], input_type=["int32", "int32"],
                    input_size=[[128], [128]])

        def inputs(b):
            ids = torch.randint(0, 30522, (b, 128), generator=cpu, dtype=torch.int32)
            mask = torch.ones((b, 128), dtype=torch.int32)
            mask[:, 100:] = 0
            return {"input_ids": ids.numpy(), "attention_mask": mask.numpy()}
    elif arch == "mlp":
        spec = dict(input_type="float32", input_size=[4])

        def inputs(b):
            return torch.randn((b, 4), generator=cpu).numpy()
    else:
        spec = dict(input_name="image", input_type="float32", input_size=[28, 28])

        def inputs(b):
            return {"image": torch.rand((b, 28, 28), generator=cpu).numpy()}
    if kind in ("mlp", "cnn", "bert"):
        save_bundle(tmp_path, arch, cfg, tree)
        return tmp_path, spec, inputs
    params = bundle.convert_params(tree, dev)
    module = apply_module(bundle.apply, params)
    example = torch.rand((1, 28, 28), device=dev)
    if kind == "onnx":
        (tmp_path / "model.onnx").write_bytes(export_onnx_bytes(module, [example], ["image"]))
        return tmp_path / "model.onnx", spec, inputs
    if kind == "graphdef":
        np_tree = {k: [{n: t.cpu().numpy() for n, t in layer.items()} for layer in v]
                   for k, v in tree.items()}
        (tmp_path / "model.graphdef").write_bytes(cnn_graphdef(np_tree))
        return tmp_path / "model.graphdef", spec, inputs
    torch.jit.trace(module, example).save(str(tmp_path / "model.pt"))
    return tmp_path / "model.pt", dict(spec, input_name="input_0"), \
        lambda b: {"input_0": inputs(b)["image"]}


def _jax_request(path, spec, dev, cuda_graphs, buckets=None):
    from clearml_serving_tpu_torch.engines.jax_engine import JaxEngineRequest
    from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint

    registry = types.SimpleNamespace(
        get=lambda _id: types.SimpleNamespace(get_local_copy=lambda: str(path)))
    aux = {"batching": {"buckets": buckets}} if buckets else None
    ep = ModelEndpoint(engine_type="jax", serving_url="m", model_id="m",
                       auxiliary_cfg=aux, **spec)
    return JaxEngineRequest(ep, registry=registry, device=str(dev), cuda_graphs=cuda_graphs)


@pytest.mark.parametrize("kind", ["mlp", "cnn", "bert", "onnx", "graphdef", "torchscript"])
def test_bucket_graph_replay_is_bitwise_the_eager_run(cuda, tmp_path, kind):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    path, spec, inputs = _bundle_payload(kind, cuda, tmp_path)
    graphed = _jax_request(path, spec, cuda, True, buckets=[1, 4, 16])
    eager = _jax_request(path, spec, cuda, False, buckets=[1, 4, 16])
    for batch in (1, 3, 4, 11):
        data = inputs(batch)
        got, want = graphed.process(data, {}), eager.process(data, {})
        assert got.shape == want.shape and got.shape[0] == batch
        assert torch.equal(torch.from_numpy(got), torch.from_numpy(want)), (kind, batch)
    health = graphed.engine.health()
    assert health["graph_captures"] == 3 and health["graph_replays"] == 4
    assert health["graph_pool_bytes"] > 0 and eager.engine.health()["graph_captures"] == 0


def test_no_capture_after_the_first_request_of_each_key(cuda, tmp_path):
    path, spec, inputs = _bundle_payload("cnn", cuda, tmp_path)
    req = _jax_request(path, spec, cuda, True)
    for batch in (2, 2, 1, 7, 8, 2, 1):
        req.process(inputs(batch), {})
    health = req.engine.health()
    # keys: buckets 2, 1 and 8
    assert health["graph_captures"] == 3 and health["graph_replays"] == 7
    assert sorted(health["graph_keys"]) == ["b1:1x28x28float32", "b2:2x28x28float32",
                                            "b8:8x28x28float32"]


def test_a_capture_failure_raises_and_names_the_key(cuda):
    from clearml_serving_tpu_torch.engines.bucket_graph import BucketRunner

    def syncs(x):
        # a host read inside the capture: the capture fails
        return x * float(x.sum().item())

    runner = BucketRunner(syncs, cuda)
    import numpy as np

    with pytest.raises(RuntimeError, match=r"capture of bucket key b4:4x3float32 failed"):
        runner.run([np.ones((4, 3), np.float32)])
    assert runner.health()["graph_captures"] == 0
    # the card still serves: an eager runner works after the failed capture
    ok = BucketRunner(lambda x: x + 1, cuda, cuda_graphs=False)
    assert float(ok.run([np.ones((1, 3), np.float32)]).sum()) == 6.0


# -- the engine server's models and the encoder (jax_grpc, llm encoder tasks) ----

def _compiled_model(path, spec, dev, cuda_graphs, key="m", buckets=(1, 2, 4, 8)):
    from clearml_serving_tpu_torch.engine_server.repo import CompiledModel
    from clearml_serving_tpu_torch.engines.jax_engine import load_bundle
    from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint

    ep = ModelEndpoint(engine_type="jax_grpc", serving_url=key, model_id=key,
                       auxiliary_cfg={"batching": {"buckets": list(buckets),
                                                   "preferred_batch_size": 4,
                                                   "max_queue_delay_us": 20000}}, **spec)
    bundle, params = load_bundle(path, endpoint=ep, device=dev)
    return CompiledModel(ep, bundle, params, key=key, device=dev, cuda_graphs=cuda_graphs)


def test_compiled_model_batches_run_on_its_leased_thread_bitwise_eager(cuda, tmp_path):
    """A jax_grpc model's batches replay its bucket graphs on the step thread
    it leased, never on the loop's or the default executor's threads; each
    request's rows are the bits of the same rows run eagerly."""
    import threading

    import numpy as np

    path, spec, inputs = _bundle_payload("bert", cuda, tmp_path)
    graphed = _compiled_model(path, spec, cuda, True)
    eager = _compiled_model(path, spec, cuda, False)
    graphed.warmup()
    threads = []
    run_batch = graphed.run_batch

    def spy(concat):
        threads.append(threading.current_thread().name)
        return run_batch(concat)

    graphed.batcher._run_batch = spy
    rows = [inputs(1) for _ in range(7)]

    async def traffic():
        return await asyncio.gather(*[graphed.batcher.infer(
            [r["input_ids"], r["attention_mask"]]) for r in rows])

    outs = asyncio.run(traffic())
    worker_names = {n for n in threads}
    assert len(worker_names) == 1 and next(iter(worker_names)).startswith("step")
    for r, out in zip(rows, outs):
        want = eager.run_batch([r["input_ids"], r["attention_mask"]])[0]
        assert torch.equal(torch.from_numpy(np.ascontiguousarray(out[0])),
                           torch.from_numpy(want))
    health = graphed.health()
    assert health["graph_captures"] == len(health["graph_keys"]) >= 2
    assert graphed.batcher.batches_executed < 7
    graphed.retire()
    eager.retire()
    assert graphed.released.is_set()


def test_retired_model_pool_is_freed_under_capture_lock_while_another_replays(cuda,
                                                                               tmp_path):
    """Retiring a model that captured graphs drops its graphs, pool and
    weights under CAPTURE_LOCK, while another model replays on its own
    thread; the survivor's answers keep their bits and the card's allocated
    bytes return within 64 MiB of the level before the retired model."""
    import threading

    from clearml_serving_tpu_torch.device import CAPTURE_LOCK

    path, spec, inputs = _bundle_payload("bert", cuda, tmp_path)
    survivor = _compiled_model(path, spec, cuda, True, key="a")
    x = inputs(2)
    want = survivor.run_batch([x["input_ids"], x["attention_mask"]])[0]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    doomed = _compiled_model(path, spec, cuda, True, key="b")
    for b in (1, 2, 4):
        y = inputs(b)
        doomed.run_batch([y["input_ids"], y["attention_mask"]])
    assert doomed.health()["graph_captures"] == 3
    held = []
    release = doomed.runner.release

    def spy():
        held.append(CAPTURE_LOCK._is_owned())
        release()

    doomed.runner.release = spy
    stop = threading.Event()
    answers = []

    def replay_loop():
        while not stop.is_set():
            answers.append(survivor._worker.submit(
                survivor.run_batch, [x["input_ids"], x["attention_mask"]]).result()[0])

    t = threading.Thread(target=replay_loop)
    t.start()
    try:
        time.sleep(0.05)
        doomed.retire()  # never served through its batcher: released now
    finally:
        time.sleep(0.05)
        stop.set()
        t.join()
    assert held == [True] and doomed.released.is_set() and doomed.runner is None
    assert answers and all(torch.equal(torch.from_numpy(a), torch.from_numpy(want))
                           for a in answers)
    del spy, release
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) - before <= 64 << 20
    survivor.retire()


@pytest.mark.parametrize("name", ["embed", "tokens", "classify"])
def test_encoder_key_replay_is_bitwise_its_eager_run(cuda, name):
    """Each EncoderCore key (function, batch bucket, seq bucket) is one graph
    captured at its first use; its replay gives the eager run's bits."""
    from clearml_serving_tpu_torch import models
    from clearml_serving_tpu_torch.llm.encoder import EncoderCore

    torch.backends.cuda.matmul.allow_tf32 = False
    bundle = models.build_model("bert", {"preset": "bert-tiny", "num_labels": 3})
    params = bundle.convert_params(bundle.init(torch.Generator(cuda).manual_seed(0)), cuda)
    kw = dict(seq_buckets=[16, 32], batch_buckets=[1, 2, 4], device=cuda)
    graphed = EncoderCore(bundle, params, **kw)
    eager = EncoderCore(bundle, params, cuda_graphs=False, **kw)
    gen = torch.Generator().manual_seed(3)
    batches = [[torch.randint(0, 512, (int(n),), generator=gen).tolist() for n in lens]
               for lens in ([5], [30, 7], [100, 3, 12], [9, 9, 9, 9, 9, 9])]
    call = {"embed": "embed", "tokens": "token_states", "classify": "classify"}[name]
    for ids in batches:
        got = getattr(graphed, call)(ids)
        want = getattr(eager, call)(ids)
        for g, w in zip(got, want):
            assert torch.equal(torch.from_numpy(g), torch.from_numpy(w)), (name, len(ids))
    health = graphed.health()
    assert health["graph_captures"] == len(health["graph_keys"]) == 5
    assert all(k.startswith(name + ":") for k in health["graph_keys"])
    assert health["graph_pool_bytes"] > 0 and eager.health()["graph_captures"] == 0
    graphed.retire()
    graphed.worker.submit(lambda: None).result()
    assert graphed.health()["released"]


# -- Whisper's audio core (llm/audio.py) -------------------------------------------

WHISPER_CARD = dict(preset="whisper-tiny", dtype="bfloat16", n_audio_layers=2, n_text_layers=2,
                    transcribe_prompt_ids=[50258, 50259, 50359, 50363],
                    translate_prompt_ids=[50258, 50259, 50358, 50363], eos_token_id=50257,
                    notimestamps_token_id=50363, timestamp_begin=50364, chunk_length=30)


def _audio_cores(cuda, cfg=WHISPER_CARD, **kw):
    """(graphed, eager) cores over the same seed-0 weights on the card."""
    from clearml_serving_tpu_torch import models
    from clearml_serving_tpu_torch.llm.audio import AudioCore

    torch.backends.cuda.matmul.allow_tf32 = False
    bundle = models.build_model("whisper", dict(cfg))
    params = bundle.convert_params(bundle.init(torch.Generator(cuda).manual_seed(0)), cuda)
    return (AudioCore(bundle, params, device=cuda, **kw),
            AudioCore(bundle, params, device=cuda, cuda_graphs=False, **kw))


def _pcm(seconds, seed):
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(int(16000 * seconds)) / 16000
    return (0.3 * torch.sin(2 * torch.pi * (200 + 50 * seed) * t)
            + 0.05 * torch.randn(len(t), generator=gen)).numpy()


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_audio_replays_are_bitwise_the_eager_steps(cuda, rows):
    """Per batch bucket: the encode graph's encoder states and cross K/V,
    and the plain and timestamp chunks' tokens and self-K/V, bitwise the
    eager steps'."""
    graphed, eager = _audio_cores(cuda, decode_steps=4, max_new_tokens=24)
    pcms = [_pcm(12 + 6 * i, i) for i in range(rows)]
    for task, ts in (("transcribe", False), ("translate", True)):
        prompt = graphed.prompt_ids(task, ts)
        fn = "_transcribe_batch_ts" if ts else "_transcribe_batch"
        got = getattr(graphed, fn)(pcms, prompt)
        want = getattr(eager, fn)(pcms, prompt)
        assert got == want and all(ids for ids in got), (task, got, want)
        g, e = graphed._buckets[rows], eager._buckets[rows]
        assert torch.equal(g["enc"], e["enc"])
        for key in ("cross_k", "cross_v", "k", "v", "length"):
            assert torch.equal(g["cache"][key], e["cache"][key]), (task, key)
    health = graphed.health()
    assert set(health["graph_keys"]) == {"{}:b{}".format(n, rows) for n in
                                         ("encode", "prime", "chunk", "chunk_ts")}
    assert health["serve_captures"] == 4   # each at the first batch that needs it
    assert health["graph_pool_bytes"] > 0 and eager.health()["graph_captures"] == 0
    for core in (graphed, eager):
        core.retire()


def test_audio_window_past_the_cache_end_raises_no_device_assert(cuda):
    """With no ``max_tokens`` a window reaches its budget at the cache's end
    and its last chunk steps past ``max_target_positions``: the clamped
    gather and K/V write keep the context alive, and graphed equals eager."""
    graphed, eager = _audio_cores(cuda, decode_steps=16)
    pcm = [_pcm(30, 7)]
    for task, ts in (("transcribe", False), ("transcribe", True)):
        prompt = graphed.prompt_ids(task, ts)
        fn = "_transcribe_batch_ts" if ts else "_transcribe_batch"
        got = getattr(graphed, fn)(pcm, prompt)
        torch.cuda.synchronize()
        assert got == getattr(eager, fn)(pcm, prompt)
        assert int(graphed._buckets[1]["cache"]["length"][0]) > graphed.max_target
    torch.zeros(1, device=cuda).add_(1).item()   # the context still serves
    for core in (graphed, eager):
        core.retire()


def test_audio_retire_frees_the_pool_and_buffers(cuda):
    """retire() releases the graphs, their pool, the buckets' buffers and the
    weights under CAPTURE_LOCK once the queued calls ran: the card's
    allocated bytes come back within 64 MiB."""
    from clearml_serving_tpu_torch import models
    from clearml_serving_tpu_torch.device import CAPTURE_LOCK
    from clearml_serving_tpu_torch.llm.audio import AudioCore

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    bundle = models.build_model("whisper", dict(WHISPER_CARD))
    params = bundle.convert_params(bundle.init(torch.Generator(cuda).manual_seed(0)), cuda)
    core = AudioCore(bundle, params, device=cuda, decode_steps=4, max_new_tokens=8)
    del params
    core.warmup()
    assert core.health()["serve_captures"] == 0 and len(core.health()["graph_keys"]) == 12
    prompt = core.prompt_ids("transcribe")
    queued = core.worker.submit(core._transcribe_batch, [_pcm(5, 1)], prompt)
    held = []
    release = core._align.release

    def spy():
        held.append(CAPTURE_LOCK._is_owned())
        release()

    core._align.release = spy
    core.retire()
    assert len(queued.result()[0]) == 8
    core.worker.submit(lambda: None).result()
    assert held == [True] and core.health() == {"ready": False, "released": True}
    del spy, release, bundle
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) - before <= 64 << 20
