"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc: the CUDA
paged attention kernels (decode and ragged, the ragged one with and without
its draft-tree mask) and the w4a16 matmul against their plain PyTorch
versions, their gates and launch counts, and the engine on the card under
both schedulers, with bf16 and int4 weights and with speculative verify
rows, and its request lifecycle over CUDA-graph replays (watchdog recovery,
a capture inside the watchdog's grace, a preemption). They skip
elsewhere. This file
imports neither jax nor the JAX package, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance for kernel vs plain version: atol = rtol = 2e-2 (bf16 output
rounding and another summation order; the plain version computes in f32 on
the same operands)."""

import asyncio
import ctypes
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
@pytest.mark.parametrize("d", [64, 128])
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
@pytest.mark.parametrize("d", [64, 128])
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
@pytest.mark.parametrize("d", [64, 128])
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
@pytest.mark.parametrize("d", [64, 128])
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
@pytest.mark.parametrize("g,d,page_size", [(4, 128, 16), (8, 64, 32)])
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
