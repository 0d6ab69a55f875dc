"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc: the CUDA
paged attention kernel against its plain PyTorch version, its gates and
launch count, and the engine on the card. They skip elsewhere. This file
imports neither jax nor the JAX package, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance for kernel vs plain version: atol = rtol = 2e-2 (bf16 output
rounding and another summation order; the plain version computes in f32 on
the same operands)."""

import asyncio

import pytest
import torch

from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.models.llama import Llama, init_params, kv_store
from clearml_serving_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_ref,
)

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
