"""The port's engine (clearml_serving_tpu_torch/llm/engine.py) against the
reference's ``LLMEngineCore(cache_mode="paged", pipeline_depth=1,
scheduler="two_dispatch")`` on llama-tiny in float32, same weights through
``convert_params``: greedy token streams must be identical."""

import asyncio

import jax
import numpy as np
import pytest

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
ENGINE = dict(max_batch=2, max_seq_len=128, prefill_buckets=[32, 64],
              eos_token_id=257, decode_steps=4, page_size=16)
# four prompts of different lengths; 20 and 37 cross page boundaries
PROMPT_LENS = (5, 12, 20, 37)


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, n).tolist() for n in PROMPT_LENS]


async def _collect(engine, request):
    return [t async for t in engine.generate(request)]


async def _run_all(engine, requests):
    return await asyncio.gather(*[_collect(engine, r) for r in requests])


def _engine_kw(kv_quant):
    # int8 pools take 32-token pages, the reference's default for them
    return dict(ENGINE, page_size=32) if kv_quant else ENGINE


def _port_engine(tiny_np, kv_quant=""):
    cfg = dict(TINY, kv_quant=kv_quant) if kv_quant else TINY
    return LLMEngineCore(Llama(cfg, convert_params(tiny_np, device="cpu")),
                         **_engine_kw(kv_quant))


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
def test_greedy_streams_match_reference_with_slot_reuse(tiny_np, kv_quant):
    cfg = dict(TINY, kv_quant=kv_quant) if kv_quant else TINY
    jax_engine = JaxEngine(
        models.build_model("llama", cfg), tiny_np, cache_mode="paged",
        pipeline_depth=1, scheduler="two_dispatch", **_engine_kw(kv_quant),
    )
    port = _port_engine(tiny_np, kv_quant)
    max_new = [12, 9, 16, 7]
    want = asyncio.run(_run_all(jax_engine, [
        JaxGenRequest(prompt_ids=p, max_new_tokens=m) for p, m in zip(_prompts(), max_new)
    ]))
    got = asyncio.run(_run_all(port, [
        GenRequest(prompt_ids=p, max_new_tokens=m) for p, m in zip(_prompts(), max_new)
    ]))
    assert got == want
    assert all(len(s) >= 1 for s in got) and max(len(s) for s in got) > 4
    # four requests through two slots: slots were reused, and every page
    # came back to the pool
    assert port.counters["prefills"] == 4
    pool = port.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1
    assert port.active_slots == 0


def test_pages_return_after_each_request(tiny_np):
    port = _port_engine(tiny_np)
    pool = port.paged_cache.pool

    async def run():
        for prompt in _prompts():
            out = await _collect(port, GenRequest(prompt_ids=prompt, max_new_tokens=6))
            assert 1 <= len(out) <= 6
            await port.wait_drained()
            assert pool.free_pages == pool.num_pages - 1

    asyncio.run(run())
    assert port.counters["decode_steps"] > 0


def test_cancelled_stream_frees_its_slot(tiny_np):
    port = _port_engine(tiny_np)

    async def run():
        gen = port.generate(GenRequest(prompt_ids=_prompts()[3], max_new_tokens=40))
        first = await gen.__anext__()
        await gen.aclose()
        await port.wait_drained()
        return first

    assert isinstance(asyncio.run(run()), int)
    assert port.paged_cache.pool.free_pages == port.paged_cache.pool.num_pages - 1


def test_prompt_past_max_seq_len_is_refused(tiny_np):
    port = _port_engine(tiny_np)
    with pytest.raises(ValueError, match="max_seq_len"):
        port.validate(GenRequest(prompt_ids=[1] * 128))


@pytest.mark.parametrize("knob", [
    {"cache_mode": "dense"}, {"ragged_decode_steps": 8}, {"long_prefill_threshold": 512},
    {"speculation": "ngram"}, {"lora_adapters": ["adapter"]}, {"weight_quant": "int4"},
], ids=["dense", "ragged", "chunked_prefill", "speculation", "prefix_cache", "weight_quant"])
def test_unsupported_knob_raises_naming_itself(tiny_np, knob):
    model = Llama(TINY, convert_params(tiny_np, device="cpu"))
    (name,) = knob
    with pytest.raises(ValueError, match=name):
        LLMEngineCore(model, **dict(ENGINE, **knob))


def test_stop_fails_active_and_pending_requests(tiny_np):
    port = _port_engine(tiny_np)   # max_batch 2: the third request waits

    async def run():
        tasks = [asyncio.ensure_future(_collect(port, GenRequest(prompt_ids=p,
                                                                 max_new_tokens=100)))
                 for p in _prompts()[:3]]
        # admissions commit one by one beside decode: wait for both slots
        while port.counters["decode_steps"] == 0 or port.active_slots < 2:
            await asyncio.sleep(0.001)
        assert port._pending.qsize() == 1 and port.active_slots == 2
        port.stop()
        return await asyncio.gather(*tasks, return_exceptions=True)

    results = asyncio.run(run())
    assert [type(r).__name__ for r in results] == ["EngineUnavailableError"] * 3
    assert port.paged_cache.pool.free_pages == port.paged_cache.pool.num_pages - 1
