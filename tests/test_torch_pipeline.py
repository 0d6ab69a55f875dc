"""Pipelined decode in the port (clearml_serving_tpu_torch/llm/engine.py and
llm/decode_graph.py) on the CPU, against the serial loop and the reference.

The reference's pipeline tests (tests/test_pipeline.py) on the port: the
env knob, greedy streams equal at depths 1 and 2 with more requests than
slots (freed slots re-enter through the quarantine barrier) on model-dtype
and int8 KV with every page back after drain, the quarantine deferring a
free until its barrier retires, the dispatchable mask skipping covered
slots, and the pipeline observability. Then the port at depth 2 against the
JAX engine at depth 2, byte for byte (llama-tiny f32; model-dtype and int8
KV; int4 weights carried over by ``quantize_llama_params``), sampled
streams across depths, ``decode_chunk`` bitwise against the serial loop it
replaced, the warmup sweep and the aux ``engine.warmup`` knob.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu_torch.llm.decode_graph import ChunkLayout, decode_chunk, run_chunk
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore, _InFlightChunk
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
from clearml_serving_tpu_torch.llm.sampling import SamplingParams, gumbel_noise, sample_tokens
from clearml_serving_tpu_torch.models.llama import Llama, convert_params
from clearml_serving_tpu_torch.ops.quant import quantize_llama_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
ENGINE = dict(max_batch=2, max_seq_len=128, prefill_buckets=[16, 32], eos_token_id=257,
              decode_steps=4)
# the reference test's prompts: five requests through two slots
PROMPTS = [[256] + [(7 * i + 3 * j) % 250 + 1 for j in range(11)] for i in range(5)]


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _cfg(kv_quant):
    return dict(TINY, kv_quant=kv_quant) if kv_quant else TINY


def _kw(kv_quant, **knobs):
    # int8 pools take 32-token pages, the reference's default for them
    return dict(ENGINE, page_size=32 if kv_quant else 16, **knobs)


def _port(tiny_np, kv_quant="", weight_quant="", **knobs):
    params = convert_params(tiny_np, device="cpu")
    if weight_quant:
        params = quantize_llama_params(params, bits=4)
        knobs["weight_quant"] = weight_quant
    return LLMEngineCore(Llama(_cfg(kv_quant), params), **_kw(kv_quant, **knobs))


def _run_group(engine, request_cls, prompts, **req_kw):
    """Submit every prompt at once; the per-prompt streams, after the
    engine drained."""

    async def go():
        async def one(ids):
            return [t async for t in engine.generate(request_cls(prompt_ids=list(ids), **req_kw))]

        outs = await asyncio.gather(*(one(p) for p in prompts))
        await engine.wait_drained()
        return outs

    return asyncio.run(go())


def _all_pages_back(engine):
    pool = engine.paged_cache.pool
    return pool.free_pages == pool.num_pages - 1 and not engine._quarantine


def test_pipeline_depth_env_knob(monkeypatch, tiny_np):
    monkeypatch.setenv("TPUSERVE_PIPELINE_DEPTH", "1")
    assert _port(tiny_np).pipeline_depth == 1
    monkeypatch.delenv("TPUSERVE_PIPELINE_DEPTH")
    assert _port(tiny_np).pipeline_depth == 2   # the default
    # the explicit kwarg beats the env
    monkeypatch.setenv("TPUSERVE_PIPELINE_DEPTH", "3")
    assert _port(tiny_np, pipeline_depth=1).pipeline_depth == 1
    monkeypatch.setenv("TPUSERVE_PIPELINE_DEPTH", "three")
    assert _port(tiny_np).pipeline_depth == 2


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
def test_greedy_ab_identical_across_depths(tiny_np, kv_quant):
    """Five requests through two slots: freed slots re-enter through the
    quarantine, the overshoot chunks' extra tokens are dropped, and every
    page is back after drain."""
    outs = {}
    for depth in (1, 2):
        engine = _port(tiny_np, kv_quant, pipeline_depth=depth)
        outs[depth] = _run_group(engine, GenRequest, PROMPTS, max_new_tokens=23)
        assert _all_pages_back(engine)
        assert engine.counters["prefills"] == len(PROMPTS)
        engine.stop()
    assert outs[1] == outs[2]
    assert all(len(s) >= 1 for s in outs[2]) and max(len(s) for s in outs[2]) > 4


@pytest.mark.parametrize("kv_quant,weight_quant", [("", ""), ("int8", ""), ("", "int4")],
                         ids=["model_dtype_pools", "int8", "int4_weights"])
def test_depth2_streams_equal_the_reference_at_depth2(tiny_np, kv_quant, weight_quant):
    jax_knobs = {"weight_quant": weight_quant} if weight_quant else {}
    jax_engine = JaxEngine(models.build_model("llama", _cfg(kv_quant)), tiny_np,
                           cache_mode="paged", pipeline_depth=2, scheduler="two_dispatch",
                           **_kw(kv_quant, **jax_knobs))
    want = _run_group(jax_engine, JaxGenRequest, PROMPTS, max_new_tokens=23)
    jax_engine.stop()
    port = _port(tiny_np, kv_quant, weight_quant, pipeline_depth=2)
    got = _run_group(port, GenRequest, PROMPTS, max_new_tokens=23)
    assert got == want
    assert _all_pages_back(port)
    # the pipeline ran ahead: a chunk was dispatched beside a retire
    assert port.lifecycle_stats()["pipeline"]["dispatch_ms"]["count"] == port.counters[
        "decode_chunks"] > 0


@pytest.mark.parametrize("depth", [1, 2])
def test_streams_reaching_max_seq_len_equal_the_reference(tiny_np, depth):
    """Prompts within one chunk of ``max_seq_len``: at depth 2 the port
    leaves a slot out of a dispatch once the chunks in flight reach the
    sequence limit, where the reference masks by the token budget only;
    the greedy streams, cut at the limit, are the reference's at the same
    depth."""
    knobs = dict(ENGINE, eos_token_id=None, page_size=16, pipeline_depth=depth,
                 scheduler="two_dispatch")
    prompts = [[256] + [(7 * i + 3 * j) % 250 + 1 for j in range(n - 1)]
               for i, n in enumerate((121, 124, 126, 127))]
    jax_engine = JaxEngine(models.build_model("llama", TINY), tiny_np, cache_mode="paged",
                           **knobs)
    want = _run_group(jax_engine, JaxGenRequest, prompts, max_new_tokens=40)
    jax_engine.stop()
    port = LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")), **knobs)
    got = _run_group(port, GenRequest, prompts, max_new_tokens=40)
    assert got == want
    assert [len(s) for s in got] == [7, 4, 2, 1]
    assert _all_pages_back(port)


def _admit_in_order_and_together(engine, n):
    """Make the first ``n`` admissions draw their first tokens in the order
    the loop started them, one prefill after another, and commit all ``n``
    at one boundary: the generator's draws then come in one order,
    whatever the depth (admissions otherwise interleave their prefill
    dispatches, beside the decode chunks' noise)."""
    started, turn = [], [0]
    task, prefill, commit = engine._admission_task, engine._run_prefill, engine._commit_ready

    def admission_task(request, slot):
        started.append(request)
        return task(request, slot)

    async def run_prefill(request):
        i = next(k for k, r in enumerate(started) if r is request)
        while turn[0] != i:
            await asyncio.sleep(0.001)
        try:
            return await prefill(request)
        finally:
            turn[0] += 1

    def commit_ready():
        if len(started) > n or len(engine._ready) >= n:
            commit()

    engine._admission_task = admission_task
    engine._run_prefill = run_prefill
    engine._commit_ready = commit_ready


def test_sampled_streams_identical_across_depths(tiny_np):
    """Sampled streams replay at either depth when every request is
    admitted before decode starts and all share max_tokens: each chunk's
    noise is then one draw of the same shape, in the same order. These
    requests carry no seed, so a request admitted mid-decode would draw
    its first token at another point of the generator's sequence at depth
    2 than at depth 1 (seeded ones do not: tests/test_torch_extras_engine.py);
    the admissions prefill beside decode, so the test holds their commits
    to one boundary and their draws to one order."""
    outs = {}
    for depth in (1, 2):
        engine = _port(tiny_np, pipeline_depth=depth, rng_seed=7)
        _admit_in_order_and_together(engine, 2)
        outs[depth] = _run_group(engine, GenRequest, PROMPTS[:2], max_new_tokens=17,
                                 temperature=0.9, top_k=40)
        engine.stop()
    assert outs[1] == outs[2]
    assert [len(s) for s in outs[2]] == [17, 17]


def test_quarantine_defers_free_until_barrier(tiny_np):
    """A slot freed while a younger chunk still decodes it keeps its pages,
    and stays closed to admission, until that chunk retires."""
    engine = _port(tiny_np)
    pool = engine.paged_cache.pool
    engine._slot_req[0] = GenRequest(prompt_ids=[256, 1, 2], max_new_tokens=4)
    pool.allocate(0, 8)
    held = pool.free_pages
    entry = _InFlightChunk(seq=7, active_mask=np.array([True, False]),
                           tokens=torch.zeros((2, 4), dtype=torch.int32))
    engine._inflight.append(entry)
    engine._slot_req[0] = None
    engine._free_slot_pages(0)
    assert engine._quarantine == {0: 7}
    assert pool.free_pages == held
    # an older retire does not release it
    engine._release_quarantine(6)
    assert 0 in engine._quarantine
    # admission skips the quarantined slot: its task reserves slot 1, and
    # the commit activates it there
    engine._pending.put_nowait(GenRequest(prompt_ids=[256, 3], max_new_tokens=2))

    async def admit():
        engine._loop_task = asyncio.current_task()  # this coroutine plays the loop
        engine._admit()
        assert engine._admitting == {1}
        await asyncio.gather(*engine._admission_tasks)
        engine._commit_ready()
        engine._loop_task = None

    asyncio.run(admit())
    assert engine._slot_req[0] is None and engine._slot_req[1] is not None
    # the barrier's retire does
    engine._inflight.clear()
    engine._release_quarantine(7)
    assert engine._quarantine == {}
    assert pool.slot_pages(0) == []


def test_quarantine_never_hands_a_slot_over_before_its_barrier(tiny_np, monkeypatch):
    """Through a whole depth-2 run with slot reuse: at every activation,
    no in-flight (or dispatching) chunk still decodes the slot."""
    engine = _port(tiny_np, pipeline_depth=2)
    activate = engine._activate_slot
    seen = []

    def checked(request, slot, *first):
        seen.append((slot, engine._pipeline_barrier(slot)))
        activate(request, slot, *first)

    monkeypatch.setattr(engine, "_activate_slot", checked)
    _run_group(engine, GenRequest, PROMPTS, max_new_tokens=9)
    assert len(seen) == len(PROMPTS)
    assert all(barrier is None for _slot, barrier in seen)
    assert _all_pages_back(engine)


def test_dispatchable_mask_skips_covered_slots(tiny_np):
    """A request whose remaining budget is covered by chunks in flight is
    certain to finish at an earlier retire: no compute is dispatched for
    it. The sequence limit counts as such a budget."""
    engine = _port(tiny_np)
    a = GenRequest(prompt_ids=[256, 1], max_new_tokens=6)
    b = GenRequest(prompt_ids=[256, 2], max_new_tokens=100)
    a.produced, b.produced = 3, 3
    a.prompt_len, b.prompt_len = 2, 2
    engine._slot_req[0], engine._slot_req[1] = a, b
    active = np.array([True, True])
    assert engine._dispatchable_mask(active).tolist() == [True, True]
    engine._inflight.append(_InFlightChunk(seq=1, active_mask=np.array([True, True]),
                                           tokens=torch.zeros((2, 4), dtype=torch.int32)))
    assert engine._dispatchable_mask(active).tolist() == [False, True]
    # 3 + 4 pending steps reach max_seq_len 128 from a 121-token prompt
    b.prompt_len = 121
    assert engine._dispatchable_mask(active).tolist() == [False, False]


def test_pipeline_observability(tiny_np):
    engine = _port(tiny_np, pipeline_depth=2)
    _run_group(engine, GenRequest, PROMPTS[:2], max_new_tokens=9)
    health = engine.health()
    assert health["pipeline"]["depth"] == 2
    assert health["pipeline"]["inflight"] == 0          # drained
    stats = engine.lifecycle_stats()["pipeline"]
    assert stats == health["pipeline"]
    assert stats["dispatch_ms"]["count"] > 0
    assert stats["retire_ms"]["count"] > 0
    assert stats["dispatch_ms"]["count"] == sum(stats["dispatch_ms"]["counts"])
    assert stats["retire_ms"]["sum_ms"] >= 0.0
    # no graphs on the CPU
    c = engine.counters
    assert (c["graph_captures"], c["graph_replays"], c["serve_captures"]) == (0, 0, 0)
    engine.stop()


def _serial_loop(model, cache, tokens, page_table, lengths0, wp, wo, sampling, noise, n):
    """The decode loop ``decode_chunk`` replaced (the engine's
    ``_decode_chunk`` before pipelining), with each step's noise given."""
    scale_kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                if cache.kv_quant else {})
    steps = []
    for step in range(n):
        logits = model.decode_paged(tokens, cache.k, cache.v, page_table, lengths0 + step,
                                    wp[:, step], wo[:, step], **scale_kw)
        sampled = sample_tokens(logits, sampling, noise=None if noise is None else noise[step],
                                all_greedy=noise is None)
        steps.append(sampled)
        tokens = sampled.long()
    return torch.stack(steps, dim=1)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
def test_decode_chunk_is_bitwise_the_serial_loop(tiny_np, kv_quant, sampled):
    """On the same pools and inputs (four slots at 3-40 tokens, one idle),
    ``decode_chunk`` and ``run_chunk`` (with the chain merge) give the
    serial loop's tokens and pools bit for bit."""
    model = Llama(_cfg(kv_quant), convert_params(tiny_np, device="cpu"))
    rng = np.random.default_rng(3)
    b, n, page = 5, 4, 32 if kv_quant else 16
    caches = [PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim, num_pages=24,
                           page_size=page, max_slots=b, dtype=model.dtype,
                           kv_quant=kv_quant, device="cpu") for _ in range(3)]
    pool = caches[0].pool
    for slot, length in enumerate([3, 17, 40, 9]):
        pool.allocate(slot, length + n)
    lengths0 = torch.tensor([3, 17, 40, 9, 0], dtype=torch.int32)
    wp = np.zeros((b, n), np.int32)
    wo = np.zeros((b, n), np.int32)
    for slot in range(4):
        for i, (p, o) in enumerate(pool.token_coords(slot, int(lengths0[slot]), n)):
            wp[slot, i], wo[slot, i] = p, o
    table = torch.as_tensor(pool.page_table(4))
    fill = torch.from_numpy(rng.standard_normal(tuple(caches[0].k.shape)).astype(np.float32))
    for cache in caches:
        if kv_quant:
            cache.k.copy_((fill * 40).clamp(-127, 127).to(torch.int8))
            cache.v.copy_((-fill * 30).clamp(-127, 127).to(torch.int8))
            cache.k_scale.fill_(0.01)
            cache.v_scale.fill_(0.02)
        else:
            cache.k.copy_(fill)
            cache.v.copy_(-fill)
    tokens = torch.tensor([5, 77, 200, 9, 0], dtype=torch.int32)
    temperature = np.array([0.8, 0.0, 1.3, 0.5, 0.0], np.float32) if sampled else np.zeros(b,
                                                                                         np.float32)
    sampling = SamplingParams(temperature=torch.from_numpy(temperature),
                              top_k=torch.tensor([0, 0, 20, 5, 0], dtype=torch.int32),
                              top_p=torch.tensor([1.0, 1.0, 0.9, 1.0, 1.0]))
    noise = (gumbel_noise((n, b, model.vocab_size), torch.Generator().manual_seed(1), "cpu")
             if sampled else None)
    want = _serial_loop(model, caches[0], tokens.long(), table, lengths0, torch.from_numpy(wp),
                        torch.from_numpy(wo), sampling, noise, n)
    got = decode_chunk(model, caches[1], tokens, table, lengths0, torch.from_numpy(wp),
                       torch.from_numpy(wo), sampling, noise, n)
    assert got.dtype == torch.int32 and tuple(got.shape) == (b, n)
    assert torch.equal(got, want)
    # run_chunk over packed inputs: the chain's tokens where no override
    # stands, the host's where one does
    layout = ChunkLayout(b, 4, n)
    i32 = np.zeros(layout.size_i32, np.int32)
    f32 = np.zeros(layout.size_f32, np.float32)
    v = layout.views(i32, f32)
    v["page_table"][:], v["lengths0"][:] = table.numpy(), lengths0.numpy()
    v["write_pages"][:], v["write_offsets"][:] = wp, wo
    v["temperature"][:], v["top_k"][:] = temperature, sampling.top_k.numpy()
    v["top_p"][:] = sampling.top_p.numpy()
    chain = tokens.clone()
    v["override_tokens"][:] = [0, 0, 200, 0, 0]
    v["override_mask"][:] = [0, 0, 1, 0, 0]
    chain[2] = 123
    merged = run_chunk(model, caches[2], layout.views(torch.from_numpy(i32),
                                                       torch.from_numpy(f32)),
                       chain, noise, n)
    assert torch.equal(merged, want)
    for other in caches[1:]:
        for name in ("k", "v", "k_scale", "v_scale"):
            if getattr(other, name) is not None:
                assert torch.equal(getattr(other, name), getattr(caches[0], name)), name


def test_warmup_sweep_runs_every_bucket(tiny_np):
    engine = _port(tiny_np, pipeline_depth=2)
    out = asyncio.run(engine.warmup())
    # buckets 16 and 32, then the implicit 128 (max_seq_len)
    assert out == {"requests": 3, "graph_captures": 0}
    assert engine.counters["prefills"] == 3 and engine.counters["decode_chunks"] == 3
    assert not engine._warming and _all_pages_back(engine)
    got = _run_group(engine, GenRequest, PROMPTS[:2], max_new_tokens=5)
    assert engine.counters["serve_captures"] == 0
    assert all(len(s) >= 1 for s in got)
    engine.stop()


def test_warmup_aux_knob(tiny_np):
    """Aux ``engine.warmup``: a typo fails at load naming the knob (the
    reference's words); with "startup" or "full" the first requests share
    one warmup sweep before they are served, and the content equals an
    unwarmed endpoint's."""
    from aiohttp.test_utils import TestClient, TestServer

    from clearml_serving_tpu_torch.llm.openai_api import build_engine, warmup_mode
    from clearml_serving_tpu_torch.serving.main import build_app
    from torch_serving import port_processor

    cfg = {"preset": "llama-tiny", "config": {"dtype": "float32"}, "max_batch": 2,
           "max_seq_len": 128, "prefill_buckets": [32, 64], "cache": "paged"}
    with pytest.raises(ValueError, match="aux engine.warmup must be off/startup/full"):
        build_engine(dict(cfg, warmup="sometimes"), device="cpu",
                     params=convert_params(tiny_np, device="cpu"))
    assert [warmup_mode(c) for c in ({}, {"warmup": "on"}, {"warmup": False},
                                     {"warmup": "startup"}, {"warmup": "FULL"})] == [
        "off", "startup", "off", "startup", "full"]
    body = {"model": "m", "max_tokens": 6,
            "messages": [{"role": "user", "content": "hello"}]}

    async def serve(mode):
        engine, tok = build_engine(dict(cfg, warmup=mode), device="cpu",
                                   params=convert_params(tiny_np, device="cpu"))
        mrp = port_processor(engine, tok, "m", warmup=mode)
        endpoint = mrp._engine_processor_lookup["m"]
        client = TestClient(TestServer(build_app(mrp)))
        await client.start_server()
        try:
            rs = await asyncio.gather(*[client.post("/serve/openai/v1/chat/completions",
                                                    json=body) for _ in range(2)])
            outs = [(await r.json())["choices"][0]["message"]["content"] for r in rs]
        finally:
            await client.close()
        return outs, engine.counters["prefills"], endpoint._warmup_needed

    warm, prefills, needed = asyncio.run(serve("startup"))
    # the sweep's three buckets (32, 64 and max_seq_len 128), then the two chats
    assert (prefills, needed) == (5, False)
    cold, prefills, _ = asyncio.run(serve("off"))
    assert prefills == 2 and warm == cold
    # the reference's full plan on this config: one cold prompt per bucket
    full, prefills, needed = asyncio.run(serve("full"))
    assert (prefills, needed) == (5, False) and full == cold
