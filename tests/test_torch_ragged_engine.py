"""The port's ragged path against the reference's: ``Llama.forward_ragged``
(clearml_serving_tpu_torch/models/llama.py) against the JAX
``forward_ragged`` on a mixed batch (logits and written pool rows, atol
1e-4), and the port's engine at ``scheduler="ragged"`` against the JAX
``LLMEngineCore(cache_mode="paged", pipeline_depth=1, scheduler="ragged")``
on staggered prompts: greedy token streams identical, model-dtype and int8
pools. llama-tiny in float32, the same weights through ``convert_params``."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu.llm.kv_cache import PagedKVCache as JaxPagedKVCache
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
from clearml_serving_tpu_torch.llm.openai_api import build_engine
from clearml_serving_tpu_torch.models.llama import Llama, convert_params
from clearml_serving_tpu_torch.ops.paged_attention import ragged_layout

TINY = {"preset": "llama-tiny", "dtype": "float32"}
ATOL = 1e-4
# the reference's ragged engine tests' prompts (tests/test_ragged_engine.py)
LONG = [(i * 7 + 3) % 250 + 1 for i in range(40)]
SHORT = [5, 9, 2, 17, 33]
MID = [(i * 13 + 5) % 250 + 1 for i in range(19)]


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _cfg(kv_quant):
    return dict(TINY, kv_quant=kv_quant) if kv_quant else dict(TINY)


# -- forward_ragged -----------------------------------------------------------

# (history already in the cache, query tokens this step) per row: a decode
# row, a chunk at history 0, a chunk mid-history crossing page boundaries,
# an idle row
ROWS = [(11, 1), (0, 7), (6, 9), (0, 0)]


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
def test_forward_ragged_matches_reference(tiny_np, kv_quant):
    cfg = _cfg(kv_quant)
    bundle = models.build_model("llama", cfg)
    model = Llama(cfg, convert_params(tiny_np, device="cpu"))
    geo = dict(num_pages=24, page_size=4, max_slots=len(ROWS))
    jcache = JaxPagedKVCache(bundle.n_layers, bundle.n_kv_heads, bundle.head_dim,
                             dtype="float32", kv_quant=kv_quant, **geo)
    tcache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                          dtype=torch.float32, kv_quant=kv_quant, device="cpu", **geo)
    rng = np.random.default_rng(7)
    # the same history K/V in both caches (the reference's prefill)
    for slot, (hist, _n) in enumerate(ROWS):
        if not hist:
            continue
        ids = rng.integers(0, 512, hist).astype(np.int32)
        _last, mini = bundle.prefill(tiny_np, jnp.asarray(ids[None]),
                                     jnp.asarray([hist], jnp.int32),
                                     bundle.init_cache(1, hist))
        parts = [np.array(mini[k])[:, 0, :hist] for k in ("k", "v")]
        if kv_quant:
            parts += [np.array(mini[k])[:, 0, :hist] for k in ("k_scale", "v_scale")]
        jcache.write_prompt(slot, parts[0], parts[1], hist, *parts[2:])
        tcache.write_prompt(slot, *(torch.from_numpy(p) for p in parts[:2]), hist,
                            *(torch.from_numpy(p) for p in parts[2:]))
    row_lens = np.array([n for _h, n in ROWS], np.int32)
    starts, _br, _bq, t = ragged_layout(row_lens, 1, total=int(row_lens.sum()) + 3)
    tokens = np.zeros(t, np.int32)
    tok_pos = np.zeros(t, np.int32)
    tok_row = np.zeros(t, np.int32)
    tok_valid = np.zeros(t, bool)
    write_page = np.zeros(t, np.int32)
    write_offset = np.zeros(t, np.int32)
    row_last = np.zeros(len(ROWS), np.int32)
    kv_lens = np.zeros(len(ROWS), np.int32)
    for slot, (hist, n) in enumerate(ROWS):
        if not n:
            continue
        s = int(starts[slot])
        jcache.pool.extend(slot, n)
        tcache.pool.extend(slot, n)
        coords = jcache.pool.token_coords(slot, hist, n)
        assert tcache.pool.token_coords(slot, hist, n) == coords
        tokens[s:s + n] = rng.integers(0, 512, n)
        tok_pos[s:s + n] = hist + np.arange(n)
        tok_row[s:s + n] = slot
        tok_valid[s:s + n] = True
        write_page[s:s + n] = [p for p, _ in coords]
        write_offset[s:s + n] = [o for _, o in coords]
        row_last[slot] = s + n - 1
        kv_lens[slot] = hist + n
    table = jcache.pool.page_table(6)
    np.testing.assert_array_equal(table, tcache.pool.page_table(6))
    flat = (tokens, tok_pos, tok_row, tok_valid, row_last)
    rows = (table, kv_lens, starts, row_lens, write_page, write_offset)
    jscale = ({"k_scales": jcache.k_scale, "v_scales": jcache.v_scale} if kv_quant else {})
    out = bundle.forward_ragged(tiny_np, *(jnp.asarray(a) for a in flat), jcache.k, jcache.v,
                                *(jnp.asarray(a) for a in rows), **jscale)
    tscale = ({"k_scales": tcache.k_scale, "v_scales": tcache.v_scale} if kv_quant else {})
    logits = model.forward_ragged(
        torch.from_numpy(tokens).long(), *(torch.from_numpy(a) for a in flat[1:]),
        tcache.k, tcache.v, *(torch.from_numpy(a) for a in rows), **tscale)
    live = row_lens > 0
    np.testing.assert_allclose(logits.numpy()[live], np.asarray(out[0])[live],
                               atol=ATOL, rtol=ATOL)
    # the rows this step wrote, in every layer
    wp, wo = write_page[tok_valid], write_offset[tok_valid]
    names = ("k", "v") + (("k_scale", "v_scale") if kv_quant else ())
    for i, name in enumerate(names):
        got = getattr(tcache, name)[:, :, wp, wo].numpy()
        want = np.asarray(out[1 + i])[:, :, wp, wo]
        if kv_quant and name in ("k", "v"):
            # int8 codes may differ by one where x/scale sits on a .5 tie
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
            assert (got == want).mean() > 0.99
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("kw,name,error", [
    ({"lora_idx": torch.zeros(2, dtype=torch.int32)}, "lora_idx", NotImplementedError),
    ({"row_logit_idx": torch.zeros(3, 2, dtype=torch.int32)}, "row_logit_idx", ValueError),
    ({"tree_anc": torch.full((4, 2), -2, dtype=torch.int64)}, "tree_anc", ValueError),
], ids=["lora_idx", "row_logit_idx", "tree_anc"])
def test_forward_ragged_later_slice_operands_raise(tiny_np, kw, name, error):
    """LoRA rows belong to a later slice and raise naming it; the verify
    operands (ported: tests/test_torch_spec_engine.py) raise naming
    themselves when their shape or dtype is not the call's."""
    model = Llama(TINY, convert_params(tiny_np, device="cpu"))
    cache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim, num_pages=4,
                         page_size=4, max_slots=2, dtype=torch.float32, device="cpu")
    i32 = lambda *s: torch.zeros(*s, dtype=torch.int32)  # noqa: E731
    args = (i32(4).long(), i32(4), i32(4), torch.zeros(4, dtype=torch.bool), i32(2),
            cache.k, cache.v, i32(2, 1), i32(2), i32(2), i32(2), i32(4), i32(4))
    with pytest.raises(error, match=name):
        model.forward_ragged(*args, **kw)


# -- the engine ---------------------------------------------------------------

ENGINE = dict(max_batch=2, max_seq_len=96, prefill_buckets=[16, 64], eos_token_id=None,
              decode_steps=2)


def _staggered(engine, request_cls, prompts, n=8):
    """Submit each prompt once the previous one has streamed its first
    token, so every later admission overlaps a live decode stream: the
    mixed prefill+decode batches the ragged scheduler is for."""

    async def one(ids, started, go):
        if started is not None:
            await started.wait()
        out = []
        async for t in engine.generate(request_cls(prompt_ids=list(ids), max_new_tokens=n)):
            out.append(t)
            go.set()
        return out

    async def run():
        events = [asyncio.Event() for _ in prompts]
        outs = await asyncio.gather(*(
            one(p, events[i - 1] if i else None, events[i]) for i, p in enumerate(prompts)))
        await engine.wait_drained()
        return outs

    return asyncio.run(run())


def _page_kw(kv_quant):
    # int8 pools take 32-token pages, the reference's default for them
    return {"page_size": 32 if kv_quant else 16}


@pytest.mark.parametrize("ragged_decode_steps", [1, 2])
@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
def test_ragged_streams_match_reference(tiny_np, kv_quant, ragged_decode_steps):
    cfg = _cfg(kv_quant)
    knobs = dict(ENGINE, scheduler="ragged", step_token_budget=12,
                 ragged_decode_steps=ragged_decode_steps, **_page_kw(kv_quant))
    prompts = [SHORT, LONG, MID]
    jax_engine = JaxEngine(models.build_model("llama", cfg), tiny_np, cache_mode="paged",
                           pipeline_depth=1, **knobs)
    want = _staggered(jax_engine, JaxGenRequest, prompts)
    jax_engine.stop()
    port = LLMEngineCore(Llama(cfg, convert_params(tiny_np, device="cpu")), **knobs)
    got = _staggered(port, GenRequest, prompts)
    assert got == want
    assert all(len(s) == 8 for s in got)
    # chunked admissions rode mixed launches beside live decode rows
    health = port.health()
    ragged = health["ragged"]
    assert health["scheduler"] == "ragged"
    assert ragged["steps"] == port.counters["ragged_steps"] >= 4
    assert ragged["step_rows"]["prefill"] >= 3 + len(LONG) // 12
    assert ragged["step_rows"]["decode"] >= 1
    assert ragged["decode_steps"] == ragged_decode_steps
    assert ragged["budget_utilization"]["count"] == ragged["steps"]
    assert ragged["tokens_per_launch"]["count"] >= 1
    assert ragged["decode_tokens"] == port.counters["ragged_decode_tokens"] >= 1
    if ragged_decode_steps > 1:
        # q=2 windows engaged: some launch advanced a row by two tokens
        assert port.counters["ragged_chain_steps"] >= 1
    assert ragged["prefill_jobs"] == 0 and port.active_slots == 0
    pool = port.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1      # every page came back


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
def test_ragged_and_two_dispatch_arms_agree(tiny_np, kv_quant):
    """Within the port, the ragged scheduler replays the two-dispatch
    streams (greedy), as the reference's arms do."""
    cfg = _cfg(kv_quant)
    streams = []
    for sched in ({"scheduler": "two_dispatch"},
                  {"scheduler": "ragged", "step_token_budget": 12}):
        engine = LLMEngineCore(Llama(cfg, convert_params(tiny_np, device="cpu")),
                               **dict(ENGINE, **sched, **_page_kw(kv_quant)))
        streams.append(_staggered(engine, GenRequest, [SHORT, LONG, MID]))
    assert streams[0] == streams[1]


def test_eos_inside_a_window_drops_the_surplus(tiny_np):
    """A stop token inside a q=2 decode window ends the stream there in
    both engines; the window's surplus never reaches the client."""
    knobs = dict(ENGINE, scheduler="ragged", step_token_budget=12, ragged_decode_steps=2)
    probe = LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")), **knobs)
    eos = _staggered(probe, GenRequest, [SHORT, LONG])[1][4]
    knobs["eos_token_id"] = eos
    jax_engine = JaxEngine(models.build_model("llama", TINY), tiny_np, cache_mode="paged",
                           pipeline_depth=1, **knobs)
    want = _staggered(jax_engine, JaxGenRequest, [SHORT, LONG])
    jax_engine.stop()
    port = LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")), **knobs)
    got = _staggered(port, GenRequest, [SHORT, LONG])
    assert got == want
    assert got[1][-1] == eos and len(got[1]) <= 5
    assert port.paged_cache.pool.free_pages == port.paged_cache.pool.num_pages - 1


def test_pool_exhaustion_fails_only_the_admission_that_ran_out(tiny_np):
    """Four usable 16-token pages: a 70-token prompt can never fit, so its
    chunk row is dropped from the launch that cannot extend it and its
    request fails with MemoryError; the stream decoding beside it finishes
    untouched, and every page comes back."""
    port = LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")),
                         **dict(ENGINE, scheduler="ragged", step_token_budget=12,
                                page_size=16, num_pages=5))
    want = _staggered(LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")),
                                    **dict(ENGINE, scheduler="ragged", step_token_budget=12)),
                      GenRequest, [SHORT])[0]
    long_prompt = [(i * 11 + 7) % 250 + 1 for i in range(70)]

    async def run():
        async def one(ids, started=None, first=None):
            if started is not None:
                await started.wait()
            out = []
            async for t in port.generate(GenRequest(prompt_ids=ids, max_new_tokens=8)):
                out.append(t)
                if first is not None:
                    first.set()
            return out

        first = asyncio.Event()
        outs = await asyncio.gather(one(SHORT, first=first), one(long_prompt, started=first),
                                    return_exceptions=True)
        await port.wait_drained()
        return outs

    short, long_out = asyncio.run(run())
    assert short == want
    assert isinstance(long_out, MemoryError) and "ragged admission" in str(long_out)
    assert port.step_rows["prefill"] >= 4 and not port._prefill_jobs
    assert port.paged_cache.pool.free_pages == port.paged_cache.pool.num_pages - 1


def test_cancelled_ragged_admission_frees_its_slot(tiny_np):
    port = LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")),
                         **dict(ENGINE, scheduler="ragged", step_token_budget=12))

    async def run():
        req = GenRequest(prompt_ids=LONG, max_new_tokens=8)
        gen = port.generate(req)
        task = asyncio.ensure_future(gen.__anext__())
        while port.counters["ragged_steps"] == 0:
            await asyncio.sleep(0.001)
        req.cancel()                      # mid-prefill: 40 tokens, 12 a step
        with pytest.raises(StopAsyncIteration):
            await task
        await port.wait_drained()

    asyncio.run(run())
    assert not port._prefill_jobs and not port._admitting
    assert port.paged_cache.pool.free_pages == port.paged_cache.pool.num_pages - 1


@pytest.mark.parametrize("knobs", [
    {"scheduler": "fancy"},
    {"scheduler": "ragged", "step_token_budget": 2},
    {"scheduler": "ragged", "ragged_decode_steps": 3},
    {"ragged_decode_steps": 3},
], ids=["scheduler_typo", "budget_not_above_max_batch", "window_past_decode_steps",
        "window_past_decode_steps_two_dispatch"])
def test_knob_validation_errors_equal_reference(tiny_np, knobs):
    with pytest.raises(ValueError) as want:
        JaxEngine(models.build_model("llama", TINY), tiny_np, cache_mode="paged",
                  pipeline_depth=1, **ENGINE, **knobs)
    with pytest.raises(ValueError) as got:
        LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")), **ENGINE, **knobs)
    assert str(got.value) == str(want.value)


def test_build_engine_passes_the_ragged_aux_keys(tiny_np):
    engine, _tok = build_engine(
        {"preset": "llama-tiny", "config": {"dtype": "float32"}, "cache": "paged",
         "max_batch": 2, "max_seq_len": 64, "decode_steps": 4, "scheduler": "ragged",
         "step_token_budget": 24, "ragged_decode_steps": 2},
        device="cpu", params=convert_params(tiny_np, device="cpu"))
    ragged = engine.health()["ragged"]
    assert (ragged["step_token_budget"], ragged["decode_steps"]) == (24, 2)
    assert engine.health()["scheduler"] == "ragged"
