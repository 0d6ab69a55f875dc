"""The port's engine and chat route on int4 and int8 weights against the
reference's.

- Greedy token streams of the port's ``LLMEngineCore`` on a tree quantized
  by the port's ``quantize_llama_params`` equal the JAX engine's
  ``weight_quant="int4"``/``"int8"`` streams byte for byte, under
  ``two_dispatch`` and ``ragged``, on llama-tiny widened to dim 256 / ffn 512
  in float32 (projections of 2 and 4 scale groups), the same f32 weights on
  both sides.
- ``health()["weights"]`` equals the reference's ``lifecycle_stats()
  ["weights"]``.
- The knob errors (engine kwargs and aux ``weight_quant``/``quantize``:
  conflicts, bad values, a mismatch on an already-packed tree) carry the
  reference's words.
- The chat route with aux ``weight_quant: int4`` returns the reference
  route's content byte for byte.
"""

import asyncio
import json
import os

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu.ops.quant import quantize_llama_params as ref_quantize_llama
from clearml_serving_tpu.serving.endpoints import ModelEndpoint
from clearml_serving_tpu.serving.main import build_app as jax_build_app
from clearml_serving_tpu.serving.model_request_processor import ModelRequestProcessor
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.openai_api import LLMEngineRequest, build_engine
from clearml_serving_tpu_torch.models.llama import Llama, convert_params
from clearml_serving_tpu_torch.ops.quant import quantize_llama_params
from clearml_serving_tpu_torch.serving.main import build_app

WIDE = {"preset": "llama-tiny", "dtype": "float32", "dim": 256, "n_heads": 4,
        "n_kv_heads": 2, "ffn_dim": 512}
ENGINE = dict(max_batch=2, max_seq_len=96, prefill_buckets=[16, 64], eos_token_id=None,
              decode_steps=2)
LONG = [(i * 7 + 3) % 250 + 1 for i in range(40)]
SHORT = [5, 9, 2, 17, 33]
MID = [(i * 13 + 5) % 250 + 1 for i in range(19)]


@pytest.fixture(scope="module")
def wide_np():
    bundle = models.build_model("llama", WIDE)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _staggered(engine, request_cls, prompts, n=8):
    """Each prompt is submitted once the previous one has its first token,
    so later admissions overlap live decode streams."""

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


SCHEDULERS = {
    "two_dispatch": {"scheduler": "two_dispatch"},
    "ragged": {"scheduler": "ragged", "step_token_budget": 12, "ragged_decode_steps": 2},
}


@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
@pytest.mark.parametrize("wq", ["int4", "int8"])
def test_greedy_streams_match_reference(wide_np, wq, sched):
    knobs = dict(ENGINE, **SCHEDULERS[sched])
    jax_engine = JaxEngine(models.build_model("llama", WIDE), wide_np, cache_mode="paged",
                           pipeline_depth=1, weight_quant=wq, **knobs)
    want = _staggered(jax_engine, JaxGenRequest, [SHORT, LONG, MID])
    want_weights = jax_engine.lifecycle_stats()["weights"]
    jax_engine.stop()
    params = quantize_llama_params(convert_params(wide_np, device="cpu"),
                                   bits=4 if wq == "int4" else 8)
    port = LLMEngineCore(Llama(WIDE, params), weight_quant=wq, **knobs)
    got = _staggered(port, GenRequest, [SHORT, LONG, MID])
    assert got == want
    assert all(len(s) == 8 for s in got)
    assert port.health()["weights"] == want_weights
    assert want_weights["quant"] == wq
    if sched == "ragged":
        assert port.counters["ragged_steps"] >= 4 and port.step_rows["decode"] >= 1
    pool = port.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1


def test_full_precision_health_reports_no_quant(wide_np):
    port = LLMEngineCore(Llama(WIDE, convert_params(wide_np, device="cpu")), **ENGINE)
    weights = port.health()["weights"]
    assert weights["quant"] == "none"
    assert weights["bytes"] == sum(a.nbytes for a in jax.tree.leaves(wide_np))


@pytest.mark.parametrize("knobs,packed", [
    ({"weight_quant": "int4", "quantize": "int8"}, ""),
    ({"weight_quant": "int3"}, ""),
    ({"quantize": "fp8"}, ""),
    ({"weight_quant": "int8"}, "int4"),
    ({"quantize": "int4"}, "int8"),
], ids=["conflict", "bad_value", "bad_legacy_value", "mismatch_int4_tree",
        "mismatch_int8_tree"])
def test_engine_knob_errors_equal_reference(wide_np, knobs, packed):
    jtree, ttree = wide_np, convert_params(wide_np, device="cpu")
    if packed:
        bits = 4 if packed == "int4" else 8
        jtree = jax.tree.map(np.asarray, ref_quantize_llama(wide_np, bits=bits))
        ttree = quantize_llama_params(ttree, bits=bits)
    with pytest.raises(ValueError) as want:
        JaxEngine(models.build_model("llama", WIDE), jtree, cache_mode="paged",
                  pipeline_depth=1, **ENGINE, **knobs)
    with pytest.raises(ValueError) as got:
        LLMEngineCore(Llama(WIDE, ttree), **ENGINE, **knobs)
    assert str(got.value) == str(want.value)


def test_redundant_knob_on_a_packed_tree_is_a_no_op(wide_np):
    ttree = quantize_llama_params(convert_params(wide_np, device="cpu"), bits=4)
    for knobs in ({"weight_quant": "int4"}, {"quantize": "int4"}, {}):
        engine = LLMEngineCore(Llama(WIDE, ttree), **ENGINE, **knobs)
        assert engine.weight_quant == "int4"
        assert engine.health()["weights"]["quant"] == "int4"


def test_full_precision_model_refuses_a_quant_knob(wide_np):
    with pytest.raises(ValueError, match="weight_quant='int4' requested but the model"):
        LLMEngineCore(Llama(WIDE, convert_params(wide_np, device="cpu")),
                      weight_quant="int4", **ENGINE)


# -- the chat route ----------------------------------------------------------------

ENGINE_CFG = {
    "preset": "llama-tiny", "config": {"dtype": "float32"}, "max_batch": 2,
    "max_seq_len": 128, "prefill_buckets": [32, 64], "cache": "paged",
    "pipeline_depth": 1, "seed": 0,
}
CHAT = "/serve/openai/v1/chat/completions"
BODIES = [
    {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 12},
    {"messages": [{"role": "user", "content": "name three colours of the sea"}],
     "max_tokens": 16, "stream": True},
]


def _run(app, fn):
    async def runner():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()

    return asyncio.run(runner())


async def _chat(client, body, url):
    r = await client.post(CHAT, json=dict(body, model=url))
    if r.status != 200:
        return r.status, await r.text()
    if not body.get("stream"):
        return r.status, (await r.json())["choices"][0]["message"]["content"]
    pieces = []
    async for raw in r.content:
        line = raw.decode().strip()
        if line.startswith("data: ") and line != "data: [DONE]":
            pieces.append(json.loads(line[6:])["choices"][0]["delta"].get("content", ""))
    return r.status, "".join(pieces)


@pytest.fixture
def mrp(tmp_path):
    old = os.environ.get("TPUSERVE_STATE_ROOT")
    os.environ["TPUSERVE_STATE_ROOT"] = str(tmp_path)
    try:
        yield ModelRequestProcessor(state_root=str(tmp_path), force_create=True, name="w4")
    finally:
        if old is None:
            os.environ.pop("TPUSERVE_STATE_ROOT", None)
        else:
            os.environ["TPUSERVE_STATE_ROOT"] = old


def _reference_route(mrp, url, aux):
    mrp.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=url,
                                   auxiliary_cfg={"engine": aux}))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    app = jax_build_app(mrp)
    return _run(app, lambda c: asyncio.gather(*(_chat(c, b, url) for b in BODIES)))


def test_int4_route_content_is_byte_identical_to_reference(mrp):
    aux = dict(ENGINE_CFG, weight_quant="int4")
    want = _reference_route(mrp, "w4", aux)
    assert all(status == 200 for status, _ in want)
    ref_engine = mrp._engine_processor_lookup["w4"].engine
    packed = jax.tree.map(np.asarray, ref_engine.params)
    # the reference endpoint's weights, already packed: the knob is a no-op
    engine, tok = build_engine(aux, device="cpu", params=convert_params(packed, device="cpu"))
    assert engine.health()["weights"] == ref_engine.lifecycle_stats()["weights"]
    got = _run(build_app(LLMEngineRequest(engine, tok, "w4")),
               lambda c: asyncio.gather(*(_chat(c, b, "w4") for b in BODIES)))
    assert got == want and any(text for _s, text in got)


@pytest.mark.parametrize("knobs", [
    {"weight_quant": "int-4"},
    {"weight_quant": "int4", "quantize": "int8"},
    {"quantize": "int2"},
], ids=["typo", "conflicting_alias", "legacy_typo"])
def test_aux_knob_errors_carry_the_reference_words(mrp, knobs):
    aux = dict(ENGINE_CFG, **knobs)
    ((status, text), _second) = _reference_route(mrp, "bad", aux)
    assert status == 422
    with pytest.raises(ValueError) as got:
        build_engine(aux, device="cpu")
    assert str(got.value) in text


def test_aux_mismatch_on_a_packed_tree_names_its_format(wide_np):
    packed = quantize_llama_params(convert_params(wide_np, device="cpu"), bits=8)
    config = {k: v for k, v in WIDE.items() if k != "preset"}
    aux = dict(ENGINE_CFG, config=config, weight_quant="int4")
    with pytest.raises(ValueError, match="already int8-quantized"):
        build_engine(aux, device="cpu", params=packed)
