"""The port's HTTP chat route (clearml_serving_tpu_torch/serving/main.py)
against the reference's route, built the way the reference's own tests build
it, with a paged cache on llama-tiny in float32. Both sides hold the same
weights (the reference endpoint's parameters carried over by
``convert_params``); greedy ``content`` must be byte-identical, streamed and
not."""

import asyncio
import json
import os

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from clearml_serving_tpu.serving.endpoints import ModelEndpoint
from clearml_serving_tpu.serving.main import build_app as jax_build_app
from clearml_serving_tpu.serving.model_request_processor import ModelRequestProcessor
from clearml_serving_tpu_torch.llm.openai_api import build_engine
from clearml_serving_tpu_torch.models.llama import convert_params
from torch_serving import port_app as processor_app

ENGINE_CFG = {
    "preset": "llama-tiny",
    "config": {"dtype": "float32"},
    "max_batch": 2,
    "max_seq_len": 128,
    "prefill_buckets": [32, 64],
    "cache": "paged",
    "pipeline_depth": 1,
    "scheduler": "two_dispatch",
    "seed": 0,
}
URL = "tiny_llm"
CHAT = "/serve/openai/v1/chat/completions"

BODIES = [
    {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 12},
    {"messages": [{"role": "system", "content": "be brief"},
                  {"role": "user", "content": "name three colours of the sea"}],
     "max_tokens": 20, "temperature": 0.0},
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


async def _chat(client, body):
    r = await client.post(CHAT, json=dict(body, model=URL))
    assert r.status == 200, await r.text()
    if not body.get("stream"):
        out = await r.json()
        choice = out["choices"][0]
        return choice["message"]["content"], choice["finish_reason"], out["usage"]
    pieces, finish = [], None
    async for raw in r.content:
        line = raw.decode().strip()
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        chunk = json.loads(line[len("data: "):])
        assert "error" not in chunk, chunk
        choice = chunk["choices"][0]
        pieces.append(choice["delta"].get("content", ""))
        finish = choice["finish_reason"] or finish
    return "".join(pieces), finish, None


async def _chat_all(client):
    out = []
    for body in BODIES:
        for stream in (False, True):
            out.append(await _chat(client, dict(body, stream=stream)))
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(reference app, port app) holding the same weights."""
    root = tmp_path_factory.mktemp("state")
    old = os.environ.get("TPUSERVE_STATE_ROOT")
    os.environ["TPUSERVE_STATE_ROOT"] = str(root)
    try:
        mrp = ModelRequestProcessor(state_root=str(root), force_create=True, name="llm")
        mrp.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=URL,
                                       auxiliary_cfg={"engine": dict(ENGINE_CFG)}))
        mrp.serialize()
        mrp.deserialize(skip_sync=True)
        jax_app = jax_build_app(mrp)
        # engines load lazily: one request builds the reference engine
        want = _run(jax_app, _chat_all)
        np_params = jax.tree.map(
            np.asarray, mrp._engine_processor_lookup[URL].engine.params)

        def port_app(**aux):
            # a fresh engine per app: the app stops its engine on cleanup
            engine, tok = build_engine(
                dict(ENGINE_CFG, **aux), device="cpu",
                params=convert_params(np_params, device="cpu"),
            )
            return processor_app(engine, tok, URL)

        yield mrp, port_app, want
    finally:
        if old is None:
            os.environ.pop("TPUSERVE_STATE_ROOT", None)
        else:
            os.environ["TPUSERVE_STATE_ROOT"] = old


def test_chat_content_is_byte_identical_to_reference(served):
    _mrp, port_app, want = served
    got = _run(port_app(), _chat_all)
    assert [g[0] for g in got] == [w[0] for w in want]
    assert any(g[0] for g in got)
    # finish reasons and usage agree with the reference; streamed content
    # equals the non-streamed content
    assert [g[1] for g in got] == [w[1] for w in want]
    assert [g[2] for g in got] == [w[2] for w in want]
    for i in range(0, len(got), 2):
        assert got[i][0] == got[i + 1][0]


def test_ragged_route_content_is_byte_identical_to_reference(served):
    """The same bodies through a port endpoint whose aux block selects the
    ragged scheduler (prompts prefill in 12-token chunks, decode rows take
    two-token windows) return the reference's content, finish reasons and
    usage."""
    _mrp, port_app, want = served
    got = _run(port_app(scheduler="ragged", step_token_budget=12, ragged_decode_steps=2),
               _chat_all)
    assert got == want


def test_stop_string_trims_like_reference(served):
    mrp, port_app, want = served
    text = want[2][0]
    stop = text[3:5] if len(text) >= 5 else text[-1:]
    assert stop, "reference produced no text to stop on"
    body = dict(BODIES[1], stop=[stop])
    ref = _run(jax_build_app(mrp), lambda c: asyncio.gather(
        _chat(c, body), _chat(c, dict(body, stream=True))))
    got = _run(port_app(), lambda c: asyncio.gather(
        _chat(c, body), _chat(c, dict(body, stream=True))))
    assert [g[0] for g in got] == [r[0] for r in ref]
    assert got[0][1] == got[1][1] == "stop"
    assert stop not in got[0][0]


def test_models_health_and_refusals(served):
    _mrp, port_app, _want = served

    async def fn(client):
        # the router's OpenAI routes name the endpoint by the body's model
        r = await client.post("/serve/openai/v1/models", json={"model": URL})
        assert r.status == 200
        assert (await r.json())["data"][0]["id"] == URL
        r = await client.get("/health")
        assert r.status == 200 and (await r.json())["endpoints"] == [URL]
        r = await client.get("/ready")
        assert r.status == 200
        health = (await r.json())["engines"][URL]
        assert health["cache"] == "paged" and health["ready"]
        r = await client.post(CHAT, json=dict(BODIES[0], model="nope"))
        assert r.status == 404
        # a field the chat route does not take is refused by name
        r = await client.post(CHAT, json=dict(BODIES[0], model=URL, suffix="x"))
        assert r.status == 422 and "suffix" in (await r.json())["detail"]
        # tool_choice without tools, as the reference refuses it
        r = await client.post(CHAT, json=dict(BODIES[0], model=URL, tool_choice="auto"))
        assert r.status == 422
        r = await client.post(CHAT, json=dict(BODIES[0], model=URL,
                                              messages=[{"role": "user",
                                                         "content": "x" * 200}]))
        assert r.status == 422 and "max_seq_len" in (await r.json())["detail"]

    _run(port_app(), fn)


@pytest.mark.parametrize("key", [
    pytest.param("lora_adapters", id="prefix_cache"), "speculation", "weight_quant"])
def test_unsupported_aux_engine_keys_raise(key):
    with pytest.raises(ValueError, match=key):
        build_engine(dict(ENGINE_CFG, **{key: 8}), device="cpu")
