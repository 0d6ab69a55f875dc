"""Guided decoding and tools on the port's OpenAI routes
(clearml_serving_tpu_torch/llm/openai_api.py, serving/main.py) against the
reference's, body for body: every guided field (``response_format``
``json_object``/``json_schema``/``text``, ``guided_regex``,
``guided_json``, ``guided_choice``) on chat and completions, and every
``tool_choice`` mode (none, auto, required, forced; ``parallel_tool_calls:
false``) on chat, streamed and not; the refusals (malformed grammars and
schemas, malformed tools, a forced unknown tool, ``tool_choice`` without
tools, streaming tools at n > 1) with the reference's status, before any
stream header. Both apps hold the same llama-tiny float32 weights (the
reference endpoint's, carried over by ``convert_params``) and sampled
cases are seeded, so the responses must be the reference's: content, tool
calls (their random ids aside), finish reasons and the SSE chunks, with
logprobs within 1e-5."""

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
from torch_serving import port_app

# the tool preamble is ~500 byte tokens: the context holds it
ENGINE_CFG = {
    "preset": "llama-tiny",
    "config": {"dtype": "float32"},
    "max_batch": 4,
    "max_seq_len": 1024,
    "prefill_buckets": [64, 1024],
    "cache": "paged",
    "seed": 0,
}
URL = "tiny_llm"
CHAT = "/serve/openai/v1/chat/completions"
CMPL = "/serve/openai/v1/completions"
LP_TOL = 1e-5
WEATHER = {"type": "function", "function": {
    "name": "get_weather", "description": "Look up the weather",
    "parameters": {"type": "object", "properties": {"location": {"enum": ["paris", "tokyo"]}},
                   "required": ["location"]}}}
LIGHTS = {"type": "function", "function": {
    "name": "lights", "parameters": {"type": "object", "properties": {
        "on": {"type": "boolean"}}, "required": ["on"]}}}
SCHEMA = {"type": "object", "properties": {"dir": {"enum": ["north", "south"]},
                                            "n": {"type": "integer"}, "ok": {"type": "boolean"}},
          "required": ["dir", "n", "ok"]}


def _chat(**kw):
    body = {"model": URL, "messages": [{"role": "user", "content": "hello"}], "max_tokens": 24}
    body.update(kw)
    return body


def _tools(**kw):
    body = _chat(messages=[{"role": "user", "content": "weather in paris?"}], max_tokens=96,
                 temperature=0.9, seed=7, tools=[WEATHER, LIGHTS])
    body.update(kw)
    return body


def _cmpl(**kw):
    body = {"model": URL, "prompt": "abc", "max_tokens": 16}
    body.update(kw)
    return body


def _run(app, calls, settle=None):
    """POST each (path, body) in order; per call (status, JSON or the SSE
    chunks). ``settle`` is awaited after the last call, before the app
    closes."""

    async def runner():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = []
            for path, body in calls:
                r = await client.post(path, json=body)
                if r.status != 200 or not body.get("stream"):
                    out.append((r.status, await r.json() if r.status == 200 else None))
                    continue
                chunks = []
                for line in (await r.read()).decode().splitlines():
                    if line.startswith("data: ") and line != "data: [DONE]":
                        chunks.append(json.loads(line[len("data: "):]))
                out.append((r.status, chunks))
            if settle is not None:
                await settle()
            return out
        finally:
            await client.close()

    return asyncio.run(runner())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(run on the reference app, run on a fresh port app) over the same
    weights."""
    root = tmp_path_factory.mktemp("state")
    old = os.environ.get("TPUSERVE_STATE_ROOT")
    os.environ["TPUSERVE_STATE_ROOT"] = str(root)
    try:
        mrp = ModelRequestProcessor(state_root=str(root), force_create=True, name="llmg")
        mrp.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=URL,
                                       auxiliary_cfg={"engine": dict(ENGINE_CFG)}))
        mrp.serialize()
        mrp.deserialize(skip_sync=True)
        _run(jax_build_app(mrp), [(CHAT, _chat(max_tokens=1))])
        np_params = jax.tree.map(np.asarray, mrp._engine_processor_lookup[URL].engine.params)

        def run_jax(calls):
            engine = mrp._engine_processor_lookup[URL].engine

            async def settle():
                await engine.wait_drained()
                _clear_stale_guided_slots(engine)

            return _run(jax_build_app(mrp), calls, settle)

        def run_port(calls):
            engine, tok = build_engine(dict(ENGINE_CFG), device="cpu",
                                       params=convert_params(np_params, device="cpu"))
            return _run(port_app(engine, tok, URL), calls)

        yield run_jax, run_port
    finally:
        if old is None:
            os.environ.pop("TPUSERVE_STATE_ROOT", None)
        else:
            os.environ["TPUSERVE_STATE_ROOT"] = old


def _clear_stale_guided_slots(engine):
    """Free slots of the drained reference engine back to "no grammar"
    after a case. At pipeline depth 2 the reference re-anchors a freed
    slot's DFA state at the retire of a chunk dispatched while its guided
    request was live (``_retire_chunk``,
    clearml_serving_tpu/llm/engine.py:7210-7221), and the commit of an
    unguided request does not reset it (``_activate_slot``, :4926-4938). A
    chunk still in flight when a case's app closes retires when the next
    case's app starts, so whether that case's unguided request is cut to
    its first token and EOS depends on timing (ROADMAP §3). The port resets
    the state at every commit; without this the comparison depended on the
    case before and the machine's load."""
    for slot, request in enumerate(engine._slot_req):
        if request is None:
            engine._gstate[slot] = -1


_VOLATILE = {"id", "created"}


def _same(got, want, path="$"):
    """Equal JSON, floats within LP_TOL, ids (tool-call ids too) and
    timestamps ignored."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            if k not in _VOLATILE:
                _same(got[k], want[k], "{}.{}".format(path, k))
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, "{}[{}]".format(path, i))
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)) and abs(got - want) <= LP_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def _held(served, calls):
    run_jax, run_port = served
    want, got = run_jax(calls), run_port(calls)
    for (gs, gb), (ws, wb) in zip(got, want):
        assert gs == ws, (gs, ws, gb)
        _same(gb, wb)
    return got


def _both(body):
    """A body, then the same body streamed."""
    return [(CHAT if "messages" in body else CMPL, body),
            (CHAT if "messages" in body else CMPL, dict(body, stream=True))]


GUIDED = {
    "json_object": _chat(response_format={"type": "json_object"}, temperature=0.9, seed=3),
    "json_schema": _chat(response_format={"type": "json_schema", "json_schema": {
        "name": "s", "schema": SCHEMA}}, max_tokens=48, temperature=0.9, seed=4,
        presence_penalty=0.3),
    "text_format": _chat(response_format={"type": "text"}, max_tokens=4),
    "guided_regex": _chat(guided_regex="(north|south|east|west)", logprobs=True,
                          top_logprobs=3),
    "guided_json": _chat(guided_json=json.dumps(SCHEMA), max_tokens=48),
    "guided_choice": _chat(guided_choice=["yes", "no", "not.sure"], temperature=0.9, seed=9),
    "guided_regex_n2": _chat(guided_regex="[a-z]{2,8}", n=2, temperature=0.9, seed=5),
    "completions_regex": _cmpl(guided_regex="[0-9]{2,4}", logprobs=2),
    "completions_choice": _cmpl(guided_choice=["cat", "dog"], temperature=0.9, seed=1),
    "completions_json_object": _cmpl(response_format={"type": "json_object"}, max_tokens=24),
}
TOOLS = {
    "required": _tools(tool_choice="required"),
    "forced": _tools(tool_choice={"type": "function", "function": {"name": "get_weather"}}),
    "forced_single": _tools(tool_choice={"type": "function", "function": {"name": "lights"}},
                            parallel_tool_calls=False),
    "auto": _tools(max_tokens=12),
    "auto_with_json_object": _tools(max_tokens=24, response_format={"type": "json_object"}),
    "none": _tools(tool_choice="none", max_tokens=8),
    "required_logprobs": _tools(tool_choice="required", logprobs=True, top_logprobs=2),
}


def _by_index(chunks):
    """A multi-choice stream's text and finish reason per choice index
    (chunks interleave by arrival, which timing decides)."""
    texts, finishes = {}, {}
    for chunk in chunks:
        for ch in chunk.get("choices", []):
            texts[ch["index"]] = texts.get(ch["index"], "") + (ch["delta"].get("content") or "")
            if ch.get("finish_reason"):
                finishes[ch["index"]] = ch["finish_reason"]
    return texts, finishes


@pytest.mark.parametrize("case", sorted(GUIDED))
def test_guided_fields_equal_the_reference(served, case):
    body = GUIDED[case]
    if body.get("n", 1) == 1:
        got = _held(served, _both(body))
        assert all(status == 200 for status, _ in got)
        return
    got = _held(served, [(CHAT, body)])
    run_jax, run_port = served
    (ws, wchunks), = run_jax([(CHAT, dict(body, stream=True))])
    (gs, gchunks), = run_port([(CHAT, dict(body, stream=True))])
    assert gs == ws == 200 and _by_index(gchunks) == _by_index(wchunks)
    texts, _finishes = _by_index(gchunks)
    assert texts == {c["index"]: c["message"]["content"] for c in got[0][1]["choices"]}


@pytest.mark.parametrize("case", sorted(TOOLS))
def test_tool_choice_modes_equal_the_reference(served, case):
    got = _held(served, _both(TOOLS[case]))
    (status, full), (_s, chunks) = got
    assert status == 200
    choice = full["choices"][0]
    if case.startswith(("required", "forced")):
        # the grammar forces the call; at these settings it completes
        assert choice["finish_reason"] == "tool_calls"
        calls = choice["message"]["tool_calls"]
        assert len(calls) == 1 and calls[0]["id"].startswith("call_")
        forced = {"forced": "get_weather", "forced_single": "lights"}
        assert calls[0]["function"]["name"] in (
            [forced[case]] if case in forced else ["get_weather", "lights"])
        json.loads(calls[0]["function"]["arguments"])
        streamed = [c for c in chunks if c["choices"]
                    and c["choices"][0]["delta"].get("tool_calls")]
        assert streamed and chunks[-1]["choices"][0]["finish_reason"] == "tool_calls"
    if case == "auto_with_json_object":
        assert choice["finish_reason"] != "tool_calls"


def test_none_after_a_forced_call_keeps_its_stream(served):
    """The port alone (the reference cuts this stream to its first token
    and EOS when the forced call's slot state is left stale, ROADMAP §3):
    tool_choice none right after a forced call on the same port app streams
    what it streams on a fresh app, which is the reference's content on a
    clean engine."""
    run_jax, run_port = served
    (_ws, clean), = run_jax([(CHAT, TOOLS["none"])])
    forced, (status, after) = run_port([(CHAT, TOOLS["forced_single"]), (CHAT, TOOLS["none"])])
    assert forced[0] == status == 200
    assert forced[1]["choices"][0]["finish_reason"] == "tool_calls"
    _same(after, clean)
    assert len(after["choices"][0]["message"]["content"]) > 1


REFUSED = {
    "bad_regex": _chat(guided_regex="a\\bc"),
    "unclosed_regex": _chat(guided_regex="(ab"),
    "bad_schema": _chat(guided_json="{not json"),
    "yaml_format": _chat(response_format={"type": "yaml"}),
    "schema_missing": _chat(response_format={"type": "json_schema", "json_schema": {}}),
    "choice_not_list": _chat(guided_choice="yes"),
    "malformed_tool": _tools(tools=[{"type": "function", "function": {}}]),
    "forced_unknown_tool": _tools(tool_choice={"type": "function",
                                               "function": {"name": "nope"}}),
    "tool_choice_without_tools": _chat(tool_choice="required"),
    "streamed_tools_n2": _tools(n=2, stream=True),
    "completions_bad_regex": _cmpl(guided_regex="(a"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_equal_the_reference(served, case):
    body = REFUSED[case]
    calls = [(CMPL if "prompt" in body else CHAT, body)]
    if not body.get("stream"):
        calls.append((calls[0][0], dict(body, stream=True)))
    got = _held(served, calls)
    assert all(status == 422 for status, _ in got)
