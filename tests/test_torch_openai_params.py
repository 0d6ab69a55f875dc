"""The port's OpenAI routes (clearml_serving_tpu_torch/llm/openai_api.py,
serving/main.py) against the reference's, body for body: the route-level
cases of the reference's ``tests/test_openai_params.py`` (n choices, chat
and completions logprobs, streamed logprobs, stop strings with forced
tokens, echo and ``max_tokens: 0`` scoring, ``best_of`` and its
validation, ``prompt_logprobs``, ``suffix``, ``stream_options`` usage,
``response_role``, ``return_tokens_as_token_ids``, a bad ``logit_bias``,
multi-choice streaming, tokenize and detokenize). Both apps hold the same
llama-tiny float32 weights (the reference endpoint's parameters carried
over by ``convert_params``); sampled cases are seeded, so the port must
give the reference's tokens. Responses are held equal with ids and
timestamps left out: content, token ids, offsets and statuses exactly,
logprobs within 1e-5. The guided-decoding and tools fields are served on
chat as the reference serves them (``tests/test_torch_guided_api.py``
holds their responses); the completions route refuses the tools fields
by name."""

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

ENGINE_CFG = {
    "preset": "llama-tiny",
    "config": {"dtype": "float32"},
    "max_batch": 4,
    "max_seq_len": 128,
    "prefill_buckets": [32, 64],
    "cache": "paged",
    "scheduler": "two_dispatch",
    "seed": 0,
}
URL = "tiny_llm"
CHAT = "/serve/openai/v1/chat/completions"
CMPL = "/serve/openai/v1/completions"
LP_TOL = 1e-5
# logit_bias {42: +200, 43: +100} with presence_penalty 150 forces the
# byte sequence "*+**..." (the reference test's _FORCED)
FORCED = {"logit_bias": {"42": 200.0, "43": 100.0}, "presence_penalty": 150.0}


def _chat(**kw):
    body = {"model": URL, "messages": [{"role": "user", "content": "hello"}], "max_tokens": 8}
    body.update(kw)
    return body


def _cmpl(**kw):
    body = {"model": URL, "prompt": "abc", "max_tokens": 4}
    body.update(kw)
    return body


def _run(app, calls):
    """POST each (path, body) in order; per call (status, JSON or the SSE
    chunks)."""

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
        mrp = ModelRequestProcessor(state_root=str(root), force_create=True, name="llmp")
        mrp.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=URL,
                                       auxiliary_cfg={"engine": dict(ENGINE_CFG)}))
        mrp.serialize()
        mrp.deserialize(skip_sync=True)
        # engines load lazily: one request builds the reference engine
        _run(jax_build_app(mrp), [(CHAT, _chat(max_tokens=1))])
        np_params = jax.tree.map(np.asarray, mrp._engine_processor_lookup[URL].engine.params)

        def run_jax(calls):
            return _run(jax_build_app(mrp), calls)

        def run_port(calls):
            # a fresh engine per app: the app stops its engine on cleanup
            engine, tok = build_engine(dict(ENGINE_CFG), device="cpu",
                                       params=convert_params(np_params, device="cpu"))
            return _run(port_app(engine, tok, URL), calls)

        yield run_jax, run_port
    finally:
        if old is None:
            os.environ.pop("TPUSERVE_STATE_ROOT", None)
        else:
            os.environ["TPUSERVE_STATE_ROOT"] = old


_VOLATILE = {"id", "created"}


def _same(got, want, path="$"):
    """Equal JSON, floats within LP_TOL, ids and timestamps ignored."""
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


def _by_index(chunks, key):
    """A multi-choice stream's text per choice index (chunks interleave by
    arrival, which timing decides), and each choice's finish reason."""
    texts, finishes = {}, {}
    for chunk in chunks:
        for ch in chunk.get("choices", []):
            piece = ch["delta"].get("content") if key == "delta" else ch.get("text")
            texts[ch["index"]] = texts.get(ch["index"], "") + (piece or "")
            if ch.get("finish_reason"):
                finishes[ch["index"]] = ch["finish_reason"]
    return texts, finishes


def _held(served, calls):
    run_jax, run_port = served
    want, got = run_jax(calls), run_port(calls)
    for (gs, gb), (ws, wb) in zip(got, want):
        assert gs == ws, (gs, ws, gb)
        _same(gb, wb)
    return got


# single-choice bodies whose whole response (or SSE chunk sequence) must
# equal the reference's
CASES = {
    "n_choices": [(CHAT, _chat(n=3, temperature=1.0, seed=5))],
    "chat_logprobs": [(CHAT, _chat(logprobs=True, top_logprobs=3, max_tokens=4))],
    "completions_logprobs_and_offsets": [(CMPL, _cmpl(logprobs=2))],
    "stop_string_truncates": [(CHAT, _chat(**FORCED)), (CHAT, _chat(stop="**", **FORCED))],
    "stop_string_streaming": [(CHAT, _chat(stop=["**"], stream=True, **FORCED))],
    "streaming_emits_logprobs": [(CHAT, _chat(max_tokens=4, stream=True, logprobs=True,
                                              top_logprobs=2))],
    "stop_with_logprobs": [(CHAT, _chat(stop="**", logprobs=True, top_logprobs=1, **FORCED))],
    "penalties_and_seed": [(CHAT, _chat(temperature=1.0, seed=42, max_tokens=6,
                                        presence_penalty=0.4, frequency_penalty=0.6,
                                        repetition_penalty=1.3))] * 2,
    "min_tokens_over_biased_eos": [(CHAT, _chat(max_tokens=12, min_tokens=6,
                                                logit_bias={"257": 50.0}))],
    "bad_logit_bias": [(CHAT, _chat(logit_bias={"999999": 5}))],
    "response_role_and_usage": [
        (CHAT, _chat(response_role="bot")),
        (CHAT, _chat(stream=True, response_role="bot", stream_options={"include_usage": True}))],
    "return_tokens_as_token_ids": [
        (CHAT, _chat(logprobs=True, top_logprobs=2, return_tokens_as_token_ids=True,
                     max_tokens=4)),
        (CMPL, _cmpl(prompt="ab", logprobs=2, return_tokens_as_token_ids=True))],
    "best_of_top_ranked": [(CMPL, _cmpl(prompt="hi", max_tokens=6, temperature=1.0, seed=3,
                                        n=2, best_of=4))],
    "best_of_ranking": [
        (CMPL, _cmpl(prompt="go", max_tokens=6, temperature=1.0, seed=11, logprobs=0,
                     logit_bias={"257": -100}, n=1, best_of=3)),
        (CMPL, _cmpl(prompt="go", max_tokens=6, temperature=1.0, seed=11, logprobs=0,
                     logit_bias={"257": -100}, n=3))],
    "best_of_validation": [(CMPL, _cmpl(prompt="x", n=3, best_of=2)),
                           (CMPL, _cmpl(prompt="x", stream=True, best_of=2))],
    "best_of_with_logprobs_false": [
        (CMPL, _cmpl(prompt="go", max_tokens=6, temperature=1.0, seed=11, logprobs=False,
                     n=1, best_of=3))],
    "echo_with_logprobs": [(CMPL, _cmpl(logprobs=1)), (CMPL, _cmpl(logprobs=1, echo=True))],
    "echo_streaming": [(CMPL, _cmpl(prompt="xyz", max_tokens=3, stream=True, echo=True)),
                       (CMPL, _cmpl(prompt="xyz", max_tokens=3, stream=True, echo=True,
                                    logprobs=2))],
    "echo_max_tokens_zero_scores_prompt": [
        (CMPL, _cmpl(max_tokens=0, echo=True, logprobs=1)),
        (CMPL, _cmpl(prompt=[[256, 97, 98, 99, 100], "zz top"], max_tokens=0, echo=True,
                     logprobs=3, n=2))],
    "streaming_best_of_must_equal_n": [(CMPL, _cmpl(prompt="x", stream=True, n=2,
                                                    best_of=4))],
    "prompt_logprobs": [(CMPL, _cmpl(max_tokens=2, prompt_logprobs=2)),
                        (CHAT, _chat(max_tokens=2, prompt_logprobs=1)),
                        (CMPL, _cmpl(prompt="x", max_tokens=2, prompt_logprobs=10_000))],
    "prompt_logprobs_streaming_rejected": [
        (CMPL, _cmpl(prompt="x", max_tokens=2, stream=True, prompt_logprobs=1)),
        (CHAT, _chat(stream=True, prompt_logprobs=1)),
        (CMPL, _cmpl(max_tokens=0, prompt_logprobs=1)),
        (CMPL, _cmpl(prompt="x", max_tokens=0, stream=True, prompt_logprobs=1))],
    "suffix_rejected": [(CMPL, _cmpl(prompt="def f(", suffix="return x"))],
    "token_id_prompts": [(CMPL, _cmpl(prompt=[256, 104, 105], logprobs=1, echo=True)),
                         (CMPL, _cmpl(prompt=[256, 100000]))],
    "tokenize_detokenize": [("/serve/openai/v1/tokenize", {"model": URL, "prompt": "héllo"}),
                            ("/serve/openai/v1/detokenize", {"model": URL,
                                                             "tokens": [104, 195, 169]})],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_equals_reference(served, case):
    got = _held(served, CASES[case])
    if case == "stop_string_truncates":
        assert got[1][1]["choices"][0]["message"]["content"] == "*+"
    if case == "min_tokens_over_biased_eos":
        # six tokens under the floor, then the biased EOS (counted, not shown)
        choice = got[0][1]["choices"][0]
        assert got[0][1]["usage"]["completion_tokens"] == 7
        assert choice["finish_reason"] == "stop"
    if case == "echo_max_tokens_zero_scores_prompt":
        assert got[0][1]["choices"][0]["logprobs"]["token_logprobs"][0] is None
        assert got[1][1]["usage"]["completion_tokens"] == 0
    if case in ("bad_logit_bias", "best_of_validation", "streaming_best_of_must_equal_n",
                "suffix_rejected"):
        assert all(status == 422 for status, _ in got)


@pytest.mark.parametrize("path,body,key", [
    (CMPL, _cmpl(prompt="go", max_tokens=6, temperature=1.0, seed=21, n=3,
                 stream_options={"include_usage": True}), "text"),
    (CHAT, _chat(n=3, temperature=1.0, seed=9, max_tokens=5), "delta"),
], ids=["completions", "chat"])
def test_multi_choice_stream_equals_reference(served, path, body, key):
    """Chunks interleave by arrival: each choice's text and finish reason,
    the role chunk per choice and the usage total are the reference's,
    and equal the same body's non-streamed choices."""
    run_jax, run_port = served
    calls = [(path, dict(body, stream=True)), (path, body)]
    (ws, wchunks), (_, wfull) = run_jax(calls)
    (gs, gchunks), (_, gfull) = run_port(calls)
    assert gs == ws == 200
    assert _by_index(gchunks, key) == _by_index(wchunks, key)
    _same(gfull, wfull)
    texts, finishes = _by_index(gchunks, key)
    full = {c["index"]: c["text"] if key == "text" else c["message"]["content"]
            for c in gfull["choices"]}
    assert texts == full and set(finishes) == {0, 1, 2}
    if key == "delta":
        roles = {ch["index"] for c in gchunks for ch in c["choices"]
                 if ch["delta"].get("role")}
        assert roles == {0, 1, 2}
    else:
        usage = [c["usage"] for c in gchunks if c.get("usage")]
        assert usage == [u for c in wchunks for u in [c.get("usage")] if u]


def test_version_route(served):
    _run_jax, _run_port = served

    async def fn(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            r1 = await client.get("/serve/openai/version")
            r2 = await client.post("/serve/openai/version")
            return r1.status, await r1.json(), r2.status
        finally:
            await client.close()

    engine, tok = build_engine(dict(ENGINE_CFG, max_seq_len=64), device="cpu")
    status, body, post_status = asyncio.run(fn(port_app(engine, tok, URL)))
    assert (status, post_status) == (200, 200)
    from clearml_serving_tpu.version import __version__
    assert body == {"version": __version__}


@pytest.mark.parametrize("field,value", [
    ("response_format", {"type": "json_object"}),
    ("guided_regex", "[a-z]+"),
    ("guided_json", {"type": "object"}),
    ("guided_choice", ["yes", "no"]),
    ("tools", [{"type": "function", "function": {"name": "f",
                                                 "parameters": {"type": "object"}}}]),
    ("tool_choice", "auto"),
    ("parallel_tool_calls", False),
])
def test_guided_and_tools_fields_refused_by_name(served, field, value):
    """Chat answers each field with the reference's status (the guided
    fields served; the tools' preamble outgrowing this engine's 128-token
    context, and ``tool_choice`` without tools, refused as the reference
    refuses them); completions serve the guided fields and refuse the tools
    fields by name, fields of the chat route only."""
    run_jax, run_port = served
    chat = [(CHAT, _chat(max_tokens=2, **{field: value}))]
    want, got = run_jax(chat), run_port(chat)
    assert [s for s, _ in got] == [s for s, _ in want]
    tool_field = field in ("tools", "tool_choice", "parallel_tool_calls")
    if not tool_field:
        assert got[0][0] == 200

    async def detail():
        engine, tok = build_engine(dict(ENGINE_CFG, max_seq_len=64), device="cpu")
        client = TestClient(TestServer(port_app(engine, tok, URL)))
        await client.start_server()
        try:
            r = await client.post(CMPL, json=_cmpl(max_tokens=2, **{field: value}))
            return r.status, (await r.json())
        finally:
            await client.close()

    status, payload = asyncio.run(detail())
    if tool_field:
        assert status == 422 and field in payload["detail"]
    else:
        assert status == 200 and payload["choices"][0]["text"] is not None
    # a text response_format is no constraint: served
    ok = run_port([(CHAT, _chat(max_tokens=2, response_format={"type": "text"}))])
    assert ok[0][0] == 200
