"""The port's tool-calling helpers (clearml_serving_tpu_torch/llm/tools.py)
against the reference's (``clearml_serving_tpu/llm/tools.py``), on the
cases of the reference's ``tests/test_tools.py``: each function gives the
reference's output on the same input, or raises the same error with the
same message. ``tool_call_objects`` is compared with its random ids aside.
The route-level tool flow is in ``tests/test_torch_guided_api.py``."""

import json

import pytest

from clearml_serving_tpu.llm import tools as ref
from clearml_serving_tpu.llm.tokenizer import ByteTokenizer as RefByteTokenizer
from clearml_serving_tpu_torch.llm import tools as port
from clearml_serving_tpu_torch.llm.tokenizer import ByteTokenizer

WEATHER = {"type": "function", "function": {
    "name": "get_weather", "description": "Look up the weather",
    "parameters": {"type": "object", "properties": {"location": {"enum": ["paris", "tokyo"]}},
                   "required": ["location"]}}}
CLOCK = {"type": "function", "function": {"name": "get_time",
                                          "parameters": {"type": "object", "properties": {}}}}
BARE = {"type": "function", "function": {"name": "noop", "parameters": {}}}
NAMES = ["get_weather", "get_time"]


def _both(name, *args):
    """(port outcome, reference outcome): the value, or the error's type
    name and message."""
    out = []
    for mod in (port, ref):
        try:
            out.append(("ok", getattr(mod, name)(*args)))
        except Exception as ex:  # the same refusal is part of the contract
            out.append((type(ex).__name__, str(ex)))
    return out


VALIDATE = {
    "two_tools": [WEATHER, CLOCK], "bare": [BARE], "empty": [], "not_list": {"a": 1},
    "retrieval": [{"type": "retrieval"}], "no_name": [{"type": "function", "function": {}}],
    "bad_params": [{"type": "function", "function": {"name": "x", "parameters": 3}}],
    "duplicate": [WEATHER, WEATHER], "not_object": ["f"],
}


@pytest.mark.parametrize("case", sorted(VALIDATE))
def test_validate_tools_is_the_reference(case):
    got, want = _both("validate_tools", VALIDATE[case])
    assert got == want


CHOICES = {
    "no_tools": {}, "auto_default": {"tools": [WEATHER]},
    "none": {"tools": [WEATHER], "tool_choice": "none"},
    "auto": {"tools": [WEATHER], "tool_choice": "auto"},
    "required": {"tools": [WEATHER], "tool_choice": "required"},
    "forced": {"tools": [WEATHER], "tool_choice": {"type": "function",
                                                   "function": {"name": "get_weather"}}},
    "required_without_tools": {"tool_choice": "required"},
    "forced_without_name": {"tools": [WEATHER], "tool_choice": {"type": "function"}},
    "retrieval": {"tools": [WEATHER], "tool_choice": {"type": "retrieval",
                                                      "function": {"name": "get_weather"}}},
    "unknown": {"tools": [WEATHER], "tool_choice": "sometimes"},
}


@pytest.mark.parametrize("case", sorted(CHOICES))
def test_resolve_tool_choice_is_the_reference(case):
    got, want = _both("resolve_tool_choice", CHOICES[case])
    assert got == want


@pytest.mark.parametrize("forced", [None, "get_weather", "get_time", "nope"])
@pytest.mark.parametrize("tools", [[WEATHER, CLOCK], [BARE], [CLOCK]], ids=["two", "bare", "clock"])
def test_tool_call_schema_is_the_reference(tools, forced):
    got, want = _both("tool_call_schema", ref.validate_tools(tools), forced)
    assert got == want
    if got[0] == "ok":
        # declaration order survives serialization: name before arguments
        assert json.dumps(got[1]) == json.dumps(want[1])


PARSES = [
    '{"name": "get_weather", "arguments": {"location": "paris"}}',
    '{"name": "get_time", "parameters": {}}',
    '{"name": "get_time", "arguments": "{}"}',
    ('<tool_call>{"name": "get_weather", "arguments": {"location": "tokyo"}}</tool_call>\n'
     '<tool_call>{"name": "get_time", "arguments": {}}</tool_call>'),
    '[{"name": "get_time", "arguments": {}}]',
    "the weather is nice", '{"name": "other_fn", "arguments": {}}', '{"answer": 42}',
    '{"name": "get_time"', '{"name": "get_time", "arguments": "5"}',
    '{"name": "get_time", "arguments": "[1]"}', '{"name": "get_time", "arguments": 5}',
    '{"name": "get_time", "arguments": [1]}', '{"name": "get_time", "arguments": "not json"}',
    ('Let me check that for you.\n<tool_call>{"name": "get_weather", '
     '"arguments": {"location": "paris"}}</tool_call>'),
    '  {"name": "get_time", "arguments": {}}  ', "",
]


@pytest.mark.parametrize("text", PARSES)
def test_parse_and_strip_are_the_reference(text):
    got, want = _both("parse_tool_calls", text, NAMES)
    assert got == want
    got, want = _both("strip_tool_blocks", text)
    assert got == want


@pytest.mark.parametrize("pending", ["hello ", "hello <tool", "<", "a < b", "<tool_call",
                                     "x <tool_c>", "", "<<"])
def test_split_tag_holdback_is_the_reference(pending):
    got, want = _both("split_tag_holdback", pending)
    assert got == want
    assert port.TOOL_TAG == ref.TOOL_TAG


def test_tool_call_objects_are_the_reference_ids_aside():
    calls = ref.parse_tool_calls(PARSES[3], NAMES)
    got, want = port.tool_call_objects(calls), ref.tool_call_objects(calls)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["id"].startswith("call_") and w["id"].startswith("call_")
        assert {k: v for k, v in g.items() if k != "id"} == {k: v for k, v in w.items()
                                                              if k != "id"}


MESSAGES = [
    {"role": "user", "content": "weather?"},
    {"role": "assistant", "tool_calls": [
        {"id": "call_1", "type": "function",
         "function": {"name": "get_weather", "arguments": '{"location": "paris"}'}}]},
    {"role": "tool", "tool_call_id": "call_1", "content": "sunny"},
]


def test_preamble_and_tool_results_are_the_reference():
    tools = ref.validate_tools([WEATHER, CLOCK, BARE])
    assert port.tools_preamble(tools) == ref.tools_preamble(tools)
    assert port.messages_with_tool_results(MESSAGES) == ref.messages_with_tool_results(MESSAGES)


@pytest.mark.parametrize("tools", [[], [WEATHER], [WEATHER, CLOCK]], ids=["none", "one", "two"])
def test_render_chat_with_tools_is_the_reference(tools):
    """The byte tokenizer's template takes no ``tools=``: the preamble
    fallback, as the JAX route takes on the same tokenizer."""
    norm = ref.validate_tools(tools) if tools else []
    msgs = [{"role": "user", "content": "hi"}] + MESSAGES[1:]
    got = port.render_chat_with_tools(ByteTokenizer(512), msgs, norm)
    want = ref.render_chat_with_tools(RefByteTokenizer(512), msgs, norm)
    assert got == want
    if tools:
        assert "get_weather" in got and "respond ONLY with a JSON object" in got
