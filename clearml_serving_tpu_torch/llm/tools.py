"""OpenAI tool / function calling for chat completions.

The port's copy of ``clearml_serving_tpu/llm/tools.py`` (no JAX in it, but
the port imports nothing of the JAX package). Its outputs must stay the
reference's (``tests/test_torch_tools.py``).

- ``tool_choice`` "required" / {"function": {"name": ...}} compiles the
  tool-call JSON into the guided-decoding DFA (llm/guided.py): the decode
  chunk itself can only produce ``{"name": <tool>, "arguments":
  <schema-valid args>}``; arguments are enforced by construction, not
  validated after the fact.
- ``tool_choice`` "auto" leaves sampling free and parses the finished
  text: Hermes/Qwen ``<tool_call>{...}</tool_call>`` blocks and bare
  Llama-3-style JSON objects ``{"name": ..., "arguments"|"parameters":
  {...}}`` (single or array), accepted only when the name matches a
  declared tool so ordinary JSON answers are never misread as calls.
- Tool definitions reach the model through the chat template's ``tools=``
  kwarg when the template supports it; otherwise a system preamble is
  injected (render_chat_with_tools probes the rendered text for the tool
  names).
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple


def validate_tools(tools: Any) -> List[Dict[str, Any]]:
    """Normalize the OpenAI ``tools`` array -> [{name, description,
    parameters}]. Raises ValueError (-> 422) on malformed entries."""
    if not isinstance(tools, (list, tuple)) or not tools:
        raise ValueError("tools must be a non-empty array")
    out = []
    for i, t in enumerate(tools):
        if not isinstance(t, dict):
            raise ValueError("tools[{}] must be an object".format(i))
        if t.get("type", "function") != "function":
            raise ValueError(
                "tools[{}].type {!r} unsupported (only 'function')".format(
                    i, t.get("type")
                )
            )
        fn = t.get("function")
        if not isinstance(fn, dict) or not fn.get("name"):
            raise ValueError("tools[{}].function.name missing".format(i))
        params = fn.get("parameters")
        if params is not None and not isinstance(params, dict):
            raise ValueError(
                "tools[{}].function.parameters must be a JSON schema "
                "object".format(i)
            )
        out.append(
            {
                "name": str(fn["name"]),
                "description": str(fn.get("description") or ""),
                "parameters": params if params is not None else {"type": "object"},
            }
        )
    if len({t["name"] for t in out}) != len(out):
        raise ValueError("tool names must be unique")
    return out


def resolve_tool_choice(body: Dict[str, Any]) -> Tuple[str, Optional[str]]:
    """-> (mode, forced_name) with mode in none|auto|required|forced.
    OpenAI default: 'auto' when tools are present, 'none' otherwise."""
    tools = body.get("tools")
    choice = body.get("tool_choice")
    if not tools:
        if choice not in (None, "none"):
            raise ValueError("tool_choice given without tools")
        return "none", None
    if choice is None or choice == "auto":
        return "auto", None
    if choice == "none":
        return "none", None
    if choice == "required":
        return "required", None
    if isinstance(choice, dict):
        if choice.get("type", "function") != "function":
            raise ValueError(
                "tool_choice.type {!r} unsupported (only 'function')".format(
                    choice.get("type")
                )
            )
        name = (choice.get("function") or {}).get("name")
        if not name:
            raise ValueError("tool_choice.function.name missing")
        return "forced", str(name)
    raise ValueError("unsupported tool_choice {!r}".format(choice))


def tool_call_schema(
    tools: Sequence[Dict[str, Any]], forced_name: Optional[str] = None
) -> Dict[str, Any]:
    """JSON schema for one tool-call object, lowered by
    guided.json_schema_to_regex into the on-device DFA. ``const`` pins the
    name; the tool's own parameters schema constrains the arguments."""
    subset = [t for t in tools if forced_name is None or t["name"] == forced_name]
    if not subset:
        raise ValueError(
            "tool_choice names unknown tool {!r}".format(forced_name)
        )
    def arguments_schema(params: Dict[str, Any]) -> Dict[str, Any]:
        # OpenAI strict-function-calling semantics: the arguments object is
        # exactly the declared parameters. A declared-properties object is
        # already closed by the DFA lowering (only declared members can be
        # emitted); pinning additionalProperties: false extends that to the
        # propertyless case, which would otherwise lower to "any object" —
        # unbounded free-form members that a constrained decode could
        # wander in until max_tokens instead of closing the call.
        out = dict(params)
        out.setdefault("additionalProperties", False)
        # a bare `parameters: {}` has no "type" key either: without it the
        # DFA lowering would skip both object branches and fall through to
        # "any JSON value", un-closing the object the line above closed
        out.setdefault("type", "object")
        return out

    variants = [
        {
            "type": "object",
            "properties": {
                "name": {"const": t["name"]},
                "arguments": arguments_schema(t["parameters"]),
            },
            "required": ["name", "arguments"],
        }
        for t in subset
    ]
    return variants[0] if len(variants) == 1 else {"anyOf": variants}


# Hermes / Qwen style: one JSON object per <tool_call> block
_TOOL_BLOCK_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>", re.S)
TOOL_TAG = "<tool_call>"


def strip_tool_blocks(text: str) -> str:
    """Prose left after removing <tool_call> blocks — OpenAI allows content
    alongside tool_calls when the model narrates before calling."""
    return _TOOL_BLOCK_RE.sub("", text).strip()


def split_tag_holdback(pending: str) -> Tuple[str, str]:
    """(emit, keep): hold back the longest trailing prefix of
    ``<tool_call>`` so a tag spanning stream deltas is never partially
    emitted as content (same pattern as stop-string holdback)."""
    for k in range(min(len(TOOL_TAG) - 1, len(pending)), 0, -1):
        if pending.endswith(TOOL_TAG[:k]):
            return pending[:-k], pending[-k:]
    return pending, ""


def _normalize_call(
    value: Any, known: Optional[set]
) -> Optional[Dict[str, str]]:
    if not isinstance(value, dict):
        return None
    name = value.get("name")
    if not isinstance(name, str) or not name:
        return None
    if known is not None and name not in known:
        return None
    args = value.get("arguments", value.get("parameters"))
    if args is None:
        args = {}
    if isinstance(args, str):
        try:  # already JSON-encoded; OpenAI clients require an object
            parsed = json.loads(args)
        except ValueError:
            return None
        if not isinstance(parsed, dict):
            return None
        arg_str = args
    elif isinstance(args, dict):
        arg_str = json.dumps(args)
    else:  # list / scalar arguments are not a valid call shape
        return None
    return {"name": name, "arguments": arg_str}


def parse_tool_calls(
    text: str, tool_names: Optional[Sequence[str]] = None
) -> Optional[List[Dict[str, str]]]:
    """Extract tool calls from finished model text, or None if the text is
    a plain answer. ``tool_names`` gates bare-JSON detection so an ordinary
    JSON reply whose object happens to have a "name" key is not misread."""
    known = set(tool_names) if tool_names is not None else None
    stripped = text.strip()
    blocks = _TOOL_BLOCK_RE.findall(stripped)
    if blocks:
        calls = []
        for b in blocks:
            try:
                call = _normalize_call(json.loads(b), known)
            except ValueError:
                return None
            if call is None:
                return None
            calls.append(call)
        return calls or None
    if not stripped.startswith(("{", "[")):
        return None
    try:
        val = json.loads(stripped)
    except ValueError:
        return None
    vals = val if isinstance(val, list) else [val]
    calls = []
    for v in vals:
        call = _normalize_call(v, known)
        if call is None:
            return None
        calls.append(call)
    return calls or None


def tool_call_objects(calls: Sequence[Dict[str, str]]) -> List[Dict[str, Any]]:
    """-> OpenAI response shape with generated call ids."""
    return [
        {
            "id": "call_{}".format(uuid.uuid4().hex[:24]),
            "type": "function",
            "function": {"name": c["name"], "arguments": c["arguments"]},
        }
        for c in calls
    ]


def tools_preamble(tools: Sequence[Dict[str, Any]]) -> str:
    """System-message fallback for chat templates without native ``tools=``
    support; instructs the bare-JSON format parse_tool_calls accepts."""
    specs = json.dumps(
        [
            {"type": "function", "function": t}
            for t in tools
        ],
        indent=2,
    )
    return (
        "You have access to the following functions. To call a function, "
        'respond ONLY with a JSON object of the form {"name": '
        '"<function-name>", "arguments": <json-arguments-object>} and no '
        "other text.\n\nAvailable functions:\n" + specs
    )


def messages_with_tool_results(messages: List[dict]) -> List[dict]:
    """Rewrite message shapes a non-tool-aware chat template would drop:
    role 'tool' results and assistant tool_calls become textual content so
    every template renders the full call/result history."""
    out = []
    for m in messages:
        role = m.get("role")
        if role == "tool":
            out.append(
                {
                    "role": "user",
                    "content": "[tool result for {}]\n{}".format(
                        m.get("tool_call_id", "call"), m.get("content", "")
                    ),
                }
            )
        elif role == "assistant" and m.get("tool_calls") and not m.get("content"):
            calls = [
                {
                    "name": (c.get("function") or {}).get("name"),
                    "arguments": (c.get("function") or {}).get("arguments"),
                }
                for c in m["tool_calls"]
            ]
            out.append({"role": "assistant", "content": json.dumps(calls)})
        else:
            out.append(m)
    return out


def render_chat_with_tools(
    tokenizer, messages: List[dict], tools: Sequence[Dict[str, Any]]
) -> str:
    """Render the prompt so the model SEES the tool definitions: the HF
    template's native ``tools=`` path when it actually consumes them
    (probed by checking the rendered text mentions the tool names),
    otherwise a system preamble + normalized messages."""
    if tools:
        hf_tools = [{"type": "function", "function": t} for t in tools]
        # whether the template consumes `tools=` is a per-tokenizer
        # constant: probe once (two renders), then cache — long histories
        # shouldn't pay a double Jinja render on every request
        native = getattr(tokenizer, "_tools_template_native", None)
        if native is None or native:
            try:
                text = tokenizer.apply_chat_template(messages, tools=hf_tools)
            except Exception:
                text = None
            if native:
                return text if text is not None else tokenizer.apply_chat_template(
                    [{"role": "system", "content": tools_preamble(tools)}]
                    + messages_with_tool_results(messages)
                )
            # first probe: identical renders = the template has no `tools`
            # variable and dropped them silently
            try:
                base = tokenizer.apply_chat_template(messages)
            except Exception:
                base = text = None
            native = text is not None and text != base
            try:
                tokenizer._tools_template_native = native
            except Exception:
                pass
            if native:
                return text
        msgs = [{"role": "system", "content": tools_preamble(tools)}]
        msgs.extend(messages_with_tool_results(messages))
        return tokenizer.apply_chat_template(msgs)
    # no tools in the request: pass messages through untouched — chat
    # templates that natively render `tool` turns (Hermes/Qwen/Llama-3.1)
    # must see the real role structure, not the textual rewrite (which is
    # only for the preamble fallback path)
    return tokenizer.apply_chat_template(messages)
