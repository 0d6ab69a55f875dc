"""OpenAI-compatible chat route over the port's engine.

Counterpart of ``clearml_serving_tpu/llm/openai_api.py``'s
``LLMEngineRequest`` for this slice: the engine is built from the same aux
``engine`` block (``preset``, ``config``, ``cache``, ``kv_quant``,
``max_batch``, ``max_seq_len``, ``decode_steps``, ``page_size``,
``num_pages``, ``prefill_buckets``, ``pipeline_depth``, ``scheduler``,
``seed``), and ``chat/completions`` (``n=1``, streaming or not,
``max_tokens``, ``temperature``/``top_p``/``top_k``, ``stop`` strings) and
``models`` answer with the reference's response shapes. Text handling
(stop-string trimming, streamed deltas, finish reasons) follows the
reference line by line so that greedy content is byte-identical.

Every other aux key and request field is refused with a ``ValueError``
naming it; the router maps that to a 422.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, AsyncIterator, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.llama import Llama, init_params, resolve_config
from .engine import GenRequest, LLMEngineCore
from .tokenizer import ByteTokenizer

ENGINE_KEYS = (
    "preset", "arch", "config", "cache", "kv_quant", "max_batch", "max_seq_len",
    "decode_steps", "page_size", "num_pages", "prefill_buckets",
    "pipeline_depth", "scheduler", "seed",
)

CHAT_FIELDS = (
    "model", "messages", "max_tokens", "max_completion_tokens", "temperature",
    "top_p", "top_k", "stop", "stream", "n",
)


def _now() -> int:
    return int(time.time())


def _gen_id(prefix: str) -> str:
    return "{}-{}".format(prefix, uuid.uuid4().hex[:24])


def build_engine(engine_cfg: Dict[str, Any], *, device="cuda",
                 params: Optional[Dict[str, Any]] = None):
    """(engine, tokenizer) from an aux ``engine`` block. Weights are random,
    made on ``device`` from ``seed`` (the weightless preset mode), unless
    ``params`` (``init_params``/``convert_params`` output) is given."""
    unknown = sorted(k for k in engine_cfg if k not in ENGINE_KEYS)
    if unknown:
        raise ValueError(
            "aux engine keys {} are not supported by the PyTorch port yet".format(unknown)
        )
    if engine_cfg.get("arch", "llama") != "llama":
        raise ValueError("aux engine.arch {!r} is not supported by the PyTorch port "
                         "yet".format(engine_cfg["arch"]))
    if not engine_cfg.get("preset"):
        raise ValueError("the PyTorch port serves aux engine.preset models only "
                         "(bundle loading arrives with a later slice)")
    dev = resolve_device(device)
    cfg = resolve_config({"preset": engine_cfg["preset"], **(engine_cfg.get("config") or {})})
    if engine_cfg.get("kv_quant"):
        cfg["kv_quant"] = str(engine_cfg["kv_quant"])
    if params is None:
        gen = torch.Generator(dev)
        gen.manual_seed(int(engine_cfg.get("seed", 0)))
        params = init_params(cfg, gen, device=dev)
    model = Llama(cfg, params)
    tokenizer = ByteTokenizer(vocab_size=max(int(cfg["vocab_size"]), 259))
    cache = engine_cfg.get("cache", "dense")
    engine = LLMEngineCore(
        model,
        max_batch=int(engine_cfg.get("max_batch", 8)),
        max_seq_len=int(engine_cfg.get("max_seq_len", cfg.get("max_seq_len", 2048))),
        prefill_buckets=engine_cfg.get("prefill_buckets"),
        eos_token_id=tokenizer.eos_token_id,
        rng_seed=int(engine_cfg.get("seed", 0)),
        decode_steps=int(engine_cfg.get("decode_steps", 4)),
        cache_mode=cache,
        # int8 paged pools default to 32-token pages, as in the reference
        page_size=int(
            engine_cfg.get("page_size")
            or (32 if engine_cfg.get("kv_quant") and cache == "paged" else 16)
        ),
        num_pages=int(engine_cfg["num_pages"]) if engine_cfg.get("num_pages") else None,
        pipeline_depth=(
            int(engine_cfg["pipeline_depth"]) if engine_cfg.get("pipeline_depth") else None
        ),
        scheduler=engine_cfg.get("scheduler"),
    )
    return engine, tokenizer


class LLMEngineRequest:
    """One engine per served model: the chat and models routes."""

    def __init__(self, engine: LLMEngineCore, tokenizer, model_name: str = "model"):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name

    # -- request parsing -----------------------------------------------------

    def _gen_request_from_body(self, body: Dict[str, Any], prompt_ids: List[int]) -> GenRequest:
        unknown = sorted(k for k, v in body.items() if k not in CHAT_FIELDS and v is not None)
        if unknown:
            raise ValueError(
                "request fields {} are not supported by the PyTorch port yet".format(unknown)
            )
        if int(body.get("n", 1) or 1) != 1:
            raise ValueError("n != 1 is not supported by the PyTorch port yet")
        return GenRequest(
            prompt_ids=prompt_ids,
            max_new_tokens=int(body.get("max_tokens") or body.get("max_completion_tokens") or 128),
            temperature=float(body.get("temperature", 0.0) or 0.0),
            top_k=int(body.get("top_k", 0) or 0),
            top_p=float(body.get("top_p", 1.0) or 1.0),
        )

    @staticmethod
    def _stops_from_body(body: Dict[str, Any]) -> List[str]:
        """OpenAI ``stop``: str | [str], matched on the decoded text."""
        stop = body.get("stop")
        if stop is None:
            return []
        if isinstance(stop, str):
            return [stop] if stop else []
        return [str(s) for s in stop if s]

    @staticmethod
    def _first_stop_hit(text: str, stops: List[str]) -> int:
        """Earliest index where any stop string occurs, or -1."""
        hits = [h for h in (text.find(s) for s in stops) if h >= 0]
        return min(hits) if hits else -1

    def _tokens_covering(self, ids: List[int], n_chars: int) -> int:
        """Smallest token count whose decoded prefix covers n_chars."""
        j = len(ids)
        while j > 0 and len(self.tokenizer.decode(ids[: j - 1])) >= n_chars:
            j -= 1
        return j

    def _finish_reason(self, request: GenRequest) -> str:
        """"length" covers max_tokens truncation and the context limit."""
        if request.stopped_on_string:
            return "stop"
        if request.produced >= request.max_new_tokens:
            return "length"
        if request.prompt_len + request.produced >= self.engine.max_seq_len:
            return "length"
        return "stop"

    # -- text out ------------------------------------------------------------

    async def _collect_text(self, request: GenRequest, stops: List[str]) -> Dict[str, Any]:
        ids: List[int] = []
        # stop scanning decodes a tail window per token; the full decode
        # happens once, on a hit or at the end
        window = (max(len(s) for s in stops) + 8) if stops else 0
        async for token in self.engine.generate(request):
            ids.append(token)
            if stops:
                tail = self.tokenizer.decode(ids[-window:])
                if self._first_stop_hit(tail, stops) >= 0:
                    request.stopped_on_string = True
                    request.cancel()
                    text = self.tokenizer.decode(ids)
                    cut = self._first_stop_hit(text, stops)
                    if cut >= 0:
                        ids = ids[: self._tokens_covering(ids, cut)]
                        request.produced = len(ids)
                        text = text[:cut]
                    return {"text": text, "ids": ids, "finish_reason": "stop"}
        eos = self.tokenizer.eos_token_id
        if ids and eos is not None and ids[-1] == eos:
            ids = ids[:-1]
            finish = "stop"
        else:
            finish = self._finish_reason(request)
        return {"text": self.tokenizer.decode(ids), "ids": ids, "finish_reason": finish}

    async def _stream_deltas(self, request: GenRequest, stops: List[str]) -> AsyncIterator[str]:
        """Text deltas; stop strings hold back a potential stop-prefix tail
        so a matched stop is never partially emitted."""
        ids: List[int] = []
        sent = ""
        holdback = max((len(s) for s in stops), default=1) - 1
        eos = self.tokenizer.eos_token_id
        async for token in self.engine.generate(request):
            if eos is not None and token == eos:
                break
            ids.append(token)
            text = self.tokenizer.decode(ids)
            if text.endswith("�"):  # partial multi-byte sequence
                continue
            if stops:
                cut = self._first_stop_hit(text, stops)
                if cut >= 0:
                    request.stopped_on_string = True
                    request.cancel()
                    j = self._tokens_covering(ids, cut)
                    del ids[j:]
                    request.produced = j
                    if cut > len(sent):
                        yield text[len(sent):cut]
                    return
                text = text[: len(text) - holdback] if holdback else text
            if len(text) > len(sent):
                prev = len(sent)
                sent = text
                yield text[prev:]
        # flush the held-back tail (and a final legitimate replacement char)
        text = self.tokenizer.decode(ids)
        if stops:
            cut = self._first_stop_hit(text, stops)
            if cut >= 0:
                request.stopped_on_string = True
                text = text[:cut]
                j = self._tokens_covering(ids, cut)
                del ids[j:]
                request.produced = j
        if len(text) > len(sent):
            yield text[len(sent):]

    # -- routes --------------------------------------------------------------

    async def v1_chat_completions(self, body: Dict[str, Any]):
        """A response dict, or an async iterator of SSE lines when
        ``stream`` is set (validated before the first line)."""
        messages = body.get("messages") or []
        prompt = self.tokenizer.apply_chat_template(messages)
        prompt_ids = self.tokenizer.encode_chat(prompt)
        stops = self._stops_from_body(body)
        model = body.get("model", self.model_name)
        completion_id = _gen_id("chatcmpl")
        created = _now()
        request = self._gen_request_from_body(body, prompt_ids)
        self.engine.validate(request)

        def chat_chunk(choice) -> str:
            chunk = {
                "id": completion_id, "object": "chat.completion.chunk",
                "created": created, "model": model, "choices": [choice],
            }
            return "data: {}\n\n".format(json.dumps(chunk))

        if body.get("stream"):
            async def sse():
                try:
                    yield chat_chunk({"index": 0, "delta": {"role": "assistant"},
                                      "finish_reason": None})
                    try:
                        async for delta in self._stream_deltas(request, stops):
                            yield chat_chunk({"index": 0, "delta": {"content": delta},
                                              "finish_reason": None})
                    except Exception as ex:
                        yield "data: {}\n\n".format(json.dumps(
                            {"error": {"message": str(ex), "type": type(ex).__name__}}
                        ))
                        yield "data: [DONE]\n\n"
                        return
                    yield chat_chunk({"index": 0, "delta": {},
                                      "finish_reason": self._finish_reason(request)})
                    yield "data: [DONE]\n\n"
                finally:
                    # normal end and client disconnect alike: free the slot
                    request.cancel()

            return sse()

        res = await self._collect_text(request, stops)
        return {
            "id": completion_id,
            "object": "chat.completion",
            "created": created,
            "model": model,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": res["text"]},
                "finish_reason": res["finish_reason"],
                "logprobs": None,
            }],
            "usage": {
                "prompt_tokens": request.prompt_len,
                "completion_tokens": request.produced,
                "total_tokens": request.prompt_len + request.produced,
            },
        }

    async def v1_models(self, body: Dict[str, Any]) -> Dict[str, Any]:
        return {"object": "list", "data": [{
            "id": self.model_name, "object": "model", "created": _now(),
            "owned_by": "tpu-serving",
        }]}
