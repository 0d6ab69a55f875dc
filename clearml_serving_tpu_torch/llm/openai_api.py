"""OpenAI-compatible chat route over the port's engine.

Counterpart of ``clearml_serving_tpu/llm/openai_api.py``'s
``LLMEngineRequest`` for this slice: the engine is built from the same aux
``engine`` block (``preset``, ``config``, ``cache``, ``kv_quant``,
``max_batch``, ``max_seq_len``, ``decode_steps``, ``page_size``,
``num_pages``, ``prefill_buckets``, ``pipeline_depth``, ``scheduler``,
``step_token_budget``, ``ragged_decode_steps``, ``speculation``,
``spec_k``, ``spec_ngram``, ``spec_sampling``, ``spec_tree``,
``spec_branch``, ``weight_quant`` and its legacy alias ``quantize``,
``seed``; the prefix cache's ``prefix_cache``, ``prefix_block``,
``prefix_cache_mb`` and ``prefix_cache_pages``, and its host-RAM tier's
``prefix_cache_host_pages`` and ``prefix_cache_host_mb`` (a size in MiB,
or ``"auto"``: half of the host's available memory); ``warmup``, which ``warmup_mode`` reads for the endpoint; the
request lifecycle's ``max_pending``, ``queue_timeout``, ``ttft_timeout``,
``timeout``, ``watchdog_interval``, ``preemption``, ``preempt_budget``,
``starvation_floor``, ``brownout``, ``brownout_batch_cap``,
``brownout_dwell`` and ``default_priority``, ON by default as in the
reference: ``max_pending = max(16, 4 * max_batch)``, a 30 s watchdog,
preemption, and brownout with the bound), and ``chat/completions`` (``n=1``,
streaming or not, ``max_tokens``, ``temperature``/``top_p``/``top_k``,
``stop`` strings, ``priority``, ``timeout``, ``queue_timeout``,
``ttft_timeout``) and ``models`` answer with the reference's response
shapes. Admission is checked before a stream's headers, so a shed or a
spent budget is a 429 or 408, never a mid-stream error. Text handling
(stop-string trimming, streamed deltas, finish reasons) follows the
reference line by line so that greedy content is byte-identical.

Every other aux key and request field is refused with a ``ValueError``
naming it; the router maps that to a 422.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid
from typing import Any, AsyncIterator, Dict, List, Optional

import torch

from ..device import resolve_device
from ..models.llama import Llama, init_params, resolve_config
from ..ops.quant import detect_weight_quant, quantize_llama_params
from .engine import PRIORITY_CLASSES, GenRequest, LLMEngineCore
from .tokenizer import ByteTokenizer

ENGINE_KEYS = (
    "preset", "arch", "config", "cache", "kv_quant", "max_batch", "max_seq_len",
    "decode_steps", "page_size", "num_pages", "prefill_buckets",
    "pipeline_depth", "scheduler", "step_token_budget", "ragged_decode_steps",
    "speculation", "spec_k", "spec_ngram", "spec_sampling", "spec_tree", "spec_branch",
    "weight_quant", "quantize", "seed", "warmup",
    "max_pending", "queue_timeout", "ttft_timeout", "timeout", "watchdog_interval",
    "preemption", "preempt_budget", "starvation_floor", "brownout",
    "brownout_batch_cap", "brownout_dwell", "default_priority",
    "prefix_cache", "prefix_block", "prefix_cache_mb", "prefix_cache_pages",
    "prefix_cache_host_pages", "prefix_cache_host_mb",
)

CHAT_FIELDS = (
    "model", "messages", "max_tokens", "max_completion_tokens", "temperature",
    "top_p", "top_k", "stop", "stream", "n",
    "priority", "timeout", "queue_timeout", "ttft_timeout",
)


def _now() -> int:
    return int(time.time())


def _gen_id(prefix: str) -> str:
    return "{}-{}".format(prefix, uuid.uuid4().hex[:24])


def warmup_mode(engine_cfg: Dict[str, Any]) -> str:
    """The aux ``engine.warmup`` knob as the reference reads it: "off"
    (the default) or "startup" (``llm/warmup.py``); a typo raises naming
    the knob. The reference's "full" adds the compiled ragged launch
    variants, which the port does not have yet, so it raises too."""
    mode = str(engine_cfg.get("warmup", "off")).lower()
    if mode in ("1", "true", "on"):
        mode = "startup"
    if mode in ("0", "false"):
        mode = "off"
    if mode not in ("off", "startup", "full"):
        raise ValueError("aux engine.warmup must be off/startup/full: got {!r}".format(
            engine_cfg.get("warmup")))
    if mode == "full":
        raise ValueError("aux engine.warmup 'full' is not supported by the PyTorch port yet "
                         "(its ragged launch variants are not ported): use 'startup'")
    return mode


def default_priority(engine_cfg: Dict[str, Any]) -> str:
    """The aux ``engine.default_priority`` knob: the class of requests
    whose body names none. A typo raises at endpoint load, not at every
    request that omits ``priority``."""
    cls = str(engine_cfg.get("default_priority", "interactive"))
    if cls not in PRIORITY_CLASSES:
        raise ValueError("aux engine.default_priority must be one of {}: got {!r}".format(
            "/".join(PRIORITY_CLASSES), cls))
    return cls


def _lifecycle_knob(engine_cfg: Dict[str, Any], key: str, default):
    """A lifecycle knob of the aux block: absent -> ``default``, 0/false
    -> off (None), else its float."""
    if key not in engine_cfg:
        return default
    value = engine_cfg[key]
    return float(value) if value else None


def build_engine(engine_cfg: Dict[str, Any], *, device="cuda",
                 params: Optional[Dict[str, Any]] = None, cuda_graphs: bool = True):
    """(engine, tokenizer) from an aux ``engine`` block. Weights are random,
    made on ``device`` from ``seed`` (the weightless preset mode), unless
    ``params`` (``init_params``/``convert_params`` output, full precision or
    already quantized) is given. ``weight_quant`` (or ``quantize``)
    quantizes full-precision weights before the model is built; on an
    already-packed tree it must name the tree's format. ``cuda_graphs=False``
    builds the eager arm (``LLMEngineCore``'s argument; no aux key sets
    it)."""
    unknown = sorted(k for k in engine_cfg if k not in ENGINE_KEYS)
    if unknown:
        raise ValueError(
            "aux engine keys {} are not supported by the PyTorch port yet".format(unknown)
        )
    warmup_mode(engine_cfg)  # typo'd knobs fail at load
    default_priority(engine_cfg)
    if engine_cfg.get("arch", "llama") != "llama":
        raise ValueError("aux engine.arch {!r} is not supported by the PyTorch port "
                         "yet".format(engine_cfg["arch"]))
    if not engine_cfg.get("preset"):
        raise ValueError("the PyTorch port serves aux engine.preset models only "
                         "(bundle loading arrives with a later slice)")
    # weight quantization, validated before any weight is made, with the
    # reference's load-time checks and words
    weight_quant = engine_cfg.get("weight_quant", engine_cfg.get("quantize"))
    legacy = engine_cfg.get("quantize")
    if engine_cfg.get("weight_quant") and legacy and engine_cfg["weight_quant"] != legacy:
        raise ValueError(
            "aux engine.weight_quant={!r} conflicts with the legacy "
            "engine.quantize={!r} alias; set only one".format(
                engine_cfg["weight_quant"], legacy
            )
        )
    if weight_quant in ("", None):
        weight_quant = None
    elif str(weight_quant) not in ("int8", "int4"):
        raise ValueError(
            "aux engine.weight_quant must be 'int8' or 'int4': got "
            "{!r}".format(weight_quant)
        )
    dev = resolve_device(device)
    cfg = resolve_config({"preset": engine_cfg["preset"], **(engine_cfg.get("config") or {})})
    if engine_cfg.get("kv_quant"):
        cfg["kv_quant"] = str(engine_cfg["kv_quant"])
    if params is None:
        gen = torch.Generator(dev)
        gen.manual_seed(int(engine_cfg.get("seed", 0)))
        params = init_params(cfg, gen, device=dev)
    if weight_quant and not detect_weight_quant(params):
        params = quantize_llama_params(params, bits=4 if weight_quant == "int4" else 8)
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
        # ragged token-budget scheduler: chunked prefill and decode rows in
        # one launch per step, paced by step_token_budget; decode rows carry
        # up to ragged_decode_steps chained tokens (unset: decode_steps)
        scheduler=engine_cfg.get("scheduler"),
        step_token_budget=(
            int(engine_cfg["step_token_budget"])
            if engine_cfg.get("step_token_budget") else None
        ),
        ragged_decode_steps=(
            int(engine_cfg["ragged_decode_steps"])
            if engine_cfg.get("ragged_decode_steps") else None
        ),
        # speculative verify rows on the ragged launches: n-gram drafts,
        # chained or (spec_tree) branched over up to spec_branch root
        # continuations; the engine validates the values
        speculation=engine_cfg.get("speculation"),
        spec_k=int(engine_cfg.get("spec_k", 4)),
        spec_ngram=int(engine_cfg.get("spec_ngram", 2)),
        spec_sampling=bool(engine_cfg.get("spec_sampling", True)),
        spec_tree=bool(engine_cfg.get("spec_tree", False)),
        spec_branch=int(engine_cfg.get("spec_branch", 2)),
        # the engine holds the model to the knob (a packed tree of another
        # format raises, naming the tree's format)
        weight_quant=weight_quant,
        cuda_graphs=cuda_graphs,
        # the request lifecycle, on by default at the serving front as in
        # the reference: bounded admission and a stall watchdog; 0/false
        # disables a knob
        max_pending=_lifecycle_knob(engine_cfg, "max_pending",
                                    max(16, 4 * int(engine_cfg.get("max_batch", 8)))),
        queue_timeout=_lifecycle_knob(engine_cfg, "queue_timeout", None),
        ttft_timeout=_lifecycle_knob(engine_cfg, "ttft_timeout", None),
        total_timeout=_lifecycle_knob(engine_cfg, "timeout", None),
        watchdog_interval=_lifecycle_knob(engine_cfg, "watchdog_interval", 30.0),
        # SLO scheduling: the preemptible batch lane and the brownout
        # controller (None: on with the admission bound)
        preempt_batch=bool(engine_cfg.get("preemption", True)),
        preempt_budget=int(engine_cfg.get("preempt_budget", 2)),
        starvation_floor=int(engine_cfg.get("starvation_floor", 8)),
        brownout=bool(engine_cfg["brownout"]) if "brownout" in engine_cfg else None,
        brownout_batch_cap=int(engine_cfg.get("brownout_batch_cap", 32)),
        brownout_dwell=float(engine_cfg.get("brownout_dwell", 2.0)),
        # automatic prefix caching over shared, refcounted pages
        prefix_cache=engine_cfg.get("prefix_cache"),
        prefix_block=int(engine_cfg.get("prefix_block", 64)),
        prefix_cache_bytes=(
            int(float(engine_cfg["prefix_cache_mb"]) * (1 << 20))
            if engine_cfg.get("prefix_cache_mb") else None
        ),
        prefix_cache_pages=(
            int(engine_cfg["prefix_cache_pages"])
            if engine_cfg.get("prefix_cache_pages") else None
        ),
        # the host-RAM tier behind the prefix cache: preallocated host pages
        # (0/unset: none), or a budget in MiB; "auto" sizes it from
        # /proc/meminfo when the engine is built
        prefix_cache_host_pages=(
            int(engine_cfg["prefix_cache_host_pages"])
            if engine_cfg.get("prefix_cache_host_pages") else None
        ),
        prefix_cache_host_bytes=(
            "auto"
            if str(engine_cfg.get("prefix_cache_host_mb", "")).strip().lower() == "auto"
            else int(float(engine_cfg["prefix_cache_host_mb"]) * (1 << 20))
            if engine_cfg.get("prefix_cache_host_mb") else None
        ),
    )
    return engine, tokenizer


class LLMEngineRequest:
    """One engine per served model: the chat and models routes. With
    ``warmup`` other than "off" (``warmup_mode``), the first requests wait
    for the engine's warmup sweep. ``default_priority`` (the aux knob, read
    by ``default_priority``) is the class of requests whose body names
    none."""

    def __init__(self, engine: LLMEngineCore, tokenizer, model_name: str = "model",
                 warmup: str = "off", default_priority: str = "interactive"):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self._default_priority = default_priority
        self._warmup_needed = warmup != "off"
        self._warmup_task = None

    async def _ensure_warm(self) -> None:
        """First arrivals share one warmup task and wait for it; afterwards
        this is one attribute read. A failed warmup is logged and not
        retried: a decode-graph variant it left uncaptured is captured at
        its first use, and a capture that fails there fails its step."""
        if not self._warmup_needed:
            return
        if self._warmup_task is None:
            self._warmup_task = asyncio.ensure_future(self.engine.warmup())
        try:
            await asyncio.shield(self._warmup_task)
        except Exception as ex:
            logging.getLogger(__name__).warning("engine warmup failed: %s", ex,
                                                exc_info=True)
        self._warmup_needed = False

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
            # lifecycle budgets in seconds (the engine's defaults apply
            # when absent); ``timeout`` bounds the whole request
            total_timeout=float(body["timeout"]) if body.get("timeout") is not None else None,
            queue_timeout=(float(body["queue_timeout"])
                           if body.get("queue_timeout") is not None else None),
            ttft_timeout=(float(body["ttft_timeout"])
                          if body.get("ttft_timeout") is not None else None),
            # the body's class wins, else the endpoint's default; the
            # engine's validate() refuses an unknown one
            priority=str(body.get("priority") or self._default_priority),
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
        # before a stream's headers: a refusal, a shed or a spent budget is
        # a status line (422, 429, 408), not a mid-stream error
        self.engine.validate(request)
        self.engine.check_admission(request)
        await self._ensure_warm()

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
