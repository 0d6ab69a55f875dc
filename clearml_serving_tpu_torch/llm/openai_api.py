"""OpenAI-compatible LLM engine endpoint (the ``llm`` engine type).

Counterpart of ``clearml_serving_tpu/llm/openai_api.py``'s
``LLMEngineRequest``: a ``BaseEngineRequest`` registered as ``llm``, which
the processor builds per endpoint (``serving/model_request_processor.py``)
and the router dispatches to by serve type
(``/serve/openai/v1/chat/completions`` -> ``v1_chat_completions``; a plain
``POST /serve/<endpoint>`` is a non-streaming chat completion). The engine
is built on the processor's device from the endpoint's aux ``engine``
block (``preset``, ``config``, ``cache``, ``kv_quant``, ``max_batch``,
``max_seq_len``, ``decode_steps``, ``page_size``, ``num_pages``, ``prefill_buckets``, ``pipeline_depth``, ``scheduler``,
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
preemption, and brownout with the bound; ``logprobs_k``, the logprob top-k ceiling, 20;
the fleet's ``replicas``, ``replica_roles``, ``router_affinity_blocks``,
``router_spill_queue_depth``, ``router_spill_stage``, ``router_fleet_shed_stage``,
``kv_transport_pages``, ``replica_backend`` and ``kv_transport_backend``:
``fleet_config``), and the aux ``chat`` block (its ``response_role``) sits
beside them. With ``replicas`` > 1 the endpoint serves a ``ReplicaGroup``
(``llm/replica.py``), and its metrics carry each replica's label.
Weights are random, made from ``seed`` (the reference's preset mode), or
read from the endpoint's model bundle (``load_bundle_engine``: a ``llama``
bundle's ``params.msgpack``, its stored config, and its tokenizer files when
``transformers`` can read them). The routes answer with the
reference's response shapes, and report the reference's per-request stats
(``gen_tokens``, ``prompt_tokens``, ``ttft``) through ``collect_fn``; a
stream reports when it ends (``StreamingOutput.on_complete``):

- ``chat/completions``: ``n`` choices (seed + i per choice), streaming or
  not (``stream_options.include_usage``), ``max_tokens``,
  ``temperature``/``top_p``/``top_k``, ``stop`` strings, the penalties
  (``presence_penalty``, ``frequency_penalty``, ``repetition_penalty``),
  ``logit_bias``, ``seed``, ``min_tokens``, ``logprobs`` + ``top_logprobs``,
  ``prompt_logprobs``, ``return_tokens_as_token_ids``, ``response_role``,
  ``priority``, ``timeout``, ``queue_timeout``, ``ttft_timeout``; guided
  decoding (``response_format`` ``json_object``/``json_schema``, vLLM's
  ``guided_regex``, ``guided_json`` and ``guided_choice``: the engine masks
  every token by the compiled grammar, ``llm/guided.py``) and tools
  (``tools``, ``tool_choice`` none/auto/required/forced,
  ``parallel_tool_calls``; ``llm/tools.py``): required and forced compile
  the tool-call JSON into the grammar, auto parses the finished text (and
  holds back a possible call while streaming), and a parsed call answers
  with ``tool_calls`` and ``finish_reason: "tool_calls"``;
- ``completions``: the same sampling and guided fields, the polymorphic ``prompt``
  (text, texts, token ids, lists of token ids), ``logprobs`` as a count,
  ``echo``, ``best_of`` (ranked by cumulative logprob), and ``max_tokens:
  0`` (prompt scoring: ``echo`` + ``logprobs`` through the engine's
  ``score_prompt``); ``suffix`` is refused;
- ``tokenize``, ``detokenize``, ``models`` and ``version``;
- on an encoder endpoint (``engine_task``: an encoder bundle such as
  ``bert``, or ``engine.arch: bert`` with a preset, or ``engine.task``
  naming an encoder task) the generating routes answer 422 as the
  reference's do, and ``embeddings`` (``encoding_format``,
  ``dimensions``), ``pooling``, ``classify`` (aux ``engine.labels``),
  ``score`` and ``rerank`` run on ``llm/encoder.py``'s ``EncoderCore``
  (aux ``pooling``, ``normalize``, ``seq_buckets``, ``batch_buckets``; the
  generation knobs, ``replicas`` among them, are ignored there, as the
  reference ignores them); a plain POST is an embeddings call. Their body
  fields are read as the reference reads them, unknown ones ignored;
- on an audio endpoint (``engine_task``: a ``whisper`` bundle, or
  ``engine.arch: whisper`` with a preset, or ``engine.task`` naming
  ``transcribe``, ``translate`` or ``audio``) ``audio/transcriptions`` and
  ``audio/translations`` run on ``llm/audio.py``'s ``AudioCore`` (aux
  ``decode_steps``, 16 by default, and ``max_tokens``): the WAV as a
  multipart upload or base64 in JSON, ``response_format`` ``json``,
  ``text`` or ``verbose_json`` (timestamp-conditioned segments, and with
  ``timestamp_granularities`` ``word`` the cross-attention DTW's words, or
  the logged proportional fallback when that pass fails); the generating
  routes answer 422 there as the reference's do.

Admission is checked before a stream's headers, so a shed or a spent
budget is a 429 or 408, never a mid-stream error. Text handling
(stop-string trimming, streamed deltas, logprob entries, finish reasons)
follows the reference line by line so that content is byte-identical.

Every aux key and request field the port does not know is refused by
name. The router maps a ``ValueError`` to a 422: a malformed grammar or
schema is one, before any stream header.
"""

from __future__ import annotations

import asyncio
import gc
import json
import logging
import time
import uuid
import weakref
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

import torch

from ..device import CAPTURE_LOCK, replica_stream, resolve_device
from ..engines.base import BaseEngineRequest, EndpointModelError, register_engine
from ..models.llama import Llama, init_params, paged_unsupported_reason, resolve_config
from ..ops.quant import detect_weight_quant, quantize_llama_params
from ..serving.endpoints import ModelEndpoint
from ..serving.responses import StreamingOutput
from ..version import __version__
from .engine import PRIORITY_CLASSES, GenRequest, LLMEngineCore
from .guided import GuidedSpec, _regex_escape_literal
from .tokenizer import ByteTokenizer, load_tokenizer, token_repr, token_str
from .tools import (
    TOOL_TAG,
    parse_tool_calls,
    render_chat_with_tools,
    resolve_tool_choice,
    split_tag_holdback,
    strip_tool_blocks,
    tool_call_objects,
    tool_call_schema,
    validate_tools,
)

ENGINE_KEYS = (
    "preset", "arch", "config", "cache", "kv_quant", "max_batch", "max_seq_len",
    "decode_steps", "page_size", "num_pages", "prefill_buckets",
    "pipeline_depth", "scheduler", "step_token_budget", "ragged_decode_steps",
    "chunked_prefill", "prefill_segments_per_decode", "prefill_stall_timeout",
    "speculation", "spec_k", "spec_ngram", "spec_sampling", "spec_tree", "spec_branch",
    "weight_quant", "quantize", "seed", "warmup",
    "max_pending", "queue_timeout", "ttft_timeout", "timeout", "watchdog_interval",
    "preemption", "preempt_budget", "starvation_floor", "brownout",
    "brownout_batch_cap", "brownout_dwell", "default_priority",
    "prefix_cache", "prefix_block", "prefix_cache_mb", "prefix_cache_pages",
    "prefix_cache_host_pages", "prefix_cache_host_mb", "logprobs_k",
    # the replica fleet (llm/replica.py, serving/replica_router.py)
    "replicas", "replica_roles", "replica_backend", "router_affinity_blocks",
    "router_spill_queue_depth", "router_spill_stage", "router_fleet_shed_stage",
    "kv_transport_pages", "kv_transport_backend",
    # the encoder tasks (llm/encoder.py)
    "task", "pooling", "normalize", "seq_buckets", "batch_buckets", "labels",
    # the audio tasks (llm/audio.py)
    "max_tokens",
)

# the reference's task names: an encoder endpoint serves the embeddings,
# pooling, classify, score and rerank routes
ENCODER_TASKS = frozenset({"embed", "embedding", "pooling", "classify", "classification",
                           "score", "rerank"})
AUDIO_TASKS = frozenset({"transcribe", "translate", "audio"})

# the body fields of both generating routes
_SAMPLING_FIELDS = (
    "model", "max_tokens", "max_completion_tokens", "temperature", "top_p", "top_k", "stop",
    "stream", "stream_options", "n", "seed", "presence_penalty", "frequency_penalty",
    "repetition_penalty", "logit_bias", "min_tokens", "logprobs", "prompt_logprobs",
    "return_tokens_as_token_ids", "priority", "timeout", "queue_timeout", "ttft_timeout",
    "response_format", "guided_choice", "guided_regex", "guided_json",
)
CHAT_FIELDS = _SAMPLING_FIELDS + ("messages", "top_logprobs", "response_role", "tools",
                                  "tool_choice", "parallel_tool_calls")
COMPLETION_FIELDS = _SAMPLING_FIELDS + ("prompt", "echo", "best_of", "suffix")


def _now() -> int:
    return int(time.time())


def _gen_id(prefix: str) -> str:
    return "{}-{}".format(prefix, uuid.uuid4().hex[:24])


def warmup_mode(engine_cfg: Dict[str, Any]) -> str:
    """The aux ``engine.warmup`` knob as the reference reads it: "off"
    (the default), "startup" or "full" (``llm/warmup.py``: the full sweep
    captures every plain ragged launch key as well); a typo raises naming
    the knob."""
    mode = str(engine_cfg.get("warmup", "off")).lower()
    if mode in ("1", "true", "on"):
        mode = "startup"
    if mode in ("0", "false"):
        mode = "off"
    if mode not in ("off", "startup", "full"):
        raise ValueError("aux engine.warmup must be off/startup/full: got {!r}".format(
            engine_cfg.get("warmup")))
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


def fleet_config(engine_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The aux fleet knobs, validated at endpoint load as the reference
    validates them: ``replicas`` (1..16), ``replica_roles`` (a list or a
    comma string of prefill/decode/hybrid, with ``replicas`` >= 2),
    ``replica_backend`` (inprocess: N engines in this process; process:
    supervised worker processes, ``serving/process_replica.py``, which
    needs ``replicas`` >= 2) and ``kv_transport_backend`` (shared: in-heap
    slab mailboxes; socket: ``llm/kv_wire.py``; a process fleet's workers
    always ship over sockets). Returns the ``ReplicaGroup`` arguments with
    ``replicas`` and ``replica_backend``."""
    raw = engine_cfg.get("replicas")
    if raw is None:
        n = 1
    else:
        try:
            n = int(raw)
            if float(raw) != n:  # 2.5 must not truncate
                raise ValueError(raw)
        except (TypeError, ValueError):
            raise ValueError("aux engine.replicas must be an integer >= 1: got {!r}".format(raw))
    if not 1 <= n <= 16:
        raise ValueError("aux engine.replicas must be in 1..16: got {}".format(n))
    raw_roles = engine_cfg.get("replica_roles")
    roles = None
    if raw_roles is not None:
        if isinstance(raw_roles, str):
            roles = [r.strip().lower() for r in raw_roles.split(",") if r.strip()]
        elif isinstance(raw_roles, (list, tuple)):
            roles = [str(r).strip().lower() for r in raw_roles]
        else:
            raise ValueError(
                "aux engine.replica_roles must be a list (or comma string) of "
                "prefill/decode/hybrid: got {!r}".format(raw_roles))
        if n <= 1:
            raise ValueError("aux engine.replica_roles needs engine.replicas >= 2 (got {} "
                             "replica)".format(n))
        for role in roles:
            # before any worker process starts (the group checks them too)
            if role not in ("prefill", "decode", "hybrid"):
                raise ValueError("engine.replica_roles entries must be prefill/decode/"
                                 "hybrid: got {!r}".format(role))
    backend = str(engine_cfg.get("replica_backend", "inprocess")).strip().lower()
    if backend not in ("inprocess", "process"):
        raise ValueError("aux engine.replica_backend must be inprocess/process: got {!r}".format(
            engine_cfg.get("replica_backend")))
    transport = str(engine_cfg.get("kv_transport_backend", "shared")).strip().lower()
    if transport not in ("shared", "socket"):
        raise ValueError("aux engine.kv_transport_backend must be shared/socket: got {!r}".format(
            engine_cfg.get("kv_transport_backend")))
    if backend == "process" and n <= 1:
        raise ValueError("aux engine.replica_backend=process needs engine.replicas >= 2 "
                         "(got {})".format(n))
    spill = engine_cfg.get("router_spill_queue_depth")
    return {
        "replicas": n,
        "roles": roles,
        "affinity_blocks": int(engine_cfg.get("router_affinity_blocks", 4)),
        # `is not None`: an explicit 0 is "never spill on queue depth"
        "spill_queue_depth": int(spill) if spill is not None else None,
        "spill_brownout_stage": int(engine_cfg.get("router_spill_stage", 2)),
        "fleet_shed_stage": int(engine_cfg.get("router_fleet_shed_stage", 3)),
        "kv_transport_pages": (int(engine_cfg["kv_transport_pages"])
                               if engine_cfg.get("kv_transport_pages") else None),
        "kv_transport_backend": transport,
        "replica_backend": backend,
    }


def _lifecycle_knob(engine_cfg: Dict[str, Any], key: str, default):
    """A lifecycle knob of the aux block: absent -> ``default``, 0/false
    -> off (None), else its float."""
    if key not in engine_cfg:
        return default
    value = engine_cfg[key]
    return float(value) if value else None


def build_engine(engine_cfg: Dict[str, Any], *, device="cuda",
                 params: Optional[Dict[str, Any]] = None, cuda_graphs: bool = True,
                 config: Optional[Dict[str, Any]] = None, tokenizer=None):
    """(engine, tokenizer) from an aux ``engine`` block. Weights are random,
    made on ``device`` from ``seed`` (the weightless preset mode), unless
    ``params`` (``init_params``/``convert_params`` output, full precision or
    already quantized) is given. A model bundle's (``load_bundle_engine``)
    gives its stored ``config`` in place of the preset and ``engine.config``,
    and its ``tokenizer``. ``weight_quant`` (or ``quantize``)
    quantizes full-precision weights before the model is built; on an
    already-packed tree it must name the tree's format. ``cuda_graphs=False``
    builds the eager arm (``LLMEngineCore``'s argument; no aux key sets
    it). With ``replicas`` > 1 the engine is a ``ReplicaGroup``: ONE
    ``Llama`` (one set of weights) and that many ``LLMEngineCore`` replicas
    over it ("r0", "r1", ...), each with its own KV pool and graphs, and
    each on a stream of its own: replica 0 on the current stream, the
    others on ``device.replica_stream``. With ``replica_backend: process``
    the replicas are worker processes (``serving/process_replica.py``),
    each drawing the same weights from ``seed`` on its own device (or
    loading ``params`` from a file written once for them): this process
    makes no weight."""
    unknown = sorted(k for k in engine_cfg if k not in ENGINE_KEYS)
    if unknown:
        raise ValueError(
            "aux engine keys {} are not supported by the PyTorch port yet".format(unknown)
        )
    warmup = warmup_mode(engine_cfg)  # typo'd knobs fail at load
    default_priority(engine_cfg)
    fleet = fleet_config(engine_cfg)
    if engine_cfg.get("arch", "llama") != "llama":
        raise ValueError("aux engine.arch {!r} has no decoder: task 'generate' needs "
                         "arch 'llama'".format(engine_cfg["arch"]))
    if not engine_cfg.get("preset") and config is None:
        raise ValueError("an llm engine needs a model bundle or aux engine.preset")
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
    # engine.config lies over the preset: a family no preset matches (Qwen2.5,
    # Gemma) names every key there, nested rope_scaling included
    cfg = resolve_config(dict(config) if config is not None else
                         {"preset": engine_cfg["preset"], **(engine_cfg.get("config") or {})})
    if engine_cfg.get("kv_quant"):
        cfg["kv_quant"] = str(engine_cfg["kv_quant"])
    # a family the paged kernels do not serve is refused with the
    # reference's words before any weight is made
    reason = paged_unsupported_reason(cfg) if engine_cfg.get("cache") == "paged" else None
    if reason:
        raise ValueError(reason)
    seed = int(engine_cfg.get("seed", 0))
    tokenizer = tokenizer or make_tokenizer(cfg)
    kwargs = engine_kwargs(engine_cfg, cfg, tokenizer, weight_quant, cuda_graphs)
    n = fleet.pop("replicas")
    if fleet.pop("replica_backend") == "process":
        from ..serving.process_replica import build_process_fleet

        # the JSON-safe engine kwargs: each worker rebuilds its tokenizer
        worker_kwargs = {k: v for k, v in kwargs.items() if k != "tokenizer"}
        fleet.pop("kv_transport_backend")
        group = build_process_fleet(
            {"config": cfg, "seed": seed, "weight_quant": weight_quant}, worker_kwargs, n,
            warmup_mode=warmup, device=str(dev), params=params, **fleet)
        return group, tokenizer
    model = make_llama(cfg, dev, seed, weight_quant, params)
    if n == 1:
        return LLMEngineCore(model, **kwargs), tokenizer
    from .replica import ReplicaGroup

    engines = []
    for i in range(n):
        # "rN" everywhere: the engine's replica id is the ring member's
        # name, the metrics' label and the /ready block's key. Replica 0
        # stays on the current stream, the others get streams of their own
        if dev.type == "cuda" and i > 0:
            stream = replica_stream(dev, i)
            # the weights were written on the stream current here
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                engines.append(LLMEngineCore(model, replica="r{}".format(i), **kwargs))
        else:
            engines.append(LLMEngineCore(model, replica="r{}".format(i), **kwargs))
    return ReplicaGroup(engines, warmup_mode=warmup, **fleet), tokenizer


def load_bundle_engine(path, engine_cfg: Dict[str, Any], *, device="cuda",
                       cuda_graphs: bool = True):
    """(engine, tokenizer) over a model bundle, as the reference's
    ``_native_load`` serves one: ``load_bundle`` with ``kv_quant`` as a
    config override (each leaf read from the file and copied once to the
    device, then the arch's ``convert_params``), the tokenizer from the
    bundle's files (``load_tokenizer``; byte-level without them or without
    ``transformers``), and ``build_engine`` over the loaded weights:
    ``weight_quant`` quantizes them, ``replicas: N`` shares the one
    ``Llama``. A process fleet is refused with the reference's words: its
    workers rebuild the model from the preset."""
    from ..engines.jax_engine import load_bundle

    if fleet_config(engine_cfg)["replica_backend"] == "process":
        raise EndpointModelError(
            "engine.replica_backend=process needs an engine.preset "
            "model: worker processes rebuild the model from the "
            "preset spec, and a local-path bundle cannot be "
            "re-materialized in them yet (docs/replication.md)"
        )
    overrides = {"kv_quant": str(engine_cfg["kv_quant"])} if engine_cfg.get("kv_quant") else None
    bundle, params = load_bundle(path, config_overrides=overrides, device=resolve_device(device))
    if "n_kv_heads" not in bundle.config:
        raise EndpointModelError(
            "llm endpoint bundle {} is not a decoder bundle (arch {!r}): task "
            "'generate' needs one".format(path, bundle.config.get("arch")))
    tokenizer = load_tokenizer(str(path), int(bundle.config.get("vocab_size", 0)))
    return build_engine(engine_cfg, device=device, params=params, cuda_graphs=cuda_graphs,
                        config=bundle.config, tokenizer=tokenizer)


def bundle_arch(path) -> Optional[str]:
    """The ``arch`` a native bundle's ``model_config.json`` names (None for
    a foreign graph: ONNX, GraphDef, TorchScript)."""
    from pathlib import Path

    from ..utils.files import read_json

    base = Path(path)
    meta = read_json((base if base.is_dir() else base.parent) / "model_config.json")
    return (meta or {}).get("arch")


def engine_task(engine_cfg: Dict[str, Any], path=None, url: str = "") -> str:
    """The endpoint's task, gated as the reference gates it: aux
    ``engine.task``, else ``transcribe`` for a speech encoder-decoder (a
    ``whisper`` bundle or arch), ``generate`` for a decoder (a ``llama``
    bundle or preset) and ``embed`` for any other model. An unknown task is
    refused with the reference's words."""
    task = engine_cfg.get("task")
    if task is None:
        arch = bundle_arch(path) if path else engine_cfg.get("arch", "llama")
        task = {"whisper": "transcribe", "llama": "generate"}.get(arch, "embed")
    if task not in ENCODER_TASKS and task not in AUDIO_TASKS and task != "generate":
        raise EndpointModelError(
            "unknown engine task {!r} for endpoint {!r} (expected 'generate' or one of "
            "{})".format(task, url, sorted(ENCODER_TASKS | AUDIO_TASKS)))
    return task


def _bundle_and_params(engine_cfg: Dict[str, Any], dev: torch.device, path, check):
    """The model payload at ``path`` (a bundle, or any graph ``load_bundle``
    reads), else ``engine.arch``'s ``engine.preset`` (with ``engine.config``
    over it; the caller checks there is one) on weights drawn on ``dev``
    from ``seed``, ``check(bundle)`` refusing an unfit preset before any
    weight is made."""
    from .. import models
    from ..engines.jax_engine import load_bundle

    if path:
        return load_bundle(path, device=dev)
    bundle = models.build_model(engine_cfg.get("arch", "llama"), {
        "preset": engine_cfg["preset"], **(engine_cfg.get("config") or {})})
    check(bundle)
    gen = torch.Generator(dev)
    gen.manual_seed(int(engine_cfg.get("seed", 0)))
    return bundle, bundle.convert_params(bundle.init(gen), device=dev)


def build_encoder(engine_cfg: Dict[str, Any], *, device="cuda", path=None):
    """(``EncoderCore``, tokenizer) of an encoder task: the model payload at
    ``path`` (a bundle, or any graph ``load_bundle`` reads), else
    ``engine.arch``'s ``engine.preset`` (with ``engine.config`` over it; the
    caller checks there is one) on weights drawn on ``device`` from
    ``seed``. The tokenizer is the bundle's
    (byte-level without tokenizer files); its ``cls``/``sep`` ids join a
    cross-encoder's pairs. Knobs: ``pooling`` (mean/cls), ``normalize``,
    ``seq_buckets``, ``batch_buckets``; the generation knobs are ignored,
    as the reference ignores them here."""
    from .encoder import EncoderCore

    dev = resolve_device(device)
    bundle, params = _bundle_and_params(engine_cfg, dev, path, EncoderCore.check_bundle)
    tokenizer = load_tokenizer(str(path) if path else None,
                               int(bundle.config.get("vocab_size", 0)))
    hf = getattr(tokenizer, "_tok", None)
    encoder = EncoderCore(
        bundle, params,
        pooling=engine_cfg.get("pooling", "mean"),
        normalize=bool(engine_cfg.get("normalize", True)),
        seq_buckets=engine_cfg.get("seq_buckets"),
        batch_buckets=engine_cfg.get("batch_buckets"),
        sep_token_id=getattr(hf, "sep_token_id", None),
        cls_token_id=getattr(hf, "cls_token_id", None),
        device=dev)
    return encoder, tokenizer


def build_audio(engine_cfg: Dict[str, Any], *, device="cuda", path=None):
    """(``AudioCore``, tokenizer) of an audio task, from the same two
    sources as ``build_encoder``. Knobs: ``decode_steps`` (16) and
    ``max_tokens`` (the reference's ``max_new_tokens``); a bundle with no
    speech encoder-decoder surface is refused with ``AudioCore``'s
    words."""
    from .audio import AudioCore

    dev = resolve_device(device)
    bundle, params = _bundle_and_params(engine_cfg, dev, path, AudioCore.check_bundle)
    tokenizer = load_tokenizer(str(path) if path else None,
                               int(bundle.config.get("vocab_size", 0)))
    audio = AudioCore(bundle, params, decode_steps=int(engine_cfg.get("decode_steps", 16)),
                      max_new_tokens=engine_cfg.get("max_tokens"), device=dev)
    return audio, tokenizer


def make_tokenizer(cfg: Dict[str, Any]) -> ByteTokenizer:
    return ByteTokenizer(vocab_size=max(int(cfg["vocab_size"]), 259))


def make_llama(cfg: Dict[str, Any], dev: torch.device, seed: int,
               weight_quant: Optional[str], params: Optional[Dict[str, Any]] = None) -> Llama:
    """The served model: ``params`` (full precision or packed), else
    random weights drawn on ``dev`` from ``seed``; full-precision weights
    are quantized to ``weight_quant`` first. A process replica's worker
    builds its model here too, from the same arguments."""
    if params is None:
        gen = torch.Generator(dev)
        gen.manual_seed(int(seed))
        params = init_params(cfg, gen, device=dev)
    if weight_quant and not detect_weight_quant(params):
        params = quantize_llama_params(params, bits=4 if weight_quant == "int4" else 8)
    return Llama(cfg, params)


def engine_kwargs(engine_cfg: Dict[str, Any], cfg: Dict[str, Any], tokenizer,
                  weight_quant: Optional[str], cuda_graphs: bool) -> Dict[str, Any]:
    """``LLMEngineCore``'s keyword arguments from an aux ``engine`` block."""
    cache = engine_cfg.get("cache", "dense")
    return dict(
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
        # two-dispatch admissions, as the reference maps them: chunked
        # prefill segments (aux chunked_prefill) and the prefill gate, on
        # at 2 segments per decode chunk unless set to 0
        chunked_prefill_size=engine_cfg.get("chunked_prefill"),
        prefill_segments_per_decode=engine_cfg.get("prefill_segments_per_decode", 2),
        prefill_stall_timeout=engine_cfg.get("prefill_stall_timeout"),
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
        # OpenAI's top_logprobs ceiling, as the reference reads it
        logprobs_k=int(engine_cfg.get("logprobs_k", 20)),
        # guided decoding's token byte tables
        tokenizer=tokenizer,
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


@register_engine("llm", modules=["torch"])
class LLMEngineRequest(BaseEngineRequest):
    """One engine per endpoint per process: the chat, completions, tokenize,
    detokenize and models routes. With aux ``engine.warmup`` other than
    "off" (``warmup_mode``), the first requests wait for the engine's warmup
    sweep; ``engine.default_priority`` (``default_priority``) is the class
    of requests whose body names none. The engine binds its loop and
    watchdog tasks to the serving loop at the first request, so an
    endpoint built before the loop runs (the processor's launch) serves
    from it."""

    is_preprocess_async = True
    is_process_async = True
    is_postprocess_async = True

    def __init__(self, *args, **kwargs):
        self.engine: Optional[LLMEngineCore] = None
        # an encoder endpoint's core (engine_task): the encoder routes
        self.encoder = None  # llm/encoder.py's EncoderCore
        # an audio endpoint's core: the audio routes
        self.audio = None  # llm/audio.py's AudioCore
        self.tokenizer = None
        self._model_name = "model"
        # the aux engine.chat block (the reference's vLLM chat settings):
        # response_role
        self._chat_cfg: Dict[str, Any] = {}
        self._default_priority = "interactive"
        self._warmup_needed = False
        self._warmup_full = False
        self._warmup_task = None
        self._retiring = False
        self._retire_task = None
        super().__init__(*args, **kwargs)

    @classmethod
    def wrap(cls, engine, tokenizer, serving_url: str,
             engine_cfg: Optional[Dict[str, Any]] = None, **kwargs) -> "LLMEngineRequest":
        """The endpoint ``serving_url`` over an engine (or an
        ``EncoderCore`` or ``AudioCore``) the caller built (the tests' and
        ``chip_smoke.py``'s carried weights). ``engine_cfg`` is
        the aux ``engine`` block the endpoint records; only its endpoint
        knobs (``warmup``, ``default_priority``, ``chat``) are read, since
        the engine exists. The processor's path builds the engine from the
        block instead."""
        endpoint = ModelEndpoint(engine_type="llm", serving_url=serving_url,
                                 auxiliary_cfg={"engine": dict(engine_cfg or {})})
        self = cls.__new__(cls)
        self._carried = (engine, tokenizer)
        self.__init__(endpoint, **kwargs)
        return self

    def _native_load(self) -> Any:
        aux = self.endpoint.auxiliary_cfg if isinstance(self.endpoint.auxiliary_cfg, dict) else {}
        unknown = sorted(k for k in aux if k != "engine")
        if unknown:
            raise ValueError("aux config keys {} are not supported by the PyTorch port "
                             "yet".format(unknown))
        engine_cfg = dict(aux.get("engine") or {})
        self._chat_cfg = dict(engine_cfg.pop("chat", None) or {})
        # endpoint knobs, refused at load when mistyped
        warmup = warmup_mode(engine_cfg)
        self._default_priority = default_priority(engine_cfg)
        from .audio import AudioCore
        from .encoder import EncoderCore

        carried = getattr(self, "_carried", None)
        self._carried = None
        self._model_name = self.endpoint.serving_url
        if isinstance(carried, tuple) and isinstance(carried[0], EncoderCore):
            self.encoder, self.tokenizer = carried
            return self.encoder
        if isinstance(carried, tuple) and isinstance(carried[0], AudioCore):
            self.audio, self.tokenizer = carried
            return self.audio
        task = None if carried is not None else engine_task(
            engine_cfg, self._model_local_path, self.endpoint.serving_url)
        if task in ENCODER_TASKS or task in AUDIO_TASKS:
            # task-gated as the reference's vLLM handlers: an encoder serves
            # the embeddings, pooling, classify, score and rerank routes, a
            # speech encoder-decoder the audio routes
            if not self._model_local_path and not engine_cfg.get("preset"):
                raise EndpointModelError(
                    "llm endpoint {!r} needs a model bundle or aux_config "
                    "engine.preset".format(self.endpoint.serving_url))
            if task in AUDIO_TASKS:
                self.audio, self.tokenizer = build_audio(
                    engine_cfg, device=self.device, path=self._model_local_path)
                return self.audio
            self.encoder, self.tokenizer = build_encoder(
                engine_cfg, device=self.device, path=self._model_local_path)
            return self.encoder
        if carried is not None:
            self.engine, self.tokenizer = carried
        elif self._model_local_path:
            self.engine, self.tokenizer = load_bundle_engine(
                self._model_local_path, engine_cfg, device=self.device)
        elif engine_cfg.get("preset"):
            self.engine, self.tokenizer = build_engine(engine_cfg, device=self.device)
        else:
            raise EndpointModelError(
                "llm endpoint {!r} needs a model bundle or aux_config engine.preset".format(
                    self.endpoint.serving_url))
        self._warmup_needed = warmup != "off"
        self._warmup_full = warmup == "full"
        self._register_metrics()
        return self.engine

    def _register_metrics(self) -> None:
        """Prometheus wiring, as the reference's ``_register_metrics``:
        the engine's prefix cache and lifecycle provider under the
        endpoint's name, or, on a fleet, each replica's under
        ``<name>@rN`` (their series carry ``model`` and ``replica``) and
        the router's (a process replica's lifecycle block is read from its
        worker over the sync channel). A provider holds its engine weakly,
        and the release of an evicted engine drops every entry this request registered
        (``_unregister_metrics``), so the process-wide registry never pins
        an evicted engine's weights and pools."""
        from ..statistics import metrics

        model = self._model_name
        self._metric_entries = []

        def lifecycle_provider(engine_ref, inject_model=None):
            def provider():
                engine = engine_ref()
                if engine is None:
                    return None
                s = engine.lifecycle_stats()
                if inject_model is not None:
                    s["model"] = inject_model
                return s
            return provider

        def register(engine, key, replica=None):
            # a process replica's proxy has a routing-only prefix probe (its
            # cache lives in the worker and reports through the lifecycle
            # block, read over the sync channel)
            if engine._prefix is not None and hasattr(engine._prefix, "stats"):
                collector = metrics.register_prefix_cache(
                    engine._prefix, engine.paged_cache.pool, key=key,
                    model=model if replica is not None else None, replica=replica)
                self._metric_entries.append((collector, key, engine._prefix))
            provider = lifecycle_provider(weakref.ref(engine),
                                          model if replica is not None else None)
            collector = metrics.register_engine_lifecycle(provider, key=key)
            self._metric_entries.append((collector, key, provider))

        replicas = getattr(self.engine, "replicas", None)
        if replicas is None:
            register(self.engine, model)
            # a previous fleet incarnation's per-replica entries
            metrics.prune_prefix_caches(model, {model})
            metrics.prune_engine_lifecycle(model, {model})
            metrics.prune_replica_router(model, set())
            return
        keep = {"{}@{}".format(model, r.name) for r in replicas}
        for replica in replicas:
            register(replica.engine, "{}@{}".format(model, replica.name), replica.name)
        metrics.prune_prefix_caches(model, keep)
        metrics.prune_engine_lifecycle(model, keep)
        group_ref = weakref.ref(self.engine)

        def router_provider():
            group = group_ref()
            if group is None:
                return None
            s = group.router.stats()
            s["model"] = model
            return s

        collector = metrics.register_replica_router(router_provider, key=model)
        self._metric_entries.append((collector, model, router_provider))

    def _unregister_metrics(self) -> None:
        """Drop the entries ``_register_metrics`` made that are still this
        request's (a newer incarnation of the endpoint may have replaced
        them under the same key)."""
        for collector, key, value in getattr(self, "_metric_entries", None) or ():
            collector.remove_entry(key, only=value)
        self._metric_entries = []

    async def _ensure_warm(self) -> None:
        """First arrivals share one warmup task and wait for it; afterwards
        this is one attribute read. A failed warmup is logged and not
        retried: a decode-graph variant it left uncaptured is captured at
        its first use, and a capture that fails there fails its step."""
        if not self._warmup_needed or self.engine is None:
            return
        if self._warmup_task is None:
            self._warmup_task = asyncio.ensure_future(self.engine.warmup(full=self._warmup_full))
        try:
            await asyncio.shield(self._warmup_task)
        except Exception as ex:
            logging.getLogger(__name__).warning("engine warmup failed: %s", ex,
                                                exc_info=True)
        self._warmup_needed = False

    # -- eviction --------------------------------------------------------------

    def retire(self) -> None:
        """The processor dropped this endpoint (removed or changed; called
        under ``CAPTURE_LOCK`` on the sync thread). The engine's loop and
        watchdog tasks hold it, so the collector alone would never free
        it: once its in-flight requests end it is stopped, and the last
        reference drops under ``CAPTURE_LOCK``, outside any capture. An
        engine that never served is released now."""
        core = self.encoder if self.encoder is not None else self.audio
        if core is not None and not self._retiring:
            # its release queues behind the calls already on its thread
            self._retiring = True
            core.retire()
            return
        engine = self.engine
        if engine is None or self._retiring:
            return
        self._retiring = True
        task = engine._loop_task or engine._watchdog_task
        loop = task.get_loop() if task is not None else None
        if loop is None or loop.is_closed():
            # (a process fleet has no loop task here: its stop reaps the
            # workers; its proxies' cycles go with the collection)
            engine.stop()
            del engine
            self._release()
            return
        loop.call_soon_threadsafe(self._start_retire)

    def _start_retire(self) -> None:
        # held: the loop keeps only weak references to tasks
        self._retire_task = asyncio.get_running_loop().create_task(self._retire())

    async def _retire(self) -> None:
        try:
            await self.engine.stop_when_idle()
            if self._warmup_task is not None:
                await asyncio.wait([self._warmup_task])
            await asyncio.to_thread(self._release)
        except Exception:
            logging.getLogger(__name__).exception("retiring the engine of endpoint %r failed",
                                                  self.endpoint.serving_url)

    def _release(self) -> None:
        with CAPTURE_LOCK:
            self._drop_engine()
            gc.collect()

    def _drop_engine(self) -> None:
        """Drop every reference this request holds to its engine
        (``_load_model`` keeps it as ``_model`` too), and the metrics'
        entries for it."""
        self._unregister_metrics()
        self.engine = None
        self._model = None
        self._warmup_task = None

    # -- request parsing -----------------------------------------------------

    @staticmethod
    def _check_fields(body: Dict[str, Any], allowed) -> None:
        """Refuse, by name, every field the route does not know."""
        unknown = sorted(k for k, v in body.items() if k not in allowed and v is not None)
        if unknown:
            raise ValueError(
                "request fields {} are not supported by the PyTorch port yet".format(unknown))

    def _gen_request_from_body(self, body: Dict[str, Any], prompt_ids: List[int],
                               chat: bool = True, guided_override=None) -> GenRequest:
        """``guided_override``: a ``GuidedSpec`` that supersedes the body's
        own ``response_format``/``guided_*`` (tool_choice required or
        forced compiles the tool-call JSON into the grammar)."""
        logit_bias = body.get("logit_bias") or None
        if logit_bias is not None:
            logit_bias = {int(k): float(v) for k, v in logit_bias.items()}
        # logprobs: chat takes `logprobs: bool` + `top_logprobs: int`;
        # completions take `logprobs: int` (0 = the chosen token only)
        if chat:
            logprobs = (int(body.get("top_logprobs", 0) or 0) if body.get("logprobs")
                        else None)
        else:
            raw_lp = body.get("logprobs")
            logprobs = int(raw_lp) if raw_lp is not None and raw_lp is not False else None
        request = GenRequest(
            prompt_ids=prompt_ids,
            max_new_tokens=int(body.get("max_tokens") or body.get("max_completion_tokens") or 128),
            temperature=float(body.get("temperature", 0.0) or 0.0),
            top_k=int(body.get("top_k", 0) or 0),
            top_p=float(body.get("top_p", 1.0) or 1.0),
            presence_penalty=float(body.get("presence_penalty", 0.0) or 0.0),
            frequency_penalty=float(body.get("frequency_penalty", 0.0) or 0.0),
            repetition_penalty=float(body.get("repetition_penalty", 1.0) or 1.0),
            seed=int(body["seed"]) if body.get("seed") is not None else None,
            logit_bias=logit_bias,
            logprobs=logprobs,
            min_tokens=int(body.get("min_tokens", 0) or 0),
            guided=guided_override or self._guided_spec(body),
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
        # vLLM return_tokens_as_token_ids: logprob token strings become
        # "token_id:<id>" (API-layer formatting, not an engine field)
        request.tokens_as_ids = bool(body.get("return_tokens_as_token_ids"))
        return request

    @staticmethod
    def _guided_spec(body: Dict[str, Any]) -> Optional[GuidedSpec]:
        """OpenAI ``response_format`` (``json_object``/``json_schema``) and
        vLLM's ``guided_choice``/``guided_regex``/``guided_json`` as a
        ``GuidedSpec`` (None: unconstrained), in the reference's order of
        precedence."""
        if body.get("guided_choice"):
            choices = body["guided_choice"]
            if not isinstance(choices, (list, tuple)) or not choices:
                raise ValueError("guided_choice must be a non-empty list")
            return GuidedSpec("regex", "({})".format(
                "|".join(_regex_escape_literal(str(c)) for c in choices)))
        if body.get("guided_regex"):
            return GuidedSpec("regex", str(body["guided_regex"]))
        if body.get("guided_json") is not None:
            schema = body["guided_json"]
            if isinstance(schema, str):
                schema = json.loads(schema)
            # no sort_keys: the properties' declaration order is the order
            # the grammar emits them in
            return GuidedSpec("json_schema", json.dumps(schema))
        rf = body.get("response_format")
        if not rf or isinstance(rf, str):
            return None
        kind = rf.get("type")
        if kind == "json_object":
            return GuidedSpec("json_object")
        if kind == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema")
            if schema is None:
                raise ValueError("response_format.json_schema.schema missing")
            return GuidedSpec("json_schema", json.dumps(schema))
        if kind in (None, "text"):
            return None
        raise ValueError("unsupported response_format type {!r}".format(kind))

    def _n_requests(self, body: Dict[str, Any], prompt_ids: List[int],
                    chat: bool = True, guided_override=None) -> List[GenRequest]:
        """OpenAI ``n`` choices: n independent requests through the batch; a
        seeded request's choice i takes seed + i, so choices differ."""
        n = int(body.get("n", 1) or 1)
        if n < 1:
            raise ValueError("n must be >= 1")
        requests = []
        for i in range(n):
            r = self._gen_request_from_body(body, list(prompt_ids), chat=chat,
                                            guided_override=guided_override)
            if r.seed is not None and i:
                r.seed = r.seed + i
            requests.append(r)
        return requests

    @staticmethod
    def _report_gen_stats(request: GenRequest, collect_fn) -> None:
        """TTFT and token counts into the sampled stats (the reference's
        per-endpoint metrics). Streams report when their body ends: the
        processor defers their packet to ``StreamingOutput.on_complete``."""
        if collect_fn is None:
            return
        stats = {"gen_tokens": request.produced, "prompt_tokens": request.prompt_len}
        if request.first_token_at is not None:
            stats["ttft"] = round(request.first_token_at - request.submitted_at, 6)
        collect_fn(stats)

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
        """Smallest token count whose decoded prefix covers n_chars (trims
        tokens, logprobs and usage to the emitted text)."""
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

    async def _stream_deltas(self, request: GenRequest,
                             stops: List[str]) -> AsyncIterator[Dict[str, Any]]:
        """``{"delta", "entries"}`` pieces: text deltas, with the logprob
        entries of the tokens whose text they carry (None without
        logprobs). Stop strings hold back a potential stop-prefix tail so a
        matched stop is never partially emitted; entries never lead the
        text."""
        ids: List[int] = []
        sent = ""
        holdback = max((len(s) for s in stops), default=1) - 1
        eos = self.tokenizer.eos_token_id
        lp_cursor = 0

        def take_entries(upto_tokens: int):
            nonlocal lp_cursor
            new = request.logprob_entries[lp_cursor:upto_tokens]
            lp_cursor = max(lp_cursor, upto_tokens)
            return new

        def entries_for(n_chars: int):
            if request.logprobs is None:
                return None
            return take_entries(self._tokens_covering(ids, n_chars))

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
                    entries = take_entries(j) if request.logprobs is not None else None
                    if cut > len(sent) or entries:
                        yield {"delta": text[len(sent):cut], "entries": entries}
                    return
                text = text[: len(text) - holdback] if holdback else text
            if len(text) > len(sent):
                prev = len(sent)
                sent = text
                yield {"delta": text[prev:], "entries": entries_for(len(text))}
        # flush the held-back tail (and a final legitimate replacement
        # char), with the entries of tokens that decoded to no text
        text = self.tokenizer.decode(ids)
        if stops:
            cut = self._first_stop_hit(text, stops)
            if cut >= 0:
                request.stopped_on_string = True
                text = text[:cut]
                j = self._tokens_covering(ids, cut)
                del ids[j:]
                request.produced = j
        tail_entries = take_entries(len(ids)) if request.logprobs is not None else None
        if len(text) > len(sent) or tail_entries:
            yield {"delta": text[len(sent):], "entries": tail_entries}

    # -- logprob payloads (chat and completions shapes) ----------------------

    def _chat_lp_entries(self, entries: List[dict], k: int, as_ids: bool = False) -> List[dict]:
        content = []
        for entry in entries:
            tok = token_repr(self.tokenizer, entry["id"], as_ids)
            tops = []
            for t, lp in zip(entry["top_ids"][:k], entry["top_logprobs"][:k]):
                ts = token_repr(self.tokenizer, t, as_ids)
                tops.append({"token": ts, "logprob": lp, "bytes": list(ts.encode("utf-8"))})
            content.append({"token": tok, "logprob": entry["logprob"],
                            "bytes": list(tok.encode("utf-8")), "top_logprobs": tops})
        return content

    def _chat_logprobs(self, request: GenRequest, ids: List[int]) -> Dict[str, Any]:
        return {"content": self._chat_lp_entries(
            request.logprob_entries[: len(ids)], int(request.logprobs or 0),
            as_ids=getattr(request, "tokens_as_ids", False))}

    def _completion_lp_entries(self, entries: List[dict], k: int, offset: int = 0,
                               as_ids: bool = False) -> Tuple[Dict[str, Any], int]:
        """(logprobs block, next text offset); offsets track the emitted
        text, in token-id mode too."""
        tokens, token_logprobs, top_logprobs, offsets = [], [], [], []
        for entry in entries:
            decoded = token_str(self.tokenizer, entry["id"])
            tokens.append("token_id:{}".format(int(entry["id"])) if as_ids else decoded)
            token_logprobs.append(entry["logprob"])
            top_logprobs.append({token_repr(self.tokenizer, t, as_ids): lp for t, lp in
                                 zip(entry["top_ids"][:k], entry["top_logprobs"][:k])})
            offsets.append(offset)
            offset += len(decoded)
        return {"tokens": tokens, "token_logprobs": token_logprobs,
                "top_logprobs": top_logprobs, "text_offset": offsets}, offset

    def _completion_logprobs(self, request: GenRequest, ids: List[int]) -> Dict[str, Any]:
        lp, _ = self._completion_lp_entries(
            request.logprob_entries[: len(ids)], int(request.logprobs or 0),
            as_ids=getattr(request, "tokens_as_ids", False))
        return lp

    def _prompt_logprobs_n(self, body: Dict[str, Any]) -> Optional[int]:
        """The vLLM ``prompt_logprobs`` knob (None = off), validated."""
        raw = body.get("prompt_logprobs")
        if raw is None or raw is False:
            return None
        n_top = int(raw)
        if n_top < 0:
            raise ValueError("prompt_logprobs must be >= 0")
        ceiling = int(self.engine.logprobs_k)
        if n_top > ceiling:
            raise ValueError("prompt_logprobs {} exceeds the engine ceiling {}".format(
                n_top, ceiling))
        return n_top

    def _prompt_logprobs_payload(self, prompt_ids: List[int], n_top: int,
                                 entries=None) -> List[Optional[dict]]:
        """vLLM ``prompt_logprobs``: per prompt position a dict token_id ->
        {logprob, rank, decoded_token} of the top ``n_top`` and the actual
        token with its exact rank (the first position None). Device work
        unless ``entries`` are given: callers run it off the event loop."""
        if entries is None:
            entries = self.engine.score_prompt(prompt_ids)
        out: List[Optional[dict]] = [None]
        for e, tok in zip(entries, prompt_ids[1:]):
            d: Dict[str, Any] = {}
            for r_i, (t, lp) in enumerate(zip(e["top_ids"][:n_top], e["top_logprobs"][:n_top])):
                d[str(int(t))] = {"logprob": lp, "rank": r_i + 1,
                                  "decoded_token": token_str(self.tokenizer, t)}
            d.setdefault(str(int(tok)), {"logprob": e["logprob"], "rank": int(e["rank"]),
                                         "decoded_token": token_str(self.tokenizer, tok)})
            out.append(d)
        return out

    def _echo_prompt_logprobs(self, prompt_ids: List[int], request: GenRequest, entries=None):
        """OpenAI ``echo`` + ``logprobs``: the block starts with the prompt's
        tokens (the first with null logprob and top), scored by one
        teacher-forced pass. Returns (block, next text offset)."""
        k = int(request.logprobs or 0)
        as_ids = getattr(request, "tokens_as_ids", False)
        if entries is None:
            entries = self.engine.score_prompt(prompt_ids)
        first = token_repr(self.tokenizer, prompt_ids[0], as_ids)
        lp, offset = self._completion_lp_entries(
            entries, k, offset=len(token_str(self.tokenizer, prompt_ids[0])), as_ids=as_ids)
        lp["tokens"].insert(0, first)
        lp["token_logprobs"].insert(0, None)
        lp["top_logprobs"].insert(0, None)
        lp["text_offset"].insert(0, 0)
        return lp, offset

    async def _fanout_stream(self, requests: List[GenRequest], stops: List[str], collect_fn,
                             *, head, delta, finish, usage) -> AsyncIterator[str]:
        """Multi-choice SSE (chat and completions): one ``_stream_deltas``
        pump per choice feeds a queue, chunks interleave by arrival tagged
        with their choice's index; ``head`` leads, ``usage()`` (or None)
        trails. Every slot is freed on completion and on disconnect."""
        queue: "asyncio.Queue" = asyncio.Queue()

        async def pump(i, req):
            try:
                async for piece in self._stream_deltas(req, stops):
                    await queue.put((i, "delta", piece))
                await queue.put((i, "finish", None))
            except Exception as ex:  # surfaced as an SSE error event
                await queue.put((i, "error", ex))

        tasks: List[asyncio.Task] = []
        try:
            for chunk in head:
                yield chunk
            tasks = [asyncio.get_running_loop().create_task(pump(i, r))
                     for i, r in enumerate(requests)]
            live = len(requests)
            while live:
                i, kind, payload = await queue.get()
                if kind == "error":
                    yield _sse_error(payload)
                    yield "data: [DONE]\n\n"
                    return
                if kind == "finish":
                    yield finish(i, requests[i])
                    live -= 1
                    continue
                yield delta(i, requests[i], payload)
            tail = usage()
            if tail is not None:
                yield tail
            yield "data: [DONE]\n\n"
        finally:
            for t in tasks:
                t.cancel()
            for r in requests:
                r.cancel()
                self._report_gen_stats(r, collect_fn)

    def _admit_all(self, requests: List[GenRequest]) -> None:
        """Validation and admission before any header: a refusal, a shed or
        a spent budget is a status line, not a broken stream; the reserve
        counts the batch's own earlier choices."""
        for i, r in enumerate(requests):
            self.engine.validate(r)
            self.engine.check_admission(r, reserve=i)

    # -- routes --------------------------------------------------------------

    def _require_engine(self, route: str) -> None:
        if self.engine is None:
            raise EndpointModelError(
                "model {!r} does not support {} (encoder endpoint — task-gated "
                "like the reference's vLLM handler instantiation)".format(
                    self._model_name, route))

    def _require_encoder(self, route: str) -> None:
        if self.encoder is None:
            raise EndpointModelError(
                "model {!r} does not support {} (decoder-only LLM endpoint; "
                "serve an encoder bundle or set aux_config engine.task)".format(
                    self._model_name, route))

    async def v1_chat_completions(self, body: Dict[str, Any], state: Optional[dict] = None,
                                  collect_fn=None):
        """A response dict, or a ``StreamingOutput`` of SSE lines when
        ``stream`` is set (validated before the first line)."""
        self._require_engine("v1/chat/completions")
        self._check_fields(body, CHAT_FIELDS)
        messages = body.get("messages") or []
        tool_mode, forced_tool = resolve_tool_choice(body)
        # tool_choice "none" only prevents calling: the definitions stay in
        # the prompt (a multi-turn history refers to them)
        tools_render = validate_tools(body["tools"]) if body.get("tools") else []
        tools = tools_render if tool_mode != "none" else []
        tool_names = [t["name"] for t in tools]
        guided_override = None
        if tool_mode in ("required", "forced"):
            # the arguments are enforced by construction: the tool-call JSON
            # compiles into the decode grammar (no sort_keys: the name comes
            # before the arguments)
            guided_override = GuidedSpec(
                "json_schema", json.dumps(tool_call_schema(tools, forced_tool)))
        # OpenAI parallel_tool_calls (default true): false keeps one parsed
        # call (required and forced emit exactly one by construction)
        single_call = body.get("parallel_tool_calls") is False
        prompt = render_chat_with_tools(self.tokenizer, messages, tools_render)
        prompt_ids = self.tokenizer.encode_chat(prompt)
        stops = self._stops_from_body(body)
        model = body.get("model", self._model_name)
        completion_id = _gen_id("chatcmpl")
        created = _now()
        # the body's response_role, else the endpoint's aux chat block's
        role = str(body.get("response_role") or self._chat_cfg.get("response_role")
                   or "assistant")
        include_usage = bool((body.get("stream_options") or {}).get("include_usage"))

        def chat_chunk(choice, usage="omit") -> str:
            chunk = {"id": completion_id, "object": "chat.completion.chunk",
                     "created": created, "model": model,
                     "choices": [choice] if choice is not None else []}
            if include_usage:
                # every chunk carries usage null; a final choices-less
                # chunk carries the totals
                chunk["usage"] = None if usage == "omit" else usage
            return "data: {}\n\n".format(json.dumps(chunk))

        plp_n = self._prompt_logprobs_n(body)  # validated before any device work
        if body.get("stream") and plp_n is not None:
            raise ValueError("prompt_logprobs is not supported with streaming")
        if body.get("stream") and tools and int(body.get("n", 1) or 1) != 1:
            # the call sniffing and buffering is per-choice state
            raise ValueError("streaming chat with tools supports a single choice (n=1)")
        requests = self._n_requests(body, prompt_ids, guided_override=guided_override)
        # the warmup first, as the reference's routes await it: a fleet's
        # ring admits no replica before its warmup gate opened
        await self._ensure_warm()
        self._admit_all(requests)

        if body.get("stream") and tools:
            return self._stream_tool_chat(requests[0], stops, tool_mode, tool_names,
                                          single_call, role, chat_chunk, include_usage,
                                          collect_fn)
        if body.get("stream"):
            def chat_delta(i, req, piece):
                choice = {"index": i, "delta": {"content": piece["delta"]},
                          "finish_reason": None}
                if piece.get("entries") is not None:
                    choice["logprobs"] = {"content": self._chat_lp_entries(
                        piece["entries"], int(req.logprobs or 0),
                        as_ids=getattr(req, "tokens_as_ids", False))}
                return chat_chunk(choice)

            def chat_finish(i, req):
                return chat_chunk({"index": i, "delta": {},
                                   "finish_reason": self._finish_reason(req)})

            def chat_usage():
                if not include_usage:
                    return None
                total = sum(r.produced for r in requests)
                return chat_chunk(None, usage={
                    "prompt_tokens": requests[0].prompt_len, "completion_tokens": total,
                    "total_tokens": requests[0].prompt_len + total})

            return StreamingOutput(self._fanout_stream(
                requests, stops, collect_fn,
                head=[chat_chunk({"index": i, "delta": {"role": role}, "finish_reason": None})
                      for i in range(len(requests))],
                delta=chat_delta, finish=chat_finish, usage=chat_usage))

        results = await asyncio.gather(*[self._collect_text(r, stops) for r in requests])
        for r in requests:
            self._report_gen_stats(r, collect_fn)
        plp_payload = None
        if plp_n is not None:
            # one scoring pass, shared by the choices
            plp_payload = await asyncio.to_thread(self._prompt_logprobs_payload, prompt_ids,
                                                  plp_n)
        choices = []
        for i, (r, res) in enumerate(zip(requests, results)):
            choice = {
                "index": i,
                "message": {"role": role, "content": res["text"]},
                "finish_reason": res["finish_reason"],
                "logprobs": (self._chat_logprobs(r, res["ids"]) if r.logprobs is not None
                             else None),
            }
            # a body's own guided response_format pins the output's shape:
            # the JSON answer is the deliverable, not a tool call (streaming
            # skips its call sniffing under the same condition)
            parse_ok = tool_mode in ("required", "forced") or r.guided is None
            if tools and parse_ok and res["finish_reason"] != "length":
                calls = parse_tool_calls(res["text"], tool_names)
                if calls and single_call:
                    calls = calls[:1]
                if calls:
                    # prose around <tool_call> blocks stays as content
                    prose = strip_tool_blocks(res["text"]) if TOOL_TAG in res["text"] else ""
                    choice["message"] = {"role": role, "content": prose or None,
                                         "tool_calls": tool_call_objects(calls)}
                    choice["finish_reason"] = "tool_calls"
            choices.append(choice)
        completion_tokens = sum(r.produced for r in requests)
        out = {
            "id": completion_id,
            "object": "chat.completion",
            "created": created,
            "model": model,
            "choices": choices,
            # the prompt counts once whatever n is
            "usage": {
                "prompt_tokens": requests[0].prompt_len,
                "completion_tokens": completion_tokens,
                "total_tokens": requests[0].prompt_len + completion_tokens,
            },
        }
        if plp_payload is not None:
            # a top-level field in the chat shape (per choice in completions)
            out["prompt_logprobs"] = plp_payload
        return out

    def _stream_tool_chat(self, request: GenRequest, stops: List[str], tool_mode: str,
                          tool_names: List[str], single_call: bool, role: str, chat_chunk,
                          include_usage: bool, collect_fn) -> StreamingOutput:
        """One streamed choice of a chat with tools (the reference's mode
        machine): "buffer" withholds a certain or suspected tool call to
        the end (required and forced always); "sniff" decides from the
        first text whether it may grow into a call (auto, unless the body
        pins a guided format); "watch" streams live while holding back a
        possible ``<tool_call>`` tag (models narrate before calling); then
        the parsed calls stream as ``tool_calls`` deltas with
        ``finish_reason: "tool_calls"``, any prose around them as
        content."""
        buffer_all = tool_mode in ("required", "forced")
        sniffing = tool_mode == "auto" and request.guided is None

        def call_prefix(text):
            """Could ``text`` still grow into a tool call? 'yes' (buffer to
            the end), 'maybe' (keep sniffing), 'no' (flush)."""
            s = text.lstrip()
            if not s:
                return "maybe"
            if s.startswith(("{", "[", TOOL_TAG)):
                return "yes"
            if TOOL_TAG.startswith(s):
                return "maybe"
            return "no"

        async def sse():
            mode = "buffer" if buffer_all else ("sniff" if sniffing else "stream")
            held: List[str] = []      # text awaiting the decision
            stashed: List[dict] = []  # logprob entries withheld with it
            watch_pending = ""        # the tag holdback in watch mode

            def lp(entries):
                return {"content": self._chat_lp_entries(
                    entries, int(request.logprobs or 0),
                    as_ids=getattr(request, "tokens_as_ids", False))}

            def content_chunk(text, entries):
                choice = {"index": 0, "delta": {"content": text}, "finish_reason": None}
                if entries:
                    # withheld entries ride the chunk that finally emits
                    # their text: each is delivered once
                    choice["logprobs"] = lp(entries)
                return chat_chunk(choice)

            def watch_emit(text):
                """The emittable prefix of ``text``; a whole tool tag
                switches to buffer mode, a partial one is held back."""
                nonlocal mode, watch_pending, held
                watch_pending += text
                idx = watch_pending.find(TOOL_TAG)
                if idx >= 0:
                    emit = watch_pending[:idx]
                    held = [watch_pending[idx:]]
                    watch_pending = ""
                    mode = "buffer"
                    return emit
                emit, watch_pending = split_tag_holdback(watch_pending)
                return emit

            try:
                yield chat_chunk({"index": 0, "delta": {"role": role}, "finish_reason": None})
                try:
                    async for piece in self._stream_deltas(request, stops):
                        entries = piece.get("entries") or []
                        if mode in ("buffer", "sniff"):
                            held.append(piece["delta"])
                            stashed.extend(entries)
                            if mode == "sniff":
                                verdict = call_prefix("".join(held))
                                if verdict == "yes":
                                    mode = "buffer"
                                elif verdict == "no":
                                    mode = "watch"
                                    text, held = "".join(held), []
                                    emit = watch_emit(text)
                                    if emit:
                                        yield content_chunk(emit, stashed)
                                        stashed = []
                            continue
                        if mode == "watch":
                            emit = watch_emit(piece["delta"])
                            stashed.extend(entries)
                            if emit:
                                yield content_chunk(emit, stashed)
                                stashed = []
                            continue
                        choice = {"index": 0, "delta": {"content": piece["delta"]},
                                  "finish_reason": None}
                        if piece.get("entries") is not None:
                            choice["logprobs"] = lp(piece["entries"])
                        yield chat_chunk(choice)
                except Exception as ex:
                    yield _sse_error(ex)
                    yield "data: [DONE]\n\n"
                    return
                finish = self._finish_reason(request)
                text = "".join(held) + watch_pending
                calls = (parse_tool_calls(text, tool_names)
                         if text and finish != "length" else None)
                if calls and single_call:
                    calls = calls[:1]
                if calls:
                    prose = strip_tool_blocks(text) if TOOL_TAG in text else ""
                    if prose:
                        yield content_chunk(prose, stashed)
                        stashed = []
                    for ci, tc in enumerate(tool_call_objects(calls)):
                        first = {"index": 0, "delta": {"tool_calls": [{
                            "index": ci, "id": tc["id"], "type": "function",
                            "function": {"name": tc["function"]["name"], "arguments": ""},
                        }]}, "finish_reason": None}
                        if ci == 0 and stashed:
                            first["logprobs"] = lp(stashed)
                            stashed = []
                        yield chat_chunk(first)
                        yield chat_chunk({"index": 0, "delta": {"tool_calls": [{
                            "index": ci, "function": {"arguments": tc["function"]["arguments"]},
                        }]}, "finish_reason": None})
                    finish = "tool_calls"
                elif text:
                    yield content_chunk(text, stashed)
                    stashed = []
                yield chat_chunk({"index": 0, "delta": {}, "finish_reason": finish})
                if include_usage:
                    yield chat_chunk(None, usage={
                        "prompt_tokens": request.prompt_len,
                        "completion_tokens": request.produced,
                        "total_tokens": request.prompt_len + request.produced})
                yield "data: [DONE]\n\n"
            finally:
                # on completion and on a client disconnect: free the slot,
                # then report the stream's stats
                request.cancel()
                self._report_gen_stats(request, collect_fn)

        return StreamingOutput(sse())

    def _check_token_ids(self, ids: List[int]) -> List[int]:
        vocab = (self.engine.model.vocab_size if self.engine is not None
                 else self.encoder.vocab_size)
        for t in ids:
            if not 0 <= int(t) < vocab:
                raise ValueError("token id {} out of range for vocab size {}".format(t, vocab))
        return [int(t) for t in ids]

    def _encode_prompts(self, prompt) -> List[List[int]]:
        """The completions ``prompt``: str | [str] | [int] | [[int]]; token
        ids pass through, range-checked."""
        if isinstance(prompt, str):
            return [self.tokenizer.encode(prompt)]
        if isinstance(prompt, list):
            if not prompt:
                return [self.tokenizer.encode("")]
            if all(isinstance(p, int) for p in prompt):
                return [self._check_token_ids(prompt)]
            if all(isinstance(p, list) for p in prompt):
                return [self._check_token_ids(p) for p in prompt]
            return [self.tokenizer.encode(str(p)) for p in prompt]
        return [self.tokenizer.encode(str(prompt))]

    async def v1_completions(self, body: Dict[str, Any], state: Optional[dict] = None,
                             collect_fn=None):
        """A response dict, or a ``StreamingOutput`` of SSE lines when
        ``stream`` is set (one prompt; validated before the first line)."""
        self._require_engine("v1/completions")
        self._check_fields(body, COMPLETION_FIELDS)
        if body.get("suffix") is not None:
            # fill-in-middle needs a FIM template: refused, as vLLM does,
            # before any tokenization
            raise ValueError("suffix is not supported (no fill-in-middle template)")
        prompt_id_lists = self._encode_prompts(body.get("prompt") or "")
        stops = self._stops_from_body(body)
        model = body.get("model", self._model_name)
        completion_id = _gen_id("cmpl")
        created = _now()
        plp_n = self._prompt_logprobs_n(body)  # validated before any device work
        if body.get("stream") and plp_n is not None:
            raise ValueError("prompt_logprobs is not supported with streaming")
        raw_max = body.get("max_tokens", body.get("max_completion_tokens"))
        if raw_max is not None and int(raw_max) == 0:
            # the prompt-scoring call: nothing generated
            return await self._zero_completion(body, prompt_id_lists, model, completion_id,
                                               created, collect_fn, plp_n)
        echo = bool(body.get("echo"))
        if body.get("stream"):
            return await self._stream_completion(body, prompt_id_lists, stops, model,
                                                 completion_id, created, echo, collect_fn)

        # n choices per prompt (choice index prompt-major); best_of
        # candidates per prompt, the top n by cumulative logprob returned,
        # every candidate billed
        n = int(body.get("n", 1) or 1)
        best_of = int(body.get("best_of") or n)
        if best_of < n:
            raise ValueError("best_of must be >= n")
        cand_body = dict(body, n=best_of) if best_of != n else body
        requests: List[GenRequest] = []
        for ids in prompt_id_lists:
            requests.extend(self._n_requests(cand_body, ids, chat=False))
        # ranking needs the chosen logprobs: collected internally when the
        # client asked for none, and left out of the reply
        lp_internal = best_of != n and requests[0].logprobs is None
        if lp_internal:
            for r in requests:
                r.logprobs = 0
        # the warmup first, as the reference's routes await it: a fleet's
        # ring admits no replica before its warmup gate opened
        await self._ensure_warm()
        self._admit_all(requests)
        results = await asyncio.gather(*[self._collect_text(r, stops) for r in requests])
        for r in requests:
            self._report_gen_stats(r, collect_fn)
        if best_of != n:
            def cumulative_lp(i: int) -> float:
                # +1 keeps the finishing token's entry (EOS is stripped from
                # ids), as vLLM's cumulative_logprob does
                ents = requests[i].logprob_entries[: len(results[i]["ids"]) + 1]
                return sum(e["logprob"] for e in ents)

            sel: List[int] = []
            for p in range(len(prompt_id_lists)):
                grp = sorted(range(p * best_of, (p + 1) * best_of), key=cumulative_lp,
                             reverse=True)
                sel.extend(grp[:n])
        else:
            sel = list(range(len(requests)))
        # echo + logprobs and prompt_logprobs share one scoring pass per
        # prompt, off the event loop
        echo_lp: Dict[int, Any] = {}
        plp: Dict[int, Any] = {}
        want_echo_lp = echo and requests[0].logprobs is not None and not lp_internal
        if want_echo_lp or plp_n is not None:
            def build_payloads(ids, req0):
                entries = self.engine.score_prompt(ids)
                e = self._echo_prompt_logprobs(ids, req0, entries=entries) if want_echo_lp \
                    else None
                q = (self._prompt_logprobs_payload(ids, plp_n, entries=entries)
                     if plp_n is not None else None)
                return e, q

            for p, ids in enumerate(prompt_id_lists):
                e, q = await asyncio.to_thread(build_payloads, ids, requests[p * best_of])
                if e is not None:
                    echo_lp[p] = e
                if q is not None:
                    plp[p] = q
        choices = []
        for i, idx in enumerate(sel):
            r, res = requests[idx], results[idx]
            choice = {
                "index": i,
                "text": res["text"],
                "finish_reason": res["finish_reason"],
                "logprobs": (self._completion_logprobs(r, res["ids"])
                             if r.logprobs is not None and not lp_internal else None),
            }
            if idx // best_of in plp:
                choice["prompt_logprobs"] = plp[idx // best_of]
            if echo:
                choice["text"] = self.tokenizer.decode(r.prompt_ids) + res["text"]
                if idx // best_of in echo_lp:
                    lp0, off = echo_lp[idx // best_of]
                    lp = {k2: list(v2) for k2, v2 in lp0.items()}
                    gen_lp, _ = self._completion_lp_entries(
                        r.logprob_entries[: len(res["ids"])], int(r.logprobs or 0),
                        offset=off, as_ids=getattr(r, "tokens_as_ids", False))
                    for key in ("tokens", "token_logprobs", "top_logprobs", "text_offset"):
                        lp[key].extend(gen_lp[key])
                    choice["logprobs"] = lp
            choices.append(choice)
        prompt_tokens = sum(len(ids) for ids in prompt_id_lists)
        completion_tokens = sum(r.produced for r in requests)
        return {
            "id": completion_id,
            "object": "text_completion",
            "created": created,
            "model": model,
            "choices": choices,
            "usage": {"prompt_tokens": prompt_tokens, "completion_tokens": completion_tokens,
                      "total_tokens": prompt_tokens + completion_tokens},
        }

    async def _stream_completion(self, body, prompt_id_lists, stops, model, completion_id,
                                 created, echo: bool, collect_fn):
        """Streamed completions of one prompt with n choices; ``echo`` leads
        each choice with the prompt text (and its scored entries)."""
        if len(prompt_id_lists) != 1:
            raise ValueError("streaming completions support a single prompt per request")
        stream_n = int(body.get("n", 1) or 1)
        if body.get("best_of") is not None and int(body["best_of"]) != stream_n:
            # which candidate to emit is known only at the end
            raise ValueError("best_of must equal n when streaming")
        requests = self._n_requests(body, prompt_id_lists[0], chat=False)
        # the warmup first, as the reference's routes await it: a fleet's
        # ring admits no replica before its warmup gate opened
        await self._ensure_warm()
        self._admit_all(requests)
        include_usage = bool((body.get("stream_options") or {}).get("include_usage"))

        def cmpl_chunk(choices, usage="omit") -> str:
            chunk = {"id": completion_id, "object": "text_completion", "created": created,
                     "model": model, "choices": choices}
            if include_usage:
                chunk["usage"] = None if usage == "omit" else usage
            return "data: {}\n\n".format(json.dumps(chunk))

        lp_offsets = [0] * stream_n

        def cmpl_delta(i, req, piece):
            choice = {"index": i, "text": piece["delta"], "finish_reason": None}
            if piece.get("entries") is not None:
                lp, lp_offsets[i] = self._completion_lp_entries(
                    piece["entries"], int(req.logprobs or 0), offset=lp_offsets[i],
                    as_ids=getattr(req, "tokens_as_ids", False))
                choice["logprobs"] = lp
            return cmpl_chunk([choice])

        def cmpl_finish(i, req):
            return cmpl_chunk([{"index": i, "text": "",
                                "finish_reason": self._finish_reason(req)}])

        def cmpl_usage():
            if not include_usage:
                return None
            total = sum(r.produced for r in requests)
            return cmpl_chunk([], usage={
                "prompt_tokens": requests[0].prompt_len, "completion_tokens": total,
                "total_tokens": requests[0].prompt_len + total})

        async def sse():
            head = []
            if echo:
                prompt_text = self.tokenizer.decode(prompt_id_lists[0])
                echo_lp = None
                if requests[0].logprobs is not None:
                    echo_lp, off = await asyncio.to_thread(
                        self._echo_prompt_logprobs, prompt_id_lists[0], requests[0])
                    lp_offsets[:] = [off] * stream_n
                for i in range(stream_n):
                    first = {"index": i, "text": prompt_text, "finish_reason": None}
                    if echo_lp is not None:
                        first["logprobs"] = {k: list(v) for k, v in echo_lp.items()}
                    head.append(cmpl_chunk([first]))
            async for chunk in self._fanout_stream(requests, stops, collect_fn, head=head,
                                                   delta=cmpl_delta, finish=cmpl_finish,
                                                   usage=cmpl_usage):
                yield chunk

        return StreamingOutput(sse())

    async def _zero_completion(self, body, prompt_id_lists, model, completion_id, created,
                               collect_fn=None, plp_n=None):
        """``max_tokens: 0`` completions: nothing is generated; ``echo`` +
        ``logprobs`` and ``prompt_logprobs`` still apply (one scoring pass
        per prompt, off the event loop). The canonical prompt-scoring
        call."""
        echo = bool(body.get("echo"))
        n = int(body.get("n", 1) or 1)
        if n < 1:
            raise ValueError("n must be >= 1")
        choices = []
        for ids in prompt_id_lists:
            if not ids:
                raise ValueError("prompt must not be empty")
            # a probe runs the validation every generating path runs
            probe = self._gen_request_from_body(body, list(ids), chat=False)
            probe.max_new_tokens = 1
            probe.prompt_len = len(ids)
            self.engine.validate(probe)
            text = self.tokenizer.decode(ids) if echo else ""
            lp = None
            plp_payload = None
            if (probe.logprobs is not None and echo) or plp_n is not None:
                def build_payloads(ids=ids, probe=probe):
                    entries = self.engine.score_prompt(ids)
                    e = (self._echo_prompt_logprobs(ids, probe, entries=entries)
                         if probe.logprobs is not None and echo else None)
                    q = (self._prompt_logprobs_payload(ids, plp_n, entries=entries)
                         if plp_n is not None else None)
                    return e, q

                e, plp_payload = await asyncio.to_thread(build_payloads)
                if e is not None:
                    lp = e[0]
            if probe.logprobs is not None and lp is None:
                # logprobs without echo: nothing generated, an empty block
                lp = {"tokens": [], "token_logprobs": [], "top_logprobs": [],
                      "text_offset": []}
            for _ in range(n):
                choice = {"index": len(choices), "text": text, "finish_reason": "length",
                          "logprobs": dict(lp) if lp is not None else None}
                if plp_payload is not None:
                    choice["prompt_logprobs"] = plp_payload
                choices.append(choice)
        if collect_fn is not None:
            collect_fn({"gen_tokens": 0,
                        "prompt_tokens": sum(len(i) for i in prompt_id_lists)})
        prompt_tokens = sum(len(i) for i in prompt_id_lists)
        out = {
            "id": completion_id,
            "object": "text_completion",
            "created": created,
            "model": model,
            "choices": choices,
            "usage": {"prompt_tokens": prompt_tokens, "completion_tokens": 0,
                      "total_tokens": prompt_tokens},
        }
        if not body.get("stream"):
            return out
        include_usage = bool((body.get("stream_options") or {}).get("include_usage"))

        async def sse():
            for ch in choices:
                chunk = {"id": completion_id, "object": "text_completion", "created": created,
                         "model": model, "choices": [ch]}
                if include_usage:
                    chunk["usage"] = None
                yield "data: {}\n\n".format(json.dumps(chunk))
            if include_usage:
                yield "data: {}\n\n".format(json.dumps({
                    "id": completion_id, "object": "text_completion", "created": created,
                    "model": model, "choices": [], "usage": out["usage"]}))
            yield "data: [DONE]\n\n"

        return StreamingOutput(sse())

    async def v1_models(self, body: Dict[str, Any], state: Optional[dict] = None,
                        collect_fn=None) -> Dict[str, Any]:
        return {"object": "list", "data": [{
            "id": self._model_name, "object": "model", "created": _now(),
            "owned_by": "tpu-serving",
        }]}

    async def version(self, body: Dict[str, Any], state: Optional[dict] = None,
                      collect_fn=None) -> Dict[str, Any]:
        return {"version": __version__}

    async def v1_tokenize(self, body: Dict[str, Any], state: Optional[dict] = None,
                          collect_fn=None) -> Dict[str, Any]:
        ids = self.tokenizer.encode(str(body.get("prompt") or body.get("text") or ""))
        core = self.engine if self.engine is not None else self.encoder
        return {"tokens": ids, "count": len(ids),
                "max_model_len": core.max_seq_len if core is not None else 0}

    async def v1_detokenize(self, body: Dict[str, Any], state: Optional[dict] = None,
                            collect_fn=None) -> Dict[str, Any]:
        ids = body.get("tokens") or []
        return {"prompt": self.tokenizer.decode([int(i) for i in ids])}

    # -- encoder routes (OpenAI embeddings API + vLLM-compatible extensions) --

    async def _encoder_call(self, fn, *args):
        """Run an ``EncoderCore`` call on the encoder's own thread."""
        return await asyncio.get_running_loop().run_in_executor(
            self.encoder.worker, fn, *args)

    def _encode_texts(self, value) -> List[List[int]]:
        """The embeddings ``input``: str | [str] | [int] | [[int]], as the
        completions ``prompt``."""
        return self._encode_prompts(value)

    @staticmethod
    def _format_vec(vec, fmt: str):
        if fmt == "base64":
            import base64

            import numpy as np

            return base64.b64encode(np.asarray(vec, np.float32).tobytes()).decode("ascii")
        return [float(x) for x in vec]

    async def v1_embeddings(self, body: Dict[str, Any], state: Optional[dict] = None,
                            collect_fn=None) -> Dict[str, Any]:
        """OpenAI embeddings: ``encoding_format`` float or base64, and
        ``dimensions`` (the leading dims, renormalized)."""
        self._require_encoder("v1/embeddings")
        id_lists = self._encode_texts(body.get("input") or "")
        fmt = body.get("encoding_format", "float")
        if fmt not in ("float", "base64"):
            raise ValueError("encoding_format must be 'float' or 'base64'")
        dims = body.get("dimensions")
        if dims is not None:
            dims = int(dims)  # type and lower bound before the device forward
            if dims < 1:
                raise ValueError("dimensions must be >= 1")
        vecs = await self._encoder_call(self.encoder.embed, id_lists)
        if dims is not None:
            # matryoshka truncation: keep the leading dims and renormalize,
            # so cosine similarity stays meaningful
            import numpy as np

            full = len(vecs[0]) if len(vecs) else 0
            if full and dims > full:
                raise ValueError("dimensions must be in [1, {}]".format(full))
            out_vecs = []
            for v in vecs:
                t = np.asarray(v, np.float32)[:dims]
                norm = float(np.linalg.norm(t))
                out_vecs.append(t / norm if norm > 0 else t)
            vecs = out_vecs
        n_tokens = sum(len(ids) for ids in id_lists)
        if collect_fn is not None:
            collect_fn({"prompt_tokens": n_tokens, "n_inputs": len(id_lists)})
        return {
            "object": "list",
            "model": body.get("model", self._model_name),
            "data": [
                {"object": "embedding", "index": i, "embedding": self._format_vec(vec, fmt)}
                for i, vec in enumerate(vecs)
            ],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }

    async def v1_pooling(self, body: Dict[str, Any], state: Optional[dict] = None,
                         collect_fn=None) -> Dict[str, Any]:
        """vLLM pooling: per-token hidden states (``return_token_states``)
        or the pooled vector."""
        self._require_encoder("v1/pooling")
        id_lists = self._encode_texts(body.get("input") or "")
        if body.get("return_token_states", False):
            states = await self._encoder_call(self.encoder.token_states, id_lists)
            data = [{"object": "pooling", "index": i, "data": s.tolist()}
                    for i, s in enumerate(states)]
        else:
            vecs = await self._encoder_call(self.encoder.embed, id_lists)
            data = [{"object": "pooling", "index": i, "data": [float(x) for x in v]}
                    for i, v in enumerate(vecs)]
        n_tokens = sum(len(ids) for ids in id_lists)
        if collect_fn is not None:
            collect_fn({"prompt_tokens": n_tokens, "n_inputs": len(id_lists)})
        return {
            "object": "list",
            "model": body.get("model", self._model_name),
            "data": data,
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }

    async def v1_classify(self, body: Dict[str, Any], state: Optional[dict] = None,
                          collect_fn=None) -> Dict[str, Any]:
        """The CLS head's softmax per input, labelled by aux
        ``engine.labels``."""
        import numpy as np

        self._require_encoder("v1/classify")
        id_lists = self._encode_texts(body.get("input") or "")
        logits = await self._encoder_call(self.encoder.classify, id_lists)
        probs = np.exp(logits - logits.max(axis=-1, keepdims=True))
        probs = probs / probs.sum(axis=-1, keepdims=True)
        labels = self.endpoint_labels()
        data = []
        for i in range(len(id_lists)):
            idx = int(np.argmax(probs[i]))
            data.append({
                "index": i,
                "label": labels[idx] if idx < len(labels) else str(idx),
                "probs": [float(p) for p in probs[i]],
                "num_classes": int(probs.shape[-1]),
            })
        n_tokens = sum(len(ids) for ids in id_lists)
        if collect_fn is not None:
            collect_fn({"prompt_tokens": n_tokens, "n_inputs": len(id_lists)})
        return {
            "object": "list",
            "model": body.get("model", self._model_name),
            "data": data,
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }

    def endpoint_labels(self) -> List[str]:
        aux = self.endpoint.auxiliary_cfg if isinstance(self.endpoint.auxiliary_cfg, dict) else {}
        return list((aux.get("engine") or {}).get("labels") or [])

    def _score_pairs_body(self, body: Dict[str, Any]):
        t1, t2 = body.get("text_1"), body.get("text_2")
        if t1 is None or t2 is None:
            raise ValueError("score requests need text_1 and text_2")
        list1 = t1 if isinstance(t1, list) else [t1]
        list2 = t2 if isinstance(t2, list) else [t2]
        if len(list1) == 1 and len(list2) > 1:
            list1 = list1 * len(list2)
        if len(list2) == 1 and len(list1) > 1:
            list2 = list2 * len(list1)
        if len(list1) != len(list2):
            raise ValueError("text_1/text_2 lengths do not broadcast")
        # cross-encoder: segments encoded bare (EncoderCore joins the pair);
        # bi-encoder: full encodes
        bare = self.encoder.is_cross_encoder
        return [(self.tokenizer.encode(str(a), add_bos=not bare),
                 self.tokenizer.encode(str(b), add_bos=not bare))
                for a, b in zip(list1, list2)]

    async def v1_score(self, body: Dict[str, Any], state: Optional[dict] = None,
                       collect_fn=None) -> Dict[str, Any]:
        """vLLM score: the pairwise relevance of text_1 x text_2."""
        self._require_encoder("v1/score")
        pairs = self._score_pairs_body(body)
        scores = await self._encoder_call(self.encoder.score_pairs, pairs)
        n_tokens = sum(len(a) + len(b) for a, b in pairs)
        if collect_fn is not None:
            collect_fn({"prompt_tokens": n_tokens, "n_inputs": len(pairs)})
        return {
            "object": "list",
            "model": body.get("model", self._model_name),
            "data": [{"object": "score", "index": i, "score": sc}
                     for i, sc in enumerate(scores)],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }

    async def v1_rerank(self, body: Dict[str, Any], state: Optional[dict] = None,
                        collect_fn=None) -> Dict[str, Any]:
        """Jina/Cohere-compatible rerank: each document scored against the
        query, the ``top_n`` best first."""
        self._require_encoder("v1/rerank")
        query = body.get("query")
        documents = body.get("documents") or []
        if query is None or not documents:
            raise ValueError("rerank requests need query and documents")
        doc_texts = []
        for i, d in enumerate(documents):
            if isinstance(d, dict):
                text = d.get("text", d.get("content"))
                if not isinstance(text, str):
                    raise ValueError("documents[{}] needs a string 'text' field".format(i))
                doc_texts.append(text)
            else:
                doc_texts.append(str(d))
        bare = self.encoder.is_cross_encoder
        q_ids = self.tokenizer.encode(str(query), add_bos=not bare)
        doc_ids = [self.tokenizer.encode(t, add_bos=not bare) for t in doc_texts]
        scores = await self._encoder_call(self.encoder.rerank, q_ids, doc_ids)
        order = sorted(range(len(scores)), key=lambda i: scores[i], reverse=True)
        top_n = int(body.get("top_n") or len(order))
        results = [{"index": i, "document": {"text": doc_texts[i]},
                    "relevance_score": scores[i]} for i in order[:top_n]]
        n_tokens = len(q_ids) + sum(len(d) for d in doc_ids)
        if collect_fn is not None:
            collect_fn({"prompt_tokens": n_tokens, "n_inputs": len(doc_ids)})
        return {
            "id": _gen_id("rerank"),
            "model": body.get("model", self._model_name),
            "results": results,
            "usage": {"total_tokens": n_tokens},
        }

    # -- audio routes (OpenAI transcription API; whisper-family bundles) ------

    def _require_audio(self, route: str) -> None:
        if self.audio is None:
            raise EndpointModelError(
                "model {!r} does not support {} (serve a speech bundle — "
                "arch 'whisper' — on this endpoint)".format(self._model_name, route))

    def _audio_pcm(self, body: Dict[str, Any]):
        from ..ops.audio import decode_wav

        data = body.get("file")
        if isinstance(data, str):
            import base64

            try:
                data = base64.b64decode(data)
            except Exception:
                raise ValueError("'file' must be WAV bytes or base64-encoded WAV")
        if not isinstance(data, (bytes, bytearray)):
            raise ValueError(
                "audio requests need a 'file' field (multipart upload or "
                "base64 WAV in JSON)")
        return decode_wav(bytes(data), target_rate=self.audio.sampling_rate)

    async def _audio_route(self, body, collect_fn, task: str, route: str):
        """The reference's ``_audio_route``: windows through the core's
        micro-batcher, the text without timestamp markers, and the
        ``verbose_json`` segments and words."""
        self._require_audio(route)
        pcm = self._audio_pcm(body)
        duration = round(len(pcm) / self.audio.sampling_rate, 3)
        verbose = body.get("response_format") == "verbose_json"
        # verbose_json decodes with timestamp conditioning (segments need the
        # marker tokens); the plain paths keep the <|notimestamps|> prompt.
        # A bundle without the timestamp vocabulary answers text-only
        # verbose output.
        with_ts = verbose and self.audio.timestamp_begin is not None
        windows = await self.audio.transcribe_windows_async(pcm, task, timestamps=with_ts)
        ids = [t for w in windows for t in w]
        ts_begin = self.audio.timestamp_begin
        text_ids = [t for t in ids if t < ts_begin] if ts_begin is not None else ids
        text = self.tokenizer.decode(text_ids)
        if collect_fn is not None:
            collect_fn({"gen_tokens": len(ids), "audio_seconds": duration})
        if body.get("response_format") == "text":
            from ..serving.responses import TextOutput

            return TextOutput(text)
        out = {"text": text}
        if verbose:
            out.update(task=task, duration=duration, language=body.get("language"))
            if with_ts:
                segments = self.audio.parse_segments(windows, duration)
                for seg in segments:
                    seg["text"] = self.tokenizer.decode(seg["tokens"])
                granularities = body.get("timestamp_granularities") or ["segment"]
                if isinstance(granularities, str):
                    granularities = [granularities]
                if "segment" in granularities:
                    out["segments"] = segments
                if "word" in granularities:
                    # DTW over the cross-attention alignment heads; the
                    # proportional interpolation only when the bundle lacks
                    # the alignment surface or the DTW pass fails
                    words = None
                    try:
                        words = await asyncio.to_thread(
                            self.audio.words_dtw, pcm, windows, self.tokenizer, task)
                    except Exception:
                        # a degraded word timing leaves a signal: a silent
                        # fallback would hide a DTW pass that keeps failing
                        logging.getLogger(__name__).warning(
                            "word-timestamp DTW failed; falling back to "
                            "proportional interpolation", exc_info=True)
                    out["words"] = (words if words is not None
                                    else self.audio.words_from_segments(segments))
        return out

    async def v1_audio_transcriptions(self, body, state=None, collect_fn=None):
        return await self._audio_route(
            body or {}, collect_fn, "transcribe", "v1/audio/transcriptions")

    async def v1_audio_translations(self, body, state=None, collect_fn=None):
        return await self._audio_route(
            body or {}, collect_fn, "translate", "v1/audio/translations")

    # -- phases ----------------------------------------------------------------

    async def preprocess(self, body: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "preprocess"):
            out = self._preprocess.preprocess(body, state, collect_fn)
            if asyncio.iscoroutine(out):
                out = await out
            return out
        return body

    async def process(self, data: Any, state: dict, collect_fn=None) -> Any:
        """A plain ``POST /serve/<endpoint>``: a non-streaming chat
        completion (a body with ``stream`` streams), or embeddings on an
        encoder endpoint."""
        if self.engine is None and self.encoder is not None:
            return await self.v1_embeddings(data or {}, state, collect_fn)
        return await self.v1_chat_completions(data or {}, state, collect_fn)

    async def postprocess(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "postprocess"):
            out = self._preprocess.postprocess(data, state, collect_fn)
            if asyncio.iscoroutine(out):
                out = await out
            return out
        return data


def _sse_error(ex: BaseException) -> str:
    return "data: {}\n\n".format(json.dumps(
        {"error": {"message": str(ex), "type": type(ex).__name__}}))
