"""Continuous-batching LLM engine over the paged KV cache.

Counterpart of ``clearml_serving_tpu/llm/engine.py``'s ``LLMEngineCore`` in
the configuration ``cache_mode="paged"``, under either scheduler:

- a fixed ``max_batch`` of slots; FIFO admission into free slots;
- decode = chunks of ``decode_steps`` fused steps over the whole slot batch,
  each step ``Llama.decode_paged`` (the paged attention kernel once per
  layer) followed by sampling (``llm/decode_graph.py``); the chunk's tokens
  reach the host once, at its end, and fan out to the per-request queues;
- a request finishes on a stop token, ``max_new_tokens`` or
  ``max_seq_len``; its pages return to the pool once no chunk in flight
  still writes them.

Pipelined decode (the reference's ``docs/pipelined_decode.md``): a bounded
queue of dispatched chunks, ``pipeline_depth`` deep (``TPUSERVE_PIPELINE_DEPTH``,
default 2). Each step overlaps the oldest chunk's retirement (readback and
emission) with the next chunk's dispatch, whose token input chains on the
device from the chunk before it. A slot freed at a retire stays quarantined,
its pages unfreed, until every chunk dispatched before that retire has
retired; a request certain to finish inside the chunks in flight is left out
of the next dispatch. On the card each chunk is one CUDA-graph replay
(``DecodeGraphs``, captured by ``warmup()`` or at a chunk's first use of its
variant), at every depth; depth 1 is the serial loop, dispatch -> sync ->
emit. ``cuda_graphs=False`` launches a chunk's kernels one by one from
Python instead: the eager arm that the card's checks hold the graphs
against. On the CPU the worker thread carries the compute.

``scheduler="two_dispatch"``: admission = one prefill of the prompt padded
to its bucket, its K/V written into freshly allocated pages, and the first
token sampled from the last prompt position (emitted at once: the client's
first token).

``scheduler="ragged"``: admission opens a job instead of running a prefill.
While jobs exist, each step is ONE mixed launch (``Llama.forward_ragged``,
the ragged attention kernel once per layer): every decode row with a
multi-step window (``ragged_decode_steps``, widened from the budget left
over) and prefill-chunk rows that share ``step_token_budget`` tokens in
admission order. A decode row's window chains ``decode_paged`` steps after
the mixed pass in the same step; a job's final chunk samples the first
token and activates its slot. With no jobs left, decode chunks resume.

``speculation="ngram"`` (ragged scheduler only): eligible decode slots
(greedy, or sampled with ``spec_sampling``) ride the mixed launches as
verify rows of q = ``spec_k``+1 tokens, the pending token and k drafts
proposed from the slot's own history (``llm/spec_proposer.py``); ragged
steps then run even without admissions. A chain row is plain causal; with
``spec_tree`` the drafts form a forest of up to ``spec_branch`` root
continuations and each node attends its ancestor path only (the kernel's
``tree_anc`` mask). Acceptance (greedy argmax match, or rejection sampling
for sampled rows) runs on the device in the same step; a tree row's
accepted nodes have their K/V moved to their path depths, and the retire
truncates each verify row to what it kept before emitting it.

Device work runs in worker threads, on one CUDA stream, so the event loop
keeps serving HTTP while the card computes. The model arrives with its
weights already in their serving format (``build_engine`` quantizes them);
``weight_quant``/``quantize`` are accepted when they name that format.
Every reference knob this slice does not serve raises, naming itself.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncIterator, Deque, Dict, List, Optional

import numpy as np
import torch

from ..models.llama import Llama
from ..ops.gates import check_engine_gates
from ..ops.paged_attention import RAGGED_QB, ragged_layout, tree_ancestors
from .decode_graph import ChunkLayout, DecodeGraphs, run_chunk
from .kv_cache import PagedKVCache
from .sampling import (
    SamplingParams,
    greedy_tree_walk,
    gumbel_noise,
    sample_tokens,
    speculative_sample_chain,
    speculative_sample_tree,
)
from .spec_proposer import chain_parents, make_proposer
from . import shapes

logger = logging.getLogger(__name__)


class EngineUnavailableError(RuntimeError):
    """The engine is stopped (or its loop died): no request is served."""


@dataclass
class GenRequest:
    """One generation request (the reference's ``GenRequest`` fields that
    this slice serves)."""

    prompt_ids: List[int]
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # filled by the engine:
    out_queue: "asyncio.Queue" = field(default_factory=asyncio.Queue)
    produced: int = 0
    prompt_len: int = 0
    submitted_at: float = field(default_factory=time.time)
    first_token_at: Optional[float] = None
    error: Optional[BaseException] = None
    # set by the API layer when a stop string matched in the decoded text
    stopped_on_string: bool = False
    # set by the consumer (client gone): the engine frees the slot at the
    # next emission instead of decoding to max_new_tokens for nobody
    cancelled: bool = False

    def cancel(self) -> None:
        self.cancelled = True


_FINISHED = object()

# chunks dispatched ahead of retirement: 1 is the serial dispatch -> sync ->
# emit loop; 2 (the reference's default) overlaps chunk N's readback and
# emission with chunk N+1's dispatch
_DEFAULT_PIPELINE_DEPTH = 2
# the reference's _MsHistogram buckets (ms)
_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0)


def _env_pipeline_depth() -> int:
    raw = os.environ.get("TPUSERVE_PIPELINE_DEPTH", "")
    try:
        return max(1, int(raw)) if raw else _DEFAULT_PIPELINE_DEPTH
    except ValueError:
        return _DEFAULT_PIPELINE_DEPTH


@dataclass
class _InFlightChunk:
    """One dispatched-but-unretired decode chunk. ``tokens`` [B, steps]
    int32 lies on the host: on the card a pinned buffer that an
    asynchronous copy fills, complete once ``ready`` (a CUDA event) is;
    on the CPU the dispatch computed it. ``active_mask`` is the host
    snapshot the dispatch was built from: the retire stage emits exactly
    those slots."""

    seq: int
    active_mask: np.ndarray
    tokens: torch.Tensor
    ready: Optional["torch.cuda.Event"] = None
    # slots dropped from this chunk because the pool could not hold their
    # page extension (failed when the chunk lands)
    exhausted: List[int] = field(default_factory=list)


@dataclass(eq=False)  # identity semantics: jobs live in (and leave) lists
class _RaggedJob:
    """One admission riding the ragged scheduler: the request's prompt
    prefills in budget-bounded chunk rows of the loop's launches, writing
    straight into its reserved slot's pages. ``pos`` is the next
    unprefilled prompt index; the slot stays reserved (``_admitting``)
    until the final chunk activates it or a failure frees it."""

    request: GenRequest
    slot: int
    pos: int = 0
    started_at: float = field(default_factory=time.monotonic)


class _Histogram:
    """Fixed-bucket histogram, snapshot in the reference's
    ``_MsHistogram`` shape."""

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        i = next((i for i, edge in enumerate(self.buckets) if value <= edge),
                 len(self.buckets))
        self.counts[i] += 1
        self.total += float(value)
        self.n += 1

    def snapshot(self) -> dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum_ms": self.total, "count": self.n}

# reference engine knobs this slice does not serve (each raises when set)
UNSUPPORTED_KNOBS = (
    "mesh", "long_prefill_threshold",
    "long_bucket_step", "chunked_prefill_size", "prefill_segments_per_decode",
    "prefill_stall_timeout", "lora_adapters",
    "prefix_cache", "prefix_cache_bytes", "prefix_cache_pages",
    "prefix_cache_host_pages", "prefix_cache_host_bytes", "tokenizer",
    "max_pending", "queue_timeout", "ttft_timeout", "total_timeout",
    "watchdog_interval", "brownout", "replica",
)


class LLMEngineCore:
    """Slot-based continuous batching over a paged KV cache."""

    def __init__(
        self,
        model: Llama,
        *,
        max_batch: int = 8,
        max_seq_len: int = 2048,
        prefill_buckets: Optional[List[int]] = None,
        eos_token_id: Optional[int] = None,
        rng_seed: int = 0,
        decode_steps: int = 4,
        cache_mode: str = "paged",
        page_size: int = 16,
        num_pages: Optional[int] = None,
        pipeline_depth: Optional[int] = None,
        scheduler: Optional[str] = "two_dispatch",
        step_token_budget: Optional[int] = None,
        ragged_decode_steps: Optional[int] = None,
        quantize: Optional[str] = None,
        weight_quant: Optional[str] = None,
        speculation: Optional[str] = None,
        spec_k: int = 4,
        spec_ngram: int = 2,
        spec_sampling: bool = True,
        spec_tree: bool = False,
        spec_branch: int = 2,
        cuda_graphs: bool = True,
        **knobs,
    ):
        for name, value in knobs.items():
            if name not in UNSUPPORTED_KNOBS:
                raise TypeError("unknown engine argument {!r}".format(name))
            if value not in (None, False, 0, "", {}, []):
                raise ValueError(
                    "engine knob {}={!r} is not supported by the PyTorch port "
                    "yet".format(name, value)
                )
        if cache_mode != "paged":
            raise ValueError(
                "engine knob cache_mode={!r} is not supported by the PyTorch "
                "port yet (paged only)".format(cache_mode)
            )
        sched = scheduler if scheduler is not None else "two_dispatch"
        if sched not in ("two_dispatch", "ragged"):
            raise ValueError(
                "scheduler must be 'two_dispatch' or 'ragged' (got {!r})".format(sched)
            )
        # weight quantization: the reference's knob checks, against the
        # format the model's weights already have
        if weight_quant and quantize and weight_quant != quantize:
            raise ValueError(
                "weight_quant={!r} conflicts with the legacy quantize={!r} "
                "alias; set only one".format(weight_quant, quantize)
            )
        quantize = weight_quant or quantize
        pre = model.weight_quant
        if quantize and quantize not in ("int8", "int4"):
            raise ValueError(
                "unsupported weight_quant mode {!r} (expected 'int8' or "
                "'int4')".format(quantize)
            )
        if pre and quantize and pre != quantize:
            raise ValueError(
                "weight_quant={!r} requested but the bundle is already "
                "{}-quantized (scripts/quantize_ckpt.py output); drop the "
                "knob or quantize from the original full-precision "
                "checkpoint".format(quantize, pre)
            )
        if quantize and not pre:
            raise ValueError(
                "weight_quant={!r} requested but the model's weights are not "
                "quantized: the PyTorch port quantizes the parameters before "
                "building Llama (ops.quant.quantize_llama_params, or aux "
                "engine.weight_quant through build_engine)".format(quantize)
            )
        self.weight_quant = pre
        self.model = model
        self.device = model.device
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self.eos_token_id = eos_token_id
        self.decode_steps = max(1, int(decode_steps))
        self.cache_mode = "paged"
        # -- ragged scheduling: knobs and validation as in the reference
        self._ragged = sched == "ragged"
        self._step_token_budget = (
            int(step_token_budget) if step_token_budget is not None
            else max(128, 4 * self.max_batch)
        )
        if self._ragged and self._step_token_budget <= self.max_batch:
            # every decode row costs one budget token; a budget at or below
            # max_batch could starve admissions forever
            raise ValueError(
                "step_token_budget ({}) must exceed max_batch ({}) so "
                "prefill chunks always fit beside a full decode batch"
                .format(self._step_token_budget, self.max_batch)
            )
        self._ragged_decode_steps = (
            max(1, int(ragged_decode_steps)) if ragged_decode_steps is not None
            else self.decode_steps
        )
        if self._ragged_decode_steps > self.decode_steps:
            raise ValueError(
                "ragged_decode_steps ({}) must not exceed decode_steps "
                "({}): per-slot KV slack and page-table width are sized "
                "from decode_steps".format(self._ragged_decode_steps, self.decode_steps)
            )
        self._ragged_steps_cap = shapes.decode_steps_bucket(self._ragged_decode_steps)
        # -- speculation: verify rows of the ragged launches, with the
        # reference's knob checks and words
        if speculation:
            if speculation != "ngram":
                raise ValueError("speculation must be 'ngram' (got {!r})".format(speculation))
            if not self._ragged:
                raise ValueError(
                    "speculation={!r} needs scheduler='ragged' in the PyTorch port: "
                    "verify rows ride the ragged launches, and the two-dispatch serial "
                    "speculation scan is not ported yet".format(speculation))
        self._speculation = speculation or None
        self._spec_sampling = bool(spec_sampling)
        self._spec_k = max(1, int(spec_k))
        self._spec_ngram = max(1, int(spec_ngram))
        self._spec_tree = bool(spec_tree)
        if self._spec_tree and not self._speculation:
            raise ValueError(
                "spec_tree needs speculation='ngram' (the tree is a "
                "topology over the n-gram proposer's drafts)"
            )
        self._spec_proposer = None
        if self._speculation:
            self._spec_proposer = (
                make_proposer("ngram-forest", ngram=self._spec_ngram,
                              branch=max(1, int(spec_branch)))
                if self._spec_tree
                else make_proposer("ngram-chain", ngram=self._spec_ngram)
            )
        # per-slot slack sized as the reference's (decode_steps verify rows
        # of k+1 tokens); the table width and default pool cover it
        spec_slack = self.decode_steps * (self._spec_k + 1) if self._speculation else 0
        # the flat token axis of one launch: every row's segment aligns to
        # the CUDA kernel's q block (worst case one block of waste per row);
        # the CPU plain version packs rows densely
        self._ragged_qb = RAGGED_QB if self.device.type == "cuda" else 1
        waste = self.max_batch * (self._ragged_qb - 1)
        self._ragged_tpad = (-(-(self._step_token_budget + waste) // self._ragged_qb)
                             * self._ragged_qb)
        self._buckets = shapes.prefill_buckets(prefill_buckets, self.max_seq_len)
        # every slot can hold max_seq_len plus one decode chunk (or the
        # speculation slack); page 0 is the reserved null page
        self._pages_per_seq = -(-(self.max_seq_len + max(self.decode_steps, spec_slack))
                                // int(page_size))
        total_pages = num_pages or (self.max_batch * self._pages_per_seq + 1)
        if self.device.type == "cuda":
            # a configuration outside a kernel's gates fails here, at load,
            # not at every request's first launch
            check_engine_gates(
                page_size=int(page_size), n_kv_heads=model.n_kv_heads,
                head_dim=model.head_dim, group=model.group, dtype=model.dtype,
                kv_dtype=torch.int8 if model.kv_quant else model.dtype, ragged=self._ragged,
                tree_width=self._spec_k + 1 if self._spec_tree else None,
                int4_weights=model.int4_weight_shapes())
        self.paged_cache = PagedKVCache(
            model.n_layers, model.n_kv_heads, model.head_dim,
            num_pages=total_pages, page_size=int(page_size),
            max_slots=self.max_batch, dtype=model.dtype,
            kv_quant=model.kv_quant, device=self.device,
        )
        self._gen = torch.Generator(self.device)
        self._gen.manual_seed(int(rng_seed))
        # -- pipelined decode: the bounded in-flight queue, the slot-reuse
        # barrier and the device-resident token chain
        self.pipeline_depth = (max(1, int(pipeline_depth)) if pipeline_depth is not None
                               else _env_pipeline_depth())
        self._inflight: Deque[_InFlightChunk] = deque()
        self._dispatch_seq = 0
        # (seq, active_mask) of a chunk whose worker-thread dispatch is in
        # progress: the barrier must see it, since the concurrent retire
        # stage can free slots
        self._dispatching: Optional[tuple] = None
        # slot -> dispatch seq that must retire before the slot's pages are
        # freed and the slot re-admitted
        self._quarantine: Dict[int, int] = {}
        # slots whose host token must win over the device chain at the next
        # dispatch (fresh admissions; all of them after a chain reset)
        self._slot_overrides = np.ones(self.max_batch, bool)
        self._layout = ChunkLayout(self.max_batch, self._pages_per_seq, self.decode_steps)
        # every worker enqueues on this stream (torch's current stream is
        # per thread), so prefills, chunks and readbacks run in order
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        # on the card each chunk is a CUDA-graph replay unless cuda_graphs
        # is off; the eager arm keeps its chain in _chain
        self._graphs = (DecodeGraphs(model, self.paged_cache, self._layout, self.decode_steps)
                        if self._stream is not None and cuda_graphs else None)
        self._chain = torch.zeros(self.max_batch, dtype=torch.int32, device=self.device)
        self._warming = False
        self._hist_dispatch = _Histogram(_MS_BUCKETS)
        self._hist_retire = _Histogram(_MS_BUCKETS)
        # slot bookkeeping (loop thread)
        self._slot_req: List[Optional[GenRequest]] = [None] * self.max_batch
        self._next_token = np.zeros(self.max_batch, np.int32)
        self._temperature = np.zeros(self.max_batch, np.float32)
        self._top_k = np.zeros(self.max_batch, np.int32)
        self._top_p = np.ones(self.max_batch, np.float32)
        # speculation history: each slot's prompt and every emitted token
        # (the proposer's input), filled at activation and ragged retires
        self._tokbuf = (np.zeros((self.max_batch, self.max_seq_len + spec_slack + 1), np.int32)
                        if self._speculation else None)
        self._pending: Deque[GenRequest] = deque()
        self._loop_task: Optional[asyncio.Task] = None
        self._stopped = False
        # ragged scheduler: in-progress chunked admissions in admission
        # order, and the slots they reserve (loop thread)
        self._prefill_jobs: List[_RaggedJob] = []
        self._admitting: set = set()
        # observability: decode steps dispatched (each = one decode_paged
        # call, so n_layers paged-attention launches), chunks, prefills, the
        # loop's wall time in decode steps (dispatch and retire, overlapped
        # at depth > 1) and the prefills' host time (each ends in a read);
        # CUDA-graph captures, replays, and the captures a dispatch made
        # while serving (none once warmup() has captured every variant);
        # ragged steps (each = one forward_ragged call, n_layers ragged
        # attention launches), the decode tokens they emitted and their
        # chained decode_paged calls, and the ragged steps whose launch
        # carried verify rows (on tree engines, each launches the ragged
        # kernel's tree variant once per layer)
        self.counters = {"decode_steps": 0, "decode_chunks": 0, "prefills": 0,
                         "tokens_emitted": 0, "decode_ms": 0.0, "prefill_ms": 0.0,
                         "ragged_steps": 0, "ragged_decode_tokens": 0,
                         "ragged_chain_steps": 0, "ragged_verify_steps": 0,
                         "ragged_ms": 0.0, "graph_captures": 0, "graph_replays": 0,
                         "serve_captures": 0}
        # rows per phase over all ragged launches, budget use per launch,
        # decode tokens per launch, the mean accepted-draft fraction of a
        # launch's verify rows and a tree row's accepted path depth (the
        # reference's lifecycle "ragged" block)
        self.step_rows = {"prefill": 0, "decode": 0, "spec_verify": 0}
        self._hist_budget = _Histogram((0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
        self._hist_launch_tokens = _Histogram((1, 2, 4, 8, 16, 32, 64))
        self._hist_spec_accept = _Histogram((0.0, 0.2, 0.4, 0.6, 0.8, 1.0))
        self._hist_spec_tree_depth = _Histogram((0, 1, 2, 3, 4, 8, 16))
        # time to first token of recent requests, submission to emission (ms)
        self.ttft_ms: Deque[float] = deque(maxlen=1024)

    # -- request surface -----------------------------------------------------

    def validate(self, request: GenRequest) -> None:
        """Raises ValueError for inadmissible requests. Streaming callers
        call this before sending response headers."""
        if not request.prompt_ids:
            raise ValueError("empty prompt")
        if len(request.prompt_ids) >= self.max_seq_len:
            raise ValueError(
                "prompt length {} exceeds engine max_seq_len {}".format(
                    len(request.prompt_ids), self.max_seq_len
                )
            )
        if request.max_new_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        vocab = self.model.vocab_size
        if any(not 0 <= int(t) < vocab for t in request.prompt_ids):
            raise ValueError("prompt token id out of range for vocab {}".format(vocab))

    async def generate(self, request: GenRequest) -> AsyncIterator[int]:
        """Submit a request; yields sampled token ids as they decode."""
        if self._stopped:
            raise EngineUnavailableError("engine is stopped")
        self.validate(request)
        request.prompt_len = len(request.prompt_ids)
        request.out_queue = asyncio.Queue()
        self._pending.append(request)
        self._ensure_loop()
        try:
            while True:
                token = await request.out_queue.get()
                if token is _FINISHED:
                    if request.error is not None:
                        raise request.error
                    return
                yield token
        finally:
            # consumer stopped early: the engine frees the slot at its next
            # emission point (no-op after a normal finish)
            request.cancelled = True

    async def warmup(self) -> dict:
        """Serve the warmup sweep (``llm/warmup.py``) before traffic: every
        prefill bucket's first use, and one decode chunk of each CUDA-graph
        variant, which captures it. Captures after this count in
        ``counters["serve_captures"]``."""
        from . import warmup as _warmup

        return await _warmup.run_warmup(self)

    def stop(self) -> None:
        """Stop the loop and fail every active and pending request."""
        self._stopped = True
        err = EngineUnavailableError("engine stopped")
        for slot, request in enumerate(self._slot_req):
            if request is not None:
                self._fail_slot(slot, err)
        for job in list(self._prefill_jobs):
            self._fail_ragged_job(job, err)
        while self._pending:
            request = self._pending.popleft()
            request.error = err
            request.out_queue.put_nowait(_FINISHED)

    @property
    def active_slots(self) -> int:
        return sum(1 for r in self._slot_req if r is not None)

    def health(self) -> dict:
        return {
            "ready": not self._stopped,
            "cache": self.cache_mode,
            "device": str(self.device),
            "active_slots": self.active_slots,
            "max_batch": self.max_batch,
            "pending": len(self._pending),
            "free_pages": self.paged_cache.pool.free_pages,
            "kv_dtype": self.paged_cache.pool_dtype,
            "kv_pool_bytes": self.paged_cache.pool_bytes(),
            "weights": {
                "quant": self.weight_quant or "none",
                "bytes": self.model.weight_bytes(),
            },
            "counters": dict(self.counters),
            "pipeline": self._pipeline_snapshot(),
            "scheduler": "ragged" if self._ragged else "two_dispatch",
            "ragged": (
                {
                    "step_token_budget": self._step_token_budget,
                    "effective_budget": self._step_token_budget,
                    "prefill_jobs": len(self._prefill_jobs),
                    "steps": self.counters["ragged_steps"],
                    "budget_utilization": self._hist_budget.snapshot(),
                    "step_rows": dict(self.step_rows),
                    "decode_steps": self._ragged_decode_steps,
                    "decode_tokens": self.counters["ragged_decode_tokens"],
                    "tokens_per_launch": self._hist_launch_tokens.snapshot(),
                    "spec_acceptance": self._hist_spec_accept.snapshot(),
                    "spec_tree_depth": (self._hist_spec_tree_depth.snapshot()
                                        if self._spec_tree else None),
                    "spec_proposer": (
                        dict(self._spec_proposer.stats(), name=self._spec_proposer.name)
                        if self._spec_proposer is not None else None
                    ),
                }
                if self._ragged
                else None
            ),
        }

    def _pipeline_snapshot(self) -> dict:
        return {
            "depth": self.pipeline_depth,
            "inflight": len(self._inflight),
            "dispatch_ms": self._hist_dispatch.snapshot(),
            "retire_ms": self._hist_retire.snapshot(),
        }

    def lifecycle_stats(self) -> dict:
        """Scrape-time snapshot, the reference's ``lifecycle_stats`` keys
        this slice serves (counters monotonic, gauges instantaneous)."""
        return {
            "queue_depth": len(self._pending),
            "active_slots": self.active_slots,
            "ready": int(not self._stopped),
            "pipeline": self._pipeline_snapshot(),
            "scheduler": "ragged" if self._ragged else "two_dispatch",
        }

    async def wait_drained(self, timeout: float = 30.0) -> None:
        """Await the loop going idle (no active slots, nothing pending)."""
        task = self._loop_task
        if task is not None and not task.done():
            await asyncio.wait_for(asyncio.shield(task), timeout)

    # -- loop ----------------------------------------------------------------

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(self._run_loop())

    async def _run_loop(self) -> None:
        try:
            while not self._stopped:
                if self._ragged:
                    self._ragged_admission()
                else:
                    await self._admit()
                active = np.array([r is not None for r in self._slot_req])
                if not active.any() and not self._inflight and not self._prefill_jobs:
                    if not self._pending:
                        return  # drained; a new generate() restarts the loop
                    continue
                try:
                    if self._prefill_jobs or self._ragged_spec_wanted(active):
                        # ragged phase: one mixed launch per step while
                        # admissions are in progress or verify rows want
                        # to run. The pipeline drains first, one chunk per
                        # iteration, so the host mirrors the plan reads
                        # are current
                        if self._inflight:
                            await self._retire_oldest()
                        else:
                            await self._ragged_step(active)
                    else:
                        await self._decode_step(active)
                except Exception as ex:
                    await self._handle_step_failure(ex)
                await asyncio.sleep(0)  # let HTTP handlers interleave
            # stopped: wait out the chunks still writing pages, then free them
            await self._discard_pipeline()
        except BaseException as ex:
            for slot, request in enumerate(self._slot_req):
                if request is not None:
                    self._fail_slot(slot, ex)
            for job in list(self._prefill_jobs):
                self._fail_ragged_job(job, ex)
            raise
        finally:
            # the pipeline dies with the loop; after a cancellation its
            # deferred frees run without waiting for the card
            self._drop_pipeline()

    def _on_stream(self, fn, *args):
        """Run ``fn`` on the engine's stream: a worker thread starts on the
        default one."""
        if self._stream is None:
            return fn(*args)
        with torch.cuda.stream(self._stream):
            return fn(*args)

    async def _admit(self) -> None:
        """FIFO admission of pending requests into free slots: prefill,
        pages, first token. A quarantined slot is not free yet."""
        free = [i for i, r in enumerate(self._slot_req)
                if r is None and i not in self._quarantine]
        while free and self._pending and not self._stopped:
            request = self._pending.popleft()
            if request.cancelled:
                request.out_queue.put_nowait(_FINISHED)
                continue
            slot = free.pop(0)
            try:
                first_id = await asyncio.to_thread(
                    self._on_stream, self._prefill_into_slot, request, slot)
            except Exception as ex:
                # a failed admission fails only its own request
                self.paged_cache.pool.free(slot)
                request.error = ex
                request.out_queue.put_nowait(_FINISHED)
                free.insert(0, slot)
                continue
            if self._stopped:  # stop() ran during the prefill
                self.paged_cache.pool.free(slot)
                request.error = EngineUnavailableError("engine stopped")
                request.out_queue.put_nowait(_FINISHED)
                return
            self._activate_slot(request, slot, first_id)

    def _sampling(self) -> SamplingParams:
        dev = self.device
        return SamplingParams(
            temperature=torch.as_tensor(self._temperature, device=dev),
            top_k=torch.as_tensor(self._top_k, device=dev),
            top_p=torch.as_tensor(self._top_p, device=dev),
        )

    def _prefill_into_slot(self, request: GenRequest, slot: int) -> int:
        """Worker thread: prefill the prompt at its bucket, write its K/V into
        the slot's pages, sample the first token."""
        t0 = time.perf_counter()
        ids = request.prompt_ids
        n = len(ids)
        bucket = shapes.bucket_for(n, self._buckets, self.max_seq_len)
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :n] = torch.as_tensor(ids, dtype=torch.long)
        tokens = tokens.to(self.device)
        seq_lens = torch.tensor([n], dtype=torch.int32, device=self.device)
        last, cache = self.model.prefill(tokens, seq_lens)
        scales = ()
        if self.model.kv_quant:
            scales = (cache["k_scale"][:, 0, :n], cache["v_scale"][:, 0, :n])
        self.paged_cache.write_prompt(
            slot, cache["k"][:, 0, :n], cache["v"][:, 0, :n], n, *scales
        )
        first_id = self._first_token(request, last)
        self.counters["prefills"] += 1
        self.counters["prefill_ms"] += (time.perf_counter() - t0) * 1e3
        return first_id

    def _first_token(self, request: GenRequest, last_logits: torch.Tensor) -> int:
        """A request's first token from its prompt's last logits [1, vocab]
        (both schedulers sample it here)."""
        params = SamplingParams(
            temperature=torch.tensor([request.temperature], dtype=torch.float32,
                                     device=self.device),
            top_k=torch.tensor([request.top_k], dtype=torch.int32, device=self.device),
            top_p=torch.tensor([request.top_p], dtype=torch.float32, device=self.device),
        )
        first = sample_tokens(last_logits.float(), params, generator=self._gen,
                              all_greedy=request.temperature <= 0)
        return int(first.item())

    def _activate_slot(self, request: GenRequest, slot: int, first_id: int) -> None:
        self._slot_req[slot] = request
        self._next_token[slot] = first_id
        # the next dispatch takes this slot's token from the host
        self._slot_overrides[slot] = True
        if self._tokbuf is not None:
            # the history holds the prompt and every emitted token
            row = np.zeros(self._tokbuf.shape[1], np.int32)
            ids = request.prompt_ids[: self._tokbuf.shape[1] - 1]
            row[: len(ids)] = ids
            row[len(ids)] = first_id
            self._tokbuf[slot] = row
        self._temperature[slot] = request.temperature
        self._top_k[slot] = request.top_k
        self._top_p[slot] = request.top_p
        self._emit(slot, first_id)

    # -- pipelined decode: dispatch / retire ----------------------------------

    async def _decode_step(self, active_mask: np.ndarray) -> None:
        """One pipelined scheduling step. The in-flight queue fills to
        ``pipeline_depth - 1`` chunks; then each step overlaps the oldest
        chunk's retirement (readback in a worker thread, emission on the
        loop) with the next chunk's dispatch in a worker thread, whose
        token input chains on the device. At depth 1 this is the serial
        dispatch -> sync -> emit loop."""
        t0 = time.perf_counter()
        try:
            fill_target = max(1, self.pipeline_depth - 1)
            dispatch_mask = self._dispatchable_mask(active_mask)
            while dispatch_mask.any() and len(self._inflight) < fill_target:
                await self._dispatch_or_recover(dispatch_mask.copy())
                # a dispatch can fail slots (pool exhaustion): drop them
                # before topping up further
                active_mask &= np.array([r is not None for r in self._slot_req])
                dispatch_mask = self._dispatchable_mask(active_mask)
            if not self._inflight:
                return
            # the retiring chunk stays queued until its emissions land: the
            # concurrent dispatch's barrier and masking count its steps
            entry = self._inflight[0]
            if dispatch_mask.any() and len(self._inflight) < self.pipeline_depth:
                dispatch_res, retire_res = await asyncio.gather(
                    self._dispatch_async(dispatch_mask.copy()),
                    self._retire_chunk(entry),
                    return_exceptions=True,
                )
                if self._inflight and self._inflight[0] is entry:
                    self._inflight.popleft()
                # failures surface after both stages settled; a retire
                # failure loses chunk N's tokens for every stream, so it
                # outranks the dispatch's
                if isinstance(retire_res, BaseException):
                    raise retire_res
                if isinstance(dispatch_res, BaseException):
                    await self._recover_failed_dispatch()
                    raise dispatch_res
            else:
                await self._retire_oldest()
        finally:
            self.counters["decode_ms"] += (time.perf_counter() - t0) * 1e3

    async def _dispatch_or_recover(self, mask: np.ndarray) -> None:
        """Dispatch with failure recovery, where no retire runs
        concurrently (the gather branch recovers after both settle)."""
        try:
            await self._dispatch_async(mask)
        except Exception:
            await self._recover_failed_dispatch()
            raise

    async def _recover_failed_dispatch(self) -> None:
        """A dispatch raised after its prep consumed the host overrides:
        retire what is still in flight (valid results) so the host mirrors
        are current, then forget the device chain, so the next dispatch
        takes every token from them."""
        while self._inflight:
            await self._retire_oldest()
        self._reset_device_chains()

    async def _retire_oldest(self) -> None:
        """Retire the oldest in-flight chunk; it leaves the queue once its
        emissions landed."""
        entry = self._inflight[0]
        await self._retire_chunk(entry)
        if self._inflight and self._inflight[0] is entry:
            self._inflight.popleft()

    def _dispatchable_mask(self, active_mask: np.ndarray) -> np.ndarray:
        """Slots worth including in the NEXT chunk: active, and not already
        certain to finish inside the chunks in flight (by their token
        budget or the sequence limit; a stop token stays unpredictable, and
        its surplus tokens are dropped at emission)."""
        if not self._inflight and self._dispatching is None:
            return active_mask
        pending = np.zeros(self.max_batch, np.int64)
        for entry in self._inflight:
            pending += entry.active_mask * self.decode_steps
        if self._dispatching is not None:
            pending += self._dispatching[1] * self.decode_steps
        mask = active_mask.copy()
        for slot in np.nonzero(active_mask)[0]:
            request = self._slot_req[slot]
            if request is not None and request.produced + pending[slot] >= min(
                    request.max_new_tokens, self.max_seq_len - request.prompt_len):
                mask[slot] = False
        return mask

    async def _dispatch_async(self, active_mask: np.ndarray) -> None:
        """Dispatch one chunk: its host state is snapshotted on the loop
        thread (``_prepare_dispatch``), then the device work runs in a
        worker thread, possibly beside the previous chunk's retirement.
        Appends the in-flight entry and fails pool-exhausted slots."""
        prep = self._prepare_dispatch(active_mask)
        # barrier visibility: a slot freed by the concurrent retire must
        # see this chunk before its entry lands in the queue
        self._dispatching = (prep["seq"], prep["active_mask"])
        try:
            entry = await asyncio.to_thread(self._on_stream, self._dispatch_device, prep)
        finally:
            self._dispatching = None
        self._inflight.append(entry)
        for slot in entry.exhausted:
            self._fail_slot(slot, MemoryError("kv page pool exhausted for this sequence"))

    def _prepare_dispatch(self, active_mask: np.ndarray) -> dict:
        """Loop-thread half of a dispatch: allocate the chunk's pages
        host-side (a slot the pool cannot extend leaves the chunk, its row
        writing the null page) and write every host input of the chunk
        into its own staging buffers (``ChunkLayout``; pinned on the card),
        so the worker never reads state the concurrent retire stage
        changes, and no later change reaches a copy still pending."""
        pool = self.paged_cache.pool
        n = self.decode_steps
        pin = self._stream is not None
        host_i32 = torch.empty(self._layout.size_i32, dtype=torch.int32, pin_memory=pin)
        host_f32 = torch.empty(self._layout.size_f32, dtype=torch.float32, pin_memory=pin)
        v = self._layout.views(host_i32.numpy(), host_f32.numpy())
        v["lengths0"][:] = pool.lengths()                 # pre-extension lengths
        v["write_pages"][:] = 0                            # null page 0
        v["write_offsets"][:] = 0
        exhausted = []
        for slot in np.nonzero(active_mask)[0]:
            slot = int(slot)
            start = int(v["lengths0"][slot])
            try:
                pool.extend(slot, n)
            except MemoryError:
                active_mask[slot] = False
                exhausted.append(slot)
                continue
            for i, (page, offset) in enumerate(pool.token_coords(slot, start, n)):
                v["write_pages"][slot, i] = page
                v["write_offsets"][slot, i] = offset
        v["page_table"][:] = pool.page_table(self._pages_per_seq)
        v["override_tokens"][:] = self._next_token
        v["override_mask"][:] = self._slot_overrides
        self._slot_overrides[:] = False
        v["temperature"][:] = self._temperature
        v["top_k"][:] = self._top_k
        v["top_p"][:] = self._top_p
        self._dispatch_seq += 1
        return {
            "seq": self._dispatch_seq,
            "active_mask": active_mask,
            "exhausted": exhausted,
            "host_i32": host_i32,
            "host_f32": host_f32,
            # the greedy variant draws no noise
            "greedy": not (self._temperature[active_mask] > 0).any(),
        }

    def _dispatch_device(self, prep: dict) -> _InFlightChunk:
        """Worker-thread half of a dispatch, on the engine's stream: the
        chunk's noise (sampled variant: one draw from the engine's
        generator), the chunk itself (one graph replay on the card, eager
        launches on the CPU or with ``cuda_graphs`` off), and the copy of its tokens to the
        host that the retire stage waits for. Touches only what the retire
        stage never reads: the chain, the graphs and the dispatch
        histogram."""
        t0 = time.perf_counter()
        n = self.decode_steps
        noise = (None if prep["greedy"] else
                 gumbel_noise((n, self.max_batch, self.model.vocab_size), self._gen, self.device))
        if self._graphs is not None:
            greedy = prep["greedy"]
            if not self._graphs.captured(greedy):
                self._capture(greedy)
            out = self._graphs.replay(greedy, prep["host_i32"], prep["host_f32"], noise)
            self.counters["graph_replays"] += 1
        else:
            views = self._layout.views(prep["host_i32"].to(self.device, non_blocking=True),
                                       prep["host_f32"].to(self.device, non_blocking=True))
            out = run_chunk(self.model, self.paged_cache, views, self._chain, noise, n)
            self._chain = out[:, -1]
        tokens, ready = out, None
        if self._stream is not None:
            tokens = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            tokens.copy_(out, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        self.counters["decode_steps"] += n
        self.counters["decode_chunks"] += 1
        self._hist_dispatch.observe((time.perf_counter() - t0) * 1e3)
        return _InFlightChunk(seq=prep["seq"], active_mask=prep["active_mask"],
                              tokens=tokens, ready=ready, exhausted=prep["exhausted"])

    def _capture(self, greedy: bool) -> None:
        """Capture a decode-chunk variant: inside ``warmup()`` in the
        global mode (the card is the engine's alone), while serving in the
        thread-local one (a retire may read back meanwhile), counted in
        ``serve_captures``. A failed capture raises: the chunk never runs
        eagerly instead."""
        try:
            self._graphs.capture(
                greedy, capture_error_mode="global" if self._warming else "thread_local")
        except Exception as ex:
            raise RuntimeError("CUDA-graph capture of the {} decode chunk failed: {}".format(
                "greedy" if greedy else "sampled", ex)) from ex
        self.counters["graph_captures"] += 1
        if not self._warming:
            self.counters["serve_captures"] += 1

    def _capture_graphs(self) -> None:
        """Capture every decode-chunk variant not captured yet
        (``warmup()``; nothing on the CPU or with ``cuda_graphs`` off)."""
        for greedy in (True, False):
            if self._graphs is not None and not self._graphs.captured(greedy):
                self._capture(greedy)

    async def _retire_chunk(self, entry: _InFlightChunk) -> None:
        """Readback and emission of the oldest chunk, while the next one
        computes: the host token mirrors re-anchor, the chunk's tokens fan
        out to the slots of its dispatch mask (a finishing slot frees or
        quarantines its pages), and slots whose barrier was this chunk are
        released."""
        t0 = time.perf_counter()
        if entry.ready is not None and not entry.ready.query():
            await asyncio.to_thread(entry.ready.synchronize)
        chunk = entry.tokens.numpy()
        slots = [int(s) for s in np.nonzero(entry.active_mask)[0]]
        for slot in slots:
            self._next_token[slot] = int(chunk[slot, -1])
        for slot in slots:
            for token_id in chunk[slot]:
                # _emit frees the slot on finish; the rest of the chunk for
                # that slot is dropped by the None check inside _emit
                self._emit(slot, int(token_id))
        self._release_quarantine(entry.seq)
        self._hist_retire.observe((time.perf_counter() - t0) * 1e3)

    async def _handle_step_failure(self, ex: Exception) -> None:
        """A decode step raised (dispatch, capture or retire): every
        request's device state is suspect, so the pipeline is discarded and
        every active request fails with the error; the loop keeps
        serving."""
        logger.exception("decode step failed")
        await self._discard_pipeline()
        for slot, request in enumerate(self._slot_req):
            if request is not None:
                self._fail_slot(slot, ex)

    # -- pipelined decode: slot-reuse barrier ---------------------------------

    def _pipeline_barrier(self, slot: int) -> Optional[int]:
        """Newest in-flight (or dispatching) chunk that still decodes
        ``slot`` (None when the pipeline holds no reference)."""
        barrier = None
        for entry in self._inflight:
            if entry.active_mask[slot]:
                barrier = entry.seq
        if self._dispatching is not None and self._dispatching[1][slot]:
            barrier = self._dispatching[0]
        return barrier

    def _free_slot_pages(self, slot: int) -> None:
        """Release a freed slot's pages: at once when no chunk in flight
        still decodes the slot, else at the retire of the newest one that
        does. Until then the slot is quarantined against re-admission: that
        chunk still writes the slot's pages, and its retire would hand a
        new occupant the dead request's tokens."""
        barrier = self._pipeline_barrier(slot)
        if barrier is not None:
            self._quarantine[slot] = barrier
            return
        self.paged_cache.pool.free(slot)

    def _release_quarantine(self, retired_seq: int) -> None:
        """Retire point: slots whose barrier has passed become reusable and
        their deferred page frees run."""
        for slot, barrier in list(self._quarantine.items()):
            if barrier <= retired_seq:
                del self._quarantine[slot]
                if self._slot_req[slot] is None and slot not in self._admitting:
                    self.paged_cache.pool.free(slot)

    async def _discard_pipeline(self) -> None:
        """Drop every in-flight chunk (a failed step, or stop) once the card
        has finished the work already enqueued: a dropped chunk may still
        be writing its slots' pages. The wait runs in a worker thread."""
        self._inflight.clear()
        if self._stream is not None:
            await asyncio.to_thread(self._stream.synchronize)
        self._drop_pipeline()

    def _drop_pipeline(self) -> None:
        """Forget the in-flight queue and the device chain, and run the
        deferred page frees."""
        self._inflight.clear()
        pending = list(self._quarantine)
        self._quarantine.clear()
        self._reset_device_chains()
        for slot in pending:
            if self._slot_req[slot] is None and slot not in self._admitting:
                self.paged_cache.pool.free(slot)

    def _reset_device_chains(self) -> None:
        """Forget the device-resident token chain: the next dispatch takes
        every slot's token from the host mirror."""
        self._slot_overrides[:] = True

    def _fail_slot(self, slot: int, err: BaseException) -> None:
        request = self._slot_req[slot]
        self._slot_req[slot] = None
        self._free_slot_pages(slot)
        if request is not None:
            request.error = err
            request.out_queue.put_nowait(_FINISHED)

    def _finish_slot(self, slot: int, request: GenRequest) -> None:
        request.out_queue.put_nowait(_FINISHED)
        self._slot_req[slot] = None
        self._free_slot_pages(slot)

    def _emit(self, slot: int, token_id: int) -> None:
        request = self._slot_req[slot]
        if request is None:
            return
        if request.cancelled:
            self._finish_slot(slot, request)
            return
        request.produced += 1
        self.counters["tokens_emitted"] += 1
        if request.first_token_at is None:
            request.first_token_at = time.time()
            self.ttft_ms.append((request.first_token_at - request.submitted_at) * 1e3)
        request.out_queue.put_nowait(token_id)
        if (
            token_id == self.eos_token_id
            or request.produced >= request.max_new_tokens
            or request.prompt_len + request.produced >= self.max_seq_len
        ):
            self._finish_slot(slot, request)

    # -- ragged scheduler ------------------------------------------------------

    def _ragged_admission(self) -> None:
        """FIFO admission into free slots under the ragged scheduler: each
        request opens a job at prompt position 0 whose prompt rides the
        loop's launches as chunk rows (the reference's
        ``_ragged_admission_task`` and ``_start_ragged_job``; this slice has
        no worker-thread preparation and no prefix cache, so the job opens
        at once)."""
        free = [i for i, r in enumerate(self._slot_req)
                if r is None and i not in self._admitting and i not in self._quarantine]
        while free and self._pending and not self._stopped:
            request = self._pending.popleft()
            if request.cancelled:
                request.out_queue.put_nowait(_FINISHED)
                continue
            slot = free.pop(0)
            self._admitting.add(slot)
            self._prefill_jobs.append(_RaggedJob(request=request, slot=slot))

    def _fail_ragged_job(self, job: _RaggedJob, err: Optional[BaseException]) -> None:
        """Fail one in-progress admission (err None = cancelled): free its
        slot's pages and unblock its consumer."""
        if job in self._prefill_jobs:  # identity (dataclass eq=False)
            self._prefill_jobs.remove(job)
        self._admitting.discard(job.slot)
        if err is not None:
            job.request.error = err
        job.request.out_queue.put_nowait(_FINISHED)
        self.paged_cache.pool.free(job.slot)

    def _sweep_ragged_jobs(self) -> None:
        """Drop cancelled jobs before planning a step: budget spent on a dead
        admission is budget stolen from live ones."""
        for job in list(self._prefill_jobs):
            if job.request.cancelled:
                self._fail_ragged_job(job, None)

    def _spec_eligible_mask(self, active_mask: np.ndarray):
        """(greedy, sampled) slot masks of verify rows: greedy rows
        (temperature 0) replay exactly through argmax acceptance; sampled
        rows (temperature > 0) need ``spec_sampling``'s rejection
        sampling."""
        greedy = active_mask & (self._temperature == 0.0)
        sampled = (active_mask & (self._temperature > 0.0) if self._spec_sampling
                   else np.zeros_like(greedy))
        return greedy, sampled

    def _ragged_spec_wanted(self, active_mask: np.ndarray) -> bool:
        """With speculation on, eligible decode slots ride ragged launches as
        verify rows, admissions or not."""
        if not (self._ragged and self._speculation) or not active_mask.any():
            return False
        greedy, sampled = self._spec_eligible_mask(active_mask)
        return bool(greedy.any() or sampled.any())

    def _prepare_ragged(self, active_mask: np.ndarray) -> Optional[dict]:
        """Loop-thread half of a ragged step: sweep dead jobs, pick the
        verify rows (each costs k extra budget tokens; rows are demoted to
        plain decode from the highest slot while they do not fit), give
        each live job its token share of the budget in admission order,
        widen the plain decode rows' windows from the budget left over,
        draft the verify rows, and lay the rows out on the flat token
        axis. Returns None when nothing is dispatchable."""
        self._sweep_ragged_jobs()
        decode_mask = active_mask.copy()
        budget = self._step_token_budget
        n_decode = int(decode_mask.sum())
        k_ = self._spec_k
        spec_mask = np.zeros(self.max_batch, bool)
        sspec_mask = np.zeros(self.max_batch, bool)
        if self._ragged_spec_wanted(decode_mask):
            greedy, sampled_m = self._spec_eligible_mask(decode_mask)
            spec_mask, sspec_mask = greedy.copy(), sampled_m.copy()
            spec_slots = [int(s) for s in np.nonzero(spec_mask | sspec_mask)[0]]
            while spec_slots and n_decode + k_ * len(spec_slots) > budget:
                drop = spec_slots.pop()
                spec_mask[drop] = False
                sspec_mask[drop] = False
        spec_any = spec_mask | sspec_mask
        n_spec = int(spec_any.sum())
        shares: List[tuple] = []
        left = max(0, budget - n_decode - k_ * n_spec)
        for job in self._prefill_jobs:
            if left <= 0:
                break
            take = min(left, len(job.request.prompt_ids) - job.pos)
            if take <= 0:
                continue
            shares.append((job, take))
            left -= take
        if n_decode == 0 and not shares:
            return None
        # multi-step decode windows from the LEFTOVER budget, bucketed to a
        # power of two; every row clamps to its own max-token and sequence
        # bounds (a q=N row costs N budget tokens)
        plain_slots = [int(s) for s in np.nonzero(decode_mask & ~spec_any)[0]]
        launch_steps = 1
        if plain_slots and self._ragged_steps_cap > 1 and left > 0:
            launch_steps = shapes.decode_steps_bucket(
                1 + left // len(plain_slots), cap=self._ragged_steps_cap)
        row_steps = np.zeros(self.max_batch, np.int32)
        for slot in plain_slots:
            request = self._slot_req[slot]
            remaining_new = request.max_new_tokens - request.produced
            remaining_len = self.max_seq_len - (request.prompt_len + request.produced)
            row_steps[slot] = max(1, min(launch_steps, remaining_new, remaining_len))
        # drafts for the verify rows from the slots' histories: chain
        # engines get the chain proposer, spec_tree engines the forest and
        # the per-row tree arrays the acceptance walk and the mask take
        drafts = None
        tree_tokens = tree_parents = tree_depths = tree_n = None
        if n_spec:
            spec_slots = [int(s) for s in np.nonzero(spec_any)[0]]
            hists = [self._slot_req[s].prompt_len + self._slot_req[s].produced
                     for s in spec_slots]
            forest = self._spec_proposer.propose(spec_slots, hists, self._tokbuf, k_)
            drafts = np.zeros((self.max_batch, k_), np.int32)
            drafts[spec_slots] = forest.tokens[:, 1:]
            if self._spec_tree:
                tree_tokens = np.zeros((self.max_batch, k_ + 1), np.int32)
                tree_parents = np.broadcast_to(
                    chain_parents(k_), (self.max_batch, k_ + 1)).copy()
                tree_depths = np.broadcast_to(
                    np.arange(k_ + 1, dtype=np.int32), (self.max_batch, k_ + 1)).copy()
                tree_n = np.full(self.max_batch, k_ + 1, np.int32)
                tree_tokens[spec_slots] = forest.tokens
                tree_parents[spec_slots] = forest.parents
                tree_depths[spec_slots] = forest.depths
                tree_n[spec_slots] = forest.n_nodes
        job_of = {job.slot: (job, take) for job, take in shares}
        # layout lens reserve each row's WHOLE window on the flat axis (a
        # q=N decode row owns N positions: position 0 rides the mixed pass,
        # positions 1.. are written by the chained decode steps); kernel
        # row_lens count only the positions the mixed pass computes; a
        # verify row computes all of its k+1
        span_lens = np.zeros(self.max_batch, np.int32)
        row_lens = np.zeros(self.max_batch, np.int32)
        for slot in plain_slots:
            span_lens[slot] = row_steps[slot]
            row_lens[slot] = 1
        for slot in np.nonzero(spec_any)[0]:
            span_lens[slot] = row_lens[slot] = k_ + 1
        for slot, (_job, take) in job_of.items():
            span_lens[slot] = row_lens[slot] = take
        starts, block_rows, block_q0, tpad = ragged_layout(
            span_lens, self._ragged_qb, total=self._ragged_tpad)
        pool = self.paged_cache.pool
        tokens = np.zeros(tpad, np.int64)
        tok_pos = np.zeros(tpad, np.int32)
        tok_row = np.zeros(tpad, np.int32)
        tok_valid = np.zeros(tpad, bool)
        row_last = np.zeros(self.max_batch, np.int32)
        kv_lens = np.zeros(self.max_batch, np.int32)
        pre_lens = np.zeros(self.max_batch, np.int32)
        spans: Dict[int, tuple] = {}
        for slot in range(self.max_batch):
            n = int(span_lens[slot])
            if n == 0:
                continue
            s = int(starts[slot])
            v = int(row_lens[slot])
            pre = pool.slot_length(slot)
            pre_lens[slot] = pre
            if slot in job_of:
                job, _take = job_of[slot]
                tokens[s:s + n] = job.request.prompt_ids[job.pos:job.pos + n]
            elif spec_any[slot]:
                tokens[s] = self._next_token[slot]
                tokens[s + 1:s + n] = drafts[slot]
            else:
                tokens[s] = self._next_token[slot]
            spans[slot] = (s, n)
            if tree_depths is not None and spec_any[slot]:
                # a tree node's RoPE position is its path depth, not its
                # node index: siblings share a position, and the accepted
                # path's K/V (moved to positions pre+1..pre+acc) was
                # embedded at exactly those positions
                tok_pos[s:s + n] = pre + tree_depths[slot, :n]
            else:
                tok_pos[s:s + n] = pre + np.arange(n, dtype=np.int32)
            tok_row[s:s + n] = slot
            # reserved multi-step positions stay invalid in the mixed pass:
            # their tokens are sampled in-launch and their K/V written by
            # the chained decode steps
            tok_valid[s:s + v] = True
            row_last[slot] = s + v - 1
            kv_lens[slot] = pre + v
        tree_anc = None
        if tree_parents is not None:
            # per-token ancestor lists for the tree mask; every token outside
            # a tree row keeps the -2 plain-causal sentinel
            tree_anc = np.full((tpad, k_ + 1), -1, np.int32)
            tree_anc[:, 0] = -2
            for slot in np.nonzero(spec_any)[0]:
                s = int(starts[slot])
                tree_anc[s:s + k_ + 1] = tree_ancestors(
                    tree_parents[slot], int(tree_n[slot]), width=k_ + 1)
        row_logit_idx = None
        if n_spec:
            # logits at every position of each row (a row's last position
            # repeats past its end)
            row_logit_idx = np.zeros((self.max_batch, k_ + 1), np.int32)
            for slot in range(self.max_batch):
                if row_lens[slot] > 0:
                    row_logit_idx[slot] = starts[slot] + np.minimum(
                        np.arange(k_ + 1), row_lens[slot] - 1)
        plain_mask = decode_mask & ~spec_any
        return {
            "decode_mask": decode_mask,
            "shares": shares,
            "budget": budget,
            "sampling": self._sampling(),
            # plain sampling serves the plain decode rows only
            "all_greedy": not (self._temperature[plain_mask] > 0).any(),
            "row_steps": row_steps,
            "launch_steps": launch_steps,
            # per-step window mask [S-1, B]: step i runs for rows whose
            # window is still open (EOS mid-window is masked at retire)
            "chain_mask": (np.arange(1, launch_steps)[:, None] < row_steps[None, :]
                           if launch_steps > 1 else None),
            # rows whose admission completes this step: only their logits
            # are gathered for the first token
            "finish_slots": [job.slot for job, take in shares
                             if job.pos + take >= len(job.request.prompt_ids)],
            "exhausted": [],
            "failed_jobs": [],
            "spec_mask": spec_mask, "sspec_mask": sspec_mask, "spec_k": k_,
            "drafts": drafts, "tree_tokens": tree_tokens, "tree_parents": tree_parents,
            "tree_n": tree_n, "tree_anc": tree_anc, "row_logit_idx": row_logit_idx,
            "tokens": tokens, "tok_pos": tok_pos, "tok_row": tok_row,
            "tok_valid": tok_valid, "row_last": row_last, "kv_lens": kv_lens,
            "pre_lens": pre_lens, "row_starts": starts, "row_lens": row_lens,
            "spans": spans,
            "block_rows": block_rows, "block_q0": block_q0,
            "write_page": np.zeros(tpad, np.int32),
            "write_offset": np.zeros(tpad, np.int32),
        }

    def _ragged_drop_row(self, plan: dict, slot: int) -> None:
        """Worker-side removal of a row whose page extension failed: its
        tokens become pads (null-page writes, masked compute, plain-causal
        mask rows); the retire stage fails the decode request or admission
        job it carried."""
        s, n = plan["spans"].pop(slot)
        plan["tokens"][s:s + n] = 0
        plan["tok_pos"][s:s + n] = 0
        plan["tok_row"][s:s + n] = 0
        plan["tok_valid"][s:s + n] = False
        plan["row_lens"][slot] = 0
        plan["kv_lens"][slot] = plan["pre_lens"][slot]
        plan["row_last"][slot] = 0
        plan["row_steps"][slot] = 0
        plan["spec_mask"][slot] = False
        plan["sspec_mask"][slot] = False
        if plan["chain_mask"] is not None:
            plan["chain_mask"][:, slot] = False
        if plan["row_logit_idx"] is not None:
            plan["row_logit_idx"][slot] = 0
        if plan["tree_anc"] is not None:
            plan["tree_anc"][s:s + n] = -1
            plan["tree_anc"][s:s + n, 0] = -2
        if plan["decode_mask"][slot]:
            plan["decode_mask"][slot] = False
            plan["exhausted"].append(slot)
        else:
            job = next(j for j, _ in plan["shares"] if j.slot == slot)
            plan["failed_jobs"].append(
                (job, MemoryError("kv page pool exhausted during ragged admission")))

    def _spec_accept(self, plan: dict, spec_logits: torch.Tensor):
        """Draft acceptance of the verify rows over their per-position
        logits [B, k+1, vocab]: greedy rows take the argmax-match chain (or
        the longest greedy tree path), sampled rows the rejection-sampled
        chain (or tree). Returns (g [B, k+1], acc [B], nodes): g[b, :acc+1]
        are the tokens a row emits; nodes [B, k+1] maps each kept row
        position to its tree node (None on chain engines, whose accepted
        positions are already contiguous)."""
        dev = self.device

        def on_dev(a):
            return torch.as_tensor(a, device=dev)

        spec_sel, sspec_sel = on_dev(plan["spec_mask"]), on_dev(plan["sspec_mask"])
        sampled_rows = bool(plan["sspec_mask"].any())
        sl = spec_logits.float()
        zeros = torch.zeros(sl.shape[0], dtype=torch.int32, device=dev)
        if plan["tree_anc"] is not None:
            t_tok, t_par, t_n = (on_dev(plan[key]) for key in
                                 ("tree_tokens", "tree_parents", "tree_n"))
            g, acc_g, nodes = greedy_tree_walk(
                torch.argmax(sl, dim=-1).to(torch.int32), t_tok, t_par, t_n)
            acc = torch.where(spec_sel, acc_g, zeros)
            if sampled_rows:
                g_s, acc_s, nodes_s = speculative_sample_tree(
                    sl, t_tok, t_par, t_n, plan["sampling"], generator=self._gen)
                g = torch.where(sspec_sel[:, None], g_s, g)
                acc = torch.where(sspec_sel, acc_s, acc)
                nodes = torch.where(sspec_sel[:, None], nodes_s, nodes)
            ident = torch.arange(nodes.shape[1], dtype=torch.int32, device=dev)
            nodes = torch.where((spec_sel | sspec_sel)[:, None], nodes, ident)
            return g, acc, nodes
        k_ = plan["spec_k"]
        drafts = on_dev(plan["drafts"])
        g = torch.argmax(sl, dim=-1).to(torch.int32)                   # [B, k+1]
        acc_g = torch.cumprod((drafts == g[:, :k_]).to(torch.int32), dim=1).sum(dim=1)
        acc = torch.where(spec_sel, acc_g.to(torch.int32), zeros)
        if sampled_rows:
            g_s, acc_s = speculative_sample_chain(sl, drafts, plan["sampling"],
                                                  generator=self._gen)
            g = torch.where(sspec_sel[:, None], g_s, g)
            acc = torch.where(sspec_sel, acc_s, acc)
        return g, acc, None

    def _compact_tree_kv(self, plan: dict, nodes: torch.Tensor, write_page: torch.Tensor,
                         write_offset: torch.Tensor) -> None:
        """KV path compaction of the tree verify rows: each accepted node's
        just-written K/V (and int8 scales) is rewritten at its path depth,
        so the retire's truncation to pre + 1 + acc keeps a contiguous
        prefix, as a chain row's. Non-moves write the null page 0. The
        sources are gathered into a new tensor before the scatter."""
        rows = [int(s) for s in np.nonzero(plan["spec_mask"] | plan["sspec_mask"])[0]]
        if not rows:
            return
        dev = self.device
        sel = nodes[torch.as_tensor(rows, device=dev), 1:].long()     # [S, k]
        pos = torch.arange(1, nodes.shape[1], device=dev)[None, :]
        starts = torch.as_tensor(plan["row_starts"][rows].astype(np.int64), device=dev)
        src = (starts[:, None] + sel).reshape(-1)
        dst = (starts[:, None] + pos).reshape(-1)
        move = (sel != pos).reshape(-1)
        wp, wo = write_page.long(), write_offset.long()
        sp, so = wp[src], wo[src]
        dp = torch.where(move, wp[dst], 0)
        do = torch.where(move, wo[dst], 0)
        cache = self.paged_cache
        pools = [cache.k, cache.v]
        if cache.kv_quant:
            pools += [cache.k_scale, cache.v_scale]
        for p in pools:
            p[:, :, dp, do] = p[:, :, sp, so]

    def _dispatch_ragged_device(self, plan: dict) -> dict:
        """Worker thread: page allocation for every row's span, then the
        step: ``forward_ragged`` over the mixed batch (verify rows read
        their per-position logits; tree rows masked by ``tree_anc``), the
        verify rows' acceptance and tree KV compaction, sampling of the
        plain decode rows, ``launch_steps - 1`` chained ``decode_paged``
        steps at ``kv_lens + step`` (tokens held where the window is
        closed), and the finishing rows' logits gathered on the device."""
        t0 = time.perf_counter()
        pool = self.paged_cache.pool
        wp_host, wo_host = plan["write_page"], plan["write_offset"]
        for slot in list(plan["spans"]):
            s, n = plan["spans"][slot]
            try:
                pool.extend(slot, n)
            except MemoryError:
                self._ragged_drop_row(plan, slot)
                continue
            for i, (page, offset) in enumerate(
                    pool.token_coords(slot, int(plan["pre_lens"][slot]), n)):
                wp_host[s + i] = page
                wo_host[s + i] = offset
        launch_steps = plan["launch_steps"]
        spec_any = plan["spec_mask"] | plan["sspec_mask"]
        if launch_steps > 1:
            # a plain decode row's span positions 1.. become the chained
            # steps' write coordinates; the mixed pass writes them to the
            # null page, like any pad
            chain_wp = np.zeros((launch_steps - 1, self.max_batch), np.int32)
            chain_wo = np.zeros((launch_steps - 1, self.max_batch), np.int32)
            for slot, (s, n) in plan["spans"].items():
                if not plan["decode_mask"][slot] or spec_any[slot]:
                    continue
                for i in range(1, n):
                    chain_wp[i - 1, slot] = wp_host[s + i]
                    chain_wo[i - 1, slot] = wo_host[s + i]
                    wp_host[s + i] = 0
                    wo_host[s + i] = 0
        dev = self.device

        def on_dev(a):
            return torch.as_tensor(a, device=dev)

        cache = self.paged_cache
        scale_kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                    if cache.kv_quant else {})
        block_kw = ({"block_rows": on_dev(plan["block_rows"]),
                     "block_q0": on_dev(plan["block_q0"])}
                    if self._ragged_qb > 1 else {})
        verify_kw = {}
        if plan["row_logit_idx"] is not None:
            verify_kw["row_logit_idx"] = on_dev(plan["row_logit_idx"])
        if plan["tree_anc"] is not None:
            verify_kw["tree_anc"] = on_dev(plan["tree_anc"])
        page_table = on_dev(pool.page_table(self._pages_per_seq))
        kv_lens = on_dev(plan["kv_lens"])
        write_page, write_offset = on_dev(wp_host), on_dev(wo_host)
        out = self.model.forward_ragged(
            on_dev(plan["tokens"]), on_dev(plan["tok_pos"]), on_dev(plan["tok_row"]),
            on_dev(plan["tok_valid"]), on_dev(plan["row_last"]), cache.k, cache.v,
            page_table, kv_lens, on_dev(plan["row_starts"]), on_dev(plan["row_lens"]),
            write_page, write_offset, **block_kw, **scale_kw, **verify_kw,
        )
        spec_g = spec_acc = None
        if plan["row_logit_idx"] is not None:
            self.counters["ragged_verify_steps"] += 1
            logits, spec_logits = out
            spec_g, spec_acc, nodes = self._spec_accept(plan, spec_logits)
            if nodes is not None:
                self._compact_tree_kv(plan, nodes, write_page, write_offset)
        else:
            logits = out
        sampling, all_greedy = plan["sampling"], plan["all_greedy"]
        tok = sample_tokens(logits, sampling, generator=self._gen, all_greedy=all_greedy)
        steps = [tok]
        if launch_steps > 1:
            chain_mask = on_dev(plan["chain_mask"])
            wp, wo = on_dev(chain_wp), on_dev(chain_wo)
            for step in range(launch_steps - 1):
                step_logits = self.model.decode_paged(
                    tok.long(), cache.k, cache.v, page_table, kv_lens + step,
                    wp[step], wo[step], **scale_kw,
                )
                sampled = sample_tokens(step_logits, sampling, generator=self._gen,
                                        all_greedy=all_greedy)
                tok = torch.where(chain_mask[step], sampled, tok)
                steps.append(tok)
                self.counters["ragged_chain_steps"] += 1
        sampled = torch.stack(steps).cpu().numpy()                    # [S, B]
        # only the finishing rows' logits stay for the first-token draw
        # (rows pad to a power of two with row 0; a dropped row is gone)
        finish = [s for s in plan["finish_slots"] if s in plan["spans"]]
        finish_logits = None
        if finish:
            rows = np.zeros(shapes.pow2_bucket(len(finish)), np.int64)
            rows[:len(finish)] = finish
            finish_logits = logits[on_dev(rows)]
        result = {"sampled": sampled, "logits": finish_logits, "finish_rows": finish,
                  "spec_g": None, "spec_acc": None}
        if spec_g is not None:
            result["spec_g"] = spec_g.cpu().numpy()
            result["spec_acc"] = spec_acc.cpu().numpy()
        self.counters["ragged_ms"] += (time.perf_counter() - t0) * 1e3
        return result

    async def _ragged_step(self, active_mask: np.ndarray) -> None:
        """One ragged scheduling iteration: ONE mixed launch carries every
        decode row and as many prefill-chunk rows as fit the budget; serial
        dispatch -> sync -> emit, with the pipeline drained. A failed launch
        fails the requests and jobs it carried; the loop keeps serving."""
        # the decode chunks after this step take every token from the host
        # mirrors this step's retire updates
        self._reset_device_chains()
        plan = self._prepare_ragged(active_mask)
        if plan is None:
            return
        try:
            result = await asyncio.to_thread(self._on_stream, self._dispatch_ragged_device, plan)
        except Exception as ex:
            logger.exception("ragged step failed")
            for slot in np.nonzero(plan["decode_mask"])[0]:
                self._fail_slot(int(slot), ex)
            for job, _take in plan["shares"]:
                if job in self._prefill_jobs:
                    self._fail_ragged_job(job, ex)
            return
        self._retire_ragged(plan, result)

    def _retire_ragged(self, plan: dict, result: dict) -> None:
        """Loop-thread tail of a ragged step: each verify row first gives
        back the pages past what its acceptance kept, then every decode row
        emits in order under the mid-window EOS mask (a row finishing
        inside its window drops the surplus): a plain row its window, a
        verify row its accepted drafts and the bonus token; the last
        emitted token becomes the row's next pending one, and the
        speculation history follows every emission. Each job advances by
        its chunk, and a job whose final chunk landed samples its first
        token and activates its slot."""
        sampled = result["sampled"]
        spec_g, spec_acc = result["spec_g"], result["spec_acc"]
        for slot in plan["exhausted"]:
            self._fail_slot(slot, MemoryError("kv page pool exhausted for this sequence"))
        spec_any = plan["spec_mask"] | plan["sspec_mask"]
        decode_slots = [int(s) for s in np.nonzero(plan["decode_mask"])[0]]
        plain_slots = [s for s in decode_slots if not spec_any[s]]
        spec_slots = [s for s in decode_slots if spec_any[s]]
        pool = self.paged_cache.pool
        for slot in spec_slots:
            # before emission: _emit frees a finishing slot's pages
            if self._slot_req[slot] is not None:
                pool.truncate(slot, int(plan["pre_lens"][slot]) + 1 + int(spec_acc[slot]))
        emitted = 0

        def window_emit(slot: int, toks: List[int]) -> None:
            nonlocal emitted
            for tok in toks:
                request = self._slot_req[slot]
                if request is None:
                    break                      # mid-window EOS mask
                if self._tokbuf is not None:
                    idx = request.prompt_len + request.produced
                    if idx < self._tokbuf.shape[1]:
                        self._tokbuf[slot, idx] = tok
                self._emit(slot, tok)
                emitted += 1
            if self._slot_req[slot] is not None:
                self._next_token[slot] = toks[-1]

        for slot in plain_slots:
            n = int(plan["row_steps"][slot])
            window_emit(slot, [int(sampled[i, slot]) for i in range(n)])
        accept_fracs = []
        for slot in spec_slots:
            acc = int(spec_acc[slot])
            accept_fracs.append(acc / max(1, plan["spec_k"]))
            if self._spec_tree:
                self._hist_spec_tree_depth.observe(acc)
            window_emit(slot, [int(spec_g[slot, i]) for i in range(acc + 1)])
        failed = [j for j, _ in plan["failed_jobs"]]
        live_shares = [(j, t) for j, t in plan["shares"] if not any(j is f for f in failed)]
        self.counters["ragged_steps"] += 1
        self.counters["ragged_decode_tokens"] += emitted
        self.step_rows["decode"] += len(plain_slots)
        self.step_rows["spec_verify"] += len(spec_slots)
        self.step_rows["prefill"] += len(live_shares)
        if plain_slots or spec_slots:
            self._hist_launch_tokens.observe(emitted)
        if accept_fracs:
            self._hist_spec_accept.observe(sum(accept_fracs) / len(accept_fracs))
        used = (int(plan["row_steps"].sum()) + (plan["spec_k"] + 1) * len(spec_slots)
                + sum(t for _, t in live_shares))
        self._hist_budget.observe(used / max(1, plan["budget"]))
        for job, err in plan["failed_jobs"]:
            self._fail_ragged_job(job, err)
        for job, take in live_shares:
            if job not in self._prefill_jobs:  # failed since planning
                continue
            job.pos += take
            if job.pos < len(job.request.prompt_ids):
                continue
            # final chunk landed: the row's last-token logits are the
            # prompt's prefill logits
            request = job.request
            self._prefill_jobs.remove(job)
            self._admitting.discard(job.slot)
            if request.cancelled:
                request.out_queue.put_nowait(_FINISHED)
                self.paged_cache.pool.free(job.slot)
                continue
            row = result["finish_rows"].index(job.slot)
            first_id = self._first_token(request, result["logits"][row:row + 1])
            self._activate_slot(request, job.slot, first_id)
