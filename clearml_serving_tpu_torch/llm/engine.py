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

Request lifecycle (the reference's ``docs/robustness.md`` and
``docs/slo_scheduling.md``): ``check_admission`` sheds with structured
errors (``errors.py``) before a request queues: 503 once stopped, 408 on a
budget already spent, 429 with a drain-rate ``Retry-After`` at
``max_pending`` (a higher-class arrival evicts a queued lower-class request
first) or when the pool cannot hold the prompt. Pending requests wait in
per-class queues (interactive > batch > best_effort, earliest deadline
first within a class, a starvation floor). Queue, TTFT and total deadlines
fail requests with 408 where they wait, at their admission's commit and
mid-decode. A watchdog task fails the in-flight requests of a decode loop
that made no progress for ``watchdog_interval`` (503 ``engine_stalled``)
and bumps the recover epoch; the stale dispatch or retire leg, on landing,
discards the pipeline and frees pages only after the card finished the
enqueued replays. A brownout controller degrades in stages under pressure
(speculation parked, batch ``max_new_tokens`` capped, the ragged token
budget shrunk and best-effort shed), and queued interactive work preempts
batch-lane slots at a chunk boundary: the victim requeues with its history
as the prompt and its KV pages, and its resume maps them back and decodes
on, so its stream is the one it would have been. Chaos seams
(``llm/faults.py``) drive each path in the tests.

Device work runs in worker threads, on one CUDA stream, so the event loop
keeps serving HTTP while the card computes. The model arrives with its
weights already in their serving format (``build_engine`` quantizes them);
``weight_quant``/``quantize`` are accepted when they name that format.
Every reference knob this slice does not serve raises, naming itself.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncIterator, Deque, Dict, List, Optional

import numpy as np
import torch

from ..errors import (
    DeadlineExceededError,
    EngineOverloadedError,
    EngineStepError,
    EngineStuckError,
    EngineUnavailableError,
)
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
from . import faults, shapes

logger = logging.getLogger(__name__)


@dataclass
class GenRequest:
    """One generation request (the reference's ``GenRequest`` fields that
    this slice serves)."""

    prompt_ids: List[int]
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    # SLO class: "interactive" | "batch" | "best_effort". Strict class
    # order across the pending queues, earliest deadline first within a
    # class; under overload best_effort sheds first, then batch, and
    # batch-lane slots are preemptible while interactive work waits
    priority: str = "interactive"
    # per-request lifecycle budgets in seconds (None = the engine's
    # defaults): the wait in the queue, the time to the first token, the
    # whole request
    queue_timeout: Optional[float] = None
    ttft_timeout: Optional[float] = None
    total_timeout: Optional[float] = None
    # engine-internal monotonic deadlines, resolved at submission
    _queue_deadline: Optional[float] = None
    _ttft_deadline: Optional[float] = None
    _deadline: Optional[float] = None
    # engine-internal (preemptible batch lane): tokens emitted since the
    # last (re)admission; a preempted request resumes from prompt_ids +
    # _gen_ids, its whole history
    _gen_ids: List[int] = field(default_factory=list)
    # preemptions so far (bounded by the engine's preempt_budget)
    _preempt_count: int = 0
    # engine-internal: a preempted request's KV pages while it waits in the
    # queue (the KV of all its history but the last token); its resume maps
    # them back into a slot. Every queue exit that is not a resume releases
    # them (_release_parked)
    _parked: Optional[List[int]] = None
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
    # the recover epoch the chunk was dispatched under: a watchdog trip
    # since then makes it stale
    epoch: int = 0
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


PRIORITY_CLASSES = ("interactive", "batch", "best_effort")
_CLASS_RANK = {c: i for i, c in enumerate(PRIORITY_CLASSES)}
# brownout stage 3 shrinks the ragged admission share to one chunk of this
# many tokens beside the decode rows
_RAGGED_BROWNOUT_CHUNK = 16


class _ClassedPendingQueue:
    """Per-class pending queues (the reference's ``_ClassedPendingQueue``):
    strict class order across classes (interactive > batch >
    best_effort), earliest deadline first within a class (requests
    without a deadline after every deadlined one, FIFO), and a starvation
    floor: a lower class that waited through ``floor`` consecutive
    higher-class pops takes the next pop. The engine's callers run on the
    event-loop thread; the lock lets tests and the watchdog's deadline
    sweep read it from elsewhere."""

    def __init__(self, starvation_floor: int = 8):
        self._heaps: Dict[str, list] = {c: [] for c in PRIORITY_CLASSES}
        self._seq = itertools.count()
        self._floor = max(1, int(starvation_floor))
        # consecutive higher-class pops each non-empty class sat through
        self._starve = {c: 0 for c in PRIORITY_CLASSES}
        self._lock = threading.Lock()

    @staticmethod
    def _key(request: GenRequest) -> float:
        d = request._deadline
        return d if d is not None else float("inf")

    def put_nowait(self, request: GenRequest) -> None:
        cls = request.priority if request.priority in self._heaps else "interactive"
        with self._lock:
            heapq.heappush(self._heaps[cls], (self._key(request), next(self._seq), request))

    def _pop_class(self, cls: str) -> GenRequest:
        _, _, request = heapq.heappop(self._heaps[cls])
        self._starve[cls] = 0
        return request

    def get_nowait(self) -> GenRequest:
        with self._lock:
            # a class that waited through `floor` higher-class pops takes
            # this one (the lowest starved class has waited longest)
            for cls in reversed(PRIORITY_CLASSES):
                if self._heaps[cls] and self._starve[cls] >= self._floor:
                    return self._pop_class(cls)
            for i, cls in enumerate(PRIORITY_CLASSES):
                if self._heaps[cls]:
                    for lower in PRIORITY_CLASSES[i + 1:]:
                        if self._heaps[lower]:
                            self._starve[lower] += 1
                    return self._pop_class(cls)
        raise asyncio.QueueEmpty

    def qsize(self) -> int:
        with self._lock:
            return sum(len(h) for h in self._heaps.values())

    def empty(self) -> bool:
        return self.qsize() == 0

    def depths(self) -> Dict[str, int]:
        with self._lock:
            return {c: len(h) for c, h in self._heaps.items()}

    def waiting(self, cls: str) -> int:
        """Live queued requests of ``cls``: a cancelled or failed entry
        stays in its heap until a pop drops it, and must not make a batch
        slot be preempted for nobody."""
        with self._lock:
            return sum(1 for e in self._heaps.get(cls, ())
                       if not e[2].cancelled and e[2].error is None)

    def requests(self) -> List[GenRequest]:
        with self._lock:
            return [e[2] for h in self._heaps.values() for e in h]

    def shed_lowest(self, above: str) -> Optional[GenRequest]:
        """Remove and return the latest-deadline queued request of the
        lowest class strictly below ``above`` (None when there is none).
        A resumed preemption victim (``produced > 0``, its stream already
        open) is never shed."""
        above_rank = _CLASS_RANK.get(above, 0)
        with self._lock:
            for cls in reversed(PRIORITY_CLASSES):
                if _CLASS_RANK[cls] <= above_rank:
                    return None
                heap = self._heaps[cls]
                live = [e for e in heap if not e[2].cancelled and e[2].error is None
                        and e[2].produced == 0]
                if not live:
                    continue
                victim = max(live, key=lambda e: (e[0], e[1]))
                heap.remove(victim)
                heapq.heapify(heap)
                return victim[2]
        return None

    def pop_all(self) -> List[GenRequest]:
        with self._lock:
            out = [e[2] for h in self._heaps.values() for e in h]
            for h in self._heaps.values():
                h.clear()
            return out


class _BrownoutController:
    """Staged overload degradation with hysteresis (the reference's
    ``_BrownoutController``). A pressure score (the max over the queue,
    pool, deadline and watchdog signals) sets the stage:

    - 1: speculation parked;
    - 2: and batch-class ``max_new_tokens`` capped;
    - 3: and the ragged admission budget shrunk, best-effort shed at the
      door.

    Raising is immediate. Lowering needs the score below the stage's DOWN
    threshold, under its UP one, and ``dwell`` seconds since the last
    change, so a score oscillating across a threshold cannot flap."""

    UP = (0.70, 0.85, 0.95)
    DOWN = (0.50, 0.65, 0.80)

    def __init__(self, dwell: float = 2.0):
        self.dwell = float(dwell)
        self.stage = 0
        self.score = 0.0
        self.signals: Dict[str, float] = {}
        self.transitions = 0
        self._changed_at = float("-inf")

    def update(self, score: float, signals: Optional[dict] = None,
               now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        self.score = float(score)
        if signals is not None:
            self.signals = dict(signals)
        target_up = 0
        for i, threshold in enumerate(self.UP):
            if self.score >= threshold:
                target_up = i + 1
        if target_up > self.stage:
            self.stage = target_up
            self.transitions += 1
            self._changed_at = now
        elif (self.stage > 0 and self.score < self.DOWN[self.stage - 1]
              and now - self._changed_at >= self.dwell):
            self.stage -= 1
            self.transitions += 1
            self._changed_at = now
        return self.stage


# reference engine knobs this slice does not serve (each raises when set)
UNSUPPORTED_KNOBS = (
    "mesh", "long_prefill_threshold",
    "long_bucket_step", "chunked_prefill_size", "prefill_segments_per_decode",
    "prefill_stall_timeout", "lora_adapters",
    "prefix_cache", "prefix_cache_bytes", "prefix_cache_pages",
    "prefix_cache_host_pages", "prefix_cache_host_bytes", "tokenizer",
    "replica",
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
        # request lifecycle (None disables each knob; the OpenAI front
        # turns them on by default, as the reference's does)
        max_pending: Optional[int] = None,
        queue_timeout: Optional[float] = None,
        ttft_timeout: Optional[float] = None,
        total_timeout: Optional[float] = None,
        watchdog_interval: Optional[float] = None,
        # preemptible batch lane: with interactive work queued and no slot
        # free, batch-class slots are preempted at a chunk boundary and
        # requeued; preempt_budget bounds preemptions per request
        preempt_batch: bool = True,
        preempt_budget: int = 2,
        starvation_floor: int = 8,
        # brownout controller: None -> on iff max_pending is set
        brownout: Optional[bool] = None,
        brownout_batch_cap: int = 32,
        brownout_dwell: float = 2.0,
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
        self._pending = _ClassedPendingQueue(starvation_floor)
        self._loop_task: Optional[asyncio.Task] = None
        self._stopped = False
        # -- request lifecycle: admission bound, default budgets, the
        # watchdog and its recover epoch
        self.max_pending = int(max_pending) if max_pending else None
        self._queue_timeout = float(queue_timeout) if queue_timeout else None
        self._ttft_timeout = float(ttft_timeout) if ttft_timeout else None
        self._total_timeout = float(total_timeout) if total_timeout else None
        self._watchdog_interval = float(watchdog_interval) if watchdog_interval else None
        self._watchdog_task: Optional[asyncio.Task] = None
        self._last_progress = time.monotonic()
        # monotonic start of the device call a worker thread is in (a
        # prefill, a chunk dispatch, a ragged step): the watchdog's grace
        # for first-use work (the kernel build, a CUDA-graph capture while
        # serving, library handles)
        self._call_since: Optional[float] = None
        # bumped by a watchdog trip; a dispatch or retire leg that lands
        # under an older epoch discards the pipeline and completes recovery
        self._recover_epoch = 0
        self._recovering = False
        # -- SLO scheduling: sheds by (reason, class), the admission drain
        # rate behind Retry-After, preemption and the brownout controller
        self._class_sheds: Dict[str, Dict[str, int]] = {}
        self._admit_times: Deque[float] = deque(maxlen=32)
        self._admit_count = 0
        self._preempt = bool(preempt_batch)
        self._preempt_budget = max(0, int(preempt_budget))
        self._brownout = (
            _BrownoutController(dwell=brownout_dwell)
            if (brownout if brownout is not None else max_pending is not None)
            else None
        )
        self._brownout_batch_cap = max(1, int(brownout_batch_cap))
        self._brownout_checked = 0.0
        # (t, deadline hits, watchdog trips, admissions) anchoring the
        # pressure window's rates
        self._pressure_window: Optional[tuple] = None
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
        # lifecycle: sheds (queue-bound or class, pool), expired budgets by
        # stage, watchdog trips, failed steps, preemptions, verify rows the
        # engine.spec.tree seam demoted to plain decode
        self.counters = {"decode_steps": 0, "decode_chunks": 0, "prefills": 0,
                         "tokens_emitted": 0, "decode_ms": 0.0, "prefill_ms": 0.0,
                         "ragged_steps": 0, "ragged_decode_tokens": 0,
                         "ragged_chain_steps": 0, "ragged_verify_steps": 0,
                         "ragged_ms": 0.0, "graph_captures": 0, "graph_replays": 0,
                         "serve_captures": 0,
                         "sheds_queue": 0, "sheds_pool": 0, "deadline_queue": 0,
                         "deadline_ttft": 0, "deadline_total": 0, "watchdog_trips": 0,
                         "step_failures": 0, "preemptions": 0, "spec_tree_fallbacks": 0}
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
        if request.priority not in PRIORITY_CLASSES:
            raise ValueError("priority must be one of {} (got {!r})".format(
                "/".join(PRIORITY_CLASSES), request.priority))
        if request.max_new_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        vocab = self.model.vocab_size
        if any(not 0 <= int(t) < vocab for t in request.prompt_ids):
            raise ValueError("prompt token id out of range for vocab {}".format(vocab))

    def check_admission(self, request: GenRequest, reserve: int = 0) -> None:
        """Load shedding: a structured 503/408/429 instead of queueing a
        request the engine cannot serve in time. Streaming callers run this
        before sending response headers (``generate`` checks again).
        ``reserve``: requests the caller submits ahead of this one."""
        if self._stopped:
            raise EngineUnavailableError("engine is stopped")
        tot = request.total_timeout if request.total_timeout is not None else self._total_timeout
        if tot is not None and tot <= 0:
            # an already-spent budget fails before any queueing: the
            # pre-headers 408 of streaming clients
            self.counters["deadline_total"] += 1
            raise DeadlineExceededError(
                "request budget {}s already elapsed at submission".format(tot), stage="total")
        cls = request.priority if request.priority in PRIORITY_CLASSES else "interactive"
        self._update_brownout()
        try:
            faults.fire("engine.admit", request=request)
        except faults.InjectedFault as ex:
            self._count_shed("queue", cls)
            raise EngineOverloadedError(
                "admission shed (injected): {}".format(ex),
                retry_after=self._retry_after_hint(), shed_class=cls) from ex
        try:
            faults.fire("engine.admit.class", request=request)
        except faults.InjectedFault as ex:
            self._count_shed("class", cls)
            raise EngineOverloadedError(
                "admission shed by class policy (injected): {}".format(ex),
                retry_after=self._retry_after_hint(), shed_class=cls) from ex
        if self._brownout is not None and self._brownout.stage >= 3 and cls == "best_effort":
            # deepest stage: best-effort sheds at the door
            self._count_shed("brownout", cls)
            raise EngineOverloadedError(
                "brownout stage {}: best-effort traffic shed".format(self._brownout.stage),
                retry_after=self._retry_after_hint(), shed_class=cls)
        if self.max_pending is not None and self._pending.qsize() + reserve >= self.max_pending:
            # evict a strictly lower-class queued request (best-effort
            # first, then batch); only a queue with nothing lower sheds the
            # arrival
            victim = self._pending.shed_lowest(cls)
            if victim is not None:
                self._count_shed("queue", victim.priority)
                victim.error = EngineOverloadedError(
                    "shed from the queue by a higher-priority admission",
                    retry_after=self._retry_after_hint(), shed_class=victim.priority)
                victim.cancelled = True  # the admission pop drops it
                victim.out_queue.put_nowait(_FINISHED)
            else:
                self._count_shed("queue", cls)
                raise EngineOverloadedError(
                    "pending queue full ({} waiting, bound {})".format(
                        self._pending.qsize() + reserve, self.max_pending),
                    retry_after=self._retry_after_hint(), shed_class=cls)
        # pool headroom, enforced with admission control on (max_pending
        # set): without it, requests queue until pages free
        if self.max_pending is not None:
            pool = self.paged_cache.pool
            if not pool.can_allocate(len(request.prompt_ids) + 1):
                self._count_shed("pool", cls)
                raise EngineOverloadedError(
                    "kv page pool saturated ({} free pages)".format(pool.free_pages),
                    retry_after=self._retry_after_hint(), shed_class=cls)

    def _count_shed(self, reason: str, cls: str) -> None:
        """One shed, in the totals (``sheds_queue``/``sheds_pool``) and in
        the (reason, class) table."""
        self.counters["sheds_pool" if reason == "pool" else "sheds_queue"] += 1
        per = self._class_sheds.setdefault(reason, {})
        per[cls] = per.get(cls, 0) + 1

    def _retry_after_hint(self, ahead: Optional[int] = None) -> float:
        """Seconds until the queue has likely drained enough for a retry:
        (depth ahead + 1) / the observed admission rate over the recent
        commits, the window anchored at now (a wedged loop must not
        advertise an old burst's rate); 1 + depth / 4 before any drain was
        seen; clamped to [0.5, 60]."""
        if ahead is None:
            ahead = self._pending.qsize()
        times = self._admit_times
        rate = None
        if len(times) >= 2:
            span = time.monotonic() - times[0]
            if span > 0:
                rate = (len(times) - 1) / span
        hint = (ahead + 1) / rate if rate else 1.0 + 0.25 * ahead
        return min(60.0, max(0.5, hint))

    # -- brownout ---------------------------------------------------------------

    def _pressure_score(self) -> tuple:
        """(score, signals): overload pressure in [0, ~2], the max over
        the queue depth against its bound, the pool's occupancy, and the
        deadline-hit and watchdog rates over a sliding ~5 s window."""
        signals: Dict[str, float] = {}
        if self.max_pending:
            signals["queue"] = min(2.0, self._pending.qsize() / float(self.max_pending))
        pool = self.paged_cache.pool
        usable = max(1, pool.num_pages - 1)  # page 0 is the null page
        signals["pool"] = max(0.0, (usable - pool.free_pages) / usable)
        c = self.counters
        deadlines = c["deadline_queue"] + c["deadline_ttft"] + c["deadline_total"]
        now = time.monotonic()
        win = self._pressure_window
        if win is not None:
            d_dead = deadlines - win[1]
            d_trips = c["watchdog_trips"] - win[2]
            d_admit = self._admit_count - win[3]
            if d_dead + d_admit >= 4:
                # a volume floor: one expired request against no admission
                # must not send an idle engine to stage 3
                signals["deadline"] = d_dead / float(d_dead + d_admit)
            if d_trips > 0:
                signals["watchdog"] = 1.0
        if win is None or now - win[0] >= 5.0:
            self._pressure_window = (now, deadlines, c["watchdog_trips"], self._admit_count)
        return max(signals.values(), default=0.0), signals

    def _update_brownout(self) -> None:
        """Feed the pressure score to the controller (at most every 0.1 s;
        from the loop top and from check_admission, so the stage stays
        live while the loop sits in a long step)."""
        if self._brownout is None:
            return
        now = time.monotonic()
        if now - self._brownout_checked < 0.1:
            return
        self._brownout_checked = now
        score, signals = self._pressure_score()
        self._brownout.update(score, signals, now)

    def _brownout_snapshot(self) -> Optional[dict]:
        if self._brownout is None:
            return None
        return {"stage": self._brownout.stage, "score": round(self._brownout.score, 4),
                "signals": {k: round(v, 4) for k, v in self._brownout.signals.items()}}

    def _effective_max_new(self, request: GenRequest) -> int:
        """Brownout stage >= 2 caps the batch lanes' generation length, so
        long batch decodes release their slots early."""
        if (self._brownout is not None and self._brownout.stage >= 2
                and request.priority != "interactive"):
            return min(request.max_new_tokens, self._brownout_batch_cap)
        return request.max_new_tokens

    def _effective_token_budget(self) -> int:
        """The ragged step budget: brownout stage >= 3 shrinks the
        admission share to about one minimal chunk beside the decode rows,
        so decode slots drain ahead of new admissions."""
        if self._brownout is not None and self._brownout.stage >= 3:
            return min(self._step_token_budget, self.max_batch + _RAGGED_BROWNOUT_CHUNK)
        return self._step_token_budget

    # -- preemptible batch lane -----------------------------------------------

    def _maybe_preempt(self) -> None:
        """Loop thread, chunk boundary: with interactive work queued and no
        slot free for it, preempt batch-lane slots, one per waiting
        interactive request. A quarantined slot counts as free here: it
        opens within a chunk, and preempting another slot meanwhile would
        preempt twice per arrival at depth 2."""
        if not self._preempt:
            return
        want = self._pending.waiting("interactive")
        if want <= 0:
            return
        free = sum(1 for i, r in enumerate(self._slot_req)
                   if r is None and i not in self._admitting)
        need = want - free
        while need > 0:
            victim_slot, victim_key = None, None
            for slot, request in enumerate(self._slot_req):
                if request is None or request.priority == "interactive":
                    continue
                if request.cancelled or request.produced < 1:
                    continue
                if request._preempt_count >= self._preempt_budget:
                    continue  # budget spent: immune, so batch work finishes
                key = (_CLASS_RANK[request.priority],          # lowest class
                       request._deadline if request._deadline is not None
                       else float("inf"),                       # latest deadline
                       -request.produced)                       # least progress
                if victim_key is None or key > victim_key:
                    victim_slot, victim_key = slot, key
            if victim_slot is None or not self._preempt_slot(victim_slot):
                return
            need -= 1

    def _preempt_slot(self, slot: int) -> bool:
        """Preempt the batch-lane request in ``slot``: requeue it with its
        whole history as the prompt, and with its KV pages, which leave the
        slot with it; the slot is quarantined while a chunk in flight still
        decodes it. The stream stays open: the resume maps the pages back
        and decodes on from the last token, so no prefill recomputes the
        history (a bf16 prefill of a Llama-3-8B history through other
        kernels than the decode steps that wrote its KV can change a later
        token). The reference, without its prefix cache, prefills the
        history again; with it, it replays the stored pages. False when
        the ``engine.preempt`` seam aborted the preemption (the request
        keeps decoding in its slot)."""
        request = self._slot_req[slot]
        if request is None:
            return False
        try:
            faults.fire("engine.preempt", request=request)
        except faults.InjectedFault:
            return False
        self.counters["preemptions"] += 1
        request._preempt_count += 1
        request.prompt_ids = list(request.prompt_ids) + [int(t) for t in request._gen_ids]
        request._gen_ids = []
        # the pages hold the KV of the history but its last token; a chunk
        # still in flight writes only past that, and the resume's first
        # decode step rewrites it after that chunk on the same stream
        request._parked = self.paged_cache.pool.detach(slot)
        # the queue-wait budget restarts for the resume leg: time spent
        # generating must not count against it
        qt = request.queue_timeout if request.queue_timeout is not None else self._queue_timeout
        request._queue_deadline = time.monotonic() + qt if qt is not None else None
        self._slot_req[slot] = None
        self._free_slot_pages(slot)
        self._pending.put_nowait(request)
        return True

    # -- deadlines ------------------------------------------------------------

    def _resolve_deadlines(self, request: GenRequest) -> None:
        """Pin the request's monotonic deadlines at submission (its own
        budgets override the engine's defaults)."""
        now = time.monotonic()
        qt = request.queue_timeout if request.queue_timeout is not None else self._queue_timeout
        tt = request.ttft_timeout if request.ttft_timeout is not None else self._ttft_timeout
        tot = request.total_timeout if request.total_timeout is not None else self._total_timeout
        request._queue_deadline = now + qt if qt is not None else None
        request._ttft_deadline = now + tt if tt is not None else None
        request._deadline = now + tot if tot is not None else None

    def _expire_pending(self) -> None:
        """Fail queued requests whose queue-wait or total deadline passed
        (the loop top, and the watchdog while the loop is wedged)."""
        queue = self._pending.requests()
        if not queue:
            return
        now = time.monotonic()
        for request in queue:
            if request.cancelled or request.error is not None:
                continue
            err = None
            if request._queue_deadline is not None and now > request._queue_deadline:
                self.counters["deadline_queue"] += 1
                err = DeadlineExceededError(
                    "request spent its queue-wait budget before admission", stage="queue")
            elif request._deadline is not None and now > request._deadline:
                self.counters["deadline_total"] += 1
                err = DeadlineExceededError("request budget elapsed while queued",
                                            stage="total")
            if err is not None:
                request.error = err
                request.cancelled = True  # the admission pop drops it
                request.out_queue.put_nowait(_FINISHED)

    def _release_parked(self, request: GenRequest) -> None:
        """Free a preempted request's parked KV pages (a queue exit other
        than its resume)."""
        if request._parked is not None:
            self.paged_cache.pool.release(request._parked)
            request._parked = None

    def _deadline_error_at_commit(self, request: GenRequest) -> Optional[BaseException]:
        """The TTFT and total deadlines, checked when an admission is about
        to activate its slot."""
        now = time.monotonic()
        if (request._ttft_deadline is not None and request.first_token_at is None
                and now > request._ttft_deadline):
            self.counters["deadline_ttft"] += 1
            return DeadlineExceededError("no first token within the ttft budget", stage="ttft")
        if request._deadline is not None and now > request._deadline:
            self.counters["deadline_total"] += 1
            return DeadlineExceededError("request budget elapsed during admission",
                                         stage="total")
        return None

    async def generate(self, request: GenRequest) -> AsyncIterator[int]:
        """Submit a request; yields sampled token ids as they decode."""
        if self._stopped:
            raise EngineUnavailableError("engine is stopped")
        self.validate(request)
        self.check_admission(request)
        self._resolve_deadlines(request)
        request.prompt_len = len(request.prompt_ids)
        request.out_queue = asyncio.Queue()
        self._pending.put_nowait(request)
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
        """Stop the loop and fail every active and pending request (503);
        the loop's exit frees the pages once the chunks in flight landed."""
        self._stopped = True
        err = EngineUnavailableError("engine stopped")
        for slot, request in enumerate(self._slot_req):
            if request is not None:
                self._fail_slot(slot, err)
        for job in list(self._prefill_jobs):
            self._fail_ragged_job(job, err)
        for request in self._pending.pop_all():
            self._release_parked(request)
            request.error = err
            request.out_queue.put_nowait(_FINISHED)

    @property
    def active_slots(self) -> int:
        return sum(1 for r in self._slot_req if r is not None)

    @property
    def is_ready(self) -> bool:
        """False while the engine is stopped or the watchdog is recovering
        (the HTTP app's ``/ready``)."""
        return not self._stopped and not self._recovering

    def _lifecycle_fields(self) -> dict:
        """The lifecycle keys ``health()`` and ``lifecycle_stats()`` share."""
        return {
            "queue_depth": self._pending.qsize(),
            "queue_depths": self._pending.depths(),
            "active_slots": self.active_slots,
            "preemptions": self.counters["preemptions"],
            "brownout": self._brownout_snapshot(),
            "watchdog_trips": self.counters["watchdog_trips"],
            "step_failures": self.counters["step_failures"],
        }

    def health(self) -> dict:
        return dict(
            self._lifecycle_fields(),
            ready=self.is_ready,
            stopped=self._stopped,
            recovering=self._recovering,
            cache=self.cache_mode,
            device=str(self.device),
            max_batch=self.max_batch,
            free_pages=self.paged_cache.pool.free_pages,
            kv_dtype=self.paged_cache.pool_dtype,
            kv_pool_bytes=self.paged_cache.pool_bytes(),
            weights={
                "quant": self.weight_quant or "none",
                "bytes": self.model.weight_bytes(),
            },
            counters=dict(self.counters),
            pipeline=self._pipeline_snapshot(),
            scheduler="ragged" if self._ragged else "two_dispatch",
            ragged=self._ragged_snapshot(),
        )

    def _ragged_snapshot(self) -> Optional[dict]:
        if not self._ragged:
            return None
        return {
            "step_token_budget": self._step_token_budget,
            "effective_budget": self._effective_token_budget(),
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
            "spec_tree_fallbacks": self.counters["spec_tree_fallbacks"],
            "spec_proposer": (
                dict(self._spec_proposer.stats(), name=self._spec_proposer.name)
                if self._spec_proposer is not None else None
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
        """Scrape-time snapshot with the reference's ``lifecycle_stats``
        keys this slice serves (counters monotonic, gauges instantaneous)."""
        c = self.counters
        return dict(
            self._lifecycle_fields(),
            ready=int(self.is_ready),
            sheds={"queue": c["sheds_queue"], "pool": c["sheds_pool"]},
            sheds_by_class={reason: dict(per) for reason, per in self._class_sheds.items()},
            deadlines={"queue": c["deadline_queue"], "ttft": c["deadline_ttft"],
                       "total": c["deadline_total"]},
            pipeline=self._pipeline_snapshot(),
            scheduler="ragged" if self._ragged else "two_dispatch",
            ragged=self._ragged_snapshot(),
        )

    async def wait_drained(self, timeout: float = 30.0) -> None:
        """Await the loop going idle (no active slots, nothing pending)."""
        task = self._loop_task
        if task is not None and not task.done():
            await asyncio.wait_for(asyncio.shield(task), timeout)

    # -- loop ----------------------------------------------------------------

    def _ensure_loop(self) -> None:
        loop = asyncio.get_running_loop()
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = loop.create_task(self._run_loop())
        if self._watchdog_interval and (self._watchdog_task is None
                                        or self._watchdog_task.done()):
            self._watchdog_task = loop.create_task(self._watchdog_loop())

    async def _run_loop(self) -> None:
        try:
            while not self._stopped:
                self._expire_pending()
                if self._recovering and not self._inflight:
                    # a trip that found no stale chunk to land (the loop
                    # was in an admission): recover at this boundary
                    await self._finish_recovery()
                # SLO scheduling: the brownout stage from the pressure
                # signals, then, with interactive work waiting and no slot
                # free, a batch-lane preemption at this chunk boundary
                self._update_brownout()
                self._maybe_preempt()
                if self._ragged:
                    self._ragged_admission()
                else:
                    await self._admit()
                active = np.array([r is not None for r in self._slot_req])
                if not active.any() and not self._inflight and not self._prefill_jobs:
                    if self._pending.empty():
                        faults.fire("engine.drain")
                        return  # drained; a new generate() restarts the loop
                    continue
                # a watchdog trip (epoch bump) during this step makes the
                # step's results stale
                step_epoch = self._recover_epoch
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
                            await self._ragged_step(active, step_epoch)
                    else:
                        await self._decode_step(active, step_epoch)
                except Exception as ex:
                    await self._handle_step_failure(ex, step_epoch)
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
            # no worker is left: every slot the watchdog failed gets its
            # pages back
            self._free_unowned_slots()
            self._recovering = False
            if self._stopped and self._watchdog_task is not None:
                self._watchdog_task.cancel()

    def _on_stream(self, fn, *args):
        """Run ``fn`` on the engine's stream: a worker thread starts on the
        default one."""
        if self._stream is None:
            return fn(*args)
        with torch.cuda.stream(self._stream):
            return fn(*args)

    async def _admit(self) -> None:
        """Admission of pending requests into free slots, in the queue's
        class order: prefill, pages, first token. A quarantined slot is
        not free yet."""
        free = [i for i, r in enumerate(self._slot_req)
                if r is None and i not in self._quarantine]
        while free and not self._pending.empty() and not self._stopped:
            request = self._pending.get_nowait()
            if request.cancelled:
                self._release_parked(request)
                request.out_queue.put_nowait(_FINISHED)
                continue
            slot = free.pop(0)
            if request._parked is not None:
                self._resume_slot(request, slot)
                continue
            self._call_since = time.monotonic()
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
            finally:
                self._call_since = None
            if self._stopped:  # stop() ran during the prefill
                self.paged_cache.pool.free(slot)
                request.error = EngineUnavailableError("engine stopped")
                request.out_queue.put_nowait(_FINISHED)
                return
            err = self._deadline_error_at_commit(request)
            if err is not None:
                # the prefill outlived the request's ttft/total budget: a
                # structured 408 instead of a slot commit
                self.paged_cache.pool.free(slot)
                request.error = err
                request.out_queue.put_nowait(_FINISHED)
                free.insert(0, slot)
                continue
            self._activate_slot(request, slot, first_id)
            self._last_progress = time.monotonic()

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

    def _occupy_slot(self, request: GenRequest, slot: int, next_token: int,
                     history: List[int]) -> None:
        """Slot bookkeeping of an admission's activation and of a
        preempted request's resume: the request, the admission record
        behind Retry-After, the next decode input (taken from the host at
        the next dispatch), the speculation history (prompt and emitted
        tokens) and the sampling parameters."""
        self._slot_req[slot] = request
        self._admit_times.append(time.monotonic())
        self._admit_count += 1
        request._gen_ids = []  # a resume leg's history is in prompt_ids
        self._next_token[slot] = next_token
        self._slot_overrides[slot] = True
        if self._tokbuf is not None:
            row = np.zeros(self._tokbuf.shape[1], np.int32)
            ids = history[: self._tokbuf.shape[1]]
            row[: len(ids)] = ids
            self._tokbuf[slot] = row
        self._temperature[slot] = request.temperature
        self._top_k[slot] = request.top_k
        self._top_p[slot] = request.top_p

    def _activate_slot(self, request: GenRequest, slot: int, first_id: int) -> None:
        """An admission's slot goes live with its first token."""
        self._occupy_slot(request, slot, first_id, list(request.prompt_ids) + [first_id])
        self._emit(slot, first_id)

    def _resume_slot(self, request: GenRequest, slot: int) -> None:
        """A preempted request back in a slot: its parked pages hold the KV
        of its history but the last token, which is the next decode input;
        its next token comes from the next decode step."""
        pages, request._parked = request._parked, None
        self.paged_cache.pool.attach(slot, pages, len(request.prompt_ids) - 1)
        self._occupy_slot(request, slot, request.prompt_ids[-1], request.prompt_ids)
        self._last_progress = time.monotonic()

    # -- pipelined decode: dispatch / retire ----------------------------------

    async def _decode_step(self, active_mask: np.ndarray, epoch: int) -> None:
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
                await self._dispatch_or_recover(dispatch_mask.copy(), epoch)
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
                    self._dispatch_async(dispatch_mask.copy(), epoch),
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

    async def _dispatch_or_recover(self, mask: np.ndarray, epoch: int) -> None:
        """Dispatch with failure recovery, where no retire runs
        concurrently (the gather branch recovers after both settle)."""
        try:
            await self._dispatch_async(mask, epoch)
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
        emissions landed (a recovery may have emptied the queue)."""
        entry = self._inflight[0]
        await self._retire_chunk(entry)
        if self._inflight and self._inflight[0] is entry:
            self._inflight.popleft()

    def _dispatchable_mask(self, active_mask: np.ndarray) -> np.ndarray:
        """Slots worth including in the NEXT chunk: active, and not already
        certain to finish inside the chunks in flight (by their token
        budget, brownout's batch cap included, or the sequence limit; a
        stop token stays unpredictable, and its surplus tokens are dropped
        at emission)."""
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
                    self._effective_max_new(request),
                    self.max_seq_len - request.prompt_len):
                mask[slot] = False
        return mask

    async def _dispatch_async(self, active_mask: np.ndarray, epoch: int) -> None:
        """Dispatch one chunk: its host state is snapshotted on the loop
        thread (``_prepare_dispatch``), then the device work runs in a
        worker thread, possibly beside the previous chunk's retirement.
        Appends the in-flight entry and fails pool-exhausted slots."""
        prep = self._prepare_dispatch(active_mask, epoch)
        # barrier visibility: a slot freed by the concurrent retire must
        # see this chunk before its entry lands in the queue
        self._dispatching = (prep["seq"], prep["active_mask"])
        self._call_since = time.monotonic()
        try:
            entry = await asyncio.to_thread(self._on_stream, self._dispatch_device, prep)
        finally:
            self._dispatching = None
            self._call_since = None
        self._inflight.append(entry)
        if entry.epoch != self._recover_epoch:
            # the watchdog tripped during this dispatch and failed its
            # requests: queued, the entry's work is waited out with the
            # rest of the pipeline before any page is freed
            await self._finish_recovery()
            return
        for slot in entry.exhausted:
            self._fail_slot(slot, MemoryError("kv page pool exhausted for this sequence"))

    def _prepare_dispatch(self, active_mask: np.ndarray, epoch: int) -> dict:
        """Loop-thread half of a dispatch: allocate the chunk's pages
        host-side (a slot the pool cannot extend leaves the chunk, its row
        writing the null page) and write every host input of the chunk
        into its own staging buffers (``ChunkLayout``; pinned on the card),
        so the worker never reads state the concurrent retire stage
        changes, and no later change reaches a copy still pending."""
        self._last_progress = time.monotonic()
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
        prep = {
            "seq": self._dispatch_seq,
            "epoch": epoch,
            "active_mask": active_mask,
            "exhausted": exhausted,
            "host_i32": host_i32,
            "host_f32": host_f32,
            # the greedy variant draws no noise
            "greedy": not (self._temperature[active_mask] > 0).any(),
            "requests": [r for r in self._slot_req if r is not None],
        }
        try:
            faults.fire("engine.dispatch.prepare", requests=prep["requests"])
        except faults.InjectedFault:
            self._give_back_extension(prep)
            raise
        return prep

    def _give_back_extension(self, prep: dict) -> None:
        """A dispatch that failed before enqueueing any device work returns
        its chunk's page extension: each slot's length goes back to where
        the chunk found it."""
        lengths0 = self._layout.views(prep["host_i32"].numpy(),
                                      prep["host_f32"].numpy())["lengths0"]
        for slot in np.nonzero(prep["active_mask"])[0]:
            self.paged_cache.pool.truncate(int(slot), int(lengths0[slot]))

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
        if faults.active():
            try:
                faults.fire("engine.decode", requests=prep["requests"])
            except faults.InjectedFault:
                self._give_back_extension(prep)
                raise
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
        self._last_progress = time.monotonic()
        self._hist_dispatch.observe((time.perf_counter() - t0) * 1e3)
        return _InFlightChunk(seq=prep["seq"], active_mask=prep["active_mask"],
                              tokens=tokens, ready=ready, exhausted=prep["exhausted"],
                              epoch=prep["epoch"])

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
        released. A chunk that lands under an older recover epoch was
        failed by the watchdog: the pipeline is discarded instead."""
        t0 = time.perf_counter()
        if faults.active() or (entry.ready is not None and not entry.ready.query()):
            requests = [r for r in self._slot_req if r is not None]

            def wait():
                # the stall seam wedges this worker, never the event loop,
                # so the watchdog sees the stall
                faults.fire("engine.decode.stall", requests=requests)
                if entry.ready is not None:
                    entry.ready.synchronize()

            await asyncio.to_thread(wait)
        if entry.epoch != self._recover_epoch:
            await self._finish_recovery()
            return
        try:
            faults.fire("engine.decode.retire",
                        requests=[r for r in self._slot_req if r is not None])
        except faults.InjectedFault as ex:
            if ex.request is None:
                raise  # batch-wide: the loop's step-failure path
            self.counters["step_failures"] += 1
            for slot, request in enumerate(self._slot_req):
                if request is ex.request:
                    self._fail_slot(slot, EngineStepError(
                        "retire failed for this request: {}".format(ex)))
                    break
            # the rest of the chunk still emits
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
        self._last_progress = time.monotonic()
        self._hist_retire.observe((time.perf_counter() - t0) * 1e3)

    async def _handle_step_failure(self, ex: Exception, epoch: int) -> None:
        """A step raised (dispatch, capture, retire or a ragged launch).
        One attributed to a single request (a matched fault) fails that
        request; otherwise every request's device state is suspect: the
        pipeline is discarded and every active request and admission job
        fails with ``EngineStepError``. The loop keeps serving."""
        if epoch != self._recover_epoch:
            # the watchdog already failed this step's requests
            await self._finish_recovery()
            return
        self.counters["step_failures"] += 1
        target = getattr(ex, "request", None)
        if target is not None:
            for slot, request in enumerate(self._slot_req):
                if request is target:
                    self._fail_slot(slot, EngineStepError(
                        "decode step failed for this request: {}".format(ex)))
                    break
            return
        logger.exception("decode step failed")
        await self._discard_pipeline()
        err = EngineStepError("decode step failed: {}".format(ex))
        for slot, request in enumerate(self._slot_req):
            if request is not None:
                self._fail_slot(slot, err)
        for job in list(self._prefill_jobs):
            self._fail_ragged_job(job, err)
        self._last_progress = time.monotonic()

    # -- watchdog and recovery ------------------------------------------------

    async def _watchdog_loop(self) -> None:
        """Detects a stalled loop (no progress within ``watchdog_interval``
        while slots are active), fails only the in-flight requests and arms
        the epoch recovery. Also expires queued requests' deadlines while
        the loop is wedged."""
        interval = float(self._watchdog_interval)
        tick = max(0.01, interval / 4.0)
        try:
            while not self._stopped:
                await asyncio.sleep(tick)
                self._expire_pending()
                if (self._loop_task is None or self._loop_task.done()
                        or self.active_slots == 0):
                    # nothing to supervise; stay alive for the next request
                    self._last_progress = time.monotonic()
                    continue
                since = self._call_since
                if since is not None and time.monotonic() - since < 10.0 * interval:
                    # a worker is inside a device call: first-use work (the
                    # kernel build, a graph capture while serving) runs
                    # there and may take seconds. The grace is bounded; a
                    # stalled replay shows at the retire wait, where none
                    # applies
                    continue
                if time.monotonic() - self._last_progress > interval:
                    self._watchdog_trip(interval)
        except asyncio.CancelledError:
            return

    def _watchdog_trip(self, interval: float) -> None:
        faults.fire("engine.watchdog",
                    requests=[r for r in self._slot_req if r is not None])
        self.counters["watchdog_trips"] += 1
        self._recovering = True
        self._recover_epoch += 1
        err = EngineStuckError(
            "decode loop made no progress for {:.1f}s; failing in-flight requests "
            "and recovering".format(interval))
        for slot, request in enumerate(self._slot_req):
            if request is not None:
                request.error = err
                request.out_queue.put_nowait(_FINISHED)
                self._slot_req[slot] = None
                # the pages stay: a chunk in flight may still write them;
                # _finish_recovery frees them once the card is done
        self._last_progress = time.monotonic()

    async def _finish_recovery(self) -> None:
        """After a stale-epoch leg landed: discard the in-flight pipeline,
        wait until the card has finished the work already enqueued on the
        engine's stream (the replays of the discarded chunks write the
        pages), free every unowned slot's pages and report ready again.
        Deferred while a dispatch is mid-call: that leg completes the
        recovery when it lands."""
        if self._dispatching is not None:
            return
        await self._discard_pipeline()
        self._free_unowned_slots()
        self._recovering = False
        self._last_progress = time.monotonic()

    def _free_unowned_slots(self) -> None:
        """Free the pages of every slot no request or admission owns."""
        for slot in range(self.max_batch):
            if self._slot_req[slot] is None and slot not in self._admitting:
                self.paged_cache.pool.free(slot)

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
        if request._deadline is not None and time.monotonic() > request._deadline:
            # the total budget ran out mid-decode: a structured 408, the
            # slot reclaimed
            self.counters["deadline_total"] += 1
            self._fail_slot(slot, DeadlineExceededError(
                "request budget elapsed after {} tokens".format(request.produced),
                stage="total"))
            return
        request.produced += 1
        if request.priority != "interactive":
            # preemptible lane: a preemption folds these into the resume
            # prompt
            request._gen_ids.append(int(token_id))
        self.counters["tokens_emitted"] += 1
        if request.first_token_at is None:
            request.first_token_at = time.time()
            self.ttft_ms.append((request.first_token_at - request.submitted_at) * 1e3)
        request.out_queue.put_nowait(token_id)
        if (
            token_id == self.eos_token_id
            or request.produced >= self._effective_max_new(request)
            or request.prompt_len + request.produced >= self.max_seq_len
        ):
            self._finish_slot(slot, request)

    # -- ragged scheduler ------------------------------------------------------

    def _ragged_admission(self) -> None:
        """Admission into free slots under the ragged scheduler, in the
        queue's class order: each request opens a job at prompt position 0
        whose prompt rides the loop's launches as chunk rows (the
        reference's ``_ragged_admission_task`` and ``_start_ragged_job``;
        this slice has no worker-thread preparation and no prefix cache,
        so the job opens at once)."""
        free = [i for i, r in enumerate(self._slot_req)
                if r is None and i not in self._admitting and i not in self._quarantine]
        while free and not self._pending.empty() and not self._stopped:
            request = self._pending.get_nowait()
            if request.cancelled:
                self._release_parked(request)
                request.out_queue.put_nowait(_FINISHED)
                continue
            slot = free.pop(0)
            if request._parked is not None:
                self._resume_slot(request, slot)
                continue
            self._admitting.add(slot)
            self._prefill_jobs.append(_RaggedJob(request=request, slot=slot))
            self._last_progress = time.monotonic()

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
        """Drop cancelled and deadline-expired jobs before planning a step:
        budget spent on a dead admission is budget stolen from live ones."""
        for job in list(self._prefill_jobs):
            if job.request.cancelled:
                self._fail_ragged_job(job, None)
                continue
            err = self._deadline_error_at_commit(job.request)
            if err is not None:
                self._fail_ragged_job(job, err)

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
        verify rows, admissions or not. Brownout stage 1+ parks speculation:
        the verify slack and the k wasted positions of a reject are
        headroom an overloaded engine no longer has."""
        if not (self._ragged and self._speculation) or not active_mask.any():
            return False
        if self._brownout is not None and self._brownout.stage >= 1:
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
        self._last_progress = time.monotonic()
        self._sweep_ragged_jobs()
        decode_mask = active_mask.copy()
        budget = self._effective_token_budget()
        n_decode = int(decode_mask.sum())
        k_ = self._spec_k
        spec_mask = np.zeros(self.max_batch, bool)
        sspec_mask = np.zeros(self.max_batch, bool)
        if self._ragged_spec_wanted(decode_mask):
            greedy, sampled_m = self._spec_eligible_mask(decode_mask)
            spec_mask, sspec_mask = greedy.copy(), sampled_m.copy()
            try:
                # chaos seam: a proposer or tree-layout failure demotes the
                # matched row (unmatched: every verify row) to plain decode
                # in this same launch; nothing was allocated yet
                faults.fire("engine.spec.tree", requests=[
                    self._slot_req[int(s)] for s in np.nonzero(spec_mask | sspec_mask)[0]])
            except faults.InjectedFault as ex:
                self.counters["spec_tree_fallbacks"] += 1
                for s in np.nonzero(spec_mask | sspec_mask)[0]:
                    if ex.request is None or self._slot_req[int(s)] is ex.request:
                        spec_mask[int(s)] = False
                        sspec_mask[int(s)] = False
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
            remaining_new = self._effective_max_new(request) - request.produced
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

    async def _ragged_step(self, active_mask: np.ndarray, epoch: int) -> None:
        """One ragged scheduling iteration: ONE mixed launch carries every
        decode row and as many prefill-chunk rows as fit the budget; serial
        dispatch -> sync -> emit, with the pipeline drained. A failed launch
        raises to the loop's step-failure path, which fails every request
        and job; the loop keeps serving."""
        # the decode chunks after this step take every token from the host
        # mirrors this step's retire updates
        self._reset_device_chains()
        plan = self._prepare_ragged(active_mask)
        if plan is None:
            return
        self._call_since = time.monotonic()
        try:
            result = await asyncio.to_thread(self._on_stream, self._dispatch_ragged_device, plan)
        finally:
            self._call_since = None
        if epoch != self._recover_epoch:
            await self._ragged_recover(plan)
            return
        self._retire_ragged(plan, result)

    async def _ragged_recover(self, plan: dict) -> None:
        """The watchdog tripped during this ragged step: its decode rows'
        requests were failed and nothing may commit. The step's device work
        ended with its reads; the surviving jobs' pages roll back to their
        pre-step lengths (the next step redoes the chunk), then the shared
        recovery runs."""
        pool = self.paged_cache.pool
        for job, _take in plan["shares"]:
            if job in self._prefill_jobs:
                pool.truncate(job.slot, int(plan["pre_lens"][job.slot]))
        await self._finish_recovery()

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
            err = self._deadline_error_at_commit(request)
            if err is not None:
                request.error = err
                request.out_queue.put_nowait(_FINISHED)
                self.paged_cache.pool.free(job.slot)
                continue
            row = result["finish_rows"].index(job.slot)
            first_id = self._first_token(request, result["logits"][row:row + 1])
            self._activate_slot(request, job.slot, first_id)
        self._last_progress = time.monotonic()
