"""Continuous-batching LLM engine over the paged KV cache.

Counterpart of ``clearml_serving_tpu/llm/engine.py``'s ``LLMEngineCore`` in
the configuration ``cache_mode="paged"``, under either scheduler:

- a fixed ``max_batch`` of slots; FIFO admission into free slots;
- decode = chunks of ``decode_steps`` fused steps over the whole slot batch,
  each step ``Llama.decode_paged`` (the paged attention kernel once per
  layer) followed by sampling (``llm/decode_graph.py``); the chunk's tokens
  reach the host once, at its end, and fan out to the per-request queues;
- a request finishes on a stop token (its ``stop_token_ids``, else EOS),
  ``max_new_tokens`` or ``max_seq_len``; its pages return to the pool once
  no chunk in flight still writes them.

The sampling surface (the reference's ``SamplingExtras``): presence,
frequency and repetition penalties, a logit bias, a per-request ``seed``,
``min_tokens`` and ``logprobs`` ride every decode step as batch data. The
histogram of generated tokens, the bias rows and the prompt masks are
``[max_batch, V]`` device rows (``ExtrasState``), made at the first commit
with extras and reset at every commit after, on the engine's stream; a
chunk with an active extras slot runs the extras variant of its graph,
which advances the histogram in place, and a seeded row's draw comes from
``fold_in(PRNGKey(seed), counter)`` with the counter counting the chunks in
flight, so a seeded stream is the JAX engine's whatever the depth, the
batch or the graph. Every admission samples its first token, with its
first logprob entry, through ``_first_token``. Rows with extras or
logprobs never verify drafts and are never preempted; ``score_prompt``
scores a prompt teacher-forced for the completions route's ``echo`` and
``prompt_logprobs``.

Guided decoding (the reference's ``llm/guided.py`` grammars): a request's
``guided`` spec compiles once per unique spec, in the admission worker,
into one COMBINED state space (each grammar at its own state offset), so
mixed-grammar batches share one mask/byte-table pair; the device copy is
padded to a power-of-two state count, one buffer pair per bucket at a
fixed address, written on the engine's stream. The first token is masked
by the grammar's start row and its state walked on the host; each decode
step then masks, samples and advances every guided slot's DFA state on
the device, chained across chunks as the tokens are (a guided variant of
the chunk's graph per bucket). Guided slots never verify drafts and are
never preempted; a grammar's registry reference (the ledger's
``guided.ref``) moves from the admission to the slot at commit and drops
when the slot frees.

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

``scheduler="two_dispatch"``: each admission prefills in a background task
(``_admission_task``) whose worker thread, on the engine's stream, runs the
prompt's prefill at its bucket (with ``chunked_prefill_size`` C, a prompt
longer than C in C-token ``prefill_chunk`` segments over a fresh dense
mini cache) and samples the first token from the last prompt position; it
touches no slot and no page. The task hands the first token and the mini
cache to the ``_ready`` queue, and the loop commits them at its next chunk
boundary, interactive first: the K/V is written into the slot's pages,
the prompt stored in the prefix cache, the slot activated and the first
token emitted. Decode chunks keep dispatching meanwhile. ``_PrefillGate``
paces the prefill dispatches against them: while decode is active, at most
``prefill_segments_per_decode`` segments (default 2; brownout stage 3: 1)
enter the stream per retired chunk, a single-dispatch interactive
admission bypasses it, and ``prefill_stall_timeout`` bounds a wait. A
dispatch the gate holds back hands the admission back to the event loop,
which waits for the permit there (``_run_prefill``), so the stream's one
prefill thread serves the other admissions meanwhile. One
dispatch's launches enqueue under a lock, so they stay contiguous on the
stream beside other admissions', as the reference's compiled dispatch is.

Automatic prefix caching (``prefix_cache``, ``llm/prefix_cache.py``): a
radix tree of block-aligned prompt prefixes whose nodes hold references on
the pool's pages. An admission's commit stores its prompt by reference to
the slot's own pages; a later prompt sharing a stored run maps those pages
into its page table (no KV copy) and prefills only the tail: under
``two_dispatch`` through ``Llama.prefill_chunk`` over the gathered pages,
under ``ragged`` as chunk rows that read the mapped pages through the
ragged kernel. A write into a page still shared elsewhere copies it first
(copy on write), on the engine's stream ahead of the launch that writes
it. ``TPUSERVE_SANITIZE=1`` audits the page accounting after every step
and at drain (``llm/kv_sanitizer.py``). With ``prefix_cache_host_pages``
(or ``prefix_cache_host_bytes``, a size or "auto") the cache demotes runs
over its device budgets into a pinned host-RAM tier instead of dropping
them, and a hit on a demoted run promotes it with copies enqueued on the
engine's stream ahead of the launches that read it; the loop reaps the
finished promotions at its retire boundaries and waits for the rest at
drain. ``TPUSERVE_LEDGER=1|strict`` arms the ownership ledger
(``llm/lifecycle_ledger.py``): every acquire and release of pages, pins,
hits, host pages, quarantine entries and promotions is recorded and
audited per request at its exit and over the engine at drain.

``scheduler="ragged"``: admission opens a job instead of running a prefill.
While jobs exist, each step is ONE mixed launch (``Llama.forward_ragged``,
the ragged attention kernel once per layer): every decode row with a
multi-step window (``ragged_decode_steps``, widened from the budget left
over) and prefill-chunk rows that share ``step_token_budget`` tokens in
admission order. A decode row's window chains ``decode_paged`` steps after
the mixed pass in the same step; a job's final chunk samples the first
token and activates its slot. With no jobs left, decode chunks resume. A
step's inputs are staged on the host into two packed buffers after its
page allocation (``_stage_ragged``, ``llm/ragged_graph.py``'s
``RaggedLayout``); on the card the step is one CUDA-graph replay of its
launch key (``RaggedVariant``, captured by ``warmup(full=True)`` or at its
first use), eagerly ``run_ragged`` on the CPU or with ``cuda_graphs`` off.

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
as the prompt and its KV pages (with the cache on, its history is also
stored for other admissions to share), and its resume maps them back and
decodes on, so its stream is the one it would have been. Chaos seams
(``llm/faults.py``) drive each path in the tests.

Disaggregated prefill/decode (``llm/replica.py`` with roles): an engine
wired to a KV transport (``attach_kv_transport``) ships a prefill leg's
storable prefix pages at its commit (``_maybe_ship``; under the ragged
scheduler, whole pages ship ahead as partial frames at each chunk boundary,
``_maybe_ship_draft``), and a decode replica imports a shipment into its
prefix cache before the stream's admission (``receive_shipment``), which
then runs as a prefix hit. Every failure drops to a recompute.

Device work runs in worker threads, on the engine's CUDA stream (the
current stream when it was built: a replica group builds its replicas
past the first on streams of their own), so the event loop keeps serving
HTTP while the card computes. The engines on one stream enqueue their
prefills on that stream's one prefill thread, one dispatch per job, and
each runs its steps on a thread of its own, leased from the stream's pool
(``device.prefill_worker``, ``device.lease_step_worker``). The engines of
a group share one ``Llama``.
The model arrives with its weights already in their serving format
(``build_engine`` quantizes them);
``weight_quant``/``quantize`` are accepted when they name that format.
Every reference knob this slice does not serve raises, naming itself.
"""

from __future__ import annotations

import asyncio
import contextlib
import functools
import heapq
import itertools
import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Deque, Dict, List, Optional

import numpy as np
import torch

from ..errors import (
    DeadlineExceededError,
    EngineOverloadedError,
    EngineStepError,
    EngineStuckError,
    EngineUnavailableError,
)
from ..device import lease_step_worker, prefill_worker, return_step_worker
from ..models.llama import Llama
from ..ops.gates import check_engine_gates
from ..ops.paged_attention import RAGGED_QB, ragged_layout, tree_ancestors
from .decode_graph import (
    ChunkLayout,
    ChunkVariant,
    DecodeGraphs,
    ExtrasState,
    extras_host_rows,
    run_chunk,
)
from . import kv_cache, lifecycle_ledger
from .ragged_graph import (
    RaggedGraphs,
    RaggedLayout,
    RaggedVariant,
    plain_variants,
    ragged_draws,
    run_ragged,
)
from . import guided as _guided
from .kv_cache import PagedKVCache
from .kv_sanitizer import KVSanitizer, enabled as sanitizer_enabled
from .prefix_cache import RadixPrefixCache
from .sampling import (
    GUIDED_FILL,
    STOP_SLOTS,
    SamplingExtras,
    SamplingParams,
    gumbel_noise,
    logprobs_of,
    penalize_logits,
    sample_penalized,
    sample_tokens,
    top_k,
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
    # the tokens the request finishes on (None: the engine's EOS)
    stop_token_ids: Optional[List[int]] = None
    # OpenAI/vLLM sampling parameters, applied on the device as batch data
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    seed: Optional[int] = None
    logit_bias: Optional[Dict[int, float]] = None
    # top alternatives to record per emitted token (None: no logprobs; 0:
    # the chosen token's logprob only)
    logprobs: Optional[int] = None
    # vLLM min_tokens: the stop tokens are suppressed until this many
    # tokens were generated
    min_tokens: int = 0
    # grammar constraint (llm/guided.py GuidedSpec): compiled at admission,
    # enforced on the device inside the decode chunk
    guided: Optional[Any] = None
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
    # queue (the KV of all its history but the last token), held as pool
    # pins (the ledger's ``pages.pin``, owned by this request); its resume
    # maps them back into a slot. Every queue exit that is not a resume
    # releases them (_release_parked)
    _parked: Optional[List[int]] = None
    # engine-internal (prefix cache): a lookup's pinned hit, carried from
    # the lookup to the commit that maps its pages; every failure path
    # between the two releases it (_release_prefix_hit)
    _prefix_hit: Optional[dict] = None
    # engine-internal (guided decoding): the combined-table DFA state after
    # the first token, and the registry key whose reference the admission
    # holds until its commit hands it to the slot
    _gstate0: int = -1
    _guided_key: Optional[str] = None
    # disaggregated prefill/decode (llm/replica.py): the group sets
    # _ship_to on the prefill leg's clone (the decode replica its commit
    # ships the prefix pages to) and _shipped on the original request, so
    # the decode replica's admission books the shipped prefix's fate
    _ship_to: Optional[str] = None
    _shipped: bool = False
    # filled by the engine:
    out_queue: "asyncio.Queue" = field(default_factory=asyncio.Queue)
    produced: int = 0
    prompt_len: int = 0
    submitted_at: float = field(default_factory=time.time)
    first_token_at: Optional[float] = None
    error: Optional[BaseException] = None
    # per emitted token (when logprobs is not None): {"id", "logprob",
    # "top_ids", "top_logprobs"}; entry i is appended before token i is
    # queued, so a consumer that just received token i may read entry i
    logprob_entries: List[dict] = field(default_factory=list)
    # set by the API layer when a stop string matched in the decoded text
    stopped_on_string: bool = False
    # set by the consumer (client gone): the engine frees the slot at the
    # next emission instead of decoding to max_new_tokens for nobody
    cancelled: bool = False

    def cancel(self) -> None:
        self.cancelled = True


_FINISHED = object()


class _ShipShim:
    """Carrier for the ``engine.kv.receive`` fault seam, which matches on
    ``prompt_ids`` (the receive runs before the stream's request exists on
    the decode replica)."""

    def __init__(self, prompt_ids: List[int]):
        self.prompt_ids = list(prompt_ids)


# prompt scoring takes its softmax and top-k in blocks of this many positions
_SCORE_BLOCK = 256
# chunks dispatched ahead of retirement: 1 is the serial dispatch -> sync ->
# emit loop; 2 (the reference's default) overlaps chunk N's readback and
# emission with chunk N+1's dispatch
_DEFAULT_PIPELINE_DEPTH = 2
# the reference's _MsHistogram buckets (ms)
_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0)
# the combined grammar tables' state budget: states are int16 on the device
_GUIDED_STATE_BUDGET = 32000
# the host tier's auto-sizing (prefix_cache_host_bytes="auto"): half of
# MemAvailable, clamped to this range
_AUTO_HOST_TIER_MIN_BYTES = 64 << 20
_AUTO_HOST_TIER_MAX_BYTES = 16 << 30


def auto_host_tier_pages(page_bytes: int) -> int:
    """The host tier's page count under ``prefix_cache_host_mb: "auto"``
    (the reference's sizing): half of /proc/meminfo's ``MemAvailable``,
    split between the engine processes sharing the host, clamped to 64
    MiB-16 GiB, in pages of ``page_bytes``. Raises
    ``HostTierAutoSizeError`` where MemAvailable cannot be read."""
    budget = (kv_cache.available_host_memory_bytes() // 2
              // kv_cache.cohosted_worker_processes())
    budget = min(max(budget, _AUTO_HOST_TIER_MIN_BYTES), _AUTO_HOST_TIER_MAX_BYTES)
    return max(1, budget // int(page_bytes))


def _owner(request: "GenRequest"):
    """The ledger's owner context for acquires made on ``request``'s behalf
    (a no-op while the ledger is disarmed)."""
    return lifecycle_ledger.owner(lifecycle_ledger.request_tag(request))


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
    # a logprob variant's (chosen [B, steps], top ids, top logprobs [B,
    # steps, K]) on the host, filled with ``tokens``
    lp: Optional[tuple] = None
    # a guided variant's DFA states [B] after the chunk, on the host
    gstate: Optional[torch.Tensor] = None


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
    - 3: and the admission budget shrunk (the ragged step's token share,
      or the two-dispatch prefill gate's segments per chunk), best-effort
      shed at the door.

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


class _PrefillGate:
    """Decode-first pacing of the two-dispatch admission prefills (the
    reference's ``_PrefillGate``).

    Admission prefills run on their stream's prefill thread beside the
    decode chunks, and every dispatch lands on the engine's one stream: an
    unpaced segment train would enqueue ahead of the next decode chunk and
    stretch the live rows' inter-token gaps. While decode is active, at most
    ``segments_per_chunk`` prefill dispatches enter the stream per decode
    chunk: the loop ``deposit()``s that many permits at each retire, and an
    admission takes one per dispatch by awaiting ``wait()`` on the loop (a
    thread blocks in ``acquire()`` instead); both go through ``take()``.

    ``stall_timeout`` bounds a wait the other way: when decode stops
    depositing (the loop wedged), a waiting prefill proceeds after that many
    seconds. It must exceed one decode chunk by far, or segments would time
    out past the gate mid-chunk and void the bound."""

    def __init__(self, segments_per_chunk: int = 2, stall_timeout: float = 2.0):
        self._spc_cfg = max(1, int(segments_per_chunk))
        self._spc = self._spc_cfg
        self._stall_timeout = float(stall_timeout)
        self._cond = threading.Condition()
        self._permits = self._spc
        self._active = False
        # futures of the admissions awaiting a permit on an event loop
        self._waiters: List[asyncio.Future] = []

    def _notify(self) -> None:
        """Under ``_cond``: wake every waiter, blocked or awaiting."""
        self._cond.notify_all()
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            try:
                fut.get_loop().call_soon_threadsafe(_resolve, fut)
            except RuntimeError:
                pass  # its loop has closed

    def set_budget(self, segments_per_chunk: Optional[int]) -> None:
        """Brownout's override of the per-chunk budget (stage 3 sets 1, so
        decode slots drain ahead of new admissions); None restores the
        configured value."""
        with self._cond:
            self._spc = (max(1, int(segments_per_chunk)) if segments_per_chunk
                         else self._spc_cfg)
            self._permits = min(self._permits, self._spc)
            self._notify()

    def set_active(self, active: bool) -> None:
        """Loop thread: whether decode has live slots; inactive opens the
        gate."""
        with self._cond:
            self._active = bool(active)
            if not self._active:
                self._permits = self._spc
                self._notify()

    def deposit(self) -> None:
        """Loop thread: a decode chunk retired. Permits are set, never
        accumulated: an idle stretch must not bank a burst for later."""
        with self._cond:
            self._permits = self._spc
            self._notify()

    def take(self, bypass: bool = False) -> bool:
        """Whether one prefill dispatch may enter the stream now, taking a
        permit where one is needed. ``bypass``: a single-dispatch
        interactive admission skips the pacing, since one dispatch cannot
        train, and parking a first token behind a batch admission's permit
        inverts priorities; an interactive segment train is paced like any
        other."""
        if bypass:
            return True
        with self._cond:
            if not self._active:
                return True
            if self._permits > 0:
                self._permits -= 1
                return True
            return False

    def acquire(self, bypass: bool = False) -> None:
        """Thread: wait (boundedly) before one prefill dispatch; timed out
        without a permit, it proceeds (the starvation bound)."""
        with self._cond:
            self._cond.wait_for(lambda: self.take(bypass), timeout=self._stall_timeout)

    async def wait(self, bypass: bool = False) -> None:
        """Event loop: ``acquire`` without blocking the loop."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self._stall_timeout
        while True:
            with self._cond:
                if self.take(bypass):
                    return
                fut = loop.create_future()
                self._waiters.append(fut)
            left = deadline - loop.time()
            if left <= 0:
                return
            try:
                await asyncio.wait_for(fut, left)
            except asyncio.TimeoutError:
                return


def _resolve(fut: asyncio.Future) -> None:
    if not fut.done():
        fut.set_result(None)


# reference engine knobs this slice does not serve (each raises when set)
UNSUPPORTED_KNOBS = (
    "mesh", "long_prefill_threshold", "long_bucket_step", "lora_adapters",
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
        # two-dispatch admissions: prompts longer than chunked_prefill_size
        # prefill in segments of that many tokens; the prefill gate admits
        # prefill_segments_per_decode of them per decode chunk while decode
        # is active (None/0: no gate), a wait bounded by
        # prefill_stall_timeout seconds (None: 2.0)
        chunked_prefill_size: Optional[int] = None,
        prefill_segments_per_decode: Optional[int] = 2,
        prefill_stall_timeout: Optional[float] = None,
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
        # automatic prefix caching: a radix tree of up to prefix_cache
        # block-aligned prompt-prefix runs over shared, refcounted pages
        prefix_cache: Optional[int] = None,
        prefix_block: int = 64,
        prefix_cache_bytes: Optional[int] = None,
        prefix_cache_pages: Optional[int] = None,
        # the host-RAM tier behind the prefix cache: its page count, or a
        # byte budget ("auto": sized from MemAvailable)
        prefix_cache_host_pages: Optional[int] = None,
        prefix_cache_host_bytes=None,
        # the top-k ceiling of logprob reporting (OpenAI top_logprobs)
        logprobs_k: int = 20,
        # guided decoding's token byte tables come from it (None: guided
        # requests are refused)
        tokenizer=None,
        # this engine's replica id in a fleet ("rN", llm/replica.py): its
        # health() and lifecycle_stats() carry it, and the metrics label
        # its series with it
        replica: Optional[str] = None,
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
        # the host tier's knobs, checked as the reference checks them: a
        # budget that silently does nothing reads as "tiering on"
        host_auto = (isinstance(prefix_cache_host_bytes, str)
                     and prefix_cache_host_bytes.strip().lower() == "auto")
        if isinstance(prefix_cache_host_bytes, str) and not host_auto:
            raise ValueError(
                "prefix_cache_host_bytes (aux engine.prefix_cache_host_mb) must be a size "
                "or 'auto': got {!r}".format(prefix_cache_host_bytes))
        if host_auto and prefix_cache_host_pages:
            raise ValueError(
                "prefix_cache_host_mb='auto' derives the host page count itself; drop "
                "engine.prefix_cache_host_pages (or set an explicit size)")
        if prefix_cache_host_bytes and not host_auto and not prefix_cache_host_pages:
            raise ValueError(
                "prefix_cache_host_bytes (aux engine.prefix_cache_host_mb) is set but the "
                "host tier is disabled: set prefix_cache_host_pages (aux "
                "engine.prefix_cache_host_pages) to enable it")
        if (prefix_cache_host_pages or host_auto) and (cache_mode != "paged"
                                                       or not prefix_cache):
            raise ValueError(
                "prefix_cache_host_pages (or prefix_cache_host_mb='auto') needs "
                "cache_mode='paged' and a prefix_cache on a bundle with prefill_chunk (the "
                "host tier spills the paged radix prefix cache)")
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
        self.replica_id = str(replica) if replica is not None else None
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
        # -- two-dispatch admission: chunked prefill and the prefill gate.
        # The ragged scheduler builds no gate: its admissions ride the
        # decode launches, paced by the step token budget
        self._chunked = int(chunked_prefill_size or 0)
        self._prefill_gate = (
            _PrefillGate(int(prefill_segments_per_decode),
                         **({"stall_timeout": float(prefill_stall_timeout)}
                            if prefill_stall_timeout else {}))
            if (prefill_segments_per_decode and not self._ragged) else None
        )
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
        # automatic prefix caching (llm/prefix_cache.py): a hit maps the
        # cached pages into the slot's page table by reference and only
        # the tail prefills; storing a prompt takes references on the
        # slot's own pages
        self._prefix: Optional[RadixPrefixCache] = None
        if prefix_cache:
            pool = self.paged_cache.pool
            # shared runs cover whole pages: a block ending mid-page would
            # put a live slot's writes inside a shared page
            block = -(-int(prefix_block) // pool.page_size) * pool.page_size
            # a cached page's device bytes: K and V, and the scale rows on
            # int8 pools
            page_bytes = sum(self.paged_cache.pool_bytes().values()) // pool.num_pages
            # the host-RAM tier: pinned page slabs preallocated here, so
            # eviction demotes into host RAM instead of dropping
            tier_backend = None
            if host_auto:
                prefix_cache_host_pages = auto_host_tier_pages(page_bytes)
                prefix_cache_host_bytes = None  # the budget is the capacity
            if prefix_cache_host_pages:
                self.paged_cache.enable_host_tier(int(prefix_cache_host_pages))
                tier_backend = self.paged_cache
            self._prefix = RadixPrefixCache(
                int(prefix_cache), block, max_bytes=prefix_cache_bytes,
                max_pages=prefix_cache_pages, pool=pool, page_bytes=page_bytes,
                backend=tier_backend, host_max_bytes=prefix_cache_host_bytes)
        # a hit's tail prefills in segments of this many tokens
        self._prefix_chunk = max(1, int(prefix_block))
        # the runtime KV sanitizer (TPUSERVE_SANITIZE=1): page accounting
        # audited after every loop step and at drain
        self._sanitizer = (KVSanitizer(self.paged_cache.pool, self._prefix,
                                       paged_cache=self.paged_cache)
                           if sanitizer_enabled() else None)
        # the ownership ledger (TPUSERVE_LEDGER=1|strict): acquires and
        # releases audited per request at its exit and over the engine at
        # drain; process-wide, shared by every engine of the process
        self._ledger = lifecycle_ledger.arm() if lifecycle_ledger.enabled() else None
        # promotions the loop saw complete
        self._promotion_reaps = 0
        self._gen = torch.Generator(self.device)
        self._gen.manual_seed(int(rng_seed))
        # the generator is drawn from by the admission workers' first
        # tokens and the decode dispatch's noise, on two threads
        self._rng_lock = threading.Lock()
        # the admission workers' counter updates
        self._count_lock = threading.Lock()
        # held by an admission worker while it enqueues one prefill
        # dispatch (``_prefill_dispatch``)
        self._prefill_lock = threading.Lock()
        # the sampling extras: the logprob top-k every chunk reports, and
        # the device rows (histogram, bias, prompt mask), made when the
        # first request with extras commits and reset at every commit after
        self._lp_k = max(1, int(logprobs_k))
        self._extras: Optional[ExtrasState] = None
        # guided decoding: grammars compile once per unique spec into ONE
        # combined state space (per-grammar offsets), so mixed-grammar
        # batches share one mask/byte-table pair. The device copy pads the
        # state count to a power of two: one buffer pair per bucket, never
        # moved (graphs read it by address), written on the engine's stream.
        # The bucket only grows; an outgrown bucket's buffers and graphs go
        # once the launches that read them have run
        self._guided_lock = threading.Lock()
        self._tokenizer = tokenizer
        self._grammars: Dict[str, dict] = {}          # key -> entry
        self._gmask_np: Optional[np.ndarray] = None   # [S, ceil(V/8)] uint8
        self._gbyte_np: Optional[np.ndarray] = None   # [S, 256] int16
        self._gtok_bytes = None                       # the tokenizer's token_byte_table
        self._gtok_np = None                          # (tok_bytes [V, 16], tok_len [V])
        self._gtok_dev = None
        self._gdev: Dict[int, tuple] = {}             # bucket -> (mask, byte) buffers
        self._gbucket = 0                             # the bucket holding the rows
        self._gsynced = 0                             # host rows copied into it
        self._gstale: List[tuple] = []                # (outgrown bucket, event after its reads)
        # ragged scheduler: guided admissions whose grammar compiles in a
        # worker (the task's strong refs), and the (request, slot) pairs
        # handed back to the loop, each slot reserved in _admitting
        # meanwhile (two-dispatch admissions compile in their admission task)
        self._grammar_preps: set = set()
        self._prepped: Deque[tuple] = deque()
        # bumped when every grammar drained and the tables were rebuilt:
        # states chained on the device from before are stale
        self._gepoch = 0
        # the epoch of the last guided dispatch (None after a plain one or a
        # chain reset): a guided dispatch under another takes every slot's
        # state from the host mirror
        self._gchain_epoch: Optional[int] = None
        self._gstate = np.full(self.max_batch, -1, np.int32)
        self._slot_guided_key: List[Optional[str]] = [None] * self.max_batch
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
        # per thread), so prefills, chunks, readbacks and the host tier's
        # promotions run in order; the cache's (the current stream when it
        # was built)
        self._stream = self.paged_cache.stream
        # the stream's one prefill thread, and a step thread of the
        # engine's own, leased from the stream's pool until the engine is
        # collected: cuBLAS keeps a 32 MiB workspace per (thread, stream),
        # which the event loop's pool of worker threads would multiply, for
        # every stream a fleet adds (``device.prefill_worker``)
        self._workers = {"prefill": prefill_worker(self._stream),
                         "step": lease_step_worker(self._stream)}
        weakref.finalize(self, return_step_worker, self._stream, self._workers["step"])
        # on the card each chunk is a CUDA-graph replay unless cuda_graphs
        # is off; the eager arm keeps its chain in _chain
        self._graphs = (DecodeGraphs(model, self.paged_cache, self._layout, self.decode_steps,
                                     state_fn=lambda: self._extras, lp_k=self._lp_k,
                                     tables_fn=self._guided_tables_of)
                        if self._stream is not None and cuda_graphs else None)
        # the ragged launch: its inputs' staging layout, and on the card one
        # CUDA graph per launch key over static buffers (unless cuda_graphs
        # is off), the verify rows' kind fixed by the engine's knobs
        self._verify_kind = ("tree" if self._spec_tree
                             else "chain" if self._speculation else "")
        self._ragged_layout = (RaggedLayout(self.max_batch, self._ragged_tpad, self._ragged_qb,
                                            self._pages_per_seq, self._ragged_steps_cap,
                                            self._spec_k)
                               if self._ragged else None)
        self._ragged_graphs = (RaggedGraphs(model, self.paged_cache, self._ragged_layout,
                                            block_map=self._ragged_qb > 1,
                                            spec=bool(self._speculation),
                                            state_fn=lambda: self._extras, lp_k=self._lp_k,
                                            tables_fn=self._guided_tables_of)
                               if self._ragged and self._graphs is not None else None)
        # first-use capture time of each variant (ms), by label
        self._capture_ms: Dict[str, float] = {}
        self._chain = torch.zeros(self.max_batch, dtype=torch.int32, device=self.device)
        self._gchain = torch.full((self.max_batch,), -1, dtype=torch.int32, device=self.device)
        self._warming = False
        self._hist_dispatch = _Histogram(_MS_BUCKETS)
        self._hist_retire = _Histogram(_MS_BUCKETS)
        # slot bookkeeping (loop thread)
        self._slot_req: List[Optional[GenRequest]] = [None] * self.max_batch
        self._next_token = np.zeros(self.max_batch, np.int32)
        self._temperature = np.zeros(self.max_batch, np.float32)
        self._top_k = np.zeros(self.max_batch, np.int32)
        self._top_p = np.ones(self.max_batch, np.float32)
        # the extras' host rows (the reference's per-slot arrays)
        self._slot_extra = np.zeros(self.max_batch, bool)
        self._presence = np.zeros(self.max_batch, np.float32)
        self._frequency = np.zeros(self.max_batch, np.float32)
        self._repetition = np.ones(self.max_batch, np.float32)
        self._seeds = np.full(self.max_batch, -1, np.int64)
        self._min_tokens = np.zeros(self.max_batch, np.int32)
        self._stop_rows = np.full((self.max_batch, STOP_SLOTS), -1, np.int32)
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
        # monotonic start of the loop's device call a worker thread is in (a
        # chunk dispatch, a ragged step): the watchdog's grace for first-use
        # work (the kernel build, a CUDA-graph capture while serving,
        # library handles). Admission prefills never set it: the loop keeps
        # making progress beside them
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
        # two-dispatch admissions: the background tasks (strong refs: the
        # event loop keeps only weak ones), the (request, slot, first id,
        # mini cache, first logprob entry) tuples they hand the loop, and
        # the event that wakes an idle loop when one lands (made per loop
        # run: an asyncio.Event binds to the event loop it first waits on)
        self._admission_tasks: set = set()
        self._ready: Deque[tuple] = deque()
        self._wake: Optional[asyncio.Event] = None
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
                         "ragged_replays": 0, "serve_captures": 0,
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
        # -- disaggregated prefill/decode: the KV-transport endpoint and the
        # replica's role (attach_kv_transport; None: a monolithic engine),
        # the ship and receive counters, each slot's draft-ahead stream
        # (offset shipped so far, aborted), and the ship / receive times
        self._kv_transport = None
        self.replica_role = "hybrid"
        self._kv_ship_stats = {
            "ships": 0, "ship_pages": 0, "ship_drops": 0, "receives": 0,
            "receive_pages": 0, "receive_empty": 0, "receive_failures": 0,
            "hits": 0, "recomputes": 0, "draft_ships": 0, "draft_pages": 0,
            "draft_aborts": 0,
        }
        self._kv_draft_ahead: Dict[int, dict] = {}
        self._hist_ship_ms = _Histogram(_MS_BUCKETS)
        self._hist_receive_ms = _Histogram(_MS_BUCKETS)
        # set by a replica group whose engines share the card: their
        # captures, warmup's included, run in the thread-local mode, since
        # a sibling may be serving meanwhile
        self._cohosted = False

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
        vocab = self.model.vocab_size
        if request.logit_bias:
            for tok in request.logit_bias:
                try:
                    tok_i = int(tok)
                except (TypeError, ValueError):
                    raise ValueError("logit_bias keys must be token ids (got {!r})".format(tok))
                if not 0 <= tok_i < vocab:
                    raise ValueError("logit_bias token id {} out of range for vocab {}".format(
                        tok_i, vocab))
        if request.repetition_penalty is not None and request.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")
        if request.min_tokens:
            if request.min_tokens < 0:
                raise ValueError("min_tokens must be >= 0")
            if request.min_tokens > request.max_new_tokens:
                raise ValueError("min_tokens {} exceeds max_tokens {}".format(
                    request.min_tokens, request.max_new_tokens))
            if len(request.stop_token_ids or []) > STOP_SLOTS:
                # the floor's suppression rows are fixed-width: an unsuppressed
                # stop id could end the sequence before the floor
                raise ValueError("min_tokens supports at most {} stop_token_ids (got {})".format(
                    STOP_SLOTS, len(request.stop_token_ids)))
        if request.logprobs is not None:
            if request.logprobs < 0:
                raise ValueError("logprobs must be >= 0")
            if request.logprobs > self._lp_k:
                raise ValueError("logprobs={} exceeds the engine's logprobs_k={}".format(
                    request.logprobs, self._lp_k))
        if request.max_new_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if any(not 0 <= int(t) < vocab for t in request.prompt_ids):
            raise ValueError("prompt token id out of range for vocab {}".format(vocab))
        if request.guided is not None:
            if self._tokenizer is None:
                raise ValueError("guided decoding needs the engine's tokenizer "
                                 "(constructed without one)")
            if self.eos_token_id is None:
                raise ValueError("guided decoding requires an eos token")
            spec = request.guided
            if spec.kind not in ("regex", "json_schema", "json_object"):
                raise ValueError("unknown guided kind {!r}".format(spec.kind))
            # a cheap syntactic pre-flight, so a 4xx precedes the stream's
            # headers; the full compile (the token lifting) runs at admission
            try:
                if spec.kind == "regex":
                    _guided._Parser(spec.payload).parse()
                elif spec.kind == "json_schema":
                    _guided.json_schema_to_regex(json.loads(spec.payload))
            except _guided.RegexError as ex:
                raise ValueError("invalid guided grammar: {}".format(ex))
            except Exception as ex:
                raise ValueError("invalid guided schema: {}".format(ex))

    # -- guided decoding: the grammar registry ---------------------------------

    def _ensure_grammar(self, request: GenRequest) -> dict:
        """Compile (or reuse) the request's grammar and splice it into the
        combined host tables; the request takes one registry reference
        (``guided.ref``). Runs in an admission worker: the compile (DFA and
        token lifting) can take seconds at a large vocab. Returns the
        registry entry {offset, n_states, start, terminal, refs}."""
        key = request.guided.cache_key()
        with self._guided_lock:
            entry = self._grammars.get(key)
            if entry is not None:
                entry["refs"] += 1
                request._guided_key = key
                self._ledger_guided_acquire(key, request)
                return entry
            token_bytes = self._gtok_bytes
        # the O(V) token byte table is the tokenizer's: built once, shared
        # by every grammar's compile and the device walk
        if token_bytes is None:
            token_bytes = _guided.token_byte_table(self._tokenizer, self.model.vocab_size)
        # compile outside the lock (pure); splice under it
        grammar = _guided.compile_guided(request.guided, self._tokenizer, self.model.vocab_size,
                                         self.eos_token_id, token_bytes=token_bytes)
        with self._guided_lock:
            entry = self._grammars.get(key)
            if entry is not None:  # another admission raced this one: reuse its
                entry["refs"] += 1
                request._guided_key = key
                self._ledger_guided_acquire(key, request)
                return entry
            if self._gtok_bytes is None:
                self._gtok_bytes = token_bytes
            if self._gtok_np is None:
                self._gtok_np = _guided.build_token_byte_arrays(token_bytes)
            # int16 device states: the combined table stays bounded so
            # offsets never wrap; fails only this request, and only while
            # many distinct grammars are alive at once
            total = self._gmask_np.shape[0] if self._gmask_np is not None else 0
            if total + grammar.n_states > _GUIDED_STATE_BUDGET:
                raise ValueError(
                    "guided-grammar state budget exhausted ({} + {} states); retry when "
                    "active grammars drain".format(total, grammar.n_states))
            # compaction, only when every grammar is dead (no slot state and
            # no admission holds a key: a partial rebuild would shift the
            # offsets under states already computed)
            if self._grammars and all(e["refs"] <= 0 for e in self._grammars.values()):
                self._grammars.clear()
                self._gmask_np = self._gbyte_np = None
                self._gepoch += 1
                self._gsynced = 0
            offset = self._gmask_np.shape[0] if self._gmask_np is not None else 0
            entry = {"offset": offset, "n_states": grammar.n_states,
                     "terminal": offset + grammar.terminal, "start": offset + grammar.start,
                     "refs": 1, "grammar": grammar}
            self._grammars[key] = entry
            self._append_guided_tables_locked(grammar)
            request._guided_key = key
            self._ledger_guided_acquire(key, request)
            return entry

    def _append_guided_tables_locked(self, grammar) -> None:
        """Append a grammar's rows to the combined host tables, its byte
        transitions shifted by its offset."""
        offset = self._gmask_np.shape[0] if self._gmask_np is not None else 0
        byte = grammar.byte_trans.astype(np.int32)
        byte = np.where(byte == _guided.DEAD, _guided.DEAD, byte + offset).astype(np.int16)
        if self._gmask_np is None:
            self._gmask_np = grammar.mask_bits.copy()
            self._gbyte_np = byte
        else:
            self._gmask_np = np.vstack([self._gmask_np, grammar.mask_bits])
            self._gbyte_np = np.vstack([self._gbyte_np, byte])

    def _guided_device_tables(self) -> int:
        """Loop thread, before a launch with a guided slot: the state
        bucket of the combined tables (the power of two at or above their
        state count), its device buffers made current. The copies go on
        the engine's stream, so they land behind every launch in flight
        and ahead of this one: rows appended since the last call, or the
        whole padded table after a growth into a larger bucket or a
        rebuild. The bucket never shrinks (a rebuild keeps it), so buckets
        do not come and go with the traffic; an outgrown bucket's buffers
        and graphs are dropped once the launches enqueued before the growth
        have run (``_drop_outgrown_buckets``)."""
        self._drop_outgrown_buckets()
        with self._guided_lock:
            if self._gmask_np is None:
                return 0
            rows = self._gmask_np.shape[0]
            bucket = max(shapes.pow2_bucket(rows), self._gbucket)
            if bucket == self._gbucket and self._gsynced == rows:
                return bucket
            lo = self._gsynced if bucket == self._gbucket else 0
            if bucket != self._gbucket and self._gbucket:
                event = None
                if self._stream is not None:
                    event = torch.cuda.Event()
                    event.record(self._stream)
                self._gstale.append((self._gbucket, event))
            self._on_stream(self._write_guided_tables, bucket, self._gmask_np,
                            self._gbyte_np, lo)
            self._gbucket, self._gsynced = bucket, rows
            return bucket

    def _drop_outgrown_buckets(self) -> None:
        """Free the buffers and graphs of the buckets the tables outgrew
        whose last reader has run: every launch that read one was enqueued
        before the event recorded at the growth."""
        while self._gstale and (self._gstale[0][1] is None or self._gstale[0][1].query()):
            bucket, _event = self._gstale.pop(0)
            self._gdev.pop(bucket, None)
            for graphs in (self._graphs, self._ragged_graphs):
                if graphs is not None:
                    graphs.drop_guided(bucket)

    def _write_guided_tables(self, bucket: int, mask_np: np.ndarray, byte_np: np.ndarray,
                             lo: int) -> None:
        """Rows ``lo`` on of the combined tables into the bucket's buffers
        (from ``lo`` 0, the padding too: mask rows empty, byte rows DEAD)."""
        dev = self.device
        rows = mask_np.shape[0]
        pair = self._gdev.get(bucket)
        if pair is None:
            pair = (torch.zeros((bucket, mask_np.shape[1]), dtype=torch.uint8, device=dev),
                    torch.full((bucket, 256), _guided.DEAD, dtype=torch.int16, device=dev))
            self._gdev[bucket] = pair
        hi = bucket if lo == 0 else rows
        mask = np.zeros((hi - lo, mask_np.shape[1]), np.uint8)
        mask[:rows - lo] = mask_np[lo:rows]
        byte = np.full((hi - lo, 256), _guided.DEAD, np.int16)
        byte[:rows - lo] = byte_np[lo:rows]
        for dst, src in zip(pair, (mask, byte)):
            dst[lo:hi].copy_(self._host_tensor(src), non_blocking=True)
        if self._gtok_dev is None:
            self._gtok_dev = tuple(self._host_tensor(a).to(dev, non_blocking=True)
                                   for a in self._gtok_np)

    def _host_tensor(self, array: np.ndarray) -> torch.Tensor:
        """A host array as a tensor to copy from: pinned on the card, so
        the copy enqueues without waiting for the stream (the caching host
        allocator keeps it until the copy ran)."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if self._stream is not None else t

    def _device_tensor(self, values, dtype) -> torch.Tensor:
        """Host values (a list or an array; ``dtype`` a numpy dtype) on the
        engine's device, copied on the current stream without waiting for
        the work queued on it: an admission worker's inputs must not wait
        for the decode chunks enqueued ahead of them."""
        return self._host_tensor(np.asarray(values, dtype=dtype)).to(self.device,
                                                                    non_blocking=True)

    def _guided_tables_of(self, bucket: int) -> tuple:
        """(mask bits, byte table, token bytes, token lengths) on the
        device, the first two the bucket's buffers."""
        return self._gdev[bucket] + self._gtok_dev

    def _guided_snapshot(self) -> dict:
        """The registry's size: grammars, their references, the combined
        state count, the device bucket and the device tables' bytes."""
        with self._guided_lock:
            states = self._gmask_np.shape[0] if self._gmask_np is not None else 0
            return {
                "grammars": len(self._grammars),
                "refs": sum(e["refs"] for e in self._grammars.values()),
                "states": states,
                "bucket": self._gbucket,
                "table_bytes": sum(t.numel() * t.element_size()
                                   for pair in self._gdev.values() for t in pair),
            }

    def _release_guided(self, slot: int, request: Optional[GenRequest] = None) -> None:
        """A slot frees: its DFA state clears and its grammar reference
        drops. The key was captured at commit (``_slot_req[slot]`` is
        already None on some finish paths); a caller holding the request
        passes it, so the ledger discharges that request's entry."""
        self._gstate[slot] = -1
        key, self._slot_guided_key[slot] = self._slot_guided_key[slot], None
        if key is not None:
            self._deref_guided_key(key, request)

    def _deref_guided_request(self, request: GenRequest) -> None:
        """An admission failed or was dropped before its commit: return the
        reference ``_ensure_grammar`` took (no-op otherwise)."""
        key, request._guided_key = request._guided_key, None
        if key is not None:
            self._deref_guided_key(key, request)

    def _deref_guided_key(self, key: str, request: Optional[GenRequest] = None) -> None:
        with self._guided_lock:
            entry = self._grammars.get(key)
            if entry is not None:
                entry["refs"] -= 1
                if self._ledger is not None:
                    self._ledger.release(
                        "guided.ref", key=key, domain=self,
                        owner=lifecycle_ledger.request_tag(request) if request is not None
                        else None)

    def _ledger_guided_acquire(self, key: str, request: GenRequest) -> None:
        """One registry reference taken on the request's behalf
        (``_ensure_grammar``'s three take paths)."""
        if self._ledger is not None:
            self._ledger.acquire("guided.ref", key=key, domain=self,
                                 owner=lifecycle_ledger.request_tag(request))

    @property
    def logprobs_k(self) -> int:
        """The top-k ceiling of logprob reporting (OpenAI top_logprobs and
        vLLM prompt_logprobs validate against it)."""
        return self._lp_k

    # -- sampling extras (penalties, bias, seeds, min_tokens) ------------------

    def _request_stop_row(self, request: GenRequest) -> np.ndarray:
        """The stop set the min_tokens floor suppresses, the one ``_emit``
        finishes on: stop_token_ids if given, else the engine's EOS."""
        ids = request.stop_token_ids or (
            [self.eos_token_id] if self.eos_token_id is not None else [])
        row = np.full(STOP_SLOTS, -1, np.int32)
        for i, t in enumerate(ids[:STOP_SLOTS]):
            row[i] = int(t)
        return row

    @staticmethod
    def _request_has_extras(request: GenRequest) -> bool:
        return bool(
            request.presence_penalty
            or request.frequency_penalty
            or (request.repetition_penalty and request.repetition_penalty != 1.0)
            or request.seed is not None
            or request.logit_bias
            or request.min_tokens > 0
        )

    @staticmethod
    def _request_seed(request: GenRequest) -> int:
        # masked before the int64 store: JSON ints are unbounded
        return -1 if request.seed is None else int(request.seed) & 0x7FFFFFFF

    @staticmethod
    def _request_min_new(request: GenRequest) -> int:
        return min(max(0, int(request.min_tokens or 0)), 2 ** 31 - 1)

    def _extras_active(self, active_mask: np.ndarray) -> bool:
        return self._extras is not None and bool(np.any(self._slot_extra[active_mask]))

    def _bias_pmask_rows(self, request: GenRequest):
        """The request's dense bias row and prompt-token mask [V] (host)."""
        vocab = self.model.vocab_size
        bias = np.zeros(vocab, np.float32)
        for tok, value in (request.logit_bias or {}).items():
            tok = int(tok)
            if 0 <= tok < vocab:
                bias[tok] = float(value)
        pmask = np.zeros(vocab, bool)
        pmask[[t for t in request.prompt_ids if 0 <= t < vocab]] = True
        return bias, pmask

    def _request_extras_row(self, request: GenRequest):
        """Single-row extras for a first token: (extras, counts, prompt
        mask) on the device, the histogram empty and the counter 0."""
        dev = self.device
        bias, pmask = self._bias_pmask_rows(request)
        seed = self._request_seed(request)
        extras = SamplingExtras(
            presence=self._device_tensor([request.presence_penalty], np.float32),
            frequency=self._device_tensor([request.frequency_penalty], np.float32),
            repetition=self._device_tensor([request.repetition_penalty or 1.0], np.float32),
            bias=self._device_tensor(bias[None], np.float32),
            seeds=self._device_tensor([seed], np.int32) if seed >= 0 else None,
            counters=torch.zeros(1, dtype=torch.int32, device=dev),
            min_new=self._device_tensor([self._request_min_new(request)], np.int32),
            stop=self._device_tensor(self._request_stop_row(request)[None], np.int32),
        )
        return (extras, torch.zeros((1, self.model.vocab_size), dtype=torch.int32, device=dev),
                self._device_tensor(pmask[None], pmask.dtype))

    def _set_slot_extras(self, request: GenRequest, slot: int,
                         first_id: Optional[int]) -> None:
        """A commit's extras rows: the host rows, and, once the device rows
        exist (from the first commit with extras on), the slot's device rows
        reset on the engine's stream (a previous occupant's bias, mask or
        histogram must not reach this request)."""
        has_extras = self._request_has_extras(request)
        self._slot_extra[slot] = has_extras
        self._presence[slot] = request.presence_penalty
        self._frequency[slot] = request.frequency_penalty
        self._repetition[slot] = request.repetition_penalty or 1.0
        self._seeds[slot] = self._request_seed(request)
        self._min_tokens[slot] = self._request_min_new(request)
        self._stop_rows[slot] = self._request_stop_row(request)
        if not has_extras and self._extras is None:
            return
        bias, pmask = (self._host_tensor(a) for a in self._bias_pmask_rows(request))

        def reset():
            # made and written on the engine's stream, which every chunk
            # reading the rows runs on
            if self._extras is None:
                self._extras = ExtrasState(self.max_batch, self.model.vocab_size, self.device)
            self._extras.reset_row(slot, first_id, bias, pmask)

        self._on_stream(reset)

    def _batch_extras_rows(self, v: dict, active_mask: np.ndarray) -> None:
        """Write a chunk's extras rows into its staging views: the
        per-slot config, and the seed counters, which account for the
        chunks still in flight (a slot advances decode_steps per chunk that
        decodes it; a dead slot's counter is garbage, its samples dropped
        at retire)."""
        produced = np.array([r.produced if r is not None else 0 for r in self._slot_req],
                            np.int64)
        for entry in self._inflight:
            produced += entry.active_mask.astype(np.int64) * self.decode_steps
        v["active"][:] = active_mask
        v["seeds"][:] = self._seeds
        v["counters"][:] = produced
        v["min_new"][:] = self._min_tokens
        v["stop"][:] = self._stop_rows
        v["presence"][:] = self._presence
        v["frequency"][:] = self._frequency
        v["repetition"][:] = self._repetition

    def _wants_logprobs(self, mask: np.ndarray) -> bool:
        return any(self._slot_req[s] is not None and self._slot_req[s].logprobs is not None
                   for s in np.nonzero(mask)[0])

    def _lp_entry(self, token_id: int, chosen, top_ids, top_lp) -> dict:
        return {"id": int(token_id), "logprob": float(chosen),
                "top_ids": [int(t) for t in top_ids], "top_logprobs": [float(x) for x in top_lp]}

    def score_prompt(self, prompt_ids: List[int]) -> List[dict]:
        """Teacher-forced prompt scoring (the reference's ``score_prompt``):
        logprob entries (``logprob_entries``' shape plus the exact vocab
        ``rank``) for positions 1..n-1; the first token has no conditional.
        One forward of the prompt at its prefill bucket, then the final norm,
        the lm_head, ``log_softmax`` and the top-k in sequential blocks of
        256 positions, so the float32 logits of the whole prompt never exist
        at once. Read-only on the pools; runs on the engine's stream."""
        n = len(prompt_ids)
        if n < 2:
            return []
        return self._on_stream(self._score_prompt, list(prompt_ids))

    def _score_prompt(self, ids: List[int]) -> List[dict]:
        n = len(ids)
        bucket = shapes.bucket_for(n, self._buckets, self.max_seq_len)
        tokens = torch.zeros((1, bucket), dtype=torch.long)
        tokens[0, :n] = torch.as_tensor(ids, dtype=torch.long)
        dev = self.device
        hidden = self.model.hidden_states(
            tokens.to(dev), torch.tensor([n], dtype=torch.int32, device=dev))[0]
        tgt = torch.as_tensor(ids[1:], dtype=torch.long).to(dev)
        parts = []
        for lo in range(0, n - 1, _SCORE_BLOCK):
            hi = min(n - 1, lo + _SCORE_BLOCK)
            lp = torch.log_softmax(self.model.logits_of(hidden[lo:hi]), dim=-1)
            chosen = lp.gather(-1, tgt[lo:hi, None])[:, 0]
            # the exact rank among the whole vocab (vLLM prompt_logprobs)
            rank = 1 + (lp > chosen[:, None]).sum(dim=-1)
            top_lp, top_id = top_k(lp, self._lp_k)
            parts.append((chosen, rank, top_id, top_lp))
        chosen, rank, top_id, top_lp = (torch.cat(p).cpu().numpy() for p in zip(*parts))
        return [{"id": int(ids[i + 1]), "logprob": float(chosen[i]), "rank": int(rank[i]),
                 "top_ids": top_id[i].tolist(), "top_logprobs": top_lp[i].tolist()}
                for i in range(n - 1)]

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
            need_tokens = len(request.prompt_ids) + 1
            if self._prefix is not None:
                # a cached prefix maps in by reference: only the tail needs
                # fresh pages
                need_tokens -= self._prefix.match_len(request.prompt_ids)
            saturated = not pool.can_allocate(need_tokens)
            try:
                faults.fire("engine.pool", request=request)
            except faults.InjectedFault:
                saturated = True
            if saturated:
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
        headroom = pool.free_pages
        if self._prefix is not None:
            # as the reference: the cache's pages count as headroom, though
            # its eviction runs only when a store or an unpin finds it over
            # a budget, never for an allocation
            headroom += self._prefix.cached_pages
        signals["pool"] = max(0.0, (usable - headroom) / usable)
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
        prev = self._brownout.stage
        stage = self._brownout.update(score, signals, now)
        if stage != prev and self._prefill_gate is not None:
            # stage 3 shrinks the prefill budget to one segment per decode
            # chunk; a lower stage restores the configured value
            self._prefill_gate.set_budget(1 if stage >= 3 else None)

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
                if (self._request_has_extras(request) or request.logprobs is not None
                        or request.guided is not None or self._gstate[slot] >= 0):
                    # penalties over the histogram, seed counters, logprob
                    # streams and a grammar's DFA state do not survive the
                    # round trip: never a victim
                    continue
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
        decodes it. With the prefix cache on, the history is first stored
        by reference to the slot's pages, as the reference stores it. The
        stream stays open: the resume maps the pages back and decodes on
        from the last token, so no prefill recomputes the history (a bf16
        prefill of a Llama-3-8B history through other kernels than the
        decode steps that wrote its KV can change a later token). The
        reference's resume looks its stored history up and prefills the
        tail past the stored run; without a cache it prefills the whole
        history. False when the ``engine.preempt`` seam aborted the
        preemption (the request keeps decoding in its slot)."""
        request = self._slot_req[slot]
        if request is None:
            return False
        history = list(request.prompt_ids) + [int(t) for t in request._gen_ids]
        if self._prefix is not None:
            # the reference's store of the history, by reference to the
            # slot's pages, so other admissions can share it: block-aligned
            # whole pages below len(history) - 1 only, which no chunk in
            # flight writes (they write from the last emitted token on)
            self._prefix.store_pages(history, 0, self.paged_cache.pool.slot_pages(slot))
        try:
            faults.fire("engine.preempt", request=request)
        except faults.InjectedFault:
            # the store above is an admission commit's store: nothing leaks
            return False
        self.counters["preemptions"] += 1
        request._preempt_count += 1
        request.prompt_ids = history
        request._gen_ids = []
        # the pages hold the KV of the history but its last token; a chunk
        # still in flight writes only past that, and the resume's first
        # decode step rewrites it after that chunk on the same stream. The
        # slot's references leave with them as pins (the stored run needs
        # no pin_run: these references keep its pages), owned by the
        # request in the ledger
        with _owner(request):
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
        than its resume). The ``engine.ledger.leak`` seam fires after the
        pages left the request and before their pins drop: a raise loses
        the release, which the armed ledger names at drain (``pages.pin``,
        acquired in ``_preempt_slot``)."""
        pages, request._parked = request._parked, None
        if pages is None:
            return
        if faults.active():
            try:
                faults.fire("engine.ledger.leak", request=request)
            except faults.InjectedFault:
                return
        with _owner(request):
            self.paged_cache.pool.release(pages)

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
        self._wake_loop()  # a loop idling on admissions in flight admits it now
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

    async def warmup(self, full: bool = False) -> dict:
        """Serve the warmup sweep (``llm/warmup.py``) before traffic: every
        prefill bucket's first use, and one decode chunk of each CUDA-graph
        variant, which captures it; ``full``: the reference's full sweep
        besides, with every plain ragged launch key. Captures after this
        count in ``counters["serve_captures"]``."""
        from . import warmup as _warmup

        return await _warmup.run_warmup(self, full=full)

    def stop(self) -> None:
        """Stop the loop and fail every active and pending request (503);
        the loop's exit frees the pages once the chunks in flight landed.
        An admission still prefilling fails when its worker returns."""
        self._stopped = True
        err = EngineUnavailableError("engine stopped")
        for slot, request in enumerate(self._slot_req):
            if request is not None:
                self._fail_slot(slot, err)
        for job in list(self._prefill_jobs):
            self._fail_ragged_job(job, err)
        self._fail_prepped(err)
        self._drain_ready(err)
        for request in self._pending.pop_all():
            self._release_parked(request)
            request.error = err
            request.out_queue.put_nowait(_FINISHED)
        self._wake_loop()  # an idle loop runs its exit now

    async def stop_when_idle(self) -> None:
        """Stop once the requests in flight have ended: wait for the loop
        to drain (a request that arrives meanwhile restarts it and is
        waited for too), then ``stop()``, and return once the loop and the
        watchdog have exited. Nothing then holds the engine but its
        owner (the processor's eviction)."""
        while self._loop_task is not None and not self._loop_task.done():
            await asyncio.wait([self._loop_task])
        self.stop()
        if self._watchdog_task is not None:
            self._watchdog_task.cancel()
        pending = [t for t in (self._loop_task, self._watchdog_task)
                   if t is not None and not t.done()]
        if pending:
            await asyncio.wait(pending)

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
            # the radix prefix cache: hits, misses, hit_tokens, nodes,
            # cached pages and bytes, evictions (None without the cache)
            "prefix_cache": self._prefix.stats() if self._prefix is not None else None,
            "cow_events": self.paged_cache.pool.cow_events,
            "sanitizer": self._sanitizer.stats() if self._sanitizer is not None else None,
            # the host-RAM tier (None without it) and the ownership ledger
            # (None unless armed)
            "kv_tier": self._kv_tier_snapshot(),
            "ledger": self._ledger.stats() if self._ledger is not None else None,
            # the pools' bytes by kind and dtype, and the KV transport's
            # movement (None on a monolithic engine)
            "kv_pool": self._kv_pool_snapshot(),
            "kv_ship": self._kv_ship_snapshot(),
        }

    def _kv_tier_snapshot(self) -> Optional[dict]:
        """The host tier's occupancy and movement, with the reference's
        keys (None without a tier)."""
        pc = self.paged_cache
        if pc.host_tier is None:
            return None
        backend = pc.tier_stats()
        prefix = self._prefix.stats()
        return {
            "pages": {"hbm": prefix["cached_pages"], "host": prefix["host_pages"]},
            "bytes": {"hbm": prefix["cached_bytes"], "host": prefix["host_bytes"]},
            "nodes": {"hbm": prefix["nodes"] - prefix["host_nodes"],
                      "host": prefix["host_nodes"]},
            "demotions": prefix["demotions"],
            "promotions": prefix["promotions"],
            "hits_by_tier": prefix["hits_by_tier"],
            "host_pages_capacity": backend["host_pages_capacity"],
            "host_pages_used": backend["host_pages_used"],
            "demoted_pages_total": backend["demoted_pages_total"],
            "promoted_pages_total": backend["promoted_pages_total"],
            "promo_overlap_ratio": backend["overlap_ratio"],
            "promo_wait_ms": backend["promo_wait_ms"],
            "promo_total_ms": backend["promo_total_ms"],
            "reaps": self._promotion_reaps,
            "page_bytes": sum(pc.pool_bytes().values()) // pc.pool.num_pages,
        }

    def _reap_promotions(self, force: bool = False) -> None:
        """Loop thread: account the host tier's promotions that completed
        (a retire boundary); ``force`` waits for the rest (drain). A no-op
        without a tier."""
        if self.paged_cache.host_tier is None and self._kv_transport is None:
            # a transport's imports ride the promotions' records
            return
        self._promotion_reaps += self.paged_cache.reap_promotions(force=force)

    def _ledger_domains(self) -> list:
        """The primitives whose drain-zero entries this engine audits (the
        ledger is process-wide)."""
        pc = self.paged_cache
        domains = [self, pc, pc.pool]
        if pc.host_tier is not None:
            domains.append(pc.host_tier)
        if self._prefix is not None:
            domains.append(self._prefix)
        return domains

    def _ledger_audit_request(self, request: Optional[GenRequest], where: str) -> None:
        """A request's exit (emit-finish, fail, cancel): every
        request-scoped acquire attributed to it must be released; strict
        mode raises on the loop thread."""
        if self._ledger is not None and request is not None:
            self._ledger.audit_request(lifecycle_ledger.request_tag(request), where=where)

    # -- disaggregated prefill/decode ------------------------------------------

    def attach_kv_transport(self, endpoint, role: str = "hybrid") -> None:
        """Wire a KV-transport endpoint (``llm/kv_transport.py``) and this
        replica's role into the engine (the replica group does, at its
        construction). The shipment payload is the radix-storable prefix,
        so a transport needs the prefix cache."""
        if role not in ("prefill", "decode", "hybrid"):
            raise ValueError("replica role must be prefill/decode/hybrid: got {!r}".format(role))
        if endpoint is not None and self._prefix is None:
            raise ValueError(
                "KV transport needs cache_mode='paged' and a prefix_cache (the shipment "
                "payload is the radix-storable prefix)")
        self._kv_transport = endpoint
        self.replica_role = role

    def _ship_shipment(self, request: GenRequest, pages: List[int], prefix_len: int,
                       offset: int, final: bool) -> bool:
        """Export ``pages`` (a synchronous readback: it waits for the work
        enqueued on the engine's stream) and send them to
        ``request._ship_to``; False when the transport dropped them."""
        from .kv_transport import KVShipment, shipment_key

        slabs = self.paged_cache.export_pages(pages)
        return self._kv_transport.send(request._ship_to, KVShipment(
            key=shipment_key(request.prompt_ids, self._prefix.block, 0),
            src=self.replica_id or "r?", prefix_len=prefix_len,
            page_size=self.paged_cache.pool.page_size, lora=0,
            hk=slabs["hk"], hv=slabs["hv"], hk_scale=slabs.get("hk_scale"),
            hv_scale=slabs.get("hv_scale"), page_offset=offset, final=final))

    def _maybe_ship_draft(self, job: _RaggedJob) -> None:
        """Draft-ahead shipping (loop thread): at a ragged chunk boundary,
        the job's newly final storable pages ship as an unsealed partial
        frame, overlapping the rest of the prefill. The last storable page
        is always held back for the commit's seal (``_maybe_ship``). An
        injected ``kv.ship.partial`` fault, a failed export or send, or a
        transport drop aborts the job's whole draft-ahead stream and skips
        the seal: the receiver's unsealed assembly never becomes
        consumable, and the decode replica recomputes."""
        request = job.request
        if not request._ship_to or self._kv_transport is None or self._prefix is None:
            return
        storable = self._prefix.longest_prefix_len(len(request.prompt_ids))
        if storable < self._prefix.block:
            return
        page_size = self.paged_cache.pool.page_size
        state = self._kv_draft_ahead.get(job.slot)
        if state is not None and state["aborted"]:
            return
        n_pages = min(min(job.pos, storable) // page_size, storable // page_size - 1)
        offset = state["offset"] if state is not None else 0
        if n_pages <= offset:
            return
        if state is None:
            state = self._kv_draft_ahead[job.slot] = {"offset": 0, "aborted": False}
        pages = self.paged_cache.pool.slot_pages(job.slot)[offset:n_pages]
        try:
            faults.fire("kv.ship.partial", request=request)
            sent = self._ship_shipment(request, pages, n_pages * page_size, offset, False)
        except faults.InjectedFault:
            sent = False
        except Exception as ex:  # best-effort by contract
            logger.warning("draft-ahead kv ship to %s aborted (%s: %s); decode-side recompute",
                           request._ship_to, type(ex).__name__, ex)
            sent = False
        if not sent:
            state["aborted"] = True
            self._kv_ship_stats["draft_aborts"] += 1
            return
        state["offset"] = n_pages
        self._kv_ship_stats["draft_ships"] += 1
        self._kv_ship_stats["draft_pages"] += n_pages - offset

    def _maybe_ship(self, request: GenRequest, slot: int) -> None:
        """Ship at the commit (loop thread): the just-committed admission's
        block-aligned prefix pages export into a shipment addressed to
        ``request._ship_to``. After draft-ahead frames only the tail pages
        ship, as the sealing final frame; an aborted draft-ahead stream
        skips the seal. Best-effort: an injected ``engine.kv.ship`` fault,
        a failed export or a full receive slab drops the shipment (counted
        in ``ship_drops``) and the decode replica recomputes; nothing here
        fails the request."""
        state = self._kv_draft_ahead.pop(slot, None)
        if not request._ship_to or self._kv_transport is None or self._prefix is None:
            return
        if state is not None and state["aborted"]:
            self._kv_ship_stats["ship_drops"] += 1
            return
        offset = state["offset"] if state is not None else 0
        prefix_len = self._prefix.longest_prefix_len(len(request.prompt_ids))
        if prefix_len < self._prefix.block:
            return
        t0 = time.perf_counter()
        n_pages = prefix_len // self.paged_cache.pool.page_size
        pages = self.paged_cache.pool.slot_pages(slot)[offset:n_pages]
        try:
            faults.fire("engine.kv.ship", request=request)
            sent = self._ship_shipment(request, pages, prefix_len, offset, True)
        except faults.InjectedFault:
            sent = False
        except Exception as ex:  # best-effort by contract
            logger.warning("kv ship to %s dropped (%s: %s); decode-side recompute",
                           request._ship_to, type(ex).__name__, ex)
            sent = False
        if not sent:
            self._kv_ship_stats["ship_drops"] += 1
            return
        self._kv_ship_stats["ships"] += 1
        # the whole prefix: the head pages rode the draft frames
        self._kv_ship_stats["ship_pages"] += n_pages
        self._hist_ship_ms.observe((time.perf_counter() - t0) * 1e3)

    def receive_shipment(self, prompt_ids: List[int], lora: int = 0) -> dict:
        """Receive and import (the decode replica's half): pop the shipment
        for the prompt's prefix from this replica's receive slab and attach
        it to the prefix cache (``RadixPrefixCache.store_shipped``): fresh
        pages allocated, their upload enqueued on the engine's stream, the
        nodes attached last. The next admission's lookup then hits the
        shipped run, and its gather is enqueued after the upload.

        Called on the engine's loop thread (the replica group's coroutine
        runs on the loop every replica of the group serves from), where the
        commits allocate pages too. Returns ``{"status": "imported" |
        "empty" | "failed" | "off", "pages": n}``; ``failed`` (an injected
        ``engine.kv.receive`` fault, pool pressure, a geometry mismatch)
        drops the shipment with no page leaked."""
        if self._kv_transport is None or self._prefix is None:
            return {"status": "off", "pages": 0}
        from .kv_transport import shipment_key

        shipment = self._kv_transport.recv(shipment_key(prompt_ids, self._prefix.block, lora))
        if shipment is None:
            self._kv_ship_stats["receive_empty"] += 1
            return {"status": "empty", "pages": 0}
        t0 = time.perf_counter()
        try:
            faults.fire("engine.kv.receive", request=_ShipShim(prompt_ids))
            with self._on_stream_ctx():
                pages = self._prefix.store_shipped(prompt_ids, lora, shipment, self.paged_cache)
        except (faults.InjectedFault, MemoryError, ValueError) as ex:
            self._kv_ship_stats["receive_failures"] += 1
            return {"status": "failed", "pages": 0, "error": repr(ex)[:200]}
        self._kv_ship_stats["receives"] += 1
        self._kv_ship_stats["receive_pages"] += pages
        self._hist_receive_ms.observe((time.perf_counter() - t0) * 1e3)
        return {"status": "imported", "pages": pages}

    def _count_ship_outcome(self, request: GenRequest) -> None:
        """Admission-time ship accounting on the decode replica, once per
        request the group marked ``_shipped``: a hit when its whole storable
        prefix is resident, else a recompute (a transport drop, an
        eviction, a failed receive)."""
        if not request._shipped or self._prefix is None:
            return
        request._shipped = False
        ids = request.prompt_ids
        storable = self._prefix.longest_prefix_len(len(ids))
        hit = storable >= self._prefix.block and self._prefix.match_len(ids, 0) >= storable
        with self._count_lock:
            self._kv_ship_stats["hits" if hit else "recomputes"] += 1

    def _kv_ship_snapshot(self) -> Optional[dict]:
        """The KV transport's movement block (the reference's keys); None
        without a transport."""
        if self._kv_transport is None:
            return None
        s = self._kv_ship_stats
        judged = s["hits"] + s["recomputes"]
        return {
            "role": self.replica_role,
            "ships": s["ships"],
            "ship_pages": s["ship_pages"],
            "ship_drops": s["ship_drops"],
            "receives": s["receives"],
            "receive_pages": s["receive_pages"],
            "receive_empty": s["receive_empty"],
            "receive_failures": s["receive_failures"],
            "hits": s["hits"],
            "recomputes": s["recomputes"],
            "hit_rate": round(s["hits"] / judged, 4) if judged else None,
            "draft_ships": s["draft_ships"],
            "draft_pages": s["draft_pages"],
            "draft_aborts": s["draft_aborts"],
            # the share of the shipped prefix pages that overlapped the
            # prefill instead of waiting for the commit
            "overlap_ratio": (round(s["draft_pages"] / s["ship_pages"], 4)
                              if s["ship_pages"] else 0.0),
            "ship_ms": self._hist_ship_ms.snapshot(),
            "receive_ms": self._hist_receive_ms.snapshot(),
            "transport": self._kv_transport.stats(),
        }

    def _kv_pool_snapshot(self) -> dict:
        """The paged pools' capacity block (the reference's keys)."""
        pc = self.paged_cache
        return dict(pc.pool_bytes(), dtype=pc.pool_dtype, num_pages=pc.pool.num_pages,
                    page_size=pc.pool.page_size)

    def health(self) -> dict:
        out = dict(
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
            # the captured graph variants (the decode chunk's, and the
            # ragged launch's keys, labelled "ragged+...") and each one's
            # capture time (ms)
            graph_variants=dict(self._capture_ms),
            # each live graph's memory: the rise of the card's reserved
            # bytes inside its capture (a decode-chunk variant's private
            # pool; what the ragged keys' shared pool took for the key)
            graph_pool_bytes=self._graph_pool_bytes(),
            # the grammar registry: grammars, references, combined states,
            # the device bucket and its tables' bytes
            guided=self._guided_snapshot(),
            pipeline=self._pipeline_snapshot(),
            scheduler="ragged" if self._ragged else "two_dispatch",
            ragged=self._ragged_snapshot(),
        )
        if self.replica_id is not None:
            out["replica"] = self.replica_id
        return out

    def _graph_pool_bytes(self) -> Dict[str, int]:
        out = {}
        for graphs in (self._graphs, self._ragged_graphs):
            if graphs is not None:
                out.update((v.label(), n) for v, n in graphs.pool_growth.items())
        return out

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
        out = dict(
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
        if self.replica_id is not None:
            out["replica"] = self.replica_id
        return out

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
        self._wake = asyncio.Event()
        try:
            while not self._stopped:
                self._expire_pending()
                # the host tier's promotions that completed since the last
                # boundary
                self._reap_promotions()
                if self._recovering and not self._inflight:
                    # a trip that found no stale chunk to land: recover at
                    # this boundary
                    await self._finish_recovery()
                # SLO scheduling: the brownout stage from the pressure
                # signals, then, with interactive work waiting and no slot
                # free, a batch-lane preemption at this chunk boundary
                self._update_brownout()
                self._maybe_preempt()
                if self._ragged:
                    self._ragged_admission()
                else:
                    # start admission tasks into free slots, then commit the
                    # prefills that landed since the last boundary
                    self._admit()
                    self._commit_ready()
                active = np.array([r is not None for r in self._slot_req])
                if self._prefill_gate is not None:
                    # pace prefills while decode is live; open otherwise
                    self._prefill_gate.set_active(bool(active.any() or self._inflight))
                if not active.any() and not self._inflight and not self._prefill_jobs:
                    if self._grammar_preps:
                        # nothing to decode while grammars compile: their
                        # admissions open when a worker hands one back
                        await asyncio.wait(set(self._grammar_preps),
                                           return_when=asyncio.FIRST_COMPLETED)
                        continue
                    if self._admitting or self._ready:
                        # idle with admissions in flight: sleep until one
                        # lands or a request arrives
                        await self._wake.wait()
                        self._wake.clear()
                        continue
                    if self._pending.empty():
                        faults.fire("engine.drain")
                        # promotions still in flight settle before the
                        # drained audits
                        self._reap_promotions(force=True)
                        # drained: nothing owns pages but the prefix cache
                        self._sanitize("drain", drained=True)
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
                # armed sanitizer: the page accounting after every step,
                # failure recoveries included; a violation raises out of
                # the loop
                self._sanitize("decode-step")
                await asyncio.sleep(0)  # let HTTP handlers interleave
            # stopped: wait out the chunks still writing pages, then free them
            await self._discard_pipeline()
        except BaseException as ex:
            for slot, request in enumerate(self._slot_req):
                if request is not None:
                    self._fail_slot(slot, ex)
            for job in list(self._prefill_jobs):
                self._fail_ragged_job(job, ex)
            self._fail_prepped(ex)
            self._drain_ready(ex)
            raise
        finally:
            if self._prefill_gate is not None:
                # no decode left to pace against: release the waiters
                self._prefill_gate.set_active(False)
            if self._stopped:
                # admissions that landed while stop() raced the loop
                self._drain_ready(EngineUnavailableError("engine stopped"))
            # the pipeline dies with the loop; after a cancellation its
            # deferred frees run without waiting for the card
            self._drop_pipeline()
            # no worker is left: every slot the watchdog failed gets its
            # pages back
            self._free_unowned_slots()
            self._recovering = False
            if self._stopped and self._watchdog_task is not None:
                self._watchdog_task.cancel()

    def _sanitize(self, where: str, drained: bool = False) -> None:
        """The armed audits of a loop boundary: the KV sanitizer, then the
        ownership ledger (its drain-zero rule once nothing is in flight)."""
        if self._sanitizer is not None:
            self._sanitizer.check(where, drained=drained, inflight=len(self._inflight))
        if self._ledger is not None:
            self._ledger.check(where=where, drained=drained and not self._inflight,
                               domains=self._ledger_domains())

    def _on_stream_ctx(self):
        """The engine's stream as the current stream (a no-op on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    async def _on_worker(self, role: str, fn, *args):
        """``fn(*args)`` on the engine's stream in its ``role`` thread."""
        return await asyncio.get_running_loop().run_in_executor(
            self._workers[role], functools.partial(self._on_stream, fn, *args))

    def _on_stream(self, fn, *args):
        """Run ``fn`` on the engine's stream: a worker thread starts on the
        default one."""
        with self._on_stream_ctx():
            return fn(*args)

    def _wake_loop(self) -> None:
        if self._wake is not None:
            self._wake.set()

    def _admit(self) -> None:
        """Loop thread, two-dispatch: start one admission task per pending
        request, in the queue's class order, each into a free slot it
        reserves in ``_admitting`` until its commit or failure. A
        quarantined slot is not free yet. A preempted request resumes at
        once (``_resume_slot``): its pages hold its history."""
        free = [i for i, r in enumerate(self._slot_req)
                if r is None and i not in self._quarantine and i not in self._admitting]
        loop = asyncio.get_running_loop()
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
            task = loop.create_task(self._admission_task(request, slot))
            self._admission_tasks.add(task)
            task.add_done_callback(self._admission_tasks.discard)

    async def _admission_task(self, request: GenRequest, slot: int) -> None:
        """One admission's background half: the grammar compile in a
        thread of its own (host work, kept off the stream's one prefill
        thread, which the other admissions share), then the prefill and
        the first token on the prefill thread, on the engine's stream
        (``_run_prefill``), handed to the loop through ``_ready``."""
        try:
            if request.guided is not None and request._guided_key is None:
                await asyncio.to_thread(self._ensure_grammar, request)
            first_id, mini_cache, first_lp = await self._run_prefill(request)
        except Exception as ex:
            # a failed admission fails only its own request
            self._abandon_admission(request, slot, ex)
            self._wake_loop()
            return
        if self._stopped:
            self._abandon_admission(request, slot, EngineUnavailableError("engine stopped"))
            return
        self._ready.append((request, slot, first_id, mini_cache, first_lp))
        self._wake_loop()
        if self._loop_task is None or self._loop_task.done():
            # the loop died between the prefill and the hand-off: nobody
            # commits what waits in the queue
            self._drain_ready(EngineUnavailableError("engine loop exited"))

    def _abandon_admission(self, request: GenRequest, slot: int,
                           err: Optional[BaseException]) -> None:
        """An admission that will not commit (failed, cancelled, expired,
        stopped): its grammar reference and prefix pin drop, its consumer
        ends (``err`` None: cancelled), and its slot, which holds no page,
        is free again."""
        self._admitting.discard(slot)
        self._deref_guided_request(request)
        self._release_prefix_hit(request)
        if err is not None:
            request.error = err
        request.out_queue.put_nowait(_FINISHED)
        self._ledger_audit_request(request, "admission")

    def _commit_ready(self) -> None:
        """Loop thread, at a chunk boundary: commit the admissions that
        landed, interactive first (a commit is a first token, so class
        order holds here too). A cancelled request, or one past its TTFT or
        total deadline, drops instead."""
        if not self._ready:
            return
        batch = sorted(self._ready, key=lambda item: _CLASS_RANK.get(item[0].priority, 0))
        self._ready.clear()
        for request, slot, first_id, mini_cache, first_lp in batch:
            if request.cancelled:
                self._abandon_admission(request, slot, None)
                continue
            err = self._deadline_error_at_commit(request)
            if err is not None:
                # the prefill outlived the request's budget: a structured
                # 408 instead of a slot commit
                self._abandon_admission(request, slot, err)
                continue
            self._admitting.discard(slot)
            try:
                self._on_stream(self._insert_prefill, slot, mini_cache, request)
            except Exception as ex:
                # the pool could not hold the prompt: only this request fails
                self.paged_cache.pool.free(slot)
                self._abandon_admission(request, slot, ex)
                continue
            self._activate_slot(request, slot, first_id, first_lp)
            self._last_progress = time.monotonic()

    def _drain_ready(self, err: BaseException) -> None:
        """Fail every landed admission not committed yet (stop, loop
        exit)."""
        while self._ready:
            request, slot, _first, _cache, _lp = self._ready.popleft()
            self._abandon_admission(request, slot, err)

    # -- ragged guided admissions: the grammar compile off the loop ------------

    def _needs_grammar_compile(self, request: GenRequest) -> bool:
        """A guided request whose grammar the registry does not hold yet
        (a compile can take seconds at a large vocab)."""
        if request.guided is None or request._guided_key is not None:
            return False
        with self._guided_lock:
            return request.guided.cache_key() not in self._grammars

    def _start_grammar_prep(self, request: GenRequest, slot: int) -> None:
        """Loop thread, ragged scheduler: reserve ``slot`` and compile the
        request's grammar in a worker (the reference's
        ``_ragged_admission_task``), while the loop goes on decoding the
        live rows; the request comes back through ``_prepped``. (A
        two-dispatch admission compiles in its own admission task.)"""
        self._admitting.add(slot)
        task = asyncio.get_running_loop().create_task(self._grammar_prep(request, slot))
        self._grammar_preps.add(task)
        task.add_done_callback(self._grammar_preps.discard)

    async def _grammar_prep(self, request: GenRequest, slot: int) -> None:
        try:
            await asyncio.to_thread(self._ensure_grammar, request)
        except Exception as ex:
            self._admitting.discard(slot)
            request.error = ex
            request.out_queue.put_nowait(_FINISHED)
            return
        self._prepped.append((request, slot))
        if self._stopped:
            self._fail_prepped(EngineUnavailableError("engine stopped"))
        elif self._loop_task is None or self._loop_task.done():
            # the loop died meanwhile: nobody admits the request
            self._fail_prepped(EngineUnavailableError("engine loop exited"))

    def _take_prepped(self):
        """Loop thread: yield the compiled guided admissions to open now,
        each with the slot it reserved; a cancelled one returns its
        reference instead."""
        while self._prepped and not self._stopped:
            request, slot = self._prepped.popleft()
            self._admitting.discard(slot)
            if request.cancelled:
                self._deref_guided_request(request)
                request.out_queue.put_nowait(_FINISHED)
                continue
            yield request, slot

    def _fail_prepped(self, err: BaseException) -> None:
        """Fail every compiled guided admission not opened yet."""
        while self._prepped:
            request, slot = self._prepped.popleft()
            self._admitting.discard(slot)
            self._deref_guided_request(request)
            request.error = err
            request.out_queue.put_nowait(_FINISHED)

    async def _run_prefill(self, request: GenRequest):
        """Loop thread: run an admission's prefill (``_prefill_steps``) on
        the stream's prefill thread, one job per dispatch, so the jobs of
        the stream's admissions interleave. Each dispatch's gate permit is
        awaited here, on the loop (``_PrefillGate.wait``): no thread parks
        on the gate, and a bypassing interactive dispatch waits behind at
        most one job. The first token is sampled in a thread of its own,
        since its read waits for the card. Returns (first token, mini
        cache, first logprob entry or None)."""
        steps = self._prefill_steps(request)
        try:
            done, value = await self._on_worker("prefill", self._advance_prefill, steps)
            while not done:
                if self._prefill_gate is not None:
                    await self._prefill_gate.wait(value)
                done, value = await self._on_worker("prefill", self._advance_prefill, steps)
        finally:
            # cancelled at the gate: the generator's handlers drop its pin
            if not steps.gi_running:
                steps.close()
        last, cache, t0 = value
        first_id, first_lp = await asyncio.to_thread(self._first_token, request, last)
        with self._count_lock:
            self.counters["prefills"] += 1
            self.counters["prefill_ms"] += (time.perf_counter() - t0) * 1e3
        return first_id, cache, first_lp

    def _advance_prefill(self, steps):
        """Prefill thread: run ``steps`` on to its next dispatch's permit,
        ``(False, bypass)``, or to its end, ``(True, result)``. A dispatch
        past the gate (``bypass``) waits for no permit: it runs in this
        job."""
        gate = self._prefill_gate
        try:
            bypass = next(steps)
            while bypass and (gate is None or gate.take(bypass)):
                bypass = next(steps)
            return False, bypass
        except StopIteration as stop:
            return True, stop.value

    def _run_gated(self, steps):
        """Run a prefill generator (``_prefill_steps``, ``_prefix_admission``,
        ``_prefill_segments``) to its end on the calling thread, waiting
        for each of the gate's permits there; returns its result."""
        try:
            while True:
                bypass = next(steps)
                if self._prefill_gate is not None:
                    self._prefill_gate.acquire(bypass)
        except StopIteration as stop:
            return stop.value

    def _prefill_steps(self, request: GenRequest):
        """Prefill thread, on the engine's stream, beside the decode
        chunks (a generator: it yields before each dispatch for the gate's
        permit, its ``bypass`` flag, to its driver, ``_run_prefill``): the
        prompt prefills into a dense mini cache. Touches no slot state and
        no page. A prefix-cache hit prefills only the tail over its
        gathered shared pages, its pinned hit left on
        ``request._prefix_hit`` for the commit; a prompt longer than
        ``chunked_prefill_size`` C (no hit, its bucket rounded up to a
        multiple of C within ``max_seq_len``) prefills in C-token segments,
        each paced by the gate; any other takes one dispatch, which a
        single interactive admission runs past the gate. Returns (the last
        prompt position's logits, the mini cache, its start time)."""
        t0 = time.perf_counter()
        if faults.active():
            faults.fire("engine.prefill", request=request)
        # a shipped prefix's fate, booked before the lookup uses it
        self._count_ship_outcome(request)
        if request.guided is not None and request._guided_key is None:
            self._ensure_grammar(request)
        ids = request.prompt_ids
        n = len(ids)
        bypass = request.priority == "interactive"
        hit_result = ((yield from self._prefix_admission(request, bypass))
                      if self._prefix is not None else None)
        if hit_result is not None:
            last, cache, _plen = hit_result
        else:
            bucket = shapes.bucket_for(n, self._buckets, self.max_seq_len)
            c = self._chunked
            # the chunked mini cache is a multiple of C: the last segment's
            # index write past the cache would raise
            chunk_bucket = -(-bucket // c) * c if c else 0
            if c > 0 and n > c and chunk_bucket <= self.max_seq_len:
                cache = self.model.init_cache(1, chunk_bucket)
                last, cache = yield from self._prefill_segments(cache, ids, 0, c)
            else:
                tokens = np.zeros((1, bucket), np.int64)
                tokens[0, :n] = ids
                tokens = self._device_tensor(tokens, np.int64)
                seq_lens = self._device_tensor([n], np.int32)
                last, cache = yield from self._prefill_dispatch(
                    self.model.prefill, tokens, seq_lens, bypass=bypass)
        return last, cache, t0

    def _insert_prefill(self, slot: int, cache: dict, request: GenRequest) -> None:
        """Loop thread, on the engine's stream, at a chunk boundary (the
        commit half of an admission): write the mini cache's prompt K/V
        into the slot's fresh pages, or on a prefix hit map the hit's
        shared pages by reference and write the tail alone, dropping the
        lookup's pin once the slot holds its own references; then store
        the prompt in the prefix cache. Page pressure is decided here,
        on the thread that extends the live slots."""
        n = len(request.prompt_ids)
        hit, request._prefix_hit = request._prefix_hit, None
        if hit is not None:
            plen = hit["len"]
            try:
                self.paged_cache.write_prompt_shared(
                    slot, hit["pages"], plen, cache["k"][:, 0, plen:n], cache["v"][:, 0, plen:n],
                    n, *self._mini_scales(cache, plen, n))
            finally:
                with _owner(request):
                    self._prefix.release(hit)
        else:
            self.paged_cache.write_prompt(
                slot, cache["k"][:, 0, :n], cache["v"][:, 0, :n], n,
                *self._mini_scales(cache, 0, n))
        self._store_prompt(request, slot)
        # the slot's pages hold the whole prompt: a prefill leg ships its
        # storable prefix to the decode replica
        self._maybe_ship(request, slot)

    def _mini_scales(self, cache: dict, lo: int, hi: int) -> tuple:
        """A mini cache's scale rows of positions [lo, hi) (int8 KV), else
        nothing."""
        if not self.model.kv_quant:
            return ()
        return cache["k_scale"][:, 0, lo:hi], cache["v_scale"][:, 0, lo:hi]

    def _prefix_bucket(self, prefix_len: int, n_tokens: int) -> Optional[int]:
        """The mini cache's bucket: the smallest prefill bucket covering the
        prefix plus the tail's whole segments; None when none does."""
        c2 = self._prefix_chunk
        required = prefix_len + -(-(n_tokens - prefix_len) // c2) * c2
        bucket = shapes.bucket_for(required, self._buckets, self.max_seq_len)
        if bucket < required or bucket > self.max_seq_len:
            return None
        return bucket

    def _prefix_admission(self, request: GenRequest, bypass: bool = False):
        """Prefill thread, a generator as ``_prefill_steps``, the
        two-dispatch hit path (the reference's
        ``_prefix_admission_paged``): look the prompt up; on a hit, gather
        its pinned shared pages into a dense mini cache of the bucket's
        size (the page list padded with the null page 0, whose rows the
        cache length masks) on the engine's stream, and prefill the tail
        over it (``bypass``: the gate's, for a one-segment tail). Returns
        ``(last_logits, mini_cache, prefix_len)`` with the pinned hit on
        ``request._prefix_hit``, or None: a miss, or a hit no bucket fits,
        which recomputes cold and counts as a miss. The gather reads shared
        pages while a decode chunk may be in flight on the same stream; it
        writes none, and nobody writes a shared page. A hit on a demoted
        run promoted it: its copies were enqueued on this stream before the
        lookup returned, so the gather reads them. The hit and its pin are
        the request's in the ledger."""
        ids = request.prompt_ids
        with _owner(request):
            hit = self._prefix.lookup_pages(ids, 0)
        if hit is None:
            return None
        try:
            plen = hit["len"]
            bucket = self._prefix_bucket(plen, len(ids))
            page_size = self.paged_cache.pool.page_size
            if bucket is None or bucket % page_size:
                with _owner(request):
                    self._prefix.release(hit)
                self._prefix.uncount_hit(hit)
                return None
            pages = list(hit["pages"]) + [0] * (bucket // page_size - len(hit["pages"]))
            cache = self.paged_cache.gather_pages(pages)
            cache["length"] = self._device_tensor([plen], np.int32)
            last, cache = yield from self._prefill_segments(cache, ids, plen,
                                                            self._prefix_chunk, bypass)
        except BaseException:
            with _owner(request):
                self._prefix.release(hit)  # a no-op after the release above
            raise
        request._prefix_hit = hit
        return last, cache, plen

    def _prefill_segments(self, cache: dict, ids: List[int], start: int, c: int,
                          bypass: bool = False):
        """A generator as ``_prefill_steps``: prefill ``ids`` past
        ``start`` in segments of ``c`` tokens through
        ``Llama.prefill_chunk``, each attending over the mini cache so far
        (a prefix hit's tail, or a chunked cold prefill from 0); only the
        last segment computes logits. Each segment first takes a permit of
        the prefill gate; ``bypass`` skips it for a one-segment train
        only. Returns (last_logits, cache)."""
        starts = list(range(start, len(ids), c))
        bypass = bypass and len(starts) == 1
        last = None
        for si, s in enumerate(starts):
            seg = ids[s:s + c]
            seg_tokens = np.zeros((1, c), np.int64)
            seg_tokens[0, :len(seg)] = seg
            last, cache = yield from self._prefill_dispatch(
                self.model.prefill_chunk, self._device_tensor(seg_tokens, np.int64),
                self._device_tensor([s], np.int32), self._device_tensor([len(seg) - 1], np.int32),
                cache, with_logits=si == len(starts) - 1, bypass=bypass)
        return last, cache

    def _prefill_dispatch(self, fn, *args, bypass: bool = False, **kwargs):
        """One prefill dispatch of an admission, a generator: it yields
        ``bypass`` for its driver to take a permit of the prefill gate
        (``bypass``: none needed), then runs ``fn``'s launches under
        ``_prefill_lock``, so one dispatch's kernels stay contiguous on the
        engine's stream whatever else enqueues prefills meanwhile, as the
        reference's dispatch (one compiled program) is."""
        yield bypass
        with self._prefill_lock:
            return fn(*args, **kwargs)

    def _release_prefix_hit(self, request: GenRequest) -> None:
        """An admission failed before its commit mapped the hit: drop the
        lookup's pin. No-op otherwise."""
        hit, request._prefix_hit = request._prefix_hit, None
        if hit is not None and self._prefix is not None:
            with _owner(request):
                self._prefix.release(hit)

    def _store_prompt(self, request: GenRequest, slot: int) -> None:
        """An admission's commit: the tree takes references on the slot's
        own pages for the prompt's block-aligned prefix (blocks already
        stored are only touched; runs over the device budgets are demoted
        or dropped)."""
        if self._prefix is not None:
            self._prefix.store_pages(request.prompt_ids, 0,
                                     self.paged_cache.pool.slot_pages(slot))

    def _first_token(self, request: GenRequest, last_logits: torch.Tensor):
        """A request's first token from its prompt's last logits [1, vocab],
        and its logprob entry (None without logprobs): a guided request's
        grammar (compiled here unless its admission did) masks the logits by
        its start row, the request's extras apply (a seeded draw at counter
        0), the entry reads the masked, penalized logits, and the token's
        bytes walk the grammar's DFA on the host into ``_gstate0`` (EOS to
        its terminal). Every admission samples here, cold prefills, prefix
        hits and the ragged scheduler's finishing rows alike (the
        reference's ``_first_token_from_logits``), so their first tokens
        are the same."""
        return self._on_stream(self._first_token_device, request, last_logits)

    def _first_token_device(self, request: GenRequest, last_logits: torch.Tensor):
        # inputs copied without a host wait: the only wait is the token's read
        params = SamplingParams(
            temperature=self._device_tensor([request.temperature], np.float32),
            top_k=self._device_tensor([request.top_k], np.int32),
            top_p=self._device_tensor([request.top_p], np.float32),
        )
        logits = last_logits.float()
        greedy = request.temperature <= 0
        gentry = None
        if request.guided is not None:
            if request._guided_key is not None:
                with self._guided_lock:
                    gentry = self._grammars.get(request._guided_key)
            if gentry is None:
                gentry = self._ensure_grammar(request)
            with self._guided_lock:
                row = self._gmask_np[gentry["start"]]
            allowed = np.unpackbits(row, bitorder="little")[: logits.shape[-1]] > 0
            logits = torch.where(self._device_tensor(allowed, np.bool_)[None, :], logits,
                                 torch.full_like(logits, GUIDED_FILL))
        if self._request_has_extras(request):
            extras, counts0, pmask0 = self._request_extras_row(request)
            logits = penalize_logits(logits, extras, counts0, pmask0)
            with self._rng_lock:
                first = sample_penalized(logits, params, generator=self._gen,
                                         all_greedy=greedy, extras=extras)
        else:
            with self._rng_lock:
                first = sample_tokens(logits, params, generator=self._gen, all_greedy=greedy)
        first_id = int(first.item())
        if gentry is not None:
            request._gstate0 = self._walk_first_token(gentry, first_id)
        if request.logprobs is None:
            return first_id, None
        chosen, top_id, top_lp = logprobs_of(logits, first, self._lp_k)
        return first_id, self._lp_entry(first_id, chosen[0].item(), top_id[0].tolist(),
                                        top_lp[0].tolist())

    def _walk_first_token(self, gentry: dict, token_id: int) -> int:
        """The grammar state after a first token: its bytes walked through
        the byte DFA on the host (EOS goes to the grammar's terminal)."""
        if token_id == self.eos_token_id:
            return gentry["terminal"]
        state = gentry["start"]
        with self._guided_lock:
            byte_np = self._gbyte_np
            tok_bytes, tok_len = self._gtok_np
        for b in tok_bytes[token_id][: int(tok_len[token_id])]:
            state = int(byte_np[state, int(b)])
            if state < 0:
                break
        return state

    def _occupy_slot(self, request: GenRequest, slot: int, next_token: int,
                     history: List[int], first_id: Optional[int] = None) -> None:
        """Slot bookkeeping of an admission's activation and of a
        preempted request's resume: the request, the admission record
        behind Retry-After, the next decode input (taken from the host at
        the next dispatch), the speculation history (prompt and emitted
        tokens), the sampling parameters, the extras rows (the histogram
        holding ``first_id``) and the DFA state, with the grammar reference
        handed from the request to the slot."""
        self._slot_req[slot] = request
        key, request._guided_key = request._guided_key, None
        self._slot_guided_key[slot] = key
        self._gstate[slot] = request._gstate0 if key is not None else -1
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
        self._set_slot_extras(request, slot, first_id)

    def _activate_slot(self, request: GenRequest, slot: int, first_id: int,
                       first_lp: Optional[dict] = None) -> None:
        """An admission's slot goes live with its first token."""
        self._occupy_slot(request, slot, first_id, list(request.prompt_ids) + [first_id],
                          first_id)
        self._emit(slot, first_id, first_lp)

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
            entry = await self._on_worker("step", self._dispatch_device, prep)
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
        v["active"][:] = active_mask
        # a guided slot in the chunk: the grammar tables of the state
        # bucket, and the DFA states, chained on the device like the tokens
        # (fresh commits from the host) unless the device chain is not this
        # table generation's: the last chunk was plain, the chain was reset
        # or every grammar drained and the tables were rebuilt
        gbucket = (self._guided_device_tables()
                   if (self._gstate[active_mask] >= 0).any() else 0)
        if gbucket:
            v["override_gstate"][:] = self._gstate
            v["override_gmask"][:] = (self._slot_overrides
                                      | (self._gchain_epoch != self._gepoch))
        self._gchain_epoch = self._gepoch if gbucket else None
        self._slot_overrides[:] = False
        v["temperature"][:] = self._temperature
        v["top_k"][:] = self._top_k
        v["top_p"][:] = self._top_p
        # the chunk's variant: the greedy one draws no noise; extras while
        # an active slot has them (a seeded draw only where a sampled one
        # is seeded); logprobs while an active request asks for them
        greedy = not (self._temperature[active_mask] > 0).any()
        extras = self._extras_active(active_mask)
        if extras:
            self._batch_extras_rows(v, active_mask)
        variant = ChunkVariant(
            greedy=bool(greedy), extras=extras,
            seeded=bool(extras and not greedy and (
                self._seeds[active_mask & (self._temperature > 0)] >= 0).any()),
            lp=self._wants_logprobs(active_mask), guided=gbucket)
        self._dispatch_seq += 1
        prep = {
            "seq": self._dispatch_seq,
            "epoch": epoch,
            "active_mask": active_mask,
            "exhausted": exhausted,
            "host_i32": host_i32,
            "host_f32": host_f32,
            "variant": variant,
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
        # copy on write: _prepare_dispatch's extensions (loop thread) may
        # have swapped shared pages for private ones; this worker enqueues
        # their copies on the engine's stream ahead of the replay or the
        # launches that write them, outside the graph
        self.paged_cache.apply_pending_cow()
        variant = prep["variant"]
        noise = None
        if not variant.greedy:
            with self._rng_lock:
                noise = gumbel_noise((n, self.max_batch, self.model.vocab_size), self._gen,
                                     self.device)
        gstate = None
        if self._graphs is not None:
            if not self._graphs.captured(variant):
                self._capture(variant)
            out = self._graphs.replay(variant, prep["host_i32"], prep["host_f32"], noise)
            if variant.guided:
                out, gstate = out
            self.counters["graph_replays"] += 1
        else:
            views = self._layout.views(prep["host_i32"].to(self.device, non_blocking=True),
                                       prep["host_f32"].to(self.device, non_blocking=True))
            out = run_chunk(self.model, self.paged_cache, views, self._chain, noise, n,
                            variant=variant, state=self._extras, lp_k=self._lp_k,
                            tables=(self._guided_tables_of(variant.guided)
                                    if variant.guided else None),
                            gchain=self._gchain)
            if variant.guided:
                out, gstate = out
                self._gchain = gstate
            self._chain = (out[0] if variant.lp else out)[:, -1]
        out, lp = (out[0], out[1]) if variant.lp else (out, None)
        tokens, ready = out, None
        if self._stream is not None:
            tokens = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            tokens.copy_(out, non_blocking=True)
            if lp is not None:
                host_lp = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                for t in lp)
                for dst, src in zip(host_lp, lp):
                    dst.copy_(src, non_blocking=True)
                lp = host_lp
            if gstate is not None:
                host_g = torch.empty(gstate.shape, dtype=gstate.dtype, pin_memory=True)
                host_g.copy_(gstate, non_blocking=True)
                gstate = host_g
            ready = torch.cuda.Event()
            ready.record(self._stream)
        self.counters["decode_steps"] += n
        self.counters["decode_chunks"] += 1
        self._last_progress = time.monotonic()
        self._hist_dispatch.observe((time.perf_counter() - t0) * 1e3)
        return _InFlightChunk(seq=prep["seq"], active_mask=prep["active_mask"],
                              tokens=tokens, ready=ready, exhausted=prep["exhausted"],
                              epoch=prep["epoch"], lp=lp, gstate=gstate)

    def _capture(self, variant) -> None:
        """Capture a decode-chunk variant (``ChunkVariant``) or a ragged
        launch key (``RaggedVariant``): inside ``warmup()`` in the global
        mode (the card is the engine's alone), while serving in the
        thread-local one (a retire may read back meanwhile), counted in
        ``serve_captures``; its time lands in ``health()["graph_variants"]``.
        A failed capture raises: the step never runs eagerly instead.
        Engines of a replica group capture in the thread-local mode
        always: a sibling may be serving meanwhile."""
        ragged = isinstance(variant, RaggedVariant)
        graphs = self._ragged_graphs if ragged else self._graphs
        t0 = time.perf_counter()
        try:
            graphs.capture(
                variant, capture_error_mode=("global" if self._warming and not self._cohosted
                                             else "thread_local"))
        except Exception as ex:
            raise RuntimeError("CUDA-graph capture of the {} {} failed: {}".format(
                variant.label(), "ragged launch" if ragged else "decode chunk", ex)) from ex
        self._capture_ms[variant.label()] = (time.perf_counter() - t0) * 1e3
        self.counters["graph_captures"] += 1
        if not self._warming:
            self.counters["serve_captures"] += 1

    def _capture_graphs(self, ragged: bool = False) -> None:
        """Capture the plain decode-chunk variants not captured yet
        (``warmup()``; nothing on the CPU or with ``cuda_graphs`` off). As
        in the reference's sweep, the extras, logprob and guided variants
        are captured at their first use. With ``ragged`` (``warmup:
        full`` on a ragged engine with graphs) every plain ragged launch key
        too (the reference's ``warm_ragged_variants``)."""
        for greedy in (True, False):
            variant = ChunkVariant(greedy)
            if self._graphs is not None and not self._graphs.captured(variant):
                self._capture(variant)
        if not ragged or self._ragged_graphs is None:
            return
        for variant in plain_variants(self._ragged_steps_cap, self._verify_kind):
            if not self._ragged_graphs.captured(variant):
                self._capture(variant)

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
        lp = None if entry.lp is None else tuple(t.numpy() for t in entry.lp)
        gstate = None if entry.gstate is None else entry.gstate.numpy()
        slots = [int(s) for s in np.nonzero(entry.active_mask)[0]]
        for slot in slots:
            self._next_token[slot] = int(chunk[slot, -1])
            if gstate is not None and self._slot_req[slot] is not None:
                # a slot freed since the dispatch keeps its cleared state
                self._gstate[slot] = int(gstate[slot])
        if self._prefill_gate is not None:
            # a decode chunk is done: the next prefill dispatches' budget
            self._prefill_gate.deposit()
        for slot in slots:
            request = self._slot_req[slot]
            want_lp = lp is not None and request is not None and request.logprobs is not None
            for i, token_id in enumerate(chunk[slot]):
                # _emit frees the slot on finish; the rest of the chunk for
                # that slot is dropped by the None check inside _emit
                entry_lp = (self._lp_entry(token_id, lp[0][slot, i], lp[1][slot, i],
                                           lp[2][slot, i]) if want_lp else None)
                self._emit(slot, int(token_id), entry_lp)
        self._release_quarantine(entry.seq)
        # a promotion that completed while this chunk computed cost the
        # loop nothing
        self._reap_promotions()
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
                self._release_guided(slot, request)
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
            if self._ledger is not None:
                lifecycle_ledger.acquire("slot.quarantine", key=slot, domain=self)
            return
        self.paged_cache.pool.free(slot)

    def _release_quarantine(self, retired_seq: int) -> None:
        """Retire point: slots whose barrier has passed become reusable and
        their deferred page frees run."""
        for slot, barrier in list(self._quarantine.items()):
            if barrier <= retired_seq:
                del self._quarantine[slot]
                if self._ledger is not None:
                    lifecycle_ledger.release("slot.quarantine", key=slot, domain=self,
                                             all_of_key=True)
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
        if self._ledger is not None:
            for slot in pending:
                lifecycle_ledger.release("slot.quarantine", key=slot, domain=self,
                                         all_of_key=True)
        self._reset_device_chains()
        for slot in pending:
            if self._slot_req[slot] is None and slot not in self._admitting:
                self.paged_cache.pool.free(slot)

    def _reset_device_chains(self) -> None:
        """Forget the device-resident token and DFA-state chains: the next
        dispatch takes every slot's token and state from the host
        mirrors."""
        self._slot_overrides[:] = True
        self._gchain_epoch = None

    def _fail_slot(self, slot: int, err: BaseException) -> None:
        request = self._slot_req[slot]
        self._slot_req[slot] = None
        self._release_guided(slot, request)
        self._free_slot_pages(slot)
        if request is not None:
            request.error = err
            request.out_queue.put_nowait(_FINISHED)
            self._ledger_audit_request(request, "fail")

    def _finish_slot(self, slot: int, request: GenRequest) -> None:
        request.out_queue.put_nowait(_FINISHED)
        self._slot_req[slot] = None
        self._release_guided(slot, request)
        try:
            # chaos seam: a raise models a teardown that loses the slot's
            # page references; the armed sanitizer names them at drain
            faults.fire("engine.release", request=request)
            self._free_slot_pages(slot)
        except faults.InjectedFault:
            pass
        self._ledger_audit_request(request, "cancel" if request.cancelled else "emit-finish")

    def _emit(self, slot: int, token_id: int, lp: Optional[dict] = None) -> None:
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
        if lp is not None and request.logprobs is not None:
            # appended before the token is queued (GenRequest contract)
            request.logprob_entries.append(lp)
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
        stop_ids = request.stop_token_ids or (
            [self.eos_token_id] if self.eos_token_id is not None else [])
        if (
            token_id in stop_ids
            or request.produced >= self._effective_max_new(request)
            or request.prompt_len + request.produced >= self.max_seq_len
        ):
            self._finish_slot(slot, request)

    # -- ragged scheduler ------------------------------------------------------

    def _ragged_admission(self) -> None:
        """Admission into free slots under the ragged scheduler, in the
        queue's class order: each request opens a job whose prompt rides
        the loop's launches as chunk rows (the reference's
        ``_ragged_admission_task`` and ``_start_ragged_job``; the port's
        only worker-thread preparation is a guided request's grammar
        compile (``_start_grammar_prep``), whose job opens at a later turn
        into the slot it reserved; any other job opens at once, and the
        ``engine.prefill`` seam fires here). A prefix-cache hit maps its
        shared pages into the slot by reference and opens the job at the
        prefix's end: its chunk rows read the mapped pages through the
        ragged kernel, and only the tail gets new pages."""
        for request, slot in self._take_prepped():
            self._open_ragged_job(request, slot)
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
            if self._needs_grammar_compile(request):
                self._start_grammar_prep(request, slot)
                continue
            if not self._open_ragged_job(request, slot):
                free.insert(0, slot)

    def _open_ragged_job(self, request: GenRequest, slot: int) -> bool:
        """Open one request's job in a free slot (its grammar, if any,
        already compiled: the registry reference is taken here if the prep
        did not take it); False when it failed and the slot is free
        again."""
        try:
            if request.guided is not None and request._guided_key is None:
                self._ensure_grammar(request)
            pos = self._start_ragged_job(request, slot)
        except Exception as ex:
            # the slot's table is authoritative: a free reclaims what a
            # hit mapped into it before the failure, nothing otherwise
            self._deref_guided_request(request)
            self._free_ragged_slot(slot)
            request.error = ex
            request.out_queue.put_nowait(_FINISHED)
            return False
        self._admitting.add(slot)
        self._prefill_jobs.append(_RaggedJob(request=request, slot=slot, pos=pos))
        self._last_progress = time.monotonic()
        return True

    def _start_ragged_job(self, request: GenRequest, slot: int) -> int:
        """The prompt position a ragged job opens at: a prefix-cache hit
        whose run is page-aligned and leaves a tail is mapped into the
        empty ``slot`` (``map_shared``) and the job starts past it; any
        other hit recomputes cold and counts as a miss. A hit on a demoted
        run promoted it: its copies were enqueued on the engine's stream,
        ahead of the launch whose chunk rows read the pages."""
        if faults.active():
            faults.fire("engine.prefill", request=request)
        if self._prefix is None:
            return 0
        self._count_ship_outcome(request)
        with _owner(request):
            hit = self._prefix.lookup_pages(request.prompt_ids, 0)
            if hit is None:
                return 0
            try:
                plen = hit["len"]
                if (0 < plen < len(request.prompt_ids)
                        and plen % self.paged_cache.pool.page_size == 0):
                    self.paged_cache.pool.map_shared(slot, list(hit["pages"]), plen)
                    return plen
                self._prefix.uncount_hit(hit)
                return 0
            finally:
                # the slot holds its own references now (or none)
                self._prefix.release(hit)

    def _fail_ragged_job(self, job: _RaggedJob, err: Optional[BaseException]) -> None:
        """Fail one in-progress admission (err None = cancelled): free its
        slot's pages and unblock its consumer."""
        if job in self._prefill_jobs:  # identity (dataclass eq=False)
            self._prefill_jobs.remove(job)
        self._admitting.discard(job.slot)
        self._deref_guided_request(job.request)
        if err is not None:
            job.request.error = err
        job.request.out_queue.put_nowait(_FINISHED)
        self._free_ragged_slot(job.slot)
        self._ledger_audit_request(job.request, "fail-ragged")

    def _free_ragged_slot(self, slot: int) -> None:
        """Reclaim a ragged admission's slot pages (no pipeline barrier
        applies: ragged steps run with the pipeline drained). The slot's
        table is authoritative: the free drops its mapped shared pages'
        references with the rest. A draft-ahead stream it started is never
        sealed: the receiver's unsealed assembly ages out."""
        self._kv_draft_ahead.pop(slot, None)
        self.paged_cache.pool.free(slot)

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
        sampling. A slot with sampling extras, a grammar or logprobs rides
        the launch as a plain decode row instead, sampled with the chunk's
        semantics (the reference's exclusions)."""
        lp_free = np.array([r is None or r.logprobs is None for r in self._slot_req])
        clean = active_mask & ~self._slot_extra & (self._gstate < 0) & lp_free
        greedy = clean & (self._temperature == 0.0)
        sampled = (clean & (self._temperature > 0.0) if self._spec_sampling
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
        for job in list(self._prefill_jobs):
            if left <= 0:
                break
            take = min(left, len(job.request.prompt_ids) - job.pos)
            if take <= 0:
                continue
            if faults.active():
                try:
                    # chaos seam: the budget admission of one job into this
                    # step; a raise sheds that admission alone
                    faults.fire("engine.admit.budget", request=job.request)
                except faults.InjectedFault as ex:
                    self._count_shed("budget", job.request.priority)
                    self._fail_ragged_job(job, EngineOverloadedError(
                        "ragged budget admission shed (injected): {}".format(ex),
                        retry_after=self._retry_after_hint(),
                        shed_class=job.request.priority))
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
        # the plain rows' extras and logprobs (the pipeline is drained, so a
        # row's seed counter is its produced count)
        extras_rows = None
        if self._extras_active(decode_mask):
            extras_rows = extras_host_rows(self.max_batch)
            self._batch_extras_rows(extras_rows, plain_mask)
        want_lp = self._wants_logprobs(decode_mask)
        # guided plain rows: the grammar tables of the state bucket, and the
        # rows' DFA states from the host mirror (the pipeline is drained)
        gbucket = (self._guided_device_tables()
                   if (self._gstate[decode_mask] >= 0).any() else 0)
        return {
            "decode_mask": decode_mask,
            "shares": shares,
            "budget": budget,
            "extras_rows": extras_rows,
            "want_lp": want_lp,
            "gbucket": gbucket,
            "gstate": self._gstate.copy() if gbucket else None,
            "temperature": self._temperature.copy(), "top_k": self._top_k.copy(),
            "top_p": self._top_p.copy(),
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

    def _stage_ragged(self, plan: dict):
        """Worker-side host half of a ragged step, before any device work:
        page allocation for every row's span (a row the pool cannot extend
        leaves the launch, ``_ragged_drop_row``), the pending copies on
        write enqueued on the engine's stream ahead of the launch that
        writes the fresh pages, each token's page coordinates (a plain
        decode row's window positions 1.. become the chained steps' write
        coordinates, the mixed pass writing them to the null page, like any
        pad), and every input of the launch packed into fresh staging
        buffers (``RaggedLayout``; pinned on the card). Returns
        ``(host_i32, host_f32)``."""
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
        # copy on write: an extension above may have swapped a shared page
        # for a private one; its copy is enqueued on the engine's stream
        # (this worker's) before the launch that writes it
        self.paged_cache.apply_pending_cow()
        launch_steps = plan["launch_steps"]
        spec_any = plan["spec_mask"] | plan["sspec_mask"]
        chain_wp = chain_wo = None
        if launch_steps > 1:
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
        arrays = dict(plan["extras_rows"] or {})
        arrays.update({name: plan[name] for name in (
            "tokens", "tok_pos", "tok_row", "tok_valid", "write_page", "write_offset",
            "block_rows", "block_q0", "row_last", "row_starts", "row_lens", "kv_lens",
            "chain_mask", "spec_mask", "sspec_mask", "drafts", "row_logit_idx",
            "tree_tokens", "tree_parents", "tree_n", "tree_anc", "temperature", "top_k",
            "top_p", "gstate")})
        arrays.update(page_table=pool.page_table(self._pages_per_seq), chain_wp=chain_wp,
                      chain_wo=chain_wo,
                      # the plain rows of the launch, after any dropped row:
                      # the histogram and the DFA states advance for them
                      active=plan["decode_mask"] & ~spec_any)
        return self._ragged_layout.stage(arrays, pin=self._stream is not None)

    def _ragged_variant(self, plan: dict) -> RaggedVariant:
        """The launch's key, from what the plan fixes: its window, its
        verify rows' kind (from the plan's layout: a verify row dropped for
        want of pages leaves the kind) and whether one samples, whether
        every plain row is greedy, the extras (a sampled plain row
        seeded), the logprobs and the grammar tables' bucket."""
        verify = ("" if plan["row_logit_idx"] is None
                  else "tree" if plan["tree_anc"] is not None else "chain")
        rows = plan["extras_rows"]
        sampled = plan["decode_mask"] & (plan["temperature"] > 0)
        return RaggedVariant(
            steps=plan["launch_steps"], verify=verify,
            sampled_verify=bool(plan["sspec_mask"].any()), greedy=bool(plan["all_greedy"]),
            extras=rows is not None,
            seeded=rows is not None and bool((rows["seeds"][sampled] >= 0).any()),
            lp=bool(plan["want_lp"]), guided=int(plan["gbucket"]))

    def _run_ragged(self, variant: RaggedVariant, host_i32: torch.Tensor,
                    host_f32: torch.Tensor, draws: dict) -> dict:
        """The launch run eagerly (the CPU, or ``cuda_graphs`` off):
        ``run_ragged`` over the staged buffers, uploaded."""
        views = self._ragged_layout.views(host_i32.to(self.device, non_blocking=True),
                                          host_f32.to(self.device, non_blocking=True))
        return run_ragged(self.model, self.paged_cache, views, variant, draws,
                          block_map=self._ragged_qb > 1,
                          state=self._extras if variant.extras else None,
                          tables=(self._guided_tables_of(variant.guided)
                                  if variant.guided else None), lp_k=self._lp_k)

    def _read_ragged(self, plan: dict, out: dict, variant: RaggedVariant) -> dict:
        """The readback of a launch's outputs, before any later launch can
        overwrite them: the finishing rows' logits gathered on the device
        (rows padded to a power of two with row 0; a dropped row is gone),
        then the host reads of the tokens, the logprobs, the verify rows'
        tokens and acceptance and the DFA states."""
        finish = [s for s in plan["finish_slots"] if s in plan["spans"]]
        finish_logits = None
        if finish:
            rows = np.zeros(shapes.pow2_bucket(len(finish)), np.int64)
            rows[:len(finish)] = finish
            finish_logits = out["logits"][self._device_tensor(rows, np.int64)]
        result = {"sampled": out["sampled"].cpu().numpy(), "logits": finish_logits,
                  "finish_rows": finish, "spec_g": None, "spec_acc": None, "lp": None,
                  "gstate": None}
        if variant.lp:
            # step-major [S, B] (and [S, B, K]) on the host
            result["lp"] = tuple(part.cpu().numpy() for part in out["lp"])
        if variant.verify:
            result["spec_g"] = out["spec_g"].cpu().numpy()
            result["spec_acc"] = out["spec_acc"].cpu().numpy()
        if variant.guided:
            result["gstate"] = out["gstate"].cpu().numpy()
        return result

    def _dispatch_ragged_device(self, plan: dict) -> dict:
        """Worker thread: one ragged step in three parts. The host staging
        (``_stage_ragged``); the device work, one CUDA-graph replay of the
        launch's key on the card (captured at its first use), or
        ``run_ragged`` eagerly on the CPU or with ``cuda_graphs`` off, both
        over the same staged inputs and the draws taken here from the
        engine's generator; the readback (``_read_ragged``). The verify and
        chained-step counters count on the host, per launch."""
        t0 = time.perf_counter()
        host_i32, host_f32 = self._stage_ragged(plan)
        variant = self._ragged_variant(plan)
        with self._rng_lock:
            draws = ragged_draws(variant, self.max_batch, self.model.vocab_size,
                                 self._spec_k, self._gen, self.device)
        if self._ragged_graphs is not None:
            if not self._ragged_graphs.captured(variant):
                self._capture(variant)
            out = self._ragged_graphs.replay(variant, host_i32, host_f32, draws)
            self.counters["ragged_replays"] += 1
        else:
            out = self._run_ragged(variant, host_i32, host_f32, draws)
        if variant.verify:
            self.counters["ragged_verify_steps"] += 1
        self.counters["ragged_chain_steps"] += variant.steps - 1
        result = self._read_ragged(plan, out, variant)
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
            result = await self._on_worker("step", self._dispatch_ragged_device, plan)
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
        lp = result["lp"]

        def window_emit(slot: int, toks: List[int], with_lp: bool = False) -> None:
            nonlocal emitted
            for i, tok in enumerate(toks):
                request = self._slot_req[slot]
                if request is None:
                    break                      # mid-window EOS mask
                if self._tokbuf is not None:
                    idx = request.prompt_len + request.produced
                    if idx < self._tokbuf.shape[1]:
                        self._tokbuf[slot, idx] = tok
                entry = (self._lp_entry(tok, lp[0][i, slot], lp[1][i, slot], lp[2][i, slot])
                         if with_lp and lp is not None and request.logprobs is not None
                         else None)
                self._emit(slot, tok, entry)
                emitted += 1
            if self._slot_req[slot] is not None:
                self._next_token[slot] = toks[-1]

        gstate = result["gstate"]
        for slot in plain_slots:
            n = int(plan["row_steps"][slot])
            window_emit(slot, [int(sampled[i, slot]) for i in range(n)], with_lp=True)
            if gstate is not None and self._slot_req[slot] is not None:
                self._gstate[slot] = int(gstate[slot])
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
                # the chunk made whole storable pages final: a prefill leg
                # ships them ahead of its commit
                self._maybe_ship_draft(job)
                continue
            # final chunk landed: the row's last-token logits are the
            # prompt's prefill logits
            request = job.request
            self._prefill_jobs.remove(job)
            self._admitting.discard(job.slot)
            if request.cancelled:
                self._deref_guided_request(request)
                request.out_queue.put_nowait(_FINISHED)
                self._free_ragged_slot(job.slot)
                continue
            err = self._deadline_error_at_commit(request)
            if err is not None:
                self._deref_guided_request(request)
                request.error = err
                request.out_queue.put_nowait(_FINISHED)
                self._free_ragged_slot(job.slot)
                continue
            row = result["finish_rows"].index(job.slot)
            first_id, first_lp = self._first_token(request, result["logits"][row:row + 1])
            # the slot's own pages now hold the whole prompt's K/V
            self._store_prompt(request, job.slot)
            self._maybe_ship(request, job.slot)
            self._activate_slot(request, job.slot, first_id, first_lp)
        # the retire boundary's reap, as after a decode chunk
        self._reap_promotions()
        self._last_progress = time.monotonic()
