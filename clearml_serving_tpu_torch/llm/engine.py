"""Continuous-batching LLM engine over the paged KV cache.

Counterpart of ``clearml_serving_tpu/llm/engine.py``'s ``LLMEngineCore`` in
the configuration ``cache_mode="paged"``, ``scheduler="two_dispatch"``,
``pipeline_depth=1``:

- a fixed ``max_batch`` of slots; FIFO admission into free slots;
- admission = one prefill of the prompt padded to its bucket, its K/V
  written into freshly allocated pages, and the first token sampled from
  the last prompt position (emitted at once: the client's first token);
- decode = chunks of ``decode_steps`` fused steps over the whole slot batch,
  each step ``Llama.decode_paged`` (the paged attention kernel once per
  layer) followed by sampling; the chunk's tokens reach the host once, at
  its end, and fan out to the per-request queues;
- a request finishes on a stop token, ``max_new_tokens`` or
  ``max_seq_len``; its pages return to the pool right away.

Device work (prefill and decode chunks) runs in a worker thread, one call at
a time, so the event loop keeps serving HTTP while the card computes. Every
reference knob this slice does not serve raises, naming itself.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import AsyncIterator, Deque, List, Optional

import numpy as np
import torch

from ..models.llama import Llama
from .kv_cache import PagedKVCache
from .sampling import SamplingParams, sample_tokens
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

# reference engine knobs this slice does not serve (each raises when set)
UNSUPPORTED_KNOBS = (
    "mesh", "quantize", "weight_quant", "long_prefill_threshold",
    "long_bucket_step", "chunked_prefill_size", "prefill_segments_per_decode",
    "prefill_stall_timeout", "speculation", "spec_tree", "lora_adapters",
    "prefix_cache", "prefix_cache_bytes", "prefix_cache_pages",
    "prefix_cache_host_pages", "prefix_cache_host_bytes", "tokenizer",
    "max_pending", "queue_timeout", "ttft_timeout", "total_timeout",
    "watchdog_interval", "step_token_budget", "ragged_decode_steps",
    "brownout", "replica",
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
        pipeline_depth: Optional[int] = 1,
        scheduler: Optional[str] = "two_dispatch",
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
        if scheduler not in (None, "two_dispatch"):
            raise ValueError(
                "engine knob scheduler={!r} is not supported by the PyTorch "
                "port yet (two_dispatch only)".format(scheduler)
            )
        if pipeline_depth not in (None, 1):
            raise ValueError(
                "engine knob pipeline_depth={!r} is not supported by the "
                "PyTorch port yet (1 only)".format(pipeline_depth)
            )
        self.model = model
        self.device = model.device
        self.max_batch = int(max_batch)
        self.max_seq_len = int(max_seq_len)
        self.eos_token_id = eos_token_id
        self.decode_steps = max(1, int(decode_steps))
        self.cache_mode = "paged"
        self._buckets = shapes.prefill_buckets(prefill_buckets, self.max_seq_len)
        # every slot can hold max_seq_len plus one decode chunk; page 0 is
        # the reserved null page
        self._pages_per_seq = -(-(self.max_seq_len + self.decode_steps) // int(page_size))
        total_pages = num_pages or (self.max_batch * self._pages_per_seq + 1)
        self.paged_cache = PagedKVCache(
            model.n_layers, model.n_kv_heads, model.head_dim,
            num_pages=total_pages, page_size=int(page_size),
            max_slots=self.max_batch, dtype=model.dtype,
            kv_quant=model.kv_quant, device=self.device,
        )
        self._gen = torch.Generator(self.device)
        self._gen.manual_seed(int(rng_seed))
        # slot bookkeeping (loop thread)
        self._slot_req: List[Optional[GenRequest]] = [None] * self.max_batch
        self._next_token = np.zeros(self.max_batch, np.int32)
        self._temperature = np.zeros(self.max_batch, np.float32)
        self._top_k = np.zeros(self.max_batch, np.int32)
        self._top_p = np.ones(self.max_batch, np.float32)
        self._pending: Deque[GenRequest] = deque()
        self._loop_task: Optional[asyncio.Task] = None
        self._stopped = False
        # observability: decode steps run (each = one decode_paged call, so
        # n_layers paged-attention launches), chunks, prefills, and the host
        # wall time of the device calls (each ends in a device->host read)
        self.counters = {"decode_steps": 0, "decode_chunks": 0, "prefills": 0,
                         "tokens_emitted": 0, "decode_ms": 0.0, "prefill_ms": 0.0}
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

    def stop(self) -> None:
        """Stop the loop and fail every active and pending request."""
        self._stopped = True
        err = EngineUnavailableError("engine stopped")
        for slot, request in enumerate(self._slot_req):
            if request is not None:
                self._fail_slot(slot, err)
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
            "counters": dict(self.counters),
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
                await self._admit()
                active = np.array([r is not None for r in self._slot_req])
                if not active.any():
                    if not self._pending:
                        return  # drained; a new generate() restarts the loop
                    continue
                try:
                    chunk, exhausted = await asyncio.to_thread(self._decode_chunk, active)
                except Exception as ex:
                    logger.exception("decode chunk failed")
                    for slot in np.nonzero(active)[0]:
                        self._fail_slot(int(slot), ex)
                    continue
                self._retire_chunk(active, chunk, exhausted)
                await asyncio.sleep(0)  # let HTTP handlers interleave
        except BaseException as ex:
            for slot, request in enumerate(self._slot_req):
                if request is not None:
                    self._fail_slot(slot, ex)
            raise

    async def _admit(self) -> None:
        """FIFO admission of pending requests into free slots: prefill,
        pages, first token."""
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        while free and self._pending and not self._stopped:
            request = self._pending.popleft()
            if request.cancelled:
                request.out_queue.put_nowait(_FINISHED)
                continue
            slot = free.pop(0)
            try:
                first_id = await asyncio.to_thread(self._prefill_into_slot, request, slot)
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
        params = SamplingParams(
            temperature=torch.tensor([request.temperature], dtype=torch.float32,
                                     device=self.device),
            top_k=torch.tensor([request.top_k], dtype=torch.int32, device=self.device),
            top_p=torch.tensor([request.top_p], dtype=torch.float32, device=self.device),
        )
        first = sample_tokens(last.float(), params, generator=self._gen,
                              all_greedy=request.temperature <= 0)
        first_id = int(first.item())
        self.counters["prefills"] += 1
        self.counters["prefill_ms"] += (time.perf_counter() - t0) * 1e3
        return first_id

    def _activate_slot(self, request: GenRequest, slot: int, first_id: int) -> None:
        self._slot_req[slot] = request
        self._next_token[slot] = first_id
        self._temperature[slot] = request.temperature
        self._top_k[slot] = request.top_k
        self._top_p[slot] = request.top_p
        self._emit(slot, first_id)

    def _decode_chunk(self, active: np.ndarray):
        """Worker thread: ``decode_steps`` fused decode steps over the slot
        batch. Pre-allocates each active slot's pages for the whole chunk
        host-side; a slot the pool cannot extend is dropped from the chunk
        (its row writes the null page) and reported for failing."""
        t0 = time.perf_counter()
        pool = self.paged_cache.pool
        n = self.decode_steps
        lengths0 = pool.lengths().copy()          # pre-extension lengths
        write_pages = np.zeros((self.max_batch, n), np.int32)   # null page 0
        write_offsets = np.zeros((self.max_batch, n), np.int32)
        exhausted = []
        for slot in np.nonzero(active)[0]:
            slot = int(slot)
            start = pool.slot_length(slot)
            try:
                pool.extend(slot, n)
            except MemoryError:
                exhausted.append(slot)
                continue
            for i, (page, offset) in enumerate(pool.token_coords(slot, start, n)):
                write_pages[slot, i] = page
                write_offsets[slot, i] = offset
        dev = self.device
        page_table = torch.as_tensor(pool.page_table(self._pages_per_seq), device=dev)
        lengths0_t = torch.as_tensor(lengths0, device=dev)
        wp = torch.as_tensor(write_pages, device=dev)
        wo = torch.as_tensor(write_offsets, device=dev)
        tokens = torch.as_tensor(self._next_token.astype(np.int64), device=dev)
        sampling = self._sampling()
        all_greedy = not (self._temperature[active] > 0).any()
        cache = self.paged_cache
        scale_kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                    if cache.kv_quant else {})
        steps = []
        for step in range(n):
            logits = self.model.decode_paged(
                tokens, cache.k, cache.v, page_table, lengths0_t + step,
                wp[:, step], wo[:, step], **scale_kw,
            )
            sampled = sample_tokens(logits, sampling, generator=self._gen,
                                    all_greedy=all_greedy)
            steps.append(sampled)
            tokens = sampled.long()
            self.counters["decode_steps"] += 1
        chunk = torch.stack(steps, dim=1).cpu().numpy()
        self.counters["decode_chunks"] += 1
        self.counters["decode_ms"] += (time.perf_counter() - t0) * 1e3
        return chunk, exhausted

    def _retire_chunk(self, active: np.ndarray, chunk: np.ndarray,
                      exhausted: List[int]) -> None:
        for slot in exhausted:
            self._fail_slot(slot, MemoryError("kv page pool exhausted for this sequence"))
        for slot in np.nonzero(active)[0]:
            slot = int(slot)
            if slot in exhausted:
                continue
            self._next_token[slot] = int(chunk[slot, -1])
            for token_id in chunk[slot]:
                # _emit frees the slot on finish; the rest of the chunk for
                # that slot is dropped by the None check inside _emit
                self._emit(slot, int(token_id))

    def _fail_slot(self, slot: int, err: BaseException) -> None:
        request = self._slot_req[slot]
        self._slot_req[slot] = None
        self.paged_cache.pool.free(slot)
        if request is not None:
            request.error = err
            request.out_queue.put_nowait(_FINISHED)

    def _finish_slot(self, slot: int, request: GenRequest) -> None:
        request.out_queue.put_nowait(_FINISHED)
        self._slot_req[slot] = None
        self.paged_cache.pool.free(slot)

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
