"""One fused decode chunk: the plain function, and its CUDA graphs.

Counterpart of the reference's ``_decode_paged_chunk_jit``
(``clearml_serving_tpu/llm/engine.py:2121-2128``): ``decode_steps`` times
``decode_paged`` (the paged attention kernel once per layer) and sampling,
over the whole slot batch, each step feeding its sampled tokens to the next.
The JAX engine runs it as one compiled program; on the card the port
captures it once per variant into a ``torch.cuda.CUDAGraph`` and replays
it, so a chunk costs one launch from Python instead of ~1000.

A chunk's host inputs travel in two packed buffers, one int32 and one
float32 (``ChunkLayout``), so one upload per dtype fills them all:

- the page table, the lengths before the chunk, each step's write page and
  offset (the host allocates the chunk's pages ahead);
- the per-slot sampling parameters;
- the chain merge: the token input is the previous chunk's last token,
  kept on the device (``chain``), except where the host overrides it with
  a fresh admission's first token (the reference's ``_merge_rows``).

The Gumbel noise of a sampled chunk is drawn outside, from the engine's
generator, and passed in: draws made inside a graph would repeat on every
replay. A greedy chunk draws nothing (``noise`` None).

The reference's extras ride the chunk as batch data (its ``_decode_chunk``,
``clearml_serving_tpu/llm/engine.py:1634-1698``): the active mask, the
penalties, seeds, seed counters, ``min_tokens`` floors and stop rows travel
in the packed buffers; the generated-token histogram, the bias rows and the
prompt masks are ``ExtrasState``'s ``[max_batch, V]`` tensors at fixed
addresses, which each step reads and whose histogram it advances in place
for the active rows, so it chains across steps and chunks. A seeded row's
Gumbel row is drawn inside the graph from its seed and counter
(``llm/prng.py``); the counters are offset per step. With logprobs a chunk
also emits each step's chosen logprob and top-k over the penalized logits.

Guided decoding rides the same way (the reference chunk body's order:
grammar mask, penalized sample, histogram count, DFA advance): each slot's
DFA state is a device ``[B]`` int32 chain beside the token chain, which the
host overrides per slot as it does tokens, and the grammar tables
(``llm/guided.py``'s combined mask bits and byte DFA, padded to a
power-of-two state count) sit at fixed addresses, one buffer pair per
bucket, so a guided variant's graph is keyed by its bucket.
``DecodeGraphs`` keys its graphs by ``ChunkVariant`` (greedy, extras,
seeded, logprobs, guided bucket); the two plain variants are the ones
``warmup()`` captures.

Graphs read their inputs from static buffers and write the KV pools (and
the int8 scale pools) by address: ``PagedKVCache`` allocates them once and
never reallocates them. A graph's own allocations (activations, the
kernels' workspaces, the output tokens) live in its private memory pool for
the graph's lifetime.
"""

from __future__ import annotations

import concurrent.futures
import gc
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import CAPTURE_LOCK
from ..ops import launch_counts
from ..ops.fused_matmul import fused_int4_matmul
from ..ops.paged_attention import paged_attention
from .sampling import (
    STOP_SLOTS,
    SamplingExtras,
    SamplingParams,
    logprobs_of,
    penalize_logits,
    guided_advance,
    guided_mask,
    sample_penalized,
    sample_tokens,
)

# the kernels a chunk launches: (wrapper, count) pairs a replay adds to
COUNTED = ((paged_attention, "launches"), (fused_int4_matmul, "launches"))


# Every capture warms up on one stream per device and captures on the
# capture stream kept for the engine's stream: (device index, engine
# stream) -> capture stream.
# cuBLAS keeps a 32 MiB workspace per (thread's handle, stream) for the
# life of the process, so a new stream per capture would leave one more
# behind each time. The graphs use their capture stream's workspace: an
# eager run on that stream would write it while a graph replays, and so
# would the replay of another graph captured there on another engine
# stream. Engines on one stream replay in order; engines on separate
# streams (a fleet's replicas) capture on streams of their own, so their
# concurrent replays use separate workspaces. The warm-up runs, eager and
# serialized by ``CAPTURE_LOCK``, share one stream whose workspace no
# graph uses.
_WARM_STREAMS: Dict[int, "torch.cuda.Stream"] = {}
_CAPTURE_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}


def _capture_streams(dev: torch.device, stream: "torch.cuda.Stream") -> tuple:
    """The warm-up stream and the capture stream of the engines on
    ``stream`` (made at their first capture; the caller holds
    ``CAPTURE_LOCK``)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _WARM_STREAMS:
        _WARM_STREAMS[index] = torch.cuda.Stream(index)
    key = (index, stream.cuda_stream)
    if key not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[key] = torch.cuda.Stream(index)
    return _WARM_STREAMS[index], _CAPTURE_STREAMS[key]


# The one thread every capture runs on, made at the first capture: each
# thread has its own cuBLAS handle, so captures from the engines' worker
# threads would each leave a workspace of their own on the capture stream.
_CAPTURE_THREAD: list = []
_CAPTURE_THREAD_MADE = threading.Lock()


def _on_capture_thread(fn, *args):
    """Run ``fn(*args)`` on the capture thread and return its result (its
    exception is raised here). The caller must not hold ``CAPTURE_LOCK``,
    which the capture takes."""
    with _CAPTURE_THREAD_MADE:
        if not _CAPTURE_THREAD:
            _CAPTURE_THREAD.append(concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="cuda-graph-capture"))
    return _CAPTURE_THREAD[0].submit(fn, *args).result()


class ChunkVariant(NamedTuple):
    """One compiled shape of the chunk: every row greedy (no noise read),
    the extras applied, a seeded row present (the in-graph draw), the
    logprobs emitted, and ``guided``: the state bucket of the grammar
    tables a guided slot reads (0: no guided slot). The plain variants are
    ``ChunkVariant(True)`` and ``ChunkVariant(False)``."""

    greedy: bool
    extras: bool = False
    seeded: bool = False
    lp: bool = False
    guided: int = 0

    def label(self) -> str:
        parts = ["greedy" if self.greedy else "sampled"]
        parts += [name for name, on in (("extras", self.extras), ("seeded", self.seeded),
                                        ("logprobs", self.lp)) if on]
        if self.guided:
            parts.append("guided{}".format(self.guided))
        return "+".join(parts)


def _variant(key) -> ChunkVariant:
    """A variant from a ``ChunkVariant`` or a bool (a plain variant:
    greedy or sampled)."""
    return key if isinstance(key, ChunkVariant) else ChunkVariant(bool(key))


class ExtrasState:
    """The device-chained rows of the extras, ``[max_batch, V]`` each and
    allocated once, so graphs read them by address: the generated-token
    histogram ``counts`` (int32), the dense logit ``bias`` (f32) and the
    prompt's token mask ``pmask`` (bool). An admission's commit resets its
    slot's rows (``reset_row``) on the engine's stream, behind any chunk in
    flight and ahead of the next one."""

    def __init__(self, batch: int, vocab: int, device):
        self.counts = torch.zeros((batch, vocab), dtype=torch.int32, device=device)
        self.bias = torch.zeros((batch, vocab), dtype=torch.float32, device=device)
        self.pmask = torch.zeros((batch, vocab), dtype=torch.bool, device=device)

    def reset_row(self, slot: int, first_id: Optional[int], bias_row: torch.Tensor,
                  pmask_row: torch.Tensor) -> None:
        """The slot's histogram holds just its first token (generated output
        for the penalties; none for a resume), its bias and prompt mask the
        given host rows (pinned on the card: the copies are asynchronous)."""
        self.counts[slot].zero_()
        if first_id is not None:
            self.counts[slot, int(first_id)] = 1
        self.bias[slot].copy_(bias_row, non_blocking=True)
        self.pmask[slot].copy_(pmask_row, non_blocking=True)


def decode_chunk(model, cache, tokens, page_table, lengths0, write_pages, write_offsets,
                 sampling: SamplingParams, noise: Optional[torch.Tensor],
                 steps: int, *, extras: Optional[SamplingExtras] = None,
                 counts: Optional[torch.Tensor] = None,
                 prompt_mask: Optional[torch.Tensor] = None,
                 active: Optional[torch.Tensor] = None, lp_k: int = 0,
                 guided: Optional[tuple] = None, gstate: Optional[torch.Tensor] = None):
    """``steps`` fused decode steps over the slot batch: tokens [B] ->
    sampled tokens [B, steps] int32. Step i attends over ``lengths0 + i``
    tokens and writes its K/V at ``write_pages[:, i]``/``write_offsets[:,
    i]`` (rows the chunk skips write the null page 0). ``noise`` [steps, B,
    V] holds each step's Gumbel draws; None means every row is greedy.

    ``extras`` penalize every step's logits (its counters offset by the
    step); the histogram ``counts`` gains each step's token for the rows of
    ``active`` [B], in place. With ``lp_k`` > 0 the result is ``(tokens,
    (chosen [B, steps], top_ids [B, steps, lp_k], top_lp [B, steps,
    lp_k]))`` over the penalized logits.

    ``guided`` (mask bits, byte table, token bytes, token lengths) masks
    every step's logits by the rows' DFA states ``gstate`` [B] int32 (< 0:
    unguided) before the extras, and advances the states of ``active``'s
    rows by the sampled tokens; the result is then ``(result, states)``."""
    scale_kw = ({"k_scales": cache.k_scale, "v_scales": cache.v_scale}
                if cache.kv_quant else {})
    tokens = tokens.long()
    out, lps = [], []
    for step in range(steps):
        logits = model.decode_paged(
            tokens, cache.k, cache.v, page_table, lengths0 + step,
            write_pages[:, step], write_offsets[:, step], **scale_kw,
        )
        step_noise = None if noise is None else noise[step]
        if guided is not None:
            logits = guided_mask(logits.float(), gstate, guided[0])
        if extras is None:
            sampled = sample_tokens(logits, sampling, noise=step_noise,
                                    all_greedy=noise is None)
            lp_src = logits
        else:
            ex = extras._replace(counters=extras.counters + step)
            lp_src = penalize_logits(logits.float(), ex, counts, prompt_mask)
            sampled = sample_penalized(lp_src, sampling, noise=step_noise,
                                       all_greedy=noise is None, extras=ex)
            counts.scatter_add_(1, sampled.long()[:, None], active.to(counts.dtype)[:, None])
        if guided is not None:
            gstate = guided_advance(gstate, sampled, active != 0, *guided[1:])
        if lp_k:
            lps.append(logprobs_of(lp_src, sampled, lp_k))
        out.append(sampled)
        tokens = sampled.long()
    toks = torch.stack(out, dim=1)
    result = toks if not lp_k else (
        toks, tuple(torch.stack(parts, dim=1) for parts in zip(*lps)))
    return result if guided is None else (result, gstate)


def _extras_fields(b: int):
    """The extras' per-row host data (int32 fields, float32 fields): read
    by the extras variants of the chunk and the ragged launch's rows."""
    return ((("active", (b,)), ("seeds", (b,)), ("counters", (b,)), ("min_new", (b,)),
             ("stop", (b, STOP_SLOTS))),
            (("presence", (b,)), ("frequency", (b,)), ("repetition", (b,))))


def extras_host_rows(b: int) -> Dict[str, np.ndarray]:
    """Zeroed host arrays of the extras' per-row fields, by name."""
    i32, f32 = _extras_fields(b)
    return dict([(name, np.zeros(shape, np.int32)) for name, shape in i32]
                + [(name, np.zeros(shape, np.float32)) for name, shape in f32])


class ChunkLayout:
    """Where each host input of a chunk sits in the packed int32 and
    float32 buffers. ``views`` cuts either a numpy array or a tensor."""

    def __init__(self, batch: int, pages_per_seq: int, steps: int):
        b, n = batch, steps
        ex_i32, ex_f32 = _extras_fields(b)
        self.i32 = (("page_table", (b, pages_per_seq)), ("lengths0", (b,)),
                    ("write_pages", (b, n)), ("write_offsets", (b, n)), ("top_k", (b,)),
                    ("override_tokens", (b,)), ("override_mask", (b,)),
                    ("override_gstate", (b,)), ("override_gmask", (b,))) + ex_i32
        self.f32 = (("temperature", (b,)), ("top_p", (b,))) + ex_f32
        self.size_i32 = sum(int(np.prod(shape)) for _, shape in self.i32)
        self.size_f32 = sum(int(np.prod(shape)) for _, shape in self.f32)

    def views(self, buf_i32, buf_f32) -> Dict[str, object]:
        out = {}
        for fields, buf in ((self.i32, buf_i32), (self.f32, buf_f32)):
            off = 0
            for name, shape in fields:
                size = int(np.prod(shape))
                out[name] = buf[off:off + size].reshape(shape)
                off += size
        return out


def run_chunk(model, cache, views, chain: torch.Tensor, noise: Optional[torch.Tensor],
              steps: int, *, variant: Optional[ChunkVariant] = None,
              state: Optional[ExtrasState] = None, lp_k: int = 0,
              tables: Optional[tuple] = None, gchain: Optional[torch.Tensor] = None):
    """``decode_chunk`` over the inputs of ``ChunkLayout.views``: the token
    input is ``chain`` where the host does not override it. An extras
    ``variant`` reads the extras rows of the views and ``state``; a
    logprobs one returns ``(tokens, lp)`` (``decode_chunk``). A guided one
    reads the grammar ``tables`` and the DFA states ``gchain`` where the
    host does not override them (``override_gmask``), and returns
    ``(result, states)``."""
    tokens = torch.where(views["override_mask"] != 0, views["override_tokens"], chain)
    sampling = SamplingParams(temperature=views["temperature"], top_k=views["top_k"],
                              top_p=views["top_p"])
    kw = {}
    if variant is not None and variant.extras:
        kw = dict(extras=SamplingExtras(
            presence=views["presence"], frequency=views["frequency"],
            repetition=views["repetition"], bias=state.bias,
            seeds=views["seeds"] if variant.seeded else None, counters=views["counters"],
            min_new=views["min_new"], stop=views["stop"]),
            counts=state.counts, prompt_mask=state.pmask, active=views["active"])
    if variant is not None and variant.lp:
        kw["lp_k"] = lp_k
    if variant is not None and variant.guided:
        kw.update(guided=tables, active=views["active"], gstate=torch.where(
            views["override_gmask"] != 0, views["override_gstate"], gchain))
    return decode_chunk(model, cache, tokens, views["page_table"], views["lengths0"],
                        views["write_pages"], views["write_offsets"], sampling, noise, steps,
                        **kw)


def capture_graph(run, stream: "torch.cuda.Stream", counted, capture_error_mode: str,
                  pool=None) -> tuple:
    """Capture ``run()`` into a new CUDA graph. Called on the capture thread
    (``_on_capture_thread``), on ``stream`` (the engine's), with the static
    inputs set to a launch that writes only the null page. ``run`` first runs
    once eagerly on the warm-up stream, so kernel loads and library handles
    are set up outside the capture, then is captured on the capture stream
    of ``stream`` (``_capture_streams``), into ``pool`` (None: a private
    pool of its own). The kernels' counts of ``counted`` ((wrapper, count)
    pairs) keep meaning kernels run on the card: the capture's calls are
    taken back out and the warm-up run's ``launches`` moved into
    ``setup_launches``, both from this thread's own calls
    (``ops.launch_counts``: an admission worker may launch meanwhile).
    Returns ``(graph, static output, counts per replay, pool growth)``: the
    rise of the card's reserved memory inside the capture, the segments the
    pool took for it."""
    dev = stream.device

    def own():
        return [launch_counts.own(fn, attr) for fn, attr in counted]

    before = own()
    graph = torch.cuda.CUDAGraph()
    # the lock keeps another thread's release of a dropped engine out of
    # the capture
    with CAPTURE_LOCK:
        warm, side = _capture_streams(dev, stream)
        warm.wait_stream(stream)
        with torch.cuda.stream(warm):
            run()
        stream.wait_stream(warm)
        start = own()
        # the cycle collector stays off during the capture: a dead engine's
        # graphs and events it would free there release CUDA resources from
        # inside the capture, which invalidates it
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode=capture_error_mode):
                # read inside: entering the capture empties the cache
                reserved = torch.cuda.memory_reserved(dev)
                out = run()
                grown = torch.cuda.memory_reserved(dev) - reserved
        finally:
            if gc_was_on:
                gc.enable()
    now = own()
    for (fn, attr), was, warm_end, count in zip(counted, before, start, now):
        launch_counts.add(fn, was - count, attr=attr)
        if attr == "launches":
            launch_counts.add(fn, warm_end - was, attr="setup_launches")
    return graph, out, [a - b for a, b in zip(now, start)], grown


def add_replay_counts(counted, per_replay) -> None:
    """Add one replay's launches, as its capture recorded them."""
    for (fn, attr), count in zip(counted, per_replay):
        launch_counts.add(fn, count, attr=attr)


class DecodeGraphs:
    """The decode chunk captured as one CUDA graph per ``ChunkVariant``
    (each with its own memory pool): the plain greedy (every row argmax, no
    noise read) and sampled ones, and the extras, logprob and guided
    variants, captured at their first use. A guided variant reads the
    grammar tables of its bucket (``tables_fn(bucket)``, buffers that never
    move) and chains the DFA states in ``gchain``. The reference's chunk always runs all
    ``max_batch`` rows under an active mask, so there are no batch
    buckets.

    The kernels' ``launches`` counts keep meaning kernels run on the card
    (``capture_graph``): each replay adds the counts its capture recorded."""

    def __init__(self, model, cache, layout: ChunkLayout, steps: int,
                 state_fn=None, lp_k: int = 1, tables_fn=None):
        dev = model.device
        self.model, self.cache, self.layout, self.steps = model, cache, layout, steps
        # the extras' device rows (``ExtrasState``), made at first need
        self._state_fn = state_fn
        # a state bucket's grammar tables (mask bits, byte table, token
        # bytes, token lengths), at fixed addresses
        self._tables_fn = tables_fn
        self.lp_k = int(lp_k)
        self._i32 = torch.zeros(layout.size_i32, dtype=torch.int32, device=dev)
        self._f32 = torch.zeros(layout.size_f32, dtype=torch.float32, device=dev)
        self.views = layout.views(self._i32, self._f32)
        b = self.views["lengths0"].shape[0]
        # the device-resident token chain: the last sampled token of the
        # newest chunk, written by each replay's epilogue
        self.chain = torch.zeros(b, dtype=torch.int32, device=dev)
        # the DFA-state chain, written by each guided replay's epilogue
        self.gchain = torch.full((b,), -1, dtype=torch.int32, device=dev)
        self.noise = torch.zeros((steps, b, model.vocab_size), dtype=torch.float32, device=dev)
        # variant -> (graph, static output, launches per replay)
        self._graphs: Dict[ChunkVariant, tuple] = {}
        # variant -> the rise of the card's reserved memory inside its
        # capture: the segments its private pool took
        self.pool_growth: Dict[ChunkVariant, int] = {}

    def captured(self, greedy) -> bool:
        """Whether the variant (a ``ChunkVariant``, or a bool naming a
        plain one) is captured."""
        return _variant(greedy) in self._graphs

    def drop_guided(self, bucket: int) -> None:
        """Free the graphs (and their memory pools) of the guided variants
        of a grammar-table bucket no launch reads any more."""
        for variant in [v for v in self._graphs if v.guided == bucket]:
            del self._graphs[variant]
            self.pool_growth.pop(variant, None)

    def _run(self, variant: ChunkVariant):
        return run_chunk(self.model, self.cache, self.views, self.chain,
                         None if variant.greedy else self.noise, self.steps, variant=variant,
                         state=self._state_fn() if variant.extras else None, lp_k=self.lp_k,
                         tables=self._tables_fn(variant.guided) if variant.guided else None,
                         gchain=self.gchain)

    def capture(self, greedy, capture_error_mode: str = "global") -> None:
        """Capture one variant (a ``ChunkVariant``, or a bool naming a plain
        one). Called on the engine's stream with no chunk of this engine in
        flight on another; ``"thread_local"`` lets other threads keep using
        the card meanwhile (a capture while serving)."""
        variant = _variant(greedy)
        stream = torch.cuda.current_stream(self.model.device)
        _on_capture_thread(self._capture_on, variant, stream, capture_error_mode)

    def _capture_on(self, variant: ChunkVariant, stream: "torch.cuda.Stream",
                    capture_error_mode: str) -> None:
        """``capture``'s body, on the capture thread, ordered after the
        caller's ``stream``."""
        with torch.cuda.stream(stream):
            # null coordinates and no active row: the warm-up run writes only
            # the null page and adds nothing to the extras' histogram
            for name in ("page_table", "lengths0", "write_pages", "write_offsets", "active"):
                self.views[name].zero_()
            graph, out, per_replay, grown = capture_graph(
                lambda: self._run(variant), stream, COUNTED, capture_error_mode)
            self.pool_growth[variant] = grown
            self._graphs[variant] = (graph, out, per_replay)

    def replay(self, greedy, host_i32: torch.Tensor, host_f32: torch.Tensor,
               noise: Optional[torch.Tensor]):
        """Upload a chunk's packed host inputs (pinned, so the copies are
        asynchronous; the caching host allocator keeps each buffer until
        its copy has run), replay the variant on the current stream and
        advance the chains. Returns the static output, [B, steps] (with the
        logprob tensors for a logprob variant, and ``(output, states)`` for
        a guided one): the next replay overwrites it, so the caller copies
        it out on this stream first."""
        variant = _variant(greedy)
        graph, out, per_replay = self._graphs[variant]
        self._i32.copy_(host_i32, non_blocking=True)
        self._f32.copy_(host_f32, non_blocking=True)
        if not variant.greedy:
            self.noise.copy_(noise)
        graph.replay()
        add_replay_counts(COUNTED, per_replay)
        result = out
        if variant.guided:
            result, gstate = out
            self.gchain.copy_(gstate)
        tokens = result[0] if variant.lp else result
        self.chain.copy_(tokens[:, -1])
        return out
